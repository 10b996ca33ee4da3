from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (
    checkpoint,
    checkpoint_wrapper,
    configure,
    is_configured,
    resolve_policy,
)

__all__ = [
    "checkpointing",
    "checkpoint",
    "checkpoint_wrapper",
    "configure",
    "is_configured",
    "resolve_policy",
]
