"""ZeRO config block, cut to what the single-device engine reads.

Counterpart of ``deepspeed_tpu/runtime/zero/config.py`` (``ZeroConfig``):
the same ``zero_optimization`` JSON block, of which the port reads only the
stage. Stage 0 (parameters, gradients and optimizer state whole on the one
device) is the only one ported; a higher stage, an offload tier, or any other
key set in the block raises ``NotImplementedError`` naming ROADMAP.md, so
that no config silently trains without the sharding it asked for.
"""

from dataclasses import dataclass

from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.utils import not_ported


@dataclass
class ZeroConfig:
    stage: int = 0

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        if self.stage != 0:
            raise not_ported(f"ZeRO stage {self.stage}")


def _offload_off(value) -> bool:
    return not value or (isinstance(value, dict) and value.get("device", "none") == "none")


def zero_config_from_dict(block) -> ZeroConfig:
    """The block's ``ZeroConfig``; raises for anything beyond stage 0."""
    if block is None:
        block = {}
    if not isinstance(block, dict):
        raise ConfigError(f"zero_optimization must be a dict, got {type(block).__name__}")
    for key, value in block.items():
        if key == "stage":
            continue
        if key in ("offload_optimizer", "offload_param") and _offload_off(value):
            continue
        raise not_ported(f"zero_optimization.{key}")
    return ZeroConfig(stage=block.get("stage", 0))
