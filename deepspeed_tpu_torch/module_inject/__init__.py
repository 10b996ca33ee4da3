from deepspeed_tpu_torch.module_inject.policies import (  # noqa: F401
    config_from_hf,
    convert_hf_model,
    partition_rules,
    policy_for,
)
