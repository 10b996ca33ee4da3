"""ZeRO config block (counterpart of ``deepspeed_tpu/runtime/zero/config.py``).

The same ``zero_optimization`` JSON keys, read as the reference reads them:
the stage (0-3) selects the sharding policy (``runtime/zero/sharding.py``),
and ``stage3_param_persistence_threshold`` keeps stage 3's parameters of
fewer elements whole. The scheduling knobs (bucket sizes, overlap, prefetch)
are accepted and, as in the reference, ignored. The offload tiers raise
``NotImplementedError`` naming ROADMAP.md (Queue 1 item 10), so that no
config silently trains without the tier it asked for.
"""

from dataclasses import dataclass, fields

from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.utils import not_ported


@dataclass
class ZeroConfig:
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = False
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    sub_group_size: int = 1_000_000_000
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = 2**63 - 1
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False
    memory_efficient_linear: bool = True

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")


# the reference's aliases (DeepSpeed JSON configs of various versions)
_ALIASES = {
    "stage3_prefetch_bucket_size": "prefetch_bucket_size",
    "stage3_param_persistence_threshold": "param_persistence_threshold",
    "stage3_model_persistence_threshold": "model_persistence_threshold",
    "stage3_max_live_parameters": "max_live_parameters",
    "stage3_max_reuse_distance": "max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save": "gather_16bit_weights_on_model_save",
}
_OFFLOAD = ("offload_optimizer", "offload_param", "cpu_offload", "cpu_offload_params")
# ZeRO++ and MiCS, at their defaults (anything else raises)
_REFUSED = {"zero_hpz_partition_size": 1, "zero_quantized_weights": False,
            "zero_quantized_gradients": False, "mics_shard_size": -1,
            "mics_hierarchical_params_gather": False}
_FIELDS = {f.name for f in fields(ZeroConfig)}


def _offload_off(value) -> bool:
    return not value or (isinstance(value, dict) and value.get("device", "none") == "none")


def zero_config_from_dict(block) -> ZeroConfig:
    """The block's ``ZeroConfig``; raises for the offload tiers and for the
    ZeRO++/MiCS options the port does not have."""
    if block is None:
        block = {}
    if not isinstance(block, dict):
        raise ConfigError(f"zero_optimization must be a dict, got {type(block).__name__}")
    kwargs = {}
    for key, value in block.items():
        if key in _OFFLOAD:
            if not _offload_off(value):
                raise not_ported(f"zero_optimization.{key} (the offload tiers, Queue 1 item 10)")
            continue
        if key in _REFUSED:
            if value is not None and (type(value), value) != (type(_REFUSED[key]), _REFUSED[key]):
                raise not_ported(f"zero_optimization.{key}")
            continue
        name = _ALIASES.get(key, key)
        if name not in _FIELDS:
            raise not_ported(f"zero_optimization.{key}")
        kwargs[name] = value
    return ZeroConfig(**kwargs)
