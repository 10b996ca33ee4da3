"""JSON config of the training engine, the subset the port's engine reads.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (``TpuConfig``; reference
``DeepSpeedConfig``, config.py:674): the same JSON schema, the same
``train_batch_size = micro_batch * grad_accum * dp`` reconciliation (dp is
the mesh's ``data`` x ``fsdp``) and the same typed blocks for the keys it
reads: ``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``, ``optimizer``, ``scheduler``, ``bf16`` /
``fp16``, ``gradient_clipping``, ``prescale_gradients`` /
``gradient_predivide_factor``, ``zero_optimization`` (stages 0-3,
``runtime/zero/config.py``), ``steps_per_print``, ``wall_clock_breakdown``
(the engine's timers), ``seed``, ``mesh`` (a shape whose product is the
world size: the process group's, else 1) and ``checkpoint``
(``async_save``, ``integrity_manifest``; ``use_ocdbt`` only when false, since
the port has no Orbax layout) and ``activation_checkpointing`` (the
engine hands it to ``runtime/activation_checkpointing.configure``, which
raises for what it does not port). Any other key
set away from its default (a block switched on, an offload tier, a
multi-slice ``mesh.dcn``) raises ``NotImplementedError`` naming ROADMAP.md,
so that no config silently takes a path the port does not have.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import ConfigError, from_dict
from deepspeed_tpu_torch.runtime.zero.config import zero_config_from_dict
from deepspeed_tpu_torch.utils import not_ported

AUTO = "auto"


@dataclass
class FP16Config:
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class OptimizerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ActivationCheckpointingConfig:
    # reference: activation_checkpointing/checkpointing.py configure() :789
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    # the remat policy's name (runtime/activation_checkpointing.POLICIES)
    policy: str = "full"


@dataclass
class MeshConfig:
    """Device mesh axis sizes; -1 on one axis absorbs the remaining ranks."""

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1
    dcn: Optional[dict] = None


_READ = {
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.GRADIENT_ACCUMULATION_STEPS,
    C.STEPS_PER_PRINT, C.GRADIENT_CLIPPING, C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR,
    C.WALL_CLOCK_BREAKDOWN, "seed", "fp16", "bf16", "bfloat16", "optimizer", "scheduler",
    "zero_optimization", "mesh", "checkpoint", "activation_checkpointing",
}
# the checkpoint block's keys (the reference's engine.py:520-524, :1758)
_CHECKPOINT_KEYS = {"async_save", "integrity_manifest", "use_ocdbt"}


def _is_off(value) -> bool:
    """A config block or flag left at its default: absent, empty, false or
    ``{"enabled": false, ...}``."""
    if value is None or value is False or value == {} or value == []:
        return True
    return isinstance(value, dict) and value.get("enabled") is False


def _is_auto(value) -> bool:
    return isinstance(value, str) and value == AUTO


class TpuConfig:
    """Parsed, validated config (the reference's ``TpuConfig``)."""

    def __init__(self, config):
        if isinstance(config, str):
            with open(config, "r") as fh:
                config = json.load(fh)
        if config is None:
            config = {}
        if not isinstance(config, dict):
            raise ConfigError(f"config must be a dict or a path to a JSON file, got {type(config)}")
        for key, value in config.items():
            if key not in _READ and not _is_off(value):
                raise not_ported(f"config key {key!r}")

        g = config.get
        self.train_batch_size = g(C.TRAIN_BATCH_SIZE, None)
        self.train_micro_batch_size_per_gpu = g(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, None)
        self.gradient_accumulation_steps = g(C.GRADIENT_ACCUMULATION_STEPS, None)
        self.steps_per_print = g(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = g(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)
        self.prescale_gradients = g(C.PRESCALE_GRADIENTS, False)
        self.gradient_predivide_factor = g(C.GRADIENT_PREDIVIDE_FACTOR, 1.0)
        self.wall_clock_breakdown = g(C.WALL_CLOCK_BREAKDOWN, False)
        self.seed = g("seed", 1234)

        self.fp16 = from_dict(FP16Config, g("fp16", {}))
        self.bf16 = from_dict(BF16Config, g("bf16", g("bfloat16", {})))
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        self.optimizer = from_dict(OptimizerConfig, g("optimizer", {})) if g("optimizer") else None
        self.scheduler = from_dict(SchedulerConfig, g("scheduler", {})) if g("scheduler") else None
        self.zero_config = zero_config_from_dict(g("zero_optimization", {}))
        self.activation_checkpointing = from_dict(ActivationCheckpointingConfig,
                                                  g("activation_checkpointing", None) or {})
        self.mesh = from_dict(MeshConfig, g("mesh", {}))
        self._check_mesh()
        self.checkpoint = dict(g("checkpoint", None) or {})
        for key, value in self.checkpoint.items():
            if key not in _CHECKPOINT_KEYS and not _is_off(value):
                raise not_ported(f"config key 'checkpoint.{key}'")
        if self.checkpoint.get("use_ocdbt", False):
            raise not_ported("checkpoint.use_ocdbt (Orbax's OCDBT layout: the port writes "
                             "one file per leaf)")
        self._resolve_batch_sizes()

    def _check_mesh(self):
        if self.mesh.dcn:
            raise not_ported("a multi-slice mesh (mesh.dcn)")
        self.mesh_axis_sizes()

    def mesh_axis_sizes(self) -> Dict[str, int]:
        """The mesh's full {axis: size} over the world (the process
        group's, else one process; the reference's ``_normalize_mesh_shape``
        rules)."""
        from deepspeed_tpu_torch import comm

        n = comm.get_world_size()
        sizes = {k: v for k, v in dataclasses.asdict(self.mesh).items() if k != "dcn"}
        try:
            return comm.comm._normalize_mesh_shape(sizes, n)
        except ValueError as e:
            raise ConfigError(str(e)) from e

    def dp_world_size(self) -> int:
        """Data-parallel world size implied by the mesh (data x fsdp axes)."""
        sizes = self.mesh_axis_sizes()
        return sizes["data"] * sizes["fsdp"]

    # --- batch triad reconciliation (reference runtime/config.py batch logic)
    def _resolve_batch_sizes(self):
        dp = self.dp_world_size()
        tb, mb, gas = self.train_batch_size, self.train_micro_batch_size_per_gpu, self.gradient_accumulation_steps
        tb = None if _is_auto(tb) else tb
        mb = None if _is_auto(mb) else mb
        gas = None if _is_auto(gas) else gas

        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp:
                raise ConfigError(
                    f"train_batch_size ({tb}) != micro_batch ({mb}) * grad_accum ({gas}) * dp_world_size ({dp})"
                )
        elif tb is not None and mb is not None:
            gas, rem = divmod(tb, mb * dp)
            if rem:
                raise ConfigError(f"train_batch_size {tb} not divisible by micro_batch*dp {mb * dp}")
        elif tb is not None and gas is not None:
            mb, rem = divmod(tb, gas * dp)
            if rem:
                raise ConfigError(f"train_batch_size {tb} not divisible by grad_accum*dp {gas * dp}")
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp
        elif tb is not None:
            mb, rem = divmod(tb, dp)
            gas = 1
            if rem:
                raise ConfigError(f"train_batch_size {tb} not divisible by dp_world_size {dp}")
        else:
            raise ConfigError(
                "Provide at least train_batch_size or train_micro_batch_size_per_gpu "
                f"(keys: {C.TRAIN_BATCH_SIZE}, {C.TRAIN_MICRO_BATCH_SIZE_PER_GPU})"
            )
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    # --- dtype resolution ----------------------------------------------
    def model_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
