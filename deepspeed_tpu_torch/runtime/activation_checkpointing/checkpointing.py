"""Activation checkpointing (rematerialisation).

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py`` (reference ``deepspeed/runtime/activation_checkpointing/
checkpointing.py``: ``checkpoint()`` :708, ``configure()`` :789,
``partition_activations`` :366, ``CudaRNGStatesTracker`` :121):

  - ``checkpoint(fn, *args)`` runs ``fn`` under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the backward
    recomputes the region's activations instead of keeping them.
  - The reference's four ``jax.checkpoint`` policies (``POLICIES``) keep the
    same sets: ``nothing_saveable`` recomputes everything inside the
    region; ``dots_saveable`` keeps every matrix product's output
    (``mm``/``addmm``/``bmm``/``baddbmm``) and ``dots_with_no_batch_dims``
    those without a batch dimension (``mm``/``addmm``: the weight
    products), through selective-checkpoint contexts; ``full`` keeps
    everything, which is the region run as it is. A kernel's custom
    autograd op is recomputed under every policy but ``full``, as
    ``jax.checkpoint`` recomputes a Pallas call.
  - ``partition_activations`` shards the saved layer input over the
    ``tensor`` (and ``sequence``) axes in the reference; with neither axis
    over 1 it returns the input unchanged, as here. Over 1 it raises.
  - ``cpu_checkpointing`` (and the ``"offload"`` policy) raise: the host
    tiers come with ``zero3_offload`` (ROADMAP Queue 1 item 10).
  - ``RNGStatesTracker`` holds named ``torch.Generator`` streams.

``configure()`` reads the same JSON block (``runtime/config.py``
``activation_checkpointing``): partition_activations, cpu_checkpointing,
contiguous_memory_optimization (a no-op that warns: the allocator owns
layout), number_checkpoints, profile (each layer under a
``torch.profiler.record_function("checkpoint_layer")`` range),
synchronize_checkpoint_boundary (a no-op that warns) and ``policy``.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils import checkpoint as _tc

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import log_dist, logger

_aten = torch.ops.aten
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
_DOTS = _NO_BATCH_DOTS + (_aten.bmm.default, _aten.baddbmm.default)

# the saved sets of the reference's policies: None = nothing saved (plain
# recompute), else the ops whose outputs are kept; "full" keeps everything
POLICIES: Dict[str, Optional[tuple]] = {
    "nothing_saveable": None,
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims": _NO_BATCH_DOTS,
    "full": "everything",
}


def _offload_refused():
    return not_ported("cpu_checkpointing and the 'offload' remat policy (the host tiers come "
                      "with zero3_offload, Queue 1 item 10)")


@dataclass
class CheckpointConfig:
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False  # the allocator owns layout; accepted
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "nothing_saveable"


_CONFIG = CheckpointConfig()
_CONFIGURED = False


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Reference: checkpointing.configure (checkpointing.py:789).

    Accepts either the kwargs or a config object with an
    ``activation_checkpointing`` block (TpuConfig works)."""
    global _CONFIG, _CONFIGURED
    block = {}
    if deepspeed_config is not None:
        block = getattr(deepspeed_config, "activation_checkpointing", None)
        if block is None and isinstance(deepspeed_config, dict):
            block = deepspeed_config.get("activation_checkpointing", {})
        if hasattr(block, "__dict__"):
            block = dict(block.__dict__)
        block = dict(block or {})
    cfg = CheckpointConfig(
        partition_activations=_pick(partition_activations, block, "partition_activations", False),
        cpu_checkpointing=_pick(checkpoint_in_cpu, block, "cpu_checkpointing", False),
        contiguous_memory_optimization=_pick(
            contiguous_checkpointing, block, "contiguous_memory_optimization", False
        ),
        number_checkpoints=_pick(num_checkpoints, block, "number_checkpoints", None),
        synchronize_checkpoint_boundary=_pick(synchronize, block, "synchronize_checkpoint_boundary", False),
        profile=_pick(profile, block, "profile", False),
        policy=block.get("policy", "nothing_saveable"),
    )
    if cfg.cpu_checkpointing or cfg.policy == "offload":
        raise _offload_refused()
    if cfg.policy not in POLICIES:
        raise ValueError(f"unknown activation checkpointing policy {cfg.policy!r}; "
                         f"one of {sorted(POLICIES)}")
    if cfg.partition_activations:
        _check_partition(comm.get_mesh() if comm.is_initialized() else None)
    _CONFIG = cfg
    _CONFIGURED = True
    if cfg.synchronize_checkpoint_boundary:
        logger.warning(
            "activation_checkpointing.synchronize_checkpoint_boundary is a "
            "no-op here (the recompute runs on the backward's own stream); "
            "remove it from the config"
        )
    if cfg.contiguous_memory_optimization:
        logger.warning(
            "activation_checkpointing.contiguous_memory_optimization is a "
            "no-op here (the caching allocator owns buffer layout); remove it "
            "from the config"
        )
    log_dist(
        f"activation checkpointing configured: policy={cfg.policy} "
        f"cpu={cfg.cpu_checkpointing} partition={cfg.partition_activations} "
        f"profile={cfg.profile}",
        ranks=[0],
    )


def _pick(arg, block, key, default):
    if arg is not None:
        return arg
    return block.get(key, default)


def is_configured() -> bool:
    return _CONFIGURED


def get_config() -> CheckpointConfig:
    return _CONFIG


def reset():
    """Reference: checkpointing.reset (clears stashed buffers; here, config)."""
    global _CONFIG, _CONFIGURED
    _CONFIG = CheckpointConfig()
    _CONFIGURED = False


def resolve_policy(name: Optional[str] = None, cpu_checkpointing: Optional[bool] = None):
    """A policy name (+ the cpu flag) -> its saved set: None (recompute
    everything), a tuple of ops whose outputs are kept, or
    ``"everything"``."""
    cpu = _CONFIG.cpu_checkpointing if cpu_checkpointing is None else cpu_checkpointing
    if cpu or name == "offload":
        raise _offload_refused()
    name = name or _CONFIG.policy
    if name not in POLICIES:
        raise ValueError(f"unknown activation checkpointing policy {name!r}; "
                         f"one of {sorted(POLICIES)}")
    return POLICIES[name]


def partition_activations_enabled() -> bool:
    return _CONFIG.partition_activations


def profile_enabled() -> bool:
    return _CONFIG.profile


def _check_partition(mesh):
    if mesh is None:
        return
    wide = {ax: mesh.shape.get(ax, 1) for ax in ("sequence", "tensor") if mesh.shape.get(ax, 1) > 1}
    if wide:
        raise not_ported(f"partition_activations over the mesh axes {wide} (Queue 1 item 10)")


def partition_saved_activation(x, mesh=None):
    """The layer-boundary activation for ``partition_activations``
    (reference checkpointing.py:366): returned unchanged, since it raises
    where the mesh has a ``tensor`` or ``sequence`` axis over 1 (the only
    case where the reference shards it)."""
    if not _CONFIG.partition_activations:
        return x
    if mesh is None and comm.is_initialized():
        mesh = comm.get_mesh()
    _check_partition(mesh)
    return x


def _selective_context(saved: tuple):
    def policy(ctx, op, *args, **kwargs):
        if op in saved:
            return _tc.CheckpointPolicy.MUST_SAVE
        return _tc.CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: _tc.create_selective_checkpoint_contexts(policy)


def checkpoint_wrapper(fn: Callable, policy: Optional[str] = None,
                       preserve_rng_state: bool = True) -> Callable:
    """Wrap ``fn`` so that the backward recomputes its activations under
    ``policy`` (default the configured one)."""
    saved = resolve_policy(policy)
    if saved == "everything":
        return fn
    kwargs = {} if saved is None else {"context_fn": _selective_context(saved)}

    def wrapped(*args):
        return _tc.checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=preserve_rng_state, **kwargs)

    return wrapped


def checkpoint(function: Callable, *args):
    """Reference API (checkpointing.py:708): run ``function(*args)`` under
    rematerialisation with the configured policy."""
    return checkpoint_wrapper(function)(*args)


# ---------------------------------------------------------------------------
# RNG tracking (reference CudaRNGStatesTracker :121): named generator
# streams; a fork hands out a generator seeded from the stream's next draw,
# so that forks are deterministic functions of the seed.
# ---------------------------------------------------------------------------

class RNGStatesTracker:
    def __init__(self):
        self._states: Dict[str, torch.Generator] = {}

    def reset(self):
        self._states.clear()

    def get_states(self):
        return {name: g.get_state() for name, g in self._states.items()}

    def set_states(self, states):
        for name, state in states.items():
            if name not in self._states:
                self._states[name] = torch.Generator()
            self._states[name].set_state(state)

    def add(self, name: str, seed: int):
        if name in self._states:
            raise Exception(f"rng state {name} already exists")
        self._states[name] = torch.Generator().manual_seed(int(seed))

    def fork(self, name: str = "model-parallel-rng", device=None) -> torch.Generator:
        """A fresh generator split off the named stream (on ``device``)."""
        if name not in self._states:
            raise Exception(f"rng state {name} not added")
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._states[name]))
        return torch.Generator(device=device or "cpu").manual_seed(seed)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


def model_parallel_seed(seed: int, tp_rank: int = 0):
    """Reference model_parallel_cuda_manual_seed: distinct dropout streams per
    TP rank (offset), shared default stream."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("default", seed)
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718 + tp_rank)
