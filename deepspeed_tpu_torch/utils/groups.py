"""Process-group registry as mesh-axis bookkeeping.

Counterpart of ``deepspeed_tpu/utils/groups.py`` (reference
``deepspeed/utils/groups.py``): a group is a tuple of named mesh axes, and
the comm facade's collectives take it as their ``group`` (the process group
of this rank's sub-mesh over those axes). Expert groups are checked against
the mesh's ``expert`` axis, as the reference checks them.
"""

from typing import Dict, Optional, Tuple

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils.logging import log_dist

_EXPERT_PARALLEL_GROUP: Dict[str, Tuple[str, ...]] = {}
_EXPERT_DATA_PARALLEL_GROUP: Dict[str, Tuple[str, ...]] = {}
_MAX_EP_SIZE: Optional[int] = None


def initialize(ep_size: int = 1, mpu=None):
    """Expert (and expert-data) groups for ``ep_size``-way expert
    parallelism: ``ep_size`` must be 1 or the mesh's expert width."""
    mesh = comm.get_mesh()
    expert_axis = mesh.shape.get("expert", 1)
    world = mesh.size
    if ep_size > world:
        raise ValueError(f"ep_size {ep_size} > world size {world}")
    if ep_size not in (1, expert_axis):
        raise ValueError(
            f"mesh expert axis is {expert_axis}; ep_size {ep_size} must match it "
            "(shape the mesh with {'expert': ep_size} to enable expert parallelism)")
    name = f"ep_size_{ep_size}"
    _EXPERT_PARALLEL_GROUP[name] = () if ep_size <= 1 else ("expert",)
    _EXPERT_DATA_PARALLEL_GROUP[name] = comm.batch_axes()
    global _MAX_EP_SIZE
    _MAX_EP_SIZE = max(_MAX_EP_SIZE or 1, ep_size)
    log_dist(f"expert groups ready: {name} -> axes {_EXPERT_PARALLEL_GROUP[name]}", ranks=[0])
    return _EXPERT_PARALLEL_GROUP[name]


def _default_name() -> str:
    if _MAX_EP_SIZE is None:
        raise KeyError("no expert groups initialized")
    return f"ep_size_{_MAX_EP_SIZE}"


def _get_expert_parallel_group(name: str = None) -> Tuple[str, ...]:
    name = name or _default_name()
    if name not in _EXPERT_PARALLEL_GROUP:
        raise KeyError(f"expert group {name} not initialized; call groups.initialize(ep_size)")
    return _EXPERT_PARALLEL_GROUP[name]


def _get_expert_data_parallel_group(name: str = None) -> Tuple[str, ...]:
    name = name or _default_name()
    if name not in _EXPERT_DATA_PARALLEL_GROUP:
        raise KeyError(f"expert-data group {name} not initialized")
    return _EXPERT_DATA_PARALLEL_GROUP[name]


def _get_data_parallel_group() -> Tuple[str, ...]:
    return comm.batch_axes()


def _get_model_parallel_group() -> Tuple[str, ...]:
    return ("tensor",)


def _get_sequence_parallel_group() -> Tuple[str, ...]:
    return ("sequence",)


def _get_expert_parallel_world_size(name: str = None) -> int:
    axes = _get_expert_parallel_group(name)
    return comm.get_world_size(axes) if axes else 1


def _get_expert_data_parallel_world_size(name: str = None) -> int:
    axes = _get_expert_data_parallel_group(name)
    return comm.get_world_size(axes) if axes else 1


def _get_data_parallel_world_size() -> int:
    return comm.dp_world_size()


def _get_model_parallel_world_size() -> int:
    return comm.get_world_size(("tensor",))


def _get_sequence_parallel_world_size() -> int:
    return comm.get_world_size(("sequence",))


def _get_data_parallel_rank() -> int:
    return comm.get_rank(comm.batch_axes())


def _get_model_parallel_rank() -> int:
    return comm.get_rank(("tensor",))


def _get_expert_parallel_rank(name: str = None) -> int:
    axes = _get_expert_parallel_group(name)
    return comm.get_rank(axes) if axes else 0


def _clear():
    global _MAX_EP_SIZE
    _EXPERT_PARALLEL_GROUP.clear()
    _EXPERT_DATA_PARALLEL_GROUP.clear()
    _MAX_EP_SIZE = None
