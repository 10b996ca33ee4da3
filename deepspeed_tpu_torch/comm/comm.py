"""Distributed communication facade: a named device mesh over
``torch.distributed`` process groups.

Counterpart of ``deepspeed_tpu/comm/comm.py``. The reference names its
groups by mesh axes and runs its collectives inside ``shard_map``; here one
process drives one device, the mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` with the reference's six named axes (``MESH_AXES``, ``tensor``
innermost), and a group handle (an axis name or a tuple of names) maps to
the process group of this rank's sub-mesh over those axes. The collectives
are top-level ``torch.distributed`` calls over such a group and keep the
reference's argument names; each returns a new tensor and leaves its input
as it was (``all_reduce_`` reduces in place, for a caller that owns the
buffer).

A rank's coordinates are ``np.unravel_index(rank, dims)``, the order in
which the reference's ``build_mesh`` reshapes its device list. A mesh
shape follows the reference's ``_normalize_mesh_shape`` with the world
size in place of the device count: ``-1`` absorbs the rest, and ``data``
does so by default.

No process group starts on its own: :func:`init_distributed` starts one
only when it is given an ``init_method`` (or finds one already started),
and a process without one is a world of one, whose collectives return
copies. CUDA tensors go over NCCL and CPU tensors over gloo: the backend
follows the device, unless ``init_distributed(dist_backend=...)`` names
one. On a gloo group every collective carries a CUDA tensor through the
host (ranks sharing one card: NCCL refuses two ranks on one GPU, and gloo
takes few collectives of CUDA tensors). ``ppermute`` (ring attention's exchange) raises until
sequence parallelism is ported.

Serving meshes are subsets of the world: :func:`subset_mesh` builds one
over the first ``prod(shape)`` ranks with its own process groups, without
touching the global mesh, and a collective names one of its axes by a
:class:`MeshAxes` handle. Every rank makes every group (``new_group`` is
collective over the world), so the world's rank 0 announces a new subset
mesh on the control channel (:func:`control_send`, a gloo group over the
world that carries the serving controller's host messages) before it
makes its groups; the other ranks make theirs when they read it.
"""

import datetime
import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import log_dist

# slowest-varying first, as the reference's (tensor innermost: neighbouring ranks)
MESH_AXES = ("pipe", "data", "fsdp", "expert", "sequence", "tensor")

ReduceOp = type("ReduceOp", (), {"SUM": "sum", "AVG": "avg", "MAX": "max", "MIN": "min",
                                 "PROD": "prod"})

# the names torch 2.13 gives the tensor collectives (older releases: the *_tensor ones)
_all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)

_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}



@dataclass(frozen=True)
class MeshAxes:
    """A group handle on a mesh other than the global one (a serving mesh,
    :func:`subset_mesh`): the sub-mesh of ``mesh`` over ``axes``."""

    mesh: "Mesh" = field(compare=False)
    axes: Tuple[str, ...] = ()


GroupLike = Union[None, str, Sequence[str], MeshAxes]


def _normalize_mesh_shape(mesh_shape: Optional[dict], n_devices: int) -> dict:
    """Fill in a full {axis: size} dict; -1 means 'absorb the remaining
    ranks' (the reference's rules, the world size as its device count)."""
    shape = dict(mesh_shape or {})
    if "data" not in shape and -1 not in shape.values():
        shape["data"] = -1
    for ax in MESH_AXES:
        shape.setdefault(ax, 1)
    unknown = set(shape) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"Unknown mesh axes {unknown}; valid axes: {MESH_AXES}")
    wildcards = [ax for ax, s in shape.items() if s == -1]
    if len(wildcards) > 1 and "data" in wildcards:
        shape["data"] = 1
        wildcards.remove("data")
    fixed = int(np.prod([s for s in shape.values() if s != -1]))
    if len(wildcards) > 1:
        raise ValueError("At most one mesh axis may be -1")
    if wildcards:
        if n_devices % fixed != 0:
            raise ValueError(f"device count {n_devices} not divisible by fixed mesh product {fixed}")
        shape[wildcards[0]] = n_devices // fixed
    total = int(np.prod(list(shape.values())))
    if total != n_devices:
        raise ValueError(f"mesh shape {shape} covers {total} devices but {n_devices} are available")
    return {ax: int(shape[ax]) for ax in MESH_AXES}


def rank_coords(rank: int, shape: dict) -> Dict[str, int]:
    """This rank's coordinate on each axis: ``np.unravel_index`` over the
    mesh's dims, as the reference's ``build_mesh`` reshapes its devices."""
    idx = np.unravel_index(rank, tuple(shape[ax] for ax in MESH_AXES))
    return {ax: int(i) for ax, i in zip(MESH_AXES, idx)}


def _canonical(axes) -> Tuple[str, ...]:
    return tuple(ax for ax in MESH_AXES if ax in axes)


@dataclass
class Mesh:
    """A named mesh over the world's ranks: its full ``shape``, this rank's
    ``rank`` and ``coords``, the torch ``device_mesh`` (None in a world of
    one without a process group) and the process group of this rank's
    sub-mesh for every set of axes larger than one (``groups``, keyed by the
    axes in mesh order)."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    device_mesh: object = None
    groups: Dict[Tuple[str, ...], object] = field(default_factory=dict)

    @property
    def coords(self) -> Dict[str, int]:
        return rank_coords(self.rank, self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes`` (in mesh order), or None when
        those axes hold one rank."""
        axes = tuple(ax for ax in _canonical(axes) if self.shape[ax] > 1)
        return self.groups.get(axes) if axes else None


def build_mesh(mesh_shape: Optional[dict] = None, world_size: int = 1, rank: int = 0,
               device=None) -> Mesh:
    """A :class:`Mesh` of ``world_size`` ranks without process groups: the
    shape and the coordinates, for placement arithmetic."""
    shape = _normalize_mesh_shape(dict(mesh_shape or {}), world_size)
    return Mesh(shape=shape, rank=rank, device=torch.device(device or "cpu"))


@dataclass
class CommState:
    mesh: Optional[Mesh] = None
    initialized: bool = False
    started_group: bool = False  # this module called init_process_group
    comms_logger: Optional[object] = None
    control: object = None  # the control channel's gloo group over the world
    subset_meshes: Dict[tuple, "Mesh"] = field(default_factory=dict)


_STATE = CommState()


def is_initialized() -> bool:
    return _STATE.initialized


def canonical_device(device) -> torch.device:
    """``device`` with its index (a bare ``"cuda"`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _make_groups(shape: dict, device_type: str):
    """The DeviceMesh and a process group for every set of axes larger than
    one. Every rank creates every group, in one order (``new_group`` is
    collective)."""
    from torch.distributed.device_mesh import init_device_mesh

    dims = tuple(shape[ax] for ax in MESH_AXES)
    device_mesh = init_device_mesh(device_type, dims, mesh_dim_names=MESH_AXES)
    big = [ax for ax in MESH_AXES if shape[ax] > 1]
    groups = {(ax,): device_mesh.get_group(ax) for ax in big}
    ranks = np.arange(int(np.prod(dims))).reshape(dims)
    rank = dist.get_rank()
    for n in range(2, len(big) + 1):
        for axes in itertools.combinations(big, n):
            keep = [MESH_AXES.index(ax) for ax in axes]
            rest = [i for i in range(len(MESH_AXES)) if i not in keep]
            blocks = ranks.transpose(rest + keep).reshape(-1, int(np.prod([dims[i] for i in keep])))
            for block in blocks:
                pg = dist.new_group([int(r) for r in block])
                if rank in block:
                    groups[axes] = pg
    return device_mesh, groups


def init_distributed(mesh_shape: Optional[dict] = None, device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     dist_backend: Optional[str] = None, timeout: Optional[datetime.timedelta] = None,
                     verbose: bool = True, enable_comms_logging: bool = False) -> Mesh:
    """Shape the mesh over the world's ranks (reference: ``init_distributed``).

    Starts the process group with ``init_method`` (e.g. ``file://...`` or
    ``tcp://localhost:<port>``), ``rank`` and ``world_size`` when given and
    none is running; the backend is NCCL for a CUDA device and gloo for
    ``device="cpu"``, unless ``dist_backend`` names one. Without a process
    group the world is this one process. Called again with a mesh shape, it
    reshapes the mesh over the same ranks. ``device`` defaults to the
    current CUDA device (raising without CUDA)."""
    from deepspeed_tpu_torch.accelerator import get_accelerator

    if _STATE.initialized and mesh_shape is None and init_method is None:
        return _STATE.mesh
    device = canonical_device(get_accelerator().resolve_device(device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized() and init_method is not None:
        kwargs = {"timeout": timeout} if timeout is not None else {}
        backend = dist_backend or _backend(device)
        if device.type == "cuda" and backend == "nccl":  # gloo takes no bound device
            kwargs["device_id"] = device
        dist.init_process_group(backend, init_method=init_method,
                                rank=0 if rank is None else rank,
                                world_size=1 if world_size is None else world_size, **kwargs)
        _STATE.started_group = True
    live = dist.is_initialized()
    world = dist.get_world_size() if live else 1
    my_rank = dist.get_rank() if live else 0
    shape = _normalize_mesh_shape(dict(mesh_shape or {}), world)
    device_mesh, groups = _make_groups(shape, device.type) if live else (None, {})
    _STATE.mesh = Mesh(shape=shape, rank=my_rank, device=device, device_mesh=device_mesh,
                       groups=groups)
    _STATE.initialized = True
    if enable_comms_logging:
        ensure_comms_logger()
    if verbose:
        backend = dist.get_backend() if live else "none"
        log_dist(f"Initialized mesh {shape} over {world} {backend} rank(s)", ranks=[0])
    return _STATE.mesh


def destroy():
    """Forget the mesh; end the process group if :func:`init_distributed`
    started it."""
    if _STATE.started_group and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.mesh = None
    _STATE.initialized = False
    _STATE.started_group = False
    _STATE.comms_logger = None
    _STATE.control = None
    _STATE.subset_meshes = {}


def get_mesh() -> Mesh:
    if not _STATE.initialized:
        raise RuntimeError("no mesh: call deepspeed_tpu_torch.comm.init_distributed(...) first")
    return _STATE.mesh


def set_mesh(mesh: Mesh):
    _STATE.mesh = mesh
    _STATE.initialized = True


def has_process_group() -> bool:
    return _STATE.initialized and dist.is_initialized()


def get_comms_logger():
    return _STATE.comms_logger


def ensure_comms_logger():
    if _STATE.comms_logger is None:
        from deepspeed_tpu_torch.comm.comms_logging import CommsLogger

        _STATE.comms_logger = CommsLogger()
    return _STATE.comms_logger


def _axes(group: GroupLike) -> Tuple[str, ...]:
    """Resolve a 'group' to mesh axis names. None = all axes (world)."""
    if group is None:
        return MESH_AXES
    if isinstance(group, MeshAxes):
        return group.axes
    if isinstance(group, str):
        return (group,)
    return tuple(group)


def _mesh_or_world() -> Mesh:
    return _STATE.mesh if _STATE.initialized else build_mesh()


def _mesh_of(group: GroupLike) -> Mesh:
    return group.mesh if isinstance(group, MeshAxes) else _mesh_or_world()


def get_world_size(group: GroupLike = None) -> int:
    mesh = _mesh_of(group)
    return int(np.prod([mesh.shape[ax] for ax in _axes(group)]))


def get_rank(group: GroupLike = None) -> int:
    """This rank's index in the world, or in ``group`` (row-major over the
    group's axes in the order given, as the reference's)."""
    mesh = _mesh_of(group)
    if group is None:
        return mesh.rank
    coords = mesh.coords
    rank = 0
    for ax in _axes(group):
        rank = rank * mesh.shape[ax] + coords[ax]
    return rank


def get_local_rank() -> int:
    """The index of this rank's card (0 on the CPU)."""
    device = _mesh_or_world().device
    return device.index if device.type == "cuda" else 0


def get_process_rank() -> int:
    return _mesh_or_world().rank  # one process per device


def get_process_count() -> int:
    return _mesh_or_world().size


def _group_of(group: GroupLike):
    """(process group or None, size) of a group handle. A group of one rank
    takes no process group, except in a world of one under a live process
    group, whose collectives then run on it (NCCL's or gloo's own copy)."""
    axes = _axes(group)
    size = get_world_size(group)
    if isinstance(group, MeshAxes):  # a subset mesh: its own groups; one rank reduces nothing
        return (group.mesh.group(axes) if size > 1 else None), size
    if size == 1:
        live_world_of_one = has_process_group() and dist.get_world_size() == 1
        return (dist.group.WORLD if live_world_of_one else None), 1
    mesh = get_mesh()
    if size == mesh.size:
        return dist.group.WORLD, size
    return mesh.group(axes), size


def barrier(group: GroupLike = None):
    """Block until every rank of the group reaches this point and this
    rank's queued device work has finished."""
    if has_process_group():
        pg, _ = _group_of(group)
        dist.barrier(group=pg)
    mesh = _mesh_or_world()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


# ---------------------------------------------------------------------------
# Collectives (reference: all_reduce, all_gather, reduce_scatter,
# all_to_all, ppermute, broadcast)
# ---------------------------------------------------------------------------

def _run(collective, out, src, pg):
    """``collective(out, src, pg)``, through host copies for a CUDA tensor on
    a gloo group (ranks sharing one card: gloo takes few collectives of CUDA
    tensors); NCCL and CPU tensors run as they are. ``out is src`` for an op
    in place."""
    if not (src.is_cuda and dist.get_backend(pg) == dist.Backend.GLOO):
        collective(out, src, pg)
        return
    host_src = src.cpu()
    host_out = host_src if out is src else torch.empty(out.shape, dtype=out.dtype)
    collective(host_out, host_src, pg)
    out.copy_(host_out)


def _log_op(name, tensor, group):
    if _STATE.comms_logger is not None:
        _STATE.comms_logger.append(name, tensor, _axes(group))


def all_reduce(tensor, op: str = ReduceOp.SUM, group: GroupLike = None):
    """The reduction of ``tensor`` over the group's ranks, on every rank."""
    return all_reduce_(tensor.clone(), op, group)


def all_reduce_(tensor, op: str = ReduceOp.SUM, group: GroupLike = None):
    """:func:`all_reduce` in place, for a caller that owns ``tensor``;
    returns it."""
    _log_op("all_reduce", tensor, group)
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    pg, size = _group_of(group)
    if pg is not None:
        _run(lambda out, _, g: dist.all_reduce(out, op=_TORCH_OPS[op], group=g), tensor, tensor, pg)
    if op == ReduceOp.AVG:
        tensor.div_(size)
    return tensor


def all_gather(tensor, group: GroupLike = None, axis: int = 0, tiled: bool = True):
    """Every rank's ``tensor`` in group-rank order: concatenated along
    ``axis`` (``tiled``) or stacked on a new ``axis``."""
    _log_op("all_gather", tensor, group)
    pg, size = _group_of(group)
    x = tensor.unsqueeze(axis) if not tiled else tensor
    axis = axis % x.dim()
    src = x.movedim(axis, 0).contiguous()
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    if pg is None:
        out.copy_(src)
    else:
        _run(lambda o, s, g: _all_gather_single(o, s, group=g), out, src, pg)
    return out.movedim(0, axis).contiguous()


def reduce_scatter(tensor, group: GroupLike = None, scatter_dimension: int = 0, tiled: bool = True):
    """The sum over the group of ``tensor``, this rank's block of it along
    ``scatter_dimension`` (``tiled``: size / n; else the dim, of size n,
    indexed away)."""
    _log_op("reduce_scatter", tensor, group)
    pg, size = _group_of(group)
    dim = scatter_dimension % tensor.dim()
    if tensor.shape[dim] % size:
        raise ValueError(f"dimension {dim} of size {tensor.shape[dim]} does not split {size} ways")
    src = tensor.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // size,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    if pg is None:
        out.copy_(src)
    else:
        _run(lambda o, s, g: _reduce_scatter_single(o, s, group=g), out, src, pg)
    out = out.movedim(0, dim).contiguous()
    return out if tiled else out.squeeze(dim)


def all_to_all(tensor, group: GroupLike = None, split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = True):
    """Block j of ``split_axis`` goes to group rank j; the blocks received
    are concatenated along ``concat_axis`` in group-rank order (``tiled``)
    or, untiled, the split dim (of size n) is indexed away and the received
    blocks are stacked on a new ``concat_axis``."""
    _log_op("all_to_all", tensor, group)
    axes = _axes(group)
    assert len(axes) == 1, "all_to_all runs over a single mesh axis"
    pg, size = _group_of(group)
    split_axis %= tensor.dim()
    if tensor.shape[split_axis] % size:
        raise ValueError(f"dimension {split_axis} of size {tensor.shape[split_axis]} does not split "
                         f"{size} ways")
    src = tensor.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(src)
    if pg is None:
        out.copy_(src)
    else:
        _run(lambda o, s, g: dist.all_to_all_single(o, s, group=g), out, src, pg)
    blocks = out.chunk(size, dim=0)  # block j came from rank j
    blocks = [b.movedim(0, split_axis) for b in blocks]
    if tiled:
        return torch.cat(blocks, dim=concat_axis % tensor.dim()).contiguous()
    blocks = [b.squeeze(split_axis) for b in blocks]
    return torch.stack(blocks, dim=concat_axis).contiguous()


def ppermute(tensor, perm, group: GroupLike = None):
    raise not_ported("ppermute (ring attention's exchange: sequence parallelism, Queue 1 item 10)")


def broadcast(tensor, src: int = 0, group: GroupLike = None):
    """Group rank ``src``'s ``tensor`` on every rank of the group."""
    _log_op("broadcast", tensor, group)
    pg, _ = _group_of(group)
    out = tensor.clone()
    if pg is not None:
        root = dist.get_global_rank(pg, src)
        _run(lambda o, _, g: dist.broadcast(o, src=root, group=g), out, out, pg)
    return out


def axis_index(group: GroupLike = None) -> int:
    return get_rank(_axes(group))


# ---------------------------------------------------------------------------
# Subset meshes and the control channel (the serving controller's)
# ---------------------------------------------------------------------------

def process_world() -> Tuple[int, int]:
    """(rank, size) of this process in the live process group's world, or
    (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def control_group():
    """The control channel's group: a gloo group over the whole world (the
    world's own group when its backend is gloo). Made once, collectively:
    every rank calls this before its first control message."""
    if _STATE.control is None:
        if dist.get_backend() == dist.Backend.GLOO:
            _STATE.control = dist.group.WORLD
        else:
            _STATE.control = dist.new_group(list(range(dist.get_world_size())), backend="gloo")
    return _STATE.control


def control_all(flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of the world: a vote over the
    control channel, which every rank must reach (a barrier too)."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=control_group())
    return bool(t.item())


def control_send(commands):
    """Broadcast a list of host commands from the world's rank 0 to every
    other rank (pickled, over the control group)."""
    dist.broadcast_object_list([commands], src=0, group=control_group())


def control_recv():
    """The next list of commands rank 0 sent with :func:`control_send`."""
    box = [None]
    dist.broadcast_object_list(box, src=0, group=control_group())
    return box[0]


def control_send_to(rank: int, obj):
    """Send one host object from the world's rank 0 to ``rank`` alone
    (pickled, over the control group)."""
    dist.send_object_list([obj], dst=rank, group=control_group())


def control_recv_own():
    """The object rank 0 sent this rank with :func:`control_send_to`."""
    box = [None]
    dist.recv_object_list(box, src=0, group=control_group())
    return box[0]


def subset_mesh(mesh_shape: dict, device=None) -> Mesh:
    """A :class:`Mesh` over the first ``prod(mesh_shape)`` ranks of the
    world (the shape normalized over that count), with a process group for
    every set of its axes larger than one, of the world's backend; the
    global mesh stays as it is. Made once a shape: the world's rank 0
    announces a new one on the control channel, then every rank makes its
    groups in one order (``new_group`` is collective over the world). A
    rank outside the subset makes its groups too and gets None."""
    n = int(np.prod([s for s in mesh_shape.values()] or [1]))
    shape = _normalize_mesh_shape(dict(mesh_shape), n)
    key = tuple(shape[ax] for ax in MESH_AXES)
    rank, world = process_world()
    device = torch.device(device or "cpu")
    if key not in _STATE.subset_meshes:
        groups = {}
        if world > 1 and n > 1:
            if rank == 0:
                control_send([("mesh", dict(mesh_shape))])
            dims = key
            ranks = np.arange(n).reshape(dims)
            big = [ax for ax in MESH_AXES if shape[ax] > 1]
            for k in range(1, len(big) + 1):
                for axes in itertools.combinations(big, k):
                    keep = [MESH_AXES.index(ax) for ax in axes]
                    rest = [i for i in range(len(MESH_AXES)) if i not in keep]
                    blocks = ranks.transpose(rest + keep).reshape(
                        -1, int(np.prod([dims[i] for i in keep])))
                    for block in blocks:
                        pg = dist.new_group([int(r) for r in block])
                        if rank in block:
                            groups[axes] = pg
        _STATE.subset_meshes[key] = (shape, groups)
    shape, groups = _STATE.subset_meshes[key]
    if rank >= n:
        return None
    return Mesh(shape=dict(shape), rank=rank, device=device, groups=groups)


# ---------------------------------------------------------------------------
# Batch helpers
# ---------------------------------------------------------------------------

def batch_axes() -> Tuple[str, ...]:
    """Mesh axes the global batch is split over (ZeRO's DP dimension)."""
    return ("data", "fsdp")


def dp_world_size() -> int:
    mesh = _mesh_or_world()
    return mesh.shape["data"] * mesh.shape["fsdp"]
