"""ZeRO as a sharding policy over the named mesh.

Counterpart of ``deepspeed_tpu/runtime/zero/sharding.py``: every array of
the train state gets a placement over the mesh's axes, and ZeRO's stages
say which of them carry the ``fsdp`` axis:

  stage 0: params, grads and optimizer state whole across the data axes
  stage 1: + the optimizer state (f32 masters, Adam's m and v) over ``fsdp``
  stage 2: + the gradient accumulators over ``fsdp``
  stage 3: + the model-dtype params over ``fsdp``

Tensor parallelism composes: params carry logical axis names
(``("embed", "mlp")``), rules map them onto mesh axes, and ZeRO shards a
remaining free dimension over ``fsdp``. The rules and the choice of that
dimension are the reference's, so a leaf is placed alike in both packages.

A placement is a :class:`PartitionSpec` of the port's own (one entry per
dim: None, an axis name or a tuple of names). Where the reference lets
GSPMD move the data, the port cuts a full tensor to this rank's block
(:func:`local_shard`) and gathers the blocks back (:func:`gather_shard`)
over the mesh's process groups.
"""

from typing import Optional, Sequence, Tuple

import numpy as np

# logical axis name -> mesh axis (or tuple of axes). None = replicated.
DEFAULT_LOGICAL_AXIS_RULES = (
    ("batch", ("data", "fsdp")),
    ("seq", "sequence"),
    ("vocab", "tensor"),
    ("embed", None),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("kv", None),
    ("qkv", "tensor"),
    ("expert", "expert"),
    ("layers", None),
    ("stage", "pipe"),
    ("norm", None),
)


class PartitionSpec(tuple):
    """Per-dimension placement: each entry None (whole), a mesh axis name or
    a tuple of names (the dim split over their product, row-major in the
    order given). Dims past the spec's length are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def logical_to_mesh_spec(logical_names: Optional[Sequence[Optional[str]]], rules=None) -> PartitionSpec:
    """Map a tuple of per-dimension logical names to a PartitionSpec."""
    if logical_names is None:
        return PartitionSpec()
    rules = dict(rules if rules is not None else DEFAULT_LOGICAL_AXIS_RULES)
    out = []
    used = set()
    for name in logical_names:
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t if a not in used)
        used.update(axes_t)
        if not axes_t:
            out.append(None)
        elif len(axes_t) == 1:
            out.append(axes_t[0])
        else:
            out.append(axes_t)
    return PartitionSpec(*out)


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_axes(spec):
    return {ax for entry in spec for ax in entry_axes(entry)}


def add_fsdp_axis(shape: Tuple[int, ...], spec: PartitionSpec, mesh_shape: dict,
                  min_shard_elems: int = 0) -> PartitionSpec:
    """Shard one free dimension of ``shape`` over the ``fsdp`` axis: the
    largest dim not already sharded whose size the fsdp width divides; else
    a TP-sharded dim whose per-shard size it divides (``(tensor, fsdp)``);
    else none. Leaves under ``min_shard_elems`` elements stay whole (the
    reference's ``stage3_param_persistence_threshold``)."""
    fsdp = mesh_shape.get("fsdp", 1)
    if fsdp <= 1:
        return spec
    if _spec_axes(spec) >= {"fsdp"}:
        return spec
    if int(np.prod(shape or (1,))) < max(min_shard_elems, fsdp):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def _factor(entry):
        return int(np.prod([mesh_shape[a] for a in entry_axes(entry)]))

    best_dim, best_size = -1, 0
    for d, size in enumerate(shape):
        if entries[d] is not None:
            continue
        if size % fsdp == 0 and size > best_size:
            best_dim, best_size = d, size
    if best_dim < 0:
        for d, size in enumerate(shape):
            entry = entries[d]
            if entry is None:
                continue
            if "fsdp" not in entry_axes(entry):
                if (size // _factor(entry)) % fsdp == 0:
                    entries[d] = entry_axes(entry) + ("fsdp",)
                    return PartitionSpec(*entries)
        return spec
    entries[best_dim] = "fsdp"
    return PartitionSpec(*entries)


class ShardingPolicy:
    """Placements for every component of the train state (the reference's
    ``ShardingPolicy``, over a mesh shape). ``logical_specs`` maps a leaf's
    key to its per-dim logical names; a leaf without them is plain fsdp."""

    def __init__(self, mesh_shape: dict, stage: int, logical_specs=None, rules=None,
                 min_shard_elems: int = 0):
        assert stage in (0, 1, 2, 3)
        self.mesh_shape = dict(getattr(mesh_shape, "shape", mesh_shape))
        self.stage = stage
        self.rules = rules if rules is not None else DEFAULT_LOGICAL_AXIS_RULES
        self.logical_specs = logical_specs
        self.min_shard_elems = min_shard_elems

    def _tp_spec(self, leaf_logical) -> PartitionSpec:
        return logical_to_mesh_spec(leaf_logical, self.rules)

    def param_spec(self, shape, leaf_logical=None) -> PartitionSpec:
        spec = self._tp_spec(leaf_logical)
        if self.stage >= 3:
            spec = add_fsdp_axis(tuple(shape), spec, self.mesh_shape, self.min_shard_elems)
        return spec

    def opt_spec(self, shape, leaf_logical=None) -> PartitionSpec:
        spec = self._tp_spec(leaf_logical)
        if self.stage >= 1:
            spec = add_fsdp_axis(tuple(shape), spec, self.mesh_shape, 0)
        return spec

    def grad_spec(self, shape, leaf_logical=None) -> PartitionSpec:
        spec = self._tp_spec(leaf_logical)
        if self.stage >= 2:
            spec = add_fsdp_axis(tuple(shape), spec, self.mesh_shape, 0)
        return spec

    def _tree_specs(self, shapes: dict, spec_fn):
        logical = self.logical_specs or {}
        return {k: spec_fn(shape, logical.get(k)) for k, shape in shapes.items()}

    def param_pspecs(self, shapes: dict):
        """{key: spec} for a flat {key: shape} dict."""
        return self._tree_specs(shapes, self.param_spec)

    def grad_pspecs(self, shapes: dict):
        return self._tree_specs(shapes, self.grad_spec)

    def opt_pspecs(self, shapes: dict):
        return self._tree_specs(shapes, self.opt_spec)

    def batch_spec(self) -> PartitionSpec:
        return PartitionSpec(("data", "fsdp"), "sequence")

    def replicated(self) -> PartitionSpec:
        return PartitionSpec()


# ---------------------------------------------------------------------------
# A spec on this rank: the block it holds, cut and gathered
# ---------------------------------------------------------------------------

def _entries(spec, ndim):
    return list(spec) + [None] * (ndim - len(spec))


def dim_block(size: int, entry, mesh_shape: dict, coords: dict):
    """(start, length) of this rank's block of a dim of ``size`` under one
    spec entry; raises where the entry's width does not divide the dim (as
    the reference's placement does)."""
    axes = entry_axes(entry)
    count = int(np.prod([mesh_shape[a] for a in axes])) if axes else 1
    if size % count:
        raise ValueError(f"a dimension of size {size} placed over {axes} must be divisible by "
                         f"{count}")
    index = 0
    for ax in axes:
        index = index * mesh_shape[ax] + coords[ax]
    n = size // count
    return index * n, n


def local_shape(shape, spec, mesh_shape: dict) -> Tuple[int, ...]:
    zero = {ax: 0 for ax in mesh_shape}
    return tuple(dim_block(s, e, mesh_shape, zero)[1] for s, e in zip(shape, _entries(spec, len(shape))))


def shard_slices(shape, spec, mesh) -> tuple:
    """The index of this rank's block of a tensor of ``shape``."""
    out = []
    for size, entry in zip(shape, _entries(spec, len(shape))):
        start, n = dim_block(size, entry, mesh.shape, mesh.coords)
        out.append(slice(start, start + n))
    return tuple(out)


def local_shard(full, spec, mesh):
    """This rank's block of the full tensor ``full`` (a copy of its own)."""
    return full[shard_slices(full.shape, spec, mesh)].clone()


def gather_shard(local, spec, mesh):
    """The full tensor from every rank's block: each sharded dim is gathered
    over its entry's axes, the innermost axis first (a block's index is
    row-major over the entry's axes)."""
    from deepspeed_tpu_torch import comm

    out = local
    for d, entry in enumerate(_entries(spec, local.dim())):
        for ax in reversed(entry_axes(entry)):
            if mesh.shape[ax] > 1:
                out = comm.all_gather(out, group=ax, axis=d, tiled=True)
    return out
