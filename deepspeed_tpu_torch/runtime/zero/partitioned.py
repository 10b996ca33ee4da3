"""The training state of one rank: its blocks of every leaf under ZeRO
stages 0-3 and tensor parallelism, or the whole state on one device.

The reference's engine (``deepspeed_tpu/runtime/engine.py:232-261``)
places each leaf of its train state with ``ShardingPolicy`` and lets GSPMD
move the data. Here the placements are the same, computed on the
reference's layout (``models/transformer.reference_shapes``: layers
stacked, weights ``x @ w``), and mapped once, at start-up, onto this
package's own layout, so that what a rank holds is what its forward reads:

  - a *part* is one leaf of the reference's layout, for one layer where it
    is stacked; a weight is the transpose of its block in this package's
    tree, and ``wq``/``wk``/``wv`` (``bq``/``bk``/``bv``) are row blocks of
    ``wqkv`` (``bqkv``), or under tensor parallelism leaves of their own
    (``wq`` split over ``tensor``, ``wk``/``wv`` whole, as the reference's
    rules keep them);
  - a *slot* is one leaf of the forward's tree and the parts it is made of.

Each component of a slot (the model-dtype params; the f32 masters, which
Adam's m and v follow; the f32 gradient accumulators) is held whole (this
rank's tensor-parallel block of the leaf, which the forward reads as it
is) where no part of it carries ``fsdp`` in that component, and otherwise
part by part, as the parts' ``fsdp`` blocks (a part whose placement splits
the stacked layers dim is held by one fsdp rank and by no other):

  - stage 1: the masters, m and v; the gradients are all-reduced over the
    data-parallel ranks at the step, in ``reduce_bucket_size`` buckets,
    and the updated blocks gathered back into the params;
  - stage 2: + the accumulators; each micro-step's gradient is
    reduce-scattered into them;
  - stage 3: + the params; a layer's weights are gathered just before its
    forward and dropped after it (saved-tensor hooks keep a handle in the
    graph, not the weights), gathered again in the backward, and their
    gradients reduce-scattered back.

At fsdp 1 and tensor 1 (one device, or data parallelism alone) every slot
is whole: the state is the single-device engine's trees (:attr:`tree`,
:attr:`master_tree`) and nothing is reduced that a group of one would
hold. At the step the gradients are divided by the loss scale, the
accumulation steps and the data-parallel width; the fp16 overflow flag and
the global norm are taken over every shard (a block that several ranks hold
counts once); Adam updates this rank's optimizer blocks. The loss of a
data-parallel rank is its share of the global batch's loss: its rows'
mean, or with a ``loss_mask`` its rows' masked sum over the global count
(the reference's ``_ce_from_logits`` normalises by the whole batch's
count).

MoE layers' experts (stacked over E, in the reference's layout) split over
the ``expert`` axis as their placements say: each expert rank holds its
E / ep experts, and the forward routes over the global batch
(``moe.sharded_moe.MoEGroups``). Their gradients sum over ``data`` and
``fsdp`` only, like every other leaf's; MoE with ``tensor`` over 1 raises.
Under remat a stage-3 layer is fetched inside its recomputed region, so
that the backward gathers it again.

Whole leaves, for checkpoints, snapshots and the fragment accessors:
:meth:`PartitionedState.full_leaf` assembles one leaf of this package's
tree from every rank's blocks of one component (collective: every rank
calls it, in one order, and gets the same tensor), and
:meth:`PartitionedState.set_leaf` cuts a whole leaf into this rank's blocks,
copied into the tensors the optimizer's lists and ``grad_acc`` alias. A
component is ``"param"``, ``"base"`` or ``"grad"``, or a list aligned with
the units of one of them (Adam's moments follow ``base``), such as a host
copy of this rank's units.
"""

import contextlib
import functools
import weakref
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.moe.sharded_moe import MoEGroups
from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel
from deepspeed_tpu_torch.runtime.zero.sharding import (
    PartitionSpec,
    ShardingPolicy,
    entry_axes,
    gather_shard,
    local_shard,
    shard_slices,
)
from deepspeed_tpu_torch.utils import not_ported

DP = ("data", "fsdp")


def _walk(tree, prefix=()):
    """(path, leaf) of a nested dict/list tree, in its own order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [x for k, v in items for x in _walk(v, prefix + (k,))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _port_tree(tree):
    """A tree built by :func:`_put` with the layers keyed by index -> this
    package's (the layers a list)."""
    if "layers" in tree:
        tree["layers"] = [tree["layers"][i] for i in range(len(tree["layers"]))]
    return tree


@dataclass
class Part:
    """One leaf of the reference's layout (``key``), for one ``layer`` where
    it is stacked, as this package holds it."""

    key: str
    layer: Optional[int]
    src: tuple                          # its leaf in this package's tree
    src_rows: Optional[Tuple[int, int]]  # (start, n) of its rows there; None: all of it
    dst: tuple                          # its leaf in the forward's tree
    transposed: bool
    tp_spec: PartitionSpec              # a layer's, in this package's orientation
    opt_spec: PartitionSpec
    fsdp_dim: Union[None, str, int]     # where opt_spec adds fsdp: None, "layers" or a dim
    owner: Optional[int]                # "layers": the fsdp rank that holds this layer
    param_sharded: bool
    grad_sharded: bool


def plan(cfg: tf.TransformerConfig, mesh_shape: dict, stage: int, threshold: int = 0):
    """The parts of ``cfg``'s params under ``mesh_shape`` at ZeRO ``stage``
    (``threshold``: stage 3's ``stage3_param_persistence_threshold``)."""
    shapes = dict(_walk(tf.reference_shapes(cfg)))
    logical = dict(_walk(tf.logical_specs(tf.reference_shapes(cfg), cfg)))
    policy = ShardingPolicy(mesh_shape, stage, min_shard_elems=threshold if stage >= 3 else 0)
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    qkv_rows = {"q": (0, nh * hd), "k": (nh * hd, nkv * hd), "v": ((nh + nkv) * hd, nkv * hd)}
    unfused = mesh_shape.get("tensor", 1) > 1
    fsdp = mesh_shape.get("fsdp", 1)
    parts = []
    for path, shape in shapes.items():
        names, n = logical[path], len(shape)

        def full(spec):
            return list(spec) + [None] * (n - len(spec))

        tp = full(policy._tp_spec(names))
        opt = full(policy.opt_spec(shape, names))
        param_sharded = full(policy.param_spec(shape, names)) != tp
        grad_sharded = full(policy.grad_spec(shape, names)) != tp
        stacked = path[0] == "layers"
        transposed = (tf.is_transposed(path[1], path[2], n - 1) if stacked
                      else path == ("lm_head", "w"))
        diff = [d for d in range(n) if tp[d] != opt[d]]
        per_layer = 1 if stacked else 0

        def orient(entries):
            entries = entries[per_layer:]
            return PartitionSpec(*(entries[::-1] if transposed else entries))

        if not diff:
            fsdp_dim = None
        elif stacked and diff[0] == 0:
            fsdp_dim = "layers"
        else:
            d = diff[0] - per_layer
            fsdp_dim = (n - per_layer - 1 - d) if transposed else d
        layer_spec = orient(tp)
        for i in (range(shape[0]) if stacked else [None]):
            src, rows = path, None
            if stacked:
                group, name = path[1], path[2]
                src = ("layers", i, group, name)
                if group == "attn" and name[0] in "wb" and name[1:] in qkv_rows:
                    src, rows = ("layers", i, "attn", name[0] + "qkv"), qkv_rows[name[1:]]
            dst = ("layers", i, path[1], path[2]) if stacked and unfused else src
            parts.append(Part(
                key=".".join(path), layer=i, src=src, src_rows=rows, dst=dst,
                transposed=transposed, tp_spec=layer_spec,
                opt_spec=layer_spec if fsdp_dim == "layers" else orient(opt),
                fsdp_dim=fsdp_dim,
                owner=i // (shape[0] // fsdp) if fsdp_dim == "layers" else None,
                param_sharded=param_sharded, grad_sharded=grad_sharded))
    return parts


@dataclass
class Slot:
    """One leaf of the forward's tree (``path``) and its parts. Each
    component (``param``, ``base``: what the optimizer updates, ``grad``)
    is one tensor (this rank's whole block of the leaf) or a list, one
    entry a part (its block, or None where another rank holds it)."""

    path: tuple
    parts: List[Part]
    tp_shapes: List[tuple]  # each part's tensor-parallel block
    param: object = None
    base: object = None
    grad: object = None
    counted: List[bool] = field(default_factory=list)  # per unit of ``base``

    def view(self, what: str, j: int):
        """Part ``j`` of component ``what`` (a row view of a whole one)."""
        return self.part_of(getattr(self, what), j)

    def part_of(self, value, j: int):
        """Part ``j`` of ``value``, a component as this slot holds it."""
        if not torch.is_tensor(value):
            return None if value[j] is None else value[j].detach()
        value = value.detach()
        if len(self.parts) == 1:
            return value
        return value.narrow(0, *self.parts[j].src_rows)

    def units(self, what: str):
        """The component's tensors that this rank holds."""
        t = getattr(self, what)
        return [t] if torch.is_tensor(t) else [x for x in t if x is not None]


def _buckets(tensors, limit):
    """``tensors`` in order, cut into runs of at most ``limit`` elements
    (a larger tensor is a run of its own)."""
    run, n = [], 0
    for t in tensors:
        if run and n + t.numel() > limit:
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


class _FsdpGather(torch.autograd.Function):
    """A stage-3 block gathered over ``fsdp`` along ``dim``; the backward
    reduce-scatters the gradient back into the block."""

    @staticmethod
    def forward(ctx, block, dim):
        ctx.dim = dim
        return comm.all_gather(block, "fsdp", axis=dim)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter(g.contiguous(), "fsdp", scatter_dimension=ctx.dim), None


class _FsdpBroadcast(torch.autograd.Function):
    """A stage-3 layer that one fsdp rank holds whole, sent to the others;
    the backward sums the gradient onto the owner. Every rank passes a
    tensor that needs a gradient (an empty one where it holds no block), so
    that every rank's backward reaches the collective."""

    @staticmethod
    def forward(ctx, block, src, shape, dtype, mine):
        ctx.mine = mine
        buf = block if mine else torch.empty(shape, dtype=dtype, device=block.device)
        return comm.broadcast(buf, src, "fsdp")

    @staticmethod
    def backward(ctx, g):
        total = comm.all_reduce(g.contiguous(), comm.ReduceOp.SUM, "fsdp")
        return (total if ctx.mine else g.new_zeros((0,))), None, None, None, None


class _Regather:
    """Saved-tensor hooks for stage 3: a tensor that autograd saves and
    that shares storage with a registered (gathered) weight is kept as a
    handle, and the backward gathers its unit again (one unit cached at a
    time: the backward walks the layers in reverse)."""

    def __init__(self, fetch):
        self.fetch = fetch
        self.live = []  # (weakref, storage pointer, unit, path)
        self.cached_unit, self.cached = None, None

    def register(self, unit, leaves):
        self.live = [e for e in self.live if e[0]() is not None]
        for path, t in leaves:
            if t.numel():
                self.live.append((weakref.ref(t), t.untyped_storage().data_ptr(), unit, path))

    def pack(self, t):
        if t.numel() and not t.is_sparse:
            ptr = t.untyped_storage().data_ptr()
            for ref, p, unit, path in self.live:
                if p == ptr and ref() is not None:
                    return (unit, path, tuple(t.size()), t.stride(), t.storage_offset())
        return t

    def unpack(self, x):
        if not isinstance(x, tuple):
            return x
        unit, path, size, stride, offset = x
        if self.cached_unit != unit:
            self.cached = None
            with torch.no_grad():
                self.cached = dict(_walk(self.fetch(unit, register=False)))
            self.cached_unit = unit
        return self.cached[path].as_strided(size, stride, offset)

    def drop_cache(self):
        self.cached_unit, self.cached = None, None


class PartitionedState:
    """One rank's share of the train state of a ``TransformerModel`` under
    ``mesh`` at ZeRO ``stage`` (see the module docstring), made from
    ``master``: this package's tree of the full f32 params, on the host or
    on the device, which it empties leaf by leaf as it cuts them."""

    def __init__(self, cfg: tf.TransformerConfig, mesh, stage: int, master,
                 model_dtype: torch.dtype, persistence_threshold: int = 0,
                 bucket_elems: int = 500_000_000, device=None):
        self.cfg, self.mesh, self.stage = cfg, mesh, stage
        self.bucket_elems = int(bucket_elems)
        self.device = torch.device(device) if device is not None else mesh.device
        self.model_dtype = model_dtype
        self.mixed = model_dtype != torch.float32
        tensor = mesh.shape["tensor"]
        self.tp = TensorParallel(tensor, mesh.coords["tensor"]) if tensor > 1 else None
        self.dp = mesh.shape["data"] * mesh.shape["fsdp"]
        self.fsdp, self.fsdp_rank = mesh.shape["fsdp"], mesh.coords["fsdp"]
        self.dp_rank = comm.get_rank(DP) if self.dp > 1 else 0
        if cfg.moe_num_experts > 0 and tensor > 1:
            raise not_ported("MoE layers with tensor parallelism (Queue 1 item 10)")
        self.moe = MoEGroups.of_mesh(mesh) if cfg.moe_num_experts > 0 else None
        self.parts = plan(cfg, mesh.shape, stage, persistence_threshold)
        self.split = self.tp is not None or any(p.fsdp_dim is not None for p in self.parts)

        by_src = {}
        for p in self.parts:
            by_src.setdefault(p.src, {}).setdefault(p.dst, []).append(p)
        self.slots: List[Slot] = []
        # this package's leaves, in the order of its trees, and their shapes
        self.leaf_paths = [path for path, _ in _walk(master)]
        self.leaf_shapes = {path: tuple(t.shape) for path, t in _walk(master)}
        with torch.no_grad():
            for path in self.leaf_paths:
                full = _get(master, path)
                _get(master, path[:-1])[path[-1]] = None  # the caller's tree lets it go
                for dst, parts in by_src[path].items():
                    self.slots.append(self._slot(dst, parts, full))
                del full
        self.stage3_gather = any(not torch.is_tensor(s.param) for s in self.slots)
        self._units = {}
        for s in self.slots:
            self._units.setdefault("outer" if s.path[0] != "layers" else s.path[1], []).append(s)
        self.tree = None if self.stage3_gather else self._tree("param")
        self.master_tree = (self._tree("base") if self.mixed
                            and all(torch.is_tensor(s.base) for s in self.slots) else None)
        self.param_units = [u for s in self.slots for u in s.units("param")]
        self.base = [u for s in self.slots for u in s.units("base")]
        self.grad_acc = [u for s in self.slots for u in s.units("grad")]
        # where each slot's units start in those lists, and each leaf's parts
        self._start = {what: {} for what in ("param", "base", "grad")}
        for what in self._start:
            n = 0
            for i, s in enumerate(self.slots):
                self._start[what][i] = n
                n += len(s.units(what))
        self._parts_of = {}
        for i, s in enumerate(self.slots):
            for j, p in enumerate(s.parts):
                self._parts_of.setdefault(p.src, []).append((i, j))
        for parts in self._parts_of.values():  # row blocks of a fused leaf in row order
            parts.sort(key=lambda ij: (self.slots[ij[0]].parts[ij[1]].src_rows or (0, 0))[0])
        self.opt_grads = [u for s in self.slots for u in self._opt_grads(s)]
        self.counted = [c for s in self.slots for c in s.counted]
        self._hooks = _Regather(self.fetch) if self.stage3_gather else None

    # ------------------------------------------------------------------
    # start-up: a slot's components from the full leaf
    # ------------------------------------------------------------------
    def _whole(self, spec) -> bool:
        return all(self.mesh.shape[ax] == 1 for e in spec for ax in entry_axes(e))

    def _block(self, p: Part, t):
        """Part ``p``'s fsdp block of its tensor-parallel block ``t`` (a
        view), or None where another fsdp rank holds it."""
        if p.fsdp_dim is None:
            return t
        if p.fsdp_dim == "layers":
            return t if p.owner == self.fsdp_rank else None
        return t.chunk(self.fsdp, dim=p.fsdp_dim)[self.fsdp_rank]

    def _own(self, t, dtype):
        """``t`` on the device in ``dtype``, contiguous and of its own."""
        if t is None:
            return None
        out = t.to(self.device, dtype)
        if out is t or not out.is_contiguous():
            out = out.clone(memory_format=torch.contiguous_format)
        return out

    def _counts(self, p: Part, sharded: bool) -> bool:
        """Whether this rank counts a block of ``p`` in the global norm: it
        is the first of the ranks that hold the same block."""
        used = {ax for e in (p.opt_spec if sharded else p.tp_spec) for ax in entry_axes(e)}
        if sharded and p.fsdp_dim == "layers":
            used.add("fsdp")
        return all(self.mesh.coords[ax] == 0 for ax, n in self.mesh.shape.items()
                   if n > 1 and ax not in used)

    def _slot(self, dst, parts, full) -> Slot:
        pieces = []
        for p in parts:
            x = full if p.src_rows is None else full.narrow(0, *p.src_rows)
            pieces.append(x if self._whole(p.tp_spec) else local_shard(x, p.tp_spec, self.mesh))
        whole = full if len(parts) > 1 else pieces[0]  # fused parts are never tensor-split
        if whole._base is not None:  # a row view of the leaf: a tensor of its own
            whole = whole.clone()
        s = Slot(dst, parts, [tuple(t.shape) for t in pieces])
        f32, dt = torch.float32, self.model_dtype
        if not any(p.param_sharded for p in parts):
            s.param = whole.to(self.device, dt).requires_grad_(True)
        else:
            s.param = [None if b is None else self._own(b, dt).requires_grad_(True)
                       for b in (self._block(p, t) if p.param_sharded else t
                                 for p, t in zip(parts, pieces))]
        opt_whole = not any(p.fsdp_dim is not None for p in parts)
        if self.mixed:
            s.base = (whole.to(self.device, f32) if opt_whole else
                      [self._own(self._block(p, t), f32) for p, t in zip(parts, pieces)])
        elif opt_whole:
            s.base = s.param
        else:  # f32: the optimizer's blocks are the params' own
            s.base = [s.view("param", j) if p.param_sharded else self._block(p, s.view("param", j))
                      for j, p in enumerate(parts)]
        if not any(p.grad_sharded for p in parts):
            s.grad = torch.zeros(whole.shape, dtype=f32, device=self.device)
        else:
            s.grad = [None if b is None else torch.zeros(b.shape, dtype=f32, device=self.device)
                      for b in (self._block(p, t) if p.grad_sharded else t
                                for p, t in zip(parts, pieces))]
        if opt_whole:
            s.counted = [self._counts(parts[0], False)]
        else:
            s.counted = [self._counts(p, p.fsdp_dim is not None)
                         for p, b in zip(parts, s.base) if b is not None]
        return s

    def _opt_grads(self, s: Slot):
        """The slot's accumulators as the optimizer reads them (views in
        its layout, aligned with ``s.units("base")``)."""
        if torch.is_tensor(s.base) or not torch.is_tensor(s.grad):
            return s.units("grad")
        blocks = [self._block(p, s.view("grad", j)) for j, p in enumerate(s.parts)]
        return [b for b in blocks if b is not None]

    def _tree(self, what: str):
        tree = {}
        for s in self.slots:
            _put(tree, s.path, getattr(s, what))
        return _port_tree(tree)

    # ------------------------------------------------------------------
    # placements, as the reference's addressable shards see them
    # ------------------------------------------------------------------
    def shard_shapes(self, what: str) -> dict:
        """{key: this rank's block shape in the reference's layout} for
        ``"params"``, ``"master"``, ``"grad_acc"`` or ``"opt"`` (m and v)."""
        comp = {"params": "param", "master": "base", "grad_acc": "grad", "opt": "base"}[what]
        out = {}
        for s in self.slots:
            for j, p in enumerate(s.parts):
                t = s.view(comp, j)
                if t is None:
                    continue
                shape = tuple(t.shape)[::-1] if p.transposed else tuple(t.shape)
                if p.layer is None:
                    out[p.key] = shape
                else:
                    held = out.get(p.key, (0,) + shape)[0]
                    out[p.key] = (held + 1,) + shape
        return out

    # ------------------------------------------------------------------
    # the forward's weights
    # ------------------------------------------------------------------
    def _gathered(self, s: Slot, j: int):
        """Part ``j``'s tensor-parallel block, gathered over fsdp at stage 3
        (differentiable in the stored block)."""
        p, block = s.parts[j], s.param[j]
        if not p.param_sharded:
            return block
        if p.fsdp_dim == "layers":
            mine = p.owner == self.fsdp_rank
            arg = block if mine else torch.zeros((0,), dtype=self.model_dtype,
                                                 device=self.device, requires_grad=True)
            return _FsdpBroadcast.apply(arg, p.owner, s.tp_shapes[j], self.model_dtype, mine)
        return _FsdpGather.apply(block, p.fsdp_dim)

    def fetch(self, unit, register=True):
        """The forward's weights of ``unit`` (``"outer"`` or a layer index),
        gathered where they are sharded; differentiable in what is
        stored."""
        tree, fresh = {}, []
        for s in self._units[unit]:
            if torch.is_tensor(s.param):
                leaf = s.param
            else:
                got = [self._gathered(s, j) for j in range(len(s.parts))]
                leaf = got[0] if len(got) == 1 else torch.cat(got)
                fresh.append((s.path[2:] if unit != "outer" else s.path, leaf))
            _put(tree, s.path[2:] if unit != "outer" else s.path, leaf)
        if register and self._hooks is not None:
            self._hooks.register(unit, fresh)
        return tree

    # ------------------------------------------------------------------
    # micro-step
    # ------------------------------------------------------------------
    def local_batch(self, batch: dict, micro: int) -> dict:
        """This rank's rows: the batch as given when it holds ``micro`` rows
        (or without data parallelism), its block in mesh order when it holds
        the global batch (the reference's ``_shard_batch`` takes either
        feed). Tensor ranks of one data-parallel index take the same rows."""
        if self.dp == 1:
            return batch
        out = {}
        for k, x in batch.items():
            if x.dim() == 0:
                out[k] = x
                continue
            rows = x.shape[0]
            if rows == micro:
                out[k] = x
            elif rows == micro * self.dp:
                out[k] = x[self.dp_rank * micro:(self.dp_rank + 1) * micro]
            else:
                raise ValueError(f"batch leaf {k!r} has {rows} rows: expected this rank's "
                                 f"{micro} or the global batch of {micro * self.dp}")
        return out

    def loss(self, batch: dict):
        """This rank's loss (its share of the global batch's: the mean over
        the data-parallel ranks of these is the reference's loss), with its
        graph."""
        denom = None
        mask = batch.get("loss_mask")
        if mask is not None and self.dp > 1:
            n = batch["input_ids"].shape[1] - (0 if "labels" in batch else 1)
            count = comm.all_reduce(mask[..., :n].float().sum(), comm.ReduceOp.SUM, DP)
            denom = torch.clamp(count, min=1.0) / self.dp
        if self.tree is not None:
            params = self.tree
        else:
            # each layer fetched as the forward reaches it (inside its
            # recomputed region under remat, so that the backward gathers
            # it again)
            params = dict(self.fetch("outer"),
                          layers=[functools.partial(self.fetch, i)
                                  for i in range(self.cfg.num_layers)])
        hooks = (torch.autograd.graph.saved_tensors_hooks(self._hooks.pack, self._hooks.unpack)
                 if self._hooks is not None else contextlib.nullcontext())
        with hooks:
            return tf.loss_fn(params, self.cfg, batch, tp=self.tp, denom=denom, moe=self.moe)

    def global_loss(self, loss):
        """The reference's loss: the mean of the ranks' shares."""
        return comm.all_reduce(loss.detach(), comm.ReduceOp.AVG, DP)

    @torch.no_grad()
    def accumulate(self, predivide: float):
        """Move each param's gradient into the accumulators, reduce-scattered
        over fsdp where the accumulator is a block and the param is not."""
        accs, grads, by_key = [], [], {}
        for s in self.slots:
            if torch.is_tensor(s.grad):  # the param is whole too
                if s.param.grad is not None:
                    accs.append(s.grad)
                    grads.append(s.param.grad)
                    s.param.grad = None
                continue
            whole = torch.is_tensor(s.param)
            g_whole = s.param.grad if whole else None
            for j, p in enumerate(s.parts):
                if whole:
                    g = (g_whole.narrow(0, *p.src_rows) if len(s.parts) > 1 and g_whole is not None
                         else g_whole)
                    g = torch.zeros(s.tp_shapes[j], device=self.device) if g is None else g
                else:
                    t = s.param[j]
                    if t is None:
                        continue
                    g = torch.zeros(t.shape, device=self.device) if t.grad is None else t.grad
                if p.grad_sharded and not p.param_sharded:
                    if p.fsdp_dim == "layers":
                        by_key.setdefault(p.key, []).append((s, j, g))
                        continue
                    g = comm.reduce_scatter(g.float().contiguous(), "fsdp",
                                            scatter_dimension=p.fsdp_dim)
                accs.append(s.grad[j])
                grads.append(g)
            if whole:
                s.param.grad = None
            else:
                for t in s.param:
                    if t is not None:
                        t.grad = None
        for items in by_key.values():  # a leaf split over its layers: each to its owner
            mine = comm.reduce_scatter(torch.stack([g.float() for _, _, g in items]), "fsdp",
                                       scatter_dimension=0)
            held = [(s, j) for s, j, _ in items if s.parts[j].owner == self.fsdp_rank]
            for (s, j), g in zip(held, mine):
                accs.append(s.grad[j])
                grads.append(g)
        if accs:
            torch._foreach_add_(accs, grads if predivide == 1.0
                                else [g.float() / predivide for g in grads])
        if self._hooks is not None:
            self._hooks.drop_cache()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def reduce_grads(self):
        """Sum the accumulators over the data-parallel ranks (those whole
        over fsdp) or over ``data`` (the blocks), in place, in flat buckets
        of at most ``reduce_bucket_size`` elements; a group of one rank is
        skipped. Returns the gradients in the optimizer's layout."""
        by_axes = {}
        for s in self.slots:
            if torch.is_tensor(s.grad):
                by_axes.setdefault(DP, []).append(s.grad)
                continue
            for p, a in zip(s.parts, s.grad):
                if a is not None:
                    by_axes.setdefault(("data",) if p.grad_sharded else DP, []).append(a)
        for axes, accs in by_axes.items():
            if comm.get_world_size(axes) == 1:
                continue
            for bucket in _buckets(accs, self.bucket_elems):
                flat = comm.all_reduce_(torch.cat([a.reshape(-1) for a in bucket]),
                                        comm.ReduceOp.SUM, axes)
                torch._foreach_copy_(bucket, [v.view_as(a) for v, a in zip(
                    flat.split([a.numel() for a in bucket]), bucket)])
        return self.opt_grads

    def overflow_and_norm(self, grads, with_overflow: bool):
        """(overflow flag, global norm) over every block, each block counted
        once; the flag (fp16's) only ``with_overflow``, else False."""
        counted = [g for g, c in zip(grads, self.counted) if c]
        gnorm = (torch.linalg.vector_norm(torch.stack(torch._foreach_norm(counted))) if counted
                 else torch.zeros((), device=self.device))
        if with_overflow:
            overflow = (~torch.stack([torch.isfinite(g).all() for g in grads]).all() if grads
                        else torch.zeros((), dtype=torch.bool, device=self.device))
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if comm.get_world_size() > 1:
            gnorm = comm.all_reduce(gnorm.square(), comm.ReduceOp.SUM).sqrt()
            if with_overflow:
                overflow = comm.all_reduce(overflow.float(), comm.ReduceOp.MAX) > 0
        return overflow, gnorm

    def _gather_fsdp(self, s: Slot, j: int, block, dtype):
        """Part ``j``'s tensor-parallel block from its fsdp blocks (on the
        device, in ``dtype``; ``block`` is None where another fsdp rank
        holds the part)."""
        p = s.parts[j]
        if p.fsdp_dim == "layers":
            mine = p.owner == self.fsdp_rank
            buf = (block.to(self.device, dtype) if mine else
                   torch.empty(s.tp_shapes[j], dtype=dtype, device=self.device))
            return comm.broadcast(buf, p.owner, "fsdp")
        return comm.all_gather(block.to(self.device, dtype).contiguous(), "fsdp", axis=p.fsdp_dim)

    @torch.no_grad()
    def write_back(self):
        """The updated optimizer blocks into the model-dtype params,
        gathered over fsdp where the params' placement is whole."""
        dst, src = [], []
        for s in self.slots:
            if torch.is_tensor(s.base):  # the param is whole too
                if self.mixed:
                    dst.append(s.param.detach())
                    src.append(s.base)
                continue
            for j, p in enumerate(s.parts):
                target, block = s.view("param", j), s.base[j]
                if target is None:
                    continue
                if p.fsdp_dim is not None and not p.param_sharded:
                    dst.append(target)
                    src.append(self._gather_fsdp(s, j, block, self.model_dtype))
                elif self.mixed:
                    dst.append(target)
                    src.append(block)
        if dst:
            torch._foreach_copy_(dst, src)

    def zero_grads(self):
        torch._foreach_zero_(self.grad_acc)

    def gathered_params(self):
        """The full model-dtype params in this package's layout (every
        rank's blocks gathered, in tensors of their own), for comparisons
        and export."""
        return self.leaf_tree(lambda path: self.full_leaf(path, "param").clone())

    # ------------------------------------------------------------------
    # whole leaves (checkpoints, snapshots, the fragment accessors)
    # ------------------------------------------------------------------
    def leaf_tree(self, fn):
        """This package's param tree with ``fn(path)`` at each leaf."""
        tree = {}
        for path in self.leaf_paths:
            _put(tree, path, fn(path))
        return _port_tree(tree)

    def path_of(self, name) -> Optional[tuple]:
        """The leaf path of a dotted name (``"layers.0.attn.wqkv"``) or a
        list of keys, or None where the tree has no such leaf."""
        keys = ([str(k) for k in name] if isinstance(name, (list, tuple)) else
                [k for k in str(name).replace("]", "").replace("[", ".").split(".") if k])
        path = tuple(int(k) if k.isdigit() else k for k in keys)
        return path if path in self.leaf_shapes else None

    def _value(self, i: int, what, flat=None):
        """Slot ``i``'s component ``what`` as the slot holds it (a tensor,
        or a list with None where another rank holds the part); ``flat``, a
        list aligned with the units of ``what``, is read in its place."""
        own = getattr(self.slots[i], what)
        if flat is None:
            return own
        start = self._start[what][i]
        if torch.is_tensor(own):
            return flat[start]
        it = iter(flat[start:])
        return [None if b is None else next(it) for b in own]

    @staticmethod
    def _split(p: Part, what: str, value) -> bool:
        """Whether ``value`` holds part ``p`` as its fsdp block."""
        if torch.is_tensor(value):
            return False
        return {"param": p.param_sharded, "grad": p.grad_sharded}.get(what, p.fsdp_dim is not None)

    def _sum_axes(self, p: Part, value) -> tuple:
        """The axes over which the step sums an accumulator of part ``p``
        held in ``value`` (:meth:`reduce_grads`). A rank's loss is its share
        of the global loss, a data-parallel width's worth of it, so these
        ranks' accumulators sum to ``dp`` times the gradient that one
        device's accumulator would hold."""
        return ("data",) if not torch.is_tensor(value) and p.grad_sharded else DP

    @torch.no_grad()
    def full_leaf(self, path, what: str, flat=None):
        """Leaf ``path`` of component ``what`` (or of ``flat``, aligned with
        its units), whole, in this package's layout, from every rank's
        blocks (the accumulators summed as the step sums them, over
        ``dp``): on the device where a block was gathered or summed (it may
        alias this rank's own tensors where nothing was). Collective over
        the mesh."""
        rows = []
        dtype = self.model_dtype if what == "param" else torch.float32
        for i, j in self._parts_of[path]:
            s = self.slots[i]
            p = s.parts[j]
            value = self._value(i, what, flat)
            block = s.part_of(value, j)
            if self._split(p, what, value):
                block = self._gather_fsdp(s, j, block, dtype)
            elif not self._whole(p.tp_spec):
                block = block.to(self.device)
            if what == "grad" and self.dp > 1:
                if comm.get_world_size(self._sum_axes(p, value)) > 1:
                    block = comm.all_reduce(block.to(self.device), comm.ReduceOp.SUM,
                                            self._sum_axes(p, value))
                block = block / self.dp
            rows.append(gather_shard(block, p.tp_spec, self.mesh))
        return rows[0] if len(rows) == 1 else torch.cat([r.to(rows[0].device) for r in rows])

    @torch.no_grad()
    def set_leaf(self, path, what: str, full, flat=None):
        """Copy the whole leaf ``full`` (this package's layout, on any
        device) into this rank's blocks of component ``what`` (or of
        ``flat``), in place. Each rank cuts its own: a block that several
        ranks hold is copied by each, except an accumulator's: the first
        rank of the axes the step sums over takes ``dp`` times it and the
        others zero, so that the step's sum divided by ``dp`` is the
        whole (exactly, for a power of two)."""
        for i, j in self._parts_of[path]:
            s = self.slots[i]
            p = s.parts[j]
            value = self._value(i, what, flat)
            dst = s.part_of(value, j)
            if dst is None:
                continue
            if what == "grad" and any(self.mesh.coords[ax] for ax in self._sum_axes(p, value)):
                dst.zero_()
                continue
            x = full if p.src_rows is None else full.narrow(0, *p.src_rows)
            if not self._whole(p.tp_spec):
                x = x[shard_slices(x.shape, p.tp_spec, self.mesh)]
            if self._split(p, what, value):
                x = self._block(p, x)
            dst.copy_(x)
            if what == "grad" and self.dp > 1:
                dst.mul_(self.dp)

    def fragments(self, path, what: str = "base"):
        """``(index, block)`` of every block of leaf ``path`` that this rank
        holds of component ``what``: ``index`` is the block's slices of the
        whole leaf, ``block`` the tensor (a view of this rank's own)."""
        out = []
        for i, j in self._parts_of[path]:
            s = self.slots[i]
            p = s.parts[j]
            value = self._value(i, what)
            block = s.part_of(value, j)
            if block is None:
                continue
            shape = list(self.leaf_shapes[path])
            row0 = 0
            if p.src_rows is not None:
                row0, shape[0] = p.src_rows
            index = list(shard_slices(shape, p.tp_spec, self.mesh))
            d = p.fsdp_dim
            if self._split(p, what, value) and d != "layers":
                lo, hi = index[d].start, index[d].stop
                size = -(-(hi - lo) // self.fsdp)  # torch.chunk's
                start = min(lo + self.fsdp_rank * size, hi)
                index[d] = slice(start, min(start + size, hi))
            index[0] = slice(index[0].start + row0, index[0].stop + row0)
            out.append((tuple(index), block))
        return out
