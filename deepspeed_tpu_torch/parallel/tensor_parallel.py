"""Tensor parallelism's collectives under autograd, over the mesh's
``tensor`` axis.

The reference partitions its training step with GSPMD, which inserts the
collectives the placements imply. The port writes them out, in Megatron's
form: every tensor rank computes the same loss, and a tensor that every
rank holds whole has the same value and the same gradient on each.

  ``copy_to``      identity forward, all-reduce backward (a whole tensor
                   entering a column-parallel product)
  ``reduce_from``  all-reduce forward, identity backward (after a
                   row-parallel product)
  ``gather_from``  all-gather forward, this rank's block backward
  ``scatter_to``   this rank's block forward, all-gather backward

plus the vocab-parallel embedding and cross-entropy, where each rank holds
a block of the vocabulary's rows.
"""

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm

AXIS = "tensor"


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``tensor`` axis: ``size`` ranks, this one
    ``rank``; ``group`` the axis's handle (the global mesh's ``tensor``, or
    a serving mesh's ``comm.MeshAxes``)."""

    size: int
    rank: int
    group: object = field(default=AXIS, compare=False)

    def heads_split(self, cfg) -> bool:
        """Whether attention runs on this rank's heads alone: the query and
        the kv head counts both divide the width (the reference's
        ``_tp_head_shard``); else every rank computes every head."""
        return cfg.num_heads % self.size == 0 and cfg.kv_heads % self.size == 0

    def block(self, n: int):
        """(start, length) of this rank's block of a dim of ``n``."""
        if n % self.size:
            raise ValueError(f"a dimension of size {n} placed over 'tensor' must be divisible "
                             f"by {self.size}")
        return self.rank * (n // self.size), n // self.size


@dataclass(frozen=True)
class ServingShard(TensorParallel):
    """A serving rank's place on the serving mesh's ``tensor`` axis and the
    modes its placements give the cached forward (``inference/mesh.
    serving_shard`` derives them from the spec tree):

      ``attn``   ``"heads"``: q/k/v column-split on whole heads, each rank
                 attending its H/T query and Hkv/T kv heads over a cache of
                 its kv heads, ``wo`` row-split; ``"columns"``: the q/``wo``
                 split where the head counts do not divide the width: q
                 gathered, every kv head on every rank (a whole cache), the
                 output cut back to this rank's columns; ``"whole"``: the
                 attention whole on every rank
      ``mlp``    the MLP's in/gate column-split and ``wo`` row-split
      ``embed``  the embedding's rows split over the vocabulary
      ``head``   the logits split over the vocabulary, gathered before the
                 sampler
    """

    attn: str = "whole"
    mlp: bool = False
    embed: bool = False
    head: bool = False

    def local_heads(self, cfg):
        """(query heads, kv heads) this rank attends (in ``"columns"``: after
        the gather of q)."""
        if self.attn == "heads":
            return cfg.num_heads // self.size, cfg.kv_heads // self.size
        return cfg.num_heads, cfg.kv_heads

    def cache_kv_heads(self, cfg) -> int:
        """The kv heads of this rank's KV cache."""
        return cfg.kv_heads // self.size if self.attn == "heads" else cfg.kv_heads

    def head_offset(self, cfg) -> int:
        """The global index of this rank's first query head."""
        return self.rank * (cfg.num_heads // self.size) if self.attn == "heads" else 0


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, comm.ReduceOp.SUM, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x, comm.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, rank, group):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return comm.all_gather(x, group, axis=dim, tiled=True)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, start, n, group):
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, start, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (comm.all_gather(g.contiguous(), ctx.group, axis=ctx.dim, tiled=True),
                None, None, None, None)


def copy_to(x, tp: TensorParallel):
    return _CopyTo.apply(x, tp.group)


def reduce_from(x, tp: TensorParallel):
    return _ReduceFrom.apply(x, tp.group)


def gather_from(x, tp: TensorParallel, dim: int = -1):
    return _GatherFrom.apply(x, dim % x.dim(), tp.rank, tp.group)


def scatter_to(x, tp: TensorParallel, dim: int = -1):
    """This rank's block of dim ``dim`` of a tensor every rank holds whole."""
    dim %= x.dim()
    start, n = tp.block(x.shape[dim])
    return _ScatterTo.apply(x, dim, start, n, tp.group)


def _vocab_block(labels, tp: TensorParallel, n_local: int):
    local = labels.long() - tp.rank * n_local
    inside = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), inside


def vocab_parallel_embedding(tokens, table, tp: TensorParallel):
    """Rows of the embedding whose vocabulary this rank holds a block of
    (``table`` (V/tp, D)): each rank looks up its own tokens, zeroes the
    others, and the sum over the ranks is the whole lookup."""
    local, inside = _vocab_block(tokens, tp, table.shape[0])
    rows = F.embedding(local, table) * inside[..., None].to(table.dtype)
    return reduce_from(rows, tp)


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """``ops/cross_entropy``'s arithmetic over a vocabulary split across the
    tensor ranks: the max and the exp-sum are reduced over the ranks, the
    gold logit comes from the rank that holds it; the backward is each
    rank's block of ``softmax - onehot``, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, rank, size):
        tp = TensorParallel(size, rank)
        logits32 = logits.float()
        m = comm.all_reduce(logits32.amax(dim=-1), comm.ReduceOp.MAX, AXIS)
        s = comm.all_reduce((logits32 - m[..., None]).exp_().sum(dim=-1), comm.ReduceOp.SUM, AXIS)
        lse = torch.log(s) + m
        local, inside = _vocab_block(labels, tp, logits.shape[-1])
        gold = torch.gather(logits32, -1, local[..., None])[..., 0] * inside
        gold = comm.all_reduce(gold, comm.ReduceOp.SUM, AXIS)
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        grad = logits.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
        grad.scatter_add_(-1, local[..., None], -inside[..., None].to(torch.float32))
        return grad.mul_(g[..., None].float()).to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, labels, tp: TensorParallel):
    """Per-token f32 negative log-likelihood of ``labels`` (global vocab
    ids) from this rank's block of the logits (..., V/tp)."""
    return _VocabParallelCrossEntropy.apply(logits, labels, tp.rank, tp.size)
