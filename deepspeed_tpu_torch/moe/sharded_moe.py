"""Sharded Mixture-of-Experts: gating, dispatch and combine.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (reference
``deepspeed/moe/sharded_moe.py``: ``TopKGate`` :343, ``MOELayer`` :420,
``top1gating`` :179, ``top2gating`` :277). The gating is the reference's
arithmetic: the router's softmax in f32, top-1 or top-2 choices by argmax,
each expert's buffer filled in token order (an exclusive cumsum, or the
order of a given priority) up to its capacity ``max(min_capacity,
ceil(N / E * capacity_factor * k))``, a second choice placed after every
first choice that expert kept, the Switch/GShard load-balancing loss, and
for k = 2 the combine weights renormalised over the kept choices.

The reference dispatches and combines with one-hot (N, E, C) einsums. Here
a gate is held compactly, per choice: the expert, the slot in its buffer,
whether it was kept, and the combine weight (:class:`GateOutput`, whose
``combine_weights()``/``dispatch_mask()`` give the reference's dense
tensors). Every kept choice owns one slot of the (E, C) buffers, and every
dropped one a spare row of its own past them, so that dispatch is a
scatter of token rows to distinct rows and combine a gather back: the
forward moves each row once, the backward of either is the other (a
gather, or a write to distinct rows), with no accumulation over repeated
indices, so a step stays bit for bit deterministic on the card. In f32 at
top-1 the result is the einsum's bit for bit (each einsum sum has one term
that is not zero).

On a training mesh (:class:`MoEGroups`) the routing is the reference's
over the global batch, as its jitted step computes it: the capacity from
the global token count, a token's slot after the tokens of lower
data-parallel ranks (an exclusive scan of the per-expert counts over
``data``/``fsdp``), and the load-balancing loss from the means over every
rank's tokens. Experts split over the ``expert`` axis: each expert rank
sees the same tokens, runs its own experts, and the combine sums over the
expert ranks (Megatron's ``copy_to``/``reduce_from`` pair over that axis).
"""

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import tensor_parallel as tpm
from deepspeed_tpu_torch.utils import not_ported

DP_AXES = ("data", "fsdp")
EXPERT_AXIS = "expert"


@dataclass(frozen=True)
class MoEGroups:
    """A rank's place for routing: ``dp`` data-parallel ranks (``data`` x
    ``fsdp``) share the global batch, this one ``dp_rank`` (its rows are the
    ``dp_rank``-th block); ``ep`` expert ranks split the experts, this one
    holding block ``ep_rank``."""

    dp: int = 1
    dp_rank: int = 0
    ep: int = 1
    ep_rank: int = 0

    @classmethod
    def of_mesh(cls, mesh) -> Optional["MoEGroups"]:
        """The groups of a training mesh, or None where no axis routes over
        more than one rank."""
        dp = mesh.shape["data"] * mesh.shape["fsdp"]
        ep = mesh.shape[EXPERT_AXIS]
        if dp == 1 and ep == 1:
            return None
        return cls(dp=dp, dp_rank=comm.get_rank(DP_AXES) if dp > 1 else 0,
                   ep=ep, ep_rank=mesh.coords[EXPERT_AXIS])

    @property
    def expert_tp(self) -> tpm.TensorParallel:
        return tpm.TensorParallel(self.ep, self.ep_rank, EXPERT_AXIS)


class GateOutput(NamedTuple):
    """A gate, per choice (k, N): the ``expert`` chosen, its ``position`` in
    that expert's buffer (meaningful where ``keep``), whether it fits the
    ``capacity`` (``keep``), its f32 combine ``weight`` (0 where dropped);
    the scalar load-balancing ``aux_loss`` and the (E,) int32
    ``expert_counts`` of tokens routed to each expert before drops."""

    expert: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    capacity: int
    num_experts: int
    aux_loss: torch.Tensor
    expert_counts: torch.Tensor

    def dispatch_mask(self) -> torch.Tensor:
        """The reference's (N, E, C) bool dispatch mask."""
        return self._dense(self.keep.float()) > 0

    def combine_weights(self) -> torch.Tensor:
        """The reference's (N, E, C) f32 combine weights."""
        return self._dense(self.weight * self.keep)

    def _dense(self, values):
        k, N = self.expert.shape
        E, C = self.num_experts, self.capacity
        out = torch.zeros(N, E * C, dtype=values.dtype, device=values.device)
        slot = self.expert * C + self.position.clamp(0, C - 1)  # a dropped choice adds 0
        for i in range(k):
            out.scatter_add_(1, slot[i][:, None], values[i][:, None])
        return out.view(N, E, C)


def compute_capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int,
                     k: int = 1) -> int:
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor * k))
    return max(cap, min_capacity)


class _MeanOver(torch.autograd.Function):
    """The mean over the data-parallel ranks of a per-rank quantity, on
    every rank. Each rank's loss carries the same global term, so the
    gradient each rank's share receives is the mean of the ranks'
    gradients of it."""

    @staticmethod
    def forward(ctx, x):
        return comm.all_reduce(x, comm.ReduceOp.AVG, DP_AXES)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.contiguous(), comm.ReduceOp.AVG, DP_AXES)


def _lower_ranks_sum(counts, groups: Optional[MoEGroups]):
    """The sum of ``counts`` (E,) over the data-parallel ranks below this
    one: where this rank's tokens start in the global order."""
    if groups is None or groups.dp == 1:
        return torch.zeros_like(counts)
    every = comm.all_gather(counts, DP_AXES, axis=0, tiled=False)  # (dp, E)
    return every[:groups.dp_rank].sum(0)


def _global_sum(counts, groups: Optional[MoEGroups]):
    if groups is None or groups.dp == 1:
        return counts
    return comm.all_reduce(counts, comm.ReduceOp.SUM, DP_AXES)


def _assign_positions(mask, priority: Optional[torch.Tensor] = None,
                      groups: Optional[MoEGroups] = None):
    """Position of each selected token within its expert's buffer: ``mask``
    (N, E) 0/1 selection; ``priority`` optional (N,), lower goes first (the
    reference's exclusive cumsum in token order; RTS shuffles this order).
    Returns (N, E) int64 positions (meaningful where mask is 1). On a
    training mesh the scan runs over the global batch, this rank's tokens
    after those of the lower data-parallel ranks."""
    mask = mask.long()
    if priority is None:
        # scanned along contiguous rows: on the card the scan down the
        # columns of an (N, E) tensor took 1.4 ms at N 8192, E 8
        pos = (torch.cumsum(mask.t().contiguous(), dim=1) - mask.t()).t()
    else:
        if groups is not None and groups.dp > 1:
            raise not_ported("random token selection over data-parallel ranks "
                             "(Queue 1 item 10)")
        order = torch.argsort(priority, stable=True)
        inv = torch.argsort(order, stable=True)
        sorted_mask = mask.index_select(0, order)
        pos = (torch.cumsum(sorted_mask, dim=0) - sorted_mask).index_select(0, inv)
    return pos + _lower_ranks_sum(mask.sum(0), groups)[None, :]


def _load_balance_loss(gates, mask1, groups: Optional[MoEGroups] = None):
    """Switch/GShard aux loss: E * sum_e mean(gates_e) * mean(mask_e)
    (reference top1gating :222), the means over the global batch."""
    E = gates.shape[1]
    me = gates.mean(dim=0)
    ce = mask1.float().mean(dim=0)
    if groups is not None and groups.dp > 1:
        me = _MeanOver.apply(me)
        ce = comm.all_reduce(ce, comm.ReduceOp.AVG, DP_AXES)
    return (me * ce).sum() * E


def topk_gating(
    logits: torch.Tensor,
    k: int,
    capacity_factor: float = 1.0,
    min_capacity: int = 4,
    generator: Optional[torch.Generator] = None,
    use_rts: bool = True,
    drop_tokens: bool = True,
    noisy_gate_policy: Optional[str] = None,
    groups: Optional[MoEGroups] = None,
) -> GateOutput:
    """Top-k gating with static capacity (k=1 -> Switch, k=2 -> GShard).

    ``logits`` (N, E) router outputs. The random parts (RTS's priority,
    ``noisy_gate_policy="RSample"``) draw from ``generator``, and only
    with one, as the reference draws only with a key."""
    N, E = logits.shape
    n_global = N * (groups.dp if groups is not None else 1)
    C = compute_capacity(n_global, E, capacity_factor, min_capacity, k)
    if not drop_tokens:
        C = n_global  # full capacity: nothing dropped (reference drop_tokens=False)
    dev = logits.device

    if noisy_gate_policy == "RSample" and generator is not None:
        noise = torch.randn(logits.shape, generator=generator, device=dev, dtype=torch.float32)
        logits_for_select = logits + noise / E
    else:
        logits_for_select = logits
    gates = torch.softmax(logits.float(), dim=-1)  # (N, E)

    masked = logits_for_select.float()
    experts, positions, keeps, gate_vals = [], [], [], []
    expert_counts = torch.zeros(E, dtype=torch.int32, device=dev)
    kept_before = None  # (E,) kept choices of the earlier rounds, over the global batch
    aux_loss = None
    for i in range(k):
        idx = torch.argmax(masked, dim=-1)  # (N,)
        mask = torch.nn.functional.one_hot(idx, E).float()  # (N, E)
        if i == 0:
            aux_loss = _load_balance_loss(gates, mask, groups)
        priority = None
        if use_rts and generator is not None:
            priority = torch.rand(N, generator=generator, device=dev)
        pos = _assign_positions(mask, priority, groups)  # (N, E)
        if kept_before is not None:
            # later choices start after the slots earlier choices took in
            # the same expert buffer (reference top2gating :307)
            pos = pos + kept_before[None, :]
        pos = pos.gather(1, idx[:, None])[:, 0]  # (N,): the chosen expert's slot
        keep = pos < C
        expert_counts = expert_counts + _global_sum(mask.sum(0), groups).to(torch.int32)
        kept = _global_sum((mask * keep[:, None]).sum(0).long(), groups)
        kept_before = kept if kept_before is None else kept_before + kept
        experts.append(idx)
        positions.append(pos)
        keeps.append(keep)
        gate_vals.append((gates * mask).sum(dim=-1))  # the chosen expert's gate
        # the chosen expert is out of the next round
        masked = masked.masked_fill(mask > 0, float("-inf"))

    weights = [g * kp for g, kp in zip(gate_vals, keeps)]
    if k > 1:
        # renormalise over the kept choices (reference top2gating :320)
        denom = 0
        for w in weights:
            denom = denom + w
        denom = torch.clamp(denom, min=torch.finfo(torch.float32).eps)
        weights = [w / denom for w in weights]
    return GateOutput(torch.stack(experts), torch.stack(positions), torch.stack(keeps),
                      torch.stack(weights), C, E, aux_loss, expert_counts)


def top1_gating(logits, **kw) -> GateOutput:
    return topk_gating(logits, k=1, **kw)


def top2_gating(logits, **kw) -> GateOutput:
    return topk_gating(logits, k=2, **kw)


class _ScatterRows(torch.autograd.Function):
    """``rows`` rows of zeros with row ``index[j]`` set to ``src[j]``; no
    index repeats. The backward gathers the gradient's rows back."""

    @staticmethod
    def forward(ctx, src, index, rows):
        ctx.save_for_backward(index)
        return src.new_zeros((rows,) + tuple(src.shape[1:])).index_copy_(0, index, src)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return g.index_select(0, index), None, None


class _GatherRows(torch.autograd.Function):
    """Rows ``index`` of ``src``; no index repeats. The backward writes the
    gradient's rows to their distinct places (no accumulation)."""

    @staticmethod
    def forward(ctx, src, index):
        ctx.save_for_backward(index)
        ctx.rows = src.shape[0]
        return src.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        return out.index_copy_(0, index, g.contiguous()), None


def _rows(gate: GateOutput, first: int, n_experts: int):
    """(k, N) row of each choice in the buffers of experts ``[first, first +
    n_experts)``: its slot where it was kept by one of them, else a spare
    row of its own after the ``n_experts * C`` slots."""
    k, N = gate.expert.shape
    C = gate.capacity
    local = gate.expert - first
    mine = gate.keep & (local >= 0) & (local < n_experts)
    spare = (n_experts * C + torch.arange(k * N, device=gate.expert.device)).view(k, N)
    return torch.where(mine, local * C + gate.position, spare)


def moe_forward(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    expert_fn: Callable,
    expert_params,
    k: int = 1,
    capacity_factor: float = 1.0,
    min_capacity: int = 4,
    generator: Optional[torch.Generator] = None,
    use_rts: bool = True,
    drop_tokens: bool = True,
    noisy_gate_policy: Optional[str] = None,
    groups: Optional[MoEGroups] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route, dispatch, run the experts and combine.

    ``x`` (..., D) tokens; ``gate_w`` (D, E); ``expert_params`` a dict of
    tensors stacked over this rank's experts (E / ep of them, the
    ``ep_rank``-th block under ``groups``); ``expert_fn(params, tokens)``
    maps (E', C, D) tokens through the stacked experts to (E', C, F') in
    one batched product. Returns (out (..., F'), aux_loss,
    expert_counts)."""
    orig_shape = x.shape
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    E = gate_w.shape[-1]

    logits = xf.float() @ gate_w.float()  # the router in f32 (reference :185)
    gate = topk_gating(logits, k, capacity_factor=capacity_factor, min_capacity=min_capacity,
                       generator=generator, use_rts=use_rts, drop_tokens=drop_tokens,
                       noisy_gate_policy=noisy_gate_policy, groups=groups)
    C = gate.capacity
    ep = groups.ep if groups is not None else 1
    n_local = E // ep
    first = (groups.ep_rank if groups is not None else 0) * n_local
    weight = gate.weight
    if ep > 1:
        # every expert rank sees every token: the dispatch input and the
        # combine weights are whole on each, their gradients summed over
        # the ranks' experts
        xf = tpm.copy_to(xf, groups.expert_tp)
        weight = tpm.copy_to(weight, groups.expert_tp)

    rows = _rows(gate, first, n_local)  # (k, N)
    flat = rows.reshape(-1)
    buffers = _ScatterRows.apply(xf.expand(k, N, D).reshape(k * N, D), flat,
                                 n_local * C + k * N)
    expert_inputs = buffers[:n_local * C].view(n_local, C, D)
    expert_outputs = expert_fn(expert_params, expert_inputs)  # (E', C, F')
    F_out = expert_outputs.shape[-1]
    padded = torch.cat([expert_outputs.reshape(n_local * C, F_out),
                        expert_outputs.new_zeros(k * N, F_out)])
    picked = _GatherRows.apply(padded, flat).view(k, N, F_out)
    w = weight.to(x.dtype).float()  # combine weights in x's dtype (reference :196)
    out = (w[..., None] * picked.float()).sum(0).to(x.dtype)
    if ep > 1:
        out = tpm.reduce_from(out, groups.expert_tp)
    return out.reshape(orig_shape[:-1] + (F_out,)), gate.aux_loss, gate.expert_counts
