"""Fused Adam/AdamW.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py`` (reference: the
multi-tensor fused Adam, ``csrc/adam/multi_tensor_adam.cu`` +
``ops/adam/fused_adam.py:18``), with the same arithmetic: f32 moments, bias
correction, ``sqrt(v / bc2) + eps`` in the denominator, and decoupled weight
decay ``-lr * wd * p`` in AdamW mode (L2 added to the gradient otherwise).
:meth:`FusedAdam.update` returns the update as deltas that the caller adds
to its f32 parameters, as the reference's does. It is plain tensor code over
lists of tensors with ``torch._foreach_*`` ops (a handful of launches per
step for the whole model), not ``torch.optim``. To keep one copy of the
moments, it advances them in place and returns the same ``AdamState``.
"""

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import torch


@dataclass
class AdamState:
    step: int = 0
    exp_avg: List[torch.Tensor] = field(default_factory=list)
    exp_avg_sq: List[torch.Tensor] = field(default_factory=list)


@dataclass(frozen=True)
class FusedAdam:
    """Adam/AdamW with bias correction, matching torch.optim.Adam semantics
    (as the reference's)."""

    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            step=0,
            exp_avg=[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
            exp_avg_sq=[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
        )

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamState, params: List[torch.Tensor],
               lr=None) -> Tuple[List[torch.Tensor], AdamState]:
        """Returns (updates, state): f32 deltas to add to ``params``, and
        ``state`` with its step and moments advanced (in place)."""
        lr = self.lr if lr is None else float(lr)
        b1, b2 = self.betas
        state.step += 1
        if self.bias_correction:
            bc1, bc2 = 1.0 - b1 ** state.step, 1.0 - b2 ** state.step
        else:
            bc1 = bc2 = 1.0
        grads = [g.float() for g in grads]
        params = [p.float() for p in params]
        wd = self.weight_decay
        if not self.adam_w_mode and wd > 0.0:
            grads = torch._foreach_add(grads, params, alpha=wd)
        m, v = state.exp_avg, state.exp_avg_sq
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(m, bc1)
        torch._foreach_mul_(updates, -lr)
        torch._foreach_div_(updates, denom)
        if self.adam_w_mode and wd > 0.0:
            torch._foreach_add_(updates, params, alpha=-lr * wd)
        return updates, state


def FusedAdamW(**kw):
    kw.setdefault("adam_w_mode", True)
    return FusedAdam(**kw)
