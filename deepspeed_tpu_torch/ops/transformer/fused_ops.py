"""Fused-op surface (counterpart of ``deepspeed_tpu/ops/transformer/fused_ops.py``),
cut to what the serving slice runs: ``fused_softmax``."""

import torch


def fused_softmax(scores, mask=None):
    """Masked softmax with f32 math, returned in the scores' dtype."""
    if mask is not None:
        scores = scores + mask
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)
