"""Fused-op surface (op registry target for 'transformer'): counterpart of
``deepspeed_tpu/ops/transformer/fused_ops.py``, with the same functions and
signatures, less the Pallas-only ``interpret``.

- :func:`fused_layernorm` and :func:`fused_rmsnorm` are ``ops/fused_norm.py``:
  the hand-written CUDA kernels K7 (forward) and K8 (backward) on a CUDA
  tensor, their plain PyTorch versions on a CPU tensor.
- :func:`fused_softmax`, :func:`fused_bias_gelu` and
  :func:`fused_bias_dropout_residual` are plain jnp expressions in the
  reference, not Pallas kernels, so plain PyTorch on both devices is their
  faithful port: there is no kernel of theirs to look for.

The reference also re-exports the transformer layer
(``DeepSpeedTransformerConfig``, ``DeepSpeedTransformerLayer``,
``init_transformer_layer``, ``transformer_layer_fwd``); here those names raise
``NotImplementedError`` until the BERT encoder is ported (ROADMAP.md, Queue 1
item 10).
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.fused_norm import fused_layernorm, fused_rmsnorm

_LAYER_NAMES = ("DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer",
                "init_transformer_layer", "transformer_layer_fwd")


def __getattr__(name):
    if name in _LAYER_NAMES:
        raise NotImplementedError(
            f"{name} is not ported to deepspeed_tpu_torch yet (ROADMAP.md, Queue 1 item 10: "
            f"the BERT encoder and ops/transformer/transformer.py)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def fused_softmax(scores, mask=None):
    """Masked softmax with f32 math, returned in the scores' dtype."""
    if mask is not None:
        scores = scores + mask
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)


def fused_bias_gelu(x, bias):
    """GELU of x + bias, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x + bias, approximate="tanh")


def fused_bias_dropout_residual(x, bias, residual, ratio, rng):
    """residual + dropout(x + bias). With ``ratio > 0`` and a
    ``torch.Generator`` ``rng`` on x's device, each element of h = x + bias
    is kept with probability 1 − ratio and scaled to h / (1 − ratio), the
    rest set to 0, in h's dtype; (1 − ratio) is taken in h's dtype first, as
    the reference's weakly typed scalar is. In every other case the result is
    ``residual + h`` exactly. The keep mask comes from ``rng``, so it is not
    the reference's (``jax.random.bernoulli``) bit for bit."""
    h = x + bias
    if ratio > 0.0 and rng is not None:
        keep = torch.rand(h.shape, generator=rng, device=h.device) < 1.0 - ratio
        keep_scale = torch.tensor(1.0 - ratio, dtype=h.dtype).item()
        h = torch.where(keep, h / keep_scale, 0.0).to(h.dtype)
    return residual + h


__all__ = [
    "fused_softmax",
    "fused_bias_gelu",
    "fused_bias_dropout_residual",
    "fused_layernorm",
    "fused_rmsnorm",
]
