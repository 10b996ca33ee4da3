"""Memory-tiled linear layers.

Counterpart of ``deepspeed_tpu/runtime/zero/tiling.py`` (reference
``runtime/zero/tiling.py:32`` ``TiledLinear``): a linear split into
(in_splits x out_splits) tiles, so that one out-tile's product and its
inputs are live at a time. Each out-tile runs under activation
checkpointing (``torch.utils.checkpoint``), as the reference wraps each in
``jax.checkpoint``: its backward recomputes the tile instead of keeping it.
Weights are laid out ``x @ w`` (D_in, D_out), as the reference's.
"""

import math

import torch
from torch.utils.checkpoint import checkpoint


def _out_tile(x_t, w_o):  # (..., in_splits, ti) x (in_splits, ti, to) -> (..., to)
    return torch.einsum("...kt,kto->...o", x_t, w_o)


def tiled_linear(x, w, b=None, in_splits: int = 1, out_splits: int = 1):
    """y = x @ w (+ b), computed in (in_splits x out_splits) tiles.

    x: (..., D_in); w: (D_in, D_out); b: (D_out,) or None. D_in must divide
    by in_splits and D_out by out_splits."""
    D_in, D_out = w.shape
    if D_in % in_splits or D_out % out_splits:
        raise ValueError(
            f"weight ({D_in},{D_out}) not divisible by splits ({in_splits},{out_splits})")
    ti, to = D_in // in_splits, D_out // out_splits
    if in_splits == 1 and out_splits == 1:
        y = x @ w
        return y + b if b is not None else y
    w_t = w.reshape(in_splits, ti, out_splits, to).permute(2, 0, 1, 3)
    x_t = x.reshape(x.shape[:-1] + (in_splits, ti))
    tiles = [checkpoint(_out_tile, x_t, w_t[o], use_reentrant=False) for o in range(out_splits)]
    y = torch.cat(tiles, dim=-1)
    return y + b if b is not None else y


class TiledLinear:
    """``TiledLinear(in_features, out_features, in_splits=, out_splits=,
    bias=)`` with ``init(generator) -> params`` and ``apply(params, x)``,
    as the reference's."""

    def __init__(self, in_features: int, out_features: int, in_splits: int = 1,
                 out_splits: int = 1, bias: bool = True):
        if in_features % in_splits or out_features % out_splits:
            raise ValueError("features must divide the split counts")
        self.in_features = in_features
        self.out_features = out_features
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.bias = bias

    def init(self, generator: torch.Generator):
        dev = generator.device
        params = {"w": torch.randn((self.in_features, self.out_features), generator=generator,
                                   device=dev) / math.sqrt(self.in_features)}
        if self.bias:
            params["b"] = torch.zeros((self.out_features,), device=dev)
        return params

    def apply(self, params, x):
        return tiled_linear(x, params["w"], params.get("b"), in_splits=self.in_splits,
                            out_splits=self.out_splits)

    def __call__(self, params, x):
        return self.apply(params, x)
