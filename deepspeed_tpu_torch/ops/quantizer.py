"""Groupwise quantization and the W8A8 linear of the int8 inference path
(counterpart of ``deepspeed_tpu/ops/quantizer.py``).

The reference's functions are jnp chains that XLA fuses; here they are
plain PyTorch with the same f32 arithmetic, so that on the CPU every integer
and every scale equals the reference's bit for bit. Stochastic rounding
draws its noise from a ``torch.Generator`` where the reference takes a JAX
key: the two give other numbers, so that path is held to a distribution.

Layout convention: the tensor is flattened to (num_groups, group_size) and
each group gets its own scale (and zero-point if asymmetric).

:func:`int8_linear` takes the port's ``F.linear`` weight layout, (out, in)
with per-output-channel scales of shape (out,); the reference's is
(in, out) with (1, out). Its int8 x int8 product with int32 sums is
``torch._int_mm`` on both devices (cuBLASLt on the card), one plain product
as the reference's ``dot_general`` is. On a CUDA tensor the rows are padded
to what the card's product takes (:func:`int_mm_rows`), and a width it does
not take raises; nothing moves to the CPU.
"""

from typing import Optional, Tuple

import torch


def div_exact(x, c: float):
    """x / c, rounded as IEEE division on every device. On a CUDA tensor
    ATen computes x / <python number> as x * (1 / c), which can differ in
    the last bit; the reference (XLA) and the CPU divide. A 0-dim tensor on
    x's device takes the dividing kernel."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _grouped(x, num_groups: int):
    n = x.numel()
    if n % num_groups:
        raise ValueError(f"{n} elements not divisible into {num_groups} groups")
    return x.reshape(num_groups, n // num_groups)


def quantize(x, num_bits: int = 8, num_groups: int = 1, symmetric: bool = True,
             stochastic: bool = False, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Quantize to ints. Returns (q int8/int32, scales (G, 1) f32,
    zero_points (G, 1) or None). Stochastic rounding draws uniform noise
    from ``generator`` (on x's device)."""
    g = _grouped(x.float(), num_groups)
    qmax = 2 ** (num_bits - 1) - 1
    qmin = -(2 ** (num_bits - 1))
    if symmetric:
        absmax = g.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(div_exact(absmax, qmax), min=1e-12)
        t = g / scale
        zp = None
    else:
        gmax = g.amax(dim=-1, keepdim=True)
        gmin = g.amin(dim=-1, keepdim=True)
        scale = torch.clamp(div_exact(gmax - gmin, 2 ** num_bits - 1), min=1e-12)
        zp = torch.round(qmin - gmin / scale)
        t = g / scale + zp
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a generator")
        noise = torch.rand(t.shape, generator=generator, device=t.device) - 0.5
        q = torch.floor(t + 0.5 + noise)
    else:
        q = torch.round(t)  # half to even, as jnp.round
    q = torch.clamp(q, qmin, qmax)
    return q.to(torch.int8 if num_bits <= 8 else torch.int32), scale, zp


def dequantize(q, scale, zero_point=None, num_groups: int = 1, out_shape=None):
    g = _grouped(q.float(), num_groups)
    if zero_point is not None:
        g = g - zero_point
    out = g * scale
    return out.reshape(out_shape) if out_shape is not None else out.reshape(-1)


def fake_quantize(x, num_bits: int = 8, num_groups: int = 1, symmetric: bool = True,
                  stochastic: bool = False, generator: Optional[torch.Generator] = None):
    """Quantize-dequantize round trip with a straight-through gradient:
    the value of the round trip, the gradient of the identity (the
    reference's ``(x - stop_gradient(x)) + stop_gradient(ste(x))``)."""
    with torch.no_grad():
        q, scale, zp = quantize(x, num_bits, num_groups, symmetric, stochastic, generator)
        rt = dequantize(q, scale, zp, num_groups, out_shape=x.shape).to(x.dtype)
    return (x - x.detach()) + rt


def quantize_per_channel(w, num_bits: int = 8, axis: int = 0):
    """Per-channel symmetric weight quantization along ``axis`` (the scales
    keep every dimension, extent 1 off ``axis``)."""
    w32 = w.float()
    qmax = 2 ** (num_bits - 1) - 1
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis)
    absmax = w32.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(div_exact(absmax, qmax), min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -(2 ** (num_bits - 1)), qmax).to(torch.int8)
    return q, scale


def dequantize_per_channel(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def quantize_weight(w):
    """The inference engine's int8 storage of one (out, in) matmul weight:
    per-output-channel absmax over the contraction dim, scales kept in f32
    with shape (out,), values clipped to [-128, 127] (the reference's
    ``_quantize_weights``)."""
    w32 = w.float()
    s = torch.clamp(div_exact(w32.abs().amax(dim=-1), 127.0), min=1e-12)
    q8 = torch.clamp(torch.round(w32 / s[:, None]), -128, 127).to(torch.int8)
    return {"q8": q8, "s": s}


# torch._int_mm's checks on a CUDA tensor (torch 2.11): more than 16 rows,
# and the contraction and output widths multiples of 8; the weight is taken
# as it lies, (out, in) read column-major
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def int_mm_rows(M: int, K: int, N: int) -> int:
    """Rows the card's int8 product runs for an (M, K) x (K, N) product: M,
    or 17 when M is 16 or fewer. Raises for a K or N that the product does
    not take."""
    if K % _INT_MM_ALIGN or N % _INT_MM_ALIGN:
        raise ValueError(f"the card's int8 product needs K and N multiples of "
                         f"{_INT_MM_ALIGN}, got K={K} N={N}")
    return max(M, _INT_MM_MIN_ROWS)


def _int8_dot(xq, q8):
    """int32 sums of (M, K) int8 x (N, K) int8 -> (M, N)."""
    if xq.device.type != "cuda":
        return torch._int_mm(xq, q8.t())
    M, K = xq.shape
    rows = int_mm_rows(M, K, q8.shape[0])
    if rows != M:
        xq = torch.cat([xq, xq.new_zeros(rows - M, K)])
    return torch._int_mm(xq, q8.t())[:M]


def int8_linear(x, q8, scale):
    """W8A8 linear: dynamic per-token symmetric activation quantization, an
    int8 x int8 product with int32 sums, then the float rescale
    ``(acc * sx) * sw`` in x's dtype.

    x: (..., K) float; q8: (N, K) int8 (the ``F.linear`` layout); scale:
    (N,) per-output-channel weight scales. Returns (..., N) in x.dtype. As
    the reference: round half to even, scales floored at 1e-12, and no clip
    on the activations (|x| / sx <= 127 by construction).
    """
    orig_dtype = x.dtype
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(div_exact(amax, 127.0), min=1e-12)
    xq = torch.round(xf / sx).to(torch.int8)
    lead = x.shape[:-1]
    acc = _int8_dot(xq.reshape(-1, x.shape[-1]), q8).reshape(*lead, q8.shape[0])
    return (acc.float() * sx * scale.float()).to(orig_dtype)
