"""Fused LayerNorm / RMSNorm over the last dimension, forward and backward.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_norm.py``:
:func:`fused_layernorm` and :func:`fused_rmsnorm` take any leading shape,
reshape it to rows (N, D), and are differentiable through one
``torch.autograd.Function`` (the reference's custom VJP) whose forward saves
(x, scale, bias, mu, rstd) and whose backward returns dx in x's dtype, dscale
in scale's dtype and dbias in bias's dtype (None without a bias). The math is
f32 throughout: two-pass mean and population variance (RMSNorm: mu = 0, var =
mean(x²)), rstd = rsqrt(var + eps), out = (x − mu)·rstd·scale (+ bias).

On a CUDA tensor each direction launches a hand-written Hopper kernel or
raises: the forward K7 and the backward K8, both in ``ops/csrc/fused_norm.cu``,
built on first use (see ``op_builder``). K8 writes per-block f32 partial sums
of do·xhat and do, and, as the reference's ``_run_bwd`` sums its per-block
partials outside its kernel, :func:`_cuda_bwd` sums them with ``torch.sum``
(a fixed order: no atomics, so two calls give the same bits). On a CPU tensor
each direction runs its plain PyTorch version beside it
(:func:`_reference_fwd`, :func:`_reference_bwd`). There is no other path: no
library norm call and no fallback from one to the other.

The kernels take contiguous rows: a non-contiguous x (or output gradient) is
copied to a contiguous one first.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.op_builder import LAUNCHES, CudaKernelLib

KERNEL_LIB = CudaKernelLib("fused_norm.cu")  # built and loaded at the first launch
LAUNCHES["fused_norm_fwd"] = 0
LAUNCHES["fused_norm_bwd"] = 0
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = KERNEL_LIB.load()
    fwd, bwd = lib.dstorch_fused_norm_fwd, lib.dstorch_fused_norm_bwd
    blocks = lib.dstorch_fused_norm_bwd_blocks
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd.argtypes = [i32, ptr, ptr, i32, ptr, i32, ptr, ptr, ptr, i32, i32, ctypes.c_float, i32,
                    ptr]
    bwd.argtypes = [i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    blocks.argtypes = [i32, i32, i32]
    fwd.restype = bwd.restype = blocks.restype = ctypes.c_int
    return fwd, bwd, blocks


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _reference_fwd(x2, scale, bias, eps: float,
                   rms: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7 on rows (N, D): (out in x's dtype, mu and
    rstd f32 (N, 1)), step by step as the TPU kernel writes it."""
    x = x2.float()
    if rms:
        mu = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
        var = (x * x).mean(dim=-1, keepdim=True)
    else:
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x - mu) * rstd
    out = xhat * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x2.dtype), mu, rstd


def _reference_bwd(x2, scale, mu, rstd, do2,
                   rms: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8 and the sum of its partials: (dx in x's
    dtype, dscale f32 (D,), dbias f32 (D,)), from the forward's f32 mu and
    rstd (N, 1)."""
    x, do = x2.float(), do2.float()
    xhat = (x - mu) * rstd
    dscale = (do * xhat).sum(dim=0)
    dbias = do.sum(dim=0)
    dxhat = do * scale.float()
    if rms:
        dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    else:
        dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x2.dtype), dscale, dbias


def _check_kernel_inputs(x2, *weights):
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused norm kernel takes float32/float16/bfloat16 x, got {x2.dtype}")
    for w in weights:
        if w is not None and w.dtype not in _DTYPE_CODE:
            raise TypeError(f"fused norm kernel takes a float32/float16/bfloat16 scale and "
                            f"bias, got {w.dtype}")
    if x2.shape[0] >= 2 ** 31 or x2.shape[1] >= 2 ** 31:
        raise ValueError(f"fused norm kernel: rows and width must be below 2**31, got "
                         f"{tuple(x2.shape)}")


def _cuda_fwd(x2, scale, bias, eps: float,
              rms: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 on contiguous rows x2 (N, D): (out, mu, rstd) as the plain version."""
    _check_kernel_inputs(x2, scale, bias)
    N, D = x2.shape
    scale = scale.contiguous()
    bias = bias.contiguous() if bias is not None else None
    out = torch.empty_like(x2)
    mu = torch.empty((N, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((N, 1), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        rc = _kernels()[0](
            _DTYPE_CODE[x2.dtype], x2.data_ptr(), scale.data_ptr(), _DTYPE_CODE[scale.dtype],
            None if bias is None else bias.data_ptr(),
            0 if bias is None else _DTYPE_CODE[bias.dtype],
            out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), N, D, float(eps), int(rms),
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_norm_fwd kernel launch failed (cudaError {rc})")
    LAUNCHES["fused_norm_fwd"] += 1
    return out, mu, rstd


def _cuda_bwd(x2, scale, mu, rstd, do2,
              rms: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 on contiguous rows, then the sum of its (nb, D) f32 partials over
    blocks: (dx, dscale f32, dbias f32) as the plain version."""
    _check_kernel_inputs(x2, scale)
    N, D = x2.shape
    scale = scale.contiguous()
    nb = _kernels()[2](N, D, _sm_count(x2.device.index))  # the kernel's own block count
    dx = torch.empty_like(x2)
    dscale_p = torch.empty((nb, D), dtype=torch.float32, device=x2.device)
    dbias_p = torch.empty((nb, D), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        rc = _kernels()[1](
            _DTYPE_CODE[x2.dtype], x2.data_ptr(), scale.data_ptr(), _DTYPE_CODE[scale.dtype],
            mu.data_ptr(), rstd.data_ptr(), do2.data_ptr(), dx.data_ptr(), dscale_p.data_ptr(),
            dbias_p.data_ptr(), N, D, nb, int(rms),
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_norm_bwd kernel launch failed (cudaError {rc})")
    LAUNCHES["fused_norm_bwd"] += 1
    return dx, dscale_p.sum(dim=0), dbias_p.sum(dim=0)


def _device_type(x) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused norm runs on cuda or cpu tensors, got {x.device}")
    return x.device.type


def _fwd(x2, scale, bias, eps: float, rms: bool):
    """The forward on checked rows: K7 on a CUDA tensor, the plain version on
    a CPU tensor."""
    if _device_type(x2) == "cuda":
        return _cuda_fwd(x2, scale, bias, eps, rms)
    return _reference_fwd(x2, scale, bias, eps, rms)


def _bwd(x2, scale, mu, rstd, do2, rms: bool):
    """The backward on checked rows: K8 and the sum of its partials on a
    CUDA tensor, the plain version on a CPU tensor."""
    if _device_type(x2) == "cpu":
        return _reference_bwd(x2, scale, mu, rstd, do2, rms)
    return _cuda_bwd(x2, scale, mu.contiguous(), rstd.contiguous(),
                     do2.to(x2.dtype).contiguous(), rms)


class _FusedNorm(torch.autograd.Function):
    """The reference's custom VJP (``_fused_norm``): forward K7, saving
    (x, scale, bias, mu, rstd); backward K8, with dscale and dbias cast to
    their parameters' dtypes and dbias dropped without a bias."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps, rms):
        out, mu, rstd = _fwd(x2, scale, bias, eps, rms)
        ctx.save_for_backward(x2, scale, bias, mu, rstd)
        ctx.rms = rms
        return out

    @staticmethod
    def backward(ctx, do):
        x2, scale, bias, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = _bwd(x2, scale, mu, rstd, do, ctx.rms)
        dbias = dbias.to(bias.dtype) if bias is not None else None
        return dx, dscale.to(scale.dtype), dbias, None, None


def _check_inputs(x, scale, bias, block_rows):
    if isinstance(block_rows, bool) or not isinstance(block_rows, int) or block_rows < 1:
        raise ValueError(f"block_rows must be an int >= 1, got {block_rows!r}")
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"fused norm needs at least one row of at least one feature, "
                         f"got x of shape {tuple(x.shape)}")
    D = x.shape[-1]
    for name, w in (("scale", scale), ("bias", bias)):
        if w is None:
            continue
        if tuple(w.shape) != (D,):
            raise ValueError(f"{name} must have shape ({D},), the width of x, got "
                             f"{tuple(w.shape)}")
        if w.device != x.device:
            raise ValueError(f"{name} is on {w.device}, x on {x.device}")


def _fused_norm(x, scale, bias, eps: float, rms: bool, block_rows: int):
    _check_inputs(x, scale, bias, block_rows)
    _device_type(x)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias)):
        out = _FusedNorm.apply(x2, scale, bias, float(eps), rms)
    else:
        out = _fwd(x2, scale, bias, float(eps), rms)[0]
    return out.reshape(x.shape)


def fused_layernorm(x, scale, bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                    block_rows: int = 256) -> torch.Tensor:
    """LayerNorm over the last dim of x (any leading shape), in x's dtype.
    ``block_rows`` is the TPU kernel's row tile: accepted for the
    reference's signature and checked (an int >= 1), unused. The CUDA kernels
    partition rows by themselves; the partition only changes the order of
    the dscale/dbias sums."""
    return _fused_norm(x, scale, bias, eps, False, block_rows)


def fused_rmsnorm(x, scale, eps: float = 1e-5, block_rows: int = 256) -> torch.Tensor:
    """RMSNorm over the last dim of x, in x's dtype; ``block_rows`` as in
    :func:`fused_layernorm`."""
    return _fused_norm(x, scale, None, eps, True, block_rows)
