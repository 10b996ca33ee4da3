"""Flash attention on (B, S, H, head_dim) tensors, forward and backward.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``:
:func:`flash_attention` is differentiable through a
``torch.autograd.Function`` (the reference's custom VJP) whose forward saves
(q, k, v, o, lse) and whose backward computes ``delta = rowsum(do * o)`` in
f32 and then dq and dk/dv.

On a CUDA tensor each step launches a hand-written Hopper kernel or raises:
the forward ``ops/csrc/flash_fwd.cu`` (K1), the backward's dq and dk/dv
``ops/csrc/flash_bwd.cu`` (K2, K3), each built on first use (see
``op_builder``). Forward and backward each have two variants, chosen by the
dtype alone (:data:`TENSOR_CORE_DTYPES`): float16 and bfloat16 run the
tensor-core (wgmma) kernels, float32 the f32 FMA kernels, since on the
tensor cores f32 would be TF32. The tensor-core kernels copy 16-byte rows, so
the wrapper makes a q, k, v or do whose rows are not 16-byte aligned
contiguous first (:func:`_tensor_core_rows`), and every kernel wrapper
refuses such a row (:func:`_check_kernel_inputs`). On a CPU tensor each step
runs its plain PyTorch version beside it (:func:`_reference_fwd`,
:func:`_reference_bwd`).
There is no other path: no library attention call and no fallback from one
kernel to another.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.op_builder import LAUNCHES, CudaKernelLib

NEG_INF = -1e30

# The TPU kernel's tile cap. The CUDA kernel tiles by itself; the cap stays
# because it decides which sequence lengths the model's prefill sends here
# (supports_seq_len), and both packages must take the same path.
_DEFAULT_BLOCK = 512

KERNEL_LIB = CudaKernelLib("flash_fwd.cu")  # built and loaded at the first launch
BWD_KERNEL_LIB = CudaKernelLib("flash_bwd.cu")
LAUNCHES["flash_fwd"] = 0
LAUNCHES["flash_bwd_dq"] = 0
LAUNCHES["flash_bwd_dkv"] = 0
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64, 128)
# the dtypes whose forward and backward run the tensor-core kernels of
# flash_fwd.cu and flash_bwd.cu; float32 runs their f32 FMA kernels
TENSOR_CORE_DTYPES = (torch.float16, torch.bfloat16)


def _blk(size: int, cap: int) -> int:
    return min(cap, size)


def supports_seq_len(size: int) -> bool:
    """True when the reference's auto-tiler can cover a sequence of this
    length; the prefill gate in ``models/transformer.py`` uses it so that the
    port and the reference send the same lengths to flash attention."""
    return size <= _DEFAULT_BLOCK or size % 64 == 0


def _auto_block(size: int, cap: Optional[int]) -> int:
    """The reference's tile size for ``size``: ``size`` itself when it fits
    under the cap, else the largest of 512/256/128/64 that divides it."""
    if cap is not None:
        return _blk(size, cap)
    cap = _DEFAULT_BLOCK
    if size <= cap:
        return size
    b = cap
    while b >= 64:
        if size % b == 0:
            return b
        b //= 2
    raise ValueError(
        f"flash attention auto-tiling needs the sequence length ({size}) to be "
        f"divisible by 64; pad the sequence or pass block_q/block_k explicitly")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = KERNEL_LIB.load().dstorch_flash_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = BWD_KERNEL_LIB.load()
    head = [ctypes.c_int] + [ctypes.c_void_p] * 6
    tail = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dq, dkv = lib.dstorch_flash_bwd_dq, lib.dstorch_flash_bwd_dkv
    dq.argtypes = head + [ctypes.c_void_p] + [ctypes.c_int] * 6 + tail
    dkv.argtypes = head + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + tail
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _rows_16b_aligned(t) -> bool:
    """True when the tensor-core kernels' 16-byte copies can read ``t``
    (B, S, H, hd) as it is: a 16-byte aligned base and (batch, seq, head)
    strides of 8 elements (16 bytes in a 16-bit dtype)."""
    return t.data_ptr() % 16 == 0 and all(t.stride(i) % 8 == 0 for i in range(3))


def _tensor_core_rows(t):
    """``t`` itself when its rows are 16-byte aligned, else a contiguous copy
    (a fresh allocation, aligned even where ``t`` is already contiguous).
    A ``t`` whose last dimension is not contiguous is left as it is: every
    kernel wrapper refuses it, whatever the dtype, so the copy changes only
    where rows start, never which layouts the entry points take."""
    if t.stride(-1) != 1 or _rows_16b_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention takes (B, S, H, hd) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"query heads ({H}) must be a multiple of kv heads ({k.shape[2]})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, {v.device}")


def _mask(S: int, Sk: int, causal: bool, window: Optional[int], device):
    """(S, Sk) bool mask of the pairs attention may use, or None for all."""
    mask = None
    if causal:
        mask = torch.ones((S, Sk), dtype=torch.bool, device=device).tril()
    if window is not None:
        qp = torch.arange(S, device=device)[:, None]
        kp = torch.arange(Sk, device=device)[None, :]
        local = qp - kp < window
        mask = local if mask is None else mask & local
    return mask


def _repeat_kv(t, group: int):
    return t if group == 1 else t.repeat_interleave(group, dim=2)


def _reference_fwd(q, k, v, causal: bool, sm_scale: float,
                   window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (o, lse) with o in q's dtype and
    lse f32 (B, H, Sq, 1). f32 math throughout, as the reference's
    ``mha_reference``."""
    group = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return o, lse


def _delta(o, do) -> torch.Tensor:
    """rowsum(do * o) in f32, laid out (B, H, Sq) like lse (the reference's
    ``_bwd`` computes it outside its kernels too)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _reference_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float,
                   window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) in the
    inputs' dtypes from the forward's o and f32 lse (B, H, Sq, 1). f32 math
    throughout; GQA's dk/dv are summed over each kv head's query heads after
    each head's partial is rounded to the input dtype, as the reference's
    ``_bwd`` sums its per-head ``dk_full``/``dv_full``."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf, dof = q.float(), do.float()
    kf, vf = _repeat_kv(k, group).float(), _repeat_kv(v, group).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    mask = _mask(Sq, Sk, causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(o, do)[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    if group > 1:
        dk = dk.to(k.dtype).float().reshape(B, Sk, Hkv, group, hd).sum(3)
        dv = dv.to(v.dtype).float().reshape(B, Sk, Hkv, group, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v, *more):
    """What every kernel wrapper (K1, K2, K3) checks before its launch: dtype,
    head dim, contiguous last dims, one dtype, extents, and for the
    tensor-core dtypes 16-byte aligned rows (the entry points copy any that
    are not first, :func:`_tensor_core_rows`). ``more``: the backward's do."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32/float16/bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of {HEAD_DIMS}, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v, *more)):
        raise ValueError("flash kernel needs q/k/v with a contiguous last dimension")
    if any(t.dtype != q.dtype for t in more):
        raise TypeError(f"flash kernel: do must be in q's dtype {q.dtype}")
    if Sq == 0 or Sk == 0 or B * H > 65535:
        raise ValueError(f"flash kernel: unsupported extent B*H={B * H}, Sq={Sq}, Sk={Sk}")
    if q.dtype in TENSOR_CORE_DTYPES and not all(
            _rows_16b_aligned(t) for t in (q, k, v, *more)):
        raise ValueError("flash kernel: 16-bit q/k/v/do rows must be 16-byte aligned "
                         "(pass them through _tensor_core_rows)")


def _cuda_fwd(q, k, v, causal: bool, sm_scale: float,
              window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Hkv, Sq, Sk, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(sm_scale), int(causal), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (cudaError {rc})")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _cuda_bwd_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                 window: Optional[int]) -> torch.Tensor:
    """K2: dq (B, Sq, H, hd) in q's dtype."""
    _check_kernel_inputs(q, k, v, do)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, do) for i in range(3)))
    with torch.cuda.device(q.device):
        rc = _bwd_kernels()[0](
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Hkv, Sq, Sk, hd,
            strides, float(sm_scale), int(causal), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed (cudaError {rc})")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _cuda_bwd_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                  window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: dk, dv (B, Sk, Hkv, hd) in k's dtype, summed over each kv head's
    query heads inside the kernel."""
    _check_kernel_inputs(q, k, v, do)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dk = torch.empty((B, Sk, Hkv, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, Hkv, hd), dtype=v.dtype, device=v.device)
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, do) for i in range(3)))
    with torch.cuda.device(q.device):
        rc = _bwd_kernels()[1](
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Hkv, Sq, Sk, hd, strides, float(sm_scale), int(causal), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed (cudaError {rc})")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _resolve(q, k, causal: bool, sm_scale: Optional[float],
             window: Optional[int]) -> Tuple[float, Optional[int]]:
    """The call's sm_scale and window, checked as the reference checks them."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if window is not None:
        if not causal:
            raise ValueError("sliding-window flash attention requires causal=True")
        if q.shape[1] != k.shape[1]:
            raise ValueError("sliding-window flash attention requires equal q/k sequence lengths")
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    return sm_scale, window


def _device_type(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    return q.device.type


def _fwd(q, k, v, causal: bool, sm_scale: float, window: Optional[int]):
    """The forward on checked inputs: on a CUDA tensor K1 (the tensor-core
    variant on rows made 16-byte aligned), on a CPU tensor the plain
    version."""
    if _device_type(q) == "cpu":
        return _reference_fwd(q, k, v, causal, sm_scale, window)
    if q.dtype in TENSOR_CORE_DTYPES:
        q, k, v = (_tensor_core_rows(t) for t in (q, k, v))
    return _cuda_fwd(q, k, v, causal, sm_scale, window)


def _bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float, window: Optional[int]):
    """The backward on checked inputs: on a CUDA tensor delta in f32, then
    K2 and K3 (the tensor-core variant on rows made 16-byte aligned); on a
    CPU tensor the plain version."""
    if _device_type(q) == "cpu":
        return _reference_bwd(q, k, v, o, lse, do, causal, sm_scale, window)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if q.dtype in TENSOR_CORE_DTYPES:
        q, k, v, do = (_tensor_core_rows(t) for t in (q, k, v, do))
    delta = _delta(o, do)
    lse = lse.contiguous()
    dq = _cuda_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale, window)
    dk, dv = _cuda_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale, window)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o (B, Sq, H, hd) in q's dtype, lse f32 (B, H, Sq, 1). The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check_inputs(q, k, v)
    sm_scale, window = _resolve(q, k, causal, sm_scale, window)
    return _fwd(q, k, v, causal, sm_scale, window)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) from the forward's inputs, o and lse, and the output
    gradient ``do`` (B, Sq, H, hd). On a CUDA tensor: delta in f32, then the
    dq kernel (K2) and the dk/dv kernel (K3); on a CPU tensor the plain
    version."""
    _check_inputs(q, k, v)
    sm_scale, window = _resolve(q, k, causal, sm_scale, window)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} must match q {tuple(q.shape)}")
    B, Sq, H, _ = q.shape
    if lse.shape != (B, H, Sq, 1) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(B, H, Sq, 1)}, got {lse.dtype} {tuple(lse.shape)}")
    return _bwd(q, k, v, o, lse, do, causal, sm_scale, window)


class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP (``_flash_bhsd``): forward K1, saving
    (q, k, v, o, lse); backward K2 and K3. Takes inputs that
    :func:`flash_attention` has already checked and resolved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = _fwd(q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None, block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention on (B, S, H, head_dim) tensors (GQA via fewer KV
    heads), differentiable in q, k and v. ``block_q``/``block_k`` are the
    TPU kernel's tile hints: accepted for the reference's signature, unused
    (the CUDA kernels tile by themselves and mask ragged edges).
    ``window``: static sliding window, each query attends keys in
    ``(qpos - window, qpos]``; requires ``causal`` and equal q/k lengths."""
    _check_inputs(q, k, v)
    sm_scale, window = _resolve(q, k, causal, sm_scale, window)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return _fwd(q, k, v, causal, sm_scale, window)[0]
    return _FlashAttention.apply(q, k, v, causal, sm_scale, window)


def mha_reference(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch attention, the kernel's reference (f32 math, output in
    q's dtype), on any device."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _reference_fwd(q, k, v, causal, sm_scale, window)[0]
