"""Flash attention forward on (B, S, H, head_dim) tensors.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``, forward only:
the backward kernels (dq and dk/dv) come with the training slice, and until
then a call that would need a gradient raises.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel ``ops/csrc/flash_fwd.cu`` (built on first use, see ``op_builder``) or
raises; on a CPU tensor it runs the plain PyTorch version beside it
(:func:`mha_reference`). There is no other path: no library attention call
and no fallback from one to the other.
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
LAUNCHES["flash_fwd"] = 0
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64, 128)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention is forward-only in the port until the backward "
            "kernels land (ROADMAP.md, Queue 2: K2/K3)")


def _reference_fwd(q, k, v, causal: bool, sm_scale: float,
                   window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (o, lse) with o in q's dtype and
    lse f32 (B, H, Sq, 1). f32 math throughout, as the reference's
    ``mha_reference``."""
    H, Hkv = q.shape[2], k.shape[2]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    S, Sk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device).tril()
    if window is not None:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(Sk, device=q.device)[None, :]
        local = qp - kp < window
        mask = local if mask is None else mask & local
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return o, lse


def _cuda_fwd(q, k, v, causal: bool, sm_scale: float,
              window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32/float16/bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of {HEAD_DIMS}, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs q/k/v with a contiguous last dimension")
    if Sq == 0 or Sk == 0 or B * H > 65535:
        raise ValueError(f"flash kernel: unsupported extent B*H={B * H}, Sq={Sq}, Sk={Sk}")
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


def flash_attention_fwd(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o (B, Sq, H, hd) in q's dtype, lse f32 (B, H, Sq, 1). The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check_inputs(q, k, v)
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
    if q.device.type == "cuda":
        return _cuda_fwd(q, k, v, causal, sm_scale, window)
    if q.device.type == "cpu":
        return _reference_fwd(q, k, v, causal, sm_scale, window)
    raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None, block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention on (B, S, H, head_dim) tensors (GQA via fewer KV
    heads); forward only. ``block_q``/``block_k`` are the TPU kernel's tile
    hints: accepted for the reference's signature, unused (the CUDA kernel
    tiles by itself and masks ragged edges). ``window``: static sliding
    window, each query attends keys in ``(qpos - window, qpos]``; requires
    ``causal`` and equal q/k lengths."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale, window=window)[0]


def mha_reference(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch attention, the kernel's reference (f32 math, output in
    q's dtype), on any device."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _reference_fwd(q, k, v, causal, sm_scale, window)[0]
