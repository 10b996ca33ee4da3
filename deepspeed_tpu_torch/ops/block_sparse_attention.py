"""Block-sparse attention on (B, S, H, hd) tensors, forward and backward.

Counterpart of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``:
:func:`block_sparse_attention` attends only the (query tile, key tile) pairs
whose entry of a block-level layout (H, S/b, S/b) is nonzero, with square
tiles b = min(block, S) and an optional causal mask. It is differentiable
through a ``torch.autograd.Function`` (the reference's custom VJP) whose
forward saves (q, k, v, o, lse) and whose backward computes
``delta = rowsum(do * o)`` in f32 and then dq and dk/dv. All arithmetic is
f32, as in the reference's kernels; outputs are in the input dtype.

On a CUDA tensor each step launches a hand-written Hopper kernel or raises:
the forward ``ops/csrc/block_sparse_fwd.cu`` (K4, the counterpart of the
reference's ``_sparse_fwd_kernel``), the backward's dq and dk/dv
``ops/csrc/block_sparse_bwd.cu`` (K5, K6), each built on first use (see
``op_builder``). The kernels walk lists of the live tiles built from the
layout on the host once per (layout, causal) and kept on the card
(:func:`tile_lists`); under causal the lists leave out the tiles wholly
above the diagonal, which add nothing. Each of the three has two variants,
chosen from the dtype and the tile alone (:func:`kernel_variant` names it):
float16 and bfloat16 at tile 64 run the tensor-core (wgmma) kernels, which
take their blocks longest list first from the lists' launch orders and need
16-byte aligned rows (the forward and the backward copy any that are not,
as the flash kernels do); float32 and tiles 16 and 32 run the f32 FMA
kernels. The tensor-core kernels keep the reference's f32 arithmetic: q kᵀ
and do vᵀ multiply 16-bit inputs exactly, and the f32 operands p and ds go
through their products as three bfloat16 (two float16) parts, each tile's
product summed in f32. K4's work at the block-sparse training shape is
15.3 GFLOP over 51 MB, at the bf16 tensor cores' ridge; its parts make the
tensor cores do twice that. On a CPU tensor each step runs its plain
PyTorch version (:func:`_reference_fwd`, :func:`_reference_bwd`). There is
no other path: no library attention call and no fallback from one kernel to
another.
"""

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.flash_attention import (_DTYPE_CODE, HEAD_DIMS, NEG_INF,
                                                     TENSOR_CORE_DTYPES, _delta,
                                                     _rows_16b_aligned, _tensor_core_rows)
from deepspeed_tpu_torch.ops.op_builder import LAUNCHES, CudaKernelLib

FWD_KERNEL_LIB = CudaKernelLib("block_sparse_fwd.cu")  # built and loaded at the first launch
BWD_KERNEL_LIB = CudaKernelLib("block_sparse_bwd.cu")
LAUNCHES["block_sparse_fwd"] = 0
LAUNCHES["block_sparse_bwd_dq"] = 0
LAUNCHES["block_sparse_bwd_dkv"] = 0
BLOCKS = (16, 32, 64, 128)  # the layout blocks the kernels take
MAX_TILE = 64  # the kernels' tile: a 128 block is split into 2 x 2 tiles of 64


def kernel_variant(dtype: torch.dtype, tile: int) -> str:
    """Which kernels (K4, K5 and K6 alike) run for inputs of ``dtype`` at
    ``tile`` rows: ``"tensor_core"`` (wgmma m64n64k16, 64-row tiles) for
    float16 and bfloat16 at tile 64, ``"f32_fma"`` otherwise (float32, which
    the tensor cores would take only as TF32, and tiles 16 and 32, under a
    wgmma's 64 rows). Both do the TPU kernels' f32 arithmetic. The kernels'
    C entry points make the same choice from the same two facts; this
    function decides which rows the forward and the backward copy, and names
    the variant in reports."""
    return "tensor_core" if dtype in TENSOR_CORE_DTYPES and tile == MAX_TILE else "f32_fma"


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    fn = FWD_KERNEL_LIB.load().dstorch_block_sparse_fwd
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = BWD_KERNEL_LIB.load()
    tail = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dq, dkv = lib.dstorch_block_sparse_bwd_dq, lib.dstorch_block_sparse_bwd_dkv
    dq.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + tail
    dkv.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + tail
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


# ---------------------------------------------------------------------------
# shapes, layouts and tile lists
# ---------------------------------------------------------------------------

def _shapes(q, k, block: int):
    """(b, nq, nk) as the reference's ``_shapes``: square tiles
    b = min(block, Sq, Sk) that must divide both lengths."""
    Sq, Sk = q.shape[1], k.shape[1]
    b = min(block, Sq, Sk)
    if Sq % b or Sk % b:
        raise ValueError(f"block-sparse attention needs the sequence lengths ({Sq}, {Sk}) "
                         f"to be multiples of the block {b}")
    return b, Sq // b, Sk // b


def _as_layout(layout) -> np.ndarray:
    if torch.is_tensor(layout):
        layout = layout.detach().cpu().numpy()
    return np.asarray(layout)


def _check_inputs(q, k, v, layout: np.ndarray, block: int) -> int:
    """Check q/k/v (B, S, H, hd) and the layout; return the tile b."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"block-sparse attention takes (B, S, H, hd) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if k.shape[2] != H:
        raise ValueError(f"block-sparse attention takes as many kv heads as query heads "
                         f"({k.shape[2]} != {H}); repeat the kv heads first, as the model does")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"block-sparse attention runs on cuda or cpu tensors, got {q.device}")
    b, nq, nk = _shapes(q, k, block)
    if layout.shape != (H, nq, nk):
        raise ValueError(f"layout shape {layout.shape} != (heads, Sq/b, Sk/b) = {(H, nq, nk)} "
                         f"for block {b}")
    return b


def _longest_first(ptr: np.ndarray) -> np.ndarray:
    """Every (head, tile) list of the CSR lists ``ptr`` (H * n + 1 offsets)
    as h * n + tile, longest list first; lists of equal length in ascending
    order of that number (a stable sort)."""
    return np.argsort(-np.diff(ptr), kind="stable").astype(np.int32)


def tile_lists(layout, block: int, causal: bool) -> Dict[str, np.ndarray]:
    """The live tiles of a layout as the kernels walk them, in numpy.

    The layout block ``block`` is split into tiles of ``tile = min(block,
    64)`` rows; under ``causal`` the tiles wholly above the diagonal
    (ki > qi) are dropped. Per head, CSR-style int32 lists:
    ``row_ptr`` (H * nq + 1 offsets) into ``cols``, the live k-tiles of each
    q-tile in ascending order (K4, K5); ``col_ptr`` (H * nk + 1) into
    ``rows``, the live q-tiles of each k-tile in ascending order (K6).
    ``row_order`` (the tensor-core K4 and K5) and ``col_order`` (K6): launch
    orders, every (h, tile) list as h * n + tile, the longest first
    (:func:`_longest_first`); the kernels run the batch rows of each entry
    one after another. A block still walks its list in ascending order, so
    the order decides when a block runs and never the order of a sum."""
    tile = min(block, MAX_TILE)
    live = _as_layout(layout) > 0
    if block > tile:
        r = block // tile
        live = live.repeat(r, axis=1).repeat(r, axis=2)
    if causal:
        live = live & np.tri(live.shape[1], live.shape[2], dtype=bool)

    def csr(m):
        ptr = np.concatenate([[0], np.cumsum(m.sum(-1).reshape(-1))]).astype(np.int32)
        return ptr, np.nonzero(m)[2].astype(np.int32)

    row_ptr, cols = csr(live)
    col_ptr, rows = csr(live.transpose(0, 2, 1))
    return {"tile": tile, "row_ptr": row_ptr, "cols": cols, "col_ptr": col_ptr, "rows": rows,
            "row_order": _longest_first(row_ptr), "col_order": _longest_first(col_ptr)}


@functools.lru_cache(maxsize=32)
def _device_tile_lists(shape, packed: bytes, block: int, causal: bool, device: torch.device):
    live = np.unpackbits(np.frombuffer(packed, np.uint8), count=int(np.prod(shape)))
    lists = tile_lists(live.reshape(shape), block, causal)
    return lists["tile"], {name: torch.from_numpy(a).to(device)
                           for name, a in lists.items() if name != "tile"}


def _lists_on(layout: np.ndarray, block: int, causal: bool, device):
    """(tile, tile lists and launch orders on ``device``), built once per
    (layout, block, causal, device): the cache is keyed by the layout's live
    bits, so a caller may pass a new array with the same entries and hit
    it."""
    live = layout > 0
    return _device_tile_lists(live.shape, np.packbits(live).tobytes(), block, bool(causal),
                              torch.device(device))


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------

def _mask(layout: np.ndarray, b: int, Sq: int, Sk: int, causal: bool, device):
    """(H, Sq, Sk) bool mask of the pairs the layout and causal let through."""
    live = torch.as_tensor(layout > 0, device=device)
    mask = live.repeat_interleave(b, dim=1).repeat_interleave(b, dim=2)
    if causal:
        mask = mask & torch.ones((Sq, Sk), dtype=torch.bool, device=device).tril()
    return mask


def _reference_fwd(q, k, v, layout: np.ndarray, b: int, causal: bool,
                   sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: (o, lse) with o in q's dtype and lse f32
    (B, H, Sq, 1); f32 math. A row that nothing may attend gets o = 0 and
    lse = -1e30 + log(1e-20), as the TPU kernel gives."""
    mask = _mask(layout, b, q.shape[1], k.shape[1], causal, q.device)[None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.transpose(1, 2)
    return o.to(q.dtype), m + torch.log(l)


def _reference_bwd(q, k, v, o, lse, do, layout: np.ndarray, b: int, causal: bool,
                   sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 and K6: (dq, dk, dv) in the inputs'
    dtypes from the forward's o and f32 lse (B, H, Sq, 1); f32 math."""
    mask = _mask(layout, b, q.shape[1], k.shape[1], causal, q.device)[None]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse).masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(o, do)[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_kernel_inputs(q, k, v, b: int, *more, aligned_rows: bool = False):
    """What every kernel wrapper (K4, K5, K6) checks before its launch:
    dtype, head dim, block, contiguous last dims, one dtype, extents, and,
    with ``aligned_rows`` (the tensor-core variant), 16-byte aligned rows
    (the forward and the backward copy any that are not first,
    ``_tensor_core_rows``). ``more``: the backward's do."""
    B, _, H, hd = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"block-sparse kernel takes float32/float16/bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"block-sparse kernel head_dim must be one of {HEAD_DIMS}, got {hd}")
    if b not in BLOCKS:
        raise ValueError(f"block-sparse kernel block must be one of {BLOCKS}, got {b}")
    if any(t.stride(-1) != 1 for t in (q, k, v, *more)):
        raise ValueError("block-sparse kernel needs q/k/v with a contiguous last dimension")
    if any(t.dtype != q.dtype for t in more):
        raise TypeError(f"block-sparse kernel: do must be in q's dtype {q.dtype}")
    if B * H > 65535:
        raise ValueError(f"block-sparse kernel: unsupported extent B*H={B * H}")
    if aligned_rows and not all(_rows_16b_aligned(t) for t in (q, k, v, *more)):
        raise ValueError("block-sparse kernel: 16-bit q/k/v/do rows must be 16-byte aligned "
                         "for the tensor-core variant (pass them through _tensor_core_rows)")


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(t.stride(i) for t in tensors for i in range(3)))


def _setup(q, k, v, layout, b, causal, *more):
    """The checks and lists every kernel wrapper needs: (variant, tile,
    lists on q's device). ``more``: the backward's do."""
    tile = min(b, MAX_TILE)
    variant = kernel_variant(q.dtype, tile)
    _check_kernel_inputs(q, k, v, b, *more, aligned_rows=variant == "tensor_core")
    return variant, *_lists_on(layout, b, causal, q.device)


def _cuda_fwd(q, k, v, layout, b, causal, sm_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (o (B, Sq, H, hd) in q's dtype, lse f32 (B, H, Sq, 1))."""
    variant, tile, lists = _setup(q, k, v, layout, b, causal)
    B, Sq, H, hd = q.shape
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _fwd_kernel()(
            _DTYPE_CODE[q.dtype], hd, tile, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), lists["row_ptr"].data_ptr(), lists["cols"].data_ptr(),
            lists["row_order"].data_ptr(), B, H, Sq, k.shape[1], Sq // tile,
            _strides(q, k, v), float(sm_scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_sparse_fwd kernel ({variant}) launch failed (cudaError {rc})")
    LAUNCHES["block_sparse_fwd"] += 1
    return o, lse


def _cuda_bwd_dq(q, k, v, do, lse, delta, layout, b, causal, sm_scale) -> torch.Tensor:
    """K5: dq (B, Sq, H, hd) in q's dtype."""
    variant, tile, lists = _setup(q, k, v, layout, b, causal, do)
    B, Sq, H, hd = q.shape
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _bwd_kernels()[0](
            _DTYPE_CODE[q.dtype], hd, tile, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            lists["row_ptr"].data_ptr(), lists["cols"].data_ptr(), lists["row_order"].data_ptr(),
            B, H, Sq, k.shape[1], Sq // tile,
            _strides(q, k, v, do), float(sm_scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_sparse_bwd_dq kernel ({variant}) launch failed (cudaError {rc})")
    LAUNCHES["block_sparse_bwd_dq"] += 1
    return dq


def _cuda_bwd_dkv(q, k, v, do, lse, delta, layout, b, causal,
                  sm_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: dk, dv (B, Sk, H, hd) in k's dtype."""
    variant, tile, lists = _setup(q, k, v, layout, b, causal, do)
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    dk = torch.empty((B, Sk, H, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, H, hd), dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        rc = _bwd_kernels()[1](
            _DTYPE_CODE[q.dtype], hd, tile, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lists["col_ptr"].data_ptr(), lists["rows"].data_ptr(), lists["col_order"].data_ptr(),
            B, H, Sq, Sk, Sk // tile,
            _strides(q, k, v, do), float(sm_scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_sparse_bwd_dkv kernel ({variant}) launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["block_sparse_bwd_dkv"] += 1
    return dk, dv


def _device_type(q) -> str:
    return q.device.type


def _fwd(q, k, v, layout, b, causal, sm_scale):
    """The forward on checked inputs: K4 on a CUDA tensor (for the
    tensor-core variant on rows made 16-byte aligned), the plain version on
    a CPU tensor."""
    if _device_type(q) == "cpu":
        return _reference_fwd(q, k, v, layout, b, causal, sm_scale)
    if kernel_variant(q.dtype, min(b, MAX_TILE)) == "tensor_core":
        q, k, v = (_tensor_core_rows(t) for t in (q, k, v))
    return _cuda_fwd(q, k, v, layout, b, causal, sm_scale)


def _bwd(q, k, v, o, lse, do, layout, b, causal, sm_scale):
    """The backward on checked inputs: on a CUDA tensor delta in f32, then
    K5 and K6 (for the tensor-core variant on rows made 16-byte aligned); on
    a CPU tensor the plain version."""
    if _device_type(q) == "cpu":
        return _reference_bwd(q, k, v, o, lse, do, layout, b, causal, sm_scale)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if kernel_variant(q.dtype, min(b, MAX_TILE)) == "tensor_core":
        q, k, v, do = (_tensor_core_rows(t) for t in (q, k, v, do))
    delta = _delta(o, do)
    lse = lse.contiguous()
    dq = _cuda_bwd_dq(q, k, v, do, lse, delta, layout, b, causal, sm_scale)
    dk, dv = _cuda_bwd_dkv(q, k, v, do, lse, delta, layout, b, causal, sm_scale)
    return dq, dk, dv


def _resolve(q, k, v, layout, block, sm_scale):
    layout = _as_layout(layout)
    b = _check_inputs(q, k, v, layout, block)
    return layout, b, (1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale)


def block_sparse_attention_fwd(q, k, v, layout, causal: bool = False,
                               sm_scale: Optional[float] = None,
                               block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o (B, Sq, H, hd) in q's dtype, lse f32 (B, H, Sq, 1). The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    layout, b, sm_scale = _resolve(q, k, v, layout, block, sm_scale)
    return _fwd(q, k, v, layout, b, causal, sm_scale)


def block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal: bool = False,
                               sm_scale: Optional[float] = None,
                               block: int = 128) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) from the forward's inputs, o and lse, and the output
    gradient ``do`` (B, Sq, H, hd). On a CUDA tensor: delta in f32, then the
    dq kernel (K5) and the dk/dv kernel (K6); on a CPU tensor the plain
    version."""
    layout, b, sm_scale = _resolve(q, k, v, layout, block, sm_scale)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} must match q {tuple(q.shape)}")
    B, Sq, H, _ = q.shape
    if lse.shape != (B, H, Sq, 1) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(B, H, Sq, 1)}, got {lse.dtype} {tuple(lse.shape)}")
    return _bwd(q, k, v, o, lse, do, layout, b, causal, sm_scale)


class _BlockSparseAttention(torch.autograd.Function):
    """The reference's custom VJP (``_sparse_bhsd``): forward K4, saving
    (q, k, v, o, lse); backward K5 and K6. Takes inputs that
    :func:`block_sparse_attention` has already checked and resolved."""

    @staticmethod
    def forward(ctx, q, k, v, layout, b, causal, sm_scale):
        o, lse = _fwd(q, k, v, layout, b, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (layout, b, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def block_sparse_attention(q, k, v, layout, causal: bool = False,
                           sm_scale: Optional[float] = None, block: int = 128) -> torch.Tensor:
    """Block-sparse attention on (B, S, H, hd); layout (H, S/b, S/b) int
    from a SparsityConfig, b = min(block, S). Differentiable in q, k and v."""
    layout, b, sm_scale = _resolve(q, k, v, layout, block, sm_scale)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return _fwd(q, k, v, layout, b, causal, sm_scale)[0]
    return _BlockSparseAttention.apply(q, k, v, layout, b, causal, sm_scale)


def sparse_attention_reference(q, k, v, layout, block: int, causal: bool = False,
                               sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense plain-PyTorch reference applying the expanded block mask (the
    reference's ``sparse_attention_reference``), on any device."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    S, Sk = q.shape[1], k.shape[1]
    mask = _mask(_as_layout(layout), block, S, Sk, causal, q.device)[None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class SparseSelfAttention:
    """The reference's ``SparseSelfAttention``: a sparsity config, a causal
    flag and a per-length layout cache, called on (B, S, H, hd)."""

    def __init__(self, sparsity_config, causal: bool = False, block_override: Optional[int] = None):
        self.config = sparsity_config
        self.causal = causal
        self.block = block_override or sparsity_config.block
        self._layout_cache = {}

    def layout(self, seq_len: int) -> np.ndarray:
        """The config's int32 layout for ``seq_len``, made once and read-only."""
        if seq_len not in self._layout_cache:
            layout = np.asarray(self.config.make_layout(seq_len), np.int32)
            layout.setflags(write=False)
            self._layout_cache[seq_len] = layout
        return self._layout_cache[seq_len]

    def __call__(self, q, k, v):
        return block_sparse_attention(q, k, v, self.layout(q.shape[1]), causal=self.causal,
                                      block=self.block)
