"""Fused LayerNorm / RMSNorm over the last dimension, forward and backward.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_norm.py``:
:func:`fused_layernorm` and :func:`fused_rmsnorm` take any leading shape,
reshape it to rows (N, D), and are differentiable through one
``torch.autograd.Function`` (the reference's custom VJP) whose forward saves
(x, scale, bias, mu, rstd) and whose backward returns dx in x's dtype, dscale
in scale's dtype and dbias in bias's dtype (None without a bias). The math is
f32 throughout: two-pass mean and population variance (RMSNorm: mu = 0, var =
mean(x²)), rstd = rsqrt(var + eps), out = (x − mu)·rstd·scale (+ bias). The
model's ``_norm`` (``models/transformer.py``) runs through :func:`_fused_norm`,
so every LayerNorm and RMSNorm of the training and serving paths is K7/K8 on
the card.

On a CUDA tensor each direction launches a hand-written Hopper kernel or
raises: the forward K7 and the backward K8, both in ``ops/csrc/fused_norm.cu``,
built on first use (see ``op_builder``). As the reference's ``_run_bwd`` sums
its per-block partials of dscale and dbias outside its kernel, K8 writes one
f32 partial row per block and a second kernel of the same launch adds them
in a fixed order (no atomics, so two calls give the same bits) and writes
dscale and dbias in the dtypes asked for: no ``torch.sum`` and no cast after
it. One K8 launch in :data:`LAUNCHES` is that pair. On a CPU tensor each
direction runs its plain PyTorch version beside it (:func:`_reference_fwd`,
:func:`_reference_bwd`). There is no other path: no library norm call and no
fallback from one to the other.

The kernels take contiguous rows: a non-contiguous x (or output gradient) is
copied to a contiguous one first. :func:`kernel_variant` names the kernel a
call runs, from (D, dtype) and where the rows start, never after a failure:
``"vector"`` (16-byte loads and stores: D a multiple of 16 bytes' worth of
elements and the row tensors 16-byte aligned), ``"scalar"`` (element loads,
any D and base) and ``"wide"`` (rows wider than a block holds in registers).
Scale and bias reach the kernels in x's dtype or in f32; any other mix is cast
to f32 first, which is exact.
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
_VARIANT_CODE = {"scalar": 0, "vector": 1, "wide": 2}
# fused_norm.cu's register kernels: most and fewest threads a block, 16-byte
# chunks a thread (checked against the library's own when it loads)
BLOCK_THREADS = 256
MIN_BLOCK_THREADS = 128
MAX_CHUNKS = 4


class _Plan(ctypes.Structure):
    """The kernels' plan for one call shape: fused_norm.cu's ``PlanField``,
    field for field, in its order."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "dtype", "wdtype", "variant", "tpr", "rpb", "chunks", "grid", "n", "d", "rms",
        "sdtype", "bdtype", "device")]

    def __repr__(self):
        return repr({name: getattr(self, name) for name, _ in self._fields_})


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = KERNEL_LIB.load()
    layout = (ctypes.c_int * 5)()
    lib.dstorch_fused_norm_layout(layout)
    ours = (len(_Plan._fields_), _Plan.grid.offset // ctypes.sizeof(ctypes.c_int),
            BLOCK_THREADS, MIN_BLOCK_THREADS, MAX_CHUNKS)
    if tuple(layout) != ours:
        raise RuntimeError(f"fused_norm.cu's plan and limits {tuple(layout)} are not the "
                           f"wrapper's {ours} (fields, grid field, block threads, fewest "
                           f"block threads, chunks)")
    fwd, bwd = lib.dstorch_fused_norm_fwd, lib.dstorch_fused_norm_bwd
    occupancy = lib.dstorch_fused_norm_blocks_per_sm
    ptr, plan = ctypes.c_void_p, ctypes.POINTER(_Plan)
    fwd.argtypes = [plan, ptr, ptr, ptr, ptr, ptr, ctypes.c_float, ptr]
    bwd.argtypes = [plan, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    occupancy.argtypes = [plan, ctypes.c_int]
    fwd.restype = bwd.restype = occupancy.restype = ctypes.c_int
    return fwd, bwd, occupancy


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _geometry(D: int, dtype: torch.dtype) -> Optional[Tuple[int, int, int]]:
    """(threads per row, rows per block, 16-byte chunks per thread) of the
    register kernels for rows of width D: the fewest threads, from one warp
    up to BLOCK_THREADS, that hold the row in at most MAX_CHUNKS chunks each,
    in blocks of at least MIN_BLOCK_THREADS; None when a row is wider than
    that (the wide kernels)."""
    vec = 16 // dtype.itemsize
    tpr = 32
    while tpr * MAX_CHUNKS * vec < D:
        tpr *= 2
    if tpr > BLOCK_THREADS:
        return None
    return tpr, max(1, MIN_BLOCK_THREADS // tpr), -(-D // (tpr * vec))


def kernel_variant(D: int, dtype: torch.dtype, *rows: torch.Tensor) -> str:
    """The kernel a call on rows of width D runs: "wide" for rows wider than
    the register kernels hold, else "vector" when D is a multiple of 16
    bytes' worth of elements and every row tensor (x, do) starts on 16 bytes,
    else "scalar"."""
    if _geometry(D, dtype) is None:
        return "wide"
    if D % (16 // dtype.itemsize) == 0 and all(t.data_ptr() % 16 == 0 for t in rows):
        return "vector"
    return "scalar"


def _grid(N: int, rows_per_block: int, blocks_per_sm: int, sm_count: int) -> int:
    """Blocks of a register kernel: as many as the card holds at once
    (blocks_per_sm on each SM), or fewer when the rows need fewer; each row
    group then walks rows with the grid's stride."""
    return max(1, min(-(-N // rows_per_block), blocks_per_sm * sm_count))


@functools.lru_cache(maxsize=4096)  # a few per model; prefill lengths vary N
def _plan(bwd: bool, N: int, D: int, dtype: torch.dtype, wdtype: torch.dtype, variant: str,
          rms: bool, device_index: int, sdtype: torch.dtype = torch.float32,
          bdtype: torch.dtype = torch.float32):
    """The kernels' :class:`_Plan` for one call shape, built once: the wide
    K7 runs a block a row, the wide K8 about two blocks an SM over ranges of
    rows, the register kernels ``_grid`` blocks at their occupancy on this
    card. ``plan.grid`` is also the rows of K8's partials."""
    tpr, rpb, chunks = (0, 1, 0) if variant == "wide" else _geometry(D, dtype)
    plan = _Plan(dtype=_DTYPE_CODE[dtype], wdtype=_DTYPE_CODE[wdtype],
                 variant=_VARIANT_CODE[variant], tpr=tpr, rpb=rpb, chunks=chunks, grid=1, n=N,
                 d=D, rms=int(rms), sdtype=_DTYPE_CODE[sdtype], bdtype=_DTYPE_CODE[bdtype],
                 device=device_index)
    sms = _sm_count(device_index)
    if variant == "wide":
        plan.grid = min(N, 2 * sms) if bwd else N
        return plan
    blocks = _kernels()[2](plan, int(bwd))
    if blocks < 1:
        raise RuntimeError(f"fused norm: no occupancy for the plan {plan!r} ({blocks})")
    plan.grid = _grid(N, rpb, blocks, sms)
    return plan


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


def _kernel_weights(dtype, scale, bias=None):
    """scale and bias as the kernels take them: contiguous, and both of x's
    dtype or both f32 (any other mix cast to f32, which is exact)."""
    if scale.dtype not in (dtype, torch.float32) or (bias is not None
                                                     and bias.dtype != scale.dtype):
        scale = scale.float()
        bias = bias.float() if bias is not None else None
    return scale.contiguous(), bias.contiguous() if bias is not None else None


def _cuda_fwd(x2, scale, bias, eps: float, rms: bool,
              with_stats: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 on contiguous rows x2 (N, D): (out, mu, rstd) as the plain version;
    mu and rstd None without ``with_stats`` (no backward will read them)."""
    _check_kernel_inputs(x2, scale, bias)
    N, D = x2.shape
    scale, bias = _kernel_weights(x2.dtype, scale, bias)
    dev = x2.get_device()
    plan = _plan(False, N, D, x2.dtype, scale.dtype, kernel_variant(D, x2.dtype, x2), rms, dev)
    out = torch.empty_like(x2)
    stats = torch.empty((2, N, 1), dtype=torch.float32, device=x2.device) if with_stats else None
    rc = _kernels()[0](plan, x2.data_ptr(), scale.data_ptr(),
                       None if bias is None else bias.data_ptr(), out.data_ptr(),
                       None if stats is None else stats.data_ptr(), eps,
                       torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_norm_fwd kernel launch failed (cudaError {rc})")
    LAUNCHES["fused_norm_fwd"] += 1
    return (out, stats[0], stats[1]) if with_stats else (out, None, None)


def _cuda_bwd(x2, scale, mu, rstd, do2, rms: bool, dscale_dtype=torch.float32,
              dbias_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 on contiguous rows and its fixed-order sum of the per-block
    partials: (dx, dscale, dbias) as the plain version, dscale and dbias in
    the dtypes asked for (dbias None for a dbias_dtype of None)."""
    _check_kernel_inputs(x2, scale)
    N, D = x2.shape
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.numel() != N or not t.is_contiguous():
            raise ValueError(f"fused norm kernel: {name} must be {N} contiguous float32 "
                             f"values, got {t.dtype} {tuple(t.shape)}")
    scale, _ = _kernel_weights(x2.dtype, scale)
    dev = x2.get_device()
    plan = _plan(True, N, D, x2.dtype, scale.dtype, kernel_variant(D, x2.dtype, x2, do2), rms,
                 dev, dscale_dtype, torch.float32 if dbias_dtype is None else dbias_dtype)
    dx = torch.empty_like(x2)
    partials = torch.empty((2, plan.grid, D), dtype=torch.float32, device=x2.device)
    dscale = torch.empty(D, dtype=dscale_dtype, device=x2.device)
    dbias = None if dbias_dtype is None else torch.empty(D, dtype=dbias_dtype, device=x2.device)
    rc = _kernels()[1](plan, x2.data_ptr(), scale.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                       do2.data_ptr(), dx.data_ptr(), partials.data_ptr(), dscale.data_ptr(),
                       None if dbias is None else dbias.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_norm_bwd kernel launch failed (cudaError {rc})")
    LAUNCHES["fused_norm_bwd"] += 1
    return dx, dscale, dbias


def _device_type(x) -> str:
    if x.is_cuda:
        return "cuda"
    if x.is_cpu:
        return "cpu"
    raise ValueError(f"fused norm runs on cuda or cpu tensors, got {x.device}")


def _fwd(x2, scale, bias, eps: float, rms: bool, with_stats: bool = True):
    """The forward on checked rows: K7 on a CUDA tensor (mu and rstd None
    without ``with_stats``), the plain version on a CPU tensor."""
    if _device_type(x2) == "cuda":
        return _cuda_fwd(x2, scale, bias, eps, rms, with_stats)
    return _reference_fwd(x2, scale, bias, eps, rms)


def _bwd(x2, scale, mu, rstd, do2, rms: bool, dscale_dtype=torch.float32,
         dbias_dtype=torch.float32):
    """The backward on checked rows: K8 and the sum of its partials on a
    CUDA tensor, the plain version on a CPU tensor; dscale and dbias in the
    dtypes asked for (f32 by default; no dbias for a dbias_dtype of None)."""
    if _device_type(x2) == "cpu":
        dx, dscale, dbias = _reference_bwd(x2, scale, mu, rstd, do2, rms)
        return dx, dscale.to(dscale_dtype), None if dbias_dtype is None else dbias.to(dbias_dtype)
    return _cuda_bwd(x2, scale, mu.contiguous(), rstd.contiguous(),
                     do2.to(x2.dtype).contiguous(), rms, dscale_dtype, dbias_dtype)


class _FusedNorm(torch.autograd.Function):
    """The reference's custom VJP (``_fused_norm``): forward K7, saving
    (x, scale, bias, mu, rstd); backward K8, with dscale and dbias summed in
    f32 and written once in their parameters' dtypes, and no dbias without a
    bias."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps, rms):
        out, mu, rstd = _fwd(x2, scale, bias, eps, rms)
        ctx.save_for_backward(x2, scale, bias, mu, rstd)
        ctx.rms = rms
        return out

    @staticmethod
    def backward(ctx, do):
        x2, scale, bias, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = _bwd(x2, scale, mu, rstd, do, ctx.rms, scale.dtype,
                                 None if bias is None else bias.dtype)
        return dx, dscale, dbias, None, None


def _check_block_rows(block_rows):
    if isinstance(block_rows, bool) or not isinstance(block_rows, int) or block_rows < 1:
        raise ValueError(f"block_rows must be an int >= 1, got {block_rows!r}")


def _check_inputs(x, scale, bias):
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"fused norm needs at least one row of at least one feature, "
                         f"got x of shape {tuple(x.shape)}")
    D = x.shape[-1]
    for name, w in (("scale", scale), ("bias", bias)):
        if w is None:
            continue
        if w.shape != (D,):
            raise ValueError(f"{name} must have shape ({D},), the width of x, got "
                             f"{tuple(w.shape)}")
        if w.device != x.device:
            raise ValueError(f"{name} is on {w.device}, x on {x.device}")


def _fused_norm(x, scale, bias, eps: float, rms: bool):
    _check_inputs(x, scale, bias)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias)):
        out = _FusedNorm.apply(x2, scale, bias, float(eps), rms)
    else:
        out = _fwd(x2, scale, bias, float(eps), rms, with_stats=False)[0]
    return out.reshape(x.shape)


def fused_layernorm(x, scale, bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                    block_rows: int = 256) -> torch.Tensor:
    """LayerNorm over the last dim of x (any leading shape), in x's dtype.
    ``block_rows`` is the TPU kernel's row tile: accepted for the
    reference's signature and checked (an int >= 1), unused. The CUDA kernels
    partition rows by themselves; the partition only changes the order of
    the dscale/dbias sums."""
    _check_block_rows(block_rows)
    return _fused_norm(x, scale, bias, eps, False)


def fused_rmsnorm(x, scale, eps: float = 1e-5, block_rows: int = 256) -> torch.Tensor:
    """RMSNorm over the last dim of x, in x's dtype; ``block_rows`` as in
    :func:`fused_layernorm`."""
    _check_block_rows(block_rows)
    return _fused_norm(x, scale, None, eps, True)
