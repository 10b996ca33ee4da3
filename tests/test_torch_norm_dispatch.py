"""The model's norm through the fused-norm op, held on the CPU with plain
tensors: ``models/transformer._norm`` runs ``ops/fused_norm._fused_norm``
(its ``_FusedNorm`` node under autograd, its forward alone without one), the
plain versions on CPU tensors and, with the device check and the kernel
wrappers replaced by recorders, exactly one K7 and one K8 call on CUDA
tensors, with contiguous rows. RMSNorm keeps its bias, as the reference's
``_norm`` does; the weights' gradients come back in the leaves' dtypes. Then
the host-side choices of the kernels: the register kernels' row geometry,
the vector or scalar path from (D, dtype, alignment), the grid from the
occupancy, the weights' dtype, and the plan that carries them, field for
field the kernel source's.

Tolerance against the reference's ``_norm`` and ``jax.vjp`` of it (bf16 x,
f32 scale and bias): ``test_norm_computes_in_f32_and_casts_back``'s, max
|Δ| / (|ref| + 1e-3) <= 2**-7. Both compute in f32 (two-pass mean,
population variance) and round once to x's dtype; the f32 values differ by
summation order and the closed-form backward's other order of operations,
far below one bf16 rounding (2**-8 relative).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops import fused_norm as tfn

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
            dtype="float32")
NORM_TYPES = ("layernorm", "rmsnorm")
bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32


def _cfg(norm_type, **over):
    return ttf.TransformerConfig(**dict(TINY, norm_type=norm_type, **over))


def _leaves(shape, x_dtype, w_dtype, seed=0):
    rs = np.random.RandomState(seed)
    D = shape[-1]
    x = torch.from_numpy((rs.randn(*shape) * 2 + 0.5).astype(np.float32)).to(x_dtype)
    scale = torch.from_numpy((1 + 0.1 * rs.randn(D)).astype(np.float32)).to(w_dtype)
    bias = torch.from_numpy((0.1 * rs.randn(D)).astype(np.float32)).to(w_dtype)
    return [t.requires_grad_(True) for t in (x, scale, bias)]


def _graph_nodes(t):
    seen, todo = [], [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.append(node)
        todo.extend(f for f, _ in node.next_functions)
    return [type(n).__name__ for n in seen]


def _assert_close(got, ref, what):
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.max(np.abs(ref - got) / (np.abs(ref) + 1e-3)) <= 2 ** -7, what


# ---------------------------------------------------------------------------
# the model's norm is the fused-norm op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_cpu_norm_runs_the_plain_versions_through_the_fused_norm_node(monkeypatch, norm_type):
    calls = []
    ref_fwd, ref_bwd = tfn._reference_fwd, tfn._reference_bwd
    monkeypatch.setattr(tfn, "_reference_fwd",
                        lambda *a: calls.append("fwd") or ref_fwd(*a))
    monkeypatch.setattr(tfn, "_reference_bwd",
                        lambda *a: calls.append("bwd") or ref_bwd(*a))
    x, scale, bias = _leaves((2, 8, 64), f32, f32)
    out = ttf._norm(x, scale, bias, _cfg(norm_type))
    assert "_FusedNormBackward" in _graph_nodes(out)
    assert calls == ["fwd"]
    out.sum().backward()
    assert calls == ["fwd", "bwd"]
    assert all(t.grad is not None for t in (x, scale, bias))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_norm_without_grad_runs_the_forward_alone(monkeypatch, norm_type, mode):
    """The serving path's norm (``forward_with_cache`` under no_grad or
    inference_mode, leaves that require grad): no autograd node and no saved
    tensors, the forward's values."""
    def refuse(*args):
        raise AssertionError("an autograd node was built without grad")

    monkeypatch.setattr(tfn._FusedNorm, "apply", refuse)
    x, scale, bias = _leaves((8, 1, 64), bf16, bf16)
    with getattr(torch, mode)():
        out = ttf._norm(x, scale, bias, _cfg(norm_type))
    assert out.grad_fn is None and out.dtype == bf16
    want = tfn._reference_fwd(x.detach().reshape(-1, 64), scale.detach(), bias.detach(), 1e-5,
                              norm_type == "rmsnorm")[0]
    assert torch.equal(out.reshape(-1, 64), want)


@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_norm_and_its_gradient_match_the_reference_norm(norm_type):
    """bf16 x, f32 scale and bias, RMSNorm with its bias too: the forward and
    the gradients of x, scale and bias against the reference's ``_norm`` and
    ``jax.vjp`` of it on the same cotangent."""
    rs = np.random.RandomState(7)
    x = (rs.randn(4, 8, 64) * 3 + 1).astype(np.float32)
    scale = (1 + 0.2 * rs.randn(64)).astype(np.float32)
    bias = (0.3 * rs.randn(64)).astype(np.float32)
    cot = rs.randn(4, 8, 64).astype(np.float32)
    jcfg = jtf.TransformerConfig(**dict(TINY, norm_type=norm_type))
    ref, vjp = jax.vjp(lambda a, s, b: jtf._norm(a, s, b, jcfg), jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(scale), jnp.asarray(bias))
    rdx, rds, rdb = vjp(jnp.asarray(cot, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    st, bt = (torch.from_numpy(a).requires_grad_(True) for a in (scale, bias))
    out = ttf._norm(xt, st, bt, _cfg(norm_type))
    out.backward(torch.from_numpy(cot).bfloat16())
    assert out.dtype == xt.grad.dtype == bf16 and st.grad.dtype == bt.grad.dtype == f32
    assert bt.grad.abs().max() > 0
    for got, want, what in ((out, ref, "out"), (xt.grad, rdx, "dx"), (st.grad, rds, "dscale"),
                            (bt.grad, rdb, "dbias")):
        _assert_close(got, want, what)


@pytest.mark.parametrize("norm_type", NORM_TYPES)
@pytest.mark.parametrize("x_dtype,w_dtype", [(bf16, bf16), (f32, f32), (f16, f16), (bf16, f32)])
def test_weight_gradients_come_back_in_the_leaves_dtype(x_dtype, w_dtype, norm_type):
    """bf16 leaves (the engine's mixed precision) get bf16 dscale and dbias,
    f32 leaves f32 ones; dx has x's dtype."""
    x, scale, bias = _leaves((2, 4, 64), x_dtype, w_dtype)
    ttf._norm(x, scale, bias, _cfg(norm_type)).float().sum().backward()
    assert x.grad.dtype == x_dtype
    assert scale.grad.dtype == bias.grad.dtype == w_dtype


@pytest.fixture
def kernel_calls(monkeypatch):
    """The op's CUDA branch with K7 and K8 replaced by recorders that return
    the plain versions' results; the plain versions themselves refuse to
    run, so nothing but the two kernel wrappers can."""
    calls = []
    ref_fwd, ref_bwd = tfn._reference_fwd, tfn._reference_bwd

    def record_fwd(x2, scale, bias, eps, rms, with_stats=True):
        calls.append(("fwd", x2, scale, bias, eps, rms, with_stats))
        out, mu, rstd = ref_fwd(x2, scale, bias, eps, rms)
        return (out, mu, rstd) if with_stats else (out, None, None)

    def record_bwd(x2, scale, mu, rstd, do2, rms, dscale_dtype=f32, dbias_dtype=f32):
        calls.append(("bwd", x2, do2, dscale_dtype, dbias_dtype))
        dx, dscale, dbias = ref_bwd(x2, scale, mu, rstd, do2, rms)
        return dx, dscale.to(dscale_dtype), None if dbias_dtype is None else dbias.to(dbias_dtype)

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(tfn, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(tfn, "_cuda_fwd", record_fwd)
    monkeypatch.setattr(tfn, "_cuda_bwd", record_bwd)
    monkeypatch.setattr(tfn, "_reference_fwd", refuse)
    monkeypatch.setattr(tfn, "_reference_bwd", refuse)
    return calls


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_cuda_norm_reaches_k7_and_k8_once_each_with_contiguous_rows(kernel_calls, norm_type,
                                                                    with_bias):
    """A strided x and a strided cotangent reach K7 and K8 as contiguous
    rows, once each; K8 is asked for dscale and dbias in the leaves' bf16 (no
    dbias without a bias), RMSNorm with the params' bias."""
    cfg = _cfg(norm_type, dtype="bfloat16")
    _, scale, bias = _leaves((4, 16, 64), bf16, bf16)
    bias = bias if with_bias else None
    base = torch.randn(64, 4, 16).bfloat16().requires_grad_(True)
    x = base.permute(1, 2, 0)  # (4, 16, 64), not contiguous
    assert not x.is_contiguous()
    out = ttf._norm(x, scale, bias, cfg)
    cot = torch.randn(64, 16, 4).bfloat16().permute(2, 1, 0)
    out.backward(cot)
    assert [c[0] for c in kernel_calls] == ["fwd", "bwd"]
    _, fx, fscale, fbias, eps, rms, with_stats = kernel_calls[0]
    _, bx, bdo, dscale_dtype, dbias_dtype = kernel_calls[1]
    assert fx.is_contiguous() and torch.equal(fx, x.detach().reshape(-1, 64))
    assert fscale is scale and fbias is bias and eps == cfg.norm_eps
    assert rms == (norm_type == "rmsnorm") and with_stats
    assert bx is fx and bdo.is_contiguous() and bdo.dtype == bf16
    assert torch.equal(bdo, cot.reshape(-1, 64))
    assert dscale_dtype == bf16 and dbias_dtype == (bf16 if with_bias else None)
    assert base.grad.dtype == scale.grad.dtype == bf16
    assert (bias.grad.dtype == bf16) if with_bias else bias is None


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_cuda_norm_without_grad_reaches_k7_alone_without_stats(kernel_calls, mode):
    x, scale, bias = _leaves((8, 1, 64), bf16, bf16)
    with getattr(torch, mode)():
        out = ttf._norm(x, scale, bias, _cfg("layernorm", dtype="bfloat16"))
    assert out.grad_fn is None
    assert [c[0] for c in kernel_calls] == ["fwd"]
    assert kernel_calls[0][-1] is False  # no mu and rstd: nothing will read them


# ---------------------------------------------------------------------------
# the kernels' host-side choices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,dtype,expected", [
    (768, bf16, (32, 4, 3)),     # GPT-2 125M: a warp a row, four rows a block
    (1024, bf16, (32, 4, 4)),    # GPT-2 350M
    (1025, bf16, (64, 2, 3)),
    (1600, f32, (128, 1, 4)),    # gpt2-1.5b in f32
    (4096, bf16, (128, 1, 4)),   # llama2-7b
    (8192, bf16, (256, 1, 4)),   # the widest 16-bit row in registers
    (8193, bf16, None),          # then the wide kernels
    (4096, f32, (256, 1, 4)),
    (4097, f32, None),
    (100, f16, (32, 4, 1)),
    (1, f32, (32, 4, 1)),
])
def test_geometry_holds_a_row_in_at_most_four_chunks_a_thread(D, dtype, expected):
    assert tfn._geometry(D, dtype) == expected


@pytest.mark.parametrize("dtype", [bf16, f16, f32])
def test_geometry_covers_every_width_in_registers_with_the_fewest_threads(dtype):
    vec = 16 // dtype.itemsize
    for D in range(1, 256 * 4 * vec + 1, 7):
        tpr, rpb, chunks = tfn._geometry(D, dtype)
        assert tpr % 32 == 0 and tpr * rpb == max(tpr, 128) and 1 <= chunks <= 4
        assert tpr * chunks * vec >= D > (tpr * (chunks - 1) * vec if chunks > 1 else 0)
        assert tpr == 32 or (tpr // 2) * 4 * vec < D


@pytest.mark.parametrize("D,dtype,x_offset,do_offset,expected", [
    (768, bf16, 0, 0, "vector"),
    (768, bf16, 1, 0, "scalar"),    # x starts 2 bytes off 16
    (768, bf16, 0, 1, "scalar"),    # do does
    (768, bf16, 8, 8, "vector"),    # 16 bytes in: aligned again
    (100, f16, 0, 0, "scalar"),     # 200-byte rows: row 1 starts off 16
    (100, f32, 0, 0, "vector"),     # 400-byte rows
    (1600, f32, 0, 0, "vector"),
    (1600, f32, 2, 2, "scalar"),
    (4096, bf16, 0, 0, "vector"),
    (1, f32, 0, 0, "scalar"),
    (8192, bf16, 1, 1, "scalar"),
    (8200, bf16, 0, 0, "wide"),
    (4100, f32, 0, 0, "wide"),
])
def test_kernel_variant_follows_dtype_width_and_alignment(D, dtype, x_offset, do_offset,
                                                          expected):
    x = torch.zeros(3 * D + x_offset, dtype=dtype)[x_offset:].view(3, D)
    do = torch.zeros(3 * D + do_offset, dtype=dtype)[do_offset:].view(3, D)
    assert tfn.kernel_variant(D, dtype, x, do) == expected


@pytest.mark.parametrize("N,rows_per_block,blocks_per_sm,sms,expected", [
    (8192, 4, 3, 132, 396),   # training rows: what the card holds at once
    (8, 4, 3, 132, 2),        # a decode step's 8 rows
    (77, 4, 5, 132, 20),
    (4096, 1, 1, 132, 132),
    (1, 1, 2, 132, 1),
])
def test_grid_is_the_occupancy_or_the_row_groups(N, rows_per_block, blocks_per_sm, sms,
                                                 expected):
    assert tfn._grid(N, rows_per_block, blocks_per_sm, sms) == expected


@pytest.mark.parametrize("x_dtype,scale_dtype,bias_dtype,expected", [
    (bf16, bf16, bf16, bf16),
    (bf16, f32, f32, f32),
    (bf16, f16, f16, f32),    # neither x's dtype nor f32
    (bf16, bf16, f32, f32),   # scale and bias differ
    (f32, bf16, bf16, f32),
    (f16, f32, None, f32),
    (f16, f16, None, f16),
])
def test_kernel_weights_are_x_dtype_or_f32_with_their_values(x_dtype, scale_dtype, bias_dtype,
                                                             expected):
    scale = torch.linspace(-2, 2, 24).to(scale_dtype)[::2]  # strided: copied contiguous
    bias = None if bias_dtype is None else torch.linspace(-1, 1, 12).to(bias_dtype)
    ks, kb = tfn._kernel_weights(x_dtype, scale, bias)
    assert ks.dtype == expected and ks.is_contiguous() and torch.equal(ks.float(), scale.float())
    if bias is None:
        assert kb is None
    else:
        assert kb.dtype == expected and torch.equal(kb.float(), bias.float())


def _cu_source():
    with open(tfn.KERNEL_LIB.source) as fh:
        return fh.read()


def test_plan_fields_are_the_kernel_sources_in_its_order():
    """``_Plan`` mirrors fused_norm.cu's ``PlanField`` (kDtype -> "dtype",
    ...), so a field added on one side only fails here, not on the card."""
    enum = re.search(r"enum PlanField \{(.*?)\};", _cu_source(), re.S).group(1)
    names = re.findall(r"^\s*k(\w+),", enum, re.M)
    assert names[-1] == "Device" and "PlanFields" in enum
    assert [name for name, _ in tfn._Plan._fields_] == [n.lower() for n in names]


@pytest.mark.parametrize("cu_name,py_name", [("kBlockThreads", "BLOCK_THREADS"),
                                             ("kMinBlockThreads", "MIN_BLOCK_THREADS"),
                                             ("kMaxChunks", "MAX_CHUNKS")])
def test_register_kernel_limits_are_the_kernel_sources(cu_name, py_name):
    value = re.search(rf"constexpr int {cu_name} = (\d+);", _cu_source()).group(1)
    assert int(value) == getattr(tfn, py_name)


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("N,D,dtype,variant", [
    (8192, 768, bf16, "vector"),
    (77, 100, f16, "scalar"),
    (300, 9000, bf16, "wide"),
])
def test_plan_names_the_call_and_its_grid(monkeypatch, N, D, dtype, variant, bwd):
    """The plan of a call, with the card's SM count and the instantiation's
    occupancy stood in: the register kernels' grid is ``_grid`` of the
    occupancy, the wide K7's a block a row, the wide K8's two blocks an SM."""
    asked = []

    def occupancy(plan, is_bwd):
        asked.append((plan.variant, plan.tpr, plan.rpb, plan.chunks, is_bwd))
        return 3

    monkeypatch.setattr(tfn, "_sm_count", lambda device_index: 132)
    monkeypatch.setattr(tfn, "_kernels", lambda: (None, None, occupancy))
    plan = tfn._plan.__wrapped__(bwd, N, D, dtype, f32, variant, True, 1, bf16, f32)
    assert (plan.dtype, plan.wdtype, plan.n, plan.d, plan.rms, plan.device) == (
        tfn._DTYPE_CODE[dtype], 0, N, D, 1, 1)
    assert (plan.sdtype, plan.bdtype, plan.variant) == (2, 0, tfn._VARIANT_CODE[variant])
    if variant == "wide":
        assert not asked and (plan.tpr, plan.rpb, plan.chunks) == (0, 1, 0)
        assert plan.grid == (min(N, 264) if bwd else N)
    else:
        tpr, rpb, chunks = tfn._geometry(D, dtype)
        assert asked == [(tfn._VARIANT_CODE[variant], tpr, rpb, chunks, int(bwd))]
        assert plan.grid == tfn._grid(N, rpb, 3, 132)
