"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the flash kernels K1-K3, the block-sparse kernels K4-K6 and the fused norm
kernels K7-K8; the int8 decode path's W8A8 product (``int8_linear``,
cuBLASLt's int8 product through ``torch._int_mm``) and int8 engine; and the
continuous-batching engine's ticks, plain and speculative (ngram and draft
modes), dispatched where a host sync raises; the serving layer and the fleet
over card engines: ticks with the telemetry hub, and fleet ticks with the
health probe and the ops server on their threads, dispatched where a host
sync raises; a recovery rebuild, and a replica kill with migration, that
finish every request; ALiBi's cached reads and a BLOOM-shaped pool's ticks
dispatched where a host sync raises; and the HF checkpoint reader
(``module_inject.load_checkpoint``) on tensors written from the card.

Runs only with an NVIDIA GPU (marker ``cuda``; skips elsewhere, deciding
inside each test). It imports neither JAX nor the reference package, so on
the machine with the card it runs without the repository's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -m cuda

Tolerances for the flash forward (K1; the tensor-core kernel for bfloat16
and float16, the FMA kernel for float32) against ``_reference_fwd``: the
kernel rounds p to the input dtype before PV (as the TPU kernel does) while
the reference keeps p in f32, so the output differs by a rounding of the
input dtype: two roundings at |o| <= 4 are 3e-2 in bfloat16 (8-bit
mantissa) and 4e-3 in float16; float32 1e-5; lse is f32 on both sides: 1e-5.

Tolerances for the backward kernels (K2 dq, K3 dk/dv) against
``_reference_bwd`` on the same (o, lse, do): the kernels round ds (and, in
K3, p) to the input dtype before the products that use them, as the TPU
kernels do, and round their f32 sums once at the output; the plain version
keeps f32 throughout. Each rounding is unbiased and at most half an ulp
(2**-9 relative in bfloat16, 2**-12 in float16), so the sums differ by a
few such ulps of the gradient's own scale: the bound is 2**-6 (bfloat16),
2**-9 (float16) and 1e-5 (float32, summation order only) times the largest
|gradient| of the reference.

Tolerances for the fused norm kernels (K7 forward, K8 backward) against
``_reference_fwd``/``_reference_bwd`` on the same inputs: both compute in f32
and round once at the output, so out and dx are one rounding plus summation
order apart, 2**-8 of the largest |plain| value in bfloat16 and float16, 1e-5
in float32; mu and rstd (f32) 1e-5. dscale and dbias are f32 sums over all
rows in another order (per-block partials, then their fixed-order sum): 1e-4
of the largest |plain| value, and 2**-8 after the cast to bfloat16.

``int8_linear`` and the int8 quantizations on the card against the same
calls on the CPU: the quantization is f32 arithmetic in the same order
(IEEE division, ``quantizer.div_exact``, and rounding on both), the int8
product sums exactly in int32 on both, and the rescale is two f32 products
and one cast: bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import fused_norm as tfn
from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

pytestmark = pytest.mark.cuda

O_TOL = {torch.bfloat16: 3e-2, torch.float16: 4e-3, torch.float32: 1e-5}
LSE_TOL = 1e-5
GRAD_REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9, torch.float32: 1e-5}
SHAPES = [
    (8, 128, 16, 16, 64, True, None),
    (2, 896, 16, 16, 64, True, None),
    (2, 100, 16, 16, 64, True, None),
    (2, 512, 8, 2, 64, True, 64),
    (2, 512, 8, 2, 64, False, None),
    (1, 300, 4, 1, 128, True, 37),
    (2, 70, 2, 2, 32, False, None),
]
# the forward's and the backward's cases: SHAPES, then head dim 16, and head
# dim 128 with GQA (group 4), causal and a window, over several key and query
# tiles
BWD_SHAPES = SHAPES + [
    (2, 200, 4, 4, 16, True, None),
    (1, 1024, 8, 2, 128, True, 256),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel is CUDA C++ with no CPU mode")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", BWD_SHAPES)
def test_flash_kernel_matches_plain_version(dtype, B, S, H, Hkv, hd, causal, window):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    before = LAUNCHES["flash_fwd"]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd"] == before + 1
    ro, rl = tfa._reference_fwd(q, k, v, causal, hd ** -0.5, window)
    assert o.dtype == dtype and torch.isfinite(o).all()
    assert lse.shape == (B, H, S, 1) and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() <= O_TOL[dtype]
    assert (lse - rl).abs().max().item() <= LSE_TOL


def test_flash_forward_gives_the_same_bits_twice():
    """No atomics: K1 (tensor-core variant, bf16, GQA and causal) gives
    bit-equal o and lse on the same inputs."""
    _need_card()
    assert torch.bfloat16 in tfa.TENSOR_CORE_DTYPES
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(2, 1024, 8, 64, generator=g, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(2, 1024, 2, 64, generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    first = tfa.flash_attention_fwd(q, k, v)
    again = tfa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_forward_copies_rows_that_are_not_16_byte_aligned(dtype):
    """q, k and v as views whose rows start at odd element offsets: the
    wrapper copies them to contiguous rows, the tensor-core kernel runs on
    the copies (one launch) and matches the plain version; the kernel
    wrapper itself refuses the unaligned views."""
    _need_card()
    B, S, H, hd = 2, 130, 4, 64
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(B, S, H, hd + 1, generator=g, device="cuda",
                           dtype=dtype)[..., 1:] for _ in range(3))
    assert not any(tfa._rows_16b_aligned(t) for t in (q, k, v))
    before = LAUNCHES["flash_fwd"]
    o, lse = tfa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd"] == before + 1
    ro, rl = tfa._reference_fwd(q, k, v, True, hd ** -0.5, None)
    assert torch.isfinite(o).all()
    assert (o.float() - ro.float()).abs().max().item() <= O_TOL[dtype]
    assert (lse - rl).abs().max().item() <= LSE_TOL
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._cuda_fwd(q, k, v, True, hd ** -0.5, None)
    assert LAUNCHES["flash_fwd"] == before + 1


def test_flash_kernel_reads_strided_qkv():
    """q/k/v as views of one fused projection, as the model passes them."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 96, 3 * 4 * 64, generator=g, device="cuda", dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(4 * 64, dim=-1))
    o = tfa.flash_attention(q, k, v)
    ro = tfa.mha_reference(q, k, v)
    assert (o.float() - ro.float()).abs().max().item() <= O_TOL[torch.bfloat16]


def test_flash_kernel_rejects_what_it_does_not_take():
    _need_card()
    q = torch.randn(1, 16, 2, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        t = q.transpose(-1, -2).contiguous().transpose(-1, -2)
        tfa.flash_attention(t, t, t)


def _grad_err(got, ref):
    """max |got - ref| over the largest |ref| (the tolerances' unit)."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", BWD_SHAPES)
def test_flash_backward_kernels_match_plain_version(dtype, B, S, H, Hkv, hd, causal, window):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S + 1)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    do = torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
    scale = hd ** -0.5
    o, lse = tfa._reference_fwd(q, k, v, causal, scale, window)
    before = dict(LAUNCHES)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    assert LAUNCHES["flash_fwd"] == before["flash_fwd"]
    rq, rk, rv = tfa._reference_bwd(q, k, v, o, lse, do, causal, scale, window)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.shape == ref.shape and got.dtype == dtype and torch.isfinite(got).all()
        assert _grad_err(got, ref) <= GRAD_REL_TOL[dtype]


def test_flash_backward_reads_strided_qkv():
    """Gradients through q/k/v views of one fused projection, as the model
    passes them, against autograd of the plain attention."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    base = torch.randn(2, 96, 3 * 4 * 64, generator=g, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2, 96, 4, 64, generator=g, device="cuda", dtype=torch.bfloat16)
    grads = []
    for fn in (tfa.flash_attention, tfa.mha_reference):
        qkv = base.clone().requires_grad_(True)
        q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(4 * 64, dim=-1))
        (fn(q, k, v).float() * w.float()).sum().backward()
        grads.append(qkv.grad)
    assert _grad_err(grads[0], grads[1]) <= 2 * GRAD_REL_TOL[torch.bfloat16]


def test_flash_backward_gives_the_same_bits_twice():
    """No atomics: K2 and K3 (tensor-core variant, bf16, GQA and causal)
    give bit-equal gradients on the same inputs."""
    _need_card()
    assert torch.bfloat16 in tfa.TENSOR_CORE_DTYPES
    g = torch.Generator(device="cuda").manual_seed(5)
    q, do = (torch.randn(2, 1024, 8, 64, generator=g, device="cuda", dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, 1024, 2, 64, generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    o, lse = tfa._reference_fwd(q, k, v, True, 64 ** -0.5, None)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_backward_copies_rows_that_are_not_16_byte_aligned(dtype):
    """q, k, v and do as views whose rows start at odd element offsets: the
    wrapper copies them to contiguous rows, the tensor-core kernels run on
    the copies (one launch each) and match the plain version; the kernel
    wrappers themselves refuse the unaligned views."""
    _need_card()
    B, S, H, hd = 2, 130, 4, 64
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn(B, S, H, hd + 1, generator=g, device="cuda",
                               dtype=dtype)[..., 1:] for _ in range(4))
    assert not any(tfa._rows_16b_aligned(t) for t in (q, k, v, do))
    o, lse = tfa._reference_fwd(q, k, v, True, hd ** -0.5, None)
    before = dict(LAUNCHES)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    ref = tfa._reference_bwd(q, k, v, o, lse, do, True, hd ** -0.5, None)
    for got, want in zip(grads, ref):
        assert torch.isfinite(got).all() and _grad_err(got, want) <= GRAD_REL_TOL[dtype]
    delta = tfa._delta(o, do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._cuda_bwd_dq(q, k, v, do, lse, delta, True, hd ** -0.5, None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._cuda_bwd_dkv(q, k, v, do, lse, delta, True, hd ** -0.5, None)


def test_model_backward_launches_each_kernel_once_per_layer():
    _need_card()
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.ops.op_builder import reset_launch_counts

    cfg = ttf.TransformerConfig(vocab_size=128, hidden_size=128, num_layers=3, num_heads=2,
                                max_seq_len=64, dtype="bfloat16", attn_impl="pallas")
    params = ttf.map_params(lambda p: p.to(torch.bfloat16).requires_grad_(True),
                            ttf.init(torch.Generator(device="cuda").manual_seed(0), cfg))
    toks = torch.randint(0, 128, (2, 64), device="cuda")
    reset_launch_counts()
    loss = ttf.loss_fn(params, cfg, {"input_ids": toks})
    loss.backward()
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_bwd_dq"] == LAUNCHES["flash_bwd_dkv"] == 3
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all()
                                        for p in params["layers"][0]["attn"].values())


def test_flash_backward_rejects_a_do_of_another_dtype():
    _need_card()
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_bwd(q, q, q, o, lse, o.float())


# ---------------------------------------------------------------------------
# block-sparse attention: K4 (forward), K5 (dq), K6 (dk/dv)
# ---------------------------------------------------------------------------
#
# Against the plain versions (_reference_fwd / _reference_bwd of
# ops/block_sparse_attention.py) on the same inputs, as max |Δ| over max
# |plain|. The kernels keep f32 throughout, as the plain versions do, and
# round once at the store (the tensor-core K4/K5/K6, for 16-bit inputs at
# tile 64, split p and ds into 16-bit parts whose sum keeps them below f32's
# own rounding, and sum each tile in f32): in bfloat16 one rounding is 2**-9
# relative, so 2**-8 of max |plain| leaves room for the summation order;
# float16 2**-11; float32 1e-5 (summation order only). lse is f32 on both
# sides: 1e-5 absolute over values of magnitude ~10 (a few ulps). A row that
# nothing may attend is held exactly: o = 0 and dq = 0.

BS_TOL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11, torch.float32: 1e-5}
BS_LSE_TOL = 1e-5
# name: (B, S, H, hd, config, kwargs, causal, dtype); (a)-(f) are chip_smoke.py's k4_k6 shapes
BS_SHAPES = {
    "a_fixed_b2_s4096": (2, 4096, 12, 64, "FixedSparsityConfig", {}, True, torch.bfloat16),
    "b_fixed_b2_s4096_f32": (2, 4096, 12, 64, "FixedSparsityConfig", {}, True, torch.float32),
    "c_bigbird_s2048": (2, 2048, 12, 64, "BigBirdSparsityConfig", {}, True, torch.bfloat16),
    "d_bslongformer_s2048_noncausal": (2, 2048, 12, 64, "BSLongformerSparsityConfig", {}, False,
                                       torch.bfloat16),
    "e_variable_block32_s2048": (2, 2048, 12, 64, "VariableSparsityConfig",
                                 dict(block=32, attention="unidirectional"), True, torch.bfloat16),
    "f_zero_row_hd128_s512": (1, 512, 4, 128, "FixedSparsityConfig",
                              dict(block=128, num_local_blocks=2), True, torch.bfloat16),
    "g_block16_hd16_f16": (2, 256, 4, 16, "BigBirdSparsityConfig", dict(block=16), True,
                           torch.float16),
    "h_block128_hd32_noncausal_f32": (1, 512, 2, 32, "BigBirdSparsityConfig",
                                      dict(block=128, different_layout_per_head=True), False,
                                      torch.float32),
    "i_fixed_s1024_f16": (2, 1024, 12, 64, "FixedSparsityConfig", {}, True, torch.float16),
    "j_bigbird_hd128_noncausal": (1, 1024, 4, 128, "BigBirdSparsityConfig", {}, False,
                                  torch.bfloat16),
    # hd 128 over the fixed layout's long global columns (61 tiles), as
    # chip_smoke.py's k4_k6 (h) and (i)
    "k_fixed_s4096_hd128": (1, 4096, 12, 128, "FixedSparsityConfig", {}, True, torch.bfloat16),
    "l_fixed_s4096_hd128_f16": (1, 4096, 12, 128, "FixedSparsityConfig", {}, True,
                                torch.float16),
}


def _bs_layout(S, H, config, kw, zero_row):
    layout = getattr(tsc, config)(num_heads=H, **kw).make_layout(S)
    if zero_row:
        layout[1, 2, :] = 0  # head 1, q-block 2 attends nothing
    return layout, kw.get("block", 64)


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("name", sorted(BS_SHAPES))
def test_block_sparse_kernels_match_plain_version(name):
    _need_card()
    B, S, H, hd, config, kw, causal, dtype = BS_SHAPES[name]
    layout, block = _bs_layout(S, H, config, kw, zero_row=name.startswith("f_"))
    g = torch.Generator(device="cuda").manual_seed(S + H)
    q, k, v, do = (torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
                   for _ in range(4))
    scale, b = hd ** -0.5, min(block, S)
    before = dict(LAUNCHES)
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, causal=causal, block=block)
    torch.cuda.synchronize()
    assert LAUNCHES["block_sparse_fwd"] == before["block_sparse_fwd"] + 1
    ro, rl = tbs._reference_fwd(q, k, v, layout, b, causal, scale)
    assert o.dtype == dtype and torch.isfinite(o).all()
    assert _rel_err(o, ro) <= BS_TOL[dtype]
    assert (lse - rl).abs().max().item() <= BS_LSE_TOL
    dq, dk, dv = tbs.block_sparse_attention_bwd(q, k, v, ro, rl, do, layout, causal=causal,
                                                block=block)
    torch.cuda.synchronize()
    for kname in ("block_sparse_bwd_dq", "block_sparse_bwd_dkv"):
        assert LAUNCHES[kname] == before[kname] + 1
    rq, rk, rv = tbs._reference_bwd(q, k, v, ro, rl, do, layout, b, causal, scale)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.shape == ref.shape and got.dtype == dtype and torch.isfinite(got).all()
        assert _rel_err(got, ref) <= BS_TOL[dtype]
    if name.startswith("f_"):
        rows = slice(2 * block, 3 * block)
        assert o[:, rows, 1].abs().max().item() == 0.0
        assert dq[:, rows, 1].abs().max().item() == 0.0


def _bs_backward_inputs(B, S, H, hd, dtype, seed, config="FixedSparsityConfig", causal=True):
    layout = getattr(tsc, config)(num_heads=H).make_layout(S)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
                   for _ in range(4))
    o, lse = tbs._reference_fwd(q, k, v, layout, 64, causal, hd ** -0.5)
    return layout, q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_backward_gives_the_same_bits_twice(dtype):
    """No atomics: the tensor-core K5 and K6 (fixed layout, causal, 64 blocks)
    give bit-equal gradients on the same inputs."""
    _need_card()
    assert tbs.kernel_variant(dtype, 64) == "tensor_core"
    layout, q, k, v, o, lse, do = _bs_backward_inputs(2, 2048, 12, 64, dtype, seed=9)
    first = tbs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=True, block=64)
    again = tbs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=True, block=64)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [64, 128])
def test_block_sparse_forward_gives_the_same_bits_twice(dtype, hd):
    """No atomics: the tensor-core K4 (fixed layout, causal, 64 blocks)
    gives bit-equal o and lse on the same inputs."""
    _need_card()
    assert tbs.kernel_variant(dtype, 64) == "tensor_core"
    layout, q, k, v, _, _, _ = _bs_backward_inputs(2, 2048, 12, hd, dtype, seed=12)
    first = tbs.block_sparse_attention_fwd(q, k, v, layout, causal=True, block=64)
    again = tbs.block_sparse_attention_fwd(q, k, v, layout, causal=True, block=64)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("config,causal,hd", [("FixedSparsityConfig", True, 64),
                                              ("BigBirdSparsityConfig", True, 64),
                                              ("BSLongformerSparsityConfig", False, 64),
                                              ("FixedSparsityConfig", True, 128)])
def test_block_sparse_launch_order_changes_no_bit(monkeypatch, config, causal, hd):
    """The tensor-core K4, K5 and K6 take their blocks longest list first;
    with the blocks launched in ascending order instead, o, lse, dq, dk and
    dv are the same bits: the order decides when a block runs, never a sum's
    order (at hd 128 also with K6's two panel blocks a list)."""
    _need_card()
    B, S, H = 2, 2048, 12
    layout, q, k, v, o, lse, do = _bs_backward_inputs(B, S, H, hd, torch.bfloat16, seed=10,
                                                      config=config, causal=causal)
    fwd_longest_first = tbs.block_sparse_attention_fwd(q, k, v, layout, causal=causal, block=64)
    longest_first = tbs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=causal,
                                                   block=64)
    tile, lists = tbs._lists_on(layout, 64, causal, q.device)
    for name in ("row_order", "col_order"):
        assert not torch.equal(lists[name], torch.sort(lists[name]).values)
    ascending = dict(lists, **{name: torch.arange(lists[name].numel(), dtype=torch.int32,
                                                  device="cuda")
                               for name in ("row_order", "col_order")})
    monkeypatch.setattr(tbs, "_lists_on", lambda *args: (tile, ascending))
    before = dict(LAUNCHES)
    fwd_in_order = tbs.block_sparse_attention_fwd(q, k, v, layout, causal=causal, block=64)
    in_order = tbs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=causal,
                                              block=64)
    torch.cuda.synchronize()
    for kname in ("block_sparse_fwd", "block_sparse_bwd_dq", "block_sparse_bwd_dkv"):
        assert LAUNCHES[kname] == before[kname] + 1
    assert all(torch.equal(a, b) for a, b in zip(fwd_longest_first, fwd_in_order))
    assert all(torch.equal(a, b) for a, b in zip(longest_first, in_order))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_forward_copies_rows_that_are_not_16_byte_aligned(dtype):
    """q, k and v as views whose rows start at odd element offsets: the
    forward copies them to aligned rows, the tensor-core K4 runs on the
    copies (one launch) and matches the plain version; its wrapper refuses
    the views."""
    _need_card()
    B, S, H, hd = 2, 512, 4, 64
    layout = tsc.FixedSparsityConfig(num_heads=H).make_layout(S)
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(B, S, H, hd + 1, generator=g, device="cuda",
                           dtype=dtype)[..., 1:] for _ in range(3))
    assert not any(tfa._rows_16b_aligned(t) for t in (q, k, v))
    assert tbs.kernel_variant(dtype, 64) == "tensor_core"
    before = LAUNCHES["block_sparse_fwd"]
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, causal=True, block=64)
    torch.cuda.synchronize()
    assert LAUNCHES["block_sparse_fwd"] == before + 1
    ro, rl = tbs._reference_fwd(q, k, v, layout, 64, True, hd ** -0.5)
    assert torch.isfinite(o).all() and _rel_err(o, ro) <= BS_TOL[dtype]
    assert (lse - rl).abs().max().item() <= BS_LSE_TOL
    with pytest.raises(ValueError, match="16-byte aligned"):
        tbs._cuda_fwd(q, k, v, layout, 64, True, hd ** -0.5)
    assert LAUNCHES["block_sparse_fwd"] == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_backward_copies_rows_that_are_not_16_byte_aligned(dtype):
    """q, k, v and do as views whose rows start at odd element offsets: the
    backward copies them to aligned rows, the tensor-core K5/K6 run on the
    copies and match the plain version; their wrappers refuse the views."""
    _need_card()
    B, S, H, hd = 2, 512, 4, 64
    layout = tsc.FixedSparsityConfig(num_heads=H).make_layout(S)
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(B, S, H, hd + 1, generator=g, device="cuda",
                               dtype=dtype)[..., 1:] for _ in range(4))
    assert not any(tfa._rows_16b_aligned(t) for t in (q, k, v, do))
    o, lse = tbs._reference_fwd(q, k, v, layout, 64, True, hd ** -0.5)
    before = dict(LAUNCHES)
    grads = tbs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=True, block=64)
    torch.cuda.synchronize()
    assert tbs.kernel_variant(dtype, 64) == "tensor_core"
    for kname in ("block_sparse_bwd_dq", "block_sparse_bwd_dkv"):
        assert LAUNCHES[kname] == before[kname] + 1
    ref = tbs._reference_bwd(q, k, v, o, lse, do, layout, 64, True, hd ** -0.5)
    for got, want in zip(grads, ref):
        assert torch.isfinite(got).all() and _rel_err(got, want) <= BS_TOL[dtype]
    delta = tfa._delta(o, do)
    for fn in (tbs._cuda_bwd_dq, tbs._cuda_bwd_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(q, k, v, do, lse, delta, layout, 64, True, hd ** -0.5)


def test_block_sparse_kernels_read_strided_qkv():
    """q/k/v as views of one fused projection, as the model passes them,
    through autograd, against autograd of the dense masked reference."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    layout = tsc.BigBirdSparsityConfig(num_heads=4, block=32).make_layout(256)
    base = torch.randn(2, 256, 3 * 4 * 64, generator=g, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2, 256, 4, 64, generator=g, device="cuda", dtype=torch.bfloat16)
    grads = []
    for fn in (tbs.block_sparse_attention, tbs.sparse_attention_reference):
        qkv = base.clone().requires_grad_(True)
        q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(4 * 64, dim=-1))
        (fn(q, k, v, layout, causal=True, block=32).float() * w.float()).sum().backward()
        grads.append(qkv.grad)
    assert _rel_err(grads[0], grads[1]) <= 2 * BS_TOL[torch.bfloat16]


def test_block_sparse_model_launches_each_kernel_once_per_layer():
    _need_card()
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.ops.op_builder import reset_launch_counts

    cfg = ttf.TransformerConfig(vocab_size=128, hidden_size=128, num_layers=3, num_heads=2,
                                num_kv_heads=1, max_seq_len=256, dtype="bfloat16",
                                attn_impl="block_sparse",
                                sparse_attention={"mode": "fixed", "block": 64})
    params = ttf.map_params(lambda p: p.to(torch.bfloat16).requires_grad_(True),
                            ttf.init(torch.Generator(device="cuda").manual_seed(0), cfg))
    toks = torch.randint(0, 128, (2, 256), device="cuda")
    reset_launch_counts()
    loss = ttf.loss_fn(params, cfg, {"input_ids": toks})
    loss.backward()
    torch.cuda.synchronize()
    assert (LAUNCHES["block_sparse_fwd"] == LAUNCHES["block_sparse_bwd_dq"]
            == LAUNCHES["block_sparse_bwd_dkv"] == 3)
    # bf16 at block 64: each of those launches is the tensor-core K4, K5 and K6
    assert tbs.kernel_variant(torch.bfloat16, 64) == "tensor_core"
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_bwd_dq"] == LAUNCHES["flash_bwd_dkv"] == 0
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all()
                                        for p in params["layers"][0]["attn"].values())


def test_block_sparse_kernels_reject_what_they_do_not_take():
    _need_card()
    layout = tsc.FixedSparsityConfig(num_heads=2, block=16).make_layout(64)
    q = torch.randn(1, 64, 2, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tbs.block_sparse_attention(q, q, q, layout, block=16)
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        tbs.block_sparse_attention(q, q, q, layout, block=16)
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block must be one of"):
        tbs.block_sparse_attention(q, q, q, np.ones((2, 8, 8), np.int32), block=8)


def test_flash_dkv_gqa_sums_per_head_rounded_partials():
    """K3 with GQA rounds each query head's dk/dv partial to the input dtype
    and sums the group in f32, rounding once: bit for bit what K3 gives on
    k and v repeated to every query head (group 1), summed over each group
    in f32 in head order and rounded once, as the reference's _bwd does."""
    _need_card()
    B, S, H, Hkv, hd = 2, 512, 8, 2, 64
    group = H // Hkv
    g = torch.Generator(device="cuda").manual_seed(4)
    q, do = (torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    o, lse = tfa._reference_fwd(q, k, v, True, hd ** -0.5, None)
    _, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    _, dk1, dv1 = tfa.flash_attention_bwd(q, k.repeat_interleave(group, 2),
                                          v.repeat_interleave(group, 2), o, lse, do, causal=True)
    torch.cuda.synchronize()
    for got, per_head in ((dk, dk1), (dv, dv1)):
        parts = per_head.reshape(B, S, Hkv, group, hd)
        total = parts[..., 0, :].float()
        for i in range(1, group):
            total = total + parts[..., i, :].float()
        assert torch.equal(got, total.to(torch.bfloat16))


NORM_TOL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -8, torch.float32: 1e-5}
NORM_STAT_TOL = 1e-5
NORM_SUM_TOL = 1e-4
# name: (rows N, width D); (a)-(e) are chip_smoke.py's k7_k8 shapes: GPT-2 125M
# training, GPT-2 350M prefill, llama2-7b at S 4096, gpt2-1.5b's width, ragged;
# then one row, one feature, and the widths where fused_norm.cu changes path
NORM_SHAPES = {
    "a_8192x768": (8192, 768),
    "b_1024x1024": (1024, 1024),
    "c_4096x4096": (4096, 4096),
    "d_2048x1600": (2048, 1600),
    "e_77x100": (77, 100),
    "n1_1x768": (1, 768),
    "d1_64x1": (64, 1),
    "d8192_256x8192": (256, 8192),
    # above 25,568 K8 sums its columns in device memory, above 51,136 K7
    # reads the row again instead of keeping it in shared memory
    "d30000_16x30000": (16, 30000),
    "d60000_4x60000": (4, 60000),
}
# kind: LayerNorm with a bias, without one, RMSNorm, LayerNorm with f32 scale and bias
NORM_KINDS = ("ln", "ln_nobias", "rms", "ln_f32_params")


def _norm_err(got, ref):
    """max |got - ref| over the largest |ref| (absolute where ref is all 0)."""
    d = (got.float() - ref.float()).abs().max().item()
    m = ref.float().abs().max().item()
    return d / m if m > 0 else d


def _norm_inputs(N, D, kind, dtype, seed, offset=0):
    """x and do start ``offset`` elements past an allocation (16-byte aligned
    at offset 0, not at offset 1: the scalar path)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    wdtype = torch.float32 if kind == "ln_f32_params" else dtype
    x, do = (torch.randn(N * D + offset, generator=g, device="cuda", dtype=dtype)[offset:]
             .view(N, D) for _ in range(2))
    scale = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(wdtype)
    bias = (0.1 * torch.randn(D, generator=g, device="cuda")).to(wdtype)
    return x, do, scale, None if kind in ("ln_nobias", "rms") else bias


def _expected_variant(D, dtype, offset):
    if tfn._geometry(D, dtype) is None:
        return "wide"
    return "vector" if offset == 0 and D % (16 // dtype.itemsize) == 0 else "scalar"


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("kind", NORM_KINDS)
@pytest.mark.parametrize("name", sorted(NORM_SHAPES))
def test_fused_norm_kernels_match_plain_version(name, kind, dtype, offset):
    """Every shape on the path its rows take: offset 0 runs the vector path
    where D allows it, offset 1 (rows off 16 bytes) the scalar path; the
    widest rows run the wide kernels."""
    _need_card()
    N, D = NORM_SHAPES[name]
    rms = kind == "rms"
    x, do, scale, bias = _norm_inputs(N, D, kind, dtype, seed=N + D, offset=offset)
    assert tfn.kernel_variant(D, dtype, x, do) == _expected_variant(D, dtype, offset)
    before = dict(LAUNCHES)
    out, mu, rstd = tfn._fwd(x, scale, bias, 1e-5, rms)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_norm_fwd"] == before["fused_norm_fwd"] + 1
    ro, rmu, rrstd = tfn._reference_fwd(x, scale, bias, 1e-5, rms)
    assert out.dtype == dtype and out.shape == (N, D) and torch.isfinite(out).all()
    assert _norm_err(out, ro) <= NORM_TOL[dtype]
    assert mu.shape == rstd.shape == (N, 1) and mu.dtype == rstd.dtype == torch.float32
    assert _norm_err(mu, rmu) <= NORM_STAT_TOL and _norm_err(rstd, rrstd) <= NORM_STAT_TOL
    if rms:
        assert not mu.any()
    dx, dscale, dbias = tfn._bwd(x, scale, rmu, rrstd, do, rms)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_norm_bwd"] == before["fused_norm_bwd"] + 1
    rdx, rdscale, rdbias = tfn._reference_bwd(x, scale, rmu, rrstd, do, rms)
    assert dx.dtype == dtype and torch.isfinite(dx).all()
    assert _norm_err(dx, rdx) <= NORM_TOL[dtype]
    for got, ref in ((dscale, rdscale), (dbias, rdbias)):
        assert got.dtype == torch.float32 and got.shape == (D,)
        assert _norm_err(got, ref) <= NORM_SUM_TOL
        assert _norm_err(got.to(torch.bfloat16), ref.to(torch.bfloat16)) <= 2.0 ** -8


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", ["a_8192x768", "c_4096x4096", "d8192_256x8192",
                                  "d30000_16x30000"])
def test_fused_norm_kernels_give_the_same_bits_twice(name, offset):
    """No float atomics: K7 and K8 (with the sum of its partials) give
    bit-equal results on the same inputs, on the vector, scalar and wide
    paths; K7 without mu and rstd (no autograd) gives the same out."""
    _need_card()
    N, D = NORM_SHAPES[name]
    x, do, scale, bias = _norm_inputs(N, D, "ln", torch.bfloat16, seed=3, offset=offset)
    first = tfn._fwd(x, scale, bias, 1e-5, False)
    again = tfn._fwd(x, scale, bias, 1e-5, False)
    out_only, no_mu, no_rstd = tfn._fwd(x, scale, bias, 1e-5, False, with_stats=False)
    _, mu, rstd = first
    grads = [tfn._bwd(x, scale, mu, rstd, do, False) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert no_mu is None and no_rstd is None and torch.equal(out_only, first[0])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_fused_layernorm_launches_each_kernel_once_and_reads_a_strided_x():
    """Through autograd on a transposed (non-contiguous) x, which the wrapper
    copies to contiguous rows first, and an expanded output gradient: one
    K7 and one K8 launch, and the gradients of the plain version."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    base = torch.randn(768, 4, 256, generator=g, device="cuda", dtype=torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(768, generator=g, device="cuda")).to(torch.bfloat16)
    bias = (0.1 * torch.randn(768, generator=g, device="cuda")).to(torch.bfloat16)
    grads = []
    for fn in (tfn.fused_layernorm, None):
        x, s, b = (t.clone().requires_grad_(True) for t in (base, scale, bias))
        xt = x.permute(1, 2, 0)  # (4, 256, 768), not contiguous
        assert not xt.is_contiguous()
        before = dict(LAUNCHES)
        if fn is None:
            out = tfn._reference_fwd(xt.reshape(-1, 768), s, b, 1e-5, False)[0].reshape(xt.shape)
        else:
            out = fn(xt, s, b)
        out.float().sum().backward()
        torch.cuda.synchronize()
        launched = 0 if fn is None else 1
        assert LAUNCHES["fused_norm_fwd"] == before["fused_norm_fwd"] + launched
        assert LAUNCHES["fused_norm_bwd"] == before["fused_norm_bwd"] + launched
        grads.append((out, x.grad, s.grad, b.grad))
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        assert _norm_err(got, ref) <= 2.0 ** -7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_fused_norm_sums_in_the_weights_dtype_are_the_f32_sums_rounded_once(dtype):
    """K8 writes dscale and dbias in the dtype asked for (the weights' own
    under autograd): the f32 sums of the same launch, rounded once."""
    _need_card()
    x, do, scale, bias = _norm_inputs(8192, 768, "ln", torch.bfloat16, seed=11)
    _, mu, rstd = tfn._fwd(x, scale, bias, 1e-5, False)
    _, s32, b32 = tfn._bwd(x, scale, mu, rstd, do, False)
    _, s16, b16 = tfn._bwd(x, scale, mu, rstd, do, False, dtype, dtype)
    _, s_only, none = tfn._bwd(x, scale, mu, rstd, do, False, dtype, None)
    assert s16.dtype == b16.dtype == dtype and none is None
    assert torch.equal(s16, s32.to(dtype)) and torch.equal(b16, b32.to(dtype))
    assert torch.equal(s_only, s16)


@pytest.mark.parametrize("norm_type", ["layernorm", "rmsnorm"])
def test_model_norm_launches_k7_once_forward_and_k8_once_backward(norm_type):
    """The model's _norm on the card, bf16 leaves as the engine keeps them
    (RMSNorm with a bias too): one K7 launch forward and one K8 launch
    backward, and the plain versions' values, dscale and dbias in bf16."""
    _need_card()
    from deepspeed_tpu_torch.models import transformer as ttf

    cfg = ttf.TransformerConfig(hidden_size=768, norm_type=norm_type, dtype="bfloat16")
    x, do, scale, bias = _norm_inputs(8192, 768, "ln", torch.bfloat16, seed=13)
    x, do = x.view(8, 1024, 768), do.view(8, 1024, 768)
    grads = []
    for routed in (True, False):
        xl, s, b = (t.clone().requires_grad_(True) for t in (x, scale, bias))
        before = dict(LAUNCHES)
        if routed:
            out = ttf._norm(xl, s, b, cfg)
        else:
            out = tfn._reference_fwd(xl.reshape(-1, 768), s, b, cfg.norm_eps,
                                     norm_type == "rmsnorm")[0].reshape(x.shape)
        out.backward(do)
        torch.cuda.synchronize()
        launched = 1 if routed else 0
        assert LAUNCHES["fused_norm_fwd"] == before["fused_norm_fwd"] + launched
        assert LAUNCHES["fused_norm_bwd"] == before["fused_norm_bwd"] + launched
        grads.append((out, xl.grad, s.grad, b.grad))
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype == torch.bfloat16
        assert _norm_err(got, ref) <= 2.0 ** -7


def test_fused_norm_rejects_what_it_does_not_take():
    _need_card()
    x = torch.randn(8, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        tfn.fused_layernorm(x, torch.ones(64, device="cuda", dtype=torch.float64))
    x = torch.randn(8, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale is on cpu"):
        tfn.fused_layernorm(x, torch.ones(64))
    with pytest.raises(ValueError, match="must have shape"):
        tfn.fused_rmsnorm(x, torch.ones(32, device="cuda"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfn.fused_layernorm(torch.empty(8, 64, device="meta"), torch.empty(64, device="meta"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", [(1024, 3072), (1024, 4096), (4096, 1024)])
@pytest.mark.parametrize("lead", [(8, 1), (1, 1), (16,), (17,), (8, 128)])
def test_int8_linear_on_the_card_equals_the_cpu(lead, K, N, dtype):
    """GPT-2 350M's int8 products at decode rows (B 8, padded to the 17 rows
    the card's product takes), at 1, 16 and 17 rows, and at prefill rows (B 8
    x 128): the same bits as the CPU."""
    from deepspeed_tpu_torch.ops import quantizer as tq

    _need_card()
    g = torch.Generator().manual_seed(K + N)
    x = torch.randn(*lead, K, generator=g).to(dtype)
    w = tq.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
    ref = tq.int8_linear(x, w["q8"], w["s"])
    out = tq.int8_linear(x.cuda(), w["q8"].cuda(), w["s"].cuda())
    torch.cuda.synchronize()
    assert out.is_cuda and out.dtype == dtype and out.shape == (*lead, N)
    assert torch.equal(out.cpu(), ref)


def test_int8_quantization_on_the_card_equals_the_cpu():
    """The engine's weight quantization and the int8 cache's quantize/
    dequantize: the same bits on the card as on the CPU (the divisions by
    127 are IEEE divisions on both, ``quantizer.div_exact``)."""
    from deepspeed_tpu_torch.ops import quantizer as tq
    from deepspeed_tpu_torch.ops.transformer import inference_ops as tio

    _need_card()
    g = torch.Generator().manual_seed(7)
    w = torch.randn(3072, 1024, generator=g) * 0.02
    ref, out = tq.quantize_weight(w), tq.quantize_weight(w.cuda())
    assert torch.equal(out["q8"].cpu(), ref["q8"]) and torch.equal(out["s"].cpu(), ref["s"])
    for dtype in (torch.bfloat16, torch.float32):
        kv = torch.randn(8, 128, 16, 64, generator=g).to(dtype)
        (rq, rs), (q, s) = tio.quantize_kv(kv), tio.quantize_kv(kv.cuda())
        assert torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)
        back = tio.dequantize_kv({"q8": q, "s": s}, dtype)
        assert torch.equal(back.cpu(), tio.dequantize_kv({"q8": rq, "s": rs}, dtype))


def test_int8_linear_raises_for_widths_the_card_does_not_take():
    from deepspeed_tpu_torch.ops import quantizer as tq

    _need_card()
    w = tq.quantize_weight(torch.randn(16, 12))
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int8_linear(torch.randn(8, 12, device="cuda"), w["q8"].cuda(), w["s"].cuda())


def test_int8_engine_stays_on_the_card():
    """dtype="int8" with the int8 KV cache on the card: weights, scales and
    the cache live on the card, and generate runs through K1 and K7."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.ops.op_builder import launch_counts, reset_launch_counts

    _need_card()
    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                                max_seq_len=128, dtype="float32", attn_impl="pallas")
    eng = deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(cfg), config={"dtype": "int8", "kv_cache_dtype": "int8"})
    leaves = []
    ttf.map_params(leaves.append, eng.params)
    assert all(t.is_cuda for t in leaves)
    wqkv = eng.params["layers"][0]["attn"]["wqkv"]
    assert wqkv["q8"].dtype == torch.int8 and wqkv["s"].dtype == torch.float32
    cache = ttf.init_cache(eng.cfg, 2, 64, device=eng.device)
    assert cache["k"]["q8"].is_cuda and cache["k"]["q8"].dtype == torch.int8
    toks = torch.randint(0, 256, (2, 64), device="cuda")
    reset_launch_counts()
    out = eng.generate(toks, max_new_tokens=4)
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (2, 68)
    counts = launch_counts()
    assert counts["flash_fwd"] == 2 and counts["fused_norm_fwd"] == 5 * 4


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("tokens_per_tick", [4, 1])
def test_pool_ticks_dispatch_without_a_host_sync(tokens_per_tick, kv):
    """The continuous-batching engine's ticks never wait on the card: three
    admissions and two ticks (a burst of 4 after separate-prefill
    admission, or single-token ticks carrying fused prefill chunks),
    dispatched under ``torch.cuda.set_sync_debug_mode("error")``, where any
    synchronizing call raises. A depth of 8 retires nothing in two steps.
    The results then equal the same requests served before."""
    from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
    from deepspeed_tpu_torch.models import transformer as ttf

    _need_card()
    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                                max_seq_len=128, dtype="bfloat16", attn_impl="pallas")
    eng = ContinuousBatchingEngine(ttf.TransformerModel(cfg), config={"kv_cache_dtype": kv},
                                   max_slots=4, cache_len=96, tokens_per_tick=tokens_per_tick,
                                   pipeline_depth=8, prefill_chunk=32)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, n).astype(np.int32) for n in (20, 45, 7)]
    for p in prompts:  # the same shapes once, outside the check
        eng.submit(p, max_new_tokens=9)
    while eng.has_work():
        eng.step()
    want = eng.finished()
    rids = [eng.submit(p, max_new_tokens=9) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(eng._inflight) == 2 and not eng.poisoned
    assert (eng.tick_stats()["fused_prefill_ticks"] > 0) == (tokens_per_tick == 1)
    while eng.has_work():
        eng.step()
    got = eng.finished()
    for r, w in zip(rids, sorted(want)):
        np.testing.assert_array_equal(got[r], want[w])


def test_keyed_uniforms_on_the_card_equal_the_cpu():
    """The serving sampler's noise is integer hashing in int64 tensor ops:
    the same bits on both devices."""
    from deepspeed_tpu_torch.inference import decoding as tdec

    _need_card()
    rids = torch.arange(16).repeat_interleave(4)
    gens = torch.tensor([0, 1, 64, 2 ** 31 - 1]).repeat(16)
    cpu = tdec.request_uniforms(2 ** 40 + 5, rids, gens, 50257)
    card = tdec.request_uniforms(2 ** 40 + 5, rids.cuda(), gens.cuda(), 50257)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_pool_ticks_dispatch_without_a_host_sync(mode, fused):
    """The speculative pool's ticks never wait on the card either: three
    admissions (fused: their prompt chunks through the separate segment
    dispatch; separate: the bucket prefill and splice, and in draft mode
    the draft's prefill) and two verify rounds, dispatched under
    ``torch.cuda.set_sync_debug_mode("error")``. The ngram proposals go up
    in the same pinned copy as the tick's other host vectors. A depth of 8
    retires nothing in two steps; the results then equal the same requests
    served before."""
    from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
    from deepspeed_tpu_torch.models import transformer as ttf

    _need_card()
    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                                max_seq_len=128, dtype="bfloat16", attn_impl="pallas")
    kw = {}
    if mode == "draft":
        kw = dict(draft_model=ttf.TransformerModel(dataclasses.replace(cfg, num_layers=1)))
    eng = ContinuousBatchingEngine(
        ttf.TransformerModel(cfg),
        config={"speculative": {"enabled": True, "pool": True, "mode": mode,
                                "num_draft_tokens": 3}},
        max_slots=4, cache_len=96, pipeline_depth=8, prefill_chunk=32, fused_prefill=fused, **kw)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, n).astype(np.int32) for n in (20, 45, 7)]
    for p in prompts:  # the same shapes once, outside the check
        eng.submit(p, max_new_tokens=9)
    while eng.has_work():
        eng.step()
    want = eng.finished()
    rids = [eng.submit(p, max_new_tokens=9) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(eng._inflight) == 2 and not eng.poisoned
    assert (eng.tick_stats()["fused_prefill_ticks"] > 0) == fused
    while eng.has_work():
        eng.step()
    got = eng.finished()
    for r, w in zip(rids, sorted(want)):
        np.testing.assert_array_equal(got[r], want[w])
    assert eng.tick_stats()["spec_drafted"] > 0


def test_spec_lane_uniforms_on_the_card_equal_the_cpu():
    """The speculative lanes' keys and uniforms (the acceptance scalar and
    the vocab-wide draws) are integer hashing in int64 tensor ops: the same
    bits on both devices."""
    from deepspeed_tpu_torch.inference import decoding as tdec

    _need_card()
    rids = torch.arange(16).repeat_interleave(4)
    gens = torch.tensor([0, 1, 64, 2 ** 31 - 1]).repeat(16)
    base = 2 ** 40 + 5
    for lane in (tdec.LANE_DRAFT, tdec.LANE_ACCEPT, tdec.LANE_BONUS):
        cpu = tdec.spec_request_keys(base, rids, gens, lane)
        assert torch.equal(tdec.spec_request_keys(base, rids.cuda(), gens.cuda(), lane).cpu(),
                           cpu)
        cpu = tdec.spec_uniforms(base, rids, gens, lane, 50257)
        card = tdec.spec_uniforms(base, rids.cuda(), gens.cuda(), lane, 50257)
        assert torch.equal(card.cpu(), cpu)
    grid = (rids[:, None].expand(64, 8), gens[:, None] + torch.arange(8)[None])
    cpu = tdec.spec_accept_uniforms(base, *grid)
    card = tdec.spec_accept_uniforms(base, *(t.cuda() for t in grid))
    assert torch.equal(card.cpu(), cpu)


def _serving_card_engine(**kw):
    from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
    from deepspeed_tpu_torch.models import transformer as ttf

    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                                max_seq_len=128, dtype="bfloat16", attn_impl="pallas")
    return ContinuousBatchingEngine(ttf.TransformerModel(cfg), max_slots=4, cache_len=96,
                                    prefill_chunk=32, **kw)


def test_serving_ticks_with_telemetry_dispatch_without_a_host_sync(tmp_path):
    """The serving layer over a card engine with the telemetry hub on (a
    trace file, every gauge, histogram, event and span) adds no wait on
    the card to a tick: three admissions and two serving ticks under
    ``torch.cuda.set_sync_debug_mode("error")`` (a depth of 8 retires
    nothing), then the run finishes with the same results as before."""
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.telemetry import read_trace

    _need_card()
    trace = str(tmp_path / "serve.jsonl")
    eng = _serving_card_engine(config={"telemetry": {"enabled": True, "trace_file": trace}})
    srv = ServingEngine(eng, pipeline_depth=8)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, n).astype(np.int32) for n in (20, 45, 7)]
    want = [srv.submit(p, max_new_tokens=9).rid for p in prompts]
    srv.run()
    want = [srv.result(r) for r in want]
    rids = [srv.submit(p, max_new_tokens=9).rid for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            srv.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(eng._inflight) == 2 and not eng.poisoned
    srv.run()
    for r, w in zip(rids, want):
        np.testing.assert_array_equal(srv.result(r), w)
    srv.close()
    kinds = {e["kind"] for e in read_trace(trace)}
    assert {"serving_tick", "inference_request", "span"} <= kinds


def test_serving_rebuild_on_the_card_finishes_every_request():
    """One fault plan on the card (a retried dispatch error, a fetch hang
    and a preemption): the serving layer rebuilds the engine at the same
    size twice and every request finishes, none lost."""
    from deepspeed_tpu_torch.serving import (
        Fault,
        FaultInjector,
        FaultPlan,
        RecoveryConfig,
        ServingEngine,
    )

    _need_card()
    eng = _serving_card_engine()
    eng.fault_hook = FaultInjector(FaultPlan([Fault(tick=3, kind="dispatch_error"),
                                              Fault(tick=5, kind="fetch_hang"),
                                              Fault(tick=8, kind="preempt")]))
    srv = ServingEngine(eng, engine_factory=lambda mesh_shape=None: _serving_card_engine(),
                        recovery=RecoveryConfig(backoff_s=0.0))
    rs = np.random.RandomState(1)
    adms = [srv.submit(rs.randint(0, 256, n).astype(np.int32), max_new_tokens=12)
            for n in (20, 45, 7, 30)]
    srv.run()
    done = srv.reap()
    assert [done[a.rid].state for a in adms] == ["finished"] * 4
    assert all(len(done[a.rid].tokens) == 12 for a in adms)
    stats = srv.recovery_stats()
    assert (stats["retries"], stats["rebuilds"], stats["lost_requests"]) == (1, 2, 0)
    assert srv._cb.device.type == "cuda"


def _card_fleet(n, hub=False, **serving_kw):
    """A ``FleetRouter`` over ``n`` replicas of the card engine on the same
    weights, sharing one hub (registry only) when ``hub``."""
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.serving import FleetRouter, ServingEngine, attach_replica_telemetry

    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                                max_seq_len=128, dtype="bfloat16", attn_impl="pallas")
    params = ttf.TransformerModel(cfg).init(torch.Generator().manual_seed(0))
    holder = {}

    def factory(replica_id):
        config = ({"telemetry": {"enabled": True, "trace_file": ""}}
                  if hub and not holder else None)
        eng = _serving_card_engine(params=params, config=config)
        if hub:
            holder.setdefault("hub", eng._eng.telemetry)
            attach_replica_telemetry(eng, holder["hub"], replica_id)
        return ServingEngine(eng, **serving_kw)

    return FleetRouter(factory, replicas=n)


def test_fleet_ticks_with_the_probe_and_ops_threads_dispatch_without_a_host_sync():
    """A 2-replica fleet with the health probe running every 10 ms on its
    thread and the ops server scraped from another (``/healthz``,
    ``/statusz``, ``/metrics``) while the main thread dispatches two fleet
    ticks under ``torch.cuda.set_sync_debug_mode("error")``: nothing the
    router reads from a replica (``health``, ``statusz``,
    ``admission_outlook``, ``committed_tokens``) waits on the card. A depth
    of 8 retires nothing; the run then finishes with the same results as
    before."""
    import threading
    import time
    import urllib.request

    _need_card()
    router = _card_fleet(2, hub=True, pipeline_depth=8)
    ops = router.start_ops_server(port=0)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 256, n).astype(np.int32) for n in (20, 45, 7, 33, 12, 26)]
    want = [router.submit(p, max_new_tokens=9).rid for p in prompts]
    router.run()
    want = [router.result(r) for r in want]
    frids = [router.submit(p, max_new_tokens=9).rid for p in prompts]
    stop, scrapes, errors = threading.Event(), [], []

    def scrape():
        while not stop.is_set():
            for path in ("/healthz", "/statusz", "/metrics"):
                try:
                    with urllib.request.urlopen(ops.url + path, timeout=5) as r:
                        scrapes.append((path, r.status))
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append((path, repr(e)))

    torch.cuda.synchronize()
    probe = router.start_probe(0.01)
    scraper = threading.Thread(target=scrape, daemon=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        scraper.start()
        for _ in range(2):
            router.step()
            time.sleep(0.05)
    finally:
        stop.set()
        scraper.join(timeout=10)
        alive = probe.is_alive()
        router.stop_probe()
        torch.cuda.set_sync_debug_mode(0)
    assert alive and not errors and {p for p, _ in scrapes} == {"/healthz", "/statusz",
                                                                 "/metrics"}
    assert all(status == 200 for _, status in scrapes)
    for _, srv in router.steppable_engines():
        assert len(srv._cb._inflight) == 2 and not srv._cb.poisoned
    router.run()
    for r, w in zip(frids, want):
        np.testing.assert_array_equal(router.result(r), w)
    router.close()


def test_fleet_kill_on_the_card_migrates_and_finishes_every_request():
    """A replica killed on the card with running streams: the survivor
    re-prefills each one's prompt and emitted tokens and finishes it; no
    request is lost."""
    _need_card()
    router = _card_fleet(2)
    rs = np.random.RandomState(3)
    adms = [router.submit(rs.randint(0, 256, n).astype(np.int32), max_new_tokens=12)
            for n in (20, 45, 7, 30, 11, 16)]
    router.at_tick(4, lambda r: r.kill("r0", detail="card test"))
    router.run()
    done = router.reap()
    assert [done[a.rid].state for a in adms] == ["finished"] * 6
    assert all(len(done[a.rid].tokens) == 12 for a in adms)
    st = router.statusz()
    assert st["migrated"] > 0 and st["lost"] == 0 and st["replica_deaths"] == 1
    assert all(srv._cb.device.type == "cuda" for _, srv in router.steppable_engines())
    router.close()


# ---------------------------------------------------------------------------
# Llama-family serving: K1 at the llama2-7b and Mistral 7B prefill shapes,
# the ring write and the windowed decode, the per-token loop's migrations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,hd,window", [(8, 512, 32, 32, 128, None),
                                                 (1, 4608, 32, 8, 128, 4096)],
                         ids=["llama2_7b_b8_s512", "mistral_7b_b1_s4608_w4096"])
def test_flash_kernel_matches_plain_version_at_the_llama_prefills(B, S, H, Hkv, hd, window):
    """K1 in bf16 at the prefill shapes of ``chip_smoke.py``'s ``llama_serve``
    (causal, MHA) and ``mistral_ring`` (GQA group 4, the 4096-position
    window), against ``_reference_fwd``, with the bf16 tolerance above."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, window=window)
    ro, rl = tfa._reference_fwd(q, k, v, True, hd ** -0.5, window)
    assert torch.isfinite(o).all()
    assert (o.float() - ro.float()).abs().max().item() <= O_TOL[torch.bfloat16]
    assert (lse - rl).abs().max().item() <= LSE_TOL


def _ring_case(device, int8):
    """A ring of 8 slots over (2, T, 2, 64) bf16 or int8 caches, and three
    aligned segments: 5 tokens, 13 (longer than the ring) and a decode."""
    g = torch.Generator().manual_seed(11)
    shape = (2, 8, 2, 64)
    if int8:
        caches = [{"q8": torch.zeros(shape, dtype=torch.int8),
                   "s": torch.zeros(shape[:-1] + (1,))} for _ in range(2)]
    else:
        caches = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]
    segs = [(0, torch.randn(2, 5, 2, 64, generator=g), torch.randn(2, 5, 2, 64, generator=g)),
            (5, torch.randn(2, 13, 2, 64, generator=g), torch.randn(2, 13, 2, 64, generator=g)),
            (18, torch.randn(2, 1, 2, 64, generator=g), torch.randn(2, 1, 2, 64, generator=g))]
    q = torch.randn(2, 1, 4, 64, generator=g)

    def move(t):
        return {k: v.to(device) for k, v in t.items()} if isinstance(t, dict) else t.to(device)

    dt = torch.bfloat16
    return ([move(c) for c in caches],
            [(p, k.to(device, dt), v.to(device, dt)) for p, k, v in segs], q.to(device, dt))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ring_write_and_windowed_decode_dispatch_without_a_host_sync(int8):
    """The ring write (at most two slice copies at a Python-int position)
    and the windowed ring read dispatch under the sync debug mode "error";
    the ring's bits equal the same writes on the CPU, and the decode
    attention agrees with the CPU's within the bf16 rounding of its output
    (2**-7 of the largest |value|)."""
    from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

    _need_card()
    out = {}
    for device in ("cpu", "cuda"):
        (kc, vc), segs, q = _ring_case(device, int8)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for pos, kn, vn in segs:
                positions = (pos + torch.arange(kn.shape[1], device=device))[None].expand(2, -1)
                kc, vc = tops.update_kv_cache(kc, vc, kn, vn, pos, positions, ring=True)
            pos = segs[-1][0]
            o = tops.softmax_context(q, kc, vc, pos, positions=positions, local_window=6,
                                     ring=True)
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        out[device] = (kc, vc, o)
    for a, b in zip(out["cpu"][:2], out["cuda"][:2]):
        for name in (("q8", "s") if int8 else (None,)):
            x, y = (a, b) if name is None else (a[name], b[name])
            assert torch.equal(x, y.cpu())
    o_cpu, o_card = out["cpu"][2].float(), out["cuda"][2].float().cpu()
    assert (o_cpu - o_card).abs().max().item() <= 2.0 ** -7 * o_cpu.abs().max().item()


def test_per_token_loop_migrating_twice_dispatches_without_a_host_sync():
    """``fused_generate: false`` with a 16-slot floor: a 10-token prompt and
    40 new tokens migrate the cache 16 -> 32 -> 64 while nothing waits on
    the card; the stream equals the fused path's on the same engine build."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as ttf

    _need_card()
    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=2,
                                num_kv_heads=1, max_seq_len=64, dtype="bfloat16",
                                pos_embedding="rope", norm_type="rmsnorm",
                                activation="silu_glu", use_bias=False, tie_embeddings=False,
                                attn_impl="pallas")
    config = {"dtype": "bfloat16", "kv_read_floor": 16}
    fused = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(cfg), config=config)
    loop = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(cfg), params=fused.params,
                                              config=dict(config, fused_generate=False))
    toks = torch.randint(0, 256, (2, 10), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    want = fused.generate(toks, max_new_tokens=40)  # also builds and loads K1 and K7
    walk, real_grow = [], loop._grow_cache

    def grow(cache, new_len):
        walk.append(new_len)
        return real_grow(cache, new_len)

    loop._grow_cache = grow
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = loop.generate(toks, max_new_tokens=40)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert walk == [32, 64]
    assert torch.equal(got, want)


def test_alibi_reads_dispatch_without_a_host_sync():
    """ALiBi's cached reads never wait on the card: the aligned and the
    vector-position read of ``softmax_context`` (the slopes built before),
    then a BLOOM-shaped pool's two ticks (ALiBi, the embedding LayerNorm),
    under ``torch.cuda.set_sync_debug_mode("error")``; the reads equal the
    same calls on the CPU within 1e-5 (f32, summation order), and the pool's
    results the same requests served before."""
    from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, T, nh, nkv, hd = 2, 3, 64, 6, 2, 32
    q = torch.randn(B, S, nh, hd, generator=g, device="cuda")
    kc = torch.randn(B, T, nkv, hd, generator=g, device="cuda")
    vc = torch.randn(B, T, nkv, hd, generator=g, device="cuda")
    slopes = ttf._alibi_slopes(nh, q.device)
    pos = torch.tensor([5, 40], device="cuda")
    vector = (pos, pos[:, None] + torch.arange(S, device="cuda")[None])
    aligned = (17, (17 + torch.arange(S, device="cuda"))[None].expand(B, S))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [tops.softmax_context(q, kc, vc, p, positions=positions, alibi_slopes=slopes)
                for p, positions in (vector, aligned)]
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for out, (p, positions) in zip(outs, (vector, aligned)):
        want = tops.softmax_context(q.cpu(), kc.cpu(), vc.cpu(),
                                    p.cpu() if torch.is_tensor(p) else p,
                                    positions=positions.cpu(), alibi_slopes=slopes.cpu())
        assert (out.cpu() - want).abs().max().item() <= 1e-5

    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                                max_seq_len=128, dtype="bfloat16", pos_embedding="alibi",
                                embed_norm=True)
    eng = ContinuousBatchingEngine(ttf.TransformerModel(cfg), max_slots=4, cache_len=96,
                                   pipeline_depth=8, prefill_chunk=32)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32) for n in (20, 7, 33)]
    for p in prompts:
        eng.submit(p, max_new_tokens=9)
    while eng.has_work():
        eng.step()
    want = eng.finished()
    rids = [eng.submit(p, max_new_tokens=9) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(eng._inflight) == 2 and not eng.poisoned
    while eng.has_work():
        eng.step()
    got = eng.finished()
    for r, w in zip(rids, sorted(want)):
        np.testing.assert_array_equal(got[r], want[w])


def test_safetensors_reader_gives_the_same_tensors_on_the_card(tmp_path):
    """Tensors written from the card by ``chip_smoke.write_safetensors``
    (the card's machine has no safetensors package) read back through
    ``module_inject.load_checkpoint`` bit for bit, every dtype, onto the
    card; and a tiny Llama engine's weights written as HF shards load back
    through ``init_inference(dir)`` to the same greedy stream."""
    import chip_smoke
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.module_inject import export
    from deepspeed_tpu_torch.module_inject import load_checkpoint as tload

    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    tensors = {
        "bf16": torch.randn(64, 48, generator=g, device="cuda").to(torch.bfloat16),
        "f32": torch.randn(3, 5, 7, generator=g, device="cuda"),
        "f16": torch.randn(11, generator=g, device="cuda").half(),
        "u8": torch.arange(3, dtype=torch.uint8, device="cuda"),  # unaligns the next one
        "bf16_after": torch.randn(9, generator=g, device="cuda").to(torch.bfloat16),
        "i64": torch.arange(-4, 4, device="cuda"),
        "bool": torch.tensor([True, False], device="cuda"),
        "empty": torch.zeros(0, 3, device="cuda"),
    }
    path = str(tmp_path / "t.safetensors")
    chip_smoke.write_safetensors(path, tensors)
    got = tload.load_file(path)
    assert got.keys() == tensors.keys()
    for k, t in tensors.items():
        back = got[k].cuda()
        assert back.dtype == t.dtype and back.shape == t.shape and torch.equal(back, t), k

    cfg = ttf.TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                                num_kv_heads=2, ffn_hidden_size=256, max_seq_len=128,
                                dtype="bfloat16", pos_embedding="rope", norm_type="rmsnorm",
                                activation="silu_glu", use_bias=False, tie_embeddings=False,
                                attn_impl="pallas")
    eng = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(cfg),
                                             config={"dtype": "bfloat16"})
    hf_config = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
                 "vocab_size": 256, "hidden_size": 128, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 256,
                 "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
                 "tie_word_embeddings": False}
    d = str(tmp_path / "llama")
    os.makedirs(d)
    chip_smoke.write_hf_shards(d, export.export_hf_state_dict(eng.params, cfg, "llama"),
                               hf_config)
    loaded = deepspeed_tpu_torch.init_inference(d, config={"dtype": "bfloat16"})
    assert loaded.cfg == eng.cfg
    toks = torch.randint(0, 256, (2, 32), device="cuda", generator=g)
    assert torch.equal(loaded.generate(toks, max_new_tokens=8),
                       eng.generate(toks, max_new_tokens=8))
