"""The port's ``ops/quantizer`` against the reference's, on the CPU, on the
same seeded numpy inputs (mirroring ``tests/unit/ops/test_pallas_ops.py``
``TestQuantizer``).

Tolerances: every deterministic function is f32 arithmetic in the same
order on both sides, and ``int8_linear``'s int8 product sums exactly in
int32, so the integers, the scales and the outputs must be equal bit for
bit (in f32 and in bf16). Stochastic rounding draws other noise (a
``torch.Generator`` against a JAX key), so it is held to its distribution:
unbiased within 2e-3 over 64 draws (the reference's own bound), and each
value on one of the two grid points around it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.ops import quantizer as tq


def _same(ref, out):
    ref = np.asarray(ref.astype(jnp.float32) if ref.dtype == jnp.bfloat16 else ref)
    out = (out.float() if out.dtype == torch.bfloat16 else out).detach().numpy()
    assert ref.dtype == out.dtype and ref.shape == out.shape, (ref.dtype, out.dtype)
    np.testing.assert_array_equal(ref, out)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("num_bits,num_groups", [(8, 4), (4, 8), (8, 1), (16, 2)])
def test_quantize_dequantize_bitwise(symmetric, num_bits, num_groups):
    rs = np.random.RandomState(num_bits + num_groups)
    x = (rs.randn(8, 96) * 3 + (0 if symmetric else 2)).astype(np.float32)
    x[0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # exact halves: round half to even
    rq, rs_, rzp = jq.quantize(jnp.asarray(x), num_bits, num_groups, symmetric)
    q, s, zp = tq.quantize(torch.from_numpy(x), num_bits, num_groups, symmetric)
    _same(rq, q)
    _same(rs_, s)
    assert (rzp is None) == (zp is None) == symmetric
    if zp is not None:
        _same(rzp, zp)
    _same(jq.dequantize(rq, rs_, rzp, num_groups, out_shape=x.shape),
          tq.dequantize(q, s, zp, num_groups, out_shape=x.shape))
    _same(jq.dequantize(rq, rs_, rzp, num_groups), tq.dequantize(q, s, zp, num_groups))


def test_symmetric_roundtrip():
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 256).astype(np.float32))
    q, scale, zp = tq.quantize(x, num_bits=8, num_groups=4, symmetric=True)
    assert q.dtype == torch.int8 and zp is None
    err = (tq.dequantize(q, scale, num_groups=4, out_shape=x.shape) - x).abs()
    assert float(err.max()) < float(x.abs().max()) / 127 * 1.01


def test_quantize_refuses_uneven_groups():
    with pytest.raises(ValueError, match="groups"):
        tq.quantize(torch.zeros(10), num_groups=3)


def test_stochastic_rounding_unbiased():
    """The reference's test: a value between grid points averages to itself."""
    x = torch.full((1, 1024), 0.5004)
    gen = torch.Generator().manual_seed(0)
    vals = []
    for _ in range(64):
        q, scale, _ = tq.quantize(x, num_bits=8, num_groups=1, stochastic=True, generator=gen)
        vals.append(float(tq.dequantize(q, scale, num_groups=1).mean()))
    assert abs(np.mean(vals) - 0.5004) < 2e-3


def test_stochastic_rounding_distribution():
    """Each value lands on one of the two grid points around it (those of
    the reference's nearest rounding and its neighbour), the upper one with
    probability equal to the fraction, as the reference's draws do."""
    rs = np.random.RandomState(5)
    x = rs.randn(16, 512).astype(np.float32)
    rq, rscale, _ = jq.quantize(jnp.asarray(x), 8, 16)
    t = x.reshape(16, -1) / np.asarray(rscale)
    lo = np.floor(t)
    draws = [tq.quantize(torch.from_numpy(x), 8, 16, stochastic=True,
                         generator=torch.Generator().manual_seed(i))[0].numpy() for i in range(32)]
    ref_draws = [np.asarray(jq.quantize(jnp.asarray(x), 8, 16, stochastic=True,
                                        rng=jax.random.PRNGKey(i))[0]) for i in range(32)]
    for d in (draws, ref_draws):
        d = np.stack(d).astype(np.float64)
        assert np.all((d == lo) | (d == lo + 1) | (np.abs(d) == 127))
        frac_up = (d == lo + 1).mean(axis=0)
        # 32 draws of 8192 values: the mean of (up - p) has a std of ~2e-3
        assert abs(float((frac_up - (t - lo)).mean())) < 0.01
    np.testing.assert_array_equal(np.asarray(rq), np.round(t).clip(-128, 127))
    with pytest.raises(ValueError, match="generator"):
        tq.quantize(torch.from_numpy(x), stochastic=True)


@pytest.mark.parametrize("num_bits,num_groups", [(4, 4), (8, 2)])
def test_fake_quantize_value_and_straight_through(num_bits, num_groups):
    x = np.random.RandomState(0).randn(4, 64).astype(np.float32)
    ref = jq.fake_quantize(jnp.asarray(x), num_bits=num_bits, num_groups=num_groups)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tq.fake_quantize(xt, num_bits=num_bits, num_groups=num_groups)
    _same(ref, out)
    (out * 2.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.full_like(x, 2.0))
    rg = jax.grad(lambda a: jnp.sum(jq.fake_quantize(a, num_bits, num_groups) * 2.0))(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(rg), xt.grad.numpy())


def test_fake_quantize_keeps_bf16():
    x = np.random.RandomState(1).randn(8, 256).astype(np.float32)
    ref = jq.fake_quantize(jnp.asarray(x, jnp.bfloat16), num_bits=4, num_groups=2)
    out = tq.fake_quantize(torch.from_numpy(x).bfloat16(), num_bits=4, num_groups=2)
    assert out.dtype == torch.bfloat16
    _same(ref, out)


@pytest.mark.parametrize("axis", [0, 1])
def test_per_channel_bitwise(axis):
    w = np.random.RandomState(2).randn(64, 32).astype(np.float32)
    rq, rscale = jq.quantize_per_channel(jnp.asarray(w), axis=axis)
    q, scale = tq.quantize_per_channel(torch.from_numpy(w), axis=axis)
    _same(rq, q)
    _same(rscale, scale)
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        _same(jq.dequantize_per_channel(rq, rscale, dtype=dtype),
              tq.dequantize_per_channel(q, scale, dtype=tdtype))
    back = tq.dequantize_per_channel(q, scale, dtype=torch.float32)
    assert float((back - torch.from_numpy(w)).abs().max()) / np.abs(w).max() < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(5,), (2, 7), (8, 1), (24,)])
def test_int8_linear_bitwise(dtype, lead):
    """The reference's (K, N) weight with (1, N) scales against the port's
    (N, K) weight with (N,) scales: the same bits out."""
    rs = np.random.RandomState(len(lead) * 10 + lead[-1])
    K, N = 48, 40
    x = rs.randn(*lead, K).astype(np.float32)
    x[..., 0] = 0.0
    if len(lead) == 2:
        x[0, 0] = 0.0  # an all-zero row: scale floored at 1e-12
    q8, scale = jq.quantize_per_channel(jnp.asarray(rs.randn(K, N).astype(np.float32)), axis=1)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jq.int8_linear(jx, q8, scale)
    out = tq.int8_linear(tx, torch.from_numpy(np.asarray(q8).T.copy()),
                         torch.from_numpy(np.asarray(scale).reshape(-1).copy()))
    assert out.dtype == tx.dtype and out.shape == (*lead, N)
    _same(ref, out)


def test_quantize_weight_matches_the_reference_engine_rule():
    """The engine's storage rule (absmax over the contraction dim, clip to
    [-128, 127], f32 scales) on the port's (out, in) layout: the reference's
    ``_quantize_weights`` on the transpose."""
    w = np.random.RandomState(3).randn(24, 40).astype(np.float32)  # (out, in)
    w[3] = 0.0
    w32 = jnp.asarray(w.T)  # the reference's (in, out)
    s = jnp.maximum(jnp.max(jnp.abs(w32), axis=-2, keepdims=True) / 127.0, 1e-12)
    q8 = jnp.clip(jnp.round(w32 / s), -128, 127).astype(jnp.int8)
    out = tq.quantize_weight(torch.from_numpy(w))
    assert out["q8"].shape == (24, 40) and out["s"].shape == (24,)
    assert out["q8"].dtype == torch.int8 and out["s"].dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(q8).T, out["q8"].numpy())
    np.testing.assert_array_equal(np.asarray(s).reshape(-1), out["s"].numpy())


@pytest.mark.parametrize("M,K,N,rows", [(8, 1024, 3072, 17), (16, 64, 8, 17), (17, 8, 8, 17),
                                        (1024, 4096, 1024, 1024)])
def test_int_mm_rows_pads_decode_rows(M, K, N, rows):
    assert tq.int_mm_rows(M, K, N) == rows


@pytest.mark.parametrize("K,N", [(12, 16), (16, 12), (100, 64)])
def test_int_mm_rows_raises_for_widths_the_card_refuses(K, N):
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int_mm_rows(8, K, N)
