"""The port's fused-op surface (``ops/transformer/fused_ops.py`` and
``ops/fused_norm.py``) against the reference's ``fused_ops``, on the CPU.
The reference's fused norm runs its Pallas kernels in interpret mode (which
``_auto_interpret`` picks on the CPU), as ``tests/unit/ops/test_pallas_ops.py``
``TestFusedNorm`` runs them; the port takes its plain versions on CPU
tensors. Inputs and cotangents are made by numpy from a seed and handed to
both packages.

Tolerances, f32: forward (out, mu, rstd) within 1e-5 of the largest
|reference| value, every gradient within 1e-5 of the largest |reference|
value of the same leaf. Both sides compute in f32 and differ only in
summation order: the reference sums rows block by block and its dscale/dbias
partials over blocks, the port sums whole rows and all rows at once. In
bf16/f16 the two f32 results are rounded once each, so they are at most one
rounding apart: elementwise within one ulp (2**-7 relative in bf16, 2**-10
in f16) of the larger. The bias-dropout-residual at ratio 0 or without a
generator is ``residual + x + bias`` on both sides: exact. Its keep mask
comes from a ``torch.Generator``, not JAX's keys, so at ratio 0.1 it is held
to its keep rate (within 4 sigma of 1 - ratio), to the reference's scaling
of the kept values (bit for bit) and to the residual where it drops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import fused_norm as jfn
from deepspeed_tpu.ops.transformer import fused_ops as jfo
from deepspeed_tpu_torch.ops import fused_norm as tfn
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo

TOL = 1e-5
ULP = {jnp.bfloat16: 2.0 ** -7, jnp.float16: 2.0 ** -10}


def _rand(rs, *shape, loc=0.0, std=1.0):
    return (loc + std * rs.randn(*shape)).astype(np.float32)


def _norm_inputs(seed, shape, bias=True):
    rs = np.random.RandomState(seed)
    D = shape[-1]
    x = _rand(rs, *shape)
    scale = _rand(rs, D, loc=1.0, std=0.1)
    b = _rand(rs, D, std=0.1) if bias else None
    do = _rand(rs, *shape)
    return x, scale, b, do


def _t(a, requires_grad=False):
    return None if a is None else torch.from_numpy(a.copy()).requires_grad_(requires_grad)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _from_jax(a, dtype):
    """A JAX array as a torch tensor of ``dtype`` (through an f32 copy)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _assert_close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _assert_one_rounding(got, ref, dtype, what):
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.detach().float().numpy()
    bound = ULP[dtype] * np.maximum(np.abs(got), np.abs(ref))
    assert np.all(np.abs(got - ref) <= bound), (what, np.abs(got - ref).max())


# name: (shape, kind, block_rows); kind "ln" with bias, "ln_nobias", "rms"
FWD_CASES = {
    "ln_4x16x128": ((4, 16, 128), "ln", 256),
    "ln_nobias_4x16x128": ((4, 16, 128), "ln_nobias", 256),
    "rms_64x256": ((64, 256), "rms", 256),
    "ln_ragged_3x7x96": ((3, 7, 96), "ln", 256),
    "rms_ragged_3x7x96": ((3, 7, 96), "rms", 256),
    "ln_block_rows_16_64x128": ((64, 128), "ln", 16),
}


def _call(pkg, kind, x, scale, bias, block_rows=256):
    if kind == "rms":
        return pkg.fused_rmsnorm(x, scale, block_rows=block_rows)
    return pkg.fused_layernorm(x, scale, bias if kind == "ln" else None,
                               block_rows=block_rows)


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_forward_matches_reference(name):
    shape, kind, block_rows = FWD_CASES[name]
    x, scale, bias, _ = _norm_inputs(len(name), shape, bias=kind == "ln")
    ref = _call(jfo, kind, _j(x), _j(scale), _j(bias), block_rows)
    out = _call(tfo, kind, _t(x), _t(scale), _t(bias), block_rows)
    assert out.dtype == torch.float32 and out.shape == shape
    _assert_close(out, ref, name)


@pytest.mark.parametrize("kind,shape", [("ln", (64, 128)), ("rms", (64, 128)),
                                        ("ln", (21, 96))])
def test_mu_and_rstd_match_run_fwd(kind, shape):
    """The saved statistics against the reference kernel's, (N, 1) f32."""
    rms = kind == "rms"
    x, scale, bias, _ = _norm_inputs(7, shape, bias=not rms)
    o, mu, rstd = jfn._run_fwd(_j(x), _j(scale), _j(bias), 1e-5, rms, 256, True)
    to, tmu, trstd = tfn._reference_fwd(_t(x), _t(scale), _t(bias), 1e-5, rms)
    assert tmu.dtype == trstd.dtype == torch.float32 and tmu.shape == (shape[0], 1)
    for what, got, ref in (("out", to, o), ("mu", tmu, mu), ("rstd", trstd, rstd)):
        _assert_close(got, ref, what)
    if rms:
        assert not tmu.any()


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_reference_bwd_matches_run_bwd(kind):
    """K8's plain version (with the sum over rows) against the reference
    kernel's dx and its partials summed over two row blocks."""
    rms = kind == "rms"
    x, scale, _, do = _norm_inputs(8, (48, 128), bias=False)
    _, mu, rstd = jfn._run_fwd(_j(x), _j(scale), None, 1e-5, rms, 24, True)
    dx, dscale, dbias = jfn._run_bwd(_j(x), _j(scale), mu, rstd, _j(do), rms, 24, True)
    tdx, tdscale, tdbias = tfn._reference_bwd(_t(x), _t(scale), _t(np.asarray(mu)),
                                              _t(np.asarray(rstd)), _t(do), rms)
    assert tdscale.dtype == tdbias.dtype == torch.float32
    for what, got, ref in (("dx", tdx, dx), ("dscale", tdscale, dscale),
                           ("dbias", tdbias, dbias)):
        _assert_close(got, ref, what)


# name: (shape, kind)
GRAD_CASES = {
    "ln_32x128": ((32, 128), "ln"),
    "ln_nobias_32x128": ((32, 128), "ln_nobias"),
    "rms_16x128": ((16, 128), "rms"),
    "ln_2x8x64": ((2, 8, 64), "ln"),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradients_match_jax_vjp(name):
    shape, kind = GRAD_CASES[name]
    x, scale, bias, do = _norm_inputs(len(name) + 11, shape, bias=kind == "ln")
    if kind == "ln":
        ref_out, vjp = jax.vjp(lambda a, s, b: jfo.fused_layernorm(a, s, b), _j(x), _j(scale),
                               _j(bias))
    else:
        ref_out, vjp = jax.vjp(lambda a, s: _call(jfo, kind, a, s, None), _j(x), _j(scale))
    ref_grads = vjp(_j(do))
    leaves = [_t(x, True), _t(scale, True)] + ([_t(bias, True)] if kind == "ln" else [])
    out = _call(tfo, kind, leaves[0], leaves[1], leaves[2] if kind == "ln" else None)
    _assert_close(out, ref_out, "out")
    grads = torch.autograd.grad(out, leaves, _t(do))
    assert len(grads) == len(ref_grads)
    for leaf, got, ref in zip(("x", "scale", "bias"), grads, ref_grads):
        assert got.dtype == torch.float32
        _assert_close(got, ref, f"d{leaf}")


def test_no_bias_gives_no_dbias():
    """The autograd Function's backward returns None for the absent bias,
    as the reference's VJP does, and the bias's dtype for a present one."""
    x, scale, bias, do = _norm_inputs(3, (8, 32))
    xt, st = _t(x, True), _t(scale, True)
    out = tfn._FusedNorm.apply(xt, st, None, 1e-5, False)
    grads = out.grad_fn.apply(_t(do))
    assert grads[2] is None and grads[0].shape == (8, 32) and grads[1].shape == (32,)
    bt = torch.from_numpy(bias).to(torch.float16).requires_grad_(True)
    out = tfn._FusedNorm.apply(xt, st, bt, 1e-5, False)
    assert out.grad_fn.apply(_t(do))[2].dtype == torch.float16


@pytest.mark.parametrize("scale_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_bf16_x_matches_reference_within_one_rounding(scale_dtype, kind):
    """bf16 x with an f32 or a bf16 scale (and bias): out and dx in bf16,
    dscale and dbias in the parameters' dtype, each within one bf16
    rounding of the reference's."""
    x, scale, bias, do = _norm_inputs(5, (4, 16, 128), bias=kind == "ln")
    jx, jdo = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(do).astype(jnp.bfloat16)
    params = [jnp.asarray(scale).astype(scale_dtype)]
    if kind == "ln":
        params.append(jnp.asarray(bias).astype(scale_dtype))
    fn = (lambda a, *p: jfo.fused_layernorm(a, *p)) if kind == "ln" else jfo.fused_rmsnorm
    ref_out, vjp = jax.vjp(fn, jx, *params)
    ref_grads = vjp(jdo)
    tparam_dtype = torch.float32 if scale_dtype == jnp.float32 else torch.bfloat16
    leaves = [_from_jax(jx, torch.bfloat16).requires_grad_(True)] + [
        _from_jax(p, tparam_dtype).requires_grad_(True) for p in params]
    out = (tfo.fused_layernorm(*leaves) if kind == "ln" else tfo.fused_rmsnorm(*leaves))
    assert out.dtype == torch.bfloat16
    _assert_one_rounding(out, ref_out, jnp.bfloat16, "out")
    grads = torch.autograd.grad(out, leaves, _from_jax(jdo, torch.bfloat16))
    assert grads[0].dtype == torch.bfloat16
    assert all(g.dtype == tparam_dtype for g in grads[1:])
    for leaf, got, ref in zip(("x", "scale", "bias"), grads, ref_grads):
        if got.dtype == torch.float32:
            _assert_close(got, ref, f"d{leaf}")
        else:
            _assert_one_rounding(got, ref, jnp.bfloat16, f"d{leaf}")


def test_f16_x_without_bias_matches_reference():
    """chip_smoke.py's ragged shape: rows 77 x D 100, f16 x, f32 scale."""
    x, scale, _, do = _norm_inputs(6, (77, 100), bias=False)
    jx, jdo = jnp.asarray(x).astype(jnp.float16), jnp.asarray(do).astype(jnp.float16)
    ref_out, vjp = jax.vjp(lambda a, s: jfo.fused_layernorm(a, s), jx, _j(scale))
    rdx, rds = vjp(jdo)
    tx = torch.from_numpy(x).to(torch.float16).requires_grad_(True)
    ts = _t(scale, True)
    out = tfo.fused_layernorm(tx, ts)
    _assert_one_rounding(out, ref_out, jnp.float16, "out")
    dx, ds = torch.autograd.grad(out, (tx, ts), torch.from_numpy(do).to(torch.float16))
    assert dx.dtype == torch.float16 and ds.dtype == torch.float32
    _assert_one_rounding(dx, rdx, jnp.float16, "dx")
    _assert_close(ds, rds, "dscale")


def test_fused_bias_gelu_matches_reference():
    rs = np.random.RandomState(9)
    x, b = _rand(rs, 4, 8, 96, std=2.0), _rand(rs, 96)
    ref = jfo.fused_bias_gelu(_j(x), _j(b))
    out = tfo.fused_bias_gelu(_t(x), _t(b))
    _assert_close(out, ref, "gelu")


def _dropout_inputs(seed, shape=(64, 512)):
    rs = np.random.RandomState(seed)
    return _rand(rs, *shape), _rand(rs, shape[-1]), _rand(rs, *shape)


@pytest.mark.parametrize("ratio,with_rng", [(0.0, True), (0.1, False)])
def test_bias_dropout_residual_without_dropout_is_exact(ratio, with_rng):
    x, b, res = _dropout_inputs(10)
    ref = jfo.fused_bias_dropout_residual(_j(x), _j(b), _j(res), ratio,
                                          jax.random.PRNGKey(0) if with_rng else None)
    gen = torch.Generator().manual_seed(0) if with_rng else None
    out = tfo.fused_bias_dropout_residual(_t(x), _t(b), _t(res), ratio, gen)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bias_dropout_residual_keep_rate_and_scaling(dtype):
    """At ratio 0.1: the keep rate within 4 sigma of 0.9, every kept element
    the reference's h / (1 - ratio) bit for bit, every dropped element the
    residual exactly."""
    ratio = 0.1
    x, b, res = _dropout_inputs(11)
    jx, jb, jres = (jnp.asarray(a).astype(dtype) for a in (x, b, res))
    h = jx + jb
    want_kept = np.asarray((h / (1.0 - ratio)).astype(jnp.float32))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx, tb, tres = (_from_jax(a, tdtype) for a in (jx, jb, jres))
    dropped_only = tfo.fused_bias_dropout_residual(tx, tb, torch.zeros_like(tres), ratio,
                                                   torch.Generator().manual_seed(1))
    out = tfo.fused_bias_dropout_residual(tx, tb, tres, ratio, torch.Generator().manual_seed(1))
    assert out.dtype == tdtype
    h_np = np.asarray(h.astype(jnp.float32))
    decided = h_np != 0  # where h is 0 a kept and a dropped element look alike
    kept = dropped_only.float().numpy() != 0
    rate = kept[decided].mean()
    sigma = np.sqrt(ratio * (1 - ratio) / decided.sum())
    assert abs(rate - (1 - ratio)) <= 4 * sigma, rate
    np.testing.assert_array_equal(dropped_only.float().numpy()[kept], want_kept[kept])
    res_np = np.asarray(jres.astype(jnp.float32))
    np.testing.assert_array_equal(out.float().numpy()[~kept], res_np[~kept])
    want_out = np.asarray((jres + (h / (1.0 - ratio))).astype(jnp.float32))
    np.testing.assert_array_equal(out.float().numpy()[kept], want_out[kept])


def test_bias_dropout_residual_mask_follows_the_generator_seed():
    x, b, res = (_t(a) for a in _dropout_inputs(12))
    first = tfo.fused_bias_dropout_residual(x, b, res, 0.1, torch.Generator().manual_seed(5))
    again = tfo.fused_bias_dropout_residual(x, b, res, 0.1, torch.Generator().manual_seed(5))
    other = tfo.fused_bias_dropout_residual(x, b, res, 0.1, torch.Generator().manual_seed(6))
    assert torch.equal(first, again)
    assert not torch.equal(first, other)


@pytest.mark.parametrize("name", ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer",
                                  "init_transformer_layer", "transformer_layer_fwd"])
def test_transformer_layer_names_are_not_ported_yet(name):
    assert hasattr(jfo, name)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        getattr(tfo, name)
    assert name not in tfo.__all__


def test_surface_has_the_reference_functions():
    ported = {"fused_softmax", "fused_bias_gelu", "fused_bias_dropout_residual",
              "fused_layernorm", "fused_rmsnorm"}
    assert set(tfo.__all__) == ported == set(jfo.__all__) - {
        "DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer", "init_transformer_layer",
        "transformer_layer_fwd"}
    with pytest.raises(AttributeError):
        tfo.no_such_op


@pytest.mark.parametrize("which", ["scale", "bias"])
def test_a_parameter_of_the_wrong_width_raises(which):
    x, scale, bias, _ = _norm_inputs(2, (4, 32))
    if which == "scale":
        scale = np.ones(33, np.float32)
    else:
        bias = np.zeros(31, np.float32)
    with pytest.raises(ValueError, match=f"{which} must have shape"):
        tfo.fused_layernorm(_t(x), _t(scale), _t(bias))


@pytest.mark.parametrize("block_rows", [0, -8, 2.5, True])
def test_block_rows_must_be_a_positive_int(block_rows):
    x, scale, _, _ = _norm_inputs(2, (4, 32))
    with pytest.raises(ValueError, match="block_rows"):
        tfo.fused_rmsnorm(_t(x), _t(scale), block_rows=block_rows)


def test_block_rows_does_not_change_the_result():
    x, scale, bias, _ = _norm_inputs(4, (40, 64))
    outs = [tfo.fused_layernorm(_t(x), _t(scale), _t(bias), block_rows=br) for br in (1, 8, 256)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_a_device_other_than_cuda_or_cpu_raises():
    x = torch.empty(4, 32, device="meta")
    scale = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfo.fused_layernorm(x, scale)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfo.fused_rmsnorm(x, scale)
