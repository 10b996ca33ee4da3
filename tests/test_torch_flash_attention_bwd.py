"""Flash attention gradients: the port's plain backward ``_reference_bwd``
and autograd through its ``flash_attention`` (a ``torch.autograd.Function``
that takes the plain versions on CPU tensors) against ``jax.vjp`` of the
reference's ``flash_attention``, whose Pallas kernels run in interpret mode
on the CPU, as ``tests/unit/ops/test_pallas_ops.py`` runs them.

Tolerance: 2e-5 absolute on dq, dk and dv, in f32. Both sides compute in f32
(the reference's casts to the input dtype are identities at f32) and differ
only in summation order: the reference walks 32-wide tiles (or one 48-wide
tile), the plain version sums whole rows. Inputs and the output cotangent
are O(1), so the gradients are O(1) and agree to a few f32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5

# name: (B, S, H, Hkv, hd, causal, window, reference tile or None for its auto-tile)
CASES = {
    "causal": (2, 64, 4, 4, 16, True, None, 32),
    "non-causal": (2, 64, 4, 4, 16, False, None, 32),
    "gqa-h4-hkv2": (2, 64, 4, 2, 16, True, None, 32),
    "window-16": (2, 64, 4, 4, 16, True, 16, 32),
    "s48-auto-tile": (2, 48, 4, 4, 16, True, None, None),
}


def _inputs(B, S, H, Hkv, hd, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, H, hd).astype(np.float32)
    k = rs.randn(B, S, Hkv, hd).astype(np.float32)
    v = rs.randn(B, S, Hkv, hd).astype(np.float32)
    do = rs.randn(B, S, H, hd).astype(np.float32)  # the output's cotangent
    return q, k, v, do


def _max_diff(ref, got):
    return float(np.max(np.abs(np.asarray(ref) - got.detach().numpy())))


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_reference_vjp(case):
    B, S, H, Hkv, hd, causal, window, tile = CASES[case]
    q, k, v, do = _inputs(B, S, H, Hkv, hd, seed=len(case))
    kw = dict(causal=causal, window=window)
    if tile is not None:
        kw.update(block_q=tile, block_k=tile)
    o_ref, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, **kw),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    scale = hd ** -0.5
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal, window=window)
    assert _max_diff(o_ref, o) <= TOL
    plain = tfa._reference_bwd(tq, tk, tv, o, lse, tdo, causal, scale, window)

    tq, tk, tv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = tfa.flash_attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(tdo)
    for name, r, p, t in zip(("dq", "dk", "dv"), ref, plain, (tq, tk, tv)):
        assert p.shape == t.shape and p.dtype == torch.float32, name
        assert _max_diff(r, p) <= TOL, (name, "plain", _max_diff(r, p))
        assert _max_diff(r, t.grad) <= TOL, (name, "autograd", _max_diff(r, t.grad))


def test_grad_flows_through_strided_views_of_a_fused_projection():
    """q/k/v as views of one (B, S, 3*H*hd) projection, as the model passes
    them: the gradient lands in the projection's slices."""
    rs = np.random.RandomState(2)
    qkv = torch.from_numpy(rs.randn(2, 48, 3 * 4 * 16).astype(np.float32)).requires_grad_(True)
    q, k, v = (x.unflatten(-1, (4, 16)) for x in qkv.split(64, dim=-1))
    tfa.flash_attention(q, k, v).square().sum().backward()
    ref = qkv.detach().clone().requires_grad_(True)
    rq, rk, rv = (x.unflatten(-1, (4, 16)) for x in ref.split(64, dim=-1))
    tfa.mha_reference(rq, rk, rv).square().sum().backward()
    assert float((qkv.grad - ref.grad).abs().max()) <= TOL


def test_no_graph_without_grad():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 2, 16, seed=0))
    assert tfa.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None


def test_backward_rejects_mismatched_residuals():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 2, 16, seed=0))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="must match q"):
        tfa.flash_attention_bwd(q, k, v, o[:, :8], lse, do)
    with pytest.raises(ValueError, match="lse must be f32"):
        tfa.flash_attention_bwd(q, k, v, o, lse[:, :, :8], do)
