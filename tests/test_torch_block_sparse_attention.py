"""Block-sparse attention: the port's ``block_sparse_attention`` (a
``torch.autograd.Function`` that takes the plain versions on CPU tensors),
its plain forward and backward, ``sparse_attention_reference`` and
``SparseSelfAttention`` against the reference's, whose Pallas kernels run in
interpret mode on the CPU, as ``tests/unit/ops/test_sparse_attention.py``
runs them. Inputs and output cotangents are made by numpy from a seed and
handed to both packages.

Tolerance: 2e-5 absolute on o, dq, dk and dv, in f32. Both sides compute in
f32 (the reference's kernels upcast every operand) and differ only in
summation order: the reference walks its tiles one at a time with a running
max, the plain versions sum whole rows. Inputs are O(1), so outputs and
gradients are O(1) and agree to a few f32 ulps. lse is held to 1e-5. A row
that nothing may attend is held exactly: o = 0 and lse = -1e30 + log(1e-20)
on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

TOL = 2e-5
LSE_TOL = 1e-5
B, S, H, HD = 2, 64, 4, 16
# mode: (config class, kwargs, block); small layouts of 4 x 4 or 2 x 2 tiles
MODES = {
    "dense": ("DenseSparsityConfig", {}, 32),
    "fixed": ("FixedSparsityConfig", dict(num_local_blocks=2), 16),
    "bigbird": ("BigBirdSparsityConfig", dict(num_random_blocks=1), 16),
    "bslongformer": ("BSLongformerSparsityConfig", {}, 16),
    "variable": ("VariableSparsityConfig", dict(local_window_blocks=[1, 2]), 16),
}


def _layout(mode, heads=H, seq=S):
    cls, kw, block = MODES[mode]
    return getattr(tsc, cls)(num_heads=heads, block=block, **kw).make_layout(seq), block


def _inputs(seed, shape=(B, S, H, HD), kv_heads=None):
    rs = np.random.RandomState(seed)
    kv_shape = shape[:2] + (kv_heads or shape[2], shape[3])
    q = rs.randn(*shape).astype(np.float32)
    k = rs.randn(*kv_shape).astype(np.float32)
    v = rs.randn(*kv_shape).astype(np.float32)
    do = rs.randn(*shape).astype(np.float32)
    return q, k, v, do


def _max_diff(ref, got):
    return float(np.max(np.abs(np.asarray(ref) - got.detach().numpy())))


def _reference_vjp(fn, q, k, v, do):
    """(fn(q, k, v), its vjp at do), under one jit (faster than eager
    interpret mode)."""
    def run(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)

    return jax.jit(run)(*(jnp.asarray(a) for a in (q, k, v, do)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_and_vjp_match_reference(mode, causal):
    layout, block = _layout(mode)
    q, k, v, do = _inputs(seed=len(mode) + causal)
    o_ref, grads_ref = _reference_vjp(
        lambda q, k, v: jbs.block_sparse_attention(q, k, v, layout, causal=causal, block=block),
        q, k, v, do)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tbs.block_sparse_attention_fwd(tq, tk, tv, layout, causal=causal, block=block)
    assert _max_diff(o_ref, o) <= TOL
    plain = tbs.block_sparse_attention_bwd(tq, tk, tv, o, lse, tdo, layout, causal=causal,
                                           block=block)

    tq, tk, tv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = tbs.block_sparse_attention(tq, tk, tv, layout, causal=causal, block=block)
    assert type(out.grad_fn).__name__ == "_BlockSparseAttentionBackward"
    assert _max_diff(o_ref, out) <= TOL
    out.backward(tdo)
    for name, r, p, t in zip(("dq", "dk", "dv"), grads_ref, plain, (tq, tk, tv)):
        assert p.shape == t.shape and p.dtype == torch.float32, name
        assert _max_diff(r, p) <= TOL, (name, "plain", _max_diff(r, p))
        assert _max_diff(r, t.grad) <= TOL, (name, "autograd", _max_diff(r, t.grad))


def test_lse_matches_the_reference_kernel():
    """The saved lse (B, H, S, 1) against the reference's ``_fwd``."""
    layout, block = _layout("bigbird")
    q, k, v, _ = _inputs(seed=7)
    qt, kt, vt = (jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)) for a in (q, k, v))
    _, lse_ref = jbs._fwd(qt, kt, vt, jnp.asarray(layout), True, HD ** -0.5, block, True)
    _, lse = tbs.block_sparse_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), layout,
                                            causal=True, block=block)
    assert lse.shape == (B, H, S, 1) and lse.dtype == torch.float32
    assert _max_diff(lse_ref, lse) <= LSE_TOL


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["bigbird", "variable"])
def test_dense_reference_matches_reference(mode, causal):
    """``sparse_attention_reference`` (the expanded block mask, dense) in
    both packages, and the port's kernel path against it."""
    layout, block = _layout(mode)
    q, k, v, _ = _inputs(seed=3)
    ref = jbs.sparse_attention_reference(*(jnp.asarray(a) for a in (q, k, v)), layout, block,
                                         causal=causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    dense = tbs.sparse_attention_reference(tq, tk, tv, layout, block, causal=causal)
    assert _max_diff(ref, dense) <= TOL
    out = tbs.block_sparse_attention(tq, tk, tv, layout, causal=causal, block=block)
    assert float((out - dense).abs().max()) <= TOL


@pytest.mark.parametrize("causal", [False, True])
def test_an_all_zero_layout_row_gives_zero(causal):
    """A q-tile whose layout row is all zero attends nothing: o = 0 exactly
    and lse = -1e30 + log(1e-20), as the reference kernel gives; its
    gradients are 0 and the other rows are unaffected."""
    layout, block = _layout("fixed")
    layout[1, 2, :] = 0  # head 1, rows 32..47
    q, k, v, do = _inputs(seed=11)
    qt, kt, vt = (jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)) for a in (q, k, v))
    o_ref, lse_ref = jbs._fwd(qt, kt, vt, jnp.asarray(layout), causal, HD ** -0.5, block, True)
    o_ref, lse_ref = np.asarray(o_ref).transpose(0, 2, 1, 3), np.asarray(lse_ref)
    tq, tk, tv, tdo = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, do))
    o, lse = tbs.block_sparse_attention_fwd(tq.detach(), tk.detach(), tv.detach(), layout,
                                            causal=causal, block=block)
    rows = slice(2 * block, 3 * block)
    assert float(o[:, rows, 1].abs().max()) == 0.0 and float(np.abs(o_ref[:, rows, 1]).max()) == 0.0
    np.testing.assert_array_equal(lse[:, 1, rows].detach().numpy(), lse_ref[:, 1, rows])
    assert float(lse[0, 1, 2 * block, 0]) == np.float32(-1e30) + np.float32(np.log(1e-20))
    assert _max_diff(o_ref, o) <= TOL
    out = tbs.block_sparse_attention(tq, tk, tv, layout, causal=causal, block=block)
    out.backward(tdo.detach())
    assert float(tq.grad[:, rows, 1].abs().max()) == 0.0


def test_gqa_through_the_models_repeat():
    """Fewer kv heads: the caller repeats them (``repeat_interleave`` on dim
    2, as ``jnp.repeat(axis=2)``), and autograd sums each group's gradients."""
    layout, block = _layout("bigbird")
    q, k, v, do = _inputs(seed=5, kv_heads=2)

    def ref_fn(q, k, v):
        k, v = jnp.repeat(k, 2, axis=2), jnp.repeat(v, 2, axis=2)
        return jbs.block_sparse_attention(q, k, v, layout, causal=True, block=block)

    o_ref, grads_ref = _reference_vjp(ref_fn, q, k, v, do)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tbs.block_sparse_attention(tq, tk.repeat_interleave(2, dim=2),
                                     tv.repeat_interleave(2, dim=2), layout, causal=True,
                                     block=block)
    out.backward(torch.from_numpy(do))
    assert _max_diff(o_ref, out) <= TOL
    for r, t in zip(grads_ref, (tq, tk, tv)):
        assert t.grad.shape == t.shape and _max_diff(r, t.grad) <= TOL


def test_sparse_self_attention_matches_reference():
    ref = jbs.SparseSelfAttention(jsc.BSLongformerSparsityConfig(num_heads=H, block=16),
                                  causal=True)
    attn = tbs.SparseSelfAttention(tsc.BSLongformerSparsityConfig(num_heads=H, block=16),
                                   causal=True)
    q, k, v, _ = _inputs(seed=2)
    out = attn(*(torch.from_numpy(a) for a in (q, k, v)))
    assert out.shape == (B, S, H, HD)
    assert _max_diff(ref(*(jnp.asarray(a) for a in (q, k, v))), out) <= TOL
    layout = attn.layout(S)
    assert attn.layout(S) is layout and not layout.flags.writeable
    np.testing.assert_array_equal(layout, np.asarray(ref.layout(S)))


@pytest.mark.parametrize("block,causal", [(16, True), (16, False), (128, True), (128, False)])
def test_tile_lists_hold_exactly_the_live_pairs(block, causal):
    """The kernels' tile lists: ascending, each (q-tile, k-tile) once in the
    rows and once in the columns, and together exactly the pairs the layout
    and the causal mask let through (a tile wholly above the diagonal is
    left out; a block of 128 is split into 2 x 2 tiles of 64)."""
    seq = 8 * block
    layout = tsc.BigBirdSparsityConfig(num_heads=3, block=block, num_random_blocks=2,
                                       different_layout_per_head=True).make_layout(seq)
    lists = tbs.tile_lists(layout, block, causal)
    tile = lists["tile"]
    assert tile == min(block, 64)
    n = seq // tile
    assert lists["row_ptr"].shape == lists["col_ptr"].shape == (3 * n + 1,)
    covered = np.zeros((3, seq, seq), bool)
    by_rows = set()
    for h in range(3):
        for qt in range(n):
            lo, hi = lists["row_ptr"][h * n + qt], lists["row_ptr"][h * n + qt + 1]
            kts = lists["cols"][lo:hi]
            assert list(kts) == sorted(set(kts))
            assert not causal or all(kt <= qt for kt in kts)
            for kt in kts:
                by_rows.add((h, qt, int(kt)))
                covered[h, qt * tile:(qt + 1) * tile, kt * tile:(kt + 1) * tile] = True
    by_cols = set()
    for h in range(3):
        for kt in range(n):
            lo, hi = lists["col_ptr"][h * n + kt], lists["col_ptr"][h * n + kt + 1]
            qts = lists["rows"][lo:hi]
            assert list(qts) == sorted(set(qts))
            by_cols.update((h, int(qt), kt) for qt in qts)
    assert by_rows == by_cols
    mask = tbs._mask(layout, block, seq, seq, causal, "cpu").numpy()
    assert np.array_equal(covered & mask, mask)  # every live pair lies in a listed tile
    for h, qt, kt in by_rows:  # and every listed tile holds a live pair
        assert mask[h, qt * tile:(qt + 1) * tile, kt * tile:(kt + 1) * tile].any()


def test_the_fixed_default_at_the_slices_length():
    """The training slice's layout (the fixed default, 12 heads, S 4096,
    block 64): 1216 live tiles per head, 640 on or below the diagonal."""
    layout = tsc.FixedSparsityConfig(num_heads=12).make_layout(4096)
    assert (layout.reshape(12, -1).sum(1) == 1216).all()
    lists = tbs.tile_lists(layout, 64, True)
    assert lists["cols"].size == lists["rows"].size == 12 * 640


def test_inputs_it_does_not_take_raise():
    layout, block = _layout("fixed")
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(seed=0))
    with pytest.raises(ValueError, match="as many kv heads"):
        tbs.block_sparse_attention(q, k[:, :, :2], v[:, :, :2], layout[:2], block=block)
    with pytest.raises(ValueError, match="multiples of the block"):
        tbs.block_sparse_attention(q[:, :40], k[:, :40], v[:, :40], layout, block=block)
    with pytest.raises(ValueError, match="layout shape"):
        tbs.block_sparse_attention(q, k, v, layout[:, :2], block=block)
    with pytest.raises(TypeError, match="dtypes differ"):
        tbs.block_sparse_attention(q, k.double(), v, layout, block=block)
    with pytest.raises(ValueError, match=r"\(B, S, H, hd\)"):
        tbs.block_sparse_attention(q[0], k[0], v[0], layout, block=block)
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, block=block)
    with pytest.raises(ValueError, match="must match q"):
        tbs.block_sparse_attention_bwd(q, k, v, o[:, :16], lse, q, layout, block=block)
    with pytest.raises(ValueError, match="lse must be f32"):
        tbs.block_sparse_attention_bwd(q, k, v, o, lse.double(), q, layout, block=block)
    # the kernels' own limits, checked before any launch
    with pytest.raises(ValueError, match="head_dim"):
        tbs._check_kernel_inputs(torch.zeros(1, 64, 2, 48), torch.zeros(1, 64, 2, 48),
                                 torch.zeros(1, 64, 2, 48), 16)
    with pytest.raises(ValueError, match="block must be one of"):
        tbs._check_kernel_inputs(q, k, v, 8)
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        tbs._check_kernel_inputs(q.double(), k.double(), v.double(), 16)


def test_no_graph_without_grad():
    layout, block = _layout("fixed")
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(seed=0))
    assert tbs.block_sparse_attention(q, k, v, layout, block=block).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert tbs.block_sparse_attention(q, k, v, layout, block=block).grad_fn is None
