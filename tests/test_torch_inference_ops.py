"""Decode-path inference ops of the port against the reference's, in f32 on
the CPU: the KV-cache write (scalar and vector ``pos``) and the cached
masked attention ``softmax_context`` with and without tight reads.

Tolerances: the cache write copies values, so it must be exact; attention
is f32 on both sides with another summation order: 1e-5 absolute (one bf16
case: 2e-2, see its test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import fused_ops as jfo
from deepspeed_tpu.ops.transformer import inference_ops as jops
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

TOL = 1e-5


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _caches(rs, B=2, T=16, H=2, hd=8):
    return _rand(rs, B, T, H, hd), _rand(rs, B, T, H, hd)


@pytest.mark.parametrize("pos,S", [(0, 5), (3, 5), (15, 1), (14, 5)])
def test_update_kv_cache_scalar_pos(pos, S):
    """Contiguous write; (14, 5) overruns T=16 and is clamped to fit, as
    lax.dynamic_update_slice clamps."""
    rs = np.random.RandomState(pos)
    kc, vc = _caches(rs)
    kn, vn = _rand(rs, 2, S, 2, 8), _rand(rs, 2, S, 2, 8)
    ref_k, ref_v = jops.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                                        jnp.asarray(vn), pos)
    out_k, out_v = tops.update_kv_cache(torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                                        torch.from_numpy(kn), torch.from_numpy(vn), pos)
    np.testing.assert_array_equal(np.asarray(ref_k), out_k.numpy())
    np.testing.assert_array_equal(np.asarray(ref_v), out_v.numpy())


def test_update_kv_cache_vector_pos_drops_out_of_range():
    rs = np.random.RandomState(1)
    kc, vc = _caches(rs)
    kn, vn = _rand(rs, 2, 3, 2, 8), _rand(rs, 2, 3, 2, 8)
    pos = np.array([4, 14], np.int32)
    positions = pos[:, None] + np.arange(3, dtype=np.int32)[None]  # row 1 runs past T=16
    positions[0, 2] = 99  # a parked pad column: dropped
    ref_k, ref_v = jops.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                                        jnp.asarray(vn), jnp.asarray(pos), jnp.asarray(positions))
    out_k, out_v = tops.update_kv_cache(
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(pos), torch.from_numpy(positions).long())
    np.testing.assert_array_equal(np.asarray(ref_k), out_k.numpy())
    np.testing.assert_array_equal(np.asarray(ref_v), out_v.numpy())


def test_update_kv_cache_writes_in_place():
    rs = np.random.RandomState(2)
    kc, vc = (torch.from_numpy(a) for a in _caches(rs))
    k_out, _ = tops.update_kv_cache(kc, vc, torch.ones(2, 1, 2, 8), torch.ones(2, 1, 2, 8), 3)
    assert k_out.data_ptr() == kc.data_ptr() and bool((kc[:, 3] == 1).all())


def _context(q, kc, vc, pos, positions, read_len):
    ref = jops.softmax_context(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos,
        positions=None if positions is None else jnp.asarray(positions), read_len=read_len)
    out = tops.softmax_context(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos,
        positions=None if positions is None else torch.from_numpy(positions).long(),
        read_len=read_len)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("read_len", [None, 8])
@pytest.mark.parametrize("S,pos", [(1, 5), (4, 3)])
def test_softmax_context_scalar_pos(S, pos, read_len):
    """Causal segment at an aligned depth; GQA (4 query heads, 2 kv heads);
    a tight read of 8 slots covers every attended position."""
    rs = np.random.RandomState(S * 10 + pos)
    kc, vc = _caches(rs)
    q = _rand(rs, 2, S, 4, 8)
    positions = np.broadcast_to(pos + np.arange(S, dtype=np.int32), (2, S)).copy()
    ref, out = _context(q, kc, vc, pos, positions, read_len)
    assert out.shape == (2, S, 4, 8)
    assert np.max(np.abs(ref - out)) <= TOL


@pytest.mark.parametrize("read_len", [None, 8])
def test_softmax_context_vector_pos(read_len):
    rs = np.random.RandomState(4)
    kc, vc = _caches(rs)
    q = _rand(rs, 2, 2, 4, 8)
    pos = np.array([2, 5], np.int32)
    positions = pos[:, None] + np.arange(2, dtype=np.int32)[None]
    ref, out = _context(q, kc, vc, pos, positions, read_len)
    assert np.max(np.abs(ref - out)) <= TOL


def test_softmax_context_bf16_casts_probs_like_reference():
    """In bfloat16 both packages cast the f32 probabilities to q's dtype
    before the PV product; the outputs then agree to bf16 rounding (8-bit
    mantissa: 2e-2 at |o| <= 2)."""
    rs = np.random.RandomState(8)
    kc, vc = _caches(rs)
    q = _rand(rs, 2, 3, 4, 8)
    positions = np.broadcast_to(5 + np.arange(3, dtype=np.int32), (2, 3)).copy()
    ref = jops.softmax_context(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
                               jnp.asarray(vc, jnp.bfloat16), 5, positions=jnp.asarray(positions))
    out = tops.softmax_context(torch.from_numpy(q).bfloat16(), torch.from_numpy(kc).bfloat16(),
                               torch.from_numpy(vc).bfloat16(), 5,
                               positions=torch.from_numpy(positions).long())
    assert out.dtype == torch.bfloat16
    assert np.max(np.abs(np.asarray(ref.astype(jnp.float32)) - out.float().numpy())) <= 2e-2


def test_softmax_context_prefix_mode():
    """positions=None: every row attends the [0..pos] prefix."""
    rs = np.random.RandomState(5)
    kc, vc = _caches(rs)
    q = _rand(rs, 2, 3, 2, 8)
    ref, out = _context(q, kc, vc, 6, None, None)
    assert np.max(np.abs(ref - out)) <= TOL


def test_tight_read_equals_full_read():
    """The masked tail beyond the active length contributes exact zeros."""
    rs = np.random.RandomState(6)
    kc, vc = (torch.from_numpy(a) for a in _caches(rs))
    q = torch.from_numpy(_rand(rs, 2, 1, 2, 8))
    positions = torch.full((2, 1), 6, dtype=torch.long)
    full = tops.softmax_context(q, kc, vc, 6, positions=positions)
    tight = tops.softmax_context(q, kc, vc, 6, positions=positions, read_len=8)
    assert torch.allclose(full, tight, atol=1e-6, rtol=0)


def test_slice_kv_time_is_a_view():
    kc = torch.zeros(2, 16, 2, 8)
    view = tops.slice_kv_time(kc, 4)
    assert view.shape == (2, 4, 2, 8) and view.data_ptr() == kc.data_ptr()
    assert tops.slice_kv_time(kc, None) is kc


def test_fused_softmax_matches_reference():
    rs = np.random.RandomState(7)
    x = _rand(rs, 3, 17)
    mask = np.where(rs.rand(3, 17) < 0.3, -1e30, 0.0).astype(np.float32)
    ref = jfo.fused_softmax(jnp.asarray(x), jnp.asarray(mask))
    out = tfo.fused_softmax(torch.from_numpy(x), torch.from_numpy(mask))
    assert np.max(np.abs(np.asarray(ref) - out.numpy())) <= 1e-6
