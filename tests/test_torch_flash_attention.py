"""Flash attention: the port's plain path (the CPU side of
``deepspeed_tpu_torch.ops.flash_attention``) against the reference's Pallas
kernel, run in interpret mode on the CPU as the reference's own tests run it.

Tolerance: 1e-5 absolute in f32. Both sides compute in f32 and differ only
in summation order (online softmax over tiles against a dense softmax); the
inputs are O(1), so the outputs agree to a few f32 ulps.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5


def _inputs(B, S, H, Hkv, hd, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, H, hd).astype(np.float32)
    k = rs.randn(B, S, Hkv, hd).astype(np.float32)
    v = rs.randn(B, S, Hkv, hd).astype(np.float32)
    return q, k, v


def _max_diff(a_jax, b_torch):
    return float(np.max(np.abs(np.asarray(a_jax) - b_torch.numpy())))


@pytest.mark.parametrize("S", [100, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_kernel(S, causal):
    q, k, v = _inputs(2, S, 4, 4, 16, seed=S)
    o_ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=causal)
    assert o.shape == (2, S, 4, 16) and o.dtype == torch.float32
    assert _max_diff(o_ref, o) <= TOL


@pytest.mark.parametrize("H,Hkv,window", [(4, 2, None), (4, 4, 32), (4, 1, 24)])
def test_flash_gqa_and_window_match_reference_kernel(H, Hkv, window):
    q, k, v = _inputs(2, 128, H, Hkv, 16, seed=7)
    # 32-wide tiles so the reference walks a pruned band of several k-blocks;
    # the port takes the same hints and ignores them
    kw = dict(causal=True, window=window, block_q=32, block_k=32)
    o_ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    o = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert _max_diff(o_ref, o) <= TOL


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 16)])
def test_lse_matches_reference_kernel(causal, window):
    """The kernel's second output, lse = m + log(l), laid out (B, H, S, 1)."""
    q, k, v = _inputs(2, 64, 4, 2, 16, seed=3)
    scale = 1.0 / math.sqrt(16)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    o_ref, lse_ref = jfa._fwd(tr(q), tr(k), tr(v), causal, scale, None, None, True,
                              window=window)
    o, lse = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal, window=window)
    assert lse.shape == (2, 4, 64, 1) and lse.dtype == torch.float32
    assert _max_diff(lse_ref, lse) <= TOL
    assert _max_diff(jnp.transpose(o_ref, (0, 2, 1, 3)), o) <= TOL


@pytest.mark.parametrize("causal,window,Hkv", [(True, None, 4), (False, None, 2), (True, 8, 1)])
def test_mha_reference_matches_reference(causal, window, Hkv):
    q, k, v = _inputs(2, 40, 4, Hkv, 16, seed=11)
    o_ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    o = tfa.mha_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window)
    assert _max_diff(o_ref, o) <= TOL


def test_sm_scale_is_honoured():
    q, k, v = _inputs(1, 32, 2, 2, 16, seed=5)
    o_ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=0.5)
    o = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            sm_scale=0.5)
    assert _max_diff(o_ref, o) <= TOL


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return "raises"


def test_tiling_rules_agree_with_reference():
    """supports_seq_len gates the model's flash prefill, so both packages
    must answer the same at every length."""
    for s in range(1, 1101):
        assert tfa.supports_seq_len(s) == jfa.supports_seq_len(s), s
        assert _outcome(tfa._auto_block, s, None) == _outcome(jfa._auto_block, s, None), s
        assert tfa._auto_block(s, 128) == jfa._auto_block(s, 128), s


def test_forward_only_until_backward_kernels_land():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 2, 16))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K2/K3"):
        tfa.flash_attention(q, k, v)
    with torch.no_grad():  # no gradient wanted: the forward runs
        assert tfa.flash_attention(q, k, v).shape == (1, 16, 2, 16)


def test_wrapper_rejects_bad_inputs_and_devices():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 16).contiguous(),
                            v[:, :, :1].expand(1, 16, 3, 16).contiguous())
    with pytest.raises(TypeError, match="dtypes differ"):
        tfa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    meta = [t.to("meta") for t in (q, k, v)]
    # neither CPU (plain version) nor CUDA (kernel): no third path
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(*meta)
