"""The port's model (``deepspeed_tpu_torch.models.transformer``) against the
reference's on bridged weights, in f32 on the CPU. Mirrors
``tests/unit/models/test_transformer.py`` for the serving slice.

The reference's params come from its own ``init``; every leaf is perturbed
with seeded noise (so that biases and norm scales are not the trivial 0/1
and a mistake in them shows), then bridged with ``params_from_numpy``.

Tolerance: 1e-4 absolute on logits. Both sides are f32; matmuls and the
softmax sum in different orders through 2 layers and a 128-way vocab
projection, which keeps the difference near 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf

TOL = 1e-4
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
            dtype="float32")
VARIANTS = {
    "gpt2": {},
    "gqa-untied-bias-head": dict(num_kv_heads=2, tie_embeddings=False, lm_head_bias=True),
    "llama-like-no-rope": dict(norm_type="rmsnorm", activation="silu_glu", use_bias=False,
                               tie_embeddings=False, ffn_hidden_size=96),
    "relu": dict(activation="relu"),
}


def _perturbed_params(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _pair(variant="gpt2", attn_impl="xla"):
    over = dict(TINY, attn_impl=attn_impl, **VARIANTS[variant])
    jcfg, tcfg = jtf.TransformerConfig(**over), ttf.TransformerConfig(**over)
    np_params = _perturbed_params(jcfg)
    return jcfg, tcfg, np_params, ttf.params_from_numpy(np_params, tcfg, "cpu")


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(np.int32)


def _diff(ref, out):
    return float(np.max(np.abs(np.asarray(ref) - out.detach().numpy())))


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_matches_reference(variant, attn_impl):
    jcfg, tcfg, np_params, params = _pair(variant, attn_impl)
    toks = _tokens(2, 24)
    ref = jtf.apply(np_params, jcfg, jnp.asarray(toks))
    out = ttf.apply(params, tcfg, torch.from_numpy(toks).long())
    assert out.shape == (2, 24, 128)
    assert _diff(ref, out) <= TOL


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", ["gpt2", "gqa-untied-bias-head"])
def test_prefill_and_decode_step_match_reference(variant, attn_impl):
    """forward_with_cache: a prefill at pos 0 (the flash prefill gate for
    "pallas"), then one decode step, full and tight reads; logits and the
    written caches agree."""
    jcfg, tcfg, np_params, params = _pair(variant, attn_impl)
    B, S, T = 2, 20, 48
    toks = _tokens(B, S, seed=1)
    jcache = jtf.init_cache(jcfg, B, T)
    tcache = ttf.init_cache(tcfg, B, T)
    ref, jcache = jtf.forward_with_cache(np_params, jcfg, jnp.asarray(toks), jcache, 0)
    out, tcache = ttf.forward_with_cache(params, tcfg, torch.from_numpy(toks).long(), tcache, 0)
    assert _diff(ref, out) <= TOL
    for name in ("k", "v"):
        assert _diff(jcache[name], tcache[name]) <= TOL
    nxt = np.asarray(jnp.argmax(ref[:, -1], axis=-1)).astype(np.int32)[:, None]
    for read_len in (None, 32):
        ref_step, _ = jtf.forward_with_cache(np_params, jcfg, jnp.asarray(nxt), jcache,
                                             jnp.int32(S), read_len=read_len)
        out_step, _ = ttf.forward_with_cache(params, tcfg, torch.from_numpy(nxt).long(),
                                             {k: v.clone() for k, v in tcache.items()}, S,
                                             read_len=read_len)
        assert out_step.shape == (B, 1, 128)
        assert _diff(ref_step, out_step) <= TOL


def test_last_only_head_keeps_the_last_row():
    _, tcfg, _, params = _pair()
    toks = torch.from_numpy(_tokens(2, 12, seed=2)).long()
    full, _ = ttf.forward_with_cache(params, tcfg, toks, ttf.init_cache(tcfg, 2, 32), 0)
    last, _ = ttf.forward_with_cache(params, tcfg, toks, ttf.init_cache(tcfg, 2, 32), 0,
                                     last_only=True)
    assert last.shape == (2, 1, 128)
    assert torch.allclose(full[:, -1:], last, atol=1e-6, rtol=0)


def test_vector_pos_segment_matches_reference():
    """Per-row depths: learned positions per row (the scalar path uses row
    0's positions, which the prefill/decode tests above pin)."""
    jcfg, tcfg, np_params, params = _pair()
    B, T = 2, 32
    toks = _tokens(B, 6, seed=3)
    jcache = jtf.init_cache(jcfg, B, T)
    tcache = ttf.init_cache(tcfg, B, T)
    _, jcache = jtf.forward_with_cache(np_params, jcfg, jnp.asarray(toks), jcache, 0)
    _, tcache = ttf.forward_with_cache(params, tcfg, torch.from_numpy(toks).long(), tcache, 0)
    seg = _tokens(B, 2, seed=4)
    pos = np.array([4, 6], np.int32)
    ref, _ = jtf.forward_with_cache(np_params, jcfg, jnp.asarray(seg), jcache, jnp.asarray(pos))
    out, _ = ttf.forward_with_cache(params, tcfg, torch.from_numpy(seg).long(), tcache,
                                    torch.from_numpy(pos).long())
    assert _diff(ref, out) <= TOL


def test_norm_computes_in_f32_and_casts_back():
    """bf16 in, bf16 out, f32 statistics with the population variance: the
    two packages agree to one bf16 rounding."""
    rs = np.random.RandomState(5)
    x = (rs.randn(3, 64) * 4 + 1).astype(np.float32)
    scale, bias = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    for norm_type in ("layernorm", "rmsnorm"):
        jcfg = jtf.TransformerConfig(**dict(TINY, norm_type=norm_type))
        tcfg = ttf.TransformerConfig(**dict(TINY, norm_type=norm_type))
        ref = jtf._norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias), jcfg)
        out = ttf._norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                        torch.from_numpy(bias), tcfg)
        assert out.dtype == torch.bfloat16
        ref32 = np.asarray(ref.astype(jnp.float32))
        assert np.max(np.abs(ref32 - out.float().numpy()) / (np.abs(ref32) + 1e-3)) <= 2 ** -7


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = jax.nn.gelu(jnp.asarray(x))
    out = ttf._dense_act(ttf.TransformerConfig(**TINY))(torch.from_numpy(x))
    assert _diff(ref, out) <= 1e-6


def test_init_shapes_and_param_count():
    cfg = ttf.get_config("gpt2-125m", num_layers=2)
    params = ttf.init(torch.Generator().manual_seed(0), cfg)
    n = sum(t.numel() for t in jax.tree.leaves(params, is_leaf=torch.is_tensor))
    assert n == cfg.num_params() == jtf.get_config("gpt2-125m", num_layers=2).num_params()
    bridged = ttf.params_from_numpy(_perturbed_params(jtf.TransformerConfig(**TINY)),
                                    ttf.TransformerConfig(**TINY), "cpu")
    own = ttf.init(torch.Generator().manual_seed(0), ttf.TransformerConfig(**TINY))
    shapes = lambda p: jax.tree.map(lambda t: tuple(t.shape), p, is_leaf=torch.is_tensor)  # noqa: E731
    assert shapes(bridged) == shapes(own)


def test_presets_match_reference():
    assert ttf.PRESETS == jtf.PRESETS
    for name in ttf.PRESETS:
        a, b = ttf.get_config(name), jtf.get_config(name)
        assert a.num_params() == b.num_params()
        assert a.flops_per_token(1024) == b.flops_per_token(1024)


def test_kv_read_bytes_match_reference():
    for dtype in ("float32", "bfloat16"):
        for over in ({}, {"num_kv_heads": 2}):
            a = ttf.TransformerConfig(**dict(TINY, dtype=dtype, **over))
            b = jtf.TransformerConfig(**dict(TINY, dtype=dtype, **over))
            for r in (1, 16, 48):
                assert ttf.kv_read_bytes_per_row(a, r) == jtf.kv_read_bytes_per_row(b, r)


@pytest.mark.parametrize("over", [
    dict(pos_embedding="rope"), dict(pos_embedding="alibi"), dict(moe_num_experts=4),
    dict(local_attn_windows=(8, 8)), dict(rolling_kv_cache=True), dict(kv_cache_dtype="int8"),
    dict(norm_position="post"), dict(parallel_residual=True), dict(attn_impl="block_sparse"),
])
def test_features_outside_the_slice_raise(over):
    cfg = ttf.TransformerConfig(**dict(TINY, **over))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttf.init(torch.Generator().manual_seed(0), cfg)
