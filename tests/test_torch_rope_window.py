"""Rotary embeddings and sliding windows in the port
(``ops/transformer/inference_ops.apply_rotary_pos_emb``/``rope_table`` and
``models/transformer``) against the reference, on the CPU.

Tolerances:
  - the rotation is bit for bit the reference's, in f32 and bf16, given the
    same (cos, sin) table: the port rotates with the reference's arithmetic
    (f32 products, bf16 promoted, one cast at the end);
  - the table itself (``rope_table``) is the reference's formula in f32, but
    XLA's and ATen's ``exp``/``sin``/``cos`` each round the last bit their own
    way (one f32 ulp apart on ~5-10 % of arguments), so the frequencies are
    held within 1 ulp and the whole op within 1e-6 absolute in f32 (inputs
    N(0, 1), angles below 64 rad: a one-ulp frequency moves an angle by at
    most 64 * 2**-23 = 7.6e-6 rad, a few ulps of the output) and within one
    bf16 ulp of the output in bf16;
  - model logits: 1e-4 absolute in f32, as ``tests/test_torch_transformer.py``
    holds them (summation order through 2 layers and the vocab projection).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.transformer import inference_ops as jops
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

TOL = 1e-4
ROPE_F32_TOL = 1e-6
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            max_seq_len=64, dtype="float32", norm_type="rmsnorm", activation="silu_glu",
            use_bias=False, tie_embeddings=False, ffn_hidden_size=96)
VARIANTS = {
    "llama-rope": dict(pos_embedding="rope"),
    "mistral-window8": dict(pos_embedding="rope", local_attn_windows=(8, 8)),
    "rope-partial-interleaved": dict(pos_embedding="rope", rope_dim=8, rope_interleaved=True,
                                     rope_theta=500.0),
    "rope-windows-8-0": dict(pos_embedding="rope", local_attn_windows=(8, 0)),
}


def _positions(B, S, vector):
    if vector:  # rows at their own depths
        return (np.arange(S)[None] + np.array([[0], [37]])[:B]).astype(np.int32)
    return np.broadcast_to(np.arange(5, 5 + S)[None], (B, S)).astype(np.int32)


def _x(B, S, H, hd, seed=0):
    return np.random.RandomState(seed).randn(B, S, H, hd).astype(np.float32)


def _as(x, dtype):
    return (jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32))


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector", [False, True], ids=["aligned", "vector"])
@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "half-split"])
@pytest.mark.parametrize("rot_dim", [None, 8], ids=["whole", "partial"])
def test_rotation_is_bitwise_given_the_table(rot_dim, interleaved, vector, dtype):
    B, S, H, hd = 2, 24, 4, 16
    x = _x(B, S, H, hd)
    pos = _positions(B, S, vector)
    jx, tx = _as(x, dtype)
    ref = jops.apply_rotary_pos_emb(jx, jnp.asarray(pos), 10000.0, rot_dim, interleaved)
    half = (rot_dim or hd) // 2
    freqs = jnp.exp(-math.log(10000.0) * jnp.arange(0, half, dtype=jnp.float32) / half)
    angles = jnp.asarray(pos)[:, :, None].astype(jnp.float32) * freqs[None, None, :]
    table = (torch.from_numpy(np.array(jnp.cos(angles)))[:, :, None, :],
             torch.from_numpy(np.array(jnp.sin(angles)))[:, :, None, :])
    out = tops.apply_rotary_pos_emb(tx, torch.from_numpy(pos).long(), 10000.0, rot_dim,
                                    interleaved, table=table)
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(out), _f32(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector", [False, True], ids=["aligned", "vector"])
@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "half-split"])
@pytest.mark.parametrize("rot_dim", [None, 8], ids=["whole", "partial"])
def test_rotary_op_matches_reference(rot_dim, interleaved, vector, dtype):
    B, S, H, hd = 2, 24, 4, 16
    x = _x(B, S, H, hd, seed=1)
    pos = _positions(B, S, vector)
    jx, tx = _as(x, dtype)
    ref = _f32(jops.apply_rotary_pos_emb(jx, jnp.asarray(pos), 10000.0, rot_dim, interleaved))
    out = _f32(tops.apply_rotary_pos_emb(tx, torch.from_numpy(pos).long(), 10000.0, rot_dim,
                                         interleaved))
    if dtype == "float32":
        assert np.max(np.abs(out - ref)) <= ROPE_F32_TOL
    else:  # one bf16 ulp of the output: 2**-7 relative to its binade
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
        assert np.all(np.abs(out - ref) <= ulp)


def test_the_public_default_pairs_even_and_odd_dims():
    """The op's default stays ``interleaved=True``, the reference's contract;
    the model passes ``cfg.rope_interleaved`` itself."""
    x = _x(1, 6, 2, 8, seed=2)
    pos = _positions(1, 6, False)
    a = tops.apply_rotary_pos_emb(torch.from_numpy(x), torch.from_numpy(pos).long())
    b = tops.apply_rotary_pos_emb(torch.from_numpy(x), torch.from_numpy(pos).long(),
                                  interleaved=True)
    c = tops.apply_rotary_pos_emb(torch.from_numpy(x), torch.from_numpy(pos).long(),
                                  interleaved=False)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_rope_table_follows_the_reference_formula():
    """Frequencies ``exp(-log(theta) * arange(half) / half)`` (not HF's
    ``1 / theta ** (arange(0, d, 2) / d)``): the exp's argument bit for bit,
    the frequencies within one f32 ulp, and the table's cos/sin at positions
    below 64 within the angle error that ulp makes (64 * 2**-23) plus one
    ulp of their own."""
    for theta, half in ((10000.0, 64), (500.0, 4), (1e6, 32)):
        ar = jnp.arange(0, half, dtype=jnp.float32)
        arg = np.asarray(-math.log(theta) * ar / half)
        want = np.asarray(jnp.exp(arg))
        targ = tops.div_exact(-math.log(theta) * torch.arange(half, dtype=torch.float32),
                              float(half)).numpy()
        np.testing.assert_array_equal(targ, arg)
        tfreqs = torch.exp(torch.from_numpy(arg)).numpy()
        assert np.all(np.abs(tfreqs - want) <= np.spacing(want))
        pos = np.arange(64, dtype=np.int32)[None]
        angles = jnp.asarray(pos)[:, :, None].astype(jnp.float32) * jnp.asarray(want)[None, None]
        cos, sin = tops.rope_table(torch.from_numpy(pos).long(), theta, 2 * half)
        bound = 64 * 2.0 ** -23 + 2.0 ** -24
        assert np.max(np.abs(cos[:, :, 0].numpy() - np.asarray(jnp.cos(angles)))) <= bound
        assert np.max(np.abs(sin[:, :, 0].numpy() - np.asarray(jnp.sin(angles)))) <= bound


@functools.lru_cache(maxsize=None)
def _perturbed(variant, seed=0):
    """The reference's params of a variant (attn_impl does not change them),
    perturbed with seeded noise; built once a module."""
    jcfg = jtf.TransformerConfig(**dict(TINY, **VARIANTS[variant]))
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _pair(variant, attn_impl):
    over = dict(TINY, attn_impl=attn_impl, **VARIANTS[variant])
    jcfg, tcfg = jtf.TransformerConfig(**over), ttf.TransformerConfig(**over)
    np_params = _perturbed(variant)
    return jcfg, tcfg, np_params, ttf.params_from_numpy(np_params, tcfg, "cpu")


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(np.int32)


def _diff(ref, out):
    return float(np.max(np.abs(np.asarray(ref) - out.detach().numpy())))


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_matches_reference(variant, attn_impl):
    """The uncached forward: rope at every layer, a uniform window on the
    flash band (pallas) or the masked einsum (xla), per-layer windows on the
    masked path in both."""
    jcfg, tcfg, np_params, params = _pair(variant, attn_impl)
    toks = _tokens(2, 24)
    ref = jtf.apply(np_params, jcfg, jnp.asarray(toks))
    out = ttf.apply(params, tcfg, torch.from_numpy(toks).long())
    assert _diff(ref, out) <= TOL


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_steps_match_reference(variant, attn_impl):
    """forward_with_cache: a 20-token prefill (uniform windows on the flash
    band for pallas), then 3 decode steps, each attending the window;
    logits and the written caches agree."""
    jcfg, tcfg, np_params, params = _pair(variant, attn_impl)
    B, S, T = 2, 20, 32
    toks = _tokens(B, S + 3, seed=1)
    jcache, tcache = jtf.init_cache(jcfg, B, T), ttf.init_cache(tcfg, B, T)
    ref, jcache = jtf.forward_with_cache(np_params, jcfg, jnp.asarray(toks[:, :S]), jcache, 0)
    out, tcache = ttf.forward_with_cache(params, tcfg, torch.from_numpy(toks[:, :S]).long(),
                                         tcache, 0)
    assert _diff(ref, out) <= TOL
    for j in range(S, S + 3):
        ref, jcache = jtf.forward_with_cache(np_params, jcfg, jnp.asarray(toks[:, j:j + 1]),
                                             jcache, j)
        out, tcache = ttf.forward_with_cache(params, tcfg,
                                             torch.from_numpy(toks[:, j:j + 1]).long(), tcache, j)
        assert _diff(ref, out) <= TOL
    for name in ("k", "v"):
        assert _diff(jcache[name], tcache[name]) <= 1e-5


def test_varying_windows_stay_off_the_flash_kernel(monkeypatch):
    """Per-layer windows ride the reference's layer scan as traced scalars,
    so its prefill never reaches the flash kernel; the port follows that
    path choice, while a uniform window takes the band."""
    calls = []
    real = ttf.flash_attention

    def spy(*args, **kw):
        calls.append(kw.get("window"))
        return real(*args, **kw)

    monkeypatch.setattr(ttf, "flash_attention", spy)
    toks = torch.from_numpy(_tokens(1, 16)).long()
    for variant, want in (("rope-windows-8-0", []), ("mistral-window8", [8, 8])):
        _, tcfg, _, params = _pair(variant, "pallas")
        calls.clear()
        ttf.forward_with_cache(params, tcfg, toks, ttf.init_cache(tcfg, 1, 32), 0)
        assert calls == want
        calls.clear()
        ttf.apply(params, tcfg, toks)
        assert calls == want


@pytest.mark.parametrize("windows", [None, (8, 0), (0, 0)], ids=["none", "varying", "zeros"])
def test_a_ring_without_one_window_is_refused(windows):
    cfg = ttf.TransformerConfig(**dict(TINY, pos_embedding="rope", rolling_kv_cache=True,
                                       local_attn_windows=windows))
    with pytest.raises(ValueError, match="sliding window"):
        ttf.check_supported(cfg)
