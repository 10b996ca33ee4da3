"""The decoder variants that ``module_inject``'s policies produce, in the
port's model (``models/transformer.py``) and decode attention
(``ops/transformer/inference_ops.softmax_context``) against the reference's,
in f32 on the CPU: ALiBi with the embedding LayerNorm (BLOOM), post-LN (OPT
with ``do_layer_norm_before=False``), the parallel residual with and without
the shared LN (GPT-J, GPT-NeoX), partial and interleaved rotary at model
level, and the lm head's bias; and the refusals around them (ALiBi off the
ring and block-sparse). Their training is held in
``tests/test_torch_decoder_training.py``.

Tolerances:
  - ALiBi's slopes: bit for bit (the same float64 formula rounded once to
    f32);
  - the cached read with ALiBi: 1e-6 absolute (the same f32 bias, the
    softmax and PV summed in another order);
  - model logits: 1e-4 absolute in f32, as ``tests/test_torch_transformer.py``
    holds them (summation order through 2 layers and the vocab projection);
    caches 1e-5;
  - greedy streams: equal, or first differing at a reference top-2 margin
    under 1e-4 (a tie; reported, not failed).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.inference.continuous import ContinuousBatchingEngine as JPool
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.transformer import inference_ops as jops
from deepspeed_tpu_torch.inference import ContinuousBatchingEngine as TPool
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

TOL = 1e-4
ATTN_TOL = 1e-6
TIE = 1e-4
V = 128
TINY = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
            dtype="float32")
VARIANTS = {
    # BLOOM: ALiBi and the embedding LayerNorm
    "alibi-embed-norm": dict(pos_embedding="alibi", embed_norm=True),
    # ALiBi at a head count that is not a power of two
    "alibi-6-heads": dict(pos_embedding="alibi", num_heads=6, hidden_size=48),
    # OPT-350m's ordering
    "post-ln": dict(norm_position="post", activation="relu"),
    # GPT-NeoX: the parallel residual, partial half-split rotary, untied head
    "neox": dict(pos_embedding="rope", rope_dim=8, parallel_residual=True,
                 tie_embeddings=False),
    # GPT-J: one shared LN, interleaved partial rotary, a biased head
    "gptj": dict(pos_embedding="rope", rope_dim=8, rope_interleaved=True,
                 parallel_residual=True, shared_ln=True, tie_embeddings=False,
                 lm_head_bias=True),
}


@functools.lru_cache(maxsize=None)
def _perturbed(variant, seed=0):
    """The reference's params of a variant, perturbed with seeded noise (so
    that norms, biases and the head's bias are not at their init values);
    built once a module."""
    jcfg = jtf.TransformerConfig(**dict(TINY, **VARIANTS[variant]))
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _pair(variant, attn_impl="xla"):
    over = dict(TINY, attn_impl=attn_impl, **VARIANTS[variant])
    jcfg, tcfg = jtf.TransformerConfig(**over), ttf.TransformerConfig(**over)
    np_params = _perturbed(variant)
    return jcfg, tcfg, np_params, ttf.params_from_numpy(np_params, tcfg, "cpu")


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def _diff(ref, out):
    return float(np.max(np.abs(np.asarray(ref) - out.detach().numpy())))


# ---------------------------------------------------------------------------
# ALiBi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_heads", [1, 4, 6, 12, 16, 32, 40])
def test_alibi_slopes_are_the_reference_bits(n_heads):
    want = np.asarray(jtf._alibi_slopes(n_heads))
    got = ttf._alibi_slopes(n_heads, torch.device("cpu")).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["aligned", "vector"])
def test_cached_read_with_alibi_matches_reference(mode):
    """``softmax_context`` with ALiBi on the aligned read (scalar pos) and
    the vector-position read (per-row depths: the pool tick and the
    speculative paths), a window on top for the aligned one."""
    rs = np.random.RandomState(0)
    B, S, T, nh, nkv, hd = 2, 3, 16, 6, 2, 8
    q = rs.randn(B, S, nh, hd).astype(np.float32)
    kc = rs.randn(B, T, nkv, hd).astype(np.float32)
    vc = rs.randn(B, T, nkv, hd).astype(np.float32)
    slopes = np.array(jtf._alibi_slopes(nh))
    if mode == "aligned":
        pos, window = 5, 4
        positions = np.broadcast_to(np.arange(5, 5 + S)[None], (B, S)).astype(np.int32)
        jpos, tpos = pos, pos
    else:
        pos, window = np.array([2, 9], np.int32), None
        positions = (pos[:, None] + np.arange(S)[None]).astype(np.int32)
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos).long()
    ref = jops.softmax_context(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jpos,
                               positions=jnp.asarray(positions),
                               alibi_slopes=jnp.asarray(slopes), local_window=window)
    out = tops.softmax_context(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                               tpos, positions=torch.from_numpy(positions).long(),
                               alibi_slopes=torch.from_numpy(slopes), local_window=window)
    assert _diff(ref, out) <= ATTN_TOL


# ---------------------------------------------------------------------------
# the model, uncached and cached
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_matches_reference(variant, attn_impl):
    jcfg, tcfg, np_params, params = _pair(variant, attn_impl)
    toks = _tokens(2, 24)
    ref = jtf.apply(np_params, jcfg, jnp.asarray(toks))
    out = ttf.apply(params, tcfg, torch.from_numpy(toks).long())
    assert _diff(ref, out) <= TOL


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_steps_match_reference(variant, attn_impl):
    """A 20-token prefill, then 3 aligned decode steps and one step at
    vector positions (rows at their own depths); logits and caches."""
    jcfg, tcfg, np_params, params = _pair(variant, attn_impl)
    B, S, T = 2, 20, 32
    toks = _tokens(B, S + 4, seed=1)
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
    pos = np.array([S + 3, S - 2], np.int32)
    step = toks[:, S + 3:S + 4]
    ref, jcache = jtf.forward_with_cache(np_params, jcfg, jnp.asarray(step), jcache,
                                         jnp.asarray(pos))
    out, tcache = ttf.forward_with_cache(params, tcfg, torch.from_numpy(step).long(), tcache,
                                         torch.from_numpy(pos).long())
    assert _diff(ref, out) <= TOL
    for name in ("k", "v"):
        assert _diff(jcache[name], tcache[name]) <= 1e-5


def test_alibi_stays_off_the_flash_kernel(monkeypatch):
    """The reference keeps ALiBi off flash (uncached and on the prefill);
    the port follows, with ``attn_impl="pallas"`` asked for."""
    calls = []
    real = ttf.flash_attention

    def spy(*args, **kw):
        calls.append(kw.get("window"))
        return real(*args, **kw)

    monkeypatch.setattr(ttf, "flash_attention", spy)
    _, tcfg, _, params = _pair("alibi-embed-norm", "pallas")
    toks = torch.from_numpy(_tokens(1, 16)).long()
    ttf.apply(params, tcfg, toks)
    ttf.forward_with_cache(params, tcfg, toks, ttf.init_cache(tcfg, 1, 32), 0)
    assert calls == []
    _, tcfg, _, params = _pair("post-ln", "pallas")  # the other variants do take it
    ttf.apply(params, tcfg, toks)
    assert len(calls) == TINY["num_layers"]


@pytest.mark.parametrize("variant", ["alibi-embed-norm", "post-ln", "gptj"])
def test_the_bridge_round_trips(variant):
    """``params_to_numpy(params_from_numpy(tree))`` is the tree (the
    ``embed_norm`` group and the head's bias included), and
    ``reference_shapes`` is the reference's ``jax.eval_shape(init)``."""
    jcfg, tcfg, np_params, params = _pair(variant)
    back = ttf.params_to_numpy(params, tcfg)
    flat = dict(jax.tree_util.tree_leaves_with_path(np_params))
    assert {jax.tree_util.keystr(k) for k in flat} == {
        jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(back)}
    for k, v in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(v, flat[k])
    shapes = jax.eval_shape(lambda r: jtf.init(r, jcfg), jax.random.PRNGKey(0))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert ttf.reference_shapes(tcfg) == want
    assert tcfg.num_params() == jcfg.num_params()


# ---------------------------------------------------------------------------
# greedy streams through the engine, against the reference
# ---------------------------------------------------------------------------

NEW = 8


def _assert_streams_agree(jcfg, params, want, got, prompt_lens):
    want, got = [np.asarray(w) for w in want], [np.asarray(g) for g in got]
    for b, (w, g, n) in enumerate(zip(want, got, prompt_lens)):
        assert w.shape == g.shape
        diff = np.nonzero(w != g)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        assert j >= n
        logits = np.asarray(jtf.apply(params, jcfg, jnp.asarray(w[None, :j])))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"row {b} differs at position {j} (reference margin {margin})"
        warnings.warn(f"row {b}: a tie at position {j} (reference margin {margin:.3g})")


def _engines(variant, **config):
    over = dict(TINY, **VARIANTS[variant])
    config = dict(config, dtype="float32")
    params = _perturbed(variant)
    comm.destroy()
    ref = deepspeed_tpu.init_inference(jtf.TransformerModel(jtf.TransformerConfig(**over)),
                                       params=params, config=config)
    port = deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**over)), params=params, config=config,
        device="cpu")
    return ref, port, jtf.TransformerConfig(**over), params


PATHS = {"aligned": {}, "per-token": {"fused_generate": False, "kv_read_floor": 8},
         "chunked": {"prefill_chunk_size": 4}, "int8-kv": {"kv_cache_dtype": "int8"}}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_streams_match_reference(variant, path):
    ref, port, jcfg, params = _engines(variant, **PATHS[path])
    toks = _tokens(2, 10, seed=2)
    want = ref.generate(toks, max_new_tokens=NEW)
    got = port.generate(toks, max_new_tokens=NEW)
    _assert_streams_agree(jcfg, params, want, got, [10, 10])


@pytest.mark.parametrize("variant", ["alibi-embed-norm", "gptj"])
def test_speculative_streams_match_plain_greedy(variant):
    """Self-speculation (the target as its own draft) writes rows at their
    own depths (the vector-position read); greedy, it gives plain greedy's
    stream in both packages."""
    ref, port, jcfg, params = _engines(variant)
    toks = _tokens(2, 10, seed=3)
    plain = ref.generate(toks, max_new_tokens=NEW)
    got = port.generate(toks, max_new_tokens=NEW, draft=port, num_draft_tokens=3)
    _assert_streams_agree(jcfg, params, plain, got, [10, 10])


@pytest.mark.parametrize("variant", ["alibi-embed-norm", "post-ln", "gptj"])
def test_pool_tick_streams_match_reference(variant):
    over = dict(TINY, **VARIANTS[variant])
    params = _perturbed(variant)
    config = {"dtype": "float32", "kv_read_floor": 16}
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, V, (n,)).astype(np.int32) for n in (9, 5, 12)]
    comm.destroy()
    pools = (JPool(jtf.TransformerModel(jtf.TransformerConfig(**over)), params=params,
                   config=config, max_slots=2, cache_len=32),
             TPool(ttf.TransformerModel(ttf.TransformerConfig(**over)), params=params,
                   config=config, max_slots=2, cache_len=32, device="cpu"))
    results = []
    for pool in pools:
        rids = [pool.submit(p, max_new_tokens=NEW) for p in prompts]
        done = {}
        while pool.has_work():
            pool.step()
            done.update(pool.finished())
        done.update(pool.finished())
        results.append([done[r] for r in rids])
    _assert_streams_agree(jtf.TransformerConfig(**over), params, results[0], results[1],
                          [len(p) for p in prompts])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_the_ring_refuses_alibi():
    """The engine switches the ring on only for rope or no positions; a
    config that forces it with ALiBi is refused at the cached read, as the
    reference asserts."""
    ref, port, _, _ = _engines("alibi-embed-norm", rolling_kv_cache=True)
    assert not port.cfg.rolling_kv_cache and not ref.cfg.rolling_kv_cache
    cfg = ttf.TransformerConfig(**dict(TINY, pos_embedding="alibi", rolling_kv_cache=True,
                                       local_attn_windows=(8, 8)))
    params = ttf.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="ALiBi"):
        ttf.forward_with_cache(params, cfg, torch.zeros((1, 1), dtype=torch.long),
                               ttf.init_cache(cfg, 1, 8), 0)


def test_block_sparse_refuses_alibi():
    cfg = ttf.TransformerConfig(**dict(TINY, pos_embedding="alibi", attn_impl="block_sparse"))
    with pytest.raises(NotImplementedError, match="block-sparse attention with ALiBi"):
        ttf.check_supported(cfg)


@pytest.mark.parametrize("over", [dict(causal=False), dict(type_vocab_size=2),
                                  dict(activation="quick_gelu")],
                         ids=["bidirectional", "token-types", "quick-gelu"])
def test_the_encoders_raise_naming_item_10(over):
    cfg = ttf.TransformerConfig(**dict(TINY, **over))
    with pytest.raises(NotImplementedError, match="item 10"):
        ttf.check_supported(cfg)
