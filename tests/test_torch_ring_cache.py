"""The rolling (ring) KV cache of uniform-window models (Mistral) and the
window masks of the decode attention, in the port against the reference, on
the CPU (mirroring ``tests/unit/inference/test_rolling_cache.py``).

Tolerances:
  - the ring write is bit for bit the reference's scatter, on dense and int8
    caches, for segments shorter than, as long as and longer than the ring;
  - ``softmax_context`` with ``local_window`` and ``ring``: 1e-6 absolute in
    f32 (the same masked softmax, summation order only);
  - greedy streams of every path that runs on a ring-enabled engine equal
    the reference engine's on the same bridged weights, or first differ at a
    step whose reference top-2 logit margin is under 1e-4 (a tie that f32
    summation order may break; reported, not failed; the rule of
    ``tests/test_torch_inference_engine.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.inference.continuous import ContinuousBatchingEngine as JEngine
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.transformer import inference_ops as jops
from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

TIE = 1e-4
ATTN_TOL = 1e-6
W = 16
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           max_seq_len=128, dtype="float32", pos_embedding="rope", norm_type="rmsnorm",
           activation="silu_glu", use_bias=False, tie_embeddings=False, ffn_hidden_size=96,
           attn_impl="pallas", local_attn_windows=(W, W))


@pytest.fixture(scope="module")
def setup():
    comm.destroy()
    jcfg = jtf.TransformerConfig(**CFG)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)
    yield {"jcfg": jcfg, "params": params}
    comm.destroy()


def _ref(setup, **config):
    comm.destroy()
    return deepspeed_tpu.init_inference(jtf.TransformerModel(setup["jcfg"]),
                                        params=setup["params"],
                                        config=dict(config, dtype="float32"))


def _port(setup, **config):
    return deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**CFG)), params=setup["params"],
        config=dict(config, dtype="float32"), device="cpu")


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(np.int32)


def _assert_agree(setup, want, got, prompt_len):
    """Row by row: equal, or first differing at a generated step where the
    reference's own top-2 margin is < TIE (rows decode independently)."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    for b in range(want.shape[0]):
        diff = np.nonzero(want[b] != got[b])[0]
        if not diff.size:
            continue
        j = int(diff[0])
        assert j >= prompt_len, f"row {b}: the prompt region differs"
        logits = np.asarray(jtf.apply(setup["params"], setup["jcfg"],
                                      jnp.asarray(want[b:b + 1, :j])))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"row {b} differs at position {j} (reference margin {margin})"
        warnings.warn(f"row {b}: a tie at position {j} (reference margin {margin:.3g})")


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

RING_T = 8
SEGMENTS = {"s5-short": (0, 5), "s8-whole": (0, 8), "s13-longer": (0, 13),
            "pos6-s5-wraps": (6, 5), "pos21-decode": (21, 1), "pos3-s13-longer": (3, 13)}


def _ring_inputs(pos, S, int8, seed=0):
    rs = np.random.RandomState(seed)
    B, H, hd = 2, 2, 4
    shape = (B, RING_T, H, hd)
    if int8:
        def component():
            # scales of real keys: |values| up to 2, as the dense case's
            return {"q8": rs.randint(-127, 128, shape).astype(np.int8),
                    "s": (rs.rand(*shape[:-1], 1) / 64).astype(np.float32)}

        caches = (component(), component())
    else:
        caches = (rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32))
    new = (rs.randn(B, S, H, hd).astype(np.float32), rs.randn(B, S, H, hd).astype(np.float32))
    positions = np.broadcast_to(np.arange(pos, pos + S)[None], (B, S)).astype(np.int32)
    return caches, new, positions


def _to_torch(c):
    return ({k: torch.from_numpy(v.copy()) for k, v in c.items()} if isinstance(c, dict)
            else torch.from_numpy(c.copy()))


def _to_jax(c):
    return {k: jnp.asarray(v) for k, v in c.items()} if isinstance(c, dict) else jnp.asarray(c)


def _np(c):
    return ({k: np.asarray(v) for k, v in c.items()} if isinstance(c, dict) else np.asarray(c))


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("segment", sorted(SEGMENTS))
def test_ring_write_is_bitwise_the_reference(segment, int8):
    pos, S = SEGMENTS[segment]
    (kc, vc), (kn, vn), positions = _ring_inputs(pos, S, int8)
    jk, jv = jops.update_kv_cache(_to_jax(kc), _to_jax(vc), jnp.asarray(kn), jnp.asarray(vn),
                                  pos, jnp.asarray(positions), ring=True)
    tk, tv = tops.update_kv_cache(_to_torch(kc), _to_torch(vc), torch.from_numpy(kn),
                                  torch.from_numpy(vn), pos, torch.from_numpy(positions),
                                  ring=True)
    for want, got in ((_np(jk), tk), (_np(jv), tv)):
        if int8:
            for name in ("q8", "s"):
                np.testing.assert_array_equal(got[name].numpy(), want[name])
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("segment", sorted(k for k, (_, S) in SEGMENTS.items() if S <= RING_T))
def test_softmax_context_reads_the_ring_as_the_reference(segment, int8):
    """After a ring write, the segment's queries attend the derived
    absolute positions with a window of 5: unwritten slots and positions
    outside the window masked. (A segment longer than the ring takes the
    flash prefill instead.)"""
    pos, S = SEGMENTS[segment]
    (kc, vc), (kn, vn), positions = _ring_inputs(pos, S, int8, seed=1)
    q = np.random.RandomState(2).randn(2, S, 4, 4).astype(np.float32)
    jk, jv = jops.update_kv_cache(_to_jax(kc), _to_jax(vc), jnp.asarray(kn), jnp.asarray(vn),
                                  pos, jnp.asarray(positions), ring=True)
    ref = jops.softmax_context(jnp.asarray(q), jk, jv, pos, positions=jnp.asarray(positions),
                               local_window=5, ring=True)
    tk, tv = tops.update_kv_cache(_to_torch(kc), _to_torch(vc), torch.from_numpy(kn),
                                  torch.from_numpy(vn), pos, torch.from_numpy(positions),
                                  ring=True)
    out = tops.softmax_context(torch.from_numpy(q), tk, tv, pos,
                               positions=torch.from_numpy(positions), local_window=5, ring=True)
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= ATTN_TOL


@pytest.mark.parametrize("window", [0, 3, 7])
@pytest.mark.parametrize("vector", [False, True], ids=["aligned", "vector"])
def test_softmax_context_local_window_matches_reference(vector, window):
    rs = np.random.RandomState(3)
    B, S, T = 2, 3, 12
    kc, vc = rs.randn(B, T, 2, 4).astype(np.float32), rs.randn(B, T, 2, 4).astype(np.float32)
    q = rs.randn(B, S, 4, 4).astype(np.float32)
    if vector:
        pos = np.array([4, 8], np.int32)
        positions = (pos[:, None] + np.arange(S)[None]).astype(np.int32)
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos).long()
    else:
        pos = 6
        positions = np.broadcast_to(np.arange(pos, pos + S)[None], (B, S)).astype(np.int32)
        jpos, tpos = pos, pos
    ref = jops.softmax_context(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jpos,
                               positions=jnp.asarray(positions), local_window=window)
    out = tops.softmax_context(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                               tpos, positions=torch.from_numpy(positions).long(),
                               local_window=window)
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= ATTN_TOL


@pytest.mark.parametrize("case", ["vector-pos", "no-window", "alibi", "read-len"])
def test_ring_misuse_raises_value_error(case):
    """The reference's asserts, as ValueErrors."""
    (kc, vc), (kn, vn), positions = _ring_inputs(0, 3, False)
    q = torch.zeros(2, 3, 4, 4)
    pos, kw = 0, dict(local_window=4, ring=True)
    if case == "vector-pos":
        pos = torch.zeros(2, dtype=torch.long)
        with pytest.raises(ValueError, match="aligned"):
            tops.update_kv_cache(_to_torch(kc), _to_torch(vc), torch.from_numpy(kn),
                                 torch.from_numpy(vn), pos, torch.from_numpy(positions),
                                 ring=True)
    elif case == "no-window":
        kw.pop("local_window")
    elif case == "alibi":
        kw["alibi_slopes"] = torch.ones(4)
    else:
        kw["read_len"] = 4
    with pytest.raises(ValueError):
        tops.softmax_context(q, _to_torch(kc), _to_torch(vc), pos,
                             positions=torch.from_numpy(positions), **kw)


# ---------------------------------------------------------------------------
# the engine: the ring switch and every path on a ring-enabled engine
# ---------------------------------------------------------------------------

def test_the_ring_switches_on_as_the_reference(setup):
    port, ref = _port(setup), _ref(setup)
    assert port.cfg.rolling_kv_cache and ref.cfg.rolling_kv_cache
    for args in ((200, 8), (200, 1), (12, 8), (200, 64), (200, 100)):
        assert port._ring_cache_len(*args) == ref._ring_cache_len(*args)
    assert port._ring_cache_len(200, 8) == W
    assert not port._ring_off_cfg.rolling_kv_cache and port.cfg.rolling_kv_cache
    for config in ({"rolling_kv_cache": False}, {"attn_impl": "xla"},
                   {"speculative": {"enabled": True, "mode": "ngram", "pool": True}}):
        assert not _port(setup, **config).cfg.rolling_kv_cache
    plain = deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**dict(CFG, local_attn_windows=None))),
        config={"dtype": "float32"}, device="cpu")
    assert not plain.cfg.rolling_kv_cache


@pytest.mark.parametrize("prompt_len,new", [(8, 40), (64, 24)],
                         ids=["wraps-in-decode", "prompt-longer-than-window"])
def test_fused_generate_on_the_ring_matches_reference(setup, prompt_len, new):
    toks = _tokens(2, prompt_len)
    want = np.asarray(_ref(setup).generate(jnp.asarray(toks), max_new_tokens=new))
    port = _port(setup)
    got = port.generate(toks, max_new_tokens=new)
    _assert_agree(setup, want, got, prompt_len)
    full = _port(setup, rolling_kv_cache=False).generate(toks, max_new_tokens=new)
    _assert_agree(setup, want, full, prompt_len)


def test_int8_kv_on_the_ring_matches_reference(setup):
    toks = _tokens(2, 8, seed=2)
    ref, port = _ref(setup, kv_cache_dtype="int8"), _port(setup, kv_cache_dtype="int8")
    assert port.cfg.rolling_kv_cache and port.cfg.kv_cache_dtype == "int8"
    want = np.asarray(ref.generate(jnp.asarray(toks), max_new_tokens=30))
    _assert_agree(setup, want, port.generate(toks, max_new_tokens=30), 8)


@pytest.mark.parametrize("chunk", [None, 8], ids=["ragged", "chunked"])
def test_ragged_and_chunked_run_ring_off(setup, chunk):
    """Rows at their own depths: both engines run these paths on full-length
    caches (``_ring_off_cfg``), with the window still masked."""
    toks = _tokens(2, 22, seed=3)
    mask = np.ones((2, 22), np.int32)
    mask[1, :5] = 0
    over = {} if chunk is None else {"prefill_chunk_size": chunk}
    want = np.asarray(_ref(setup, **over).generate(jnp.asarray(toks), max_new_tokens=20,
                                                   attention_mask=mask))
    got = np.asarray(_port(setup, **over).generate(toks, max_new_tokens=20, attention_mask=mask))
    np.testing.assert_array_equal(got[:, :22], want[:, :22])
    for b, n in ((0, 22), (1, 17)):  # each row's generated tokens, held to its own prompt
        row_w, row_g = want[b, 22:], got[b, 22:]
        if not np.array_equal(row_w, row_g):
            j = int(np.nonzero(row_w != row_g)[0][0])
            prompt = toks[b, 22 - n:]
            logits = np.asarray(jtf.apply(setup["params"], setup["jcfg"], jnp.asarray(
                np.concatenate([prompt, row_w[:j]])[None])))[0, -1]
            top2 = np.sort(logits)[-2:]
            assert float(top2[1] - top2[0]) < TIE, f"row {b} differs at step {j}"


SUBS = [(0, 5, 20), (0, 9, 24), (1, 20, 10)]  # every stream passes the window


def _serve(cb, submissions, max_ticks=400):
    results, rid_of, pending, tick = {}, {}, list(submissions), 0
    while pending or cb.has_work():
        assert tick < max_ticks, "scheduler did not drain"
        for item in [s for s in pending if s[0] <= tick]:
            rid_of[id(item)] = cb.submit(item[1], max_new_tokens=item[2])
        pending = [s for s in pending if s[0] > tick]
        cb.step()
        results.update(cb.finished())
        tick += 1
    return [np.asarray(results[rid_of[id(s)]]) for s in submissions]


@pytest.mark.parametrize("spec", [None, "ngram"], ids=["pool-tick", "ngram-spec-pool"])
def test_batching_engine_on_a_window_model_matches_reference(setup, spec):
    """The slot pools write rows at their own depths, so both packages'
    pools run ring-off caches under the window mask; the ngram speculative
    pool (which keeps the ring off altogether) likewise."""
    config = {"dtype": "float32", "kv_read_floor": 16}
    if spec:
        config["speculative"] = {"enabled": True, "pool": True, "mode": spec,
                                 "num_draft_tokens": 2}
    rs = np.random.RandomState(4)
    subs = [(t, rs.randint(0, 128, (n,)).astype(np.int32), m) for t, n, m in SUBS]
    comm.destroy()
    ref = JEngine(jtf.TransformerModel(setup["jcfg"]), params=setup["params"], config=config,
                  max_slots=3, cache_len=64, donate_cache=False)
    port = ContinuousBatchingEngine(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                    params=setup["params"], config=config, max_slots=3,
                                    cache_len=64, device="cpu")
    assert not port.cfg.rolling_kv_cache
    want, got = _serve(ref, subs), _serve(port, subs)
    for (_, prompt, _), w, g in zip(subs, want, got):
        _assert_agree(setup, w[None], g[None], len(prompt))
