"""The port's speculative pool (``ContinuousBatchingEngine`` with
``speculative: {"enabled": true, "pool": true}``, ngram and draft modes;
``inference/decoding.compile_spec_pool_tick_fn``,
``compile_spec_row_update_fn``, ``spec_request_keys``; ``inference/ngram``)
in f32 on the CPU, mirroring ``tests/unit/inference/test_spec_pool.py``.

Speculation is lossless: it changes how many tokens a tick emits, never
which. Greedy streams must equal the port's plain pool across pipeline
depths, prefill fusion, int8 KV, gamma and EOS, and the reference's
speculative pool on the same schedule and bridged weights; each result
equal, or first differing at a generated step where the reference's top-2
logit margin is under 1e-4 (a tie that f32 summation order may break;
reported, not failed). The tick programs are held to the reference's
``compile_spec_pool_tick_fn`` on the same inputs: ``packed`` and the
threaded state equal, the caches within f32 rounding (1e-5).

Sampled streams cannot match the reference's threefry draws. The port's
lanes are keyed by (seed, rid, token index, lane), so the port is held to the
reference's invariants: draft-mode streams bit for bit across depths,
fusion and slot placement, and every mode's token histogram within total
variation 0.2 of the plain pool's (the reference's bar).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu import comm
from deepspeed_tpu.inference import decoding as jdec
from deepspeed_tpu.inference import ngram as jngram
from deepspeed_tpu.inference.continuous import ContinuousBatchingEngine as JEngine
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
from deepspeed_tpu_torch.inference import decoding as tdec
from deepspeed_tpu_torch.inference import ngram
from deepspeed_tpu_torch.models import transformer as ttf

TIE = 1e-4
FLOOR = 16  # small tight-read floor so tiny pools cross read buckets
CACHE_TOL = 1e-5
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128,
           dtype="float32")
DRAFT_CFG = dict(CFG, hidden_size=32, num_layers=1)


def _noisy_params(cfg, seed):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def setup():
    comm.destroy()
    jcfg, dcfg = jtf.TransformerConfig(**CFG), jtf.TransformerConfig(**DRAFT_CFG)
    yield {"jcfg": jcfg, "dcfg": dcfg, "params": _noisy_params(jcfg, 0),
           "dparams": _noisy_params(dcfg, 1)}
    comm.destroy()


def _prompts(ns, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, (n,)).astype(np.int32) for n in ns]


def _config(spec, extra):
    config = {"dtype": "float32", "kv_read_floor": FLOOR}
    if spec is not None:
        gamma, mode = spec
        config["speculative"] = {"enabled": True, "pool": True, "mode": mode,
                                 "num_draft_tokens": gamma}
    config.update(extra)
    return config


def _cb(setup, spec=None, use_draft=False, config=None, **kw):
    """The port's pool engine; ``spec=(gamma, mode)`` turns the speculative
    tick on."""
    kw.setdefault("max_slots", 3)
    kw.setdefault("cache_len", 64)
    if use_draft:
        kw.update(draft_model=ttf.TransformerModel(ttf.TransformerConfig(**DRAFT_CFG)),
                  draft_params=setup["dparams"])
    return ContinuousBatchingEngine(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                    params=setup["params"], config=_config(spec, config or {}),
                                    device="cpu", **kw)


def _ref_cb(setup, spec=None, use_draft=False, **kw):
    """The reference's pool engine with the same arguments (donation off:
    the JAX CPU backend blocks at dispatch under donation)."""
    kw.setdefault("max_slots", 3)
    kw.setdefault("cache_len", 64)
    if use_draft:
        kw.update(draft_model=jtf.TransformerModel(setup["dcfg"]),
                  draft_params=setup["dparams"])
    comm.destroy()
    return JEngine(jtf.TransformerModel(setup["jcfg"]), params=setup["params"],
                   config=_config(spec, {}), donate_cache=False, **kw)


def _serve(cb, submissions, max_ticks=800):
    """Drive ``cb`` over [(tick, prompt, max_new)]; returns the finished
    arrays in submission order and checks that the concatenated step()
    emissions (up to gamma + 1 a rid a step) are each request's stream."""
    streams, results, rid_of = {}, {}, {}
    pending = list(submissions)
    tick = 0
    while pending or cb.has_work():
        assert tick < max_ticks, "scheduler did not drain"
        for item in [s for s in pending if s[0] <= tick]:
            rid_of[id(item)] = cb.submit(item[1], max_new_tokens=item[2])
        pending = [s for s in pending if s[0] > tick]
        for rid, toks in cb.step().items():
            streams.setdefault(rid, []).extend(toks)
        results.update(cb.finished())
        tick += 1
    for item in submissions:
        rid = rid_of[id(item)]
        np.testing.assert_array_equal(np.asarray(streams[rid], np.int32),
                                      results[rid][len(item[1]):])
    return [results[rid_of[id(s)]] for s in submissions]


def _assert_agree(setup, want, got, prompt_lens):
    """Each result equals the wanted one, or first differs at a generated
    step where the reference's top-2 margin is < TIE."""
    assert len(want) == len(got)
    for i, (w, g, n) in enumerate(zip(want, got, prompt_lens)):
        w, g = np.asarray(w), np.asarray(g)
        if w.shape == g.shape and np.array_equal(w, g):
            continue
        np.testing.assert_array_equal(g[:n], w[:n])
        m = min(len(w), len(g))
        diff = np.nonzero(w[:m] != g[:m])[0]
        j = int(diff[0]) if diff.size else m  # a length difference: EOS at a tie
        logits = np.asarray(jtf.apply(setup["params"], setup["jcfg"],
                                      jnp.asarray(w[None, :j])))[0, j - 1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"request {i} differs at position {j} (reference margin {margin})"
        warnings.warn(f"request {i}: a tie at position {j} (reference margin {margin:.3g})")


def _lens(subs):
    return [len(s[1]) for s in subs]


# ---------------------------------------------------------------------------
# greedy streams
# ---------------------------------------------------------------------------

SUBS = [(0, 5, 12), (0, 9, 40), (0, 3, 8), (1, 20, 10), (3, 7, 6)]


def _subs(spec=SUBS, seed=1):
    return list(zip([t for t, _, _ in spec], _prompts([n for _, n, _ in spec], seed),
                    [m for _, _, m in spec]))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_ngram_matches_plain_across_depths(setup, depth):
    """Mixed mid-flight admission: slot churn re-owns freed slots."""
    subs = _subs()
    plain = _serve(_cb(setup), subs)
    spec = _serve(_cb(setup, spec=(4, "ngram"), pipeline_depth=depth), subs)
    _assert_agree(setup, plain, spec, _lens(subs))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_draft_model_matches_plain_across_depths(setup, depth):
    """An unrelated draft accepts per-row-variable counts."""
    subs = _subs([(0, 6, 10), (0, 11, 14), (2, 4, 8)], 2)
    plain = _serve(_cb(setup), subs)
    spec = _serve(_cb(setup, spec=(3, "draft"), use_draft=True, pipeline_depth=depth), subs)
    _assert_agree(setup, plain, spec, _lens(subs))


@pytest.mark.parametrize("mode,depth", [("ngram", 1), ("draft", 0)])
def test_streams_match_the_reference_spec_pool(setup, mode, depth):
    subs = _subs([(0, 6, 12), (0, 11, 14), (1, 4, 9), (2, 17, 8)], 3)
    kw = dict(spec=(3, mode), use_draft=mode == "draft", pipeline_depth=depth)
    want = _serve(_ref_cb(setup, **kw), subs)
    got = _serve(_cb(setup, **kw), subs)
    _assert_agree(setup, want, got, _lens(subs))


def test_fused_and_separate_prefill_parity(setup):
    """Admission must not touch the verify math: fused chunks through the
    separate segment dispatch == separate prefill == plain, in both modes."""
    subs = _subs([(0, 5, 8), (1, 26, 8), (1, 2, 8)], 4)
    plain = _serve(_cb(setup), subs)
    for mode in ("ngram", "draft"):
        for fused in (True, False):
            spec = _serve(_cb(setup, spec=(4, mode), use_draft=mode == "draft",
                              fused_prefill=fused, prefill_chunk=16), subs)
            _assert_agree(setup, plain, spec, _lens(subs))


def test_int8_kv_both_modes(setup):
    """int8 KV quantizes a write the same on the plain path, the gamma-wide
    verify and the draft's own cache."""
    subs = _subs([(0, 5, 10), (0, 9, 12), (1, 4, 8)], 3)
    int8 = {"kv_cache_dtype": "int8"}
    plain = _serve(_cb(setup, config=int8), subs)
    ngram_out = _serve(_cb(setup, spec=(4, "ngram"), pipeline_depth=1, config=int8), subs)
    drafted = _serve(_cb(setup, spec=(2, "draft"), use_draft=True, config=int8), subs)
    _assert_agree(setup, plain, ngram_out, _lens(subs))
    _assert_agree(setup, plain, drafted, _lens(subs))


@pytest.mark.parametrize("gamma", [1, 8])
def test_gamma_edges(setup, gamma):
    """gamma 1 (the smallest round) and 8 (wider than most quotas left)."""
    subs = _subs([(0, 5, 9), (0, 8, 11)], 6)
    plain = _serve(_cb(setup), subs)
    spec = _serve(_cb(setup, spec=(gamma, "ngram")), subs)
    _assert_agree(setup, plain, spec, _lens(subs))


def test_eos_mid_round_matches_plain(setup):
    """A request that hits EOS inside a verify round stops where the plain
    stream stops (the round's tail past the accepted EOS is masked)."""
    subs = _subs([(0, 5, 14), (0, 7, 14)], 7)
    probe = _serve(_cb(setup), subs)
    eos = int(probe[0][len(subs[0][1]) + 3])  # fires mid-round at gamma 4
    plain = _serve(_cb(setup, eos_token_id=eos), subs)
    for mode in ("ngram", "draft"):
        spec = _serve(_cb(setup, spec=(4, mode), use_draft=mode == "draft", eos_token_id=eos),
                      subs)
        _assert_agree(setup, plain, spec, _lens(subs))
    assert len(plain[0]) < len(probe[0])  # the early stop really fired


def test_windows_that_straddle_the_cache_end(setup):
    """Requests that fill their row to the last slot: the last rounds'
    windows run past ``cache_len``, whose columns must drop their writes."""
    subs = _subs([(0, 50, 14), (0, 57, 7), (1, 40, 24)], 8)
    plain = _serve(_cb(setup), subs)
    for mode in ("ngram", "draft"):
        for depth in (0, 1):
            spec = _serve(_cb(setup, spec=(8, mode), use_draft=mode == "draft",
                              pipeline_depth=depth), subs)
            _assert_agree(setup, plain, spec, _lens(subs))


def test_self_draft_accepts_what_the_target_would_emit(setup):
    """The target as its own draft: every proposal the quota leaves room
    for is accepted, so the acceptance counts only the quota-clipped last
    rounds."""
    subs = _subs([(0, 6, 21), (0, 9, 11)], 9)
    cb = ContinuousBatchingEngine(
        ttf.TransformerModel(ttf.TransformerConfig(**CFG)), params=setup["params"],
        config=_config((4, "draft"), {}), device="cpu", max_slots=2, cache_len=64,
        draft_model=ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
        draft_params=setup["params"])
    _assert_agree(setup, _serve(_cb(setup), subs), _serve(cb, subs), _lens(subs))
    stats = cb.tick_stats()
    # 21 tokens: 4 rounds of 5, then 1 of a quota-clipped 4; 11: 5, 5, then 1 of 4
    assert stats["spec_drafted"] == 4 * (5 + 3) and stats["spec_accepted"] == 4 * 6 + 1 + 1


# ---------------------------------------------------------------------------
# the tick programs against the reference's
# ---------------------------------------------------------------------------

B, T, GAMMA = 5, 128, 4


def _rows(read_len):
    """Row state: rows 0 and 1 decode (row 1 stops at its quota inside the
    window), row 2 is parked by ``run_mask`` with live threaded state, row 3
    decodes at the cache's end (its window straddles T; parked by
    ``run_mask`` when the tick reads only 64 slots), row 4 is done."""
    return dict(last_tok=np.array([5, 17, 3, 99, 0], np.int32),
                done=np.array([0, 0, 0, 0, 1], np.int32),
                pos=np.array([5, 20, 30, T - 3, T], np.int32),
                gen=np.array([0, 3, 2, 7, 0], np.int32),
                quota=np.array([20, 5, 9, 12, 0], np.int32),
                rids=np.array([0, 1, 2, 3, 4], np.int32),
                run_mask=np.array([1, 1, 0, int(read_len is None), 1], np.int32))


def _cache(cfg, seed):
    rs = np.random.RandomState(seed)
    shape = (cfg["num_layers"], B, T, cfg["num_heads"], cfg["hidden_size"] // cfg["num_heads"])
    return {n: (0.5 * rs.randn(*shape)).astype(np.float32) for n in ("k", "v")}


_STATE = ("last_tok", "done", "pos", "gen")


def _ref_tick(setup, jengs, mode, eos, read_len, rows, caches, drafts):
    jeng, jdraft = jengs
    kw = {}
    if mode == "draft":
        kw = dict(draft_cfg=jdraft.cfg, draft_param_shardings=jdraft.param_shardings)
    fn, cache_sh, _ = jdec.compile_spec_pool_tick_fn(
        jeng.mesh, jeng.cfg, jeng.param_shardings, B, T, GAMMA, 0.0, 0, 1.0,
        eos_token_id=eos, read_len=read_len, donate=False, **kw)
    jc = jax.device_put({n: jnp.asarray(a) for n, a in caches[0].items()}, cache_sh)
    state = [jnp.asarray(rows[n]) for n in _STATE + ("quota", "rids", "run_mask")]
    key = jax.random.PRNGKey(0)
    if mode == "draft":
        jd = {n: jnp.asarray(a) for n, a in caches[1].items()}
        packed, jc, jd, *threaded = fn(jeng.params, jdraft.params, jc, jd, *state, key)
        out_caches = [jc, jd]
    else:
        packed, jc, *threaded = fn(jeng.params, jc, *state, jnp.asarray(drafts), key)
        out_caches = [jc]
    return (np.asarray(packed), [np.asarray(t) for t in threaded],
            [{n: np.asarray(a) for n, a in c.items()} for c in out_caches])


def _port_tick(setup, pengs, mode, eos, read_len, rows, caches, drafts):
    peng, pdraft = pengs
    fn = tdec.compile_spec_pool_tick_fn(
        None, peng.cfg, B, T, GAMMA, 0.0, 0, 1.0, eos_token_id=eos, read_len=read_len,
        draft_cfg=pdraft.cfg if mode == "draft" else None)[0]
    tc = [{n: torch.from_numpy(a.copy()) for n, a in c.items()} for c in caches]
    state = [torch.from_numpy(rows[n].copy()) for n in _STATE]
    per_tick = [torch.from_numpy(rows[n].astype(np.int64)) for n in ("quota", "rids", "run_mask")]
    with torch.inference_mode():
        if mode == "draft":
            packed, c, d, *threaded = fn(peng.params, pdraft.params, tc[0], tc[1], *state,
                                         *per_tick, 0)
            out_caches = [c, d]
        else:
            packed, c, *threaded = fn(peng.params, tc[0], *state, *per_tick,
                                      torch.from_numpy(drafts.astype(np.int64)), 0)
            out_caches = [c]
    # in place: the threaded state and the caches are the tensors passed in
    assert all(a is b for a, b in zip(threaded, state)) and out_caches[0]["k"] is tc[0]["k"]
    return (packed.numpy(), [t.numpy() for t in threaded],
            [{n: a.numpy() for n, a in c.items()} for c in out_caches])


@pytest.fixture(scope="module")
def tick_engines(setup):
    comm.destroy()
    jengs = (deepspeed_tpu.init_inference(jtf.TransformerModel(setup["jcfg"]),
                                          params=setup["params"], config={"dtype": "float32"}),
             deepspeed_tpu.init_inference(jtf.TransformerModel(setup["dcfg"]),
                                          params=setup["dparams"], config={"dtype": "float32"}))
    pengs = tuple(ContinuousBatchingEngine(
        ttf.TransformerModel(ttf.TransformerConfig(**c)), params=p, config={"dtype": "float32"},
        device="cpu", max_slots=1)._eng for c, p in ((CFG, setup["params"]),
                                                     (DRAFT_CFG, setup["dparams"])))
    return jengs, pengs


@pytest.mark.parametrize("mode,read_len,with_eos", [
    ("ngram", None, False), ("ngram", 64, False), ("ngram", None, True),
    ("draft", None, False), ("draft", 64, True)])
def test_spec_tick_matches_reference(setup, tick_engines, mode, read_len, with_eos):
    jengs, pengs = tick_engines
    rows = _rows(read_len)
    caches = [_cache(CFG, 1), _cache(DRAFT_CFG, 2)][:2 if mode == "draft" else 1]
    drafts = np.random.RandomState(3).randint(0, 128, (B, GAMMA)).astype(np.int32)
    if mode == "ngram":
        # row 0 proposes the target's own chain for 2 tokens, then a miss:
        # the target's argmax chain from the reference's first verdicts
        probe = _ref_tick(setup, jengs, mode, None, read_len, rows, caches, drafts)[0]
        drafts[0, 0] = probe[0, 0]
        probe = _ref_tick(setup, jengs, mode, None, read_len, rows, caches, drafts)[0]
        drafts[0, 1] = probe[0, 1]
    eos = None
    if with_eos:
        eos = int(_ref_tick(setup, jengs, mode, None, read_len, rows, caches, drafts)[0][0, 0])
    ref = _ref_tick(setup, jengs, mode, eos, read_len, rows, caches, drafts)
    port = _port_tick(setup, pengs, mode, eos, read_len, rows, caches, drafts)
    np.testing.assert_array_equal(port[0], ref[0])
    for p, r, name in zip(port[1], ref[1], _STATE):
        np.testing.assert_array_equal(p, r, err_msg=name)
    for pc, rc in zip(port[2], ref[2]):
        for n in rc:
            np.testing.assert_allclose(pc[n], rc[n], rtol=CACHE_TOL, atol=CACHE_TOL)
    packed = ref[0]
    g = GAMMA
    assert packed[4, g + 1] == 0 and packed[4, g + 2] == 1  # the done row never emits
    assert packed[2, g + 1] == 0 and packed[2, g + 2] == 0  # run_mask parks row 2
    np.testing.assert_array_equal(ref[1][2][2], rows["pos"][2])  # ... and keeps its state
    # row 1: quota 5 from gen 3, so at most 2 tokens, and done when it gets them
    n1 = min(int(packed[1, g + 3]) + 1, 2)
    assert packed[1, g + 1] == n1 and packed[1, g + 2] == int(n1 == 2)
    if mode == "ngram" and eos is None:
        assert packed[0, g + 3] == 2  # the two drafts that were the target's chain


def test_spec_row_update_sets_one_row_in_place():
    set_row = tdec.compile_spec_row_update_fn(None, None, 3)
    state = [torch.zeros(3, dtype=torch.int32) for _ in range(4)]
    out = set_row(*state, 1, 7, 1, 40, 5)
    assert all(a is b for a, b in zip(out, state))
    assert [t.tolist() for t in out] == [[0, 7, 0], [0, 1, 0], [0, 40, 0], [0, 5, 0]]
    copy = tdec.compile_spec_row_update_fn(None, None, 3, donate=False)(*state, 0, 9, 0, 1, 2)
    assert state[0].tolist() == [0, 7, 0] and copy[0].tolist() == [9, 7, 0]


# ---------------------------------------------------------------------------
# sampled streams
# ---------------------------------------------------------------------------

def test_sampled_streams_equal_across_scheduling(setup):
    """Draft-mode draws key off (seed, rid, token index, lane) and the
    proposals run on the device from threaded state: depth, fusion and slot
    placement move no draw. (N-gram proposals come from the host context,
    which lags the device under dispatch-ahead, so sampled ngram streams are
    equal across depths in distribution only.)"""
    subs = _subs([(0, 6, 10), (0, 11, 10), (2, 4, 8)], 8)
    kw = dict(spec=(3, "draft"), use_draft=True, temperature=0.9, top_k=20, top_p=0.9,
              seed=11)
    base = _serve(_cb(setup, pipeline_depth=0, **kw), subs)
    variants = [
        _cb(setup, pipeline_depth=2, **kw),
        _cb(setup, pipeline_depth=1, fused_prefill=False, **kw),
        _cb(setup, cache_buckets=[(2, 32), (2, 64)], max_slots=None, cache_len=None, **kw),
    ]
    for cb in variants:
        for a, b in zip(base, _serve(cb, subs)):
            np.testing.assert_array_equal(a, b)
    greedy = _serve(_cb(setup, spec=(3, "draft"), use_draft=True, seed=11), subs)
    assert any(not np.array_equal(a, b) for a, b in zip(base, greedy))


def test_sampled_distribution_matches_the_plain_pool(setup):
    """Lossless rejection sampling: the emitted tokens follow the target's
    distribution whatever the proposals. The same prompt 48 times (each rid
    its own keys); each mode's token histogram within TV 0.2 of the plain
    pool's."""
    prompt = _prompts((6,), 9)[0]
    subs = [(i // 3, prompt, 6) for i in range(48)]
    kw = dict(temperature=1.0, top_k=3, seed=7)

    def hist(outs):
        toks = np.concatenate([o[len(prompt):] for o in outs])
        return np.bincount(toks, minlength=128) / toks.size

    plain = hist(_serve(_cb(setup, **kw), subs))
    for spec in ((3, "ngram"), (2, "draft")):
        h = hist(_serve(_cb(setup, spec=spec, use_draft=spec[1] == "draft", **kw), subs))
        tv = 0.5 * np.abs(plain - h).sum()
        assert tv < 0.2, f"{spec}: total variation {tv:.3f} against the plain pool"


# ---------------------------------------------------------------------------
# the lane keys
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _mix(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x2C1B3C6D) & M32
    return x ^ (x >> 16)


def _py_key(base, rid, gen):
    seed = _mix((base & M32) ^ ((base >> 32) & M32))
    return _mix(_mix(seed ^ (rid & M32)) ^ (gen & M32))


def _py_lane_key(base, rid, gen, lane):
    return _mix(_py_key(base, rid, gen) ^ _mix(0x5BD1E995 ^ lane))


def _py_unit(h):
    return np.float32(((h >> 9) + 0.5) * 2.0 ** -23)


@pytest.mark.parametrize("base", [0, 11, 2 ** 40 + 5])
def test_lane_keys_match_a_python_integer_implementation(base):
    rids = torch.tensor([0, 1, 7, 2 ** 31 - 1, 12345])
    gens = torch.tensor([0, 3, 64, 5, 2 ** 31 - 1])
    for lane in (tdec.LANE_DRAFT, tdec.LANE_ACCEPT, tdec.LANE_BONUS):
        got = tdec.spec_request_keys(base, rids, gens, lane).tolist()
        assert got == [_py_lane_key(base, r, g, lane) for r, g in zip(rids.tolist(),
                                                                       gens.tolist())]
    accept = tdec.spec_accept_uniforms(base, rids, gens)
    want = [_py_unit(_mix(_py_lane_key(base, r, g, tdec.LANE_ACCEPT)))
            for r, g in zip(rids.tolist(), gens.tolist())]
    assert accept.dtype == torch.float32 and accept.tolist() == want
    u = tdec.spec_uniforms(base, rids, gens, tdec.LANE_BONUS, 16)
    for i, (r, g) in enumerate(zip(rids.tolist(), gens.tolist())):
        k = _py_lane_key(base, r, g, tdec.LANE_BONUS)
        row = [_py_unit(_mix(_mix(k ^ ((v * 0x9E3779B1) & M32)))) for v in range(16)]
        assert u[i].tolist() == row
    assert bool(((u > 0) & (u < 1)).all())


def test_lane_keys_are_apart_from_the_plain_keys():
    rids = torch.arange(64).repeat_interleave(64)
    gens = torch.arange(64).repeat(64)
    plain = set(tdec.request_keys(3, rids, gens).tolist())
    lanes = [set(tdec.spec_request_keys(3, rids, gens, lane).tolist()) for lane in (1, 2, 3)]
    assert len(plain) == rids.numel() and all(len(s) == rids.numel() for s in lanes)
    for s in lanes:
        assert not s & plain
    assert not (lanes[0] & lanes[1]) and not (lanes[0] & lanes[2]) and not (lanes[1] & lanes[2])


# ---------------------------------------------------------------------------
# validation, stats, the n-gram proposer
# ---------------------------------------------------------------------------

def test_requires_single_token_ticks(setup):
    with pytest.raises(ValueError, match="tokens_per_tick=1"):
        _cb(setup, spec=(4, "ngram"), tokens_per_tick=2)


def test_rejects_an_unknown_mode(setup):
    with pytest.raises(ValueError, match="'draft' or 'ngram'"):
        _cb(setup, spec=(4, "retrieval"))


def test_rejects_gamma_below_one(setup):
    with pytest.raises(ValueError, match="num_draft_tokens"):
        _cb(setup, spec=(0, "ngram"))


def test_draft_mode_without_a_model_names_ngram(setup):
    with pytest.raises(ValueError, match="ngram"):
        _cb(setup, spec=(4, "draft"))


def test_draft_model_without_the_spec_pool(setup):
    with pytest.raises(ValueError, match="speculative"):
        _cb(setup, use_draft=True)


def test_draft_vocab_mismatch(setup):
    other = ttf.TransformerModel(ttf.TransformerConfig(**dict(DRAFT_CFG, vocab_size=64)))
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatchingEngine(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                 params=setup["params"], config=_config((4, "draft"), {}),
                                 device="cpu", max_slots=2, cache_len=64, draft_model=other)


def test_tick_stats_spec_fields(setup):
    cb = _cb(setup, spec=(4, "ngram"))
    _serve(cb, _subs([(0, 5, 10), (0, 8, 10)], 11))
    st = cb.tick_stats()
    assert st["spec_gamma"] == 4 and st["spec_mode"] == "ngram"
    assert st["spec_drafted"] > 0 and 0 <= st["spec_accepted"] <= st["spec_drafted"]
    assert st["spec_acceptance"] == pytest.approx(st["spec_accepted"] / st["spec_drafted"],
                                                  abs=1e-3)
    assert _cb(setup).tick_stats()["spec_acceptance"] is None


def test_spec_windows_reach_the_span_hook(setup):
    cb = _cb(setup, spec=(3, "ngram"))
    spans = []
    cb.span_hook = lambda rid, kind, t0, t1, attrs: spans.append((kind, attrs))
    _serve(cb, _subs([(0, 5, 10)], 12))
    kinds = {k for k, _ in spans}
    assert kinds == {"spec_verify_round"}
    assert sum(a["tokens"] for _, a in spans) == 10
    assert sum(a["drafted"] for _, a in spans) == cb.tick_stats()["spec_drafted"]


def test_ngram_proposals_equal_the_reference():
    rs = np.random.RandomState(0)
    for trial in range(200):
        n = int(rs.randint(0, 40))
        ctx = rs.randint(0, 1 + trial % 6, n).astype(np.int32)  # small vocabularies recur
        gamma, order = int(rs.randint(1, 9)), int(rs.randint(1, 5))
        np.testing.assert_array_equal(ngram.propose(ctx, gamma, order),
                                      jngram.propose(ctx, gamma, order))
    rows = [rs.randint(0, 4, int(m)) for m in (1, 7, 20)]
    np.testing.assert_array_equal(ngram.propose_rows(rows, 3), jngram.propose_rows(rows, 3))


def test_ngram_proposer_cases():
    np.testing.assert_array_equal(ngram.propose([1, 2, 3, 1, 2], 3), [3, 1, 2])
    assert ngram.propose([5, 1, 2, 7, 1, 2], 1)[0] == 7  # the most recent match wins
    np.testing.assert_array_equal(ngram.propose([9], 3), [9, 9, 9])
    np.testing.assert_array_equal(ngram.propose([1, 2, 3], 3), [3, 3, 3])
    np.testing.assert_array_equal(ngram.propose([1, 2, 1, 2, 1, 2], 4), [1, 2, 2, 2])
    np.testing.assert_array_equal(ngram.propose([], 2), [0, 0])
    rows = ngram.propose_rows([[1, 2], [7]], 3)
    assert rows.shape == (2, 3) and rows.dtype == np.int32
    with pytest.raises(ValueError, match="gamma"):
        ngram.propose([1, 2], 0)
