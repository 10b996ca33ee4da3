"""The port's continuous-batching engine (``inference/continuous.py``) against
the reference's ``ContinuousBatchingEngine``, in f32 on the CPU, on the same
bridged weights and the same schedule of submissions, steps and cancels
(mirroring ``tests/unit/inference/test_continuous_batching.py`` and
``tests/unit/inference/test_tick_pipeline.py``).

Greedy streams: each request's result equals the reference engine's, or
first differs at a generated step where the reference's own top-2 logit
margin is under 1e-4 (a tie that f32 summation order may break; reported,
not failed; the rule of ``tests/test_torch_inference_engine.py``).

Sampled streams cannot match the reference's threefry draws. The port's
sampler is keyed by (seed, rid, token index) as the reference's is, so the
port is held to the same invariants: bit for bit across pipeline depths,
fused against separate prefill and slot placement, and a ``gen_base`` resume
equal to the uninterrupted stream; and its draws to the softmax of the same
filtered logits, total variation < 0.2 (the bar of
``tests/unit/inference/test_spec_pool.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import comm
from deepspeed_tpu.inference.continuous import ContinuousBatchingEngine as JEngine
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
from deepspeed_tpu_torch.inference import decoding as tdec
from deepspeed_tpu_torch.models import transformer as ttf

TIE = 1e-4
FLOOR = 16  # small tight-read floor so tiny pools cross read buckets
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128,
           dtype="float32")


@pytest.fixture(scope="module")
def setup():
    comm.destroy()
    jcfg = jtf.TransformerConfig(**CFG)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)
    return jcfg, params


def _prompts(ns, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, (n,)).astype(np.int32) for n in ns]


def _engines(setup, floor=FLOOR, **kw):
    """(reference engine, port engine) with the same arguments."""
    jcfg, params = setup
    config = {"dtype": "float32", "kv_read_floor": floor}
    comm.destroy()
    ref = JEngine(jtf.TransformerModel(jcfg), params=params, config=config, **kw)
    port = ContinuousBatchingEngine(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                    params=params, config=config, device="cpu", **kw)
    return ref, port


def _port(setup, floor=FLOOR, **kw):
    _, params = setup
    return ContinuousBatchingEngine(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                    params=params,
                                    config={"dtype": "float32", "kv_read_floor": floor},
                                    device="cpu", **kw)


def _serve(cb, submissions, max_ticks=400):
    """Drive ``cb`` over [(tick, prompt, max_new)]; returns the finished
    arrays in submission order and checks that the concatenated step()
    emissions are each request's generated stream."""
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


def _drain(cb):
    done = {}
    while cb.has_work():
        cb.step()
        done.update(cb.finished())
    done.update(cb.finished())
    return done


def _assert_agree(setup, ref_out, port_out, prompt_lens):
    """Each port result equals the reference's, or first differs at a
    generated step where the reference's top-2 margin is < TIE."""
    jcfg, params = setup
    assert len(ref_out) == len(port_out)
    for i, (r, p, n) in enumerate(zip(ref_out, port_out, prompt_lens)):
        r, p = np.asarray(r), np.asarray(p)
        if r.shape == p.shape and np.array_equal(r, p):
            continue
        np.testing.assert_array_equal(p[:n], r[:n])
        m = min(len(r), len(p))
        diff = np.nonzero(r[:m] != p[:m])[0]
        j = int(diff[0]) if diff.size else m  # a length difference: EOS at a tie
        logits = np.asarray(jtf.apply(params, jcfg, jnp.asarray(r[None, :j])))[0, j - 1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"request {i} differs at position {j} (reference margin {margin})"
        warnings.warn(f"request {i}: a tie at position {j} (reference margin {margin:.3g})")


# ---------------------------------------------------------------------------
# greedy streams against the reference engine
# ---------------------------------------------------------------------------

def test_staggered_admission_and_slot_reuse(setup):
    """4 requests through 3 slots, one submitted after two steps into a
    reused slot (default depth 1, fused prefill)."""
    prompts = _prompts((5, 9, 3, 7))
    outs = []
    for cb in _engines(setup, floor=128, max_slots=3, cache_len=64):
        rids = [cb.submit(p, max_new_tokens=8) for p in prompts[:3]]
        cb.step()
        cb.step()
        rids.append(cb.submit(prompts[3], max_new_tokens=8))
        done = _drain(cb)
        outs.append([done[r] for r in rids])
    _assert_agree(setup, outs[0], outs[1], [len(p) for p in prompts])


def test_burst_with_eos_in_mid_burst(setup):
    """tokens_per_tick=4 with an EOS taken from request 0's stream, so it
    finishes in mid-burst, and a mid-flight admission."""
    prompts = _prompts((5, 9, 3, 7), seed=2)
    probe = _port(setup, floor=128, max_slots=1, cache_len=64)
    eos = int(_serve(probe, [(0, prompts[0], 10)])[0][len(prompts[0]) + 2])
    outs = []
    for cb in _engines(setup, floor=128, max_slots=3, cache_len=64, eos_token_id=eos,
                       tokens_per_tick=4):
        rids = [cb.submit(p, max_new_tokens=10) for p in prompts[:3]]
        cb.step()
        rids.append(cb.submit(prompts[3], max_new_tokens=10))
        done = _drain(cb)
        outs.append([done[r] for r in rids])
        assert outs[-1][0][-1] == eos and len(outs[-1][0]) == len(prompts[0]) + 3
        assert cb.tick_stats()["wasted_tokens"] > 0
    _assert_agree(setup, outs[0], outs[1], [len(p) for p in prompts])


def test_queue_longer_than_slots_drains(setup):
    prompts = _prompts((3, 4, 5, 6, 7), seed=2)
    subs = [(0, p, 4) for p in prompts]
    ref, port = _engines(setup, floor=128, max_slots=2, cache_len=64)
    _assert_agree(setup, _serve(ref, subs), _serve(port, subs), [len(p) for p in prompts])


def test_pipelined_matches_sync_and_reference_bucketed(setup):
    """Depths 0 / 1 / 2 over bucketed pools with mid-flight admission and
    read-bucket crossings: every depth equals the reference (depth 0)."""
    subs = list(zip((0, 0, 0, 1, 3, 4), _prompts((5, 9, 3, 20, 7, 4), 1),
                    (12, 40, 8, 10, 6, 9)))
    ref, _ = _engines(setup, cache_buckets=[(2, 32), (2, 64)], pipeline_depth=0)
    want = _serve(ref, subs)
    for depth in (0, 1, 2):
        cb = _port(setup, cache_buckets=[(2, 32), (2, 64)], pipeline_depth=depth)
        _assert_agree(setup, want, _serve(cb, subs), [len(s[1]) for s in subs])
        assert cb.tick_stats()["max_inflight"] == depth + 1


def test_fused_against_separate_prefill_against_generate(setup):
    import deepspeed_tpu_torch

    _, params = setup
    prompts = _prompts((5, 13, 26, 2, 1), 4)
    subs = [(i % 3, p, 8) for i, p in enumerate(prompts)]
    ref, fused = _engines(setup, fused_prefill=True)
    want = _serve(ref, subs)
    separate = _serve(_port(setup, fused_prefill=False), subs)
    fused_out = _serve(fused, subs)
    plain = deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**CFG)), params=params,
        config={"dtype": "float32"}, device="cpu")
    solo = [plain.generate(p[None].astype(np.int64), max_new_tokens=8)[0].numpy()
            for p in prompts]
    lens = [len(p) for p in prompts]
    _assert_agree(setup, want, fused_out, lens)
    for f, s, g in zip(fused_out, separate, solo):
        np.testing.assert_array_equal(f, s)
        np.testing.assert_array_equal(f, g)


def test_long_prompt_prefills_while_others_decode(setup):
    """Fused prefill never stalls decode: while a 40-token prompt streams
    its 16-wide chunks, the active row emits every tick."""
    short, long_p = _prompts((4, 40), 5)
    outs = []
    for cb in _engines(setup, pipeline_depth=0, prefill_chunk=16, max_slots=2, cache_len=64):
        r_short = cb.submit(short, max_new_tokens=30)
        cb.step()
        r_long = cb.submit(long_p, max_new_tokens=8)
        waiting = short_ticks = 0
        for _ in range(50):
            out = cb.step()
            if r_long in out:
                break
            waiting += 1
            short_ticks += 1 if r_short in out else 0
        else:
            raise AssertionError("long request never emitted")
        assert waiting >= 2 and short_ticks == waiting
        done = _drain(cb)
        outs.append([done[r_short], done[r_long]])
    _assert_agree(setup, outs[0], outs[1], [4, 40])


@pytest.mark.parametrize("fused", [False, True])
def test_prefix_caching(setup, fused):
    """register_prefix + submit_with_prefix, with another row mid-decode:
    separate admission (the suffix through the pool's segment forward) and
    fused (the suffix as chunks), at depths 0 and 1."""
    rs = np.random.RandomState(5)
    prefix = rs.randint(0, 128, (11,)).astype(np.int32)
    sufs = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (4, 7)]
    other = rs.randint(0, 128, (6,)).astype(np.int32)
    for depth in (0, 1):
        outs = []
        for cb in _engines(setup, max_slots=2, cache_len=64, fused_prefill=fused,
                           pipeline_depth=depth):
            pid = cb.register_prefix(prefix)
            r_other = cb.submit(other, max_new_tokens=10)
            cb.step()
            cb.step()
            r0 = cb.submit_with_prefix(pid, sufs[0], max_new_tokens=6)
            cb.step()
            r1 = cb.submit_with_prefix(pid, sufs[1], max_new_tokens=6)
            done = _drain(cb)
            outs.append([done[r0], done[r1], done[r_other]])
        _assert_agree(setup, outs[0], outs[1], [15, 18, 6])


def test_prefix_reuse_stays_stable(setup):
    """The registered prefix KV serves every request while the ticks write
    the pool cache in place around it: three serves, the same result."""
    rs = np.random.RandomState(9)
    prefix = rs.randint(0, 128, (9,)).astype(np.int32)
    suffix = rs.randint(0, 128, (3,)).astype(np.int32)
    cb = _port(setup, max_slots=2, cache_len=64)
    pid = cb.register_prefix(prefix)
    snapshot = {n: c.clone() for n, c in cb._prefixes[pid]["cache"].items()}
    results = []
    for _ in range(3):
        rid = cb.submit_with_prefix(pid, suffix, max_new_tokens=6)
        results.append(_drain(cb)[rid])
    for n, c in cb._prefixes[pid]["cache"].items():
        assert torch.equal(c, snapshot[n])
    ref, _ = _engines(setup, max_slots=2, cache_len=64)
    rid = ref.submit_with_prefix(ref.register_prefix(prefix), suffix, max_new_tokens=6)
    want = _drain(ref)[rid]
    for r in results:
        _assert_agree(setup, [want], [r], [12])


class TestBucketedKV:
    def test_parity_with_fixed_slots(self, setup):
        prompts = _prompts((5, 9, 3, 20), seed=3)
        subs = [(0, p, 8) for p in prompts]
        ref, port = _engines(setup, cache_buckets=[(2, 32), (1, 64)])
        fixed = _port(setup, max_slots=3, cache_len=64)
        want = _serve(ref, subs)
        got = _serve(port, subs)
        _assert_agree(setup, want, got, [len(p) for p in prompts])
        for a, b in zip(got, _serve(fixed, subs)):
            np.testing.assert_array_equal(a, b)

    def test_placement_smallest_fit_with_fallback(self, setup):
        cb = _port(setup, cache_buckets=[(1, 32), (1, 64)])
        short1, short2, long1 = _prompts((4, 6, 40), seed=4)
        r_short1 = cb.submit(short1, max_new_tokens=4)
        r_long = cb.submit(long1, max_new_tokens=8)   # only fits pool 1
        cb.step()
        assert cb._pools[0].active[0].rid == r_short1
        assert cb._pools[1].active[0].rid == r_long
        r_short2 = cb.submit(short2, max_new_tokens=4)
        assert set(_drain(cb)) == {r_short1, r_long, r_short2}

    def test_long_request_does_not_block_short_behind_it(self, setup):
        cb = _port(setup, cache_buckets=[(1, 32), (1, 64)])
        long_a, long_b, short = _prompts((40, 44, 4), seed=5)
        cb.submit(long_a, max_new_tokens=8)
        r_b = cb.submit(long_b, max_new_tokens=8)   # queues behind long_a
        r_s = cb.submit(short, max_new_tokens=6)    # must skip ahead
        cb.step()
        assert cb._pools[0].active[0].rid == r_s, "short request was blocked"
        assert any(r.rid == r_b for r in cb._pending)
        _drain(cb)
        assert not cb._pending

    def test_footprint(self, setup):
        row = 2 * CFG["num_layers"] * CFG["hidden_size"] * 4  # k+v, f32, a position
        fixed = _port(setup, max_slots=4, cache_len=128)
        bucketed = _port(setup, cache_buckets=[(3, 32), (1, 128)])
        assert fixed.kv_cache_bytes() == 4 * 128 * row
        assert bucketed.kv_cache_bytes() == (3 * 32 + 128) * row


class TestCancel:
    def test_cancel_while_tick_in_flight(self, setup):
        p_a, p_b, p_c = _prompts((5, 7, 6), 7)
        outs = []
        for cb in _engines(setup, max_slots=2, cache_len=64, pipeline_depth=1):
            ra = cb.submit(p_a, max_new_tokens=20)
            rb = cb.submit(p_b, max_new_tokens=20)
            for _ in range(3):
                cb.step()
            assert cb._inflight
            assert cb.cancel(ra) is True and cb.status(ra) == "cancelled"
            rc = cb.submit(p_c, max_new_tokens=5)  # reuses ra's slot
            done = _drain(cb)
            assert ra not in done
            with pytest.raises(KeyError, match="cancelled"):
                cb.result(ra)
            outs.append([done[rb], done[rc]])
        _assert_agree(setup, outs[0], outs[1], [7, 6])

    def test_cancel_mid_prefill_chunks(self, setup):
        short, long_p = _prompts((4, 40), 8)
        outs = []
        for cb in _engines(setup, max_slots=2, cache_len=64, prefill_chunk=16,
                           pipeline_depth=1):
            r_short = cb.submit(short, max_new_tokens=12)
            r_long = cb.submit(long_p, max_new_tokens=8)
            cb.step()
            assert cb.cancel(r_long) is True
            assert not cb._pools[0].prefill_q
            outs.append([_drain(cb)[r_short]])
        _assert_agree(setup, outs[0], outs[1], [4])


class TestLifecycle:
    def test_status_peek_result(self, setup):
        cb = _port(setup, max_slots=1, cache_len=64)
        p_a, p_b = _prompts((4, 5), seed=7)
        ra = cb.submit(p_a, max_new_tokens=4)
        rb = cb.submit(p_b, max_new_tokens=4)
        assert cb.status(ra) == "pending" and cb.status(rb) == "pending"
        with pytest.raises(KeyError, match=f"request {ra}: pending"):
            cb.result(ra)
        cb.step()
        assert cb.status(ra) == "active" and cb.status(rb) == "pending"
        assert cb.peek(ra) is None
        with pytest.raises(KeyError, match=f"request {ra}: active"):
            cb.result(ra)
        while cb.status(ra) in ("pending", "active"):
            cb.step()
        assert cb.status(ra) == "finished"
        got = cb.peek(ra)
        assert got is not None and len(got) == len(p_a) + 4
        np.testing.assert_array_equal(cb.result(ra), got)
        assert cb.status(ra) == "unknown" and cb.status(12345) == "unknown"
        with pytest.raises(KeyError, match="request 999: unknown"):
            cb.result(999)
        _drain(cb)

    def test_cancel_pending_and_active_frees_slot(self, setup):
        cb = _port(setup, max_slots=1, cache_len=64)
        p_a, p_b, p_c = _prompts((4, 5, 6), seed=9)
        ra = cb.submit(p_a, max_new_tokens=8)
        rb = cb.submit(p_b, max_new_tokens=8)
        cb.step()
        assert cb.cancel(rb) is True and cb.status(rb) == "cancelled" and not cb._pending
        assert cb.cancel(ra) is True and cb.status(ra) == "cancelled"
        assert cb.pool_state() == [{"length": 64, "slots": 1, "free": 1}]
        rc = cb.submit(p_c, max_new_tokens=2)
        out = _drain(cb)
        assert set(out) == {rc} and len(out[rc]) == len(p_c) + 2
        assert cb.cancel(rc) is False

    def test_cancelled_set_is_bounded(self, setup):
        cb = _port(setup, max_slots=1, cache_len=64)
        cb._cancelled_cap = 4
        prompt = _prompts((3,), seed=10)[0]
        rids = []
        for _ in range(6):
            rid = cb.submit(prompt, max_new_tokens=2)
            assert cb.cancel(rid) is True
            rids.append(rid)
        assert len(cb._cancelled) == 4
        assert cb.status(rids[0]) == "unknown" and cb.status(rids[-1]) == "cancelled"

    def test_rejected_requests(self, setup):
        cb = _port(setup, max_slots=2, cache_len=32)
        with pytest.raises(ValueError, match="cache_len"):
            cb.submit(np.arange(30, dtype=np.int32), max_new_tokens=8)
        with pytest.raises(ValueError, match="max_new_tokens"):
            cb.submit(np.arange(4, dtype=np.int32), max_new_tokens=0)
        with pytest.raises(ValueError, match="empty prompt"):
            cb.submit([], max_new_tokens=4)
        pid = cb.register_prefix(np.arange(20, dtype=np.int32) % 128)
        with pytest.raises(ValueError, match="cache_len"):
            cb.submit_with_prefix(pid, np.arange(8, dtype=np.int32), max_new_tokens=8)
        cb.unregister_prefix(pid)
        with pytest.raises(KeyError, match="unknown prefix id"):
            cb.unregister_prefix(pid)
        with pytest.raises(ValueError, match="already in use"):
            rid = cb.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
            cb.submit(np.arange(3, dtype=np.int32), max_new_tokens=2, rid=rid)

    def test_sync_mode_keeps_nothing_in_flight(self, setup):
        cb = _port(setup, max_slots=1, pipeline_depth=0)
        rid = cb.submit(_prompts((4,), 11)[0], max_new_tokens=3)
        seen = 0
        while cb.has_work():
            seen += len(cb.step().get(rid, []))
            assert not cb._inflight
        stats = cb.tick_stats()
        assert seen == 3 and stats["max_inflight"] <= 1 and stats["tokens"] == 3
        assert 0.0 <= stats["overlap_frac"] <= 1.0 and stats["block_ms_per_token"] is not None

    def test_runs_on_the_card_unless_asked_for_the_cpu(self, setup):
        _, params = setup
        model = ttf.TransformerModel(ttf.TransformerConfig(**CFG))
        if torch.cuda.is_available():
            cb = ContinuousBatchingEngine(model, params=params, max_slots=1)
            assert cb.device.type == "cuda" and cb.cache["k"].is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                ContinuousBatchingEngine(model, params=params, max_slots=1)
        cb = _port(setup, max_slots=1)
        assert cb.device.type == "cpu" and not cb.cache["k"].is_cuda

    def test_unported_surface_raises(self, setup):
        _, params = setup
        model = ttf.TransformerModel(ttf.TransformerConfig(**CFG))
        with pytest.raises(NotImplementedError, match="item 8"):
            ContinuousBatchingEngine(model, params=params, device="cpu", mesh=object())
        cb = _port(setup, max_slots=1)
        for name in ("hbm_components", "analyze_program_memory"):
            with pytest.raises(NotImplementedError, match="item 1[12]"):
                getattr(cb, name)()


# ---------------------------------------------------------------------------
# sampled streams: the port's own invariants, and its draws' distribution
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.9, seed=11)


def test_sampled_streams_equal_across_depths_and_fusion(setup):
    subs = list(zip((0, 0, 2), _prompts((6, 11, 4), 2), (10, 10, 8)))
    variants = [dict(pipeline_depth=0), dict(pipeline_depth=1),
                dict(pipeline_depth=1, fused_prefill=False),
                dict(pipeline_depth=0, fused_prefill=False),
                dict(pipeline_depth=2, tokens_per_tick=3)]
    outs = [_serve(_port(setup, **SAMPLED, **kw), subs) for kw in variants]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)
    greedy = _serve(_port(setup, seed=11), subs)
    assert any(not np.array_equal(a, b) for a, b in zip(outs[0], greedy))


def test_sampled_stream_independent_of_slot(setup):
    """The same rid lands in slot 0 of one engine and slot 2 of another."""
    prompt = _prompts((7,), 12)[0]
    alone = _port(setup, **SAMPLED, max_slots=3)
    alone.submit(prompt, max_new_tokens=12, rid=5)
    busy = _port(setup, **SAMPLED, max_slots=3)
    for i, p in enumerate(_prompts((3, 4), 13)):
        busy.submit(p, max_new_tokens=20, rid=i)
    busy.submit(prompt, max_new_tokens=12, rid=5)
    busy.step()
    assert busy._pools[0].active[2].rid == 5
    np.testing.assert_array_equal(_drain(alone)[5], _drain(busy)[5])


@pytest.mark.parametrize("fused", [True, False])
def test_gen_base_resume_continues_the_stream(setup, fused):
    prompt = _prompts((6,), 14)[0]
    full = _port(setup, **SAMPLED, fused_prefill=fused)
    full.submit(prompt, max_new_tokens=12, rid=3)
    whole = _drain(full)[3]
    emitted = whole[len(prompt):]
    resumed = _port(setup, **SAMPLED, fused_prefill=not fused)
    resumed.submit(np.concatenate([prompt, emitted[:5]]), max_new_tokens=7, rid=3,
                   gen_base=5)
    np.testing.assert_array_equal(_drain(resumed)[3], whole)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.8, 40, 1.0),
                                                     (0.9, 0, 0.9)])
def test_sampler_distribution_matches_softmax(temperature, top_k, top_p):
    """Draws for one row of logits over 4000 token indices, against the
    softmax of the same filtered logits: TV < 0.2."""
    logits = torch.from_numpy(np.random.RandomState(0).randn(1, 128).astype(np.float32) * 2.0)
    N = 4000
    gens = torch.arange(N)
    toks = tdec.select_token_rows(logits.expand(N, 128), temperature, top_k, 7,
                                  torch.full((N,), 3), gens, top_p)
    probs = torch.softmax(tdec._filter_logits(logits, temperature, top_k, top_p), dim=-1)[0]
    hist = torch.bincount(toks.long(), minlength=128).double() / N
    tv = 0.5 * float((hist - probs.double()).abs().sum())
    assert tv < 0.2, tv
    assert (hist[probs == 0] == 0).all()  # nothing outside the filtered support


def test_sampler_keys_are_counter_based():
    """The uniforms depend on (seed, rid, gen, vocab index) alone: a row's
    noise is the same in any batch and at any row; other keys differ."""
    rids, gens = torch.tensor([0, 1, 2, 1]), torch.tensor([5, 5, 5, 6])
    u = tdec.request_uniforms(9, rids, gens, 64)
    assert u.dtype == torch.float32 and bool(((u > 0) & (u < 1)).all())
    one = tdec.request_uniforms(9, rids[1:2], gens[1:2], 64)
    assert torch.equal(one[0], u[1])
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[1], u[3])
    assert not torch.equal(tdec.request_uniforms(10, rids, gens, 64), u)
    # the same bits from the hash as from plain integer arithmetic
    want = _uniform_py(9, 1, 5, 17)
    assert float(u[1, 17]) == want


def _uniform_py(seed, rid, gen, v):
    """The sampler's hash in Python integers, as a second implementation."""
    m = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & m
        x ^= x >> 15
        x = (x * 0x2C1B3C6D) & m
        return x ^ (x >> 16)

    key = mix(mix(mix((seed & m) ^ ((seed >> 32) & m)) ^ rid) ^ gen)
    h = mix(mix(key ^ ((v * 0x9E3779B1) & m)))
    return ((h >> 9) + 0.5) * 2.0 ** -23
