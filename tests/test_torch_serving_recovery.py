"""Fault-injected serving in the port (``serving/engine.py`` "Fault
tolerance", ``faults.py``, the batching engine's hooks) against the
reference, on the CPU in f32 (the schedules of
``tests/unit/serving/test_recovery.py``).

The bar: under a seeded fault plan (dispatch errors, fetch hangs,
preemptions), at pipeline depths 0/1/2, with fused and separate prefill,
greedy and sampled, every recovered stream equals the port's fault-free
stream bit for bit; greedy recovered streams equal the reference's
recovered streams (tie rule: ``tests/torch_serving_common.py``); and
``recovery_stats()``, the circuit breaker's shed verdicts and the terminal
``RecoveryFailed`` equal the reference's.
"""

import numpy as np
import pytest

from deepspeed_tpu import comm
from torch_serving_common import (
    FakeClock,
    assert_stream_agrees,
    make_params,
    prompts,
    side_of,
    verdict,
)

MAX_NEW = (10, 12, 6, 9)
PROMPT_NS = (5, 9, 20, 3)  # 20 spans several fused-prefill chunks
# one of each fault class: retried in place, poisoned (rebuild), preempted
# (rebuild)
PLAN = (("dispatch_error", 3), ("fetch_hang", 5), ("preempt", 8))


@pytest.fixture(scope="module")
def params():
    comm.destroy()
    yield make_params()
    comm.destroy()


def _prompts():
    return prompts(PROMPT_NS, seed=1)


def _plan(side, faults):
    s = side.serving
    return s.FaultPlan([s.Fault(tick=t, kind=k) for k, t in faults])


def _run(side, *, plan=None, depth=1, fused=True, sampled=False, factory=None,
         recovery=None, max_ticks=300, **srv_kw):
    """A full serving run; returns ({rid: (state, tokens)}, serving). With
    a plan, recovery is armed (default factory: the run's geometry)."""
    clock = FakeClock()

    def build(cache_len=64):
        return side.build_cb(sampled=sampled, max_slots=3, cache_len=cache_len,
                             pipeline_depth=depth, fused_prefill=fused)

    cb = build()
    kw = dict(srv_kw)
    if plan is not None:
        cb.fault_hook = side.serving.FaultInjector(plan)
        kw.setdefault("engine_factory", factory or (lambda mesh_shape=None: build()))
        kw.setdefault("recovery", recovery or side.serving.RecoveryConfig(backoff_s=0.0))
        kw.setdefault("sleep", lambda s: None)
    srv = side.serving.ServingEngine(cb, clock=clock, **kw)
    adms = [srv.submit(p, max_new_tokens=m) for p, m in zip(_prompts(), MAX_NEW)]
    n = 0
    while srv.has_work():
        assert n < max_ticks, "serving did not drain"
        clock.advance(0.01)
        srv.step()
        n += 1
    done = srv.reap()
    return {a.rid: (done[a.rid].state, [int(t) for t in done[a.rid].tokens])
            for a in adms}, srv


_FAULT_FREE = {}


def _fault_free(params, fused, sampled):
    """The port's fault-free streams (depth-invariant: depth 1)."""
    key = (fused, sampled)
    if key not in _FAULT_FREE:
        _FAULT_FREE[key] = _run(side_of("port", params), fused=fused, sampled=sampled)[0]
    return _FAULT_FREE[key]


def _assert_bitwise(ref, chaos):
    assert set(ref) == set(chaos)
    for rid in ref:
        assert ref[rid][0] == chaos[rid][0] == "finished"
        assert ref[rid][1] == chaos[rid][1], f"stream diverged for rid {rid}"


def _assert_greedy_agree(params, ref_out, port_out):
    assert {r: v[0] for r, v in port_out.items()} == {r: v[0] for r, v in ref_out.items()}
    for rid, p in enumerate(_prompts()):
        assert_stream_agrees(params, ref_out[rid][1], port_out[rid][1], p, what=f"rid {rid}")


# ---------------------------------------------------------------------------
# bitwise resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "separate"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_recovered_streams_equal_the_fault_free_run(params, depth, fused, sampled):
    """A retried dispatch error, a fetch hang (poisoned: rebuild) and a
    preemption (rebuild): every recovered stream equals the fault-free
    stream bit for bit; greedy streams and the recovery accounting equal
    the reference's under the same plan."""
    port_side = side_of("port", params)
    chaos, srv = _run(port_side, plan=_plan(port_side, PLAN), depth=depth, fused=fused,
                      sampled=sampled)
    _assert_bitwise(_fault_free(params, fused, sampled), chaos)
    stats = srv.recovery_stats()
    assert (stats["faults"], stats["retries"], stats["rebuilds"]) == (3, 1, 2), stats
    assert stats["lost_requests"] == 0 and not stats["breaker_open"]
    assert srv._cb.fault_hook.pending() == 0
    if not sampled:
        ref_side = side_of("ref", params)
        ref_chaos, ref_srv = _run(ref_side, plan=_plan(ref_side, PLAN), depth=depth,
                                  fused=fused)
        _assert_greedy_agree(params, ref_chaos, chaos)
        assert stats == ref_srv.recovery_stats()
        assert srv._cb.fault_hook.fired == ref_srv._cb.fault_hook.fired


@pytest.mark.parametrize("seed", [3, 11])
def test_synthesized_plans_resume_bitwise(params, seed):
    """Seeded random plans (``FaultPlan.synth``, the reference's plans byte
    for byte) recover every stream bit for bit, with the reference's
    accounting."""
    stats, fired = {}, {}
    for name in ("ref", "port"):
        side = side_of(name, params)
        plan = side.serving.FaultPlan.synth(seed=seed, n_faults=3, first_tick=2, tick_span=14)
        out, srv = _run(side, plan=plan)
        stats[name], fired[name] = srv.recovery_stats(), srv._cb.fault_hook.fired
        if name == "port":
            _assert_bitwise(_fault_free(params, True, False), out)
        else:
            ref_out = out
    _assert_greedy_agree(params, ref_out, out)
    assert stats["port"] == stats["ref"] and fired["port"] == fired["ref"]


def test_prefix_requests_survive_rebuild(params):
    """Serving-level prefix ids stay valid across a rebuild: the tokens are
    re-registered on the replacement, in-flight prefix requests recover bit
    for bit (sampled), and a new prefix submit works afterwards."""
    rs = np.random.RandomState(5)
    prefix = rs.randint(0, 128, (12,)).astype(np.int32)
    suffixes = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (4, 6)]
    side = side_of("port", params)

    def run(plan=None):
        clock = FakeClock()
        cb = side.build_cb(sampled=True, max_slots=3, cache_len=64)
        kw = {}
        if plan is not None:
            cb.fault_hook = side.serving.FaultInjector(plan)
            kw = dict(engine_factory=lambda mesh_shape=None: side.build_cb(
                sampled=True, max_slots=3, cache_len=64),
                recovery=side.serving.RecoveryConfig(backoff_s=0.0), sleep=lambda s: None)
        srv = side.serving.ServingEngine(cb, clock=clock, **kw)
        pid = srv.register_prefix(prefix)
        adms = [srv.submit(s, max_new_tokens=8, prefix_id=pid) for s in suffixes]
        while srv.has_work():
            clock.advance(0.01)
            srv.step()
        done = srv.reap()
        late = srv.submit(suffixes[0], max_new_tokens=4, prefix_id=pid)
        while srv.has_work():
            clock.advance(0.01)
            srv.step()
        assert srv.reap()[late.rid].state == "finished"
        return [list(done[a.rid].tokens) for a in adms], srv

    ref, _ = run()
    chaos, srv = run(_plan(side, [("preempt", 3)]))
    assert srv.recovery_stats()["rebuilds"] == 1
    assert chaos == ref


# ---------------------------------------------------------------------------
# the escalation ladder, against the reference
# ---------------------------------------------------------------------------

def test_persistent_fault_exhausts_retries_then_rebuilds(params):
    """A dispatch error firing three times burns the retry budget (2) and
    escalates to a rebuild; streams stay bitwise."""
    stats = {}
    for name in ("ref", "port"):
        side = side_of(name, params)
        plan = side.serving.FaultPlan([side.serving.Fault(tick=3, kind="dispatch_error",
                                                          count=3)])
        out, srv = _run(side, plan=plan)
        stats[name] = srv.recovery_stats()
    _assert_bitwise(_fault_free(params, True, False), out)
    assert stats["port"] == stats["ref"]
    assert (stats["port"]["retries"], stats["port"]["rebuilds"],
            stats["port"]["faults"]) == (2, 1, 3)


def test_breaker_sheds_recovering_with_the_reference_hint(params):
    """While the breaker is open admission sheds ``recovering`` with the
    reference's retry hint (the rebuild's measured time on the fake
    clock); the first healthy tick closes it and admission resumes."""
    rec = {}
    for name in ("ref", "port"):
        side = side_of(name, params)
        clock = FakeClock()
        cb = side.build_cb(max_slots=3, cache_len=64)
        cb.fault_hook = side.serving.FaultInjector(_plan(side, [("preempt", 2)]))

        def factory(mesh_shape=None, side=side, clock=clock):
            clock.advance(0.5)  # a rebuild that visibly costs time
            return side.build_cb(max_slots=3, cache_len=64)

        srv = side.serving.ServingEngine(
            cb, clock=clock, engine_factory=factory,
            recovery=side.serving.RecoveryConfig(backoff_s=0.0, est_recovery_s=2.0),
            sleep=lambda s: None)
        ps = _prompts()
        verdicts = [verdict(srv.submit(ps[0], max_new_tokens=6))]
        for _ in range(2):
            clock.advance(0.01)
            srv.step()
        verdicts.append(verdict(srv.submit(ps[1], max_new_tokens=4)))
        clock.advance(0.01)
        srv.step()
        verdicts.append(verdict(srv.submit(ps[1], max_new_tokens=4)))
        while srv.has_work():
            clock.advance(0.01)
            srv.step()
        rec[name] = (verdicts, {r: q.state for r, q in srv.reap().items()},
                     srv.recovery_stats())
    verdicts = rec["port"][0]
    assert verdicts[1][0] == "shed" and verdicts[1][2] == "recovering" and verdicts[1][3] > 0
    assert verdicts[2][0] == "admitted"
    assert rec["port"] == rec["ref"]


def test_unrecoverable_failure_surfaces_and_sheds(params):
    """Recovery armed without a factory: a preemption is terminal. run()
    raises RecoveryFailed with the reference's message, every in-flight
    request ends shed, a mid-stream TokenStream stops, close() is
    idempotent."""
    rec = {}
    for name in ("ref", "port"):
        side = side_of(name, params)
        clock = FakeClock()
        cb = side.build_cb(max_slots=3, cache_len=64)
        cb.fault_hook = side.serving.FaultInjector(_plan(side, [("preempt", 3)]))
        srv = side.serving.ServingEngine(cb, clock=clock,
                                         recovery=side.serving.RecoveryConfig(),
                                         sleep=lambda s: None)
        adms = [srv.submit(p, max_new_tokens=8) for p in _prompts()[:3]]
        stream = srv.stream(adms[0].rid)
        first = next(stream)
        with pytest.raises(side.serving.RecoveryFailed, match="no engine_factory") as e:
            srv.run()
        assert list(stream) == []
        assert srv.request(adms[0].rid).tokens[0] == first
        rec[name] = ([srv.status(a.rid) for a in adms], srv.recovery_stats(), str(e.value))
        srv.close()
        srv.close()
    assert rec["port"][0] == ["shed"] * 3 and rec["port"][1]["lost_requests"] == 3
    assert rec["port"] == rec["ref"]


def test_restore_failure_is_terminal_not_raw(params):
    """A replacement that cannot be restored (prefix re-registration blows
    up with a non-ValueError): every live request is shed and
    RecoveryFailed surfaces, as in the reference."""
    side = side_of("port", params)
    clock = FakeClock()
    cb = side.build_cb(max_slots=3, cache_len=64)
    cb.fault_hook = side.serving.FaultInjector(_plan(side, [("preempt", 3)]))

    def bad_factory(mesh_shape=None):
        new = side.build_cb(max_slots=3, cache_len=64)
        new.register_prefix = None
        return new

    srv = side.serving.ServingEngine(cb, clock=clock, engine_factory=bad_factory,
                                     recovery=side.serving.RecoveryConfig(backoff_s=0.0),
                                     sleep=lambda s: None)
    srv.register_prefix(np.asarray([1, 2, 3], np.int32))
    adms = [srv.submit(p, max_new_tokens=6) for p in _prompts()[:2]]
    with pytest.raises(side.serving.RecoveryFailed, match="could not be restored"):
        while srv.has_work():
            clock.advance(0.01)
            srv.step()
    assert all(srv.status(a.rid) == "shed" for a in adms)
    assert srv.recovery_stats()["lost_requests"] == len(adms)
    srv.close()


def test_readmit_failure_sheds_honestly(params):
    """A replacement too small for a request: its re-admission fails and it
    ends shed (counted, never lost silently), everything else recovers;
    the same outcome as the reference's, with conservation."""
    rec = {}
    for name in ("ref", "port"):
        side = side_of(name, params)
        tiny = (lambda mesh_shape=None, side=side: side.build_cb(max_slots=3, cache_len=16))
        out, srv = _run(side, plan=_plan(side, [("preempt", 4)]), factory=tiny)
        rec[name] = (out, srv.recovery_stats())
    out, stats = rec["port"]
    states = [out[rid][0] for rid in out]
    assert stats["lost_requests"] >= 1 and states.count("shed") == stats["lost_requests"]
    assert states.count("finished") + states.count("shed") == len(states)
    assert stats == rec["ref"][1]
    free = _fault_free(params, True, False)
    for rid in out:
        if out[rid][0] == "finished":
            assert out[rid][1] == free[rid][1]
    _assert_greedy_agree(params, rec["ref"][0], out)


# ---------------------------------------------------------------------------
# the port's own watchdog and log
# ---------------------------------------------------------------------------

def test_fetch_watchdog_poisons_engine(params):
    """The real watchdog: a fetch over ``fetch_timeout_s`` raises
    TimeoutError out of step() and poisons the engine."""
    cb = side_of("port", params).build_cb(max_slots=3, cache_len=64)
    cb.fetch_timeout_s = 1e-9
    cb.submit(_prompts()[0], max_new_tokens=4)
    with pytest.raises(TimeoutError, match="fetch_timeout_s"):
        while cb.has_work():
            cb.step()
    assert cb.poisoned


def test_recovery_log_tracks_running_requests_and_roundtrips(params, tmp_path):
    side = side_of("port", params)
    clock = FakeClock()
    srv = side.serving.ServingEngine(side.build_cb(max_slots=3, cache_len=64), clock=clock)
    p = _prompts()[0]
    a = srv.submit(p, max_new_tokens=8, priority=2, tenant="t1", deadline_ms=5000.0)
    for _ in range(4):
        clock.advance(0.01)
        srv.step()
    req = srv.request(a.rid)
    [entry] = srv._recovery_log.entries()
    assert entry["emitted"] == list(req.tokens) and req.tokens
    assert entry["prompt"] == [int(t) for t in p]
    assert (entry["priority"], entry["tenant"]) == (2, "t1")
    path = str(tmp_path / "rlog.jsonl")
    srv._recovery_log.to_jsonl(path)
    assert side.serving.RecoveryLog.from_jsonl(path).entries() == [entry]
    while srv.has_work():
        clock.advance(0.01)
        srv.step()
    assert len(srv._recovery_log) == 0


def _migrate(side, sampled):
    """Serve the four requests on one engine for four ticks, then move
    every live one to a second engine the way a fleet router does
    (``recovery_snapshot`` -> ``readmit`` -> ``release``) and finish
    there. Returns (verdicts, outlook, {serving rid on the second: (state,
    tokens)}, the snapshot's engine rids)."""
    clock = FakeClock()

    def serving():
        return side.serving.ServingEngine(
            side.build_cb(sampled=sampled, max_slots=3, cache_len=64), clock=clock)

    a, b = serving(), serving()
    b.set_rid_base(1000)
    for p, m in zip(_prompts(), MAX_NEW):
        a.submit(p, max_new_tokens=m)
    for _ in range(4):
        clock.advance(0.01)
        a.step()
    outlook = b.admission_outlook(50)
    snap = a.recovery_snapshot(include_queued=True)
    verdicts = []
    for entry in snap:
        verdicts.append(verdict(b.readmit(entry)))
        assert a.release(entry["rid"]) is not None
    assert a.queue_depth() == 0 and a.abandon("nothing left") == {}
    while b.has_work():
        clock.advance(0.01)
        b.step()
    done = b.reap()
    return (verdicts, outlook, {rid: (r.state, [int(t) for t in r.tokens])
                                for rid, r in done.items()},
            [e["engine_rid"] for e in snap])


def test_fleet_surface_moves_streams_between_engines(params):
    """The serving engine's fleet surface (the router's moves, driven by
    hand): the moved running streams continue bit for bit (their engine
    rids pinned, sampled), the queued one starts fresh on the second
    engine's rid range; verdicts, the outlook and greedy streams equal the
    reference's."""
    verdicts, _, moved, erids = _migrate(side_of("port", params), sampled=True)
    free = _fault_free(params, True, True)
    assert erids == [0, 1, 2, None]
    assert [v[0] for v in verdicts] == ["admitted"] * 3 + ["queued"]
    for (_, rid, _, _), erid in zip(verdicts[:3], erids):
        assert moved[rid] == free[erid]
    rec = {name: _migrate(side_of(name, params), sampled=False) for name in ("ref", "port")}
    assert rec["port"][:2] == rec["ref"][:2] and rec["port"][3] == rec["ref"][3]
    prompt_of = dict(zip((v[1] for v in rec["port"][0]), _prompts()))
    for rid, (state, toks) in rec["port"][2].items():
        assert state == rec["ref"][2][rid][0] == "finished"
        assert_stream_agrees(params, rec["ref"][2][rid][1], toks, prompt_of[rid], what=f"rid {rid}")
