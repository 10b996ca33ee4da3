"""The port's fleet over the real model (the cases of
``tests/unit/serving/test_fleet.py``): two ``ServingEngine`` replicas of
the toy model (vocab 128, hidden 64, 2 layers, 4 heads, f32, on the CPU)
behind each package's ``FleetRouter``, on the bridged weights of
``tests/torch_serving_common.py`` and a fake clock per side.

- A kill with running streams: every migrated greedy stream equals the
  reference fleet's and the port's own fault-free run's, bit for bit; every
  migrated sampled stream equals the port's fault-free run's (same rids:
  the rid keys the sampler), bit for bit; nothing is lost and the fleet's
  books balance.
- A rolling restart under load loses nothing and changes no stream.
- An in-replica recovery rebuild keeps the replica's ``replica`` tag on
  the rebuilt engine's events (the serving engine re-injects the fleet's
  facade, not the base hub).
- The rid partition reaches the sampler's hash unmasked: a replica in a
  high slot samples the same bits as a bare engine given the same rid.
"""

import numpy as np
import pytest
from torch_serving_common import FakeClock, make_params, prompts, side_of

from deepspeed_tpu import comm

MAX_NEW = (10, 12, 6, 9)
PROMPT_NS = (5, 9, 7, 3)


@pytest.fixture(scope="module")
def params():
    comm.destroy()
    yield make_params()
    comm.destroy()


def _fleet(side, n=2, *, sampled=False, slots=2, hub=None, factory_kw=None):
    clock = FakeClock()

    def factory(replica_id):
        cb = side.build_cb(sampled=sampled, max_slots=slots, cache_len=64)
        if hub is not None:
            side.serving.attach_replica_telemetry(cb, hub, replica_id)
        return side.serving.ServingEngine(cb, clock=clock, **(factory_kw or {}))

    return side.serving.FleetRouter(factory, replicas=n, clock=clock, telemetry=hub), clock


def _run(side, *, hooks=(), sampled=False, hub=None, factory_kw=None):
    router, clock = _fleet(side, sampled=sampled, hub=hub, factory_kw=factory_kw)
    adms = [router.submit(p, max_new_tokens=m)
            for p, m in zip(prompts(PROMPT_NS, seed=1), MAX_NEW)]
    assert all(adms)
    hooks = dict(hooks)
    n = 0
    while router.has_work():
        assert n < 400, "fleet did not drain"
        if n in hooks:
            hooks[n](router)
        router.step()
        clock.advance(0.01)
        n += 1
    done = router.reap()
    streams = {rid: (req.state, [int(t) for t in req.tokens]) for rid, req in done.items()}
    st = router.statusz()
    router.close()
    return [a.rid for a in adms], streams, st


def _kill_r1(router):
    router.kill("r1", detail="test")


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_kill_migrates_streams_bit_for_bit(params, sampled):
    port = side_of("port", params)
    rids0, free, _ = _run(port, sampled=sampled)
    rids, chaos, st = _run(port, sampled=sampled, hooks=[(4, _kill_r1)])
    assert rids == rids0
    assert all(s == "finished" for s, _ in chaos.values())
    assert st["migrated"] >= 1 and st["lost"] == 0 and st["replica_deaths"] == 1
    assert st["admitted"] == len(MAX_NEW) == len(chaos)
    assert st["replicas"]["r1"]["migrated_out"] == st["migrated"]
    assert chaos == free
    if not sampled:
        _, ref, ref_st = _run(side_of("ref", params), hooks=[(4, _kill_r1)])
        assert chaos == ref
        assert {k: st[k] for k in ("migrated", "lost", "admitted", "replica_deaths")} == {
            k: ref_st[k] for k in ("migrated", "lost", "admitted", "replica_deaths")}


def test_rolling_restart_loses_nothing(params):
    port = side_of("port", params)
    _, free, _ = _run(port)
    _, rolled, st = _run(port, hooks=[(3, lambda r: r.rolling_restart())])
    assert rolled == free
    assert st["lost"] == 0 and st["replica_deaths"] == 0 and not st["rolling_restart"]
    assert sorted(i["state"] for i in st["replicas"].values()) == [
        "drained", "drained", "healthy", "healthy"]
    _, ref, ref_st = _run(side_of("ref", params), hooks=[(3, lambda r: r.rolling_restart())])
    assert rolled == ref
    assert {r: i["state"] for r, i in st["replicas"].items()} == {
        r: i["state"] for r, i in ref_st["replicas"].items()}


def test_recovery_rebuild_keeps_the_replica_tag(params):
    """r1's engine is preempted at its third tick: the serving engine
    rebuilds it from the factory and re-admits its streams. The rebuilt
    engine's hub is the fleet's facade, so its events still carry
    ``replica: r1``; the streams equal the fault-free run's."""
    port = side_of("port", params)
    s = port.serving
    _, free, _ = _run(port)
    clock, events, holder = FakeClock(), [], {}

    def factory(replica_id):
        # the loadgen's build: the first engine's hub (registry only, no
        # trace file) is the fleet's, every replica talks through a facade
        if "hub" not in holder:
            cb = port.build_cb(config={"dtype": "float32", "kv_read_floor": 16,
                                       "telemetry": {"enabled": True, "trace_file": ""}},
                               max_slots=2, cache_len=64)
            hub = holder["hub"] = cb._eng.telemetry
            emit = hub.emit

            def journal(kind, payload, **kw):
                events.append((kind, dict(payload)))
                return emit(kind, payload, **kw)

            hub.emit = journal
        else:
            cb = port.build_cb(max_slots=2, cache_len=64)
        s.attach_replica_telemetry(cb, holder["hub"], replica_id)
        return s.ServingEngine(
            cb, clock=clock, recovery=s.RecoveryConfig(backoff_s=0.0), sleep=lambda _s: None,
            engine_factory=lambda mesh_shape=None: port.build_cb(max_slots=2, cache_len=64))

    router = s.FleetRouter(factory, replicas=2, clock=clock)
    assert router.telemetry is holder["hub"]
    rep = router._replicas["r1"].serving
    facade = rep._cb._eng.telemetry
    assert isinstance(facade, s.ReplicaTelemetry) and facade.replica == "r1"
    rep._cb.fault_hook = s.FaultInjector(s.FaultPlan([s.Fault(tick=2, kind="preempt")]))
    old_cb = rep._cb
    adms = [router.submit(p, max_new_tokens=m)
            for p, m in zip(prompts(PROMPT_NS, seed=1), MAX_NEW)]
    n = 0
    while router.has_work():
        assert n < 400, "fleet did not drain"
        router.step()
        clock.advance(0.01)
        n += 1
    assert rep.recovery_stats()["rebuilds"] == 1 and rep._cb is not old_cb
    assert rep._cb._eng.telemetry is facade
    done = {rid: (req.state, [int(t) for t in req.tokens]) for rid, req in router.reap().items()}
    assert done == free and sorted(a.rid for a in adms) == sorted(free)
    kinds = [(k, p.get("event")) for k, p in events]
    at = kinds.index(("serving_fault", "rebuild"))
    after = [p for k, p in events[at:] if k == "inference_request"]
    assert after and {p["replica"] for p in after} <= {"r0", "r1"}
    assert any(p["replica"] == "r1" for p in after), "no tagged event from the rebuilt engine"
    assert all(p["replica"] == "r1" for k, p in events if k == "serving_fault")
    assert all("replica" in p for k, p in events
               if k in ("inference_request", "serving_event", "serving_fault", "span"))
    router.close()


def test_the_rid_partition_reaches_the_sampler_unmasked(params):
    """A request pinned to rid ``3 * RID_STRIDE + 2`` on a replica samples
    the stream a bare engine gives that rid: the rid goes through the
    host's int32 row vector and the keyed sampler without truncation."""
    port = side_of("port", params)
    s = port.serving
    rid = 3 * s.RID_STRIDE + 2
    p = prompts((6,), seed=5)[0]
    bare = port.build_cb(sampled=True, max_slots=2, cache_len=64)
    assert bare.submit(p, max_new_tokens=12, rid=rid) == rid
    while bare.has_work():
        bare.step()
    want = [int(t) for t in bare.result(rid)[p.size:]]
    other = port.build_cb(sampled=True, max_slots=2, cache_len=64)
    other.submit(p, max_new_tokens=12, rid=2)
    while other.has_work():
        other.step()
    assert [int(t) for t in other.result(2)[p.size:]] != want
    router, clock = _fleet(port, n=4, sampled=True)
    for _ in range(3):
        router.kill(f"r{_}")
    adm = router.submit(p, max_new_tokens=12)
    while router.has_work():
        router.step()
        clock.advance(0.01)
    req = router.reap()[adm.rid]
    assert req.state == "finished" and [int(t) for t in req.tokens] != want
    # r3's first natural engine rid is 3 * RID_STRIDE; pin the third one
    entry = {"rid": 0, "engine_rid": rid, "prompt": p.tolist(), "emitted": [],
             "max_new_tokens": 12, "priority": 0, "tenant": "default", "deadline_ms": None,
             "submit_t": clock(), "prefix_id": None}
    rep = router._replicas["r3"].serving
    adm = rep.readmit(entry)
    while rep.has_work():
        rep.step()
    assert [int(t) for t in rep.reap()[adm.rid].tokens] == want
    assert np.iinfo(np.int32).max > rid
    router.close()
