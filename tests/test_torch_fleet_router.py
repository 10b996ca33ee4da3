"""The port's fleet router (``deepspeed_tpu_torch/serving/{router,fleet}.py``)
against the reference's, over the host-only fake engine on a fake clock
(the cases of ``tests/unit/serving/test_router.py``): spillover and shed
hints with backoff, kills with live, queued and pending work with and
without room on the survivors, drain, rolling restart under load, queue
rebalancing, cancel, reap, the health probe and close.

Each case runs one script through both packages (``torch_fleet_common``)
and holds the records equal, exactly: verdicts, fleet rids, states,
``statusz()``, ``tick_stats()``, trace events with their ``replica``
fields, the registry's labelled series, and every stream. Each case also
checks the port's own record against the fake engine's streams, so a
case says what it tests without the reference.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
from torch_fleet_common import (
    assert_same,
    attempt,
    expected,
    hub_record,
    reaped,
    run_both,
    run_fleet,
    snapshot,
    verdict,
)

from deepspeed_tpu_torch.serving.fleet import RID_STRIDE


def _p(n, start=1):
    return np.arange(start, start + n)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def case_single_replica(side):
    """One replica: slot 0 keeps engine-rid base 0, so submission order
    pins rids 0..2, rid for rid a bare serving engine's."""
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=2, telemetry=hub, tag=True)
    ps = [_p(4), _p(5), _p(6)]
    verdicts = [verdict(router.submit(p, max_new_tokens=6)) for p in ps]
    run_fleet(router, clock)
    results = [[int(t) for t in router.result(v[1])] for v in verdicts]
    return {"verdicts": verdicts, "results": results, "snap": snapshot(router),
            "hub": hub_record(hub)}


def check_single_replica(rec):
    for erid, (res, n) in enumerate(zip(rec["results"], (4, 5, 6))):
        assert res[n:] == expected(erid, 6)
    st = rec["snap"]["statusz"]
    assert (st["submitted"], st["admitted"], st["shed"], st["lost"]) == (3, 3, 0, 0)
    tagged = [p for k, p in rec["hub"]["events"] if k == "inference_request"]
    assert tagged and all(p["replica"] == "r0" for p in tagged)


def case_least_loaded(side):
    router, clock = side.make_fleet(2, slots=2)
    verdicts = [verdict(router.submit(_p(4), max_new_tokens=6)) for _ in range(2)]
    return {"verdicts": verdicts, "snap": snapshot(router)}


def check_least_loaded(rec):
    reps = rec["snap"]["statusz"]["replicas"]
    assert reps["r0"]["admitted"] == 1 and reps["r1"]["admitted"] == 1


def case_spillover(side):
    """The least-loaded replica would shed (budget 12 < need 20): the
    verdict spills to its peer."""
    hub = side.hub()
    router, clock = side.make_fleet(2, budgets={"r0": 12, "r1": 1000}, telemetry=hub,
                                    tag=True)
    v = verdict(router.submit(_p(10), max_new_tokens=10))
    run_fleet(router, clock)
    return {"verdicts": [v], "reaped": reaped(router), "snap": snapshot(router),
            "hub": hub_record(hub)}


def check_spillover(rec):
    st = rec["snap"]["statusz"]
    assert st["spillovers"] == 1 and st["replicas"]["r1"]["admitted"] == 1
    events = [p for k, p in rec["hub"]["events"] if k == "router_event"]
    spill = [p for p in events if p["event"] == "spillover"]
    assert spill and (spill[0]["from_replica"], spill[0]["replica"]) == ("r0", "r1")
    assert [p["attempts"] for p in events if p["event"] == "route"] == [2]


def case_shed_hint_backoff(side):
    """A shed verdict's retry hint backs the replica off; the fleet then
    has no one to ask until the hint has passed."""
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=2, kv_budget=30, telemetry=hub, tag=True)
    a = router.submit(_p(5), max_new_tokens=5)
    run_fleet(router, clock)
    result_a = [int(t) for t in router.result(a.rid)]
    hold = router.submit(_p(10), max_new_tokens=10)
    b = router.submit(_p(4), max_new_tokens=8)
    c = router.submit(_p(2), max_new_tokens=2)
    clock.advance(b.retry_after_s + 0.001)
    d = router.submit(_p(2), max_new_tokens=2)
    run_fleet(router, clock)
    return {"verdicts": [verdict(x) for x in (a, hold, b, c, d)], "result_a": result_a,
            "reaped": reaped(router), "snap": snapshot(router), "hub": hub_record(hub)}


def check_shed_hint_backoff(rec):
    a, hold, b, c, d = rec["verdicts"]
    assert a[0] == "admitted" and hold[0] != "shed"
    assert b[0] == "shed" and b[2] == "kv_budget" and b[3] > 0
    assert c[0] == "shed" and c[2] == "no_replicas" and c[3] is not None
    assert d[0] != "shed"


def case_all_dead(side):
    router, clock = side.make_fleet(1)
    router.kill("r0")
    v = verdict(router.submit(_p(3), max_new_tokens=4))
    return {"verdicts": [v], "snap": snapshot(router)}


def check_all_dead(rec):
    assert rec["verdicts"][0] == ("shed", None, "no_replicas", None)
    assert rec["snap"]["health"] == "dead"


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------

def case_kill_running(side):
    """A kill with running streams: r0's stream resumes on r1 under its
    pinned engine rid, bit for bit."""
    hub = side.hub()
    router, clock = side.make_fleet(2, slots=2, telemetry=hub, tag=True)
    a = router.submit(_p(4), max_new_tokens=8)
    b = router.submit(_p(4), max_new_tokens=8)
    for _ in range(3):
        router.step()
        clock.advance(0.01)
    mid = snapshot(router)
    router.kill("r0")
    run_fleet(router, clock)
    return {"verdicts": [verdict(a), verdict(b)], "mid": mid,
            "results": [[int(t) for t in router.result(x.rid)] for x in (a, b)],
            "snap": snapshot(router), "hub": hub_record(hub)}


def check_kill_running(rec):
    assert rec["results"][0][4:] == expected(0, 8)
    assert rec["results"][1][4:] == expected(RID_STRIDE, 8)
    st = rec["snap"]["statusz"]
    assert (st["migrated"], st["lost"], st["replica_deaths"]) == (1, 0, 1)
    assert st["replicas"]["r0"]["state"] == "dead"
    mig = [p for k, p in rec["hub"]["events"]
           if k == "router_event" and p["event"] == "migrated"]
    assert mig and mig[0]["tokens_emitted"] == 3 == mig[0]["gen_base"]
    # the survivor's spans stitch onto the request's trace across replicas
    bridges = [p for k, p in rec["hub"]["events"]
               if k == "span" and p["span"] == "migration"]
    assert bridges and bridges[0]["attrs"]["to_replica"] == "r1"


def case_kill_queued(side):
    """A kill with a running and a queued request and a replica added
    just before: the running one resumes its pinned rid, the queued one
    starts fresh under the new replica's partition."""
    router, clock = side.make_fleet(1, slots=1)
    a = router.submit(_p(3), max_new_tokens=6)
    b = router.submit(_p(3), max_new_tokens=6)
    router.step()
    router.add()
    router.kill("r0")
    run_fleet(router, clock)
    return {"verdicts": [verdict(a), verdict(b)],
            "results": [[int(t) for t in router.result(x.rid)] for x in (a, b)],
            "snap": snapshot(router)}


def check_kill_queued(rec):
    assert rec["results"][0][3:] == expected(0, 6)
    assert rec["results"][1][3:] == expected(RID_STRIDE, 6)
    assert rec["snap"]["statusz"]["migrated"] == 2


def case_kill_pending_no_room(side):
    """A kill where no survivor can ever hold the stream (budget 12 <
    need 20): it is shed honestly, and conservation still holds."""
    hub = side.hub()
    router, clock = side.make_fleet(2, budgets={"r0": 1000, "r1": 12}, telemetry=hub,
                                    tag=True)
    adm = router.submit(_p(10), max_new_tokens=10)
    router.step()
    router.kill("r0")
    return {"verdicts": [verdict(adm)], "reaped": reaped(router), "snap": snapshot(router),
            "hub": hub_record(hub)}


def check_kill_pending_no_room(rec):
    frid = rec["verdicts"][0][1]
    assert rec["reaped"][frid][0] == "shed"
    st = rec["snap"]["statusz"]
    assert (st["lost"], st["migrated"], st["admitted"]) == (1, 0, 1)


def case_kill_with_room_and_backlog(side):
    """A kill under load: running, queued and not-yet-handed-over work on
    the victim, room for some of it on the survivor's queue only."""
    hub = side.hub()
    router, clock = side.make_fleet(2, slots=2, telemetry=hub, tag=True)
    adms = [router.submit(_p(3 + i % 4), max_new_tokens=5 + i % 3) for i in range(9)]
    router.step()
    clock.advance(0.01)
    router.step()
    router.kill("r0")
    run_fleet(router, clock)
    return {"verdicts": [verdict(a) for a in adms], "reaped": reaped(router),
            "snap": snapshot(router), "hub": hub_record(hub)}


def check_kill_with_room_and_backlog(rec):
    st = rec["snap"]["statusz"]
    assert st["migrated"] > 0 and st["lost"] == 0
    assert all(r[0] == "finished" for r in rec["reaped"].values())


def case_step_exception(side):
    router, clock = side.make_fleet(2, slots=2)
    a = router.submit(_p(4), max_new_tokens=6)
    b = router.submit(_p(4), max_new_tokens=6)
    router.step()
    clock.advance(0.01)
    router._replicas["r0"].serving._cb.poison_next_step = True
    router.step()
    state = router._replicas["r0"].state
    run_fleet(router, clock)
    return {"state": state, "verdicts": [verdict(a), verdict(b)],
            "results": [[int(t) for t in router.result(x.rid)] for x in (a, b)],
            "snap": snapshot(router)}


def check_step_exception(rec):
    assert rec["state"] == "dead"
    assert rec["results"][0][4:] == expected(0, 6)
    assert rec["results"][1][4:] == expected(RID_STRIDE, 6)


def case_stream_survives_migration(side):
    router, clock = side.make_fleet(2, slots=2)
    a = router.submit(_p(4), max_new_tokens=8)
    router.at_tick(4, lambda rt: rt.kill("r0"))
    toks = list(router.stream(a.rid))
    return {"tokens": toks, "snap": snapshot(router)}


def check_stream_survives_migration(rec):
    assert rec["tokens"] == expected(0, 8)
    assert rec["snap"]["statusz"]["replicas"]["r0"]["state"] == "dead"


# ---------------------------------------------------------------------------
# the health ladder
# ---------------------------------------------------------------------------

def case_probe_recovering(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, telemetry=hub)
    rep = router._replicas["r0"]
    rep.serving._breaker_open = True
    router.probe()
    states = [rep.state]
    verdicts = [verdict(router.submit(_p(3), max_new_tokens=4)) for _ in range(2)]
    rep.serving._breaker_open = False
    router.probe()
    states.append(rep.state)
    run_fleet(router, clock)
    return {"states": states, "verdicts": verdicts, "reaped": reaped(router),
            "snap": snapshot(router), "hub": hub_record(hub)}


def check_probe_recovering(rec):
    assert rec["states"] == ["recovering", "healthy"]
    assert rec["snap"]["statusz"]["replicas"]["r1"]["admitted"] == 2


def case_probe_poisoned(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, telemetry=hub, tag=True)
    a = router.submit(_p(4), max_new_tokens=6)
    router.step()
    clock.advance(0.01)
    router._replicas["r0"].serving._cb.poisoned = True
    router.probe()
    states = [router._replicas["r0"].state]
    router.step()
    states.append(router._replicas["r0"].state)
    run_fleet(router, clock)
    return {"states": states, "result": [int(t) for t in router.result(a.rid)],
            "snap": snapshot(router), "hub": hub_record(hub)}


def check_probe_poisoned(rec):
    assert rec["states"] == ["failed", "dead"]
    assert rec["result"][4:] == expected(0, 6)


def case_health_words(side):
    router, clock = side.make_fleet(2)
    words = [router.health()]
    router.drain("r0")
    words.append(router.health())
    router.drain("r1")
    words.append(router.health())
    router.step()
    words.append(router.health())
    return {"words": words, "snap": snapshot(router)}


def check_health_words(rec):
    assert rec["words"] == ["ok", "ok", "draining", "dead"]


def case_probe_thread(side):
    """The daemon probe runs ``probe()`` beside the main thread's ticks;
    what the fleet serves does not depend on it."""
    router, clock = side.make_fleet(2, slots=2)
    t = router.start_probe(interval_s=0.001)
    same = router.start_probe() is t
    adms = [router.submit(_p(4), max_new_tokens=6) for _ in range(4)]
    for _ in range(5):
        router.step()
        clock.advance(0.01)
        time.sleep(0.002)
    run_fleet(router, clock)
    router.stop_probe()
    stopped = router._probe_thread is None
    out = {"same": same, "stopped": stopped, "verdicts": [verdict(a) for a in adms],
           "reaped": reaped(router), "snap": snapshot(router)}
    router.close()
    return out


def check_probe_thread(rec):
    assert rec["same"] and rec["stopped"]
    assert all(r[0] == "finished" for r in rec["reaped"].values())


# ---------------------------------------------------------------------------
# drain and rolling restart
# ---------------------------------------------------------------------------

def case_drain(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, slots=2, telemetry=hub, tag=True)
    a = router.submit(_p(4), max_new_tokens=6)
    router.drain("r0")
    draining = router.statusz()["replicas"]["r0"]["statusz"]
    b = router.submit(_p(4), max_new_tokens=6)
    run_fleet(router, clock)
    return {"draining": draining, "verdicts": [verdict(a), verdict(b)],
            "results": [[int(t) for t in router.result(x.rid)] for x in (a, b)],
            "snap": snapshot(router), "hub": hub_record(hub)}


def check_drain(rec):
    d = rec["draining"]
    assert d["draining"] is True and d["residue_running"] == 1 and d["residue_tokens"] == 6
    assert rec["snap"]["statusz"]["replicas"]["r0"]["state"] == "drained"
    assert rec["results"][0][4:] == expected(0, 6)
    assert rec["results"][1][4:] == expected(RID_STRIDE, 6)
    assert rec["snap"]["statusz"]["lost"] == 0


def case_rolling_restart(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, slots=2, telemetry=hub, tag=True)
    adms = [router.submit(_p(5), max_new_tokens=6) for _ in range(4)]
    router.rolling_restart()
    mid = {}
    router.at_tick(3, lambda rt: mid.setdefault("adm", rt.submit(_p(5), max_new_tokens=4)))
    run_fleet(router, clock, until=lambda: router._rolling is None)
    return {"verdicts": [verdict(a) for a in adms + [mid["adm"]]],
            "results": [[int(t) for t in router.result(x.rid)] for x in adms + [mid["adm"]]],
            "snap": snapshot(router), "hub": hub_record(hub)}


def check_rolling_restart(rec):
    assert [len(r) for r in rec["results"]] == [11] * 4 + [9]
    st = rec["snap"]["statusz"]
    assert st["lost"] == 0 and st["replica_deaths"] == 0
    assert {r: i["state"] for r, i in st["replicas"].items()} == {
        "r0": "drained", "r1": "drained", "r2": "healthy", "r3": "healthy"}


# ---------------------------------------------------------------------------
# the request surface
# ---------------------------------------------------------------------------

def case_cancel_and_errors(side):
    router, clock = side.make_fleet(1, slots=1)
    a = router.submit(_p(3), max_new_tokens=4)
    b = router.submit(_p(3), max_new_tokens=4)
    cancels = [router.cancel(b.rid), router.cancel(b.rid), router.cancel(12345)]
    run_fleet(router, clock)
    out = reaped(router)
    return {"verdicts": [verdict(a), verdict(b)], "cancels": cancels, "reaped": out,
            "result_after_reap": attempt(router.result, a.rid),
            "stream_unknown": attempt(router.stream, 99999), "snap": snapshot(router)}


def check_cancel_and_errors(rec):
    (_, a, _, _), (_, b, _, _) = rec["verdicts"]
    assert rec["cancels"] == [True, False, False]
    assert rec["reaped"][b][0] == "cancelled" and rec["reaped"][a][0] == "finished"
    assert rec["result_after_reap"][:2] == ("raises", "KeyError")
    assert rec["stream_unknown"][:2] == ("raises", "KeyError")


def case_aggregates(side):
    router, clock = side.make_fleet(2, slots=2)
    a = router.submit(_p(4), max_new_tokens=6)
    before = {"vocab": router.vocab_size, "committed": router.committed_tokens()}
    run_fleet(router, clock)
    return {"before": before, "snap": snapshot(router),
            "result": [int(t) for t in router.result(a.rid)],
            "engines": [r for r, _ in router.steppable_engines()]}


def check_aggregates(rec):
    assert rec["before"] == {"vocab": 997, "committed": 10}
    ts = rec["snap"]["tick_stats"]
    assert ts["ticks"] > 0 and ts["tokens"] == 6 and 0.0 <= ts["utilization"] <= 1.0
    assert rec["snap"]["recovery"]["fleet_migrated"] == 0


def case_counters_and_close(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, telemetry=hub, tag=True)
    a = router.submit(_p(4), max_new_tokens=4)
    run_fleet(router, clock)
    result = [int(t) for t in router.result(a.rid)]
    router.kill("r1")
    router.close()
    closed_once = hub.closed
    router.close()
    return {"result": result, "closed": (closed_once, hub.closed), "snap": snapshot(router),
            "hub": hub_record(hub)}


def check_counters_and_close(rec):
    c = rec["hub"]["registry"]["counters"]
    assert c["fleet_submitted_total"] == 1 and c["fleet_admitted_total"] == 1
    assert c["fleet_replica_deaths_total"] == 1
    assert "fleet_replicas" in rec["hub"]["registry"]["gauges"]
    # the replicas' series in the shared registry carry their replica label
    assert any("replica=r0" in k for k in c)
    assert rec["closed"] == (1, 1)


# ---------------------------------------------------------------------------
# scale-in candidates and queue rebalancing
# ---------------------------------------------------------------------------

def case_scale_in_candidates(side):
    out = {}
    router, _ = side.make_fleet(1)
    out["last"] = router.scale_in_candidate()
    router, clock = side.make_fleet(2)
    router.submit(_p(3), max_new_tokens=20)
    router.step()
    out["emptiest"] = router.scale_in_candidate()
    run_fleet(router, clock)
    router.reap()
    out["tie"] = router.scale_in_candidate()
    router, _ = side.make_fleet(2)
    router.drain("r0")
    out["non_healthy"] = router.scale_in_candidate()
    router, clock = side.make_fleet(3)
    router.submit(_p(3), max_new_tokens=30)
    router.step()
    router.submit(_p(3), max_new_tokens=10)
    router.step()
    engines = dict(router.steppable_engines())
    engines["r0"]._breaker_open = True
    out["residue"] = router.scale_in_candidate()
    for eng in engines.values():
        eng._breaker_open = True
    router.submit(_p(3), max_new_tokens=10)
    router.step()
    out["all_residue"] = router.scale_in_candidate()
    out["snap"] = snapshot(router)
    return out


def check_scale_in_candidates(rec):
    assert (rec["last"], rec["emptiest"], rec["tie"], rec["non_healthy"], rec["residue"],
            rec["all_residue"]) == (None, "r1", "r0", None, "r2", None)


def case_rebalance(side):
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=2, telemetry=hub, tag=True)
    adms = [router.submit(_p(4), max_new_tokens=8) for _ in range(8)]
    router.add()
    moved = router.rebalance_queued()
    depths = sorted(eng.statusz()["queue_depth"] for _, eng in router.steppable_engines())
    run_fleet(router, clock)
    return {"verdicts": [verdict(a) for a in adms], "moved": moved, "depths": depths,
            "reaped": reaped(router), "snap": snapshot(router), "hub": hub_record(hub)}


def check_rebalance(rec):
    assert rec["moved"] >= 3 and rec["depths"][-1] - rec["depths"][0] <= 1
    assert rec["snap"]["statusz"]["migrated"] == 0 and rec["snap"]["statusz"]["lost"] == 0
    assert rec["hub"]["registry"]["counters"]["fleet_rebalanced_total"] == rec["moved"]
    assert all(r[0] == "finished" and len(r[1]) == 8 for r in rec["reaped"].values())


def case_rebalance_refused_and_capped(side):
    out = {}
    hub = side.hub()
    router, _ = side.make_fleet(2, telemetry=hub)
    out["balanced"] = router.rebalance_queued()
    router, _ = side.make_fleet(1, slots=1)
    for _ in range(4):
        router.submit(_p(3), max_new_tokens=6)
    out["single"] = router.rebalance_queued()
    router, clock = side.make_fleet(1, slots=1)
    adms = [router.submit(_p(3), max_new_tokens=6) for _ in range(5)]
    router.add()
    engines = dict(router.steppable_engines())
    engines["r1"]._breaker_open = True
    out["refused"] = router.rebalance_queued()
    engines["r1"]._breaker_open = False
    run_fleet(router, clock)
    out["refused_reaped"] = reaped(router)
    out["refused_verdicts"] = [verdict(a) for a in adms]
    router, _ = side.make_fleet(1, slots=1)
    for _ in range(9):
        router.submit(_p(3), max_new_tokens=6)
    router.add()
    out["capped"] = router.rebalance_queued(max_moves=2)
    out["snap"] = snapshot(router)
    out["hub"] = hub_record(hub)
    return out


def check_rebalance_refused_and_capped(rec):
    assert (rec["balanced"], rec["single"], rec["refused"], rec["capped"]) == (0, 0, 0, 2)
    assert all(r[0] == "finished" for r in rec["refused_reaped"].values())
    assert len(rec["refused_reaped"]) == 5


# ---------------------------------------------------------------------------
# replica telemetry and the ops server
# ---------------------------------------------------------------------------

def case_replica_telemetry(side):
    base = side.registry.MetricsRegistry()
    scoped = side.fleet.ScopedRegistry(base, "r3")
    scoped.counter("serve_finished_total").inc()
    scoped.gauge("serve_queue_depth", {"pool": "a"}).set(2)
    hub = side.hub()
    tele = side.fleet.ReplicaTelemetry(hub, "r1")
    tele.emit("serving_event", {"event": "shed", "reason": "kv_budget"})
    tele.close()
    return {"scoped": base.dump(), "enabled": tele.enabled, "hub": hub_record(hub),
            "stride": side.fleet.RID_STRIDE,
            "states": [side.fleet.HEALTHY, side.fleet.RECOVERING, side.fleet.DRAINING,
                       side.fleet.FAILED, side.fleet.DEAD, side.fleet.DRAINED,
                       side.fleet.PLACEABLE, side.fleet.STEPPABLE]}


def check_replica_telemetry(rec):
    assert rec["scoped"]["counters"]["serve_finished_total{replica=r3}"] == 1
    assert rec["hub"]["events"] == [("serving_event", {"event": "shed", "reason": "kv_budget",
                                                       "replica": "r1"})]
    assert rec["hub"]["closed"] == 0 and rec["stride"] == 1 << 20


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode()


def case_ops_server(side):
    """The fleet's ``/healthz``, ``/statusz`` and ``/metrics`` over the
    shared registry, scraped mid-run."""
    hub = side.hub()
    router, clock = side.make_fleet(2, slots=2, telemetry=hub, tag=True)
    ops = router.start_ops_server(port=0)
    same = router.start_ops_server() is ops
    adms = [router.submit(_p(4), max_new_tokens=6) for _ in range(3)]
    router.step()
    health = _get(ops.url + "/healthz")
    status = _get(ops.url + "/statusz")
    metrics = _get(ops.url + "/metrics")
    run_fleet(router, clock)
    router.close()
    return {"same": same, "verdicts": [verdict(a) for a in adms],
            "health": (health[0], json.loads(health[1])),
            "status": (status[0], json.loads(status[1])),
            "metrics": (metrics[0], sorted(line for line in metrics[1].splitlines()
                                           if line.startswith("fleet_"))),
            "reaped": reaped(router)}


def check_ops_server(rec):
    assert rec["same"]
    assert rec["health"][0] == 200 and rec["status"][1]["placeable"] == 2
    assert any(line.startswith("fleet_admitted_total") for line in rec["metrics"][1])


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_case_matches_the_reference(case):
    rec = run_both(CASES[case])
    globals()["check_" + case](rec["port"])
    assert_same(rec)
