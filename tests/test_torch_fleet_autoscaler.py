"""The port's fleet autoscaler (``deepspeed_tpu_torch/serving/autoscaler.py``)
against the reference's, over the host-only fake engine on a fake clock
(the cases of ``tests/unit/serving/test_autoscaler.py``): scale-out on
queue pressure with the backlog rebalanced, the replica bounds, scale-in
on sustained calm and its refusal of a sole residue holder, the degrade
ladder's entry and exit, the cooldown under a sawtooth, and ``stats()``.

The same load script runs through both packages and the records are held
equal, exactly: the per-tick trajectory (placeable replicas, degrade
level, the router's degrade knobs, every replica's kv budget), the
``fleet_scale`` and router events, the registry, ``stats()`` and every
stream (``torch_fleet_common``).
"""

import pytest
from torch_fleet_common import (
    assert_same,
    attempt,
    hub_record,
    reaped,
    run_both,
    snapshot,
    verdict,
)


def _submit_burst(router, n, max_new=12, prompt=4, deadline_ms=None):
    return [verdict(router.submit(list(range(prompt)), max_new_tokens=max_new,
                                  deadline_ms=deadline_ms)) for _ in range(n)]


def _trajectory(router, clock, scaler, n, dt=0.05, burst=None):
    """Step ``n`` ticks, recording after each the fleet's shape and the
    autoscaler's actuators; ``burst(i)`` submits before tick ``i``."""
    out = []
    for i in range(n):
        if burst is not None:
            burst(i)
        router.step()
        clock.advance(dt)
        st = router.statusz()
        out.append((st["placeable"], scaler.degrade_level if scaler else None,
                    router.cap_new_tokens_no_slo, router.shed_backfill,
                    sorted((r, e.kv_budget_tokens) for r, e in router.steppable_engines())))
    return out


def _record(router, scaler, hub, traj, **extra):
    out = {"traj": traj, "stats": scaler.stats() if scaler else None,
           "snap": snapshot(router), "reaped": reaped(router), "hub": hub_record(hub)}
    out.update(extra)
    return out


def _scaler(side, router, clock, **cfg):
    return side.autoscaler.FleetAutoscaler(router, side.autoscaler.AutoscalerConfig(**cfg),
                                           clock=clock)


def case_queue_pressure_scales_out(side):
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=2, telemetry=hub, tag=True)
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=3, cooldown_s=0.1)
    verdicts = _submit_burst(router, 8)
    traj = _trajectory(router, clock, scaler, 60)
    return _record(router, scaler, hub, traj, verdicts=verdicts)


def check_queue_pressure_scales_out(rec):
    ups = [p for k, p in rec["hub"]["events"] if k == "fleet_scale" and p["event"] == "scale_up"]
    assert ups and ups[0]["replicas"] == 2 and ups[0]["queue_depth"] >= 4
    assert ups[0]["rebalanced"] >= 1
    assert rec["traj"][1][0] == 2
    assert rec["stats"]["scale_ups"] == rec["hub"]["registry"]["counters"]["fleet_scale_up_total"]
    assert all(r[0] == "finished" for r in rec["reaped"].values())


def case_bounds(side):
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=1, telemetry=hub)
    scaler = _scaler(side, router, clock, max_replicas=2, cooldown_s=0.0)
    verdicts = _submit_burst(router, 12, max_new=20)
    up = _trajectory(router, clock, scaler, 30)
    hub2 = side.hub()
    router2, clock2 = side.make_fleet(2, telemetry=hub2)
    scaler2 = _scaler(side, router2, clock2, min_replicas=2, max_replicas=4, cooldown_s=0.0,
                      down_stable_ticks=2)
    down = _trajectory(router2, clock2, scaler2, 40)
    return _record(router, scaler, hub, up, verdicts=verdicts, down=down,
                   stats2=scaler2.stats(), hub2=hub_record(hub2))


def check_bounds(rec):
    assert max(t[0] for t in rec["traj"]) <= 2
    assert all(t[0] == 2 for t in rec["down"])


def case_config_marker(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, telemetry=hub)
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=4, cooldown_s=1.5)
    return _record(router, scaler, hub, [])


def check_config_marker(rec):
    assert [p for k, p in rec["hub"]["events"] if k == "fleet_scale"] == [
        {"event": "autoscaler", "min_replicas": 1, "max_replicas": 4, "cooldown_s": 1.5,
         "replicas": 2}]


def case_calm_drains_to_min(side):
    hub = side.hub()
    router, clock = side.make_fleet(3, telemetry=hub, tag=True)
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=3, cooldown_s=0.2,
                     down_stable_ticks=4)
    traj = _trajectory(router, clock, scaler, 60)
    return _record(router, scaler, hub, traj)


def check_calm_drains_to_min(rec):
    assert rec["traj"][-1][0] == 1 and rec["stats"]["scale_downs"] == 2
    downs = [p["replicas"] for k, p in rec["hub"]["events"]
             if k == "fleet_scale" and p["event"] == "scale_down"]
    assert downs == [2, 1] and rec["snap"]["statusz"]["lost"] == 0


def case_residue_refusal(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, telemetry=hub, tag=True)
    verdicts = _submit_burst(router, 4, max_new=30)
    pre = _trajectory(router, clock, None, 2)
    for _rid, eng in router.steppable_engines():
        eng._breaker_open = True
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=2, cooldown_s=0.0,
                     down_stable_ticks=1, down_occupancy=1.0)
    traj = _trajectory(router, clock, scaler, 41)
    return _record(router, scaler, hub, pre + traj, verdicts=verdicts)


def check_residue_refusal(rec):
    assert not [p for k, p in rec["hub"]["events"]
                if k == "fleet_scale" and p["event"] == "scale_down"]


def _capped(side, kv_budget=120):
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=1, kv_budget=kv_budget, telemetry=hub, tag=True)
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=1, cooldown_s=0.1,
                     down_stable_ticks=2, degrade_kv_frac=0.5, degrade_new_tokens_cap=4)
    return router, clock, scaler, hub


def case_degrade_ladder(side):
    router, clock, scaler, hub = _capped(side)
    verdicts = _submit_burst(router, 10, max_new=25)
    traj = _trajectory(router, clock, scaler, 40)
    backfill = verdict(router.submit([1, 2, 3], max_new_tokens=8))
    interactive = verdict(router.submit([1, 2, 3], max_new_tokens=8, deadline_ms=500.0))
    traj += _trajectory(router, clock, scaler, 120)
    return _record(router, scaler, hub, traj, verdicts=verdicts + [backfill, interactive])


def check_degrade_ladder(rec):
    steps = [(p["from_level"], p["to_level"]) for k, p in rec["hub"]["events"]
             if k == "fleet_scale" and p["event"] == "degrade"]
    assert steps == [(0, 1), (1, 2), (2, 3), (3, 2), (2, 1), (1, 0)]
    assert rec["traj"][39][1:4] == (3, 4, True)
    assert rec["traj"][39][4] == [("r0", 60)]
    assert rec["verdicts"][-2][2] == "degraded_backfill"
    assert rec["verdicts"][-1][2] != "degraded_backfill"
    assert rec["traj"][-1][1:] == (0, None, False, [("r0", 120)])
    assert rec["hub"]["registry"]["gauges"]["fleet_degrade_level"] == 0


def case_new_token_cap(side):
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=2, telemetry=hub)
    router.cap_new_tokens_no_slo = 4
    a = verdict(router.submit([1, 2], max_new_tokens=20))
    b = verdict(router.submit([1, 2], max_new_tokens=20, deadline_ms=1e6))
    traj = _trajectory(router, clock, None, 25, dt=0.01)
    return _record(router, None, hub, traj, verdicts=[a, b])


def check_new_token_cap(rec):
    (_, a, _, _), (_, b, _, _) = rec["verdicts"]
    assert len(rec["reaped"][a][1]) == 4 and len(rec["reaped"][b][1]) == 20


def case_replica_added_mid_degrade(side):
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=1, kv_budget=100, telemetry=hub)
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=1, cooldown_s=0.0,
                     degrade_kv_frac=0.5)
    verdicts = _submit_burst(router, 8, max_new=25)
    traj = _trajectory(router, clock, scaler, 4)
    router.add()
    traj += _trajectory(router, clock, scaler, 1)
    return _record(router, scaler, hub, traj, verdicts=verdicts)


def check_replica_added_mid_degrade(rec):
    assert dict(rec["traj"][-1][4])["r1"] == 50


def case_sawtooth_cooldown(side):
    hub = side.hub()
    router, clock = side.make_fleet(1, slots=1, telemetry=hub, tag=True)
    decisions = []
    emit = hub.emit

    def journal(kind, payload, **kw):
        if kind == "fleet_scale" and payload.get("event") in (
                "scale_up", "scale_down", "scale_down_skipped", "degrade"):
            decisions.append(clock.t)
        emit(kind, payload, **kw)

    hub.emit = journal
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=4, cooldown_s=1.0,
                     down_stable_ticks=2)
    verdicts = []
    traj = _trajectory(router, clock, scaler, 200, burst=lambda i: verdicts.extend(
        _submit_burst(router, 6, max_new=6)) if i % 4 == 0 else None)
    return _record(router, scaler, hub, traj, verdicts=verdicts, decisions=decisions)


def check_sawtooth_cooldown(rec):
    t = rec["decisions"]
    assert t and all(b - a >= 1.0 - 1e-9 for a, b in zip(t, t[1:]))


def case_scale_down_needs_calm(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, kv_budget=60, telemetry=hub)
    scaler = _scaler(side, router, clock, min_replicas=1, max_replicas=2, cooldown_s=0.0,
                     down_stable_ticks=10)
    verdicts, traj = [], []
    for _ in range(3):
        traj += _trajectory(router, clock, scaler, 6)
        verdicts += _submit_burst(router, 6, max_new=6, prompt=3)
        traj += _trajectory(router, clock, scaler, 6)
    downs_before = len([p for k, p in hub.events
                        if k == "fleet_scale" and p["event"] == "scale_down"])
    traj += _trajectory(router, clock, scaler, 14)
    return _record(router, scaler, hub, traj, verdicts=verdicts, downs_before=downs_before)


def check_scale_down_needs_calm(rec):
    assert rec["downs_before"] == 0
    assert [p for k, p in rec["hub"]["events"] if k == "fleet_scale" and p["event"] == "scale_down"]


def case_stats_and_config_errors(side):
    hub = side.hub()
    router, clock = side.make_fleet(2, telemetry=hub)
    scaler = _scaler(side, router, clock, cooldown_s=0.2, down_stable_ticks=2)
    traj = _trajectory(router, clock, scaler, 30)
    cfg = side.autoscaler.AutoscalerConfig
    errors = [attempt(cfg, **kw) for kw in (
        dict(min_replicas=0), dict(min_replicas=3, max_replicas=2), dict(cooldown_s=-1.0),
        dict(degrade_kv_frac=0.0), dict(max_degrade_level=4))]
    return _record(router, scaler, hub, traj, errors=errors)


def check_stats_and_config_errors(rec):
    assert set(rec["stats"]) == {"scale_ups", "scale_downs", "scale_down_skips",
                                 "degrade_level", "mean_replicas"}
    assert 1.0 <= rec["stats"]["mean_replicas"] <= 2.0
    assert all(e[:2] == ("raises", "ValueError") for e in rec["errors"])


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_autoscaler_case_matches_the_reference(case):
    rec = run_both(CASES[case])
    globals()["check_" + case](rec["port"])
    assert_same(rec)
