"""Shared harness of the fleet parity tests over the fake engine
(``tests/test_torch_fleet_router.py``, ``test_torch_fleet_autoscaler.py``):
the reference's ``FleetRouter`` over its ``ServingEngine`` replicas and the
port's over the port's, each replica over the host-only
``tests/unit/serving/fake_engine.py`` engine, whose token ``i`` of engine
rid ``r`` is a pure function of ``(r, i)``, and each side on its own
``FakeClock``, started at 100 s as ``tests/unit/serving/test_router.py``'s.

A scenario is a function ``scenario(side) -> record`` run once per side;
``run_both`` runs it through both packages and ``assert_same`` holds the
two records equal, exactly. Records are plain data: admission verdicts,
fleet rids, states, ``statusz()``, ``tick_stats()``, ``recovery_stats()``,
the trace events every hub saw (router events, and the replicas' own
events with their ``replica`` tags), the registries' labelled series, and
every stream. Span ids carry a process-wide scope counter, so ``canon``
renames them in order of first appearance before the comparison.
"""

import os
import re
import sys
import types

import numpy as np

import deepspeed_tpu.serving as jserving
import deepspeed_tpu.serving.autoscaler as jautoscaler
import deepspeed_tpu.serving.fleet as jfleet
import deepspeed_tpu.serving.router as jrouter
import deepspeed_tpu.telemetry.registry as jregistry
import deepspeed_tpu_torch.serving as tserving
import deepspeed_tpu_torch.serving.autoscaler as tautoscaler
import deepspeed_tpu_torch.serving.fleet as tfleet
import deepspeed_tpu_torch.serving.router as trouter
import deepspeed_tpu_torch.telemetry.registry as tregistry

from torch_serving_common import FakeClock

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "unit", "serving"))
from fake_engine import FakeEngine, fake_token  # noqa: E402

VOCAB = 997
_MODULES = {
    "ref": dict(serving=jserving, fleet=jfleet, router=jrouter, autoscaler=jautoscaler,
                registry=jregistry),
    "port": dict(serving=tserving, fleet=tfleet, router=trouter, autoscaler=tautoscaler,
                 registry=tregistry),
}


class HubStub:
    """An enabled telemetry hub that keeps every event and owns one registry
    of its side's ``MetricsRegistry``."""

    def __init__(self, registry_cls):
        self.enabled = True
        self.registry = registry_cls()
        self.events = []
        self.closed = 0

    def emit(self, kind, payload, **kw):
        self.events.append((kind, dict(payload)))

    def close(self):
        self.closed += 1

    def of_kind(self, kind, event=None):
        return [p for k, p in self.events
                if k == kind and (event is None or p.get("event") == event)]


def expected(erid: int, n: int, start: int = 0) -> list:
    """The fake engine's stream of engine rid ``erid``."""
    return [fake_token(erid, i, VOCAB) for i in range(start, start + n)]


def side_of(name: str) -> types.SimpleNamespace:
    """The namespace a scenario gets: the side's modules, ``hub()`` and
    ``make_fleet(...) -> (router, clock)``."""
    mods = _MODULES[name]
    ns = types.SimpleNamespace(name=name, **mods)
    ns.hub = lambda: HubStub(mods["registry"].MetricsRegistry)

    def make_fleet(n=2, *, clock=None, slots=2, kv_budget=None, budgets=None,
                   cache_len=64, telemetry=None, tag=False):
        """``n`` replicas over fake engines. ``budgets`` maps replica ids
        to kv budgets; ``tag`` attaches every replica to ``telemetry``
        through the fleet's facade, so the replicas' own events land in
        the same hub with their ``replica`` tag."""
        clock = clock or FakeClock(100.0)

        def factory(replica_id):
            kw = {}
            budget = (budgets or {}).get(replica_id, kv_budget)
            if budget is not None:
                kw["kv_budget_tokens"] = budget
            eng = FakeEngine(vocab_size=VOCAB, cache_len=cache_len, slots=slots, clock=clock)
            if tag:
                mods["fleet"].attach_replica_telemetry(eng, telemetry, replica_id)
            return mods["serving"].ServingEngine(eng, clock=clock, **kw)

        router = mods["router"].FleetRouter(factory, replicas=n, clock=clock,
                                            telemetry=telemetry)
        return router, clock

    ns.make_fleet = make_fleet
    return ns


def run_fleet(router, clock, max_ticks=300, dt=0.01, until=None) -> int:
    n = 0
    while router.has_work() or (until is not None and not until()):
        assert n < max_ticks, "fleet did not converge"
        router.step()
        clock.advance(dt)
        n += 1
    return n


def tick(router, clock, n=1, dt=0.05):
    for _ in range(n):
        router.step()
        clock.advance(dt)


def verdict(adm) -> tuple:
    return (adm.status, adm.rid, adm.reason, adm.retry_after_s)


def attempt(fn, *args, **kw):
    """``fn``'s result, or ``("raises", type, message)``."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the exception is the record
        return ("raises", type(e).__name__, str(e))


def reaped(router) -> dict:
    """{fleet rid: (state, tokens, result)} of every terminal request."""
    return {frid: (req.state, [int(t) for t in req.tokens],
                   None if req.result is None else [int(t) for t in req.result])
            for frid, req in router.reap().items()}


def snapshot(router) -> dict:
    return {"health": router.health(), "statusz": router.statusz(),
            "tick_stats": router.tick_stats(), "recovery": router.recovery_stats()}


def hub_record(hub) -> dict:
    return {"events": hub.events, "registry": hub.registry.dump(), "closed": hub.closed}


_SPAN_ID = re.compile(r"^s\d+-\d+$")


def canon(obj):
    """Plain data with numpy scalars/arrays as Python values and span ids
    renamed in order of first appearance."""
    ids = {}

    def fix(v):
        if isinstance(v, str) and _SPAN_ID.match(v):
            return ids.setdefault(v, f"span{len(ids)}")
        if isinstance(v, dict):
            return {fix(k): fix(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(fix(x) for x in v)
        if isinstance(v, np.ndarray):
            return [fix(x) for x in v.tolist()]
        if isinstance(v, np.generic):
            return v.item()
        return v

    return fix(obj)


def run_both(scenario) -> dict:
    return {name: canon(scenario(side_of(name))) for name in ("ref", "port")}


def assert_same(rec: dict):
    """The port's record equals the reference's, key by key (so a failure
    names the first key that differs)."""
    ref, port = rec["ref"], rec["port"]
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key] == ref[key], key
