"""Fleet autoscaler: the closed loop that keeps SLOs under sustained
overload (counterpart of ``deepspeed_tpu/serving/autoscaler.py``).

A :class:`FleetAutoscaler` attaches to a :class:`FleetRouter` via
``router.on_step`` and, once per fleet tick, reads the router's own
health-plane signals — queue depth, recent shed count, committed-token
occupancy against the KV budgets, breaker state — and drives exactly one
of three actuators:

- **scale out** through the replica factory (``router.add()``:
  add-then-warm, the same primitive rolling restart uses), never above
  ``max_replicas``;
- **scale in** through graceful drain (``router.drain()``), never below
  ``min_replicas``, and only on the replica the residue-aware
  ``router.scale_in_candidate()`` deems safe — a replica holding the
  only copy of a recovering request's RecoveryLog residue is never
  picked;
- when scale-out is capped, the **degradation ladder**: (1) tighten
  every replica's admission ``kv_budget_tokens``, (2) cap
  ``max_new_tokens`` for no-SLO tenants, (3) shed batch backfill before
  interactive. Entry and exit walk the same rungs in opposite order, so
  recovery is symmetric.

Hysteresis is structural, not tuned: every decision (including a
skipped scale-in) starts a ``cooldown_s`` window in which no further
decision fires, and scale-in/undegrade additionally require
``down_stable_ticks`` consecutive underloaded ticks — a diurnal curve
breathes 1→4→1 without thrash, a sawtooth gets at most one decision per
cooldown window (tests/test_torch_fleet_autoscaler.py holds these
decisions equal to the reference's on the same load script).

Every transition is journaled as a ``fleet_scale`` trace event plus counters/gauges: ``fleet_scale_up_total``,
``fleet_scale_down_total``, ``fleet_degrade_level`` alongside the
router's ``fleet_replicas``. Standard library only, like everything
else at this layer.
"""

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class AutoscalerConfig:
    """Policy knobs. The defaults suit the loadgen scenarios: scale out
    eagerly (queue or shed pressure), scale in lazily (sustained calm)."""

    min_replicas: int = 1
    max_replicas: int = 4
    cooldown_s: float = 2.0          # min wall-clock between decisions
    up_queue_depth: float = 4.0      # avg queued reqs/replica => overload
    up_occupancy: float = 0.85       # committed/budget => overload
    up_shed: int = 1                 # sheds in window => overload
    down_occupancy: float = 0.30     # occupancy below => underload
    down_stable_ticks: int = 8       # consecutive calm ticks before down
    shed_window_ticks: int = 16      # window for "recent" sheds
    degrade_kv_frac: float = 0.5     # rung 1: budget tightening factor
    degrade_new_tokens_cap: int = 16  # rung 2: no-SLO output cap
    max_degrade_level: int = 3

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if not 0 < self.degrade_kv_frac <= 1:
            raise ValueError("degrade_kv_frac must be in (0, 1]")
        if not 0 <= self.max_degrade_level <= 3:
            raise ValueError("max_degrade_level must be in [0, 3]")


class FleetAutoscaler:
    """The policy loop. Construct it over a live router and it runs
    itself from ``router.step()`` — no thread, no timer: decisions land
    on the main thread where the trace writer lives."""

    def __init__(self, router, config: Optional[AutoscalerConfig] = None,
                 *, clock=None):
        self._router = router
        self.config = config or AutoscalerConfig()
        self._clock = clock if clock is not None else time.monotonic
        self._last_decision_t = float("-inf")
        self._down_streak = 0
        self._shed_hist = deque()        # (tick, cumulative fleet sheds)
        self._orig_kv: Dict[str, Optional[int]] = {}
        self.degrade_level = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_down_skips = 0
        self._ticks = 0
        self._replica_ticks = 0
        router.on_step(self._on_step)
        self._gauge("fleet_degrade_level", 0)
        self._emit({"event": "autoscaler",
                    "min_replicas": self.config.min_replicas,
                    "max_replicas": self.config.max_replicas,
                    "cooldown_s": self.config.cooldown_s,
                    "replicas": router.statusz()["placeable"]})

    # -- the policy tick ------------------------------------------------
    def _on_step(self, router):
        cfg = self.config
        st = router.statusz()
        tick = int(st["tick"])
        placeable = int(st["placeable"])
        self._ticks += 1
        self._replica_ticks += placeable

        queue_total, committed, budget, breakers = 0, 0, 0, 0
        for info in st["replicas"].values():
            es = info.get("statusz")
            if not es:
                continue
            queue_total += int(es.get("queue_depth", 0))
            committed += int(es.get("committed_kv_tokens", 0))
            b = es.get("kv_budget_tokens")
            if b:
                budget += int(b)
            breakers += 1 if es.get("breaker_open") else 0
        occupancy = committed / budget if budget else 0.0
        avg_queue = queue_total / max(1, placeable)

        self._shed_hist.append((tick, int(st["shed"])))
        while (len(self._shed_hist) > 1
               and self._shed_hist[0][0] < tick - cfg.shed_window_ticks):
            self._shed_hist.popleft()
        shed_recent = int(st["shed"]) - self._shed_hist[0][1]

        if self.degrade_level >= 1:
            self._tighten_budgets(router)  # covers replicas added later

        overload = (avg_queue >= cfg.up_queue_depth
                    or occupancy >= cfg.up_occupancy
                    or shed_recent >= cfg.up_shed
                    or breakers > 0)
        underload = (not overload and shed_recent == 0
                     and queue_total == 0
                     and occupancy <= cfg.down_occupancy)
        self._down_streak = self._down_streak + 1 if underload else 0

        now = self._clock()
        if now - self._last_decision_t < cfg.cooldown_s:
            return
        ctx = {"queue_depth": queue_total, "shed_recent": shed_recent,
               "committed_frac": round(occupancy, 4),
               "breakers_open": breakers, "tick": tick}

        if overload:
            if placeable < cfg.max_replicas:
                rid = router.add()
                # rescue the trapped backlog: placement is at submit
                # time, so the queue that TRIGGERED this scale-out sits
                # on the old replicas — spread it onto the new one
                rebalanced = router.rebalance_queued()
                self.scale_ups += 1
                self._counter("fleet_scale_up_total")
                self._emit({"event": "scale_up", "replica": rid,
                            "replicas": placeable + 1,
                            "rebalanced": rebalanced, **ctx})
            elif self.degrade_level < cfg.max_degrade_level:
                self._set_degrade(router, self.degrade_level + 1,
                                  "scale_out_capped", ctx)
            else:
                return  # fully degraded at max scale: nothing left to do
            self._last_decision_t = now
        elif underload and self._down_streak >= cfg.down_stable_ticks:
            if self.degrade_level > 0:
                self._set_degrade(router, self.degrade_level - 1,
                                  "load_subsided", ctx)
            elif placeable > cfg.min_replicas:
                cand = router.scale_in_candidate()
                if cand is None:
                    self.scale_down_skips += 1
                    self._emit({"event": "scale_down_skipped",
                                "reason": "residue", **ctx})
                else:
                    router.drain(cand)
                    self.scale_downs += 1
                    self._counter("fleet_scale_down_total")
                    self._emit({"event": "scale_down", "replica": cand,
                                "replicas": placeable - 1, **ctx})
            else:
                return  # already at the floor, fully undegraded
            self._last_decision_t = now
            self._down_streak = 0

    # -- the degradation ladder -----------------------------------------
    def _set_degrade(self, router, level: int, reason: str, ctx: dict):
        """Walk the ladder one rung: 1 = tighten kv budgets, 2 = cap
        no-SLO output length, 3 = shed batch backfill. Exit reverses the
        same rung — entry/exit are symmetric by construction."""
        prev, self.degrade_level = self.degrade_level, level
        if level >= 1 and prev < 1:
            self._tighten_budgets(router)
        elif level < 1 <= prev:
            self._restore_budgets(router)
        if level >= 2 and prev < 2:
            router.cap_new_tokens_no_slo = self.config.degrade_new_tokens_cap
        elif level < 2 <= prev:
            router.cap_new_tokens_no_slo = None
        if level >= 3 and prev < 3:
            router.shed_backfill = True
        elif level < 3 <= prev:
            router.shed_backfill = False
        self._gauge("fleet_degrade_level", level)
        self._emit({"event": "degrade", "from_level": prev,
                    "to_level": level, "reason": reason, **ctx})

    def _tighten_budgets(self, router):
        for rid, eng in router.steppable_engines():
            if rid in self._orig_kv:
                continue
            orig = eng.kv_budget_tokens
            self._orig_kv[rid] = orig
            if orig is not None:
                eng.kv_budget_tokens = max(
                    1, int(orig * self.config.degrade_kv_frac))

    def _restore_budgets(self, router):
        engines = dict(router.steppable_engines())
        for rid, orig in self._orig_kv.items():
            eng = engines.get(rid)
            if eng is not None and orig is not None:
                eng.kv_budget_tokens = orig
        self._orig_kv.clear()

    # -- reporting -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "scale_down_skips": self.scale_down_skips,
            "degrade_level": self.degrade_level,
            "mean_replicas": (round(self._replica_ticks / self._ticks, 3)
                              if self._ticks else None),
        }

    def _emit(self, payload: dict):
        tele = self._router.telemetry
        if tele is not None and tele.enabled:
            tele.emit("fleet_scale", payload)

    def _counter(self, name: str, n: float = 1.0):
        tele = self._router.telemetry
        if tele is not None and tele.enabled:
            tele.registry.counter(name).inc(n)

    def _gauge(self, name: str, value: float):
        tele = self._router.telemetry
        if tele is not None and tele.enabled:
            tele.registry.gauge(name).set(value)
