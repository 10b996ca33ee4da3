"""Declarative serving scenarios: production-shaped load as one
replayable artifact (counterpart of ``deepspeed_tpu/serving/scenarios.py``).

A scenario composes the three things a serving stack is actually judged
under — an arrival-rate curve (diurnal sinusoid, step change, burst
train), a tenant/priority/deadline mix (interactive vs batch backfill,
long-doc RAG prompt ranges, shared-prefix tenants), and an embedded
chaos schedule (replica kill/restore/rolling-restart riding the
FleetRouter's replayable ``at_tick`` hooks) — into ONE seeded JSONL
file, dump/loadable exactly like the fault plans (``faults.FaultPlan``):
one record per line, fully determined by the header's seed, so
``python -m deepspeed_tpu_torch.serving.loadgen --scenario
diurnal.jsonl`` replays the same run anyone else got from the same file.
The repo's ``scenarios/*.jsonl`` are :func:`builtin_matrix` dumped.

Like the router under it, compiling a scenario is pure host bookkeeping
(stdlib ``random`` + the loadgen arrival generators).

Record shapes (JSONL, ``record`` discriminated):

- ``{"record": "scenario", "name", "seed", "requests", "rate",
  "curve", "process", "burst_size", "vocab"}`` — the header (exactly
  one, first line). ``curve`` is a ``--rate-curve`` spec
  (``diurnal:PERIOD:PEAK`` / ``step:T:RATE`` / ``burst_train:GAP:SIZE``)
  or null for a flat-rate ``process`` schedule.
- ``{"record": "mix", "tenant", "weight", "prompt_range", "new_range",
  "priority", "deadline_ms", "shared_prefix"}`` — one tenant class.
  ``deadline_ms`` null marks no-SLO batch backfill (what the degrade
  ladder sheds first); ``shared_prefix`` > 0 gives every request of the
  tenant the same seeded prompt prefix (the prefix-cache shape).
- ``{"record": "chaos", "tick", "action"}`` — ``kill`` (lowest-slot
  healthy replica), ``restore`` (factory-add a fresh replica), or
  ``rolling_restart``, at 1-based router tick ``tick``.
"""

import json
import random
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from deepspeed_tpu_torch.serving.loadgen import gen_arrivals, gen_curve_arrivals

CHAOS_ACTIONS = ("kill", "restore", "rolling_restart")


@dataclass
class TenantMix:
    """One tenant class in a scenario's request mix."""

    tenant: str = "default"
    weight: float = 1.0
    prompt_range: Tuple[int, int] = (4, 16)
    new_range: Tuple[int, int] = (4, 16)
    priority: int = 0
    deadline_ms: Optional[float] = None   # None = no-SLO batch backfill
    shared_prefix: int = 0                # shared prompt-prefix tokens

    def __post_init__(self):
        self.prompt_range = (int(self.prompt_range[0]),
                             int(self.prompt_range[1]))
        self.new_range = (int(self.new_range[0]), int(self.new_range[1]))
        if self.weight <= 0:
            raise ValueError(f"mix {self.tenant!r}: weight must be > 0")
        for lo, hi, what in (self.prompt_range + ("prompt_range",),
                             self.new_range + ("new_range",)):
            if lo < 1 or hi < lo:
                raise ValueError(f"mix {self.tenant!r}: bad {what} "
                                 f"({lo}, {hi})")
        if self.shared_prefix < 0:
            raise ValueError(f"mix {self.tenant!r}: shared_prefix < 0")

    def to_record(self) -> dict:
        return {"record": "mix", "tenant": self.tenant,
                "weight": self.weight,
                "prompt_range": list(self.prompt_range),
                "new_range": list(self.new_range),
                "priority": self.priority, "deadline_ms": self.deadline_ms,
                "shared_prefix": self.shared_prefix}


@dataclass
class ChaosAction:
    """One replica-level chaos step, scheduled on a router tick."""

    tick: int
    action: str

    def __post_init__(self):
        self.tick = int(self.tick)
        if self.tick < 1:
            raise ValueError(f"chaos tick must be >= 1 (got {self.tick})")
        if self.action not in CHAOS_ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r} "
                             f"(choose from {CHAOS_ACTIONS})")

    def to_record(self) -> dict:
        return {"record": "chaos", "tick": self.tick, "action": self.action}


def _kill_lowest_healthy(router):
    """The replayable chaos kill: the lowest-slot healthy replica dies
    abruptly (same victim rule as the loadgen's ``--kill-replica``)."""
    for rid in router.replica_ids():
        if router.statusz()["replicas"][rid]["state"] == "healthy":
            router.kill(rid, detail="scenario chaos kill")
            return


@dataclass
class Scenario:
    """A named, seeded, replayable serving scenario."""

    name: str
    seed: int = 0
    requests: int = 64
    rate: float = 8.0
    curve: Optional[str] = None     # a --rate-curve spec, or None
    process: str = "poisson"        # flat-rate process when curve is None
    burst_size: int = 8
    vocab: int = 128                # id range for explicit (prefix) prompts
    mixes: List[TenantMix] = field(default_factory=list)
    chaos: List[ChaosAction] = field(default_factory=list)

    def __post_init__(self):
        if not self.name:
            raise ValueError("scenario needs a name")
        if self.requests < 1:
            raise ValueError("requests must be >= 1")
        if self.rate <= 0:
            raise ValueError("rate must be > 0 req/s")
        self.chaos = sorted(self.chaos, key=lambda c: c.tick)

    # -- compilation ---------------------------------------------------
    def arrivals(self) -> List[float]:
        """The arrival schedule, delegated to the loadgen generators the
        CLI exposes standalone (``--rate-curve`` / ``--process``)."""
        if self.curve is not None:
            return gen_curve_arrivals(self.requests, self.rate, self.curve,
                                      seed=self.seed, process=self.process)
        return gen_arrivals(self.requests, self.rate, self.process,
                            seed=self.seed, burst_size=self.burst_size)

    def workload(self) -> List[dict]:
        """The request mix as loadgen workload items, fully determined by
        the header seed: per-request tenant class by weighted draw, then
        prompt/output lengths uniform in the class ranges. Shared-prefix
        tenants get explicit prompt ids — one seeded prefix per tenant,
        fresh suffix per request — so the prefix cache sees real reuse."""
        mixes = self.mixes or [TenantMix()]
        rng = random.Random(self.seed)
        weights = [m.weight for m in mixes]
        prefixes = {}
        out = []
        for _ in range(self.requests):
            m = rng.choices(mixes, weights=weights)[0]
            plen = rng.randint(*m.prompt_range)
            item = {"max_new_tokens": rng.randint(*m.new_range),
                    "tenant": m.tenant, "priority": int(m.priority)}
            if m.shared_prefix > 0:
                if m.tenant not in prefixes:
                    prefixes[m.tenant] = [rng.randrange(self.vocab)
                                          for _ in range(m.shared_prefix)]
                suffix = [rng.randrange(self.vocab)
                          for _ in range(max(1, plen - m.shared_prefix))]
                item["prompt"] = prefixes[m.tenant] + suffix
            else:
                item["prompt_tokens"] = plen
            if m.deadline_ms is not None:
                item["deadline_ms"] = float(m.deadline_ms)
            out.append(item)
        return out

    def compile(self) -> Tuple[List[dict], List[float]]:
        """``(workload, arrivals)`` ready for ``loadgen.run_load``."""
        return self.workload(), self.arrivals()

    def arm(self, router) -> int:
        """Register the chaos schedule on a FleetRouter's replayable
        ``at_tick`` hooks and journal the scenario marker (the
        ``fleet_scale`` event a trace report keys its per-scenario
        section on). Returns the number of chaos actions
        armed."""
        for act in self.chaos:
            if act.action == "kill":
                router.at_tick(act.tick, _kill_lowest_healthy)
            elif act.action == "restore":
                router.at_tick(act.tick, lambda r: r.add())
            else:
                router.at_tick(act.tick, lambda r: r.rolling_restart())
        tele = router.telemetry
        if tele is not None and tele.enabled:
            tele.emit("fleet_scale", {
                "event": "scenario", "scenario": self.name,
                "requests": self.requests, "seed": self.seed})
        return len(self.chaos)

    def without_chaos(self) -> "Scenario":
        """The quiet twin: identical workload + arrivals, no chaos — the
        baseline the bitwise-parity check compares migrated streams
        against."""
        return Scenario(name=f"{self.name}~quiet", seed=self.seed,
                        requests=self.requests, rate=self.rate,
                        curve=self.curve, process=self.process,
                        burst_size=self.burst_size, vocab=self.vocab,
                        mixes=list(self.mixes), chaos=[])

    # -- persistence (FaultPlan-style JSONL) ---------------------------
    def dump(self, path: str):
        with open(path, "w") as fh:
            fh.write(json.dumps({
                "record": "scenario", "name": self.name, "seed": self.seed,
                "requests": self.requests, "rate": self.rate,
                "curve": self.curve, "process": self.process,
                "burst_size": self.burst_size, "vocab": self.vocab}) + "\n")
            for m in self.mixes:
                fh.write(json.dumps(m.to_record()) + "\n")
            for c in self.chaos:
                fh.write(json.dumps(c.to_record()) + "\n")

    @classmethod
    def load(cls, path: str) -> "Scenario":
        header, mixes, chaos = None, [], []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.pop("record", None)
                if kind == "scenario":
                    if header is not None:
                        raise ValueError(f"{path}: duplicate scenario header")
                    header = rec
                elif kind == "mix":
                    mixes.append(TenantMix(
                        tenant=rec["tenant"], weight=rec.get("weight", 1.0),
                        prompt_range=tuple(rec.get("prompt_range", (4, 16))),
                        new_range=tuple(rec.get("new_range", (4, 16))),
                        priority=rec.get("priority", 0),
                        deadline_ms=rec.get("deadline_ms"),
                        shared_prefix=rec.get("shared_prefix", 0)))
                elif kind == "chaos":
                    chaos.append(ChaosAction(tick=rec["tick"],
                                             action=rec["action"]))
                else:
                    raise ValueError(f"{path}: unknown record {kind!r}")
        if header is None:
            raise ValueError(f"no scenario header in {path}")
        return cls(name=header["name"], seed=header.get("seed", 0),
                   requests=header.get("requests", 64),
                   rate=header.get("rate", 8.0), curve=header.get("curve"),
                   process=header.get("process", "poisson"),
                   burst_size=header.get("burst_size", 8),
                   vocab=header.get("vocab", 128),
                   mixes=mixes, chaos=chaos)


def scenario_scorecard(scenario: Scenario, summary: dict) -> dict:
    """The per-scenario SLO verdict over one run's loadgen summary: the
    numbers the acceptance criteria compare fleets on, tagged with the
    scenario identity so a matrix of runs stays self-describing."""
    fleet = summary.get("fleet") or {}
    return {
        "scenario": scenario.name,
        "seed": scenario.seed,
        "requests": scenario.requests,
        "curve": scenario.curve,
        "chaos_actions": len(scenario.chaos),
        "goodput_tok_s": summary.get("goodput_tok_s"),
        "throughput_tok_s": summary.get("throughput_tok_s"),
        "shed_rate": summary.get("shed_rate"),
        "deadline_met_frac": summary.get("deadline_met_frac"),
        "lost": fleet.get("lost"),
        "replica_deaths": fleet.get("replica_deaths"),
        "conservation_ok": fleet.get("conservation_ok"),
    }


def builtin_matrix() -> List[Scenario]:
    """The checked-in scenario matrix (``scenarios/*.jsonl`` is this
    list dumped byte for byte; tests/test_torch_fleet_scenarios.py
    holds the two equal).
    Every entry is production-shaped: mixed SLO tenants over a hostile
    rate curve, two of them (``kill_during_peak``, ``rolling_under_load``)
    with embedded replica chaos."""
    interactive = TenantMix(tenant="interactive", weight=0.6,
                            prompt_range=(4, 12), new_range=(6, 12),
                            priority=1, deadline_ms=1500.0)
    backfill = TenantMix(tenant="backfill", weight=0.4,
                         prompt_range=(8, 24), new_range=(8, 16),
                         priority=0, deadline_ms=None)
    return [
        Scenario(
            name="diurnal_interactive", seed=13, requests=120, rate=3.0,
            curve="diurnal:8:20",
            mixes=[interactive, backfill]),
        Scenario(
            name="burst_frontend", seed=13, requests=96, rate=8.0,
            curve="burst_train:1.5:16",
            mixes=[TenantMix(tenant="frontend", weight=0.7,
                             prompt_range=(4, 10), new_range=(4, 10),
                             priority=1, deadline_ms=1200.0),
                   backfill]),
        Scenario(
            name="step_rampup", seed=13, requests=96, rate=4.0,
            curve="step:4:18",
            mixes=[interactive, backfill]),
        Scenario(
            name="ragdoc_longprompts", seed=13, requests=48, rate=4.0,
            curve="diurnal:8:10",
            mixes=[TenantMix(tenant="rag", weight=0.5,
                             prompt_range=(24, 40), new_range=(8, 16),
                             priority=1, deadline_ms=3000.0,
                             shared_prefix=16),
                   interactive]),
        Scenario(
            name="multi_tenant_fairshare", seed=13, requests=96, rate=10.0,
            mixes=[TenantMix(tenant=f"tenant{i}", weight=w,
                             prompt_range=(4, 12), new_range=(4, 12),
                             priority=p, deadline_ms=d)
                   for i, (w, p, d) in enumerate(
                       [(0.4, 2, 900.0), (0.3, 1, 1800.0),
                        (0.2, 0, None), (0.1, 0, None)])]),
        Scenario(
            name="kill_during_peak", seed=13, requests=120, rate=3.0,
            curve="diurnal:8:20",
            mixes=[interactive, backfill],
            chaos=[ChaosAction(tick=80, action="kill"),
                   ChaosAction(tick=140, action="restore")]),
        Scenario(
            name="rolling_under_load", seed=13, requests=96, rate=8.0,
            mixes=[interactive, backfill],
            chaos=[ChaosAction(tick=30, action="rolling_restart")]),
    ]


def write_matrix(dirpath: str) -> List[str]:
    """Dump the builtin matrix into ``dirpath`` as one JSONL per
    scenario; returns the written paths (regeneration entry point:
    ``python -m deepspeed_tpu_torch.serving.scenarios scenarios/``)."""
    import os

    paths = []
    for sc in builtin_matrix():
        path = os.path.join(dirpath, f"{sc.name}.jsonl")
        sc.dump(path)
        paths.append(path)
    return paths


if __name__ == "__main__":  # pragma: no cover - regeneration helper
    import sys

    out_dir = sys.argv[1] if len(sys.argv) > 1 else "scenarios"
    for p in write_matrix(out_dir):
        print(p)
