"""Deterministic fault injection (counterpart of ``deepspeed_tpu/faults.py``):
the shared plan and injector machinery and the serving domain.

A tick dispatch can raise, a device fetch can hang, a whole engine can
vanish mid-generation. This module makes those failures *expressible and
replayable*, so that the serving layer's recovery (serving/engine.py
"Fault tolerance") is tested to the same bitwise bar as every other
change:

- a **fault plan** is a seeded, deterministic schedule of faults keyed on
  the global serving tick, replayable JSONL like the loadgen workloads
  (``dump``/``load`` round-trip, ``synth`` for seeded random plans), byte
  for byte the reference's;
- an **injector** is the plan, armed: installed as the batching engine's
  ``fault_hook`` (an explicit injection point the engine calls, no
  monkeypatching), it raises the planned exception when its tick comes
  up.

Hook points are ``dispatch`` / ``retire`` / ``set_row``
(:data:`HOOK_POINTS`); the injector counts serving ticks itself. The
exception taxonomy the recovery ladder decides by:
:class:`TickDispatchError` (raised before any engine mutation:
retryable), :class:`FetchHang` (poisons the tick pipeline: rebuild),
:class:`EnginePreempted` (whole-engine loss: rebuild).

The reference's train domain (``TrainFault*``, ``plan_bitflip``,
``flip_float_bit``, the poison helpers) comes with the training
supervisor (ROADMAP Queue 1 item 11 (b)). stdlib only.
"""

import json
import random
from dataclasses import dataclass, field
from typing import ClassVar, Dict, FrozenSet, List, Optional, Tuple

# ---------------------------------------------------------------------------
# exception taxonomy — serving
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Base class for injected faults; ``fault`` carries the plan entry
    that fired (tick/step, kind, point)."""

    def __init__(self, message: str, fault: Optional[dict] = None):
        super().__init__(message)
        self.fault = fault or {}


class TickDispatchError(InjectedFault):
    """A transient tick-dispatch failure raised at the ``dispatch`` hook,
    BEFORE the engine mutates any state — the retryable fault class."""


class FetchHang(InjectedFault, TimeoutError):
    """A device fetch that hung past the watchdog (injected stand-in for
    the real ``fetch_timeout_s`` timeout): the in-flight tick's results
    are unrecoverable, the engine is poisoned."""


class EnginePreempted(InjectedFault):
    """Whole-engine preemption (the device was reclaimed). ``degrade``
    signals the replacement must be smaller (a degraded-mesh rebuild,
    which needs the serving mesh: ROADMAP Queue 1 item 8)."""

    def __init__(self, message: str, fault: Optional[dict] = None,
                 degrade: bool = False):
        super().__init__(message, fault)
        self.degrade = degrade


# ---------------------------------------------------------------------------
# generic machinery
# ---------------------------------------------------------------------------


@dataclass
class PlannedFault:
    """One planned fault: fires at the first hook call at ``point`` whose
    clock has reached ``tick``, then ``count - 1`` more consecutive times
    (``count > 1`` models a persistent failure that exhausts the retry
    budget and forces escalation). Domain subclasses pin ``KINDS`` (fault
    kind → natural hook point), ``POINTS`` and the JSONL ``TICK_KEY``."""

    tick: int
    kind: str
    point: str = ""         # defaults to the kind's natural hook point
    count: int = 1
    degrade: bool = False   # preempt only: replacement capacity must shrink
    fired: int = field(default=0, compare=False)

    KINDS: ClassVar[Dict[str, str]] = {}
    POINTS: ClassVar[Tuple[str, ...]] = ()
    TICK_KEY: ClassVar[str] = "tick"
    # domain-specific payload fields round-tripped through JSONL when
    # they differ from their dataclass default
    EXTRA_FIELDS: ClassVar[Tuple[str, ...]] = ()
    # kinds ``synth`` draws from by default ("" sentinel = all of KINDS)
    SYNTH_KINDS: ClassVar[Tuple[str, ...]] = ()

    def __post_init__(self):
        cls = type(self)
        if self.kind not in cls.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {sorted(cls.KINDS)})")
        if not self.point:
            self.point = cls.KINDS[self.kind]
        if self.point not in cls.POINTS:
            raise ValueError(f"unknown hook point {self.point!r} "
                             f"(choose from {cls.POINTS})")
        if self.tick < 0:
            raise ValueError(f"fault {cls.TICK_KEY} must be >= 0")
        if self.count < 1:
            raise ValueError("fault count must be >= 1")

    def to_dict(self) -> dict:
        cls = type(self)
        out = {cls.TICK_KEY: self.tick, "kind": self.kind,
               "point": self.point}
        if self.count != 1:
            out["count"] = self.count
        if self.degrade:
            out["degrade"] = True
        for name in cls.EXTRA_FIELDS:
            value = getattr(self, name)
            if value != cls.__dataclass_fields__[name].default:
                out[name] = value
        return out


class PlannedFaultSchedule:
    """An ordered, replayable schedule of :class:`PlannedFault` entries."""

    fault_cls = PlannedFault

    def __init__(self, faults: List[PlannedFault]):
        self.faults = sorted(faults, key=lambda f: (f.tick, f.point, f.kind))

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    @classmethod
    def synth(cls, seed: int = 0, n_faults: int = 3, first_tick: int = 2,
              tick_span: int = 100, kinds: Optional[List[str]] = None,
              degrade_last: bool = False):
        """A seeded random plan: ``n_faults`` faults uniformly over
        ``[first_tick, first_tick + tick_span)``, kinds drawn from
        ``kinds`` (default: the domain's full taxonomy). Fully determined
        by ``seed`` — the chaos-soak analogue of ``synth_workload``."""
        rng = random.Random(seed)
        kinds = list(kinds or cls.fault_cls.SYNTH_KINDS
                     or cls.fault_cls.KINDS)
        ticks = sorted(rng.randrange(first_tick, first_tick + tick_span)
                       for _ in range(n_faults))
        faults = [cls.fault_cls(tick=t, kind=rng.choice(kinds))
                  for t in ticks]
        if degrade_last and faults:
            faults[-1].kind = "preempt"
            faults[-1].point = cls.fault_cls.KINDS["preempt"]
            faults[-1].degrade = True
        return cls(faults)

    def dump(self, path: str):
        """Write the plan as replayable JSONL (one fault per line)."""
        with open(path, "w") as fh:
            for f in self.faults:
                fh.write(json.dumps(f.to_dict()) + "\n")

    @classmethod
    def load(cls, path: str):
        key = cls.fault_cls.TICK_KEY
        faults = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                tick = rec.get(key, rec.get("tick"))
                extras = {name: rec[name]
                          for name in cls.fault_cls.EXTRA_FIELDS
                          if name in rec}
                faults.append(cls.fault_cls(
                    tick=int(tick), kind=rec["kind"],
                    point=rec.get("point", ""),
                    count=int(rec.get("count", 1)),
                    degrade=bool(rec.get("degrade", False)),
                    **extras))
        if not faults:
            raise ValueError(f"no fault records in {path}")
        return cls(faults)


class PlannedFaultInjector:
    """A fault plan, armed as an engine fault hook.

    Install with ``engine.fault_hook = injector``; the engine calls
    ``injector(point, info)`` at each hook point and the injector raises
    the planned exception when a fault is due. How the clock advances is
    the domain's choice: the serving injector counts ticks ITSELF (one
    per ``dispatch`` call) so a single plan stays meaningful across
    engine rebuilds; the train injector reads the global optimizer step
    from ``info`` so the clock survives rebuilds for free (a restored
    engine resumes the step counter)."""

    tick_point: ClassVar[Optional[str]] = None   # hook point that counts
    tick_info_key: ClassVar[Optional[str]] = None  # info key that sets it
    tick_label: ClassVar[str] = "tick"
    info_renames: ClassVar[Dict[str, str]] = {}
    EXCEPTIONS: ClassVar[Dict[str, type]] = {}
    PREEMPT_EXCEPTION: ClassVar[type] = EnginePreempted
    # kinds that corrupt values instead of raising: the fired record is
    # RETURNED to the hook site, which applies the mutation itself
    MUTATION_KINDS: ClassVar[FrozenSet[str]] = frozenset()

    def __init__(self, plan: PlannedFaultSchedule):
        self.plan = plan
        self.tick = 0                  # the domain clock, as observed
        self.fired: List[dict] = []    # log of injected faults, in order

    def pending(self) -> int:
        """Faults that have not fully fired yet."""
        return sum(1 for f in self.plan if f.fired < f.count)

    def _due(self, point: str) -> Optional[PlannedFault]:
        for f in self.plan:
            if f.point == point and f.fired < f.count and self.tick >= f.tick:
                return f
        return None

    def __call__(self, point: str, info: dict):
        cls = type(self)
        if (cls.tick_info_key is not None and info
                and cls.tick_info_key in info):
            self.tick = int(info[cls.tick_info_key])
        elif cls.tick_point is not None and point == cls.tick_point:
            self.tick += 1
        fault = self._due(point)
        if fault is None:
            return
        fault.fired += 1
        # plan fields win; the hook's engine-local clock (which resets on
        # every rebuild) is kept under its own key so a fired record can
        # be diffed against the plan without ambiguity
        record = dict(fault.to_dict(), fired_tick=self.tick)
        for key, value in (info or {}).items():
            record.setdefault(cls.info_renames.get(key, key), value)
        self.fired.append(record)
        msg = (f"injected {fault.kind} at {cls.tick_label} {self.tick} "
               f"(plan {type(fault).TICK_KEY} {fault.tick}, point {point})")
        if fault.kind in cls.MUTATION_KINDS:
            # numeric kinds corrupt VALUES rather than control flow: hand
            # the fired record back so the hook site applies the mutation
            # (engine._apply_numeric_fault) and the step keeps running —
            # only the NumericSentinel can catch what happens next
            return record
        exc = cls.EXCEPTIONS.get(fault.kind)
        if exc is not None:
            raise exc(msg, record)
        raise cls.PREEMPT_EXCEPTION(msg, record, degrade=fault.degrade)


# ---------------------------------------------------------------------------
# serving domain (re-exported by serving/faults.py)
# ---------------------------------------------------------------------------

# fault kind -> the engine hook point it fires at by default
FAULT_KINDS: Dict[str, str] = {
    "dispatch_error": "dispatch",  # raised before the tick mutates anything
    "fetch_hang": "retire",        # raised at the packed-result fetch
    "preempt": "dispatch",         # whole-engine loss (before mutation)
}
HOOK_POINTS = ("dispatch", "retire", "set_row")


@dataclass
class Fault(PlannedFault):
    """One planned serving fault, keyed on the global serving tick."""

    KINDS: ClassVar[Dict[str, str]] = FAULT_KINDS
    POINTS: ClassVar[Tuple[str, ...]] = HOOK_POINTS
    TICK_KEY: ClassVar[str] = "tick"


class FaultPlan(PlannedFaultSchedule):
    """An ordered, replayable schedule of serving :class:`Fault` entries."""

    fault_cls = Fault


class FaultInjector(PlannedFaultInjector):
    """The serving plan, armed as ``ContinuousBatchingEngine.fault_hook``.
    Counts serving ticks itself (one per ``dispatch`` call) so one plan
    spans engine rebuilds — the replacement engine's private tick counter
    restarts, the plan's does not. The serving layer re-installs the hook
    on every rebuilt engine."""

    tick_point = "dispatch"
    tick_label = "serving tick"
    info_renames = {"tick": "engine_tick"}
    EXCEPTIONS = {"dispatch_error": TickDispatchError,
                  "fetch_hang": FetchHang}
    PREEMPT_EXCEPTION = EnginePreempted
