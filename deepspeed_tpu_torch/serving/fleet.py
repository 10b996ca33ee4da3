"""Fleet membership primitives for the router (serving/router.py;
counterpart of ``deepspeed_tpu/serving/fleet.py``): replica records, the
engine-rid namespace partition, and the per-replica telemetry proxies that
let N serving engines share ONE hub — one trace file, one metrics
registry — with every event and metric tagged by replica id.

Everything here is host bookkeeping, like the router itself: the fleet
layer never touches device state directly, it only drives
``ServingEngine`` public APIs, so nothing here waits on the card.
"""

from typing import Callable, Dict, Optional

# Replica lifecycle (router-side view; the replica's own ``health()`` is
# the input, these are the router's placement decisions):
#
#   HEALTHY    — in rotation, takes placements.
#   RECOVERING — breaker open on the replica (recovery ladder running): no
#                placements, backed off; re-admitted when health() says ok.
#   DRAINING   — admission closed by router.drain(); in-flight work
#                finishes, then the replica retires to DRAINED.
#   FAILED     — the replica's step() raised terminally or its engine is
#                poisoned with no recovery armed: the router must evict
#                (migrate its live streams to survivors) on the next step.
#   DEAD       — evicted; live work migrated or honestly shed.
#   DRAINED    — drained to empty and retired; zero requests lost.
HEALTHY = "healthy"
RECOVERING = "recovering"
DRAINING = "draining"
FAILED = "failed"
DEAD = "dead"
DRAINED = "drained"

# States the router will place new work on (everything else is skipped
# by routing; DRAINING still *finishes* what it holds).
PLACEABLE = (HEALTHY,)
# States with a live engine the router still steps.
STEPPABLE = (HEALTHY, RECOVERING, DRAINING)

# Engine-rid namespace partition: replica slot i assigns natural engine
# rids from i * RID_STRIDE. A request migrated off a dead replica keeps
# its pinned engine rid — its RNG identity — and the stride guarantees
# no survivor ever assigned (or will naturally assign) that rid itself.
# Slot 0 starts at 0: a single-replica fleet is rid-for-rid identical to
# a bare ServingEngine.
RID_STRIDE = 1 << 20


class Replica:
    """One fleet member: the serving engine plus the router's view of it
    (placement state, shed-hint backoff, local→fleet rid map)."""

    def __init__(self, replica_id: str, serving, slot: int):
        self.replica_id = replica_id
        self.serving = serving
        self.slot = slot                    # rid-partition slot (monotonic)
        self.state = HEALTHY
        self.backoff_until = 0.0            # shed retry_after_s hints land here
        self.local_to_fleet: Dict[int, int] = {}   # local serving rid -> fleet rid
        self.admitted = 0                   # placements this router made here
        self.shed = 0                       # final fleet verdicts shed here
        self.migrated_in = 0                # requests re-admitted from dead peers
        self.migrated_out = 0               # live requests moved off at eviction

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"Replica({self.replica_id!r}, state={self.state!r}, "
                f"slot={self.slot})")


class ScopedRegistry:
    """A :class:`MetricsRegistry` view that stamps every metric with a
    ``replica`` label — replicas share the fleet's one registry, and
    per-replica series stay separable in ``/metrics`` and ``dump()``."""

    def __init__(self, base, replica_id: str):
        self._base = base
        self._replica = replica_id

    def _labels(self, labels: Optional[dict]) -> dict:
        merged = dict(labels) if labels else {}
        merged.setdefault("replica", self._replica)
        return merged

    def counter(self, name: str, labels: Optional[dict] = None):
        return self._base.counter(name, self._labels(labels))

    def gauge(self, name: str, labels: Optional[dict] = None):
        return self._base.gauge(name, self._labels(labels))

    def histogram(self, name: str, labels: Optional[dict] = None):
        return self._base.histogram(name, self._labels(labels))

    def span(self, name: str, labels: Optional[dict] = None):
        return self._base.span(name, self._labels(labels))

    def dump(self) -> dict:
        return self._base.dump()


class ReplicaTelemetry:
    """Per-replica facade over the fleet's shared telemetry hub: every
    trace event gains a ``replica`` field and every metric a ``replica``
    label, through ONE underlying trace writer and registry.

    ``close()`` is a no-op — replicas come and go (drain/add, rolling
    restart) but the hub belongs to the fleet; only ``FleetRouter.
    close()`` closes the base hub, once, after the last replica."""

    def __init__(self, base, replica_id: str):
        self._base = base
        self.replica = replica_id
        self.registry = ScopedRegistry(base.registry, replica_id)

    @property
    def enabled(self) -> bool:
        return self._base.enabled

    def emit(self, kind: str, payload: dict, **kwargs):
        tagged = dict(payload)
        tagged.setdefault("replica", self.replica)
        return self._base.emit(kind, tagged, **kwargs)

    def span(self, name: str, labels: Optional[dict] = None):
        return self.registry.span(name, labels)

    def close(self):
        """No-op by design: see class docstring."""

    def __getattr__(self, name):
        # everything else (cfg, role, summary, compile_recorder, ...)
        # answers from the shared hub
        return getattr(self._base, name)


def attach_replica_telemetry(engine, base_hub, replica_id: str):
    """Point a (telemetry-off-built) continuous-batching engine at the
    fleet's shared hub through a :class:`ReplicaTelemetry` facade. Must
    run BEFORE the engine is wrapped in ``ServingEngine`` (which caches
    the hub at construction, and re-injects that cached facade into every
    engine a recovery rebuild makes, so a rebuilt replica's events keep
    their ``replica`` tag). Returns the facade."""
    tele = ReplicaTelemetry(base_hub, replica_id)
    engine._eng.telemetry = tele
    return tele


ReplicaFactory = Callable[[str], object]
