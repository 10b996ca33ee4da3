"""Pluggable scheduler policies for :class:`ServingEngine` (counterpart of
``deepspeed_tpu/serving/policies.py``, copied).

A policy orders the bounded admission queue each tick; the engine then
walks that order placing requests into free slots, with ONE shared
anti-starvation rule layered on top (the aging barrier, see
``ServingEngine._schedule``): a request whose queue wait exceeds
``aging_s`` may no longer be leapfrogged by later-ranked requests — the
fix for the bare FIFO-with-skip starvation mode where a long request
waiting for the big pool watches an endless stream of short ones jump
past it.

Policies are deterministic: ordering depends
only on request fields and the injected clock, so admission-order tests
are exact.

    fifo      submission order (the pre-serving behavior, minus
              unbounded skip)
    priority  higher ``priority`` first; waiting boosts effective
              priority by 1 level per ``aging_s`` so low-priority work
              cannot starve under a steady high-priority stream
    edf       earliest absolute deadline (submit + deadline_ms) first;
              no-SLO requests sort last in submission order
    fair      per-tenant fair share: the tenant with the least committed
              service (admitted prompt+output tokens) goes first, so one
              chatty tenant cannot monopolize the slots
"""

from typing import Dict, List

from deepspeed_tpu_torch.serving.request import ServeRequest


class SchedulerPolicy:
    """Base: FIFO. Subclasses override ``key`` (sort key over the queue,
    lower = admitted first) and, when stateful, the lifecycle hooks."""

    name = "fifo"

    def key(self, req: ServeRequest, now: float):
        return (req.rid,)

    def order(self, queue: List[ServeRequest], now: float) -> List[ServeRequest]:
        # sorted() is stable: ties always resolve in submission order
        return sorted(queue, key=lambda r: self.key(r, now))

    # lifecycle hooks (stateful policies only)
    def on_admit(self, req: ServeRequest, now: float):
        pass

    def on_finish(self, req: ServeRequest, now: float):
        pass


class FifoPolicy(SchedulerPolicy):
    name = "fifo"


class PriorityPolicy(SchedulerPolicy):
    """Strict priority with aging: effective priority = ``priority`` +
    one level per ``aging_s`` seconds waited, so a parked low-priority
    request eventually outranks freshly submitted high-priority ones."""

    name = "priority"

    def __init__(self, aging_s: float = 30.0):
        if aging_s <= 0:
            raise ValueError("aging_s must be > 0")
        self.aging_s = aging_s

    def key(self, req: ServeRequest, now: float):
        effective = req.priority + req.waited_s(now) / self.aging_s
        return (-effective, req.rid)


class EdfPolicy(SchedulerPolicy):
    """Earliest-deadline-first against per-request SLOs. Requests without
    a deadline sort last (deadline_at = +inf), in submission order."""

    name = "edf"

    def key(self, req: ServeRequest, now: float):
        return (req.deadline_at, req.rid)


class FairSharePolicy(SchedulerPolicy):
    """Per-tenant fair share by committed service: tenants are charged
    ``need_tokens`` (prompt + max_new) at admission — deterministic, known
    before decoding — and the least-served tenant's oldest request goes
    first. New tenants start at the CURRENT minimum, not zero, so a
    late-arriving tenant gets its fair turn without replaying history."""

    name = "fair"

    def __init__(self):
        self._served: Dict[str, float] = {}

    def _account(self, tenant: str) -> float:
        """The tenant's service counter, opened at the CURRENT minimum on
        first sight (recomputing the baseline per lookup would hand every
        incumbent's total to the newcomer and break the interleave)."""
        if tenant not in self._served:
            self._served[tenant] = (min(self._served.values())
                                    if self._served else 0.0)
        return self._served[tenant]

    def key(self, req: ServeRequest, now: float):
        return (self._account(req.tenant), req.rid)

    def on_admit(self, req: ServeRequest, now: float):
        self._served[req.tenant] = self._account(req.tenant) + req.need_tokens


def resolve_policy(spec, aging_s: float = None) -> SchedulerPolicy:
    """A policy instance from its name ("fifo" | "priority" | "edf" |
    "fair") or an already-constructed :class:`SchedulerPolicy` (instances
    pass through untouched — construct one to pin knobs explicitly).
    ``aging_s`` flows into aging-aware policies built by name, so
    ``ServingEngine(policy="priority", aging_s=...)`` configures the
    boost rate it documents rather than the policy default."""
    if isinstance(spec, SchedulerPolicy):
        return spec
    builders = {"fifo": FifoPolicy, "priority": PriorityPolicy,
                "edf": EdfPolicy, "fair": FairSharePolicy}
    try:
        builder = builders[spec]
    except KeyError:
        raise ValueError(
            f"unknown scheduler policy {spec!r} (choose from "
            f"{sorted(builders)} or pass a SchedulerPolicy instance)"
        ) from None
    if builder is PriorityPolicy and aging_s is not None:
        return PriorityPolicy(aging_s=aging_s)
    return builder()
