"""Fleet router: N serving replicas behind one admission surface,
surviving replica failure (counterpart of
``deepspeed_tpu/serving/router.py``).

The :class:`FleetRouter` is host bookkeeping over ``ServingEngine``
public APIs, like the serving layer under it, so the placement, failover,
and drain logic is testable in milliseconds with a fake engine. Every call
it makes into a replica (``admission_outlook``, ``committed_tokens``,
``health``, ``statusz``, ``recovery_snapshot``) reads host state only: the
probe thread and the ops-server thread run them while the main thread
dispatches ticks, and none of them waits on the card. On one card the
replicas share the device and the host thread: ``step()`` ticks them one
after another in slot order. The load-bearing behaviors:

- **Routing** — join-shortest-committed-tokens: candidates are ranked by
  ``committed_tokens()`` and consulted via ``admission_outlook()`` (no
  side effects); the ONE real ``submit`` lands on the best replica that
  would admit, spilling over to the next-best when the first would only
  queue or shed. A shed verdict's ``retry_after_s`` hint backs the
  replica off so the router stops hammering a recovering/full replica.
- **Health-driven ejection** — ``probe()`` (inline per step, and
  optionally on a daemon thread) walks each replica's ``health()``
  ladder: ok ⇢ healthy, recovering ⇢ backed out of rotation, poisoned ⇢
  failed. A failed replica — or one whose ``step()`` raises terminally —
  is evicted: every live request is re-admitted onto survivors from the
  replica's ``RecoveryLog`` snapshot and resumes **bitwise** mid-token
  (``submit(rid=, gen_base=)`` under the fleet's partitioned engine-rid
  namespace — see ``fleet.RID_STRIDE``; the engine rid keys the sampler,
  so a sampled stream resumes on the same draws); what no survivor can hold is
  shed honestly. Fleet conservation holds: admitted == finished + shed
  + expired + cancelled.
- **Rolling drain/add** — ``drain()`` finishes a replica's in-flight
  work while admissions spill to peers; ``add()`` brings a factory-built
  replica into rotation under live load; ``rolling_restart()`` composes
  them over the whole fleet with zero lost requests.

The router owns the FLEET rid namespace: callers hold fleet rids,
``_routes`` maps each to its current ``(replica, local rid)`` placement
— which eviction rewrites mid-stream without the caller noticing.
"""

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.serving.fleet import (
    DEAD,
    DRAINED,
    DRAINING,
    FAILED,
    HEALTHY,
    PLACEABLE,
    RECOVERING,
    RID_STRIDE,
    STEPPABLE,
    Replica,
)
from deepspeed_tpu_torch.serving.request import (
    ADMITTED,
    FINISHED,
    SHED,
    TERMINAL_STATES,
    Admission,
    ServeRequest,
)
from deepspeed_tpu_torch.telemetry.spans import SpanEmitter

# tick_stats fields that are ratios/identities, recomputed (not summed)
# when aggregating across replicas
_DERIVED_TICK_FIELDS = ("pipeline_depth", "mean_emitted_per_tick",
                        "block_ms_per_token", "overlap_frac", "utilization")


class FleetStream:
    """Per-token pull iterator over a FLEET rid: replays what the current
    placement already emitted, then drives ``router.step()`` for more.
    Migration is invisible — the survivor's record is pre-seeded with
    every token the dead replica emitted, so the cursor just keeps
    walking the same logical stream."""

    def __init__(self, router: "FleetRouter", frid: int):
        self._router = router
        self._frid = frid
        self._pos = 0

    def __iter__(self) -> "FleetStream":
        return self

    def __next__(self) -> int:
        while True:
            req = self._router.request(self._frid)
            if req is not None and self._pos < len(req.tokens):
                tok = req.tokens[self._pos]
                self._pos += 1
                return int(tok)
            if req is None or req.state in TERMINAL_STATES:
                raise StopIteration
            if not self._router.has_work():
                # live request but nothing can make progress (engine gone
                # mid-eviction): never spin
                raise StopIteration
            self._router.step()


class FleetRouter:
    """Load balancer + failover layer over N ``ServingEngine`` replicas.

    ``factory(replica_id) -> ServingEngine`` builds one replica; build
    the engine with telemetry OFF and attach the fleet's shared hub via
    ``fleet.attach_replica_telemetry`` so every replica's events/metrics
    land in one trace tagged by replica id. ``telemetry`` is the base
    hub for fleet-level ``router_event``s / ``fleet_*`` metrics (when
    None, the first replica's hub is adopted).

    Drive it exactly like a single serving engine: ``submit`` /
    ``step`` / ``reap`` / ``stream`` / ``result`` / ``cancel`` — the
    returned rids are fleet-scoped and survive replica death."""

    def __init__(self, factory: Callable[[str], object], replicas: int = 1,
                 *, telemetry=None, clock=time.monotonic):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self._factory = factory
        self._clock = clock
        # Probe-thread discipline (ds-lint thread-shared-state): every
        # attribute the probe/ops threads read is read under this lock;
        # the probe thread NEVER emits trace events itself (TraceWriter
        # is main-thread-owned) — it enqueues into _pending_events, and
        # step() drains the queue on the main thread.
        self._lock = threading.RLock()
        self._pending_events: List[dict] = []
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._replicas: Dict[str, Replica] = {}
        self._routes: Dict[int, Tuple[str, int]] = {}  # fleet rid -> (replica, local rid)
        self._dead_reaped: Dict[int, ServeRequest] = {}
        self._next_frid = 0
        self._next_slot = 0
        self._tick = 0
        self._hooks: Dict[int, List[Callable]] = {}
        self._rolling: Optional[dict] = None
        self._submitted = 0
        self._admitted = 0
        self._shed = 0
        self._spillovers = 0
        self._migrated = 0
        self._lost = 0
        self._deaths = 0
        self._ops_server = None
        self._closed = False
        self._on_step_hooks: List[Callable] = []
        # Degradation-ladder knobs (driven by serving.autoscaler): cap
        # output length for no-SLO tenants, then shed batch backfill
        # before interactive — both consulted in submit() for requests
        # with no deadline, both journaled by the autoscaler.
        self.cap_new_tokens_no_slo: Optional[int] = None
        self.shed_backfill = False
        self._tele = telemetry
        for _ in range(replicas):
            self.add()
        if self._tele is None:  # adopt the first replica's (possibly
            # facade-wrapped) hub; fleet events go to the BASE hub
            first = next(iter(self._replicas.values()))
            tele = first.serving._tele
            self._tele = getattr(tele, "_base", tele)
        # migration-bridge spans go to the base hub untagged (the bridge
        # is fleet-level, between replicas); only the main thread emits
        # (the _place_entry call sites), honoring the probe discipline
        self._spans = SpanEmitter(self._tele, clock=clock)

    # -- fleet lifecycle ------------------------------------------------
    def add(self, factory: Optional[Callable[[str], object]] = None) -> str:
        """Build and enroll a fresh replica (under live load): slot ids
        are monotonic — a replacement never reuses a dead replica's
        engine-rid partition, so migrated pinned rids stay unique."""
        slot = self._next_slot
        self._next_slot += 1
        replica_id = f"r{slot}"
        serving = (factory or self._factory)(replica_id)
        serving.set_rid_base(slot * RID_STRIDE)
        rep = Replica(replica_id, serving, slot)
        with self._lock:
            self._replicas[replica_id] = rep
        self._event({"event": "replica_added", "replica": replica_id,
                     "replicas": self._placeable_count()})
        self._update_gauges()
        return replica_id

    def drain(self, replica_id: str):
        """Take a replica out of rotation gracefully: admission closes
        (new work spills to peers), in-flight streams finish intact, and
        the replica retires to ``drained`` once dry — zero requests
        lost. The rolling-restart building block."""
        rep = self._replica(replica_id)
        if rep.state in (DEAD, DRAINED):
            return
        rep.serving.drain()
        with self._lock:
            rep.state = DRAINING
        self._event({"event": "drain", "replica": replica_id})
        self._update_gauges()

    def kill(self, replica_id: str, detail: str = "killed"):
        """Chaos primitive: abrupt replica death. Recovery runs from the
        replica's ``RecoveryLog`` snapshot alone — exactly the state a
        real process loss would leave behind."""
        rep = self._replica(replica_id)
        if rep.state in (DEAD, DRAINED):
            return
        self._event({"event": "kill", "replica": replica_id,
                     "tick": self._tick})
        self._evict(rep, detail)

    def rolling_restart(self):
        """Restart the whole fleet with zero lost requests: one replica
        at a time — add the replacement first (capacity never dips), then
        drain the old one; the next pair starts when the drain retires.
        Driven forward by ``step()``; idempotent while one is running."""
        if self._rolling is not None:
            return
        pending = [r.replica_id for r in self._replicas.values()
                   if r.state in STEPPABLE]
        self._rolling = {"pending": pending, "draining": None}
        self._event({"event": "rolling_restart",
                     "replicas": len(pending)})

    def at_tick(self, tick: int, fn: Callable[["FleetRouter"], None]):
        """Register a chaos hook to run at the START of router tick
        ``tick`` (1-based, like the engine fault plans) — the replayable
        scheduling surface behind the loadgen's ``--kill-replica`` /
        ``--rolling-restart``."""
        self._hooks.setdefault(int(tick), []).append(fn)

    def replica_ids(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def on_step(self, fn: Callable[["FleetRouter"], None]):
        """Register a recurring hook run at the END of every ``step()``
        (after replicas stepped, before gauges) — the autoscaler's
        attachment point: its policy reads/acts on the main thread, so
        its ``fleet_scale`` events hit the trace writer safely."""
        self._on_step_hooks.append(fn)

    @property
    def telemetry(self):
        """The fleet's base telemetry hub (events + metrics registry)."""
        return self._tele

    def scale_in_candidate(self) -> Optional[str]:
        """The replica an autoscaler may safely drain, or None.

        Residue-aware: never the last placeable replica, never a
        non-healthy one, and — the scale-in correctness rule — never a
        replica that holds the ONLY copy of a recovering request's
        RecoveryLog residue (breaker open or engine health not ``ok``
        while outstanding ``residue_tokens`` remain: draining it would
        strand mid-stream state no survivor has). Among the eligible,
        prefer the emptiest (least residue, then least committed KV)."""
        with self._lock:
            if self._placeable_count() <= 1:
                return None
            reps = [r for r in self._replicas.values()
                    if r.state == HEALTHY]
        eligible = []
        for rep in reps:
            st = rep.serving.statusz()
            residue = int(st.get("residue_tokens", 0))
            if residue > 0 and (st.get("breaker_open")
                                or rep.serving.health() != "ok"):
                continue  # sole copy of recovering residue: not drainable
            eligible.append((residue, rep.serving.committed_tokens(),
                             rep.slot, rep.replica_id))
        if not eligible:
            return None
        return min(eligible)[3]

    def rebalance_queued(self, max_moves: Optional[int] = None) -> int:
        """Spread host-side QUEUED (never-started) requests across the
        fleet: pop entries off the deepest healthy queue and re-admit
        them on a lighter replica until depths are within one of each
        other (or ``max_moves``). Returns the number moved.

        Why this exists: placement happens at submit time, so a burst
        that lands on a small fleet stays trapped on the old replicas'
        queues — ``add()``-ing a replica only helps FUTURE arrivals. The
        autoscaler calls this right after scale-out so new capacity
        rescues the very burst that triggered it. Only queued entries
        move (``engine_rid`` None — no KV state, no stream to resume);
        running streams stay pinned where their cache lives. A request
        is released from its source only AFTER a survivor admitted it,
        so a failed placement leaves it exactly where it was."""
        moved = 0
        while max_moves is None or moved < max_moves:
            with self._lock:
                reps = [r for r in self._replicas.values()
                        if r.state == HEALTHY]
            if len(reps) < 2:
                break
            depths = sorted((int(r.serving.statusz()["queue_depth"]),
                             r.slot, r) for r in reps)
            (lo, _, dst), (hi, _, src) = depths[0], depths[-1]
            if hi - lo <= 1:
                break  # balanced: moving more would just shuffle work
            queued = [e for e
                      in src.serving.recovery_snapshot(include_queued=True)
                      if e.get("engine_rid") is None]
            if not queued:
                break  # statusz raced a drain; nothing concrete to move
            entry = queued[-1]  # tail = least-urgent under the policy
            lrid = entry["rid"]
            frid = src.local_to_fleet.get(lrid)
            old = src.serving.request(lrid)
            if frid is None or old is None:
                break
            # target ONLY the shallowest queue: each move strictly
            # shrinks the imbalance, so the loop terminates
            if not self._place_entry(entry, src, frid, old.on_token,
                                     event="rebalanced", targets=[dst]):
                break  # the lightest replica won't admit it; keep at src
            src.serving.release(lrid)
            moved += 1
        if moved:
            self._event({"event": "rebalance", "migrated": moved})
            self._flush_events()
        return moved

    # -- routing --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               priority: int = 0, tenant: str = "default",
               deadline_ms: Optional[float] = None,
               on_token=None, prefix_id: Optional[int] = None) -> Admission:
        """Fleet admission: one honest verdict from the best replica.
        Candidates (healthy, not backed off) are ranked by committed KV
        tokens; ``admission_outlook`` picks the first that would ADMIT,
        falling back to the first that would queue, falling back to the
        least-loaded one's real shed verdict (whose ``retry_after_s``
        hint also backs that replica off). The returned rid is
        fleet-scoped.

        ``prefix_id`` requires the factory to register prefixes
        SYMMETRICALLY on every replica (same registration order -> same
        serving-level id everywhere): placement may pick any replica, and
        a migrated request's survivor resolves the same id — a replica
        missing it falls back to the full-prompt prefill rather than
        stranding the stream."""
        self._submitted += 1
        self._counter("fleet_submitted_total")
        if deadline_ms is None:   # degradation ladder: no-SLO traffic
            if self.shed_backfill:
                self._shed += 1
                self._counter("fleet_shed_total")
                self._event({"event": "shed",
                             "reason": "degraded_backfill"})
                return Admission(status=SHED, reason="degraded_backfill")
            if self.cap_new_tokens_no_slo is not None:
                max_new_tokens = min(int(max_new_tokens),
                                     int(self.cap_new_tokens_no_slo))
        need = int(np.asarray(prompt_ids, np.int32).reshape(-1).size) \
            + int(max_new_tokens)
        now = self._clock()
        cands = self._candidates(now)
        if not cands:
            return self._fleet_shed(need, now)
        chosen, verdicts = None, []
        for rep in cands:
            status, reason = rep.serving.admission_outlook(need)
            verdicts.append((rep, status))
            if status == ADMITTED:
                chosen = rep
                break
        if chosen is None:
            chosen = next((rep for rep, status in verdicts
                           if status not in (SHED,)), None)
        if chosen is None:
            chosen = cands[0]   # all would shed: least-loaded sheds honestly
        adm = chosen.serving.submit(
            prompt_ids, max_new_tokens, priority=priority, tenant=tenant,
            deadline_ms=deadline_ms, on_token=on_token,
            prefix_id=prefix_id)
        if not adm:
            chosen.shed += 1
            self._shed += 1
            self._counter("fleet_shed_total")
            if adm.retry_after_s is not None:
                with self._lock:
                    chosen.backoff_until = now + adm.retry_after_s
                self._event({
                    "event": "backoff", "replica": chosen.replica_id,
                    "retry_after_s": adm.retry_after_s})
            return adm
        frid = self._next_frid
        self._next_frid += 1
        with self._lock:
            self._routes[frid] = (chosen.replica_id, adm.rid)
        chosen.local_to_fleet[adm.rid] = frid
        chosen.admitted += 1
        self._admitted += 1
        self._counter("fleet_admitted_total")
        if chosen is not cands[0]:
            # the least-loaded replica would not take it; the fleet
            # verdict came from a peer — a spillover
            self._spillovers += 1
            self._counter("fleet_spillover_total")
            self._event({
                "event": "spillover", "request": frid,
                "from_replica": cands[0].replica_id,
                "replica": chosen.replica_id})
        self._event({
            "event": "route", "request": frid,
            "replica": chosen.replica_id, "verdict": adm.status,
            "attempts": 1 + cands.index(chosen)})
        return Admission(status=adm.status, rid=frid, reason=adm.reason,
                         retry_after_s=adm.retry_after_s)

    def _candidates(self, now: float) -> List[Replica]:
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in PLACEABLE and now >= r.backoff_until]
        reps.sort(key=lambda r: (r.serving.committed_tokens(), r.slot))
        return reps

    def _fleet_shed(self, need: int, now: float) -> Admission:
        """No replica can even be asked: the fleet-level verdict. The
        hint is the soonest any backed-off replica re-opens."""
        with self._lock:
            waits = [r.backoff_until - now for r in self._replicas.values()
                     if r.state in PLACEABLE and r.backoff_until > now]
        hint = round(min(waits), 3) if waits else None
        self._shed += 1
        self._counter("fleet_shed_total")
        payload = {"event": "shed", "reason": "no_replicas",
                   "need_tokens": need}
        if hint is not None:
            payload["retry_after_s"] = hint
        self._event(payload)
        return Admission(status=SHED, reason="no_replicas",
                         retry_after_s=hint)

    # -- the fleet tick -------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """One fleet tick: chaos hooks, the health ladder, evictions, one
        ``step()`` per steppable replica (a raising replica is evicted —
        its streams migrate to survivors), drain retirement, and the
        rolling-restart machine. Returns {fleet rid: [tokens]} emitted
        this tick."""
        self._tick += 1
        for fn in self._hooks.pop(self._tick, []):
            fn(self)
        self.probe()
        for rep in list(self._replicas.values()):
            if rep.state == FAILED:
                self._evict(rep, "health: poisoned")
        out: Dict[int, List[int]] = {}
        for rep in list(self._replicas.values()):
            if rep.state not in STEPPABLE:
                continue
            if rep.serving.has_work():
                try:
                    emitted = rep.serving.step()
                except Exception as e:  # noqa: BLE001 — any terminal step
                    # failure ejects the replica; the fleet keeps serving
                    self._evict(rep, f"{type(e).__name__}: {e}")
                    continue
                for lrid, toks in emitted.items():
                    frid = rep.local_to_fleet.get(lrid)
                    if frid is not None:
                        out[frid] = toks
            if rep.state == DRAINING and not rep.serving.has_work():
                self._retire(rep)
        self._advance_rolling()
        for fn in list(self._on_step_hooks):
            fn(self)
        self._flush_events()
        self._update_gauges()
        return out

    def has_work(self) -> bool:
        return any(rep.serving.has_work()
                   for rep in self._replicas.values()
                   if rep.state in STEPPABLE)

    def run(self, max_ticks: Optional[int] = None) -> int:
        ticks = 0
        while self.has_work():
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.step()
            ticks += 1
        return ticks

    # -- ejection + migration -------------------------------------------
    def _evict(self, rep: Replica, detail: str):
        """Replica death: re-admit its live requests onto survivors from
        the recovery snapshot (running streams resume bitwise under
        their pinned engine rids; queued ones re-enter fresh), shed the
        rest honestly, and stash its terminal records for ``reap``."""
        with self._lock:
            rep.state = DEAD
        self._deaths += 1
        self._counter("fleet_replica_deaths_total")
        migrated = 0
        for entry in rep.serving.recovery_snapshot(include_queued=True):
            lrid = entry["rid"]
            frid = rep.local_to_fleet.get(lrid)
            old = rep.serving.request(lrid)
            if frid is None or old is None:
                continue
            placed = self._place_entry(entry, rep, frid, old.on_token)
            if placed:
                rep.serving.release(lrid)
                rep.migrated_out += 1
                migrated += 1
        # whatever no survivor could hold is shed honestly on the dead
        # replica's books (serving_event reason engine_lost, tagged with
        # its replica id) and surfaces through reap below
        lost = rep.serving.abandon(f"replica {rep.replica_id} lost: "
                                   f"{detail[:120]}")
        self._lost += len(lost)
        if lost:
            self._counter("fleet_lost_total", len(lost))
        self._stash_reaped(rep)
        self._event({
            "event": "replica_dead", "replica": rep.replica_id,
            "detail": detail[:200], "migrated": migrated,
            "lost": len(lost)})
        self._flush_events()
        self._update_gauges()

    def _place_entry(self, entry: dict, dead: Replica, frid: int,
                     on_token, event: str = "migrated",
                     targets: Optional[List[Replica]] = None) -> bool:
        """Try every survivor (least-loaded first, or the explicit
        ``targets`` list in order) for one recovery entry. True when one
        admitted/queued it — the route now points there and the stream
        continues. ``event`` discriminates death migration
        (``migrated``, counted as such) from queue rebalancing
        (``rebalanced``, counted separately: nothing died)."""
        now = self._clock()
        cands = targets if targets is not None else self._candidates(now)
        # migration-bridge span id, minted BEFORE the readmit so the
        # survivor's admission span can parent on it — but EMITTED only
        # after a successful placement (a failed sweep writes nothing, so
        # the trace never holds a dangling bridge)
        mig_span = (self._spans.new_span_id()
                    if entry.get("trace_id") is not None
                    and self._spans.enabled else None)
        for surv in cands:
            if surv is dead:
                continue
            try:
                adm = surv.serving.readmit(entry, on_token=on_token,
                                           parent_span=mig_span)
            except ValueError:
                continue  # cannot ever fit here (budget/rid collision)
            if not adm:
                continue  # honest local shed: try the next survivor
            with self._lock:
                self._routes[frid] = (surv.replica_id, adm.rid)
            surv.local_to_fleet[adm.rid] = frid
            if event == "migrated":
                surv.migrated_in += 1
                self._migrated += 1
                self._counter("fleet_migrated_total")
            else:
                self._counter("fleet_rebalanced_total")
            if mig_span is not None:
                # the cross-replica stitch: parented on the request's
                # root (emitted on its birth replica), tagged with both
                # endpoints — one trace_id spans engine generations
                self._spans.emit(
                    "migration", entry["trace_id"], now, self._clock(),
                    span_id=mig_span, parent_id=entry.get("span_root"),
                    attrs={"event": event,
                           "from_replica": dead.replica_id,
                           "to_replica": surv.replica_id,
                           "gen_base": len(entry.get("emitted", []))})
            self._event({
                "event": event, "request": frid,
                "from_replica": dead.replica_id,
                "to_replica": surv.replica_id,
                "tokens_emitted": len(entry.get("emitted", [])),
                "gen_base": len(entry.get("emitted", [])),
                "verdict": adm.status})
            return True
        return False

    def _retire(self, rep: Replica):
        """A draining replica ran dry: retire it (state ``drained``) and
        stash its terminal records — nothing was lost."""
        with self._lock:
            rep.state = DRAINED
        self._stash_reaped(rep)
        self._event({"event": "replica_drained",
                     "replica": rep.replica_id})
        self._update_gauges()

    def _stash_reaped(self, rep: Replica):
        """Translate a retiring replica's terminal records into the fleet
        namespace so a later ``reap()`` still surfaces them."""
        for lrid, req in rep.serving.reap().items():
            frid = rep.local_to_fleet.pop(lrid, None)
            if frid is None:
                continue
            with self._lock:
                self._routes.pop(frid, None)
                self._dead_reaped[frid] = req

    def _advance_rolling(self):
        roll = self._rolling
        if roll is None:
            return
        if roll["draining"] is not None:
            rep = self._replicas.get(roll["draining"])
            if rep is not None and rep.state not in (DRAINED, DEAD):
                return  # still finishing in-flight work
            roll["draining"] = None
        if not roll["pending"]:
            self._rolling = None
            self._event({"event": "rolling_restart_done",
                         "replicas": self._placeable_count()})
            return
        old = roll["pending"].pop(0)
        rep = self._replicas.get(old)
        if rep is None or rep.state not in STEPPABLE:
            return  # died on its own mid-restart; next step advances
        self.add()          # replacement first: capacity never dips
        self.drain(old)
        roll["draining"] = old

    # -- request surface (fleet rid namespace) --------------------------
    def request(self, frid: int) -> Optional[ServeRequest]:
        """The request's CURRENT record — wherever migration put it."""
        with self._lock:
            route = self._routes.get(frid)
            if route is None:
                return self._dead_reaped.get(frid)
        rep = self._replicas.get(route[0])
        return rep.serving.request(route[1]) if rep is not None else None

    def status(self, frid: int) -> str:
        req = self.request(frid)
        return req.state if req is not None else "unknown"

    def stream(self, frid: int) -> FleetStream:
        if self.request(frid) is None:
            raise KeyError(f"unknown fleet request {frid}: shed or "
                           f"already reaped")
        return FleetStream(self, frid)

    def result(self, frid: int):
        """Pop a FINISHED request's full token array (prompt + generated),
        wherever it finished. KeyError (naming the state) otherwise."""
        with self._lock:
            req = self._dead_reaped.get(frid)
            if req is not None:
                if req.state != FINISHED:
                    raise KeyError(f"no result for fleet request {frid}: "
                                   f"{req.state}")
                self._dead_reaped.pop(frid)
                return req.result
            route = self._routes.get(frid)
        if route is None:
            raise KeyError(f"no result for fleet request {frid}: unknown — "
                           f"never admitted, shed, or already reaped")
        rep_id, lrid = route
        out = self._replicas[rep_id].serving.result(lrid)
        with self._lock:
            self._routes.pop(frid, None)
        self._replicas[rep_id].local_to_fleet.pop(lrid, None)
        return out

    def cancel(self, frid: int) -> bool:
        with self._lock:
            route = self._routes.get(frid)
        if route is None:
            return False
        rep = self._replicas.get(route[0])
        return rep.serving.cancel(route[1]) if rep is not None else False

    def reap(self) -> Dict[int, ServeRequest]:
        """Every terminal record across the fleet (and from dead/drained
        replicas), keyed by fleet rid."""
        with self._lock:
            out = dict(self._dead_reaped)
            self._dead_reaped.clear()
        for rep in list(self._replicas.values()):
            for lrid, req in rep.serving.reap().items():
                frid = rep.local_to_fleet.pop(lrid, None)
                if frid is None:
                    continue
                with self._lock:
                    self._routes.pop(frid, None)
                out[frid] = req
        return out

    # -- health plane ---------------------------------------------------
    def probe(self):
        """Walk every replica's ``health()`` ladder and update placement
        states. Runs inline each ``step()`` and (optionally) on the
        daemon probe thread — so the WHOLE body holds the router lock,
        and state-change trace events are only ENQUEUED here; ``step()``
        emits them from the main thread (the trace writer is not
        thread-safe)."""
        with self._lock:
            now = self._clock()
            for rep in self._replicas.values():
                if rep.state in (DEAD, DRAINED, FAILED):
                    continue
                health = rep.serving.health()
                if health == "ok" and rep.state == RECOVERING:
                    rep.state = HEALTHY
                    rep.backoff_until = now
                    self._pending_events.append({
                        "event": "replica_recovered",
                        "replica": rep.replica_id, "health": health})
                elif health == "recovering" and rep.state == HEALTHY:
                    rep.state = RECOVERING
                    self._pending_events.append({
                        "event": "replica_recovering",
                        "replica": rep.replica_id, "health": health})
                elif health == "poisoned":
                    rep.state = FAILED
                    self._pending_events.append({
                        "event": "replica_failed",
                        "replica": rep.replica_id, "health": health})
                elif health == "draining" and rep.state in (HEALTHY,
                                                            RECOVERING):
                    # drained out-of-band (operator called engine.drain):
                    # honor it — finish, then retire
                    rep.state = DRAINING
                    self._pending_events.append({
                        "event": "drain", "replica": rep.replica_id})

    def start_probe(self, interval_s: float = 0.25) -> threading.Thread:
        """Background health probe for deployments that do not call
        ``step()`` continuously. Idempotent."""
        if self._probe_thread is not None:
            return self._probe_thread
        self._probe_thread = threading.Thread(
            target=self._probe_loop, args=(float(interval_s),),
            name="fleet-probe", daemon=True)
        self._probe_thread.start()
        return self._probe_thread

    def _probe_loop(self, interval_s: float):
        while not self._probe_stop.wait(interval_s):
            self.probe()

    def stop_probe(self):
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None

    def health(self) -> str:
        """Fleet health for ``/healthz``: ``"ok"`` while ANY replica is
        in rotation; ``"draining"`` when the rest are only finishing
        work; ``"recovering"`` when replicas may come back; ``"dead"``
        when nothing is left."""
        with self._lock:
            states = [r.state for r in self._replicas.values()]
        if any(s == HEALTHY for s in states):
            return "ok"
        if any(s in (RECOVERING, FAILED) for s in states):
            return "recovering"
        if any(s == DRAINING for s in states):
            return "draining"
        return "dead"

    def statusz(self) -> dict:
        """Fleet ``/statusz``: per-replica placement state + engine
        snapshot, the route count, and the fleet counters."""
        with self._lock:
            reps = list(self._replicas.values())
            routes = len(self._routes)
            pending = len(self._dead_reaped)
            counters = {
                "tick": self._tick,
                "submitted": self._submitted,
                "admitted": self._admitted,
                "shed": self._shed,
                "spillovers": self._spillovers,
                "migrated": self._migrated,
                "lost": self._lost,
                "replica_deaths": self._deaths,
                "rolling_restart": self._rolling is not None,
            }
        replicas = {}
        for rep in reps:
            info = {"state": rep.state, "slot": rep.slot,
                    "admitted": rep.admitted, "shed": rep.shed,
                    "migrated_in": rep.migrated_in,
                    "migrated_out": rep.migrated_out}
            if rep.state in STEPPABLE:
                info["statusz"] = rep.serving.statusz()
            replicas[rep.replica_id] = info
        out = {
            "health": self.health(),
            "replicas": replicas,
            "placeable": self._placeable_count(),
            "routes": routes,
            "unreaped_terminal": pending,
        }
        out.update(counters)
        return out

    def start_ops_server(self, port: int = 0, host: str = "127.0.0.1"):
        """Fleet-level ``/metrics``, ``/healthz``, ``/statusz`` — the one
        scrape endpoint over the shared registry (per-replica series are
        separable by their ``replica`` label)."""
        if self._ops_server is not None:
            return self._ops_server
        from deepspeed_tpu_torch.telemetry.ops_server import OpsServer

        self._ops_server = OpsServer(
            registry=self._tele.registry, health=self.health,
            status=self.statusz, host=host, port=port).start()
        return self._ops_server

    # -- aggregate views (the loadgen drives these) --------------------
    def steppable_engines(self) -> List[Tuple[str, object]]:
        """``(replica_id, serving_engine)`` for every in-rotation replica
        — the autoscaler's actuation surface (per-engine ``kv_budget``
        tightening on the degradation ladder)."""
        with self._lock:
            return [(r.replica_id, r.serving)
                    for r in self._replicas.values()
                    if r.state in STEPPABLE]

    @property
    def vocab_size(self) -> int:
        return next(iter(self._replicas.values())).serving.vocab_size

    def committed_tokens(self) -> int:
        return sum(rep.serving.committed_tokens()
                   for rep in self._replicas.values()
                   if rep.state in STEPPABLE)

    def tick_stats(self) -> dict:
        """Summed tick accounting across live replicas, with the derived
        ratios recomputed fleet-wide."""
        out: Dict[str, float] = {}
        for rep in self._replicas.values():
            if rep.state not in STEPPABLE:
                continue
            for k, v in rep.serving.tick_stats().items():
                if k in _DERIVED_TICK_FIELDS or not isinstance(
                        v, (int, float)) or isinstance(v, bool):
                    continue
                out[k] = out.get(k, 0) + v
        ticks = out.get("ticks", 0)
        tokens = out.get("tokens", 0)
        cap = out.get("capacity_tokens", 0)
        host = out.get("dispatch_ms", 0.0) + out.get("block_ms", 0.0)
        out["mean_emitted_per_tick"] = (round(tokens / ticks, 3)
                                        if ticks else 0.0)
        out["block_ms_per_token"] = (round(out.get("block_ms", 0.0) / tokens,
                                           4) if tokens else None)
        out["overlap_frac"] = (round(1.0 - out.get("block_ms", 0.0) / host, 4)
                               if host > 0 else None)
        out["utilization"] = round(tokens / cap, 4) if cap else 0.0
        return out

    def recovery_stats(self) -> dict:
        """Summed engine recovery accounting plus the fleet's own:
        migrations, losses, deaths, spillovers."""
        out: Dict[str, float] = {}
        for rep in self._replicas.values():
            for k, v in rep.serving.recovery_stats().items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out[k] = round(out.get(k, 0) + v, 3)
        out["fleet_migrated"] = self._migrated
        out["fleet_lost"] = self._lost
        out["fleet_replica_deaths"] = self._deaths
        out["fleet_spillovers"] = self._spillovers
        return out

    def close(self):
        """Shut the fleet down: probe thread, ops server, every replica
        (their telemetry facades are no-op closers), then the ONE base
        hub — flushed exactly once."""
        if self._closed:
            return
        self._closed = True
        self.stop_probe()
        if self._ops_server is not None:
            self._ops_server.close()
            self._ops_server = None
        self._flush_events()
        for rep in self._replicas.values():
            try:
                rep.serving.close()
            except Exception:  # noqa: BLE001 — shutdown must not raise
                pass
        try:
            self._tele.close()
        except Exception:  # noqa: BLE001 — shutdown must not raise
            pass

    # -- internals ------------------------------------------------------
    def _replica(self, replica_id: str) -> Replica:
        rep = self._replicas.get(replica_id)
        if rep is None:
            raise KeyError(f"unknown replica {replica_id!r} "
                           f"(have {sorted(self._replicas)})")
        return rep

    def _placeable_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.state in PLACEABLE)

    def _event(self, payload: dict):
        if self._tele is not None and self._tele.enabled:
            self._tele.emit("router_event", payload)

    def _flush_events(self):
        """Emit probe-thread-enqueued state changes from the main thread
        (the trace writer is not thread-safe)."""
        with self._lock:
            pending, self._pending_events = self._pending_events, []
        for payload in pending:
            self._event(payload)

    def _counter(self, name: str, n: float = 1.0):
        if self._tele is not None and self._tele.enabled:
            self._tele.registry.counter(name).inc(n)

    def _update_gauges(self):
        if self._tele is None or not self._tele.enabled:
            return
        reg = self._tele.registry
        reg.gauge("fleet_replicas").set(self._placeable_count())
        reg.gauge("fleet_queue_depth").set(
            sum(rep.serving.queue_depth() for rep in self._replicas.values()
                if rep.state in STEPPABLE))
        reg.gauge("fleet_committed_tokens").set(self.committed_tokens())
