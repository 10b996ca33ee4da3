"""SLO-aware serving front end over :class:`ContinuousBatchingEngine`
(counterpart of ``deepspeed_tpu/serving/engine.py``), on one device.

The batching engine (inference/continuous.py) is a fast decode loop with
an UNBOUNDED pending list drained FIFO-with-skip: fine for a script, not
a server. :class:`ServingEngine` adds the layer a server needs, without
touching the hot path; it is host bookkeeping only and adds no wait on
the device to a tick:

- **Bounded admission + backpressure**: ``submit`` returns an
  :class:`Admission` verdict — ``admitted`` (handed to the engine now),
  ``queued`` (bounded queue), or ``shed`` (queue full / KV token budget
  exceeded; nothing enqueued, retry-after hint attached).
- **Pluggable scheduling**: FIFO, strict priority, earliest-deadline-
  first, per-tenant fair share (serving/policies.py), all subject to one
  anti-starvation aging rule: a request whose queue wait exceeds
  ``aging_s`` can no longer be leapfrogged.
- **Request lifecycle**: cancellation frees the pool slot mid-flight,
  per-token streaming (callback or pull iterator), and queued work whose
  deadline has blown is shed instead of decoded uselessly.
- **Pipelined drive**: the serving loop drives the engine's
  dispatch-ahead tick pipeline (``pipeline_depth``; ``0`` is the
  synchronous loop, token streams bitwise identical).
- **Fault tolerance** (armed by ``engine_factory=``/``recovery=``): a
  failed engine tick enters an escalation ladder — bounded
  retry-with-backoff for clean (pre-mutation) failures, then engine
  rebuild with every running request re-admitted mid-stream (``prompt +
  emitted``, same engine rid, ``gen_base=len(emitted)``) so recovered
  token streams are BITWISE identical to the fault-free run. While the
  circuit breaker is open, new admissions shed with reason
  ``"recovering"`` and an honest ``retry_after_s``; requests recovery
  cannot re-admit terminate ``shed`` — never a silent drop. Terminal
  failure (every level exhausted) raises :class:`RecoveryFailed`.
- **Telemetry**: every lifecycle transition counts
  (``serve_admitted/shed/expired/cancelled/finished_total``,
  ``serve_deadline_met/missed_total``, ``serve_queue_depth`` /
  ``serve_committed_tokens`` gauges); finished requests'
  ``inference_request`` events are enriched in place (via the engine's
  ``request_event_hook``) with ``path:"serving"``, ``queue_ms``,
  ``ttft_ms``, ``priority``, ``tenant``, ``deadline_ms``/``deadline_met``.
- **Request tracing**: every admitted request carries a ``trace_id``
  (optionally sampled via ``span_sampler=``) and the lifecycle emits
  causally linked ``span`` events — queue/admission here, tick windows
  via the engine's ``span_hook``, recovery_replay on rebuild — that
  ``telemetry/timeline.py`` reconstructs into one per-request timeline
  with critical-path attribution.

Rebuilds may degrade onto smaller serving meshes (``degrade_mesh_shapes``,
the reference's ladder): the serving layer runs on the world's rank 0 and
the meshes' other ranks serve the engines it builds (``inference/mesh.py``).
The process groups of every rung are made when the layer is built, never
mid-serve.

Not ported (``NotImplementedError``, ROADMAP.md Queue 1): the device-memory
headroom (``hbm_headroom_bytes``, and ``statusz``'s ``hbm_*`` keys, which
are absent; item 11 (b)).

Single-threaded by design, like the engine it wraps: the caller (or
``serving/loadgen.py``) drives ``step()``; everything is deterministic
given the injected ``clock``, which is what makes the scheduler-policy
tests exact.

    cb = ContinuousBatchingEngine(model, config=..., cache_buckets=...)
    srv = ServingEngine(cb, policy="edf", max_queue_depth=32)
    adm = srv.submit(prompt, max_new_tokens=64, deadline_ms=500)
    if adm:                       # admitted or queued (falsy == shed)
        for tok in srv.stream(adm.rid):
            ...                   # pulls srv.step() under the hood
"""

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.serving.faults import EnginePreempted
from deepspeed_tpu_torch.serving.policies import SchedulerPolicy, resolve_policy
from deepspeed_tpu_torch.serving.recovery import (
    RecoveryConfig,
    RecoveryFailed,
    RecoveryLog,
    snapshot_request,
)
from deepspeed_tpu_torch.serving.request import (
    ADMITTED,
    CANCELLED,
    EXPIRED,
    FINISHED,
    QUEUED,
    QUEUED_STATUS,
    RUNNING,
    SHED,
    TERMINAL_STATES,
    Admission,
    ServeRequest,
)
from deepspeed_tpu_torch.telemetry.spans import SpanEmitter
from deepspeed_tpu_torch.parallel.partition import serving_mesh
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import logger


class TokenStream:
    """Pull-based per-token iterator over one request's output. Each
    ``next()`` returns the next generated token, driving
    ``ServingEngine.step()`` as needed; iteration ends when the request
    reaches a terminal state (check ``request.state`` to tell a finished
    stream from a cancelled/expired one)."""

    def __init__(self, serving: "ServingEngine", request: ServeRequest):
        self._serving = serving
        self._request = request
        self._i = 0

    @property
    def request(self) -> ServeRequest:
        return self._request

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        while self._i >= len(self._request.tokens):
            req = self._request
            if req.state in TERMINAL_STATES:
                raise StopIteration
            if not self._serving.has_work():
                raise StopIteration
            if not self._serving._tracks(req):
                # orphaned: the request claims to be live but the serving
                # layer no longer holds it anywhere work could reach it
                # (e.g. someone cancelled its engine rid directly) —
                # stepping an engine that will never emit for this rid
                # again would spin forever. Terminate with the full lost-
                # request bookkeeping (counters, serving_event, recovery-
                # log retirement), never a silent state flip.
                self._serving._mark_lost(req, "orphaned mid-stream: the "
                                              "engine no longer tracks it")
                raise StopIteration
            self._serving.step()
        tok = self._request.tokens[self._i]
        self._i += 1
        return tok


class ServingEngine:
    """Admission control + scheduling + lifecycle over a
    :class:`ContinuousBatchingEngine` (which this object then owns: it
    installs the request-event hook and expects to be the only caller of
    ``engine.submit``/``step``)."""

    def __init__(self, engine, policy="fifo", max_queue_depth: int = 64,
                 kv_budget_tokens: Optional[int] = None,
                 aging_s: float = 30.0, clock=time.monotonic,
                 pipeline_depth: Optional[int] = None,
                 engine_factory: Optional[Callable] = None,
                 degrade_mesh_shapes: Optional[List[dict]] = None,
                 recovery=None, sleep=time.sleep,
                 span_sampler: Optional[Callable[[int], bool]] = None):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if aging_s <= 0:
            raise ValueError("aging_s must be > 0")
        for shape in degrade_mesh_shapes or []:
            # every rung's process groups now: making a group is collective
            # over the world, which a rebuild mid-serve must not wait on
            serving_mesh(int(shape.get("data", 1)), int(shape.get("tensor", 1)))
        if pipeline_depth is not None:
            if pipeline_depth < 0:
                raise ValueError("pipeline_depth must be >= 0")
            # the serving layer drives the engine's dispatch-pipelined tick
            # loop; None keeps whatever the engine was constructed with
            # (default: 1 tick in flight)
            engine.pipeline_depth = pipeline_depth
        self._cb = engine
        # -- fault tolerance ---------------------------------------------
        # Recovery is armed when a rebuild factory or an explicit
        # RecoveryConfig is given; otherwise tick exceptions propagate
        # raw, exactly as before this layer existed.
        #   engine_factory(mesh_shape=None) -> ContinuousBatchingEngine
        # builds a replacement engine after a preemption/poisoned tick
        # (build with telemetry OFF: the serving layer re-injects its own
        # hub so counters and the trace file stay continuous);
        # degrade_mesh_shapes lists successively smaller mesh shapes to
        # fall back to when the full-size rebuild fails or a preemption
        # took capacity with it (graceful degradation).
        self.engine_factory = engine_factory
        self.degrade_mesh_shapes = list(degrade_mesh_shapes or [])
        self.recovery_cfg = RecoveryConfig.parse(recovery)
        self._recovery_enabled = (engine_factory is not None
                                  or recovery is not None)
        if self.recovery_cfg.fetch_timeout_s is not None:
            engine.fetch_timeout_s = self.recovery_cfg.fetch_timeout_s
        self._pipeline_depth = pipeline_depth
        self._sleep = sleep
        self._recovery_log = RecoveryLog()
        # highest engine rid ever assigned (+1): a rebuilt engine's rid
        # counter resumes here, so a new request after a recovery gets
        # the same engine rid — hence the same per-request RNG stream —
        # it would have gotten in the fault-free run
        self._rid_watermark = 0
        self._breaker_open = False
        self._outage_start: Optional[float] = None
        self._consecutive_failures = 0
        self._fault_count = 0
        self._retry_count = 0
        self._rebuild_count = 0
        self._lost_ticks = 0
        self._lost_requests = 0
        self._degrade_level = 0          # 0 = full mesh, i = degrade_mesh_shapes[i-1]
        self._recovery_ms: List[float] = []
        self._outage_ms_total = 0.0
        self._closed = False
        # serving-level prefix registry: stable ids that survive engine
        # rebuilds (tokens kept host-side, re-registered on the new engine)
        self._prefixes: Dict[int, np.ndarray] = {}
        self._prefix_pids: Dict[int, int] = {}   # serving pid -> engine pid
        self._next_prefix_id = 0
        self.policy: SchedulerPolicy = resolve_policy(policy, aging_s=aging_s)
        self.max_queue_depth = max_queue_depth
        # KV token budget: total prompt+output tokens committed across
        # RUNNING + QUEUED requests. Default 2x the slot-pool capacity —
        # one poolful decoding plus one poolful staged behind it; more
        # than that is queue wait the client should see as backpressure.
        cap = sum(p["slots"] * p["length"] for p in engine.pool_state())
        self.kv_budget_tokens = (kv_budget_tokens if kv_budget_tokens is not None
                                 else 2 * cap)
        if self.kv_budget_tokens < 1:
            raise ValueError("kv_budget_tokens must be >= 1")
        self.aging_s = aging_s
        self._clock = clock
        self._created = clock()   # uptime zero for /statusz
        self._draining = False    # drain(): admission closed, work finishes
        self._ops_server = None   # live ops plane (start_ops_server)
        # Ops-plane read lock: the exporter's
        # handler threads call health()/statusz()/tick_stats() while the
        # tick loop runs. The ONE discipline: those readers hold this
        # RLock; the tick loop takes it only around the engine swap in
        # _restore_onto (the single multi-step mutation whose
        # intermediate states — half-restored engine, cleared _running —
        # must never be scraped). Everything else the readers touch is
        # either read under the lock as an atomic copy (list/dict of a
        # container the main thread mutates in place) or a single
        # attribute load. step() itself never takes the lock: a scrape
        # can never block the hot path on device work.
        self._ops_lock = threading.RLock()
        self._tele = engine._eng.telemetry
        self._queue: List[ServeRequest] = []
        self._running: Dict[int, ServeRequest] = {}   # engine rid -> request
        self._requests: Dict[int, ServeRequest] = {}  # serving rid -> request
        # handed to the engine but not yet admitted by an engine tick: the
        # engine queues them in _pending, so pool_state() still reports
        # their slots free — admission math must reserve them explicitly
        self._staged: Dict[int, int] = {}             # engine rid -> need_tokens
        self._next_rid = 0
        self._t_start: Optional[float] = None  # first submit: rate clock zero
        self._tokens_done = 0                  # finished requests' tokens
        # committed (finished-request) tokens per tenant — the /statusz
        # fair-share view and serve_tenant_committed_tokens gauges
        self._tenant_tokens: Dict[str, int] = {}
        engine.request_event_hook = self._event_hook
        # -- request-scoped tracing ----------------------------------------
        # One SpanEmitter per serving engine; span ids are scope-unique so
        # several replicas sharing one trace file never collide. The
        # sampler (None = trace everything) decides per ORIGINAL serving
        # rid at submit; sampled-out requests get trace_id None and emit
        # no spans (their counters/events are untouched). The engine-side
        # span hook is installed only when the hub is live, so a disabled
        # build never pays the per-tick window bookkeeping.
        self._span_sampler = span_sampler
        self._spans = SpanEmitter(self._tele, clock=clock)
        self._drain_t0: Optional[float] = None  # drain() start, for drain_wait
        if self._tele.enabled:
            engine.span_hook = self._span_hook

    # -- public API -----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               priority: int = 0, tenant: str = "default",
               deadline_ms: Optional[float] = None,
               on_token=None, prefix_id: Optional[int] = None) -> Admission:
        """Admission-controlled submit. Malformed arguments raise
        ValueError (an oversized request can NEVER run — that is an
        error, not load); a well-formed one is admitted, queued, or shed
        with explicit backpressure. Shed requests get no id and leave no
        state behind. With ``prefix_id`` (``register_prefix``),
        ``prompt_ids`` is the per-request SUFFIX; admission splices the
        registered prefix KV and only the suffix is prefilled. While the
        circuit breaker is open (engine lost, recovery in progress) new
        work is shed with reason ``"recovering"`` and an honest
        ``retry_after_s`` covering the expected outage."""
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise KeyError(f"unknown prefix id {prefix_id}: never "
                               f"registered with this serving engine")
            suffix = np.asarray(prompt_ids, np.int32).reshape(-1)
            if suffix.size == 0:
                raise ValueError("empty suffix (use submit without "
                                 "prefix_id for prefix-only prompts)")
            prompt_ids = np.concatenate([self._prefixes[prefix_id], suffix])
        prompt = self._cb.validate_request(prompt_ids, max_new_tokens)
        need = int(prompt.size) + max_new_tokens
        if need > self.kv_budget_tokens:
            # structurally inadmissible: no amount of draining frees
            # enough budget, so a shed-with-retry-hint would loop forever
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"exceeds kv_budget_tokens {self.kv_budget_tokens}: this "
                f"request can never be admitted under the configured budget")
        now = self._clock()
        if self._t_start is None:
            self._t_start = now
        if self._draining:
            # the replica is being removed from the fleet: no retry hint —
            # the client must go to another replica, not wait for this one
            return self._shed("draining", prompt, need, now, no_hint=True)
        if self._breaker_open:
            # honest degradation: during an outage admission answers
            # immediately with a load-shed verdict + recovery ETA rather
            # than queueing work behind an engine that may never return
            return self._shed("recovering", prompt, need, now)
        if len(self._queue) >= self.max_queue_depth:
            return self._shed("queue_full", prompt, need, now)
        committed = self.committed_tokens()
        if committed + need > self.kv_budget_tokens:
            return self._shed("kv_budget", prompt, need, now,
                              excess=committed + need - self.kv_budget_tokens)
        rid = self._next_rid
        self._next_rid += 1
        req = ServeRequest(rid=rid, prompt=prompt,
                           max_new_tokens=max_new_tokens, priority=priority,
                           tenant=tenant, deadline_ms=deadline_ms,
                           on_token=on_token, submit_t=now,
                           prefix_id=prefix_id)
        if self._tele.enabled and (self._span_sampler is None
                                   or self._span_sampler(rid)):
            # trace identity = birth replica + original serving rid; it
            # rides the recovery entry unchanged, so spans emitted after a
            # migration still land on the SAME trace
            req.trace_id = f"{self._trace_scope()}{rid}"
        self._requests[rid] = req
        # empty queue + a fitting free slot: hand straight to the engine —
        # the strongest statement submit can truthfully make (with a
        # non-empty queue the policy decides, so the verdict is "queued")
        if not self._queue and self._fits_now(need):
            self._handover(req, now)
            status = ADMITTED
        else:
            self._queue.append(req)
            status = QUEUED_STATUS
        self._update_gauges()
        return Admission(status=status, rid=rid)

    def step(self) -> Dict[int, List[int]]:
        """One serving tick: expire deadline-blown queued work, place
        queued requests into free slots in policy order (bounded by the
        aging barrier), then one engine tick. Returns {rid: [tokens]}
        emitted this tick, keyed by SERVING rid."""
        now = self._clock()
        self._expire(now)
        self._schedule(now)
        out: Dict[int, List[int]] = {}
        if self._cb.has_work():
            emitted, ticked = self._guarded_tick()
            if ticked:
                # the engine admits every placeable pending request at the
                # top of its tick, and we only hand over what fits — so
                # after the tick the staged reservations are real slots
                # (pool_state now counts them) or already finished-and-
                # freed. A recovered (re-admitted) tick keeps its staged
                # reservations: the rebuilt engine has not ticked yet.
                self._staged.clear()
            tnow = self._clock()
            for erid, toks in emitted.items():
                req = self._running.get(erid)
                if req is None:
                    continue  # not ours (direct engine.submit user)
                if req.first_token_t is None and toks:
                    req.first_token_t = tnow
                req.tokens.extend(toks)
                self._recovery_log.extend(req.rid, toks)
                out[req.rid] = list(toks)
                if req.on_token is not None:
                    for tok in toks:
                        req.on_token(req.rid, tok)
            for erid, result in self._cb.finished().items():
                req = self._running.pop(erid, None)
                if req is None:
                    continue
                self._finish_request(req, result, tnow)
            if ticked and self._tele.enabled:
                s = self._cb.tick_stats()
                if s.get("spec_drafted"):
                    # live acceptance rate for /metrics + /statusz: the
                    # one number that says whether speculation is earning
                    # its verify FLOPs right now
                    self._tele.registry.gauge("serve_spec_acceptance").set(
                        round(s["spec_accepted"] / s["spec_drafted"], 4))
        if (self._drain_t0 is not None and self._draining
                and not self.has_work()):
            # the drain completed this tick: close the ops-scoped
            # drain_wait span (how long removal-from-rotation stalled on
            # in-flight work)
            self._spans.emit("drain_wait", f"{self._trace_scope()}ops",
                             self._drain_t0, self._clock())
            self._drain_t0 = None
        self._update_gauges()
        return out

    def _finish_request(self, req: ServeRequest, result, now: float):
        """The ONE FINISHED transition (normal retirement and recovered-
        complete synthesis both land here): record/result state, recovery
        log retirement, the deadline fallback verdict, rate accounting,
        policy hook, and the finished/deadline counters."""
        req.state = FINISHED
        req.finish_t = now
        req.result = result
        self._recovery_log.retire(req.rid)
        if req.deadline_ms is not None and req.deadline_met is None:
            # telemetry off: the event hook didn't judge it first
            req.deadline_met = now <= req.deadline_at
        self._tokens_done += len(req.tokens)
        self._tenant_tokens[req.tenant] = (
            self._tenant_tokens.get(req.tenant, 0) + len(req.tokens))
        self.policy.on_finish(req, now)
        if self._tele.enabled:
            reg = self._tele.registry
            reg.counter("serve_finished_total").inc()
            reg.gauge("serve_tenant_committed_tokens",
                      {"tenant": req.tenant}).set(
                self._tenant_tokens[req.tenant])
            if req.deadline_met is not None:
                reg.counter("serve_deadline_met_total" if req.deadline_met
                            else "serve_deadline_missed_total").inc()

    # -- fault tolerance ------------------------------------------------
    def _guarded_tick(self):
        """One engine tick under the recovery policy. Returns
        ``(emitted, ticked)`` — ``ticked`` False when the tick was lost
        to a fault and the engine was rebuilt (the re-admitted requests'
        staged reservations must survive until the NEW engine ticks).
        With recovery disarmed (no factory, no RecoveryConfig) this is a
        bare ``engine.step()`` — exceptions propagate unchanged."""
        if not self._recovery_enabled:
            return self._cb.step(), True
        try:
            emitted = self._cb.step()
        except Exception as e:  # noqa: BLE001 — any tick failure enters recovery
            return self._on_tick_failure(e)
        self._consecutive_failures = 0
        if self._breaker_open:
            self._close_breaker()
        return emitted, True

    def _on_tick_failure(self, exc: Exception):
        """The escalation ladder: bounded retry-with-backoff for a CLEAN
        failure (raised before the engine mutated state), then engine
        rebuild — on the full mesh first, then each configured degraded
        mesh. Ticks in flight on the lost engine are discarded, never
        fetched; the resume RNG design regenerates their tokens bitwise."""
        cfg = self.recovery_cfg
        now = self._clock()
        self._open_breaker(now)
        self._consecutive_failures += 1
        self._fault_count += 1
        self._fault_event("fault", error=type(exc).__name__,
                          detail=str(exc)[:200],
                          poisoned=bool(self._cb.poisoned),
                          consecutive=self._consecutive_failures)
        if self._tele.enabled:
            self._tele.registry.counter("serve_fault_total").inc()
        # a poisoned engine (exception past the dispatch barrier: results
        # lost mid-pipeline) or an explicit preemption must NOT be
        # retried — a retried tick would leave a hole in every stream
        retryable = not self._cb.poisoned and not isinstance(exc, EnginePreempted)
        if retryable:
            for attempt in range(cfg.max_tick_retries):
                self._sleep(cfg.backoff_s * (2 ** attempt))
                self._retry_count += 1
                if self._tele.enabled:
                    self._tele.registry.counter("serve_tick_retry_total").inc()
                try:
                    emitted = self._cb.step()
                except Exception as e2:  # noqa: BLE001 — retry outcome feeds escalation
                    self._consecutive_failures += 1
                    self._fault_count += 1
                    if self._tele.enabled:
                        # a failed retry IS another fault: the counter,
                        # recovery_stats()["faults"] and the trace-report
                        # recovery section must all agree on the total
                        self._tele.registry.counter("serve_fault_total").inc()
                    self._fault_event("retry_failed", attempt=attempt + 1,
                                      error=type(e2).__name__,
                                      consecutive=self._consecutive_failures)
                    exc = e2
                    if self._cb.poisoned or isinstance(e2, EnginePreempted):
                        break  # state lost mid-retry: straight to rebuild
                else:
                    # a real completed tick: tokens flow through the
                    # normal attribution path, staged slots are consumed
                    self._fault_event("retried", attempt=attempt + 1)
                    self._consecutive_failures = 0
                    self._close_breaker()
                    return emitted, True
        self._rebuild(exc)
        return {}, False

    def _rebuild(self, exc: Exception):
        """Abandon the engine and build a replacement, re-admitting every
        running request mid-stream (prompt + emitted, same engine rid,
        ``gen_base=len(emitted)`` — bitwise resume). Escalates through
        ``degrade_mesh_shapes`` when a build fails or the preemption took
        capacity; raises :class:`RecoveryFailed` (after marking every
        live request shed) when nothing can be built."""
        cfg = self.recovery_cfg
        t0 = self._clock()
        if self.engine_factory is None:
            self._fail_terminally(exc, "no engine_factory configured — "
                                       "cannot rebuild the lost engine")
        if self._rebuild_count >= cfg.max_rebuilds:
            self._fail_terminally(exc, f"max_rebuilds={cfg.max_rebuilds} "
                                       f"exhausted")
        lost = self._cb.abort_inflight()
        self._lost_ticks += lost
        old_hook = self._cb.fault_hook
        # degradation ladder: level 0 = the factory's full-size build,
        # level i = degrade_mesh_shapes[i-1]. A degrading preemption
        # advances the ladder before building; a failed build advances it
        # and tries again.
        shapes: List[Optional[dict]] = [None] + self.degrade_mesh_shapes
        if isinstance(exc, EnginePreempted) and exc.degrade:
            self._degrade_level = min(self._degrade_level + 1,
                                      len(shapes) - 1)
            if self._degrade_level == 0 or shapes[self._degrade_level] is None:
                logger.warning("preemption demanded degradation but no "
                               "degrade_mesh_shapes are configured — "
                               "rebuilding at full size")
        new = None
        while new is None:
            shape = shapes[self._degrade_level]
            try:
                new = self.engine_factory(mesh_shape=shape)
            except Exception as build_err:  # noqa: BLE001 — feeds the degradation ladder
                self._fault_event("rebuild_failed", mesh=shape,
                                  error=type(build_err).__name__,
                                  detail=str(build_err)[:200])
                if self._degrade_level + 1 < len(shapes):
                    self._degrade_level += 1
                else:
                    self._fail_terminally(
                        build_err, "engine_factory failed at every "
                                   "degradation level")
        try:
            # device-heavy restore (prefix re-prefill + re-admission) runs
            # against the replacement OFF the ops lock — a /healthz probe
            # must answer 503 "recovering" instantly, not block for the
            # whole rebuild; only the final multi-reference swap inside
            # _restore_onto takes _ops_lock (see the commit block there)
            readmitted = self._restore_onto(new, old_hook)
        except Exception as restore_err:  # noqa: BLE001 — restore failure is terminal
            # a replacement that cannot be restored (prefix prefill or
            # re-admission raised something other than a size rejection)
            # must still honour the contract: mark every live request
            # shed and SURFACE RecoveryFailed — never a raw escape that
            # leaves requests RUNNING against a half-restored engine
            self._fail_terminally(restore_err,
                                  "replacement engine could not be restored")
        recovery_ms = (self._clock() - t0) * 1000.0
        self._recovery_ms.append(recovery_ms)
        shape = shapes[self._degrade_level]
        self._fault_event("rebuild", recovery_ms=round(recovery_ms, 3),
                          readmitted=readmitted, lost_ticks=lost,
                          degraded=shape is not None, mesh=shape,
                          rebuilds=self._rebuild_count)
        if self._tele.enabled:
            reg = self._tele.registry
            reg.counter("serve_rebuild_total").inc()
            if lost:
                reg.counter("serve_lost_tick_total").inc(lost)
            reg.histogram("recovery_ms").observe(recovery_ms)
        logger.warning(
            f"serving engine rebuilt after {type(exc).__name__} "
            f"(#{self._rebuild_count}, {recovery_ms:.1f} ms, "
            f"{readmitted} re-admitted, {lost} in-flight ticks lost"
            + (f", degraded to mesh {shape}" if shape is not None else "")
            + ")")

    def _restore_onto(self, new, old_hook) -> int:
        """Make the replacement engine serve where the lost one stopped:
        adopt the telemetry hub and hooks, restore rid continuity and
        serving-level prefixes, and re-admit every running request
        mid-stream. Returns the re-admission count. Raises only when the
        replacement itself is unusable (the caller converts that into
        the terminal-failure path).

        Lock discipline: the device-heavy work (prefix re-prefill,
        re-admission prefills) targets only the replacement engine and
        LOCAL tables, off ``_ops_lock`` — a concurrent scrape keeps
        answering from the lost engine's last state (breaker open, so
        ``/healthz`` says 503 "recovering" instantly instead of blocking
        for the whole rebuild). Only the final multi-reference commit —
        engine swap + prefix/running/staged tables + the generation
        bump — runs under the lock, so ``statusz()``/``health()``/
        ``tick_stats()`` see the old engine or the fully restored one,
        never the in-between."""
        cfg = self.recovery_cfg
        # adopt the serving hub on the replacement: ONE trace writer and
        # metrics registry across engine generations (factories build
        # with telemetry off; a factory-created hub would re-open the
        # trace file and fork the counters)
        new._eng.telemetry = self._tele
        new.request_event_hook = self._event_hook
        new.fault_hook = old_hook
        if self._tele.enabled:
            new.span_hook = self._span_hook
        # (the reference's "rebuild" memory snapshot waits for the memory
        # accountant, ROADMAP Queue 1 item 11 (b))
        if self._pipeline_depth is not None:
            new.pipeline_depth = self._pipeline_depth
        if cfg.fetch_timeout_s is not None:
            new.fetch_timeout_s = cfg.fetch_timeout_s
        # rid continuity: new requests continue the rid sequence the lost
        # engine was on, so their RNG streams match the fault-free run
        new._next_rid = max(new._next_rid, self._rid_watermark)
        # serving-level prefixes survive: re-register on the new engine
        prefix_pids = {spid: new.register_prefix(toks)
                       for spid, toks in self._prefixes.items()}
        # re-admit every running request mid-stream, in the lost engine's
        # submission order (deterministic). The RecoveryLog — not the
        # live records — is the source of truth here: it is exactly the
        # plain host state a cross-process recovery would have.
        readmitted = 0
        running: Dict[int, ServeRequest] = {}
        staged: Dict[int, int] = {}
        for entry in self._recovery_log.entries():
            req = self._requests.get(entry["rid"])
            if req is None or req.state != RUNNING:
                self._recovery_log.retire(entry["rid"])
                continue
            emitted = entry["emitted"]
            remaining = entry["max_new_tokens"] - len(emitted)
            if remaining < 1:
                # every token surfaced but the finish never retired: the
                # stream is complete, finish it host-side
                self._finish_recovered(req, entry)
                continue
            full = np.concatenate([
                np.asarray(entry["prompt"], np.int32),
                np.asarray(emitted, np.int32)]) if emitted else req.prompt
            t0_replay = self._clock()
            try:
                erid = new.submit(full, remaining, rid=entry["engine_rid"],
                                  gen_base=len(emitted))
            except ValueError as e:
                # the degraded engine cannot hold it — shed honestly
                self._mark_lost(req, f"readmit_failed: {e}")
                continue
            running[erid] = req
            staged[erid] = req.need_tokens
            req.recoveries += 1
            readmitted += 1
            if req.trace_id is not None and self._spans.enabled:
                # in-process recovery: the replay span parents on the
                # request's root and becomes the parent of its post-
                # recovery tick windows — the timeline shows recovery
                # time as recovery, not mystery gap
                sid = self._spans.emit(
                    "recovery_replay", req.trace_id, t0_replay, self._clock(),
                    parent_id=req.span_root,
                    attrs={"gen_base": len(emitted),
                           "engine_rid": int(erid)})
                req.span_parent = sid
        # commit: the one multi-step mutation a scrape must never observe
        # half-done (the _ops_lock read/swap discipline)
        with self._ops_lock:
            self._cb = new
            self._prefix_pids = prefix_pids
            self._running = running
            self._staged.clear()
            self._staged.update(staged)
            self._rebuild_count += 1
        return readmitted

    def _finish_recovered(self, req: ServeRequest, entry: dict):
        """A lost request whose stream was already complete host-side:
        synthesize the result (and the ``inference_request`` event the
        lost engine never got to retire — trace-derived finished counts
        must match the registry counters), then run the one shared
        FINISHED transition."""
        if self._tele.enabled:
            event = {"request": int(req.rid), "path": "continuous",
                     "batch": 1, "prompt_tokens": len(entry["prompt"]),
                     "new_tokens": len(entry["emitted"]),
                     "recovered_finish": True}
            # enrich through the one enrichment path (queue_ms/ttft/
            # priority/tenant + the single SLO verdict) with the request
            # in hand — never a transient write to the live _running
            # table (this runs off _ops_lock during restore; a scrape
            # could observe the intermediate entry)
            event = self._enrich_event(req, event) or event
            self._tele.emit("inference_request", event)
        self._finish_request(req, np.concatenate([
            np.asarray(entry["prompt"], np.int32),
            np.asarray(entry["emitted"], np.int32)]), self._clock())

    def _mark_lost(self, req: ServeRequest, reason: str):
        """Terminal shed for a request recovery could not re-admit: the
        honest outcome — never a silent drop (the conservation invariant
        admitted == finished + shed + expired + cancelled holds)."""
        now = self._clock()
        req.state = SHED
        req.finish_t = now
        self._running = {erid: r for erid, r in self._running.items()
                         if r.rid != req.rid}
        self._queue = [r for r in self._queue if r.rid != req.rid]
        self._recovery_log.retire(req.rid)
        self._lost_requests += 1
        if self._tele.enabled:
            self._tele.registry.counter("serve_lost_request_total").inc()
            self._tele.emit("serving_event", {
                "event": "shed", "reason": "engine_lost", "request": req.rid,
                "detail": reason[:200], "tokens_emitted": len(req.tokens),
            })

    def _fail_terminally(self, exc: Exception, detail: str):
        """Recovery exhausted: mark every live request shed (streams
        terminate, accounting stays conservative), emit the terminal
        fault event, and raise :class:`RecoveryFailed` — ``run()`` and
        ``step()`` SURFACE this; nothing swallows it."""
        # gather from the record table, not _queue/_running: a failure
        # mid-restore leaves _running only partially rebuilt, and every
        # live request must still be accounted for
        live = [r for r in self._requests.values()
                if r.state not in TERMINAL_STATES]
        for req in live:
            self._mark_lost(req, f"unrecoverable: {detail}")
        self._fault_event("unrecoverable", error=type(exc).__name__,
                          detail=detail, requests_lost=len(live))
        self._update_gauges()
        raise RecoveryFailed(
            f"serving recovery failed ({detail}); last engine fault: "
            f"{type(exc).__name__}: {exc}. {len(live)} in-flight "
            f"request(s) marked shed.") from exc

    def _open_breaker(self, now: float):
        if self._breaker_open:
            return
        with self._ops_lock:  # serialize with statusz(): its health/
            # breaker_open fields must come from one consistent state
            self._breaker_open = True
            self._outage_start = now
        self._fault_event("breaker", state="open")

    def _close_breaker(self):
        if not self._breaker_open:
            return
        now = self._clock()
        outage_ms = ((now - self._outage_start) * 1000.0
                     if self._outage_start is not None else 0.0)
        with self._ops_lock:
            self._outage_ms_total += outage_ms
            self._breaker_open = False
            self._outage_start = None
        self._fault_event("breaker", state="closed",
                          outage_ms=round(outage_ms, 3))

    def _fault_event(self, event: str, **fields):
        if self._tele.enabled:
            payload = {"event": event}
            payload.update(fields)
            self._tele.emit("serving_fault", payload)

    def recovery_stats(self) -> dict:
        """In-process view of the fault/recovery accounting (what
        ``loadgen --chaos`` reports; a trace report recomputes it from
        ``serving_fault`` trace events)."""
        out = {
            "faults": self._fault_count,
            "retries": self._retry_count,
            "rebuilds": self._rebuild_count,
            "lost_ticks": self._lost_ticks,
            "lost_requests": self._lost_requests,
            "degrade_level": self._degrade_level,
            "outage_ms_total": round(self._outage_ms_total, 3),
            "breaker_open": self._breaker_open,
        }
        if self._recovery_ms:
            # the same interpolated percentile a trace report computes
            # from the serving_fault journal
            from deepspeed_tpu_torch.telemetry.registry import percentile

            rs = sorted(self._recovery_ms)
            out["recovery_ms"] = {
                "count": len(rs),
                "p50": round(percentile(rs, 50.0), 3),
                "max": round(rs[-1], 3),
            }
        return out

    def register_prefix(self, prefix_ids) -> int:
        """Serving-level prefix registration: like the engine's
        ``register_prefix`` but with an id that stays valid across
        engine rebuilds (the tokens are kept host-side and re-registered
        on every replacement engine)."""
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        epid = self._cb.register_prefix(prefix)  # validates + prefills
        spid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[spid] = prefix
        self._prefix_pids[spid] = epid
        return spid

    def unregister_prefix(self, prefix_id: int):
        if prefix_id not in self._prefixes:
            raise KeyError(f"unknown prefix id {prefix_id}")
        self._prefixes.pop(prefix_id)
        epid = self._prefix_pids.pop(prefix_id)
        self._cb.unregister_prefix(epid)

    def _tracks(self, req: ServeRequest) -> bool:
        """Whether serving still holds ``req`` somewhere a ``step()`` can
        make progress on it — the TokenStream spin guard."""
        if req.state == QUEUED:
            return any(r.rid == req.rid for r in self._queue)
        if req.state == RUNNING:
            return any(r.rid == req.rid for r in self._running.values())
        return False

    def run(self, max_ticks: Optional[int] = None) -> int:
        """Step until idle (or ``max_ticks``); returns ticks taken.
        A terminal recovery failure (:class:`RecoveryFailed` — retries
        and every rebuild level exhausted) propagates to the caller; it
        is never swallowed into a normal-looking return."""
        ticks = 0
        while self.has_work():
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.step()
            ticks += 1
        return ticks

    def has_work(self) -> bool:
        return bool(self._queue) or self._cb.has_work()

    def queue_depth(self) -> int:
        return len(self._queue)

    # -- live ops plane ------------------------------------------------
    def drain(self):
        """Stop admission while queued + running work runs to completion
        — the fleet-router precondition for removing a replica: after
        ``drain()``, ``submit`` sheds with reason ``"draining"`` (no
        retry hint: clients must go elsewhere), ``/healthz`` answers 503,
        and ``step()`` keeps serving until ``has_work()`` is False —
        in-flight streams finish bitwise-intact. Idempotent; ``resume()``
        reopens admission."""
        if self._draining:
            return
        with self._ops_lock:  # consistent with a concurrent statusz()
            self._draining = True
        # drain_wait span clock zero: step() closes the span (under the
        # replica's ops trace id) once the last in-flight stream retires
        self._drain_t0 = self._clock() if self.has_work() else None
        if self._tele.enabled:
            self._tele.emit("serving_event", {
                "event": "drain", "queue_depth": len(self._queue),
                "running": len(self._running)})

    def resume(self):
        """Reopen admission after :meth:`drain` (replica back in rotation)."""
        if not self._draining:
            return
        with self._ops_lock:
            self._draining = False
        self._drain_t0 = None  # drain aborted: no drain_wait span
        if self._tele.enabled:
            self._tele.emit("serving_event", {"event": "resume"})

    @property
    def draining(self) -> bool:
        return self._draining

    def health(self) -> str:
        """One-word replica health for ``/healthz``:

        - ``"recovering"`` — the circuit breaker is open (engine lost,
          the recovery ladder is running); closes on the first
          healthy tick of a replacement.
        - ``"poisoned"`` — the engine marked its state untrustworthy and
          NO recovery is armed to replace it: operator intervention.
        - ``"draining"`` — admission closed, in-flight work finishing.
        - ``"ok"`` — take traffic.

        Only ``"ok"`` answers HTTP 200 on ``/healthz``."""
        with self._ops_lock:  # exporter-thread read discipline
            if self._breaker_open:
                return "recovering"
            if getattr(self._cb, "poisoned", False):
                return "poisoned"
            if self._draining:
                return "draining"
            return "ok"

    def statusz(self) -> dict:
        """One JSON-shaped snapshot for ``/statusz``: health, uptime,
        pool occupancy, queue depth, committed KV tokens, in-flight tick
        depth, tick overlap accounting, recovery generation, and the
        device-memory attribution where it is ported. Read-only and safe to call from the
        ops-server thread: the whole read runs under ``_ops_lock`` (the
        shared read/swap discipline — a recovery rebuild can therefore
        never swap ``_cb`` out from under a half-built snapshot), with
        shared containers additionally copied atomically before
        iteration so a concurrent ``step()`` can never torn-read them."""
        with self._ops_lock:
            now = self._clock()
            queue = list(self._queue)
            running = list(dict(self._running).values())
            requests = list(dict(self._requests).values())
            counts: Dict[str, int] = {}
            for r in requests:
                counts[r.state] = counts.get(r.state, 0) + 1
            stats = self.tick_stats()
            out = {
                "health": self.health(),
                "uptime_s": round(now - self._created, 3),
                "draining": self._draining,
                "pools": self._cb.pool_state(),
                "queue_depth": len(queue),
                "running": len(running),
                "requests": counts,
                "committed_kv_tokens": (sum(r.need_tokens for r in queue)
                                        + sum(r.need_tokens for r in running)),
                "kv_budget_tokens": self.kv_budget_tokens,
                "inflight_depth": len(self._cb._inflight),
                "pipeline_depth": self._cb.pipeline_depth,
                "ticks": stats.get("ticks", 0),
                "overlap_frac": stats.get("overlap_frac"),
                "block_ms_per_token": stats.get("block_ms_per_token"),
                "recovery_generation": self._rebuild_count,
                "breaker_open": self._breaker_open,
                # speculative decode health: lifetime acceptance rate
                # (accepted drafts / proposed drafts; None = speculation
                # never ran) — mirrors the serve_spec_acceptance gauge
                "spec_acceptance": stats.get("spec_acceptance"),
                # committed (finished-request) tokens per tenant — the
                # fair-share ledger behind the per-tenant
                # serve_tenant_committed_tokens gauges
                "tenant_committed_tokens": dict(self._tenant_tokens),
                # queue residue: how much admitted-but-unfinished work
                # this replica still owes. "draining with residue" means
                # don't place here, but the work WILL finish; "breaker
                # open" means don't place here, the work may die — a
                # fleet router (or any external probe) must not conflate
                # the two when deciding whether to wait or migrate.
                "residue_queued": len(queue),
                "residue_running": len(running),
                "residue_tokens": (
                    sum(max(0, r.max_new_tokens - len(r.tokens))
                        for r in queue)
                    + sum(max(0, r.max_new_tokens - len(r.tokens))
                          for r in running)),
            }
            try:
                # the device-memory attribution is not ported (ROADMAP
                # Queue 1 item 11 (b)): hbm_components raises, and the
                # hbm_* keys are simply absent
                out["hbm_bytes"] = self._cb.hbm_components()
            except Exception:  # noqa: BLE001 — status must render even mid-rebuild
                pass
            return out

    def hbm_headroom_bytes(self) -> Optional[int]:
        """Per-device memory headroom (configured/backend limit minus the live
        attribution) — the number an admission policy or the fleet router
        consults before placing more KV on this replica. None when no
        limit is known. Not ported: it needs the memory accountant."""
        raise not_ported("hbm_headroom_bytes (the device-memory accountant, "
                         "telemetry/memory.py; ROADMAP Queue 1 item 11 (b))")

    def start_ops_server(self, port: int = 0, host: str = "127.0.0.1"):
        """Serve ``/metrics`` (Prometheus), ``/healthz`` and ``/statusz``
        for this replica on a daemon thread (telemetry/ops_server.py).
        ``port=0`` binds an ephemeral port — read it from the returned
        server's ``.port``/``.url``. Idempotent (returns the live
        server); ``close()`` shuts it down."""
        if self._ops_server is not None:
            return self._ops_server
        from deepspeed_tpu_torch.telemetry.ops_server import OpsServer

        self._ops_server = OpsServer(
            registry=self._tele.registry, health=self.health,
            status=self.statusz, host=host, port=port).start()
        return self._ops_server

    def committed_tokens(self) -> int:
        """Prompt+output tokens committed by queued + running requests —
        what admission weighs against ``kv_budget_tokens``."""
        return (sum(r.need_tokens for r in self._queue)
                + sum(r.need_tokens for r in self._running.values()))

    def tick_stats(self) -> dict:
        """Tick-utilization accounting for the serving loop: the engine's
        dispatch/block/overlap numbers (``ContinuousBatchingEngine.
        tick_stats``) plus ``utilization`` — fraction of the dispatched
        emission capacity actually emitted (tokens / capacity_tokens,
        where each ticked pool contributes slots × burst). This is the
        in-process view of what a trace report computes from
        ``serving_tick`` trace events, and what the loadgen's
        ``--ab-pipeline`` compares."""
        with self._ops_lock:  # exporter-thread read discipline
            s = self._cb.tick_stats()
        cap = s.get("capacity_tokens", 0)
        s["utilization"] = round(s["tokens"] / cap, 4) if cap else 0.0
        return s

    def status(self, rid: int) -> str:
        req = self._requests.get(rid)
        return req.state if req is not None else "unknown"

    def request(self, rid: int) -> Optional[ServeRequest]:
        """The live request record (None once reaped or never admitted)."""
        return self._requests.get(rid)

    def result(self, rid: int):
        """Pop a FINISHED request's full token array (prompt + generated).
        Raises KeyError naming the actual state otherwise — mirrors
        ``ContinuousBatchingEngine.result`` semantics."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"no result for request {rid}: unknown — never "
                           f"admitted, shed, or already reaped")
        if req.state != FINISHED:
            raise KeyError(f"no result for request {rid}: {req.state}")
        self._requests.pop(rid)
        return req.result

    def reap(self) -> Dict[int, ServeRequest]:
        """Remove and return every terminal-state request record —
        finished (``.result`` holds the tokens), cancelled, and expired.
        A long-running server calls this (or ``result``) to keep the
        record table bounded; the load generator uses it for reporting."""
        done = {rid: r for rid, r in self._requests.items()
                if r.state in TERMINAL_STATES}
        for rid in done:
            self._requests.pop(rid)
        return done

    def close(self):
        """Flush/close the telemetry trace (the engines share one hub,
        including across rebuilds); the load generator and servers call
        this at shutdown. Idempotent and fault-safe: double close and
        close during/after a (possibly failed) recovery are no-ops —
        shutdown paths run from exception handlers and must never raise."""
        if self._closed:
            return
        self._closed = True
        if self._ops_server is not None:
            self._ops_server.close()  # never raises
            self._ops_server = None
        try:
            self._tele.close()
        except Exception as e:  # noqa: BLE001 — shutdown must not raise
            logger.warning(f"serving close: telemetry close failed ({e})")

    def stream(self, rid: int) -> TokenStream:
        """Per-token pull iterator for an admitted/queued request; tokens
        already emitted are replayed first, then each ``next()`` drives
        ``step()`` until the next token or a terminal state."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request {rid}: shed or already reaped")
        return TokenStream(self, req)

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request. A running one frees its
        pool slot immediately — the next ``step()`` can admit into it.
        False when already terminal/unknown (nothing left to cancel)."""
        req = self._requests.get(rid)
        if req is None or req.state in TERMINAL_STATES:
            return False
        now = self._clock()
        if req.state == QUEUED:
            self._queue = [r for r in self._queue if r.rid != rid]
        else:  # RUNNING
            self._cb.cancel(req.engine_rid)
            self._running.pop(req.engine_rid, None)
            self._staged.pop(req.engine_rid, None)
            self._recovery_log.retire(rid)
        req.state = CANCELLED
        req.finish_t = now
        if self._tele.enabled:
            self._tele.registry.counter("serve_cancelled_total").inc()
            self._tele.emit("serving_event", {
                "event": "cancelled", "request": rid,
                "queue_ms": round(req.waited_s(now) * 1000.0, 3),
                "tokens_emitted": len(req.tokens),
            })
        self._update_gauges()
        return True

    # -- fleet membership (serving/router.py) ---------------------------
    @property
    def vocab_size(self) -> int:
        """The engine's vocabulary size — surfaced so fleet-level callers
        (router, load generator) never reach into ``_cb.cfg``."""
        return self._cb.cfg.vocab_size

    def set_rid_base(self, base: int):
        """Partition the engine-rid namespace for fleet membership: every
        rid this replica assigns naturally from now on is ``>= base``.
        The fleet router gives each replica slot a disjoint stride so a
        migrated request's pinned engine rid (its RNG identity, hence its
        bitwise token stream) can never collide with a rid the survivor
        hands out on its own. Slot 0 keeps base 0 — a single-replica
        fleet is rid-for-rid identical to a bare serving engine."""
        self._rid_watermark = max(self._rid_watermark, int(base))
        self._cb._next_rid = max(self._cb._next_rid, int(base))

    def admission_outlook(self, need_tokens: int):
        """What :meth:`submit` would answer RIGHT NOW for a well-formed
        request committing ``need_tokens`` — ``(status, reason)`` with no
        side effects: nothing is admitted, queued, or counted, and no
        ``serving_event`` is emitted. The fleet router uses this to rank
        candidate replicas before spending the one real ``submit`` (whose
        verdict — and shed event — is the honest, final one)."""
        with self._ops_lock:
            if self._draining:
                return SHED, "draining"
            if self._breaker_open:
                return SHED, "recovering"
            if len(self._queue) >= self.max_queue_depth:
                return SHED, "queue_full"
            if self.committed_tokens() + need_tokens > self.kv_budget_tokens:
                return SHED, "kv_budget"
            if not self._queue and self._fits_now(need_tokens):
                return ADMITTED, ""
            return QUEUED_STATUS, ""

    def recovery_snapshot(self, include_queued: bool = False) -> List[dict]:
        """Plain-data copy of every RUNNING request's recovery entry
        (prompt, emitted tokens, remaining quota, engine rid — see
        ``RecoveryLog``). This is what the fleet router reads off a dead
        replica to re-admit its streams onto survivors. With
        ``include_queued`` the host-side queue is appended too (entries
        with ``engine_rid`` None, in queue order) — queued requests have
        no device state but a dead replica's queue still holds work the
        fleet must not lose."""
        with self._ops_lock:
            out = self._recovery_log.snapshot()
            if include_queued:
                out.extend(snapshot_request(r) for r in list(self._queue))
        return out

    def readmit(self, entry: dict, *, on_token=None,
                parent_span: Optional[str] = None) -> Admission:
        """Re-admit a (possibly foreign) ``RecoveryLog`` entry onto THIS
        serving engine, resuming its stream mid-token: the handover
        re-prefills ``prompt + emitted`` and continues at
        ``gen_base=len(emitted)`` under the entry's pinned engine rid, so
        the tokens that follow are bitwise the ones the lost replica
        would have produced (``entry["engine_rid"]`` None — the request
        never reached that engine — gets a natural rid and a fresh
        stream). Admission-controlled exactly like :meth:`submit`: the
        verdict is honest, and a shed leaves no state behind. A pinned
        rid this engine already holds raises ValueError (namespace
        collision — see :meth:`set_rid_base`)."""
        prompt = np.asarray(entry["prompt"], np.int32).reshape(-1)
        emitted = [int(t) for t in entry.get("emitted", [])]
        max_new = int(entry["max_new_tokens"])
        need = int(prompt.size) + max_new
        now = self._clock()
        if self._t_start is None:
            self._t_start = now
        if max_new - len(emitted) < 1:
            # every token already surfaced host-side: synthesize the
            # finish — nothing left for an engine to generate
            rid = self._next_rid
            self._next_rid += 1
            req = self._entry_request(rid, entry, prompt, on_token, emitted)
            self._requests[rid] = req
            self._finish_request(req, np.concatenate(
                [prompt, np.asarray(emitted, np.int32)]), now)
            return Admission(status=ADMITTED, rid=rid)
        if need > self.kv_budget_tokens:
            raise ValueError(
                f"recovery entry needs {need} tokens, over this replica's "
                f"kv_budget_tokens {self.kv_budget_tokens}: it can never "
                f"be admitted here")
        if self._draining:
            return self._shed("draining", prompt, need, now, no_hint=True)
        if self._breaker_open:
            return self._shed("recovering", prompt, need, now)
        if len(self._queue) >= self.max_queue_depth:
            return self._shed("queue_full", prompt, need, now)
        committed = self.committed_tokens()
        if committed + need > self.kv_budget_tokens:
            return self._shed("kv_budget", prompt, need, now,
                              excess=committed + need - self.kv_budget_tokens)
        rid = self._next_rid
        self._next_rid += 1
        req = self._entry_request(rid, entry, prompt, on_token, emitted)
        if parent_span is not None:
            # the router's migration span: the survivor-side admission
            # span parents on it, bridging the replicas in one timeline
            req.span_parent = parent_span
        self._requests[rid] = req
        try:
            if not self._queue and self._fits_now(need):
                self._handover(req, now)
                status = ADMITTED
            else:
                self._queue.append(req)
                status = QUEUED_STATUS
        except ValueError:
            # engine refused the resume (rid collision, degraded cache):
            # leave no state behind — the router tries the next survivor
            self._requests.pop(rid, None)
            raise
        self._update_gauges()
        return Admission(status=status, rid=rid)

    def _entry_request(self, rid: int, entry: dict, prompt, on_token,
                       emitted: List[int]) -> ServeRequest:
        """A live ``ServeRequest`` rebuilt from a recovery entry: original
        submit time (queue-wait and deadline clocks keep running across
        the migration), emitted tokens pre-seeded (streams replay them,
        then continue), pinned engine rid carried until handover."""
        req = ServeRequest(rid=rid, prompt=prompt,
                           max_new_tokens=int(entry["max_new_tokens"]),
                           priority=int(entry.get("priority", 0)),
                           tenant=str(entry.get("tenant", "default")),
                           deadline_ms=entry.get("deadline_ms"),
                           on_token=on_token,
                           submit_t=float(entry["submit_t"]))
        req.tokens.extend(emitted)
        req.engine_rid = entry.get("engine_rid")
        req.recoveries = 1
        # trace identity rides the entry: survivor-side spans land on the
        # ORIGINAL trace_id under the original root (None = sampled out)
        req.trace_id = entry.get("trace_id")
        req.span_root = entry.get("span_root")
        req.span_parent = entry.get("span_parent")
        return req

    def release(self, rid: int) -> Optional[ServeRequest]:
        """Detach a live request WITHOUT terminal accounting: no state
        change, no counter, no event — the request is not lost, it
        continues on another replica (the fleet router calls this after
        a successful cross-replica ``readmit``). Frees the local slot
        best-effort (the engine may already be gone). Returns the record,
        or None if unknown/terminal (nothing to release)."""
        req = self._requests.get(rid)
        if req is None or req.state in TERMINAL_STATES:
            return None
        self._requests.pop(rid)
        self._queue = [r for r in self._queue if r.rid != rid]
        if req.engine_rid is not None:
            self._running.pop(req.engine_rid, None)
            self._staged.pop(req.engine_rid, None)
            try:
                self._cb.cancel(req.engine_rid)
            except Exception:  # noqa: BLE001 — engine may be lost/poisoned
                pass
        self._recovery_log.retire(rid)
        self._update_gauges()
        return req

    def abandon(self, detail: str) -> Dict[int, ServeRequest]:
        """Mark every live request shed (reason ``engine_lost``) — the
        honest terminal outcome for work that could not be migrated off a
        dead replica. Same accounting as the in-engine terminal-failure
        path (:meth:`_fail_terminally`) but without raising: the fleet
        keeps serving on the survivors. Returns the abandoned records."""
        live = [r for r in self._requests.values()
                if r.state not in TERMINAL_STATES]
        for req in live:
            self._mark_lost(req, detail)
        self._update_gauges()
        return {r.rid: r for r in live}

    # -- internals ------------------------------------------------------
    def _shed(self, reason: str, prompt, need: int, now: float,
              excess: Optional[int] = None, no_hint: bool = False) -> Admission:
        hint = (None if no_hint
                else self._retry_after(need if excess is None else excess, now))
        if self._tele.enabled:
            self._tele.registry.counter("serve_shed_total").inc()
            event = {"event": "shed", "reason": reason,
                     "prompt_tokens": int(prompt.size), "need_tokens": need,
                     "queue_depth": len(self._queue),
                     "committed_tokens": self.committed_tokens()}
            if hint is not None:
                event["retry_after_s"] = hint
            self._tele.emit("serving_event", event)
        return Admission(status=SHED, reason=reason, retry_after_s=hint)

    def _completion_rate(self, now: float) -> Optional[float]:
        """Observed completion rate (tokens/s), or None when it is not
        yet observable — zero requests finished, or no time has elapsed
        since the first submit. Callers must treat None as "no rate",
        never divide by it."""
        if self._tokens_done <= 0 or self._t_start is None:
            return None
        elapsed = now - self._t_start
        if elapsed <= 0:
            return None
        rate = self._tokens_done / elapsed
        return rate if rate > 0 else None

    def _recovery_eta_s(self, now: float) -> float:
        """Expected seconds until the current outage ends: the last
        measured recovery time (or the configured estimate before any
        has been observed) minus the outage time already elapsed. While
        the breaker is STILL open past that estimate (the rebuilt engine
        is unproven, or recovery is slower than last time) the honest
        assumption is another full recovery cycle — the hint never decays
        to zero mid-outage. 0.0 while healthy."""
        if not self._breaker_open or self._outage_start is None:
            return 0.0
        est = (self._recovery_ms[-1] / 1000.0 if self._recovery_ms
               else self.recovery_cfg.est_recovery_s)
        est = max(est, self.recovery_cfg.backoff_s)
        remaining = est - (now - self._outage_start)
        return remaining if remaining > 0 else est

    def _retry_after(self, excess_tokens: int, now: float) -> Optional[float]:
        """Coarse backpressure hint: how long until ``excess_tokens`` of
        committed work drains at the observed completion rate, PLUS the
        expected remaining outage when the circuit breaker is open.
        Well-defined in every regime — in particular, with ZERO
        completions in the observation window (cold start, or an outage
        before anything finished) there is no rate to divide by: the
        hint is the recovery ETA alone, or None when healthy with
        nothing to extrapolate from."""
        outage = self._recovery_eta_s(now)
        rate = self._completion_rate(now)
        if rate is None:
            return round(outage, 3) if outage > 0 else None
        return round(max(1, excess_tokens) / rate + outage, 3)

    def _effective_pool_state(self) -> List[dict]:
        """pool_state() with staged handovers already subtracted, placed
        the way the engine's ``_place`` will (smallest fitting pool)."""
        pools = [dict(p) for p in self._cb.pool_state()]
        for need in self._staged.values():
            pool = next((p for p in pools
                         if p["length"] >= need and p["free"] > 0), None)
            if pool is not None:
                pool["free"] -= 1
        return pools

    def _fits_now(self, need: int) -> bool:
        return any(p["length"] >= need and p["free"] > 0
                   for p in self._effective_pool_state())

    def _handover(self, req: ServeRequest, now: float):
        if req.engine_rid is not None or req.tokens:
            # migrated resume (readmit): re-prefill prompt + everything
            # already emitted and continue at gen_base, pinning the
            # foreign engine rid — the RNG identity — so the stream is
            # bitwise the one the lost replica would have produced.
            # rid None means the request never reached the dead
            # replica's engine (still queued there): a natural rid is
            # correct, the stream starts fresh.
            full = (np.concatenate([req.prompt,
                                    np.asarray(req.tokens, np.int32)])
                    if req.tokens else req.prompt)
            req.engine_rid = self._cb.submit(
                full, req.max_new_tokens - len(req.tokens),
                rid=req.engine_rid, gen_base=len(req.tokens))
        elif req.prefix_id is not None and req.prefix_id in self._prefixes:
            # splice the registered prefix KV; only the suffix prefills
            suffix = req.prompt[self._prefixes[req.prefix_id].size:]
            req.engine_rid = self._cb.submit_with_prefix(
                self._prefix_pids[req.prefix_id], suffix, req.max_new_tokens)
        else:
            # no prefix — or it was unregistered while this request sat
            # in the queue: req.prompt already holds the FULL token
            # sequence, so pay the full prefill instead of stranding the
            # request (stream bitwise identical either way)
            req.engine_rid = self._cb.submit(req.prompt, req.max_new_tokens)
        req.state = RUNNING
        req.admit_t = now
        self._rid_watermark = max(self._rid_watermark, req.engine_rid + 1)
        self._staged[req.engine_rid] = req.need_tokens
        self._running[req.engine_rid] = req
        # spans BEFORE the recovery-log snapshot: the entry must carry
        # span_root, or a migrated re-admission would mint a second root
        # and the cross-replica timeline would fork
        self._emit_admit_spans(req, now)
        self._recovery_log.admit(req)
        self.policy.on_admit(req, now)
        if self._tele.enabled:
            self._tele.registry.counter("serve_admitted_total").inc()

    def _schedule(self, now: float):
        """Place queued requests into free slots in policy order, bounded
        by the anti-starvation aging rule: a request that has waited
        ``aging_s`` (a) moves to the head of the order, oldest first —
        so a request the policy keeps outranking (no-deadline work under
        EDF, low priority under a high-priority stream) still gets the
        next slot it fits — and (b) becomes a barrier when it does NOT
        fit: nothing ranked behind it may leapfrog (the fix for the bare
        FIFO-with-skip mode where a long request waiting for the big pool
        starves behind an endless stream of short ones)."""
        if not self._queue:
            return
        free = self._effective_pool_state()
        placed = set()
        order = self.policy.order(self._queue, now)
        aged = [r for r in order if r.waited_s(now) >= self.aging_s]
        if aged:
            aged.sort(key=lambda r: r.rid)  # oldest aged request first
            fresh = [r for r in order if r.waited_s(now) < self.aging_s]
            order = aged + fresh
        for req in order:
            pool = next((p for p in free
                         if p["length"] >= req.need_tokens and p["free"] > 0),
                        None)
            if pool is None:
                if req.waited_s(now) >= self.aging_s:
                    break  # aging barrier: nobody leapfrogs an aged request
                continue
            pool["free"] -= 1
            self._handover(req, now)
            placed.add(req.rid)
        if placed:
            self._queue = [r for r in self._queue if r.rid not in placed]

    def _expire(self, now: float):
        """Shed queued work whose deadline already blew: decoding it would
        burn slot time on a response the client stopped waiting for."""
        expired = [r for r in self._queue if now > r.deadline_at]
        if not expired:
            return
        for req in expired:
            req.state = EXPIRED
            req.finish_t = now
            if self._tele.enabled:
                self._tele.registry.counter("serve_expired_total").inc()
                self._tele.emit("serving_event", {
                    "event": "expired", "request": req.rid,
                    "queue_ms": round(req.waited_s(now) * 1000.0, 3),
                    "deadline_ms": req.deadline_ms,
                })
        self._queue = [r for r in self._queue if r.state == QUEUED]

    def _update_gauges(self):
        if not self._tele.enabled:
            return
        reg = self._tele.registry
        reg.gauge("serve_queue_depth").set(len(self._queue))
        reg.gauge("serve_committed_tokens").set(self.committed_tokens())

    # -- request-scoped tracing ----------------------------------------
    def _trace_scope(self) -> str:
        """Trace-id prefix: the hub's replica tag when this engine serves
        inside a fleet (``ReplicaTelemetry``), else empty. Serving rids
        are per-replica counters, so the birth-replica prefix is what
        keeps trace ids distinct in a shared fleet trace file."""
        rep = getattr(self._tele, "replica", None)
        return f"{rep}/" if rep is not None else ""

    def _emit_admit_spans(self, req: ServeRequest, now: float):
        """Queue + admission spans at handover. The queue (root) span is
        emitted once per trace — original submit to FIRST handover, even
        when that handover happens on a survivor replica after a
        migration — and every handover adds an admission span that
        becomes the parent the request's subsequent tick-window spans
        hang off. A migrated re-admission's admission span parents on the
        router's migration span (``req.span_parent`` pre-seeded by
        ``readmit``), stitching the cross-replica bridge."""
        if req.trace_id is None or not self._spans.enabled:
            return
        if req.span_root is None:
            req.span_root = self._spans.emit(
                "queue", req.trace_id, req.submit_t, now,
                attrs={"request": req.rid, "priority": req.priority,
                       "tenant": req.tenant})
        parent = req.span_parent if req.span_parent is not None else req.span_root
        sid = self._spans.emit(
            "admission", req.trace_id, now, self._clock(), parent_id=parent,
            attrs={"engine_rid": int(req.engine_rid),
                   "gen_base": len(req.tokens),
                   "prefix": req.prefix_id is not None})
        req.span_parent = sid

    def _span_hook(self, engine_rid: int, kind: str, t0: float, t1: float,
                   attrs: Optional[dict] = None):
        """Installed as the batching engine's ``span_hook`` (only when the
        hub is live): attribute a retired tick window (prefill_chunk /
        decode_window / spec_verify_round) to the owning request's trace,
        parented on its latest admission/recovery_replay span."""
        req = self._running.get(engine_rid)
        if req is None or req.trace_id is None:
            return
        self._spans.emit(kind, req.trace_id, t0, t1,
                         parent_id=req.span_parent, attrs=attrs)

    def _event_hook(self, engine_rid: int, event: dict) -> Optional[dict]:
        """Installed as the batching engine's ``request_event_hook``:
        enrich the per-request ``inference_request`` event with the
        serving-side lifecycle fields (and retag it as ours)."""
        req = self._running.get(engine_rid)
        if req is None:
            return None  # a direct engine.submit request: leave it alone
        return self._enrich_event(req, event)

    def _enrich_event(self, req: ServeRequest, event: dict) -> dict:
        """The enrichment body, callable with the request in hand —
        `_finish_recovered` uses this directly so it never has to
        transiently register the request in the live `_running` table
        (an off-lock write a concurrent scrape could observe)."""
        now = self._clock()
        event["path"] = "serving"
        event["request"] = req.rid
        q = req.queue_ms()
        if q is not None:
            event["queue_ms"] = round(q, 3)
        # finishing tick: first_token_t for a one-tick request is not
        # recorded yet, so fall back to "now" (same tick that emitted it)
        ttft = req.ttft_ms()
        event["ttft_ms"] = round(
            ttft if ttft is not None else (now - req.submit_t) * 1000.0, 3)
        event["priority"] = req.priority
        event["tenant"] = req.tenant
        if req.trace_id is not None:
            # joins the request summary to its span timeline
            event["trace_id"] = req.trace_id
        if req.recoveries:
            # the rebuilt engine only generated the post-outage remainder;
            # the client's stream is the full accumulated one — report
            # THAT, and flag the request so SLO analysis can segment
            event["new_tokens"] = len(req.tokens)
            event["recoveries"] = req.recoveries
        if req.deadline_ms is not None:
            # this is the request's single SLO verdict: the counters and
            # loadgen records reuse it rather than re-reading the clock
            req.deadline_met = bool(now <= req.deadline_at)
            event["deadline_ms"] = req.deadline_ms
            event["deadline_met"] = req.deadline_met
        return event
