"""Preemption-safe training: the supervised resume ladder over
:class:`~deepspeed_tpu_torch.runtime.engine.TpuEngine` (counterpart of
``deepspeed_tpu/runtime/resilience.py``).

The training column's analogue of the serving recovery stack
(serving/recovery.py + serving/engine.py's ``_on_tick_failure``), built
on the shared fault taxonomy in :mod:`deepspeed_tpu_torch.faults`:

- a CLEAN micro-step dispatch failure (:class:`MicroDispatchError`,
  raised at the ``micro_dispatch`` hook BEFORE the engine mutated
  anything) gets bounded retry-with-backoff on the SAME cached
  micro-batch — the retried micro-step is bitwise the micro-step that
  would have run;
- a POISONED failure (anything past the dispatch barrier: a hung
  ``step_fetch``, an exception mid-update — buffers written in place are
  unaccounted for) rebuilds the engine from the newest in-memory host
  snapshot (a 2-deep double buffer captured every
  ``snapshot_every_n_steps``) and replays forward;
- a whole-process :class:`TrainPreempted` drops the in-memory buffers
  (they die with the process) and restores from the newest COMMITTED
  tag on disk — torn/markerless tags are refused by
  ``engine.load_checkpoint`` and the ladder falls back to the previous
  good one. A ``degrade=True`` preemption with a ``degrade_world_sizes``
  ladder needs elasticity and more than one device (ROADMAP Queue 1
  items 8 and 12) and raises ``NotImplementedError``;
- nothing restorable and no budget left is terminal:
  :class:`TrainingFailed`.

With a :class:`~deepspeed_tpu_torch.runtime.numerics.NumericSentinel`
armed (``numeric_sentinel`` in the recovery config), two cheaper rungs
sit *before* rebuild for the failures that never raise:

- **quarantine** — a non-ok pre-apply loss verdict means the flagged
  batch's grads were accumulated but never applied: discard them
  (``engine.discard_accumulated_grads``), journal the batch's data
  cursor, add it to the loader's skip-list, and retry the step with the
  next batch;
- **rewind-and-replay** — a ``corrupt`` post-apply verdict (grad-norm
  explosion, NaN beyond fp16, SDC probe mismatch) means wrong state was
  already committed: restore the newest in-memory snapshot onto the
  LIVE engine (no factory — the engine is not poisoned, its numbers are
  merely wrong) and replay forward with quarantined batches excluded.

Exhausting either budget (``max_quarantines`` / ``max_rewinds``), or
needing a rewind with no snapshot taken, raises
:class:`~deepspeed_tpu_torch.runtime.numerics.NumericCorruption` into
the ordinary ladder.

What makes resume *bitwise*: a snapshot is ONE atomic unit — params /
optimizer state / LR scheduler / step counters / the engine's generator
state / the dataloader cursor — captured at a step boundary where
``grad_acc`` is zeros. Restoring it puts the engine in exactly the
pre-step state and the cursor replays exactly the batches the lost run
would have consumed, so the replayed per-step loss stream equals the
fault-free run's bit for bit wherever a step is a deterministic function
of its inputs.

On an engine whose state is split across ranks (ZeRO stages 1-3, tensor
parallelism) every rank runs its own supervisor over the same loader and
fault plan, in lockstep: a snapshot is each rank's copy of its own blocks
(with the whole leaves' manifest), the ranks save and load each tag
together and agree on every commit and every refusal, and the probes and
sentinel verdicts read values every rank shares.
"""

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.faults import (
    MicroDispatchError,
    TornCheckpointWrite,
    TrainPreempted,
)
from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity as ckpt_integrity
from deepspeed_tpu_torch.runtime.numerics import (
    NumericCorruption,
    NumericSentinel,
    Verdict,
)
from deepspeed_tpu_torch.telemetry.registry import percentile
from deepspeed_tpu_torch.telemetry.spans import SpanEmitter
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import logger


class TrainingFailed(RuntimeError):
    """Terminal training failure: retries were exhausted and no engine
    rebuild (in-process or from disk)
    succeeded. ``steps_completed`` is the last fully-applied optimizer
    step; ``last_committed_tag`` names the newest durable checkpoint (a
    later incarnation can still resume from it)."""

    def __init__(self, message: str, steps_completed: int = 0,
                 last_committed_tag: Optional[str] = None):
        super().__init__(message)
        self.steps_completed = steps_completed
        self.last_committed_tag = last_committed_tag


@dataclass
class TrainRecoveryConfig:
    """Watchdog + snapshot + escalation knobs (``TrainSupervisor(recovery=...)``).

    - ``fetch_timeout_s``: watchdog on the optimizer-step metrics fetch
      (``TpuEngine.fetch_timeout_s``); an overrun poisons the engine and
      triggers a rebuild. None = off.
    - ``max_step_retries``: bounded retry budget for a CLEAN micro-step
      dispatch failure; exhausting it — or any poisoned failure —
      escalates to rebuild.
    - ``backoff_s``: base retry backoff, doubled per attempt.
    - ``max_rebuilds``: total engine rebuilds (in-process + from-disk)
      allowed before :class:`TrainingFailed`.
    - ``snapshot_every_n_steps``: host-snapshot cadence (0 disables —
      poisoned failures then restart from disk or step 0).
    - ``snapshot_dir``: where committed checkpoints go; None keeps
      snapshots memory-only (preemptions then cold-restart).
    - ``degrade_world_sizes``: descending chip counts to escalate
      through on ``TrainPreempted(degrade=True)`` — the degrade ladder,
      which raises ``NotImplementedError`` in the port (ROADMAP Queue 1
      items 8 and 12); empty, such a preemption rebuilds at the current
      size, as the reference's does with its ladder exhausted.
    - ``verify_integrity``: recompute per-leaf checksums against the
      manifest on every disk restore.
    - ``numeric_sentinel``: :class:`~deepspeed_tpu_torch.runtime.numerics
      .SentinelConfig` knobs (or an instance); None disarms the
      numerical-health layer entirely.
    - ``max_quarantines`` / ``max_rewinds``: budgets for the sentinel's
      two rungs; exhaustion escalates into the ordinary ladder as
      :class:`~deepspeed_tpu_torch.runtime.numerics.NumericCorruption`.
    """

    fetch_timeout_s: Optional[float] = None
    max_step_retries: int = 2
    backoff_s: float = 0.05
    max_rebuilds: int = 8
    snapshot_every_n_steps: int = 100
    snapshot_dir: Optional[str] = None
    degrade_world_sizes: Sequence[int] = ()
    verify_integrity: bool = True
    numeric_sentinel: Optional[Any] = None
    max_quarantines: int = 8
    max_rewinds: int = 4

    def __post_init__(self):
        if self.max_step_retries < 0:
            raise ValueError("max_step_retries must be >= 0")
        if self.max_quarantines < 0:
            raise ValueError("max_quarantines must be >= 0")
        if self.max_rewinds < 0:
            raise ValueError("max_rewinds must be >= 0")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        if self.max_rebuilds < 1:
            raise ValueError("max_rebuilds must be >= 1")
        if self.snapshot_every_n_steps < 0:
            raise ValueError("snapshot_every_n_steps must be >= 0 (0 = off)")
        if self.fetch_timeout_s is not None and self.fetch_timeout_s <= 0:
            raise ValueError("fetch_timeout_s must be > 0 (None = off)")
        if any(int(w) < 1 for w in self.degrade_world_sizes):
            raise ValueError("degrade_world_sizes entries must be >= 1")

    @classmethod
    def parse(cls, spec) -> "TrainRecoveryConfig":
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(f"recovery must be a TrainRecoveryConfig or dict, "
                        f"got {type(spec).__name__}")


@dataclass
class TrainSnapshot:
    """One atomic unit of resumable training state, host-side: the full
    state tree as numpy, the checkpoint metadata (step counters / LR
    scheduler / client state), the per-leaf checksum manifest, the raw
    RNG key words, and the dataloader cursor. ``step`` is the optimizer
    step the snapshot was captured AFTER."""

    step: int
    host_tree: Any
    meta: dict
    manifest: Optional[dict]
    rng_key: Any
    cursor: Optional[dict] = None

    def client_state(self) -> dict:
        return dict(self.meta.get("client_state") or {})


def leading_rows(batch) -> int:
    """Row count of a global batch (the leading dim of its first leaf)."""
    if isinstance(batch, dict):
        return leading_rows(next(iter(batch.values())))
    if isinstance(batch, (tuple, list)):
        return leading_rows(batch[0])
    return int(batch.shape[0])


def _slice_rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _slice_rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice_rows(v, lo, hi) for v in tree)
    return tree[lo:hi]


def _copy_tree(tree):
    """Deep copy of a (dict/tuple/list of) array or tensor batch — the SDC
    probe's pinned batch must not alias live buffers."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy_tree(v) for v in tree)
    return tree.clone() if torch.is_tensor(tree) else np.array(tree)


def slice_micro_batches(batch, gas: int) -> List[Any]:
    """Split one GLOBAL batch into ``gas`` row-contiguous micro-batches.
    The supervisor pulls global batches (loader batch_size ==
    train_batch_size) precisely so the dataloader cursor means the same
    thing at every world size — only this slicing changes shape."""
    n = leading_rows(batch)
    if gas < 1 or n % gas != 0:
        raise ValueError(
            f"global batch of {n} rows does not split into "
            f"gradient_accumulation_steps={gas} micro-batches")
    per = n // gas
    return [_slice_rows(batch, i * per, (i + 1) * per) for i in range(gas)]


class TrainSupervisor:
    """Drives ``forward → backward → step`` under the escalation ladder.

    ``engine_factory()`` builds a fresh :class:`TpuEngine` (factories
    build with telemetry off; the supervisor adopts the FIRST engine's hub
    and re-injects it into every rebuild, so one trace file and one
    metrics registry span engine generations). ``loader`` yields GLOBAL batches
    of ``train_batch_size`` rows and should expose the
    ``state_dict``/``load_state_dict`` cursor protocol
    (runtime/dataloader.py) for bitwise resume. ``fault_hook`` is
    typically a :class:`deepspeed_tpu_torch.faults.TrainFaultInjector`; it
    is re-armed on every rebuilt engine. ``base_config`` (the plain
    ds_config dict) serves the reference's degraded restarts, which the
    port refuses (ROADMAP Queue 1 items 8 and 12)."""

    def __init__(self, engine_factory, loader, recovery=None,
                 fault_hook=None, base_config: Optional[dict] = None):
        self.engine_factory = engine_factory
        self.loader = loader
        self.cfg = TrainRecoveryConfig.parse(recovery)
        self.fault_hook = fault_hook
        self.base_config = base_config
        self.engine = None
        self._tele = None
        self._data_iter = None
        self._snapshots: List[TrainSnapshot] = []  # newest last, max 2
        self._step_losses: Dict[int, float] = {}
        self._fault_count = 0
        self._retry_count = 0
        self._rebuild_count = 0
        self._torn_writes = 0
        self._snapshots_taken = 0
        self._pending_ckpt: Optional[Tuple[int, str]] = None  # (step, tag)
        self._recovery_ms: List[float] = []
        # numerical-health layer (disarmed unless the config asks for it)
        self.sentinel = (NumericSentinel(self.cfg.numeric_sentinel)
                         if self.cfg.numeric_sentinel is not None else None)
        self._quarantine_journal: List[dict] = []
        self._quarantine_count = 0
        self._rewind_count = 0
        self._sdc_probes = 0
        self._sdc_mismatches = 0
        self._pinned_batch = None      # first micro-batch seen, host copy
        self._clock = time.perf_counter
        self._sleep = time.sleep
        # train-side request tracing (docs/telemetry.md "Request
        # tracing"): one trace per training step (trace_id "step:N") with
        # a train_step root and train_retry / train_rebuild children —
        # the same span model, reader and tooling as serving traces. The
        # emitter binds to the hub lazily (the hub exists only after the
        # first engine build).
        self._spans = SpanEmitter(None, clock=self._clock)
        self._step_span: Optional[str] = None  # open train_step root id

    # ------------------------------------------------------------------
    # engine lifecycle
    # ------------------------------------------------------------------
    def _build_engine(self):
        eng = self.engine_factory()
        if self._tele is None:
            self._tele = eng.telemetry
        else:
            eng.telemetry = self._tele
        self._spans.rebind(self._tele)
        eng.fault_hook = self.fault_hook
        if self.cfg.fetch_timeout_s is not None:
            eng.fetch_timeout_s = self.cfg.fetch_timeout_s
        return eng

    def _ensure_engine(self):
        if self.engine is None:
            self.engine = self._build_engine()

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self, num_steps: int) -> List[float]:
        """Train until ``engine.global_steps == num_steps`` (absolute),
        surviving injected/real faults per the escalation ladder.
        Returns the per-step loss stream for steps 1..num_steps —
        replayed steps overwrite their slot, so the stream is what a
        fault-free run would have produced (bitwise, at the same world
        size)."""
        self._ensure_engine()
        while self.engine.global_steps < num_steps:
            step_no = self.engine.global_steps + 1
            # train_step root span covers the attempt AND any in-step
            # recovery (its id is minted up front so train_retry /
            # train_rebuild children can parent on it before it closes)
            span_t0 = self._clock()
            self._step_span = (self._spans.new_span_id()
                               if self._spans.enabled else None)
            try:
                self._run_one_step(step_no)
            except TrainingFailed:
                raise
            except Exception as exc:  # noqa: BLE001 — every failure enters the ladder
                self._on_step_failure(step_no, exc)
            finally:
                if self._step_span is not None:
                    self._spans.emit(
                        "train_step", f"step:{step_no}", span_t0,
                        self._clock(), span_id=self._step_span,
                        attrs={"step": step_no})
                    self._step_span = None
        # the last cadence's async save must be durable before run()
        # reports success
        self._fence_pending_save()
        return [self._step_losses[s] for s in range(1, num_steps + 1)
                if s in self._step_losses]

    def _run_one_step(self, step_no: int):
        eng = self.engine
        if eng.fault_hook is not None:
            # the between-steps preemption window: process loss strikes
            # here, before this step consumed a batch or mutated state
            eng.fault_hook("preempt", {"step": step_no})
        gas = eng.gradient_accumulation_steps
        batch = self._next_global_batch()
        # the cursor AFTER next() names the batch just consumed as
        # (epoch, batch - 1) — correct across an epoch rollover, where
        # epoch already advanced and batch restarted at 1
        cursor = (self.loader.state_dict()
                  if hasattr(self.loader, "state_dict") else None)
        micros = slice_micro_batches(batch, gas)
        if (self.sentinel is not None and self.sentinel.cfg.sdc_probe_every
                and self._pinned_batch is None):
            self._pinned_batch = _copy_tree(micros[0])
        micro_losses = []
        for m, mb in enumerate(micros):
            micro_losses.append(self._run_micro(mb, step_no, m))
        # fetched per-micro (float() syncs) and reduced in float32 the
        # same way on every run — the bitwise-compared loss stream
        loss_val = float(
            np.mean(np.asarray(micro_losses, dtype=np.float32),
                    dtype=np.float32))
        if self.sentinel is not None:
            # PRE-apply window: the batch's grads are accumulated but not
            # applied — a non-ok loss verdict can still quarantine it
            verdict = self.sentinel.check_loss(step_no, loss_val)
            if not verdict.ok:
                self._quarantine(step_no, verdict, cursor, loss_val)
                return  # step_no not advanced; the loop retries with the next batch
        eng.step()
        self._step_losses[step_no] = loss_val
        if self.sentinel is not None:
            scal = eng.step_health_scalars() or {}
            v2 = self.sentinel.check_step(
                step_no, scal.get("grad_norm", 0.0),
                scal.get("overflow", False), scal.get("loss_scale", 1.0))
            if not v2.ok:
                self._numeric_event("anomaly", step=step_no,
                                    verdict=v2.verdict, reasons=v2.reasons,
                                    loss=loss_val,
                                    grad_norm=scal.get("grad_norm", 0.0),
                                    grad_ratio=round(v2.grad_ratio, 6))
                self._count_anomalies(v2)
            if v2.corrupt:
                # wrong state is already committed — un-commit it BEFORE
                # the snapshot cadence could capture the corrupted params
                self._rewind_and_replay(step_no, v2)
                return
        self._maybe_snapshot(step_no)
        self._maybe_sdc_probe(step_no)

    def _run_micro(self, micro_batch, step_no: int, micro: int):
        """One forward/backward with the clean-retry budget. Only a
        non-poisoning :class:`MicroDispatchError` is retryable — the
        hook fires before RNG/donation, so the retry IS the micro-step."""
        cfg = self.cfg
        eng = self.engine
        attempt = 0
        while True:
            try:
                loss = eng.forward(micro_batch)
                val = np.float32(float(loss))
                eng.backward(loss)
                if attempt:
                    self._fault_event("retried", step=step_no, micro=micro,
                                      attempt=attempt)
                return val
            except MicroDispatchError as exc:
                self._count_fault(exc, step=step_no, micro=micro)
                if eng.poisoned or attempt >= cfg.max_step_retries:
                    raise
                retry_t0 = self._clock()
                self._sleep(cfg.backoff_s * (2 ** attempt))
                attempt += 1
                self._retry_count += 1
                if self._tele is not None and self._tele.enabled:
                    self._tele.registry.counter("step_retry_total").inc()
                if self._step_span is not None:
                    # the backoff window, attributed as recovery time
                    # inside the step's trace
                    self._spans.emit(
                        "train_retry", f"step:{step_no}", retry_t0,
                        self._clock(), parent_id=self._step_span,
                        attrs={"micro": micro, "attempt": attempt})

    # ------------------------------------------------------------------
    # numerical-health rungs (quarantine < rewind < the ordinary ladder)
    # ------------------------------------------------------------------
    def _quarantine(self, step_no: int, verdict: Verdict,
                    cursor: Optional[dict], loss_val: float):
        """Skip rung: the flagged batch's grads were never applied.
        Discard the accumulation, journal + skip-list the batch, and let
        the main loop retry the step with the next batch."""
        if self._quarantine_count >= self.cfg.max_quarantines:
            raise NumericCorruption(
                f"max_quarantines={self.cfg.max_quarantines} exhausted at "
                f"step {step_no} ({'/'.join(verdict.reasons)})", verdict)
        self._quarantine_count += 1
        if cursor is not None:
            epoch, bidx = int(cursor["epoch"]), int(cursor["batch"]) - 1
        else:
            epoch, bidx = -1, -1  # loader has no cursor: journal-only
        self._quarantine_journal.append({
            "step": step_no, "epoch": epoch, "batch": bidx,
            "verdict": verdict.verdict, "reasons": list(verdict.reasons)})
        if bidx >= 0 and hasattr(self.loader, "quarantine"):
            self.loader.quarantine(epoch, bidx)
        self.engine.discard_accumulated_grads()
        self._count_anomalies(verdict)
        self._numeric_event("quarantine", step=step_no, epoch=epoch,
                            batch=bidx, verdict=verdict.verdict,
                            reasons=list(verdict.reasons), loss=loss_val,
                            zscore=round(verdict.zscore, 6))
        if self._tele is not None and self._tele.enabled:
            self._tele.registry.counter("batch_quarantine_total").inc()
        logger.warning(
            f"quarantined batch (epoch {epoch}, batch {bidx}) at step "
            f"{step_no}: {verdict.verdict} ({'/'.join(verdict.reasons)}, "
            f"loss={loss_val:.6g}, z={verdict.zscore:.1f})")

    def _rewind_and_replay(self, step_no: int, verdict: Verdict):
        """Rewind rung: corrupted state was committed, but the engine
        itself is healthy — restore the newest in-memory snapshot onto
        the LIVE engine (no factory, no recompile) and replay forward
        with quarantined batches excluded."""
        if not self._snapshots:
            raise NumericCorruption(
                f"corrupt verdict at step {step_no} "
                f"({'/'.join(verdict.reasons)}) with no snapshot to rewind "
                "to", verdict)
        if self._rewind_count >= self.cfg.max_rewinds:
            raise NumericCorruption(
                f"max_rewinds={self.cfg.max_rewinds} exhausted at step "
                f"{step_no} ({'/'.join(verdict.reasons)})", verdict)
        t0 = self._clock()
        self._rewind_count += 1
        snap = self._snapshots[-1]
        eng = self.engine
        eng.restore_from_host_state(
            snap.host_tree, snap.meta,
            verify_integrity=snap.manifest if self.cfg.verify_integrity
            else None)
        eng.set_rng_state(snap.rng_key)
        self._rewind_loader(snap.cursor)
        self.sentinel.note_rewind()
        rewind_ms = (self._clock() - t0) * 1000.0
        self._numeric_event("rewind", step=step_no,
                            resume_step=snap.step,
                            replayed_steps=max(0, step_no - snap.step),
                            verdict=verdict.verdict,
                            reasons=list(verdict.reasons),
                            rewind_ms=round(rewind_ms, 3))
        if self._tele is not None and self._tele.enabled:
            self._tele.registry.counter("rewind_total").inc()
        logger.warning(
            f"rewind-and-replay after {verdict.verdict} at step {step_no} "
            f"({'/'.join(verdict.reasons)}): restored step {snap.step} "
            f"snapshot in {rewind_ms:.1f} ms, replaying "
            f"{max(0, step_no - snap.step)} steps")

    def _maybe_sdc_probe(self, step_no: int):
        """Every ``sdc_probe_every`` steps, replay the pinned sentinel
        micro-step twice and CRC-compare the grad bytes — a mismatch is
        nondeterministic hardware corruption (always ``corrupt``)."""
        if (self.sentinel is None or not self.sentinel.cfg.sdc_probe_every
                or step_no % self.sentinel.cfg.sdc_probe_every
                or self._pinned_batch is None
                or not hasattr(self.engine, "sdc_probe")):
            return
        d1 = self.engine.sdc_probe(self._pinned_batch)
        if d1 is None:  # engine path without a probe-capable micro fn
            return
        d2 = self.engine.sdc_probe(self._pinned_batch)
        self._sdc_probes += 1
        match = d1 == d2
        self._numeric_event("sdc_probe", step=step_no, digest=int(d1),
                            match=bool(match))
        if match:
            return
        self._sdc_mismatches += 1
        v = self.sentinel.flag_sdc_mismatch(step_no)
        self._count_anomalies(v)
        logger.warning(
            f"SDC probe mismatch at step {step_no}: digests {d1:#010x} != "
            f"{d2:#010x} — treating committed state as corrupt")
        self._rewind_and_replay(step_no, v)

    def _count_anomalies(self, verdict: Verdict):
        if self._tele is None or not self._tele.enabled:
            return
        for reason in verdict.reasons:
            self._tele.registry.counter(
                "numeric_anomaly_total", {"kind": reason}).inc()

    def _numeric_event(self, event: str, **fields):
        if self._tele is not None and self._tele.enabled:
            payload = {"event": event}
            payload.update(fields)
            self._tele.emit("numeric_health", payload)

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def _next_global_batch(self):
        if self._data_iter is None:
            self._data_iter = iter(self.loader)
        try:
            return next(self._data_iter)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self._data_iter = iter(self.loader)
            return next(self._data_iter)

    def _rewind_loader(self, cursor: Optional[dict]):
        if hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(cursor or {"epoch": 0, "batch": 0})
            # a snapshot cursor can predate later quarantines, and
            # load_state_dict REPLACES the skip-list — re-apply the
            # supervisor's journal so the replay excludes them too
            if hasattr(self.loader, "quarantine"):
                for rec in self._quarantine_journal:
                    if rec["batch"] >= 0:
                        self.loader.quarantine(rec["epoch"], rec["batch"])
        self._data_iter = None

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def _maybe_snapshot(self, step_no: int):
        cfg = self.cfg
        if not cfg.snapshot_every_n_steps or step_no % cfg.snapshot_every_n_steps:
            return
        t0 = self._clock()
        cursor = (self.loader.state_dict()
                  if hasattr(self.loader, "state_dict") else None)
        rng = self.engine.rng_state()
        client_state = {
            "rng_key": [int(w) for w in np.asarray(rng).ravel()],
            "data_cursor": cursor,
        }
        host_tree, meta, manifest = self.engine.host_state_snapshot(client_state)
        self._snapshots.append(TrainSnapshot(
            step=step_no, host_tree=host_tree, meta=meta, manifest=manifest,
            rng_key=np.asarray(rng), cursor=cursor))
        del self._snapshots[:-2]  # double buffer: newest two survive
        self._snapshots_taken += 1
        tag = f"global_step{step_no}"
        committed = cfg.snapshot_dir is None
        if cfg.snapshot_dir is not None:
            # double-buffered disk cadence: the PREVIOUS cadence's async
            # save must have landed before this one queues (its torn
            # write — injected or real — surfaces at this fence); the
            # new save then overlaps with the next snapshot window. A
            # sync engine commits inside save_checkpoint and its wait()
            # is a no-op, so the fence costs nothing there.
            self._fence_pending_save()
            try:
                self.engine.save_checkpoint(
                    cfg.snapshot_dir, tag=tag, client_state=client_state,
                    state_tree=host_tree, manifest=manifest)
                self._pending_ckpt = (step_no, tag)
                committed = True
            except TornCheckpointWrite as exc:
                # the tag on disk is markerless — exactly what a writer
                # death mid-commit leaves. Training continues; the next
                # cadence overwrites it, and load_checkpoint refuses it
                # meanwhile.
                self._record_torn_write(exc, step_no, tag)
        ckpt_ms = (self._clock() - t0) * 1000.0
        if self._tele is not None and self._tele.enabled:
            self._tele.registry.histogram("checkpoint_ms").observe(ckpt_ms)
        self._fault_event("snapshot", step=step_no, tag=tag,
                          checkpoint_ms=round(ckpt_ms, 3),
                          committed=committed)

    def _fence_pending_save(self):
        """Wait out the previous cadence's (possibly async) checkpoint
        write, recording a torn write if its commit died in flight."""
        pending, self._pending_ckpt = self._pending_ckpt, None
        if pending is None or self.engine is None:
            return
        step_no, tag = pending
        try:
            self.engine.checkpoint_engine.wait()
        except TornCheckpointWrite as exc:
            self._record_torn_write(exc, step_no, tag)

    def _record_torn_write(self, exc: Exception, step_no: int, tag: str):
        self._torn_writes += 1
        self._count_fault(exc, step=step_no, tag=tag)
        self._fault_event("ckpt_torn", step=step_no, tag=tag,
                          detail=str(exc)[:200])

    # ------------------------------------------------------------------
    # the escalation ladder
    # ------------------------------------------------------------------
    def _on_step_failure(self, step_no: int, exc: Exception):
        poisoned = bool(self.engine.poisoned) if self.engine else False
        if not isinstance(exc, MicroDispatchError):
            # MicroDispatchError was already counted at the micro level
            self._count_fault(exc, step=step_no, poisoned=poisoned)
        if isinstance(exc, TrainPreempted):
            # the process (and its host snapshot buffers) is gone
            self._snapshots.clear()
            self._restore_from_disk(exc)
        else:
            self._rebuild_in_process(exc)

    def _check_rebuild_budget(self, exc: Exception):
        if self._rebuild_count >= self.cfg.max_rebuilds:
            self._fail_terminally(
                exc, f"max_rebuilds={self.cfg.max_rebuilds} exhausted")

    def _rebuild_in_process(self, exc: Exception):
        """Poisoned engine, process still alive: rebuild at the current
        world size and restore the newest in-memory snapshot (or restart
        from step 0 when none was taken yet — the factory's deterministic
        init plus a rewound cursor is still bitwise)."""
        self._check_rebuild_budget(exc)
        t0 = self._clock()
        self._rebuild_count += 1
        failed_at = self.engine.global_steps + 1 if self.engine else 0
        snap = self._snapshots[-1] if self._snapshots else None
        new = self._build_engine()
        if snap is not None:
            new.restore_from_host_state(
                snap.host_tree, snap.meta,
                verify_integrity=snap.manifest if self.cfg.verify_integrity
                else None)
            new.set_rng_state(snap.rng_key)
            self._rewind_loader(snap.cursor)
            source, resume_step = "memory", snap.step
        else:
            self._rewind_loader(None)
            source, resume_step = "cold", 0
        self.engine = new
        self._finish_recovery(exc, t0, source, resume_step, failed_at)

    def _restore_from_disk(self, exc: TrainPreempted):
        """Process loss: build a replacement and restore the newest
        COMMITTED tag, refusing torn ones via the engine's fallback walk.
        No disk, or nothing committed, means a cold restart from step 0."""
        if getattr(exc, "degrade", False) and self.cfg.degrade_world_sizes:
            raise not_ported("the degrade ladder (TrainPreempted(degrade=True) with "
                             "degrade_world_sizes: elasticity and more than one device, "
                             "items 8 and 12)")
        # land (or surface the tear of) any checkpoint still in flight on
        # the dying engine before the replacement scans the disk
        self._fence_pending_save()
        self._check_rebuild_budget(exc)
        t0 = self._clock()
        self._rebuild_count += 1
        failed_at = self.engine.global_steps + 1 if self.engine else 0
        new = self._build_engine()
        source, resume_step, client_state = "cold", 0, {}
        if self.cfg.snapshot_dir is not None:
            try:
                path, client_state = new.load_checkpoint(
                    self.cfg.snapshot_dir,
                    verify_integrity=self.cfg.verify_integrity)
            except ckpt_integrity.TornCheckpointError as torn:
                # every tag on disk was torn: the refusals were emitted
                # as ckpt_refused events by the engine's fallback walk
                logger.warning(f"disk restore found no committed tag: {torn}")
                path, client_state = None, {}
            if path is not None:
                source, resume_step = "disk", new.global_steps
        if source == "cold":
            self._rewind_loader(None)
        else:
            if client_state.get("rng_key") is not None:
                new.set_rng_state(np.asarray(client_state["rng_key"]))
            self._rewind_loader(client_state.get("data_cursor"))
        self.engine = new
        self._finish_recovery(exc, t0, source, resume_step, failed_at)

    def _finish_recovery(self, exc, t0, source, resume_step, failed_at):
        # one world size: the reference's "degraded"/"world_size" fields
        # keep their not-degraded values
        recovery_ms = (self._clock() - t0) * 1000.0
        self._recovery_ms.append(recovery_ms)
        self._fault_event("rebuild", step=failed_at, source=source,
                          resume_step=resume_step,
                          replayed_steps=max(0, failed_at - 1 - resume_step),
                          recovery_ms=round(recovery_ms, 3),
                          rebuilds=self._rebuild_count, degraded=False,
                          world_size=0)
        if self._tele is not None and self._tele.enabled:
            reg = self._tele.registry
            reg.counter("rebuild_total").inc()
            reg.histogram("recovery_ms").observe(recovery_ms)
        if self._step_span is not None:
            # whole-rebuild window (both in-process and disk-restore
            # paths converge here with the rung's t0 in hand)
            self._spans.emit(
                "train_rebuild", f"step:{failed_at}", t0, self._clock(),
                parent_id=self._step_span,
                attrs={"source": source, "resume_step": resume_step,
                       "degraded": False,
                       "rebuilds": self._rebuild_count})
        logger.warning(
            f"training engine rebuilt after {type(exc).__name__} at step "
            f"{failed_at} (#{self._rebuild_count}, {recovery_ms:.1f} ms, "
            f"resume from {source} at step {resume_step})")

    def _fail_terminally(self, exc: Exception, reason: str):
        steps = self.engine.global_steps if self.engine is not None else 0
        tag = (ckpt_integrity.latest_committed_tag(self.cfg.snapshot_dir)
               if self.cfg.snapshot_dir is not None else None)
        self._fault_event("failed", step=steps, reason=reason,
                          error=type(exc).__name__, detail=str(exc)[:200])
        raise TrainingFailed(
            f"training failed: {reason} (last error: "
            f"{type(exc).__name__}: {exc})",
            steps_completed=steps, last_committed_tag=tag) from exc

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def _count_fault(self, exc: Exception, **fields):
        self._fault_count += 1
        if self._tele is not None and self._tele.enabled:
            self._tele.registry.counter("train_fault_total").inc()
        self._fault_event("fault", error=type(exc).__name__,
                          detail=str(exc)[:200], **fields)

    def _fault_event(self, event: str, **fields):
        if self._tele is not None and self._tele.enabled:
            payload = {"event": event}
            payload.update(fields)
            self._tele.emit("train_fault", payload)

    def recovery_stats(self) -> dict:
        """In-process view of the fault/recovery accounting (what
        ``ds_trace_report --train`` recomputes from ``train_fault``
        trace events)."""
        out = {
            "faults": self._fault_count,
            "retries": self._retry_count,
            "rebuilds": self._rebuild_count,
            "torn_writes": self._torn_writes,
            "snapshots": self._snapshots_taken,
            "degrade_level": 0,
            "world_size": None,
            "quarantines": self._quarantine_count,
            "rewinds": self._rewind_count,
            "sdc_probes": self._sdc_probes,
            "sdc_mismatches": self._sdc_mismatches,
        }
        if self.sentinel is not None:
            out["numeric_anomalies"] = dict(self.sentinel.anomalies)
        if self._recovery_ms:
            rs = sorted(self._recovery_ms)
            out["recovery_ms"] = {
                "count": len(rs),
                "p50": round(percentile(rs, 50.0), 3),
                "max": round(rs[-1], 3),
            }
        return out
