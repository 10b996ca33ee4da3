"""Preemption-safe request recovery (counterpart of
``deepspeed_tpu/serving/recovery.py``, copied): the host state the serving
layer needs to rebuild an engine mid-run.

What makes recovery bitwise testable: every sampled token draws from a
key of (seed, engine rid, token index) on the device
(``inference/decoding.request_keys``), so a request rebuilt on a FRESH
engine by re-prefilling ``prompt + emitted_tokens`` and resuming at
``gen_base = len(emitted)`` with the same engine rid continues with the
token stream the fault-free run would have produced. The
:class:`RecoveryLog` holds everything that resume needs, as plain host
data, JSONL-serializable:

- per running request: prompt ids, emitted tokens, remaining quota,
  tenant / priority / deadline, the engine rid (the RNG identity), and
  the serving-level prefix id if admission spliced one.

:class:`RecoveryConfig` is the watchdog/retry/rebuild knob block the
:class:`~deepspeed_tpu_torch.serving.engine.ServingEngine` reads;
:class:`RecoveryFailed` is the terminal error ``run()`` surfaces when
every escalation level (retry -> rebuild) is exhausted.
"""

import json
from dataclasses import dataclass
from typing import Dict, List, Optional


class RecoveryFailed(RuntimeError):
    """Terminal serving failure: the tick failed, retries were exhausted,
    and no engine rebuild (at any degradation level) succeeded. Every
    in-flight request has been marked shed before this is raised — no
    request is silently lost."""


@dataclass
class RecoveryConfig:
    """Watchdog + recovery knobs (``ServingEngine(recovery=...)``).

    - ``fetch_timeout_s``: per-tick watchdog on the engine's packed-result
      fetch (``ContinuousBatchingEngine.fetch_timeout_s``); a fetch
      exceeding it poisons the engine and triggers a rebuild. None = off.
    - ``max_tick_retries``: bounded retry-with-backoff budget for a
      CLEAN tick failure (raised before the engine mutated state);
      exhausting it — or any poisoned/preemption failure — escalates to
      engine rebuild.
    - ``backoff_s``: base retry backoff, doubled per attempt.
    - ``max_rebuilds``: total engine rebuilds allowed for the serving
      engine's lifetime before recovery is declared failed.
    - ``est_recovery_s``: the ``retry_after_s`` hint for shed-while-
      recovering admissions before any rebuild has been observed (after
      one, the last measured recovery time is used instead).
    """

    fetch_timeout_s: Optional[float] = None
    max_tick_retries: int = 2
    backoff_s: float = 0.05
    max_rebuilds: int = 8
    est_recovery_s: float = 1.0

    def __post_init__(self):
        if self.max_tick_retries < 0:
            raise ValueError("max_tick_retries must be >= 0")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        if self.max_rebuilds < 1:
            raise ValueError("max_rebuilds must be >= 1")
        if self.fetch_timeout_s is not None and self.fetch_timeout_s <= 0:
            raise ValueError("fetch_timeout_s must be > 0 (None = off)")

    @classmethod
    def parse(cls, spec) -> "RecoveryConfig":
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(f"recovery must be a RecoveryConfig or dict, "
                        f"got {type(spec).__name__}")


def snapshot_request(req) -> dict:
    """One request as a plain-data recovery entry (``ServeRequest``
    shape: rid/engine_rid/prompt/tokens/max_new_tokens/priority/tenant/
    deadline_ms/prefix_id). ``engine_rid`` may be None for a request
    that never reached an engine (still queued host-side) — the fleet
    router snapshots those too when it migrates a dead replica's work,
    and re-admission simply assigns a natural rid."""
    return {
        "rid": int(req.rid),
        "engine_rid": (int(req.engine_rid)
                       if req.engine_rid is not None else None),
        "prompt": [int(t) for t in req.prompt],
        "emitted": [int(t) for t in req.tokens],
        "max_new_tokens": int(req.max_new_tokens),
        "priority": int(req.priority),
        "tenant": str(req.tenant),
        "deadline_ms": (float(req.deadline_ms)
                        if req.deadline_ms is not None else None),
        "submit_t": float(req.submit_t),
        "prefix_id": (int(req.prefix_id)
                      if req.prefix_id is not None else None),
        # request-scoped tracing identity (telemetry/spans.py): carried in
        # the entry so a migrated request's survivor-side spans land on the
        # SAME trace_id and stitch under the same root — one timeline
        # across engine generations and replicas. All None when the
        # request was sampled out (no spans anywhere).
        "trace_id": (str(req.trace_id)
                     if getattr(req, "trace_id", None) is not None else None),
        "span_root": (str(req.span_root)
                      if getattr(req, "span_root", None) is not None else None),
        "span_parent": (str(req.span_parent)
                        if getattr(req, "span_parent", None) is not None
                        else None),
    }


class RecoveryLog:
    """Scheduler-visible snapshots of every RUNNING request, keyed by
    serving rid — exactly what engine loss would otherwise destroy.
    Queued requests need no entry (they live host-side in the serving
    queue and survive an engine loss untouched).

    Entries are plain dicts (ints/strs/lists only) so ``snapshot()`` /
    ``to_jsonl()`` round-trip without numpy."""

    def __init__(self):
        self._entries: Dict[int, dict] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    def admit(self, req):
        """Record a request at engine handover (see
        :func:`snapshot_request` for the entry shape)."""
        self._entries[req.rid] = snapshot_request(req)

    def extend(self, rid: int, tokens: List[int]):
        """Append tokens that surfaced for ``rid`` this tick (no-op for
        requests the log does not track — direct engine submitters)."""
        entry = self._entries.get(rid)
        if entry is not None and tokens:
            entry["emitted"].extend(int(t) for t in tokens)

    def retire(self, rid: int):
        """Drop a request that reached a terminal state (finished,
        cancelled, shed): nothing left to recover."""
        self._entries.pop(rid, None)

    def entries(self) -> List[dict]:
        """Live entries in deterministic re-admission order (by engine
        rid — the submission order of the lost engine; queued-request
        entries with no engine rid sort last, by serving rid)."""
        return sorted(self._entries.values(),
                      key=lambda e: ((0, e["engine_rid"])
                                     if e["engine_rid"] is not None
                                     else (1, e["rid"])))

    def snapshot(self) -> List[dict]:
        """Deep-copied plain-data view (safe to serialize/mutate)."""
        return [json.loads(json.dumps(e)) for e in self.entries()]

    def clear(self):
        self._entries.clear()

    def to_jsonl(self, path: str):
        """Durable form: one entry per line, the cross-process recovery
        seed a fleet router would replay onto a replacement replica."""
        with open(path, "w") as fh:
            for entry in self.entries():
                fh.write(json.dumps(entry) + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "RecoveryLog":
        log = cls()
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                log._entries[int(entry["rid"])] = entry
        return log
