"""Structured JSONL trace writer (counterpart of
``deepspeed_tpu/telemetry/trace.py``, copied).

One event per line; every event carries ``"schema": 1`` (bump on any
incompatible field change), a ``"kind"`` discriminator ("train_step",
"inference_request", "serving_tick", ...) and a wall-clock ``"ts"``.
"""

import json
import os
import time

SCHEMA_VERSION = 1


def _json_default(obj):
    """Coerce numpy/torch scalars (and anything with .item()) to JSON."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


class TraceWriter:
    """Append-only JSONL writer; the file opens lazily on the first event
    (so a constructed-but-never-used writer creates nothing) and each line
    is flushed — a crashed run keeps every completed event.

    ``max_bytes`` > 0 size-bounds the file: once a completed write
    reaches the limit the file rotates to ``<path>.1`` (one generation —
    the previous ``.1`` is replaced, so disk use stays <= ~2x the bound)
    and the next event lazily reopens a fresh file. ``rotations`` counts
    rotations for the hub's ``trace_rotations`` counter. Rotation happens
    AFTER the triggering line is flushed, so no event is ever torn across
    files."""

    def __init__(self, path: str, max_bytes: int = 0):
        self.path = path
        self.max_bytes = int(max_bytes or 0)
        self.rotations = 0
        self._fh = None

    def write(self, kind: str, payload: dict):
        event = {"schema": SCHEMA_VERSION, "kind": kind, "ts": time.time()}
        event.update(payload)
        if self._fh is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(event, default=_json_default) + "\n")
        self._fh.flush()
        if self.max_bytes > 0 and self._fh.tell() >= self.max_bytes:
            self._rotate()
        return event

    def _rotate(self):
        self._fh.close()
        self._fh = None
        os.replace(self.path, self.path + ".1")
        self.rotations += 1

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_trace(path: str):
    """Yield parsed events from a JSONL trace, skipping malformed lines
    (a crashed writer may leave a torn final line)."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict):
                yield ev
