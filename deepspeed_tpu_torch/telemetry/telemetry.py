"""Telemetry hub (counterpart of ``deepspeed_tpu/telemetry/telemetry.py``):
one object per engine fanning events into every export path, the JSONL
trace file, the in-process :class:`MetricsRegistry` (for ``summary()``
percentiles) and monitor writers, plus the optional ``torch.profiler``
capture window.

Disabled (the default) it is inert: ``emit`` returns immediately, no file
is opened, no profiler started. Engines therefore construct one
unconditionally and guard hot-path measurement (timers, device syncs) on
``telemetry.enabled`` only.

Where the reference asks JAX, the port asks PyTorch: the trace writer
opens on rank 0 of ``torch.distributed`` (rank 0 when it is not
initialized), the MFU denominator is the H100's dense bf16 peak, and the
capture window is a ``torch.profiler`` session written as a Chrome trace.
"""

import json
import os
from typing import Optional

from deepspeed_tpu_torch.telemetry.config import TelemetryConfig
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
from deepspeed_tpu_torch.telemetry.trace import SCHEMA_VERSION, TraceWriter
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import logger

# the MFU denominator: the H100's dense bf16 tensor-core peak (TFLOP/s).
# Override via telemetry.peak_tflops_per_device.
_PEAK_TFLOPS = 989.0


def _numeric_items(payload: dict):
    for k, v in payload.items():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            yield k, float(v)


def _process_rank() -> int:
    """This process's rank in ``torch.distributed``, 0 when it is not
    initialized (one process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Telemetry:
    def __init__(self, cfg: Optional[TelemetryConfig] = None, monitor=None,
                 role: str = "train"):
        self.cfg = cfg if cfg is not None else TelemetryConfig()
        self.enabled = self.cfg.enabled
        self.role = role
        self.monitor = monitor
        self.registry = MetricsRegistry()
        self._writer = None
        self._write_warned = False
        self._profiler = None
        if self.enabled and self.cfg.trace_file and _process_rank() == 0:
            self._writer = TraceWriter(self.cfg.trace_file,
                                       max_bytes=self.cfg.max_trace_bytes)

    # ------------------------------------------------------------------
    def span(self, name: str, labels: Optional[dict] = None):
        return self.registry.span(name, labels)

    def emit(self, kind: str, payload: dict, monitor_prefix: Optional[str] = None,
             monitor_step: Optional[int] = None):
        """Fan one structured event into every export path. ``payload`` is
        flat-ish JSON (nested dicts allowed; only top-level numerics feed
        the registry/monitor). Returns the full event dict (None when
        disabled)."""
        if not self.enabled:
            return None
        event = {"role": self.role}
        event.update(payload)
        for field, value in _numeric_items(payload):
            self.registry.histogram(f"{kind}.{field}").observe(value)
        if self._writer is not None:
            try:
                rotations_before = self._writer.rotations
                self._writer.write(kind, event)
                if self._writer.rotations != rotations_before:
                    self.registry.counter("trace_rotations").inc(
                        self._writer.rotations - rotations_before)
            except OSError as e:  # telemetry must never kill the step loop
                # count the drop, warn ONCE, and drop the file handle so the
                # next emit retries through the writer's lazy reopen
                self.registry.counter("trace_write_errors").inc()
                if not self._write_warned:
                    logger.warning(
                        f"telemetry trace write failed (will retry on the "
                        f"next event; trace_write_errors counts drops): {e}")
                    self._write_warned = True
                try:
                    self._writer.close()
                except OSError:
                    self._writer._fh = None  # force the lazy reopen anyway
        if (monitor_prefix and self.cfg.emit_to_monitor
                and self.monitor is not None and self.monitor.enabled):
            step = int(monitor_step if monitor_step is not None
                       else payload.get("step", 0))
            self.monitor.write_events(
                [(f"{monitor_prefix}/{field}", value, step)
                 for field, value in _numeric_items(payload)]
            )
        event.setdefault("schema", SCHEMA_VERSION)
        event.setdefault("kind", kind)
        return event

    # ------------------------------------------------------------------
    def compile_recorder(self):
        """The reference's compile flight recorder. The port compiles
        nothing; its counterpart is the timing of CUDA-graph captures."""
        raise not_ported("the compile flight recorder (telemetry/compile_log.py; "
                         "ROADMAP Queue 1 item 11 (b))")

    # ------------------------------------------------------------------
    def peak_flops_per_device(self) -> float:
        """MFU denominator in FLOP/s per local device."""
        return (self.cfg.peak_tflops_per_device or _PEAK_TFLOPS) * 1e12

    # ------------------------------------------------------------------
    def _profile_dir(self) -> str:
        cfg = self.cfg
        return cfg.profile_dir or os.path.join(
            os.path.dirname(os.path.abspath(cfg.trace_file or ".")), "torch_trace")

    def _stop_profiler(self):
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = self._profile_dir()
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"trace_rank{_process_rank()}.json"))

    def maybe_capture(self, step: int):
        """Drive the configured ``torch.profiler`` window: start when
        ``step`` reaches ``profile_start_step``, stop ``profile_num_steps``
        later and write the Chrome trace to ``profile_dir`` (default: a
        ``torch_trace`` folder beside the trace file). Failures never
        propagate into the loop that calls this."""
        cfg = self.cfg
        if not self.enabled or cfg.profile_start_step <= 0:
            return
        try:
            if self._profiler is None and step == cfg.profile_start_step:
                import torch

                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._profiler = torch.profiler.profile(activities=acts)
                self._profiler.start()
            elif (self._profiler is not None
                  and step >= cfg.profile_start_step + cfg.profile_num_steps):
                self._stop_profiler()
        except Exception as e:
            logger.warning(f"telemetry profiler capture failed: {e}")
            self._profiler = None

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """Aggregated view of everything emitted so far (counters, gauges,
        per-field histogram percentiles)."""
        return {
            "schema": SCHEMA_VERSION,
            "role": self.role,
            "metrics": self.registry.dump(),
        }

    def dump_summary(self, path: str) -> dict:
        s = self.summary()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(s, fh, indent=2, sort_keys=True)
        return s

    def close(self):
        if self._profiler is not None:
            try:
                self._stop_profiler()
            except Exception:
                self._profiler = None
        if self._writer is not None:
            self._writer.close()
