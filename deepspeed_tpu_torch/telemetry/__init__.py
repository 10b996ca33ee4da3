"""Unified telemetry layer (counterpart of ``deepspeed_tpu/telemetry/``):
labeled metrics, structured JSONL request traces, request-scoped spans
and their timelines, the live ops plane, and ``torch.profiler`` capture.

Entry points:
  - :class:`Telemetry` — per-engine hub (``InferenceEngine.telemetry``,
    shared by the batching engine and the serving layer), built from the
    ``telemetry`` config block (default off).
  - :class:`MetricsRegistry` — standalone counters/gauges/histograms/spans.
  - :class:`TraceWriter` / :func:`read_trace` — the JSONL format
    (``"schema": 1``).
  - :class:`OpsServer` / :func:`render_prometheus` — ``/metrics``,
    ``/healthz`` and ``/statusz`` on loopback.

Not ported (ROADMAP Queue 1 item 11 (b)): the device-memory accountant
(``telemetry/memory.py``) and the compile flight recorder
(``telemetry/compile_log.py``).
"""

from deepspeed_tpu_torch.telemetry.config import TelemetryConfig
from deepspeed_tpu_torch.telemetry.ops_server import OpsServer, render_prometheus
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry, metric_key, percentile
from deepspeed_tpu_torch.telemetry.telemetry import Telemetry
from deepspeed_tpu_torch.telemetry.trace import SCHEMA_VERSION, TraceWriter, read_trace

__all__ = [
    "Telemetry",
    "TelemetryConfig",
    "MetricsRegistry",
    "TraceWriter",
    "read_trace",
    "metric_key",
    "percentile",
    "SCHEMA_VERSION",
    "OpsServer",
    "render_prometheus",
]
