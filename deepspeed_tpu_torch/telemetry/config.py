"""Telemetry config block (counterpart of ``deepspeed_tpu/telemetry/config.py``).

Only the dataclass is ported, so that ``InferenceConfig`` parses the same
JSON. The telemetry layer itself is not ported yet: the inference engine
raises ``NotImplementedError`` when ``enabled`` is true (ROADMAP.md).

    "telemetry": {
        "enabled": true,
        "trace_file": "runs/trace.jsonl",
        "profile_start_step": 10,
        "profile_num_steps": 3
    }
"""

from dataclasses import dataclass


@dataclass
class TelemetryConfig:
    enabled: bool = False
    # JSONL destination, one event per line ("schema": 1)
    trace_file: str = "telemetry_trace.jsonl"
    # mirror numeric event fields into monitor writers when any are configured
    emit_to_monitor: bool = True
    # block on device work at step boundaries so phase wall times measure compute
    sync_timers: bool = True
    # per-device peak FLOP/s (TFLOP/s) for the MFU denominator; 0 = auto-detect
    peak_tflops_per_device: float = 0.0
    # device-trace capture window: start step (0 = never) and length
    profile_start_step: int = 0
    profile_num_steps: int = 1
    profile_dir: str = ""
    # size bound (bytes) on the JSONL trace file; 0 = unbounded
    max_trace_bytes: int = 0
    # per-device memory capacity override (bytes) for the headroom gauge
    hbm_limit_bytes: int = 0
