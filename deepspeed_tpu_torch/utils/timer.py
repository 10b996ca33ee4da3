"""Wall-clock and throughput timers, as far as the training engine uses them.

Counterpart of ``deepspeed_tpu/utils/timer.py`` (reference:
``deepspeed/utils/timer.py``): named timers that, when asked to, synchronise
with the device at their edges (``torch.cuda.synchronize`` where CUDA is up)
so that they measure device work and not the asynchronous launch, and the
``ThroughputTimer`` samples/sec accounting the engine logs each
``steps_per_print``.
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import logger


def _sync():
    """Block until previously launched device work completes."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    def __init__(self, name: str, synchronize: bool = False):
        self.name = name
        self.synchronize = synchronize
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self.count = 0

    def start(self):
        if self.started:
            return
        if self.synchronize:
            _sync()
        self._start = time.time()
        self.started = True

    def stop(self, record: bool = True):
        if not self.started:
            return
        if self.synchronize:
            _sync()
        if record:
            self._elapsed += time.time() - self._start
            self.count += 1
        self.started = False

    def elapsed(self, reset: bool = True) -> float:
        """Total recorded seconds; optionally reset."""
        if self.started:
            self.stop()
            self.start()
        value = self._elapsed
        if reset:
            self._elapsed = 0.0
            self.count = 0
        return value


class SynchronizedWallClockTimer:
    """A registry of named timers; ``log`` prints ms per name."""

    def __init__(self, synchronize: bool = True):
        self.timers = {}
        self.synchronize = synchronize

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, synchronize=self.synchronize)
        return self.timers[name]

    def log(self, names=None, normalizer: float = 1.0, reset: bool = True):
        assert normalizer > 0.0
        names = names if names is not None else list(self.timers)
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}")
        if parts:
            logger.info("time (ms) | " + " | ".join(parts))


class ThroughputTimer:
    """Samples/sec over training steps, skipping warmup. It reads the host
    clock without synchronising with the device, so its spans end where
    the host got to, not where the device did."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self._started = False
        self._start_time = 0.0

    def start(self):
        self._started = True
        self._start_time = time.time()

    def stop(self, global_step: bool):
        if not self._started:
            return
        self._started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        duration = time.time() - self._start_time
        if self.global_step_count >= self.start_step:
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step and self.global_step_count % self.steps_per_output == 0:
                logger.info(
                    f"micro_step={self.micro_step_count}/global_step={self.global_step_count}, "
                    f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.2f}, "
                    f"CurrSamplesPerSec={self.batch_size * self.steps_per_output / self.step_elapsed_time:.2f}"
                )
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            steps = self.global_step_count - self.start_step
            return self.batch_size * steps / self.total_elapsed_time
        return 0.0


class EngineTimers:
    """Forward/backward/step timers, mirroring the reference engine's
    ``wall_clock_breakdown`` accounting (engine.py:148)."""

    FORWARD = "fwd"
    BACKWARD = "bwd"
    STEP = "step"

    def __init__(self, enable: bool):
        self.enabled = enable
        self.timers = SynchronizedWallClockTimer(synchronize=enable)

    def __call__(self, name):
        return self.timers(name)

    def log(self, normalizer: float = 1.0):
        if self.enabled:
            self.timers.log([self.FORWARD, self.BACKWARD, self.STEP], normalizer=normalizer)
