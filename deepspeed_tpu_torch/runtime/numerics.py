"""Numerical-health sentinel: silent-corruption detection policy
(counterpart of ``deepspeed_tpu/runtime/numerics.py``, copied).

The fp16 loss scaler catches exactly one failure shape — inf/NaN grads
on the fp16 path. Everything else that eats production runs is
*silent*: a poisoned batch that spikes the loss, a bit-flipped
accumulator that stays finite, a grad stream that quietly collapses to
zero. :class:`NumericSentinel` watches the per-step host scalars the
engine already holds (loss, grad_norm, overflow flag, loss scale) and
issues a per-step verdict:

- ``ok``      — nothing to see;
- ``suspect`` — out of band but survivable (the supervisor quarantines
  the batch pre-apply, or journals the anomaly post-apply);
- ``corrupt`` — the math is provably wrong (NaN/Inf beyond the fp16
  path, an extreme spike, an SDC probe mismatch): post-apply this
  triggers rewind-and-replay.

Detectors (all O(1) host arithmetic per step):

- **robust loss z-score** — ``max(0, loss - median) / (1.4826·MAD)``
  over a sliding window of *accepted* losses. One-sided on purpose:
  corruption spikes the loss UP; a clean converging run drifts DOWN and
  must never trip it (the zero-false-positive gate).
- **grad-norm EWMA band** — ratio of the step's grad norm to an EWMA of
  accepted norms; ``suspect`` / ``corrupt`` at configurable multiples.
- **NaN/Inf beyond fp16** — a non-finite loss or grad norm with the
  overflow flag DOWN. (Overflow-flagged steps were already skipped by
  the loss scaler: verdict ``ok``, baselines not updated.)
- **zero-grad stall** — ``patience`` consecutive ~zero grad norms
  (dead graph / detached loss), ``suspect``.

Anomalous observations never update the baselines — a corrupt step must
not teach the sentinel that corruption is normal.

The optional **SDC probe** (:func:`crc_digest` + the supervisor's
cadence) replays one sentinel micro-step from a pinned batch and
CRC-compares the raw grad bytes across back-to-back executions: equal
where a step is a deterministic function of its inputs, so a mismatch is
nondeterministic hardware corruption.

numpy + stdlib only.
"""

import math
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

#: verdict values, in escalation order
OK, SUSPECT, CORRUPT = "ok", "suspect", "corrupt"


class NumericCorruption(RuntimeError):
    """Raised by the supervisor when the sentinel's own rungs (quarantine
    budget, rewind budget, no snapshot to rewind to) are exhausted — it
    enters the ordinary escalation ladder as a poisoning failure."""

    def __init__(self, message: str, verdict: Optional["Verdict"] = None):
        super().__init__(message)
        self.verdict = verdict


@dataclass
class SentinelConfig:
    """Detector knobs (see docs/training.md "Numerical health").

    - ``loss_window``: sliding window of accepted losses for the robust
      z-score; ``min_history`` accepted observations arm each detector
      (cold-start steps are never flagged).
    - ``loss_z_suspect`` / ``loss_z_corrupt``: one-sided robust z-score
      thresholds. The MAD is floored at ``rel_floor·|median|`` so a
      plateaued loss (MAD → 0) cannot make ordinary jitter look
      infinitely significant.
    - ``grad_ewma_alpha``: EWMA smoothing for the grad-norm baseline;
      ``grad_band_suspect`` / ``grad_band_corrupt`` are ratio-to-EWMA
      thresholds.
    - ``zero_grad_eps`` / ``zero_grad_patience``: grad norms at or below
      eps for ``patience`` consecutive steps = stall (suspect).
    - ``sdc_probe_every``: supervisor probe cadence in optimizer steps
      (0 = off). Each probe costs two extra micro-step executions of the
      pinned batch — cadence N amortizes that to 2/N micro-steps per
      step.
    """

    loss_window: int = 32
    min_history: int = 8
    loss_z_suspect: float = 8.0
    loss_z_corrupt: float = 24.0
    rel_floor: float = 0.01
    grad_ewma_alpha: float = 0.2
    grad_band_suspect: float = 10.0
    grad_band_corrupt: float = 100.0
    zero_grad_eps: float = 1e-12
    zero_grad_patience: int = 5
    sdc_probe_every: int = 0

    def __post_init__(self):
        if self.loss_window < 4:
            raise ValueError("loss_window must be >= 4")
        if not 1 <= self.min_history <= self.loss_window:
            raise ValueError("min_history must be in [1, loss_window]")
        if not 0 < self.loss_z_suspect <= self.loss_z_corrupt:
            raise ValueError(
                "need 0 < loss_z_suspect <= loss_z_corrupt")
        if self.rel_floor < 0:
            raise ValueError("rel_floor must be >= 0")
        if not 0 < self.grad_ewma_alpha <= 1:
            raise ValueError("grad_ewma_alpha must be in (0, 1]")
        if not 1 < self.grad_band_suspect <= self.grad_band_corrupt:
            raise ValueError(
                "need 1 < grad_band_suspect <= grad_band_corrupt")
        if self.zero_grad_eps < 0:
            raise ValueError("zero_grad_eps must be >= 0")
        if self.zero_grad_patience < 1:
            raise ValueError("zero_grad_patience must be >= 1")
        if self.sdc_probe_every < 0:
            raise ValueError("sdc_probe_every must be >= 0 (0 = off)")

    @classmethod
    def parse(cls, spec) -> "SentinelConfig":
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(f"numeric_sentinel must be a SentinelConfig or "
                        f"dict, got {type(spec).__name__}")


@dataclass
class Verdict:
    """One observation's outcome. ``reasons`` are anomaly-kind slugs
    (``loss_spike`` / ``non_finite_loss`` / ``grad_norm_explosion`` /
    ``non_finite_grad_norm`` / ``zero_grad_stall`` / ``sdc_mismatch``) —
    the label values of ``numeric_anomaly_total{kind}``."""

    verdict: str = OK
    reasons: List[str] = field(default_factory=list)
    step: int = 0
    zscore: float = 0.0
    grad_ratio: float = 0.0

    @property
    def ok(self) -> bool:
        return self.verdict == OK

    @property
    def corrupt(self) -> bool:
        return self.verdict == CORRUPT


def _escalate(current: str, new: str) -> str:
    order = (OK, SUSPECT, CORRUPT)
    return new if order.index(new) > order.index(current) else current


class NumericSentinel:
    """The per-run detector state: a sliding window of accepted losses,
    an EWMA of accepted grad norms, a stall streak, and the anomaly
    tally. Two entry points, matching the two decision windows the
    supervisor has:

    - :meth:`check_loss` — PRE-apply, on the micro-averaged loss the
      supervisor already holds; a non-ok verdict here means the batch
      can still be quarantined (its grads were never applied).
    - :meth:`check_step` — POST-apply, on the step metrics the engine
      fetched for telemetry; ``corrupt`` here means wrong state was
      already committed and only rewind-and-replay un-commits it.
    """

    def __init__(self, config=None):
        self.cfg = SentinelConfig.parse(config)
        self._losses: List[float] = []   # accepted, newest last
        self._grad_ewma: Optional[float] = None
        self._grad_seen = 0
        self._zero_streak = 0
        # highest step each detector has fully vetted: rewind-and-replay
        # (and the ladder's rebuilds) re-execute steps the sentinel has
        # already accepted, and re-observing the identical loss would
        # double-count the sample and collapse the MAD to zero — so a
        # replayed step keeps only the always-on non-finite guard
        self._seen_loss_step = 0
        self._seen_grad_step = 0
        self.observations = 0
        self.anomalies: Dict[str, int] = {}  # reason slug -> count

    # ------------------------------------------------------------------
    # detectors
    # ------------------------------------------------------------------
    def check_loss(self, step: int, loss: float) -> Verdict:
        """Pre-apply verdict on this step's (micro-averaged) loss."""
        v = Verdict(step=step)
        loss = float(loss)
        if not math.isfinite(loss):
            self._flag(v, CORRUPT, "non_finite_loss")
            return v
        if step <= self._seen_loss_step:
            return v  # replay of an already-vetted step (see __init__)
        if len(self._losses) >= self.cfg.min_history:
            arr = np.asarray(self._losses, dtype=np.float64)
            med = float(np.median(arr))
            mad = float(np.median(np.abs(arr - med)))
            scale = 1.4826 * mad + self.cfg.rel_floor * max(abs(med), 1e-12)
            v.zscore = max(0.0, loss - med) / max(scale, 1e-300)
            if v.zscore >= self.cfg.loss_z_corrupt:
                self._flag(v, CORRUPT, "loss_spike")
            elif v.zscore >= self.cfg.loss_z_suspect:
                self._flag(v, SUSPECT, "loss_spike")
        if v.ok:
            # flagged steps never advance the watermark: a quarantined
            # step is retried with the NEXT batch under the same number,
            # and that retry must get the full check
            self._seen_loss_step = step
            self._losses.append(loss)
            del self._losses[:-self.cfg.loss_window]
        return v

    def check_step(self, step: int, grad_norm: float, overflow: bool,
                   loss_scale: float = 1.0) -> Verdict:
        """Post-apply verdict on the step metrics the engine fetched."""
        del loss_scale  # reserved: scale-aware banding
        v = Verdict(step=step)
        self.observations += 1
        grad_norm = float(grad_norm)
        if overflow:
            # the loss scaler already skipped this step's apply — loud,
            # handled, and not this sentinel's problem; baselines freeze
            return v
        if not math.isfinite(grad_norm):
            self._flag(v, CORRUPT, "non_finite_grad_norm")
            return v
        if step <= self._seen_grad_step:
            return v  # replay of an already-vetted step (see __init__)
        # marked seen whatever the verdict: a corrupt step is rewound and
        # replayed under the same number with the (spent) fault gone
        self._seen_grad_step = step
        if self._grad_ewma is not None and self._grad_seen >= self.cfg.min_history:
            v.grad_ratio = grad_norm / max(self._grad_ewma, 1e-300)
            if v.grad_ratio >= self.cfg.grad_band_corrupt:
                self._flag(v, CORRUPT, "grad_norm_explosion")
            elif v.grad_ratio >= self.cfg.grad_band_suspect:
                self._flag(v, SUSPECT, "grad_norm_explosion")
        if grad_norm <= self.cfg.zero_grad_eps:
            self._zero_streak += 1
            if self._zero_streak >= self.cfg.zero_grad_patience:
                self._flag(v, SUSPECT, "zero_grad_stall")
        else:
            self._zero_streak = 0
        if v.ok:
            a = self.cfg.grad_ewma_alpha
            self._grad_ewma = (grad_norm if self._grad_ewma is None
                               else (1 - a) * self._grad_ewma + a * grad_norm)
            self._grad_seen += 1
        return v

    def flag_sdc_mismatch(self, step: int) -> Verdict:
        """Record an SDC probe digest mismatch — always ``corrupt``."""
        v = Verdict(step=step)
        self._flag(v, CORRUPT, "sdc_mismatch")
        return v

    def note_rewind(self):
        """The supervisor rewound state: the stall streak no longer
        describes the live trajectory (windowed baselines stay — they
        summarize accepted history, which rewind does not invalidate)."""
        self._zero_streak = 0

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def _flag(self, v: Verdict, verdict: str, reason: str):
        v.verdict = _escalate(v.verdict, verdict)
        v.reasons.append(reason)
        self.anomalies[reason] = self.anomalies.get(reason, 0) + 1

    def stats(self) -> dict:
        return {
            "observations": self.observations,
            "anomalies": dict(self.anomalies),
            "loss_history": len(self._losses),
            "grad_ewma": self._grad_ewma,
        }


def crc_digest(arrays) -> int:
    """Order-sensitive CRC-32 over the raw bytes of a sequence of numpy
    arrays — the SDC probe's grad fingerprint. Cheap (one pass, no
    copies beyond contiguity) and exact: two bitwise-identical grad
    trees digest equal, one flipped bit anywhere does not."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc & 0xFFFFFFFF
