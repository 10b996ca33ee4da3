"""Dynamic and static loss scaling.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (reference:
``runtime/fp16/loss_scaler.py`` ``DynamicLossScaler`` :90 — on overflow
halve the scale with hysteresis, after ``scale_window`` clean steps double
it). The same pure state transition, with the state as plain tensors on the
engine's device, so deciding the next scale needs no host sync.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: torch.Tensor  # f32 scalar
    good_steps: torch.Tensor  # i32 since last overflow/raise
    hysteresis: torch.Tensor  # i32 remaining tolerated overflows before lowering


def _i32(x, device):
    return torch.tensor(x, dtype=torch.int32, device=device)


class DynamicLossScaler:
    def __init__(
        self,
        init_scale: float = 2.0**16,
        scale_factor: float = 2.0,
        scale_window: int = 1000,
        min_scale: float = 1.0,
        delayed_shift: int = 2,
        consecutive_hysteresis: bool = False,
        raise_error_at_min_scale: bool = False,
    ):
        self.init_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = max(delayed_shift, 1)
        self.consecutive_hysteresis = consecutive_hysteresis
        self.dynamic = True

    def init(self, device=None) -> LossScaleState:
        return LossScaleState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32, device=device),
            good_steps=_i32(0, device),
            hysteresis=_i32(self.delayed_shift, device),
        )

    def update(self, state: LossScaleState, overflow) -> LossScaleState:
        """Pure transition; ``overflow`` is a bool scalar tensor."""
        hysteresis_spent = state.hysteresis <= 1
        new_scale_on_ovf = torch.where(
            hysteresis_spent,
            torch.clamp(state.scale / self.scale_factor, min=self.min_scale),
            state.scale,
        )
        new_hyst_on_ovf = torch.where(hysteresis_spent, state.hysteresis, state.hysteresis - 1)

        grown = state.good_steps + 1 >= self.scale_window
        new_scale_ok = torch.where(grown, state.scale * self.scale_factor, state.scale)
        new_good_ok = torch.where(grown, torch.zeros_like(state.good_steps), state.good_steps + 1)
        new_hyst_ok = (
            torch.full_like(state.hysteresis, self.delayed_shift)
            if not self.consecutive_hysteresis else state.hysteresis
        )

        return LossScaleState(
            scale=torch.where(overflow, new_scale_on_ovf, new_scale_ok),
            good_steps=torch.where(overflow, torch.zeros_like(state.good_steps), new_good_ok),
            hysteresis=torch.where(overflow, new_hyst_on_ovf, new_hyst_ok),
        )


class StaticLossScaler:
    def __init__(self, scale: float = 1.0):
        self.scale = scale
        self.dynamic = False

    def init(self, device=None) -> LossScaleState:
        return LossScaleState(
            scale=torch.tensor(self.scale, dtype=torch.float32, device=device),
            good_steps=_i32(0, device),
            hysteresis=_i32(1, device),
        )

    def update(self, state: LossScaleState, overflow) -> LossScaleState:
        return state


def create_loss_scaler(fp16_config, fp16_enabled: bool):
    """Map the fp16 config block to a scaler (reference: engine.py loss-scale
    wiring via fp16.loss_scale==0 => dynamic)."""
    if not fp16_enabled:
        return StaticLossScaler(1.0)
    if fp16_config.loss_scale and fp16_config.loss_scale > 0:
        return StaticLossScaler(fp16_config.loss_scale)
    return DynamicLossScaler(
        init_scale=2.0**fp16_config.initial_scale_power,
        scale_window=fp16_config.loss_scale_window,
        min_scale=fp16_config.min_loss_scale,
        delayed_shift=fp16_config.hysteresis,
        consecutive_hysteresis=fp16_config.consecutive_hysteresis,
    )
