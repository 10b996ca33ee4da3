"""The parts of the port's training engine against the reference's, on the
CPU: ``FusedAdam``/``FusedAdamW``, every lr schedule, the dynamic loss
scaler and ``TpuConfig``.

Tolerances. Adam: max |Δ| / max |ref| <= 1e-6 on parameters and moments
after 5 updates (the same f32 formulas; the port's bias corrections are
rounded from doubles where the reference computes them in f32, which moves a
value by an f32 ulp or two). Schedules are the same Python float math
(1e-12). The loss scaler's transitions and the batch-size triple are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import FP16Config, SchedulerConfig
from deepspeed_tpu.runtime.config import TpuConfig as JTpuConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam, FusedAdamW
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.config import TpuConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

ADAM_REL_TOL = 1e-6


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - np.asarray(got))) / np.max(np.abs(ref)))


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_fused_adam_matches_reference_over_5_updates(weight_decay, adam_w_mode, bias_correction):
    kw = dict(lr=1e-2, betas=(0.8, 0.95), eps=1e-6, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    rs = np.random.RandomState(0)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes] for _ in range(5)]
    jopt, topt = JFusedAdam(**kw), FusedAdam(**kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tp)
    for step, g in enumerate(grads):
        lr = kw["lr"] * (1 + step) / 5  # the lr rides per step, as the engine passes it
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp, lr=lr)
        jp = [p + u for p, u in zip(jp, upd)]
        tupd, tstate = topt.update([torch.from_numpy(x) for x in g], tstate, tp, lr=lr)
        assert all(u.dtype == torch.float32 for u in tupd)
        tp = [p + u for p, u in zip(tp, tupd)]
    assert tstate.step == int(jstate.step) == 5
    for a, b in zip(jp + jstate.exp_avg + jstate.exp_avg_sq,
                    tp + tstate.exp_avg + tstate.exp_avg_sq):
        assert _rel(a, b) <= ADAM_REL_TOL


def test_fused_adamw_defaults_to_decoupled_decay():
    assert FusedAdamW(lr=1.0).adam_w_mode and FusedAdamW(adam_w_mode=False).adam_w_mode is False


SCHEDULES = {
    "WarmupLR": dict(warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=10,
                     warmup_type="linear"),
    "WarmupLR-log": dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=10),
    "WarmupDecayLR": dict(total_num_steps=40, warmup_min_lr=0.0, warmup_max_lr=1e-3,
                          warmup_num_steps=10),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3, cycle_first_step_size=10,
                     decay_lr_rate=0.1, decay_step_size=5),
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7,
                        lr_range_test_step_rate=2.0, lr_range_test_staircase=True),
    "CosineAnnealing": dict(total_num_steps=40, warmup_num_steps=5, min_lr=1e-5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_reference(name):
    sched = SchedulerConfig(type=name.split("-")[0], params=SCHEDULES[name])
    j = jlr.create_lr_scheduler(sched, 1e-3)
    t = tlr.create_lr_scheduler(sched, 1e-3)
    ref = [j.lr_at(s) for s in range(51)]
    np.testing.assert_allclose([t.lr_at(s) for s in range(51)], ref, rtol=0, atol=1e-12)
    assert len(set(ref)) > 3  # the schedule moves
    # get_lr reads the step the scheduler has reached, as the engine reads it
    for s in range(51):
        assert t.get_lr() == pytest.approx(ref[s], abs=1e-12)
        t.step()


def test_lr_schedule_registry_matches_reference():
    assert sorted(tlr.SCHEDULE_REGISTRY) == sorted(jlr.SCHEDULE_REGISTRY)
    assert tlr.create_lr_scheduler(None, 1.0) is None


def test_dynamic_loss_scaler_transitions_match_reference():
    kw = dict(init_scale=2.0 ** 8, scale_window=3, min_scale=4.0, delayed_shift=2)
    j, t = jls.DynamicLossScaler(**kw), tls.DynamicLossScaler(**kw)
    js, ts = j.init(), t.init()
    pattern = [0, 0, 0, 1, 1, 0] + [1] * 10 + [0, 0, 0, 0, 1, 0, 0, 0]
    scales = []
    for ovf in pattern:
        js = j.update(js, jnp.asarray(bool(ovf)))
        ts = t.update(ts, torch.tensor(bool(ovf)))
        assert float(ts.scale) == float(js.scale)
        assert int(ts.good_steps) == int(js.good_steps)
        assert int(ts.hysteresis) == int(js.hysteresis)
        scales.append(float(ts.scale))
    # grew after a clean window, fell with hysteresis, held the floor
    assert max(scales) == 512.0 and min(scales) == 4.0


def test_create_loss_scaler_matches_reference():
    for cfg, on in [(FP16Config(), False), (FP16Config(enabled=True), True),
                    (FP16Config(enabled=True, loss_scale=128.0), True)]:
        j, t = jls.create_loss_scaler(cfg, on), tls.create_loss_scaler(cfg, on)
        assert type(j).__name__ == type(t).__name__
        assert float(j.init().scale) == float(t.init().scale)


BENCH = {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 1,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
         "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
         "steps_per_print": 1000000, "mesh": {"data": -1}}


@pytest.mark.parametrize("over", [{}, {"train_batch_size": 16, "gradient_accumulation_steps": 4,
                                       "train_micro_batch_size_per_gpu": None},
                                  {"train_batch_size": 24, "gradient_accumulation_steps": 3},
                                  {"prescale_gradients": True, "gradient_predivide_factor": 2.0}])
def test_config_parses_like_the_reference_on_one_device(over):
    conf = {k: v for k, v in dict(BENCH, **over).items() if v is not None}
    j, t = JTpuConfig(conf, mesh_device_count=1), TpuConfig(conf)
    triple = ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps")
    assert [getattr(t, a) for a in triple] == [getattr(j, a) for a in triple]
    for attr in ("gradient_clipping", "steps_per_print", "seed", "prescale_gradients",
                 "gradient_predivide_factor"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.zero_config.stage == j.zero_config.stage == 0
    assert t.optimizer.type == j.optimizer.type and t.optimizer.params == j.optimizer.params
    assert t.model_dtype() == torch.bfloat16


@pytest.mark.parametrize("extra", [
    {"zero_optimization": {"stage": 2}}, {"mesh": {"data": 2}},
    {"telemetry": {"enabled": True}}, {"pipeline": {"stages": 2}},
    {"zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 0, "overlap_comm": True}},
    {"progressive_layer_drop": {"enabled": True}},
])
def test_config_raises_outside_the_slice(extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TpuConfig(dict(BENCH, **extra))


def test_config_accepts_blocks_left_off():
    conf = dict(BENCH, tensorboard={"enabled": False},
                zero_optimization={"stage": 0, "offload_param": {"device": "none"}})
    assert TpuConfig(conf).train_batch_size == 8
