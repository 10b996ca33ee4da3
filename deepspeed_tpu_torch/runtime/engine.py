"""Training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``
``TpuEngine``), cut to the single-device path of the training slice.

``forward(batch)`` runs the model's loss with autograd on and returns it;
``backward()`` takes the gradient of ``loss * loss_scale``, adds each
parameter gradient as ``g.float() / predivide`` into f32 accumulators and
frees it (the reference's ``micro_fn``, engine.py:785-800), and advances the
micro-step counter. ``step()`` at the accumulation boundary applies the
reference's ``apply_fn`` (engine.py:841-875): divide by ``scale * gas``, the
fp16 overflow flag, the global norm, clipping by
``min(1, clip / (gnorm + 1e-6))``, the optimizer's update added to the f32
master weights, a cast back into the model-dtype parameters, and a zeroed
accumulator; the lr is read before the scheduler advances.
``train_batch(data_iter)`` runs one accumulation cycle.

Parameters come from a seeded ``torch.Generator`` or from ``params=`` (the
reference's numpy tree or this package's own). The engine keeps f32 masters
when the precision is bf16/fp16. It runs on CUDA unless ``device="cpu"`` is
passed; without CUDA and without that argument it raises. It updates its
buffers in place where the reference's programs donate theirs.

Outside this slice (each raises ``NotImplementedError`` naming ROADMAP.md):
ZeRO stages above 0 and offload, meshes larger than one device, pipeline
and hybrid engines, telemetry, progressive layer drop and random-LTD,
optimizers other than Adam/AdamW, client optimizers, data loaders and
checkpoints.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config import TpuConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import create_loss_scaler
from deepspeed_tpu_torch.runtime.lr_schedules import create_lr_scheduler
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import EngineTimers, ThroughputTimer


class StepMetrics(NamedTuple):
    grad_norm: torch.Tensor
    overflow: torch.Tensor
    loss_scale: torch.Tensor


_OTHER_OPTIMIZERS = (C.LAMB_OPTIMIZER, C.SGD_OPTIMIZER, C.ADAGRAD_OPTIMIZER, C.LION_OPTIMIZER,
                     C.ONEBIT_ADAM_OPTIMIZER, C.ZERO_ONE_ADAM_OPTIMIZER, C.ONEBIT_LAMB_OPTIMIZER)


def _build_optimizer(opt_config) -> FusedAdam:
    """The config's optimizer: Adam (the reference's default is decoupled
    decay, ``adam_w_mode=True``) or AdamW."""
    name = opt_config.type.lower()
    if name in _OTHER_OPTIMIZERS:
        raise not_ported(f"optimizer {opt_config.type!r}")
    if name not in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER):
        raise ValueError(f"Unknown optimizer '{opt_config.type}'; supported: "
                         f"{sorted((C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER))}")
    params = dict(opt_config.params)
    if "betas" in params:
        params["betas"] = tuple(params["betas"])
    params.pop("torch_adam", None)
    if name == C.ADAMW_OPTIMIZER:
        params["adam_w_mode"] = True
    params.setdefault("adam_w_mode", True)
    return FusedAdam(**params)


def _leaves(tree):
    """The tensors of a nested dict/list param tree, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _is_numpy_tree(tree) -> bool:
    return not torch.is_tensor(tree["embed"]["tok"])


class TpuEngine:
    def __init__(self, model, config: TpuConfig, params=None, optimizer=None, lr_scheduler=None,
                 device=None, seed: Optional[int] = None):
        self.config = config
        self.device = get_accelerator().resolve_device(device)
        if isinstance(model, tf.TransformerConfig):
            model = tf.TransformerModel(model)
        if not isinstance(model, tf.TransformerModel):
            raise not_ported(f"training models of type {type(model).__name__}")
        tf.check_trainable(model.cfg)
        self.model = model
        self.zero_stage = config.zero_config.stage

        # --- precision plan (reference: bf16_optimizer / fp16 fused_optimizer)
        self.model_dtype = config.model_dtype()
        if model.cfg.torch_dtype != self.model_dtype:
            raise ValueError(
                f"the model computes in {model.cfg.dtype} but the config trains in "
                f"{self.model_dtype}: set the model's dtype to the config's precision")
        self.mixed_precision = self.model_dtype != torch.float32
        self.fp16_enabled = config.fp16.enabled
        self.loss_scaler = create_loss_scaler(config.fp16, self.fp16_enabled)
        self.predivide = (config.gradient_predivide_factor if config.prescale_gradients
                          else 1.0)

        seed = config.seed if seed is None else seed
        if params is None:
            master = model.init(torch.Generator(device=self.device).manual_seed(int(seed)))
        elif _is_numpy_tree(params):
            master = tf.params_from_numpy(params, model.cfg, self.device)
        else:
            master = params
        # f32 masters of the caller's values (copies: the caller's tree is never updated)
        master = tf.map_params(lambda p: p.detach().to(self.device, torch.float32, copy=True), master)
        if self.mixed_precision:
            self.master_params = master
            self.params = tf.map_params(
                lambda p: p.to(self.model_dtype).requires_grad_(True), master)
        else:
            self.master_params = None
            self.params = tf.map_params(lambda p: p.requires_grad_(True), master)
        self._param_leaves = _leaves(self.params)
        self._base_leaves = _leaves(master)  # what the optimizer updates (f32)

        # --- optimizer
        if optimizer is None and config.optimizer is not None:
            optimizer = _build_optimizer(config.optimizer)
        if optimizer is not None and not isinstance(optimizer, FusedAdam):
            raise not_ported(f"client optimizers ({type(optimizer).__name__})")
        self.optimizer = optimizer
        self.base_lr = optimizer.lr if optimizer is not None else 0.0
        self.opt_state = optimizer.init(self._base_leaves) if optimizer is not None else None

        # --- f32 gradient accumulators and the loss scale
        self.grad_acc = [torch.zeros(p.shape, dtype=torch.float32, device=self.device)
                         for p in self._param_leaves]
        self.scale_state = self.loss_scaler.init(self.device)

        # --- lr scheduler
        if lr_scheduler is None and config.scheduler is not None:
            lr_scheduler = create_lr_scheduler(config.scheduler, self.base_lr)
        self.lr_scheduler = lr_scheduler

        # --- counters / bookkeeping
        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_micro_batch_size_per_gpu = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        self._last_metrics: Optional[StepMetrics] = None
        self._pending_loss = None  # the last forward's loss, with its graph

        self.timers = EngineTimers(enable=config.wall_clock_breakdown)
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size,
                                          steps_per_output=config.steps_per_print)
        log_dist(
            f"TpuEngine ready: zero_stage={self.zero_stage} dtype={self.model_dtype} "
            f"device={self.device} micro_bs={self.train_micro_batch_size_per_gpu} "
            f"gas={self.gradient_accumulation_steps}",
            ranks=[0],
        )

    def _to_device(self, batch):
        if not isinstance(batch, dict):
            raise TypeError(f"a batch is a dict of arrays (input_ids, labels, loss_mask), "
                            f"got {type(batch).__name__}")

        def put(x):
            t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            dtype = torch.long if not t.is_floating_point() else None
            return t.to(self.device, dtype)

        return {k: put(v) for k, v in batch.items()}

    # ------------------------------------------------------------------
    # train loop surface (forward / backward / step)
    # ------------------------------------------------------------------
    def forward(self, batch, rng=None):
        """The micro-batch's loss (f32, detached); its graph stays with the
        engine for :meth:`backward`. ``rng`` is the reference's dropout key:
        dropout is not ported, so it is accepted and unused."""
        self.timers(EngineTimers.FORWARD).start()
        self.tput_timer.start()
        loss = self.model.loss(self.params, self._to_device(batch)).float()
        self._pending_loss = loss
        self.timers(EngineTimers.FORWARD).stop()
        return loss.detach()

    __call__ = forward

    def eval_batch(self, batch, rng=None):
        with torch.no_grad():
            return self.model.loss(self.params, self._to_device(batch)).float()

    def backward(self, loss=None):
        """Gradient of the last forward's ``loss * scale``, accumulated into
        the f32 buffers as ``g.float() / predivide`` (the parameters'
        ``.grad`` is freed); advances the micro-step counter."""
        if self._pending_loss is None:
            raise RuntimeError("backward() needs a forward() first")
        self.timers(EngineTimers.BACKWARD).start()
        pending, self._pending_loss = self._pending_loss, None
        (pending * self.scale_state.scale).backward()
        with torch.no_grad():
            for acc, p in zip(self.grad_acc, self._param_leaves):
                if p.grad is not None:
                    acc.add_(p.grad if self.predivide == 1.0
                             else p.grad.float() / self.predivide)
                    p.grad = None
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu
        self.timers(EngineTimers.BACKWARD).stop()
        return loss if loss is not None else pending.detach()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps == 0

    def step(self):
        if not self.is_gradient_accumulation_boundary():
            self.tput_timer.stop(global_step=False)
            return
        if self.optimizer is None:
            raise RuntimeError("step() requires an optimizer (config or client-provided)")
        self.timers(EngineTimers.STEP).start()
        metrics = self._apply(self.get_lr_value())
        self._last_metrics = metrics
        self.global_steps += 1
        if self.fp16_enabled and bool(metrics.overflow):
            # dynamic scaling reads the overflow flag (a host sync, as the
            # reference's)
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps} overflow: skipping, loss scale -> "
                     f"{float(self.scale_state.scale)}", ranks=[0])
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self.timers(EngineTimers.STEP).stop()
        self.tput_timer.stop(global_step=True)
        if self.config.steps_per_print and self.global_steps % self.config.steps_per_print == 0:
            self.timers.log(normalizer=self.gradient_accumulation_steps)

    @torch.no_grad()
    def _apply(self, lr: float) -> StepMetrics:
        """The reference's ``apply_fn``, in place on the engine's buffers."""
        cfg = self.config
        grads = self.grad_acc
        scale = self.scale_state.scale
        torch._foreach_div_(grads, scale * (1 if cfg.prescale_gradients
                                            else self.gradient_accumulation_steps))
        if self.fp16_enabled:
            overflow = ~torch.stack([torch.isfinite(g).all() for g in grads]).all()
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if cfg.gradient_clipping > 0.0:
            torch._foreach_mul_(grads, torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0))
        # fp16 skips the step wholesale on overflow (optimizer state included)
        if not (self.fp16_enabled and bool(overflow)):
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                            self._base_leaves, lr)
            torch._foreach_add_(self._base_leaves, updates)
            if self.mixed_precision:
                torch._foreach_copy_(self._param_leaves, self._base_leaves)
        self.scale_state = self.loss_scaler.update(self.scale_state, overflow)
        torch._foreach_zero_(grads)
        return StepMetrics(grad_norm=gnorm, overflow=overflow, loss_scale=scale)

    def train_batch(self, data_iter):
        """Full accumulation cycle over ``data_iter``; the mean of its
        micro-batch losses."""
        losses = []
        for _ in range(self.gradient_accumulation_steps):
            loss = self.forward(next(data_iter))
            self.backward(loss)
            self.step()
            losses.append(loss)
        return torch.stack(losses).mean()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def get_lr_value(self) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.get_lr())
        return float(self.base_lr)

    def get_lr(self):
        return [self.get_lr_value()]

    @property
    def loss_scale(self) -> float:
        return float(self.scale_state.scale)

    def get_global_grad_norm(self) -> Optional[float]:
        if self._last_metrics is None:
            return None
        return float(self._last_metrics.grad_norm)

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def save_checkpoint(self, *args, **kwargs):
        raise not_ported("checkpoints (save_checkpoint)")

    def load_checkpoint(self, *args, **kwargs):
        raise not_ported("checkpoints (load_checkpoint)")
