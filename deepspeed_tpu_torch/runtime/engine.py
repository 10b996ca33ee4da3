"""Training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``
``TpuEngine``): one process per device, over a named mesh.

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

Under a process group (``comm.init_distributed``) the engine trains on the
mesh of its config's ``mesh`` block (or ``initialize(mesh=...)``), with ZeRO
stages 0-3 over ``fsdp`` and tensor parallelism over ``tensor``: the state
is this rank's blocks of the reference's placements, mapped onto this
package's layout (``runtime/zero/partitioned.py``). ``forward(batch)``
takes this rank's rows or the global batch (cut to this rank's block in
mesh order) and returns the global batch's loss. Without a process group
the same state is whole on the one device; so it is wherever nothing is
split (fsdp and tensor of 1).

Parameters come from a seeded ``torch.Generator`` or from ``params=``: the
reference's layout (its numpy tree, or the tensors that
``module_inject.load_checkpoint.convert_hf_checkpoint`` reads from an HF
directory, which is how a fine-tune starts) or this package's own. The
engine keeps f32 masters when the precision is bf16/fp16. It runs on CUDA
unless ``device="cpu"`` is passed; without CUDA and without that argument it
raises. It updates its buffers in place where the reference's programs
donate theirs.

Checkpoints (the reference's engine.py:1693-1929): ``save_checkpoint`` writes
the state tree (params, the loss scale, the gradient accumulators, the f32
masters and Adam's state) through ``checkpoint_engine/`` with a checksum
manifest and a commit marker; ``load_checkpoint`` walks the tags newest
first past torn ones. A tag holds each leaf whole, in this package's layout,
whatever the stage and mesh that wrote it: each leaf is assembled from the
ranks' blocks as it is written (rank 0 writes), and a load cuts each rank's
blocks from the leaf files, so a tag moves between stages and meshes as it
is. A load, a host snapshot's restore and the reference bridge
(:func:`state_from_reference_snapshot`) copy into the engine's own tensors,
which ``_param_leaves``, ``_base_leaves``, ``grad_acc`` and the moments
alias. A host snapshot is a copy of this rank's blocks (:class:`HostBlocks`)
with the whole leaves' manifest. The fault and health seams that
``runtime/resilience.py`` drives (engine.py:1109-1197, :1287-1321,
:1495-1557): ``fault_hook``, ``poisoned``, ``fetch_timeout_s``, the numeric
faults, ``step_health_scalars``, ``discard_accumulated_grads`` and
``sdc_probe``. ``deepspeed_io`` wraps a dataset in
``runtime/dataloader.TpuDataLoader``.

Outside this slice (each raises ``NotImplementedError`` naming ROADMAP.md):
offload, pipeline and hybrid engines, the engine's per-step telemetry,
progressive layer drop and random-LTD, optimizers other than Adam/AdamW and
client optimizers.
"""

import os
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch import faults as _faults
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity as ckpt_integrity
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import (
    AsyncTorchCheckpointEngine,
    CommitGroup,
    TorchCheckpointEngine,
    named_host_leaves,
    tree_items,
)
from deepspeed_tpu_torch.runtime.config import TpuConfig
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader, TpuDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import LossScaleState, create_loss_scaler
from deepspeed_tpu_torch.runtime.lr_schedules import create_lr_scheduler
from deepspeed_tpu_torch.runtime.numerics import crc_digest
from deepspeed_tpu_torch.runtime.zero.partitioned import PartitionedState
from deepspeed_tpu_torch.telemetry.telemetry import Telemetry
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import EngineTimers, ThroughputTimer


class StepMetrics(NamedTuple):
    grad_norm: torch.Tensor
    overflow: torch.Tensor
    loss_scale: torch.Tensor


class OptStateTree(NamedTuple):
    """Adam's state as it stands in the checkpoint tree: the reference's
    ``AdamState`` fields, the moments shaped as the param tree."""

    step: torch.Tensor  # i32 scalar
    exp_avg: Any
    exp_avg_sq: Any


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


def _leaf_names(tree, prefix=""):
    """Dotted paths of a param tree's leaves, in :func:`_leaves` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _host_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _Ref:
    """A param-shaped leaf of the engine's state tree: leaf ``path`` of this
    package's tree, of the units of ``what`` (``"param"``, ``"base"`` or
    ``"grad"``), read from the engine's own tensors of ``name`` (``what``
    itself, or Adam's ``"exp_avg"``/``"exp_avg_sq"``, which follow
    ``base``). It is assembled from the ranks' blocks when it is read."""

    __slots__ = ("path", "what", "name")

    def __init__(self, path, what, name):
        self.path, self.what, self.name = path, what, name


@dataclass
class HostBlocks:
    """A host snapshot: copies of this rank's units of each
    component (``units``: ``"param"``, ``"grad"``, ``"base"`` where there
    are masters, ``"exp_avg"``/``"exp_avg_sq"``), the scalar leaves by tree
    key, and the (mesh, stage, rank) they were taken on."""

    units: dict
    scalars: dict
    layout: tuple


class _Leaves:
    """Leaves by tree key, each read from its file when asked for (a tag's
    ``read``) and let go after use: a load maps one leaf at a time."""

    def __init__(self, read, keys):
        self._read, self._keys = read, set(keys)

    def __contains__(self, key):
        return key in self._keys

    def __getitem__(self, key):
        return self._read(key)


class TpuEngine:
    def __init__(self, model, config: TpuConfig, params=None, optimizer=None, lr_scheduler=None,
                 device=None, seed: Optional[int] = None, training_data=None, collate_fn=None):
        self.config = config
        self.device = get_accelerator().resolve_device(device)
        self.mesh = self._engine_mesh()
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
        # the full f32 params: on the device for one rank; for more, on the
        # host, where each rank cuts its blocks leaf by leaf (the device
        # holds only those)
        staging = (self.device if self.mesh is None or self.mesh.size == 1
                   else torch.device("cpu"))
        if params is None:
            master = model.init(torch.Generator(device=self.device).manual_seed(int(seed)),
                                place=lambda t: t.to(staging))
        else:
            if tf.is_reference_tree(params):
                params = tf.params_from_numpy(params, model.cfg, staging)
            # copies: the caller's tree is never updated
            master = tf.map_params(lambda p: p.detach().to(staging, torch.float32, copy=True),
                                   params)
        zc = config.zero_config
        self._state = PartitionedState(
            model.cfg, self.mesh or comm.build_mesh(device=self.device), self.zero_stage, master,
            self.model_dtype, zc.param_persistence_threshold, zc.reduce_bucket_size, self.device)
        del master
        # the trees of the forward's params and of the f32 masters (None
        # where the state is held in blocks), and the flat lists the
        # optimizer's foreach ops take
        self.params = self._state.tree
        self.master_params = self._state.master_tree
        self._param_leaves = _leaves(self.params) if self.params is not None else []
        self._leaf_names = _leaf_names(self.params) if self.params is not None else []
        self._base_leaves = self._state.base  # what the optimizer updates (f32)
        # the engine's own random stream, for the draws a step will make
        # (dropout is not ported yet: no step draws from it so far)
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(seed))

        # --- optimizer
        if optimizer is None and config.optimizer is not None:
            optimizer = _build_optimizer(config.optimizer)
        if optimizer is not None and not isinstance(optimizer, FusedAdam):
            raise not_ported(f"client optimizers ({type(optimizer).__name__})")
        self.optimizer = optimizer
        self.base_lr = optimizer.lr if optimizer is not None else 0.0
        self.opt_state = optimizer.init(self._base_leaves) if optimizer is not None else None

        # --- f32 gradient accumulators and the loss scale
        self.grad_acc = self._state.grad_acc
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

        # --- dataloader
        self.training_dataloader = None
        self._train_iter = None  # train_batch()'s own pass over it
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn)

        # --- checkpoint engine (config checkpoint.async_save selects the
        # non-blocking engine)
        ckpt = config.checkpoint
        engine_cls = (AsyncTorchCheckpointEngine if ckpt.get("async_save", False)
                      else TorchCheckpointEngine)
        self.checkpoint_engine = engine_cls(use_ocdbt=ckpt.get("use_ocdbt", False))
        if comm.process_world()[1] > 1:  # the ranks save each tag together
            self.checkpoint_engine.world = CommitGroup()

        # --- telemetry hub: off; the TrainSupervisor adopts it and re-injects
        # it into every rebuilt engine (the engine's own per-step events are
        # ROADMAP Queue 1 item 11 (b))
        self.telemetry = Telemetry(role="train")

        # --- fault surface: the TrainSupervisor installs an injector as
        # fault_hook and arms the step-fetch watchdog; both stay inert for
        # plain training. poisoned flips when a failure lands PAST a
        # mutation barrier (grad_acc or params already written): the
        # supervisor must rebuild from the last committed snapshot.
        self.fault_hook = None          # callable(point, info) or None
        self.fetch_timeout_s = None     # step-fetch watchdog seconds; None = off
        self.poisoned = False
        self._pending_bitflip = None    # fired numeric-fault record or None
        self._force_nan_loss = False    # nan_loss on a batch of token ids only

        self.timers = EngineTimers(enable=config.wall_clock_breakdown)
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size,
                                          steps_per_output=config.steps_per_print)
        log_dist(
            f"TpuEngine ready: zero_stage={self.zero_stage} dtype={self.model_dtype} "
            f"device={self.device} micro_bs={self.train_micro_batch_size_per_gpu} "
            f"gas={self.gradient_accumulation_steps} "
            f"mesh={self.mesh.shape if self.mesh is not None else None}",
            ranks=[0],
        )

    def _engine_mesh(self):
        """The comm mesh this engine trains on, shaped by the config's
        ``mesh`` block, or None without a process group (one device, the
        state whole)."""
        shape = self.config.mesh_axis_sizes()
        if not comm.has_process_group():
            return None
        current = comm.get_mesh()
        if current.shape != shape or current.device != comm.comm.canonical_device(self.device):
            comm.init_distributed(mesh_shape=shape, device=self.device, verbose=False)
        return comm.get_mesh()

    def gathered_params(self):
        """The full model-dtype params in this package's layout, every
        rank's blocks gathered, in tensors of their own."""
        return self._state.gathered_params()

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
    # data plumbing
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None, num_local_io_workers=None,
                     route=None):
        """A :class:`TpuDataLoader` over ``dataset``: global batches (the
        micro-batch times the mesh's data-parallel width, which ``forward``
        cuts to this rank's block), shuffled by the config's seed."""
        rows = self.train_micro_batch_size_per_gpu * self.config.dp_world_size()
        return TpuDataLoader(dataset, batch_size=batch_size or rows,
                             collate_fn=collate_fn, seed=self.config.seed)

    # ------------------------------------------------------------------
    # train loop surface (forward / backward / step)
    # ------------------------------------------------------------------
    def forward(self, batch, rng=None):
        """The micro-batch's loss (f32, detached); its graph stays with the
        engine for :meth:`backward`. ``rng`` is the reference's dropout key:
        dropout is not ported, so it is accepted and unused."""
        if self.fault_hook is not None:
            # fires BEFORE anything mutates: an injected micro_dispatch
            # fault leaves the engine exactly as it was, so the
            # supervisor's retry of the same batch is bitwise the
            # micro-step that would have run. Numeric kinds come back as a
            # directive record instead of raising: the values get
            # corrupted and the step keeps running (the sentinel's problem)
            directive = self.fault_hook("micro_dispatch", {"step": self.global_steps + 1,
                                                           "micro": self.micro_steps})
            if directive is not None:
                batch = self._apply_numeric_fault(directive, batch)
        try:
            loss = self._forward_body(batch)
        except BaseException:
            # past the dispatch barrier: poison so recovery rebuilds, never retries
            self.poisoned = True
            raise
        if self._force_nan_loss:
            # nan_loss on a batch with no float leaves (token ids): the
            # reported loss is corrupted instead of the data
            self._force_nan_loss = False
            loss = torch.full_like(loss, float("nan"))
        return loss

    def _forward_body(self, batch):
        self.timers(EngineTimers.FORWARD).start()
        self.tput_timer.start()
        local = self._state.local_batch(self._to_device(batch), self.train_micro_batch_size_per_gpu)
        self._pending_loss = self._state.loss(local).float()
        out = self._state.global_loss(self._pending_loss)
        self.timers(EngineTimers.FORWARD).stop()
        return out

    __call__ = forward

    def _apply_numeric_fault(self, record: dict, batch):
        """Apply a numeric-fault directive the injector handed back
        (``faults.TRAIN_NUMERIC_KINDS``). ``data_poison`` / ``nan_loss``
        corrupt the batch on the host; ``grad_bitflip`` waits for the
        accumulation boundary (:meth:`step`), where the accumulators hold
        the whole step's gradient."""
        kind = record.get("kind")
        if kind == "data_poison":
            factor = float(record.get("factor") or 0.0) or _faults.DEFAULT_POISON_FACTOR
            return {k: _faults.poison_array(_host_numpy(v), factor) for k, v in batch.items()}
        if kind == "nan_loss":
            host = {k: _host_numpy(v) for k, v in batch.items()}
            if any(np.issubdtype(a.dtype, np.floating) for a in host.values()):
                return {k: _faults.nan_poison_array(a) for k, a in host.items()}
            self._force_nan_loss = True
            return batch
        if kind == "grad_bitflip":
            self._pending_bitflip = record
        return batch

    @torch.no_grad()
    def _apply_grad_bitflip(self, record: dict):
        """Flip one bit of one accumulated-gradient element (an injected
        SDC). The (leaf, element, bit) target resolves deterministically
        from the plan record (``faults.plan_bitflip``) over the param
        tree's dotted leaf paths and whole leaves, and the record is
        annotated with the resolved target for the injector's fired log;
        on a split engine every rank that holds the element flips it. One
        element's host round trip: fault path only."""
        state = self._state
        step = int(record.get("step", self.global_steps + 1))
        sizes = {".".join(map(str, path)): int(np.prod(shape, dtype=np.int64))
                 for path, shape in state.leaf_shapes.items()}
        name, elem, bit = _faults.plan_bitflip(step, sizes, str(record.get("leaf", "") or ""),
                                               int(record.get("bit", -1)))
        path = state.path_of(name)
        at = np.unravel_index(elem, state.leaf_shapes[path])
        for index, block in state.fragments(path, "grad"):
            if all(sl.start <= i < sl.stop for sl, i in zip(index, at)):
                local = tuple(int(i - sl.start) for sl, i in zip(index, at))
                value = _host_numpy(block[local]).reshape(1)
                block[local] = torch.from_numpy(_faults.flip_float_bit(value, 0, bit))[0]
        record["leaf"], record["bit"] = name, bit
        record.setdefault("elem", elem)

    def eval_batch(self, batch, rng=None):
        with torch.no_grad():
            local = self._state.local_batch(self._to_device(batch),
                                            self.train_micro_batch_size_per_gpu)
            return self._state.global_loss(self._state.loss(local).float())

    def backward(self, loss=None):
        """Gradient of the last forward's ``loss * scale``, accumulated into
        the f32 buffers as ``g.float() / predivide`` (the parameters'
        ``.grad`` is freed); advances the micro-step counter."""
        if self._pending_loss is None:
            raise RuntimeError("backward() needs a forward() first")
        self.timers(EngineTimers.BACKWARD).start()
        pending, self._pending_loss = self._pending_loss, None
        try:
            (pending * self.scale_state.scale).backward()
            self._state.accumulate(self.predivide)
        except BaseException:
            # the accumulators may hold part of this micro-step
            self.poisoned = True
            raise
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu * self.config.dp_world_size()
        self.timers(EngineTimers.BACKWARD).stop()
        return loss if loss is not None else pending.detach()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps == 0

    def step(self):
        if not self.is_gradient_accumulation_boundary():
            self.tput_timer.stop(global_step=False)
            return
        if self._pending_bitflip is not None:
            # the deferred grad_bitflip lands now, after every micro-step
            # accumulated and before the update reads the accumulators
            record, self._pending_bitflip = self._pending_bitflip, None
            self._apply_grad_bitflip(record)
        try:
            self._step_body()
        except BaseException:
            # the update writes params, masters, moments and accumulators
            # in place: any failure inside the step body (a hung or
            # injected step_fetch included) leaves them unaccounted for
            self.poisoned = True
            raise

    def _guarded_fetch(self, metrics: StepMetrics):
        """The step metrics' host fetch, under the ``step_fetch`` fault hook
        and the post-hoc ``fetch_timeout_s`` watchdog (time the blocking
        fetch, raise TimeoutError when it overran: the step's host view is
        then untrustworthy and :meth:`step` poisons the engine)."""
        if self.fault_hook is not None:
            self.fault_hook("step_fetch", {"step": self.global_steps + 1})
        if self.fetch_timeout_s is None:
            return
        t0 = time.perf_counter()
        metrics.grad_norm.item()
        dt = time.perf_counter() - t0
        if dt > self.fetch_timeout_s:
            raise TimeoutError(
                f"step {self.global_steps + 1} metrics fetch took {dt:.3f}s "
                f"> fetch_timeout_s={self.fetch_timeout_s}")

    def _step_body(self):
        if self.optimizer is None:
            raise RuntimeError("step() requires an optimizer (config or client-provided)")
        self.timers(EngineTimers.STEP).start()
        metrics = self._apply(self.get_lr_value())
        self._last_metrics = metrics
        self._guarded_fetch(metrics)
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
        """The reference's ``apply_fn``, in place on this rank's buffers: the
        accumulators summed over the data-parallel ranks and divided by
        ``scale * gas * dp``, the overflow flag and the norm over every
        block, Adam on this rank's optimizer blocks, the params written
        back (gathered where their placement is wider)."""
        cfg, state = self.config, self._state
        grads = state.reduce_grads()
        scale = self.scale_state.scale
        denom = scale * (1 if cfg.prescale_gradients else self.gradient_accumulation_steps)
        if state.dp > 1:
            denom = denom * state.dp
        torch._foreach_div_(grads, denom)
        overflow, gnorm = state.overflow_and_norm(grads, with_overflow=self.fp16_enabled)
        if cfg.gradient_clipping > 0.0:
            torch._foreach_mul_(grads, torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0))
        # fp16 skips the step wholesale on overflow (optimizer state included)
        if not (self.fp16_enabled and bool(overflow)):
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                            self._base_leaves, lr)
            torch._foreach_add_(self._base_leaves, updates)
            state.write_back()
        self.scale_state = self.loss_scaler.update(self.scale_state, overflow)
        state.zero_grads()
        return StepMetrics(grad_norm=gnorm, overflow=overflow, loss_scale=scale)

    def train_batch(self, data_iter=None):
        """Full accumulation cycle over ``data_iter`` (by default the
        engine's ``training_dataloader``, read on from where the last call
        left it, epoch after epoch); the mean of its micro-batch losses."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch() needs data_iter= or initialize(training_data=...)")
            if self._train_iter is None:
                self._train_iter = RepeatingLoader(self.training_dataloader)
            data_iter = self._train_iter
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

    # ------------------------------------------------------------------
    # numerical health: the three engine seams the NumericSentinel /
    # TrainSupervisor pair drives
    # ------------------------------------------------------------------
    def step_health_scalars(self) -> Optional[dict]:
        """The per-step host scalars the sentinel consumes, from the last
        step's metrics."""
        m = self._last_metrics
        if m is None:
            return None
        return {"grad_norm": float(m.grad_norm), "overflow": bool(m.overflow),
                "loss_scale": float(m.loss_scale)}

    @torch.no_grad()
    def discard_accumulated_grads(self):
        """Zero the accumulated gradients WITHOUT applying them — the
        supervisor's quarantine rung. Params, optimizer state, loss scale
        and step counters are untouched, so the next step proceeds exactly
        as if the flagged batch had been excluded from the stream."""
        self._pending_bitflip = None
        self._force_nan_loss = False
        self._pending_loss = None
        torch._foreach_zero_(self.grad_acc)

    def sdc_probe(self, batch, rng_seed: int = 0) -> int:
        """One sentinel micro-step, out of band: the loss of ``batch`` and
        its gradient, accumulated as :meth:`backward` adds it (each rank's
        share, summed over the data-parallel ranks as the step sums it),
        then a CRC-32 of the whole logical gradient, leaf by leaf in the
        tree's order; ``grad_acc`` is put back as it was, and the counters
        and the engine's generator are untouched. Every rank calls this and
        gets the same digest. Two probes of one batch give the same digest
        where a step is a deterministic function of its inputs.
        ``rng_seed`` is the reference's dropout key: nothing draws from it
        yet."""
        state = self._state
        held = [g.clone() for g in state.grad_acc]
        torch._foreach_zero_(state.grad_acc)
        try:
            local = state.local_batch(self._to_device(batch), self.train_micro_batch_size_per_gpu)
            (state.loss(local).float() * self.scale_state.scale).backward()
            state.accumulate(self.predivide)
            return crc_digest(state.full_leaf(path, "grad").cpu().numpy()
                              for path in state.leaf_paths)
        finally:
            with torch.no_grad():
                torch._foreach_copy_(state.grad_acc, held)

    # ------------------------------------------------------------------
    # checkpointing (reference: engine.py:1693-1929)
    # ------------------------------------------------------------------
    def _state_tree(self):
        """The checkpoint state tree: a :class:`_Ref` at each param-shaped
        leaf (read with :meth:`_host_leaves`, written with ``set_leaf``),
        the loss scale and Adam's step as tensors."""
        state = self._state

        def refs(what, name):
            return state.leaf_tree(lambda path: _Ref(path, what, name))

        tree = {"params": refs("param", "param"), "scale_state": self.scale_state,
                "grad_acc": refs("grad", "grad")}
        if self.mixed_precision:
            tree["master_params"] = refs("base", "base")
        if self.opt_state is not None:
            tree["opt_state"] = OptStateTree(
                step=torch.tensor(self.opt_state.step, dtype=torch.int32, device=self.device),
                exp_avg=refs("base", "exp_avg"), exp_avg_sq=refs("base", "exp_avg_sq"))
        return tree

    def _units(self, name, blocks=None):
        """The unit list a :class:`_Ref` of ``name`` reads: a snapshot's
        copy, Adam's moments, or None (the component's own tensors)."""
        if blocks is not None:
            return blocks.units[name]
        if name in ("exp_avg", "exp_avg_sq"):
            return getattr(self.opt_state, name)
        return None

    def _host_leaves(self, blocks: Optional[HostBlocks] = None, keep: bool = True):
        """``(key, host tensor)`` for every leaf of the state tree, in its
        order, each assembled when it is reached (collectives on a split
        engine, which every rank must run: consume this to its end), from
        the snapshot ``blocks`` where given (which the leaves may alias),
        else into tensors of their own. ``keep=False`` assembles each leaf
        and yields none (a rank that does not write)."""
        for key, leaf in tree_items(self._state_tree()):
            if isinstance(leaf, _Ref):
                t = self._state.full_leaf(leaf.path, leaf.what, self._units(leaf.name, blocks))
            else:
                t = leaf if blocks is None else blocks.scalars[key]
            if keep:
                yield key, t.detach().to("cpu", copy=blocks is None)

    def _layout(self) -> tuple:
        mesh = tuple(sorted(self.mesh.shape.items())) if self.mesh is not None else None
        return mesh, self.zero_stage, comm.process_world()[0]

    def _block_units(self, with_moments: bool) -> dict:
        """This rank's units of each component a :class:`HostBlocks` holds,
        by name."""
        state = self._state
        units = {"param": state.param_units, "grad": state.grad_acc}
        if self.mixed_precision:
            units["base"] = state.base
        if with_moments:
            units.update(exp_avg=self.opt_state.exp_avg, exp_avg_sq=self.opt_state.exp_avg_sq)
        return units

    def _checkpoint_meta(self, client_state=None) -> dict:
        return {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": self.lr_scheduler.state_dict() if self.lr_scheduler else None,
            "client_state": client_state or {},
            "zero_stage": self.zero_stage,
            "dtype": str(self.model_dtype).removeprefix("torch."),
        }

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        state_tree=None, manifest=None):
        """Write tag ``global_step<N>`` under ``save_dir``; ``latest`` names
        it once it is durable. The state is copied to the host before this
        returns, async or not. ``state_tree``/``manifest`` let the
        TrainSupervisor commit an already-captured :meth:`host_state_snapshot`
        (its :class:`HostBlocks`) without a second copy; plain callers leave
        both None. With more than one rank every rank calls this: rank 0
        writes each leaf whole (assembled from the ranks' blocks, one leaf at
        a time), and the tag is committed once every rank agrees."""
        tag = tag if tag is not None else f"global_step{self.global_steps}"
        meta = self._checkpoint_meta(client_state)
        ckpt = self.checkpoint_engine
        leaves = self._host_leaves(state_tree, keep=ckpt.writes())
        if manifest is None and self.config.checkpoint.get("integrity_manifest", True):
            # built from the host copies as they are written (on the
            # writer's thread when async)
            manifest = ckpt_integrity.manifest_from_leaves
        pre_commit = None
        if self.fault_hook is not None:
            hook, step = self.fault_hook, self.global_steps

            def pre_commit():
                # the torn-write injection window: arrays/metadata/manifest
                # are durable, the commit marker is not yet placed
                hook("checkpoint_write", {"step": step, "tag": tag})

        def _write_latest():
            # runs at commit time ('latest' must only ever name durable
            # checkpoints; async saves defer this to their fence) and is
            # atomic: a reader sees the old pointer or the new
            os.makedirs(save_dir, exist_ok=True)
            tmp = os.path.join(save_dir, f".latest.tmp.{os.getpid()}")
            with open(tmp, "w") as fh:
                fh.write(tag)
            os.replace(tmp, os.path.join(save_dir, "latest"))

        ckpt.save_leaves(os.path.join(save_dir, tag), leaves, meta, manifest=manifest,
                         pre_commit=pre_commit,
                         on_commit=[_write_latest] if save_latest and ckpt.writes() else [])
        log_dist(f"saved checkpoint {save_dir}/{tag}", ranks=[0])
        return True

    def _ckpt_refused(self, tag, reason):
        logger.warning(f"refusing checkpoint tag {tag!r}: {reason}")
        if self.telemetry.enabled:
            self.telemetry.emit("train_fault", {"event": "ckpt_refused", "tag": str(tag),
                                                "reason": str(reason)})

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, verify_integrity=True):
        """Restore ``tag``, or else what ``latest`` names and then every
        ``global_step<N>`` tag newest first, refusing torn ones; raises
        ``TornCheckpointError`` when none is restorable. Returns
        ``(path, client_state)``, or ``(None, {})`` without ``latest``.
        Every rank reads the leaf files and cuts its own blocks; rank 0
        checks the checksums, and the ranks agree on each tag before any
        restores it."""
        explicit = tag is not None
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.exists(latest):
                logger.warning(f"no 'latest' file at {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as fh:
                tag = fh.read().strip()
        candidates = [tag]
        if not explicit:
            # resume from the newest restorable state, not just what
            # 'latest' names: scan every global_step tag newest-first (torn
            # ones are refused and the walk falls back), keeping the latest
            # pointer as the lead candidate when it names a foreign tag
            scanned = [t for _s, t, _c in ckpt_integrity.scan_tags(load_dir)]
            candidates = scanned if tag in scanned else [tag] + scanned
        ckpt = self.checkpoint_engine
        keys = [key for key, _ in tree_items(self._state_tree())]
        read = meta = None
        errors = []
        for cand in candidates:
            try:
                read, meta = ckpt.open(os.path.join(load_dir, cand), keys,
                                       verify_integrity=verify_integrity and ckpt.writes())
                problem = None
            except ckpt_integrity.TornCheckpointError as e:
                problem = str(e)
            if ckpt.world is not None and not ckpt.world.agree(problem is None):
                problem = problem or "another rank refused it"
            if problem is None:
                tag = cand
                break
            read = None
            self._ckpt_refused(cand, problem)
            errors.append(f"{cand}: {problem}")
        if read is None:
            raise ckpt_integrity.TornCheckpointError(
                f"no committed checkpoint restorable from {load_dir} "
                f"(refused: {'; '.join(errors) or 'none found'})")
        path = os.path.join(load_dir, tag)
        self._restore_state(_Leaves(read, keys), meta, load_optimizer_states,
                            load_lr_scheduler_states)
        log_dist(f"loaded checkpoint {path} at step {self.global_steps}", ranks=[0])
        return path, meta.get("client_state", {})

    @torch.no_grad()
    def _restore_state(self, src, meta, load_optimizer_states=True,
                       load_lr_scheduler_states=True):
        """Copy a restored state into the engine's own tensors (the aliases
        stay valid) and take its counters — shared by disk loads,
        host-snapshot restores and the reference bridge. ``src`` maps tree
        keys to whole leaves (leaves pair by key, whatever the order of the
        restored tree's dicts; each rank cuts its blocks from each), or is a
        :class:`HostBlocks` of this engine's own layout."""
        live = self._state_tree()
        groups = ["params", "grad_acc"] + (["master_params"] if "master_params" in live else [])
        load_opt = load_optimizer_states and self.opt_state is not None
        if load_opt:
            groups.append("opt_state")
        if isinstance(src, HostBlocks):
            for name, dst in self._block_units(load_opt).items():
                torch._foreach_copy_(dst, src.units[name])
            src = src.scalars
        else:
            absent = [key for g in groups for key, _ in tree_items(live[g], f"[{g!r}]")
                      if key not in src]
            if absent:
                raise ValueError(f"the restored state has no leaf {absent[0]!r} "
                                 f"({len(absent)} absent)")
            for g in groups:
                for key, dst in tree_items(live[g], f"[{g!r}]"):
                    if key != "['opt_state'].step":  # a count, not a buffer
                        self._state.set_leaf(dst.path, dst.what, src[key], self._units(dst.name))
        if load_opt:
            self.opt_state.step = int(src["['opt_state'].step"])
        self.scale_state = LossScaleState(*(
            src[f"['scale_state'].{f}"].to(self.device, copy=True) for f in LossScaleState._fields))
        for p in self._state.param_units:
            p.grad = None
        self._pending_loss = None
        self._pending_bitflip = None
        self._force_nan_loss = False
        self.global_steps = meta.get("global_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        if load_lr_scheduler_states and self.lr_scheduler is not None and meta.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        self.poisoned = False

    # ---- host snapshots (TrainSupervisor double buffer) -------------------

    def rng_state(self) -> np.ndarray:
        """Host copy of the engine's generator state (raw bytes)."""
        return self._rng.get_state().numpy().copy()

    def set_rng_state(self, key):
        self._rng.set_state(torch.from_numpy(np.asarray(key).astype(np.uint8)))

    def host_state_snapshot(self, client_state=None):
        """One atomic unit of training state on the host: ``(blocks, meta,
        manifest)``, a :class:`HostBlocks` copy of this rank's blocks (the
        whole state where nothing is split; never more than this rank's
        share), the checkpoint metadata and the per-leaf checksum manifest
        of the whole leaves (assembled one at a time: every rank calls
        this). Captured at a step boundary it is everything a bitwise resume
        needs."""
        meta = self._checkpoint_meta(client_state)
        scalars = {key: leaf.detach().to("cpu", copy=True)
                   for key, leaf in tree_items(self._state_tree()) if not isinstance(leaf, _Ref)}
        units = self._block_units(self.opt_state is not None)
        blocks = HostBlocks({name: [t.detach().to("cpu", copy=True) for t in ts]
                             for name, ts in units.items()}, scalars, self._layout())
        return blocks, meta, ckpt_integrity.manifest_from_leaves(self._host_leaves(blocks))

    def restore_from_host_state(self, host_tree, meta, verify_integrity=None):
        """Copy a :meth:`host_state_snapshot` (onto the layout it was taken
        on) or a whole state tree (:func:`state_from_reference_snapshot`'s,
        of which each rank cuts its blocks) back into this engine's tensors;
        ``verify_integrity`` is the manifest to hold it to."""
        if isinstance(host_tree, HostBlocks):
            if host_tree.layout != self._layout():
                raise ValueError(f"a snapshot of this rank's blocks on {host_tree.layout} does "
                                 f"not restore onto {self._layout()}")
            leaves = self._host_leaves(host_tree)
        else:
            leaves = named_host_leaves(host_tree)
            host_tree = dict(tree_items(host_tree))
        if verify_integrity is not None:
            problems = ckpt_integrity.verify_leaves(leaves, verify_integrity)
            if problems:
                raise ckpt_integrity.TornCheckpointError(
                    f"host snapshot failed integrity verification "
                    f"({len(problems)} leaf mismatch(es)): " + "; ".join(problems[:3]))
        self._restore_state(host_tree, meta)


def _reference_tensor(a) -> torch.Tensor:
    """A host tensor of a reference numpy leaf (an ``ml_dtypes`` bf16 array
    through its raw 16-bit words: torch cannot read that dtype)."""
    a = np.array(a)  # a writable C-contiguous copy, 0-d kept 0-d
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_from_reference_snapshot(host_tree, meta, cfg: tf.TransformerConfig, device=None):
    """The reference engine's ``host_state_snapshot()`` tree (numpy leaves)
    and meta as this package's state tree, for
    :meth:`TpuEngine.restore_from_host_state`. Params, masters, the
    accumulators and Adam's moments go through ``params_from_numpy``'s
    layout rules (the moments are elementwise, so they take their param's
    transform); the step, the loss scale, the counters and the lr
    scheduler's state carry over as they are."""

    def tree(t):
        return tf.params_from_numpy(tf.map_params(_reference_tensor, t), cfg, device)

    def scalar(x):
        return _reference_tensor(x).to(device)

    ss = host_tree["scale_state"]
    out = {"params": tree(host_tree["params"]), "grad_acc": tree(host_tree["grad_acc"]),
           "scale_state": LossScaleState(*(scalar(getattr(ss, f)) for f in LossScaleState._fields))}
    if "master_params" in host_tree:
        out["master_params"] = tree(host_tree["master_params"])
    if "opt_state" in host_tree:
        opt = host_tree["opt_state"]
        out["opt_state"] = OptStateTree(step=scalar(opt.step), exp_avg=tree(opt.exp_avg),
                                        exp_avg_sq=tree(opt.exp_avg_sq))
    return out, dict(meta)
