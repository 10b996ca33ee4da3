"""Worlds of gloo ranks on the CPU for the port's distributed tests.

``run_world(program, world, tmp_path, mesh, *args)`` spawns ``world``
processes (``torch.multiprocessing``, the spawn start method), each of
which scrubs the launcher variables that other tests of the suite leave in
``os.environ`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_*``,
``DSTPU_*``), starts its process group through the port's
``comm.init_distributed`` on a ``file://`` store under ``tmp_path`` (no
port to collide between xdist workers), runs ``PROGRAMS[program]`` and
pickles what it returns. The parent gets the ranks' results in rank order.

The children import neither JAX nor the reference: each program lives here,
in a module that imports neither, and every result says whether the rank
found either in ``sys.modules``. The parent computes the reference.

``serving_program`` is the serving mesh's: rank 0 runs the cases and the
other ranks serve as ``inference.mesh.serve_worker``s.
"""

import datetime
import os
import pickle
import sys

import numpy as np
import torch

_SCRUB = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK")


def _scrub_env():
    for key in list(os.environ):
        if key in _SCRUB or key.startswith(("MASTER_", "DSTPU_")):
            del os.environ[key]


def _child(rank, world, store, out_dir, mesh, program, args):
    _scrub_env()
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    comm.init_distributed(mesh_shape=mesh, device="cpu", init_method=f"file://{store}", rank=rank,
                          world_size=world, timeout=datetime.timedelta(seconds=120), verbose=False)
    try:
        result = PROGRAMS[program](rank, *args)
        comm.barrier()
    finally:
        comm.destroy()
    result["foreign_modules"] = sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def run_world(program: str, world: int, tmp_path, mesh: dict, *args):
    """The results of ``PROGRAMS[program](rank, *args)`` on each rank of a
    ``world``-rank gloo world over ``mesh``."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    mp.start_processes(_child, args=(world, os.path.join(out_dir, "store"), out_dir, mesh,
                                     program, args),
                       nprocs=world, join=True, start_method="spawn")
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def rank_input(rank: int, shape=(4, 8)):
    """A rank's tensor for the collective checks: small integers in f32, so
    that every sum is exact."""
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float32).reshape(shape) % 7 + 1) * (rank + 1)


def comm_program(rank):
    """Every collective of the facade over each group handle, on this
    rank's ``rank_input``; the mesh's coordinates; the comms log."""
    from deepspeed_tpu_torch import comm

    mesh = comm.get_mesh()
    logger = comm.ensure_comms_logger()
    x = torch.from_numpy(rank_input(rank))
    out = {"coords": mesh.coords, "device_mesh": tuple(int(c) for c in
                                                       mesh.device_mesh.get_coordinate())}
    for group in (None, "tensor", "data", ("data", "tensor")):
        n = comm.get_world_size(group)
        r = {"rank": comm.get_rank(group), "size": n}
        for op in ("sum", "avg", "max", "min", "prod"):
            r[f"all_reduce_{op}"] = comm.all_reduce(x, op, group)
        r["all_gather_0"] = comm.all_gather(x, group, axis=0)
        r["all_gather_1"] = comm.all_gather(x, group, axis=1)
        r["all_gather_stacked"] = comm.all_gather(x, group, axis=1, tiled=False)
        r["reduce_scatter_0"] = comm.reduce_scatter(x, group, scatter_dimension=0)
        r["reduce_scatter_1"] = comm.reduce_scatter(x, group, scatter_dimension=1)
        y = torch.from_numpy(rank_input(rank, (n, 3)))
        r["reduce_scatter_untiled"] = comm.reduce_scatter(y, group, scatter_dimension=0,
                                                          tiled=False)
        if isinstance(group, str):  # all_to_all runs over one axis
            r["all_to_all"] = comm.all_to_all(x, group, split_axis=0, concat_axis=1)
        r["broadcast"] = comm.broadcast(x, src=n - 1, group=group)
        out[str(group)] = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in r.items()}
    try:
        comm.ppermute(x, [(0, 1), (1, 0)], "tensor")
        out["ppermute"] = "ran"
    except NotImplementedError as e:
        out["ppermute"] = str(e)
    from deepspeed_tpu_torch.utils import groups

    groups._clear()
    out["groups"] = {
        "expert": groups.initialize(ep_size=1),
        "expert_data": groups._get_expert_data_parallel_group(),
        "data": groups._get_data_parallel_group(), "model": groups._get_model_parallel_group(),
        "sequence": groups._get_sequence_parallel_group(),
        "sizes": (groups._get_data_parallel_world_size(), groups._get_model_parallel_world_size(),
                  groups._get_sequence_parallel_world_size(),
                  groups._get_expert_parallel_world_size(),
                  groups._get_expert_data_parallel_world_size()),
        "ranks": (groups._get_data_parallel_rank(), groups._get_model_parallel_rank(),
                  groups._get_expert_parallel_rank())}
    try:
        groups.initialize(ep_size=2)
        out["groups"]["ep2"] = "ran"
    except ValueError as e:
        out["groups"]["ep2"] = str(e)
    out["comms"] = logger.summary()
    out["input_unchanged"] = bool(torch.equal(x, torch.from_numpy(rank_input(rank))))
    return out


def engine_program(rank, cases):
    """Each case's engine through ``deepspeed_tpu_torch.initialize``: its
    shard shapes (``"shapes"``), or its loss stream over the case's global
    batches (fed whole, or as this rank's rows with ``"local_feed"``), the
    last global norm and the gathered final params in the reference's
    layout."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import transformer as ttf

    out = {}
    for name, case in cases.items():
        model = ttf.TransformerModel(ttf.TransformerConfig(**case["cfg"]))
        engine = dst.initialize(model=model, params=case.get("params"), config=case["config"],
                                device="cpu")[0]
        if case.get("shapes"):
            what = ("params", "grad_acc", "opt") + (("master",) if engine.mixed_precision else ())
            out[name] = {w: engine._state.shard_shapes(w) for w in what}
            out[name]["surfaces"] = _one_tree_surfaces(engine, os.path.join(case["ckpt_dir"], name))
            continue
        micro = engine.train_micro_batch_size_per_gpu
        dp_rank = comm.get_rank(comm.batch_axes())
        losses, held = [], None
        for batch in case["batches"]:
            if case.get("local_feed"):
                batch = {k: v[dp_rank * micro:(dp_rank + 1) * micro] for k, v in batch.items()}
            loss = engine.forward(batch)
            hooks = engine._state._hooks
            if hooks is not None:  # stage 3: the gathered weights died with their layer
                live = sum(ref() is not None for ref, *_ in hooks.live)
                held = live if held is None else max(held, live)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
        out[name] = {"losses": losses, "gnorm": engine.get_global_grad_norm(),
                     "gathered_alive_after_forward": held,
                     "final": ttf.params_to_numpy(engine.gathered_params(), model.cfg),
                     "mesh": dict(engine.mesh.shape)}
    return out


def _one_tree_surfaces(engine, ckpt_dir):
    """What the surfaces that read the state as one tree say: "ran", or
    their refusal (a save under ``ckpt_dir`` that rank 0 writes, its load
    on every rank, a host snapshot restored, a probe)."""
    snap = []
    rows = engine.train_micro_batch_size_per_gpu
    calls = {"save_checkpoint": lambda: engine.save_checkpoint(ckpt_dir, tag="t"),
             "load_checkpoint": lambda: engine.load_checkpoint(ckpt_dir, tag="t"),
             "host_state_snapshot": lambda: snap.append(engine.host_state_snapshot()),
             "restore_from_host_state": lambda: engine.restore_from_host_state(
                 *(snap[0][:2] if snap else ({}, {}))),
             "sdc_probe": lambda: engine.sdc_probe({"input_ids": np.zeros((rows, 4), np.int64)})}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = str(e)
    return out


# ---------------------------------------------------------------------------
# ZeRO-sharded checkpoints: each op on every rank, in one order
# ---------------------------------------------------------------------------

def _zc_engine(op, seed=None, config=None):
    """The op's engine: from its params, or (``seed``) from a seeded init,
    so that only a load can make it equal another."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import transformer as ttf

    model = ttf.TransformerModel(ttf.TransformerConfig(**op["cfg"]))
    params = op.get("params") if seed is None else None
    return dst.initialize(model=model, params=params, config=config or op["config"],
                          device="cpu", seed=seed)[0]


def _zc_steps(engine, batches):
    losses = []
    for batch in batches:
        loss = engine.forward(batch)
        engine.backward(loss)
        engine.step()
        losses.append(loss.item())
    return losses


def _zc_whole(engine, rank):
    """Every leaf of the engine's state tree, whole, by key (rank 0 keeps
    them; every rank assembles)."""
    return dict(engine._host_leaves(keep=rank == 0))


def _zc_train(rank, op):
    """Uninterrupted; saved at ``save_at`` and continued; a fresh engine
    (another init) loading that tag and continuing."""
    batches, at = op["batches"], op["save_at"]
    e = _zc_engine(op)
    out = {"losses_u": _zc_steps(e, batches), "final_u": _zc_whole(e, rank)}
    conf = dict(op["config"], checkpoint={"async_save": op.get("async", False)})
    e = _zc_engine(op, config=conf)
    out["losses_s"] = _zc_steps(e, batches[:at])
    e.save_checkpoint(op["dir"])
    out["losses_s"] += _zc_steps(e, batches[at:])
    e.checkpoint_engine.wait()
    out["final_s"] = _zc_whole(e, rank)
    e = _zc_engine(op, seed=7)
    out["path"] = e.load_checkpoint(op["dir"])[0]
    out["loaded"] = _zc_whole(e, rank)
    out["losses_r"] = _zc_steps(e, batches[at:])
    out["final_r"] = _zc_whole(e, rank)
    return out


def _zc_resume(rank, op):
    """A fresh engine loading another engine's tag, then continuing."""
    e = _zc_engine(op, seed=7)
    out = {"path": e.load_checkpoint(op["dir"], tag=op.get("tag"))[0],
           "loaded": _zc_whole(e, rank)}
    out["losses"] = _zc_steps(e, op["batches"])
    out["final"] = _zc_whole(e, rank)
    return out


def _zc_untrained(rank, op):
    _zc_engine(op).save_checkpoint(op["dir"])
    return {}


def _zc_fragments(rank, op):
    """The fragment accessors at two points: after the first batch's
    forward and backward (``"first"``: the masters still the init, the
    accumulators holding one gradient), and after that step and the second
    batch's forward and backward (``"second"``, with the state tree's whole
    leaves); this rank's fragments, and a write read back."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tfrag

    def read(e):
        return {name: {
            "fp32": tfrag.safe_get_full_fp32_param(e, name),
            "grad": tfrag.safe_get_full_grad(e, name),
            "exp_avg": tfrag.safe_get_full_optimizer_state(e, name, "exp_avg"),
            "exp_avg_sq": tfrag.safe_get_full_optimizer_state(e, name, "exp_avg_sq")}
            for name in op["names"]}

    e = _zc_engine(op)
    first, second = op["batches"][:2]
    e.backward(e.forward(first))
    out = {"first": read(e)}
    e.step()
    e.backward(e.forward(second))
    out.update(second=read(e), state=_zc_whole(e, rank),
               fragments={name: [(f.index, f.shape) for f in
                                 tfrag.get_hp_fragment_mapping(e, name)]
                          for name in op["names"]})
    name = op["names"][0]
    value = out["second"][name]["fp32"] + 1.0
    out["set_ran"] = tfrag.safe_set_full_fp32_param(e, name, value)
    out["set_read_back"] = bool(torch.equal(tfrag.safe_get_full_fp32_param(e, name), value))
    out["unknown"] = (tfrag.safe_get_full_grad(e, "layers.9.mlp.wi"),
                      tfrag.safe_set_full_fp32_param(e, "nope.w", value))
    return out


def _zc_universal_in(rank, op):
    """A fresh engine from a universal directory, saved to ``op["save"]``,
    then continuing."""
    from deepspeed_tpu_torch.checkpoint import load_universal_into_engine
    from deepspeed_tpu_torch.models import transformer as ttf

    e = _zc_engine(op, seed=7)
    meta = load_universal_into_engine(e, op["dir"])
    out = {"meta": meta, "steps": e.global_steps, "loaded": _zc_whole(e, rank)}
    e.save_checkpoint(op["save"])
    out["losses"] = _zc_steps(e, op["batches"])
    out["final"] = ttf.params_to_numpy(e.gathered_params(), e.model.cfg)
    return out


def _zc_exit_drain(rank, op):
    """An async save left unfenced and drained as the interpreter's exit
    drains it, rank 1 first while rank 0's writer is held inside its first
    file: whether a commit marker is on disk after rank 1's drain and
    before rank 0's, and after rank 0's the marker and the manifest; then
    every rank loads the tag."""
    import threading

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity
    from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce

    e = _zc_engine(op, config=dict(op["config"], checkpoint={"async_save": True}))
    _zc_steps(e, op["batches"][:1])
    path = os.path.join(op["dir"], "global_step1")
    entered, release = threading.Event(), threading.Event()
    write = tce._write_leaf

    def held(fname, a):
        entered.set()
        release.wait()
        write(fname, a)

    out = {}
    if rank == 0:
        tce._write_leaf = held
    try:
        e.save_checkpoint(op["dir"])
        if rank == 0:
            entered.wait()
        comm.barrier()
        if rank == 1:
            tce._drain_async_engines()
            out["marker_after_rank1_exit"] = integrity.is_committed(path)
        comm.barrier()
        if rank == 0:
            out["marker_before_rank0_exit"] = integrity.is_committed(path)
            release.set()
            tce._drain_async_engines()
            out["marker"] = integrity.is_committed(path)
            out["manifest"] = integrity.read_manifest(path) is not None
        comm.barrier()
    finally:
        tce._write_leaf = write
        release.set()
    out["loaded"] = _zc_engine(op, seed=7).load_checkpoint(op["dir"])[0]
    return out


def _zc_torn(rank, op):
    """Tags at steps 1-3; a byte of the newest flipped (rank 0 alone checks
    the checksums), then the marker of the one before removed: each load
    falls back, and every rank loads the same tag."""
    import json

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity
    from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce

    e = _zc_engine(op)
    for batch in op["batches"][:3]:
        _zc_steps(e, [batch])
        e.save_checkpoint(op["dir"])
    out = {}
    if rank == 0:
        adir = os.path.join(op["dir"], "global_step3", tce.ARRAYS_DIR)
        with open(os.path.join(adir, tce.INDEX_FILE)) as fh:
            leaf = os.path.join(adir, json.load(fh)["['master_params']['embed']['tok']"]["file"])
        with open(leaf, "r+b") as fh:
            fh.seek(100)
            byte = fh.read(1)
            fh.seek(100)
            fh.write(bytes([byte[0] ^ 0x10]))
    comm.barrier()
    fresh = _zc_engine(op, seed=7)
    out["flipped"] = (fresh.load_checkpoint(op["dir"])[0], fresh.global_steps)
    if rank == 0:
        os.remove(os.path.join(op["dir"], "global_step2", integrity.COMMIT_MARKER))
    comm.barrier()
    out["markerless"] = (fresh.load_checkpoint(op["dir"])[0], fresh.global_steps)
    if rank == 0:
        os.remove(os.path.join(op["dir"], "global_step1", integrity.COMMIT_MARKER))
    comm.barrier()
    try:
        fresh.load_checkpoint(op["dir"])
        out["none_left"] = "loaded"
    except integrity.TornCheckpointError as exc:
        out["none_left"] = str(exc)
    return out


def _zc_dataset(n=64, seed=11):
    """Rows that cycle through 16 tokens from a random start after a marker
    token 127 (the resilience tests' data)."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        row = ((rs.randint(0, 16) + np.arange(32)) % 16).astype(np.int32)
        row[0] = 127
        rows.append({"input_ids": row})
    return rows


def _zc_supervised(rank, op):
    """A TrainSupervisor over the op's fault plan (with the sentinel and
    snapshots on disk) and its fault-free run with the plan's quarantined
    batches excluded; then two SDC probes of one batch."""
    from deepspeed_tpu_torch import faults as tfaults
    from deepspeed_tpu_torch.runtime.dataloader import TpuDataLoader
    from deepspeed_tpu_torch.runtime.resilience import TrainSupervisor

    def factory():
        return _zc_engine(op, seed=0)

    def loader(quarantined=()):
        out = TpuDataLoader(_zc_dataset(), batch_size=op["rows"], seed=0, shuffle=True)
        for epoch, batch in quarantined:
            out.quarantine(epoch, batch)
        return out

    recovery = {"numeric_sentinel": op["sentinel"], "backoff_s": 0.0,
                "snapshot_every_n_steps": 2, "snapshot_dir": op["dir"]}
    inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan(
        [tfaults.TrainFault(**f) for f in op["faults"]]))
    sup = TrainSupervisor(factory, loader(), fault_hook=inj, recovery=recovery)
    out = {"chaos": sup.run(op["steps"]), "stats": sup.recovery_stats(),
           "fired": [dict(f) for f in inj.fired]}
    clean = TrainSupervisor(factory, loader(op["quarantined"]),
                            recovery={"backoff_s": 0.0, "snapshot_every_n_steps": 0})
    out["clean"] = clean.run(op["steps"])
    probe = {"input_ids": np.stack([r["input_ids"] for r in _zc_dataset()[:op["rows"]]])}
    out["digests"] = [sup.engine.sdc_probe(probe) for _ in range(2)]
    return out


_ZC_OPS = {"train": _zc_train, "resume": _zc_resume, "untrained": _zc_untrained,
           "fragments": _zc_fragments, "universal_in": _zc_universal_in, "torn": _zc_torn,
           "supervised": _zc_supervised, "exit_drain": _zc_exit_drain}


def zero_checkpoint_program(rank, ops):
    """Each op of ``ops`` ({name: op}) in order, on every rank; their
    results by name."""
    return {name: _ZC_OPS[op["kind"]](rank, op) for name, op in ops.items()}


# ---------------------------------------------------------------------------
# the serving mesh: rank 0 drives, every other rank serves
# ---------------------------------------------------------------------------

def _skew_clock(offset_s: float, delay_s: float):
    """This rank's clocks run ``offset_s`` ahead, and it reads each control
    message ``delay_s`` late: what a worker does must not depend on
    either."""
    import time

    from deepspeed_tpu_torch import comm

    for name in ("time", "monotonic", "perf_counter"):
        real = getattr(time, name)
        setattr(time, name, lambda real=real: real() + offset_s)
    real_recv = comm.comm.control_recv

    def late_recv():
        time.sleep(delay_s)
        return real_recv()

    comm.comm.control_recv = late_recv
    comm.control_recv = late_recv


def _events(path):
    import json

    if not path or not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _shard_info(engine):
    from deepspeed_tpu_torch.models import transformer as ttf

    shard = engine.shard
    return {"mesh": None if engine.mesh is None else dict(engine.mesh.shape),
            "shard": None if shard is None else (shard.attn, shard.mlp, shard.embed, shard.head),
            "kv_shard_width": engine.kv_shard_width,
            "specs": None if engine.param_specs is None else ttf.map_params(
                lambda spec: tuple(spec), engine.param_specs),
            "local_shapes": ttf.map_params(lambda t: tuple(t.shape), engine.params)}


def _mesh_config(case):
    config = {"dtype": "float32", "kv_read_floor": case.get("floor", 16)}
    if case.get("tensor") is not None:
        config["mesh"] = {"shape": {"data": 1, "tensor": case["tensor"]}}
        config["mesh"].update(case.get("mesh_extra", {}))
    config.update(case.get("config", {}))
    return config


def _generate_case(case):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import transformer as ttf

    config = _mesh_config(case)
    config["fused_generate"] = case.get("fused", True)
    if case.get("trace"):
        config["telemetry"] = {"enabled": True, "trace_file": case["trace"]}
    draft = case.get("draft")
    if draft is not None:
        config["speculative"] = {"enabled": True, "num_draft_tokens": 3}
    eng = dst.init_inference(ttf.TransformerConfig(**case["cfg"]), params=case["params"],
                             config=config, device="cpu",
                             draft_model=None if draft is None else ttf.TransformerConfig(
                                 **draft["cfg"]),
                             draft_params=None if draft is None else draft["params"])
    out = {"info": _shard_info(eng)}
    kw = dict(case.get("kw", {}))
    if kw.pop("generator_seed", None) is not None:
        kw["generator"] = torch.Generator().manual_seed(5)
    out["tokens"] = eng.generate(case["tokens"], max_new_tokens=case["new"], **kw).numpy()
    if case.get("forward"):
        out["logits"] = eng.forward(case["tokens"]).numpy()
    out["events"] = _events(case.get("trace"))
    return out


def _pool(case, mesh_shape="case"):
    from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
    from deepspeed_tpu_torch.models import transformer as ttf

    config = _mesh_config(case if mesh_shape == "case" else dict(case, tensor=mesh_shape))
    if case.get("trace"):
        config["telemetry"] = {"enabled": True, "trace_file": case["trace"]}
    kw = dict(case.get("kw", {}))
    draft = case.get("draft")
    if draft is not None:
        kw.update(draft_model=ttf.TransformerConfig(**draft["cfg"]), draft_params=draft["params"])
    return ContinuousBatchingEngine(ttf.TransformerConfig(**case["cfg"]), params=case["params"],
                                    config=config, device="cpu", donate_cache=False, **kw)


def _pool_case(case):
    cb = _pool(case)
    results, rid_of, pending, tick = {}, {}, list(enumerate(case["subs"])), 0
    prefix = case.get("prefix")
    pid = cb.register_prefix(prefix) if prefix is not None else None
    while pending or cb.has_work():
        assert tick < 400, "the pool did not drain"
        for i, (at, prompt, new) in [x for x in pending if x[1][0] <= tick]:
            rid_of[i] = (cb.submit_with_prefix(pid, prompt, max_new_tokens=new) if pid is not None
                         else cb.submit(prompt, max_new_tokens=new))
        pending = [x for x in pending if x[1][0] > tick]
        cb.step()
        results.update(cb.finished())
        tick += 1
    return {"streams": [results[rid_of[i]] for i in range(len(case["subs"]))],
            "rids": [rid_of[i] for i in range(len(case["subs"]))],
            "events": _events(case.get("trace")), "info": _shard_info(cb._eng),
            "stats": cb.tick_stats()}


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _serve_case(case):
    """A ServingEngine over the case's pool on a fake clock, with a fault
    plan and a degrade ladder when the case has them."""
    from deepspeed_tpu_torch.serving import RecoveryConfig, ServingEngine
    from deepspeed_tpu_torch.serving.faults import Fault, FaultInjector, FaultPlan

    clock = _FakeClock()
    cb = _pool(case)
    kw = {}
    if case.get("faults"):
        cb.fault_hook = FaultInjector(FaultPlan([Fault(**f) for f in case["faults"]]))

        def factory(mesh_shape=None):
            tensor = case["tensor"] if mesh_shape is None else mesh_shape.get("tensor", 1)
            return _pool(case, mesh_shape=tensor)

        kw = dict(engine_factory=factory, recovery=RecoveryConfig(backoff_s=0.0),
                  sleep=lambda s: None, degrade_mesh_shapes=case.get("degrade", []))
    srv = ServingEngine(cb, clock=clock, **kw)
    adms = [srv.submit(p, max_new_tokens=m) for p, m in case["requests"]]
    n = 0
    while srv.has_work():
        assert n < 300, "serving did not drain"
        clock.t += 0.01
        srv.step()
        n += 1
    done = srv.reap()
    return {"streams": {a.rid: (done[a.rid].state, [int(t) for t in done[a.rid].tokens])
                        for a in adms},
            "recovery": srv.recovery_stats(),
            "final_mesh": None if srv._cb.mesh is None else dict(srv._cb.mesh.shape)}


def _meshes_case(case):
    from deepspeed_tpu_torch.parallel.partition import serving_mesh

    out = {}
    for d, t in case["shapes"]:
        try:
            out[(d, t)] = dict(serving_mesh(d, t).shape)
        except ValueError as e:
            out[(d, t)] = str(e)
    return out


def _refusals_case(case):
    """What each engine build in ``case["tries"]`` ({name: (model config,
    engine config)}) says: "ran", or its refusal."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import transformer as ttf

    out = {}
    for name, (cfg_kw, config) in case["tries"].items():
        try:
            dst.init_inference(ttf.TransformerConfig(**cfg_kw), config=config, device="cpu")
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _tensor_bytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _leaves(tree):
    from deepspeed_tpu_torch.models import transformer as ttf

    out = []
    ttf.map_params(out.append, tree)
    return out


def _built(model, params, case):
    """An engine on the case's mesh from ``model`` and ``params``: its
    greedy stream, its logits, its own params, and the tensor bytes rank 0
    sent to the workers while building it: in messages to every worker
    (``broadcast``) and to each worker alone (``own``, by rank)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import transformer as ttf

    sent = {"broadcast": 0, "own": {}}
    real_send, real_send_to = comm.control_send, comm.control_send_to

    def send(commands):
        sent["broadcast"] += _tensor_bytes(commands)
        real_send(commands)

    def send_to(rank, obj):
        sent["own"][rank] = sent["own"].get(rank, 0) + _tensor_bytes(obj)
        real_send_to(rank, obj)

    comm.control_send, comm.control_send_to = send, send_to
    try:
        eng = dst.init_inference(model, params=params, seed=4, config=_mesh_config(case),
                                 device="cpu")
    finally:
        comm.control_send, comm.control_send_to = real_send, real_send_to
    return eng, {"tokens": eng.generate(case["tokens"], max_new_tokens=case["new"]).numpy(),
                 "logits": eng.forward(case["tokens"]).numpy(), "sent": sent,
                 "local": ttf.map_params(lambda t: t.numpy(), eng.params)}


def _sources_case(case):
    """One model on the case's mesh built from the seed and from the param
    tree of the engine without a mesh on that seed; rank 0's own params
    against its blocks of that tree, and the bytes of rank 1's blocks and
    of the whole tree."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import mesh as mesh_mod
    from deepspeed_tpu_torch.models import transformer as ttf

    cfg = ttf.TransformerConfig(**case["cfg"])
    plain = dst.init_inference(cfg, seed=4, config=_mesh_config(dict(case, tensor=None)),
                               device="cpu")
    out = {}
    for name, params in (("seed", None), ("tree", plain.params)):
        eng, out[name] = _built(cfg, params, case)
        mine = mesh_mod.shard_params(plain.params, cfg, eng.shard)
        out[name]["local_is_blocks"] = all(
            torch.equal(a, b) for a, b in zip(_leaves(mine), _leaves(eng.params)))
    out["rank1_block_bytes"] = _tensor_bytes(
        mesh_mod.RankBlocks(plain.params, cfg, eng.shard).of_rank(1))
    out["tree_bytes"] = _tensor_bytes(plain.params)
    return out


def _checkpoint_case(case):
    """One HF checkpoint directory on the case's mesh, built from the
    directory and from the tree its converter gives."""
    from deepspeed_tpu_torch.module_inject.load_checkpoint import convert_hf_checkpoint

    cfg, tree = convert_hf_checkpoint(case["path"])
    return {"dir": _built(case["path"], None, case)[1], "tree": _built(cfg, tree, case)[1]}


_SERVING_CASES = {"generate": _generate_case, "pool": _pool_case, "serve": _serve_case,
                  "meshes": _meshes_case, "refusals": _refusals_case, "sources": _sources_case,
                  "checkpoint": _checkpoint_case}


def serving_program(rank, cases, skew=None):
    """The serving mesh's single controller: rank 0 runs each case (an
    engine on a mesh of the world's first ranks, or on none) and returns
    its results; every other rank serves as a worker, with its clocks
    skewed and its reads delayed where ``skew`` says so."""
    from deepspeed_tpu_torch.inference import mesh as mesh_mod

    if rank != 0:
        if skew is not None and rank == 1:
            _skew_clock(*skew)
        return {"ops": mesh_mod.serve_worker(device="cpu")}
    try:
        return {name: _SERVING_CASES[case["kind"]](case) for name, case in cases.items()}
    finally:
        mesh_mod.shutdown()


PROGRAMS = {"comm": comm_program, "engine": engine_program, "serving": serving_program,
            "zero_checkpoint": zero_checkpoint_program}
