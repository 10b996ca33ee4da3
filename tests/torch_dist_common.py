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
            out[name]["refusals"] = _refusals(engine, os.path.join(case["ckpt_dir"], name))
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


def _refusals(engine, ckpt_dir):
    """What the surfaces that read the state as one tree say: their
    refusal where the engine's state is split across ranks, else "ran" (a
    save under ``ckpt_dir`` that rank 0 writes, its load on every rank, a
    host snapshot restored, a probe)."""
    snap = []
    calls = {"save_checkpoint": lambda: engine.save_checkpoint(ckpt_dir, tag="t"),
             "load_checkpoint": lambda: engine.load_checkpoint(ckpt_dir, tag="t"),
             "host_state_snapshot": lambda: snap.append(engine.host_state_snapshot()),
             "restore_from_host_state": lambda: engine.restore_from_host_state(
                 *(snap[0][:2] if snap else ({}, {}))),
             "sdc_probe": lambda: engine.sdc_probe({"input_ids": np.zeros((1, 4), np.int64)})}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = str(e)
    return out


PROGRAMS = {"comm": comm_program, "engine": engine_program}
