"""The serving mesh on ranks: placements, each rank's params, and the single
controller that drives the ranks.

The reference serves a tensor-parallel mesh from one process: its host
loop decides once, and GSPMD changes where the arithmetic runs, never what
it computes. The port runs one process a device, so it keeps that shape
with a single controller:

- The world's rank 0 runs every host loop: the inference engine's calls,
  the batching engine's scheduler, the serving layer with its clock,
  deadlines and recovery ladder, the loadgen. Every other rank runs
  :func:`serve_worker` and holds no scheduler state.
- A mesh engine on rank 0 announces itself when it is built (its
  constructor's arguments; a param tree given to it goes to each worker
  as that worker's blocks alone, :class:`RankBlocks`, and a checkpoint
  directory as its path) and at each of its device operations
  (:func:`mirrored`): the operation's name and its small host-made
  inputs go to the workers over the control channel
  (``comm.control_send``), and each worker runs the same operation on its
  own shard of the params and the KV cache. The collectives inside the
  forward are where the ranks meet; every rank ends an operation with the
  same gathered logits and the same sampled tokens, and only rank 0
  fetches them, emits telemetry and answers ``finished()``.
- Nothing a worker runs depends on its own clock, so a skewed or slow rank
  changes no stream. An engine rank 0 lets go of (a rebuild onto a smaller
  rung of the degrade ladder) is dropped on the workers with the next
  message; a rank outside the new mesh only reads messages.

``serving_shard`` turns an engine's spec tree (``parallel.partition.
serving_placements``) into the forward's modes (``ServingShard``), raising
for a placement the forward has no mode for, and ``shard_params`` cuts the
port's full param tree to what a rank holds: each leaf split on one dim
over ``tensor`` or whole.
"""

import dataclasses
import functools
import itertools
import weakref
from typing import Dict, List

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.partition import mesh_tensor_width, serving_mesh, tree_path_names
from deepspeed_tpu_torch.parallel.tensor_parallel import ServingShard
from deepspeed_tpu_torch.utils import not_ported

_ITEM = "Queue 1 item 8 (c)"
# rank 0's side of the control channel (one a process, as the channel is):
# engine ids, and the commands queued for the next message (engines it let
# go of); "worker" is set inside serve_worker, "depth" inside a mirrored call
_EIDS = itertools.count(1)
_QUEUED: List[tuple] = []
_STATE = {"worker": False, "depth": 0}


def refuse(feature: str):
    """The refusal of a serving-mesh feature that stays out of this slice."""
    return not_ported(f"{feature} ({_ITEM})")


# ---------------------------------------------------------------------------
# placements -> the forward's modes, and each rank's params
# ---------------------------------------------------------------------------

def _has_tensor(spec, dim: int) -> bool:
    entries = list(spec)
    if not -len(entries) <= dim < len(entries):
        return False
    entry = entries[dim]
    return entry is not None and "tensor" in ((entry,) if isinstance(entry, str) else entry)


def _tensor_dims(spec) -> List[int]:
    n = len(spec)
    return [d - n for d in range(n) if _has_tensor(spec, d - n)]


def serving_shard(cfg, mesh, specs):
    """This rank's ``ServingShard`` for a spec tree in the reference's
    layout (None at tensor width 1): attention on heads, on q's columns or
    whole, the MLP split or whole, the embedding's and the head's vocabulary
    split or whole. Raises ``NotImplementedError`` for a placement the
    forward has no mode for (a split on another dim, the q and output
    projections placed differently, a layer's MLP half split)."""
    T = mesh_tensor_width(mesh)
    if T <= 1:
        return None
    ly = specs["layers"]
    attn, mlp = ly["attn"], ly["mlp"]
    expected = {}  # leaf path -> the dims a split may take

    def split(path, tree, name, dim):
        if name not in tree:
            return None
        expected[path + (name,)] = [dim]
        return _has_tensor(tree[name], dim)

    q = split(("layers", "attn"), attn, "wq", -1)
    o = split(("layers", "attn"), attn, "wo", -2)
    kv = [split(("layers", "attn"), attn, n, -1) for n in ("wk", "wv")]
    for n in ("bq", "bk", "bv"):
        split(("layers", "attn"), attn, n, -1)
    if q and o:
        heads = cfg.num_heads % T == 0 and cfg.kv_heads % T == 0
        attn_mode = "heads" if heads else "columns"
    elif not q and not o and not any(kv):
        attn_mode = "whole"
    else:
        raise refuse(f"a serving placement with attention's wq split {q}, wo split {o} and "
                     f"wk/wv split {kv}")
    mlp_split = [split(("layers", "mlp"), mlp, n, d)
                 for n, d in (("wi", -1), ("wg", -1), ("wo", -2))]
    split(("layers", "mlp"), mlp, "bi", -1)
    mlp_split = [m for m in mlp_split if m is not None]
    if any(mlp_split) and not all(mlp_split):
        raise refuse("a serving placement that splits part of the MLP")
    embed = split(("embed",), specs["embed"], "tok", -2)
    if cfg.tie_embeddings:
        head = embed
    else:
        head = split(("lm_head",), specs["lm_head"], "w", -1)
        split(("lm_head",), specs["lm_head"], "b", -1)
    for name, spec in tree_path_names(specs):
        path = tuple(name.split("/"))
        dims = _tensor_dims(spec)
        if dims and dims != expected.get(path, [])[:len(dims)]:
            raise refuse(f"a serving placement that splits {name} on dims {dims}")
    tensor = comm.MeshAxes(mesh, ("tensor",))
    return ServingShard(size=T, rank=comm.get_rank(tensor), group=tensor, attn=attn_mode,
                        mlp=bool(mlp_split and all(mlp_split)), embed=bool(embed),
                        head=bool(head))


def shard_params(params, cfg, shard):
    """This rank's blocks of the port's full param tree (weights (out, in),
    the fused ``wqkv`` rows ordered q, k, v): contiguous copies on the
    tree's device, so the full tree can be dropped."""
    if shard is None:
        return params
    T, r, hd = shard.size, shard.rank, cfg.head_dim
    nh, nkv = cfg.num_heads, cfg.kv_heads

    def block(t, dim):
        start, n = shard.block(t.shape[dim])
        return t.narrow(dim, start, n).clone()

    def qkv_rows(t):
        q, k, v = t.split([nh * hd, nkv * hd, nkv * hd], dim=0)
        if shard.attn == "heads":
            return torch.cat([block(q, 0), block(k, 0), block(v, 0)], dim=0)
        return torch.cat([block(q, 0), k, v], dim=0)  # "columns": every kv head

    out = {group: dict(leaves) for group, leaves in params.items() if group != "layers"}
    if shard.embed:
        out["embed"]["tok"] = block(params["embed"]["tok"], 0)
    if shard.head and "lm_head" in params:
        out["lm_head"] = {k: block(v, 0) for k, v in params["lm_head"].items()}
    layers = []
    for layer in params["layers"]:
        new = {k: dict(v) for k, v in layer.items()}
        if shard.attn != "whole":
            a = layer["attn"]
            new["attn"]["wqkv"] = qkv_rows(a["wqkv"])
            if "bqkv" in a:
                new["attn"]["bqkv"] = qkv_rows(a["bqkv"])
            new["attn"]["wo"] = block(a["wo"], 1)
        if shard.mlp:
            m = layer["mlp"]
            for name in ("wi", "wg", "bi"):
                if name in m:
                    new["mlp"][name] = block(m[name], 0)
            new["mlp"]["wo"] = block(m["wo"], 1)
        layers.append(new)
    out["layers"] = layers
    return out


class RankBlocks:
    """Rank 0's param tree for the workers of a mesh engine: each worker is
    sent only its own blocks of it (:meth:`of_rank`, on the host)."""

    def __init__(self, tree, cfg, shard):
        self.tree, self.cfg, self.shard = tree, cfg, shard

    def of_rank(self, rank: int):
        from deepspeed_tpu_torch.models import transformer as tf

        shard = dataclasses.replace(self.shard, rank=rank)
        return tf.map_params(lambda t: t.cpu(), shard_params(self.tree, self.cfg, shard))


@dataclasses.dataclass
class Blocks:
    """A worker's own blocks of a param tree, as rank 0 cut them: an engine
    takes them as they are."""

    tree: dict


# ---------------------------------------------------------------------------
# the single controller
# ---------------------------------------------------------------------------

def is_worker() -> bool:
    """Whether this process is a worker inside :func:`serve_worker`."""
    return _STATE["worker"]


def _encode(x):
    """A call's arguments as the workers read them: engines by their id,
    generators by their state, tensors as host copies."""
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, torch.Generator):
        return ("__generator__", x.get_state())
    if torch.is_tensor(x):
        return x.detach().cpu()
    mirror = getattr(x, "_mirror", None)
    if isinstance(mirror, Mirror):
        return ("__engine__", mirror.eid)
    return x


def _decode(x, device, engines: Dict[int, object]):
    if isinstance(x, tuple) and len(x) == 2 and x[0] == "__engine__":
        return engines[x[1]]
    if isinstance(x, tuple) and len(x) == 2 and x[0] == "__generator__":
        gen = torch.Generator(device=device)
        gen.set_state(x[1])
        return gen
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v, device, engines) for v in x)
    if isinstance(x, dict):
        return {k: _decode(v, device, engines) for k, v in x.items()}
    return x


def _send(command):
    # taken out before the send: a finalizer that the send's pickling sets
    # off queues its drop for the next message
    commands = _QUEUED[:]
    del _QUEUED[:len(commands)]
    comm.control_send(commands + [command])


class Mirror:
    """Rank 0's side of one mesh engine: it announces the engine to the
    workers (``kind`` and its constructor's ``kwargs``, over ``mesh``),
    then sends each worker of the mesh its blocks of every
    :class:`RankBlocks` among the ``kwargs``, and announces each of the
    engine's device operations; once the engine is gone, the workers drop
    theirs with the next message."""

    def __init__(self, engine, kind: str, mesh_shape: dict, kwargs: dict):
        self.eid = next(_EIDS)
        trees = {k: v for k, v in kwargs.items() if isinstance(v, RankBlocks)}
        kwargs = {k: v for k, v in kwargs.items() if k not in trees}
        _send(("build", self.eid, dict(mesh_shape), kind, _encode(kwargs)))
        for rank in range(1, mesh_shape["data"] * mesh_shape["tensor"]):
            comm.control_send_to(rank, {k: t.of_rank(rank) for k, t in trees.items()})
        weakref.finalize(engine, _QUEUED.append, ("drop", self.eid))

    def call(self, name: str, args, kwargs):
        _send(("call", self.eid, name, _encode(args), _encode(kwargs)))


def controller(engine, kind: str, mesh, kwargs: dict):
    """The engine's :class:`Mirror` where it serves a mesh of more than one
    rank from rank 0; None at width 1 and on a worker. Raises on another
    rank outside :func:`serve_worker`."""
    if mesh is None or mesh.size <= 1 or is_worker():
        return None
    if comm.process_world()[0] != 0:
        raise RuntimeError("a serving mesh is driven from the world's rank 0; every other rank "
                           "runs deepspeed_tpu_torch.inference.mesh.serve_worker()")
    shape = {"data": mesh.shape["data"], "tensor": mesh.shape["tensor"]}
    return Mirror(engine, kind, shape, kwargs)


def mirrored(method):
    """A device operation of a mesh engine: on rank 0 the call goes to the
    workers before it runs here; a call made inside another mirrored call
    is the workers' own to make."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        mirror = getattr(self, "_mirror", None)
        if mirror is not None and _STATE["depth"] == 0:
            mirror.call(method.__name__, args, kwargs)
        _STATE["depth"] += 1
        try:
            return method(self, *args, **kwargs)
        finally:
            _STATE["depth"] -= 1

    return wrapper


def _engine_classes():
    from deepspeed_tpu_torch.inference.continuous import ContinuousBatchingEngine
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return {"InferenceEngine": InferenceEngine,
            "ContinuousBatchingEngine": ContinuousBatchingEngine}


def serve_worker(device=None) -> int:
    """Run this rank as a worker of rank 0's serving meshes until rank 0
    calls :func:`shutdown`: make the groups of each mesh rank 0 announces,
    build this rank's shard of each engine whose mesh holds it, and run
    each device operation rank 0 sends. ``device`` is where this rank's
    engines live (default: the current CUDA device). Returns the number of
    operations run."""
    from deepspeed_tpu_torch.accelerator import get_accelerator

    rank, world = comm.process_world()
    if rank == 0 or world == 1:
        raise RuntimeError("serve_worker runs on the world's ranks other than 0")
    device = comm.comm.canonical_device(get_accelerator().resolve_device(device))
    classes = _engine_classes()
    engines: Dict[int, object] = {}  # this rank's engines, by the id rank 0 gave them
    _STATE["worker"] = True
    ran = 0
    try:
        comm.control_group()
        while True:
            for command in comm.control_recv():
                kind = command[0]
                if kind == "stop":
                    return ran
                if kind == "mesh":
                    comm.subset_mesh(command[1])
                elif kind == "drop":
                    engines.pop(command[1], None)
                elif kind == "build":
                    _, eid, shape, cls, kwargs = command
                    if serving_mesh(shape["data"], shape["tensor"]) is not None:
                        kwargs = _decode(kwargs, device, engines)
                        kwargs.update({k: Blocks(tree)
                                       for k, tree in comm.control_recv_own().items()})
                        kwargs["device"] = device
                        engines[eid] = classes[cls](**kwargs)
                elif kind == "call":
                    _, eid, name, args, kwargs = command
                    engine = engines.get(eid)
                    if engine is not None:
                        with torch.inference_mode():
                            getattr(engine, name)(*_decode(args, device, engines),
                                                  **_decode(kwargs, device, engines))
                        ran += 1
    finally:
        _STATE["worker"] = False


def shutdown():
    """Rank 0: release the workers from :func:`serve_worker` (a no-op in a
    world of one)."""
    if comm.process_world()[1] > 1 and not is_worker():
        comm.control_group()
        _send(("stop",))
