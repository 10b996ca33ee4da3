"""ZeRO stages 1-3 of the port against the reference, on the CPU.

1. Placements. The port's ``runtime/zero/sharding`` gives the specs of the
   reference's ``runtime/zero/sharding`` (the seven cases of
   ``tests/unit/zero/test_sharding.py``, then every leaf of the GPT-2 and
   Llama trees at three meshes and four stages), and ``parallel/partition``
   gives ``partition_params``' specs for the same trees. Specs are pure
   functions of the mesh shape, so the reference's meshes are built over
   the 8 virtual CPU devices.
2. Shard shapes. In one world of 2 gloo ranks over ``{fsdp: 2}``, each
   rank's blocks of the params, the f32 masters, Adam's moments and the
   accumulators at stages 0-3 (bf16, so that masters exist; a persistence
   threshold at stage 3; one ``{tensor: 2}`` engine) equal the shapes of
   the reference engine's ``addressable_shards`` on that rank's device of a
   2-device mesh.
3. Parity. In the same world, a tiny f32 GPT-2 trains 3 steps at stages 1,
   2 and 3 on the same global batches as the reference's engine on its
   2-device ``{fsdp: 2}`` mesh: stage 1 with active gradient clipping,
   stage 2 with a ``loss_mask`` whose count differs between the two ranks'
   rows (the loss is the global batch's mean, not the mean of the ranks'
   means), stage 3 fed each rank's own rows (no gathered weight outlives the
   forward: the graph keeps handles, and the backward gathers again). Losses
   within ``rtol=2e-4``
   (the reference's own ZeRO test, ``tests/unit/runtime/test_engine.py``),
   the last global norm within 1e-4 relative, and the gathered final params
   within ``PARAM_REL_TOL`` (5e-4) of each leaf's max. Both sides are f32
   and differ in summation order (the reduction over the ranks included).
   Adam divides each entry's first moment by the root of its second, so the
   embedding rows of tokens absent from a batch (their gradient only
   through the tied head) carry that rounding into their moves: ``embed.tok``
   came out up to 1.9e-4 of its max, every other leaf under 1e-5. The
   key bias ``bk`` has an exact gradient of 0, so both sides move it by
   rounding noise that Adam scales to about lr a step: its moves on each
   side are held to 1.1 x the lr sum (``tests/test_torch_training.py``
   holds them to the lr sum from a zero start).
4. One process. Without a process group the engine is the same state with
   every slot whole (its weights the forward's own leaves, checkpoints
   allowed, every stage stage 0's losses bit for bit, no gradient reduced);
   a rank of a wider mesh cuts the caller's tree leaf by leaf and keeps
   only its blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import partition as jpart
from deepspeed_tpu.runtime.zero import sharding as jsh
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.parallel import partition as tpart
from deepspeed_tpu_torch.runtime.zero import config as tzc
from deepspeed_tpu_torch.runtime.zero import sharding as tsh
from torch_dist_common import run_world

LR, STEPS, MICRO, SEQ = 3e-3, 3, 2, 32
PARAM_REL_TOL = 5e-4
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=SEQ,
            dtype="float32")
LLAMA = dict(TINY, num_kv_heads=2, pos_embedding="rope", norm_type="rmsnorm",
             activation="silu_glu", tie_embeddings=False, use_bias=False, ffn_hidden_size=96)


def _jmesh(shape, n=8):
    jcomm.destroy()
    try:
        return jcomm.build_mesh(shape, devices=jax.devices()[:n])
    finally:
        jcomm.destroy()


def _spec(s):
    return tuple(s)


# ---------------------------------------------------------------------------
# 1. placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [("batch", "seq", "embed"), ("embed", "mlp"), None,
                                   ("layers", "embed", "heads"), ("vocab", "embed"),
                                   ("batch", "vocab"), ("expert", "embed", "mlp")])
def test_logical_rules_are_the_reference_s(names):
    assert _spec(tsh.logical_to_mesh_spec(names)) == _spec(jsh.logical_to_mesh_spec(names))


@pytest.mark.parametrize("shape,spec,mesh,min_elems", [
    ((16, 64), (), {"fsdp": 8}, 0),                         # largest free dim
    ((64, 32), (None, "tensor"), {"fsdp": 4, "tensor": 2}, 0),
    ((3, 5), (), {"fsdp": 8}, 0),                           # indivisible: whole
    ((3, 64), (None, "tensor"), {"fsdp": 4, "tensor": 2}, 0),  # onto the TP dim
    ((2, 64, 64), (None, None, "tensor"), {"fsdp": 2, "tensor": 2}, 0),
    ((2, 64), (None, "tensor"), {"fsdp": 2, "tensor": 2}, 0),  # the layers dim
    ((128,), (), {"fsdp": 8}, 1024),                        # under the threshold
    ((128,), (), {"fsdp": 1, "data": 8}, 0),                # fsdp 1: nothing
    ((64, 64), ("fsdp", None), {"fsdp": 8}, 0),             # already on fsdp
])
def test_add_fsdp_axis_is_the_reference_s(shape, spec, mesh, min_elems):
    jm = _jmesh(mesh)
    ref = jsh.add_fsdp_axis(shape, jax.sharding.PartitionSpec(*spec), jm, min_elems)
    got = tsh.add_fsdp_axis(shape, tsh.PartitionSpec(*spec), dict(jm.shape), min_elems)
    assert _spec(got) == _spec(ref)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("min_elems", [0, 1024])
def test_stage_policies_are_the_reference_s(stage, min_elems):
    jm = _jmesh({"fsdp": 8})
    shapes = {"w": (64, 128), "b": (128,), "odd": (3, 5)}
    abstract = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    ref = jsh.ShardingPolicy(jm, stage=stage, min_shard_elems=min_elems)
    got = tsh.ShardingPolicy(dict(jm.shape), stage=stage, min_shard_elems=min_elems)
    for fn in ("param_pspecs", "opt_pspecs", "grad_pspecs"):
        r, g = getattr(ref, fn)(abstract), getattr(got, fn)(shapes)
        assert {k: _spec(v) for k, v in g.items()} == {k: _spec(v) for k, v in r.items()}, fn
    assert _spec(got.batch_spec()) == _spec(ref.batch_spec())


def test_stage3_blocks_split_the_bytes_as_the_reference_s():
    jm = _jmesh({"fsdp": 8})
    x = jnp.ones((8, 64), jnp.float32)
    policy = jsh.ShardingPolicy(jm, stage=3)
    placed = jax.device_put(x, policy.param_shardings({"w": x})["w"])
    spec = tsh.ShardingPolicy(dict(jm.shape), stage=3).param_spec((8, 64))
    assert tsh.local_shape((8, 64), spec, dict(jm.shape)) == placed.addressable_shards[0].data.shape
    for rank in range(8):
        mesh = tsh_mesh({"fsdp": 8}, 8, rank)
        block = torch.arange(512.0).reshape(8, 64)[tsh.shard_slices((8, 64), spec, mesh)]
        shard = next(s for s in placed.addressable_shards if s.device.id == rank)
        np.testing.assert_array_equal(block.numpy(), np.arange(512.0).reshape(8, 64)[shard.index])


def tsh_mesh(shape, world, rank):
    from deepspeed_tpu_torch import comm

    return comm.build_mesh(shape, world_size=world, rank=rank)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, prefix + (k,)).items()}
    return {".".join(prefix): tree}


@pytest.mark.parametrize("preset", ["tiny-gpt2", "tiny-llama", "gpt2-125m", "llama2-7b"])
@pytest.mark.parametrize("mesh", [{"fsdp": 8}, {"fsdp": 4, "tensor": 2},
                                  {"data": 2, "fsdp": 2, "tensor": 2}])
def test_every_leaf_is_placed_as_the_reference_places_it(preset, mesh):
    over = {"tiny-gpt2": TINY, "tiny-llama": LLAMA}.get(preset)
    jcfg = jtf.TransformerConfig(**over) if over else jtf.get_config(preset)
    tcfg = ttf.TransformerConfig(**over) if over else ttf.get_config(preset)
    jm = _jmesh(mesh)
    abstract = jax.eval_shape(lambda: jtf.init(jax.random.PRNGKey(0), jcfg))
    shapes = ttf.reference_shapes(tcfg)
    assert _flat(jax.tree.map(lambda a: tuple(a.shape), abstract)) == _flat(shapes)
    tlog = _flat(ttf.logical_specs(shapes, tcfg))
    jlog = _flat(jax.tree.map(lambda x: x, jtf.logical_specs(abstract, jcfg),
                              is_leaf=lambda x: isinstance(x, tuple)))
    assert tlog == jlog
    for stage in range(4):
        for min_elems in (0, 100_000):
            ref = jsh.ShardingPolicy(jm, stage, logical_specs=jtf.logical_specs(abstract, jcfg),
                                     min_shard_elems=min_elems)
            got = tsh.ShardingPolicy(dict(jm.shape), stage, logical_specs=tlog,
                                     min_shard_elems=min_elems)
            for fn in ("param_pspecs", "opt_pspecs", "grad_pspecs"):
                r = {k: _spec(v) for k, v in _flat(
                    jax.tree.map(lambda s: s, getattr(ref, fn)(abstract),
                                 is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))).items()}
                g = {k: _spec(v) for k, v in getattr(got, fn)(_flat(shapes)).items()}
                assert g == r, (stage, min_elems, fn)
    # the regex rules of partition.py, on the same trees
    ref = jpart.partition_params(jm, abstract)
    meta = ttf.map_params(lambda s: torch.empty(s, device="meta"), shapes)
    got = tpart.partition_params(dict(jm.shape), meta)
    assert {k: _spec(v) for k, v in _flat(got).items()} == _named_specs(ref)


def _named_specs(tree):
    """{dotted key: spec} of a tree of NamedShardings."""
    return {k: _spec(v.spec) for k, v in _flat(tree).items()}


def test_partition_rules_helpers_are_the_reference_s():
    abstract = {"layers": {"attn": {"wq": jax.ShapeDtypeStruct((2, 64, 96), jnp.float32)},
                           "mlp": {"wi": jax.ShapeDtypeStruct((2, 64, 128), jnp.float32)}},
                "embed": {"tok": jax.ShapeDtypeStruct((100, 64), jnp.float32)}}
    meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), abstract)
    rules = [[r"attn/wq$", [None, "fsdp"]], [r"mlp", ["tensor", None]]]
    assert [n for n, _ in tpart.tree_path_names(meta)] == [n for n, _ in jpart.tree_path_names(abstract)]
    assert [(p, _spec(s)) for p, s in tpart.normalize_rules(rules)] == \
        [(p, _spec(s)) for p, s in jpart.normalize_rules(rules)]
    jm = _jmesh({"fsdp": 2, "tensor": 4})
    base = jpart.partition_params(jm, abstract)
    ref = jpart.apply_rule_overrides(jm, abstract, base, rules)
    got = tpart.apply_rule_overrides(dict(jm.shape), meta, tpart.partition_params(dict(jm.shape), meta),
                                     rules)
    assert {k: _spec(v) for k, v in _flat(got).items()} == _named_specs(ref)
    with pytest.raises(ValueError, match="no partition rule"):
        tpart.match_partition_rules([(r"nothing", tsh.PartitionSpec())], meta)
    for arg in ("1:2", "data=2,tensor=4"):
        assert tpart.parse_mesh_arg(arg) == jpart.parse_mesh_arg(arg)
    cfg = ttf.TransformerConfig(**LLAMA)
    for mesh in (None, {"tensor": 2}, {"tensor": 4}):
        jmesh = None if mesh is None else _jmesh(mesh)
        assert tpart.mesh_tensor_width(mesh) == jpart.mesh_tensor_width(jmesh)
        assert tpart.kv_shard_width(mesh, cfg) == jpart.kv_shard_width(jmesh, cfg)
    # in a world of one process the serving mesh is the 1x1 one, and a
    # wider shape is refused as the reference refuses more devices than it has
    one = tpart.serving_mesh(1, 1)
    assert one.shape == dict(jpart.serving_mesh(1, 1).shape) and one.size == 1
    with pytest.raises(ValueError, match="devices"):
        tpart.serving_mesh(1, 2)


def test_zero_config_reads_the_reference_s_keys():
    from deepspeed_tpu.runtime.zero.config import ZeroConfig as JZeroConfig

    block = {"stage": 3, "stage3_param_persistence_threshold": 7, "reduce_bucket_size": 1e6,
             "overlap_comm": True, "stage3_max_live_parameters": 5}
    got = tzc.zero_config_from_dict(block)
    ref = JZeroConfig(**{JZeroConfig._aliases.get(k, k): v for k, v in block.items()})
    for field in ("stage", "param_persistence_threshold", "reduce_bucket_size", "overlap_comm",
                  "max_live_parameters"):
        assert getattr(got, field) == getattr(ref, field), field
    with pytest.raises(NotImplementedError, match="item 10"):
        tzc.zero_config_from_dict({"stage": 2, "offload_optimizer": {"device": "cpu"}})


# ---------------------------------------------------------------------------
# 2-3. one world of two ranks: shard shapes and parity
# ---------------------------------------------------------------------------

def _config(stage, mesh=None, **over):
    conf = {"train_micro_batch_size_per_gpu": MICRO,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0},
            "mesh": mesh or {"fsdp": 2}, "steps_per_print": 10**9}
    conf.update(over)
    return conf


def _params(cfg_kw, seed=0):
    cfg = jtf.TransformerConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _batches(mask=False):
    rs = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        base = rs.randint(0, 128, (2 * MICRO, SEQ // 4)).astype(np.int32)
        b = {"input_ids": np.tile(base, (1, 4))}
        if mask:  # rank 0's rows keep 5 tokens each, rank 1's 28
            m = np.zeros((2 * MICRO, SEQ), np.float32)
            m[:MICRO, :5] = 1.0
            m[MICRO:, :28] = 1.0
            b["loss_mask"] = m
        out.append(b)
    return out


SHAPE_CASES = {
    **{f"stage{s}": dict(stage=s) for s in range(4)},
    "stage3_threshold": dict(stage=3, threshold=2000),
    "tensor2_stage1": dict(stage=1, mesh={"tensor": 2}),
}
PARITY_CASES = {
    "stage1_clipped": dict(stage=1, over={"gradient_clipping": 0.05}),
    "stage2_unequal_mask": dict(stage=2, mask=True),
    "stage3_local_rows": dict(stage=3, local_feed=True),
}


def _shape_config(case):
    conf = _config(case["stage"], case.get("mesh"), bf16={"enabled": True})
    conf["zero_optimization"]["stage3_param_persistence_threshold"] = case.get("threshold", 0)
    if case.get("mesh"):
        conf["train_micro_batch_size_per_gpu"] = 2 * MICRO
    return conf


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    params = _params(TINY)
    cases = {}
    for name, case in SHAPE_CASES.items():
        cases[name] = {"cfg": dict(TINY, dtype="bfloat16"), "config": _shape_config(case),
                       "shapes": True, "ckpt_dir": str(tmp_path_factory.mktemp("zero_ckpt"))}
    for name, case in PARITY_CASES.items():
        cases[name] = {"cfg": TINY, "config": _config(case["stage"], **case.get("over", {})),
                       "params": params, "batches": _batches(case.get("mask", False)),
                       "local_feed": case.get("local_feed", False)}
    return run_world("engine", 2, tmp_path_factory.mktemp("zero_world"), {"fsdp": 2}, cases)


def _reference_engine(cfg_kw, conf, params=None):
    mesh_shape = conf["mesh"]
    jcomm.destroy()
    mesh = jcomm.build_mesh(mesh_shape, devices=jax.devices()[:2])
    model = jtf.TransformerModel(jtf.TransformerConfig(**cfg_kw))
    kwargs = {} if params is None else {"params": jax.tree.map(jnp.asarray, params)}
    return deepspeed_tpu.initialize(model=model, config=conf, mesh=mesh, **kwargs)[0]


def _shard_shapes(tree, device):
    return {k: tuple(next(s for s in a.addressable_shards if s.device == device).data.shape)
            for k, a in _flat(jax.tree.map(lambda a: a, tree)).items()}


def test_the_ranks_import_neither_jax_nor_the_reference(port_world):
    assert all(r["foreign_modules"] == [] for r in port_world)


@pytest.mark.parametrize("name", list(SHAPE_CASES))
def test_each_rank_holds_the_reference_s_shards(port_world, name):
    case = SHAPE_CASES[name]
    try:
        engine = _reference_engine(dict(TINY, dtype="bfloat16"), _shape_config(case))
        for rank, device in enumerate(jax.devices()[:2]):
            got = port_world[rank][name]
            ref = {"params": _shard_shapes(engine.params, device),
                   "master": _shard_shapes(engine.master_params, device),
                   "grad_acc": _shard_shapes(engine.grad_acc, device),
                   "opt": _shard_shapes(engine.opt_state.exp_avg, device)}
            assert _shard_shapes(engine.opt_state.exp_avg_sq, device) == ref["opt"]
            for what in ("params", "master", "grad_acc", "opt"):
                assert got[what] == ref[what], (rank, what)
    finally:
        jcomm.destroy()
    for rank in range(2):  # the one-tree surfaces refuse a split state, and run on a whole one
        for surface, said in port_world[rank][name]["refusals"].items():
            if name == "stage0":  # every rank holds every leaf whole
                assert said == "ran", (surface, said)
            else:
                assert "item 9 (b)" in said, surface
    if name == "stage3":  # the placements do split: at least one leaf is halved
        assert got["params"]["layers.attn.wq"] == (2, 32, 64)
        assert got["params"]["layers.mlp.bi"] == (1, 256)


@pytest.fixture(scope="module")
def reference_runs():
    params = _params(TINY)
    out = {}
    try:
        for name, case in PARITY_CASES.items():
            engine = _reference_engine(TINY, _config(case["stage"], **case.get("over", {})), params)
            losses = []
            for batch in _batches(case.get("mask", False)):
                loss = engine.forward(batch)
                engine.backward(loss)
                engine.step()
                losses.append(float(jax.block_until_ready(loss)))
            out[name] = {"losses": losses, "gnorm": engine.get_global_grad_norm(),
                         "final": jax.tree.map(np.asarray, engine.params)}
    finally:
        jcomm.destroy()
    return out


@pytest.mark.parametrize("name", list(PARITY_CASES))
def test_stages_match_the_reference_engine(port_world, reference_runs, name):
    ref = reference_runs[name]
    for rank in range(2):
        got = port_world[rank][name]
        assert got["mesh"]["fsdp"] == 2
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
        np.testing.assert_allclose(got["gnorm"], ref["gnorm"], rtol=1e-4)
        want, have = _flat(ref["final"]), _flat(got["final"])
        assert sorted(want) == sorted(have)
        for key, a in want.items():
            if key == "layers.attn.bk":  # noise that Adam moves by up to ~lr a step
                start = _params(TINY)["layers"]["attn"]["bk"]
                moved = max(np.abs(a - start).max(), np.abs(have[key] - start).max())
                assert moved <= 1.1 * STEPS * LR, key
            else:
                assert np.abs(have[key] - a).max() <= PARAM_REL_TOL * np.abs(a).max(), key
    if name == "stage3_local_rows":  # gathered layer by layer, none kept past the forward
        assert [port_world[r][name]["gathered_alive_after_forward"] for r in range(2)] == [0, 0]
    if name == "stage1_clipped":
        assert ref["gnorm"] > 0.05  # the clip was active
    if name == "stage2_unequal_mask":
        # the mean of the two ranks' own masked means is another number
        cfg, batch = jtf.TransformerConfig(**TINY), _batches(mask=True)[0]
        halves = [float(jtf.loss_fn(_params(TINY), cfg, {k: v[r * MICRO:(r + 1) * MICRO]
                                                          for k, v in batch.items()}))
                  for r in range(2)]
        assert abs(np.mean(halves) - ref["losses"][0]) > 1e-3


# ---------------------------------------------------------------------------
# 4. one process: the state of a world of one, and a rank's start-up
# ---------------------------------------------------------------------------

@pytest.fixture
def comms_log():
    from deepspeed_tpu_torch import comm

    comm.comm._STATE.comms_logger = None
    try:
        yield comm.ensure_comms_logger()
    finally:
        comm.comm._STATE.comms_logger = None


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_a_world_of_one_holds_the_single_device_state(stage, comms_log, tmp_path):
    """Without a process group every placement is whole: the engine's trees
    are the forward's own tensors (no weight is rebuilt a step), the one-tree
    surfaces run, every stage gives stage 0's losses bit for bit, and a step
    reduces nothing but the loss's mean (a group of one: no gradient
    bucket)."""
    import deepspeed_tpu_torch as dst

    def run(stage_):
        model = ttf.TransformerModel(ttf.TransformerConfig(**TINY))
        conf = _config(stage_, mesh={"fsdp": -1})
        engine = dst.initialize(model=model, params=_params(TINY), config=conf, device="cpu")[0]
        losses = []
        for batch in _batches()[:2]:
            loss = engine.forward({k: v[:MICRO] for k, v in batch.items()})
            engine.backward(loss)
            engine.step()
            losses.append(loss)
        return engine, torch.stack(losses)

    engine, losses = run(stage)
    state = engine._state
    assert not state.split and engine.mesh is None
    assert [t.data_ptr() for t in state.base] == [p.data_ptr() for p in engine._param_leaves]
    layer = engine.params["layers"][0]["attn"]
    assert layer["wqkv"].requires_grad and layer["wqkv"].grad_fn is None  # a leaf, not a rebuild
    assert torch.equal(losses, run(0)[1])
    said = comms_log.summary()
    assert set(said) == {"all_reduce"} and said["all_reduce"]["count"] == 4, said  # 2 losses a run
    assert said["all_reduce"]["total_bytes"] == 4 * 4
    assert engine.save_checkpoint(str(tmp_path))
    assert engine.load_checkpoint(str(tmp_path))[0] is not None


def test_a_rank_keeps_only_its_blocks_of_the_callers_tree():
    """Each rank of a ``{fsdp: 2}`` stage-3 mesh cuts the caller's f32 tree
    leaf by leaf, lets each leaf go as it is cut, and keeps only its blocks:
    the two ranks' params, masters and accumulators hold every element
    once. ``init(place=)`` (how an engine above one rank stages the tree on
    the host as it is drawn) draws the same numbers."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.zero.partitioned import PartitionedState

    cfg = ttf.TransformerConfig(**TINY)
    drawn = ttf.init(torch.Generator().manual_seed(0), cfg)
    placed = ttf.init(torch.Generator().manual_seed(0), cfg, place=lambda t: t.clone())
    flat_d, flat_p = dict(_named(drawn)), dict(_named(placed))
    assert flat_d.keys() == flat_p.keys()
    assert all(torch.equal(flat_d[k], flat_p[k]) for k in flat_d)
    total = sum(t.numel() for t in flat_d.values())
    held = {"param": 0, "base": 0, "grad": 0}
    for rank in range(2):
        master = ttf.init(torch.Generator().manual_seed(0), cfg)
        state = PartitionedState(cfg, comm.build_mesh({"fsdp": 2}, world_size=2, rank=rank), 3,
                                 master, torch.bfloat16)
        assert all(t is None for _, t in _named(master))
        assert state.split and state.tree is None
        for what in held:
            mine = sum(u.numel() for s in state.slots for u in s.units(what))
            assert mine < total
            held[what] += mine
    assert held == {"param": total, "base": total, "grad": total}


def _named(tree, prefix=()):
    """(path, leaf) of this package's param tree."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named(v, prefix + (i,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("splits", [(1, 1), (2, 3), (4, 1)])
def test_tiled_linear_matches_the_reference(splits):
    """``runtime/zero/tiling``: the product, its bias and its gradients in
    (in_splits x out_splits) tiles against the reference's (f32, summation
    order only: 1e-5)."""
    from deepspeed_tpu.runtime.zero import tiling as jtiling
    from deepspeed_tpu_torch.runtime.zero import tiling as ttiling

    rs = np.random.RandomState(3)
    x, w, b = rs.randn(2, 5, 12), rs.randn(12, 18), rs.randn(18)
    x, w, b = (a.astype(np.float32) for a in (x, w, b))
    ref, vjp = jax.vjp(lambda x_, w_, b_: jtiling.tiled_linear(x_, w_, b_, *splits), x, w, b)
    ref_grads = vjp(jnp.ones_like(ref))
    jax.block_until_ready(ref_grads)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    got = ttiling.tiled_linear(tx, tw, tb, *splits)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    for t, g in zip((tx, tw, tb), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)
    module = ttiling.TiledLinear(12, 18, *splits)
    params = module.init(torch.Generator().manual_seed(0))
    assert params["w"].shape == (12, 18) and params["b"].shape == (18,)
    assert module(params, tx).shape == (2, 5, 18)
    with pytest.raises(ValueError):
        ttiling.tiled_linear(tx, tw, None, 5, 1)
