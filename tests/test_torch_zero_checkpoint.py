"""ZeRO-sharded checkpoints of the port on the CPU, against the reference.

Three worlds of gloo ranks (``tests/torch_dist_common.zero_checkpoint_program``)
run one after the other: 4 ranks on ``{fsdp: 2, tensor: 2}`` at stage 3, 2
ranks on ``{fsdp: 2}`` at stages 1, 2 and 3, then the 4 ranks again. A tiny
GPT-2 (D 64, 2 layers, vocab 128, S 32; AdamW) trains 5 global batches of 4
rows in f32 and in bf16 in each configuration.

(a) Round trips. A run saved after 3 steps continues as the uninterrupted
    run does, bit for bit, and so does a fresh engine (another init) that
    loads the tag on the same stage and mesh. Every other configuration of
    the set, and the single-process engine, loads each tag: every leaf of
    its state then equals the tag's bit for bit, and its 2 more steps stay
    within the ZeRO parity tolerances of ``tests/test_torch_zero.py`` of the
    saving configuration's own: losses within ``rtol=2e-4``, the f32 params
    within ``PARAM_REL_TOL`` of each leaf's max; the key bias rows, whose
    gradient is exactly 0 and which Adam moves by rounding noise of about lr
    a step, within 1.1 x the lr sum of the tag's values. Summation order
    differs between meshes, so nothing more is asked. In bf16 the masters
    are held to one bf16 unit (2^-8) of each leaf's max: the two steps' bf16
    gradients round apart between meshes (stage 3 sums its gradient blocks
    in bf16), and Adam moves the embedding rows of tokens absent from a
    batch by that noise (2.3e-3 of ``embed.tok``'s max at most, every f32
    leaf within 1.1e-7).
(b) An untrained stage-3 engine's tag on ``{fsdp: 2}`` is the single-process
    engine's from the same params, byte for byte, manifest and index
    included.
(c) The reference engine trains 3 steps at stage 3 on its 2-device
    ``{fsdp: 2}`` mesh and converts its tag with its ``ds_to_universal``;
    the port at stage 3 on ``{fsdp: 2}`` loads that directory, and both take
    2 more steps within the tolerances of (a).
(d) The port's ``ds_to_universal`` of its stage-3 tag loads into the
    reference engine through the reference's ``load_universal_into_engine``:
    its masters and moments, mapped back through ``params_from_numpy``, are
    then the tag's bit for bit; the two manifests' ``tensors``,
    ``optimizer`` and ``optimizer_scalars`` have the same keys and shapes.
(e) The port at stage 3 on ``{fsdp: 2}`` loads the reference's universal
    directory of (c), and of a GQA model (2 of 4 kv heads, bf16, one step
    on the reference's ``{fsdp: 2}`` mesh), and saves a tag: ``zero_to_fp32``
    of that tag is the reference's ``model_states.npz`` bit for bit, and the
    port's ``ds_to_universal`` of it the reference's directory, every array
    of every file and the manifest's ``tensors``, ``optimizer`` and
    ``optimizer_scalars``.
(f) ``state_dict_factory``'s split and merge give the reference's output
    bit for bit at TP 2 and 4, ``META_KEY`` included.
(g) A tag whose leaf fails its checksum (rank 0 alone checks) and then one
    without its marker are refused, every rank falls back to the same tag,
    and with none left every rank raises.
(h) A ``TrainSupervisor`` at stage 3 on ``{fsdp: 2}`` through a torn write,
    a preemption restored from disk, a poisoned batch quarantined and a
    flipped gradient bit rewound gives the fault-free stream (that batch
    left out) bit for bit; two SDC probes give one digest on every rank.
(i) The two command lines run on a tag.
(j) An async save at stage 3 on ``{fsdp: 2}`` left unfenced, drained as at
    the interpreter's exit with rank 1 first while rank 0's writer is held:
    no commit marker until rank 0's own drain, then the marker and the
    manifest, and both ranks load the tag.

The fragment accessors (``utils/tensor_fragment``) at stages 1, 2 and 3 in
bf16 return the whole leaves, the same on both ranks: the masters, the
accumulated gradient and the moments bit for bit those of the state tree,
and against the reference engine's ``safe_get_full_*`` on its ``{fsdp: 2}``
mesh at the same points, mapped through ``params_from_numpy``: after the
first batch's backward the masters (the init) bit for bit and the gradient
within bf16's difference between the two implementations; after that step
and the next backward the moments within it too and the masters within one
Adam step (``BF16_MOMENT_TOL``, ``ADAM_STEP_GAP``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.checkpoint import UniversalCheckpoint as JUniversal
from deepspeed_tpu.checkpoint import ds_to_universal as j_ds_to_universal
from deepspeed_tpu.checkpoint import load_universal_into_engine as j_load_universal
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.runtime import state_dict_factory as jsdf
from deepspeed_tpu.utils import tensor_fragment as jfrag
from deepspeed_tpu.utils import zero_to_fp32 as jz
from deepspeed_tpu_torch.checkpoint import UniversalCheckpoint, ds_to_universal
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.runtime import state_dict_factory as tsdf
from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity
from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce
from deepspeed_tpu_torch.utils import zero_to_fp32 as tz
from torch_dist_common import run_world

LR, MICRO, SEQ, STEPS, SAVE_AT = 3e-3, 2, 32, 5, 3
PARAM_REL_TOL = 5e-4
BF16_REL_TOL = 2.0 ** -8
# the fragment accessors against the reference in bf16: a gradient and the
# first moment within 2^-5 of the leaf's max, the second (squared) within
# 2^-4 (measured: 1.5 % and 2.0 %); the masters one Adam step apart at most
# (its first update is lr times the gradient's sign, and a gradient near 0
# takes either sign in two bf16 implementations), weight decay included
BF16_MOMENT_TOL = {"grad": 2.0 ** -5, "exp_avg": 2.0 ** -5, "exp_avg_sq": 2.0 ** -4}
ADAM_STEP_GAP = 2 * LR * 1.01
LOSS_RTOL = 2e-4
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=SEQ)
GQA = dict(TINY, num_kv_heads=2)
MESHES = {"two": {"fsdp": 2}, "four": {"fsdp": 2, "tensor": 2}}
SETS = [(1, "two"), (2, "two"), (3, "two"), (3, "four")]
DTYPES = ("float32", "bfloat16")
FRAGMENT_NAMES = ["layers.0.attn.wqkv", "embed.tok", "layers.1.mlp.wi", "final_norm.scale"]


def _name(stage, mesh, dtype):
    return f"s{stage}_{mesh}_{dtype}"


TAGS = [_name(s, m, d) for d in DTYPES for s, m in SETS]


def _config(stage, mesh, dtype, micro=MICRO):
    conf = {"train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0},
            "steps_per_print": 10 ** 9}
    if mesh is not None:
        conf["mesh"] = MESHES[mesh]
    if dtype == "bfloat16":
        conf["bf16"] = {"enabled": True}
    return conf


def _params(seed=0, shape=TINY):
    cfg = jtf.TransformerConfig(**shape)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _batches():
    rs = np.random.RandomState(7)
    return [{"input_ids": np.tile(rs.randint(0, 128, (2 * MICRO, SEQ // 4)).astype(np.int32),
                                  (1, 4))} for _ in range(STEPS)]


def _op(kind, stage, mesh, dtype, **kw):
    return dict(kind=kind, cfg=dict(TINY, dtype=dtype), config=_config(stage, mesh, dtype), **kw)


def _tag_leaves(path):
    """Every leaf of a committed tag, whole, by key."""
    read, _ = tce.TorchCheckpointEngine().open(path)
    with open(os.path.join(path, tce.ARRAYS_DIR, tce.INDEX_FILE)) as fh:
        return {key: read(key) for key in json.load(fh)}


def _reference_engine(stage, dtype, params, shape=TINY):
    jcomm.destroy()
    mesh = jcomm.build_mesh(MESHES["two"], devices=jax.devices()[:2])
    model = jtf.TransformerModel(jtf.TransformerConfig(**dict(shape, dtype=dtype)))
    return deepspeed_tpu.initialize(model=model, config=_config(stage, "two", dtype), mesh=mesh,
                                    params=jax.tree.map(jnp.asarray, params))[0]


def _reference_steps(engine, batches):
    losses = []
    for batch in batches:
        loss = engine.forward(batch)
        engine.backward(loss)
        engine.step()
        losses.append(float(jax.block_until_ready(loss)))
    return losses


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's side, computed before any port rank runs: its
    fragment accessors after 2 steps and a backward at stages 1-3 (bf16),
    (c)'s stage-3 run with its universal directory, and (e)'s GQA model's
    after one step."""
    root = tmp_path_factory.mktemp("zckpt_ref")
    params, batches = _params(), _batches()
    out = {"fragments": {}, "root": root}
    try:
        for stage in (1, 2, 3):
            e = _reference_engine(stage, "bfloat16", params)
            out["fragments"][stage] = {}
            for point, batch in (("first", batches[0]), ("second", batches[1])):
                if point == "second":
                    e.step()
                e.backward(e.forward(batch))
                names = list(tz._flatten(jax.tree.map(np.asarray, e.params)))
                got = {"fp32": {n: jfrag.safe_get_full_fp32_param(e, n) for n in names},
                       "grad": {n: jfrag.safe_get_full_grad(e, n) for n in names}}
                for key in ("exp_avg", "exp_avg_sq"):
                    got[key] = {n: jfrag.safe_get_full_optimizer_state(e, n, key) for n in names}
                jax.block_until_ready(got)
                out["fragments"][stage][point] = got
        e = _reference_engine(3, "float32", params)
        _reference_steps(e, batches[:SAVE_AT])
        e.save_checkpoint(str(root / "tag"))
        e.checkpoint_engine.wait()
        j_ds_to_universal(str(root / "tag"), str(root / "universal"))
        out["continued"] = _reference_steps(e, batches[SAVE_AT:])
        out["final"] = jax.tree.map(np.asarray, e.params)
        e = _reference_engine(3, "bfloat16", _params(1, GQA), GQA)
        _reference_steps(e, batches[:1])
        e.save_checkpoint(str(root / "tag_gqa"))
        e.checkpoint_engine.wait()
        j_ds_to_universal(str(root / "tag_gqa"), str(root / "universal_gqa"))
    finally:
        jcomm.destroy()
    return out


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    root = tmp_path_factory.mktemp("zckpt")
    tags = {name: str(root / "tags" / name) for name in TAGS}
    params, batches = _params(), _batches()
    rest = batches[SAVE_AT:]

    def train(stage, mesh, dtype):
        name = _name(stage, mesh, dtype)
        return name, _op("train", stage, mesh, dtype, params=params, batches=batches,
                         save_at=SAVE_AT, dir=tags[name])

    def resumes(mesh, stages, sources):
        ops = {}
        for dtype in DTYPES:
            for stage in stages:
                for src in sources:
                    name = _name(stage, mesh, dtype)
                    src_name = f"{src}_{dtype}"
                    if src_name != name:
                        ops[f"{name}<{src_name}"] = _op("resume", stage, mesh, dtype,
                                                        dir=tags[src_name], batches=rest)
        return ops

    four = dict(train(3, "four", d) for d in DTYPES)
    four["s3_four_bfloat16"]["async"] = True
    first = run_world("zero_checkpoint", 4, tmp_path_factory.mktemp("w1"), MESHES["four"], four)
    ops = dict(train(s, "two", d) for d in DTYPES for s in (1, 2, 3))
    ops["s3_two_float32"]["async"] = True
    ops.update(resumes("two", (1, 2, 3), ["s1_two", "s2_two", "s3_two", "s3_four"]))
    for stage in (1, 2, 3):
        ops[f"fragments_s{stage}"] = _op("fragments", stage, "two", "bfloat16", params=params,
                                         batches=batches[:2], names=FRAGMENT_NAMES)
    ops["untrained"] = _op("untrained", 3, "two", "bfloat16", params=params,
                           dir=str(root / "untrained"))
    ops["universal_in"] = _op("universal_in", 3, "two", "float32",
                              dir=str(reference["root"] / "universal"), batches=rest,
                              save=str(root / "universal_in"))
    ops["universal_gqa"] = dict(_op("universal_in", 3, "two", "bfloat16",
                                    dir=str(reference["root"] / "universal_gqa"), batches=[],
                                    save=str(root / "universal_gqa")),
                                cfg=dict(GQA, dtype="bfloat16"))
    ops["exit_drain"] = _op("exit_drain", 3, "two", "bfloat16", params=params, batches=batches,
                            dir=str(root / "exit"))
    ops["torn"] = _op("torn", 3, "two", "bfloat16", params=params, batches=batches,
                      dir=str(root / "torn"))
    ops["supervised"] = dict(
        _op("supervised", 3, "two", "float32", rows=8, steps=10, dir=str(root / "snaps"),
            sentinel={"min_history": 2, "loss_window": 4}, quarantined=[(0, 7)],
            faults=[dict(tick=4, kind="torn_write"), dict(tick=5, kind="preempt"),
                    dict(tick=8, kind="data_poison"), dict(tick=9, kind="grad_bitflip", bit=30)]),
        config=dict(_config(3, "two", "float32", micro=4),
                    optimizer={"type": "AdamW", "params": {"lr": 3e-2, "weight_decay": 0.01}}))
    second = run_world("zero_checkpoint", 2, tmp_path_factory.mktemp("w2"), MESHES["two"], ops)
    third = run_world("zero_checkpoint", 4, tmp_path_factory.mktemp("w3"), MESHES["four"],
                      resumes("four", (3,), ["s1_two", "s2_two", "s3_two"]))
    return {"root": root, "tags": tags, "ranks": [first, second, third]}


def _result(worlds, name):
    """Rank 0's result of op ``name``, whichever world ran it."""
    for world in worlds["ranks"]:
        if name in world[0]:
            return world[0][name]
    raise KeyError(name)


def _single_process(dtype, tag_dir):
    """The single-process engine (no process group) loading ``tag_dir`` and
    taking the last 2 steps."""
    model = ttf.TransformerModel(ttf.TransformerConfig(**dict(TINY, dtype=dtype)))
    e = deepspeed_tpu_torch.initialize(model=model, config=_config(0, None, dtype, micro=2 * MICRO),
                                       device="cpu", seed=7)[0]
    e.load_checkpoint(tag_dir)
    loaded = dict(e._host_leaves())
    losses = []
    for batch in _batches()[SAVE_AT:]:
        loss = e.forward(batch)
        e.backward(loss)
        e.step()
        losses.append(loss.item())
    return {"loaded": loaded, "losses": losses, "final": dict(e._host_leaves())}


def _within(got: dict, want: dict, dtype, start: dict):
    """The continuation's f32 values against the saver's own: each leaf
    within PARAM_REL_TOL (bf16's masters: BF16_REL_TOL) of its max, the key
    bias rows within 1.1 x the lr sum of where they started."""
    group = "['master_params']" if dtype == "bfloat16" else "['params']"
    tol = BF16_REL_TOL if dtype == "bfloat16" else PARAM_REL_TOL
    kv = TINY["hidden_size"]  # q's rows of bqkv, then k's
    for key, w in want.items():
        if not key.startswith(group):
            continue
        g, w = got[key].float(), w.float()
        if key.endswith("['bqkv']"):
            moved = (g[kv:2 * kv] - start[key].float()[kv:2 * kv]).abs().max()
            assert moved <= 1.1 * (STEPS - SAVE_AT) * LR, key
            g, w = torch.cat([g[:kv], g[2 * kv:]]), torch.cat([w[:kv], w[2 * kv:]])
        assert (g - w).abs().max() <= tol * w.abs().max(), key


def _same_leaves(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def test_the_ranks_import_neither_jax_nor_the_reference(worlds):
    assert all(r["foreign_modules"] == [] for world in worlds["ranks"] for r in world)


@pytest.mark.parametrize("name", TAGS)
def test_a_tag_resumes_on_its_own_mesh_bit_for_bit(worlds, name):
    for world in worlds["ranks"]:
        if name not in world[0]:
            continue
        for rank, results in enumerate(world):
            got = results[name]
            assert got["losses_s"] == got["losses_u"], rank
            assert got["losses_r"] == got["losses_u"][SAVE_AT:], rank
            assert got["path"] == os.path.join(worlds["tags"][name], f"global_step{SAVE_AT}")
        got = world[0][name]
        _same_leaves(got["final_s"], got["final_u"])
        _same_leaves(got["final_r"], got["final_u"])
        _same_leaves(got["loaded"], _tag_leaves(got["path"]))
        assert integrity.read_manifest(got["path"]) == integrity.manifest_from_leaves(
            sorted(got["loaded"].items()))


@pytest.mark.parametrize("tag", TAGS)
def test_a_tag_loads_bit_for_bit_on_every_other_stage_and_mesh(worlds, tag):
    dtype = tag.rsplit("_", 1)[1]
    saver = _result(worlds, tag)
    want = _tag_leaves(saver["path"])
    loaders = {name: _result(worlds, name) for world in worlds["ranks"] for name in world[0]
               if name.endswith(f"<{tag}")}
    assert len(loaders) == 3  # every other configuration of the set
    loaders["single_process"] = _single_process(dtype, worlds["tags"][tag])
    for name, got in loaders.items():
        _same_leaves(got["loaded"], want)
        np.testing.assert_allclose(got["losses"], saver["losses_u"][SAVE_AT:], rtol=LOSS_RTOL,
                                   err_msg=name)
        _within(got["final"], saver["final_u"], dtype, want)


def test_a_split_tag_is_byte_identical_to_the_single_process_one(worlds, tmp_path):
    model = ttf.TransformerModel(ttf.TransformerConfig(**dict(TINY, dtype="bfloat16")))
    e = deepspeed_tpu_torch.initialize(model=model, params=_params(),
                                       config=_config(0, None, "bfloat16", micro=2 * MICRO),
                                       device="cpu")[0]
    e.save_checkpoint(str(tmp_path))
    split = os.path.join(str(worlds["root"] / "untrained"), "global_step0")
    one = os.path.join(str(tmp_path), "global_step0")
    files = sorted(os.path.relpath(os.path.join(d, f), split)
                   for d, _, fs in os.walk(split) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), one)
                           for d, _, fs in os.walk(one) for f in fs)
    assert len(files) > 30
    for f in files:
        if f == "ds_metadata.json":  # the stage differs; the rest of it is the same
            a, b = (json.load(open(os.path.join(p, f))) for p in (split, one))
            assert a.pop("zero_stage") == 3 and b.pop("zero_stage") == 0 and a == b
            continue
        with open(os.path.join(split, f), "rb") as fa, open(os.path.join(one, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_the_reference_universal_loads_into_the_port(worlds, reference):
    got = _result(worlds, "universal_in")
    assert got["steps"] == SAVE_AT and got["meta"]["zero_stage"] == 3
    np.testing.assert_allclose(got["losses"], reference["continued"], rtol=LOSS_RTOL)
    for key, want in tz._flatten(reference["final"]).items():
        have = tz._flatten(got["final"])[key]
        if key == "layers.attn.bk":  # exact gradient 0: rounding noise Adam moves by ~lr a step
            assert np.abs(have - want).max() <= 2.2 * (STEPS - SAVE_AT) * LR, key
        else:
            assert np.abs(have - want).max() <= PARAM_REL_TOL * np.abs(want).max(), key


def test_the_port_universal_loads_into_the_reference(worlds, reference, tmp_path):
    tag = os.path.join(worlds["tags"]["s3_two_bfloat16"], f"global_step{SAVE_AT}")
    mine = ds_to_universal(tag, str(tmp_path / "port"))
    ref = JUniversal(str(reference["root"] / "universal")).manifest
    for key in ("tensors", "optimizer", "optimizer_scalars"):
        assert sorted(mine[key]) == sorted(ref[key]), key
    assert mine["tensors"] == ref["tensors"] and mine["optimizer"] == ref["optimizer"]
    try:
        e = _reference_engine(3, "bfloat16", jax.tree.map(np.zeros_like, _params()))
        meta = j_load_universal(e, str(tmp_path / "port"))
        loaded = {"master_params": tz._flatten(jax.tree.map(np.asarray, e.master_params)),
                  "exp_avg": tz._flatten(jax.tree.map(np.asarray, e.opt_state.exp_avg)),
                  "exp_avg_sq": tz._flatten(jax.tree.map(np.asarray, e.opt_state.exp_avg_sq))}
        step = int(e.opt_state.step)
    finally:
        jcomm.destroy()
    assert meta["global_steps"] == SAVE_AT and step == SAVE_AT
    cfg = ttf.TransformerConfig(**dict(TINY, dtype="bfloat16"))
    tree = tz.read_tag(tag)[0]
    for what, src in (("master_params", tree["master_params"]),
                      ("exp_avg", tree["opt_state"]["exp_avg"]),
                      ("exp_avg_sq", tree["opt_state"]["exp_avg_sq"])):
        want = dict(tce.tree_items(src))
        got = dict(tce.tree_items(ttf.params_from_numpy(_unflat(loaded[what]), cfg)))
        assert sorted(got) == sorted(want), what
        for key in want:
            assert torch.equal(got[key], want[key]), (what, key)


@pytest.mark.parametrize("case", ["universal_in", "universal_gqa"])
def test_zero_to_fp32_matches_the_universal_weights(worlds, reference, case, tmp_path):
    src = reference["root"] / case.replace("_in", "")
    saved = str(worlds["root"] / case)
    assert _result(worlds, case)["meta"]["zero_stage"] == 3
    sd = tz.convert_zero_checkpoint_to_fp32_state_dict(saved, str(tmp_path / "w.npz"))
    with np.load(str(src / "model_states.npz")) as z:
        assert sorted(z.files) == sorted(sd)
        for key in z.files:
            assert sd[key].dtype == np.float32
            np.testing.assert_array_equal(sd[key], z[key], err_msg=key)
    with np.load(str(tmp_path / "w.npz")) as z:
        assert sorted(z.files) == sorted(sd)
    assert json.load(open(str(tmp_path / "w.npz.meta.json")))["num_tensors"] == len(sd)
    mine = ds_to_universal(saved, str(tmp_path / "u"))
    ref = JUniversal(str(src)).manifest
    for key in ("tensors", "optimizer", "optimizer_scalars"):
        assert mine[key] == ref[key], key
    for name in ["model_states.npz"] + [f"optim_{c}.npz" for c in ref["optimizer"]]:
        with np.load(str(src / name)) as want, np.load(str(tmp_path / "u" / name)) as got:
            assert sorted(got.files) == sorted(want.files), name
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    # the reference tool's own names on its own tag
    ref_tag = str(reference["root"] / src.name.replace("universal", "tag"))
    assert sorted(jz.get_fp32_state_dict_from_zero_checkpoint(ref_tag)) == sorted(sd)


@pytest.mark.parametrize("tp", [2, 4])
def test_state_dict_factory_is_the_reference_s(tp):
    rs = np.random.RandomState(tp)
    sd = {"layers.attn.wq": rs.randn(2, 8, 8).astype(np.float32),
          "layers.attn.wo": rs.randn(2, 8, 8).astype(np.float32),
          "layers.mlp.wi": rs.randn(2, 8, 16).astype(np.float32),
          "layers.mlp.bi": rs.randn(2, 16).astype(np.float32),
          "embed.tok": rs.randn(12, 8).astype(np.float32),
          "odd.wk": rs.randn(3, 6).astype(np.float32)}
    got, ref = tsdf.split_state_dict(sd, tp), jsdf.split_state_dict(sd, tp)
    assert tsdf.META_KEY == jsdf.META_KEY
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in r:
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
    merged, ref_merged = tsdf.merge_state_dicts(got), jsdf.merge_state_dicts(ref)
    assert sorted(merged) == sorted(ref_merged) == sorted(sd)
    for key in sd:
        np.testing.assert_array_equal(merged[key], ref_merged[key])
        np.testing.assert_array_equal(merged[key], sd[key])
    assert len(tsdf.SDLoaderFactory.get_sd_loader_json(sd, tp)) == tp


def test_torn_tags_fall_back_on_every_rank(worlds):
    torn = os.path.join(str(worlds["root"] / "torn"), "global_step{}")
    for rank, results in enumerate(worlds["ranks"][1]):
        got = results["torn"]
        assert got["flipped"] == (torn.format(2), 2), rank
        assert got["markerless"] == (torn.format(1), 1), rank
        assert got["none_left"].startswith("no committed checkpoint restorable"), rank
        said = "checksum mismatch" if rank == 0 else "another rank refused it"
        assert f"global_step3: " in got["none_left"] and said in got["none_left"], rank


def test_an_unfenced_async_save_is_committed_only_by_its_writer_at_exit(worlds):
    r0, r1 = (r["exit_drain"] for r in worlds["ranks"][1])
    assert r1["marker_after_rank1_exit"] is False
    assert r0["marker_before_rank0_exit"] is False
    assert r0["marker"] and r0["manifest"]
    assert r0["loaded"] == r1["loaded"] == os.path.join(str(worlds["root"] / "exit"),
                                                        "global_step1")


def test_supervisor_chaos_run_is_bitwise_on_a_split_engine(worlds):
    world = worlds["ranks"][1]
    for rank, results in enumerate(world):
        got = results["supervised"]
        assert [f["kind"] for f in got["fired"]] == ["torn_write", "preempt", "data_poison",
                                                     "grad_bitflip"], rank
        np.testing.assert_array_equal(np.float32(got["chaos"]), np.float32(got["clean"]))
        stats = got["stats"]
        assert stats["torn_writes"] == 1 and stats["quarantines"] == 1, stats
        assert stats["rewinds"] == 1 and stats["rebuilds"] == 1, stats
        assert got["digests"][0] == got["digests"][1]
    assert world[0]["supervised"]["digests"] == world[1]["supervised"]["digests"]


def test_the_clis_run_on_a_tag(worlds, tmp_path):
    tag = worlds["tags"]["s2_two_float32"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + sys.path))
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.utils.zero_to_fp32", tag,
                          str(tmp_path / "w.npz"), "--tag", f"global_step{SAVE_AT}"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "wrote 20 tensors" in out.stdout
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.checkpoint.ds_to_universal_cli",
                          "--input_folder", tag, "--output_folder", str(tmp_path / "u")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {"output": str(tmp_path / "u"), "tag": f"global_step{SAVE_AT}", "tensors": 20}
    with np.load(str(tmp_path / "w.npz")) as z:
        weights = {k: z[k] for k in z.files}
    universal = UniversalCheckpoint(str(tmp_path / "u")).load_weights()
    for key in universal:
        np.testing.assert_array_equal(weights[key], universal[key])


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_fragment_accessors_return_whole_tensors(worlds, reference, stage):
    cfg = ttf.TransformerConfig(**dict(TINY, dtype="bfloat16"))
    got = [r[f"fragments_s{stage}"] for r in worlds["ranks"][1]]
    state = got[0]["state"]
    groups = {"fp32": "['master_params']", "grad": "['grad_acc']",
              "exp_avg": "['opt_state'].exp_avg", "exp_avg_sq": "['opt_state'].exp_avg_sq"}
    for point in ("first", "second"):
        ref = {k: ttf.params_from_numpy(_unflat(v), cfg)
               for k, v in reference["fragments"][stage][point].items()}
        for name in FRAGMENT_NAMES:
            path = [int(k) if k.isdigit() else k for k in name.split(".")]
            key = "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]" for k in path)
            for what, group in groups.items():
                mine = got[0][point][name][what]
                assert torch.equal(mine, got[1][point][name][what]), (point, name, what)
                want = ref[what]
                for k in path:
                    want = want[k]
                assert mine.dtype == torch.float32 and mine.shape == want.shape, (name, what)
                err = (mine - want).abs().max()
                if point == "second":
                    assert torch.equal(mine, state[group + key]), (name, what)
                if what == "fp32":  # the init, then one Adam step apart at most
                    assert err == 0 if point == "first" else err <= ADAM_STEP_GAP, (point, name)
                else:
                    tol = BF16_MOMENT_TOL[what] * want.abs().max()
                    assert err <= tol, (point, name, what, float(err / want.abs().max()))
    for name in FRAGMENT_NAMES:  # the two ranks' fragments tile the leaf
        key = "".join(f"[{k}]" if k.isdigit() else f"[{k!r}]" for k in name.split("."))
        cover = torch.zeros(tuple(state["['params']" + key].shape), dtype=torch.int32)
        for rank in range(2):
            for index, shape in got[rank]["fragments"][name]:
                assert tuple(s.stop - s.start for s in index) == shape
                cover[index] += 1
        assert int(cover.min()) >= 1
    for rank in range(2):
        assert got[rank]["set_ran"] and got[rank]["set_read_back"]
        assert got[rank]["unknown"] == (None, False)


def _unflat(flat):
    tree = {}
    for name, arr in flat.items():
        node = tree
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = np.asarray(arr)
    return tree
