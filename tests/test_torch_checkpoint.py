"""The port's checkpoints, data loader and tensor-fragment access, on the CPU.

1. ``runtime/checkpoint_engine/integrity.py`` against the reference's module
   on the same leaves (f32; bf16 as ``ml_dtypes`` there and torch bf16 here;
   int32; 0-d): equal manifests, the same problems for a flipped bit, a
   missing and an extra leaf, the same tag scans.
2. Save, load and resume inside the port, bit for bit: run A trains 6
   steps; run B trains 3, saves, loads into a fresh engine and trains 3
   more. The two loss streams and every leaf of the state tree after step 6
   are equal, for f32, bf16 with f32 masters, fp16 with the dynamic scaler
   mid-run and GAS 2 with WarmupLR, each with sync and async saves. Also
   ``load_optimizer_states=False``, ``client_state``, the ``latest`` pointer
   and the commit marker (a markerless tag refused with fallback, a checksum
   corruption refused, all tags torn raises), and an async save whose next
   step must not reach the bytes being written.
3. Across packages: the reference engine trains 3 steps and takes
   ``host_state_snapshot()``; the port restores it through
   ``state_from_reference_snapshot`` and both train 3 more steps on the same
   batches, held to ``tests/test_torch_training.py``'s tolerances (loss 5e-5,
   params 1e-4 of each leaf's max, ``bk`` by its rule); counters and lr
   exactly equal.
4. ``runtime/dataloader.py`` against the reference's: the same batches over
   two epochs, the same cursors, the same skips after a quarantine.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.runtime import dataloader as rdl
from deepspeed_tpu.runtime.checkpoint_engine import integrity as rint
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity as tint
from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce
from deepspeed_tpu_torch.runtime.engine import state_from_reference_snapshot
from deepspeed_tpu_torch.utils import tensor_fragment as tfrag
from test_torch_training import (BATCH, CFG, ENGINE_LOSS_TOL, GAS, PARAM_REL_TOL, ZERO_GRAD_LEAVES,
                                 _data, _engine_config, _leaves, _rel)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's CPU ops run fastest on one thread, and the suite's
    parallel workers share the cores: more threads a worker oversubscribe
    them (each step then waits on spinning threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# 1. integrity against the reference's module
# ---------------------------------------------------------------------------


def _leaf_pairs():
    """The same bits on both sides: (reference leaves, port leaves)."""
    rs = np.random.RandomState(0)
    f32 = rs.randn(3, 5).astype(np.float32)
    bf16 = rs.randn(4, 6).astype(np.float32).astype(ml_dtypes.bfloat16)
    i32 = rs.randint(-9, 9, (7,)).astype(np.int32)
    zero_d = np.array(2.5, np.float32)
    ref = [("['a']", f32), ("['b'][0]", bf16), ("['c'].step", i32), ("['d']", zero_d)]
    port = [("['a']", torch.from_numpy(f32.copy())),
            ("['b'][0]", torch.from_numpy(bf16.view(np.int16).copy()).view(torch.bfloat16)),
            ("['c'].step", torch.from_numpy(i32.copy())), ("['d']", torch.tensor(2.5))]
    return ref, port


def test_manifest_equals_the_reference_for_the_same_bits():
    ref, port = _leaf_pairs()
    want = rint.manifest_from_leaves(ref)
    assert tint.manifest_from_leaves(port) == want
    assert want["leaves"]["['b'][0]"]["dtype"] == "bfloat16"
    assert want["leaves"]["['d']"]["shape"] == []


def _flipped(leaves, i):
    key, leaf = leaves[i]
    if torch.is_tensor(leaf):
        t = leaf.clone()
        t.view(-1).view(torch.uint8)[0] ^= 1
        return leaves[:i] + [(key, t)] + leaves[i + 1:]
    a = np.array(leaf)
    a.reshape(-1).view(np.uint8)[0] ^= 1
    return leaves[:i] + [(key, a)] + leaves[i + 1:]


@pytest.mark.parametrize("damage", ["flip_f32", "flip_bf16", "flip_0d", "missing", "extra"])
def test_verify_leaves_finds_the_reference_problems(damage):
    ref, port = _leaf_pairs()
    manifest = rint.manifest_from_leaves(ref)
    edit = {"flip_f32": lambda l: _flipped(l, 0), "flip_bf16": lambda l: _flipped(l, 1),
            "flip_0d": lambda l: _flipped(l, 3), "missing": lambda l: l[1:],
            "extra": lambda l: l + [("['e']", l[0][1])]}[damage]
    want = rint.verify_leaves(edit(ref), manifest)
    assert want and tint.verify_leaves(edit(port), manifest) == want
    assert tint.verify_leaves(port, manifest) == [] == rint.verify_leaves(ref, manifest)


def test_tag_scans_agree_with_the_reference(tmp_path):
    for step, committed in ((1, True), (2, False), (10, True), (11, False)):
        d = tmp_path / f"global_step{step}"
        d.mkdir()
        if committed:
            tint.write_commit_marker(str(d))
    (tmp_path / "foreign").mkdir()
    (tmp_path / "global_step7").write_text("a file, not a tag")
    assert tint.scan_tags(str(tmp_path)) == rint.scan_tags(str(tmp_path))
    assert tint.latest_committed_tag(str(tmp_path)) == rint.latest_committed_tag(
        str(tmp_path)) == "global_step10"
    assert tint.tag_step("global_step12") == 12 and tint.tag_step("latest") is None


# ---------------------------------------------------------------------------
# 2. save, load and resume inside the port
# ---------------------------------------------------------------------------

MICRO = 4
CASES = {
    "f32": ("float32", {}),
    "bf16": ("bfloat16", {"bf16": {"enabled": True}}),
    # a loss-scale window of 2 doubles the scale every second clean step, so
    # the scaler's state at the save (after step 3) is mid-window
    "fp16_dynamic": ("float16", {"fp16": {"enabled": True, "initial_scale_power": 12,
                                          "loss_scale_window": 2}}),
    "gas2_warmup": ("float32", {"gradient_accumulation_steps": 2,
                                "scheduler": {"type": "WarmupLR",
                                              "params": {"warmup_num_steps": 4,
                                                         "warmup_max_lr": 3e-3,
                                                         "warmup_type": "linear"}}}),
}


def _config(over=None, async_save=False):
    conf = {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 10 ** 6}
    conf.update(over or {})
    if async_save:
        conf["checkpoint"] = {"async_save": True}
    return conf


def _engine(dtype="float32", over=None, async_save=False, seed=0):
    model = ttf.TransformerModel(ttf.TransformerConfig(**dict(CFG, dtype=dtype)))
    return deepspeed_tpu_torch.initialize(model=model, config=_config(over, async_save),
                                          device="cpu", seed=seed)[0]


def _micro(step, micro):
    return {"input_ids": _data(step, micro)["input_ids"][:MICRO]}


def _train(engine, steps):
    losses = []
    for _ in range(steps):
        step = engine.global_steps
        losses.append(engine.train_batch(iter(
            [_micro(step, m) for m in range(engine.gradient_accumulation_steps)])).item())
    return losses


def _state(engine):
    return dict(engine._host_leaves())


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sorted(sa) == sorted(sb)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    assert (a.global_steps, a.micro_steps, a.global_samples, a.skipped_steps) == (
        b.global_steps, b.micro_steps, b.global_samples, b.skipped_steps)
    assert a.get_lr() == b.get_lr()


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_save_load_resume_is_bitwise(case, async_save, tmp_path):
    dtype, over = CASES[case]
    run_a = _engine(dtype, over)
    losses_a = _train(run_a, 6)
    run_b = _engine(dtype, over, async_save)
    losses_b = _train(run_b, 3)
    run_b.save_checkpoint(str(tmp_path))
    _train(run_b, 1)  # the saving engine moves on; the tag keeps step 3
    run_b.checkpoint_engine.wait()  # an async save is durable at its fence
    resumed = _engine(dtype, over, async_save, seed=1)  # other initial weights
    path, client = resumed.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and client == {} and resumed.global_steps == 3
    losses_b += _train(resumed, 3)
    assert losses_b == losses_a
    _assert_same_state(resumed, run_a)
    if case == "fp16_dynamic":
        assert run_a.loss_scale != 2.0 ** 12  # the scaler moved
    if case == "bf16":
        assert resumed.params["embed"]["tok"].dtype == torch.bfloat16
        assert resumed.master_params["embed"]["tok"].dtype == torch.float32


def test_load_without_optimizer_states_keeps_the_fresh_moments(tmp_path):
    src = _engine()
    _train(src, 2)
    src.save_checkpoint(str(tmp_path), client_state={"cursor": {"epoch": 1, "batch": 3}})
    fresh = _engine(seed=1)
    path, client = fresh.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert client == {"cursor": {"epoch": 1, "batch": 3}}
    assert fresh.opt_state.step == 0
    assert all(float(m.abs().max()) == 0.0 for m in fresh.opt_state.exp_avg)
    assert all(torch.equal(a, b) for a, b in zip(fresh._param_leaves, src._param_leaves))
    assert fresh.global_steps == 2


def test_latest_pointer_is_atomic_and_marker_present(tmp_path):
    eng = _engine()
    _train(eng, 2)
    ckpt = str(tmp_path / "ck")
    eng.save_checkpoint(ckpt)
    tag_dir = os.path.join(ckpt, "global_step2")
    assert tint.is_committed(tag_dir)
    manifest = tint.read_manifest(tag_dir)
    assert manifest["leaf_count"] == len(_state(eng)) > 0
    assert open(os.path.join(ckpt, "latest")).read() == "global_step2"
    assert not [n for n in os.listdir(ckpt) if ".tmp." in n]
    # the arrays are logical tensors, readable as raw bytes
    index = json.load(open(os.path.join(tag_dir, tce.ARRAYS_DIR, tce.INDEX_FILE)))
    key = "['params']['layers'][0]['attn']['wqkv']"
    entry = index[key]
    raw = np.fromfile(os.path.join(tag_dir, tce.ARRAYS_DIR, entry["file"]), dtype=entry["dtype"])
    np.testing.assert_array_equal(raw.reshape(entry["shape"]),
                                  eng.params["layers"][0]["attn"]["wqkv"].detach().numpy())
    assert tint.leaf_crc(raw.reshape(entry["shape"])) == manifest["leaves"][key]["crc32"]


def test_markerless_tag_refused_with_fallback(tmp_path):
    eng = _engine()
    ckpt = str(tmp_path / "ck")
    for _ in range(2):
        _train(eng, 1)
        eng.save_checkpoint(ckpt)
    os.remove(os.path.join(ckpt, "global_step2", tint.COMMIT_MARKER))
    fresh = _engine(seed=1)
    path, _ = fresh.load_checkpoint(ckpt)
    assert path.endswith("global_step1") and fresh.global_steps == 1


def test_all_torn_raises(tmp_path):
    eng = _engine()
    _train(eng, 1)
    ckpt = str(tmp_path / "ck")
    eng.save_checkpoint(ckpt)
    os.remove(os.path.join(ckpt, "global_step1", tint.COMMIT_MARKER))
    with pytest.raises(tint.TornCheckpointError, match="no committed checkpoint"):
        _engine(seed=1).load_checkpoint(ckpt)


@pytest.mark.parametrize("where", ["manifest", "leaf_file"])
def test_checksum_corruption_refused(where, tmp_path):
    eng = _engine()
    _train(eng, 1)
    ckpt = str(tmp_path / "ck")
    eng.save_checkpoint(ckpt, tag="only")
    if where == "manifest":
        man_path = os.path.join(ckpt, "only", tint.MANIFEST_FILE)
        man = json.load(open(man_path))
        first = next(iter(man["leaves"]))
        man["leaves"][first]["crc32"] ^= 1
        tint.write_json_atomic(man_path, man)
    else:  # one flipped byte in a leaf's file
        adir = os.path.join(ckpt, "only", tce.ARRAYS_DIR)
        index = json.load(open(os.path.join(adir, tce.INDEX_FILE)))
        fname = os.path.join(adir, index["['params']['embed']['tok']"]["file"])
        data = bytearray(open(fname, "rb").read())
        data[100] ^= 0x40
        open(fname, "wb").write(bytes(data))
    with pytest.raises(tint.TornCheckpointError, match="integrity verification"):
        _engine(seed=1).load_checkpoint(ckpt, tag="only")
    # verification is opt-out for forensics
    path, _ = _engine(seed=1).load_checkpoint(ckpt, tag="only", verify_integrity=False)
    assert path is not None


def test_async_save_is_not_reached_by_the_next_step(tmp_path, monkeypatch):
    """The async writer is held until the saving engine has taken another
    step, which updates every buffer in place: the tag must still hold the
    state at the save, bit for bit."""
    gate = threading.Event()
    real = tce._write_arrays

    def held(*args, **kwargs):
        assert gate.wait(30), "the test never released the writer"
        return real(*args, **kwargs)

    monkeypatch.setattr(tce, "_write_arrays", held)
    eng = _engine(async_save=True)
    _train(eng, 3)
    at_save = _state(eng)
    at_save = {k: v.clone() for k, v in at_save.items()}
    eng.save_checkpoint(str(tmp_path))
    _train(eng, 1)
    moved = _state(eng)
    assert not torch.equal(moved["['params']['embed']['tok']"], at_save["['params']['embed']['tok']"])
    assert not os.path.exists(os.path.join(str(tmp_path), "latest"))  # not durable yet
    gate.set()
    eng.checkpoint_engine.wait()
    fresh = _engine(seed=1)
    fresh.load_checkpoint(str(tmp_path))
    got = _state(fresh)
    for key, want in at_save.items():
        assert torch.equal(got[key], want), key


def test_async_fence_never_commits_a_torn_tag_later(tmp_path):
    """A commit that dies at the fence leaves the tag markerless for good:
    a later fence does not place the marker and ``latest`` never names the
    tag."""
    eng = _engine(async_save=True)
    ckpt = str(tmp_path)
    _train(eng, 1)
    eng.save_checkpoint(ckpt)
    eng.checkpoint_engine.wait()
    _train(eng, 1)

    def tear(point, info):
        if point == "checkpoint_write":
            raise RuntimeError("writer died")

    eng.fault_hook = tear
    eng.save_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="writer died"):
        eng.checkpoint_engine.wait()
    eng.fault_hook = None
    eng.checkpoint_engine.wait()
    assert not tint.is_committed(os.path.join(ckpt, "global_step2"))
    assert open(os.path.join(ckpt, "latest")).read() == "global_step1"
    assert tint.latest_committed_tag(ckpt) == "global_step1"


def test_use_ocdbt_is_refused_naming_it():
    with pytest.raises(NotImplementedError, match="use_ocdbt"):
        tce.TorchCheckpointEngine(use_ocdbt=True)


# ---------------------------------------------------------------------------
# tensor fragments
# ---------------------------------------------------------------------------


def test_tensor_fragment_reads_and_writes_whole_tensors():
    eng = _engine("bfloat16", CASES["bf16"][1])
    _train(eng, 1)
    name = "layers.1.mlp.wi"
    i = eng._leaf_names.index(name)
    master = tfrag.safe_get_full_fp32_param(eng, name)
    assert master.dtype == torch.float32 and torch.equal(master, eng._base_leaves[i])
    assert torch.equal(tfrag.safe_get_full_optimizer_state(eng, "layers[1].mlp.wi", "exp_avg"),
                       eng.opt_state.exp_avg[i])
    assert torch.equal(tfrag.safe_get_full_grad(eng, name), eng.grad_acc[i])
    assert tfrag.safe_get_full_fp32_param(eng, "layers.9.mlp.wi") is None
    assert tfrag.safe_get_full_optimizer_state(eng, name, "nope") is None
    (frag,) = tfrag.get_hp_fragment_mapping(eng._base_leaves[i])
    assert frag.shape == tuple(master.shape) and frag.device == "cpu"
    assert tfrag.safe_set_full_fp32_param(eng, name, torch.ones_like(master))
    assert float(eng._base_leaves[i].min()) == 1.0  # in place: the optimizer's alias
    assert not tfrag.safe_set_full_fp32_param(eng, "nope.w", master)


# ---------------------------------------------------------------------------
# 3. across packages: the reference's snapshot continued by the port
# ---------------------------------------------------------------------------


def _run_steps(engine, steps, to_float):
    losses, lrs = [], []
    for step in steps:
        lrs.append(engine.get_lr()[0])
        for micro in range(GAS):
            loss = engine.forward(_data(step, micro))
            engine.backward(loss)
            engine.step()
            losses.append(to_float(loss))
    return losses, lrs


def _counters(engine):
    return (engine.global_steps, engine.micro_steps, engine.global_samples, engine.skipped_steps)


@pytest.fixture(scope="module")
def reference_snapshot():
    comm.destroy()
    try:
        jcfg = jtf.TransformerConfig(**CFG)
        params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(3), jcfg))
        engine = deepspeed_tpu.initialize(model=jtf.TransformerModel(jcfg),
                                          params=jax.tree.map(jnp.asarray, params),
                                          config=_engine_config(BATCH // 8))[0]
        _, first_lrs = _run_steps(engine, range(3), float)
        host_tree, meta, manifest = engine.host_state_snapshot()
        counters = _counters(engine)
        losses, lrs = _run_steps(engine, range(3, 6), float)
        out = {"host_tree": host_tree, "meta": meta, "counters_at_snapshot": counters,
               "losses": losses, "lrs": lrs, "first_lrs": first_lrs, "counters": _counters(engine),
               "final": jax.tree.map(np.asarray, engine.params)}
    finally:
        comm.destroy()
    return out


def test_reference_snapshot_continues_in_the_port(reference_snapshot):
    ref = reference_snapshot
    engine = deepspeed_tpu_torch.initialize(
        model=ttf.TransformerModel(ttf.TransformerConfig(**CFG)), config=_engine_config(BATCH),
        device="cpu", seed=7)[0]
    tree, meta = state_from_reference_snapshot(ref["host_tree"], ref["meta"], engine.model.cfg,
                                               "cpu")
    engine.restore_from_host_state(tree, meta)
    assert _counters(engine) == ref["counters_at_snapshot"]
    assert engine.opt_state.step == 3
    losses, lrs = _run_steps(engine, range(3, 6), lambda x: x.item())
    assert lrs == ref["lrs"]
    assert _counters(engine) == ref["counters"]
    assert np.max(np.abs(np.array(losses) - np.array(ref["losses"]))) <= ENGINE_LOSS_TOL
    want = dict(_leaves(ref["final"]))
    got = dict(_leaves(ttf.params_to_numpy(engine.params, engine.model.cfg)))
    assert sorted(want) == sorted(got)
    # bk (zero at init): Adam turns its noise-level gradient into moves of
    # up to about lr a step on both sides, so its values are held to the sum
    # of the six steps' lrs
    lr_sum = sum(ref["first_lrs"]) + sum(lrs)
    for name, a in want.items():
        if name in ZERO_GRAD_LEAVES:
            assert max(np.max(np.abs(a)), np.max(np.abs(got[name]))) <= lr_sum, name
        else:
            assert _rel(a, got[name]) <= PARAM_REL_TOL, name


# ---------------------------------------------------------------------------
# 4. the data loader against the reference's
# ---------------------------------------------------------------------------


def _dataset(n=40, seed=5):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 128, 16).astype(np.int32),
             "loss_mask": rs.rand(16).astype(np.float32)} for _ in range(n)]


def _walk(loader, batches):
    """``batches`` batches through a RepeatingLoader, with the cursor after
    each."""
    rep = loader[1](loader[0])
    out = []
    for _ in range(batches):
        b = next(rep)
        out.append((b, rep.state_dict()))
    return out


def _same_walk(a, b):
    assert len(a) == len(b)
    for (ba, ca), (bb, cb) in zip(a, b):
        assert ca == cb
        assert sorted(ba) == sorted(bb)
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])


def test_data_loader_matches_the_reference_over_two_epochs():
    ds = _dataset()
    ref = rdl.TpuDataLoader(ds, batch_size=8, seed=3)
    port = tdl.TpuDataLoader(ds, batch_size=8, seed=3)
    assert len(ref) == len(port) == 5
    _same_walk(_walk((ref, rdl.RepeatingLoader), 11), _walk((port, tdl.RepeatingLoader), 11))


def test_data_loader_cursor_and_quarantine_match_the_reference():
    ds = _dataset()
    loaders = []
    for mod in (rdl, tdl):
        first = mod.TpuDataLoader(ds, batch_size=8, seed=3)
        it = iter(first)
        next(it), next(it)
        cursor = first.state_dict()
        resumed = mod.TpuDataLoader(ds, batch_size=8, seed=3)
        resumed.load_state_dict(cursor)
        resumed.quarantine(0, 3)
        resumed.quarantine(1, 0)
        loaders.append((cursor, _walk((resumed, mod.RepeatingLoader), 6), resumed.state_dict()))
    (c_ref, w_ref, s_ref), (c_port, w_port, s_port) = loaders
    assert c_ref == c_port == {"epoch": 0, "batch": 2, "seed": 3}
    _same_walk(w_ref, w_port)
    assert s_ref == s_port and s_port["quarantined"] == [[0, 3], [1, 0]]
    with pytest.raises(ValueError, match="seed"):
        tdl.TpuDataLoader(ds, batch_size=8, seed=4).load_state_dict(c_port)


def test_initialize_with_training_data_feeds_train_batch():
    """``initialize(training_data=...)`` returns the engine's loader, and
    ``train_batch()`` reads on from it across epochs: the same losses as an
    engine handed the loader's batches in their order (two micro-batches a
    step, one epoch of 8 rows a step, reshuffled each epoch)."""
    ds = [{"input_ids": _data(0, 0)["input_ids"][i]} for i in range(8)]
    conf = dict(_config(), gradient_accumulation_steps=2)
    model = ttf.TransformerModel(ttf.TransformerConfig(**CFG))
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(model=model, config=conf, device="cpu",
                                                          training_data=ds)
    assert isinstance(loader, tdl.TpuDataLoader) and loader is engine.training_dataloader
    assert loader.batch_size == MICRO and len(loader) == 2
    fed = deepspeed_tpu_torch.initialize(model=model, config=conf, device="cpu")[0]
    order = tdl.TpuDataLoader(ds, batch_size=MICRO, seed=engine.config.seed)
    want = []
    for epoch in range(2):
        order.set_epoch(epoch)
        want.append(fed.train_batch(iter(list(order))).item())
    assert [engine.train_batch().item() for _ in range(2)] == want
    assert engine.global_steps == 2 and loader.epoch == 1
