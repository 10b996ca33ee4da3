"""The serving mesh of the port against the reference, on the CPU.

Three worlds of gloo ranks (``tests/torch_dist_common.serving_program``:
rank 0 drives, the other ranks run ``inference.mesh.serve_worker``) serve
tiny f32 models at tensor widths 2 and 4, and a third replays a pool with
one worker's clocks skewed and its reads delayed. The reference is the JAX
engine on a serving mesh of the same width over the conftest's 8 virtual
devices, on the same weights and inputs. The models follow the
reference's ``tests/unit/inference/test_mesh_parallel.py``: vocab 128, D 64,
2 layers, 4 heads (MHA, learned positions, tied head); a Llama of 4 heads
over 2 kv heads (rope, RMSNorm, SwiGLU, untied head): heads split at
tensor 2, the q/wo columns with every kv head at tensor 4; and a vocabulary
of 127, which no width divides, so embedding and logits stay whole (the
reference places it only through its regex table, ``use_rules``, which
clips such a dim whole; its logical placement refuses the uneven split).

Greedy streams are held to the reference's under the tie rule of
``tests/torch_serving_common.py`` (equal, or first differing where the
reference's top-2 margin is under 1e-4): ``generate`` fused and per token,
ragged and chunked prefill, ``generate`` with a draft, the pool at depths
0-2, separate prefill and bursts, bucketed pools, the prefix splice, and
the n-gram and draft speculative pools. ``{"tensor": 1}`` is bit for bit
the engine without a mesh; sampled streams are bit for bit across widths
and depths (the keyed sampler sees gathered logits; the reference's
threefry draws cannot be matched). Placements, ``MeshConfig``,
``serving_mesh`` and the per-chip ``kv_bytes_read`` equal the reference's;
the degrade ladder's recovered streams equal the fault-free run's bit for
bit. The loadgen's ``--ab-mesh --mesh 1:2 --mesh-out`` runs green.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.continuous import ContinuousBatchingEngine as JPool
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import partition as jpart
from deepspeed_tpu.serving import loadgen as jload
from deepspeed_tpu_torch.inference.config import InferenceConfig as TConfig
from deepspeed_tpu_torch.serving import loadgen as tload
from torch_dist_common import run_world

TIE = 1e-4
FLOOR = 16
MHA = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128,
           dtype="float32")
GQA = dict(MHA, num_kv_heads=2, pos_embedding="rope", norm_type="rmsnorm",
           activation="silu_glu", use_bias=False, tie_embeddings=False)
ODD = dict(MHA, vocab_size=127)
DRAFT = dict(MHA, num_layers=1)
SAMPLED = dict(temperature=0.8, top_k=8, seed=3)
ATTN_WHOLE = [["attn/", []]]


def _params(cfg_kw, seed=0):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed),
                                               jtf.TransformerConfig(**cfg_kw)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


PARAMS = {}


def params_of(name):
    if name not in PARAMS:
        PARAMS[name] = _params({"mha": MHA, "gqa": GQA, "odd": ODD, "draft": DRAFT}[name],
                               seed={"mha": 0, "gqa": 1, "odd": 2, "draft": 3}[name])
    return PARAMS[name]


CFGS = {"mha": MHA, "gqa": GQA, "odd": ODD, "draft": DRAFT}


def _prompts(ns, seed=0, vocab=128):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).astype(np.int32) for n in ns]


SUBS = list(zip((0, 0, 1, 3), _prompts((5, 20, 9, 7), 1), (12, 10, 24, 8)))
TOKS = np.stack(_prompts((9, 9), 7))
MASK = np.ones((2, 9), np.int64)
MASK[0, :3] = 0


def _gen(model, tensor, fused=True, trace=None, **kw):
    return dict(kind="generate", cfg=CFGS[model], params=params_of(model), tensor=tensor,
                fused=fused, tokens=TOKS, new=kw.pop("new", 12), trace=trace, **kw)


def _pool(model, tensor, depth=1, **kw):
    pool_kw = dict(max_slots=3, cache_len=64, pipeline_depth=depth)
    pool_kw.update(kw.pop("kw", {}))
    return dict(kind="pool", cfg=CFGS[model], params=params_of(model), tensor=tensor,
                subs=kw.pop("subs", SUBS), kw=pool_kw, **kw)


def _draft():
    return dict(cfg=DRAFT, params=params_of("draft"))


def _ngram_config():
    return {"speculative": {"enabled": True, "pool": True, "mode": "ngram",
                            "num_draft_tokens": 3}}


def _draft_config():
    return {"speculative": {"enabled": True, "pool": True, "mode": "draft",
                            "num_draft_tokens": 2}}


def _world2_cases(tmp):
    prefix = np.arange(1, 11, dtype=np.int32)
    cases = {
        "meshes": dict(kind="meshes", shapes=[(1, 1), (1, 2), (4, 4), (1, 3)]),
        "gen_none": _gen("mha", None), "gen_t1": _gen("mha", 1),
        "gen_loop_none": _gen("mha", None, fused=False),
        "gen_loop_t1": _gen("mha", 1, fused=False),
        "gen_t2": _gen("mha", 2, trace=os.path.join(tmp, "gen_t2.jsonl"), forward=True),
        "gen_loop_t2": _gen("mha", 2, fused=False),
        "gen_tp_size_2": dict(_gen("mha", None), config={"tensor_parallel": {"tp_size": 2}}),
        "gen_gqa_t2": _gen("gqa", 2), "gen_gqa_loop_t2": _gen("gqa", 2, fused=False),
        "gen_odd_t2": _gen("odd", 2, mesh_extra={"use_rules": True}),
        "gen_rules_t2": _gen("mha", 2, mesh_extra={"rules": ATTN_WHOLE, "use_rules": True}),
        "gen_overlay_t2": _gen("mha", 2, mesh_extra={"rules": ATTN_WHOLE}),
        "gen_ragged_t2": _gen("mha", 2, kw={"attention_mask": MASK}),
        "gen_chunked_t2": _gen("mha", 2, config={"prefill_chunk_size": 4}),
        "gen_draft_t2": _gen("mha", 2, draft=_draft()),
        "gen_sampled_none": _gen("mha", None, kw={"temperature": 0.8, "top_k": 8}),
        "gen_sampled_t2": _gen("mha", 2, kw={"temperature": 0.8, "top_k": 8}),
        "pool_none": _pool("mha", None), "pool_t1": _pool("mha", 1),
        "pool_t2_d0": _pool("mha", 2, 0), "pool_t2_d1": _pool("mha", 2, 1),
        "pool_t2_d2": _pool("mha", 2, 2),
        "pool_gqa_t2": _pool("gqa", 2),
        "pool_sep_t2": _pool("mha", 2, kw={"fused_prefill": False}),
        "pool_burst_t2": _pool("mha", 2, kw={"fused_prefill": False, "tokens_per_tick": 4}),
        "pool_buckets_t2": _pool("mha", 2, kw={"max_slots": None, "cache_len": None,
                                               "cache_buckets": [(2, 32), (2, 64)]}),
        "prefix_t2": _pool("mha", 2, prefix=prefix,
                           subs=[(0, s, 10) for s in _prompts((4, 6), 5)]),
        "ngram_t2": _pool("mha", 2, config=_ngram_config()),
        "draft_t2": _pool("mha", 2, config=_draft_config(), draft=_draft()),
        "sampled_none": _pool("mha", None, kw=dict(SAMPLED)),
        "sampled_t2_d0": _pool("mha", 2, 0, kw=dict(SAMPLED)),
        "sampled_t2_d2": _pool("mha", 2, 2, kw=dict(SAMPLED)),
        "kv_t2": _pool("mha", 2, kw={"max_slots": 1}, trace=os.path.join(tmp, "kv_t2.jsonl"),
                       subs=[(0, np.arange(2, 9, dtype=np.int32), 12)]),
    }
    t2 = {"mesh": {"shape": {"data": 1, "tensor": 2}}}
    cases["refusals"] = dict(kind="refusals", tries={
        "int8_weights": (MHA, dict(t2, dtype="int8")),
        "block_sparse": (dict(MHA, attn_impl="block_sparse"), t2),
        "data_axis": (MHA, {"mesh": {"shape": {"data": 2, "tensor": 1}}}),
        "norm_split": (MHA, {"mesh": {"shape": {"data": 1, "tensor": 2}, "use_rules": True,
                                      "rules": [["ln1/scale$", ["tensor"]]]}}),
        "tensor_1_int8": (MHA, {"mesh": {"shape": {"data": 1, "tensor": 1}}, "dtype": "int8"}),
    })
    serve = dict(kind="serve", cfg=MHA, params=params_of("mha"), tensor=2,
                 kw=dict(max_slots=3, cache_len=64, **SAMPLED),
                 requests=[(p, m) for (_, p, m) in SUBS])
    cases["serve_clean_t2"] = serve
    cases["serve_degrade_t2"] = dict(serve, faults=[dict(tick=4, kind="preempt", degrade=True)],
                                     degrade=[{"data": 1, "tensor": 1}])
    cases["sources"] = dict(kind="sources", cfg=GQA, tensor=2, tokens=TOKS, new=6)
    cases["checkpoint"] = dict(kind="checkpoint", path=_hf_llama_dir(tmp), tensor=2, tokens=TOKS,
                               new=6)
    return cases


def _hf_llama_dir(tmp):
    """A tiny HF Llama (4 heads over 2 kv heads, vocab 128) saved by
    ``transformers`` in 30 kB safetensors shards."""
    import torch
    import transformers

    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, max_position_embeddings=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False))
    path = os.path.join(tmp, "hf_llama")
    model.save_pretrained(path, max_shard_size="30kB", safe_serialization=True)
    return path


def _world4_cases(tmp):
    return {
        "gen_t4": _gen("mha", 4, trace=os.path.join(tmp, "gen_t4.jsonl"), new=20),
        "gen_loop_t4": _gen("mha", 4, fused=False),
        "gen_gqa_t4": _gen("gqa", 4), "gen_gqa_loop_t4": _gen("gqa", 4, fused=False),
        "pool_t4_d0": _pool("mha", 4, 0), "pool_t4_d1": _pool("mha", 4, 1),
        "pool_t4_d2": _pool("mha", 4, 2),
        "pool_gqa_t4": _pool("gqa", 4),
        "sampled_t4_d1": _pool("mha", 4, 1, kw=dict(SAMPLED)),
    }


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh2"))
    out = run_world("serving", 2, tmp_path_factory.mktemp("world2"), None, _world2_cases(tmp))
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh4"))
    return run_world("serving", 4, tmp_path_factory.mktemp("world4"), None, _world4_cases(tmp))


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _jconfig(tensor, **extra):
    cfg = {"dtype": "float32", "kv_read_floor": FLOOR}
    if tensor is not None:
        cfg["mesh"] = {"shape": {"data": 1, "tensor": tensor}}
        cfg["mesh"].update(extra.pop("mesh_extra", {}))
    cfg.update(extra)
    return cfg


def _jengine(model, tensor, **extra):
    jcomm.destroy()
    draft = extra.pop("draft", None)
    kw = {}
    if draft is not None:
        kw = dict(draft_model=jtf.TransformerModel(jtf.TransformerConfig(**DRAFT)),
                  draft_params=params_of("draft"))
        extra.setdefault("speculative", {"enabled": True, "num_draft_tokens": 3})
    return deepspeed_tpu.init_inference(jtf.TransformerModel(jtf.TransformerConfig(**CFGS[model])),
                                        params=params_of(model), config=_jconfig(tensor, **extra),
                                        **kw)


def _jgen(model, tensor, fused=True, new=12, **kw):
    extra = {"fused_generate": fused}
    extra.update(kw.pop("config", {}))
    for key in ("mesh_extra", "draft"):
        if key in kw:
            extra[key] = kw.pop(key)
    eng = _jengine(model, tensor, **extra)
    out = eng.generate(TOKS, max_new_tokens=new, **kw)
    jax.block_until_ready(out)
    return np.asarray(out), eng


def _jpool(model, tensor, depth=1, subs=SUBS, prefix=None, config=None, draft=False, **kw):
    jcomm.destroy()
    pool_kw = dict(max_slots=3, cache_len=64, pipeline_depth=depth, donate_cache=False)
    pool_kw.update(kw)
    if draft:
        pool_kw.update(draft_model=jtf.TransformerModel(jtf.TransformerConfig(**DRAFT)),
                       draft_params=params_of("draft"))
    cb = JPool(jtf.TransformerModel(jtf.TransformerConfig(**CFGS[model])),
               params=params_of(model), config=_jconfig(tensor, **(config or {})), **pool_kw)
    results, rid_of, pending, tick = {}, {}, list(enumerate(subs)), 0
    pid = cb.register_prefix(prefix) if prefix is not None else None
    while pending or cb.has_work():
        for i, (at, prompt, new) in [x for x in pending if x[1][0] <= tick]:
            rid_of[i] = (cb.submit_with_prefix(pid, prompt, max_new_tokens=new)
                         if pid is not None else cb.submit(prompt, max_new_tokens=new))
        pending = [x for x in pending if x[1][0] > tick]
        cb.step()
        results.update(cb.finished())
        tick += 1
    return [np.asarray(results[rid_of[i]]) for i in range(len(subs))]


def _assert_agrees(model, ref, port, prompt, what):
    """``port`` (prompt + stream) equals ``ref``, or first differs where
    the reference's top-2 logit margin is under TIE."""
    ref, port = np.asarray(ref).reshape(-1), np.asarray(port).reshape(-1)
    if np.array_equal(ref, port):
        return
    assert ref.shape == port.shape, (what, ref, port)
    j = int(np.nonzero(ref != port)[0][0])
    assert j >= len(prompt), (what, "the prompt region differs")
    logits = np.asarray(jtf.apply(params_of(model), jtf.TransformerConfig(**CFGS[model]),
                                  jnp.asarray(ref[None, :j])))[0, -1]
    top2 = np.sort(logits)[-2:]
    assert float(top2[1] - top2[0]) < TIE, (what, j, float(top2[1] - top2[0]))


def _assert_rows_agree(model, ref, port, what):
    for b in range(ref.shape[0]):
        _assert_agrees(model, ref[b], port[b], TOKS[b], f"{what} row {b}")


def _assert_streams_agree(model, ref, port, subs, what):
    assert len(ref) == len(port)
    for i, (r, p, sub) in enumerate(zip(ref, port, subs)):
        _assert_agrees(model, r, p, sub[1], f"{what} request {i}")


# ---------------------------------------------------------------------------
# placements, config, meshes
# ---------------------------------------------------------------------------

def _jspecs(eng):
    """The reference engine's param specs, clipped to its mesh as the
    port's placements are (a vocabulary the width does not divide stays
    whole)."""
    return jax.tree.map(lambda s, leaf: tuple(jpart._clip_spec_to_mesh(s.spec, leaf.shape,
                                                                       eng.mesh)),
                        eng.param_shardings, eng.params,
                        is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("case,model,tensor,extra", [
    ("gen_t2", "mha", 2, {}), ("gen_gqa_t2", "gqa", 2, {}),
    ("gen_odd_t2", "odd", 2, {"mesh_extra": {"use_rules": True}}),
    ("gen_rules_t2", "mha", 2, {"mesh_extra": {"rules": ATTN_WHOLE, "use_rules": True}}),
    ("gen_overlay_t2", "mha", 2, {"mesh_extra": {"rules": ATTN_WHOLE}}),
])
def test_placements_equal_the_reference_s(world2, case, model, tensor, extra):
    """The spec tree of every leaf is the reference engine's: the logical
    axes, the regex table under ``use_rules`` and rules laid over the
    annotations leaf by leaf; attention made whole by the rules runs whole
    on every rank, and the local shapes are each spec's blocks."""
    port = world2[0][case]["info"]
    ref = _jspecs(_jengine(model, tensor, **extra))
    flat = jax.tree_util.tree_leaves_with_path(ref, is_leaf=lambda x: isinstance(x, tuple))
    for path, spec in flat:
        keys = [p.key for p in path]
        got = port["specs"]
        for k in keys:
            got = got[k]
        assert tuple(got) == tuple(spec), (case, keys, got, spec)
    attn, mlp, embed, head = port["shard"]
    assert attn == ("whole" if "rules" in extra.get("mesh_extra", {}) else "heads")
    assert mlp and head == embed == (model != "odd")
    wqkv = port["local_shapes"]["layers"][0]["attn"]["wqkv"]
    D, hd = CFGS[model]["hidden_size"], 16
    nkv = CFGS[model].get("num_kv_heads") or 4
    split = 2 if attn == "heads" else 1
    assert wqkv == ((4 + 2 * nkv) * hd // split, D)


def test_mesh_config_and_serving_mesh_equal_the_reference_s(world2):
    for conf in ({"mesh": {"data": 1, "tensor": 2}},
                 {"mesh": {"shape": {"data": 1, "tensor": 4}, "rules": [["attn/", []]],
                           "use_rules": True}}, {"dtype": "float32"}):
        t, j = TConfig.parse(conf).mesh, JConfig.parse(conf).mesh
        assert (t.shape, t.rules, t.use_rules) == (j.shape, j.rules, j.use_rules)
    meshes = world2[0]["meshes"]
    for (d, t), got in meshes.items():
        jcomm.destroy()
        try:
            want = dict(jpart.serving_mesh(d, t, devices=jax.devices()[:2]).shape)
        except ValueError as e:
            want = str(e)
        if isinstance(want, str):
            assert isinstance(got, str) and "devices" in got and f"{d}x{t}" in got, got
        else:
            assert got == want


# ---------------------------------------------------------------------------
# generate on the mesh
# ---------------------------------------------------------------------------

def test_degenerate_mesh_is_the_engine_without_one_bit_for_bit(world2):
    r = world2[0]
    # tensor_parallel.tp_size means {"data": -1, "tensor": tp_size}: the world's two ranks
    assert r["gen_tp_size_2"]["info"]["mesh"]["tensor"] == 2
    assert r["gen_tp_size_2"]["info"]["mesh"]["data"] == 1
    assert np.array_equal(r["gen_tp_size_2"]["tokens"], r["gen_t2"]["tokens"])
    assert np.array_equal(r["gen_t1"]["tokens"], r["gen_none"]["tokens"])
    assert np.array_equal(r["gen_loop_t1"]["tokens"], r["gen_loop_none"]["tokens"])
    assert r["gen_t1"]["info"]["shard"] is None
    for a, b in zip(r["pool_t1"]["streams"], r["pool_none"]["streams"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case,model,tensor,fused", [
    ("gen_t2", "mha", 2, True), ("gen_loop_t2", "mha", 2, False),
    ("gen_gqa_t2", "gqa", 2, True), ("gen_gqa_loop_t2", "gqa", 2, False),
    ("gen_odd_t2", "odd", 2, True), ("gen_t4", "mha", 4, True),
    ("gen_loop_t4", "mha", 4, False), ("gen_gqa_t4", "gqa", 4, True),
    ("gen_gqa_loop_t4", "gqa", 4, False),
])
def test_generate_matches_the_reference_on_its_mesh(world2, world4, case, model, tensor, fused):
    port = (world2 if tensor == 2 else world4)[0][case]
    new = 20 if case == "gen_t4" else 12
    # the reference places a vocabulary the width does not divide only
    # through its regex table, which clips it whole
    extra = {"mesh_extra": {"use_rules": True}} if model == "odd" else {}
    ref, _ = _jgen(model, tensor, fused=fused, new=new, **extra)
    _assert_rows_agree(model, ref, port["tokens"], case)
    if model == "gqa":  # heads split at 2; q's columns with every kv head at 4
        assert port["info"]["shard"][0] == ("heads" if tensor == 2 else "columns")
        assert port["info"]["kv_shard_width"] == (2 if tensor == 2 else 1)


@pytest.mark.parametrize("case,kw", [
    ("gen_ragged_t2", {"attention_mask": MASK}),
    ("gen_chunked_t2", {"config": {"prefill_chunk_size": 4}}),
    ("gen_draft_t2", {"draft": True}),
    ("gen_rules_t2", {"mesh_extra": {"rules": ATTN_WHOLE, "use_rules": True}}),
])
def test_generate_paths_match_the_reference_on_the_mesh(world2, case, kw):
    kw = dict(kw)
    if kw.pop("draft", False):
        ref, jeng = _jgen("mha", 2, draft=True)
    else:
        ref, _ = _jgen("mha", 2, **kw)
    _assert_rows_agree("mha", ref, world2[0][case]["tokens"], case)


def test_sampled_generate_and_forward_are_width_free(world2):
    r = world2[0]
    assert np.array_equal(r["gen_sampled_t2"]["tokens"], r["gen_sampled_none"]["tokens"])
    jeng = _jengine("mha", 2)
    ref = np.asarray(jeng.forward(TOKS))
    np.testing.assert_allclose(r["gen_t2"]["logits"], ref, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the batching engine on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tensor", [2, 4])
def test_pool_greedy_matches_the_reference_at_every_depth(world2, world4, tensor):
    r = (world2 if tensor == 2 else world4)[0]
    ref = _jpool("mha", tensor)
    for depth in (0, 1, 2):
        _assert_streams_agree("mha", ref, r[f"pool_t{tensor}_d{depth}"]["streams"], SUBS,
                              f"pool tensor {tensor} depth {depth}")
    gqa = _jpool("gqa", tensor)
    _assert_streams_agree("gqa", gqa, r[f"pool_gqa_t{tensor}"]["streams"], SUBS,
                          f"gqa pool tensor {tensor}")


@pytest.mark.parametrize("case,kw", [
    ("pool_sep_t2", {"fused_prefill": False}),
    ("pool_burst_t2", {"fused_prefill": False, "tokens_per_tick": 4}),
    ("pool_buckets_t2", {"max_slots": None, "cache_len": None,
                         "cache_buckets": [(2, 32), (2, 64)]}),
    ("ngram_t2", {"config": _ngram_config()}),
    ("draft_t2", {"config": _draft_config(), "draft": True}),
])
def test_pool_paths_match_the_reference_on_the_mesh(world2, case, kw):
    ref = _jpool("mha", 2, **kw)
    _assert_streams_agree("mha", ref, world2[0][case]["streams"], SUBS, case)


def test_prefix_splice_matches_the_reference_on_the_mesh(world2):
    subs = [(0, s, 10) for s in _prompts((4, 6), 5)]
    ref = _jpool("mha", 2, subs=subs, prefix=np.arange(1, 11, dtype=np.int32))
    _assert_streams_agree("mha", ref, world2[0]["prefix_t2"]["streams"], subs, "prefix")


def test_sampled_pool_streams_are_bit_for_bit_across_widths_and_depths(world2, world4):
    base = world2[0]["sampled_none"]["streams"]
    for run in (world2[0]["sampled_t2_d0"], world2[0]["sampled_t2_d2"],
                world4[0]["sampled_t4_d1"]):
        for a, b in zip(base, run["streams"]):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# per-chip accounting
# ---------------------------------------------------------------------------

def test_per_chip_kv_bytes_equal_the_reference_s(world2, world4, tmp_path):
    # the batching engine's event at tensor 2
    jcomm.destroy()
    trace = tmp_path / "ref_kv.jsonl"
    cb = JPool(jtf.TransformerModel(jtf.TransformerConfig(**MHA)), params=params_of("mha"),
               config=dict(_jconfig(2), telemetry={"enabled": True, "trace_file": str(trace)}),
               max_slots=1, cache_len=64, donate_cache=False)
    rid = cb.submit(np.arange(2, 9, dtype=np.int32), max_new_tokens=12)
    while cb.has_work():
        cb.step()
    cb.finished()
    with open(trace) as fh:
        ref_ev = [json.loads(line) for line in fh if line.strip()]
    want = [e for e in ref_ev if e.get("path") == "continuous" and e.get("request") == rid][0]
    port = world2[0]["kv_t2"]
    got = [e for e in port["events"] if e.get("path") == "continuous"][0]
    assert port["info"]["kv_shard_width"] == jpart.kv_shard_width(cb.mesh, cb.cfg) == 2
    for key in ("kv_bytes_read", "kv_bytes_per_token", "kv_dtype"):
        assert got[key] == want[key], key
    # the inference engine's event at tensor 4: per-chip bytes
    jcomm.destroy()
    jtrace = tmp_path / "ref_eng.jsonl"
    jeng = deepspeed_tpu.init_inference(
        jtf.TransformerModel(jtf.TransformerConfig(**MHA)), params=params_of("mha"),
        config=dict(_jconfig(4), telemetry={"enabled": True, "trace_file": str(jtrace)}))
    jax.block_until_ready(jeng.generate(TOKS, max_new_tokens=20))
    with open(jtrace) as fh:
        want = [json.loads(line) for line in fh if line.strip()]
    want = [e for e in want if e.get("kind") == "inference_request"][-1]
    got = [e for e in world4[0]["gen_t4"]["events"] if e.get("kind") == "inference_request"][-1]
    for key in ("kv_bytes_read", "kv_bytes_per_token", "cache_len", "cache_utilization"):
        assert got[key] == want[key], key
    # heads that do not divide the width: every rank reads whole rows
    jcomm.destroy()
    gqa = _jengine("gqa", 4)
    assert world4[0]["gen_gqa_t4"]["info"]["kv_shard_width"] == \
        jpart.kv_shard_width(gqa.mesh, gqa.cfg) == 1


# ---------------------------------------------------------------------------
# the degrade ladder, skewed clocks, foreign imports, the loadgen
# ---------------------------------------------------------------------------

def test_degrade_ladder_recovers_bit_for_bit(world2):
    clean, chaos = world2[0]["serve_clean_t2"], world2[0]["serve_degrade_t2"]
    assert chaos["streams"] == clean["streams"]
    assert all(state == "finished" for state, _ in chaos["streams"].values())
    stats = chaos["recovery"]
    assert stats["rebuilds"] == 1 and stats["degrade_level"] == 1
    assert chaos["final_mesh"]["tensor"] == 1


def test_a_skewed_worker_changes_no_stream(world2, tmp_path):
    cases = {"pool_t2_d1": _world2_cases(str(tmp_path))["pool_t2_d1"],
             "sampled_t2_d0": _world2_cases(str(tmp_path))["sampled_t2_d0"]}
    skewed = run_world("serving", 2, tmp_path, None, cases, (1.0e6, 0.002))
    for name in cases:
        for a, b in zip(skewed[0][name]["streams"], world2[0][name]["streams"]):
            assert np.array_equal(a, b)
    assert skewed[1]["ops"] > 0


def test_the_remaining_refusals_name_item_8c(world2):
    """What stays out of the slice raises on a mesh wider than one rank,
    naming Queue 1 item 8 (c): int8 weights, a block-sparse model, a data
    axis, a placement the forward has no mode for. At tensor 1 int8
    weights run, as the engine without a mesh runs them."""
    said = world2[0]["refusals"]
    for name in ("int8_weights", "block_sparse", "data_axis", "norm_split"):
        assert "item 8 (c)" in said[name], (name, said[name])
    assert said["tensor_1_int8"] == "ran"


def test_each_worker_is_sent_only_its_blocks_of_the_params(world2):
    """A mesh engine from the seed: every rank draws the tree on its own
    (each leaf to the host as it is drawn) and keeps its blocks; from a
    param tree: rank 0 sends each worker its blocks alone. Both hold the
    blocks of the engine's without a mesh on that seed, and serve bit for
    bit alike."""
    r = world2[0]["sources"]
    seed, tree = r["seed"], r["tree"]
    np.testing.assert_array_equal(seed["tokens"], tree["tokens"])
    np.testing.assert_array_equal(seed["logits"], tree["logits"])
    assert seed["local_is_blocks"] and tree["local_is_blocks"]
    assert seed["sent"] == {"broadcast": 0, "own": {1: 0}}
    assert tree["sent"] == {"broadcast": 0, "own": {1: r["rank1_block_bytes"]}}
    assert r["rank1_block_bytes"] < 0.6 * r["tree_bytes"]


def test_a_checkpoint_directory_reaches_the_workers_as_its_path(world2):
    """An HF checkpoint directory on a mesh: the workers convert it on
    their own hosts (no tensor is sent), and the engine serves bit for bit
    as one built from the converter's tree."""
    r = world2[0]["checkpoint"]
    np.testing.assert_array_equal(r["dir"]["tokens"], r["tree"]["tokens"])
    np.testing.assert_array_equal(r["dir"]["logits"], r["tree"]["logits"])
    assert r["dir"]["sent"] == {"broadcast": 0, "own": {1: 0}}
    assert r["tree"]["sent"]["own"][1] > 0


def test_a_drop_queued_during_a_send_goes_with_the_next_message(monkeypatch):
    """An engine let go of while rank 0 sends (the send's pickling can run
    finalizers) is dropped on the workers with the next message, not
    lost."""
    from deepspeed_tpu_torch.inference import mesh as mesh_mod

    sent = []

    def send(commands):
        sent.append(list(commands))
        if len(sent) == 1:
            mesh_mod._QUEUED.append(("drop", 7))

    monkeypatch.setattr(mesh_mod.comm, "control_send", send)
    monkeypatch.setattr(mesh_mod, "_QUEUED", [("drop", 6)])
    mesh_mod._send(("call", 1))
    mesh_mod._send(("call", 2))
    assert sent == [[("drop", 6), ("call", 1)], [("drop", 7), ("call", 2)]]
    assert mesh_mod._QUEUED == []


def test_no_rank_imports_jax_or_the_reference(world2, world4):
    for rank in world2 + world4:
        assert rank["foreign_modules"] == []
    assert all(r["ops"] > 0 for r in world2[1:] + world4[1:])


def test_loadgen_mesh_record_and_ab_equal_the_reference_s(tmp_path, capsys):
    """``--ab-mesh --mesh 1:2 --mesh-out`` starts its two ranks, serves the
    workload at both widths and writes the record; the record and the A/B
    scorecard of its summaries equal the reference's functions' (but the
    device's kind and count)."""
    out = tmp_path / "mesh.json"
    rc = tload.main(["--device", "cpu", "--preset", "toy", "--requests", "6", "--rate", "50",
                     "--mesh", "1:2", "--ab-mesh", "--mesh-out", str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    assert record["kind"] == "serving_mesh_ab" and set(record["meshes"]) == {"1x1", "1x2"}
    assert record["n_devices"] == 2 and record["device_kind"] == "cpu"
    summaries = record["summaries"]
    for key in ("1x1", "1x2"):
        assert summaries[key]["outcomes"] == {"finished": 6}
    t = tload.mesh_record(summaries, record["workload"], device="cpu")
    j = jload.mesh_record(summaries, record["workload"])
    assert {k: v for k, v in t.items() if k not in ("device_kind", "n_devices")} == \
        {k: v for k, v in j.items() if k not in ("device_kind", "n_devices")}
    assert tload.format_mesh_ab(summaries) == jload.format_mesh_ab(summaries)
