"""The port's Mixture-of-Experts against the reference's, on the CPU.

1. Gating (``moe/sharded_moe``): ``compute_capacity``, ``_assign_positions``
   (token order and a given priority), ``_load_balance_loss`` and
   ``topk_gating`` at k 1 and 2 with drops, with ample capacity and with
   ``drop_tokens=False``, on the same f32 logits: the capacity, the
   positions, the dispatch mask and the expert counts exactly, the combine
   weights and the aux loss within 2 f32 ulps (the softmax's exp and the
   means' summation order are the libraries' own).
2. ``moe_forward`` and ``MoE.apply`` (with ``use_residual``) within 1e-6 of
   the reference's on the same inputs and weights (the expert products are
   matmuls in another summation order), with the routing token for token: a
   token whose top-2 router logits lie within 1e-5 of each other may route
   either way (the router's f32 product rounds differently), and is reported
   as a tie, not failed.
3. The model: the loss within 1e-5 and every gradient within 1e-4 of its
   leaf's max against ``jax.value_and_grad`` of the reference's
   ``loss_fn`` (top-1 with drops, top-2 with PR-MoE), and the MoE block in
   bf16 (top-1, and top-2 PR-MoE with SwiGLU experts; the gate rounded to
   bf16 before the f32 router product, as the reference's ``_cast_layers``
   rounds it) within 2 bf16 ulps of the block's largest output.
4. The engine's loss stream within 5e-5 and its final params within 1e-4 of
   each leaf's max against ``deepspeed_tpu.initialize``. Adam normalises
   each entry by the root of its second moment, so an entry whose gradient
   is below what the gradient check pins (1e-4 of its leaf's max) moves by
   up to about lr a step on either side whatever its rounding: such entries
   (an expert unit that gelu leaves near 0 for the few tokens it gets) are
   held to the sum of the lrs instead.
5. Two-rank gloo worlds (``tests/torch_dist_common.moe_program``) against
   the reference engine on a 2-device mesh: ``{"data": 2}`` top-1 with
   drops (the capacity, the positions and the aux loss over the global
   batch), ``{"expert": 2}`` top-2 (each rank holding 2 of 4 experts) and
   ``{"fsdp": 2}`` at stage 3 with remat, within the ZeRO tests' bounds
   (losses rtol 2e-4, params 5e-4 of each leaf's max).
6. Serving: greedy ``generate`` on the fused and per-token paths against
   the reference's ``InferenceEngine``, its ``test_e1_matches_dense`` and
   ``test_routed_decode_matches_full_forward`` set-ups, and the refusals.
7. A world-1 MoE checkpoint round trip bit for bit, through
   ``zero_to_fp32`` and the universal checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from torch_dist_common import run_world

LOSS_TOL, GRAD_REL_TOL = 1e-5, 1e-4
ENGINE_LOSS_TOL, PARAM_REL_TOL = 5e-5, 1e-4
TIE = 1e-5
V = 128
TINY = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
            dtype="float32", moe_num_experts=4)
VARIANTS = {
    "top1-drops": dict(moe_top_k=1, moe_capacity_factor=1.0),
    "top2-prmoe": dict(moe_top_k=2, moe_capacity_factor=1.0, moe_use_residual=True),
    "top2-swiglu-prmoe": dict(moe_top_k=2, activation="silu_glu", use_bias=False,
                              moe_use_residual=True, ffn_hidden_size=96),
}
ZERO_GRAD_LEAVES = {"layers.attn.bk"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models' CPU ops run fastest on one thread, and the suite's
    parallel workers share the cores: more threads a worker oversubscribe
    them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _cfgs(**over):
    kw = dict(TINY, **over)
    return jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)


def _params(jcfg, seed=0):
    """The reference's params with seeded noise (biases and norm scales
    away from 0 and 1)."""
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _tokens(B, S, seed=1):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def _logits(N=64, E=4, seed=3):
    return np.random.RandomState(seed).randn(N, E).astype(np.float32)


def _ulps(a, b, n=2):
    return np.abs(a - b) <= n * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))


# ---------------------------------------------------------------------------
# 1. gating
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,cf,mn,k", [(64, 8, 1.0, 4, 1), (64, 8, 2.0, 4, 1), (8, 8, 1.0, 4, 1),
                                         (64, 8, 1.0, 4, 2), (8192, 8, 1.25, 4, 1),
                                         (7, 3, 1.25, 1, 2)])
def test_compute_capacity_is_the_reference_s(n, e, cf, mn, k):
    assert tsm.compute_capacity(n, e, cf, mn, k) == jsm.compute_capacity(n, e, cf, mn, k)


@pytest.mark.parametrize("with_priority", [False, True], ids=["token-order", "priority"])
def test_assign_positions_is_the_reference_s(with_priority):
    idx = np.argmax(_logits(), axis=-1)
    mask = np.eye(4, dtype=np.float32)[idx]
    prio = np.random.RandomState(5).rand(64).astype(np.float32) if with_priority else None
    ref = np.asarray(jsm._assign_positions(jnp.asarray(mask),
                                           None if prio is None else jnp.asarray(prio)))
    got = tsm._assign_positions(torch.from_numpy(mask),
                                None if prio is None else torch.from_numpy(prio))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_load_balance_loss_is_the_reference_s():
    logits = _logits()
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    mask = np.eye(4, dtype=np.float32)[np.argmax(logits, -1)]
    ref = float(jsm._load_balance_loss(jnp.asarray(gates), jnp.asarray(mask)))
    got = float(tsm._load_balance_loss(torch.from_numpy(gates), torch.from_numpy(mask)))
    assert _ulps(np.float32(got), np.float32(ref))


GATING = {"drops": dict(capacity_factor=0.5, min_capacity=1),
          "ample": dict(capacity_factor=4.0, min_capacity=4),
          "no-drop": dict(capacity_factor=0.5, min_capacity=1, drop_tokens=False)}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", list(GATING))
def test_topk_gating_is_the_reference_s(k, case):
    logits = _logits()
    ref = jsm.topk_gating(jnp.asarray(logits), k, **GATING[case])
    got = tsm.topk_gating(torch.from_numpy(logits), k, **GATING[case])
    r_disp = np.asarray(ref.dispatch_mask)
    assert got.capacity == r_disp.shape[2]
    np.testing.assert_array_equal(got.dispatch_mask().numpy(), r_disp)
    np.testing.assert_array_equal(got.expert_counts.numpy(), np.asarray(ref.expert_counts))
    assert np.all(_ulps(got.combine_weights().numpy(), np.asarray(ref.combine_weights)))
    assert _ulps(np.float32(got.aux_loss.item()), np.float32(ref.aux_loss))
    dropped = (r_disp.sum(axis=(1, 2)) < k).sum()
    assert (dropped > 0) == (case == "drops"), dropped


def _routing(gate_dispatch):
    """(N, E) 0/1: the experts each token was dispatched to."""
    return np.asarray(gate_dispatch).any(axis=2)


def _check_routing(ref_disp, got_disp, logits):
    """Token-for-token routing, a mismatch at a top-2 margin under TIE
    reported as a tie."""
    bad = np.nonzero((_routing(ref_disp) != _routing(got_disp)).any(axis=1))[0]
    if len(bad) == 0:
        return
    top2 = np.sort(logits[bad], axis=-1)[:, -2:]
    margin = float(np.min(top2[:, 1] - top2[:, 0]))
    if margin < TIE:
        pytest.skip(f"tie: a token's top-2 router logits {margin:.2e} apart")
    raise AssertionError(f"tokens {bad.tolist()} route apart (margin {margin:.3g})")


def _mlp_expert_params(D=32, F=64, E=4, seed=4):
    rs = np.random.RandomState(seed)
    return {"wi": (rs.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
            "wo": (rs.randn(E, F, D) / np.sqrt(F)).astype(np.float32)}


@pytest.mark.parametrize("k", [1, 2])
def test_moe_forward_matches_reference(k):
    rs = np.random.RandomState(6)
    x = rs.randn(2, 16, 32).astype(np.float32)
    gate = (rs.randn(32, 4) * 0.5).astype(np.float32)
    ep = _mlp_expert_params()
    kw = dict(k=k, capacity_factor=1.0, min_capacity=1)
    jexp, texp = jlayer.MLPExpert(32, 64), tlayer.MLPExpert(32, 64)
    ref_out, ref_aux, ref_counts = jsm.moe_forward(
        jnp.asarray(x), jnp.asarray(gate), jexp.apply, jax.tree.map(jnp.asarray, ep), **kw)
    out, aux, counts = tsm.moe_forward(torch.from_numpy(x), torch.from_numpy(gate), texp.apply,
                                       {n: torch.from_numpy(a) for n, a in ep.items()}, **kw)
    logits = x.reshape(-1, 32) @ gate
    ref_gate = jsm.topk_gating(jnp.asarray(logits), k, capacity_factor=1.0, min_capacity=1)
    got_gate = tsm.topk_gating(torch.from_numpy(logits), k, capacity_factor=1.0, min_capacity=1)
    _check_routing(ref_gate.dispatch_mask, got_gate.dispatch_mask(), logits)
    assert (np.asarray(ref_gate.dispatch_mask).sum(axis=(1, 2)) < k).any()  # drops happen
    assert np.max(np.abs(out.numpy() - np.asarray(ref_out))) <= 1e-6
    assert abs(aux.item() - float(ref_aux)) <= 1e-6
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))


def test_moe_forward_top1_f32_is_the_einsum_bit_for_bit():
    """At top-1 in f32 each einsum sum has one term that is not zero: the
    gathers give the reference's dense dispatch and combine exactly."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.randn(32, 16).astype(np.float32))
    gate = torch.from_numpy(rs.randn(16, 4).astype(np.float32))
    eo = {}

    def expert(p, t):
        eo["in"] = t
        eo["out"] = torch.tanh(t) * 3.0
        return eo["out"]

    out, _, _ = tsm.moe_forward(x, gate, expert, {}, k=1, capacity_factor=1.0, min_capacity=1)
    g = tsm.topk_gating(x @ gate, 1, capacity_factor=1.0, min_capacity=1)
    disp, comb = g.dispatch_mask().float(), g.combine_weights()
    assert torch.equal(eo["in"], torch.einsum("nec,nd->ecd", disp, x))
    assert torch.equal(out, torch.einsum("ecf,nec->nf", eo["out"], comb))


@pytest.mark.parametrize("use_residual", [False, True], ids=["plain", "pr-moe"])
def test_moe_layer_apply_matches_reference(use_residual):
    kw = dict(hidden_size=32, num_experts=4, k=2, capacity_factor=1.0, ffn_size=64,
              use_residual=use_residual)
    jmoe, tmoe = jlayer.MoE(**kw), tlayer.MoE(**kw)
    params = jax.tree.map(np.asarray, jmoe.init(jax.random.PRNGKey(2)))
    rs = np.random.RandomState(9)
    params = jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)
    x = rs.randn(2, 8, 32).astype(np.float32)
    ref_out, ref_aux, _ = jmoe.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    out, aux, _ = tmoe.apply(jax.tree.map(torch.from_numpy, params), torch.from_numpy(x))
    assert np.max(np.abs(out.numpy() - np.asarray(ref_out))) <= 1e-6
    assert abs(aux.item() - float(ref_aux)) <= 1e-6
    # the port's own init: the reference's shapes
    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    mine = jax.tree.map(lambda t: tuple(t.shape), tmoe.init(torch.Generator().manual_seed(0)))
    assert mine == shapes


# ---------------------------------------------------------------------------
# 3. the model
# ---------------------------------------------------------------------------

def _port_loss_and_grads(tcfg, np_params, tokens):
    tparams = ttf.params_from_numpy(np_params, tcfg, "cpu")
    ttf.map_params(lambda p: p.requires_grad_(True), tparams)
    loss = ttf.loss_fn(tparams, tcfg, {"input_ids": torch.from_numpy(tokens).long()})
    loss.backward()
    grads = ttf.map_params(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tparams)
    return loss.item(), dict(_leaves(ttf.params_to_numpy(grads, tcfg)))


def _assert_grads_match(ref, got):
    assert sorted(ref) == sorted(got)
    largest = max(float(np.max(np.abs(g))) for g in ref.values())
    for name, g in ref.items():
        assert got[name].shape == g.shape, name
        d = float(np.max(np.abs(got[name] - g)))
        bound = largest if name in ZERO_GRAD_LEAVES else float(np.max(np.abs(g)))
        assert d <= GRAD_REL_TOL * bound, (name, d)


def reference_value_and_grad(jcfg, np_params, tokens):
    vag = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {"input_ids": jnp.asarray(tokens)})))
    # finished before the port's side runs (ROADMAP Queue 3)
    loss, grads = jax.block_until_ready(vag(jax.tree.map(jnp.asarray, np_params)))
    return float(loss), dict(_leaves(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("variant", ["top1-drops", "top2-prmoe"])
def test_loss_and_every_grad_match_reference(variant):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    np_params, tokens = _params(jcfg), _tokens(2, 16)
    jloss, ref = reference_value_and_grad(jcfg, np_params, tokens)
    loss, got = _port_loss_and_grads(tcfg, np_params, tokens)
    assert abs(jloss - loss) <= LOSS_TOL
    _assert_grads_match(ref, got)
    assert set(got) >= {"layers.mlp.gate", "layers.mlp.wi", "layers.mlp.wo"}


@pytest.mark.parametrize("variant", ["top1-drops", "top2-swiglu-prmoe"])
def test_the_bf16_moe_block_matches_reference(variant):
    """The MoE block on the same bf16 input and bf16 weights (the gate too,
    as the reference's ``_cast_layers`` rounds it): the router's f32 logits
    exactly, the routing token for token, the output within 2 bf16 ulps of
    its largest entry."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant], dtype="bfloat16")
    np_params = _params(jcfg)
    mlp = {k: v[0] for k, v in np_params["layers"]["mlp"].items()}
    jmlp = jtf._cast_layers(jax.tree.map(jnp.asarray, mlp), jnp.bfloat16)
    h = jnp.asarray(np.random.RandomState(2).randn(2, 16, 64), jnp.bfloat16)
    ref_out, ref_aux = jax.jit(lambda h_, p_: jtf._mlp_block(h_, p_, jcfg))(h, jmlp)
    tmlp = ttf.params_from_numpy(np_params, tcfg, "cpu")["layers"][0]["mlp"]
    tmlp = {k: v.to(torch.bfloat16) for k, v in tmlp.items()}
    th = torch.from_numpy(np.asarray(h.astype(jnp.float32))).to(torch.bfloat16)
    out, aux = ttf._mlp_block(th, tmlp, tcfg)
    logits = np.asarray(h.astype(jnp.float32)).reshape(-1, 64) @ np.asarray(
        jmlp["gate"].astype(jnp.float32))
    got_logits = (th.reshape(-1, 64).float() @ tmlp["gate"].float()).numpy()
    np.testing.assert_allclose(got_logits, logits, rtol=1e-6, atol=1e-6)
    k = jcfg.moe_top_k
    ref_gate = jsm.topk_gating(jnp.asarray(logits), k, capacity_factor=1.0, min_capacity=4)
    got_gate = tsm.topk_gating(torch.from_numpy(logits), k, capacity_factor=1.0, min_capacity=4)
    _check_routing(ref_gate.dispatch_mask, got_gate.dispatch_mask(), logits)
    r = np.asarray(ref_out.astype(jnp.float32))
    assert out.dtype == torch.bfloat16
    bf16_ulp = 2.0 ** (np.floor(np.log2(np.max(np.abs(r)))) - 7)
    assert np.max(np.abs(out.float().numpy() - r)) <= 2 * bf16_ulp
    assert abs(aux.item() - float(ref_aux)) <= 1e-6


def test_num_params_and_flops_match_reference():
    for variant in VARIANTS:
        jcfg, tcfg = _cfgs(**VARIANTS[variant])
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.flops_per_token(1024) == jcfg.flops_per_token(1024)
        if variant != "top2-swiglu-prmoe":
            continue
        shapes = dict(_leaves(ttf.reference_shapes(tcfg)))
        ref = dict(_leaves(jax.tree.map(lambda a: np.zeros(a.shape), jax.eval_shape(
            lambda: jtf.init(jax.random.PRNGKey(0), jcfg)))))
        assert {k: tuple(v) for k, v in shapes.items()} == {k: v.shape for k, v in ref.items()}
        assert sum(int(np.prod(v)) for v in shapes.values()) == tcfg.num_params()


def test_logical_specs_are_the_reference_s():
    jcfg, tcfg = _cfgs(**VARIANTS["top2-prmoe"])
    abstract = jax.eval_shape(lambda: jtf.init(jax.random.PRNGKey(0), jcfg))
    ref = dict(_leaves(jax.tree.map(lambda s: np.asarray(s, dtype=object),
                                    jtf.logical_specs(abstract, jcfg),
                                    is_leaf=lambda x: isinstance(x, tuple))))
    got = ttf.logical_specs(ttf.reference_shapes(tcfg), tcfg)
    got = {f"layers.mlp.{k}": v for k, v in got["layers"]["mlp"].items()}
    for name, spec in got.items():
        assert tuple(spec) == tuple(ref[name]), name


# ---------------------------------------------------------------------------
# 4. the engine
# ---------------------------------------------------------------------------

LR, STEPS = 3e-3, 3
ENGINE_CASES = {
    "top1-drops": dict(VARIANTS["top1-drops"]),
    "top2-prmoe-remat": dict(VARIANTS["top2-prmoe"], remat=True,
                             remat_policy="dots_with_no_batch_dims"),
}


def _engine_config(**over):
    conf = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    conf.update(over)
    return conf


def _batches(n=STEPS, B=2, S=16, seed=7):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, V, (B, S)).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_stream_matches_reference(case):
    jcfg, tcfg = _cfgs(**ENGINE_CASES[case])
    np_params, batches = _params(jcfg), _batches()
    jcomm.destroy()
    try:
        mesh = jcomm.build_mesh({"data": 1}, devices=jax.devices()[:1])
        je = deepspeed_tpu.initialize(model=jtf.TransformerModel(jcfg), config=_engine_config(),
                                      params=jax.tree.map(jnp.asarray, np_params), mesh=mesh)[0]
        ref_losses = []
        for batch in batches:
            loss = je.forward(batch)
            je.backward(loss)
            je.step()
            ref_losses.append(float(jax.block_until_ready(loss)))
        ref = dict(_leaves(jax.tree.map(np.asarray, je.params)))
    finally:
        jcomm.destroy()
    te = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(tcfg), config=_engine_config(),
                                        params=np_params, device="cpu")[0]
    losses, tiny, state = [], {}, te._state
    for batch in batches:
        loss = te.forward(batch)
        te.backward(loss)
        # the entries whose gradient the gradient check does not pin
        grads = state.leaf_tree(lambda path: state.full_leaf(path, "grad"))
        for name, g in _leaves(ttf.params_to_numpy(grads, tcfg)):
            tiny[name] = (np.abs(g) <= GRAD_REL_TOL * np.abs(g).max()) | tiny.get(name, False)
        te.step()
        losses.append(loss.item())
    assert np.max(np.abs(np.array(losses) - np.array(ref_losses))) <= ENGINE_LOSS_TOL
    got = dict(_leaves(ttf.params_to_numpy(te.gathered_params(), tcfg)))
    assert sorted(got) == sorted(ref)
    for name, a in ref.items():
        d = np.abs(got[name] - a)
        if name in ZERO_GRAD_LEAVES:
            assert d.max() <= 2 * STEPS * LR, name
            continue
        pinned = ~tiny[name]
        assert d[pinned].max() <= PARAM_REL_TOL * np.abs(a).max(), name
        assert d.max() <= PARAM_REL_TOL * np.abs(a).max() + 2 * STEPS * LR, name


def test_the_training_refusals_name_item_10():
    _, tcfg = _cfgs(moe_use_rts=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        ttf.check_trainable(tcfg)
    _, tcfg = _cfgs()
    params = ttf.init(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(NotImplementedError, match="item 10"):
        ttf._mlp_block(torch.zeros(1, 2, 64), params["layers"][0]["mlp"], tcfg,
                       tp=object())


# ---------------------------------------------------------------------------
# 5. two-rank gloo worlds against the reference engine on 2 devices
# ---------------------------------------------------------------------------

DIST_STEPS, DIST_MICRO, DIST_SEQ = 2, 2, 16
DIST_PARAM_TOL = 5e-4
DIST_CASES = {
    "data2_top1_drops": dict(cfg=dict(VARIANTS["top1-drops"]), mesh={"data": 2}, stage=0),
    "expert2_top2": dict(cfg=dict(VARIANTS["top2-prmoe"]), mesh={"expert": 2}, stage=0),
    "fsdp2_stage3_remat": dict(cfg=dict(VARIANTS["top1-drops"], remat=True), mesh={"fsdp": 2},
                               stage=3),
}


def _dist_config(case):
    conf = _engine_config(
        train_micro_batch_size_per_gpu=DIST_MICRO * (2 if "expert" in case["mesh"] else 1),
        zero_optimization={"stage": case["stage"], "stage3_param_persistence_threshold": 0},
        mesh=case["mesh"])
    return conf


def _dist_batches():
    rs = np.random.RandomState(11)
    return [{"input_ids": rs.randint(0, V, (2 * DIST_MICRO, DIST_SEQ)).astype(np.int32)}
            for _ in range(DIST_STEPS)]


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    cases = {}
    for name, case in DIST_CASES.items():
        jcfg, _ = _cfgs(**case["cfg"])
        cases[name] = {"cfg": dict(TINY, **case["cfg"]), "config": _dist_config(case),
                       "params": _params(jcfg), "batches": _dist_batches()}
    refused = {"tensor2": (dict(TINY), _dist_config(dict(mesh={"tensor": 2}, stage=0)))}
    return run_world("moe", 2, tmp_path_factory.mktemp("moe_world"), {"data": 2}, cases, refused)


@pytest.fixture(scope="module")
def moe_reference():
    out = {}
    try:
        for name, case in DIST_CASES.items():
            jcfg, _ = _cfgs(**case["cfg"])
            jcomm.destroy()
            mesh = jcomm.build_mesh(case["mesh"], devices=jax.devices()[:2])
            engine = deepspeed_tpu.initialize(
                model=jtf.TransformerModel(jcfg), config=_dist_config(case), mesh=mesh,
                params=jax.tree.map(jnp.asarray, _params(jcfg)))[0]
            losses = []
            for batch in _dist_batches():
                loss = engine.forward(batch)
                engine.backward(loss)
                engine.step()
                losses.append(float(jax.block_until_ready(loss)))
            out[name] = {"losses": losses, "final": dict(_leaves(jax.tree.map(np.asarray,
                                                                              engine.params)))}
    finally:
        jcomm.destroy()
    return out


@pytest.mark.parametrize("name", list(DIST_CASES))
def test_two_rank_worlds_match_the_reference_engine(moe_world, moe_reference, name):
    ref = moe_reference[name]
    for rank in range(2):
        got = moe_world[rank][name]
        assert got["mesh"] == dict(got["mesh"], **DIST_CASES[name]["mesh"])
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
        have = dict(_leaves(got["final"]))
        assert sorted(have) == sorted(ref["final"])
        for key, a in ref["final"].items():
            if key in ZERO_GRAD_LEAVES:
                assert np.abs(have[key] - a).max() <= 2 * DIST_STEPS * LR, key
            else:
                assert np.abs(have[key] - a).max() <= DIST_PARAM_TOL * np.abs(a).max(), key
    if name == "expert2_top2":  # each rank holds 2 of the 4 experts
        assert moe_world[0][name]["shapes"]["layers.mlp.wi"] == (2, 2, 64, 256)
    if name == "fsdp2_stage3_remat":  # no gathered weight outlives its layer's region
        assert [moe_world[r][name]["gathered_alive_after_forward"] for r in range(2)] == [0, 0]


def test_a_rank_local_routing_is_another_number(moe_reference):
    """The data-parallel case is where a rank-local capacity, position or
    aux loss would show: the mean of the two halves' own losses (the port's
    at world 1, which the tests above hold to the reference's) differs."""
    jcfg, tcfg = _cfgs(**DIST_CASES["data2_top1_drops"]["cfg"])
    params = ttf.params_from_numpy(_params(jcfg), tcfg, "cpu")
    batch = torch.from_numpy(_dist_batches()[0]["input_ids"]).long()
    halves = [float(ttf.loss_fn(params, tcfg, {"input_ids": batch[r * DIST_MICRO:
                                                                   (r + 1) * DIST_MICRO]}))
              for r in range(2)]
    assert abs(np.mean(halves) - moe_reference["data2_top1_drops"]["losses"][0]) > 1e-4


def test_the_ranks_import_neither_jax_nor_the_reference_and_refuse_tensor_2(moe_world):
    assert all(r["foreign_modules"] == [] for r in moe_world)
    for r in moe_world:
        assert "tensor parallelism" in r["tensor2"] and "item 10" in r["tensor2"]


# ---------------------------------------------------------------------------
# 6. serving
# ---------------------------------------------------------------------------

PROMPT, NEW = 8, 12
SERVE = dict(TINY, max_seq_len=64)


def _serve_cfgs(**over):
    kw = dict(SERVE, **over)
    return jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)


def _assert_same_stream(ref, out, ref_logits, prompt=PROMPT):
    if np.array_equal(ref, out):
        return
    b, j = np.argwhere(ref[:, prompt:] != out[:, prompt:])[0]
    top2 = np.sort(ref_logits[b, prompt - 1 + j])[-2:]
    margin = float(top2[1] - top2[0])
    if margin < 1e-4:
        pytest.skip(f"tie: reference top-2 margin {margin:.2e} < 1e-4 at row {b} step {j}")
    raise AssertionError(f"streams differ at row {b} step {j} (reference margin {margin:.3g})")


@pytest.fixture(scope="module")
def serve_reference():
    jcfg, _ = _serve_cfgs(**VARIANTS["top2-prmoe"])
    params = _params(jcfg)
    toks = _tokens(2, PROMPT, seed=3)
    jcomm.destroy()
    try:
        eng = deepspeed_tpu.init_inference(jtf.TransformerModel(jcfg), params=params,
                                           config={"dtype": "float32"})
        out = np.asarray(eng.generate(jnp.asarray(toks), max_new_tokens=NEW))
        logits = np.asarray(jtf.apply(params, jcfg, jnp.asarray(out)))
    finally:
        jcomm.destroy()
    return {"params": params, "toks": toks, "out": out, "logits": logits}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-token"])
def test_generate_matches_reference(serve_reference, fused):
    _, tcfg = _serve_cfgs(**VARIANTS["top2-prmoe"])
    eng = deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(tcfg), params=serve_reference["params"], device="cpu",
        config={"dtype": "float32", "fused_generate": fused})
    out = eng.generate(serve_reference["toks"], max_new_tokens=NEW).numpy()
    assert out.shape == (2, PROMPT + NEW)
    _assert_same_stream(serve_reference["out"], out, serve_reference["logits"])


def _no_drop(E):
    # the reference's test_moe_inference set-up: routing never drops, so the
    # cached decode and the full forward see the same expert choices
    return dict(moe_num_experts=E, moe_top_k=1, moe_capacity_factor=8.0, moe_min_capacity=64)


def test_e1_matches_dense():
    """A 1-expert MoE (gate prob 1) generates what the dense model with the
    same MLP weights generates, here and in the reference."""
    jdense, tdense = _serve_cfgs(moe_num_experts=0)
    jmoe, tmoe = _serve_cfgs(**_no_drop(1))
    params_d = _params(jdense)
    params_m = dict(params_d, layers=dict(params_d["layers"]))
    mlp = params_d["layers"]["mlp"]
    L, D = SERVE["num_layers"], SERVE["hidden_size"]
    params_m["layers"]["mlp"] = {"gate": np.zeros((L, D, 1), np.float32),
                                 **{k: mlp[k][:, None] for k in ("wi", "wo", "bi", "bo")}}
    toks = _tokens(2, PROMPT, seed=4)
    outs = {}
    for name, cfg, params in (("dense", tdense, params_d), ("moe", tmoe, params_m)):
        eng = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(cfg), params=params,
                                                 config={"dtype": "float32"}, device="cpu")
        outs[name] = eng.generate(toks, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(outs["dense"], outs["moe"])
    jcomm.destroy()
    try:
        ref = deepspeed_tpu.init_inference(jtf.TransformerModel(jmoe), config={"dtype": "float32"},
                                           params=jax.tree.map(jnp.asarray, params_m))
        np.testing.assert_array_equal(np.asarray(ref.generate(jnp.asarray(toks), max_new_tokens=6)),
                                      outs["moe"])
    finally:
        jcomm.destroy()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-token"])
def test_routed_decode_matches_full_forward(fused):
    """Greedy cached decode over E = 4 experts agrees with the uncached
    forward at every generated position."""
    jcfg, tcfg = _serve_cfgs(**_no_drop(4))
    params = _params(jcfg, seed=1)
    eng = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(tcfg), params=params,
                                             config={"dtype": "float32", "fused_generate": fused},
                                             device="cpu")
    toks = _tokens(2, 6, seed=3)
    out = eng.generate(toks, max_new_tokens=5)
    assert out.shape == (2, 11)
    logits = ttf.forward(eng.params, tcfg, out.long())
    for pos in range(6, 11):
        np.testing.assert_array_equal(out[:, pos].numpy(),
                                      logits[:, pos - 1].argmax(-1).numpy(), err_msg=f"pos {pos}")


@pytest.mark.parametrize("config,match", [
    ({"dtype": "int8"}, "item 10"),
    ({"moe": {"enabled": True, "ep_size": 2}}, "item 8"),
    ({"speculative": {"enabled": True}}, "item 10"),
], ids=["int8", "ep-size-2", "speculative"])
def test_the_serving_refusals(config, match):
    _, tcfg = _serve_cfgs()
    with pytest.raises(NotImplementedError, match=match):
        eng = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(tcfg), config=config,
                                                 device="cpu")
        eng.generate(_tokens(1, 4), max_new_tokens=2)


def test_the_batching_engine_refuses_moe():
    from deepspeed_tpu_torch.inference.continuous import ContinuousBatchingEngine

    _, tcfg = _serve_cfgs()
    with pytest.raises(NotImplementedError, match="item 10"):
        ContinuousBatchingEngine(ttf.TransformerModel(tcfg), config={"dtype": "float32"},
                                 device="cpu", max_slots=2, cache_len=32)


# ---------------------------------------------------------------------------
# 7. checkpoints
# ---------------------------------------------------------------------------

def test_a_world_of_one_checkpoint_round_trips_bit_for_bit(tmp_path):
    from deepspeed_tpu_torch.checkpoint import ds_to_universal, load_universal_into_engine
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    _, tcfg = _cfgs(**VARIANTS["top2-prmoe"], dtype="bfloat16")
    conf = _engine_config(bf16={"enabled": True})

    def engine(seed):
        return deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(tcfg), config=conf,
                                              device="cpu", seed=seed)[0]

    def step(e, batch):
        loss = e.forward(batch)
        e.backward(loss)
        e.step()
        return loss.item()

    batches = _batches(3)
    a = engine(0)
    step(a, batches[0])
    a.save_checkpoint(str(tmp_path / "ckpt"))
    b = engine(5)
    b.load_checkpoint(str(tmp_path / "ckpt"))
    state_a, state_b = dict(a._host_leaves()), dict(b._host_leaves())
    assert sorted(state_a) == sorted(state_b)
    assert any("'gate'" in k for k in state_a) and any("'res_wi'" in k for k in state_a)
    for key, t in state_a.items():
        assert torch.equal(t, state_b[key]), key
    assert step(a, batches[1]) == step(b, batches[1])

    masters = dict(_leaves(ttf.params_to_numpy(a.master_params, tcfg)))
    a.save_checkpoint(str(tmp_path / "ckpt"))
    fp32 = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ckpt"))
    assert sorted(fp32) == sorted(masters)
    for name, arr in masters.items():
        np.testing.assert_array_equal(fp32[name], arr)
    ds_to_universal(str(tmp_path / "ckpt"), str(tmp_path / "universal"))
    c = engine(9)
    load_universal_into_engine(c, str(tmp_path / "universal"))
    for (ka, ta), (kc, tc) in zip(ttf.params_to_numpy(a.master_params, tcfg)["layers"]["mlp"].items(),
                                  ttf.params_to_numpy(c.master_params, tcfg)["layers"]["mlp"].items()):
        np.testing.assert_array_equal(ta, tc)
    assert step(a, batches[2]) == step(c, batches[2])
