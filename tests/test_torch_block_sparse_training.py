"""The block-sparse slice against the reference, in f32 on the CPU: a tiny
GPT (2 layers, D 64, 4 heads, S 64) with ``attn_impl="block_sparse"`` and
the same numpy weights in both packages. The reference's block-sparse
kernels run in interpret mode; the port's autograd function takes its plain
versions on CPU tensors.

1. The loss and every parameter gradient against ``jax.value_and_grad`` of
   the reference's ``loss_fn``, for a fixed and a bigbird layout (blocks 16
   and 32) and for grouped-query attention through the model's repeat.
2. ``deepspeed_tpu_torch.initialize`` -> ``forward``/``backward``/``step``
   against ``deepspeed_tpu.initialize``: a 4-step loss stream and the final
   parameters.
3. ``init_inference(attn_impl="block_sparse")``: ``forward`` logits (through
   the block-sparse kernels) and greedy ``generate`` streams (the cached
   path attends densely, in both packages) against the reference engine.

Tolerances as in ``tests/test_torch_training.py``, for the same reason (f32
on both sides, summation order only): loss 1e-5, each gradient leaf max |Δ|
/ max |ref| <= 1e-4, engine losses 5e-5 and final parameters 1e-4 of each
leaf's max; the key bias ``bk``, whose exact gradient is 0, is held to the
tree's gradient scale and to the lr sum. Logits 1e-4; greedy streams
identical unless the reference's top-2 margin is under 1e-4 (a tie).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf

ZERO_GRAD_LEAVES = ("layers.attn.bk",)
LOSS_TOL = 1e-5
GRAD_REL_TOL = 1e-4
ENGINE_LOSS_TOL = 5e-5
PARAM_REL_TOL = 1e-4
LOGITS_TOL = 1e-4
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
            dtype="float32", attn_impl="block_sparse")
VARIANTS = {
    "fixed-block16": dict(sparse_attention={"mode": "fixed", "block": 16,
                                            "num_local_blocks": 2}),
    "bigbird-block32": dict(sparse_attention={"mode": "bigbird", "block": 32,
                                              "num_sliding_window_blocks": 1}),
    "fixed-block16-gqa": dict(num_kv_heads=2,
                              sparse_attention={"mode": "fixed", "block": 16,
                                                "num_local_blocks": 2}),
}
# the engine comparison: local attention within each of two blocks of 32
# (the reference's interpret-mode kernels take seconds per grid step on 8
# virtual devices, so the engine runs the smallest grid, 2 x 2 tiles)
ENGINE_VARIANT = dict(sparse_attention={"mode": "bslongformer", "block": 32,
                                        "num_sliding_window_blocks": 1,
                                        "global_block_indices": ()})


def _configs(variant):
    over = dict(TINY, **(ENGINE_VARIANT if variant == "engine" else VARIANTS[variant]))
    return jtf.TransformerConfig(**over), ttf.TransformerConfig(**over)


def _params(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    # seeded noise: biases and norm scales away from the trivial 0/1
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _rel(ref, got):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_grad_match_reference(variant):
    jcfg, tcfg = _configs(variant)
    params = _params(jcfg)
    toks = np.random.RandomState(1).randint(0, 128, (2, 64)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {"input_ids": jnp.asarray(toks)})))(params)
    tparams = ttf.params_from_numpy(params, tcfg, "cpu")
    ttf.map_params(lambda p: p.requires_grad_(True), tparams)
    loss = ttf.loss_fn(tparams, tcfg, {"input_ids": torch.from_numpy(toks).long()})
    loss.backward()
    assert abs(float(jloss) - loss.item()) <= LOSS_TOL
    ref = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    got = dict(_leaves(ttf.params_to_numpy(ttf.map_params(lambda p: p.grad, tparams), tcfg)))
    assert sorted(ref) == sorted(got)
    largest = max(float(np.max(np.abs(g))) for g in ref.values())
    for name, g in ref.items():
        assert got[name].shape == g.shape, name
        if name in ZERO_GRAD_LEAVES:
            assert float(np.max(np.abs(got[name] - g))) <= GRAD_REL_TOL * largest, name
        else:
            assert _rel(g, got[name]) <= GRAD_REL_TOL, name


def test_the_block_sparse_path_is_taken():
    """The model's attention goes through the block-sparse autograd function
    (and, on the card, K4-K6), not the dense einsum."""
    _, tcfg = _configs("fixed-block16")
    params = ttf.init(torch.Generator().manual_seed(0), tcfg)
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(2, 64, 4, 16).astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    out = ttf._attention(q, k, v, tcfg)
    assert type(out.grad_fn).__name__ == "_BlockSparseAttentionBackward"
    dense = ttf._attention(q, k, v, ttf.TransformerConfig(**dict(TINY, attn_impl="xla")))
    assert float((out - dense).detach().abs().max()) > 1e-3  # the layout is not the dense one
    assert ttf.forward(params, tcfg, torch.zeros(1, 64, dtype=torch.long)).shape == (1, 64, 128)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

BATCH, STEPS, LR = 8, 4, 3e-3


def _engine_config(micro):
    return {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": LR,
                                 "warmup_num_steps": 3, "warmup_type": "linear"}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 0},
        "steps_per_print": 1000000,
    }


def _data():
    """One fixed batch for every step: the loss falls as the model learns it."""
    base = np.random.RandomState(100).randint(0, 128, (BATCH, 16)).astype(np.int32)
    return {"input_ids": np.tile(base, (1, 4))}


@pytest.fixture(scope="module")
def reference_run():
    # the reference engine builds a mesh over the 8 virtual CPU devices;
    # destroy it before and after so that no later test finds it
    comm.destroy()
    try:
        jcfg, _ = _configs("engine")
        params = _params(jcfg, seed=3)
        # 1 row per device: the same global batch of 8 rows the port takes whole
        engine = deepspeed_tpu.initialize(model=jtf.TransformerModel(jcfg),
                                          params=jax.tree.map(jnp.asarray, params),
                                          config=_engine_config(BATCH // 8))[0]
        losses = []
        for _ in range(STEPS):
            loss = engine.forward(_data())
            engine.backward(loss)
            engine.step()
            losses.append(float(loss))
        final = jax.tree.map(np.asarray, engine.params)
    finally:
        comm.destroy()
    return {"params": params, "losses": losses, "final": final}


def test_engine_loss_stream_and_final_params_match_reference_engine(reference_run):
    _, tcfg = _configs("engine")
    engine = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(tcfg),
                                            params=reference_run["params"],
                                            config=_engine_config(BATCH), device="cpu")[0]
    losses = []
    for _ in range(STEPS):
        loss = engine.forward(_data())
        engine.backward(loss)
        engine.step()
        losses.append(loss.item())
    assert np.max(np.abs(np.array(losses) - np.array(reference_run["losses"]))) <= ENGINE_LOSS_TOL
    assert losses[-1] < losses[0]  # it trains
    ref = dict(_leaves(reference_run["final"]))
    got = dict(_leaves(ttf.params_to_numpy(engine.params, tcfg)))
    assert sorted(ref) == sorted(got)
    for name, a in ref.items():
        if name in ZERO_GRAD_LEAVES:  # from the same start, each side moves <= ~lr a step
            assert np.max(np.abs(got[name] - a)) <= 2 * LR * STEPS, name
        else:
            assert _rel(a, got[name]) <= PARAM_REL_TOL, name


# ---------------------------------------------------------------------------
# init_inference with block-sparse attention
# ---------------------------------------------------------------------------

PROMPT, NEW = 16, 16


@pytest.fixture(scope="module")
def inference_setup():
    comm.destroy()
    try:
        jcfg, _ = _configs("fixed-block16")
        params = _params(jcfg, seed=4)
        toks = np.random.RandomState(5).randint(0, 128, (2, PROMPT)).astype(np.int32)
        eng = deepspeed_tpu.init_inference(jtf.TransformerModel(jcfg), params=params,
                                           config={"dtype": "float32",
                                                   "attn_impl": "block_sparse"})
        stream = np.asarray(eng.generate(jnp.asarray(toks), max_new_tokens=NEW))
        logits = np.asarray(eng.forward(stream))
    finally:
        comm.destroy()
    return {"params": params, "toks": toks, "stream": stream, "logits": logits}


def _port_inference(params):
    _, tcfg = _configs("fixed-block16")
    return deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(dataclasses.replace(tcfg, attn_impl="xla")),
        config={"dtype": "float32", "attn_impl": "block_sparse"}, params=params, device="cpu")


def test_inference_forward_matches_reference(inference_setup):
    eng = _port_inference(inference_setup["params"])
    assert eng.cfg.attn_impl == "block_sparse"  # the config's attn_impl overrides the model's
    out = eng.forward(inference_setup["stream"])
    assert out.shape == (2, PROMPT + NEW, 128)
    assert float(np.max(np.abs(inference_setup["logits"] - out.numpy()))) <= LOGITS_TOL


def test_inference_greedy_stream_matches_reference(inference_setup):
    eng = _port_inference(inference_setup["params"])
    out = eng.generate(inference_setup["toks"], max_new_tokens=NEW).numpy()
    ref = inference_setup["stream"]
    if np.array_equal(ref, out):
        return
    b, j = np.argwhere(ref[:, PROMPT:] != out[:, PROMPT:])[0]
    top2 = np.sort(inference_setup["logits"][b, PROMPT - 1 + j])[-2:]
    margin = float(top2[1] - top2[0])
    if margin < LOGITS_TOL:
        pytest.skip(f"tie: reference top-2 margin {margin:.2e} < {LOGITS_TOL} at row {b} step {j}")
    raise AssertionError(f"streams differ at row {b} step {j} (reference margin {margin:.3g})")
