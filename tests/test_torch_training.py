"""The port's training slice against the reference's, in f32 on the CPU.

1. The loss (``deepspeed_tpu_torch.models.transformer.loss_fn``) and every
   parameter gradient of a tiny GPT-2 against ``jax.value_and_grad`` of the
   reference's ``loss_fn`` on bridged weights. The flash path ("pallas")
   runs the reference's kernels in interpret mode and the port's autograd
   function with its plain backward.
2. ``deepspeed_tpu_torch.initialize`` -> ``forward``/``backward``/``step``
   against ``deepspeed_tpu.initialize`` on the same weights and batches:
   the loss stream and the final parameters.

Tolerances. Loss 1e-5 absolute; each gradient leaf max |Δ| / max |ref|
<= 1e-4. Both sides are f32 and differ only in summation order (matmuls,
the softmax and the vocab-wide logsumexp) through 2 layers, which moves
values by a few f32 ulps. Engine: max |Δloss| <= 5e-5 over 6 steps and the
final parameters within 1e-4 of max |ref| per leaf: after each Adam step
the weights differ by a few ulps more, so the streams drift apart slowly
from ~1e-6.

One leaf is held differently: the key bias ``bk``. Its exact gradient is 0
(it adds q.bk to every logit of a row, which the softmax cancels), so both
sides hold rounding noise there (~1e-9), and the ratio to max |ref| is
noise over noise. Its gradient is held to 1e-4 of the largest gradient in
the tree; after the engine's steps, Adam has turned that noise into moves
of up to about lr per step on both sides, so its final values are held to
the sum of the step lrs on each side.
"""

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
from deepspeed_tpu_torch.utils.timer import EngineTimers

ZERO_GRAD_LEAVES = ("layers.attn.bk",)
LOSS_TOL = 1e-5
GRAD_REL_TOL = 1e-4
ENGINE_LOSS_TOL = 5e-5
PARAM_REL_TOL = 1e-4
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
            dtype="float32")
# the variants of tests/test_torch_transformer.py
VARIANTS = {
    "gpt2": {},
    "gqa-untied-bias-head": dict(num_kv_heads=2, tie_embeddings=False, lm_head_bias=True),
    "llama-like-no-rope": dict(norm_type="rmsnorm", activation="silu_glu", use_bias=False,
                               tie_embeddings=False, ffn_hidden_size=96),
    "relu": dict(activation="relu"),
}


def _setup(variant, attn_impl, seed=0):
    over = dict(TINY, attn_impl=attn_impl, **VARIANTS[variant])
    jcfg, tcfg = jtf.TransformerConfig(**over), ttf.TransformerConfig(**over)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    # seeded noise: biases and norm scales away from the trivial 0/1
    params = jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)
    tparams = ttf.params_from_numpy(params, tcfg, "cpu")
    ttf.map_params(lambda p: p.requires_grad_(True), tparams)
    return jcfg, tcfg, params, tparams


def _batch(B=2, S=32, seed=1, labels=False, mask=False):
    rs = np.random.RandomState(seed)
    batch = {"input_ids": rs.randint(0, 128, (B, S)).astype(np.int32)}
    if labels:
        batch["labels"] = rs.randint(0, 128, (B, S)).astype(np.int32)
    if mask:
        batch["loss_mask"] = (rs.rand(B, S) < 0.7).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _compare(variant, attn_impl, batch):
    jcfg, tcfg, params, tparams = _setup(variant, attn_impl)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch)))(params)
    loss = ttf.loss_fn(tparams, tcfg, _torch_batch(batch))
    loss.backward()
    grads = ttf.params_to_numpy(ttf.map_params(lambda p: p.grad, tparams), tcfg)
    assert abs(float(jloss) - loss.item()) <= LOSS_TOL
    ref = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    got = dict(_leaves(grads))
    assert sorted(ref) == sorted(got)
    largest = max(float(np.max(np.abs(g))) for g in ref.values())
    for name, g in ref.items():
        assert got[name].shape == g.shape, name
        if name in ZERO_GRAD_LEAVES:
            assert float(np.max(np.abs(got[name] - g))) <= GRAD_REL_TOL * largest, name
        else:
            assert _rel(g, got[name]) <= GRAD_REL_TOL, name


def _rel(ref, got):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_grad_match_reference(variant, attn_impl):
    _compare(variant, attn_impl, _batch())


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("labels,mask", [(True, False), (False, True), (True, True)])
def test_labels_and_loss_mask_match_reference(attn_impl, labels, mask):
    _compare("gpt2", attn_impl, _batch(labels=labels, mask=mask))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_to_numpy_inverts_params_from_numpy(variant):
    jcfg, tcfg, params, tparams = _setup(variant, "xla")
    back = dict(_leaves(ttf.params_to_numpy(tparams, tcfg)))
    ref = dict(_leaves(params))
    assert sorted(back) == sorted(ref)
    for name, a in ref.items():
        np.testing.assert_array_equal(back[name], a)


def test_training_features_outside_the_slice_raise():
    for over in (dict(dropout=0.1), dict(remat=True), dict(random_ltd=True),
                 dict(pld_enabled=True)):
        tcfg = ttf.TransformerConfig(**dict(TINY, **over))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttf.loss_fn({}, tcfg, _torch_batch(_batch()))


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

CFG = dict(TINY, attn_impl="pallas")
GAS, BATCH, SEQ, STEPS, LR, WARMUP = 2, 8, 32, 6, 3e-3, 3


def _engine_config(micro, **over):
    return dict({
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": LR,
                                 "warmup_num_steps": WARMUP, "warmup_type": "linear"}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 0},
        "steps_per_print": 1000000,
    }, **over)


def _data(step, micro):
    rs = np.random.RandomState(1000 * step + micro)
    base = rs.randint(0, 128, (BATCH, SEQ // 4)).astype(np.int32)
    return {"input_ids": np.tile(base, (1, 4))}  # repeated patterns: the loss moves


def _run(engine, to_float):
    losses, norms, lrs = [], [], []
    for step in range(STEPS):
        lrs.append(engine.get_lr()[0])
        for micro in range(GAS):
            loss = engine.forward(_data(step, micro))
            engine.backward(loss)
            engine.step()
            losses.append(to_float(loss))
        norms.append(engine.get_global_grad_norm())
    return losses, norms, lrs


@pytest.fixture(scope="module")
def reference_run():
    # the reference engine builds a mesh over the 8 virtual CPU devices;
    # destroy it before and after so that no later test finds it
    comm.destroy()
    try:
        jcfg = jtf.TransformerConfig(**CFG)
        params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(3), jcfg))
        # the reference spreads its micro batch over the 8 devices: 1 per
        # device is the same global batch of 8 rows the port takes whole
        engine = deepspeed_tpu.initialize(model=jtf.TransformerModel(jcfg),
                                          params=jax.tree.map(jnp.asarray, params),
                                          config=_engine_config(BATCH // 8))[0]
        losses, norms, lrs = _run(engine, float)
        final = jax.tree.map(np.asarray, engine.params)
    finally:
        comm.destroy()
    return {"params": params, "losses": losses, "norms": norms, "lrs": lrs, "final": final}


def _port_engine(params, **over):
    return deepspeed_tpu_torch.initialize(
        model=ttf.TransformerModel(ttf.TransformerConfig(**CFG)), params=params,
        config=_engine_config(BATCH, **over), device="cpu")


def test_engine_loss_stream_and_final_params_match_reference_engine(reference_run):
    engine, opt, loader, sched = _port_engine(reference_run["params"])
    assert opt is engine.optimizer and sched is engine.lr_scheduler and loader is None
    losses, norms, lrs = _run(engine, lambda x: x.item())
    assert engine.global_steps == STEPS and engine.micro_steps == STEPS * GAS
    assert lrs == reference_run["lrs"] and lrs[0] == 0.0
    assert np.max(np.abs(np.array(losses) - np.array(reference_run["losses"]))) <= ENGINE_LOSS_TOL
    np.testing.assert_allclose(norms, reference_run["norms"], rtol=1e-4)
    assert losses[-1] < losses[0] - 0.05  # it trains
    ref = dict(_leaves(reference_run["final"]))
    got = dict(_leaves(ttf.params_to_numpy(engine.params, engine.model.cfg)))
    assert sorted(ref) == sorted(got)
    for name, a in ref.items():
        if name in ZERO_GRAD_LEAVES:
            assert max(np.max(np.abs(a)), np.max(np.abs(got[name]))) <= sum(lrs), name
        else:
            assert _rel(a, got[name]) <= PARAM_REL_TOL, name


def test_train_batch_runs_one_accumulation_cycle(reference_run):
    engine = _port_engine(reference_run["params"])[0]
    mean = engine.train_batch(iter([_data(0, 0), _data(0, 1)]))
    assert engine.global_steps == 1 and engine.is_gradient_accumulation_boundary()
    np.testing.assert_allclose(mean.item(), np.mean(reference_run["losses"][:2]),
                               atol=ENGINE_LOSS_TOL)
    assert engine.eval_batch(_data(1, 0)).item() == pytest.approx(reference_run["losses"][2],
                                                                 abs=ENGINE_LOSS_TOL)
    assert engine.zero_optimization_stage() == 0


def test_prescaled_gradients_divide_before_accumulating(reference_run):
    """prescale_gradients divides each micro gradient by the predivide factor
    (micro_fn) and the step then divides by the loss scale alone (apply_fn):
    with the factor equal to GAS the step is the default one."""
    runs = []
    for over in ({}, {"prescale_gradients": True, "gradient_predivide_factor": float(GAS)}):
        engine = _port_engine(reference_run["params"], **over)[0]
        engine.train_batch(iter([_data(0, 0), _data(0, 1)]))
        runs.append((engine.get_global_grad_norm(), engine._base_leaves))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_bf16_engine_keeps_f32_masters_and_trains():
    cfg = ttf.TransformerConfig(**dict(CFG, dtype="bfloat16"))
    conf = dict(_engine_config(BATCH), bf16={"enabled": True}, scheduler=None)
    engine = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(cfg), config=conf,
                                            device="cpu")[0]
    tok = engine.params["embed"]["tok"]
    assert tok.dtype == torch.bfloat16 and engine.master_params["embed"]["tok"].dtype == torch.float32
    losses = [engine.train_batch(iter([_data(0, 0), _data(0, 1)])).item() for _ in range(6)]
    assert torch.equal(tok, engine.master_params["embed"]["tok"].to(torch.bfloat16))
    assert losses[-1] < losses[0]


def test_fp16_overflow_skips_the_step_and_lowers_the_scale():
    cfg = ttf.TransformerConfig(**dict(CFG, dtype="float16"))
    conf = dict(_engine_config(BATCH), fp16={"enabled": True, "initial_scale_power": 8,
                                             "hysteresis": 1}, scheduler=None,
                gradient_accumulation_steps=1)
    engine = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(cfg), config=conf,
                                            device="cpu")[0]
    before = [t.clone() for t in engine._base_leaves]
    engine.forward(_data(0, 0))
    engine.backward()
    engine.grad_acc[0].fill_(float("inf"))  # an overflowed gradient
    engine.step()
    assert engine.skipped_steps == 1 and engine.loss_scale == 128.0
    assert all(torch.equal(a, b) for a, b in zip(before, engine._base_leaves))
    assert engine.opt_state.step == 0
    assert all(float(g.abs().max()) == 0.0 for g in engine.grad_acc)


def test_wall_clock_breakdown_times_forward_backward_and_step():
    conf = dict(_engine_config(BATCH), wall_clock_breakdown=True, scheduler=None,
                gradient_accumulation_steps=1)
    engine = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                            config=conf, device="cpu")[0]
    assert engine.timers.enabled
    engine.train_batch(iter([_data(0, 0)]))
    for name in (EngineTimers.FORWARD, EngineTimers.BACKWARD, EngineTimers.STEP):
        timer = engine.timers(name)
        assert timer.count == 1 and timer.elapsed() > 0.0


def test_initialize_runs_on_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = ttf.TransformerModel(ttf.TransformerConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.initialize(model=model, config=_engine_config(BATCH))
    for kw in (dict(optimizer=torch.optim.SGD([torch.zeros(1)], lr=0.1)),
               dict(config=_engine_config(BATCH, optimizer={"type": "Lamb",
                                                            "params": {"lr": 1e-3}})),
               dict(training_data=[_data(0, 0)])):
        kw.setdefault("config", _engine_config(BATCH))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            deepspeed_tpu_torch.initialize(model=model, device="cpu", **kw)
    engine = deepspeed_tpu_torch.initialize(model=model, config=_engine_config(BATCH),
                                            device="cpu")[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.save_checkpoint("ckpt")
