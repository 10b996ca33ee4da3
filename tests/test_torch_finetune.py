"""Fine-tuning a decoder family with the port, on the CPU in f32:

1. ``deepspeed_tpu_torch.initialize`` -> ``forward``/``backward``/``step``
   against ``deepspeed_tpu.initialize`` on the same weights and batches, for
   a tiny Llama on the flash path (rope, GQA 4/2, SwiGLU, RMSNorm, untied
   head), a tiny BLOOM (ALiBi, the embedding norm) and a tiny GPT-J (the
   lm head's bias, the shared LN): the loss stream and the final
   parameters.
2. The HF round trip: a tiny Llama checkpoint directory (written by the
   port's ``save_hf_checkpoint``) is read by ``convert_hf_checkpoint`` into
   ``initialize(params=...)``, trained 3 steps and exported again; the
   reference's ``module_inject`` loader reads the export into the same tree
   and config, and ``init_inference`` serves it.
3. Resume: the tiny Llama saved at step 3 and resumed to step 6 equals the
   uninterrupted run bit for bit.

Tolerances, as in ``tests/test_torch_training.py`` and for the same reason
(f32, summation order only): engine losses 5e-5 over 6 steps and the final
parameters 1e-4 of each leaf's max (the key bias ``bk``, whose exact
gradient is 0, by the sum of the step lrs); the exported tree and the
resumed run exactly.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.module_inject import load_checkpoint as jlc
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.module_inject import export as texport
from deepspeed_tpu_torch.module_inject import load_checkpoint as tlc
from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce
from test_torch_training import (BATCH, ENGINE_LOSS_TOL, GAS, PARAM_REL_TOL, STEPS,
                                 _data, _engine_config, _leaves, _rel, _run)

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
            dtype="float32")
FAMILIES = {
    "llama-pallas": dict(num_kv_heads=2, pos_embedding="rope", norm_type="rmsnorm",
                         activation="silu_glu", tie_embeddings=False, use_bias=False,
                         ffn_hidden_size=96, attn_impl="pallas"),
    "bloom": dict(pos_embedding="alibi", embed_norm=True),
    # the lm head's bias and the shared LN (its unused ln2 decays alone)
    "gptj": dict(pos_embedding="rope", rope_dim=8, rope_interleaved=True,
                 parallel_residual=True, shared_ln=True, tie_embeddings=False,
                 lm_head_bias=True),
}
ZERO_GRAD_LEAVES = ("layers.attn.bk",)
# the tiny Llama as an HF config.json (LlamaForCausalLM's fields)
LLAMA_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_act": "silu",
    "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 128,
    "max_position_embeddings": 32, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's CPU ops run fastest on one thread, and the suite's
    parallel workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(family):
    return dict(TINY, **FAMILIES[family])


@functools.lru_cache(maxsize=None)
def _reference_run(family):
    """The reference engine's 6 steps from its own init (seed 3): the initial
    params, the loss stream, the grad norms, the lrs and the final params.
    It builds a mesh over the 8 virtual CPU devices: destroyed before and
    after so that no later test finds it."""
    comm.destroy()
    try:
        jcfg = jtf.TransformerConfig(**_cfg(family))
        params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(3), jcfg))
        # one row a device is the port's micro batch of 8 taken whole
        engine = deepspeed_tpu.initialize(model=jtf.TransformerModel(jcfg),
                                          params=jax.tree.map(jnp.asarray, params),
                                          config=_engine_config(BATCH // 8))[0]
        losses, norms, lrs = _run(engine, float)
        final = jax.tree.map(np.asarray, engine.params)
    finally:
        comm.destroy()
    return {"params": params, "losses": losses, "norms": norms, "lrs": lrs, "final": final}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_loss_stream_and_final_params_match_reference_engine(family):
    ref = _reference_run(family)
    cfg = ttf.TransformerConfig(**_cfg(family))
    engine = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(cfg), params=ref["params"],
                                            config=_engine_config(BATCH), device="cpu")[0]
    losses, norms, lrs = _run(engine, lambda x: x.item())
    assert engine.global_steps == STEPS and engine.micro_steps == STEPS * GAS
    assert lrs == ref["lrs"]
    assert np.max(np.abs(np.array(losses) - np.array(ref["losses"]))) <= ENGINE_LOSS_TOL
    np.testing.assert_allclose(norms, ref["norms"], rtol=1e-4)
    want = dict(_leaves(ref["final"]))
    got = dict(_leaves(ttf.params_to_numpy(engine.params, cfg)))
    assert sorted(want) == sorted(got)
    for name, a in want.items():
        if name in ZERO_GRAD_LEAVES:
            assert max(np.max(np.abs(a)), np.max(np.abs(got[name]))) <= sum(lrs), name
        elif not np.any(a):  # GPT-J's unused ln2 bias: zero, and decay keeps it there
            np.testing.assert_array_equal(got[name], a, err_msg=name)
        else:
            assert _rel(a, got[name]) <= PARAM_REL_TOL, name


def _llama_engine(params=None, seed=0, config=None):
    cfg = ttf.TransformerConfig(**_cfg("llama-pallas"))
    return deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(cfg), params=params,
                                          config=config or _engine_config(BATCH, scheduler=None),
                                          device="cpu", seed=seed)[0]


def _train(engine, steps):
    losses = []
    for _ in range(steps):
        step = engine.global_steps
        losses.append(engine.train_batch(iter([_data(step, m) for m in range(GAS)])).item())
    return losses


def test_hf_fine_tune_round_trip(tmp_path):
    """An HF directory -> ``convert_hf_checkpoint`` -> ``initialize(params=)``
    -> 3 steps -> ``save_hf_checkpoint`` -> the reference's loader reads the
    trained tree and config exactly, and ``init_inference`` serves the
    export with the trained engine's logits and stream."""
    base = _llama_engine(seed=7)
    src = tmp_path / "base"
    texport.save_hf_checkpoint(str(src), base.params, base.model.cfg, "llama",
                               hf_config=tlc.HFConfig(LLAMA_HF_CONFIG))
    cfg, tree = tlc.convert_hf_checkpoint(str(src))
    assert cfg == base.model.cfg
    engine = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(cfg), params=tree,
                                            config=_engine_config(BATCH, scheduler=None),
                                            device="cpu")[0]
    for a, b in zip(engine._param_leaves, base._param_leaves):
        assert torch.equal(a, b)
    losses = _train(engine, 3)
    assert losses[-1] < losses[0]

    out = tmp_path / "finetuned"
    texport.save_hf_checkpoint(str(out), engine.params, cfg, "llama",
                               hf_config=tlc.HFConfig(LLAMA_HF_CONFIG))
    assert json.loads((out / "config.json").read_text())["num_key_value_heads"] == 2
    jcfg, jtree = jlc.convert_hf_checkpoint(str(out))
    assert {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)} == {
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    want = dict(_leaves(ttf.params_to_numpy(engine.params, cfg)))
    got = dict(_leaves(jax.tree.map(np.asarray, jtree)))
    assert sorted(want) == sorted(got)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)

    served = deepspeed_tpu_torch.init_inference(str(out), device="cpu")
    direct = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(cfg), device="cpu",
                                                params=engine.params)
    prompt = _data(9, 0)["input_ids"][:2, :8]
    torch.testing.assert_close(served.forward(prompt), direct.forward(prompt), rtol=0, atol=0)
    assert np.array_equal(np.asarray(served.generate(prompt, max_new_tokens=8)),
                          np.asarray(direct.generate(prompt, max_new_tokens=8)))


def test_llama_save_at_step_3_and_resume_to_step_6_is_bitwise(tmp_path):
    run_a = _llama_engine()
    losses_a = _train(run_a, 6)
    run_b = _llama_engine()
    losses_b = _train(run_b, 3)
    run_b.save_checkpoint(str(tmp_path))
    resumed = _llama_engine(seed=1)  # other initial weights
    path, _ = resumed.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and resumed.global_steps == 3
    losses_b += _train(resumed, 3)
    assert losses_b == losses_a
    sa, sb = (dict(tce.named_host_leaves(e._state_tree())) for e in (run_a, resumed))
    assert sorted(sa) == sorted(sb) and any("lm_head" in k for k in sa)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
