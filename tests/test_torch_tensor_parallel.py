"""Tensor parallelism of the port against the reference, on the CPU.

One world of 4 gloo ranks trains five tiny f32 models, each 3 steps on one
global batch (the same batch for both), against the reference's engine on a
4-device mesh of the same shape (``tensor`` is 2 in each):

- Llama (rope, GQA with 4 query heads over 2 kv heads, a uniform window
  of 16 over S 32) on the flash path at ``{data: 2, tensor: 2}``, stage 0:
  each tensor rank runs attention on its 2 query heads and 1 kv head;
- GPT-2 with ALiBi at ``{data: 2, tensor: 2}``, stage 1: the masked path,
  each rank's slopes taken at its head offset;
- GPT-2 with one kv head (MQA) at ``{data: 2, tensor: 2}``: the head counts
  do not divide the width, so every rank computes every head, as the
  reference does;
- GPT-2 through ``block_sparse`` (S 128, a fixed layout whose 4 heads'
  rows all differ) at ``{data: 2, tensor: 2}``, stage 2: each rank's
  layout rows are its heads';
- Llama at ``{fsdp: 2, tensor: 2}``, stage 3 (params gathered layer by
  layer inside the tensor split).

The port runs the flash and block-sparse kernels' plain versions (CPU
tensors); the reference runs its Pallas kernels in interpret mode under
its ``_head_shard_map``. Both vocabularies (128) split over ``tensor``: the
port's embedding, logits and cross-entropy are vocab-parallel. Losses are
held within ``rtol=2e-4`` and the gathered final params within 5e-4 of each
leaf's max (``tests/test_torch_zero.py`` says why), the key bias by its
moves. A vocabulary that the width does not divide (GPT-2's 50,257 at
``tensor`` 2) is refused by both packages' placements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.parallel import tensor_parallel as tpm
from deepspeed_tpu_torch.runtime.zero import sharding as tsh
from torch_dist_common import run_world

LR, STEPS, MICRO = 3e-3, 3, 2
PARAM_REL_TOL = 5e-4
GPT2 = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
            dtype="float32")
LLAMA = dict(GPT2, num_kv_heads=2, pos_embedding="rope", norm_type="rmsnorm",
             activation="silu_glu", tie_embeddings=False, use_bias=False, ffn_hidden_size=96,
             local_attn_windows=(16, 16), attn_impl="pallas")
SPARSE = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
          "num_local_blocks": 4, "num_global_blocks": 1, "num_different_global_patterns": 4}
DT = {"data": 2, "tensor": 2}
CASES = {
    "llama_flash": dict(cfg=LLAMA, mesh=DT, stage=0),
    "gpt2_alibi": dict(cfg=dict(GPT2, pos_embedding="alibi"), mesh=DT, stage=1),
    "gpt2_mqa_every_head": dict(cfg=dict(GPT2, num_kv_heads=1, attn_impl="pallas"), mesh=DT,
                                stage=0),
    "gpt2_block_sparse": dict(cfg=dict(GPT2, max_seq_len=128, attn_impl="block_sparse",
                                       sparse_attention=SPARSE), mesh=DT, stage=2),
    "llama_fsdp_tensor_stage3": dict(cfg=LLAMA, mesh={"fsdp": 2, "tensor": 2}, stage=3),
}


def _config(case):
    return {"train_micro_batch_size_per_gpu": MICRO,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": case["stage"], "stage3_param_persistence_threshold": 0},
            "mesh": case["mesh"], "steps_per_print": 10**9}


def _params(cfg_kw, seed=0):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed),
                                               jtf.TransformerConfig(**cfg_kw)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _batches(cfg_kw):
    """One global batch, STEPS times: the loss falls as it is learnt."""
    rs = np.random.RandomState(11)
    seq = cfg_kw["max_seq_len"]
    batch = {"input_ids": np.tile(rs.randint(0, 128, (2 * MICRO, seq // 4)), (1, 4)).astype(np.int32)}
    return [batch] * STEPS


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, prefix + (k,)).items()}
    return {".".join(prefix): tree}


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    cases = {name: {"cfg": c["cfg"], "config": _config(c), "params": _params(c["cfg"]),
                    "batches": _batches(c["cfg"])} for name, c in CASES.items()}
    return run_world("engine", 4, tmp_path_factory.mktemp("tp_world"), DT, cases)


@pytest.fixture(scope="module")
def reference_runs():
    out = {}
    try:
        for name, case in CASES.items():
            jcomm.destroy()
            mesh = jcomm.build_mesh(case["mesh"], devices=jax.devices()[:4])
            engine = deepspeed_tpu.initialize(
                model=jtf.TransformerModel(jtf.TransformerConfig(**case["cfg"])),
                params=jax.tree.map(jnp.asarray, _params(case["cfg"])), config=_config(case),
                mesh=mesh)[0]
            losses = []
            for batch in _batches(case["cfg"]):
                loss = engine.forward(batch)
                engine.backward(loss)
                engine.step()
                losses.append(float(jax.block_until_ready(loss)))
            out[name] = {"losses": losses, "final": jax.tree.map(np.asarray, engine.params)}
    finally:
        jcomm.destroy()
    return out


def test_the_ranks_import_neither_jax_nor_the_reference(port_world):
    assert all(r["foreign_modules"] == [] for r in port_world)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_training_matches_the_reference_engine(port_world, reference_runs, name):
    ref = reference_runs[name]
    start = _flat(_params(CASES[name]["cfg"]))
    want = _flat(ref["final"])
    for rank in range(4):
        got = port_world[rank][name]
        assert got["mesh"]["tensor"] == 2
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
        have = _flat(got["final"])
        assert sorted(want) == sorted(have)
        for key, a in want.items():
            if key == "layers.attn.bk":  # exact gradient 0: Adam moves noise by ~lr a step
                moved = max(np.abs(a - start[key]).max(), np.abs(have[key] - start[key]).max())
                assert moved <= 1.1 * STEPS * LR, key
            else:
                assert np.abs(have[key] - a).max() <= PARAM_REL_TOL * np.abs(a).max(), key
    assert ref["losses"][-1] < ref["losses"][0]  # it trains


def test_heads_split_follows_the_reference_rule():
    cfg = ttf.TransformerConfig(**LLAMA)
    assert tpm.TensorParallel(2, 1).heads_split(cfg)
    assert not tpm.TensorParallel(4, 0).heads_split(cfg)  # 2 kv heads over 4 ranks
    assert tpm.TensorParallel(2, 1).block(128) == (64, 64)


def test_an_indivisible_vocabulary_is_refused_by_both_placements():
    """GPT-2's 50,257 rows over ``tensor`` 2: the reference's placement of
    the embedding raises, and so does the port's cut of it."""
    spec = tsh.logical_to_mesh_spec(("vocab", "embed"))
    assert tuple(spec) == ("tensor", None)
    from deepspeed_tpu_torch import comm

    mesh = comm.build_mesh({"tensor": 2}, world_size=2, rank=1)
    with pytest.raises(ValueError, match="divisible"):
        tsh.shard_slices((50257, 768), spec, mesh)
    jcomm.destroy()
    try:
        jmesh = jcomm.build_mesh({"tensor": 2}, devices=jax.devices()[:2])
        with pytest.raises(ValueError, match="divisible"):
            jax.device_put(np.zeros((50257, 8), np.float32),
                           jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(*spec)))
    finally:
        jcomm.destroy()
    assert torch.equal(tsh.local_shard(torch.arange(8.0).reshape(4, 2), spec, mesh),
                       torch.tensor([[4.0, 5.0], [6.0, 7.0]]))
