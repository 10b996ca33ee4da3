"""The port's activation checkpointing (``runtime/activation_checkpointing``)
against the reference's, on the CPU.

1. ``configure`` on the same blocks (kwargs, a dict, each package's
   ``TpuConfig``) gives the reference's config, field for field; the
   refusals (``cpu_checkpointing``, the ``"offload"`` policy,
   ``partition_activations`` on a mesh with a ``tensor`` or ``sequence``
   axis over 1) name Queue 1 item 10.
2. Remat under each of the four policies: every gradient bit for bit equal
   to remat off (the recompute runs the same f32 ops on the same inputs),
   and the loss within 1e-5 and every gradient within 1e-4 of its leaf's max
   against ``jax.value_and_grad`` of the reference's ``loss_fn`` under the
   same policy, for a dense GPT-2 and a MoE (top-2, PR-MoE), and the flash
   path under two of them.
3. The policies' saved sets, by counting the ``mm``/``bmm`` calls of the
   backward (a ``TorchDispatchMode``) against remat off, on the MoE model,
   where every product's output feeds the backward: ``nothing_saveable``
   re-runs every product of the layers, ``dots_saveable`` none,
   ``dots_with_no_batch_dims`` only the batched ones (the attention's and
   the experts').
4. ``profile`` puts each layer in a ``checkpoint_layer`` range; the engine
   reads the config's block; ``checkpoint()`` keeps the RNG state across the
   recompute; the RNG tracker's named streams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jckpt
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.engine import _leaf_names
from deepspeed_tpu_torch.runtime.engine import _leaves as _flat
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as tckpt

LOSS_TOL, GRAD_REL_TOL = 1e-5, 1e-4
V = 128
TINY = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
            dtype="float32")
MODELS = {
    "gpt2": {},
    "moe-top2-prmoe": dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
                           moe_use_residual=True),
    "flash": dict(attn_impl="pallas"),
}
POLICIES = ["nothing_saveable", "dots_saveable", "dots_with_no_batch_dims", "full"]
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


@pytest.fixture(autouse=True)
def _fresh_config():
    tckpt.reset()
    jckpt.reset()
    yield
    tckpt.reset()
    jckpt.reset()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


# ---------------------------------------------------------------------------
# 1. configure
# ---------------------------------------------------------------------------

BLOCKS = {
    "empty": {},
    "partition-profile": {"partition_activations": True, "profile": True, "number_checkpoints": 4,
                          "policy": "dots_saveable"},
    "no-op-keys": {"contiguous_memory_optimization": True,
                   "synchronize_checkpoint_boundary": True, "policy": "dots_with_no_batch_dims"},
}


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("form", ["dict", "config"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_configure_reads_the_reference_s_blocks(block, form):
    conf = {"train_micro_batch_size_per_gpu": 1, "activation_checkpointing": BLOCKS[block]}
    if form == "dict":
        jsrc, tsrc = conf, conf
    else:
        jsrc, tsrc = jconfig.TpuConfig(conf), tconfig.TpuConfig(conf)
    jckpt.configure(deepspeed_config=jsrc)
    tckpt.configure(deepspeed_config=tsrc)
    assert _fields(tckpt.get_config()) == _fields(jckpt._CONFIG)
    assert tckpt.is_configured() and jckpt.is_configured()
    assert tckpt.partition_activations_enabled() == jckpt.partition_activations_enabled()
    assert tckpt.profile_enabled() == jckpt.profile_enabled()
    tckpt.reset()
    assert not tckpt.is_configured()
    assert _fields(tckpt.get_config()) == _fields(tckpt.CheckpointConfig())


def test_configure_takes_the_reference_s_kwargs():
    kw = dict(partition_activations=True, contiguous_checkpointing=False, num_checkpoints=3,
              checkpoint_in_cpu=False, synchronize=False, profile=True)
    jckpt.configure(**kw)
    tckpt.configure(**kw)
    assert _fields(tckpt.get_config()) == _fields(jckpt._CONFIG)
    assert set(tckpt.POLICIES) == set(jckpt.POLICIES)


class _Mesh:
    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("call", ["cpu_checkpointing", "offload_policy", "resolve_offload",
                                  "partition_on_tensor_2", "partition_on_sequence_2"])
def test_the_refusals_name_item_10(call):
    x = torch.zeros(2, 4, 8)
    calls = {
        "cpu_checkpointing": lambda: tckpt.configure(
            deepspeed_config={"activation_checkpointing": {"cpu_checkpointing": True}}),
        "offload_policy": lambda: tckpt.configure(
            deepspeed_config={"activation_checkpointing": {"policy": "offload"}}),
        "resolve_offload": lambda: tckpt.resolve_policy("offload"),
        "partition_on_tensor_2": lambda: (tckpt.configure(partition_activations=True),
                                          tckpt.partition_saved_activation(x, _Mesh(tensor=2))),
        "partition_on_sequence_2": lambda: (tckpt.configure(partition_activations=True),
                                            tckpt.partition_saved_activation(
                                                x, _Mesh(sequence=2, tensor=1))),
    }
    with pytest.raises(NotImplementedError, match="item 10"):
        calls[call]()


def test_partition_activations_is_the_identity_where_no_axis_shards():
    tckpt.configure(partition_activations=True)
    x = torch.randn(2, 4, 8)
    assert tckpt.partition_saved_activation(x, _Mesh(data=2, tensor=1, sequence=1)) is x
    assert tckpt.partition_saved_activation(x) is x
    with pytest.raises(ValueError, match="policy"):
        tckpt.resolve_policy("nothing")


def test_the_engine_reads_the_block_and_refuses_cpu_checkpointing():
    tcfg = ttf.TransformerConfig(**TINY, remat=True)
    conf = {"train_micro_batch_size_per_gpu": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "activation_checkpointing": {"profile": True, "policy": "dots_saveable"}}
    deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(tcfg), config=conf, device="cpu")
    assert tckpt.get_config().policy == "dots_saveable" and tckpt.profile_enabled()
    conf["activation_checkpointing"] = {"cpu_checkpointing": True}
    with pytest.raises(NotImplementedError, match="item 10"):
        deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(tcfg), config=conf, device="cpu")


# ---------------------------------------------------------------------------
# 2. remat against remat off and against the reference
# ---------------------------------------------------------------------------

def _params(model, seed=0):
    jcfg = jtf.TransformerConfig(**TINY, **MODELS[model])
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _tokens(B=2, S=32, seed=1):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def _port_grads(tcfg, np_params, tokens):
    tparams = ttf.params_from_numpy(np_params, tcfg, "cpu")
    ttf.map_params(lambda p: p.requires_grad_(True), tparams)
    loss = ttf.loss_fn(tparams, tcfg, {"input_ids": torch.from_numpy(tokens).long()})
    loss.backward()
    return loss.detach(), ttf.map_params(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tparams)


# every policy on the dense and the MoE model; the flash path (the
# reference's kernels in interpret mode) under a policy that recomputes
# everything and one that keeps the weight products
REMAT_CASES = ([(m, p) for m in ("gpt2", "moe-top2-prmoe") for p in POLICIES]
               + [("flash", "nothing_saveable"), ("flash", "dots_with_no_batch_dims")])


@pytest.mark.parametrize("model,policy", REMAT_CASES, ids=[f"{m}-{p}" for m, p in REMAT_CASES])
def test_remat_matches_remat_off_and_the_reference(model, policy):
    over = dict(TINY, **MODELS[model])
    np_params, tokens = _params(model), _tokens()
    off_loss, off = _port_grads(ttf.TransformerConfig(**over), np_params, tokens)
    tcfg = ttf.TransformerConfig(**over, remat=True, remat_policy=policy)
    loss, grads = _port_grads(tcfg, np_params, tokens)
    assert torch.equal(loss, off_loss)
    names = _leaf_names(off)
    assert names == _leaf_names(grads)
    for name, a, b in zip(names, _flat(off), _flat(grads)):
        assert torch.equal(a, b), name

    jcfg = jtf.TransformerConfig(**over, remat=True, remat_policy=policy)
    vag = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {"input_ids": jnp.asarray(tokens)})))
    jloss, jgrads = jax.block_until_ready(vag(jax.tree.map(jnp.asarray, np_params)))
    assert abs(float(jloss) - float(loss)) <= LOSS_TOL
    ref = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    got = dict(_leaves(ttf.params_to_numpy(grads, tcfg)))
    assert sorted(ref) == sorted(got)
    largest = max(float(np.abs(g).max()) for g in ref.values())
    for name, g in ref.items():
        bound = largest if name in ZERO_GRAD_LEAVES else float(np.abs(g).max())
        assert float(np.abs(got[name] - g).max()) <= GRAD_REL_TOL * bound, name


# ---------------------------------------------------------------------------
# 3. the saved sets
# ---------------------------------------------------------------------------

_MM = {torch.ops.aten.mm.default: "mm", torch.ops.aten.addmm.default: "mm",
       torch.ops.aten.bmm.default: "bmm", torch.ops.aten.baddbmm.default: "bmm"}


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MM:
            self.counts[_MM[func]] += 1
        return func(*args, **(kwargs or {}))


def _counts(policy):
    """(forward, backward) product counts of the MoE model's loss under
    ``policy`` (None: remat off)."""
    over = dict(TINY, **MODELS["moe-top2-prmoe"])
    if policy is not None:
        over.update(remat=True, remat_policy=policy)
    tcfg = ttf.TransformerConfig(**over)
    tparams = ttf.params_from_numpy(_params("moe-top2-prmoe"), tcfg, "cpu")
    ttf.map_params(lambda p: p.requires_grad_(True), tparams)
    tokens = torch.from_numpy(_tokens()).long()
    with _CountProducts() as fwd:
        loss = ttf.loss_fn(tparams, tcfg, {"input_ids": tokens})
    with _CountProducts() as bwd:
        loss.backward()
    return fwd.counts, bwd.counts


def test_the_policies_save_the_reference_s_sets():
    fwd, bwd_off = _counts(None)
    # every product but the vocab head's is inside the layers
    layer = {"mm": fwd["mm"] - 1, "bmm": fwd["bmm"]}
    L = TINY["num_layers"]
    # per layer: the qkv, attention-out, router, residual MLP (2) and
    # coefficient products; the 2 attention einsums and the 2 expert products
    assert layer == {"mm": 6 * L, "bmm": 4 * L}, layer
    rerun = {}
    for policy in POLICIES:
        f, b = _counts(policy)
        assert f == fwd, policy
        rerun[policy] = {k: b[k] - bwd_off[k] for k in b}
    assert rerun["nothing_saveable"] == layer
    assert rerun["dots_saveable"] == {"mm": 0, "bmm": 0}
    assert rerun["dots_with_no_batch_dims"] == {"mm": 0, "bmm": layer["bmm"]}
    assert rerun["full"] == {"mm": 0, "bmm": 0}


# ---------------------------------------------------------------------------
# 4. profile ranges, the public checkpoint(), the RNG tracker
# ---------------------------------------------------------------------------

def test_profile_puts_each_layer_in_a_checkpoint_layer_range():
    tckpt.configure(profile=True)
    tcfg = ttf.TransformerConfig(**TINY, remat=True)
    params = ttf.init(torch.Generator().manual_seed(0), tcfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ttf.forward(params, tcfg, torch.zeros(1, 8, dtype=torch.long))
    names = [e.name for e in prof.events()]
    assert names.count("checkpoint_layer") == TINY["num_layers"]


def test_checkpoint_keeps_the_rng_state_across_the_recompute():
    x = torch.randn(64, requires_grad=True)

    def fn(t):
        return torch.nn.functional.dropout(t * 2.0, p=0.5, training=True).sum() * t

    torch.manual_seed(3)
    plain = torch.autograd.grad(fn(x).sum(), x)[0]
    for policy in ("nothing_saveable", "dots_saveable"):
        tckpt.configure(deepspeed_config={"activation_checkpointing": {"policy": policy}})
        torch.manual_seed(3)
        again = torch.autograd.grad(tckpt.checkpoint(fn, x).sum(), x)[0]
        assert torch.equal(plain, again), policy


def test_the_rng_tracker_forks_named_streams():
    tracker = tckpt.get_rng_tracker()
    tckpt.model_parallel_seed(7, tp_rank=1)
    assert sorted(tracker.get_states()) == ["default", "model-parallel-rng"]
    states = tracker.get_states()
    a = torch.rand(4, generator=tracker.fork())
    b = torch.rand(4, generator=tracker.fork())
    assert not torch.equal(a, b)
    tracker.set_states(states)
    assert torch.equal(torch.rand(4, generator=tracker.fork()), a)
    with pytest.raises(Exception, match="already exists"):
        tracker.add("default", 1)
    with pytest.raises(Exception, match="not added"):
        tracker.fork("nope")
    tckpt.model_parallel_seed(7, tp_rank=0)
    assert not torch.equal(torch.rand(4, generator=tracker.fork()), a)
