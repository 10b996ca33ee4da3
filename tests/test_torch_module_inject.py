"""HF models in and out of the port (``deepspeed_tpu_torch/module_inject``:
the policies, the config and checkpoint readers, AutoTP and the export)
against the reference's ``deepspeed_tpu/module_inject`` and against HF
itself, in f32 on the CPU, at the reference tests' tiny sizes
(``tests/unit/inference/test_inference.py``, ``test_hf_export.py``).
``transformers`` and ``safetensors`` are the oracles here; the port imports
neither.

Tolerances:
  - converted trees, configs, exports and checkpoint reads: exact (the same
    values moved, sliced and transposed; a bf16 tree equals the reference's
    f32 one after ``.float()``, since bf16 -> f32 is exact);
  - logits against HF's: 2e-3 absolute for the port and for the reference,
    the reference's own bar (HF's attention and norms round in another
    order through 2 layers);
  - greedy streams: equal to the reference's, or first differing at a step
    whose reference top-2 logit margin is under 1e-4 (a tie f32 summation
    order may break; reported, not failed).
"""

import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.inference.continuous import ContinuousBatchingEngine as JPool
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.module_inject import export as jexport
from deepspeed_tpu.module_inject import load_checkpoint as jload
from deepspeed_tpu.module_inject import policies as jpol
from deepspeed_tpu_torch.inference import ContinuousBatchingEngine as TPool
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.module_inject import auto_tp as tauto
from deepspeed_tpu_torch.module_inject import export as texport
from deepspeed_tpu_torch.module_inject import load_checkpoint as tload
from deepspeed_tpu_torch.module_inject import policies as tpol

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

LOGITS_TOL = 2e-3
TIE = 1e-4
V = 128


def _tiny(name):
    """The reference tests' tiny HF models (random weights, seed 0)."""
    T = transformers
    torch.manual_seed(0)
    common = dict(vocab_size=V, max_position_embeddings=64)
    makers = {
        "gpt2": lambda: T.GPT2LMHeadModel(T.GPT2Config(
            vocab_size=V, n_positions=64, n_embd=32, n_layer=2, n_head=4,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)),
        "llama": lambda: T.LlamaForCausalLM(T.LlamaConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, tie_word_embeddings=False, **common)),
        "mistral": lambda: T.MistralForCausalLM(T.MistralConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, sliding_window=8, attn_implementation="eager", **common)),
        "opt": lambda: T.OPTForCausalLM(T.OPTConfig(
            hidden_size=32, ffn_dim=64, num_hidden_layers=2, num_attention_heads=4,
            word_embed_proj_dim=32, dropout=0.0, attention_dropout=0.0,
            activation_function="relu", **common)),
        "opt-postln": lambda: T.OPTForCausalLM(T.OPTConfig(
            hidden_size=32, ffn_dim=64, num_hidden_layers=2, num_attention_heads=4,
            word_embed_proj_dim=32, do_layer_norm_before=False, dropout=0.0,
            attention_dropout=0.0, activation_function="relu", **common)),
        "gptneo": lambda: T.GPTNeoForCausalLM(T.GPTNeoConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            attention_types=[[["global", "local"], 1]], window_size=4,
            resid_dropout=0.0, embed_dropout=0.0, attention_dropout=0.0, **common)),
        "bloom": lambda: T.BloomForCausalLM(T.BloomConfig(
            vocab_size=V, hidden_size=32, n_layer=2, n_head=4, hidden_dropout=0.0,
            attention_dropout=0.0)),
        "gptneox": lambda: T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            rotary_pct=0.5, use_parallel_residual=True, hidden_dropout=0.0,
            attention_dropout=0.0, **common)),
        "gptj": lambda: T.GPTJForCausalLM(T.GPTJConfig(
            vocab_size=V, n_positions=64, n_embd=32, n_layer=2, n_head=4, rotary_dim=4,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)),
        "bert": lambda: T.BertModel(T.BertConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            type_vocab_size=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            **common), add_pooling_layer=False),
        "bert-mlm": lambda: T.BertForMaskedLM(T.BertConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            type_vocab_size=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            **common)),
        "distilbert": lambda: T.DistilBertModel(T.DistilBertConfig(
            dim=32, hidden_dim=64, n_layers=2, n_heads=4, dropout=0.0, attention_dropout=0.0,
            **common)),
        "distilbert-mlm": lambda: T.DistilBertForMaskedLM(T.DistilBertConfig(
            dim=32, hidden_dim=64, n_layers=2, n_heads=4, dropout=0.0, attention_dropout=0.0,
            **common)),
        "clip-text": lambda: T.CLIPTextModel(T.CLIPTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            hidden_act="quick_gelu", attention_dropout=0.0, **common)),
        # no explicit policy: the AutoTP fallback
        "qwen2": lambda: T.Qwen2ForCausalLM(T.Qwen2Config(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, tie_word_embeddings=False, attention_dropout=0.0, **common)),
        "stablelm": lambda: T.StableLmForCausalLM(T.StableLmConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, partial_rotary_factor=0.5, attention_dropout=0.0,
            hidden_dropout=0.0, tie_word_embeddings=False, **common)),
    }
    return makers[name]().eval()


SERVABLE = ["gpt2", "llama", "mistral", "opt", "opt-postln", "gptneo", "bloom", "gptneox",
            "gptj"]
ENCODERS = ["bert", "bert-mlm", "distilbert", "distilbert-mlm", "clip-text"]
AUTOTP = ["qwen2", "stablelm"]
# the variant families every engine path is driven on: ALiBi (BLOOM),
# post-LN, the parallel residual (GPT-NeoX; GPT-J with the shared LN), and
# the Llama family
PATH_FAMILIES = ["bloom", "opt-postln", "gptneox", "gptj", "llama"]


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _tiny(name)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory, models):
    """Each family saved by HF in 30 kB safetensors shards."""
    cache = {}

    def get(name):
        if name not in cache:
            path = str(tmp_path_factory.mktemp(name.replace("-", "_")))
            models(name).save_pretrained(path, max_shard_size="30kB", safe_serialization=True)
            cache[name] = path
        return cache[name]

    return get


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _assert_trees_equal(ref, port):
    """Leaf for leaf: the same paths, shapes and f32 values."""
    ref, port = dict(_leaves(ref)), dict(_leaves(port))
    assert ref.keys() == port.keys(), set(ref) ^ set(port)
    for path, r in ref.items():
        p = port[path]
        assert torch.is_tensor(p), path
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(r, np.float32),
                                      err_msg=".".join(path))


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVABLE + ENCODERS + AUTOTP)
def test_converted_tree_matches_reference(models, name):
    hf = models(name)
    jcfg, jparams = jpol.convert_hf_model(hf)
    tcfg, tparams = tpol.convert_hf_model(hf)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(jparams, tparams)


@pytest.mark.parametrize("name", ["llama", "bloom", "gptj"])
def test_bf16_weights_keep_their_dtype(models, name):
    """A bf16 model converts to bf16 tensors (no f32 copy on the host) whose
    values are the reference's f32 conversion of the same weights."""
    hf = _tiny(name).to(torch.bfloat16)
    _, jparams = jpol.convert_hf_model(hf)
    _, tparams = tpol.convert_hf_model(hf)
    _assert_trees_equal(jparams, tparams)
    stored = {p: t.dtype for p, t in _leaves(tparams)}
    assert stored[("embed", "tok")] == torch.bfloat16
    assert stored[("layers", "attn", "wq")] == torch.bfloat16


def _megatron_state(version, rs, D=8, L=1, nh=2, hd=4, S=16):
    """The reference test's synthetic Megatron state dict: a fused (3D, D)
    query_key_value in the given row layout, distinct q/k/v constants."""
    wq, wk, wv = (np.full((D, D), c, np.float32) for c in (1.0, 2.0, 3.0))
    if version >= 2:
        fused = np.concatenate([w.T[h * hd:(h + 1) * hd] for h in range(nh)
                                for w in (wq, wk, wv)], axis=0)
    else:
        fused = np.concatenate([wq.T, wk.T, wv.T], axis=0)
    state = {"embedding.word_embeddings.weight": rs.randn(V, D),
             "embedding.position_embeddings.weight": rs.randn(S, D),
             "transformer.final_layernorm.weight": 1 + 0.1 * rs.randn(D),
             "transformer.final_layernorm.bias": 0.1 * rs.randn(D)}
    for i in range(L):
        p = f"transformer.layers.{i}."
        state.update({
            p + "attention.query_key_value.weight": fused + 0.1 * rs.randn(*fused.shape),
            p + "attention.query_key_value.bias": np.arange(3 * D) / 10,
            p + "attention.dense.weight": rs.randn(D, D) / 3,
            p + "attention.dense.bias": 0.1 * rs.randn(D),
            p + "mlp.dense_h_to_4h.weight": rs.randn(4 * D, D) / 3,
            p + "mlp.dense_h_to_4h.bias": 0.1 * rs.randn(4 * D),
            p + "mlp.dense_4h_to_h.weight": rs.randn(D, 4 * D) / 6,
            p + "mlp.dense_4h_to_h.bias": 0.1 * rs.randn(D),
            p + "input_layernorm.weight": 1 + 0.1 * rs.randn(D),
            p + "input_layernorm.bias": 0.1 * rs.randn(D),
            p + "post_attention_layernorm.weight": 1 + 0.1 * rs.randn(D),
            p + "post_attention_layernorm.bias": 0.1 * rs.randn(D),
        })
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


class _MegatronConfig:
    model_type = "megatron_gpt2"
    architectures = ["MegatronGPT2LMHeadModel"]
    vocab_size = V
    hidden_size = 8
    num_layers = 2
    num_attention_heads = 2
    max_position_embeddings = 32

    def __init__(self, version):
        self.checkpoint_version = version


class _Megatron:
    """An HF-like object (``state_dict()`` and ``config``) holding a
    Megatron checkpoint of the given row layout."""

    def __init__(self, version, seed=0):
        self.config = _MegatronConfig(version)
        self._state = _megatron_state(version, np.random.RandomState(seed), L=2, S=32)

    def state_dict(self):
        return dict(self._state)


@pytest.mark.parametrize("version", [0, 2])
def test_megatron_layouts_match_reference(version):
    """Both fused-qkv row layouts split as the reference splits them, by the
    version the checkpoint carries and by the one a policy is built with."""
    state = _megatron_state(version, np.random.RandomState(0))

    class Cfg:
        vocab_size, hidden_size, num_layers = V, 8, 1
        num_attention_heads, max_position_embeddings = 2, 16

    jp, tp = jpol.MegatronGPTPolicy(version), tpol.MegatronGPTPolicy(version)
    jcfg, tcfg = jp.config(Cfg()), tp.config(Cfg())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(jp.params(state, jcfg), tp.params(state, tcfg))
    model = _Megatron(version)
    _assert_trees_equal(jpol.convert_hf_model(model)[1], tpol.convert_hf_model(model)[1])


def test_policy_dispatch_matches_reference(models):
    class Unknown:
        architectures = ["T5ForConditionalGeneration"]
        model_type = "t5"

    with pytest.raises(ValueError, match="no injection policy"):
        tpol.policy_for(Unknown())
    for name in SERVABLE + ENCODERS:
        cfg = models(name).config
        assert type(tpol.policy_for(cfg)).__name__ == type(jpol.policy_for(cfg)).__name__
    assert isinstance(tpol.policy_for(_MegatronConfig(2)), tpol.MegatronGPTPolicy)
    assert [p.__name__ for p in tpol.POLICIES] == [p.__name__ for p in jpol.POLICIES]


def test_partition_rules_wait_for_the_mesh(models):
    """``partition_rules`` (the table a converted model's ``mesh.rules``
    takes) equals the reference's, bare and for every servable family."""
    def table(rules):
        return [(pattern, tuple(spec)) for pattern, spec in rules]

    assert table(tpol.partition_rules()) == table(jpol.partition_rules())
    for name in SERVABLE:
        cfg = models(name).config
        assert table(tpol.partition_rules(cfg)) == table(jpol.partition_rules(cfg))


@pytest.mark.parametrize("name", AUTOTP)
def test_autotp_tree_matches_the_model_shapes(models, name):
    """The fallback's tree is held to ``reference_shapes``, the shapes of
    the reference's ``jax.eval_shape(init)`` for the same config."""
    hf = models(name)
    with pytest.raises(ValueError):
        tpol.policy_for(hf.config)  # really not in the explicit list
    cfg, params = tpol.convert_hf_model(hf)
    jshapes = jax.eval_shape(lambda r: jtf.init(r, jtf.TransformerConfig(
        **dataclasses.asdict(cfg))), jax.random.PRNGKey(0))
    want = {p: tuple(s.shape) for p, s in _leaves(jshapes)}
    assert {p: tuple(t.shape) for p, t in _leaves(params)} == want
    policy = tauto.auto_policy(dict(hf.state_dict()))
    with pytest.raises(ValueError, match="shape mismatch"):
        tauto._align_to_abstract(
            {**params, "final_norm": {"scale": torch.zeros(3)}}, cfg)
    assert policy.config(hf.config) == cfg


# ---------------------------------------------------------------------------
# logits against HF, for the port and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVABLE + AUTOTP)
def test_logits_match_hf(models, name):
    hf = models(name)
    toks = np.random.RandomState(0).randint(0, V, (2, 16)).astype(np.int64)
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.numpy()
    jcfg, jparams = jpol.convert_hf_model(hf)
    ref = np.asarray(jtf.apply(jax.tree.map(jnp.asarray, jparams), jcfg,
                               jnp.asarray(toks, jnp.int32)))
    eng = deepspeed_tpu_torch.init_inference(hf, config={"dtype": "float32"}, device="cpu")
    out = eng.forward(toks).numpy()
    assert np.max(np.abs(ref - want)) <= LOGITS_TOL
    assert np.max(np.abs(out - want)) <= LOGITS_TOL


@pytest.mark.parametrize("name", ENCODERS)
def test_encoders_convert_but_do_not_serve(models, name):
    """The encoder policies convert exactly (above); serving them is item
    10's."""
    with pytest.raises(NotImplementedError, match="item 10"):
        deepspeed_tpu_torch.init_inference(models(name), config={"dtype": "float32"},
                                           device="cpu")


# ---------------------------------------------------------------------------
# the config reader
# ---------------------------------------------------------------------------

def _config_pair(path):
    """(reference: AutoConfig -> config_from_hf, port: HFConfig ->
    config_from_hf) for a saved config directory."""
    want = jpol.config_from_hf(transformers.AutoConfig.from_pretrained(path))
    got = tpol.config_from_hf(tload.HFConfig.from_pretrained(path))
    return dataclasses.asdict(want), dataclasses.asdict(got)


@pytest.mark.parametrize("name", SERVABLE + ENCODERS)
def test_config_reader_matches_autoconfig(models, tmp_path, name):
    """A ``save_pretrained`` directory (transformers writes only the values
    that differ from its class's defaults) reads as ``AutoConfig`` reads it;
    so does the class's all-default config, whose file omits every field."""
    config = models(name).config
    config.save_pretrained(str(tmp_path / "tiny"))
    want, got = _config_pair(str(tmp_path / "tiny"))
    assert got == want
    type(config)().save_pretrained(str(tmp_path / "default"))
    want, got = _config_pair(str(tmp_path / "default"))
    assert got == want


def test_config_reader_nested_clip_and_aliases(tmp_path):
    T = transformers
    config = T.CLIPConfig(text_config=dict(vocab_size=V, hidden_size=32, intermediate_size=64,
                                           num_hidden_layers=2, num_attention_heads=4))
    config.save_pretrained(str(tmp_path))
    want, got = _config_pair(str(tmp_path))
    assert got == want
    # an alias in the file (BLOOM's num_attention_heads is n_head)
    cfg = tload.HFConfig({"model_type": "bloom", "num_attention_heads": 6, "n_embed": 48})
    assert cfg.n_head == 6 and cfg.num_attention_heads == 6 and cfg.hidden_size == 48


@pytest.mark.parametrize("family", sorted(chip_smoke.HF_FAMILIES))
def test_published_configs_read_as_transformers_reads_them(tmp_path, family):
    """``chip_smoke.py``'s published ``config.json`` values (typed in, as
    the card's machine has no transformers) read through the port's reader
    as ``AutoConfig`` reads the same file."""
    values = chip_smoke.HF_FAMILIES[family]["config"]
    with open(tmp_path / "config.json", "w") as f:
        json.dump(values, f)
    want, got = _config_pair(str(tmp_path))
    assert got == want


def test_config_save_pretrained_round_trips(tmp_path):
    cfg = tload.HFConfig(chip_smoke.HF_FAMILIES["EleutherAI/gpt-neo-125M"]["config"])
    cfg.save_pretrained(str(tmp_path))
    again = tload.HFConfig.from_pretrained(str(tmp_path))
    assert again.to_dict() == cfg.to_dict()
    assert tpol.config_from_hf(again) == tpol.config_from_hf(cfg)


# ---------------------------------------------------------------------------
# the checkpoint readers
# ---------------------------------------------------------------------------

def test_safetensors_reader_matches_safetensors(tmp_path):
    rs = np.random.RandomState(0)
    tensors = {
        "f32": torch.from_numpy(rs.randn(7, 5).astype(np.float32)),
        "bf16": torch.from_numpy(rs.randn(3, 4, 6).astype(np.float32)).to(torch.bfloat16),
        "f16": torch.from_numpy(rs.randn(9).astype(np.float32)).to(torch.float16),
        "i64": torch.arange(-5, 6, dtype=torch.int64),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "bool": torch.tensor([True, False, True]),
        "u8_odd": torch.arange(3, dtype=torch.uint8),  # puts the next tensor off alignment
        "bf16_after_odd": torch.ones(5, dtype=torch.bfloat16) * 1.5,
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    want = safetensors_torch.load_file(path)
    got = tload.load_file(path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_sharded_checkpoint_matches_reference(models, tmp_path, fmt):
    """30 kB shards in both formats convert to the reference's tree. Shard
    opens are reported for both packages: the reference reads a whole shard
    on each miss of its one-shard cache, and the policies walk kind-major,
    so a shard boundary inside a stack costs it a whole re-read a kind; the
    port reads per tensor, each tensor's bytes once."""
    hf = models("gpt2")
    hf.save_pretrained(str(tmp_path), max_shard_size="30kB",
                       safe_serialization=fmt == "safetensors")
    jstate = jload.ShardedStateDict(str(tmp_path), cache_shards=1)
    tstate = tload.ShardedStateDict(str(tmp_path), cache_shards=1)
    shards = sorted(set(tstate.weight_map.values()))
    assert len(shards) > 1 and tstate.weight_map == jstate.weight_map
    jcfg, jparams = jload.convert_hf_checkpoint(str(tmp_path), cache_shards=1)
    tcfg, tparams = tload.convert_hf_checkpoint(str(tmp_path), cache_shards=1)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(jparams, tparams)

    policy = tpol.policy_for(tload.HFConfig.from_pretrained(str(tmp_path)))
    policy.params(tstate, tcfg)
    jpol.policy_for(transformers.AutoConfig.from_pretrained(str(tmp_path))).params(jstate, jcfg)
    tensor_bytes = sum(t.numel() * t.element_size() for n in shards
                       for t in tload.load_file(os.path.join(str(tmp_path), n)).values())
    warnings.warn(f"{fmt}: {len(shards)} shards; shard loads: reference {jstate.shard_loads} "
                  f"(each a whole-shard read), port {tstate.shard_loads} (header reads); "
                  f"tensor bytes read: port {tstate.bytes_read} of {tensor_bytes}")
    assert tstate.shard_loads <= jstate.shard_loads
    assert tstate.bytes_read <= tensor_bytes  # no tensor read twice
    for k in tstate.keys():
        tstate[k]
    assert len(tstate._cache) == 1  # never more than cache_shards open


def test_single_files_and_a_missing_checkpoint(models, tmp_path):
    hf = models("llama")
    for fmt, safe in (("st", True), ("bin", False)):
        path = str(tmp_path / fmt)
        hf.save_pretrained(path, safe_serialization=safe)
        state = tload.ShardedStateDict(path)
        assert state.shard_loads == 1 and len(state) == len(hf.state_dict())
        _assert_trees_equal(jload.convert_hf_checkpoint(path)[1],
                            tload.convert_hf_checkpoint(path)[1])
    with pytest.raises(FileNotFoundError, match="no HF checkpoint"):
        tload.ShardedStateDict(str(tmp_path))


# ---------------------------------------------------------------------------
# the export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,arch", [("gpt2", "gpt2"), ("llama", "llama"),
                                       ("mistral", "mistral")])
def test_export_matches_reference(models, name, arch):
    jcfg, jparams = jpol.convert_hf_model(models(name))
    tcfg, tparams = tpol.convert_hf_model(models(name))
    port_tree = ttf.params_from_numpy(tparams, tcfg, "cpu")
    want = jexport.export_hf_state_dict(jparams, jcfg, arch)
    got = texport.export_hf_state_dict(port_tree, tcfg, arch)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
    with pytest.raises(NotImplementedError, match="gpt2 and llama"):
        texport.export_hf_state_dict(port_tree, tcfg, "bloom")


@pytest.mark.parametrize("name,arch", [("gpt2", "gpt2"), ("llama", "llama")])
def test_saved_checkpoint_loads_in_hf_and_in_the_reference(models, tmp_path, name, arch):
    """``save_hf_checkpoint`` with the port's own config object: the state
    dict loads strictly into a fresh HF model of the saved config (whose
    logits then equal the source's), and the directory converts in the
    reference (``AutoConfig`` reads the port's config.json)."""
    hf = models(name)
    eng = deepspeed_tpu_torch.init_inference(hf, config={"dtype": "float32"}, device="cpu")
    hf_config = tload.HFConfig(hf.config.to_dict())
    path = texport.save_hf_checkpoint(str(tmp_path), eng.params, eng.cfg, arch,
                                      hf_config=hf_config)
    state = torch.load(path, weights_only=True)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in state.values())
    fresh = transformers.AutoModelForCausalLM.from_config(
        transformers.AutoConfig.from_pretrained(str(tmp_path))).eval()
    fresh.load_state_dict(state, strict=True)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, V, (2, 12)))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(toks).logits.numpy(), hf(toks).logits.numpy())
    jcfg, jparams = jload.convert_hf_checkpoint(str(tmp_path))
    _assert_trees_equal(jparams, tload.convert_hf_checkpoint(str(tmp_path))[1])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(eng.cfg)


# ---------------------------------------------------------------------------
# greedy streams of init_inference on every path, against the reference
# ---------------------------------------------------------------------------

PROMPT, NEW = 10, 8


def _prompts(seed=1):
    return np.random.RandomState(seed).randint(0, V, (2, PROMPT)).astype(np.int32)


def _assert_streams_agree(jeng, want, got, prompt_len):
    """Equal, or first differing (row by row) at a reference tie."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    for b in range(want.shape[0]):
        diff = np.nonzero(want[b] != got[b])[0]
        if not diff.size:
            continue
        j = int(diff[0])
        assert j >= prompt_len
        logits = np.asarray(jtf.apply(jeng.params, jeng.cfg, jnp.asarray(want[b:b + 1, :j])))
        top2 = np.sort(logits[0, -1])[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"row {b} differs at position {j} (reference margin {margin})"
        warnings.warn(f"row {b}: a tie at position {j} (reference margin {margin:.3g})")


def _engines(source, **config):
    config = dict(config, dtype="float32")
    comm.destroy()
    ref = deepspeed_tpu.init_inference(source, config=config)
    port = deepspeed_tpu_torch.init_inference(source, config=config, device="cpu")
    return ref, port


def _megatron_or(models, name):
    return _Megatron(2) if name == "megatron" else models(name)


@pytest.mark.parametrize("name", SERVABLE + ["megatron"])
def test_aligned_streams_from_an_hf_model(models, name):
    ref, port = _engines(_megatron_or(models, name))
    toks = _prompts()
    _assert_streams_agree(ref, ref.generate(toks, max_new_tokens=NEW),
                          port.generate(toks, max_new_tokens=NEW), PROMPT)


@pytest.mark.parametrize("name", SERVABLE)
def test_aligned_streams_from_a_checkpoint_dir(ckpt_dirs, name):
    ref, port = _engines(ckpt_dirs(name))
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    toks = _prompts(seed=2)
    _assert_streams_agree(ref, ref.generate(toks, max_new_tokens=NEW),
                          port.generate(toks, max_new_tokens=NEW), PROMPT)


def test_attn_impl_override_as_the_reference(models):
    """``InferenceConfig.attn_impl`` overrides the policy's choice in both."""
    ref, port = _engines(models("gpt2"), attn_impl="pallas")
    assert port.cfg.attn_impl == ref.cfg.attn_impl == "pallas"
    ref, port = _engines(models("llama"), attn_impl="xla")
    assert port.cfg.attn_impl == ref.cfg.attn_impl == "xla"
    toks = _prompts()
    _assert_streams_agree(ref, ref.generate(toks, max_new_tokens=NEW),
                          port.generate(toks, max_new_tokens=NEW), PROMPT)


def _ragged():
    rs = np.random.RandomState(3)
    lens = [PROMPT, 6]
    toks = np.zeros((2, PROMPT), np.int32)
    mask = np.zeros((2, PROMPT), np.float32)
    for b, n in enumerate(lens):
        toks[b, PROMPT - n:] = rs.randint(0, V, n)
        mask[b, PROMPT - n:] = 1
    return toks, mask


@pytest.mark.parametrize("path", ["ragged", "chunked", "per-token"])
@pytest.mark.parametrize("name", PATH_FAMILIES)
def test_streams_on_every_generate_path(models, ckpt_dirs, name, path):
    """Ragged prompts (left padded), chunked prefill (chunks of 4) and the
    per-token loop with bucket migration (floor 8), from the checkpoint
    directory for the ragged path and from the HF module otherwise."""
    config = {"ragged": {}, "chunked": {"prefill_chunk_size": 4},
              "per-token": {"fused_generate": False, "kv_read_floor": 8}}[path]
    source = ckpt_dirs(name) if path == "ragged" else models(name)
    ref, port = _engines(source, **config)
    if path == "ragged":
        toks, mask = _ragged()
        want = ref.generate(toks, max_new_tokens=NEW, attention_mask=mask)
        got = port.generate(toks, max_new_tokens=NEW, attention_mask=mask)
        # each row against the reference's own stream of that row, unpadded
        want, got = np.asarray(want)[:, PROMPT:], got.numpy()[:, PROMPT:]
        for b, n in enumerate([PROMPT, 6]):
            row = toks[b, PROMPT - n:]
            _assert_streams_agree(ref, np.concatenate([row, want[b]])[None],
                                  np.concatenate([row, got[b]])[None], n)
        return
    toks = _prompts(seed=4)
    _assert_streams_agree(ref, ref.generate(toks, max_new_tokens=NEW),
                          port.generate(toks, max_new_tokens=NEW), PROMPT)


@pytest.mark.parametrize("name", PATH_FAMILIES)
def test_pool_tick_streams(models, name):
    """The continuous-batching pool on the same HF module: 3 requests of
    lengths 10, 7 and 4 through 2 slots, the vector-position decode (ALiBi's
    vector read for BLOOM), each stream against the reference pool's."""
    hf = models(name)
    config = {"dtype": "float32", "kv_read_floor": 16}
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, V, (n,)).astype(np.int32) for n in (10, 7, 4)]
    comm.destroy()
    ref, port = (JPool(hf, config=config, max_slots=2, cache_len=32),
                 TPool(hf, config=config, max_slots=2, cache_len=32, device="cpu"))
    results = []
    for pool in (ref, port):
        rids = [pool.submit(p, max_new_tokens=NEW) for p in prompts]
        done = {}
        while pool.has_work():
            pool.step()
            done.update(pool.finished())
        done.update(pool.finished())
        results.append([np.asarray(done[r]) for r in rids])
    for p, want, got in zip(prompts, *results):
        _assert_streams_agree(ref._eng, want[None], got[None], len(p))
