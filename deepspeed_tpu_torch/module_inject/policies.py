"""HF-model injection policies (counterpart of
``deepspeed_tpu/module_inject/policies.py``).

A policy maps an HF architecture onto the port's transformer
(``models/transformer.py``): the config's translation into a
``TransformerConfig`` and the weights' relayout into the reference's param
tree (layers stacked ``(L, ...)``, weights laid out ``x @ w``), which
``models.transformer.params_from_numpy`` bridges into this package's tree.

Policies read a mapping of parameter names to tensors: an HF module's
``state_dict()`` or ``load_checkpoint.ShardedStateDict`` over a checkpoint
directory, or numpy arrays. Unlike the reference's, which casts every tensor
to f32 numpy, they keep the stored dtype (a bf16 checkpoint stays bf16 on the
host), and the inference engine casts each tensor once, to the model dtype.
Biases and norms the architecture lacks are synthesized in f32.

Architectures without a policy fall back to ``auto_tp.AutoTPPolicy`` in
:func:`convert_hf_model`. The encoder policies (BERT, DistilBERT, CLIP text)
convert as the reference's do; serving them raises through
``models.transformer.check_supported`` (ROADMAP.md Queue 1 item 10), and
``partition_rules`` waits for the tensor-parallel mesh (item 8).
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import logger


def _t(t) -> torch.Tensor:
    """A state-dict entry as a tensor of its stored dtype."""
    if torch.is_tensor(t):
        return t.detach()
    a = np.asarray(t)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _zeros(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def _ones(*shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32)


class HFPolicy:
    """Base: subclass per architecture (reference policy ABC, policy.py)."""

    ARCHITECTURES: Tuple[str, ...] = ()

    @classmethod
    def matches(cls, hf_config) -> bool:
        archs = getattr(hf_config, "architectures", None) or []
        mt = getattr(hf_config, "model_type", "")
        return any(a in cls.ARCHITECTURES for a in archs) or mt in cls.ARCHITECTURES

    def config(self, hf_config) -> TransformerConfig:
        raise NotImplementedError

    def params(self, state: Dict[str, Any], cfg: TransformerConfig) -> Dict:
        raise NotImplementedError


def _getter(state, pre, fallback=False):
    """``g(name)``: the tensor under ``pre + name`` (or, with ``fallback``,
    under ``name`` where the prefixed key is absent)."""
    def g(name):
        if fallback and pre + name not in state:
            return _t(state[name])
        return _t(state[pre + name])

    return g


def _stackers(g, L):
    """``stackT(fmt)``: the L layers' torch Linear weights (out, in)
    transposed to (in, out) and stacked; ``stackB(fmt)``: the L layers'
    tensors stacked as they are."""
    def stackT(fmt):
        return torch.stack([g(fmt.format(i)).T for i in range(L)])

    def stackB(fmt):
        return torch.stack([g(fmt.format(i)) for i in range(L)])

    return stackT, stackB


class GPT2Policy(HFPolicy):
    """reference: HFGPT2LayerPolicy (module_inject/containers/gpt2.py)."""

    ARCHITECTURES = ("GPT2LMHeadModel", "gpt2")

    def config(self, hf_config) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.n_embd,
            num_layers=hf_config.n_layer,
            num_heads=hf_config.n_head,
            max_seq_len=hf_config.n_positions,
            pos_embedding="learned",
            norm_type="layernorm",
            activation="gelu",
            tie_embeddings=True,
            use_bias=True,
            norm_eps=hf_config.layer_norm_epsilon,
        )

    def params(self, state, cfg) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        pre = "transformer." if any(k.startswith("transformer.") for k in state) else ""
        g = _getter(state, pre)
        _, stack = _stackers(g, L)
        # Conv1D stores (in, out): y = x @ W + b, already the reference's
        # layout; the fused c_attn is read once a layer and split by columns
        qkv = _stack_split(g, "h.{}.attn.c_attn.weight", L, lambda m: m.split(D, dim=1))
        qkv += _stack_split(g, "h.{}.attn.c_attn.bias", L, lambda b: b.split(D))
        return {
            "embed": {"tok": g("wte.weight"), "pos": g("wpe.weight")},
            "layers": {
                "attn": {
                    **dict(zip(("wq", "wk", "wv", "bq", "bk", "bv"), qkv)),
                    "wo": stack("h.{}.attn.c_proj.weight"),
                    "bo": stack("h.{}.attn.c_proj.bias"),
                },
                "mlp": {
                    "wi": stack("h.{}.mlp.c_fc.weight"),
                    "wo": stack("h.{}.mlp.c_proj.weight"),
                    "bi": stack("h.{}.mlp.c_fc.bias"),
                    "bo": stack("h.{}.mlp.c_proj.bias"),
                },
                "ln1": {"scale": stack("h.{}.ln_1.weight"), "bias": stack("h.{}.ln_1.bias")},
                "ln2": {"scale": stack("h.{}.ln_2.weight"), "bias": stack("h.{}.ln_2.bias")},
            },
            "final_norm": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        }


class GPTNeoPolicy(HFPolicy):
    """reference: HFGPTNEOLayerPolicy (module_inject/containers/gptneo.py):
    a GPT-2-shaped stack with separate bias-free q/k/v Linears, unscaled
    attention logits, and global/local layers (a local layer attends only
    the last ``window_size`` positions: ``local_attn_windows``)."""

    ARCHITECTURES = ("GPTNeoForCausalLM", "GPTNeoModel", "gpt_neo")

    def config(self, hf_config) -> TransformerConfig:
        window = getattr(hf_config, "window_size", 256)
        layers = getattr(hf_config, "attention_layers", None)
        if layers is None:
            layers = ["global"] * hf_config.num_layers
        windows = tuple(window if kind == "local" else 0 for kind in layers)
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_layers,
            num_heads=hf_config.num_heads,
            ffn_hidden_size=getattr(hf_config, "intermediate_size", None) or 4 * hf_config.hidden_size,
            max_seq_len=hf_config.max_position_embeddings,
            pos_embedding="learned",
            norm_type="layernorm",
            activation="gelu",  # gelu_new is the tanh approximation
            tie_embeddings=True,
            use_bias=True,
            norm_eps=hf_config.layer_norm_epsilon,
            attn_scale=1.0,  # GPT-Neo does not scale q @ k^T
            local_attn_windows=windows if any(windows) else None,
        )

    def params(self, state, cfg) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        pre = "transformer." if any(k.startswith("transformer.") for k in state) else ""
        g = _getter(state, pre)
        stackT, stackB = _stackers(g, L)
        return {
            "embed": {"tok": g("wte.weight"), "pos": g("wpe.weight")},
            "layers": {
                "attn": {
                    "wq": stackT("h.{}.attn.attention.q_proj.weight"),
                    "wk": stackT("h.{}.attn.attention.k_proj.weight"),
                    "wv": stackT("h.{}.attn.attention.v_proj.weight"),
                    "wo": stackT("h.{}.attn.attention.out_proj.weight"),
                    # the q/k/v Linears carry no bias
                    "bq": _zeros(L, D), "bk": _zeros(L, D), "bv": _zeros(L, D),
                    "bo": stackB("h.{}.attn.attention.out_proj.bias"),
                },
                "mlp": {
                    "wi": stackT("h.{}.mlp.c_fc.weight"),
                    "wo": stackT("h.{}.mlp.c_proj.weight"),
                    "bi": stackB("h.{}.mlp.c_fc.bias"),
                    "bo": stackB("h.{}.mlp.c_proj.bias"),
                },
                "ln1": {"scale": stackB("h.{}.ln_1.weight"), "bias": stackB("h.{}.ln_1.bias")},
                "ln2": {"scale": stackB("h.{}.ln_2.weight"), "bias": stackB("h.{}.ln_2.bias")},
            },
            "final_norm": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        }


class LlamaPolicy(HFPolicy):
    """reference: the Megatron/LLaMA-family container lineage (v0.9.1
    predates Llama; the mapping follows the same policy pattern)."""

    ARCHITECTURES = ("LlamaForCausalLM", "llama", "MistralForCausalLM", "mistral")

    def config(self, hf_config) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=getattr(hf_config, "num_key_value_heads", None),
            ffn_hidden_size=hf_config.intermediate_size,
            max_seq_len=hf_config.max_position_embeddings,
            pos_embedding="rope",
            norm_type="rmsnorm",
            activation="silu_glu",
            tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
            use_bias=False,
            norm_eps=hf_config.rms_norm_eps,
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
            # the flash kernel, and with it a uniform window's band on the
            # prefill and the rolling KV cache
            attn_impl="pallas",
            # Mistral: one sliding window for every layer (HF `sliding_window`)
            local_attn_windows=(
                (int(hf_config.sliding_window),) * hf_config.num_hidden_layers
                if getattr(hf_config, "sliding_window", None) else None),
        )

    def params(self, state, cfg) -> Dict:
        L = cfg.num_layers
        pre = "model." if any(k.startswith("model.") for k in state) else ""
        g = _getter(state, pre, fallback=True)
        stackT, stackB = _stackers(g, L)
        params = {
            "embed": {"tok": g("embed_tokens.weight")},
            "layers": {
                "attn": {
                    "wq": stackT("layers.{}.self_attn.q_proj.weight"),
                    "wk": stackT("layers.{}.self_attn.k_proj.weight"),
                    "wv": stackT("layers.{}.self_attn.v_proj.weight"),
                    "wo": stackT("layers.{}.self_attn.o_proj.weight"),
                },
                "mlp": {
                    "wg": stackT("layers.{}.mlp.gate_proj.weight"),
                    "wi": stackT("layers.{}.mlp.up_proj.weight"),
                    "wo": stackT("layers.{}.mlp.down_proj.weight"),
                },
                "ln1": {"scale": stackB("layers.{}.input_layernorm.weight")},
                "ln2": {"scale": stackB("layers.{}.post_attention_layernorm.weight")},
            },
            "final_norm": {"scale": g("norm.weight")},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": _t(state["lm_head.weight"]).T}
        return params


class OPTPolicy(HFPolicy):
    """reference: HFOPTLayerPolicy (module_inject/containers/opt.py)."""

    ARCHITECTURES = ("OPTForCausalLM", "opt")

    def config(self, hf_config) -> TransformerConfig:
        if getattr(hf_config, "word_embed_proj_dim", hf_config.hidden_size) != hf_config.hidden_size:
            raise NotImplementedError("OPT word_embed_proj_dim != hidden_size (project_in/out) unsupported")
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            ffn_hidden_size=hf_config.ffn_dim,
            max_seq_len=hf_config.max_position_embeddings,
            pos_embedding="learned",
            norm_type="layernorm",
            # facebook/opt-* use relu; galactica ships the OPT architecture with gelu
            activation=getattr(hf_config, "activation_function", "relu"),
            # OPT-350m ships do_layer_norm_before=False (post-LN)
            norm_position="pre" if getattr(hf_config, "do_layer_norm_before", True) else "post",
            tie_embeddings=getattr(hf_config, "tie_word_embeddings", True),
            use_bias=True,
        )

    def params(self, state, cfg) -> Dict:
        L = cfg.num_layers
        pre = "model.decoder." if any(k.startswith("model.decoder.") for k in state) else "decoder."
        g = _getter(state, pre)
        stackT, stackB = _stackers(g, L)
        params = {
            "embed": {
                "tok": g("embed_tokens.weight"),
                # OPT's learned positions are read at position + 2
                # (OPTLearnedPositionalEmbedding's offset); dropping the first
                # two rows keeps the model's 0-based lookup
                "pos": g("embed_positions.weight")[2:],
            },
            "layers": {
                "attn": {
                    "wq": stackT("layers.{}.self_attn.q_proj.weight"),
                    "wk": stackT("layers.{}.self_attn.k_proj.weight"),
                    "wv": stackT("layers.{}.self_attn.v_proj.weight"),
                    "wo": stackT("layers.{}.self_attn.out_proj.weight"),
                    "bq": stackB("layers.{}.self_attn.q_proj.bias"),
                    "bk": stackB("layers.{}.self_attn.k_proj.bias"),
                    "bv": stackB("layers.{}.self_attn.v_proj.bias"),
                    "bo": stackB("layers.{}.self_attn.out_proj.bias"),
                },
                "mlp": {
                    "wi": stackT("layers.{}.fc1.weight"),
                    "wo": stackT("layers.{}.fc2.weight"),
                    "bi": stackB("layers.{}.fc1.bias"),
                    "bo": stackB("layers.{}.fc2.bias"),
                },
                "ln1": {
                    "scale": stackB("layers.{}.self_attn_layer_norm.weight"),
                    "bias": stackB("layers.{}.self_attn_layer_norm.bias"),
                },
                "ln2": {
                    "scale": stackB("layers.{}.final_layer_norm.weight"),
                    "bias": stackB("layers.{}.final_layer_norm.bias"),
                },
            },
        }
        if cfg.norm_position == "pre":
            params["final_norm"] = {"scale": g("final_layer_norm.weight"),
                                    "bias": g("final_layer_norm.bias")}
        else:
            D = cfg.hidden_size
            params["final_norm"] = {"scale": _ones(D), "bias": _zeros(D)}
        return params


def _stack_split(g, fmt, L, split):
    """The L layers' tensors under ``fmt``, each read once and cut by
    ``split`` into parts: one stack per part."""
    parts = [split(g(fmt.format(i))) for i in range(L)]
    return [torch.stack([p[j] for p in parts]) for j in range(len(parts[0]))]


def _stacked_qkv(g, fmt, L, nh, hd, D):
    """The stacked wq/wk/wv (each (L, D, nh * hd)) and bq/bk/bv of a fused
    query_key_value Linear laid out per head, [h, (q|k|v), hd] (BLOOM,
    GPT-NeoX)."""
    ws = _stack_split(g, fmt + ".weight", L, lambda w: [
        w.reshape(nh, 3, hd, D)[:, j].reshape(nh * hd, D).T for j in range(3)])
    bs = _stack_split(g, fmt + ".bias", L, lambda b: [
        b.reshape(nh, 3, hd)[:, j].reshape(nh * hd) for j in range(3)])
    return dict(zip(("wq", "wk", "wv", "bq", "bk", "bv"), ws + bs))


class BloomPolicy(HFPolicy):
    """reference: BLOOMLayerPolicy (module_inject/containers/bloom.py):
    ALiBi positions, the embedding LayerNorm, a per-head fused qkv."""

    ARCHITECTURES = ("BloomForCausalLM", "BloomModel", "bloom")

    def config(self, hf_config) -> TransformerConfig:
        D = hf_config.hidden_size
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=D,
            num_layers=hf_config.n_layer,
            num_heads=hf_config.n_head,
            max_seq_len=getattr(hf_config, "seq_length", 2048),
            pos_embedding="alibi",
            norm_type="layernorm",
            activation="gelu",
            tie_embeddings=True,
            use_bias=True,
            embed_norm=True,
            norm_eps=hf_config.layer_norm_epsilon,
        )

    def params(self, state, cfg) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        pre = "transformer." if any(k.startswith("transformer.") for k in state) else ""
        g = _getter(state, pre)
        stackT, stackB = _stackers(g, L)
        qkv = _stacked_qkv(g, "h.{}.self_attention.query_key_value", L, cfg.num_heads,
                           cfg.head_dim, D)
        return {
            "embed": {"tok": g("word_embeddings.weight")},
            "embed_norm": {
                "scale": g("word_embeddings_layernorm.weight"),
                "bias": g("word_embeddings_layernorm.bias"),
            },
            "layers": {
                "attn": {
                    **qkv,
                    "wo": stackT("h.{}.self_attention.dense.weight"),
                    "bo": stackB("h.{}.self_attention.dense.bias"),
                },
                "mlp": {
                    "wi": stackT("h.{}.mlp.dense_h_to_4h.weight"),
                    "wo": stackT("h.{}.mlp.dense_4h_to_h.weight"),
                    "bi": stackB("h.{}.mlp.dense_h_to_4h.bias"),
                    "bo": stackB("h.{}.mlp.dense_4h_to_h.bias"),
                },
                "ln1": {
                    "scale": stackB("h.{}.input_layernorm.weight"),
                    "bias": stackB("h.{}.input_layernorm.bias"),
                },
                "ln2": {
                    "scale": stackB("h.{}.post_attention_layernorm.weight"),
                    "bias": stackB("h.{}.post_attention_layernorm.bias"),
                },
            },
            "final_norm": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        }


class GPTNeoXPolicy(HFPolicy):
    """reference: GPTNEOXLayerPolicy (module_inject/containers/gptneox.py):
    the parallel residual, partial rotary (``rotary_pct``), a per-head fused
    qkv."""

    ARCHITECTURES = ("GPTNeoXForCausalLM", "gpt_neox")

    def config(self, hf_config) -> TransformerConfig:
        hd = hf_config.hidden_size // hf_config.num_attention_heads
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            ffn_hidden_size=hf_config.intermediate_size,
            max_seq_len=hf_config.max_position_embeddings,
            pos_embedding="rope",
            rope_dim=int(hd * getattr(hf_config, "rotary_pct", 1.0)),
            rope_theta=getattr(hf_config, "rotary_emb_base", 10000.0),
            norm_type="layernorm",
            activation="gelu",
            parallel_residual=getattr(hf_config, "use_parallel_residual", True),
            tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
            use_bias=True,
            norm_eps=hf_config.layer_norm_eps,
        )

    def params(self, state, cfg) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        pre = "gpt_neox." if any(k.startswith("gpt_neox.") for k in state) else ""
        g = _getter(state, pre, fallback=True)
        stackT, stackB = _stackers(g, L)
        qkv = _stacked_qkv(g, "layers.{}.attention.query_key_value", L, cfg.num_heads,
                           cfg.head_dim, D)
        params = {
            "embed": {"tok": g("embed_in.weight")},
            "layers": {
                "attn": {
                    **qkv,
                    "wo": stackT("layers.{}.attention.dense.weight"),
                    "bo": stackB("layers.{}.attention.dense.bias"),
                },
                "mlp": {
                    "wi": stackT("layers.{}.mlp.dense_h_to_4h.weight"),
                    "wo": stackT("layers.{}.mlp.dense_4h_to_h.weight"),
                    "bi": stackB("layers.{}.mlp.dense_h_to_4h.bias"),
                    "bo": stackB("layers.{}.mlp.dense_4h_to_h.bias"),
                },
                "ln1": {
                    "scale": stackB("layers.{}.input_layernorm.weight"),
                    "bias": stackB("layers.{}.input_layernorm.bias"),
                },
                "ln2": {
                    "scale": stackB("layers.{}.post_attention_layernorm.weight"),
                    "bias": stackB("layers.{}.post_attention_layernorm.bias"),
                },
            },
            "final_norm": {"scale": g("final_layer_norm.weight"), "bias": g("final_layer_norm.bias")},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": _t(state["embed_out.weight"]).T}
        return params


class GPTJPolicy(HFPolicy):
    """reference: HFGPTJLayerPolicy (module_inject/containers/gptj.py): the
    parallel residual with one shared LN, interleaved partial rotary,
    bias-free attention projections, a biased lm head."""

    ARCHITECTURES = ("GPTJForCausalLM", "gptj")

    def config(self, hf_config) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.n_embd,
            num_layers=hf_config.n_layer,
            num_heads=hf_config.n_head,
            max_seq_len=hf_config.n_positions,
            pos_embedding="rope",
            rope_dim=getattr(hf_config, "rotary_dim", None),
            rope_interleaved=True,
            norm_type="layernorm",
            activation="gelu",
            parallel_residual=True,
            shared_ln=True,
            tie_embeddings=False,
            lm_head_bias=True,
            use_bias=True,  # the mlp and ln have biases; the attention's are zero-filled
            norm_eps=hf_config.layer_norm_epsilon,
        )

    def params(self, state, cfg) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        pre = "transformer." if any(k.startswith("transformer.") for k in state) else ""
        g = _getter(state, pre, fallback=True)
        stackT, stackB = _stackers(g, L)
        zeros_b = _zeros(L, D)
        return {
            "embed": {"tok": g("wte.weight")},
            "layers": {
                "attn": {
                    "wq": stackT("h.{}.attn.q_proj.weight"),
                    "wk": stackT("h.{}.attn.k_proj.weight"),
                    "wv": stackT("h.{}.attn.v_proj.weight"),
                    "wo": stackT("h.{}.attn.out_proj.weight"),
                    "bq": zeros_b, "bk": zeros_b, "bv": zeros_b, "bo": zeros_b,
                },
                "mlp": {
                    "wi": stackT("h.{}.mlp.fc_in.weight"),
                    "wo": stackT("h.{}.mlp.fc_out.weight"),
                    "bi": stackB("h.{}.mlp.fc_in.bias"),
                    "bo": stackB("h.{}.mlp.fc_out.bias"),
                },
                "ln1": {"scale": stackB("h.{}.ln_1.weight"), "bias": stackB("h.{}.ln_1.bias")},
                # shared_ln: ln2 is unused; identity keeps the tree uniform
                "ln2": {"scale": _ones(L, D), "bias": zeros_b},
            },
            "final_norm": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
            "lm_head": {"w": _t(state["lm_head.weight"]).T, "b": _t(state["lm_head.bias"])},
        }


def _mlm_head(state, names):
    """The MLM head (dense + act + LayerNorm, then the decoder bias) under
    ``names`` = (dense, LayerNorm, projector bias) prefixes, where the
    state has it."""
    dense, ln, proj_bias = names
    if dense + ".weight" not in state:
        return None
    return {
        "w": _t(state[dense + ".weight"]).T,
        "b": _t(state[dense + ".bias"]),
        "ln_scale": _t(state[ln + ".weight"]),
        "ln_bias": _t(state[ln + ".bias"]),
        "proj_bias": _t(state[proj_bias]),
    }


class BertPolicy(HFPolicy):
    """reference: HFBertLayerPolicy (module_inject/containers/bert.py): a
    post-LN encoder with token-type embeddings and the embedding LayerNorm.
    Serving it raises (the encoders: ROADMAP.md Queue 1 item 10)."""

    ARCHITECTURES = ("BertModel", "BertForMaskedLM", "BertForSequenceClassification", "bert")

    def config(self, hf_config) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            ffn_hidden_size=hf_config.intermediate_size,
            max_seq_len=hf_config.max_position_embeddings,
            pos_embedding="learned",
            norm_type="layernorm",
            activation="gelu",
            norm_position="post",
            causal=False,
            type_vocab_size=getattr(hf_config, "type_vocab_size", 2),
            embed_norm=True,
            tie_embeddings=True,
            use_bias=True,
            norm_eps=hf_config.layer_norm_eps,
        )

    def params(self, state, cfg) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        pre = "bert." if any(k.startswith("bert.") for k in state) else ""
        g = _getter(state, pre)
        stackT, stackB = _stackers(g, L)
        params = {
            "embed": {
                "tok": g("embeddings.word_embeddings.weight"),
                "pos": g("embeddings.position_embeddings.weight"),
                "type": g("embeddings.token_type_embeddings.weight"),
            },
            "embed_norm": {
                "scale": g("embeddings.LayerNorm.weight"),
                "bias": g("embeddings.LayerNorm.bias"),
            },
            "layers": {
                "attn": {
                    "wq": stackT("encoder.layer.{}.attention.self.query.weight"),
                    "wk": stackT("encoder.layer.{}.attention.self.key.weight"),
                    "wv": stackT("encoder.layer.{}.attention.self.value.weight"),
                    "wo": stackT("encoder.layer.{}.attention.output.dense.weight"),
                    "bq": stackB("encoder.layer.{}.attention.self.query.bias"),
                    "bk": stackB("encoder.layer.{}.attention.self.key.bias"),
                    "bv": stackB("encoder.layer.{}.attention.self.value.bias"),
                    "bo": stackB("encoder.layer.{}.attention.output.dense.bias"),
                },
                "mlp": {
                    "wi": stackT("encoder.layer.{}.intermediate.dense.weight"),
                    "wo": stackT("encoder.layer.{}.output.dense.weight"),
                    "bi": stackB("encoder.layer.{}.intermediate.dense.bias"),
                    "bo": stackB("encoder.layer.{}.output.dense.bias"),
                },
                # post-LN: ln1 = attention.output.LayerNorm, ln2 = output.LayerNorm
                "ln1": {
                    "scale": stackB("encoder.layer.{}.attention.output.LayerNorm.weight"),
                    "bias": stackB("encoder.layer.{}.attention.output.LayerNorm.bias"),
                },
                "ln2": {
                    "scale": stackB("encoder.layer.{}.output.LayerNorm.weight"),
                    "bias": stackB("encoder.layer.{}.output.LayerNorm.bias"),
                },
            },
            # unused at post-LN (no final norm); identity for the shape
            "final_norm": {"scale": _ones(D), "bias": _zeros(D)},
        }
        # BertForMaskedLM's head: cls.predictions.transform + the decoder bias
        head = _mlm_head(state, ("cls.predictions.transform.dense",
                                 "cls.predictions.transform.LayerNorm", "cls.predictions.bias"))
        if head is not None:
            params["mlm_head"] = head
        return params


class DistilBertPolicy(HFPolicy):
    """reference: HFDistilBertLayerPolicy (module_inject/containers/
    distil_bert.py): a BERT-family post-LN encoder without token types.
    Serving it raises (the encoders: ROADMAP.md Queue 1 item 10)."""

    ARCHITECTURES = ("DistilBertModel", "DistilBertForMaskedLM",
                     "DistilBertForSequenceClassification", "distilbert")

    def config(self, hf_config) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.dim,
            num_layers=hf_config.n_layers,
            num_heads=hf_config.n_heads,
            ffn_hidden_size=hf_config.hidden_dim,
            max_seq_len=hf_config.max_position_embeddings,
            pos_embedding="learned",
            norm_type="layernorm",
            activation="gelu",
            norm_position="post",
            causal=False,
            type_vocab_size=0,
            embed_norm=True,
            tie_embeddings=True,
            use_bias=True,
            norm_eps=1e-12,
        )

    def params(self, state, cfg) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        pre = "distilbert." if any(k.startswith("distilbert.") for k in state) else ""
        g = _getter(state, pre)
        stackT, stackB = _stackers(g, L)
        params = {
            "embed": {
                "tok": g("embeddings.word_embeddings.weight"),
                "pos": g("embeddings.position_embeddings.weight"),
            },
            "embed_norm": {
                "scale": g("embeddings.LayerNorm.weight"),
                "bias": g("embeddings.LayerNorm.bias"),
            },
            "layers": {
                "attn": {
                    "wq": stackT("transformer.layer.{}.attention.q_lin.weight"),
                    "wk": stackT("transformer.layer.{}.attention.k_lin.weight"),
                    "wv": stackT("transformer.layer.{}.attention.v_lin.weight"),
                    "wo": stackT("transformer.layer.{}.attention.out_lin.weight"),
                    "bq": stackB("transformer.layer.{}.attention.q_lin.bias"),
                    "bk": stackB("transformer.layer.{}.attention.k_lin.bias"),
                    "bv": stackB("transformer.layer.{}.attention.v_lin.bias"),
                    "bo": stackB("transformer.layer.{}.attention.out_lin.bias"),
                },
                "mlp": {
                    "wi": stackT("transformer.layer.{}.ffn.lin1.weight"),
                    "wo": stackT("transformer.layer.{}.ffn.lin2.weight"),
                    "bi": stackB("transformer.layer.{}.ffn.lin1.bias"),
                    "bo": stackB("transformer.layer.{}.ffn.lin2.bias"),
                },
                # post-LN: ln1 after the attention's residual, ln2 after the mlp's
                "ln1": {
                    "scale": stackB("transformer.layer.{}.sa_layer_norm.weight"),
                    "bias": stackB("transformer.layer.{}.sa_layer_norm.bias"),
                },
                "ln2": {
                    "scale": stackB("transformer.layer.{}.output_layer_norm.weight"),
                    "bias": stackB("transformer.layer.{}.output_layer_norm.bias"),
                },
            },
            "final_norm": {"scale": _ones(D), "bias": _zeros(D)},
        }
        # DistilBertForMaskedLM's head: vocab_transform + vocab_layer_norm +
        # the projector's bias (its weight is tied to the embedding)
        head = _mlm_head(state, ("vocab_transform", "vocab_layer_norm", "vocab_projector.bias"))
        if head is not None:
            params["mlm_head"] = head
        return params


class MegatronGPTPolicy(HFPolicy):
    """reference: MegatronLayerPolicy (module_inject/containers/
    megatron_gpt.py): Megatron-LM GPT checkpoints with a fused
    query_key_value. Both row layouts: checkpoint_version >= 2 stores
    per-head [q; k; v] blocks, version 0 [all q; all k; all v]."""

    ARCHITECTURES = ("MegatronGPT2LMHeadModel", "megatron-gpt2", "megatron_gpt2")

    def __init__(self, checkpoint_version: int = 2):
        self.checkpoint_version = checkpoint_version

    def config(self, hf_config) -> TransformerConfig:
        # policy_for constructs with no arguments, so a checkpoint that
        # carries its version wins over the default: both layouts have the
        # same shapes, and the wrong split scrambles heads silently
        if hasattr(hf_config, "checkpoint_version"):
            self.checkpoint_version = int(hf_config.checkpoint_version)
        return TransformerConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=getattr(hf_config, "hidden_size", getattr(hf_config, "n_embd", None)),
            num_layers=getattr(hf_config, "num_layers", getattr(hf_config, "n_layer", None)),
            num_heads=getattr(hf_config, "num_attention_heads", getattr(hf_config, "n_head", None)),
            max_seq_len=getattr(hf_config, "max_position_embeddings", 1024),
            pos_embedding="learned",
            norm_type="layernorm",
            activation="gelu",
            tie_embeddings=True,
            use_bias=True,
        )

    def _split_qkv(self, w, nh, hd):
        """(D, 3D) fused matrix -> three (D, D) matrices, by row layout."""
        if self.checkpoint_version >= 2:
            # columns grouped per head: [h0q h0k h0v h1q ...]
            cols = w.reshape(w.shape[0], nh, 3, hd)
            return tuple(cols[:, :, j].reshape(w.shape[0], nh * hd) for j in range(3))
        D = nh * hd
        return w[:, :D], w[:, D:2 * D], w[:, 2 * D:]

    def _split_qkv_bias(self, b, nh, hd):
        if self.checkpoint_version >= 2:
            cols = b.reshape(nh, 3, hd)
            return tuple(cols[:, j].reshape(-1) for j in range(3))
        D = nh * hd
        return b[:D], b[D:2 * D], b[2 * D:]

    def params(self, state, cfg) -> Dict:
        L = cfg.num_layers
        nh, hd = cfg.num_heads, cfg.head_dim
        pre = ""
        for cand in ("model.language_model.", "language_model.", ""):
            if any(k.startswith(cand + "embedding") for k in state):
                pre = cand
                break
        g = _getter(state, pre)
        stackT, stackB = _stackers(g, L)

        qkv = {name: [] for name in ("wq", "wk", "wv", "bq", "bk", "bv")}
        for i in range(L):
            # megatron's Linear stores (out, in): transpose to (in, out) first
            ws = self._split_qkv(g(f"transformer.layers.{i}.attention.query_key_value.weight").T,
                                 nh, hd)
            bs = self._split_qkv_bias(g(f"transformer.layers.{i}.attention.query_key_value.bias"),
                                      nh, hd)
            for name, t in zip(("wq", "wk", "wv", "bq", "bk", "bv"), ws + bs):
                qkv[name].append(t)
        return {
            "embed": {
                "tok": g("embedding.word_embeddings.weight"),
                "pos": g("embedding.position_embeddings.weight"),
            },
            "layers": {
                "attn": {
                    **{name: torch.stack(ts) for name, ts in qkv.items()},
                    "wo": stackT("transformer.layers.{}.attention.dense.weight"),
                    "bo": stackB("transformer.layers.{}.attention.dense.bias"),
                },
                "mlp": {
                    "wi": stackT("transformer.layers.{}.mlp.dense_h_to_4h.weight"),
                    "wo": stackT("transformer.layers.{}.mlp.dense_4h_to_h.weight"),
                    "bi": stackB("transformer.layers.{}.mlp.dense_h_to_4h.bias"),
                    "bo": stackB("transformer.layers.{}.mlp.dense_4h_to_h.bias"),
                },
                "ln1": {
                    "scale": stackB("transformer.layers.{}.input_layernorm.weight"),
                    "bias": stackB("transformer.layers.{}.input_layernorm.bias"),
                },
                "ln2": {
                    "scale": stackB("transformer.layers.{}.post_attention_layernorm.weight"),
                    "bias": stackB("transformer.layers.{}.post_attention_layernorm.bias"),
                },
            },
            "final_norm": {
                "scale": g("transformer.final_layernorm.weight"),
                "bias": g("transformer.final_layernorm.bias"),
            },
        }


class CLIPTextPolicy(HFPolicy):
    """reference: HFCLIPLayerPolicy (module_inject/containers/clip.py): the
    CLIP text encoder (pre-LN, causal attention, quick_gelu). Serving it
    raises (``quick_gelu``: ROADMAP.md Queue 1 item 10)."""

    ARCHITECTURES = ("CLIPTextModel", "CLIPModel", "clip", "clip_text_model")

    def config(self, hf_config) -> TransformerConfig:
        # CLIPModel configs nest the text tower under .text_config
        tc = getattr(hf_config, "text_config", hf_config)
        return TransformerConfig(
            vocab_size=tc.vocab_size,
            hidden_size=tc.hidden_size,
            num_layers=tc.num_hidden_layers,
            num_heads=tc.num_attention_heads,
            ffn_hidden_size=tc.intermediate_size,
            max_seq_len=tc.max_position_embeddings,
            pos_embedding="learned",
            norm_type="layernorm",
            activation="quick_gelu" if getattr(tc, "hidden_act", "quick_gelu") == "quick_gelu" else "gelu",
            norm_position="pre",
            causal=True,  # CLIP's text attention is causal
            tie_embeddings=True,
            use_bias=True,
            norm_eps=tc.layer_norm_eps,
        )

    def params(self, state, cfg) -> Dict:
        L = cfg.num_layers
        pre = ""
        for cand in ("text_model.", "model.text_model.", ""):
            if any(k.startswith(cand + "embeddings") for k in state):
                pre = cand
                break
        g = _getter(state, pre)
        stackT, stackB = _stackers(g, L)
        return {
            "embed": {
                "tok": g("embeddings.token_embedding.weight"),
                "pos": g("embeddings.position_embedding.weight"),
            },
            "layers": {
                "attn": {
                    "wq": stackT("encoder.layers.{}.self_attn.q_proj.weight"),
                    "wk": stackT("encoder.layers.{}.self_attn.k_proj.weight"),
                    "wv": stackT("encoder.layers.{}.self_attn.v_proj.weight"),
                    "wo": stackT("encoder.layers.{}.self_attn.out_proj.weight"),
                    "bq": stackB("encoder.layers.{}.self_attn.q_proj.bias"),
                    "bk": stackB("encoder.layers.{}.self_attn.k_proj.bias"),
                    "bv": stackB("encoder.layers.{}.self_attn.v_proj.bias"),
                    "bo": stackB("encoder.layers.{}.self_attn.out_proj.bias"),
                },
                "mlp": {
                    "wi": stackT("encoder.layers.{}.mlp.fc1.weight"),
                    "wo": stackT("encoder.layers.{}.mlp.fc2.weight"),
                    "bi": stackB("encoder.layers.{}.mlp.fc1.bias"),
                    "bo": stackB("encoder.layers.{}.mlp.fc2.bias"),
                },
                "ln1": {
                    "scale": stackB("encoder.layers.{}.layer_norm1.weight"),
                    "bias": stackB("encoder.layers.{}.layer_norm1.bias"),
                },
                "ln2": {
                    "scale": stackB("encoder.layers.{}.layer_norm2.weight"),
                    "bias": stackB("encoder.layers.{}.layer_norm2.bias"),
                },
            },
            "final_norm": {
                "scale": g("final_layer_norm.weight"),
                "bias": g("final_layer_norm.bias"),
            },
        }


POLICIES = [GPT2Policy, LlamaPolicy, OPTPolicy, BloomPolicy, GPTNeoXPolicy, GPTJPolicy,
            GPTNeoPolicy, BertPolicy, DistilBertPolicy, MegatronGPTPolicy, CLIPTextPolicy]


def policy_for(hf_config) -> HFPolicy:
    for p in POLICIES:
        if p.matches(hf_config):
            return p()
    raise ValueError(
        f"no injection policy for architecture {getattr(hf_config, 'architectures', None)} "
        f"(model_type={getattr(hf_config, 'model_type', '?')}); available: "
        f"{[p.__name__ for p in POLICIES]}"
    )


def config_from_hf(hf_config) -> TransformerConfig:
    return policy_for(hf_config).config(hf_config)


def partition_rules(hf_config=None):
    """The reference's tensor-parallel rule table for a converted model
    (``InferenceConfig.mesh.rules``): the port has no tensor-parallel mesh
    yet, so this raises, as ``config.mesh.rules`` does."""
    raise not_ported("partition_rules (tensor-parallel serving meshes: Queue 1 item 8)")


def convert_hf_model(hf_model) -> Tuple[TransformerConfig, Dict]:
    """(reference: replace_transformer_layer) HF torch model -> (cfg, the
    reference's param tree of tensors in their stored dtype).

    Architectures without an explicit policy fall back to the AutoTP
    name/shape-heuristic policy (``auto_tp.py``)."""
    state = dict(hf_model.state_dict())
    try:
        policy = policy_for(hf_model.config)
    except ValueError:
        from deepspeed_tpu_torch.module_inject.auto_tp import auto_policy

        policy = auto_policy(state)
        logger.info(
            f"no explicit policy for {getattr(hf_model.config, 'model_type', '?')}; "
            "using the AutoTP fallback"
        )
    cfg = policy.config(hf_model.config)
    params = policy.params(state, cfg)
    logger.info(f"converted HF {hf_model.config.model_type} -> TransformerConfig({cfg.num_params():,} params)")
    return cfg, params
