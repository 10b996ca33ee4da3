"""AutoTP fallback policy (counterpart of
``deepspeed_tpu/module_inject/auto_tp.py``): convert an HF architecture with
no explicit injection policy by inferring the layer structure from
state-dict key names and shapes, onto the port's transformer tree, after
which every engine path applies as for the explicit policies.

Heuristics (decoder-only, pre-LN, the HF mainstream):

  - the per-layer key template is the ``(prefix, suffix)`` pair around an
    integer path segment with the most distinct indices;
  - attention projections by name (``q_proj``/``query``/..., fused
    ``query_key_value``/``c_attn`` split by (D, kvD, kvD));
  - MLP matrices by name (``gate/up/down``, ``fc1/fc2``,
    ``dense_h_to_4h``...) with shape confirmation (D->F vs F->D);
  - norms: ``input_layernorm``/``ln_1`` -> ln1,
    ``post_attention...``/``ln_2`` -> ln2;
  - torch Linear stores (out, in) -> transposed; shape-checked where the
    dims disambiguate;
  - missing biases are synthesized as zeros when the config says
    ``use_bias`` (e.g. Qwen2: qkv biased, o/mlp not).

Tensors keep their stored dtype, as the explicit policies'. The converted
tree is held to the shapes of the reference's ``init`` for the config
(``models.transformer.reference_shapes``: this package's ``init`` on the
meta device, mapped to the reference's layout), which the reference takes
from ``jax.eval_shape``.

Not covered (each needs a real policy): encoder/post-LN stacks, ALiBi
(no config signal), per-head-interleaved fused qkv (GPT-NeoX has a
policy), Conv1D fused qkv (GPT-2 has a policy).
"""

import re
from typing import Any, Dict, List, Tuple

import torch

from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.module_inject.policies import _t
from deepspeed_tpu_torch.utils.logging import logger

_LAYER_RE = re.compile(r"^(.*?\.)(\d+)(\..+)$")

_Q_RE = re.compile(r"\b(q_proj|q_lin|query)\b|\.q\.", re.I)
_K_RE = re.compile(r"\b(k_proj|k_lin|key)\b|\.k\.", re.I)
_V_RE = re.compile(r"\b(v_proj|v_lin|value)\b|\.v\.", re.I)
_O_RE = re.compile(r"\b(o_proj|out_proj|out_lin|wo)\b", re.I)
_QKV_RE = re.compile(r"\b(query_key_value|qkv_proj|qkv|c_attn|Wqkv)\b", re.I)
_ATTN_SCOPE_RE = re.compile(r"\b(attn|attention|self_attn|self_attention)\b", re.I)
_MLP_SCOPE_RE = re.compile(r"\b(mlp|ffn|feed_forward|fc|dense_h_to_4h|dense_4h_to_h)\b", re.I)
_GATE_RE = re.compile(r"\b(gate_proj|w1|wg)\b", re.I)
_UP_RE = re.compile(r"\b(up_proj|fc1|fc_in|c_fc|wi|w3|dense_h_to_4h|lin1)\b", re.I)
_DOWN_RE = re.compile(r"\b(down_proj|fc2|fc_out|c_proj|w2|dense_4h_to_h|lin2)\b", re.I)
_LN1_RE = re.compile(r"\b(input_layernorm|ln_1|ln1|attention_norm|self_attn_layer_norm|"
                     r"pre_attention_layernorm|sa_layer_norm)\b", re.I)
_LN2_RE = re.compile(r"\b(post_attention_layernorm|ln_2|ln2|ffn_norm|final_layer_norm|"
                     r"post_layernorm|output_layer_norm)\b", re.I)
_TOK_RE = re.compile(r"\b(embed_tokens|wte|word_embeddings|tok_embeddings|embeddings\.word)\b", re.I)
_POS_RE = re.compile(r"\b(wpe|embed_positions|position_embeddings)\b", re.I)
_HEAD_RE = re.compile(r"\b(lm_head|embed_out|output_layer)\b", re.I)


def _attr(cfg, names, default=None):
    for n in names:
        v = getattr(cfg, n, None)
        if v is not None:
            return v
    return default


def _layer_template(keys: List[str]) -> Tuple[str, int]:
    """Find (layer key prefix, num_layers) by majority vote over integer
    path segments."""
    counts: Dict[str, set] = {}
    for k in keys:
        m = _LAYER_RE.match(k)
        if m:
            counts.setdefault(m.group(1), set()).add(int(m.group(2)))
    if not counts:
        raise ValueError("AutoTP: no '<prefix>.<i>.<suffix>' layer keys found")
    prefix = max(counts, key=lambda p: len(counts[p]))
    idxs = counts[prefix]
    assert idxs == set(range(len(idxs))), f"non-contiguous layer indices under {prefix}"
    return prefix, max(idxs) + 1


class AutoTPPolicy:
    """Fallback policy instance bound to a probed state dict.

    Produced by :func:`auto_policy` (which needs the state dict to detect
    bias/GLU/norm structure); exposes the same ``config`` / ``params``
    surface as the explicit HFPolicy classes."""

    def __init__(self, state: Dict[str, Any]):
        self._keys = [k for k in state.keys() if k.endswith(("weight", "bias"))]
        self._layer_prefix, self._num_layers = _layer_template(self._keys)
        l0 = [k for k in self._keys
              if k.startswith(f"{self._layer_prefix}0.")]
        self._l0 = l0
        self._has_gate = any(_GATE_RE.search(k) for k in l0)
        self._qkv_bias = any(
            _ATTN_SCOPE_RE.search(k) and k.endswith(".bias")
            and (_Q_RE.search(k) or _QKV_RE.search(k)) for k in l0
        )
        self._any_bias = any(k.endswith(".bias") and "norm" not in k.lower()
                             and "ln" not in k.lower() for k in l0)

    def config(self, hf_config) -> TransformerConfig:
        D = _attr(hf_config, ("hidden_size", "n_embd", "d_model"))
        L = _attr(hf_config, ("num_hidden_layers", "n_layer", "num_layers"))
        nh = _attr(hf_config, ("num_attention_heads", "n_head", "num_heads"))
        if D is None or L is None or nh is None:
            raise ValueError("AutoTP: config lacks hidden/layers/heads attributes")
        if int(L) != self._num_layers:
            raise ValueError(
                f"AutoTP: config says {L} layers, state dict has {self._num_layers}"
            )
        rms_eps = _attr(hf_config, ("rms_norm_eps",))
        ropeish = _attr(hf_config, ("rope_theta", "rotary_emb_base")) is not None or \
            _attr(hf_config, ("rotary_pct", "partial_rotary_factor")) is not None
        has_pos_embed = any(_POS_RE.search(k) for k in self._keys)
        act = str(_attr(hf_config, ("hidden_act", "activation_function"), "gelu")).lower()
        if act in ("silu", "swish") and self._has_gate:
            act = "silu_glu"
        elif act.startswith("gelu"):
            act = "gelu"
        elif act not in ("relu", "quick_gelu"):
            act = "gelu"
        tie = bool(_attr(hf_config, ("tie_word_embeddings",), False)) or \
            not any(_HEAD_RE.search(k) for k in self._keys)
        hd = D // nh
        rot_frac = _attr(hf_config, ("partial_rotary_factor", "rotary_pct"))
        rope_dim = int(rot_frac * hd) if rot_frac is not None else None
        parallel = bool(_attr(hf_config, ("use_parallel_residual", "parallel_attn"), False))
        return TransformerConfig(
            rope_dim=rope_dim,
            parallel_residual=parallel,
            vocab_size=_attr(hf_config, ("vocab_size",)),
            hidden_size=D,
            num_layers=int(L),
            num_heads=nh,
            num_kv_heads=_attr(hf_config, ("num_key_value_heads", "num_kv_heads")),
            ffn_hidden_size=_attr(hf_config, ("intermediate_size", "ffn_dim", "n_inner")),
            max_seq_len=_attr(hf_config, ("max_position_embeddings", "n_positions"), 2048),
            pos_embedding="rope" if (ropeish or not has_pos_embed) else "learned",
            norm_type="rmsnorm" if rms_eps is not None else "layernorm",
            activation=act,
            tie_embeddings=tie,
            use_bias=self._any_bias or self._qkv_bias,
            norm_eps=rms_eps if rms_eps is not None
            else _attr(hf_config, ("layer_norm_epsilon", "layer_norm_eps"), 1e-5),
            rope_theta=_attr(hf_config, ("rope_theta", "rotary_emb_base"), 10000.0),
        )

    # -- params mapping ----------------------------------------------------

    def _classify_layer_keys(self) -> Dict[str, str]:
        """suffix (after '<prefix>0.') -> slot tag, from layer-0 keys."""
        tags: Dict[str, str] = {}
        for k in self._l0:
            suffix = k[len(self._layer_prefix) + 2:]
            is_w = k.endswith(".weight")
            attn = bool(_ATTN_SCOPE_RE.search(k))
            if attn and _QKV_RE.search(k):
                tags[suffix] = "qkv_w" if is_w else "qkv_b"
            elif attn and _Q_RE.search(k):
                tags[suffix] = "wq" if is_w else "bq"
            elif attn and _K_RE.search(k):
                tags[suffix] = "wk" if is_w else "bk"
            elif attn and _V_RE.search(k):
                tags[suffix] = "wv" if is_w else "bv"
            elif attn and (_O_RE.search(k) or re.search(r"\bdense\b", k)):
                tags[suffix] = "wo" if is_w else "bo"
            elif _LN1_RE.search(k):
                tags[suffix] = "ln1_scale" if is_w else "ln1_bias"
            elif _LN2_RE.search(k):
                tags[suffix] = "ln2_scale" if is_w else "ln2_bias"
            elif _GATE_RE.search(k):
                tags[suffix] = "m_wg" if is_w else "m_bg"
            elif _UP_RE.search(k):
                tags[suffix] = "m_wi" if is_w else "m_bi"
            elif _DOWN_RE.search(k):
                tags[suffix] = "m_wo" if is_w else "m_bo"
            elif _MLP_SCOPE_RE.search(k):
                # generic MLP leaf with no up/down name hint — resolved by
                # shape in params() (torch Linear: up is (F, D), down (D, F))
                tags[suffix] = "m_unresolved_w" if is_w else "m_unresolved_b"
        return tags

    def params(self, state: Dict[str, Any], cfg: TransformerConfig) -> Dict:
        D, L = cfg.hidden_size, cfg.num_layers
        nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        F = cfg.ffn_size
        tags = self._classify_layer_keys()
        # resolve name-hint-less MLP leaves by layer-0 shape
        # (torch Linear: up stores (F, D), down stores (D, F))
        for suffix, tag in list(tags.items()):
            arr_shape = tuple(state[f"{self._layer_prefix}0.{suffix}"].shape)
            if tag == "m_unresolved_w" and D != F:
                if arr_shape == (F, D):
                    tags[suffix] = "m_wi"
                elif arr_shape == (D, F):
                    tags[suffix] = "m_wo"
            elif tag == "m_unresolved_b":
                tags[suffix] = "m_bi" if arr_shape == (F,) else "m_bo"
        need = {"wo", "m_wi", "m_wo", "ln1_scale", "ln2_scale"}
        have = set(tags.values())
        if not ({"wq", "wk", "wv"} <= have or "qkv_w" in have) or not (need <= have):
            raise ValueError(
                f"AutoTP could not identify the layer structure: found {sorted(have)}"
            )
        if "m_wg" in have and ("m_bg" in have or "m_bi" in have):
            # the unified model's GLU branch has no gate/up bias terms —
            # silently dropping them would diverge from HF, so fail loudly
            # (this module's contract: structural mismatch errors at
            # conversion, never silent wrongness)
            raise ValueError(
                "AutoTP: GLU MLP with gate/up-projection biases is not "
                "representable by the unified model; this architecture "
                "needs an explicit policy"
            )

        def lk(suffix, i):
            return f"{self._layer_prefix}{i}.{suffix}"

        by_tag = {t: s for s, t in tags.items()}

        def stackW(tag, expect_in):
            """Stack L weight mats, transposing torch (out,in) -> (in,out);
            shape-checked against the expected input dim where possible."""
            mats = []
            for i in range(L):
                m = _t(state[lk(by_tag[tag], i)])
                if m.ndim != 2:
                    raise ValueError(f"AutoTP: {tag} is not 2-D")
                if m.shape[0] != expect_in or m.shape[1] == expect_in:
                    m = m.T  # torch Linear convention
                mats.append(m)
            return torch.stack(mats)

        def stackB(tag, size):
            if tag in by_tag:
                return torch.stack([_t(state[lk(by_tag[tag], i)]) for i in range(L)])
            return torch.zeros((L, size), dtype=torch.float32)  # synthesized (e.g. Qwen2 o_proj)

        attn: Dict[str, Any] = {}
        if "qkv_w" in have:
            fused = torch.stack([_t(state[lk(by_tag["qkv_w"], i)]) for i in range(L)])
            if fused.shape[1] != D:  # (L, out, in) -> (L, in, out)
                fused = fused.transpose(1, 2)
            qd, kvd = nh * hd, nkv * hd
            attn["wq"], attn["wk"], attn["wv"] = (
                fused[:, :, :qd], fused[:, :, qd:qd + kvd], fused[:, :, qd + kvd:])
            if cfg.use_bias:
                if "qkv_b" in have:
                    fb = torch.stack([_t(state[lk(by_tag["qkv_b"], i)]) for i in range(L)])
                    attn["bq"], attn["bk"], attn["bv"] = (
                        fb[:, :qd], fb[:, qd:qd + kvd], fb[:, qd + kvd:])
                else:
                    attn["bq"] = torch.zeros((L, qd), dtype=torch.float32)
                    attn["bk"] = torch.zeros((L, kvd), dtype=torch.float32)
                    attn["bv"] = torch.zeros((L, kvd), dtype=torch.float32)
        else:
            attn["wq"] = stackW("wq", D)
            attn["wk"] = stackW("wk", D)
            attn["wv"] = stackW("wv", D)
            if cfg.use_bias:
                attn["bq"] = stackB("bq", nh * hd)
                attn["bk"] = stackB("bk", nkv * hd)
                attn["bv"] = stackB("bv", nkv * hd)
        attn["wo"] = stackW("wo", nh * hd)
        if cfg.use_bias:
            attn["bo"] = stackB("bo", D)

        mlp: Dict[str, Any] = {
            "wi": stackW("m_wi", D),
            "wo": stackW("m_wo", cfg.ffn_size),
        }
        if "m_wg" in have:
            mlp["wg"] = stackW("m_wg", D)
        if cfg.use_bias:
            mlp["bi"] = stackB("m_bi", cfg.ffn_size)
            mlp["bo"] = stackB("m_bo", D)

        def norm(tag_scale, tag_bias):
            out = {"scale": torch.stack([_t(state[lk(by_tag[tag_scale], i)]) for i in range(L)])}
            if cfg.norm_type != "rmsnorm" and tag_bias in by_tag:
                out["bias"] = torch.stack([_t(state[lk(by_tag[tag_bias], i)]) for i in range(L)])
            return out

        tok_key = next(k for k in self._keys if _TOK_RE.search(k) and k.endswith("weight"))
        embed: Dict[str, Any] = {"tok": _t(state[tok_key])}
        if cfg.pos_embedding == "learned":
            pos_key = next(k for k in self._keys if _POS_RE.search(k) and k.endswith("weight"))
            embed["pos"] = _t(state[pos_key])

        params = {
            "embed": embed,
            "layers": {"attn": attn, "mlp": mlp,
                       "ln1": norm("ln1_scale", "ln1_bias"),
                       "ln2": norm("ln2_scale", "ln2_bias")},
        }
        # final norm: a top-level (non-layer) norm weight
        fin = [k for k in self._keys
               if not k.startswith(self._layer_prefix[:-1] + ".")
               and re.search(r"\b(norm|ln_f|final_layer_norm|layernorm)\b", k, re.I)
               and k.endswith("weight") and not _LAYER_RE.match(k)]
        if fin:
            params["final_norm"] = {"scale": _t(state[fin[0]])}
            bias_key = fin[0][:-len("weight")] + "bias"
            if cfg.norm_type != "rmsnorm" and bias_key in state:
                params["final_norm"]["bias"] = _t(state[bias_key])
        if not cfg.tie_embeddings:
            head_key = next(k for k in self._keys if _HEAD_RE.search(k) and k.endswith("weight"))
            params["lm_head"] = {"w": _t(state[head_key]).T}
        params = _align_to_abstract(params, cfg)
        logger.info(
            f"AutoTP fallback mapped {self._num_layers} layers "
            f"(prefix='{self._layer_prefix}', slots={sorted(have)})"
        )
        return params


_BIAS_LEAVES = {"bias", "bq", "bk", "bv", "bo", "bi", "bg", "coef_b", "b"}


def _align_to_abstract(params: Dict, cfg: TransformerConfig) -> Dict:
    """Match the converted tree against the shapes of the model's init tree
    in the reference's layout: zero-fill missing bias leaves (e.g. Qwen2's
    rms norms under a use_bias=True config), drop leaves the model has no
    place for, and raise on shape mismatches or missing non-bias leaves, a
    structural mismatch that would fail later with a much worse message."""
    from deepspeed_tpu_torch.models import transformer as _tm

    abstract = _tm.reference_shapes(cfg)

    def walk(abs_node, got_node, path):
        if isinstance(abs_node, dict):
            got_node = dict(got_node) if isinstance(got_node, dict) else {}
            return {k: walk(sub, got_node.get(k), path + (k,)) for k, sub in abs_node.items()}
        leaf_name = path[-1]
        if got_node is None:
            if leaf_name in _BIAS_LEAVES:
                return torch.zeros(abs_node, dtype=torch.float32)
            raise ValueError(f"AutoTP: missing non-bias leaf {'.'.join(path)} "
                             f"(expected shape {abs_node})")
        if tuple(got_node.shape) != tuple(abs_node):
            raise ValueError(
                f"AutoTP: shape mismatch at {'.'.join(path)}: "
                f"mapped {tuple(got_node.shape)}, model expects {abs_node}"
            )
        return got_node

    return walk(abstract, params, ())


def auto_policy(state: Dict[str, Any]) -> AutoTPPolicy:
    """Build the fallback policy from a model's state dict."""
    return AutoTPPolicy(state)
