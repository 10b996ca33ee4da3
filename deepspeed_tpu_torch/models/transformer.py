"""Decoder-only transformer, the serving slice of the PyTorch/CUDA port.

Counterpart of ``deepspeed_tpu/models/transformer.py``, keeping its names:
``TransformerConfig``/``PRESETS``/``get_config``, ``init``, ``_norm``,
``_qkv``, ``_linear``, ``_mlp_block``, ``_attention``, ``init_cache``,
``_layer_body_cached``, ``forward_with_cache``, ``_vocab_head`` and the
inference subset of ``forward``/``apply``.

Parameters are a nested dict of tensors, one dict per layer under
``"layers"``. Matrix weights use PyTorch's ``F.linear`` layout (out, in),
and the q/k/v projections are one fused ``wqkv`` matrix whose output the
attention reads through strides. :func:`params_from_numpy` bridges the
reference's param tree (numpy arrays, layers stacked ``(L, ...)``, weights
laid out ``x @ w``) so that both packages compute the same function.

Features outside the slice (rope/alibi, MoE, windows and the rolling cache,
int8 KV, post-LN and parallel residual, encoders, sequence parallelism)
raise ``NotImplementedError``; see ROADMAP.md.
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.flash_attention import flash_attention, supports_seq_len
from deepspeed_tpu_torch.ops.transformer.fused_ops import fused_softmax
from deepspeed_tpu_torch.ops.transformer.inference_ops import softmax_context, update_kv_cache
from deepspeed_tpu_torch.utils import not_ported

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA; None => MHA
    ffn_hidden_size: Optional[int] = None  # None => 4*hidden (gpt) / derived (llama)
    max_seq_len: int = 1024
    pos_embedding: str = "learned"  # learned | rope | alibi | none
    norm_type: str = "layernorm"  # layernorm | rmsnorm
    activation: str = "gelu"  # gelu | relu | silu_glu (SwiGLU)
    tie_embeddings: bool = True
    dtype: str = "float32"  # compute/storage dtype for params & activations
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dropout: float = 0.0
    remat: bool = False
    remat_policy: str = "nothing_saveable"  # nothing_saveable | dots_saveable | dots_with_no_batch_dims
    attn_impl: str = "xla"  # xla | pallas (flash) | block_sparse (layout kernel)
    # block-sparse attention pattern (attn_impl="block_sparse"): mode is one
    # of dense|fixed|bigbird|bslongformer|variable plus that mode's kwargs
    # (ops/sparse_attention/sparsity_config.py; reference
    # ops/sparse_attention/sparse_self_attention.py + docs "~10x longer
    # sequences"). Tuple-of-pairs so the frozen config stays hashable.
    sparse_attention: Optional[tuple] = None  # e.g. (("mode","fixed"),("block",128))
    use_bias: bool = True  # linear/ln biases (gpt2 yes, llama no)
    scan_layers: bool = True
    # --- architecture variants for the HF injection-policy families
    # (module_inject/policies.py; reference replace_policy.py:20-26) ---
    rope_dim: Optional[int] = None  # partial rotary over first rope_dim dims (GPT-J/NeoX)
    rope_interleaved: bool = False  # GPT-J even/odd pairing (vs llama/neox half-split)
    parallel_residual: bool = False  # x + attn(h) + mlp(h') in one residual (GPT-J/NeoX)
    shared_ln: bool = False  # parallel residual feeds mlp from ln1 too (GPT-J)
    norm_position: str = "pre"  # pre | post (post: BERT / OPT-350m ordering)
    causal: bool = True  # False = bidirectional encoder attention (BERT)
    type_vocab_size: int = 0  # token-type-embedding vocab (BERT; 0 = off)
    embed_norm: bool = False  # LayerNorm over summed embeddings (BERT, BLOOM)
    lm_head_bias: bool = False  # untied lm head carries a bias (GPT-J)
    attn_scale: Optional[float] = None  # None => 1/sqrt(head_dim); GPT-Neo uses 1.0
    # per-layer local-attention windows (GPT-Neo global/local alternation:
    # 0 = global, W = attend only the last W positions). Tuple of
    # num_layers ints; None = all-global.
    local_attn_windows: Optional[tuple] = None
    # the reference's flash-attention tile size (None = its auto tile,
    # flash_attention._auto_block: S itself up to 512, else the largest of
    # 512/256/128/64 dividing S). The CUDA kernel tiles by itself and
    # accepts the value as a hint only.
    flash_block: Optional[int] = None
    # KV-cache storage: "model" dtype or "int8" (per-token-per-head scales;
    # decode reads half the cache bytes, context capacity doubles — the
    # quantize/dequantize lives in ops/transformer/inference_ops)
    kv_cache_dtype: str = "model"
    # rolling (ring-buffer) KV cache for uniform-sliding-window models
    # (Mistral): the cache holds only the last `window` positions — decode
    # memory and cache-read bandwidth are O(window) instead of O(total
    # generated length). Set by the inference engine when the conditions
    # hold (uniform window, rope/no pos-emb, flash prefill available);
    # slot absolute positions are derived modulo the cache length, so the
    # math degenerates to the plain cache whenever nothing wraps.
    rolling_kv_cache: bool = False
    # --- MoE (reference: deepspeed/moe/; 0 experts = dense MLP) ---
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_drop_tokens: bool = True
    moe_use_rts: bool = False  # random token selection needs an rng at loss()
    # PR-MoE residual mixing (reference moe/layer.py:28,45): dense MLP +
    # expert mix with a learned per-token 2-way softmax coefficient
    moe_use_residual: bool = False
    # --- sequence/context parallelism (parallel/sequence.py) ---
    seq_parallel: str = "none"  # none | ring | ulysses
    # --- QAT activation fake-quant bits, 0 = off (compression/ wiring) ---
    act_quant_bits: int = 0
    # --- data efficiency (engine-driven schedules) ---
    # random-LTD: layers run on a random token subset of this length
    # (engine re-jits per scheduled value; 0 = off). Applies to all scanned
    # layers; per-layer subsets need scan_layers=False.
    random_ltd: bool = False
    # progressive layer drop: stochastic depth with keep prob
    # p_l = 1 - (l/L) * (1 - theta); theta is a dynamic scalar from the
    # engine's PLD schedule (runtime/progressive_layer_drop.py)
    pld_enabled: bool = False

    def __post_init__(self):
        # accept a dict for sparse_attention (user-facing) but store a
        # tuple-of-pairs so the frozen config stays hashable
        if isinstance(self.sparse_attention, dict):
            object.__setattr__(
                self, "sparse_attention", tuple(sorted(self.sparse_attention.items()))
            )

    @property
    def uniform_window(self) -> Optional[int]:
        """The single static sliding-window size when every layer shares one
        positive window (Mistral); None for no windows or per-layer mixes
        (GPT-Neo alternation)."""
        w = self.local_attn_windows
        if w is None or len(set(w)) != 1 or int(w[0]) <= 0:
            return None
        return int(w[0])

    @property
    def varying_windows(self) -> bool:
        """True when windows differ per layer (GPT-Neo alternation) and must
        ride the layer scan as traced scalars; uniform/absent windows stay
        static python ints (flash band kernel + rolling cache rely on it)."""
        w = self.local_attn_windows
        return w is not None and len(set(w)) > 1

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def ffn_size(self):
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        return 4 * self.hidden_size

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def num_params(self) -> int:
        D, V, L, F = self.hidden_size, self.vocab_size, self.num_layers, self.ffn_size
        kvd = self.kv_heads * self.head_dim
        attn = D * D + 2 * D * kvd + D * D  # q,k,v,o
        mlp = (3 if self.activation == "silu_glu" else 2) * D * F
        if self.moe_num_experts > 0:
            dense_mlp = mlp
            mlp = mlp * self.moe_num_experts + D * self.moe_num_experts  # experts + router
            if self.moe_use_residual:
                mlp += dense_mlp + 2 * D + 2  # residual MLP + coefficient
        per_layer = attn + mlp + 2 * D  # + ln scales
        if self.use_bias:
            mlp_bias = F + D
            if self.moe_num_experts > 0:
                mlp_bias *= self.moe_num_experts  # per-expert bi/bo
                if self.moe_use_residual:
                    mlp_bias += F + D  # dense residual MLP biases
            per_layer += (D + 2 * kvd + D) + mlp_bias + 2 * D  # attn/mlp/ln biases
        emb = V * D + (self.max_seq_len * D if self.pos_embedding == "learned" else 0)
        emb += self.type_vocab_size * D
        if self.embed_norm:
            emb += D + (D if self.use_bias else 0)
        head = 0 if self.tie_embeddings else V * D + (V if self.lm_head_bias else 0)
        final = D + (D if self.use_bias else 0)
        return emb + L * per_layer + final + head

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token, Megatron-style accounting (fwd+bwd):
        6*N over matmul params + the logits projection (the V×D matmul runs
        every step whether or not embeddings are tied) + causal attention."""
        n = self.num_params() - self.vocab_size * self.hidden_size * (1 if self.tie_embeddings else 2)
        lm_head_flops = 6 * self.vocab_size * self.hidden_size
        attn_flops = 12 * self.num_layers * self.hidden_size * seq_len  # 2*2*3 per token pair
        return 6.0 * n + lm_head_flops + attn_flops


# preset shapes for parity configs (BASELINE.md tracked configs)
PRESETS = {
    "gpt2-125m": dict(vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12, max_seq_len=1024),
    "gpt2-350m": dict(vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16, max_seq_len=1024),
    "gpt2-760m": dict(vocab_size=50257, hidden_size=1280, num_layers=36, num_heads=20, max_seq_len=1024),
    "gpt2-1.5b": dict(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25, max_seq_len=1024),
    "llama2-7b": dict(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=32,
        ffn_hidden_size=11008, max_seq_len=4096, pos_embedding="rope", norm_type="rmsnorm",
        activation="silu_glu", tie_embeddings=False, use_bias=False,
    ),
    "llama2-70b": dict(
        vocab_size=32000, hidden_size=8192, num_layers=80, num_heads=64, num_kv_heads=8,
        ffn_hidden_size=28672, max_seq_len=4096, pos_embedding="rope", norm_type="rmsnorm",
        activation="silu_glu", tie_embeddings=False, use_bias=False,
    ),
    # BASELINE.json tracked inference config (BLOOM-7B kernel injection)
    "bloom-7b": dict(
        vocab_size=250880, hidden_size=4096, num_layers=30, num_heads=32,
        max_seq_len=2048, pos_embedding="alibi", embed_norm=True, tie_embeddings=True,
    ),
    "gptj-6b": dict(
        vocab_size=50400, hidden_size=4096, num_layers=28, num_heads=16,
        max_seq_len=2048, pos_embedding="rope", rope_dim=64, rope_interleaved=True,
        parallel_residual=True, shared_ln=True, tie_embeddings=False, lm_head_bias=True,
    ),
    "gpt-neox-20b": dict(
        vocab_size=50432, hidden_size=6144, num_layers=44, num_heads=64,
        ffn_hidden_size=24576, max_seq_len=2048, pos_embedding="rope", rope_dim=24,
        parallel_residual=True, tie_embeddings=False,
    ),
    # Reference headline-bench family (docs/_posts/2020-05-28-fastest-bert-training.md:
    # BERT-large pretrain, 64 TFLOPS/V100 @ seq 128). Bidirectional post-LN
    # encoder: tok+pos+type embeddings -> LayerNorm, no final norm (post-LN
    # already normalizes the last residual), MLM via labels+loss_mask in
    # loss_fn. Deviation from HF BERT: the MLM head ties directly to the
    # token embedding (no extra transform dense); pooler/NSP head omitted.
    "bert-large": dict(
        vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
        max_seq_len=512, pos_embedding="learned", type_vocab_size=2,
        embed_norm=True, norm_position="post", causal=False,
    ),
    "bert-base": dict(
        vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
        max_seq_len=512, pos_embedding="learned", type_vocab_size=2,
        embed_norm=True, norm_position="post", causal=False,
    ),
}


def get_config(preset: str, **overrides) -> TransformerConfig:
    base = dict(PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every config feature outside the serving slice, so that no
    such config silently takes another path."""
    checks = [
        (cfg.pos_embedding not in ("learned", "none"), f"pos_embedding={cfg.pos_embedding!r}"),
        (cfg.norm_type not in ("layernorm", "rmsnorm"), f"norm_type={cfg.norm_type!r}"),
        (cfg.activation not in ("gelu", "relu", "silu_glu"),
         f"activation={cfg.activation!r}"),
        (cfg.norm_position != "pre", "post-LN (norm_position='post')"),
        (cfg.parallel_residual, "parallel_residual"),
        (not cfg.causal, "bidirectional attention (causal=False)"),
        (cfg.type_vocab_size > 0 or cfg.embed_norm, "encoder embeddings (type_vocab_size/embed_norm)"),
        (cfg.local_attn_windows is not None, "local_attn_windows"),
        (cfg.rolling_kv_cache, "the rolling KV cache"),
        (cfg.kv_cache_dtype != "model", f"kv_cache_dtype={cfg.kv_cache_dtype!r}"),
        (cfg.moe_num_experts > 0, "MoE layers"),
        (cfg.seq_parallel != "none", f"seq_parallel={cfg.seq_parallel!r}"),
        (cfg.act_quant_bits > 0, "activation fake-quant"),
        (cfg.attn_impl not in ("xla", "pallas"), f"attn_impl={cfg.attn_impl!r}"),
    ]
    for bad, feature in checks:
        if bad:
            raise not_ported(feature)


def map_params(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list param tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: TransformerConfig):
    """Parameter tree in f32 on the generator's device (the engine casts to
    the model dtype). Same shapes and scales as the reference's ``init``;
    the numbers differ (another generator)."""
    check_supported(cfg)
    dev = generator.device
    D, V, F_, L = cfg.hidden_size, cfg.vocab_size, cfg.ffn_size, cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32) * std

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    params = {"embed": {"tok": normal(V, D, std=0.02)}, "final_norm": {"scale": ones(D)}}
    if cfg.pos_embedding == "learned":
        params["embed"]["pos"] = normal(cfg.max_seq_len, D, std=0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal(V, D, std=1.0 / math.sqrt(D))}
        if cfg.lm_head_bias:
            params["lm_head"]["b"] = zeros(V)
    if cfg.use_bias:
        params["final_norm"]["bias"] = zeros(D)
    qkv_out = (nh + 2 * nkv) * hd
    layers = []
    for _ in range(L):
        layer = {
            "attn": {"wqkv": normal(qkv_out, D, std=1.0 / math.sqrt(D)),
                     "wo": normal(D, nh * hd, std=1.0 / math.sqrt(nh * hd) / math.sqrt(2 * L))},
            "mlp": {"wi": normal(F_, D, std=1.0 / math.sqrt(D)),
                    "wo": normal(D, F_, std=1.0 / math.sqrt(F_) / math.sqrt(2 * L))},
            "ln1": {"scale": ones(D)},
            "ln2": {"scale": ones(D)},
        }
        if cfg.activation == "silu_glu":
            layer["mlp"]["wg"] = normal(F_, D, std=1.0 / math.sqrt(D))
        if cfg.use_bias:
            layer["attn"]["bqkv"] = zeros(qkv_out)
            layer["attn"]["bo"] = zeros(D)
            layer["mlp"]["bi"] = zeros(F_)
            layer["mlp"]["bo"] = zeros(D)
            layer["ln1"]["bias"] = zeros(D)
            layer["ln2"]["bias"] = zeros(D)
        layers.append(layer)
    params["layers"] = layers
    return params


def params_from_numpy(tree, cfg: TransformerConfig, device=None):
    """The reference's param tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``: layers stacked ``(L, ...)``, weights ``x @ w``) -> this
    package's tree on ``device``, computing the same function. Dtypes are
    kept; the engine casts to the model dtype."""
    check_supported(cfg)
    known = {"embed", "final_norm", "lm_head", "layers"}
    if set(tree) - known:
        raise not_ported(f"param groups {sorted(set(tree) - known)}")

    def t(a, transpose=False):
        a = np.asarray(a)
        if transpose:
            a = a.T
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    params = {
        "embed": {k: t(v) for k, v in tree["embed"].items()},
        "final_norm": {k: t(v) for k, v in tree["final_norm"].items()},
    }
    if "lm_head" in tree:
        params["lm_head"] = {"w": t(tree["lm_head"]["w"], transpose=True)}
        if "b" in tree["lm_head"]:
            params["lm_head"]["b"] = t(tree["lm_head"]["b"])
    ly = tree["layers"]
    attn, mlp = ly["attn"], ly["mlp"]
    layers = []
    for i in range(cfg.num_layers):
        wqkv = np.concatenate([attn["wq"][i], attn["wk"][i], attn["wv"][i]], axis=1)
        layer = {
            "attn": {"wqkv": t(wqkv, transpose=True), "wo": t(attn["wo"][i], transpose=True)},
            "mlp": {"wi": t(mlp["wi"][i], transpose=True), "wo": t(mlp["wo"][i], transpose=True)},
            "ln1": {k: t(v[i]) for k, v in ly["ln1"].items()},
            "ln2": {k: t(v[i]) for k, v in ly["ln2"].items()},
        }
        if "wg" in mlp:
            layer["mlp"]["wg"] = t(mlp["wg"][i], transpose=True)
        if "bq" in attn:
            layer["attn"]["bqkv"] = t(np.concatenate([attn["bq"][i], attn["bk"][i], attn["bv"][i]]))
            layer["attn"]["bo"] = t(attn["bo"][i])
        if "bi" in mlp:
            layer["mlp"]["bi"] = t(mlp["bi"][i])
            layer["mlp"]["bo"] = t(mlp["bo"][i])
        layers.append(layer)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _norm(x, scale, bias, cfg: TransformerConfig):
    """LayerNorm/RMSNorm with f32 math (population variance, as jnp.var),
    cast back to x's dtype."""
    x32 = x.float()
    if cfg.norm_type == "rmsnorm":
        x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    else:
        var, mu = torch.var_mean(x32, dim=-1, keepdim=True, unbiased=False)
        x32 = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
    out = x32 * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def _linear(x, w, b=None):
    """Last-dim contraction with a (out, in) weight and an optional bias."""
    return F.linear(x, w, b)


def _qkv(h, attn_p, cfg: TransformerConfig):
    """Project h -> (q, k, v) heads: one fused matmul, split into strided
    views (the flash kernel and the cache write read them as they are)."""
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    qkv = _linear(h, attn_p["wqkv"], attn_p.get("bqkv"))
    q, k, v = qkv.split([nh * hd, nkv * hd, nkv * hd], dim=-1)
    return q.unflatten(-1, (nh, hd)), k.unflatten(-1, (nkv, hd)), v.unflatten(-1, (nkv, hd))


def _attention(q, k, v, cfg: TransformerConfig):
    """Causal multi-head / grouped-query attention over a whole segment:
    the flash kernel for ``attn_impl="pallas"``, else einsum-softmax-einsum
    with f32 logits (the reference's "xla" branch)."""
    B, S, nh, hd = q.shape
    if cfg.attn_impl == "pallas":
        return flash_attention(q, k, v, causal=cfg.causal, sm_scale=cfg.attn_scale)
    nkv = k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if cfg.causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    probs = fused_softmax(logits).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dense_act(cfg: TransformerConfig):
    if cfg.activation == "relu":
        return F.relu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda x: F.gelu(x, approximate="tanh")


def _mlp_block(h, mlp_p, cfg: TransformerConfig):
    """Dense MLP block: h (B, S, D) -> (B, S, D)."""
    if cfg.activation == "silu_glu":
        act = F.silu(_linear(h, mlp_p["wg"])) * _linear(h, mlp_p["wi"])
    else:
        act = _dense_act(cfg)(_linear(h, mlp_p["wi"], mlp_p.get("bi")))
    return _linear(act, mlp_p["wo"], mlp_p.get("bo"))


def _embed(params, cfg: TransformerConfig, tokens):
    return F.embedding(tokens, params["embed"]["tok"]).to(cfg.torch_dtype)


def _layer_body(x, layer_p, cfg: TransformerConfig):
    """One pre-LN decoder layer over a whole sequence (no cache)."""
    B, S, _ = x.shape
    attn_p, ln1, ln2 = layer_p["attn"], layer_p["ln1"], layer_p["ln2"]
    h = _norm(x, ln1["scale"], ln1.get("bias"), cfg)
    q, k, v = _qkv(h, attn_p, cfg)
    attn_out = _attention(q, k, v, cfg).reshape(B, S, cfg.num_heads * cfg.head_dim)
    x = x + _linear(attn_out, attn_p["wo"], attn_p.get("bo"))
    h = _norm(x, ln2["scale"], ln2.get("bias"), cfg)
    return x + _mlp_block(h, layer_p["mlp"], cfg)


def forward(params, cfg: TransformerConfig, tokens):
    """tokens (B, S) int -> logits (B, S, V). Inference subset of the
    reference's ``forward``: no dropout, LTD, PLD or token types."""
    check_supported(cfg)
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    if cfg.pos_embedding == "learned":
        x = x + params["embed"]["pos"][:S].to(cfg.torch_dtype)
    for layer_p in params["layers"]:
        x = _layer_body(x, layer_p, cfg)
    x = _norm(x, params["final_norm"]["scale"], params["final_norm"].get("bias"), cfg)
    return _vocab_head(x, params, cfg)


def _vocab_head(x, params, cfg: TransformerConfig):
    """Hidden states -> vocab logits (tied or untied head)."""
    dtype = cfg.torch_dtype
    if cfg.tie_embeddings:
        return _linear(x, params["embed"]["tok"].to(dtype))
    head = params["lm_head"]
    b = head.get("b")
    return _linear(x, head["w"].to(dtype), None if b is None else b.to(dtype))


def apply(params, cfg: TransformerConfig, tokens):
    """tokens (B, S) int -> logits (B, S, V)."""
    return forward(params, cfg, tokens)


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch_size: int, max_len: Optional[int] = None,
               device=None):
    """Per-layer KV cache: {"k", "v"} of (L, B, T, kv_heads, head_dim) in the
    model dtype."""
    T = max_len or cfg.max_seq_len
    shape = (cfg.num_layers, batch_size, T, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def cache_alloc_len(cache) -> int:
    """Allocated time-axis length of a cache."""
    return cache["k"].shape[2]


def kv_read_bytes_per_row(cfg: TransformerConfig, read_len: int) -> int:
    """Device-memory bytes ONE sequence row's attention streams from the KV
    cache when a decode step attends ``read_len`` slots: K and V across all
    layers."""
    per_slot = cfg.kv_heads * cfg.head_dim * torch.finfo(cfg.torch_dtype).bits // 8
    return 2 * cfg.num_layers * read_len * per_slot


def _layer_body_cached(x, layer_p, k_cache, v_cache, cfg: TransformerConfig, positions, pos,
                       read_len=None):
    """One decoder layer over a segment of S new tokens with KV cache.

    x: (B, S, D); k_cache/v_cache: (B, T, nkv, hd) of THIS layer, written in
    place; pos: count of tokens already cached, a Python int (all rows
    aligned) or a (B,) tensor. ``read_len`` tight-reads the cache. Returns
    (x, k_cache, v_cache).
    """
    B, S, _ = x.shape
    attn_p, ln1 = layer_p["attn"], layer_p["ln1"]
    h = _norm(x, ln1["scale"], ln1.get("bias"), cfg)
    q, k, v = _qkv(h, attn_p, cfg)

    # PREFILL fast path: pos is the literal int 0 only for a prefill, where
    # attention over the segment is exactly causal self-attention; lengths
    # the reference's auto-tiler can't cover stay on the einsum path, so
    # both packages take the same path at each length.
    use_flash_prefill = (
        isinstance(pos, int) and pos == 0 and S > 1
        and cfg.attn_impl == "pallas" and cfg.causal
        and cfg.pos_embedding != "alibi"
        and supports_seq_len(S)
    )
    k_cache, v_cache = update_kv_cache(k_cache, v_cache, k, v, pos, positions)
    if use_flash_prefill:
        attn_out = flash_attention(q, k, v, causal=True, sm_scale=cfg.attn_scale)
    else:
        attn_out = softmax_context(q, k_cache, v_cache, pos, scale=cfg.attn_scale,
                                   positions=positions, read_len=read_len)
    attn_out = _linear(attn_out.reshape(B, S, cfg.num_heads * cfg.head_dim),
                       attn_p["wo"], attn_p.get("bo"))
    return _finish_layer_cached(x, h, attn_out, layer_p, cfg, k_cache, v_cache)


def _finish_layer_cached(x, h, attn_out, layer_p, cfg: TransformerConfig, k_cache, v_cache):
    """Residual + MLP tail of a cached layer (pre-LN)."""
    ln2 = layer_p["ln2"]
    x = x + attn_out
    h = _norm(x, ln2["scale"], ln2.get("bias"), cfg)
    return x + _mlp_block(h, layer_p["mlp"], cfg), k_cache, v_cache


def forward_with_cache(params, cfg: TransformerConfig, tokens, cache, pos, positions=None,
                       read_len=None, last_only: bool = False):
    """Segment forward with KV cache (prefill: S = prompt len, pos = 0;
    decode: S = 1). ``pos`` is a Python int (rows aligned) or a (B,) tensor
    of per-row depths; ``positions`` (B, S) overrides the derived positions
    (requires vector ``pos``). ``read_len`` tight-reads the cache time axis.
    ``last_only`` runs the vocab head on the last position only (logits
    (B, 1, V)); that row's numbers are unchanged. The cache is updated in
    place. Returns (logits, cache)."""
    check_supported(cfg)
    B, S = tokens.shape
    dev = tokens.device
    if read_len is not None and read_len >= cache_alloc_len(cache):
        read_len = None  # degenerate slice: the allocation is already tight
    vector_pos = torch.is_tensor(pos) and pos.dim() == 1
    x = _embed(params, cfg, tokens)
    if positions is not None:
        if not vector_pos:
            raise ValueError("explicit positions require a vector pos")
    elif vector_pos:
        positions = pos[:, None] + torch.arange(S, device=dev)[None, :]
    else:
        positions = (pos + torch.arange(S, device=dev))[None, :].expand(B, S)
    if cfg.pos_embedding == "learned":
        pos_table = params["embed"]["pos"].to(cfg.torch_dtype)
        clamped = positions.clamp(max=pos_table.shape[0] - 1)
        # aligned rows share row 0's positions, as in the reference
        x = x + (pos_table[clamped] if vector_pos else pos_table[clamped[0]])
    for i, layer_p in enumerate(params["layers"]):
        x, _, _ = _layer_body_cached(x, layer_p, cache["k"][i], cache["v"][i], cfg,
                                     positions, pos, read_len=read_len)
    if last_only:
        x = x[:, -1:]
    x = _norm(x, params["final_norm"]["scale"], params["final_norm"].get("bias"), cfg)
    return _vocab_head(x, params, cfg), cache


class TransformerModel:
    """Protocol wrapper (cfg + init/apply), as the reference's."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    @classmethod
    def from_preset(cls, name: str, **overrides):
        return cls(get_config(name, **overrides))

    def init(self, generator: torch.Generator):
        return init(generator, self.cfg)

    def apply(self, params, tokens):
        return apply(params, self.cfg, tokens)
