"""Decoder-only transformer of the PyTorch/CUDA port: the serving and the
training slices, with flash or block-sparse attention.

Counterpart of ``deepspeed_tpu/models/transformer.py``, keeping its names:
``TransformerConfig``/``PRESETS``/``get_config``, ``init``, ``_norm``,
``_qkv``, ``_linear``, ``_mlp_block``, ``_sparse_layout``, ``_attention``,
``_layer_body``, ``forward``/``apply``, ``_ce_from_logits``, ``loss_fn``,
``init_cache``, ``_layer_body_cached``, ``forward_with_cache`` and
``_vocab_head``. Gradients flow through plain autograd and through the
kernels' own backward: the norms' (K8, ``_norm`` being the fused-norm op)
always, the attention kernels' for ``attn_impl="pallas"`` and
``"block_sparse"``. As in the reference, block-sparse attention serves
the full-sequence ``forward`` (training, eval, ``InferenceEngine.forward``);
the cached path of ``generate`` attends densely.

Parameters are a nested dict of tensors, one dict per layer under
``"layers"``. Matrix weights use PyTorch's ``F.linear`` layout (out, in),
and the q/k/v projections are one fused ``wqkv`` matrix whose output the
attention reads through strides. :func:`params_from_numpy` bridges the
reference's param tree (numpy arrays, layers stacked ``(L, ...)``, weights
laid out ``x @ w``) so that both packages compute the same function, and
:func:`params_to_numpy` maps a tree (parameters or their gradients) back.

The serving paths also take the inference engine's int8 trees: a matmul
weight may be ``{"q8": int8 (out, in), "s": f32 (out,)}``, which
:func:`_linear` runs as the W8A8 product (``ops/quantizer.int8_linear``),
and ``kv_cache_dtype="int8"`` stores the KV cache as int8 components.

Llama-family models serve too: rotary embeddings (whole or partial,
half-split or interleaved pairs), uniform sliding windows (Mistral: the
flash kernel's band on a prefill) and per-layer windows (GPT-Neo's
alternation: the masked einsum path, as the reference's layer scan takes
it), and the rolling (ring) KV cache of uniform-window models. So do the
other decoder shapes that ``module_inject``'s policies produce: ALiBi
(BLOOM; the masked path on every prefill and decode, never flash), the
LayerNorm over the embeddings (``embed_norm``), post-LN (OPT with
``do_layer_norm_before=False``: no final norm) and the parallel residual
with or without the shared LN (GPT-NeoX, GPT-J), with the lm head's bias.

Every decoder shape that serves also trains: ``loss_fn`` takes gradients
through rope (the rotation in f32, the table built once a forward from the
positions alone), GQA (the flash kernels sum each kv head's group; the
masked path repeats the kv heads, whose gradients autograd sums), uniform
windows on the flash band, per-layer windows and ALiBi on the masked path,
``embed_norm``, post-LN and the parallel residual.

Training also runs tensor parallel (``tp``, a ``parallel.tensor_parallel.
TensorParallel``), on the placements of :func:`logical_specs` under the
reference's rules: a layer's attention holds ``wq``, ``wk`` and ``wv``
as leaves of their own in place of ``wqkv`` (and ``bq``/``bk``/``bv``);
each tensor rank holds its rows of ``wq``/``wi``/``wg`` (its output
columns) and its columns of ``wo``, slices its kv heads' rows out of the
whole ``wk``/``wv`` (which the rules keep whole), and all-reduces after
each row-parallel product. Attention runs the kernels on the rank's own
H/tp query and Hkv/tp kv heads, with the per-head quantities (ALiBi's
slopes, a block-sparse layout's rows) taken at the rank's head offset;
where the head counts do not divide the width, every rank computes every
head, as the reference does. The vocabulary splits over the ranks: the
embedding, the logits and the cross-entropy are vocab-parallel.

Features outside the slices (MoE, the encoders: bidirectional attention,
token types and ``quick_gelu``, sequence parallelism, block-sparse attention
with windows or ALiBi, and for training dropout, remat, random-LTD and
progressive layer drop) raise ``NotImplementedError``; see ROADMAP.md.
"""

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.block_sparse_attention import block_sparse_attention
from deepspeed_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from deepspeed_tpu_torch.ops.flash_attention import flash_attention, supports_seq_len
from deepspeed_tpu_torch.ops.fused_norm import _fused_norm
from deepspeed_tpu_torch.ops.quantizer import int8_linear
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.transformer.fused_ops import fused_softmax
from deepspeed_tpu_torch.ops.transformer.inference_ops import (
    apply_rotary_pos_emb,
    rope_table,
    softmax_context,
    update_kv_cache,
)
from deepspeed_tpu_torch.parallel import tensor_parallel as tpm
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
    """Raise for every config feature outside the port's slices, so that no
    such config silently takes another path."""
    if cfg.rolling_kv_cache and cfg.uniform_window is None:
        raise ValueError("the rolling KV cache needs one positive sliding window for every "
                         f"layer (local_attn_windows={cfg.local_attn_windows!r})")
    checks = [
        (cfg.pos_embedding not in ("learned", "rope", "alibi", "none"),
         f"pos_embedding={cfg.pos_embedding!r}"),
        (cfg.norm_type not in ("layernorm", "rmsnorm"), f"norm_type={cfg.norm_type!r}"),
        (cfg.activation not in ("gelu", "relu", "silu_glu"), f"activation={cfg.activation!r}"
         + (" (the CLIP text encoder, Queue 1 item 10)" if cfg.activation == "quick_gelu" else "")),
        (cfg.norm_position not in ("pre", "post"), f"norm_position={cfg.norm_position!r}"),
        (not cfg.causal, "bidirectional attention (causal=False: the encoders, Queue 1 item 10)"),
        (cfg.type_vocab_size > 0, "token-type embeddings (the encoders, Queue 1 item 10)"),
        (cfg.attn_impl == "block_sparse" and cfg.local_attn_windows is not None,
         "block-sparse attention with local_attn_windows"),
        (cfg.attn_impl == "block_sparse" and cfg.pos_embedding == "alibi",
         "block-sparse attention with ALiBi"),
        (cfg.kv_cache_dtype not in ("model", "int8"), f"kv_cache_dtype={cfg.kv_cache_dtype!r}"),
        (cfg.moe_num_experts > 0, "MoE layers"),
        (cfg.seq_parallel != "none", f"seq_parallel={cfg.seq_parallel!r}"),
        (cfg.act_quant_bits > 0, "activation fake-quant"),
        (cfg.attn_impl not in ("xla", "pallas", "block_sparse"), f"attn_impl={cfg.attn_impl!r}"),
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

def init(generator: torch.Generator, cfg: TransformerConfig, place=None):
    """Parameter tree in f32 on the generator's device (the engine casts to
    the model dtype). Same shapes and scales as the reference's ``init``;
    the numbers differ (another generator). ``place`` maps each leaf as it
    is drawn (the engine moves them to the host one at a time, so that the
    device never holds the whole f32 tree); the numbers do not change."""
    check_supported(cfg)
    return _init_tree(generator, cfg, place)


def _init_tree(generator: Optional[torch.Generator], cfg: TransformerConfig, place=None):
    """:func:`init` without the check; with ``generator=None`` the tree is
    on the meta device: its shapes, with no numbers."""
    dev = torch.device("meta") if generator is None else generator.device
    D, V, F_, L = cfg.hidden_size, cfg.vocab_size, cfg.ffn_size, cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    place = place or (lambda t: t)

    def normal(*shape, std):
        if generator is None:
            return torch.empty(shape, device=dev, dtype=torch.float32)
        return place(torch.randn(shape, generator=generator, device=dev,
                                 dtype=torch.float32) * std)

    def zeros(*shape):
        return place(torch.zeros(shape, device=dev, dtype=torch.float32))

    def ones(*shape):
        return place(torch.ones(shape, device=dev, dtype=torch.float32))

    params = {"embed": {"tok": normal(V, D, std=0.02)}, "final_norm": {"scale": ones(D)}}
    if cfg.pos_embedding == "learned":
        params["embed"]["pos"] = normal(cfg.max_seq_len, D, std=0.02)
    if cfg.embed_norm:
        params["embed_norm"] = {"scale": ones(D)}
        if cfg.use_bias:
            params["embed_norm"]["bias"] = zeros(D)
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


def is_reference_tree(tree) -> bool:
    """The reference's layout (layers stacked in one dict: numpy arrays, or
    the tensors of ``module_inject``'s policies, as
    ``load_checkpoint.convert_hf_checkpoint`` returns them), which
    ``params_from_numpy`` takes, not this package's list of layers."""
    return isinstance(tree["layers"], dict)


def params_from_numpy(tree, cfg: TransformerConfig, device=None):
    """The reference's param tree (layers stacked ``(L, ...)``, weights laid
    out ``x @ w``) -> this package's tree on ``device``, computing the same
    function. Leaves are numpy arrays (``jax.tree.map(np.asarray, params)``)
    or torch tensors (``module_inject``'s policies, in the dtype a
    checkpoint stores); dtypes are kept, and the engine casts to the model
    dtype. A tensor leaf moves to ``device`` before it is transposed or
    concatenated there. Each leaf is laid out by :func:`leaf_from_numpy`."""
    check_supported(cfg)
    known = {"embed", "embed_norm", "final_norm", "lm_head", "layers"}
    if set(tree) - known:
        raise not_ported(f"param groups {sorted(set(tree) - known)}")

    def get(name):
        node = tree
        for k in name.split("."):
            node = node[k]
        return node

    params = {group: {} for group in ("embed", "embed_norm", "final_norm", "lm_head")
              if group in tree}
    for group, out in params.items():
        for k in ("w", "b") if group == "lm_head" else tree[group]:
            if k in tree[group]:
                out[k] = leaf_from_numpy(get, (group, k), device)
    ly = tree["layers"]
    attn, mlp = ly["attn"], ly["mlp"]
    keys = ([("attn", "wqkv"), ("attn", "wo")]
            + ([("attn", "bqkv"), ("attn", "bo")] if "bq" in attn else [])
            + [("mlp", k) for k in ("wi", "wo", "wg", "bi", "bo") if k in mlp]
            + [(ln, k) for ln in ("ln1", "ln2") for k in ly[ln]])
    params["layers"] = []
    for i in range(cfg.num_layers):
        layer = {}
        for block, k in keys:
            layer.setdefault(block, {})[k] = leaf_from_numpy(get, ("layers", i, block, k), device)
        params["layers"].append(layer)
    return params


def leaf_from_numpy(get, path, device=None):
    """Leaf ``path`` of this package's tree (``("layers", 0, "attn",
    "wqkv")``) from the reference's leaves, laid out as
    :func:`params_from_numpy` lays it out: ``get(name)`` is the reference's
    leaf of dotted name ``name`` (``"layers.attn.wq"``), of which a stacked
    one is indexed by the layer alone (a memory map then reads just that
    layer's bytes)."""

    def t(a, transpose=False):
        if not torch.is_tensor(a):
            a = np.asarray(a)
            return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a)).to(device)
        a = a.to(device)
        return (a.T if transpose else a).contiguous()

    def cat(parts):
        if torch.is_tensor(parts[0]):
            return torch.cat([p.to(device) for p in parts], dim=-1)
        return np.concatenate(parts, axis=-1)

    if path[0] != "layers":
        group, k = path
        return t(get(f"{group}.{k}"), transpose=path == ("lm_head", "w"))
    _, i, block, k = path
    fused = {"wqkv": ("wq", "wk", "wv"), "bqkv": ("bq", "bk", "bv")}
    if block == "attn" and k in fused:
        return t(cat([get(f"layers.attn.{n}")[i] for n in fused[k]]), transpose=k == "wqkv")
    return t(get(f"layers.{block}.{k}")[i], transpose=block in ("attn", "mlp") and k[0] == "w")


def _reference_layout(tree, cfg: Optional[TransformerConfig]):
    """This package's tree -> the reference's layout, as tensors of the
    tree's own dtype and device: ``wqkv`` split back into ``wq``/``wk``/
    ``wv``, weights transposed to ``x @ w``, layers stacked ``(L, ...)``.
    Without ``cfg`` the q rows are read off ``wo``'s columns, and k and v
    share the rest."""
    if cfg is not None:
        q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    else:
        attn = tree["layers"][0]["attn"]
        q = attn["wo"].shape[1]
        kv = (attn["wqkv"].shape[0] - q) // 2
    split = [q, kv, kv]

    def stack(fn):
        return torch.stack([fn(layer) for layer in tree["layers"]])

    out = {group: dict(tree[group]) for group in ("embed", "embed_norm", "final_norm")
           if group in tree}
    if "lm_head" in tree:
        out["lm_head"] = {"w": tree["lm_head"]["w"].T.contiguous()}
        if "b" in tree["lm_head"]:
            out["lm_head"]["b"] = tree["lm_head"]["b"]
    first = tree["layers"][0]
    attn = {}
    for i, name in enumerate(("wq", "wk", "wv")):
        attn[name] = stack(lambda ly, i=i: ly["attn"]["wqkv"].split(split, dim=0)[i].T)
    attn["wo"] = stack(lambda ly: ly["attn"]["wo"].T)
    if "bqkv" in first["attn"]:
        for i, name in enumerate(("bq", "bk", "bv")):
            attn[name] = stack(lambda ly, i=i: ly["attn"]["bqkv"].split(split)[i])
        attn["bo"] = stack(lambda ly: ly["attn"]["bo"])
    mlp = {k: stack(lambda ly, k=k: ly["mlp"][k].T)
           for k in ("wi", "wo", "wg") if k in first["mlp"]}
    mlp.update({k: stack(lambda ly, k=k: ly["mlp"][k]) for k in ("bi", "bo") if k in first["mlp"]})
    out["layers"] = {
        "attn": attn, "mlp": mlp,
        "ln1": {k: stack(lambda ly, k=k: ly["ln1"][k]) for k in first["ln1"]},
        "ln2": {k: stack(lambda ly, k=k: ly["ln2"][k]) for k in first["ln2"]},
    }
    return out


def params_to_numpy(tree, cfg: Optional[TransformerConfig] = None):
    """The inverse of :func:`params_from_numpy`: this package's tree (of
    parameters or of their gradients) -> the reference's layout as f32 numpy
    arrays: ``wqkv`` split back into ``wq``/``wk``/``wv``, weights transposed
    to ``x @ w``, layers stacked ``(L, ...)``. ``cfg`` may be None (a tree
    read from a checkpoint): the split is then read off the shapes."""
    f32 = map_params(lambda t: t.detach().float().cpu(), tree)
    return map_params(lambda t: t.numpy(), _reference_layout(f32, cfg))


def reference_shapes(cfg: TransformerConfig):
    """The shapes of the reference's ``init`` tree for ``cfg`` (its
    ``jax.eval_shape``), from this package's init on the meta device mapped
    through :func:`_reference_layout`: nothing is allocated."""
    return map_params(lambda t: tuple(t.shape), _reference_layout(_init_tree(None, cfg), cfg))


_ATTN_LOGICAL = {"wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
                 "wo": ("heads", "embed"), "bq": ("heads",), "bk": ("kv",), "bv": ("kv",),
                 "bo": ("embed",)}
_MLP_LOGICAL = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"), "wo": ("mlp", "embed"),
                "bi": ("mlp",), "bo": ("embed",)}


def logical_specs(shapes, cfg: TransformerConfig):
    """Per-dimension logical axis names of the reference's layout (a tree
    shaped as :func:`reference_shapes`), the reference's ``logical_specs``:
    the stacked layers' leading dim is ``"layers"``, which no rule shards."""

    def annotate(path, shape):
        last = path[-1]
        pre = ("layers",) if path[0] == "layers" else ()
        if "attn" in path:
            return pre + _ATTN_LOGICAL[last]
        if "mlp" in path:
            return pre + _MLP_LOGICAL[last]
        if path[0] in ("final_norm", "embed_norm") or "ln1" in path or "ln2" in path:
            return pre + ("norm",)
        if path[0] == "embed":
            return ("vocab", "embed") if last == "tok" else ("seq", "embed")
        if path[0] == "lm_head":
            return ("embed", "vocab") if last == "w" else ("vocab",)
        return tuple(None for _ in shape)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return annotate(path, tree)

    return walk(shapes, ())


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _norm(x, scale, bias, cfg: TransformerConfig):
    """LayerNorm/RMSNorm with f32 math (two-pass mean, population variance,
    as jnp.mean/jnp.var), cast back to x's dtype, through the fused-norm op:
    K7 forward and K8 backward on a CUDA tensor, their plain versions on a
    CPU tensor. RMSNorm keeps its bias when the params have one, as the
    reference's ``_norm`` does."""
    return _fused_norm(x, scale, bias, cfg.norm_eps, cfg.norm_type == "rmsnorm")


def _linear(x, w, b=None):
    """Last-dim contraction with a (out, in) weight and an optional bias.
    An int8 weight ``{"q8", "s"}`` runs the W8A8 product, whose output is
    rounded to x's dtype before the bias is added, as the reference adds
    it."""
    if isinstance(w, dict):
        out = int8_linear(x, w["q8"], w["s"])
        return out if b is None else out + b
    return F.linear(x, w, b)


def _rope_table(cfg: TransformerConfig, positions):
    """The rotary (cos, sin) table of a forward at ``positions`` (B, S), or
    None without rope: every layer rotates at the same positions, so it is
    built once a forward. Rows that share their positions (the aligned path)
    share one row of the table."""
    if cfg.pos_embedding != "rope":
        return None
    return rope_table(positions, cfg.rope_theta, cfg.rope_dim or cfg.head_dim)


def _qkv(h, attn_p, cfg: TransformerConfig, rope=None, tp=None):
    """Project h -> (q, k, v) heads: one fused matmul, split into strided
    views (the flash kernel and the cache write read them as they are),
    then, with rope, q and k rotated through the forward's table ``rope``
    (:func:`_rope_table`), as the reference's ``_qkv`` rotates them. Under a
    serving shard ``tp`` the fused weight holds this rank's rows: its own
    heads (``"heads"``), or its block of q's columns and every kv head
    (``"columns"``: q is gathered over the ranks)."""
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    if tp is not None and tp.attn == "heads":
        nh, nkv = tp.local_heads(cfg)
    q_cols = nh * hd // tp.size if tp is not None and tp.attn == "columns" else nh * hd
    qkv = _linear(h, attn_p["wqkv"], attn_p.get("bqkv"))
    q, k, v = qkv.split([q_cols, nkv * hd, nkv * hd], dim=-1)
    if q_cols != nh * hd:
        q = comm.all_gather(q, tp.group, axis=-1)
    q, k, v = q.unflatten(-1, (nh, hd)), k.unflatten(-1, (nkv, hd)), v.unflatten(-1, (nkv, hd))
    return _rotate(q, k, cfg, rope) + (v,)


def _rotate(q, k, cfg: TransformerConfig, rope):
    if rope is not None:
        q = apply_rotary_pos_emb(q, None, rot_dim=cfg.rope_dim,
                                 interleaved=cfg.rope_interleaved, table=rope)
        k = apply_rotary_pos_emb(k, None, rot_dim=cfg.rope_dim,
                                 interleaved=cfg.rope_interleaved, table=rope)
    return q, k


@functools.lru_cache(maxsize=16)
def _alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi's per-head slopes (Press et al.), f32: the reference's formula,
    including its interleave for head counts that are not a power of 2.
    Built once a device (its copy to the card is the only host sync) and
    shared by every caller, which only reads it."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        slopes = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


_SPARSITY_CONFIGS = {
    "dense": sc.DenseSparsityConfig,
    "fixed": sc.FixedSparsityConfig,
    "bigbird": sc.BigBirdSparsityConfig,
    "bslongformer": sc.BSLongformerSparsityConfig,
    "variable": sc.VariableSparsityConfig,
}


@functools.lru_cache(maxsize=32)
def _sparse_layout(sparse_attention: tuple, num_heads: int, seq_len: int):
    """Static block-sparse layout for (pattern, heads, seq): the numpy int32
    layout (read-only, since the cache hands the same array to every
    caller) and its block."""
    opts = dict(sparse_attention)
    mode = opts.pop("mode", "fixed")
    config = _SPARSITY_CONFIGS[mode](num_heads=num_heads, **opts)
    layout = np.asarray(config.make_layout(seq_len), np.int32)
    layout.setflags(write=False)
    return layout, config.block


def _attention(q, k, v, cfg: TransformerConfig, window=None, per_layer_window: bool = False,
               head_offset: int = 0):
    """Causal multi-head / grouped-query attention over a whole segment:
    the flash kernel for ``attn_impl="pallas"``, the block-sparse kernels
    for ``"block_sparse"`` (kv heads repeated first, the layout from
    ``cfg.sparse_attention``, default the fixed pattern), else
    einsum-softmax-einsum with f32 logits (the reference's "xla" branch).

    ``window`` restricts each query to the last ``window`` positions (0 =
    unlimited). A uniform window is elided when it is ``<= 0`` or covers the
    whole segment, and rides the flash kernel's band; a per-layer window
    (``per_layer_window``: GPT-Neo's alternation, which the reference's
    layer scan carries as a traced scalar) takes the masked einsum path,
    as it does there. ALiBi adds its bias on the masked path, which it
    never leaves. ``q`` may hold a tensor rank's heads, from global head
    ``head_offset`` on: the per-head quantities (ALiBi's slopes, the
    layout's rows) are taken there."""
    B, S, nh, hd = q.shape

    def own_heads(t):
        return t[head_offset: head_offset + nh]

    if window is not None and not per_layer_window and (window <= 0 or window >= S):
        window = None
    if (cfg.attn_impl == "pallas" and cfg.pos_embedding != "alibi"
            and (window is None or (not per_layer_window and cfg.causal))):
        return flash_attention(q, k, v, causal=cfg.causal, sm_scale=cfg.attn_scale,
                               window=window)
    nkv = k.shape[2]
    if nkv != nh:  # autograd sums the repeated heads' gradients per group
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    if cfg.attn_impl == "block_sparse":
        layout, block = _sparse_layout(cfg.sparse_attention or (("mode", "fixed"),),
                                       cfg.num_heads, S)
        return block_sparse_attention(q, k, v, own_heads(layout), causal=cfg.causal, block=block,
                                      sm_scale=cfg.attn_scale)
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if cfg.pos_embedding == "alibi":
        pos = torch.arange(S, device=q.device, dtype=torch.float32)
        rel = pos[None, :] - pos[:, None]  # (q, k): negative into the past
        slopes = own_heads(_alibi_slopes(cfg.num_heads, q.device))
        logits = logits + slopes[None, :, None, None] * rel[None, None]
    mask = None
    if cfg.causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if window is not None and window > 0:
        ar = torch.arange(S, device=q.device)
        local_ok = ar[:, None] - ar[None, :] < window
        mask = local_ok if mask is None else mask & local_ok
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = fused_softmax(logits).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dense_act(cfg: TransformerConfig):
    if cfg.activation == "relu":
        return F.relu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda x: F.gelu(x, approximate="tanh")


def _mlp_block(h, mlp_p, cfg: TransformerConfig, tp=None):
    """Dense MLP block: h (B, S, D) -> (B, S, D). Under ``tp`` the hidden
    dim is this rank's block, and the output sums over the ranks before
    its bias."""
    if tp is not None:
        h = tpm.copy_to(h, tp)
    if cfg.activation == "silu_glu":
        act = F.silu(_linear(h, mlp_p["wg"])) * _linear(h, mlp_p["wi"])
    else:
        act = _dense_act(cfg)(_linear(h, mlp_p["wi"], mlp_p.get("bi")))
    if tp is None:
        return _linear(act, mlp_p["wo"], mlp_p.get("bo"))
    return _row_parallel(act, mlp_p["wo"], mlp_p.get("bo"), tp)


def _row_parallel(x, w, b, tp):
    """A row-parallel product: this rank's rows of ``w``, summed over the
    tensor ranks, then the (whole) bias."""
    out = tpm.reduce_from(_linear(x, w), tp)
    return out if b is None else out + b


def _embed(params, cfg: TransformerConfig, tokens, tp=None):
    if tp is not None:
        return tpm.vocab_parallel_embedding(tokens, params["embed"]["tok"], tp).to(cfg.torch_dtype)
    return F.embedding(tokens, params["embed"]["tok"]).to(cfg.torch_dtype)


def _embed_norm(x, params, cfg: TransformerConfig):
    """The LayerNorm over the summed embeddings (BLOOM), where the config
    has one."""
    if not cfg.embed_norm:
        return x
    en = params["embed_norm"]
    return _norm(x, en["scale"], en.get("bias"), cfg)


def _final_norm(x, params, cfg: TransformerConfig):
    """The final norm of a pre-LN stack; a post-LN stack ends normalized."""
    if cfg.norm_position != "pre":
        return x
    return _norm(x, params["final_norm"]["scale"], params["final_norm"].get("bias"), cfg)


def _residual(x, h, attn_out, layer_p, cfg: TransformerConfig, tp=None):
    """The residual topology and MLP of a layer, after its attention
    (``h`` the attention's input): pre-LN (GPT-2, Llama), post-LN (OPT with
    ``do_layer_norm_before=False``) or the parallel residual x + attn(h) +
    mlp(ln2 x), or mlp(h) with the shared LN (GPT-NeoX, GPT-J)."""
    mlp_p, ln1, ln2 = layer_p["mlp"], layer_p["ln1"], layer_p["ln2"]
    if cfg.parallel_residual:
        h2 = h if cfg.shared_ln else _norm(x, ln2["scale"], ln2.get("bias"), cfg)
        return x + attn_out + _mlp_block(h2, mlp_p, cfg, tp)
    if cfg.norm_position == "pre":
        x = x + attn_out
        return x + _mlp_block(_norm(x, ln2["scale"], ln2.get("bias"), cfg), mlp_p, cfg, tp)
    x = _norm(x + attn_out, ln1["scale"], ln1.get("bias"), cfg)
    return _norm(x + _mlp_block(x, mlp_p, cfg, tp), ln2["scale"], ln2.get("bias"), cfg)


def _attn_input(x, layer_p, cfg: TransformerConfig):
    """The attention's input: ln1 of x (pre-LN and parallel residual), or x
    itself (post-LN)."""
    if cfg.norm_position != "pre":
        return x
    ln1 = layer_p["ln1"]
    return _norm(x, ln1["scale"], ln1.get("bias"), cfg)


def _layer_body(x, layer_p, cfg: TransformerConfig, rope=None, window=None,
                per_layer_window: bool = False, tp=None):
    """One decoder layer over a whole sequence (no cache); ``rope`` the
    forward's rotary table, ``window`` as :func:`_attention` takes it,
    ``tp`` this rank's place on the tensor axis."""
    B, S, _ = x.shape
    attn_p = layer_p["attn"]
    h = _attn_input(x, layer_p, cfg)
    if tp is not None:
        attn_out = _attention_tp(h, attn_p, cfg, tp, rope, window, per_layer_window)
        return _residual(x, h, attn_out, layer_p, cfg, tp)
    q, k, v = _qkv(h, attn_p, cfg, rope)
    attn_out = _attention(q, k, v, cfg, window, per_layer_window).reshape(
        B, S, cfg.num_heads * cfg.head_dim)
    return _residual(x, h, _linear(attn_out, attn_p["wo"], attn_p.get("bo")), layer_p, cfg)


def _attention_tp(h, attn_p, cfg: TransformerConfig, tp, rope, window, per_layer_window):
    """The attention block on a tensor rank, up to its output projection:
    on the rank's own heads where the counts divide the width (the
    reference's ``_head_shard_map``), else on every head (q gathered from
    the ranks' columns, the output cut back to this rank's)."""
    B, S, _ = h.shape
    hd = cfg.head_dim
    hc = tpm.copy_to(h, tp)
    if tp.heads_split(cfg):
        nh, nkv = cfg.num_heads // tp.size, cfg.kv_heads // tp.size

        def own(name):  # this rank's kv heads of a whole wk/wv (bk/bv)
            return None if name not in attn_p else tpm.scatter_to(attn_p[name], tp, 0)

        q = _linear(hc, attn_p["wq"], attn_p.get("bq"))
        k, v = _linear(hc, own("wk"), own("bk")), _linear(hc, own("wv"), own("bv"))
        q, k = _rotate(q.unflatten(-1, (nh, hd)), k.unflatten(-1, (nkv, hd)), cfg, rope)
        out = _attention(q, k, v.unflatten(-1, (nkv, hd)), cfg, window, per_layer_window,
                         head_offset=tp.rank * nh)
        out = out.reshape(B, S, nh * hd)
    else:
        nh, nkv = cfg.num_heads, cfg.kv_heads
        q = tpm.gather_from(_linear(hc, attn_p["wq"], attn_p.get("bq")), tp)
        k, v = _linear(h, attn_p["wk"], attn_p.get("bk")), _linear(h, attn_p["wv"], attn_p.get("bv"))
        q, k = _rotate(q.unflatten(-1, (nh, hd)), k.unflatten(-1, (nkv, hd)), cfg, rope)
        out = _attention(q, k, v.unflatten(-1, (nkv, hd)), cfg, window, per_layer_window)
        out = tpm.scatter_to(out.reshape(B, S, nh * hd), tp)
    return _row_parallel(out, attn_p["wo"], attn_p.get("bo"), tp)


def forward(params, cfg: TransformerConfig, tokens, tp=None):
    """tokens (B, S) int -> logits (B, S, V). The reference's ``forward``
    without dropout, LTD, PLD or token types; differentiable in ``params``
    (the flash path through its own backward kernels). Under ``tp`` the
    params are this tensor rank's (``params["layers"]`` may be any iterable
    of layer dicts) and the logits its block of the vocabulary."""
    check_supported(cfg)
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens, tp)
    if cfg.pos_embedding == "learned":
        x = x + params["embed"]["pos"][:S].to(cfg.torch_dtype)
    x = _embed_norm(x, params, cfg)
    rope = _rope_table(cfg, torch.arange(S, device=tokens.device)[None, :])
    # the reference's layer scan carries per-layer windows as traced
    # scalars, which keeps them on the masked path
    windows = cfg.local_attn_windows or (None,) * cfg.num_layers
    for layer_p, w in zip(params["layers"], windows):
        x = _layer_body(x, layer_p, cfg, rope, w, cfg.varying_windows, tp)
    return _vocab_head(_final_norm(x, params, cfg), params, cfg, tp)


def _vocab_head(x, params, cfg: TransformerConfig, tp=None):
    """Hidden states -> vocab logits (tied or untied head); under ``tp``
    this rank's block of the vocabulary."""
    dtype = cfg.torch_dtype
    if tp is not None:
        x = tpm.copy_to(x, tp)
    if cfg.tie_embeddings:
        return _linear(x, params["embed"]["tok"].to(dtype))
    head = params["lm_head"]
    w, b = head["w"], head.get("b")
    return _linear(x, w if isinstance(w, dict) else w.to(dtype),
                   None if b is None else b.to(dtype))


def apply(params, cfg: TransformerConfig, tokens):
    """tokens (B, S) int -> logits (B, S, V)."""
    return forward(params, cfg, tokens)


def _ce_from_logits(logits, batch, tokens, denom=None, tp=None):
    """Shift + masked token cross-entropy (the reference's, shared with its
    pipeline head). ``labels`` in the batch are taken as they are, else the
    tokens are shifted by one; ``loss_mask`` weights the tokens, and
    ``denom`` overrides the normaliser (a data-parallel rank passes its
    share of the global batch's count). Under ``tp`` the logits are this
    rank's block of the vocabulary."""
    if "labels" in batch:
        labels = batch["labels"]
        logits_for_loss = logits
    else:
        labels = tokens[..., 1:]
        logits_for_loss = logits[..., :-1, :]
    if tp is not None:
        nll = tpm.vocab_parallel_cross_entropy(logits_for_loss, labels, tp)
    else:
        nll = softmax_cross_entropy(logits_for_loss, labels)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[..., : nll.shape[-1]].float()
        if denom is None:
            denom = torch.clamp(mask.sum(), min=1.0)
        return (nll * mask).sum() / denom
    if denom is not None:
        return nll.sum() / denom
    return nll.mean()


def check_trainable(cfg: TransformerConfig) -> None:
    """Raise for the training features outside the training slices: every
    decoder family that serves also trains (rope, GQA, windows, ALiBi,
    ``embed_norm``, post-LN, the parallel residual); dropout, remat,
    random-LTD and progressive layer drop do not yet."""
    check_supported(cfg)
    checks = [
        (cfg.dropout > 0.0, f"dropout={cfg.dropout} (Queue 1 item 10)"),
        (cfg.remat, "activation checkpointing (remat, Queue 1 item 10)"),
        (cfg.random_ltd, "random-LTD (Queue 1 item 10)"),
        (cfg.pld_enabled, "progressive layer drop (Queue 1 item 10)"),
    ]
    for bad, feature in checks:
        if bad:
            raise not_ported(feature)


def loss_fn(params, cfg: TransformerConfig, batch, rng=None, tp=None, denom=None):
    """Next-token cross entropy. batch: {'input_ids': (B, S) int} and
    optional 'labels' (shifted internally if absent) and 'loss_mask'.
    ``rng`` is the reference's dropout key: dropout is not ported
    (:func:`check_trainable` raises for it), so it is accepted and unused.
    ``tp`` and ``denom`` as :func:`forward` and :func:`_ce_from_logits`
    take them."""
    check_trainable(cfg)
    if "token_type_ids" in batch:
        raise not_ported("token_type_ids (encoder embeddings)")
    tokens = batch["input_ids"]
    return _ce_from_logits(forward(params, cfg, tokens, tp), batch, tokens, denom, tp)


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch_size: int, max_len: Optional[int] = None,
               device=None, tp=None):
    """Per-layer KV cache: {"k", "v"} of (L, B, T, kv_heads, head_dim) in the
    model dtype, or with ``kv_cache_dtype="int8"`` each component
    {"q8": int8 of that shape, "s": f32 (L, B, T, kv_heads, 1)}. Under a
    serving shard ``tp`` the cache holds this rank's kv heads."""
    T = max_len or cfg.max_seq_len
    kv_heads = cfg.kv_heads if tp is None else tp.cache_kv_heads(cfg)
    shape = (cfg.num_layers, batch_size, T, kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        def component():
            return {"q8": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)}

        return {"k": component(), "v": component()}
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def _layer_cache(component, i: int):
    """Layer ``i``'s view of a cache component (dense or int8)."""
    if isinstance(component, dict):
        return {k: v[i] for k, v in component.items()}
    return component[i]


def cache_alloc_len(cache) -> int:
    """Allocated time-axis length of a cache (dense or int8)."""
    k = cache["k"]
    return (k["q8"] if isinstance(k, dict) else k).shape[2]


def kv_read_bytes_per_row(cfg: TransformerConfig, read_len: int, tp: int = 1) -> int:
    """Device-memory bytes ONE sequence row's attention streams from the KV
    cache when a decode step attends ``read_len`` slots: K and V across all
    layers, int8 payload and f32 per-token-per-head scales when
    ``kv_cache_dtype == "int8"``. ``tp`` is the width the cache's heads
    split over (``parallel.partition.kv_shard_width``): the bytes are then
    each rank's, as the reference counts them per chip."""
    assert cfg.kv_heads % tp == 0, (cfg.kv_heads, tp)
    if cfg.kv_cache_dtype == "int8":
        per_slot = cfg.kv_heads * (cfg.head_dim * 1 + 4)  # q8 payload + s
    else:
        per_slot = cfg.kv_heads * cfg.head_dim * torch.finfo(cfg.torch_dtype).bits // 8
    return 2 * cfg.num_layers * read_len * per_slot // tp


def _layer_body_cached(x, layer_p, k_cache, v_cache, cfg: TransformerConfig, positions, pos,
                       read_len=None, rope=None, window=None, per_layer_window: bool = False,
                       tp=None):
    """One decoder layer over a segment of S new tokens with KV cache.

    x: (B, S, D); k_cache/v_cache: (B, T, nkv, hd) of THIS layer (or its
    int8 components), written in place; pos: count of tokens already
    cached, a Python int (all rows aligned) or a (B,) tensor. ``read_len``
    tight-reads the cache; ``rope`` is the forward's rotary table;
    ``window`` the layer's local window (0 or None = unlimited), a
    per-layer one (``per_layer_window``) kept off the flash prefill, as the
    reference's layer scan keeps its traced windows. ``tp`` is this rank's
    ``ServingShard`` on a serving mesh: the layer's params and cache are
    the rank's, ALiBi's slopes are taken at its head offset, and the
    row-parallel products sum over the ranks. Returns (x, k_cache,
    v_cache).
    """
    B, S, _ = x.shape
    attn_p = layer_p["attn"]
    h = _attn_input(x, layer_p, cfg)
    if tp is not None and tp.attn == "whole":
        attn_tp = None
    else:
        attn_tp = tp
    q, k, v = _qkv(h, attn_p, cfg, rope, attn_tp)
    nh = q.shape[2]
    offset = 0 if attn_tp is None else attn_tp.head_offset(cfg)

    # PREFILL fast path: pos is the literal int 0 only for a prefill, where
    # attention over the segment is exactly causal self-attention; lengths
    # the reference's auto-tiler can't cover stay on the einsum path, so
    # both packages take the same path at each length. A uniform window
    # rides the kernel's band; the rolling cache relies on it (a segment
    # must not read the ring, whose slots a long segment partly evicts).
    use_flash_prefill = (
        isinstance(pos, int) and pos == 0 and S > 1
        and not per_layer_window
        and cfg.attn_impl == "pallas" and cfg.causal
        and cfg.pos_embedding != "alibi"
        and supports_seq_len(S)
    )
    ring = cfg.rolling_kv_cache
    k_cache, v_cache = update_kv_cache(k_cache, v_cache, k, v, pos, positions, ring=ring)
    if use_flash_prefill:
        w = window if window is not None and 0 < window < S else None
        attn_out = flash_attention(q, k, v, causal=True, sm_scale=cfg.attn_scale, window=w)
    else:
        cache_T = (k_cache["q8"] if isinstance(k_cache, dict) else k_cache).shape[1]
        if ring and S > 1 and cache_T < S:
            raise ValueError(
                "rolling KV cache: a multi-token segment longer than the ring must take the "
                f"flash prefill path (S={S}, cache={cache_T}); a segment read through the "
                "ring would see its own evictions")
        slopes = (_alibi_slopes(cfg.num_heads, q.device)[offset: offset + nh]
                  if cfg.pos_embedding == "alibi" else None)
        attn_out = softmax_context(q, k_cache, v_cache, pos, scale=cfg.attn_scale,
                                   positions=positions, alibi_slopes=slopes,
                                   local_window=window, ring=ring,
                                   read_len=None if ring else read_len)
    attn_out = attn_out.reshape(B, S, nh * cfg.head_dim)
    if attn_tp is None:
        attn_out = _linear(attn_out, attn_p["wo"], attn_p.get("bo"))
    else:
        if attn_tp.attn == "columns":  # every head here: keep this rank's columns
            start, n = attn_tp.block(attn_out.shape[-1])
            attn_out = attn_out.narrow(-1, start, n)
        attn_out = _row_parallel(attn_out, attn_p["wo"], attn_p.get("bo"), attn_tp)
    mlp_tp = tp if tp is not None and tp.mlp else None
    return _residual(x, h, attn_out, layer_p, cfg, mlp_tp), k_cache, v_cache


def forward_with_cache(params, cfg: TransformerConfig, tokens, cache, pos, positions=None,
                       read_len=None, last_only: bool = False, tp=None):
    """Segment forward with KV cache (prefill: S = prompt len, pos = 0;
    decode: S = 1). ``pos`` is a Python int (rows aligned) or a (B,) tensor
    of per-row depths; ``positions`` (B, S) overrides the derived positions
    (requires vector ``pos``). ``read_len`` tight-reads the cache time axis.
    ``last_only`` runs the vocab head on the last position only (logits
    (B, 1, V)); that row's numbers are unchanged. The cache is updated in
    place. ``tp`` (a ``ServingShard``) runs this rank of a serving mesh on
    its params and cache; the logits come back whole on every rank (a
    vocab-split head is gathered over the ranks), so a sampler sees the
    global vocabulary. Returns (logits, cache)."""
    check_supported(cfg)
    B, S = tokens.shape
    dev = tokens.device
    if read_len is not None and read_len >= cache_alloc_len(cache):
        read_len = None  # degenerate slice: the allocation is already tight
    vector_pos = torch.is_tensor(pos) and pos.dim() == 1
    x = _embed(params, cfg, tokens, tp if tp is not None and tp.embed else None)
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
    x = _embed_norm(x, params, cfg)
    rope = _rope_table(cfg, positions if vector_pos else positions[:1])
    # as forward(): a uniform window stays a static int (the flash band
    # prefill and the ring rely on it); per-layer windows ride the
    # reference's layer scan as traced scalars, which keeps them off flash
    varying = cfg.varying_windows
    windows = (cfg.local_attn_windows if varying
               else (cfg.uniform_window,) * cfg.num_layers)
    for i, layer_p in enumerate(params["layers"]):
        x, _, _ = _layer_body_cached(x, layer_p, _layer_cache(cache["k"], i),
                                     _layer_cache(cache["v"], i), cfg, positions, pos,
                                     read_len=read_len, rope=rope, window=windows[i],
                                     per_layer_window=varying, tp=tp)
    if last_only:
        x = x[:, -1:]
    if tp is None or not tp.head:
        return _vocab_head(_final_norm(x, params, cfg), params, cfg), cache
    logits = _vocab_head(_final_norm(x, params, cfg), params, cfg, tp)
    return comm.all_gather(logits, tp.group, axis=-1), cache


class TransformerModel:
    """Engine-protocol wrapper (cfg + init/loss/apply), as the reference's."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    @classmethod
    def from_preset(cls, name: str, **overrides):
        return cls(get_config(name, **overrides))

    def init(self, generator: torch.Generator, place=None):
        return init(generator, self.cfg, place)

    def loss(self, params, batch, rng=None):
        return loss_fn(params, self.cfg, batch, rng=rng)

    def apply(self, params, tokens):
        return apply(params, self.cfg, tokens)
