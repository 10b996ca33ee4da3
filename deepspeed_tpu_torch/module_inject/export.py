"""Export parameters back to an HF state dict (counterpart of
``deepspeed_tpu/module_inject/export.py``): the inverse of the injection
policies' mapping for GPT-2 and Llama/Mistral, so that a model trained or
served by the port can be handed to the torch ecosystem as a standard HF
checkpoint.

The parameters are this package's tree (``InferenceEngine.params``, a
training engine's params): q/k/v fused in ``wqkv`` and weights stored
(out, in), which is already torch's Linear layout, so the Llama export
slices and GPT-2's Conv1D export transposes, both as views of the given
tensors in their own dtype and device.
"""

import os
from typing import Dict

import torch

from deepspeed_tpu_torch.models.transformer import TransformerConfig


def export_hf_state_dict(params: Dict, cfg: TransformerConfig,
                         architecture: str) -> Dict[str, torch.Tensor]:
    """params: this package's tree; returns {hf_param_name: tensor} for the
    architecture family ("gpt2" | "llama" | "mistral")."""
    arch = architecture.lower()
    if arch in ("gpt2", "gpt2lmheadmodel"):
        return _export_gpt2(params, cfg)
    if arch in ("llama", "llamaforcausallm", "mistral", "mistralforcausallm"):
        return _export_llama(params, cfg)
    raise NotImplementedError(
        f"HF export supports gpt2 and llama/mistral; got {architecture!r}")


def _qkv(layer, cfg: TransformerConfig, name: str):
    """A layer's fused ``wqkv`` (or ``bqkv``) split into its q, k and v
    rows."""
    hd = cfg.head_dim
    return layer["attn"][name].split(
        [cfg.num_heads * hd, cfg.kv_heads * hd, cfg.kv_heads * hd], dim=0)


def _export_gpt2(params: Dict, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    out = {
        "transformer.wte.weight": params["embed"]["tok"],
        "transformer.wpe.weight": params["embed"]["pos"],
        "transformer.ln_f.weight": params["final_norm"]["scale"],
        "transformer.ln_f.bias": params["final_norm"]["bias"],
        # the tied head: HF GPT2LMHeadModel's state_dict carries the shared
        # tensor under both names
        "lm_head.weight": params["embed"]["tok"],
    }
    for i, layer in enumerate(params["layers"]):
        p = f"transformer.h.{i}."
        attn, mlp = layer["attn"], layer["mlp"]
        # Conv1D stores (in, out): the transpose of the fused (out, in) rows
        out[p + "attn.c_attn.weight"] = attn["wqkv"].T
        out[p + "attn.c_attn.bias"] = attn["bqkv"]
        out[p + "attn.c_proj.weight"] = attn["wo"].T
        out[p + "attn.c_proj.bias"] = attn["bo"]
        out[p + "mlp.c_fc.weight"] = mlp["wi"].T
        out[p + "mlp.c_fc.bias"] = mlp["bi"]
        out[p + "mlp.c_proj.weight"] = mlp["wo"].T
        out[p + "mlp.c_proj.bias"] = mlp["bo"]
        for n, ln in (("1", "ln1"), ("2", "ln2")):
            out[p + f"ln_{n}.weight"] = layer[ln]["scale"]
            out[p + f"ln_{n}.bias"] = layer[ln]["bias"]
    return out


def _export_llama(params: Dict, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    out = {
        "model.embed_tokens.weight": params["embed"]["tok"],
        "model.norm.weight": params["final_norm"]["scale"],
        "lm_head.weight": (params["embed"]["tok"] if cfg.tie_embeddings
                           else params["lm_head"]["w"]),
    }
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        q, k, v = _qkv(layer, cfg, "wqkv")
        out[p + "self_attn.q_proj.weight"] = q
        out[p + "self_attn.k_proj.weight"] = k
        out[p + "self_attn.v_proj.weight"] = v
        out[p + "self_attn.o_proj.weight"] = layer["attn"]["wo"]
        out[p + "mlp.gate_proj.weight"] = layer["mlp"]["wg"]
        out[p + "mlp.up_proj.weight"] = layer["mlp"]["wi"]
        out[p + "mlp.down_proj.weight"] = layer["mlp"]["wo"]
        out[p + "input_layernorm.weight"] = layer["ln1"]["scale"]
        out[p + "post_attention_layernorm.weight"] = layer["ln2"]["scale"]
    return out


def save_hf_checkpoint(save_dir: str, params: Dict, cfg: TransformerConfig,
                       architecture: str, hf_config=None) -> str:
    """Write an HF-loadable checkpoint directory: ``pytorch_model.bin`` (the
    state dict in f32 on the host, each tensor its own contiguous copy) plus
    ``config.json`` when a config object is given (a transformers config or
    ``load_checkpoint.HFConfig``). Returns the state dict's path."""
    os.makedirs(save_dir, exist_ok=True)
    state = {k: v.detach().to(device="cpu", dtype=torch.float32,
                              memory_format=torch.contiguous_format, copy=True)
             for k, v in export_hf_state_dict(params, cfg, architecture).items()}
    path = os.path.join(save_dir, "pytorch_model.bin")
    torch.save(state, path)
    if hf_config is not None:
        hf_config.save_pretrained(save_dir)
    return path
