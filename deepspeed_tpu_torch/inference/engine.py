"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``),
cut to the serving slice: one device, the whole-generation ``generate``
path, ``forward`` and EOS truncation.

Weights come from a seeded ``torch.Generator``, from the reference's param
tree as numpy arrays (bridged by ``models.transformer.params_from_numpy``)
or as this package's own tree; every float tensor is cast to the model
dtype at load. The engine runs on CUDA unless ``device="cpu"`` is passed;
without CUDA and without that argument it raises.

Features outside the slice raise ``NotImplementedError`` (ROADMAP.md):
tensor-parallel meshes, int8 weights and KV, speculative decoding, ragged
prompts (``attention_mask``), chunked prefill, the per-token decode loop
(``fused_generate: false``) and telemetry.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.decoding import bounded_cache_len, compile_generate_fn
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import log_dist


def _check_config(config: InferenceConfig) -> None:
    checks = [
        (config.tensor_parallel.tp_size > 1, "tensor_parallel.tp_size > 1"),
        (config.mesh.shape is not None or config.mesh.rules, "a serving mesh (config.mesh)"),
        (config.dtype == "int8" or config.quant.enabled, "int8 weights (dtype 'int8' / quant)"),
        (config.kv_cache_dtype != "model", f"kv_cache_dtype={config.kv_cache_dtype!r}"),
        (config.speculative.enabled, "speculative decoding"),
        (config.prefill_chunk_size is not None, "chunked prefill (prefill_chunk_size)"),
        (not config.fused_generate,
         "the per-token decode loop with bucket migration (fused_generate=false)"),
        (config.telemetry.enabled, "telemetry"),
        (config.moe.enabled, "MoE inference"),
        (config.profile_model_time, "profile_model_time"),
    ]
    for bad, feature in checks:
        if bad:
            raise not_ported(feature)
    floor = config.kv_read_floor
    if not (isinstance(floor, int) and floor >= 1 and (floor & (floor - 1)) == 0):
        raise ValueError(f"kv_read_floor must be a positive power of 2, got {floor!r}")


def _is_numpy_tree(tree) -> bool:
    leaf = tree["embed"]["tok"]
    return not torch.is_tensor(leaf)


class InferenceEngine:
    def __init__(self, model, config=None, params=None, device=None, seed: int = 0):
        self.config = InferenceConfig.parse(config)
        _check_config(self.config)
        if isinstance(model, tf.TransformerConfig):
            model = tf.TransformerModel(model)
        if not isinstance(model, tf.TransformerModel):
            raise not_ported(f"models of type {type(model).__name__} (HF loading)")
        cfg = model.cfg
        overrides = {}
        if self.config.dtype in ("float32", "float16", "bfloat16") and self.config.dtype != cfg.dtype:
            overrides["dtype"] = self.config.dtype
        if self.config.attn_impl is not None and self.config.attn_impl != cfg.attn_impl:
            overrides["attn_impl"] = self.config.attn_impl
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        tf.check_supported(cfg)
        self.cfg = cfg
        self.model = tf.TransformerModel(cfg)
        self.device = get_accelerator().resolve_device(device)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        elif _is_numpy_tree(params):
            params = tf.params_from_numpy(params, cfg, self.device)
        dt = cfg.torch_dtype
        self.params = tf.map_params(
            lambda p: p.to(self.device, dt) if p.is_floating_point() else p.to(self.device),
            params)
        log_dist(f"InferenceEngine ready: dtype={cfg.dtype} attn_impl={cfg.attn_impl} "
                 f"device={self.device}", ranks=[0])

    def _tokens(self, input_ids) -> torch.Tensor:
        if torch.is_tensor(input_ids):
            return input_ids.to(self.device, torch.long)
        return torch.tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def forward(self, input_ids):
        """Full-sequence logits (B, S, V)."""
        return tf.apply(self.params, self.cfg, self._tokens(input_ids))

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None, attention_mask=None):
        """Greedy or temperature/top-k/top-p sampling over a KV cache sized
        once for the request. Returns (B, S + max_new_tokens) int32 tokens on
        the engine's device. Sampling draws from ``generator`` (default: one
        seeded with 0 on the engine's device)."""
        if attention_mask is not None:
            raise not_ported("ragged prompts (attention_mask)")
        tokens = self._tokens(input_ids)
        B, S = tokens.shape
        if max_new_tokens <= 0:
            return tokens.to(torch.int32)
        total = S + max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt {S} + {max_new_tokens} new > max_seq_len {self.cfg.max_seq_len}")
        max_len = bounded_cache_len(total, self.cfg.max_seq_len, self.config.max_out_tokens)
        if generator is None and temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        floor = self.config.kv_read_floor if self.config.kv_tight_read else None
        fn = compile_generate_fn(self.cfg, B, max_len, max_new_tokens, temperature,
                                 top_k, top_p, read_floor=floor)
        cache = tf.init_cache(self.cfg, B, max_len, device=self.device)
        result = fn(self.params, tokens, cache, generator)
        if eos_token_id is not None:
            result = self._truncate_eos(result, S, eos_token_id)
        return result

    @staticmethod
    def _truncate_eos(tokens, prompt_len, eos_id):
        """Pad everything after each row's first generated EOS with EOS."""
        gen = tokens[:, prompt_len:]
        is_eos = (gen == eos_id).long()
        after = (is_eos.cumsum(dim=1) - is_eos) > 0  # strictly after the first EOS
        if not bool(after.any()):
            return tokens
        out = tokens.clone()
        out[:, prompt_len:] = torch.where(after, torch.full_like(gen, eos_id), gen)
        return out


def init_inference(model, config=None, params=None, device=None, seed: int = 0) -> InferenceEngine:
    """Reference: ``deepspeed_tpu.init_inference``. ``device`` defaults to
    the current CUDA device; pass ``"cpu"`` to run the plain PyTorch paths."""
    return InferenceEngine(model, config=config, params=params, device=device, seed=seed)
