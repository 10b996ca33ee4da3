"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``),
cut to one device: the whole-generation ``generate`` path and the per-token
loop with bucket migration (``fused_generate: false``), ragged prompts
(``attention_mask``), chunked prefill (``prefill_chunk_size``), int8 weights
(``dtype="int8"`` / ``quant``) and the int8 KV cache
(``kv_cache_dtype="int8"``), draft-model speculative decoding (``generate(...,
draft=)`` or ``init_inference(draft_model=)``), ``forward`` and EOS
truncation. Llama-family models serve with rope and sliding windows, and a
uniform-window model (Mistral) gets the rolling (ring) KV cache on the
aligned paths, as the reference switches it on.

Weights come from a seeded ``torch.Generator``, from the reference's param
tree as numpy arrays (bridged by ``models.transformer.params_from_numpy``),
from an HF model or checkpoint directory (``module_inject``: the policies
give the reference's layout in the stored dtype, bridged the same way; a
directory needs neither ``transformers`` nor ``safetensors``) or as this
package's own tree; every float tensor is cast to the model dtype at load,
then, for int8 weights, each matmul weight is quantized
(scales stay f32). The engine runs on CUDA unless ``device="cpu"`` is
passed; without CUDA and without that argument it raises.

With the ``telemetry`` block enabled, every ``generate``/``forward`` call
emits the reference's ``inference_request`` event through the engine's
hub (``self.telemetry``, which the batching engine and the serving layer
share); only then does a call wait on the device for its timing.

Features outside the slice raise ``NotImplementedError`` (ROADMAP.md):
tensor-parallel meshes, ``profile_model_time``, and telemetry on a per-token
loop that can migrate its cache (the reference's memory snapshot at each
migration belongs to ROADMAP.md Queue 1 item 11 (b)).
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.decoding import (
    bounded_cache_len,
    chunked_generate,
    compile_decode_fns,
    compile_generate_fn,
    compile_ragged_prefill_fn,
    compile_segment_fn,
    decode_kv_bytes,
    decode_loop,
    ragged_decode_loop,
    read_bucket,
    speculative_generate,
)
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops.flash_attention import supports_seq_len
from deepspeed_tpu_torch.ops.quantizer import fake_quantize, quantize_weight
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import log_dist

# matmul weight leaves that switch to int8 storage ("w" = the untied lm
# head; biases, norms and embeddings stay float)
_QUANT_KEYS = ("wqkv", "wo", "wi", "wg", "w")
_QUANT_GROUPS = ("attn", "mlp", "lm_head")


def _check_config(config: InferenceConfig) -> None:
    checks = [
        (config.tensor_parallel.tp_size > 1, "tensor_parallel.tp_size > 1"),
        (config.mesh.shape is not None or config.mesh.rules, "a serving mesh (config.mesh)"),
        (config.moe.enabled, "MoE inference"),
        (config.profile_model_time, "profile_model_time"),
    ]
    for bad, feature in checks:
        if bad:
            raise not_ported(feature)
    if config.kv_cache_dtype not in ("model", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'model' or 'int8', got {config.kv_cache_dtype!r}")
    floor = config.kv_read_floor
    if not (isinstance(floor, int) and floor >= 1 and (floor & (floor - 1)) == 0):
        raise ValueError(f"kv_read_floor must be a positive power of 2, got {floor!r}")


def _is_reference_tree(tree) -> bool:
    """The reference's layout (layers stacked in one dict: numpy arrays, or
    the HF policies' tensors), not this package's list of layers."""
    return isinstance(tree["layers"], dict)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree; ``path`` holds the
    keys (and list indices) from the root."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _is_quant_target(path, ndim: int) -> bool:
    return (ndim >= 2 and path[-1] in _QUANT_KEYS
            and any(n in _QUANT_GROUPS for n in path))


def quantize_weights(params):
    """REAL int8 storage (``quant.num_bits`` 8): each matmul weight becomes
    ``{"q8": int8 (out, in), "s": f32 (out,)}`` (``ops/quantizer.
    quantize_weight``), which the model's ``_linear`` runs as the W8A8
    product. The fused ``wqkv`` is quantized per output row, so each of q, k
    and v gets the scales the reference gives its own matrix."""
    return _map_with_path(
        lambda path, p: quantize_weight(p) if _is_quant_target(path, p.dim()) else p, params)


def fake_quantize_weights(params, cfg, num_bits: int):
    """``quant.num_bits != 8``: fake-quant storage in the model dtype, with
    the reference's group rule over its own layout (layers stacked, weights
    ``x @ w``, q/k/v and their biases apart): every attn/mlp/lm_head leaf of
    two or more dims, in ``max(1, last dim // 128)`` groups when they divide
    its size, else one group."""
    ref_tree = tf.params_to_numpy(params, cfg)

    def fq(path, a):
        if a.ndim < 2 or not any(n in _QUANT_GROUPS for n in path):
            return a
        groups = max(1, a.shape[-1] // 128)
        groups = groups if a.size % groups == 0 else 1
        return fake_quantize(torch.from_numpy(a), num_bits=num_bits, num_groups=groups).numpy()

    dev, dt = params["embed"]["tok"].device, cfg.torch_dtype
    return tf.map_params(lambda p: p.to(dt) if p.is_floating_point() else p,
                         tf.params_from_numpy(_map_with_path(fq, ref_tree), cfg, dev))


class InferenceEngine:
    def __init__(self, model, config=None, params=None, device=None, seed: int = 0):
        self.config = InferenceConfig.parse(config)
        _check_config(self.config)
        # the reference's dispatch: a checkpoint directory converts shard by
        # shard, an HF torch module in place (module_inject)
        if isinstance(model, str):
            from deepspeed_tpu_torch.module_inject.load_checkpoint import convert_hf_checkpoint

            model, hf_params = convert_hf_checkpoint(model)
            params = hf_params if params is None else params
        elif (hasattr(model, "state_dict") and hasattr(model, "config")
              and not isinstance(model, (tf.TransformerModel, tf.TransformerConfig))):
            from deepspeed_tpu_torch.module_inject.policies import convert_hf_model

            model, hf_params = convert_hf_model(model)
            params = hf_params if params is None else params
        if isinstance(model, tf.TransformerConfig):
            model = tf.TransformerModel(model)
        if not isinstance(model, tf.TransformerModel):
            raise not_ported(f"models of type {type(model).__name__}")
        cfg = model.cfg
        self._weight_quant = self.config.dtype == "int8" or self.config.quant.enabled
        overrides = {}
        if self.config.dtype in ("float32", "float16", "bfloat16") and self.config.dtype != cfg.dtype:
            overrides["dtype"] = self.config.dtype
        elif self._weight_quant and cfg.dtype == "float32":
            overrides["dtype"] = "bfloat16"
        if self.config.kv_cache_dtype != cfg.kv_cache_dtype:
            overrides["kv_cache_dtype"] = self.config.kv_cache_dtype
        if self.config.attn_impl is not None and self.config.attn_impl != cfg.attn_impl:
            overrides["attn_impl"] = self.config.attn_impl
        # the rolling KV cache: exact for uniform-window models when the
        # prefill rides the flash band kernel (a segment never reads the
        # ring) and positions are relative (rope) or absent. Speculative
        # decoding writes rows at their own depths, which the ring's aligned
        # math does not cover, so it stays off then
        if (self.config.rolling_kv_cache
                and cfg.uniform_window is not None
                and cfg.pos_embedding in ("rope", "none")
                and overrides.get("attn_impl", cfg.attn_impl) == "pallas"
                and cfg.causal
                and not self.config.speculative.enabled):
            overrides["rolling_kv_cache"] = True
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        tf.check_supported(cfg)
        self.cfg = cfg
        self.model = tf.TransformerModel(cfg)
        self.device = get_accelerator().resolve_device(device)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        elif _is_reference_tree(params):
            params = tf.params_from_numpy(params, cfg, self.device)
        # cast to the model dtype, THEN quantize: the scales stay f32
        dt = cfg.torch_dtype
        params = tf.map_params(
            lambda p: p.to(self.device, dt) if p.is_floating_point() else p.to(self.device),
            params)
        if self._weight_quant:
            nbits = self.config.quant.num_bits
            params = (quantize_weights(params) if nbits == 8
                      else fake_quantize_weights(params, cfg, nbits))
        self.params = params
        # telemetry hub (JSONL request traces, TTFT/decode latency; inert
        # when the block is disabled). A plain attribute: the serving
        # layer re-injects its hub into every rebuilt engine
        self.telemetry = Telemetry(self.config.telemetry, role="inference")
        self._request_id = 0
        log_dist(f"InferenceEngine ready: dtype={cfg.dtype} quant={self._weight_quant} "
                 f"kv_cache_dtype={cfg.kv_cache_dtype} attn_impl={cfg.attn_impl} "
                 f"device={self.device}", ranks=[0])

    def _ring_cache_len(self, max_len: int, prompt_len: int) -> int:
        """Rolling-cache sizing: the cache shrinks to the window when the
        prefill rides the flash band path (a segment never reads the ring),
        or the prompt is a single token; otherwise the full length (the
        ring's math is the plain cache's while nothing wraps)."""
        if not self.cfg.rolling_kv_cache:
            return max_len
        if prompt_len > 1 and not supports_seq_len(prompt_len):
            return max_len  # the einsum prefill must see an unwrapped cache
        return min(max_len, self.cfg.uniform_window)

    @property
    def _ring_off_cfg(self):
        """The model config with the rolling cache off, for the paths that
        write rows at their own depths (ragged, chunked, speculative, the
        batching engine's pools): the ring's aligned math does not cover
        them, so they run full-length caches."""
        if not self.cfg.rolling_kv_cache:
            return self.cfg
        return dataclasses.replace(self.cfg, rolling_kv_cache=False)

    def _tokens(self, input_ids) -> torch.Tensor:
        if torch.is_tensor(input_ids):
            return input_ids.to(self.device, torch.long)
        return torch.tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def forward(self, input_ids):
        """Full-sequence logits (B, S, V)."""
        t0 = time.time()
        tokens = self._tokens(input_ids)
        logits = tf.apply(self.params, self.cfg, tokens)
        return self._finish_request("forward", t0, logits, prompt_tokens=tokens.shape[1],
                                    new_tokens=0, batch=tokens.shape[0])

    def _kv_fields(self, prompt_len: int, new_tokens: int, cache_len: int,
                   floor: Optional[int], batch: int,
                   alloc: Optional[int] = None) -> Optional[dict]:
        """KV-read accounting of a generate call (None when telemetry is
        off): the cache bytes its decode steps streamed (host math over
        the read geometry the decode loop runs), the per-decoded-token
        rate, the cache dtype, and the share of the allocation (``alloc``,
        default the cache length) used."""
        if not self.telemetry.enabled:
            return None
        per_row = decode_kv_bytes(self.cfg, prompt_len, new_tokens, cache_len, floor)
        decoded = max(new_tokens - 1, 0)
        alloc = alloc if alloc is not None else cache_len
        fields = {
            "kv_dtype": "int8" if self.cfg.kv_cache_dtype == "int8" else self.cfg.dtype,
            "kv_bytes_read": int(batch) * per_row,
            "cache_utilization": round(min((prompt_len + new_tokens) / alloc, 1.0), 4),
        }
        if decoded:
            fields["kv_bytes_per_token"] = round(per_row / decoded, 1)
        return fields

    def _finish_request(self, path: str, t0: float, result, prompt_tokens: int,
                        new_tokens: int, batch: int, cache_len: Optional[int] = None,
                        timings: Optional[dict] = None, kv: Optional[dict] = None):
        """Single exit point of every forward/generate path: with telemetry
        on, wait for the device and emit one ``inference_request`` event
        (TTFT where the path has a first-token boundary, tokens/s, the
        cache length and the KV-read fields). The reference's
        ``compile_cache_hit`` has no counterpart: the port compiles
        nothing; nor has its ``_timed_decode_retrace``, which journals the
        per-token loop's XLA re-trace at an untraced allocation: the port
        traces nothing."""
        if not self.telemetry.enabled:
            return result
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.time()
        total_s = now - t0
        self._request_id += 1
        event = {
            "request": self._request_id,
            "path": path,
            "batch": int(batch),
            "prompt_tokens": int(prompt_tokens),
            "new_tokens": int(new_tokens),
            "total_ms": total_s * 1000.0,
        }
        if cache_len is not None:
            event["cache_len"] = int(cache_len)
        if kv is not None:
            event.update(kv)
        ttft_s = (timings or {}).get("first_token_s")
        if ttft_s is not None:
            event["ttft_ms"] = (ttft_s - t0) * 1000.0
        if new_tokens > 0 and total_s > 0:
            event["tokens_per_sec"] = int(batch) * (prompt_tokens + new_tokens) / total_s
            if ttft_s is None:
                event["decode_tokens_per_sec"] = int(batch) * new_tokens / total_s
            elif new_tokens > 1:
                # the first token lands at TTFT; rate the rest over the
                # decode span
                event["decode_tokens_per_sec"] = (
                    int(batch) * (new_tokens - 1) / max(now - ttft_s, 1e-9))
        self.telemetry.emit("inference_request", event)
        return result

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None,
                 draft: Optional["InferenceEngine"] = None,
                 num_draft_tokens: Optional[int] = None, attention_mask=None):
        """Greedy or temperature/top-k/top-p sampling over a KV cache sized
        for the request (with ``fused_generate: false``, grown by bucket
        migration as the loop writes; a window-sized ring under the rolling
        cache). Returns (B, S + max_new_tokens) int32 tokens on the engine's
        device. Sampling draws from ``generator`` (default: one seeded with 0
        on the engine's device).

        ``attention_mask`` ((B, S) of 0/1, HF semantics) takes ragged
        prompts, left or right padded: pads never enter the KV cache, each
        row decodes from its own length, and the prompt region is returned
        as given. With ``prefill_chunk_size`` set, every prompt (masked or
        not) prefills in chunks of that many columns.

        Passing ``draft`` (a second, smaller engine on the same vocabulary)
        switches to lossless speculative decoding: the draft proposes
        ``num_draft_tokens`` tokens a round and this engine verifies them in
        one segment forward (``speculative.num_draft_tokens`` is the
        default; ``speculative.enabled`` with ``init_inference(draft_model=)``
        attaches a draft to every call). Chunked prefill is skipped then."""
        tokens = self._tokens(input_ids)
        B, S = tokens.shape
        if max_new_tokens <= 0:
            return tokens.to(torch.int32)
        # with a mask, capacity is governed by the longest REAL prompt, not
        # the padded width
        longest = S
        if attention_mask is not None:
            attention_mask = np.asarray(attention_mask.cpu() if torch.is_tensor(attention_mask)
                                        else attention_mask)
            longest = int(attention_mask.sum(axis=1).max())
        total = longest + max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt {longest} + {max_new_tokens} new > max_seq_len {self.cfg.max_seq_len}")
        max_len = bounded_cache_len(total, self.cfg.max_seq_len, self.config.max_out_tokens)
        if generator is None and temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        speculating = draft is not None or self.config.speculative.enabled
        if attention_mask is not None and speculating:
            raise NotImplementedError("speculative decoding does not take attention_mask yet")
        if draft is None and speculating:
            draft = getattr(self, "_draft_engine", None)
            if draft is None:
                raise ValueError(
                    "speculative.enabled but no draft model: pass draft= to generate() or "
                    "draft_model= to init_inference(), or set speculative.mode='ngram' for "
                    "draft-free self-drafting (pooled serving, ContinuousBatchingEngine)")
        if draft is not None:
            gamma = (num_draft_tokens if num_draft_tokens is not None
                     else self.config.speculative.num_draft_tokens)
            if gamma < 1:
                raise ValueError(f"speculative.num_draft_tokens must be >= 1, got {gamma}")
            t0 = time.time()
            result = speculative_generate(
                self._ring_off_cfg, self.params, draft, tokens, max_new_tokens, temperature,
                top_k, top_p, generator, gamma, self.config.max_out_tokens,
                get_fns=self._spec_fns, eos_token_id=eos_token_id)
            result = self._finish_request("speculative", t0, result, prompt_tokens=S,
                                          new_tokens=max_new_tokens, batch=B)
            if eos_token_id is not None:
                result = self._truncate_eos(result, S, eos_token_id)
            return result
        if self.config.prefill_chunk_size or attention_mask is not None:
            cache = tf.init_cache(self.cfg, B, max_len, device=self.device)
            # TTFT stamp of the host-driven loops (telemetry only: stamping
            # waits for the first token)
            timings = {} if self.telemetry.enabled else None
            prefill_fn, segment_fn = self._ragged_fns_for(B, max_len)
            t0 = time.time()
            if self.config.prefill_chunk_size:
                path = "chunked_prefill"
                result = chunked_generate(
                    prefill_fn, segment_fn, self.params, tokens, cache, max_len,
                    self.config.prefill_chunk_size, max_new_tokens, temperature, top_k,
                    generator, top_p, attention_mask=attention_mask,
                    tight_read=self.config.kv_tight_read, timings=timings)
            else:
                path = "ragged"
                result = ragged_decode_loop(
                    prefill_fn, segment_fn, self.params, tokens, attention_mask, cache,
                    max_len, max_new_tokens, temperature, top_k, generator, top_p,
                    tight_read=self.config.kv_tight_read, timings=timings)
            result = self._finish_request(
                path, t0, result, prompt_tokens=S, new_tokens=max_new_tokens, batch=B,
                cache_len=max_len, timings=timings,
                kv=self._kv_fields(longest, max_new_tokens, max_len, self._tight_floor(), B))
        else:
            result = self._generate_aligned(tokens, max_len, max_new_tokens, temperature,
                                            top_k, top_p, generator)
        if eos_token_id is not None:
            result = self._truncate_eos(result, S, eos_token_id)
        return result

    def _generate_aligned(self, tokens, max_len: int, max_new_tokens: int, temperature: float,
                          top_k: int, top_p: float, generator):
        """The aligned path of ``generate``: the whole-generation function
        (``fused_generate``, its tight reads as bucket-staged loops), or the
        per-token loop, whose cache starts at the prompt's read bucket and
        grows by migration (:meth:`_migrating_decode_fn`). With the rolling
        cache on, both run a window-sized ring and no tight reads."""
        B, S = tokens.shape
        max_len = self._ring_cache_len(max_len, S)
        # tight reads never apply to the ring geometry (already O(window))
        floor = None if self.cfg.rolling_kv_cache else self._tight_floor()
        if self.config.fused_generate:
            fn = compile_generate_fn(self.cfg, B, max_len, max_new_tokens, temperature,
                                     top_k, top_p, read_floor=floor)
            cache = tf.init_cache(self.cfg, B, max_len, device=self.device)
            t0 = time.time()
            result = fn(self.params, tokens, cache, generator)
            return self._finish_request(
                "fused", t0, result, prompt_tokens=S, new_tokens=max_new_tokens, batch=B,
                cache_len=max_len, kv=self._kv_fields(S, max_new_tokens, max_len, floor, B))
        if floor is not None and self.telemetry.enabled:
            raise not_ported(
                "telemetry on a per-token loop that migrates its cache (the memory_snapshot "
                "at each migration, item 11 (b); kv_tight_read=false or fused_generate "
                "avoid it)")
        # the final allocation stops at bucket(total - 1): the last write
        # lands at total - 2 (the closing sampled token is never cached)
        total = S + max_new_tokens
        alloc = max_len if floor is None else min(read_bucket(S + 1, max_len, floor), max_len)
        final_alloc = (max_len if floor is None
                       else min(read_bucket(max(S + 1, total - 1), max_len, floor), max_len))
        prefill_fn, decode_fn, _, _ = compile_decode_fns(self.cfg, B, max_len)
        if floor is not None:
            decode_fn = self._migrating_decode_fn(decode_fn, max_len, floor)
        cache = tf.init_cache(self.cfg, B, alloc, device=self.device)
        timings = {} if self.telemetry.enabled else None
        t0 = time.time()
        result = decode_loop(prefill_fn, decode_fn, self.params, tokens, cache, max_new_tokens,
                             temperature, top_k, generator, top_p, timings=timings)
        return self._finish_request(
            "decode_loop", t0, result, prompt_tokens=S, new_tokens=max_new_tokens, batch=B,
            cache_len=max_len, timings=timings,
            kv=self._kv_fields(S, max_new_tokens, max_len, floor, B, alloc=final_alloc))

    def _migrating_decode_fn(self, decode_fn, max_len: int, floor: int):
        """Wrap the decode step with bucket-migrated cache growth: when the
        write position reaches the allocation, the cache migrates to the
        next power-of-2 bucket (:meth:`_grow_cache`), so every step reads
        the bucketed active length, the tight-read geometry, with no
        per-step slicing."""

        def dispatch(params, tok, cache, pos):
            if pos + 1 > tf.cache_alloc_len(cache):
                cache = self._grow_cache(cache, min(read_bucket(pos + 1, max_len, floor), max_len))
            return decode_fn(params, tok, cache, pos)

        return dispatch

    @staticmethod
    def _grow_cache(cache, new_len: int):
        """Migrate a KV cache (dense or int8 components) to a longer time
        axis: a new zeroed cache with the old one copied into its head; the
        position mask keeps the tail inert until real writes reach it. It
        cannot be in place: the allocation's length changes."""

        def grow(c):
            if isinstance(c, dict):
                return {k: grow(v) for k, v in c.items()}
            out = c.new_zeros(c.shape[:2] + (new_len,) + c.shape[3:])
            out[:, :, :c.shape[2]] = c
            return out

        return {name: grow(c) for name, c in cache.items()}

    def _tight_floor(self) -> Optional[int]:
        """The tight-read bucket floor, or None when the knob is off."""
        return self.config.kv_read_floor if self.config.kv_tight_read else None

    def _segment_fn(self, batch_size: int, max_len: int):
        """Per-row-position segment forward of the ragged and chunked paths,
        as a dispatcher ``fn(params, toks, cache, pos, active=None)``: a
        caller that passes the live rows' longest cached extent ``active``
        gets the tight-read variant of that extent's bucket."""
        floor = self._tight_floor()
        fns = {}

        def dispatch(params, toks, cache, pos, active=None):
            read_len = None
            if floor is not None and active is not None:
                r = read_bucket(active, max_len, floor)
                read_len = None if r >= max_len else r
            if read_len not in fns:
                fns[read_len] = compile_segment_fn(self._ring_off_cfg, batch_size, max_len,
                                                   read_len)
            return fns[read_len](params, toks, cache, pos)

        return dispatch

    def _ragged_fns_for(self, batch_size: int, max_len: int):
        """(ragged_prefill_fn, segment_fn) of the attention_mask and
        chunked-prefill paths."""
        return (compile_ragged_prefill_fn(self._ring_off_cfg, batch_size, max_len),
                self._segment_fn(batch_size, max_len))

    def _spec_fns(self, batch_size: int, max_len: int):
        """(prefill_fn, segment_fn) of speculative decoding, for the target
        (a (gamma+1)-wide verify) and the draft (1-wide steps) alike: the
        aligned prefill of :func:`compile_decode_fns` and the full-read
        segment dispatcher."""
        prefill_fn = compile_decode_fns(self._ring_off_cfg, batch_size, max_len)[0]
        return prefill_fn, self._segment_fn(batch_size, max_len)

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


def init_inference(model, config=None, params=None, device=None, seed: int = 0,
                   draft_model=None, draft_params=None) -> InferenceEngine:
    """Reference: ``deepspeed_tpu.init_inference``. ``device`` defaults to
    the current CUDA device; pass ``"cpu"`` to run the plain PyTorch paths.

    ``draft_model`` (with ``speculative.enabled``) attaches a smaller
    same-vocabulary model whose engine drives speculative decoding on every
    ``generate`` call. The draft takes the target's ``dtype`` and cache
    format (``kv_cache_dtype``, ``kv_tight_read``, ``kv_read_floor``);
    ``draft_params`` may be the reference's numpy tree."""
    engine = InferenceEngine(model, config=config, params=params, device=device, seed=seed)
    if draft_model is not None:
        engine._draft_engine = InferenceEngine(
            draft_model,
            config={"dtype": engine.config.dtype,
                    "kv_cache_dtype": engine.config.kv_cache_dtype,
                    "kv_tight_read": engine.config.kv_tight_read,
                    "kv_read_floor": engine.config.kv_read_floor},
            params=draft_params, device=engine.device, seed=seed)
    return engine
