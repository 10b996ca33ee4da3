"""KV-cached decode machinery (counterpart of ``deepspeed_tpu/inference/decoding.py``),
cut to the serving slice: the tight-read geometry, sampling, and the
whole-generation path that ``InferenceEngine.generate`` runs.

The reference compiles a generation into one XLA program; the port runs the
same steps eagerly (CUDA graphs are later work), with the same read
geometry: prefill, then one Python loop per :func:`read_stages` stage.
"""

from typing import Optional

import torch

from deepspeed_tpu_torch.models import transformer as tf


def read_bucket(n: int, cap: int, floor: int = 16) -> int:
    """Smallest power-of-2 length >= n (starting at ``floor``), clamped to
    ``cap``: the one bucketing rule of the decode stack."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


def read_stages(prompt_len: int, n_steps: int, cache_len: int, floor: Optional[int]):
    """[(read_len_or_None, n_steps)] decode-step stages for a generation:
    step j attends ``prompt_len + j + 1`` cached slots, so it reads the
    bucket covering that extent; consecutive steps sharing a bucket form one
    stage. ``floor=None`` = tight reads off, a single full-length stage. A
    read_len of ``None`` means the whole allocation."""
    if n_steps <= 0:
        return []
    if floor is None:
        return [(None, n_steps)]
    stages, j = [], 0
    while j < n_steps:
        r = read_bucket(prompt_len + j + 1, cache_len, floor)
        if r >= cache_len:
            stages.append((None, n_steps - j))
            break
        n = min(n_steps, r - prompt_len) - j
        stages.append((r, n))
        j += n
    return stages


def decode_kv_bytes(cfg, prompt_len: int, new_tokens: int, cache_len: int,
                    floor: Optional[int] = None) -> int:
    """KV-cache bytes ONE sequence row streams across the ``new_tokens - 1``
    decode steps of a generation (prefill excluded), following the read
    geometry the decode loop executes (read_stages)."""
    total = 0
    for r, n in read_stages(prompt_len, new_tokens - 1, cache_len, floor):
        total += n * tf.kv_read_bytes_per_row(cfg, r if r is not None else cache_len)
    return total


def bounded_cache_len(total: int, max_seq_len: int, max_out_tokens: Optional[int]) -> int:
    """KV-cache allocation: bounded by max_out_tokens, grown when the request
    needs more, never past max_seq_len."""
    if not max_out_tokens:
        return max_seq_len
    return max(total, min(max_seq_len, max_out_tokens))


def _filter_logits(logits, temperature: float, top_k: int, top_p: float):
    """Temperature / top-k / nucleus filtering over (B, V) logits."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if top_p < 1.0:
        # keep the smallest prefix of the sorted distribution with
        # cumulative mass >= top_p; the first token is always kept
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < max(top_p, 1e-9)
        cutoff = torch.where(keep, sorted_logits, torch.inf).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, -1e30)
    return logits


def select_token(logits, temperature: float, top_k: int,
                 generator: Optional[torch.Generator] = None, top_p: float = 1.0):
    """Greedy / temperature / top-k / nucleus (top-p) sampling, one token per
    row. Sampling draws from ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def compile_generate_fn(cfg, batch_size: int, cache_len: int, max_new_tokens: int,
                        temperature: float, top_k: int, top_p: float,
                        read_floor: Optional[int] = None):
    """Whole-generation function, counterpart of the reference's fused
    program: prefill, then the decode steps, one loop per
    :func:`read_stages` stage so each step attends the bucketed active
    prefix of the cache (``read_floor``; None = full-length reads). Nothing
    is compiled: the name and arguments stay the reference's so that a
    CUDA-graph capture can take its place.

    Returns ``fn(params, tokens, cache, generator) -> (B, S + max_new_tokens)``.
    """

    def fn(params, tokens, cache, generator=None):
        B, S = tokens.shape
        assert B == batch_size and tf.cache_alloc_len(cache) == cache_len
        logits, cache = tf.forward_with_cache(params, cfg, tokens, cache, 0, last_only=True)
        last = select_token(logits[:, -1], temperature, top_k, generator, top_p)
        out = [last]
        pos = S
        for read_len, n in read_stages(S, max_new_tokens - 1, cache_len, read_floor):
            for _ in range(n):
                step_logits, cache = tf.forward_with_cache(
                    params, cfg, last[:, None], cache, pos, read_len=read_len)
                last = select_token(step_logits[:, -1], temperature, top_k, generator, top_p)
                out.append(last)
                pos += 1
        return torch.cat([tokens.to(torch.int32), torch.stack(out, dim=1)], dim=1)

    return fn
