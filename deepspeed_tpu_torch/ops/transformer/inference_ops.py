"""Inference ops of the decode path (counterpart of
``deepspeed_tpu/ops/transformer/inference_ops.py``): the KV-cache write and
the cached masked attention that ``models/transformer.py`` calls.

Cut to the serving slice: dense caches in the model dtype, no rolling (ring)
cache, no ALiBi, no local window, no int8 KV (ROADMAP.md). Decode attention
is plain PyTorch here, as it is plain einsum code that XLA fuses in the
reference; a hand-written decode-attention kernel is later work.

Unlike the reference's pure functions, the cache write updates the cache
tensors in place (no second copy of a cache that can hold gigabytes) and
returns them.
"""

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.transformer.fused_ops import fused_softmax


def _is_scalar(pos) -> bool:
    return not torch.is_tensor(pos) or pos.dim() == 0


def slice_kv_time(cache_component, read_len: Optional[int]):
    """First ``read_len`` time slots of a (B, T, H, hd) cache component, as a
    view: the attention downstream reads only those slots (the tight-read
    geometry)."""
    if read_len is None:
        return cache_component
    return cache_component[:, :read_len]


def _write_component(cache, new, pos, positions):
    T, S = cache.shape[1], new.shape[1]
    if _is_scalar(pos):
        # contiguous write; like lax.dynamic_update_slice, the start is
        # clamped so that the segment fits
        start = min(max(int(pos), 0), T - S)
        cache[:, start:start + S] = new.to(cache.dtype)
        return cache
    if positions is None:
        raise ValueError("a vector pos needs the (B, S) positions of the new tokens")
    rows = torch.arange(new.shape[0], device=cache.device)[:, None].expand_as(positions)
    keep = (positions >= 0) & (positions < T)  # out-of-range columns drop
    cache[rows[keep], positions[keep]] = new[keep].to(cache.dtype)
    return cache


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos,
                    positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write S new keys/values into (B, T, H, hd) caches, in place.

    ``pos`` scalar: contiguous write at offset pos (plain prefill/decode).
    ``pos`` (B,) vector with ``positions`` (B, S): per-row scatter, each
    row's segment at its own depth; columns >= T are dropped, matching the
    clamped read mask in :func:`softmax_context`.
    """
    return (_write_component(k_cache, k_new, pos, positions),
            _write_component(v_cache, v_new, pos, positions))


def softmax_context(q, k_cache, v_cache, pos, scale: Optional[float] = None,
                    positions=None, read_len: Optional[int] = None) -> torch.Tensor:
    """Cached masked attention: q (B, S, nh, hd) against (B, T, nkv, hd)
    caches (GQA repeat applied here).

    Masking modes:
      - ``positions is None``: every query row attends keys [0..pos].
      - ``positions`` (B, S) + scalar ``pos``: causal, query at absolute
        position p attends keys [0..p] (row 0's positions, as the reference).
      - ``positions`` (B, S) + vector ``pos`` (B,): the same rule row-wise.

    ``read_len`` (int): attend only cache slots [0, read_len), the tight-read
    geometry; the caller guarantees every attended position is below it, so
    the result equals the full-length read.
    """
    B, S, nh, hd = q.shape
    if read_len is not None:
        k_cache = slice_kv_time(k_cache, read_len)
        v_cache = slice_kv_time(v_cache, read_len)
    nkv = k_cache.shape[2]
    kk, vv = k_cache, v_cache
    if nkv != nh:
        kk = kk.repeat_interleave(nh // nkv, dim=2)
        vv = vv.repeat_interleave(nh // nkv, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale  # (B, nh, S, T)
    T = kk.shape[1]
    kpos = torch.arange(T, device=q.device)[None, :]  # (1, T)
    if positions is None:
        mask = (kpos <= pos)[None, None]
    elif _is_scalar(pos):
        qpos = positions[0][:, None]  # (S, 1): absolute positions of the new tokens
        mask = (kpos <= qpos)[None, None]
    else:
        qpos = positions[:, :, None]  # (B, S, 1) per-row positions
        mask = (kpos[None] <= qpos)[:, None]  # (B, 1, S, T)
    logits = logits.masked_fill(~mask, -1e30)
    probs = fused_softmax(logits).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)
