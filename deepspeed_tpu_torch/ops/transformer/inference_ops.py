"""Inference ops of the decode path (counterpart of
``deepspeed_tpu/ops/transformer/inference_ops.py``): the rotary embedding,
the KV-cache write and the cached masked attention that
``models/transformer.py`` calls, for dense caches in the model dtype and for
int8 caches (``{"q8", "s"}`` components: int8 payload and f32
per-token-per-head scales), with local (sliding) windows and the rolling
(ring) cache of uniform-window models (Mistral).

Rope, decode attention and its window and ring masks are plain PyTorch here,
as they are plain jnp code outside any Pallas kernel in the reference; a
hand-written decode-attention kernel is later work. The int8 cache's
dequantize is plain PyTorch too, so on the card it writes a model-dtype copy
of the slice it reads (the reference's fuses into its attention read).
ALiBi's bias (BLOOM) is added to the logits of the cached read, as the
reference adds it.

Unlike the reference's pure functions, the cache write updates the cache
tensors in place (no second copy of a cache that can hold gigabytes) and
returns them.
"""

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.quantizer import div_exact
from deepspeed_tpu_torch.ops.transformer.fused_ops import fused_softmax


def _is_scalar(pos) -> bool:
    return not torch.is_tensor(pos) or pos.dim() == 0


def rope_table(positions, theta: float = 10000.0, rot_dim: int = 64):
    """(cos, sin) of the rotary angles at ``positions`` (B, S), each
    (B, S, 1, rot_dim // 2) in f32, with the reference's arithmetic:
    frequencies ``exp(-log(theta) * arange(half) / half)``, angles
    ``positions * freqs``, all in f32. Every layer of a forward rotates at
    the same positions, so the model builds this once a forward and hands it
    to each layer: the bits equal building it in every call."""
    half = rot_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(div_exact(-math.log(theta) * ar, float(half)))
    angles = positions[:, :, None].float() * freqs[None, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rotary_pos_emb(x, positions, theta: float = 10000.0,
                         rot_dim: Optional[int] = None, interleaved: bool = True,
                         table=None):
    """Rotary embedding over x (B, S, H, hd) at absolute ``positions`` (B, S).

    ``rot_dim`` rotates only the first rot_dim dims of each head (GPT-J /
    GPT-NeoX partial rotary); ``interleaved`` pairs even/odd dims (GPT-J)
    instead of the first and second half (llama / NeoX). The public default
    stays the reference's ``interleaved=True``; the model passes
    ``cfg.rope_interleaved``. ``table``: the (cos, sin) of
    :func:`rope_table` at these positions, built once a forward by the
    model. The rotation runs in f32 (a bf16 x times the f32 table promotes,
    as in JAX), and only the result is cast back to x's dtype."""
    hd = x.shape[-1]
    rd = hd if rot_dim is None else rot_dim
    rot, rest = x[..., :rd], x[..., rd:]
    half = rd // 2
    cos, sin = rope_table(positions, theta, rd) if table is None else table
    if interleaved:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    else:
        x1, x2 = rot[..., :half], rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < hd:
        out = torch.cat([out, rest.to(out.dtype)], dim=-1)
    return out.to(x.dtype)


def quantize_kv(x):
    """Per-token-per-head symmetric int8 quantization of (B, S, H, hd)
    keys/values (the int8 cache write; the scales keep the trailing dim)."""
    a = x.float()
    s = torch.clamp(div_exact(a.abs().amax(dim=-1, keepdim=True), 127.0), min=1e-8)
    q = torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(cache_component, dtype):
    """{"q8","s"} int8 cache component -> dense (B, T, H, hd) in dtype."""
    return (cache_component["q8"].float() * cache_component["s"]).to(dtype)


def slice_kv_time(cache_component, read_len: Optional[int]):
    """First ``read_len`` time slots of a cache component (dense (B, T, H,
    hd) tensor or int8 {"q8","s"} pair), as views: the attention downstream
    reads only those slots (the tight-read geometry)."""
    if read_len is None:
        return cache_component
    if isinstance(cache_component, dict):
        return {"q8": cache_component["q8"][:, :read_len],
                "s": cache_component["s"][:, :read_len]}
    return cache_component[:, :read_len]


def _scatter_index(positions, T: int):
    """(rows, slots, source columns, row has a real column) of the vector-
    position write, computed on the device with no host sync, so that a
    CUDA graph can hold it and a pipelined tick never waits.

    Columns whose position lies in [0, T) are real: column (b, s) writes
    slot ``positions[b, s]``. Every other (parked) column must drop, but a
    fixed-shape scatter writes every column somewhere. So a parked column
    writes again what another write of its row writes: the row's first real
    column, slot and value both; in a row without a real column it writes
    slot 0's old value back. Two writes to one slot then carry the same
    bits, whichever lands last, and the cache equals the one that writes
    the real columns alone. (Real columns of one row never share a slot.)"""
    B, S = positions.shape
    positions = positions.long()
    real = (positions >= 0) & (positions < T)
    has_real = real.any(dim=1)
    first = torch.argmax(real.to(torch.int32), dim=1)  # the first real column (argmax: first max)
    cols = torch.arange(S, device=positions.device)
    src = torch.where(real, cols[None, :], first[:, None])
    slots = torch.where(has_real[:, None], positions.gather(1, src), 0)
    rows = torch.arange(B, device=positions.device)[:, None].expand(B, S)
    return rows, slots, src, has_real


def _ring_copies(pos: int, S: int, T: int):
    """The ring write of an aligned segment of S new tokens at offset ``pos``
    into T slots, as contiguous copies ``(source column, slot, length)``:
    only the segment's last ``min(S, T)`` columns (positions ``>= pos + S -
    T``) are kept, each at slot ``position mod T``, which makes at most two
    runs of slots. The reference scatters every column and drops the stale
    ones; the copies write the same slots with the same values."""
    n = min(S, T)
    first = pos + S - n  # the first kept position
    col, slot = S - n, first % T
    head = min(n, T - slot)
    copies = [(col, slot, head)]
    if head < n:
        copies.append((col + head, 0, n - head))
    return copies


def _write_component(cache, new, pos, scatter, ring=False):
    if ring:
        T, S = cache.shape[1], new.shape[1]
        for col, slot, n in _ring_copies(int(pos), S, T):
            cache[:, slot:slot + n] = new[:, col:col + n].to(cache.dtype)
        return cache
    if scatter is None:
        # contiguous write; like lax.dynamic_update_slice, the start is
        # clamped so that the segment fits
        T, S = cache.shape[1], new.shape[1]
        start = min(max(int(pos), 0), T - S)
        cache[:, start:start + S] = new.to(cache.dtype)
        return cache
    rows, slots, src, has_real = scatter
    B, S = src.shape
    index = src.view(B, S, *([1] * (new.dim() - 2))).expand(B, S, *new.shape[2:])
    values = torch.where(has_real.view(B, *([1] * (new.dim() - 1))),
                         new.gather(1, index).to(cache.dtype), cache[:, :1])
    cache.index_put_((rows, slots), values)
    return cache


def _write(cache, new, pos, scatter, ring=False):
    if isinstance(cache, dict):
        q, s = quantize_kv(new)
        return {"q8": _write_component(cache["q8"], q, pos, scatter, ring),
                "s": _write_component(cache["s"], s, pos, scatter, ring)}
    return _write_component(cache, new, pos, scatter, ring)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos,
                    positions=None, ring=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write S new keys/values into (B, T, H, hd) caches (or int8
    {"q8","s"} cache components: the write quantizes per token and head),
    in place.

    ``pos`` scalar: contiguous write at offset pos (plain prefill/decode).
    ``pos`` (B,) vector with ``positions`` (B, S): per-row scatter, each
    row's segment at its own depth; columns outside [0, T) are dropped,
    matching the clamped read mask in :func:`softmax_context`.
    ``ring``: the rolling cache of sliding-window models: position p lands
    at slot p mod T, and of a segment longer than the cache only its last T
    positions land. It needs the aligned path (a Python-int ``pos``), where
    the write is at most two contiguous copies: no scatter, no host sync.
    """
    scatter = None
    if not _is_scalar(pos):
        if ring:
            raise ValueError("ring cache writes need the aligned (scalar-pos) path")
        if positions is None:
            raise ValueError("a vector pos needs the (B, S) positions of the new tokens")
        T = (k_cache["q8"] if isinstance(k_cache, dict) else k_cache).shape[1]
        scatter = _scatter_index(positions, T)
    return (_write(k_cache, k_new, pos, scatter, ring),
            _write(v_cache, v_new, pos, scatter, ring))


def softmax_context(q, k_cache, v_cache, pos, scale: Optional[float] = None,
                    positions=None, alibi_slopes=None, local_window=None,
                    ring=False, read_len: Optional[int] = None) -> torch.Tensor:
    """Cached masked attention: q (B, S, nh, hd) against (B, T, nkv, hd)
    caches (GQA repeat applied here); int8 caches are dequantized to q's
    dtype at the read.

    Masking modes:
      - ``positions is None``: every query row attends keys [0..pos].
      - ``positions`` (B, S) + scalar ``pos``: causal, query at absolute
        position p attends keys [0..p] (row 0's positions, as the reference).
      - ``positions`` (B, S) + vector ``pos`` (B,): the same rule row-wise.

    ``local_window`` (int; 0 or None = unlimited) restricts each query to
    the last ``local_window`` key positions (GPT-Neo local layers, Mistral's
    sliding window). ``ring``: the cache is a rolling buffer, slot s holding
    the latest absolute position congruent to s mod T; the masks run over
    those derived positions (the plain cache's while nothing has wrapped),
    and unwritten slots (a negative derived position) are masked. It needs
    the aligned path and a window. ``read_len`` (int): attend only cache
    slots [0, read_len), the tight-read geometry; the caller guarantees
    every attended position is below it, so the result equals the
    full-length read. ``alibi_slopes`` (nh,) f32 adds ALiBi's bias, slope
    times (key position - query position), on both ``positions`` paths (not
    with the ring, as in the reference).
    """
    B, S, nh, hd = q.shape
    if ring:
        if positions is None or not _is_scalar(pos):
            raise ValueError("ring cache reads need the aligned (scalar-pos + positions) path")
        if alibi_slopes is not None:
            raise ValueError("the ring cache does not support ALiBi")
        if local_window is None:
            raise ValueError("the ring cache requires a sliding window (local_window)")
        if read_len is not None:
            raise ValueError("tight reads do not apply to the rolling (ring) cache")
    if read_len is not None:
        k_cache = slice_kv_time(k_cache, read_len)
        v_cache = slice_kv_time(v_cache, read_len)
    if isinstance(k_cache, dict):
        k_cache = dequantize_kv(k_cache, q.dtype)
        v_cache = dequantize_kv(v_cache, q.dtype)
    nkv = k_cache.shape[2]
    kk, vv = k_cache, v_cache
    if nkv != nh:
        kk = kk.repeat_interleave(nh // nkv, dim=2)
        vv = vv.repeat_interleave(nh // nkv, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale  # (B, nh, S, T)
    T = kk.shape[1]
    kpos = torch.arange(T, device=q.device)[None, :]  # (1, T)
    if ring:
        # absolute position each slot holds after this segment's write: the
        # largest a < pos + S with a = slot (mod T); negative = unwritten
        last = int(pos) + S - 1
        kpos = last - torch.remainder(last - kpos, T)
    qpos = None
    if positions is None:
        mask = (kpos <= pos)[None, None]
    elif _is_scalar(pos):
        qpos = positions[0][:, None]  # (S, 1): absolute positions of the new tokens
        if alibi_slopes is not None:
            rel = kpos.float() - qpos.float()  # (S, T)
            logits = logits + alibi_slopes[None, :, None, None] * rel[None, None]
        mask = (kpos <= qpos)[None, None]
    else:
        qpos = positions[:, :, None]  # (B, S, 1) per-row positions
        if alibi_slopes is not None:
            rel = kpos[None].float() - qpos.float()  # (B, S, T)
            logits = logits + alibi_slopes[None, :, None, None] * rel[:, None]
        mask = (kpos[None] <= qpos)[:, None]  # (B, 1, S, T)
    if local_window is not None and qpos is not None and local_window > 0:
        local_ok = kpos > qpos - local_window
        mask = mask & (local_ok[None, None] if _is_scalar(pos) else local_ok[:, None])
    if ring:
        # unwritten slots: the causal mask alone would admit them for early queries
        mask = mask & (kpos >= 0)[None, None]
    logits = logits.masked_fill(~mask, -1e30)
    probs = fused_softmax(logits).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)
