"""KV-cached decode machinery (counterpart of ``deepspeed_tpu/inference/decoding.py``),
cut to the serving slice: the tight-read geometry, sampling, the
whole-generation path that ``InferenceEngine.generate`` runs, the
per-row-position paths of ragged (padded) prompts and chunked prefill, and
the continuous-batching tick programs (``compile_pool_tick_fn``,
``compile_row_update_fn``) with their per-request keyed sampler.

The reference compiles a generation into one XLA program; the port runs the
same steps eagerly (CUDA graphs are later work), with the same read
geometry: prefill, then one Python loop per :func:`read_stages` stage. The
``compile_*`` functions keep the reference's names and build plain
functions, so that a CUDA-graph capture can take their place.
"""

from typing import Optional

import numpy as np
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


# A lowbias32-style integer finalizer on int64 tensors that hold 32-bit
# values: every product stays below 2**63 (multipliers below 2**31), so the
# same bits come out on every device.
_M32 = 0xFFFFFFFF


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def request_keys(base_key: int, rids, gens):
    """Per-row sampling keys of the serving tick programs, the counterpart
    of the reference's ``fold_in(fold_in(base, rid), gen)``: a 32-bit key
    from the engine seed, the request id and the token index alone, so a
    request's stream never depends on its slot, its tick, the pipeline
    depth or fused against separate prefill. ``rids``/``gens`` are (B,)
    integer tensors; returns (B,) int64 in [0, 2**32)."""
    seed = _mix32(torch.full_like(rids, int(base_key) & _M32, dtype=torch.int64)
                  ^ ((int(base_key) >> 32) & _M32))
    k = _mix32(seed ^ (rids.long() & _M32))
    return _mix32(k ^ (gens.long() & _M32))


def request_uniforms(base_key: int, rids, gens, vocab_size: int):
    """(B, V) f32 uniforms in (0, 1) keyed by (seed, rid, gen, vocab index):
    a counter-based hash in int64 tensor ops, so the bits are the same on
    the CPU and the card and nothing waits on the host. 23 bits a value,
    (h + 1/2) / 2**23, exact in f32."""
    keys = request_keys(base_key, rids, gens)
    v = torch.arange(vocab_size, device=keys.device, dtype=torch.int64)
    h = _mix32(_mix32(keys[:, None] ^ ((v * 0x9E3779B1) & _M32)[None, :]))
    return ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def select_token_rows(logits, temperature: float, top_k: int, base_key: int, rids, gens,
                      top_p: float = 1.0):
    """Row-wise sampling with one key a row (:func:`request_keys`), the same
    temperature/top-k/top-p filter as :func:`select_token`: Gumbel-max over
    the filtered logits, noise from :func:`request_uniforms`. Greedy
    (``temperature <= 0``) is the argmax."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = _filter_logits(logits, temperature, top_k, top_p)
    u = request_uniforms(base_key, rids, gens, logits.shape[-1])
    return torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


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


def compile_ragged_prefill_fn(cfg, batch_size: int, cache_len: int):
    """Prefill over LEFT- or RIGHT-padded prompts with explicit (B, S)
    positions: pads carry position ``cache_len``, so their KV writes drop,
    and real tokens pack densely at 0..len-1 per row. Returns
    ``fn(params, tokens, positions, cache) -> (logits (B, S, V), cache)``."""

    def prefill(params, tokens, positions, cache):
        assert tokens.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
        zero = torch.zeros(tokens.shape[0], dtype=torch.long, device=tokens.device)
        return tf.forward_with_cache(params, cfg, tokens, cache, zero, positions=positions)

    return prefill


def compile_segment_fn(cfg, batch_size: int, cache_len: int, read_len: Optional[int] = None):
    """Cached segment forward with PER-ROW positions (``pos``: (B,) tensor);
    ``read_len`` builds the tight-read variant, which attends only the first
    ``read_len`` cache slots (the caller guarantees every live row's extent
    fits). Returns ``fn(params, toks, cache, pos) -> (logits, cache)``."""

    def segment(params, toks, cache, pos):
        assert toks.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
        return tf.forward_with_cache(params, cfg, toks, cache, pos, read_len=read_len)

    return segment


def _segment_decode_tail(segment_fn, params, first_tok, cache, prompt_lens, n_more: int,
                         temperature: float, top_k: int, generator, top_p: float,
                         active0: Optional[int] = None):
    """Per-row-position decode loop of the ragged and chunked-prefill paths:
    ``first_tok`` (B,) was sampled from the prefill logits; emits ``n_more``
    further tokens. ``active0`` (the longest row's cached extent before the
    first step) opts into tight reads: each step passes its active extent to
    the engine's read-geometry-aware ``segment_fn`` dispatcher."""
    out = [first_tok]
    pos = torch.as_tensor(prompt_lens, dtype=torch.long, device=first_tok.device)
    for i in range(n_more):
        if active0 is None:
            step_logits, cache = segment_fn(params, out[-1][:, None], cache, pos)
        else:
            step_logits, cache = segment_fn(params, out[-1][:, None], cache, pos,
                                            active=active0 + i + 1)
        out.append(select_token(step_logits[:, 0], temperature, top_k, generator, top_p))
        pos = pos + 1
    return torch.stack(out, dim=1)


def _mask_positions(mask, cache_len: int):
    """Per-row real lengths, dense per-row positions (pads parked at
    ``cache_len``) and each row's last real column, from a (B, S) 0/1
    mask."""
    if not (mask.sum(axis=1) > 0).all():
        raise ValueError("every row needs at least one real token")
    prompt_lens = mask.sum(axis=1).astype(np.int64)
    positions = np.where(mask > 0, np.cumsum(mask, axis=1) - 1, cache_len).astype(np.int64)
    last_col = np.array([np.nonzero(row)[0][-1] for row in mask])
    return prompt_lens, positions, last_col


def _check_mask(attention_mask, shape):
    mask = np.asarray(attention_mask.cpu() if torch.is_tensor(attention_mask) else attention_mask)
    if mask.shape != tuple(shape):
        raise ValueError(f"attention_mask shape {mask.shape} != tokens shape {tuple(shape)}")
    return mask


def ragged_decode_loop(ragged_prefill_fn, segment_fn, params, tokens, attention_mask,
                       cache, cache_len: int, max_new_tokens: int, temperature: float,
                       top_k: int, generator=None, top_p: float = 1.0,
                       tight_read: bool = False):
    """Generate over a PADDED prompt batch (HF attention_mask semantics, left
    or right padding): prefill once with per-row dense positions, then
    per-row-position decode. Returns (B, S + max_new_tokens) int32: the
    prompt region as given (pads included), then the generated tokens."""
    B, S = tokens.shape
    if max_new_tokens <= 0:
        return tokens.to(torch.int32)
    mask = _check_mask(attention_mask, (B, S))
    prompt_lens, positions, last_col = _mask_positions(mask, cache_len)
    dev = tokens.device
    logits, cache = ragged_prefill_fn(params, tokens, torch.as_tensor(positions, device=dev),
                                      cache)
    last_logits = logits[torch.arange(B, device=dev), torch.as_tensor(last_col, device=dev)]
    nxt = select_token(last_logits, temperature, top_k, generator, top_p)
    gen = _segment_decode_tail(segment_fn, params, nxt, cache, prompt_lens,
                               max_new_tokens - 1, temperature, top_k, generator, top_p,
                               active0=int(prompt_lens.max()) if tight_read else None)
    return torch.cat([tokens.to(torch.int32), gen], dim=1)


def chunked_generate(ragged_prefill_fn, segment_fn, params, tokens, cache, cache_len: int,
                     chunk: int, max_new_tokens: int, temperature: float, top_k: int,
                     generator=None, top_p: float = 1.0, attention_mask=None,
                     tight_read: bool = False):
    """Generate with CHUNKED prefill: the prompt streams through (B, chunk)
    prefill segments, so prefill's peak memory is bounded by the chunk and
    one segment shape serves every prompt length. The last chunk's pads
    (and every pad of ``attention_mask``, left or right) carry position
    ``cache_len``, so their writes drop; a chunk of pads only is skipped.
    Decode then shares the ragged per-row tail. Token streams equal the
    unchunked path's (same cache contents, same sampling order)."""
    B, S = tokens.shape
    if max_new_tokens <= 0:
        return tokens.to(torch.int32)
    if chunk < 1:
        raise ValueError(f"prefill_chunk_size must be >= 1, got {chunk}")
    mask = (np.ones((B, S), np.int64) if attention_mask is None
            else _check_mask(attention_mask, (B, S)))
    prompt_lens, positions_all, last_col_all = _mask_positions(mask, cache_len)
    dev = tokens.device
    n_chunks = -(-S // chunk)
    padded_toks = torch.zeros((B, n_chunks * chunk), dtype=tokens.dtype, device=dev)
    padded_toks[:, :S] = tokens
    padded_pos = np.full((B, n_chunks * chunk), cache_len, np.int64)
    padded_pos[:, :S] = positions_all
    rows = torch.arange(B, device=dev)
    last_logits = None
    for i in range(n_chunks):
        lo, hi = i * chunk, (i + 1) * chunk
        if (padded_pos[:, lo:hi] >= cache_len).all():
            continue  # all-pad chunk (left padding / width padding)
        logits, cache = ragged_prefill_fn(params, padded_toks[:, lo:hi],
                                          torch.as_tensor(padded_pos[:, lo:hi], device=dev),
                                          cache)
        # rows whose LAST real token lands in this chunk take their logits
        in_chunk = (last_col_all >= lo) & (last_col_all < hi)
        col = torch.as_tensor(np.where(in_chunk, last_col_all - lo, 0), device=dev)
        picked = logits[rows, col]
        sel = torch.as_tensor(in_chunk, device=dev)[:, None]
        last_logits = picked if last_logits is None else torch.where(sel, picked, last_logits)
    nxt = select_token(last_logits, temperature, top_k, generator, top_p)
    gen = _segment_decode_tail(segment_fn, params, nxt, cache, prompt_lens,
                               max_new_tokens - 1, temperature, top_k, generator, top_p,
                               active0=int(prompt_lens.max()) if tight_read else None)
    return torch.cat([tokens.to(torch.int32), gen], dim=1)


def _clone_cache(cache):
    return {name: ({k: v.clone() for k, v in c.items()} if isinstance(c, dict) else c.clone())
            for name, c in cache.items()}


def compile_pool_tick_fn(cfg, batch_size: int, cache_len: int, n_tokens: int,
                         temperature: float, top_k: int, top_p: float,
                         eos_token_id: Optional[int] = None, read_len: Optional[int] = None,
                         chunk: Optional[int] = None, donate: bool = True):
    """One continuous-batching scheduler tick with ON-DEVICE ACCEPTANCE (the
    reference's signature less ``mesh``/``param_shardings``): the forward,
    per-row sampling (:func:`select_token_rows`), EOS/quota done detection,
    position advance and emission masking all run on the device, and the
    tick returns one small packed int32 buffer, ``(B, n_tokens + 2)``:
    ``[:, :k]`` the sampled tokens, ``[:, k]`` the number emitted, ``[:,
    k+1]`` the done flag. Nothing in it waits on the host, so the engine can
    dispatch tick N+1 before it reads tick N's result.

    Plain / burst (``chunk=None``)::

        tick_fn(params, cache, last_tok, done, pos, gen, quota, rids, key)
          -> (packed, cache, last_tok, done)

    ``pos``/``gen``/``quota``/``rids`` are (B,) integer tensors the host
    uploads each tick; parked rows carry ``pos = cache_len`` so their KV
    writes drop. A row whose token hits EOS or exhausts its quota flips its
    done flag and freezes (emission masked, last_tok and pos held) for the
    rest of the burst. ``key`` is the engine's integer seed.

    Fused prefill (``chunk=W``, ``n_tokens == 1``): the same tick also
    prefills ONE admitting row's next W-wide prompt chunk: decode rows ride
    column 0, the admitting row carries ``chunk_toks``/``chunk_pos`` (pads
    parked at ``cache_len``), and ``emit_col``/``emit_mask`` route sampling
    to its last real prompt column on its final chunk::

        tick_fn(params, cache, last_tok, done, pos, gen, quota, rids, key,
                chunk_toks, chunk_pos, admit_slot, emit_col, emit_mask)
          -> (packed, cache, last_tok, done)

    The counterpart of the reference's donation: the cache and the threaded
    ``last_tok``/``done`` are updated in place and returned. ``donate=False``
    works on copies and leaves the inputs as they were. Returns
    ``(tick_fn, None, None)``, the reference's triple without shardings.
    """
    k = n_tokens
    assert k >= 1, k

    def accept(tok, last_tok, done, gen, quota, emit_mask):
        """Shared acceptance: which rows emit this step, updated state."""
        live = (done == 0) & (emit_mask == 1)
        gen2 = torch.where(live, gen + 1, gen)
        stop = gen2 >= quota
        if eos_token_id is not None:
            stop = stop | (tok == eos_token_id)
        done2 = torch.where(live & stop, 1, done)
        last2 = torch.where(live, tok, last_tok)
        return last2, done2, gen2, live.to(torch.int32)

    def sample(logits, rids, gen, base_key):
        return select_token_rows(logits, temperature, top_k, base_key, rids, gen, top_p)

    def threaded(cache, last_tok, done):
        if donate:
            return cache, last_tok, done
        return _clone_cache(cache), last_tok.clone(), done.clone()

    if chunk is None:
        def run(params, cache, last_tok, done, pos, gen, quota, rids, base_key):
            assert last_tok.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
            cache, last_tok, done = threaded(cache, last_tok, done)
            ones = torch.ones_like(done)
            lt, dn, p, g = last_tok, done, pos.long(), gen
            toks, emitted = [], []
            for _ in range(k):
                logits, cache = tf.forward_with_cache(params, cfg, lt[:, None].long(), cache, p,
                                                      read_len=read_len)
                tok = sample(logits[:, 0], rids, g, base_key)
                lt2, dn2, g, em = accept(tok, lt, dn, g, quota, ones)
                p = torch.where(dn == 0, p + 1, p)
                lt, dn = lt2, dn2
                toks.append(tok)
                emitted.append(em)
            packed = torch.cat([torch.stack(toks, dim=1),
                                torch.stack(emitted, dim=1).sum(dim=1, keepdim=True),
                                dn[:, None]], dim=1).to(torch.int32)
            last_tok.copy_(lt)
            done.copy_(dn)
            return packed, cache, last_tok, done

        return run, None, None

    assert k == 1, "fused-prefill ticks are single-token (burst admits between bursts " \
                   "via the separate-prefill path)"
    W = chunk

    def run(params, cache, last_tok, done, pos, gen, quota, rids, base_key,
            chunk_toks, chunk_pos, admit_slot, emit_col, emit_mask):
        assert last_tok.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
        cache, last_tok, done = threaded(cache, last_tok, done)
        dev = last_tok.device
        toks = torch.zeros((batch_size, W), dtype=torch.long, device=dev)
        toks[:, 0] = last_tok
        toks[admit_slot] = chunk_toks
        positions = torch.full((batch_size, W), cache_len, dtype=torch.long, device=dev)
        positions[:, 0] = pos
        positions[admit_slot] = chunk_pos
        logits, cache = tf.forward_with_cache(params, cfg, toks, cache, pos.long(),
                                              positions=positions, read_len=read_len)
        col = emit_col.long().view(batch_size, 1, 1).expand(batch_size, 1, logits.shape[-1])
        tok = sample(logits.gather(1, col)[:, 0], rids, gen, base_key)
        last2, done2, _, emitted = accept(tok, last_tok, done, gen, quota, emit_mask)
        packed = torch.stack([tok, emitted, done2], dim=1).to(torch.int32)
        last_tok.copy_(last2)
        done.copy_(done2)
        return packed, cache, last_tok, done

    return run, None, None


def compile_row_update_fn(cfg, batch_size: int, donate: bool = True):
    """Row update of the threaded tick state: admission sets one slot's
    ``last_tok``/``done`` without reading or rebuilding the (possibly still
    in flight) tensors: two fills queued behind any tick already on the
    stream (``fill_`` passes the value to the kernel; an item assignment
    would copy it up from the host and wait). ``donate`` as
    :func:`compile_pool_tick_fn`'s. Returns
    ``set_row(last_tok, done, slot, tok, flag) -> (last_tok, done)``."""

    def set_row(last_tok, done, slot, tok, flag):
        assert last_tok.shape[0] == batch_size
        if not donate:
            last_tok, done = last_tok.clone(), done.clone()
        last_tok[slot].fill_(tok)
        done[slot].fill_(flag)
        return last_tok, done

    return set_row
