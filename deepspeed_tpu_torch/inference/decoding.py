"""KV-cached decode machinery (counterpart of ``deepspeed_tpu/inference/decoding.py``),
cut to the serving slice: the tight-read geometry, sampling, the
whole-generation path that ``InferenceEngine.generate`` runs, the per-token
loop (:func:`decode_loop`, ``fused_generate: false``), the
per-row-position paths of ragged (padded) prompts and chunked prefill, the
continuous-batching tick programs (``compile_pool_tick_fn``,
``compile_row_update_fn``) with their per-request keyed sampler, and
speculative decoding: the standalone draft-model loop
(``speculative_generate``, acceptance in host numpy as in the reference) and
the speculative pool tick (``compile_spec_pool_tick_fn``, acceptance on the
device, ngram and draft-model proposals).

The reference compiles a generation into one XLA program; the port runs the
same steps eagerly (CUDA graphs are later work), with the same read
geometry: prefill, then one Python loop per :func:`read_stages` stage. The
``compile_*`` functions keep the reference's names and build plain
functions, so that a CUDA-graph capture can take their place.

Every ``compile_*`` function takes the mesh first, as the reference's do:
``None`` on one device, or this rank's ``ServingShard`` of a serving mesh
(``inference/mesh.py``), whose params and KV cache the function then runs
on; its forward gathers the logits, so sampling and acceptance see the
global vocabulary and every rank computes the same tokens.
"""

import time
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models import transformer as tf


def _mark_first_token(timings: Optional[dict], token):
    """TTFT hook: when the caller passes a ``timings`` dict (telemetry
    enabled), wait for the first sampled token and stamp its wall clock.
    ``None`` (the default everywhere) never waits on the device."""
    if timings is not None:
        if token.is_cuda:
            torch.cuda.synchronize(token.device)
        timings["first_token_s"] = time.time()


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
                    floor: Optional[int] = None, tp: int = 1) -> int:
    """KV-cache bytes ONE sequence row streams across the ``new_tokens - 1``
    decode steps of a generation (prefill excluded), following the read
    geometry the decode loop executes (read_stages); ``tp`` (the cache's
    head-shard width) makes them each rank's."""
    total = 0
    for r, n in read_stages(prompt_len, new_tokens - 1, cache_len, floor):
        total += n * tf.kv_read_bytes_per_row(cfg, r if r is not None else cache_len, tp=tp)
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


def _unit(h):
    """32-bit hashes -> f32 uniforms in (0, 1): 23 bits a value,
    (h + 1/2) / 2**23, exact in f32."""
    return ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def _key_uniforms(keys, vocab_size: int):
    """(B, V) uniforms from (B,) keys, one a vocab index."""
    v = torch.arange(vocab_size, device=keys.device, dtype=torch.int64)
    return _unit(_mix32(_mix32(keys[:, None] ^ ((v * 0x9E3779B1) & _M32)[None, :])))


def request_uniforms(base_key: int, rids, gens, vocab_size: int):
    """(B, V) f32 uniforms in (0, 1) keyed by (seed, rid, gen, vocab index):
    a counter-based hash in int64 tensor ops, so the bits are the same on
    the CPU and the card and nothing waits on the host."""
    return _key_uniforms(request_keys(base_key, rids, gens), vocab_size)


# Speculative tick lanes: a third level on top of request_keys' (seed, rid,
# token index) identity separates the three independent draws speculation
# makes at a token index: the draft proposal, the acceptance uniform and the
# bonus/correction draw. The residual draw at an index is independent of
# the acceptance uniform that rejected the proposal there, which rejection
# sampling needs.
LANE_DRAFT, LANE_ACCEPT, LANE_BONUS = 1, 2, 3
# the lane keys' own domain constant: a lane key is a hash of a plain key
# and a word no plain key mixes in, so the two families stay apart
_SPEC_DOMAIN = 0x5BD1E995


def spec_request_keys(base_key: int, rids, gens, lane: int):
    """Per-row speculative sampling keys, the counterpart of the reference's
    ``fold_in(fold_in(fold_in(base, rid), gen), lane)``: like
    :func:`request_keys`, a key depends only on (engine seed, request id,
    token index, lane), never on the slot, the tick depth or how many
    proposals earlier rounds accepted. ``rids``/``gens`` are integer tensors
    of one shape; returns int64 keys of that shape in [0, 2**32)."""
    return _mix32(request_keys(base_key, rids, gens) ^ _mix32(_SPEC_DOMAIN ^ int(lane)))


def spec_accept_uniforms(base_key: int, rids, gens):
    """One f32 uniform in (0, 1) a (rid, token index) from the acceptance
    lane; ``rids``/``gens`` of one shape, the result of that shape."""
    return _unit(_mix32(spec_request_keys(base_key, rids, gens, LANE_ACCEPT)))


def spec_uniforms(base_key: int, rids, gens, lane: int, vocab_size: int):
    """(B, V) uniforms of a lane (the draft proposal's, the bonus draw's)
    for Gumbel-max over the vocabulary."""
    return _key_uniforms(spec_request_keys(base_key, rids, gens, lane), vocab_size)


def _gumbel_max(logp, u):
    """Categorical draw over (B, V) log-probabilities from (B, V)
    uniforms."""
    return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)


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
    return _gumbel_max(filtered, u).to(torch.int32)


def compile_decode_fns(mesh, cfg, batch_size: int, cache_len: int):
    """(prefill_fn, decode_fn, None, None): the aligned prefill and the
    1-wide decode step, the reference's quadruple without shardings. The
    prefill (``pos`` 0: flash attention under ``attn_impl="pallas"``) returns
    the last position's logits (B, 1, V), the only row its callers read;
    ``decode_fn(params, tok, cache, pos) -> (logits (B, V), cache)``. Both
    take a cache of any allocation up to ``cache_len``, as the reference's
    jitted pair retraces at each of the per-token loop's migrated
    allocations."""

    def prefill(params, tokens, cache):
        assert tokens.shape[0] == batch_size and tf.cache_alloc_len(cache) <= cache_len
        return tf.forward_with_cache(params, cfg, tokens, cache, 0, last_only=True, tp=mesh)

    def decode(params, tok, cache, pos):
        logits, cache = tf.forward_with_cache(params, cfg, tok, cache, pos, tp=mesh)
        return logits[:, -1], cache

    return prefill, decode, None, None


def compile_generate_fn(mesh, cfg, batch_size: int, cache_len: int, max_new_tokens: int,
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
        logits, cache = tf.forward_with_cache(params, cfg, tokens, cache, 0, last_only=True,
                                              tp=mesh)
        last = select_token(logits[:, -1], temperature, top_k, generator, top_p)
        out = [last]
        pos = S
        for read_len, n in read_stages(S, max_new_tokens - 1, cache_len, read_floor):
            for _ in range(n):
                step_logits, cache = tf.forward_with_cache(
                    params, cfg, last[:, None], cache, pos, read_len=read_len, tp=mesh)
                last = select_token(step_logits[:, -1], temperature, top_k, generator, top_p)
                out.append(last)
                pos += 1
        return torch.cat([tokens.to(torch.int32), torch.stack(out, dim=1)], dim=1)

    return fn


def decode_loop(prefill_fn, decode_fn, params, tokens, cache, max_new_tokens: int,
                temperature: float, top_k: int, generator: Optional[torch.Generator] = None,
                top_p: float = 1.0, timings: Optional[dict] = None):
    """Prefill + token-by-token decode, one ``decode_fn`` call a token (the
    reference's per-token loop); returns (B, S + max_new_tokens) int32.
    Samples are drawn from ``generator`` in the order of
    :func:`compile_generate_fn`'s, so on one generator both paths give the
    same sampled bits."""
    if max_new_tokens <= 0:
        return tokens.to(torch.int32)
    S = tokens.shape[1]
    logits, cache = prefill_fn(params, tokens, cache)
    last = select_token(logits[:, -1], temperature, top_k, generator, top_p)
    _mark_first_token(timings, last)
    out = [last]
    pos = S
    for _ in range(max_new_tokens - 1):
        step_logits, cache = decode_fn(params, out[-1][:, None], cache, pos)
        out.append(select_token(step_logits, temperature, top_k, generator, top_p))
        pos += 1
    return torch.cat([tokens.to(torch.int32), torch.stack(out, dim=1)], dim=1)


def compile_ragged_prefill_fn(mesh, cfg, batch_size: int, cache_len: int):
    """Prefill over LEFT- or RIGHT-padded prompts with explicit (B, S)
    positions: pads carry position ``cache_len``, so their KV writes drop,
    and real tokens pack densely at 0..len-1 per row. Returns
    ``fn(params, tokens, positions, cache) -> (logits (B, S, V), cache)``."""

    def prefill(params, tokens, positions, cache):
        assert tokens.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
        zero = torch.zeros(tokens.shape[0], dtype=torch.long, device=tokens.device)
        return tf.forward_with_cache(params, cfg, tokens, cache, zero, positions=positions,
                                     tp=mesh)

    return prefill


def compile_segment_fn(mesh, cfg, batch_size: int, cache_len: int,
                       read_len: Optional[int] = None):
    """Cached segment forward with PER-ROW positions (``pos``: (B,) tensor);
    ``read_len`` builds the tight-read variant, which attends only the first
    ``read_len`` cache slots (the caller guarantees every live row's extent
    fits). Returns ``fn(params, toks, cache, pos) -> (logits, cache)``."""

    def segment(params, toks, cache, pos):
        assert toks.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
        return tf.forward_with_cache(params, cfg, toks, cache, pos, read_len=read_len, tp=mesh)

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
                       tight_read: bool = False, timings: Optional[dict] = None):
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
    _mark_first_token(timings, nxt)
    gen = _segment_decode_tail(segment_fn, params, nxt, cache, prompt_lens,
                               max_new_tokens - 1, temperature, top_k, generator, top_p,
                               active0=int(prompt_lens.max()) if tight_read else None)
    return torch.cat([tokens.to(torch.int32), gen], dim=1)


def chunked_generate(ragged_prefill_fn, segment_fn, params, tokens, cache, cache_len: int,
                     chunk: int, max_new_tokens: int, temperature: float, top_k: int,
                     generator=None, top_p: float = 1.0, attention_mask=None,
                     tight_read: bool = False, timings: Optional[dict] = None):
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
    _mark_first_token(timings, nxt)
    gen = _segment_decode_tail(segment_fn, params, nxt, cache, prompt_lens,
                               max_new_tokens - 1, temperature, top_k, generator, top_p,
                               active0=int(prompt_lens.max()) if tight_read else None)
    return torch.cat([tokens.to(torch.int32), gen], dim=1)


def _clone_cache(cache):
    return {name: ({k: v.clone() for k, v in c.items()} if isinstance(c, dict) else c.clone())
            for name, c in cache.items()}


def compile_pool_tick_fn(mesh, cfg, batch_size: int, cache_len: int, n_tokens: int,
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
                                                      read_len=read_len, tp=mesh)
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
                                              positions=positions, read_len=read_len, tp=mesh)
        col = emit_col.long().view(batch_size, 1, 1).expand(batch_size, 1, logits.shape[-1])
        tok = sample(logits.gather(1, col)[:, 0], rids, gen, base_key)
        last2, done2, _, emitted = accept(tok, last_tok, done, gen, quota, emit_mask)
        packed = torch.stack([tok, emitted, done2], dim=1).to(torch.int32)
        last_tok.copy_(last2)
        done.copy_(done2)
        return packed, cache, last_tok, done

    return run, None, None


def compile_row_update_fn(mesh, cfg, batch_size: int, donate: bool = True):
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


def compile_spec_pool_tick_fn(mesh, cfg, batch_size: int, cache_len: int, gamma: int,
                              temperature: float, top_k: int, top_p: float,
                              eos_token_id: Optional[int] = None,
                              read_len: Optional[int] = None, donate: bool = True,
                              draft_cfg=None, draft_mesh=None):
    """Speculative continuous-batching tick (the reference's signature less
    ``mesh`` and the shardings): every active row proposes ``gamma``
    tokens, ONE target forward over the (gamma+1)-wide window verifies all
    rows at once, and the lossless accept/correct rule (the on-device mirror
    of :func:`_accept_round`) runs on the device. Per-row accepted counts,
    the bonus token and the new positions land in one packed int32 buffer,
    so the host keeps its one fetch a tick and dispatch-ahead composes.

    Draft-model mode (``draft_cfg`` given): a second model, on the same
    mesh (``draft_mesh`` its shard), proposes autoregressively through its
    own pool-geometry KV cache (gamma 1-wide
    steps and one more that caches the last proposal's KV)::

        run(params, draft_params, cache, draft_cache, last_tok, done, pos,
            gen, quota, rids, run_mask, base_key)
          -> (packed, cache, draft_cache, last_tok, done, pos, gen)

    N-gram mode (``draft_cfg=None``): the host proposes ``drafts`` (B,
    gamma) from each request's own context (``inference/ngram.py``), a
    point-mass proposal q = δ(d)::

        run(params, cache, last_tok, done, pos, gen, quota, rids, run_mask,
            drafts, base_key)
          -> (packed, cache, last_tok, done, pos, gen)

    ``pos``/``gen`` are device-THREADED here: a row advances by its own
    accepted count, which the host learns only when it retires the tick.
    ``run_mask`` (1 = the row decodes this tick) parks rows the host cannot
    run without touching their threaded state. Parked and done rows write
    at position ``cache_len``, and window columns at positions >=
    ``cache_len`` drop their writes (the vector-position cache write), so a
    window that overruns the cache is safe; such columns are quota-clipped
    out of acceptance.

    ``packed`` is (B, gamma+4) int32: ``[:, :gamma+1]`` the emitted tokens
    (the accepted prefix, then the bonus/correction), ``[:, gamma+1]``
    n_emitted, ``[:, gamma+2]`` the done flag, ``[:, gamma+3]`` the accepted
    draft count. Greedy emits the target's argmax chain; sampled draws come
    from :func:`spec_request_keys`' lanes. The threaded state and the caches
    are updated in place (``donate=False``: on copies). Returns ``(run_fn,
    None, None)``."""
    assert gamma >= 1, gamma
    B, g1 = batch_size, gamma + 1
    greedy = temperature <= 0.0
    draft_mode = draft_cfg is not None

    def accept_round(vlogits, drafts, qstack, active, pos, gen, quota, last_tok, done, rids,
                     base_key):
        """On-device mirror of :func:`_accept_round` plus the emission and
        state bookkeeping around it. ``qstack`` None: a point-mass
        proposal."""
        dev = drafts.device
        iota_g = torch.arange(gamma, device=dev)
        iota_g1 = torch.arange(g1, device=dev)
        gen, quota = gen.long(), quota.long()
        if greedy:
            tgt = torch.argmax(vlogits, dim=-1)  # (B, g1)
            match = drafts == tgt[:, :gamma]
        else:
            V = vlogits.shape[-1]
            p = _filtered_probs(vlogits.reshape(B * g1, V), temperature, top_k,
                                top_p).reshape(B, g1, V)
            p_at = p[:, :gamma].gather(2, drafts[..., None])[..., 0]
            if qstack is None:
                ratio = p_at  # point-mass proposal: q(d) == 1
            else:
                q_at = qstack.gather(2, drafts[..., None])[..., 0]
                ratio = p_at / torch.clamp(q_at, min=1e-20)
            u = spec_accept_uniforms(base_key, rids.long()[:, None].expand(B, gamma),
                                     gen[:, None] + iota_g[None, :])
            match = u < torch.clamp(ratio, max=1.0)
        # the leading run of accepted drafts: its length is the index of the
        # first rejection (gamma when none), whatever way a backend breaks
        # argmin ties
        n_acc = match.long().cumprod(dim=1).sum(dim=1)

        rem = torch.clamp(quota - gen, min=0)
        n_take = torch.minimum(n_acc, rem)
        if eos_token_id is not None:
            eos_mask = (drafts == eos_token_id) & (iota_g[None] < n_take[:, None])
            first_eos = (~eos_mask).long().cumprod(dim=1).sum(dim=1)  # gamma when none
            took_eos = first_eos < gamma
            n_take = torch.minimum(n_take, first_eos + 1)
        else:
            took_eos = torch.zeros_like(active)
        took_eos = took_eos & active
        n_take = torch.where(active, n_take, 0)

        bonus_ok = active & ~took_eos & (n_take == n_acc) & (gen + n_take < quota)
        if greedy:
            bonus = tgt.gather(1, n_take[:, None])[:, 0]
        else:
            p_b = p.gather(1, n_take[:, None, None].expand(B, 1, V))[:, 0]
            at = torch.clamp(n_take, max=gamma - 1)
            if qstack is None:
                d_b = drafts.gather(1, at[:, None])
                q_b = torch.zeros_like(p_b).scatter_(1, d_b, 1.0)
            else:
                q_b = qstack.gather(1, at[:, None, None].expand(B, 1, V))[:, 0]
            residual = torch.clamp(p_b - q_b, min=0.0)
            dist = torch.where((n_take < gamma)[:, None], residual, p_b)
            tot = dist.sum(dim=1, keepdim=True)
            dist = torch.where(tot > 0, dist / torch.where(tot > 0, tot, 1.0), p_b)
            u = spec_uniforms(base_key, rids, gen + n_take, LANE_BONUS, V)
            bonus = _gumbel_max(torch.where(dist > 0, torch.log(dist), -1e30), u)

        n_emit = n_take + bonus_ok.long()
        pad_drafts = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        tok_out = torch.where(
            iota_g1[None] < n_take[:, None], pad_drafts,
            torch.where((iota_g1[None] == n_take[:, None]) & bonus_ok[:, None],
                        bonus[:, None], 0))
        gen2 = torch.where(active, gen + n_emit, gen)
        done2 = torch.where(active & (took_eos | (gen2 >= quota)), 1, done)
        if eos_token_id is not None:
            done2 = torch.where(active & bonus_ok & (bonus == eos_token_id), 1, done2)
        last2 = torch.where(active & bonus_ok, bonus, last_tok.long())
        # rollback on rejection IS the position rule: the next window starts
        # right after the last verified input column the row consumed, so
        # rejected drafts' KV is overwritten before any query reaches it
        pos2 = torch.where(active, pos.long() + n_take + 1, pos.long())
        packed = torch.cat([tok_out, n_emit[:, None], done2[:, None].long(), n_take[:, None]],
                           dim=1).to(torch.int32)
        return packed, last2, done2, pos2, gen2

    def threaded(state):
        return state if donate else tuple(t.clone() for t in state)

    def verify(params, cache, drafts, qstack, last_tok, done, pos, gen, quota, rids, active,
               base_key):
        wpos = torch.where(active, pos.long(), cache_len)
        seg = torch.cat([last_tok.long()[:, None], drafts], dim=1)
        vlogits, cache = tf.forward_with_cache(params, cfg, seg, cache, wpos, read_len=read_len,
                                               tp=mesh)
        packed, last2, done2, pos2, gen2 = accept_round(
            vlogits, drafts, qstack, active, pos, gen, quota, last_tok, done, rids, base_key)
        for t, new in ((last_tok, last2), (done, done2), (pos, pos2), (gen, gen2)):
            t.copy_(new)
        return packed, cache

    if not draft_mode:
        def run(params, cache, last_tok, done, pos, gen, quota, rids, run_mask, drafts,
                base_key):
            assert last_tok.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
            if not donate:
                cache = _clone_cache(cache)
            last_tok, done, pos, gen = threaded((last_tok, done, pos, gen))
            active = (done == 0) & (run_mask == 1)
            packed, cache = verify(params, cache, drafts.long(), None, last_tok, done, pos,
                                   gen, quota, rids, active, base_key)
            return packed, cache, last_tok, done, pos, gen

        return run, None, None

    def run(params, draft_params, cache, draft_cache, last_tok, done, pos, gen, quota, rids,
            run_mask, base_key):
        assert last_tok.shape[0] == batch_size and tf.cache_alloc_len(cache) == cache_len
        if not donate:
            cache, draft_cache = _clone_cache(cache), _clone_cache(draft_cache)
        last_tok, done, pos, gen = threaded((last_tok, done, pos, gen))
        active = (done == 0) & (run_mask == 1)
        cur, ds, qs = last_tok.long(), [], []
        for i in range(gamma + 1):
            # the last step only caches the final proposal's KV, so that the
            # draft's context is whole when every proposal is accepted
            dlogits, draft_cache = tf.forward_with_cache(
                draft_params, draft_cfg, cur[:, None], draft_cache,
                torch.where(active, pos.long() + i, cache_len), read_len=read_len,
                tp=draft_mesh)
            if i == gamma:
                break
            lg = dlogits[:, 0]
            if greedy:
                cur = torch.argmax(lg, dim=-1)
            else:
                q = _filtered_probs(lg, temperature, top_k, top_p)
                u = spec_uniforms(base_key, rids, gen.long() + i, LANE_DRAFT, q.shape[-1])
                cur = _gumbel_max(torch.where(q > 0, torch.log(q), -1e30), u)
                qs.append(q)
            ds.append(cur)
        drafts = torch.stack(ds, dim=1)
        qstack = None if greedy else torch.stack(qs, dim=1)
        packed, cache = verify(params, cache, drafts, qstack, last_tok, done, pos, gen, quota,
                               rids, active, base_key)
        return packed, cache, draft_cache, last_tok, done, pos, gen

    return run, None, None


def compile_spec_row_update_fn(mesh, cfg, batch_size: int, donate: bool = True):
    """:func:`compile_row_update_fn` for the speculative tick's wider
    device-threaded state: ``pos``/``gen`` ride the tick chain too, so
    admission sets them the same enqueue-only way (``fill_``). Returns
    ``set_row(last_tok, done, pos, gen, slot, tok, flag, p, g) -> (last_tok,
    done, pos, gen)``."""

    def set_row(last_tok, done, pos, gen, slot, tok, flag, p, g):
        assert last_tok.shape[0] == batch_size
        state = (last_tok, done, pos, gen)
        if not donate:
            state = tuple(t.clone() for t in state)
        for t, value in zip(state, (tok, flag, p, g)):
            t[slot].fill_(value)
        return state

    return set_row


def _filtered_probs(logits, temperature: float, top_k: int, top_p: float):
    """Normalized f32 sampling distribution after the same temperature /
    top-k / top-p filtering :func:`select_token` applies: the q/p
    distributions of the speculative acceptance test must be what plain
    sampling would use."""
    return torch.softmax(_filter_logits(logits, temperature, top_k, top_p), dim=-1)


def _sample_rows(probs, host_rng):
    """One categorical draw per row of a (B, V) numpy probability matrix:
    vectorized inverse CDF."""
    u = host_rng.random((probs.shape[0], 1))
    cum = np.cumsum(probs, axis=-1)
    cum /= cum[:, -1:]
    idx = (cum <= u).sum(axis=-1).astype(np.int32)
    return np.minimum(idx, probs.shape[1] - 1)


def _accept_round(drafts, active, lens, max_new_tokens, eos_token_id,
                  tgt=None, pdists=None, qstack=None, host_rng=None):
    """One vectorized speculative accept/correct round in host numpy (the
    reference's, line for line).

    Inputs: drafts (B, gamma); active (B,) rows still generating; lens (B,)
    tokens emitted so far. Greedy passes ``tgt`` (B, gamma+1) argmax tokens;
    sampling passes ``pdists`` (B, gamma+1, V) target distributions,
    ``qstack`` (B, gamma, V) draft distributions and the host rng.

    Returns (n_take, bonus, bonus_ok, took_eos): the accepted drafts to
    append (0 for inactive rows; quota- and EOS-truncated), the
    correction/extra token, whether it is appended, and whether an accepted
    draft was EOS."""
    B, gamma = drafts.shape
    greedy = tgt is not None
    if greedy:
        match = drafts == tgt[:, :gamma]
    else:
        p_at = np.take_along_axis(pdists[:, :gamma], drafts[..., None], axis=2)[..., 0]
        q_at = np.take_along_axis(qstack, drafts[..., None], axis=2)[..., 0]
        u = host_rng.random((B, gamma))
        match = u < np.minimum(1.0, p_at / np.maximum(q_at, 1e-20))
    n_acc = np.where(match.all(axis=1), gamma, (~match).argmax(axis=1)).astype(np.int32)

    rem = np.maximum(max_new_tokens - lens, 0)
    n_take = np.minimum(n_acc, rem)
    if eos_token_id is not None:
        iota = np.arange(gamma, dtype=np.int32)[None]
        eos_mask = (drafts == eos_token_id) & (iota < n_take[:, None])
        took_eos = eos_mask.any(axis=1)
        first_eos = np.where(took_eos, eos_mask.argmax(axis=1), gamma)
        n_take = np.minimum(n_take, first_eos + 1).astype(np.int32)
    else:
        took_eos = np.zeros(B, bool)
    took_eos = took_eos & active
    n_take = np.where(active, n_take, 0).astype(np.int32)

    # the bonus: the target's correction at the rejection point (n_take <
    # gamma) or an extra draw past a fully accepted block, appended only
    # for rows not finished by the quota or an accepted EOS
    bonus_ok = active & ~took_eos & (n_take == n_acc) & (lens + n_take < max_new_tokens)
    if greedy:
        bonus = np.take_along_axis(tgt, n_take[:, None], axis=1)[:, 0].astype(np.int32)
    else:
        p_b = np.take_along_axis(pdists, n_take[:, None, None], axis=1)[:, 0]  # (B, V)
        q_b = np.take_along_axis(
            qstack, np.minimum(n_take, gamma - 1)[:, None, None], axis=1)[:, 0]
        residual = np.maximum(p_b - q_b, 0.0)
        dist = np.where((n_take < gamma)[:, None], residual, p_b)
        tot = dist.sum(axis=1, keepdims=True)
        dist = np.where(tot > 0, dist / np.where(tot > 0, tot, 1.0), p_b)
        bonus = _sample_rows(dist, host_rng)
    return n_take, bonus, bonus_ok, took_eos


def _host_seed(generator: torch.Generator) -> int:
    """The host rng's seed, drawn from the caller's ``torch.Generator`` (the
    reference draws it from its JAX key)."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator, device=generator.device))


def speculative_decode_loop(t_prefill, t_segment, d_prefill, d_decode, params_t, params_d,
                            tokens, cache_t, cache_d, max_new_tokens: int, gamma: int,
                            temperature: float, top_k: int, top_p: float,
                            generator: Optional[torch.Generator] = None,
                            eos_token_id: Optional[int] = None):
    """Draft-model speculative decoding (lossless).

    Each round the draft proposes ``gamma`` tokens autoregressively, the
    target verifies them all in ONE (gamma+1)-wide segment forward, and the
    standard accept/resample rule keeps the output distribution exactly the
    target's (greedy: token for token the plain greedy stream). Rows advance
    by their own accepted counts (per-row positions). As in the reference,
    each draft step's proposal and each round's verdict come to the host,
    where acceptance runs in numpy with an rng seeded from ``generator``.
    ``t_segment``/``d_decode`` take (B,) position vectors. Returns (B, S +
    max_new_tokens) int32 on the tokens' device; rows that stop at EOS are
    EOS-padded."""
    if max_new_tokens <= 0:
        return tokens.to(torch.int32)
    B, S = tokens.shape
    dev = tokens.device
    greedy = temperature <= 0.0
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    host_rng = np.random.default_rng(_host_seed(generator))

    def to_host(t):
        return t.cpu().numpy()

    logits_t, cache_t = t_prefill(params_t, tokens, cache_t)
    _, cache_d = d_prefill(params_d, tokens, cache_d)
    last_logits = logits_t[:, -1]
    if greedy:
        t0 = to_host(torch.argmax(last_logits, dim=-1)).astype(np.int32)
    else:
        t0 = _sample_rows(to_host(_filtered_probs(last_logits, temperature, top_k, top_p)),
                          host_rng)

    # fixed-width output buffer and per-row lengths; rows that finish early
    # are padded with EOS
    pad = eos_token_id if eos_token_id is not None else 0
    out = np.full((B, max_new_tokens), pad, np.int32)
    out[:, 0] = t0
    lens = np.ones((B,), np.int32)
    last = t0.astype(np.int32)
    pos = np.full((B,), S, np.int32)
    done = (lens >= max_new_tokens) | (
        (t0 == eos_token_id) if eos_token_id is not None else np.zeros(B, bool))

    def up(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    while not done.all():
        # gamma proposals; one more step caches d_gamma's KV so the draft's
        # context stays whole when every proposal is accepted
        drafts = np.zeros((B, gamma), np.int32)
        qdists = []
        cur = last
        for i in range(gamma + 1):
            logits_d, cache_d = d_decode(params_d, up(cur[:, None]), cache_d, up(pos + i))
            if i == gamma:
                break
            if greedy:
                d = to_host(torch.argmax(logits_d[:, 0], dim=-1)).astype(np.int32)
            else:
                q = to_host(_filtered_probs(logits_d[:, 0], temperature, top_k, top_p))
                qdists.append(q)
                d = _sample_rows(q, host_rng)
            drafts[:, i] = d
            cur = d.astype(np.int32)

        # verify every proposal in one target forward
        seg = np.concatenate([last[:, None], drafts], axis=1)  # (B, gamma+1)
        logits_v, cache_t = t_segment(params_t, up(seg), cache_t, up(pos))
        tgt = pdists = qstack = None
        if greedy:
            tgt = to_host(torch.argmax(logits_v, dim=-1)).astype(np.int32)
        else:
            V = logits_v.shape[-1]
            pdists = to_host(_filtered_probs(logits_v.reshape(B * (gamma + 1), V),
                                             temperature, top_k, top_p)).reshape(B, gamma + 1, V)
            qstack = np.stack(qdists, axis=1)  # (B, gamma, V)

        # whole-batch accept / correct
        active = ~done
        n_take, bonus, bonus_ok, took_eos = _accept_round(
            drafts, active, lens, max_new_tokens, eos_token_id,
            tgt=tgt, pdists=pdists, qstack=qstack, host_rng=host_rng)
        cols = lens[:, None] + np.arange(gamma, dtype=np.int32)[None]
        valid = (np.arange(gamma)[None] < n_take[:, None]) & (cols < max_new_tokens)
        br, bi = np.nonzero(valid)
        out[br, cols[br, bi]] = drafts[br, bi]
        lens = lens + n_take
        bb = np.nonzero(bonus_ok)[0]
        out[bb, lens[bb]] = bonus[bb]
        lens = lens + bonus_ok.astype(np.int32)
        last = np.where(bonus_ok, bonus, last).astype(np.int32)
        pos = pos + np.where(active, n_take + 1, 0).astype(np.int32)
        done = done | took_eos | (lens >= max_new_tokens)
        if eos_token_id is not None:
            done = done | (bonus_ok & (bonus == eos_token_id))

    return torch.cat([tokens.to(torch.int32), torch.from_numpy(out).to(dev)], dim=1)


def speculative_generate(cfg, params, draft, tokens, max_new_tokens: int, temperature: float,
                         top_k: int, top_p: float, generator, gamma: int,
                         max_out_tokens: Optional[int], get_fns,
                         eos_token_id: Optional[int] = None, tp=None):
    """Speculative-decoding orchestration (the verify round's cache slack,
    function lookup, cache init, loop). ``get_fns(B, cache_len) ->
    (t_prefill, t_segment)`` supplies the target's functions; ``draft`` is
    an ``InferenceEngine`` that provides its own through ``_spec_fns``.
    ``tp`` is the target's shard of a serving mesh (the draft's is its
    engine's ``shard``)."""
    if draft.cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft must share the vocabulary: draft vocab {draft.cfg.vocab_size} != "
            f"target vocab {cfg.vocab_size}")
    if gamma < 1:
        raise ValueError(f"speculative.num_draft_tokens must be >= 1, got {gamma}")
    B, S = tokens.shape
    total = S + max_new_tokens + gamma + 1  # the verify round's overrun slack
    cache_len = bounded_cache_len(total, max(cfg.max_seq_len, total), max_out_tokens)
    t_prefill, t_segment = get_fns(B, cache_len)
    d_prefill, d_decode = draft._spec_fns(B, cache_len)
    cache_t = tf.init_cache(cfg, B, cache_len, device=tokens.device, tp=tp)
    cache_d = tf.init_cache(draft.cfg, B, cache_len, device=tokens.device, tp=draft.shard)
    return speculative_decode_loop(
        t_prefill, t_segment, d_prefill, d_decode, params, draft.params, tokens, cache_t,
        cache_d, max_new_tokens, gamma, temperature, top_k, top_p, generator,
        eos_token_id=eos_token_id)
