"""Continuous (in-flight) batching for the inference engine (counterpart of
``deepspeed_tpu/inference/continuous.py``), on one device.

A fixed pool of sequence slots shares a KV cache; new requests are admitted
into free slots while other slots keep decoding, and a finished sequence
frees its slot at once. Decode is host bound, so the scheduler tick is built
so that device work and host scheduling overlap:

- **On-device acceptance** (``decoding.compile_pool_tick_fn``): sampling,
  EOS/quota done detection, position advance and emission masking run on
  the device. Each tick leaves one small packed ``(tokens, n_emitted,
  done)`` int32 buffer, copied into pinned host memory without waiting,
  with a CUDA event recorded behind it.
- **Dispatch-ahead pipelining** (``pipeline_depth``, default 1): the tick
  threads its decode state (``last_tok``/``done`` and the KV cache) through
  tensors updated in place on the stream, so tick N+1 is queued before the
  host waits on tick N's event. NOTHING in a dispatch waits on the device:
  the per-tick host vectors go up through pinned staging buffers, and the
  cache write at vector positions needs no host sync
  (``ops/transformer/inference_ops._scatter_index``). ``pipeline_depth=0``
  is the synchronous scheduler; token streams are bitwise identical in both
  modes (per-request keys, ``decoding.request_keys``). ``step()`` reports
  the tokens of the tick(s) it retired, which lag dispatch by up to
  ``pipeline_depth`` ticks.
- **Prefill/decode fusion** (``fused_prefill``, default on for single-token
  ticks): one admitting row's next prompt chunk (power-of-2 widths up to
  ``prefill_chunk``) rides inside the tick that decodes the active rows.
  With fusion off (or burst ticks), admission prefills ``prompt[:-1]``
  through the B=1 bucket prefill and splices it into the pool row; the last
  prompt token is re-fed by the first decode tick, whose logits give the
  first generated token.
- **In place**: the counterpart of the reference's donation: the pool's
  cache and threaded state are updated in place (``donate_cache=False``
  makes every tick work on copies).

Bucketed KV: ``cache_buckets=[(slots, len), ...]`` partitions the slots
into pools of different cache lengths; admission places each request in the
smallest pool it fits. ``kv_cache_bytes()`` reports the footprint.

    eng = ContinuousBatchingEngine(model, config={"dtype": "bfloat16"},
                                   cache_buckets=[(6, 256), (2, 1024)])
    rid = eng.submit([12, 7, 99], max_new_tokens=32)
    while eng.has_work():
        eng.step()            # dispatch tick N+1, retire tick N
    out = eng.result(rid)     # prompt + generated tokens (np.int32)

``tokens_per_tick=k`` runs k decode steps a tick (k× fewer host round
trips a token); admission then happens between bursts. Tokens a burst
computes past a row's done flag are counted as ``wasted_tokens``.

Tight-read ticks (engine config ``kv_tight_read``, default on): every tick
attends a bucketed ACTIVE length. ``tick_stats()`` reports dispatch and
blocked milliseconds, emitted and wasted tokens and the depth reached.

Speculative ticks (config ``speculative: {"enabled": true, "pool": true}``,
single-token ticks): every tick proposes ``num_draft_tokens`` tokens a live
row, by n-gram matching on the request's own history (``mode="ngram"``, host
numpy, ``inference/ngram.py``) or through a draft model with its own pool
cache (``mode="draft"``, ``draft_model=``), and ONE target forward over the
(gamma+1)-wide window verifies them, with acceptance on the device
(``decoding.compile_spec_pool_tick_fn``). A row's position and token count
then ride the device with its other tick state; fused admission prefills
its prompt chunks through a separate segment dispatch on the same step.
``tick_stats()`` adds the drafted and accepted counts and their ratio.

Telemetry (engine config ``telemetry``; the inner engine's hub, which the
serving layer shares and re-injects into rebuilt engines): each tick then
drives the ``torch.profiler`` window, sets the ``cache_utilization`` and
``tick_inflight_depth`` gauges, observes ``tick_dispatch_ms`` and
``tick_block_ms``, counts ``burst_wasted_tokens`` and emits a
``serving_tick`` event; each finished request emits ``inference_request``
(``path: "continuous"``). Every value is host-side already: telemetry adds
no wait on the device to a tick.

Serving mesh (``mesh=`` or the engine config's ``mesh``): the pools' KV
caches split on heads over the mesh's ``tensor`` ranks, while the row state
and the packed fetch stay whole on every rank (the reference's
``_tick_shardings``); a draft model lives on the same mesh. The world's
rank 0 runs the scheduler; each device operation (a tick, a row update, a
prefill and its splice, a prefix) is a ``inference.mesh.mirrored`` method
that the other ranks, inside ``serve_worker()``, run on their shards.

Not ported (``NotImplementedError``, ROADMAP.md Queue 1): the memory
attribution (``memory_snapshot``, ``hbm_components``; item 11 (b)),
``analyze_program_memory`` (item 12), and a mesh's ``data`` axis (item 8
(c)).
"""

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference import mesh as mesh_mod
from deepspeed_tpu_torch.inference import ngram
from deepspeed_tpu_torch.inference.decoding import (
    compile_pool_tick_fn,
    compile_ragged_prefill_fn,
    compile_row_update_fn,
    compile_segment_fn,
    compile_spec_pool_tick_fn,
    compile_spec_row_update_fn,
    read_bucket,
)
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.utils import not_ported

# smallest fused-prefill chunk width (power-of-2 buckets up to the pool's
# chunk cap bound the tick variants)
_CHUNK_FLOOR = 16


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # (len,) int32, full prompt incl. any shared prefix
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    pool: Optional[int] = None
    done: bool = False
    # snapshot of the registered prefix entry, taken at submit time so that
    # unregister_prefix cannot strand a queued request
    prefix: Optional[dict] = None
    # device-side emission quota (gen_base + max_new_tokens)
    quota: int = 0
    # recovery resume: the device ``gen`` counter starts here, so the
    # per-token keys (seed, rid, gen) continue the original stream
    gen_base: int = 0
    # fused prefill: remaining (tokens, pos0, n_real, emits) prompt chunks
    chunks: Optional[List[tuple]] = None
    # KV-cache bytes this request's row streamed across its decode ticks
    kv_bytes_read: int = 0
    # speculative ticks: drafts proposed for this request and drafts its
    # verify rounds accepted
    spec_drafted: int = 0
    spec_accepted: int = 0
    # tick-window span accumulation (span_hook)
    win_kind: Optional[str] = None
    win_t0: float = 0.0
    win_t1: float = 0.0
    win_ticks: int = 0
    win_tokens: int = 0
    win_drafted: int = 0
    win_accepted: int = 0


class _TickRecord:
    """Host bookkeeping for one DISPATCHED (possibly in-flight) pool tick:
    the packed result's host buffer and the event behind its copy, plus
    what is needed to attribute it when the tick is retired."""

    __slots__ = ("packed", "event", "live", "k", "row_bytes", "fused", "spec", "t0")

    def __init__(self, packed, event, live, k, row_bytes, fused, spec=0):
        self.packed = packed          # host (B, k+2) int32, valid once event is done
        self.event = event            # CUDA event after the copy (None on the CPU)
        self.live = live              # slot -> _Request live at dispatch
        self.k = k                    # burst length (1 for plain/fused)
        self.row_bytes = row_bytes    # KV bytes one row streams per step
        self.fused = fused            # carried a prefill chunk
        self.spec = spec              # a speculative round's gamma (0 = plain);
        # its packed row is (tokens[gamma+1], n_emitted, done, n_accepted)
        self.t0 = 0.0                 # dispatch time for window spans


class _Pool:
    """One fixed-shape slot pool: ``n_slots`` rows of ``length`` KV."""

    def __init__(self, engine, index: int, n_slots: int, length: int):
        self.index = index
        self.n_slots = n_slots
        self.length = length
        dev = engine.device
        shard = engine.shard
        self.segment_fn = compile_segment_fn(shard, engine.cfg, n_slots, length)
        self.cache = tf.init_cache(engine.cfg, n_slots, length, device=dev, tp=shard)
        self.active: Dict[int, _Request] = {}       # slot -> request
        # device-THREADED tick state: free slots start done=1 (never emit);
        # admission flips a row live
        self.last_tok_dev = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self.done_dev = torch.ones(n_slots, dtype=torch.int32, device=dev)
        self.set_row_fn = compile_row_update_fn(shard, engine.cfg, n_slots,
                                                donate=engine.donate_cache)
        # speculative tick state: pos/gen join the device-threaded tensors (a
        # spec row advances by its own accepted count, which only the device
        # knows at dispatch), and draft mode keeps a second KV cache of the
        # same geometry with its own segment function for the draft prefill
        self.draft_cache = None
        if engine.spec_gamma:
            self.pos_dev = torch.full((n_slots,), length, dtype=torch.int32, device=dev)
            self.gen_dev = torch.zeros(n_slots, dtype=torch.int32, device=dev)
            self.spec_set_row_fn = compile_spec_row_update_fn(shard, engine.cfg, n_slots,
                                                              donate=engine.donate_cache)
            if engine.spec_mode == "draft":
                dshard = engine._draft_eng.shard
                self.draft_segment_fn = compile_segment_fn(dshard, engine.draft_cfg, n_slots,
                                                           length)
                self.draft_cache = tf.init_cache(engine.draft_cfg, n_slots, length, device=dev,
                                                 tp=dshard)
        # host DISPATCH mirrors: the position/emission count each row will
        # have reached once every dispatched tick retires (speculative rows:
        # pos an upper bound, gen a lower one, reconciled at retire)
        self.disp_pos = np.zeros(n_slots, np.int32)
        self.disp_gen = np.zeros(n_slots, np.int32)
        # fused prefill: admitted requests whose prompt chunks still need
        # ticks, FIFO; one admitting row rides each tick
        self.prefill_q: "deque[_Request]" = deque()
        self.chunk_cap = min(engine.prefill_chunk, length)
        # tick functions keyed (chunk_width, read_len), never evicted
        self.tick_fns: Dict[tuple, object] = {}

    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.active]

    def kv_bytes(self) -> int:
        return sum(_leaf_bytes(c) for c in self.cache.values())


def _leaf_bytes(component) -> int:
    if isinstance(component, dict):
        return sum(t.numel() * t.element_size() for t in component.values())
    return component.numel() * component.element_size()


class ContinuousBatchingEngine:
    """Slot-pool serving loop over the pool-tick programs."""

    def __init__(self, model, config=None, params=None, mesh=None,
                 max_slots: Optional[int] = None, cache_len: Optional[int] = None,
                 cache_buckets: Optional[List] = None,
                 eos_token_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 tokens_per_tick: int = 1, pipeline_depth: int = 1,
                 fused_prefill: bool = True,
                 prefill_chunk: Optional[int] = None,
                 donate_cache: bool = True,
                 fetch_timeout_s: Optional[float] = None,
                 draft_model=None, draft_params=None, device=None):
        from deepspeed_tpu_torch.inference.engine import InferenceEngine, draft_config

        ctor = dict(max_slots=max_slots, cache_len=cache_len, cache_buckets=cache_buckets,
                    eos_token_id=eos_token_id, temperature=temperature, top_k=top_k,
                    top_p=top_p, seed=seed, tokens_per_tick=tokens_per_tick,
                    pipeline_depth=pipeline_depth, fused_prefill=fused_prefill,
                    prefill_chunk=prefill_chunk, donate_cache=donate_cache,
                    draft_model=draft_model, draft_params=draft_params)
        self._eng = InferenceEngine(model, config=config, params=params, device=device,
                                    seed=seed, mesh=mesh, _announce=False)
        if self._eng.cfg.moe_num_experts > 0:
            raise not_ported("MoE layers in the ContinuousBatchingEngine and the serving layer "
                             "(Queue 1 item 10)")
        self.mesh = self._eng.mesh
        self.shard = self._eng.shard
        # slot caches are written at per-row depths (ragged admission): the
        # pools run plain full/bucket-length caches
        self.cfg = self._eng._ring_off_cfg
        self.device = self._eng.device
        self.eos_token_id = eos_token_id
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        assert tokens_per_tick >= 1, tokens_per_tick
        assert pipeline_depth >= 0, pipeline_depth
        self.tokens_per_tick = tokens_per_tick
        # how many ticks may be in flight before the host waits on the
        # oldest packed result; 0 = retire every tick inside its step()
        self.pipeline_depth = pipeline_depth
        # fused prefill requires single-token ticks (a burst has no chunk row)
        self.fused_prefill = fused_prefill and tokens_per_tick == 1
        self.prefill_chunk = prefill_chunk or self._eng.config.prefill_chunk_size or 128
        self.donate_cache = donate_cache
        # ONE base key: every sampled token is keyed (seed, rid, token index)
        self._base_key = int(seed)

        # speculative pooled ticks (speculative.enabled and .pool): every tick
        # proposes spec_gamma tokens a live row and ONE target forward
        # verifies them (decoding.compile_spec_pool_tick_fn)
        spec = self._eng.config.speculative
        self.spec_gamma = 0
        self.spec_mode = None
        self._draft_eng = None
        self.draft_cfg = None
        if spec.enabled and spec.pool:
            if spec.mode not in ("draft", "ngram"):
                raise ValueError(f"speculative.mode must be 'draft' or 'ngram', got {spec.mode!r}")
            if tokens_per_tick != 1:
                raise ValueError("speculative pool ticks require tokens_per_tick=1 "
                                 "(the gamma-wide verify round IS the burst)")
            if spec.num_draft_tokens < 1:
                raise ValueError(
                    f"speculative.num_draft_tokens must be >= 1, got {spec.num_draft_tokens}")
            if spec.mode == "draft":
                if draft_model is None:
                    raise ValueError(
                        "speculative.mode='draft' needs draft_model= (a smaller "
                        "same-vocabulary model), or set speculative.mode='ngram' for "
                        "draft-free self-drafting")
                # the draft shares the cache format: int8 KV covers both trees
                self._draft_eng = InferenceEngine(
                    draft_model, config=draft_config(self._eng.config), params=draft_params,
                    device=self.device, seed=seed, mesh=self.mesh, _announce=False)
                self.draft_cfg = self._draft_eng._ring_off_cfg
                if self.draft_cfg.vocab_size != self.cfg.vocab_size:
                    raise ValueError(
                        f"draft must share the vocabulary: draft vocab "
                        f"{self.draft_cfg.vocab_size} != target vocab {self.cfg.vocab_size}")
            self.spec_gamma = spec.num_draft_tokens
            self.spec_mode = spec.mode
        elif draft_model is not None:
            raise ValueError("draft_model= given but speculative pool ticks are off: set "
                             "speculative={'enabled': True, 'pool': True} (mode='draft')")

        if cache_buckets is None:
            cache_len = min(cache_len or self.cfg.max_seq_len, self.cfg.max_seq_len)
            cache_buckets = [(max_slots if max_slots is not None else 4, cache_len)]
        else:
            assert cache_len is None, "pass cache_buckets OR cache_len, not both"
            assert max_slots is None, (
                "pass cache_buckets OR max_slots, not both (slot counts come from the buckets)")
            cache_buckets = sorted(((int(s), int(l)) for s, l in cache_buckets),
                                   key=lambda sl: sl[1])
            for s, l in cache_buckets:
                assert s >= 1 and 1 <= l <= self.cfg.max_seq_len, (s, l)
        # pools sorted by length: admission scans for the smallest fit
        self._pools = [_Pool(self, i, s, l) for i, (s, l) in enumerate(cache_buckets)]
        self.max_slots = sum(p.n_slots for p in self._pools)
        self.cache_len = max(p.length for p in self._pools)

        self._next_rid = 0
        self._next_pid = 0
        self._prefixes: Dict[int, dict] = {}  # prefix caching (register_prefix)
        self._prefix_caches: Dict[int, dict] = {}  # their KV, by prefix id
        self._pending: List[_Request] = []
        self._results: Dict[int, np.ndarray] = {}
        # dispatched-but-not-retired ticks, oldest first; each entry maps
        # pool index -> _TickRecord for one scheduler tick
        self._inflight: "deque[Dict[int, _TickRecord]]" = deque()
        self._tick_stats = {"ticks": 0, "steps": 0, "dispatch_ms": 0.0,
                            "block_ms": 0.0, "tokens": 0, "wasted_tokens": 0,
                            "capacity_tokens": 0, "fused_prefill_ticks": 0,
                            "max_inflight": 0, "spec_drafted": 0,
                            "spec_accepted": 0}
        # cancelled rids, BOUNDED (oldest evicted past the cap, back to
        # "unknown")
        self._cancelled: "OrderedDict[int, None]" = OrderedDict()
        self._cancelled_cap = 4096
        # serving-layer hooks, as the reference's: request_event_hook gets
        # (rid, event) in _finish and may enrich or replace the
        # inference_request event before it is emitted; span_hook gets
        # (rid, span_kind, t0, t1, attrs) per coalesced tick window;
        # fault_hook (point, info) at "dispatch", "retire" and "set_row"
        # and may raise
        self.request_event_hook: Optional[Callable[[int, dict], Optional[dict]]] = None
        self.span_hook: Optional[Callable[[int, str, float, float, dict], None]] = None
        self.span_window_ticks = 16
        self.fault_hook: Optional[Callable[[str, dict], None]] = None
        # a packed-result wait in _retire longer than this raises TimeoutError
        self.fetch_timeout_s = fetch_timeout_s
        # True once an exception escaped mid-tick: the serving layer must
        # rebuild rather than retry step()
        self.poisoned = False
        self._tick_index = 0
        # B=1 bucket prefills and their splices, keyed by bucket (and pool)
        self._fns: Dict[tuple, Callable] = {}
        # rank 0 of a mesh wider than one rank announces the engine: the
        # workers build theirs from the same arguments and run each of its
        # device operations
        if self._draft_eng is not None and self._draft_eng._ctor_args:
            draft_args = self._draft_eng._ctor_args
            ctor.update(draft_model=draft_args["model"], draft_params=draft_args["params"])
            self._draft_eng._ctor_args = {}
        self._mirror = mesh_mod.controller(
            self, "ContinuousBatchingEngine", self.mesh,
            dict(ctor, config=self._eng._worker_config(), **self._eng._ctor_args))
        self._eng._ctor_args = {}

    @property
    def telemetry(self):
        """The engine stack's ONE telemetry hub, owned by the inner
        InferenceEngine (serving recovery re-injects it into replacement
        engines, so counters and the trace span engine generations)."""
        return self._eng.telemetry

    # -- single-pool compatibility surface (tests, introspection) --------
    @property
    def cache(self):
        assert len(self._pools) == 1, "cache is per-pool; use _pools[i].cache"
        return self._pools[0].cache

    @cache.setter
    def cache(self, value):
        assert len(self._pools) == 1
        self._pools[0].cache = value

    @property
    def _active(self) -> Dict[int, _Request]:
        """All active requests keyed by (pool-flattened) slot index."""
        out = {}
        base = 0
        for p in self._pools:
            for s, r in p.active.items():
                out[base + s] = r
            base += p.n_slots
        return out

    def kv_cache_bytes(self) -> int:
        """Total device bytes held by the slot-pool KV caches."""
        return sum(p.kv_bytes() for p in self._pools)

    def hbm_components(self):
        raise not_ported("hbm_components (device-memory attribution; ROADMAP Queue 1 item 11 (b))")

    def memory_snapshot(self, reason: str):
        raise not_ported("memory_snapshot (device-memory attribution; ROADMAP Queue 1 item 11 (b))")

    def analyze_program_memory(self):
        raise not_ported("analyze_program_memory (program analysis; ROADMAP Queue 1 item 12)")

    # -- host -> device --------------------------------------------------
    def _upload(self, *arrays) -> List[torch.Tensor]:
        """Host integer vectors -> int64 device tensors, in ONE copy from a
        pinned staging buffer that never waits: torch's pinned-memory cache
        keeps a buffer until its copy is done, and the copy is queued on
        the stream behind the work already there."""
        flat = np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in arrays])
        if self.device.type == "cuda":
            staging = torch.empty(flat.size, dtype=torch.int64, pin_memory=True)
            staging.numpy()[:] = flat
            dev = staging.to(self.device, non_blocking=True)
        else:
            dev = torch.from_numpy(flat)
        out, off = [], 0
        for a in arrays:
            n = int(np.asarray(a).size)
            out.append(dev[off:off + n].view(np.asarray(a).shape))
            off += n
        return out

    def _fetch_async(self, packed):
        """Queue the packed result's copy to pinned host memory; returns
        (host tensor, event), the event None on the CPU."""
        if self.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # -- public API -----------------------------------------------------
    def validate_request(self, prompt_ids, max_new_tokens: int) -> np.ndarray:
        """Argument checks shared by ``submit`` and a serving layer's
        admission control. Raises ValueError and returns the canonical
        prompt array."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (every request emits a token)")
        if prompt.size + max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"exceeds the largest pool cache_len {self.cache_len}")
        return prompt

    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               rid: Optional[int] = None, gen_base: int = 0) -> int:
        """Queue a request. ``rid``/``gen_base`` are the RESUME surface: an
        explicit ``rid`` keeps a lost request's key identity on a rebuilt
        engine, and ``gen_base`` offsets the generation counter, so that
        ``prompt + emitted`` with ``gen_base=len(emitted)`` continues the
        original stream bit for bit."""
        prompt = self.validate_request(prompt_ids, max_new_tokens)
        if gen_base < 0:
            raise ValueError("gen_base must be >= 0")
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            if (any(r.rid == rid for r in self._pending) or rid in self._results
                    or any(r.rid == rid for p in self._pools for r in p.active.values())):
                raise ValueError(f"explicit rid {rid} is already in use")
            self._next_rid = max(self._next_rid, rid + 1)
        self._pending.append(_Request(rid, prompt, max_new_tokens, gen_base=gen_base))
        return rid

    def register_prefix(self, prefix_ids) -> int:
        """Prefix caching: prefill a shared prefix ONCE and reuse its KV for
        every request submitted with its id. Returns that id."""
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        if prefix.size == 0:
            raise ValueError("empty prefix")
        if prefix.size >= self.cache_len:
            raise ValueError("prefix does not fit the cache")
        n = prefix.size
        bucket = read_bucket(n, self.cache_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prefix
        positions = np.full((1, bucket), bucket, np.int32)
        positions[0, :n] = np.arange(n, dtype=np.int32)
        pid = self._next_pid  # a counter: an id is never recycled
        self._next_pid += 1
        self._run_register_prefix(pid, bucket, toks, positions)
        self._prefixes[pid] = {"tokens": prefix, "cache": self._prefix_caches[pid],
                               "bucket": bucket, "pid": pid}
        return pid

    @mesh_mod.mirrored
    def _run_register_prefix(self, pid: int, bucket: int, toks, positions):
        """Device half of :meth:`register_prefix`: the B=1 bucket prefill
        into the prefix's own cache."""
        prefill_fn = self._prefill_for_bucket(bucket)
        small = tf.init_cache(self.cfg, 1, bucket, device=self.device, tp=self.shard)
        dtoks, dpos = self._upload(toks, positions)
        with torch.inference_mode():
            _, small = prefill_fn(self._eng.params, dtoks, dpos, small)
        self._prefix_caches[pid] = small

    @mesh_mod.mirrored
    def _run_drop_prefix(self, pid: int):
        self._prefix_caches.pop(pid, None)

    def _release_prefix(self, pid: int):
        """Free an unregistered prefix's KV once no queued request holds
        it (a queued request splices it at admission)."""
        if pid in self._prefixes or pid not in self._prefix_caches:
            return
        if not any(r.prefix is not None and r.prefix["pid"] == pid for r in self._pending):
            self._run_drop_prefix(pid)

    def _require_prefix(self, prefix_id: int) -> dict:
        try:
            return self._prefixes[prefix_id]
        except KeyError:
            raise KeyError(
                f"unknown prefix id {prefix_id}: never registered or already "
                f"unregistered (live ids: {sorted(self._prefixes)})") from None

    def unregister_prefix(self, prefix_id: int):
        """Release a registered prefix's KV (requests that already spliced it
        are unaffected)."""
        self._require_prefix(prefix_id)
        self._prefixes.pop(prefix_id)
        self._release_prefix(prefix_id)

    def submit_with_prefix(self, prefix_id: int, suffix_ids, max_new_tokens: int = 32) -> int:
        """Queue a request whose prompt is (registered prefix + suffix); the
        prefix KV is reused, only the suffix is prefilled."""
        suffix = np.asarray(suffix_ids, np.int32).reshape(-1)
        if suffix.size == 0:
            raise ValueError("empty suffix (use submit for prefix-only prompts)")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (every request emits a token)")
        pre = self._require_prefix(prefix_id)
        total = pre["tokens"].size + suffix.size
        if total + max_new_tokens > self.cache_len:
            raise ValueError(
                f"prefix {pre['tokens'].size} + suffix {suffix.size} + "
                f"max_new_tokens {max_new_tokens} exceeds cache_len {self.cache_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, np.concatenate([pre["tokens"], suffix]), max_new_tokens)
        req.prefix = pre  # snapshot: queued requests survive unregister_prefix
        self._pending.append(req)
        return rid

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._inflight)
                or any(p.active for p in self._pools))

    def status(self, rid: int) -> str:
        """``"pending"``, ``"active"``, ``"finished"`` (result not yet
        collected), ``"cancelled"`` or ``"unknown"``."""
        if any(r.rid == rid for r in self._pending):
            return "pending"
        if any(r.rid == rid for p in self._pools for r in p.active.values()):
            return "active"
        if rid in self._results:
            return "finished"
        if rid in self._cancelled:
            return "cancelled"
        return "unknown"

    def peek(self, rid: int) -> Optional[np.ndarray]:
        """The finished result for ``rid`` WITHOUT consuming it."""
        return self._results.get(rid)

    def result(self, rid: int) -> np.ndarray:
        try:
            return self._results.pop(rid)
        except KeyError:
            state = self.status(rid)
            detail = {
                "pending": "still queued for a slot (step() until finished)",
                "active": "still decoding (step() until finished)",
                "cancelled": "cancelled before it finished",
                "unknown": "never submitted or its result was already collected",
            }[state]
            raise KeyError(f"no result for request {rid}: {state} — {detail}") from None

    def cancel(self, rid: int) -> bool:
        """Cancel a request: a pending one leaves the queue, an active one
        frees its slot at once, even while a tick carrying it is in flight
        (the retired tick's row is then not attributed). False when the rid
        is already finished, collected or unknown."""
        for i, req in enumerate(self._pending):
            if req.rid == rid:
                self._pending.pop(i)
                self._mark_cancelled(rid)
                return True
        for pool in self._pools:
            for slot, req in pool.active.items():
                if req.rid == rid:
                    pool.active.pop(slot)
                    if req.chunks:
                        try:
                            pool.prefill_q.remove(req)
                        except ValueError:
                            pass
                    self._mark_cancelled(rid)
                    return True
        return False

    def _mark_cancelled(self, rid: int):
        self._cancelled[rid] = None
        while len(self._cancelled) > self._cancelled_cap:
            self._cancelled.popitem(last=False)

    def pool_state(self) -> List[dict]:
        """Per-pool occupancy, ordered by pool length: ``{"length",
        "slots", "free"}``."""
        return [{"length": p.length, "slots": p.n_slots,
                 "free": p.n_slots - len(p.active)} for p in self._pools]

    def finished(self) -> Dict[int, np.ndarray]:
        out, self._results = self._results, {}
        return out

    def abort_inflight(self) -> int:
        """Drop every dispatched-but-unretired tick without reading it (the
        engine-loss path); returns the number dropped."""
        lost = len(self._inflight)
        self._inflight.clear()
        return lost

    def tick_stats(self) -> dict:
        """Host-overhead accounting of the tick loop: dispatch vs blocked
        ms, tokens emitted and wasted past done flags, depth reached.
        ``overlap_frac`` is the share of the loop's host time NOT spent
        waiting on the device; ``block_ms_per_token`` the host-blocked ms a
        decoded token."""
        s = dict(self._tick_stats)
        s["pipeline_depth"] = self.pipeline_depth
        s["mean_emitted_per_tick"] = (round(s["tokens"] / s["ticks"], 3)
                                      if s["ticks"] else 0.0)
        s["block_ms_per_token"] = (round(s["block_ms"] / s["tokens"], 4)
                                   if s["tokens"] else None)
        host = s["dispatch_ms"] + s["block_ms"]
        s["overlap_frac"] = round(1.0 - s["block_ms"] / host, 4) if host > 0 else None
        s["spec_gamma"] = self.spec_gamma
        s["spec_mode"] = self.spec_mode
        s["spec_acceptance"] = (round(s["spec_accepted"] / s["spec_drafted"], 4)
                                if s["spec_drafted"] else None)
        return s

    def _place(self, req: _Request) -> Optional[tuple]:
        """(pool_index, slot) in the smallest pool that fits the request's
        full extent and has a free slot; None if all are full."""
        need = req.prompt.size + req.max_new_tokens
        if req.prefix is not None:
            # the prefix splice writes a full bucket-length slice
            need = max(need, req.prefix["bucket"])
        for i, pool in enumerate(self._pools):
            if pool.length < need:
                continue
            free = pool.free_slots()
            if free:
                return i, free[0]
        return None

    def step(self) -> Dict[int, List[int]]:
        """One scheduler tick: admit pending requests into free slots
        (dispatching their prefill), dispatch one tick per pool with
        dispatchable rows, then retire in-flight ticks down to
        ``pipeline_depth``. Returns {rid: [tokens]} emitted by the RETIRED
        tick(s); concatenated across steps they are the generated stream.

        Fault surface: the ``dispatch`` fault hook fires first, before any
        state changes; any exception past that point sets ``poisoned``."""
        if self.fault_hook is not None:
            self.fault_hook("dispatch", {"tick": self._tick_index})
        self._tick_index += 1
        try:
            with torch.inference_mode():
                return self._step_body()
        except BaseException:
            self.poisoned = True
            raise

    def _step_body(self) -> Dict[int, List[int]]:
        emitted: Dict[int, List[int]] = {}
        t0 = time.perf_counter()
        # FIFO with skip: a request that only fits a full long pool must not
        # block shorter requests behind it
        still_pending = []
        for req in self._pending:
            placed = self._place(req)
            if placed is None:
                still_pending.append(req)
                continue
            self._admit(req, *placed)
        self._pending = still_pending

        recs: Dict[int, _TickRecord] = {}
        for pi, pool in enumerate(self._pools):
            rec = self._dispatch_spec_tick(pool) if self.spec_gamma else self._dispatch_tick(pool)
            if rec is not None:
                recs[pi] = rec
        # host enqueue time only: the device runs on behind it; the block
        # time in _retire ends at a real wait on the device
        dispatch_ms = (time.perf_counter() - t0) * 1000.0
        if recs:
            if self.span_hook is not None:
                t_disp = time.monotonic()
                for r in recs.values():
                    r.t0 = t_disp
            self._inflight.append(recs)
        stats = self._tick_stats
        stats["steps"] += 1
        stats["ticks"] += len(recs)
        stats["capacity_tokens"] += sum(self._pools[pi].n_slots * r.k for pi, r in recs.items())
        stats["fused_prefill_ticks"] += sum(1 for r in recs.values() if r.fused)
        stats["dispatch_ms"] += dispatch_ms
        stats["max_inflight"] = max(stats["max_inflight"], len(self._inflight))

        # retire down to the pipeline depth; with nothing new dispatched the
        # remaining in-flight ticks are the drain tail
        block_ms = 0.0
        tokens0, wasted0 = stats["tokens"], stats["wasted_tokens"]
        drafted0, accepted0 = stats["spec_drafted"], stats["spec_accepted"]
        while self._inflight and (len(self._inflight) > self.pipeline_depth or not recs):
            block_ms += self._retire(self._inflight.popleft(), emitted)
        stats["block_ms"] += block_ms

        tele = self._eng.telemetry
        if tele.enabled:
            # tick-indexed profiler window: profile_start_step counts
            # scheduler ticks here
            tele.maybe_capture(self._tick_index)
            reg = tele.registry
            reg.gauge("cache_utilization").set(self.cache_utilization())
            reg.gauge("tick_inflight_depth").set(len(self._inflight))
            n_tokens = stats["tokens"] - tokens0
            n_wasted = stats["wasted_tokens"] - wasted0
            if recs or block_ms:
                reg.histogram("tick_dispatch_ms").observe(dispatch_ms)
                reg.histogram("tick_block_ms").observe(block_ms)
                if n_wasted:
                    reg.counter("burst_wasted_tokens").inc(n_wasted)
                event = {
                    "dispatch_ms": round(dispatch_ms, 4),
                    "block_ms": round(block_ms, 4),
                    "inflight": len(self._inflight),
                    "emitted": n_tokens,
                    "wasted": n_wasted,
                    "fused_prefill": any(r.fused for r in recs.values()),
                }
                if self.spec_gamma:
                    event["spec_gamma"] = self.spec_gamma
                    event["spec_drafted"] = stats["spec_drafted"] - drafted0
                    event["spec_accepted"] = stats["spec_accepted"] - accepted0
                tele.emit("serving_tick", event)
        return emitted

    def cache_utilization(self) -> float:
        """Share of the slot pools' KV capacity holding live tokens."""
        used = sum(min(r.prompt.size + len(r.generated), p.length)
                   for p in self._pools for r in p.active.values())
        cap = sum(p.n_slots * p.length for p in self._pools)
        return used / cap if cap else 0.0

    # -- tick dispatch / retire ------------------------------------------
    def _read_len(self, pool: _Pool, extent: int) -> Optional[int]:
        """Tight-read length covering ``extent`` cached slots (None = the
        full pool length)."""
        if not self._eng.config.kv_tight_read or extent <= 0:
            return None
        r = read_bucket(extent, pool.length, self._eng.config.kv_read_floor)
        return None if r >= pool.length else r

    def _row_read_bytes(self, pool: _Pool, read_len: Optional[int]) -> int:
        """KV bytes one row streams a step, per chip on a mesh (the
        reference's accounting)."""
        return tf.kv_read_bytes_per_row(self.cfg,
                                        read_len if read_len is not None else pool.length,
                                        tp=self._eng.kv_shard_width)

    def _tick_fn(self, pool: _Pool, read_len: Optional[int], chunk: Optional[int] = None):
        """The pool's tick function at (chunk width, tight-read length)."""
        key = (chunk, read_len)
        if key not in pool.tick_fns:
            pool.tick_fns[key] = compile_pool_tick_fn(
                self.shard, self.cfg, pool.n_slots, pool.length,
                1 if chunk is not None else self.tokens_per_tick,
                self.temperature, self.top_k, self.top_p,
                eos_token_id=self.eos_token_id, read_len=read_len,
                chunk=chunk, donate=self.donate_cache)[0]
        return pool.tick_fns[key]

    def _dispatch_tick(self, pool: _Pool) -> Optional[_TickRecord]:
        """Dispatch one tick for ``pool`` WITHOUT waiting for anything:
        inputs come from the host dispatch mirrors (uploaded through pinned
        staging) and the threaded device state. None when the pool has
        nothing to run."""
        n, k = pool.n_slots, self.tokens_per_tick
        pos = np.full(n, pool.length, np.int32)   # parked rows: writes drop
        gen = np.zeros(n, np.int32)
        quota = np.zeros(n, np.int32)
        rids = np.zeros(n, np.int32)
        emit_mask = np.zeros(n, np.int32)
        live: Dict[int, _Request] = {}
        extent = 0
        for slot, req in pool.active.items():
            if req.chunks:
                continue  # mid-prefill: parked unless it rides this tick
            if pool.disp_gen[slot] >= req.quota:
                continue  # quota exhausted: result still in flight, no work
            live[slot] = req
            pos[slot] = pool.disp_pos[slot]
            gen[slot] = pool.disp_gen[slot]
            quota[slot] = req.quota
            rids[slot] = req.rid
            emit_mask[slot] = 1
            extent = max(extent, int(pool.disp_pos[slot]) + k)
        admit = pool.prefill_q[0] if (self.fused_prefill and pool.prefill_q) else None
        if not live and admit is None:
            return None

        if admit is not None:
            ctoks, cpos0, nreal, emits = admit.chunks[0]
            aslot = admit.slot
            W = read_bucket(nreal, pool.chunk_cap, _CHUNK_FLOOR)
            extent = max(extent, cpos0 + nreal)
            read_len = self._read_len(pool, extent)
            chunk_toks = np.zeros(W, np.int32)
            chunk_toks[:nreal] = ctoks
            chunk_pos = np.full(W, pool.length, np.int32)
            chunk_pos[:nreal] = np.arange(cpos0, cpos0 + nreal, dtype=np.int32)
            emit_col = np.zeros(n, np.int32)
            if emits:
                emit_col[aslot] = nreal - 1
                emit_mask[aslot] = 1
                quota[aslot] = admit.quota
                # resume support: the first token's key continues at gen_base
                gen[aslot] = admit.gen_base
                rids[aslot] = admit.rid
                live[aslot] = admit
            packed = self._run_tick(pool.index, read_len, W, pos, gen, quota, rids,
                                    (chunk_toks, chunk_pos, aslot, emit_col, emit_mask))
            admit.chunks.pop(0)
            if not admit.chunks:
                pool.prefill_q.popleft()
                admit.chunks = None
                pool.disp_pos[aslot] = cpos0 + nreal  # full prompt cached
                pool.disp_gen[aslot] = admit.gen_base + 1  # the emitted first token
            host, event = self._fetch_async(packed)
            rec = _TickRecord(host, event, live, 1, self._row_read_bytes(pool, read_len), True)
            advance = 1
        else:
            read_len = self._read_len(pool, extent)
            packed = self._run_tick(pool.index, read_len, None, pos, gen, quota, rids)
            host, event = self._fetch_async(packed)
            rec = _TickRecord(host, event, live, k, self._row_read_bytes(pool, read_len), False)
            advance = k
        # advance the dispatch mirrors of the decode rows (the admitting
        # row's were set above), quota-clamped
        for slot, req in live.items():
            if admit is not None and slot == admit.slot:
                continue
            adv = min(advance, int(req.quota) - int(pool.disp_gen[slot]))
            pool.disp_pos[slot] += adv
            pool.disp_gen[slot] += adv
        return rec

    @mesh_mod.mirrored
    def _run_tick(self, pi: int, read_len: Optional[int], chunk: Optional[int], pos, gen, quota,
                  rids, admit=None):
        """Device half of a tick: upload the host vectors, run the pool's
        tick function at (``chunk``, ``read_len``), thread the pool's state.
        ``admit`` is a fused tick's (chunk tokens, chunk positions, admitting
        slot, emit column, emit mask). Returns the packed result."""
        pool = self._pools[pi]
        fn = self._tick_fn(pool, read_len, chunk=chunk)
        if admit is None:
            d_pos, d_gen, d_quota, d_rids = self._upload(pos, gen, quota, rids)
            extra = ()
        else:
            chunk_toks, chunk_pos, aslot, emit_col, emit_mask = admit
            (d_pos, d_gen, d_quota, d_rids, d_ctoks, d_cpos, d_col,
             d_mask) = self._upload(pos, gen, quota, rids, chunk_toks, chunk_pos, emit_col,
                                    emit_mask)
            extra = (d_ctoks, d_cpos, aslot, d_col, d_mask)
        packed, pool.cache, pool.last_tok_dev, pool.done_dev = fn(
            self._eng.params, pool.cache, pool.last_tok_dev, pool.done_dev, d_pos, d_gen,
            d_quota, d_rids, self._base_key, *extra)
        return packed

    def _spec_round_bytes(self, pool: _Pool, read_len: Optional[int]) -> int:
        """KV bytes ONE row streams a speculative round: the target's verify
        reads its window once (the gamma+1 queries share one cache read),
        plus gamma+1 draft steps each streaming the draft cache's window (0
        for ngram: drafting is host-side)."""
        total = self._row_read_bytes(pool, read_len)
        if self.spec_mode == "draft":
            total += (self.spec_gamma + 1) * tf.kv_read_bytes_per_row(
                self.draft_cfg, read_len if read_len is not None else pool.length,
                tp=self._draft_eng.kv_shard_width)
        return total

    def _spec_tick_fn(self, pool: _Pool, read_len: Optional[int]):
        """The pool's speculative tick at tight-read length ``read_len``,
        keyed ``("spec", read_len)`` beside the plain variants."""
        key = ("spec", read_len)
        if key not in pool.tick_fns:
            pool.tick_fns[key] = compile_spec_pool_tick_fn(
                self.shard, self.cfg, pool.n_slots, pool.length, self.spec_gamma,
                self.temperature, self.top_k, self.top_p, eos_token_id=self.eos_token_id,
                read_len=read_len, donate=self.donate_cache, draft_cfg=self.draft_cfg,
                draft_mesh=None if self._draft_eng is None else self._draft_eng.shard)[0]
        return pool.tick_fns[key]

    def _dispatch_spec_tick(self, pool: _Pool) -> Optional[_TickRecord]:
        """Speculative counterpart of :meth:`_dispatch_tick`: one gamma-verify
        round a pool a step, enqueue-only like the plain path. Fused
        admission rides a SEPARATE segment dispatch on the same step (prompt
        chunks never enter the spec tick; the admitting row joins the round
        on the step its last chunk dispatches), so decode rows keep
        speculating through a long prompt's prefill."""
        g, n = self.spec_gamma, pool.n_slots
        fused = False
        if self.fused_prefill and pool.prefill_q:
            admit = pool.prefill_q[0]
            ctoks, cpos0, nreal, _ = admit.chunks.pop(0)
            W = read_bucket(nreal, pool.chunk_cap, _CHUNK_FLOOR)
            seg_toks = np.zeros((n, W), np.int32)
            seg_toks[admit.slot, :nreal] = ctoks
            seg_pos = np.full(n, pool.length, np.int32)
            seg_pos[admit.slot] = cpos0
            self._run_segment(pool.index, seg_toks, seg_pos)
            fused = True
            if not admit.chunks:
                pool.prefill_q.popleft()
                admit.chunks = None  # joins the round below
        run_mask = np.zeros(n, np.int32)
        quota = np.zeros(n, np.int32)
        rids = np.zeros(n, np.int32)
        live: Dict[int, _Request] = {}
        extent = 0
        for slot, req in pool.active.items():
            if req.chunks:
                continue  # mid-prefill: run_mask parks the row
            if pool.disp_gen[slot] >= req.quota:
                continue  # quota covered by rounds in flight (disp_gen is a lower
                # bound; the device's threaded done flag decides)
            live[slot] = req
            run_mask[slot] = 1
            quota[slot] = req.quota
            rids[slot] = req.rid
            extent = max(extent, int(pool.disp_pos[slot]) + g + 1)
        if not live:
            return None
        read_len = self._read_len(pool, min(extent, pool.length))
        drafts = None
        if self.spec_mode != "draft":
            drafts = np.zeros((n, g), np.int32)
            order = self._eng.config.speculative.ngram_max_order
            for slot, req in live.items():
                # under dispatch-ahead the host context lags the device by up
                # to pipeline_depth rounds: that only lowers the acceptance
                ctx = (np.concatenate([req.prompt, np.asarray(req.generated, np.int32)])
                       if req.generated else req.prompt)
                drafts[slot] = ngram.propose(ctx, g, order)
        packed = self._run_spec_tick(pool.index, read_len, quota, rids, run_mask, drafts)
        # dispatch mirrors: pos becomes an UPPER bound (the device advances by
        # accepted + 1 <= gamma + 1; read geometry only) and gen a LOWER one
        # (an active round emits >= 1); _retire reconciles both
        for slot in live:
            pool.disp_pos[slot] += g + 1
            pool.disp_gen[slot] += 1
        host, event = self._fetch_async(packed)
        return _TickRecord(host, event, live, g + 1, self._spec_round_bytes(pool, read_len),
                           fused, spec=g)

    @mesh_mod.mirrored
    def _run_spec_tick(self, pi: int, read_len: Optional[int], quota, rids, run_mask,
                       drafts=None):
        """Device half of a speculative tick: the round at ``read_len`` over
        the pool's threaded state; ``drafts`` (B, gamma) are the host's
        n-gram proposals (None in draft-model mode). Returns the packed
        result."""
        pool = self._pools[pi]
        fn = self._spec_tick_fn(pool, read_len)
        params = self._eng.params
        if self.spec_mode == "draft":
            d_quota, d_rids, d_mask = self._upload(quota, rids, run_mask)
            (packed, pool.cache, pool.draft_cache, pool.last_tok_dev, pool.done_dev,
             pool.pos_dev, pool.gen_dev) = fn(
                params, self._draft_eng.params, pool.cache, pool.draft_cache,
                pool.last_tok_dev, pool.done_dev, pool.pos_dev, pool.gen_dev, d_quota, d_rids,
                d_mask, self._base_key)
        else:
            d_quota, d_rids, d_mask, d_drafts = self._upload(quota, rids, run_mask, drafts)
            (packed, pool.cache, pool.last_tok_dev, pool.done_dev, pool.pos_dev,
             pool.gen_dev) = fn(params, pool.cache, pool.last_tok_dev, pool.done_dev,
                                pool.pos_dev, pool.gen_dev, d_quota, d_rids, d_mask, d_drafts,
                                self._base_key)
        return packed

    @mesh_mod.mirrored
    def _run_segment(self, pi: int, toks, pos, draft: bool = False):
        """A segment forward of pool ``pi`` at per-row positions into its
        cache (``draft``: the draft model's cache): fused speculative
        admission chunks, prefix-suffix prefills, the draft's prefill."""
        pool = self._pools[pi]
        d_toks, d_pos = self._upload(toks, pos)
        if draft:
            _, pool.draft_cache = pool.draft_segment_fn(self._draft_eng.params, d_toks,
                                                        pool.draft_cache, d_pos)
        else:
            _, pool.cache = pool.segment_fn(self._eng.params, d_toks, pool.cache, d_pos)

    def _retire(self, recs: Dict[int, _TickRecord], emitted: Dict[int, List[int]]) -> float:
        """Retire one in-flight tick: ONE wait on its packed result per
        pool, then host attribution only. Returns the ms spent blocked."""
        block_ms = 0.0
        stats = self._tick_stats
        for pi, rec in recs.items():
            pool = self._pools[pi]
            if self.fault_hook is not None:
                self.fault_hook("retire", {"tick": self._tick_index, "pool": pi})
            t0 = time.perf_counter()
            if rec.event is not None:
                rec.event.synchronize()  # the one wait on the device per tick
            arr = rec.packed.numpy()
            dt = time.perf_counter() - t0
            if self.fetch_timeout_s is not None and dt > self.fetch_timeout_s:
                raise TimeoutError(
                    f"tick result fetch took {dt:.3f}s (> fetch_timeout_s="
                    f"{self.fetch_timeout_s}): device unhealthy, tick pipeline abandoned")
            block_ms += dt * 1000.0
            k, g = rec.k, rec.spec
            hook = self.span_hook
            if hook is not None:
                t_ret = time.monotonic()
                tick_kind = ("spec_verify_round" if g else
                             "prefill_chunk" if rec.fused else "decode_window")
            for slot, req in rec.live.items():
                if pool.active.get(slot) is not req:
                    # cancelled / already finished while in flight: the
                    # row-tick computed past its done flag
                    stats["wasted_tokens"] += k
                    continue
                n = int(arr[slot, k])
                stats["tokens"] += n
                stats["wasted_tokens"] += k - n
                if g:
                    accepted = int(arr[slot, g + 3])
                    stats["spec_drafted"] += g
                    stats["spec_accepted"] += accepted
                    req.spec_drafted += g
                    req.spec_accepted += accepted
                    # reconcile the dispatch mirrors: the round advanced pos
                    # by accepted + 1 (the mirror assumed gamma + 1) and
                    # emitted n (the mirror assumed 1)
                    pool.disp_pos[slot] -= g - accepted
                    pool.disp_gen[slot] += n - 1
                    # row_bytes is the whole round's (one window + draft steps)
                    req.kv_bytes_read += rec.row_bytes
                else:
                    # the row streamed k read windows whether or not it
                    # accepted all k tokens
                    req.kv_bytes_read += k * rec.row_bytes
                if hook is not None:
                    if req.win_kind is not None and req.win_kind != tick_kind:
                        self._flush_window(req)
                    if req.win_kind is None:
                        req.win_kind = tick_kind
                        req.win_t0 = rec.t0
                    req.win_t1 = t_ret
                    req.win_ticks += 1
                    req.win_tokens += n
                    if g:
                        req.win_drafted += g
                        req.win_accepted += accepted
                    if req.win_ticks >= self.span_window_ticks:
                        self._flush_window(req)
                if n:
                    toks = [int(t) for t in arr[slot, :n]]
                    req.generated.extend(toks)
                    emitted.setdefault(req.rid, []).extend(toks)
                if arr[slot, k + 1]:
                    req.done = True
                    self._finish(pool, slot)
        return block_ms

    def _flush_window(self, req: "_Request"):
        """Emit the request's open tick window through ``span_hook`` and
        reset the accumulator."""
        if req.win_kind is None or self.span_hook is None:
            req.win_kind = None
            return
        attrs = {"ticks": req.win_ticks, "tokens": req.win_tokens}
        if req.win_kind == "spec_verify_round":
            attrs["drafted"] = req.win_drafted
            attrs["accepted"] = req.win_accepted
        self.span_hook(req.rid, req.win_kind, req.win_t0, req.win_t1, attrs)
        req.win_kind = None
        req.win_ticks = req.win_tokens = 0
        req.win_drafted = req.win_accepted = 0

    # -- internals ------------------------------------------------------
    def _prefill_for_bucket(self, bucket: int):
        """B=1 ragged prefill into a bucket-length cache (any pool)."""
        key = ("prefill_bucket", bucket)
        if key not in self._fns:
            self._fns[key] = compile_ragged_prefill_fn(self.shard, self.cfg, 1, bucket)
        return self._fns[key]

    def _insert_for_bucket(self, bucket: int, pi: int):
        """Splice a B=1 bucket cache into pool ``pi``'s cache row: time
        slots [0, bucket) overwritten, staler slots beyond are masked until
        real writes reach them (dense and int8 components alike)."""
        key = ("insert_bucket", bucket, pi)
        if key not in self._fns:
            def copy(big, small, slot):
                big[:, slot, :bucket] = small[:, 0].to(big.dtype)

            def insert(big, small, slot):
                for name in ("k", "v"):
                    if isinstance(big[name], dict):
                        for part in big[name]:
                            copy(big[name][part], small[name][part], slot)
                    else:
                        copy(big[name], small[name], slot)
                return big

            self._fns[key] = insert
        return self._fns[key]

    def _chunk_schedule(self, pool: _Pool, toks: np.ndarray, start: int) -> List[tuple]:
        """Split a prompt (or prefix suffix) into the fused-prefill chunk
        stream: [(tokens, pos0, n_real, emits)], one tick each; the final
        chunk samples the first generated token from its last column."""
        cap = pool.chunk_cap
        out, off, m = [], 0, int(toks.size)
        while off < m:
            take = min(cap, m - off)
            out.append((np.asarray(toks[off:off + take], np.int32), start + off, take,
                        off + take == m))
            off += take
        return out

    def _set_row(self, pool: _Pool, slot: int, tok: int, flag: int):
        """Admission-time update of one row of the threaded tick state,
        queued on the stream, never read back."""
        if self.fault_hook is not None:
            self.fault_hook("set_row", {"tick": self._tick_index, "slot": slot})
        self._run_set_row(pool.index, slot, tok, flag)

    @mesh_mod.mirrored
    def _run_set_row(self, pi: int, slot: int, tok: int, flag: int):
        pool = self._pools[pi]
        pool.last_tok_dev, pool.done_dev = pool.set_row_fn(
            pool.last_tok_dev, pool.done_dev, slot, tok, flag)

    def _admit(self, req: _Request, pi: int, slot: int):
        """Place ``req`` into a slot and dispatch its prefill; NOTHING here
        waits on the device. Fused mode queues the prompt as chunks riding
        the next ticks; separate mode prefills ``prompt[:-1]`` and re-feeds
        the last prompt token on the first decode tick."""
        pool = self._pools[pi]
        req.slot, req.pool = slot, pi
        req.quota = req.gen_base + req.max_new_tokens
        pool.active[slot] = req
        start = 0
        toks = req.prompt
        if req.prefix is not None:
            pre = req.prefix
            # splice the cached prefix KV into the slot row (the prefix
            # cache itself stays as it is: it serves every request)
            self._run_insert_prefix(pi, slot, pre["pid"], pre["bucket"])
            self._release_prefix(pre["pid"])
            start = pre["tokens"].size
            toks = req.prompt[start:]
        if self.spec_gamma:
            self._admit_spec(req, pool, pi, slot, toks, start)
            return
        if self.fused_prefill:
            req.chunks = self._chunk_schedule(pool, toks, start)
            pool.prefill_q.append(req)
            # flip the row live; last_tok is set by the emitting chunk tick
            self._set_row(pool, slot, int(toks[-1]), 0)
            return
        m = int(toks.size)
        self._separate_prefill(pool, pi, slot, req, toks, start)
        # the first tick re-feeds the last prompt token at its own position
        # and samples the first generated token from its logits
        self._set_row(pool, slot, int(toks[-1]), 0)
        pool.disp_pos[slot] = start + m - 1
        pool.disp_gen[slot] = req.gen_base

    @mesh_mod.mirrored
    def _run_insert_prefix(self, pi: int, slot: int, pid: int, bucket: int):
        pool = self._pools[pi]
        insert_fn = self._insert_for_bucket(bucket, pi)
        pool.cache = insert_fn(pool.cache, self._prefix_caches[pid], slot)

    def _separate_prefill(self, pool: _Pool, pi: int, slot: int, req: _Request,
                          toks: np.ndarray, start: int):
        """Admission-time prefill of ``toks[:-1]`` into the slot row: the B=1
        bucket prefill + splice, or the pool's segment forward for prefix
        suffixes."""
        m = int(toks.size)
        if m <= 1:
            return
        if req.prefix is not None:
            # other rows park at the pool length so their writes drop; pad
            # columns land at future positions of THIS row, each overwritten
            # by a real decode write before it is attended
            sb = read_bucket(m - 1, pool.length)
            seg_toks = np.zeros((pool.n_slots, sb), np.int32)
            seg_toks[slot, :m - 1] = toks[:m - 1]
            seg_pos = np.full(pool.n_slots, pool.length, np.int32)
            seg_pos[slot] = start
            self._run_segment(pi, seg_toks, seg_pos)
        else:
            b = read_bucket(m - 1, pool.length)
            ptoks = np.zeros((1, b), np.int32)
            ptoks[0, :m - 1] = toks[:m - 1]
            # pads park at bucket (dropped writes), real tokens 0..m-2
            positions = np.full((1, b), b, np.int32)
            positions[0, :m - 1] = np.arange(m - 1, dtype=np.int32)
            self._run_prefill_insert(pi, slot, b, ptoks, positions)

    @mesh_mod.mirrored
    def _run_prefill_insert(self, pi: int, slot: int, b: int, ptoks, positions):
        """The B=1 bucket prefill of a prompt into its own cache, spliced
        into pool ``pi``'s row ``slot``."""
        pool = self._pools[pi]
        prefill_fn = self._prefill_for_bucket(b)
        insert_fn = self._insert_for_bucket(b, pi)
        small = tf.init_cache(self.cfg, 1, b, device=self.device, tp=self.shard)
        d_toks, d_pos = self._upload(ptoks, positions)
        _, small = prefill_fn(self._eng.params, d_toks, d_pos, small)
        pool.cache = insert_fn(pool.cache, small, slot)

    def _admit_spec(self, req: _Request, pool: _Pool, pi: int, slot: int, toks: np.ndarray,
                    start: int):
        """Speculative admission. The row always prefills its tokens but the
        last (fused: chunks through the pool's segment function, one a step;
        separate: the bucket prefill and splice); the row's first round
        feeds the last prompt token, whose verify logits give the first
        generated token, so fused and separate admission give one stream.
        Draft mode also prefills the full prompt but its last token through
        the draft's segment function in one dispatch (prefix caching is
        target-only: the draft cache starts cold)."""
        m = int(toks.size)
        first_pos = start + m - 1
        if self.spec_mode == "draft":
            mfull = int(req.prompt.size)
            if mfull > 1:
                db = read_bucket(mfull - 1, pool.length)
                dtoks = np.zeros((pool.n_slots, db), np.int32)
                dtoks[slot, :mfull - 1] = req.prompt[:mfull - 1]
                dpos = np.full(pool.n_slots, pool.length, np.int32)
                dpos[slot] = 0
                self._run_segment(pi, dtoks, dpos, draft=True)
        if self.fused_prefill and m > 1:
            req.chunks = self._chunk_schedule(pool, toks[:-1], start)
            pool.prefill_q.append(req)
        else:
            self._separate_prefill(pool, pi, slot, req, toks, start)
        if self.fault_hook is not None:
            self.fault_hook("set_row", {"tick": self._tick_index, "slot": slot})
        self._run_spec_set_row(pi, slot, int(toks[-1]), first_pos, int(req.gen_base))
        pool.disp_pos[slot] = first_pos
        pool.disp_gen[slot] = req.gen_base

    @mesh_mod.mirrored
    def _run_spec_set_row(self, pi: int, slot: int, tok: int, first_pos: int, gen_base: int):
        pool = self._pools[pi]
        pool.last_tok_dev, pool.done_dev, pool.pos_dev, pool.gen_dev = pool.spec_set_row_fn(
            pool.last_tok_dev, pool.done_dev, pool.pos_dev, pool.gen_dev, slot, tok, 0,
            first_pos, gen_base)

    def precompile_tick_programs(self, progress: Optional[Callable] = None) -> int:
        """Run (and wait on) the FULL tick family once on throwaway state:
        every (pool, read bucket, {plain/burst, fused chunk widths}) variant
        a serve could dispatch, enumerated through the same functions the
        dispatch uses. Eager PyTorch compiles nothing; the warm-up settles
        the allocator, the kernel libraries and cuBLAS for every shape.
        Returns the count."""
        self._progress = progress
        try:
            return self._run_precompile()
        finally:
            self._progress = None

    @mesh_mod.mirrored
    def _run_precompile(self) -> int:
        progress = getattr(self, "_progress", None)
        count = 0
        with torch.inference_mode():
            for pool in self._pools:
                read_lens = sorted({self._read_len(pool, e) for e in range(1, pool.length + 1)},
                                   key=lambda r: (r is None, r))
                if self.spec_gamma:
                    count += self._precompile_spec(pool, read_lens, progress)
                    continue
                chunks: List[Optional[int]] = [None]
                if self.fused_prefill:
                    chunks += sorted({read_bucket(m, pool.chunk_cap, _CHUNK_FLOOR)
                                      for m in range(1, pool.chunk_cap + 1)})
                n = pool.n_slots
                for rl in read_lens:
                    for ch in chunks:
                        t0 = time.time()
                        fn = self._tick_fn(pool, rl, chunk=ch)
                        cache = tf.init_cache(self.cfg, n, pool.length, device=self.device,
                                              tp=self.shard)

                        def zeros():
                            return torch.zeros(n, dtype=torch.int32, device=self.device)

                        parked = torch.full((n,), pool.length, dtype=torch.int64,
                                            device=self.device)
                        args = (self._eng.params, cache, zeros(),
                                torch.ones(n, dtype=torch.int32, device=self.device), parked,
                                zeros(), zeros(), zeros(), self._base_key)
                        if ch is not None:
                            args += (torch.zeros(ch, dtype=torch.int64, device=self.device),
                                     torch.full((ch,), pool.length, dtype=torch.int64,
                                                device=self.device), 0, zeros(), zeros())
                        fn(*args)[0].cpu()
                        count += 1
                        if progress is not None:
                            progress(f"tick(pool={pool.length}, read_len={rl}, chunk={ch}) "
                                     f"in {time.time() - t0:.1f}s")
        return count

    def _precompile_spec(self, pool: _Pool, read_lens, progress) -> int:
        """Speculative arm of :meth:`precompile_tick_programs`: the spec tick
        at each read bucket on throwaway state, then (fused admission) the
        segment forward at each chunk width."""
        count, g, n, dev = 0, self.spec_gamma, pool.n_slots, self.device

        def zeros():
            return torch.zeros(n, dtype=torch.int32, device=dev)

        for rl in read_lens:
            t0 = time.time()
            fn = self._spec_tick_fn(pool, rl)
            cache = tf.init_cache(self.cfg, n, pool.length, device=dev, tp=self.shard)
            state = (zeros(), torch.ones(n, dtype=torch.int32, device=dev),
                     torch.full((n,), pool.length, dtype=torch.int32, device=dev), zeros(),
                     zeros(), zeros(), zeros())
            if self.spec_mode == "draft":
                dcache = tf.init_cache(self.draft_cfg, n, pool.length, device=dev,
                                       tp=self._draft_eng.shard)
                out = fn(self._eng.params, self._draft_eng.params, cache, dcache, *state,
                         self._base_key)
            else:
                out = fn(self._eng.params, cache, *state,
                         torch.zeros((n, g), dtype=torch.int64, device=dev), self._base_key)
            out[0].cpu()
            count += 1
            if progress is not None:
                progress(f"spec_tick(pool={pool.length}, read_len={rl}, mode={self.spec_mode}, "
                         f"gamma={g}) in {time.time() - t0:.1f}s")
        if self.fused_prefill:
            for W in sorted({read_bucket(m, pool.chunk_cap, _CHUNK_FLOOR)
                             for m in range(1, pool.chunk_cap + 1)}):
                t0 = time.time()
                cache = tf.init_cache(self.cfg, n, pool.length, device=dev, tp=self.shard)
                logits, _ = pool.segment_fn(
                    self._eng.params, torch.zeros((n, W), dtype=torch.int64, device=dev), cache,
                    torch.full((n,), pool.length, dtype=torch.int64, device=dev))
                logits[:, 0, 0].cpu()
                count += 1
                if progress is not None:
                    progress(f"spec_segment(pool={pool.length}, chunk={W}) "
                             f"in {time.time() - t0:.1f}s")
        return count

    def _finish(self, pool: _Pool, slot: int):
        tele = self._eng.telemetry
        # pool pressure BEFORE the pop: the event describes the state this
        # request served under
        util = self.cache_utilization() if tele.enabled else 0.0
        req = pool.active.pop(slot)
        # tail window span BEFORE the request leaves the serving layer's
        # engine-rid table (the hook resolves the trace through it)
        self._flush_window(req)
        self._results[req.rid] = np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)])
        if tele.enabled:
            new = len(req.generated)
            event = {
                "request": int(req.rid),
                "path": "continuous",
                "batch": 1,
                "prompt_tokens": int(req.prompt.size),
                "new_tokens": new,
                "cache_len": pool.length,
                "kv_dtype": "int8" if self.cfg.kv_cache_dtype == "int8" else self.cfg.dtype,
                "kv_bytes_read": int(req.kv_bytes_read),
                "cache_utilization": round(util, 4),
            }
            if new:
                event["kv_bytes_per_token"] = round(req.kv_bytes_read / new, 1)
            if self.spec_gamma:
                event["spec_gamma"] = self.spec_gamma
                event["spec_drafted"] = int(req.spec_drafted)
                event["spec_accepted"] = int(req.spec_accepted)
            if self.request_event_hook is not None:
                event = self.request_event_hook(req.rid, event) or event
            tele.emit("inference_request", event)
