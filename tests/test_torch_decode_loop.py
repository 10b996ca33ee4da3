"""The per-token decode loop with bucket migration (``fused_generate: false``;
``inference/decoding.decode_loop``, ``InferenceEngine._migrating_decode_fn``
and ``_grow_cache``) against the reference's engine and against the port's
own fused path, in f32 on the CPU (mirroring
``tests/unit/inference/test_kv_tight_read.py``).

Tolerances: greedy streams equal the reference's, or first differ at a step
whose reference top-2 logit margin is under 1e-4 (a tie that f32 summation
order may break; reported, not failed; the rule of
``tests/test_torch_inference_engine.py``). The allocation walk (the cache
length at the prefill and at every migration) equals the reference's
exactly. Against the port's fused path on one ``torch.Generator`` the
streams are equal bit for bit, greedy and sampled: both draw in the same
order, and every decode step reads the same number of cache slots.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference import decoding as tdec
from deepspeed_tpu_torch.models import transformer as ttf

TIE = 1e-4
FLOOR = 16  # a 10-token prompt + 40 new migrates 16 -> 32 -> 64
PROMPT, NEW = 10, 40
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           max_seq_len=64, dtype="float32", pos_embedding="rope", norm_type="rmsnorm",
           activation="silu_glu", use_bias=False, tie_embeddings=False, ffn_hidden_size=96,
           attn_impl="pallas")
RING_CFG = dict(CFG, max_seq_len=96, local_attn_windows=(16, 16))
CONFIGS = {"tight": {}, "full": {"kv_tight_read": False}, "int8-kv": {"kv_cache_dtype": "int8"}}


def _params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed),
                                               jtf.TransformerConfig(**cfg)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def setup():
    comm.destroy()
    yield {"params": _params(CFG), "ring_params": _params(RING_CFG, seed=1),
           "toks": np.random.RandomState(1).randint(0, 128, (2, PROMPT)).astype(np.int32)}
    comm.destroy()


def _config(over):
    return dict({"dtype": "float32", "kv_read_floor": FLOOR, "fused_generate": False}, **over)


def _port(cfg, params, **over):
    return deepspeed_tpu_torch.init_inference(ttf.TransformerModel(ttf.TransformerConfig(**cfg)),
                                              config=_config(over), params=params, device="cpu")


def _ref(cfg, params, **over):
    comm.destroy()
    return deepspeed_tpu.init_inference(jtf.TransformerModel(jtf.TransformerConfig(**cfg)),
                                        params=params, config=_config(over))


def _walked(monkeypatch, module, eng, generate):
    """Run ``generate()`` recording the allocation walk: the cache length
    ``init_cache`` gives the request, then each migration's target."""
    walk = []
    real_init, real_grow = module.init_cache, eng._grow_cache

    def init_cache(cfg, batch_size, max_len=None, *args, **kw):
        # the reference's sharding probe (decoding._decode_shardings)
        # builds a (1, 8) cache that holds no request
        if (batch_size, max_len) != (1, 8):
            walk.append(max_len)
        return real_init(cfg, batch_size, max_len, *args, **kw)

    def grow(cache, new_len):
        walk.append(new_len)
        return real_grow(cache, new_len)

    with monkeypatch.context() as m:
        m.setattr(module, "init_cache", init_cache)
        m.setattr(eng, "_grow_cache", grow)
        out = np.asarray(generate())
    return out, walk


def _assert_agree(cfg, params, want, got, prompt_len):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    for b in range(want.shape[0]):
        diff = np.nonzero(want[b] != got[b])[0]
        if not diff.size:
            continue
        j = int(diff[0])
        assert j >= prompt_len
        logits = np.asarray(jtf.apply(params, jtf.TransformerConfig(**cfg),
                                      jnp.asarray(want[b:b + 1, :j])))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"row {b} differs at position {j} (reference margin {margin})"
        warnings.warn(f"row {b}: a tie at position {j} (reference margin {margin:.3g})")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_per_token_loop_matches_reference(setup, monkeypatch, name):
    """Streams and the allocation walk: tight reads migrate 16 -> 32 -> 64;
    tight reads off keep the full allocation; the int8 cache migrates its
    {"q8", "s"} components."""
    params, toks = setup["params"], setup["toks"]
    ref, port = _ref(CFG, params, **CONFIGS[name]), _port(CFG, params, **CONFIGS[name])
    want, ref_walk = _walked(monkeypatch, jtf, ref,
                             lambda: ref.generate(jnp.asarray(toks), max_new_tokens=NEW))
    got, walk = _walked(monkeypatch, ttf, port,
                        lambda: port.generate(toks, max_new_tokens=NEW))
    assert walk == ref_walk
    assert walk == ([64] if name == "full" else [16, 32, 64])
    _assert_agree(CFG, params, want, got, PROMPT)


@pytest.mark.parametrize("prompt,new", [(15, 2), (31, 30)])
def test_allocation_walk_follows_the_reference_rule(setup, monkeypatch, prompt, new):
    """The walk starts at ``read_bucket(S + 1)``, grows by
    ``read_bucket(pos + 1)`` when a write reaches the allocation, and ends
    at ``read_bucket(total - 1)`` (the closing token is never cached)."""
    params = setup["params"]
    toks = np.random.RandomState(prompt).randint(0, 128, (1, prompt)).astype(np.int32)
    ref, port = _ref(CFG, params), _port(CFG, params)
    _, ref_walk = _walked(monkeypatch, jtf, ref,
                          lambda: ref.generate(jnp.asarray(toks), max_new_tokens=new))
    _, walk = _walked(monkeypatch, ttf, port, lambda: port.generate(toks, max_new_tokens=new))
    assert walk == ref_walk
    total = prompt + new
    assert walk[0] == tdec.read_bucket(prompt + 1, 64, FLOOR)
    assert walk[-1] == tdec.read_bucket(max(prompt + 1, total - 1), 64, FLOOR)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_per_token_loop_equals_the_fused_path_bit_for_bit(setup, name, temperature):
    """On one generator the per-token loop (migrating cache) and the fused
    path (bucket-staged reads) give the same tokens, bit for bit: the same
    draws in the same order over the same read lengths."""
    params, toks = setup["params"], setup["toks"]
    outs = []
    for fused in (True, False):
        eng = _port(CFG, params, fused_generate=fused, **CONFIGS[name])
        gen = torch.Generator().manual_seed(7)
        outs.append(eng.generate(toks, max_new_tokens=NEW, temperature=temperature, top_k=20,
                                 generator=gen))
    assert torch.equal(outs[0], outs[1])


def test_per_token_loop_on_the_ring_matches_reference(setup, monkeypatch):
    """A uniform-window model: the per-token loop runs the window-sized ring
    (no tight reads, no migration), and its stream equals the reference's."""
    params = setup["ring_params"]
    toks = np.random.RandomState(2).randint(0, 128, (2, 8)).astype(np.int32)
    ref, port = _ref(RING_CFG, params), _port(RING_CFG, params)
    assert port.cfg.rolling_kv_cache
    want, ref_walk = _walked(monkeypatch, jtf, ref,
                             lambda: ref.generate(jnp.asarray(toks), max_new_tokens=40))
    got, walk = _walked(monkeypatch, ttf, port, lambda: port.generate(toks, max_new_tokens=40))
    assert walk == ref_walk == [16]
    _assert_agree(RING_CFG, params, want, got, 8)


def test_decode_loop_draws_as_the_fused_function(setup):
    """``decode_loop`` over ``compile_decode_fns`` against
    ``compile_generate_fn`` on one generator: the same sampled bits."""
    port = _port(CFG, setup["params"])
    toks = torch.from_numpy(setup["toks"]).long()
    prefill, decode, _, _ = tdec.compile_decode_fns(None, port.cfg, 2, 64)
    a = tdec.decode_loop(prefill, decode, port.params, toks, ttf.init_cache(port.cfg, 2, 64),
                         12, 1.0, 0, torch.Generator().manual_seed(3), 0.9)
    fn = tdec.compile_generate_fn(None, port.cfg, 2, 64, 12, 1.0, 0, 0.9)
    b = fn(port.params, toks, ttf.init_cache(port.cfg, 2, 64), torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_telemetry_with_migration_is_refused(setup, tmp_path):
    """The reference snapshots device memory at every migration
    (``telemetry/memory.py``): that belongs to ROADMAP.md Queue 1 item
    11 (b), so the port refuses the combination instead of emitting less."""
    port = _port(CFG, setup["params"],
                 telemetry={"enabled": True, "trace_file": str(tmp_path / "t.jsonl")})
    with pytest.raises(NotImplementedError, match=r"item 11 \(b\)"):
        port.generate(setup["toks"], max_new_tokens=4)


def test_decode_loop_event_matches_the_reference(setup, tmp_path):
    """With tight reads off nothing migrates, and the per-token loop emits
    the reference's ``decode_loop`` event: the same fields, equal apart from
    the timings (``compile_cache_hit`` has no counterpart)."""
    from deepspeed_tpu_torch.telemetry import read_trace

    events = {}
    for side in ("ref", "port"):
        over = {"kv_tight_read": False,
                "telemetry": {"enabled": True, "trace_file": str(tmp_path / f"{side}.jsonl")}}
        if side == "ref":
            eng = _ref(CFG, setup["params"], **over)
            eng.generate(jnp.asarray(setup["toks"]), max_new_tokens=8)
        else:
            eng = _port(CFG, setup["params"], **over)
            eng.generate(setup["toks"], max_new_tokens=8)
        eng.telemetry.close()
        events[side] = [e for e in read_trace(str(tmp_path / f"{side}.jsonl"))
                        if e["kind"] == "inference_request"]
    (ref,), (port,) = events["ref"], events["port"]
    assert port["path"] == ref["path"] == "decode_loop"
    assert set(ref) - {"compile_cache_hit"} == set(port)
    for key in set(port) - {"ts", "total_ms", "ttft_ms", "tokens_per_sec",
                            "decode_tokens_per_sec"}:
        assert port[key] == ref[key], key
