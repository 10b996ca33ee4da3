"""The port's serving entry point (``init_inference`` -> ``generate``) against
the reference's ``InferenceEngine`` on the same bridged weights, in f32 on
the CPU, plus the decode geometry helpers.

Greedy token streams must be identical. When they are not, the test looks
up the reference's top-2 logit margin at the first differing step: a margin
under the logits tolerance (1e-4, see tests/test_torch_transformer.py) is a
tie that f32 summation order may break either way, and is reported as such
instead of as a failure. Sampled streams are not compared bitwise: the
reference draws from JAX threefry keys, the port from a ``torch.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import comm
from deepspeed_tpu.inference import decoding as jdec
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference import decoding as tdec
from deepspeed_tpu_torch.models import transformer as ttf

# A suite-order hazard outside the port: the mpi_shim test in
# tests/unit/launcher/test_runner.py leaves DSTPU_COORDINATOR /
# DSTPU_NUM_PROCESSES / DSTPU_PROCESS_ID in os.environ (mpi_shim.main sets
# them before the exec that the test mocks). A pytest-xdist worker that runs
# that file before its first mesh initialisation then tries to join a
# coordinator in every later engine test. Every worker imports every test
# file at collection, while the environment is still clean, so settling the
# single-controller check here keeps such a worker's later files working.
comm.comm._maybe_init_multi_controller()

FLOOR = 16  # small tight-read floor: a 10-token prompt + 40 new crosses 16/32/64
TOL = 1e-4
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           dtype="float32")
PROMPT, NEW = 10, 40


@pytest.fixture(scope="module")
def setup():
    comm.destroy()
    jcfg = jtf.TransformerConfig(**CFG)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(0)
    # seeded noise: biases and norm scales away from the trivial 0/1
    params = jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)
    toks = np.random.RandomState(1).randint(0, 128, (2, PROMPT)).astype(np.int32)
    ref = {}
    for tight in (True, False):
        eng = deepspeed_tpu.init_inference(
            jtf.TransformerModel(jcfg), params=params,
            config={"dtype": "float32", "attn_impl": "pallas", "kv_read_floor": FLOOR,
                    "kv_tight_read": tight})
        ref[tight] = np.asarray(eng.generate(jnp.asarray(toks), max_new_tokens=NEW))
    logits = np.asarray(jtf.apply(params, jcfg, jnp.asarray(ref[True])))
    yield {"params": params, "toks": toks, "ref": ref, "ref_logits": logits, "jeng": eng}
    comm.destroy()


def _engine(params, **over):
    config = {"dtype": "float32", "attn_impl": "pallas", "kv_read_floor": FLOOR}
    config.update(over)
    return deepspeed_tpu_torch.init_inference(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                              config=config, params=params, device="cpu")


def _assert_same_stream(ref, out, ref_logits):
    if np.array_equal(ref, out):
        return
    b, j = np.argwhere(ref[:, PROMPT:] != out[:, PROMPT:])[0]
    top2 = np.sort(ref_logits[b, PROMPT - 1 + j])[-2:]
    margin = float(top2[1] - top2[0])
    if margin < TOL:
        pytest.skip(f"tie: reference top-2 margin {margin:.2e} < {TOL} at row {b} step {j}")
    raise AssertionError(f"streams differ at row {b} step {j} (reference margin {margin:.3g})")


@pytest.mark.parametrize("tight", [True, False])
def test_greedy_stream_matches_reference(setup, tight):
    eng = _engine(setup["params"], kv_tight_read=tight)
    out = eng.generate(setup["toks"], max_new_tokens=NEW)
    assert out.shape == (2, PROMPT + NEW) and out.dtype == torch.int32
    _assert_same_stream(setup["ref"][tight], out.numpy(), setup["ref_logits"])


def test_xla_attention_gives_the_same_stream(setup):
    out = _engine(setup["params"], attn_impl="xla").generate(setup["toks"], max_new_tokens=NEW)
    _assert_same_stream(setup["ref"][True], out.numpy(), setup["ref_logits"])


def test_forward_matches_reference(setup):
    out = _engine(setup["params"]).forward(setup["ref"][True])
    ref = np.asarray(setup["jeng"].forward(setup["ref"][True]))
    assert float(np.max(np.abs(ref - out.numpy()))) <= TOL


def test_eos_truncation_matches_reference(setup):
    ref_stream = setup["ref"][True]
    eos = int(ref_stream[0, PROMPT + 3])  # a token the stream emits early
    ref = np.asarray(setup["jeng"].generate(jnp.asarray(setup["toks"]), max_new_tokens=NEW,
                                            eos_token_id=eos))
    out = _engine(setup["params"]).generate(setup["toks"], max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(ref, out.numpy())
    assert (out[0, PROMPT + 4:] == eos).all()


def test_sampling_emits_only_top_k_tokens(setup):
    eng = _engine(setup["params"])
    gen = torch.Generator().manual_seed(3)
    out = eng.generate(setup["toks"], max_new_tokens=NEW, temperature=1.0, top_k=5,
                       generator=gen)
    logits = eng.forward(out).float()
    steps = logits[:, PROMPT - 1:-1]  # logits that chose each generated token
    chosen = out[:, PROMPT:].long()
    kth = torch.topk(steps, 5, dim=-1).values[..., -1]
    picked = steps.gather(-1, chosen[..., None])[..., 0]
    assert bool((picked >= kth - TOL).all())
    again = eng.generate(setup["toks"], max_new_tokens=NEW, temperature=1.0, top_k=5,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)  # same generator seed, same stream


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.0, 0, 0.9), (0.8, 50, 0.5), (1.3, 3, 0.0)])
def test_logit_filter_matches_reference(temperature, top_k, top_p):
    """The temperature / top-k / nucleus filter that sampling draws from."""
    logits = np.random.RandomState(int(temperature * 10) + top_k).randn(3, 128).astype(np.float32)
    ref = np.asarray(jdec._filter_logits(jnp.asarray(logits), temperature, top_k, top_p))
    out = tdec._filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(ref <= -1e29, out <= -1e29)  # same tokens kept
    kept = ref > -1e29
    assert float(np.max(np.abs(ref[kept] - out[kept]))) <= 1e-6


def test_read_geometry_matches_reference():
    for prompt in (1, 5, 10, 16, 33, 100):
        for steps in (0, 1, 7, 40, 200):
            for cache_len in (32, 64, 256, 1024):
                for floor in (None, 16, 128):
                    assert (tdec.read_stages(prompt, steps, cache_len, floor)
                            == jdec.read_stages(prompt, steps, cache_len, floor))
    for n in range(1, 300, 7):
        for cap in (64, 1024):
            for floor in (1, 16, 128):
                assert tdec.read_bucket(n, cap, floor) == jdec.read_bucket(n, cap, floor)
    for total in (10, 200, 1500):
        for mot in (None, 0, 128, 1024):
            assert (tdec.bounded_cache_len(total, 1024, mot)
                    == jdec.bounded_cache_len(total, 1024, mot))


def test_decode_kv_bytes_matches_reference():
    for dtype in ("float32", "bfloat16"):
        a = ttf.TransformerConfig(**dict(CFG, dtype=dtype))
        b = jtf.TransformerConfig(**dict(CFG, dtype=dtype))
        for prompt, new, cache_len, floor in [(10, 40, 64, 16), (10, 40, 64, None),
                                              (128, 128, 1024, 128), (3, 1, 16, 16)]:
            assert (tdec.decode_kv_bytes(a, prompt, new, cache_len, floor)
                    == jdec.decode_kv_bytes(b, prompt, new, cache_len, floor))


@pytest.mark.parametrize("config", [
    {"mesh": {"shape": {"data": 2, "tensor": 1}}},
    {"mesh": {"shape": {"expert": 2}}}, {"profile_model_time": True},
])
def test_features_outside_the_slice_raise(config):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        deepspeed_tpu_torch.init_inference(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                           config=config, device="cpu")


# wall-clock fields of an inference_request event; every other field must
# equal the reference's (compile_cache_hit has no counterpart: the port
# compiles nothing)
_TIMING_FIELDS = {"ts", "total_ms", "ttft_ms", "tokens_per_sec", "decode_tokens_per_sec"}


@pytest.mark.parametrize("over", [{}, {"prefill_chunk_size": 4}], ids=["whole", "chunked"])
def test_inference_request_events_match_the_reference(setup, tmp_path, over):
    """With telemetry on, each generate/forward call emits the reference's
    ``inference_request`` event: the same fields (TTFT where the path has a
    first-token boundary), equal apart from the timings, on the fused,
    chunked, ragged, speculative and forward paths."""
    from deepspeed_tpu_torch.telemetry import read_trace

    params, toks = setup["params"], setup["toks"]
    mask = np.ones_like(toks)
    mask[0, :3] = 0
    events = {}
    for side in ("ref", "port"):
        config = {"dtype": "float32", "attn_impl": "pallas", "kv_read_floor": FLOOR,
                  "telemetry": {"enabled": True,
                                "trace_file": str(tmp_path / f"{side}.jsonl")}, **over}
        if side == "ref":
            eng = deepspeed_tpu.init_inference(jtf.TransformerModel(jtf.TransformerConfig(**CFG)),
                                               params=params, config=config)
            ids = jnp.asarray(toks)
        else:
            eng = deepspeed_tpu_torch.init_inference(
                ttf.TransformerModel(ttf.TransformerConfig(**CFG)), config=config,
                params=params, device="cpu")
            ids = toks
        eng.generate(ids, max_new_tokens=8)
        eng.generate(ids, max_new_tokens=8, attention_mask=mask)
        eng.generate(ids, max_new_tokens=6, draft=eng, num_draft_tokens=2)
        eng.forward(ids)
        eng.telemetry.close()
        events[side] = [e for e in read_trace(str(tmp_path / f"{side}.jsonl"))
                        if e["kind"] == "inference_request"]
    paths = [e["path"] for e in events["port"]]
    assert paths == [e["path"] for e in events["ref"]]
    assert paths == (["chunked_prefill", "chunked_prefill"] if over else ["fused", "ragged"]) + [
        "speculative", "forward"]
    for ref, port in zip(events["ref"], events["port"]):
        assert set(ref) - {"compile_cache_hit"} == set(port), port["path"]
        for key in set(port) - _TIMING_FIELDS:
            assert port[key] == ref[key], (port["path"], key)


def test_speculation_without_a_draft_raises_as_the_reference(setup):
    """``speculative.enabled`` with no draft anywhere fails loudly in both
    packages (ValueError naming the draft and the pooled ngram route), and
    does not fall back to plain decoding."""
    config = {"dtype": "float32", "speculative": {"enabled": True}}
    jeng = deepspeed_tpu.init_inference(jtf.TransformerModel(jtf.TransformerConfig(**CFG)),
                                        params=setup["params"], config=config)
    with pytest.raises(ValueError, match="no draft model") as ref:
        jeng.generate(jnp.asarray(setup["toks"]), max_new_tokens=4)
    eng = _engine(setup["params"], speculative={"enabled": True})
    with pytest.raises(ValueError, match="no draft model") as port:
        eng.generate(setup["toks"], max_new_tokens=4)
    assert "mode='ngram'" in str(port.value) and "mode='ngram'" in str(ref.value)


@pytest.mark.parametrize("config,cfg_dtype,kv", [
    ({"dtype": "int8"}, "bfloat16", "model"),
    ({"quant": {"enabled": True}}, "bfloat16", "model"),
    ({"kv_cache_dtype": "int8"}, "float32", "int8"),
    ({"prefill_chunk_size": 8}, "float32", "model"),
])
def test_slice_features_reach_the_model(setup, config, cfg_dtype, kv):
    """int8 weights (an f32 model runs in bf16, as in the reference), the
    int8 KV cache and chunked prefill build and generate; the full streams
    against the reference are in tests/test_torch_{int8,ragged}_decode.py."""
    eng = _engine(setup["params"], **config)
    assert eng.cfg.dtype == cfg_dtype and eng.cfg.kv_cache_dtype == kv
    wqkv = eng.params["layers"][0]["attn"]["wqkv"]
    assert isinstance(wqkv, dict) == (cfg_dtype == "bfloat16")
    cache = ttf.init_cache(eng.cfg, 2, 16)
    assert isinstance(cache["k"], dict) == (kv == "int8")
    out = eng.generate(setup["toks"], max_new_tokens=NEW)
    assert out.shape == (2, PROMPT + NEW) and bool(((out >= 0) & (out < 128)).all())
    if "prefill_chunk_size" in config:
        _assert_same_stream(setup["ref"][True], out.numpy(), setup["ref_logits"])


def test_ragged_prompts_generate(setup):
    """An all-ones attention_mask takes the ragged path and gives the plain
    stream (left/right padding: tests/test_torch_ragged_decode.py)."""
    out = _engine(setup["params"]).generate(setup["toks"], max_new_tokens=NEW,
                                            attention_mask=np.ones((2, PROMPT)))
    _assert_same_stream(setup["ref"][True], out.numpy(), setup["ref_logits"])


def test_config_parses_like_reference():
    from deepspeed_tpu.inference.config import InferenceConfig as JConfig
    from deepspeed_tpu_torch.inference.config import InferenceConfig as TConfig

    raw = {"dtype": "bfloat16", "attn_impl": "pallas", "max_tokens": 512, "mp_size": 1,
           "kv_read_floor": 64, "telemetry": False}
    assert repr(TConfig.parse(raw)) == repr(JConfig.parse(raw))
    assert repr(TConfig.parse(None)) == repr(JConfig.parse(None))
