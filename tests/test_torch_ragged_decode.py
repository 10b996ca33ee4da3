"""Ragged prompts (``attention_mask``) and chunked prefill
(``prefill_chunk_size``) in the port's ``generate`` against the reference
engine's, in f32 on the CPU, on the same bridged weights (mirroring
``tests/unit/inference/test_chunked_prefill.py`` and
``tests/unit/inference/test_inference.py`` ``TestRaggedGenerate``).

Tolerances: greedy streams are identical, or first differ (row by row; rows
decode independently) at a step where the reference's top-2 logit margin is
under 1e-4, a tie that f32 summation order may break (the rule of
``tests/test_torch_inference_engine.py``). Sampled streams cannot match the
reference's draws (JAX keys against a ``torch.Generator``): the first
sampled token's distribution over many rows is held to total variation
< 0.2 from the reference's filtered distribution (the bar of
``tests/unit/inference/test_spec_pool.py``).
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

# see tests/test_torch_inference_engine.py: settle the single-controller
# check while the environment is clean
comm.comm._maybe_init_multi_controller()

TIE = 1e-4
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           dtype="float32", attn_impl="pallas")
NEW = 8


def _np_params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed),
                                               jtf.TransformerConfig(**cfg)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _ref_engine(cfg, params, **config):
    comm.destroy()
    return deepspeed_tpu.init_inference(jtf.TransformerModel(jtf.TransformerConfig(**cfg)),
                                        params=params, config=dict(config, dtype="float32"))


def _port_engine(cfg, params, **config):
    return deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**cfg)), params=params,
        config=dict(config, dtype="float32"), device="cpu")


def _padded(lens, side, width=None, seed=0):
    """Rows of random tokens of the given lengths, padded to ``width`` on
    one side; pads hold token 0. Returns (tokens, mask, rows)."""
    rs = np.random.RandomState(seed)
    S = width or max(lens)
    rows = [rs.randint(0, 128, (n,)).astype(np.int32) for n in lens]
    toks = np.zeros((len(lens), S), np.int32)
    mask = np.zeros((len(lens), S), np.float32)
    for b, r in enumerate(rows):
        sl = slice(S - len(r), S) if side == "left" else slice(0, len(r))
        toks[b, sl] = r
        mask[b, sl] = 1
    return toks, mask, rows


def _assert_rows_agree(ref_rows, out_rows, ref_logits):
    """``ref_rows``/``out_rows``: per row, the generated tokens;
    ``ref_logits``: per row, the reference's logits that chose each."""
    for b, (ref, out, logits) in enumerate(zip(ref_rows, out_rows, ref_logits)):
        diff = np.nonzero(np.asarray(ref) != np.asarray(out))[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        top2 = np.sort(logits[j])[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"row {b} differs at step {j} (reference margin {margin:.3g})"


def _gen_logits(jeng, rows, gens):
    """The reference's logits that chose each generated token of each row,
    from a full forward over the row's own unpadded stream."""
    out = []
    for r, g in zip(rows, gens):
        stream = np.concatenate([r, np.asarray(g)])[None]
        logits = np.asarray(jtf.apply(jeng.params, jeng.cfg, jnp.asarray(stream)))[0]
        out.append(logits[len(r) - 1:len(r) - 1 + len(g)])
    return out


def _generated(result, S):
    return [row[S:] for row in np.asarray(result)]


@pytest.fixture(scope="module")
def params():
    return _np_params(CFG)


@pytest.fixture(scope="module")
def ref_ragged(params):
    """The reference engine's ragged streams, left and right padded."""
    out = {}
    for side in ("left", "right"):
        toks, mask, rows = _padded([5, 9, 3], side)
        eng = _ref_engine(CFG, params)
        res = np.asarray(eng.generate(jnp.asarray(toks), max_new_tokens=NEW, attention_mask=mask))
        gens = _generated(res, toks.shape[1])
        out[side] = (toks, mask, rows, res, _gen_logits(eng, rows, gens))
    comm.destroy()
    return out


@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("side", ["left", "right"])
def test_ragged_matches_reference(params, ref_ragged, side, tight):
    toks, mask, rows, ref, logits = ref_ragged[side]
    eng = _port_engine(CFG, params, kv_read_floor=16, kv_tight_read=tight)
    out = eng.generate(toks, max_new_tokens=NEW, attention_mask=mask)
    assert out.shape == ref.shape and out.dtype == torch.int32
    np.testing.assert_array_equal(out[:, :toks.shape[1]].numpy(), toks)  # prompt as given
    _assert_rows_agree(_generated(ref, toks.shape[1]), _generated(out, toks.shape[1]), logits)


@pytest.mark.parametrize("side", ["left", "right"])
def test_padded_rows_equal_each_row_alone(params, ref_ragged, side):
    """The reference's own test: each padded row continues as it would
    generated alone, unpadded."""
    toks, mask, rows, _, logits = ref_ragged[side]
    eng = _port_engine(CFG, params)
    out = _generated(eng.generate(toks, max_new_tokens=NEW, attention_mask=mask), toks.shape[1])
    solo = [eng.generate(r[None], max_new_tokens=NEW)[0, len(r):].numpy() for r in rows]
    _assert_rows_agree(solo, out, logits)


def test_full_mask_matches_plain(params):
    eng = _port_engine(CFG, params)
    toks = np.random.RandomState(1).randint(0, 128, (2, 7)).astype(np.int32)
    plain = eng.generate(toks, max_new_tokens=6)
    ragged = eng.generate(toks, max_new_tokens=6, attention_mask=np.ones((2, 7), np.float32))
    assert torch.equal(plain, ragged)


def test_max_length_padding_allowed(params):
    """Padded width == max_seq_len is legal when the real prompts and the new
    tokens fit: capacity follows the longest real prompt."""
    eng = _port_engine(CFG, params)
    S = CFG["max_seq_len"]
    toks, mask, rows = _padded([6, 3], "left", width=S, seed=2)
    out = eng.generate(toks, max_new_tokens=4, attention_mask=mask)
    assert out.shape == (2, S + 4)
    for b, r in enumerate(rows):
        assert torch.equal(out[b, S:], eng.generate(r[None], max_new_tokens=4)[0, len(r):])
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(toks, max_new_tokens=S, attention_mask=mask)


def test_bad_masks_raise(params):
    eng = _port_engine(CFG, params)
    toks = np.ones((2, 5), np.int32)
    with pytest.raises(ValueError, match="real token"):
        eng.generate(toks, max_new_tokens=2, attention_mask=np.array([[1] * 5, [0] * 5]))
    with pytest.raises(ValueError, match="shape"):
        eng.generate(toks, max_new_tokens=2, attention_mask=np.ones((2, 4)))


def test_ragged_eos_truncation_matches_reference(params, ref_ragged):
    toks, mask, rows, ref, _ = ref_ragged["left"]
    S = toks.shape[1]
    eos = int(ref[0, S + 2])
    jeng = _ref_engine(CFG, params)
    ref_eos = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=NEW,
                                       attention_mask=mask, eos_token_id=eos))
    comm.destroy()
    out = _port_engine(CFG, params).generate(toks, max_new_tokens=NEW, attention_mask=mask,
                                             eos_token_id=eos)
    np.testing.assert_array_equal(ref_eos, out.numpy())


def test_ragged_sampling_distribution_matches_reference(params):
    """First sampled token of two left-padded prompts, each repeated over
    200 rows (temperature 0.8, top-k 5): each row's histogram against the
    reference's filtered softmax of that row's last real logits."""
    toks2, mask2, rows = _padded([9, 4], "left", seed=4)
    n = 200
    toks, mask = np.repeat(toks2, n, axis=0), np.repeat(mask2, n, axis=0)
    eng = _port_engine(CFG, params)
    out = eng.generate(toks, max_new_tokens=1, temperature=0.8, top_k=5,
                       generator=torch.Generator().manual_seed(0), attention_mask=mask)
    first = out[:, -1].numpy().reshape(2, n)
    jeng = _ref_engine(CFG, params)
    for b, r in enumerate(rows):
        logits = np.asarray(jtf.apply(jeng.params, jeng.cfg, jnp.asarray(r[None])))[:, -1]
        p = np.asarray(jax.nn.softmax(jdec._filter_logits(jnp.asarray(logits), 0.8, 5, 1.0)))[0]
        hist = np.bincount(first[b], minlength=128) / n
        tv = 0.5 * float(np.abs(hist - p).sum())
        assert tv < 0.2, f"row {b}: total variation {tv:.3f}"
        assert set(np.nonzero(hist)[0]) <= set(np.argsort(p)[-5:])
    comm.destroy()


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt_len,chunk", [(16, 8), (13, 8), (5, 8), (8, 8), (13, 1)],
                         ids=["even", "ragged-tail", "prompt-lt-chunk", "exact", "chunk-1"])
def test_chunked_greedy_matches_plain_and_reference(params, prompt_len, chunk):
    toks = np.random.RandomState(0).randint(0, 128, (2, prompt_len)).astype(np.int32)
    jeng = _ref_engine(CFG, params, prefill_chunk_size=chunk)
    ref = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=NEW))
    logits = _gen_logits(jeng, list(toks), _generated(ref, prompt_len))
    comm.destroy()
    chunked = _port_engine(CFG, params, prefill_chunk_size=chunk)
    out = chunked.generate(toks, max_new_tokens=NEW)
    assert out.shape == (2, prompt_len + NEW)
    _assert_rows_agree(_generated(ref, prompt_len), _generated(out, prompt_len), logits)
    plain = _port_engine(CFG, params).generate(toks, max_new_tokens=NEW)
    _assert_rows_agree(_generated(plain, prompt_len), _generated(out, prompt_len), logits)


@pytest.mark.parametrize("side,chunk", [("right", 8), ("left", 8), ("left", 4), ("right", 6)])
def test_chunked_with_attention_mask_matches_reference(params, side, chunk):
    """Varied-width padded batches through the chunks; ("left", 4) leaves
    two chunks of pads only, which are skipped."""
    toks = np.random.RandomState(3).randint(0, 128, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.float32)
    if side == "right":
        mask[1, 13:] = 0
    else:
        mask[0, :8] = 0
        mask[1, :12] = 0
    jeng = _ref_engine(CFG, params, prefill_chunk_size=chunk)
    ref = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=6, attention_mask=mask))
    rows = [toks[b][mask[b] > 0] for b in range(2)]
    logits = _gen_logits(jeng, rows, _generated(ref, 20))
    comm.destroy()
    out = _port_engine(CFG, params, prefill_chunk_size=chunk).generate(
        toks, max_new_tokens=6, attention_mask=mask)
    np.testing.assert_array_equal(out[:, :20].numpy(), toks)
    _assert_rows_agree(_generated(ref, 20), _generated(out, 20), logits)
    unchunked = _port_engine(CFG, params).generate(toks, max_new_tokens=6, attention_mask=mask)
    _assert_rows_agree(_generated(unchunked, 20), _generated(out, 20), logits)


def test_all_pad_chunks_are_skipped(params, monkeypatch):
    calls = []
    real = tdec.compile_ragged_prefill_fn

    def counting(mesh, cfg, B, T):
        fn = real(mesh, cfg, B, T)

        def wrapped(p, t, pos, cache):
            calls.append(t.shape)
            return fn(p, t, pos, cache)
        return wrapped

    monkeypatch.setattr("deepspeed_tpu_torch.inference.engine.compile_ragged_prefill_fn",
                        counting)
    toks = np.ones((2, 20), np.int32)
    mask = np.ones((2, 20), np.float32)
    mask[0, :8] = 0
    mask[1, :12] = 0
    _port_engine(CFG, params, prefill_chunk_size=4).generate(toks, max_new_tokens=2,
                                                            attention_mask=mask)
    assert calls == [(2, 4)] * 3  # chunks 0 and 1 hold pads only


@pytest.mark.parametrize("chunk", [8, 3])
def test_chunked_composes_with_int8_kv(chunk):
    """Chunked prefill writes the int8 cache through the scatter write (GQA,
    RMSNorm, no biases), against the reference's chunked int8-KV engine and
    the port's unchunked int8-KV engine."""
    cfg = dict(CFG, norm_type="rmsnorm", use_bias=False, num_kv_heads=2)
    params = _np_params(cfg, seed=5)
    toks = np.random.RandomState(2).randint(0, 128, (2, 20)).astype(np.int32)
    config = {"prefill_chunk_size": chunk, "kv_cache_dtype": "int8"}
    jeng = _ref_engine(cfg, params, **config)
    ref = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=6))
    comm.destroy()
    out = _port_engine(cfg, params, **config).generate(toks, max_new_tokens=6)
    # the int8 cache holds the quantized keys, which a full forward does not
    # see: ties are read from the port's own step logits of the plain path
    plain_eng = _port_engine(cfg, params, kv_cache_dtype="int8")
    plain = plain_eng.generate(toks, max_new_tokens=6)
    logits = _step_logits(plain_eng, toks, plain.numpy())
    _assert_rows_agree(_generated(ref, 20), _generated(out, 20), logits)
    _assert_rows_agree(_generated(plain, 20), _generated(out, 20), logits)


def _step_logits(eng, toks, stream):
    """The logits that chose each generated token, teacher-forced through
    the engine's cached path (prefill, then one step a token)."""
    B, S = toks.shape
    cache = ttf.init_cache(eng.cfg, B, eng.cfg.max_seq_len)
    with torch.inference_mode():
        logits, cache = ttf.forward_with_cache(eng.params, eng.cfg, torch.from_numpy(toks).long(),
                                               cache, 0)
        out = [logits[:, -1]]
        for j in range(stream.shape[1] - S - 1):
            step, cache = ttf.forward_with_cache(
                eng.params, eng.cfg, torch.from_numpy(stream[:, S + j:S + j + 1]).long(), cache,
                S + j)
            out.append(step[:, -1])
    return list(torch.stack(out, dim=1).numpy())
