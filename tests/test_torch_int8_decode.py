"""The int8 decode path of the port (int8 weights run as W8A8, the int8 KV
cache) against the reference, on the CPU, on the same seeded numpy inputs:
the cache's quantize/dequantize and writes, the cached attention over int8
caches, the cache's byte accounting, the engine's int8 storage, the fused
``wqkv`` int8 product, and greedy token streams.

Tolerances:
- bit for bit: ``quantize_kv``/``dequantize_kv``, the int8 cache writes,
  the engine's int8 weights and scales, and the fused ``wqkv`` product
  against the reference's three products (f32 arithmetic in the same order,
  int8 products summed exactly in int32);
- 1e-5 absolute: attention over int8 caches (f32 both sides, another
  summation order, as ``tests/test_torch_inference_ops.py``);
- f32 greedy streams (int8 KV; int8 weights at the model level with f32
  activations): identical, or first differing at a step where the
  reference's top-2 logit margin is under 1e-4 (a tie that summation order
  may break; ``tests/test_torch_inference_engine.py``'s rule);
- bf16 greedy streams (``dtype="int8"`` runs the model in bf16, as the
  reference does): identical, or first differing where the reference's
  top-2 margin is under 2 x ``TOL_BF16``. ``TOL_BF16`` bounds the
  teacher-forced logits' difference: XLA rounds to bf16 after every op of
  GELU and of the residual stream where PyTorch rounds some chains once,
  which moves logits of magnitude < 8 by a few bf16 steps (2^-5 there).
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
from deepspeed_tpu.ops.transformer import inference_ops as jops
from deepspeed_tpu_torch.inference import decoding as tdec
from deepspeed_tpu_torch.inference import engine as teng
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

# see tests/test_torch_inference_engine.py: settle the single-controller
# check while the environment is clean
comm.comm._maybe_init_multi_controller()

TOL = 1e-5
TIE_F32 = 1e-4
TOL_BF16 = 0.125
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           dtype="float32")
PROMPT, NEW = 10, 40


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _int8_cache(B=2, T=16, H=2, hd=8):
    return ({"q8": np.zeros((B, T, H, hd), np.int8), "s": np.zeros((B, T, H, 1), np.float32)},
            {"q8": np.zeros((B, T, H, hd), np.int8), "s": np.zeros((B, T, H, 1), np.float32)})


def _to_j(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _to_t(c):
    return {k: torch.from_numpy(v.copy()) for k, v in c.items()}


def _same_cache(ref, out):
    for name in ("q8", "s"):
        np.testing.assert_array_equal(np.asarray(ref[name]), out[name].numpy())


# ---------------------------------------------------------------------------
# ops: quantize_kv / dequantize_kv, the int8 writes, the int8 read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise(dtype):
    rs = np.random.RandomState(0)
    x = _rand(rs, 2, 5, 3, 16) * 3
    x[0, 0, 0] = 0.0  # an all-zero head: scale floored at 1e-8
    x[1, 2, 1, :3] = [127.0, -63.5, 0.5]  # a row whose halves round to even
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rq, rs_ = jops.quantize_kv(jx)
    q, s = tops.quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(np.asarray(rq), q.numpy())
    np.testing.assert_array_equal(np.asarray(rs_), s.numpy())
    ref = jops.dequantize_kv({"q8": rq, "s": rs_}, jx.dtype)
    out = tops.dequantize_kv({"q8": q, "s": s}, tx.dtype)
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(_jnp(ref), _np(out))


@pytest.mark.parametrize("pos,S", [(0, 5), (3, 5), (15, 1), (14, 5)])
def test_int8_cache_write_contiguous(pos, S):
    """Scalar pos; (14, 5) overruns T=16 and is clamped to fit, as
    lax.dynamic_update_slice clamps."""
    rs = np.random.RandomState(pos + 10 * S)
    kc, vc = _int8_cache()
    kn, vn = _rand(rs, 2, S, 2, 8), _rand(rs, 2, S, 2, 8)
    ref_k, ref_v = jops.update_kv_cache(_to_j(kc), _to_j(vc), jnp.asarray(kn), jnp.asarray(vn),
                                        pos)
    out_k, out_v = tops.update_kv_cache(_to_t(kc), _to_t(vc), torch.from_numpy(kn),
                                        torch.from_numpy(vn), pos)
    _same_cache(ref_k, out_k)
    _same_cache(ref_v, out_v)


def test_int8_cache_write_scatter_drops_out_of_range():
    """Vector pos with per-row positions; columns at or past T drop."""
    rs = np.random.RandomState(1)
    kc, vc = _int8_cache()
    kn, vn = _rand(rs, 2, 3, 2, 8), _rand(rs, 2, 3, 2, 8)
    pos = np.array([4, 14], np.int32)
    positions = pos[:, None] + np.arange(3, dtype=np.int32)[None]  # row 1 runs past T=16
    positions[0, 2] = 16  # a parked pad column: dropped
    ref_k, ref_v = jops.update_kv_cache(_to_j(kc), _to_j(vc), jnp.asarray(kn), jnp.asarray(vn),
                                        jnp.asarray(pos), jnp.asarray(positions))
    out_k, out_v = tops.update_kv_cache(_to_t(kc), _to_t(vc), torch.from_numpy(kn),
                                        torch.from_numpy(vn), torch.from_numpy(pos).long(),
                                        torch.from_numpy(positions).long())
    _same_cache(ref_k, out_k)
    _same_cache(ref_v, out_v)
    assert int((out_k["q8"][0, 6] != 0).sum()) == 0  # the pad never landed


def test_int8_cache_write_in_place():
    kc, vc = (_to_t(c) for c in _int8_cache())
    ptrs = (kc["q8"].data_ptr(), kc["s"].data_ptr())
    k_out, _ = tops.update_kv_cache(kc, vc, torch.ones(2, 1, 2, 8), torch.ones(2, 1, 2, 8), 3)
    assert (k_out["q8"].data_ptr(), k_out["s"].data_ptr()) == ptrs
    assert bool((kc["q8"][:, 3] == 127).all())
    assert torch.equal(kc["s"][:, 3], torch.full((2, 2, 1), 1.0 / 127.0))


def _filled_int8_cache(rs, T=16):
    kc, vc = _rand(rs, 2, T, 2, 8), _rand(rs, 2, T, 2, 8)
    out = []
    for c in (kc, vc):
        q, s = jops.quantize_kv(jnp.asarray(c))
        out.append({"q8": np.asarray(q), "s": np.asarray(s)})
    return out


@pytest.mark.parametrize("read_len", [None, 8])
@pytest.mark.parametrize("mode", ["scalar", "vector", "prefix"])
def test_softmax_context_int8_matches_reference(mode, read_len):
    """GQA (4 query heads over 2 kv heads), dequantized at the read; a tight
    read of 8 slots covers every attended position."""
    rs = np.random.RandomState(len(mode) + (read_len or 0))
    kc, vc = _filled_int8_cache(rs)
    S = 1 if mode == "prefix" else 3
    q = _rand(rs, 2, S, 4, 8)
    if mode == "scalar":
        pos, positions = 4, np.broadcast_to(4 + np.arange(S, dtype=np.int32), (2, S)).copy()
    elif mode == "vector":
        pos = np.array([2, 5], np.int32)
        positions = pos[:, None] + np.arange(S, dtype=np.int32)[None]
    else:
        pos, positions = 6, None
    ref = jops.softmax_context(
        jnp.asarray(q), _to_j(kc), _to_j(vc), jnp.asarray(pos) if mode == "vector" else pos,
        positions=None if positions is None else jnp.asarray(positions), read_len=read_len)
    out = tops.softmax_context(
        torch.from_numpy(q), _to_t(kc), _to_t(vc),
        torch.from_numpy(pos).long() if mode == "vector" else pos,
        positions=None if positions is None else torch.from_numpy(positions).long(),
        read_len=read_len)
    assert out.shape == (2, S, 4, 8)
    assert float(np.max(np.abs(np.asarray(ref) - out.numpy()))) <= TOL


def test_slice_kv_time_int8_views():
    kc = _to_t(_int8_cache()[0])
    view = tops.slice_kv_time(kc, 4)
    assert view["q8"].shape == (2, 4, 2, 8) and view["s"].shape == (2, 4, 2, 1)
    assert view["q8"].data_ptr() == kc["q8"].data_ptr()
    assert tops.slice_kv_time(kc, None) is kc


# ---------------------------------------------------------------------------
# the model's cache and its byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [{}, {"num_kv_heads": 2}])
def test_init_cache_int8_like_reference(over):
    cfg = dict(CFG, kv_cache_dtype="int8", **over)
    ref = jtf.init_cache(jtf.TransformerConfig(**cfg), 3, 24)
    out = ttf.init_cache(ttf.TransformerConfig(**cfg), 3, 24, device="cpu")
    for kv in ("k", "v"):
        for name in ("q8", "s"):
            assert tuple(out[kv][name].shape) == tuple(ref[kv][name].shape)
            assert str(out[kv][name].dtype).split(".")[-1] == str(ref[kv][name].dtype)
    assert ttf.cache_alloc_len(out) == jtf.cache_alloc_len(ref) == 24
    dense = ttf.init_cache(ttf.TransformerConfig(**dict(cfg, kv_cache_dtype="model",
                                                         dtype="bfloat16")), 3, 24)
    nbytes = sum(t.numel() * t.element_size() for c in out.values() for t in c.values())
    dense_bytes = sum(t.numel() * t.element_size() for t in dense.values())
    hd = 64 // 4
    assert nbytes * 2 * hd == dense_bytes * (hd + 4)  # (hd + 4) / (2 hd) of the bf16 cache


def test_kv_bytes_int8_match_reference():
    for over in ({}, {"num_kv_heads": 2}):
        a = ttf.TransformerConfig(**dict(CFG, kv_cache_dtype="int8", **over))
        b = jtf.TransformerConfig(**dict(CFG, kv_cache_dtype="int8", **over))
        for r in (1, 16, 48):
            assert ttf.kv_read_bytes_per_row(a, r) == jtf.kv_read_bytes_per_row(b, r)
        for prompt, new, cache_len, floor in [(10, 40, 64, 16), (10, 40, 64, None),
                                              (128, 128, 256, 128), (3, 1, 16, 16)]:
            assert (tdec.decode_kv_bytes(a, prompt, new, cache_len, floor)
                    == jdec.decode_kv_bytes(b, prompt, new, cache_len, floor))


def test_kv_cache_dtype_is_checked():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        deepspeed_tpu_torch.init_inference(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                           config={"kv_cache_dtype": "fp8"}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttf.init(torch.Generator().manual_seed(0),
                 ttf.TransformerConfig(**dict(CFG, kv_cache_dtype="fp8")))


# ---------------------------------------------------------------------------
# int8 weights: the engine's storage and the fused wqkv product
# ---------------------------------------------------------------------------

def _np_params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed),
                                               jtf.TransformerConfig(**cfg)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _ref_engine(cfg, params, **config):
    comm.destroy()
    return deepspeed_tpu.init_inference(jtf.TransformerModel(jtf.TransformerConfig(**cfg)),
                                        params=params, config=config)


def _port_engine(cfg, params, **config):
    return deepspeed_tpu_torch.init_inference(ttf.TransformerModel(ttf.TransformerConfig(**cfg)),
                                              params=params, config=config, device="cpu")


@pytest.mark.parametrize("tie", [True, False])
def test_engine_stores_int8_where_the_reference_does(tie):
    """Mirrors tests/unit/inference/test_inference.py TestRealInt8: every
    attn/mlp matmul weight and the untied lm head are int8 with an f32
    scale; embeddings, norms and biases stay in the model dtype (bf16). The
    integers and scales equal the reference's, wqkv's rows being wq|wk|wv's
    columns."""
    cfg = dict(CFG, tie_embeddings=tie)
    params = _np_params(cfg)
    ref = jax.tree.map(np.asarray, _ref_engine(cfg, params, dtype="int8").params)
    out = _port_engine(cfg, params, dtype="int8")
    assert out.cfg.dtype == "bfloat16"
    named = {}
    teng._map_with_path(lambda path, t: named.__setitem__(".".join(map(str, path)), t), out.params)
    q8 = {k for k, t in named.items() if t.dtype == torch.int8}
    want = {f"layers.{i}.{n}.q8" for i in range(2)
            for n in ("attn.wqkv", "attn.wo", "mlp.wi", "mlp.wo")}
    assert q8 == want | (set() if tie else {"lm_head.w.q8"})
    assert {k for k, t in named.items() if t.dtype == torch.float32} == {
        k[:-2] + "s" for k in q8}
    assert all(t.dtype == torch.bfloat16 for k, t in named.items()
               if not k.endswith((".q8", ".s")))
    ly = ref["layers"]
    for i, layer in enumerate(out.params["layers"]):
        qkv_q8 = np.concatenate([ly["attn"][n]["q8"][i] for n in ("wq", "wk", "wv")], axis=1)
        qkv_s = np.concatenate([ly["attn"][n]["s"][i] for n in ("wq", "wk", "wv")], axis=1)
        np.testing.assert_array_equal(layer["attn"]["wqkv"]["q8"].numpy(), qkv_q8.T)
        np.testing.assert_array_equal(layer["attn"]["wqkv"]["s"].numpy(), qkv_s.reshape(-1))
        for grp, name in (("attn", "wo"), ("mlp", "wi"), ("mlp", "wo")):
            np.testing.assert_array_equal(layer[grp][name]["q8"].numpy(),
                                          ly[grp][name]["q8"][i].T)
            np.testing.assert_array_equal(layer[grp][name]["s"].numpy(),
                                          ly[grp][name]["s"][i].reshape(-1))
    if not tie:
        np.testing.assert_array_equal(out.params["lm_head"]["w"]["q8"].numpy(),
                                      ref["lm_head"]["w"]["q8"].T)
    toks = np.random.RandomState(0).randint(0, 128, (2, 6))
    gen = out.generate(toks, max_new_tokens=4)
    assert gen.shape == (2, 10) and bool(((gen >= 0) & (gen < 128)).all())


def test_fake_quant_storage_matches_the_reference():
    """quant.num_bits != 8: fake-quant storage with the reference's group
    rule over its stacked layout, bit for bit in bf16."""
    cfg = dict(CFG, tie_embeddings=False, lm_head_bias=True)
    params = _np_params(cfg, seed=1)
    config = {"quant": {"enabled": True, "num_bits": 4}}
    ref = jax.tree.map(_jnp, _ref_engine(cfg, params, **config).params)
    out = _port_engine(cfg, params, **config)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(out.params))
    back = ttf.params_to_numpy(out.params, out.cfg)
    jax.tree.map(np.testing.assert_array_equal, ref, back)
    plain = ttf.params_to_numpy(_port_engine(cfg, params, dtype="bfloat16").params, out.cfg)
    assert not np.array_equal(plain["layers"]["attn"]["wq"], back["layers"]["attn"]["wq"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_wqkv_int8_product_equals_three_reference_products(dtype):
    """Per-output-channel weight scales and a per-row activation scale: the
    fused product's q, k and v blocks equal the reference's three calls bit
    for bit (GQA widths: q 64, k 32, v 32)."""
    rs = np.random.RandomState(3)
    D = 64
    h = _rand(rs, 2, 5, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    from deepspeed_tpu.ops.quantizer import int8_linear, quantize_per_channel
    refs, q8s, ss = [], [], []
    for width in (64, 32, 32):
        q8, s = quantize_per_channel(jnp.asarray(_rand(rs, D, width)), axis=1)
        refs.append(_jnp(int8_linear(jnp.asarray(h, jd), q8, s)))
        q8s.append(np.asarray(q8).T)
        ss.append(np.asarray(s).reshape(-1))
    w = {"q8": torch.from_numpy(np.concatenate(q8s)), "s": torch.from_numpy(np.concatenate(ss))}
    out = ttf._linear(torch.from_numpy(h).to(td), w)
    for ref, part in zip(refs, out.split([64, 32, 32], dim=-1)):
        np.testing.assert_array_equal(ref, _np(part))


def test_int8_linear_bias_after_the_cast():
    """The reference adds the bias to the product rounded to bf16; adding it
    before the rounding (as F.linear does) would differ by an ulp."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(_rand(rs, 6, 32)).bfloat16()
    w = tq.quantize_weight(torch.from_numpy(_rand(rs, 16, 32)))
    b = torch.from_numpy(_rand(rs, 16)).bfloat16()
    out = ttf._linear(x, w, b)
    assert torch.equal(out, tq.int8_linear(x, w["q8"], w["s"]) + b)


# ---------------------------------------------------------------------------
# greedy token streams
# ---------------------------------------------------------------------------

def _assert_greedy_agrees(ref, out, ref_logits, tie):
    """Rows decode independently: each row's stream equals the reference's,
    or first differs at a step whose reference top-2 margin is under
    ``tie`` (the rest of that row is then not compared)."""
    assert ref.shape == out.shape
    for b in range(ref.shape[0]):
        diff = np.nonzero(ref[b, PROMPT:] != out[b, PROMPT:])[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        top2 = np.sort(ref_logits[b, PROMPT - 1 + j])[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < tie, f"row {b} differs at step {j} (reference margin {margin:.3g})"


@pytest.fixture(scope="module")
def engines():
    params = _np_params(CFG)
    toks = np.random.RandomState(1).randint(0, 128, (2, PROMPT)).astype(np.int32)
    cases = {"weights": {"dtype": "int8"},
             "kv": {"dtype": "float32", "kv_cache_dtype": "int8"},
             "both": {"dtype": "int8", "kv_cache_dtype": "int8"}}
    out = {}
    for name, config in cases.items():
        config = dict(config, attn_impl="pallas", kv_read_floor=16)
        je = _ref_engine(CFG, params, **config)
        ref = np.asarray(je.generate(jnp.asarray(toks), max_new_tokens=NEW))
        logits = _jnp(jtf.apply(je.params, je.cfg, jnp.asarray(ref)))
        out[name] = (config, ref, logits)
    comm.destroy()
    yield params, toks, out


@pytest.mark.parametrize("case", ["weights", "kv", "both"])
def test_engine_greedy_matches_reference(engines, case):
    params, toks, cases = engines
    config, ref, logits = cases[case]
    eng = _port_engine(CFG, params, **config)
    out = eng.generate(toks, max_new_tokens=NEW)
    assert out.shape == (2, PROMPT + NEW) and out.dtype == torch.int32
    bf16 = config["dtype"] == "int8"
    _assert_greedy_agrees(ref, out.numpy(), logits, 2 * TOL_BF16 if bf16 else TIE_F32)
    # teacher-forced on the reference's stream: the whole-sequence logits
    diff = float(np.max(np.abs(logits - _np(eng.forward(ref)))))
    assert diff <= (TOL_BF16 if bf16 else 1e-4), diff


def _ref_greedy(params, cfg, toks, new, cache_len):
    cache = jtf.init_cache(cfg, toks.shape[0], cache_len)
    logits, cache = jtf.forward_with_cache(params, cfg, jnp.asarray(toks), cache, 0)
    last = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    out, pos = [last], toks.shape[1]
    for _ in range(new - 1):
        logits, cache = jtf.forward_with_cache(params, cfg, last[:, None], cache, jnp.int32(pos))
        last = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out.append(last)
        pos += 1
    return np.concatenate([toks, np.stack([np.asarray(t) for t in out], axis=1)], axis=1)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_int8_weights_greedy_in_f32_matches_reference(kv):
    """The sharp check of the W8A8 path: int8 weights with f32 activations
    at the model level (the engine runs int8 weights in bf16 only), each
    package quantizing the same f32 weights by its own engine rule; the
    port's ``compile_generate_fn`` against the reference's cached forward."""
    cfg = dict(CFG, tie_embeddings=False, kv_cache_dtype=kv)
    params = _np_params(cfg, seed=2)
    je = _ref_engine(cfg, params, dtype="float32")
    jparams, _ = je._quantize_weights(je.params)
    jcfg, tcfg = jtf.TransformerConfig(**cfg), ttf.TransformerConfig(**cfg)
    tparams = teng.quantize_weights(ttf.params_from_numpy(params, tcfg, "cpu"))
    toks = np.random.RandomState(3).randint(0, 128, (2, PROMPT)).astype(np.int32)
    ref = _ref_greedy(jparams, jcfg, toks, NEW, 64)
    fn = tdec.compile_generate_fn(tcfg, 2, 64, NEW, 0.0, 0, 1.0, read_floor=16)
    with torch.inference_mode():
        out = fn(tparams, torch.from_numpy(toks).long(), ttf.init_cache(tcfg, 2, 64), None)
        logits = _np(ttf.apply(tparams, tcfg, torch.from_numpy(ref).long()))
    ref_logits = _jnp(jtf.apply(jparams, jcfg, jnp.asarray(ref)))
    comm.destroy()
    assert float(np.max(np.abs(ref_logits - logits))) <= 1e-4
    _assert_greedy_agrees(ref, out.numpy(), ref_logits, TIE_F32)
