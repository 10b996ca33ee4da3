"""The port's serving-tick programs against the reference's, in f32 on the
CPU, on the same bridged weights and the same inputs: ``compile_pool_tick_fn``
(burst k = 1 and k = 4, fused prefill chunks W = 16 and 32, parked rows, quota
and EOS stops, a tight-read bucket) and ``compile_row_update_fn``, mirroring
``deepspeed_tpu/inference/decoding.py:485-644``. The packed result (tokens,
emitted counts, done flags) and the threaded state must be equal; the cache
within f32 rounding (1e-5), as the two packages sum in different orders.

Also the cache write at vector positions (``inference_ops.update_kv_cache``)
against the write it replaced, kept here as plain code: the old write found
the in-range columns with ``nonzero`` (a host sync a layer). The new one
must give the same cache bit for bit: random positions, parked columns at T
and beyond and below 0, a real write at T-1 in the same row as parked
columns, rows with no real column, in the model dtype and the int8 cache.
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
from deepspeed_tpu_torch.ops.transformer import inference_ops as tio

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128,
           dtype="float32")
B, T = 4, 128
CACHE_TOL = 1e-5


@pytest.fixture(scope="module")
def engines():
    comm.destroy()
    jcfg = jtf.TransformerConfig(**CFG)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)
    jeng = deepspeed_tpu.init_inference(jtf.TransformerModel(jcfg), params=params,
                                        config={"dtype": "float32"})
    peng = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(ttf.TransformerConfig(**CFG)),
                                              params=params, config={"dtype": "float32"},
                                              device="cpu")
    return jeng, peng


def _cache(seed=1):
    """A random cache, as though rows had been prefilled."""
    rs = np.random.RandomState(seed)
    shape = (CFG["num_layers"], B, T, CFG["num_heads"], CFG["hidden_size"] // CFG["num_heads"])
    return {n: (0.5 * rs.randn(*shape)).astype(np.float32) for n in ("k", "v")}


def _rows():
    """Row state of a tick: rows 0, 1, 3 decode (row 1 stops at its quota
    inside a k = 4 burst), row 2 is parked (free, done, pos = T)."""
    return dict(last_tok=np.array([5, 17, 0, 99], np.int32),
                done=np.array([0, 0, 1, 0], np.int32),
                pos=np.array([5, 20, T, 40], np.int32),
                gen=np.array([0, 3, 0, 7], np.int32),
                quota=np.array([8, 5, 0, 12], np.int32),
                rids=np.array([0, 1, 2, 3], np.int32))


def _chunk(W, nreal, cpos0=0, seed=2):
    toks = np.zeros(W, np.int32)
    toks[:nreal] = np.random.RandomState(seed).randint(0, 128, nreal)
    pos = np.full(W, T, np.int32)
    pos[:nreal] = np.arange(cpos0, cpos0 + nreal)
    return toks, pos


def _ref_tick(jeng, k, eos, read_len, chunk, rows, cache, extra):
    fn, cache_sh, _ = jdec.compile_pool_tick_fn(
        jeng.mesh, jeng.cfg, jeng.param_shardings, B, T, k, 0.0, 0, 1.0, eos_token_id=eos,
        read_len=read_len, chunk=chunk, donate=False)
    jc = jax.device_put({n: jnp.asarray(a) for n, a in cache.items()}, cache_sh)
    args = [jeng.params, jc] + [jnp.asarray(rows[n]) for n in
                                ("last_tok", "done", "pos", "gen", "quota", "rids")]
    args.append(jax.random.PRNGKey(0))
    if chunk is not None:
        ctoks, cpos, aslot, col, mask = extra
        args += [jnp.asarray(ctoks), jnp.asarray(cpos), aslot, jnp.asarray(col),
                 jnp.asarray(mask)]
    packed, jc, lt, dn = fn(*args)
    return (np.asarray(packed), {n: np.asarray(a) for n, a in jc.items()}, np.asarray(lt),
            np.asarray(dn))


def _port_tick(peng, k, eos, read_len, chunk, rows, cache, extra):
    fn = tdec.compile_pool_tick_fn(peng.cfg, B, T, k, 0.0, 0, 1.0, eos_token_id=eos,
                                   read_len=read_len, chunk=chunk)[0]
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    t = {n: torch.from_numpy(a.copy()) for n, a in rows.items()}
    args = [peng.params, tc, t["last_tok"], t["done"], t["pos"].long(), t["gen"], t["quota"],
            t["rids"], 0]
    if chunk is not None:
        ctoks, cpos, aslot, col, mask = extra
        args += [torch.from_numpy(ctoks).long(), torch.from_numpy(cpos).long(), aslot,
                 torch.from_numpy(col), torch.from_numpy(mask)]
    with torch.inference_mode():
        packed, tc, lt, dn = fn(*args)
    # in place: the threaded state and the cache are the tensors passed in
    assert lt is args[2] and dn is args[3] and tc["k"] is args[1]["k"]
    return packed.numpy(), {n: a.numpy() for n, a in tc.items()}, lt.numpy(), dn.numpy()


def _assert_same(ref, port):
    rp, rc, rlt, rdn = ref
    pp, pc, plt, pdn = port
    np.testing.assert_array_equal(pp, rp)
    np.testing.assert_array_equal(plt, rlt)
    np.testing.assert_array_equal(pdn, rdn)
    for n in rc:
        np.testing.assert_allclose(pc[n], rc[n], rtol=CACHE_TOL, atol=CACHE_TOL)


@pytest.mark.parametrize("k,read_len,with_eos", [(1, None, False), (1, 64, False),
                                                 (4, None, False), (4, 64, False),
                                                 (4, 64, True)])
def test_burst_tick_matches_reference(engines, k, read_len, with_eos):
    jeng, peng = engines
    rows, cache = _rows(), _cache()
    eos = None
    if with_eos:
        # row 3's second token in the run without EOS: it stops mid-burst
        eos = int(_ref_tick(jeng, k, None, read_len, None, rows, cache, None)[0][3, 1])
    ref = _ref_tick(jeng, k, eos, read_len, None, rows, cache, None)
    port = _port_tick(peng, k, eos, read_len, None, rows, cache, None)
    _assert_same(ref, port)
    packed = ref[0]
    assert packed[2, k] == 0 and packed[2, k + 1] == 1  # the parked row never emits
    if k == 4:
        assert packed[1, k] == 2 and packed[1, k + 1] == 1  # quota 5 from gen 3
    if with_eos:
        assert packed[3, k] == 2 and packed[3, k + 1] == 1 and packed[3, 1] == eos


@pytest.mark.parametrize("W,nreal,emits,read_len", [(16, 11, True, None), (16, 16, False, 64),
                                                    (32, 25, True, 64), (32, 19, True, None)])
def test_fused_prefill_tick_matches_reference(engines, W, nreal, emits, read_len):
    """Decode rows in column 0, the admitting row (slot 2) carries a chunk
    at positions [3, 3 + nreal) and samples at its last real column on its
    final chunk."""
    jeng, peng = engines
    rows, cache = _rows(), _cache()
    rows["done"][2] = 0  # admission flipped the row live
    rows["quota"][2] = 6 if emits else 0
    ctoks, cpos = _chunk(W, nreal, cpos0=3)
    col = np.zeros(B, np.int32)
    mask = np.array([1, 1, 0, 1], np.int32)
    if emits:
        col[2] = nreal - 1
        mask[2] = 1
    extra = (ctoks, cpos, 2, col, mask)
    ref = _ref_tick(jeng, 1, None, read_len, W, rows, cache, extra)
    port = _port_tick(peng, 1, None, read_len, W, rows, cache, extra)
    _assert_same(ref, port)
    assert ref[0][2, 1] == int(emits)


@pytest.mark.parametrize("donate", [True, False])
def test_row_update_matches_reference(engines, donate):
    jeng, peng = engines
    last, done = np.arange(B, dtype=np.int32), np.ones(B, np.int32)
    jfn = jdec.compile_row_update_fn(jeng.mesh, jeng.cfg, B, donate=False)
    rl, rd = jfn(jnp.asarray(last), jnp.asarray(done), 2, 77, 0)
    pfn = tdec.compile_row_update_fn(peng.cfg, B, donate=donate)
    tl, td = torch.from_numpy(last.copy()), torch.from_numpy(done.copy())
    pl, pd = pfn(tl, td, 2, 77, 0)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert (pl is tl) == donate and (pd is td) == donate
    if not donate:
        np.testing.assert_array_equal(tl.numpy(), last)


def test_tick_without_donation_leaves_inputs(engines):
    _, peng = engines
    rows, cache = _rows(), _cache()
    fn = tdec.compile_pool_tick_fn(peng.cfg, B, T, 2, 0.0, 0, 1.0, donate=False)[0]
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    t = {n: torch.from_numpy(a.copy()) for n, a in rows.items()}
    with torch.inference_mode():
        packed, c2, lt, dn = fn(peng.params, tc, t["last_tok"], t["done"], t["pos"].long(),
                                t["gen"], t["quota"], t["rids"], 0)
    for n in cache:
        np.testing.assert_array_equal(tc[n].numpy(), cache[n])
    np.testing.assert_array_equal(t["last_tok"].numpy(), rows["last_tok"])
    assert not np.array_equal(c2["k"].numpy(), cache["k"])
    np.testing.assert_array_equal(lt.numpy(), packed[:, 1].numpy() * (rows["done"] == 0)
                                  + rows["last_tok"] * (rows["done"] == 1))


# ---------------------------------------------------------------------------
# the cache write at vector positions against the write it replaced
# ---------------------------------------------------------------------------

def _old_write_component(cache, new, positions):
    """The replaced write: in-range columns found with ``nonzero``."""
    T_ = cache.shape[1]
    rows, cols = ((positions >= 0) & (positions < T_)).nonzero(as_tuple=True)
    cache[rows, positions[rows, cols]] = new[rows, cols].to(cache.dtype)
    return cache


def _old_update(k_cache, v_cache, k_new, v_new, positions):
    def write(cache, new):
        if isinstance(cache, dict):
            q, s = tio.quantize_kv(new)
            return {"q8": _old_write_component(cache["q8"], q, positions),
                    "s": _old_write_component(cache["s"], s, positions)}
        return _old_write_component(cache, new, positions)

    return write(k_cache, k_new), write(v_cache, v_new)


def _positions(rs, Bw, S, Tw):
    """Distinct slots a row, with parked columns at T and beyond and below
    0; row 0 all parked; row 1 a real write at T-1 beside parked columns."""
    pos = np.stack([rs.permutation(np.arange(-2, Tw + 6))[:S] for _ in range(Bw)])
    pos[0] = Tw + rs.randint(0, 4, S)
    if S > 1:
        pos[1, 0], pos[1, 1:] = Tw - 1, Tw
    return torch.from_numpy(pos)


def _clone(c):
    return {n: v.clone() for n, v in c.items()} if isinstance(c, dict) else c.clone()


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("S", [1, 3, 8])
def test_vector_position_write_equals_the_nonzero_write(kv, S):
    Bw, Tw, H, hd = 5, 12, 2, 8
    rs = np.random.RandomState(S)
    g = torch.Generator().manual_seed(S)
    for trial in range(10):
        positions = _positions(rs, Bw, S, Tw)
        k_new = torch.randn(Bw, S, H, hd, generator=g)
        v_new = torch.randn(Bw, S, H, hd, generator=g)
        if kv == "int8":
            def comp():
                return {"q8": torch.randint(-127, 128, (Bw, Tw, H, hd), generator=g,
                                            dtype=torch.int8),
                        "s": torch.rand(Bw, Tw, H, 1, generator=g)}
            kc, vc = comp(), comp()
        else:
            dt = getattr(torch, kv)
            kc = torch.randn(Bw, Tw, H, hd, generator=g).to(dt)
            vc = torch.randn(Bw, Tw, H, hd, generator=g).to(dt)
            k_new, v_new = k_new.to(dt), v_new.to(dt)
        want = _old_update(_clone(kc), _clone(vc), k_new, v_new, positions)
        pos = positions[:, 0].clone()  # the vector pos (only its being a vector matters)
        got = tio.update_kv_cache(_clone(kc), _clone(vc), k_new, v_new, pos, positions)
        for w, o in zip(want, got):
            if isinstance(w, dict):
                for part in w:
                    assert torch.equal(o[part], w[part]), (trial, part)
            else:
                assert torch.equal(o, w), trial


def test_vector_position_write_has_no_host_sync():
    """The write's index math is tensor ops alone: no nonzero, no boolean
    indexing, no item(); checked by running it where such calls raise."""
    positions = torch.tensor([[3, 12, 13], [12, 12, 12], [11, 12, 40]])
    calls = []
    orig = torch.Tensor.nonzero

    def spy(*a, **kw):
        calls.append("nonzero")
        return orig(*a, **kw)

    torch.Tensor.nonzero = spy
    try:
        kc, vc = torch.zeros(3, 12, 2, 4), torch.zeros(3, 12, 2, 4)
        new = torch.ones(3, 3, 2, 4)
        tio.update_kv_cache(kc, vc, new, new, positions[:, 0], positions)
    finally:
        torch.Tensor.nonzero = orig
    assert not calls
    assert kc[0, 3].eq(1).all() and kc[2, 11].eq(1).all()
    assert kc[1].eq(0).all() and kc[0, :3].eq(0).all()
