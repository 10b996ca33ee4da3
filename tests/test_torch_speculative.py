"""The port's standalone speculative decoding (``generate(..., draft=)``,
``init_inference(draft_model=)``; ``inference/decoding.speculative_generate``
and ``speculative_decode_loop``) against the port's plain ``generate`` and
against the reference's ``generate(draft=...)``, in f32 on the CPU, on the
same bridged weights (mirroring ``tests/unit/inference/test_speculative.py``
and the reference's ``TestEngineDraftPath``).

Greedy streams: speculation is lossless, so each stream equals plain greedy
decoding and the reference's speculative stream, or first differs at a
generated step where the reference's own top-2 logit margin is under 1e-4 (a
tie that f32 summation order may break; reported, not failed).

The host-side acceptance (``_accept_round``, ``_sample_rows``) is numpy in
both packages and must agree bit for bit on the same inputs and the same
``np.random.default_rng`` seed, greedy and sampled. Sampled streams cannot
match the reference's (its host rng is seeded from a JAX key, the port's
from a ``torch.Generator``): they are held to the target's top-k support.
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
from deepspeed_tpu.inference import decoding as jdec
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference import decoding as tdec
from deepspeed_tpu_torch.models import transformer as ttf

TIE = 1e-4
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128,
           dtype="float32")
DRAFT_CFG = dict(CFG, hidden_size=32, num_layers=1)


def _noisy_params(cfg, seed):
    """Reference params with seeded noise on every leaf (biases and norm
    scales away from the trivial 0/1), as numpy."""
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def setup():
    comm.destroy()
    jcfg, dcfg = jtf.TransformerConfig(**CFG), jtf.TransformerConfig(**DRAFT_CFG)
    params, dparams = _noisy_params(jcfg, 0), _noisy_params(dcfg, 1)
    yield {"jcfg": jcfg, "dcfg": dcfg, "params": params, "dparams": dparams}
    comm.destroy()


def _port(params, cfg=CFG, **config):
    return deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**cfg)), params=params,
        config={"dtype": "float32", **config}, device="cpu")


def _ref(params, jcfg, **config):
    return deepspeed_tpu.init_inference(jtf.TransformerModel(jcfg), params=params,
                                        config={"dtype": "float32", **config})


def _prompt(B=3, S=9, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(np.int32)


def _assert_agree(setup, want, got, S):
    """Each row of ``got`` equals ``want``'s, or first differs at a generated
    step where the reference's top-2 margin is < TIE."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    for b in range(want.shape[0]):
        if np.array_equal(want[b], got[b]):
            continue
        np.testing.assert_array_equal(got[b, :S], want[b, :S])
        j = int(np.nonzero(want[b] != got[b])[0][0])
        logits = np.asarray(jtf.apply(setup["params"], setup["jcfg"],
                                      jnp.asarray(want[b:b + 1, :j])))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE, f"row {b} differs at position {j} (reference margin {margin})"
        warnings.warn(f"row {b}: a tie at position {j} (reference margin {margin:.3g})")


# ---------------------------------------------------------------------------
# greedy streams: the port's plain generate and the reference's speculative one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [1, 4, 8])
def test_greedy_matches_plain_and_reference(setup, gamma):
    """An unrelated draft accepts different counts in each row, so this also
    drives the per-row positions of the draft steps and the verify window."""
    target, draft = _port(setup["params"]), _port(setup["dparams"], DRAFT_CFG)
    prompt = _prompt()
    plain = target.generate(prompt, max_new_tokens=16)
    spec = target.generate(prompt, max_new_tokens=16, draft=draft, num_draft_tokens=gamma)
    assert spec.dtype == torch.int32 and spec.shape == (3, 25)
    _assert_agree(setup, plain.numpy(), spec.numpy(), 9)
    jt, jd = _ref(setup["params"], setup["jcfg"]), _ref(setup["dparams"], setup["dcfg"])
    want = np.asarray(jt.generate(prompt, max_new_tokens=16, draft=jd, num_draft_tokens=gamma))
    _assert_agree(setup, want, spec.numpy(), 9)


def test_self_draft_accepts_everything(setup):
    """Drafting with the target itself accepts every greedy proposal and
    still emits the plain greedy continuation; each round is then gamma + 1
    tokens wide, which the round count shows."""
    target = _port(setup["params"])
    prompt = _prompt(B=2)
    plain = target.generate(prompt, max_new_tokens=12)
    rounds = []
    segment = target._segment_fn

    def counting(batch_size, max_len):
        fn = segment(batch_size, max_len)

        def call(params, toks, cache, pos, active=None):
            if toks.shape[1] == 4:
                rounds.append(1)
            return fn(params, toks, cache, pos, active)

        return call

    target._segment_fn = counting
    spec = target.generate(prompt, max_new_tokens=12, draft=target, num_draft_tokens=3)
    _assert_agree(setup, plain.numpy(), spec.numpy(), 9)
    # 11 tokens after the prefill's first, 4 a round
    assert len(rounds) == 3


def test_gamma_longer_than_the_request(setup):
    target, draft = _port(setup["params"]), _port(setup["dparams"], DRAFT_CFG)
    prompt = _prompt(B=2, S=5)
    plain = target.generate(prompt, max_new_tokens=3)
    spec = target.generate(prompt, max_new_tokens=3, draft=draft, num_draft_tokens=8)
    _assert_agree(setup, plain.numpy(), spec.numpy(), 5)
    one = target.generate(prompt, max_new_tokens=1, draft=draft, num_draft_tokens=8)
    np.testing.assert_array_equal(one.numpy(), plain.numpy()[:, :6])


def test_eos_early_stop_matches_plain_and_reference(setup):
    target, draft = _port(setup["params"]), _port(setup["dparams"], DRAFT_CFG)
    prompt = _prompt(B=3, S=7)
    first = int(target.generate(prompt, max_new_tokens=1)[0, -1])  # so that EOS fires
    plain = target.generate(prompt, max_new_tokens=12, eos_token_id=first)
    spec = target.generate(prompt, max_new_tokens=12, draft=draft, num_draft_tokens=4,
                           eos_token_id=first)
    _assert_agree(setup, plain.numpy(), spec.numpy(), 7)
    assert (spec[0, 7:] == first).all()
    jt, jd = _ref(setup["params"], setup["jcfg"]), _ref(setup["dparams"], setup["dcfg"])
    want = np.asarray(jt.generate(prompt, max_new_tokens=12, draft=jd, num_draft_tokens=4,
                                  eos_token_id=first))
    _assert_agree(setup, want, spec.numpy(), 7)


def test_config_driven_draft_engine(setup):
    """``speculative.enabled`` and ``init_inference(draft_model=,
    draft_params=)``: every generate call uses the attached draft (here the
    reference's numpy tree, bridged), which takes the target's cache format."""
    engine = deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**CFG)), params=setup["params"],
        config={"dtype": "float32", "kv_read_floor": 16,
                "speculative": {"enabled": True, "num_draft_tokens": 3}},
        draft_model=ttf.TransformerModel(ttf.TransformerConfig(**DRAFT_CFG)),
        draft_params=setup["dparams"], device="cpu")
    draft = engine._draft_engine
    assert draft.device.type == "cpu" and draft.config.kv_read_floor == 16
    assert draft.cfg.hidden_size == 32
    prompt = _prompt(B=2, S=6)
    spec = engine.generate(prompt, max_new_tokens=10)
    plain = _port(setup["params"]).generate(prompt, max_new_tokens=10)
    _assert_agree(setup, plain.numpy(), spec.numpy(), 6)


def test_int8_kv_with_a_chunk_config(setup):
    """The reference's ``TestEngineDraftPath``: under int8 KV the quantized
    writes are the same on the plain path and the gamma-wide verify, and a
    configured ``prefill_chunk_size`` is skipped when speculating."""
    spec_eng = deepspeed_tpu_torch.init_inference(
        ttf.TransformerModel(ttf.TransformerConfig(**CFG)), params=setup["params"],
        config={"dtype": "float32", "kv_cache_dtype": "int8", "prefill_chunk_size": 16,
                "speculative": {"enabled": True, "num_draft_tokens": 3}},
        draft_model=ttf.TransformerModel(ttf.TransformerConfig(**DRAFT_CFG)),
        draft_params=setup["dparams"], device="cpu")
    assert spec_eng._draft_engine.cfg.kv_cache_dtype == "int8"
    plain_eng = _port(setup["params"], kv_cache_dtype="int8")
    prompt = _prompt(B=2, S=20, seed=12)
    spec = spec_eng.generate(prompt, max_new_tokens=10)
    plain = plain_eng.generate(prompt, max_new_tokens=10)
    _assert_agree(setup, plain.numpy(), spec.numpy(), 20)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sampling_stays_in_the_top_k_support(setup):
    """top_k=1 makes sampling greedy through the accept/resample path; at
    top_k=5 every token lies in the target's top 5 at its step, and the same
    generator seed gives the same stream."""
    target, draft = _port(setup["params"]), _port(setup["dparams"], DRAFT_CFG)
    prompt = _prompt(B=2, S=6)
    plain = target.generate(prompt, max_new_tokens=8)
    one = target.generate(prompt, max_new_tokens=8, draft=draft, num_draft_tokens=3,
                          temperature=0.7, top_k=1, generator=torch.Generator().manual_seed(3))
    _assert_agree(setup, plain.numpy(), one.numpy(), 6)

    def sampled(seed):
        return target.generate(prompt, max_new_tokens=12, draft=draft, num_draft_tokens=4,
                               temperature=1.0, top_k=5,
                               generator=torch.Generator().manual_seed(seed))

    out = sampled(5)
    assert out.shape == (2, 18) and bool(((out >= 0) & (out < 128)).all())
    steps = target.forward(out).float()[:, 5:-1]  # the logits that chose each token
    kth = torch.topk(steps, 5, dim=-1).values[..., -1]
    picked = steps.gather(-1, out[:, 6:].long()[..., None])[..., 0]
    assert bool((picked >= kth - TIE).all())
    assert torch.equal(out, sampled(5))
    assert not torch.equal(out, sampled(6))


@pytest.mark.parametrize("trial", range(6))
def test_accept_round_equals_reference_bit_for_bit(trial):
    """The same numpy inputs and the same rng seed give the same (n_take,
    bonus, bonus_ok, took_eos) and leave both rngs in the same state: greedy
    (with and without EOS), sampled from f32 and f64 distributions."""
    rs = np.random.RandomState(trial)
    B, gamma, V = 8, 1 + trial % 5, 16
    drafts = rs.randint(0, V, (B, gamma)).astype(np.int32)
    active = rs.rand(B) > 0.2
    lens = rs.randint(0, 12, B).astype(np.int32)
    eos = 5 if trial % 2 == 0 else None
    tgt = rs.randint(0, V, (B, gamma + 1)).astype(np.int32)
    tgt[:B // 2, :gamma] = drafts[:B // 2]  # rows that accept much
    dtype = np.float32 if trial < 3 else np.float64
    p = rs.rand(B, gamma + 1, V).astype(dtype)
    p[:, :, :3] = 0.0  # tokens outside the filtered support
    p /= p.sum(-1, keepdims=True)
    q = rs.rand(B, gamma, V).astype(dtype)
    q /= q.sum(-1, keepdims=True)
    cases = [dict(tgt=tgt), dict(pdists=p, qstack=q)]
    for kw in cases:
        r_rng, p_rng = np.random.default_rng(trial), np.random.default_rng(trial)
        want = jdec._accept_round(drafts, active, lens, 12, eos, host_rng=r_rng, **kw)
        got = tdec._accept_round(drafts, active, lens, 12, eos, host_rng=p_rng, **kw)
        for w, g, name in zip(want, got, ("n_take", "bonus", "bonus_ok", "took_eos")):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert r_rng.random() == p_rng.random()
    r_rng, p_rng = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(tdec._sample_rows(p[:, 0], p_rng),
                                  jdec._sample_rows(p[:, 0], r_rng))


def test_filtered_probs_match_reference():
    logits = np.random.RandomState(4).randn(5, 128).astype(np.float32)
    for temperature, top_k, top_p in ((1.0, 0, 1.0), (0.7, 5, 1.0), (1.0, 0, 0.9)):
        ref = np.asarray(jdec._filtered_probs(jnp.asarray(logits), temperature, top_k, top_p))
        out = tdec._filtered_probs(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
        np.testing.assert_array_equal(ref == 0, out == 0)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# refusals, as the reference's
# ---------------------------------------------------------------------------

def test_vocab_mismatch_raises(setup):
    target = _port(setup["params"])
    other = _port(None, dict(DRAFT_CFG, vocab_size=64))
    with pytest.raises(ValueError, match="vocab"):
        target.generate(_prompt(B=1, S=4), max_new_tokens=4, draft=other)


def test_gamma_below_one_raises(setup):
    target, draft = _port(setup["params"]), _port(setup["dparams"], DRAFT_CFG)
    with pytest.raises(ValueError, match="num_draft_tokens"):
        target.generate(_prompt(B=1, S=4), max_new_tokens=4, draft=draft, num_draft_tokens=0)


def test_ngram_mode_needs_the_pool(setup):
    """``generate`` has no token history to self-draft from: speculation
    without a draft model raises and names the pooled serving path."""
    eng = _port(setup["params"], speculative={"enabled": True, "mode": "ngram"})
    with pytest.raises(ValueError, match="pooled serving"):
        eng.generate(_prompt(B=1, S=6), max_new_tokens=4)


def test_attention_mask_with_speculation_raises(setup):
    target, draft = _port(setup["params"]), _port(setup["dparams"], DRAFT_CFG)
    with pytest.raises(NotImplementedError, match="attention_mask"):
        target.generate(_prompt(B=2, S=4), max_new_tokens=4, draft=draft,
                        attention_mask=np.ones((2, 4), np.int32))
