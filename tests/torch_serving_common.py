"""Shared harness of the serving-layer parity tests
(``tests/test_torch_serving_engine.py``, ``test_torch_serving_recovery.py``,
``test_torch_telemetry.py``): the reference's ``ServingEngine`` over its
batching engine and the port's over the port's, on the same bridged f32
weights (the toy model of ``tests/unit/serving/test_recovery.py``: vocab
128, hidden 64, 2 layers, 4 heads), each on its own ``FakeClock``, so that
scheduling depends on the script alone.

A scenario is a function ``scenario(side) -> record`` run once per side
(``side_of``): ``side.serving`` is the side's ``serving`` package,
``side.make(**kw)`` builds ``(cb, srv, clock)``. Records hold admission verdicts, states,
admission order and streams; greedy streams are compared under the tie
rule of ``tests/test_torch_inference_engine.py`` (equal, or first differing
where the reference's own top-2 logit margin is under 1e-4).
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np

import deepspeed_tpu.serving as jserving
import deepspeed_tpu_torch.serving as tserving
from deepspeed_tpu.inference.continuous import ContinuousBatchingEngine as JEngine
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference import ContinuousBatchingEngine as TEngine
from deepspeed_tpu_torch.models import transformer as ttf

TIE = 1e-4
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128,
           dtype="float32")
SAMPLED = dict(temperature=0.9, top_k=20, seed=7)


class FakeClock:
    """Deterministic clock: time moves only when the test says so."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


def make_params():
    """The reference's toy init from PRNGKey(0), with seeded noise on every
    leaf (biases and norm scales away from the trivial 0/1), as numpy."""
    jcfg = jtf.TransformerConfig(**CFG)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(0)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def prompts(ns, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, (n,)).astype(np.int32) for n in ns]


def build_cb(side: str, params, *, config=None, sampled=False, **kw):
    """A batching engine of ``side`` ("ref" or "port") on the bridged
    weights; the port's on the CPU."""
    config = dict(config or {"dtype": "float32", "kv_read_floor": 16})
    if sampled:
        kw.update(SAMPLED)
    if side == "ref":
        return JEngine(jtf.TransformerModel(jtf.TransformerConfig(**CFG)), params=params,
                       config=config, **kw)
    return TEngine(ttf.TransformerModel(ttf.TransformerConfig(**CFG)), params=params,
                   config=config, device="cpu", **kw)


def side_of(name: str, params):
    """The namespace a scenario gets: ``name``, ``serving`` (the side's
    package), ``build_cb(**kw)`` and ``make(engine_kw..., **serving_kw)``
    -> (cb, srv, clock)."""
    serving = jserving if name == "ref" else tserving
    ns = types.SimpleNamespace(name=name, serving=serving)

    def build(**kw):
        return build_cb(name, params, **kw)

    def make(*, config=None, sampled=False, clock=None, **kw):
        engine_kw = {k: kw.pop(k) for k in ("max_slots", "cache_len", "cache_buckets",
                                             "fused_prefill",
                                             "tokens_per_tick") if k in kw}
        clock = clock if clock is not None else FakeClock()
        cb = build(config=config, sampled=sampled, **engine_kw)
        srv = serving.ServingEngine(cb, clock=clock, **kw)
        return cb, srv, clock

    ns.build_cb = build
    ns.make = make
    return ns


def run_both(scenario, params):
    """{"ref": record, "port": record} of one scenario."""
    return {name: scenario(side_of(name, params)) for name in ("ref", "port")}


def drain(srv, clock, step_s=1.0, max_ticks=500):
    for _ in range(max_ticks):
        if not srv.has_work():
            return
        clock.advance(step_s)
        srv.step()
    raise AssertionError("serving engine did not drain")


def verdict(adm) -> tuple:
    """An Admission as plain data: (status, rid, reason, retry_after_s)."""
    return (adm.status, adm.rid, adm.reason, adm.retry_after_s)


def reaped(srv) -> dict:
    """{serving rid: (state, tokens, result, admit_t, finish_t)} of every
    terminal request, reaped."""
    out = {}
    for rid, req in srv.reap().items():
        out[rid] = (req.state, [int(t) for t in req.tokens],
                    None if req.result is None else np.asarray(req.result),
                    req.admit_t, req.finish_t)
    return out


def assert_stream_agrees(params, ref_tokens, port_tokens, prompt, what=""):
    """A port stream equals the reference's, or first differs where the
    reference's top-2 logit margin is < TIE (a tie, warned about)."""
    ref_tokens, port_tokens = list(ref_tokens), list(port_tokens)
    if ref_tokens == port_tokens:
        return
    assert len(ref_tokens) == len(port_tokens), (what, ref_tokens, port_tokens)
    j = next(i for i, (a, b) in enumerate(zip(ref_tokens, port_tokens)) if a != b)
    seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(ref_tokens[:j], np.int32)])
    logits = np.asarray(jtf.apply(params, jtf.TransformerConfig(**CFG),
                                  jnp.asarray(seq[None])))[0, -1]
    top2 = np.sort(logits)[-2:]
    margin = float(top2[1] - top2[0])
    assert margin < TIE, f"{what}: streams differ at step {j} (reference margin {margin:.3g})"
    warnings.warn(f"{what}: a tie at step {j} (reference margin {margin:.3g})")


def assert_records_agree(params, rec, prompt_of):
    """The two sides' reaped records: same rids, states and times, and
    greedy streams under the tie rule. ``prompt_of(rid)`` gives the full
    prompt of a serving rid."""
    ref, port = rec["ref"], rec["port"]
    assert sorted(ref) == sorted(port)
    for rid in ref:
        r, p = ref[rid], port[rid]
        assert (p[0], p[3], p[4]) == (r[0], r[3], r[4]), (rid, p[0], r[0])
        assert_stream_agrees(params, r[1], p[1], prompt_of(rid), what=f"rid {rid}")
