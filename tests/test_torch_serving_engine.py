"""The port's serving front end (``deepspeed_tpu_torch/serving/engine.py``)
against the reference's ``ServingEngine``: the same submissions, cancels,
drains and ticks on a fake clock through both packages, each over its own
batching engine on the same bridged f32 weights, on the CPU (the schedules
of ``tests/unit/serving/test_serving_engine.py``).

Equal across the packages: admission statuses, shed reasons and retry
hints, final states, admission and finish times, and the greedy streams
(tie rule: ``tests/torch_serving_common.py``). Sampled streams cannot match
the reference's threefry draws; the port's are held bit for bit across
pipeline depths, fused and separate prefill, and the bare batching
engine's streams on the same submissions (whose draws
``tests/test_torch_continuous_batching.py`` holds to the softmax).
"""

import numpy as np
import pytest

from deepspeed_tpu import comm
from torch_serving_common import (
    assert_records_agree,
    assert_stream_agrees,
    drain,
    make_params,
    prompts,
    reaped,
    run_both,
    side_of,
    verdict,
)


@pytest.fixture(scope="module")
def params():
    comm.destroy()
    yield make_params()
    comm.destroy()


def _check(params, rec, prompt_of, **extra_keys):
    """Verdicts and every extra key equal; reaped records agree."""
    for key in ("verdicts",) + tuple(extra_keys):
        assert rec["port"][key] == rec["ref"][key], key
    assert_records_agree(params, {s: rec[s]["reaped"] for s in rec}, prompt_of)


# ---------------------------------------------------------------------------
# admission control and backpressure
# ---------------------------------------------------------------------------

def test_saturation_queue_bound_shed_and_cancel(params):
    """Saturation: the queue bound holds, overflow sheds ``queue_full``, a
    cancelled running request frees its slot for an immediate admission,
    and a terminal request cannot be cancelled."""
    ps = prompts((5, 9, 3, 7, 4, 6, 8, 5), seed=11)

    def scenario(side):
        cb, srv, clock = side.make(max_slots=2, cache_len=64, max_queue_depth=3)
        verdicts = [verdict(srv.submit(p, max_new_tokens=6)) for p in ps]
        depths = []
        while srv.has_work():
            clock.advance(0.1)
            srv.step()
            depths.append(srv.queue_depth())
        out = reaped(srv)
        a1 = srv.submit(ps[0], max_new_tokens=16)
        a2 = srv.submit(ps[1], max_new_tokens=16)
        clock.advance(0.1)
        srv.step()
        cancelled = srv.cancel(a1.rid)
        a3 = srv.submit(ps[2], max_new_tokens=4)
        drain(srv, clock, step_s=0.1)
        out.update(reaped(srv))
        verdicts += [verdict(a) for a in (a1, a2, a3)]
        return {"verdicts": verdicts, "reaped": out, "depths": depths,
                "cancel": (cancelled, srv.cancel(a2.rid))}

    rec = run_both(scenario, params)
    assert [v[0] for v in rec["port"]["verdicts"][:8]] == (
        ["admitted"] * 2 + ["queued"] * 3 + ["shed"] * 3)
    assert rec["port"]["cancel"] == (True, False)
    assert max(rec["port"]["depths"]) <= 3
    prompt_of = {i: ps[i] for i in range(5)}
    prompt_of.update({5: ps[0], 6: ps[1], 7: ps[2]})
    _check(params, rec, prompt_of.__getitem__, depths=1, cancel=1)


def test_kv_budget_shed_with_retry_hint(params):
    """KV-budget shedding: no hint before any completion, then a hint
    extrapolated from the observed completion rate, equal in both."""
    p = prompts((8,), seed=12)[0]

    def scenario(side):
        cb, srv, clock = side.make(max_slots=2, cache_len=64, max_queue_depth=50,
                                   kv_budget_tokens=100)
        verdicts = [verdict(srv.submit(p, max_new_tokens=40)) for _ in range(3)]
        drain(srv, clock, step_s=0.5)
        out = reaped(srv)
        verdicts += [verdict(srv.submit(p, max_new_tokens=40)) for _ in range(3)]
        drain(srv, clock, step_s=0.5)
        out.update(reaped(srv))
        return {"verdicts": verdicts, "reaped": out}

    rec = run_both(scenario, params)
    shed = [v for v in rec["port"]["verdicts"] if v[0] == "shed"]
    assert [v[2] for v in shed] == ["kv_budget", "kv_budget"]
    assert shed[0][3] is None and shed[1][3] > 0
    _check(params, rec, lambda rid: p)


def test_invalid_requests_raise_as_the_reference(params):
    """Malformed or structurally inadmissible requests and constructor
    arguments raise the reference's errors, with its messages."""
    def scenario(side):
        errors = []
        cases = [
            (dict(max_slots=2, cache_len=32), np.arange(30, dtype=np.int32), 8),
            (dict(max_slots=2, cache_len=32), np.arange(4, dtype=np.int32), 0),
            (dict(max_slots=2, cache_len=64, kv_budget_tokens=20),
             np.arange(10, dtype=np.int32), 30),
        ]
        for kw, prompt, new in cases:
            _, srv, _ = side.make(**kw)
            with pytest.raises(ValueError) as e:
                srv.submit(prompt, max_new_tokens=new)
            errors.append(str(e.value))
        for kw in (dict(max_queue_depth=0), dict(aging_s=0), dict(policy="lifo"),
                   dict(kv_budget_tokens=0), dict(pipeline_depth=-1)):
            with pytest.raises(ValueError) as e:
                side.make(max_slots=1, cache_len=32, **kw)
            errors.append(str(e.value))
        return errors

    rec = run_both(scenario, params)
    assert rec["port"] == rec["ref"]


# ---------------------------------------------------------------------------
# scheduling policies and aging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fifo", "priority", "edf", "fair"])
def test_policy_admission_order_under_contention(params, policy):
    """One slot, a mixed queue (priorities, deadlines, tenants): the same
    admission order, times and streams under each policy."""
    ps = prompts((4, 5, 6, 7, 5, 4), seed=13)
    mix = [dict(), dict(priority=0, deadline_ms=500_000.0, tenant="a"),
           dict(priority=5, deadline_ms=100_000.0, tenant="a"),
           dict(priority=1, deadline_ms=300_000.0, tenant="a"),
           dict(priority=3, tenant="b"), dict(priority=2, deadline_ms=200_000.0, tenant="b")]

    def scenario(side):
        cb, srv, clock = side.make(policy=policy, max_slots=1, cache_len=64, aging_s=1000.0)
        verdicts = [verdict(srv.submit(p, max_new_tokens=2, **kw)) for p, kw in zip(ps, mix)]
        drain(srv, clock)
        out = reaped(srv)
        order = sorted(out, key=lambda rid: out[rid][3])
        return {"verdicts": verdicts, "reaped": out, "order": order}

    rec = run_both(scenario, params)
    if policy == "fifo":
        assert rec["port"]["order"] == list(range(6))
    _check(params, rec, lambda rid: ps[rid], order=1)


def test_aging_prevents_starvation(params):
    """EDF under a steady deadlined stream: the no-SLO request is skipped
    while fresh and admitted once aged, at the same tick in both."""
    ps = prompts((4, 5), seed=16)

    def scenario(side):
        cb, srv, clock = side.make(policy="edf", max_slots=1, cache_len=64, aging_s=5.0)
        verdicts = [verdict(srv.submit(ps[0], max_new_tokens=2, deadline_ms=600_000.0)),
                    verdict(srv.submit(ps[1], max_new_tokens=2))]
        for _ in range(12):
            verdicts.append(verdict(srv.submit(ps[0], max_new_tokens=2,
                                               deadline_ms=600_000.0)))
            clock.advance(1.0)
            srv.step()
        drain(srv, clock)
        out = reaped(srv)
        return {"verdicts": verdicts, "reaped": out,
                "order": sorted(out, key=lambda rid: out[rid][3])}

    rec = run_both(scenario, params)
    order = rec["port"]["order"]
    assert 0 < order.index(1) < len(order) - 1  # skipped while fresh, not last
    _check(params, rec, lambda rid: ps[1] if rid == 1 else ps[0], order=1)


# ---------------------------------------------------------------------------
# request lifecycle
# ---------------------------------------------------------------------------

def test_deadline_expiry_and_cancel_mid_flight(params):
    """Queued work whose deadline blows expires without decoding; a queued
    and a running request cancel (the running one mid-stream, its slot
    re-used); unknown rids cannot be cancelled."""
    ps = prompts((4, 5, 6, 7), seed=17)

    def scenario(side):
        cb, srv, clock = side.make(max_slots=1, cache_len=64)
        verdicts = [verdict(srv.submit(ps[0], max_new_tokens=8)),
                    verdict(srv.submit(ps[1], max_new_tokens=2, deadline_ms=2000.0)),
                    verdict(srv.submit(ps[2], max_new_tokens=4))]
        clock.advance(3.0)
        srv.step()
        expired = srv.status(1)
        cancels = [srv.cancel(2)]
        clock.advance(0.1)
        srv.step()
        cancels.append(srv.cancel(0))  # running, mid-stream
        verdicts.append(verdict(srv.submit(ps[3], max_new_tokens=5)))
        drain(srv, clock)
        cancels.append(srv.cancel(12345))
        return {"verdicts": verdicts, "reaped": reaped(srv), "expired": expired,
                "cancels": cancels}

    rec = run_both(scenario, params)
    assert rec["port"]["expired"] == "expired"
    assert rec["port"]["cancels"] == [True, True, False]
    states = {rid: r[0] for rid, r in rec["port"]["reaped"].items()}
    assert states == {0: "cancelled", 1: "expired", 2: "cancelled", 3: "finished"}
    _check(params, rec, lambda rid: ps[rid], expired=1, cancels=1)


def test_token_stream_callback_and_results(params):
    """The pull iterator and the per-token callback see each request's
    whole stream; result/status keep the reference's semantics."""
    ps = prompts((5, 7), seed=19)

    def scenario(side):
        cb, srv, clock = side.make(max_slots=2, cache_len=64)
        seen = []
        a = srv.submit(ps[0], max_new_tokens=6, on_token=lambda rid, t: seen.append((rid, t)))
        b = srv.submit(ps[1], max_new_tokens=6)
        stream = srv.stream(b.rid)
        pulled = [int(t) for t in stream]
        states = [stream.request.state, srv.status(a.rid)]
        res = [np.asarray(srv.result(r)).tolist() for r in (a.rid, b.rid)]
        states.append(srv.status(a.rid))
        with pytest.raises(KeyError) as e:
            srv.stream(a.rid)
        return {"verdicts": [verdict(a), verdict(b)], "reaped": reaped(srv),
                "pulled": pulled, "seen": [(r, int(t)) for r, t in seen],
                "states": states, "res": res, "error": str(e.value)}

    rec = run_both(scenario, params)
    port = rec["port"]
    assert port["pulled"] == port["res"][1][len(ps[1]):]
    assert [t for _, t in port["seen"]] == port["res"][0][len(ps[0]):]
    assert port["states"] == ["finished", "finished", "unknown"]
    for key in ("verdicts", "states", "error"):
        assert port[key] == rec["ref"][key], key
    for j, p in enumerate(ps):
        assert_stream_agrees(params, rec["ref"]["res"][j][len(p):],
                             port["res"][j][len(p):], p, what=f"request {j}")


def test_drain_resume_and_statusz(params):
    """drain() sheds new work as ``draining`` with no hint while queued and
    running work finishes; resume() reopens admission. statusz carries the
    reference's keys (its device-memory ``hbm_*`` keys are not ported) and
    values on the fake clock."""
    ps = prompts((5, 6, 7, 4), seed=23)

    def scenario(side):
        cb, srv, clock = side.make(max_slots=1, cache_len=64)
        verdicts = [verdict(srv.submit(ps[0], max_new_tokens=4)),
                    verdict(srv.submit(ps[1], max_new_tokens=3))]
        clock.advance(0.5)
        srv.step()
        srv.drain()
        health = [srv.health()]
        verdicts.append(verdict(srv.submit(ps[2], max_new_tokens=3)))
        status = srv.statusz()
        drain(srv, clock)
        srv.resume()
        health.append(srv.health())
        verdicts.append(verdict(srv.submit(ps[3], max_new_tokens=3)))
        drain(srv, clock)
        status = {k: v for k, v in status.items() if not k.startswith("hbm_")}
        return {"verdicts": verdicts, "reaped": reaped(srv), "health": health,
                "status": status}

    rec = run_both(scenario, params)
    assert rec["port"]["verdicts"][2][:3] == ("shed", None, "draining")
    assert rec["port"]["verdicts"][2][3] is None
    assert rec["port"]["health"] == ["draining", "ok"]
    st_ref = dict(rec["ref"]["status"])
    st_port = dict(rec["port"]["status"])
    for st in (st_ref, st_port):  # host-timed tick accounting
        for key in ("overlap_frac", "block_ms_per_token"):
            st.pop(key)
    assert st_port == st_ref
    prompt_of = {0: ps[0], 1: ps[1], 2: ps[3]}
    _check(params, rec, prompt_of.__getitem__, health=1)


def test_serving_level_prefixes(params):
    """Prefix ids of the serving layer: admission splices the registered
    prefix and prefills the suffix; a prefix unregistered while a request
    is queued falls back to the full prompt."""
    rs = np.random.RandomState(6)
    prefix = rs.randint(0, 128, (8,)).astype(np.int32)
    sufs = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (4, 6, 5)]

    def scenario(side):
        cb, srv, clock = side.make(max_slots=1, cache_len=64)
        pid = srv.register_prefix(prefix)
        verdicts = [verdict(srv.submit(s, max_new_tokens=6, prefix_id=pid)) for s in sufs]
        clock.advance(0.1)
        srv.step()
        srv.unregister_prefix(pid)
        drain(srv, clock, step_s=0.1)
        with pytest.raises(KeyError) as e:
            srv.submit(sufs[0], max_new_tokens=2, prefix_id=pid)
        return {"verdicts": verdicts, "reaped": reaped(srv), "error": str(e.value)}

    rec = run_both(scenario, params)
    _check(params, rec, lambda rid: np.concatenate([prefix, sufs[rid]]), error=1)


# ---------------------------------------------------------------------------
# sampled streams: the port's own invariants
# ---------------------------------------------------------------------------

def test_sampled_streams_equal_across_depth_fusion_and_the_bare_pool(params):
    """Sampled serving streams are one stream per request: equal at
    pipeline depths 0/1/2, with fused and separate prefill, and equal to
    the bare batching engine's on the same submissions."""
    ps = prompts((5, 11, 4, 20), seed=29)
    news = (10, 8, 12, 6)
    side = side_of("port", params)
    runs = []
    for kw in (dict(pipeline_depth=0), dict(pipeline_depth=1), dict(pipeline_depth=2),
               dict(pipeline_depth=1, fused_prefill=False)):
        cb, srv, clock = side.make(sampled=True, max_slots=2, cache_len=64, **kw)
        adms = [srv.submit(p, max_new_tokens=n) for p, n in zip(ps, news)]
        drain(srv, clock, step_s=0.1)
        out = srv.reap()
        runs.append([[int(t) for t in out[a.rid].tokens] for a in adms])
    bare = side.build_cb(sampled=True, max_slots=2, cache_len=64)
    rids = [bare.submit(p, max_new_tokens=n) for p, n in zip(ps, news)]
    while bare.has_work():
        bare.step()
    done = bare.finished()
    runs.append([done[r][len(p):].tolist() for r, p in zip(rids, ps)])
    assert [len(s) for s in runs[0]] == list(news)
    for other in runs[1:]:
        assert other == runs[0]


# ---------------------------------------------------------------------------
# what the port does not take yet
# ---------------------------------------------------------------------------

def test_unported_surface_raises(params):
    side = side_of("port", params)
    # a degrade ladder builds its rungs' meshes up front: the 1x1 rung is
    # there in a world of one, a wider one is refused as the reference's
    # serving_mesh refuses it
    _, srv, _ = side.make(max_slots=1, cache_len=32,
                          degrade_mesh_shapes=[{"data": 1, "tensor": 1}])
    assert srv.degrade_mesh_shapes == [{"data": 1, "tensor": 1}]
    with pytest.raises(ValueError, match="devices"):
        side.make(max_slots=1, cache_len=32, degrade_mesh_shapes=[{"data": 1, "tensor": 2}])
    _, srv, _ = side.make(max_slots=1, cache_len=32)
    with pytest.raises(NotImplementedError, match=r"item 11 \(b\)"):
        srv.hbm_headroom_bytes()
    assert not any(k.startswith("hbm_") for k in srv.statusz())
