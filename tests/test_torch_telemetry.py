"""The port's telemetry layer (``deepspeed_tpu_torch/telemetry/``), fault
plans (``faults.py``) and load generator (``serving/loadgen.py``) against
the reference, on the CPU.

Equal to the reference's: the trace events of one serving run (kinds in
order and every field but the wall-clock ones: ``ts``, the tick's dispatch
and blocked ms, span windows; span ids compared by order of appearance,
since each package numbers its emitters from its own counter), the
registry counters and the port's gauges, timelines rebuilt from the
reference's fixture, Prometheus text, fault plans and workloads byte for
byte, and the load generator's records and summary on a fake clock. The
port's own: the hub's capture window and refusals, the ops server over
loopback, the CLI, and imports free of JAX.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

import deepspeed_tpu.faults as jfaults
import deepspeed_tpu.serving.loadgen as jload
import deepspeed_tpu.telemetry as jtele
import deepspeed_tpu.telemetry.timeline as jtl
import deepspeed_tpu_torch.faults as tfaults
import deepspeed_tpu_torch.serving.loadgen as tload
import deepspeed_tpu_torch.telemetry as ttele
import deepspeed_tpu_torch.telemetry.timeline as ttl
from deepspeed_tpu import comm
from torch_serving_common import FakeClock, make_params, prompts, side_of

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unit", "telemetry",
                       "fixtures", "mini_trace.jsonl")
# wall-clock fields (per kind) left out of the comparison
_TIMING = {"serving_tick": {"dispatch_ms", "block_ms"}, "span": {"t0", "t1", "dur_ms"}}
_KINDS = ("serving_tick", "inference_request", "span", "serving_event", "serving_fault")


@pytest.fixture(scope="module")
def params():
    comm.destroy()
    yield make_params()
    comm.destroy()


# ---------------------------------------------------------------------------
# trace events and counters of one serving run
# ---------------------------------------------------------------------------

def _normalized(events):
    """Events of the compared kinds without their wall-clock fields, span
    ids replaced by their order of first appearance."""
    ids = {}

    def sid(x):
        return ids.setdefault(x, len(ids))

    out = []
    for e in events:
        if e["kind"] not in _KINDS:
            continue  # the reference's memory_snapshot / compile_event
        e = {k: v for k, v in e.items() if k != "ts" and k not in _TIMING.get(e["kind"], ())}
        for key in ("span_id", "parent_id"):
            if key in e:
                e[key] = sid(e[key])
        out.append(e)
    return out


def _traced_run(side, trace, chaos):
    clock = FakeClock()
    config = {"dtype": "float32", "kv_read_floor": 16,
              "telemetry": {"enabled": True, "trace_file": trace}}
    cb = side.build_cb(config=config, max_slots=2, cache_len=64)
    kw = {}
    if chaos:
        cb.fault_hook = side.serving.FaultInjector(side.serving.FaultPlan(
            [side.serving.Fault(tick=3, kind="dispatch_error"),
             side.serving.Fault(tick=6, kind="preempt")]))
        kw = dict(engine_factory=lambda mesh_shape=None: side.build_cb(max_slots=2, cache_len=64),
                  recovery=side.serving.RecoveryConfig(backoff_s=0.0), sleep=lambda s: None)
    srv = side.serving.ServingEngine(cb, clock=clock, max_queue_depth=2, **kw)
    ps = prompts((5, 9, 20, 3, 6), seed=41)
    srv.submit(ps[0], max_new_tokens=6, priority=2, tenant="t0", deadline_ms=60_000.0)
    srv.submit(ps[1], max_new_tokens=5, tenant="t1")
    srv.submit(ps[2], max_new_tokens=4)
    srv.submit(ps[3], max_new_tokens=3, deadline_ms=10.0)
    srv.submit(ps[4], max_new_tokens=3)  # queue full: shed
    ticks = 0
    while srv.has_work():
        clock.advance(0.05)
        srv.step()
        ticks += 1
        if ticks == 2 and not chaos:
            srv.cancel(1)
    srv.reap()
    reg = srv._tele.registry.dump()
    srv.close()
    return _normalized(jtele.read_trace(trace)), reg


@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
def test_serving_trace_and_counters_match_the_reference(params, tmp_path, chaos):
    """One serving run with shedding, a deadline, a cancel (plain) or a
    retried dispatch error and a rebuild (chaos), traced by both packages:
    the same events in the same order, the same counters, and the port's
    gauges at the reference's values."""
    out = {name: _traced_run(side_of(name, params), str(tmp_path / f"{name}.jsonl"), chaos)
           for name in ("ref", "port")}
    (ref_ev, ref_reg), (port_ev, port_reg) = out["ref"], out["port"]
    kinds = [e["kind"] for e in port_ev]
    assert {"serving_tick", "inference_request", "span", "serving_event"} <= set(kinds)
    if chaos:
        assert "serving_fault" in kinds
    assert kinds == [e["kind"] for e in ref_ev]
    for i, (r, p) in enumerate(zip(ref_ev, port_ev)):
        assert p == r, (i, p["kind"])
    # the reference's compile flight recorder counts its compiles; the port
    # compiles nothing
    compiles = ("compile_event_total", "recompile_total")
    assert port_reg["counters"] == {k: v for k, v in ref_reg["counters"].items()
                                    if not k.startswith(compiles)}
    assert port_reg["gauges"] == {k: ref_reg["gauges"][k] for k in port_reg["gauges"]}
    assert "serve_admitted_total" in port_reg["counters"]


def test_span_timeline_rebuilds_from_a_port_trace(params, tmp_path):
    """A port trace's spans rebuild into one clean timeline per request
    (no orphans) with a critical path that sums to its duration."""
    trace = str(tmp_path / "port.jsonl")
    _traced_run(side_of("port", params), trace, chaos=True)
    events = list(ttele.read_trace(trace))
    tls = ttl.build_timelines(events)
    assert tls and all(tl.orphans == [] for tl in tls.values())
    for tl in tls.values():
        assert sum(tl.critical_path().values()) == pytest.approx(tl.duration_ms)
    assert any(s.kind == "recovery_replay" for tl in tls.values() for s in tl.spans)
    assert ttl.validate_chrome_trace(ttl.to_chrome_trace(tls)) == []


# ---------------------------------------------------------------------------
# the read side, rendering, plans and workloads
# ---------------------------------------------------------------------------

def test_timeline_fixture_rebuilds_as_the_reference():
    def view(tl_mod, read):
        events = list(read(FIXTURE))
        tls = tl_mod.build_timelines(events)
        return ({tid: (tl.critical_path(), tl.attribution(), tl.dominant_kind(),
                       [s.span_id for s in tl.orphans], tl.replicas)
                 for tid, tl in tls.items()},
                tl_mod.slo_blame(events, tls), tl_mod.to_chrome_trace(tls))

    port = view(ttl, ttele.read_trace)
    assert set(port[0]) == {"r0/5", "r1/6"}
    assert port == view(jtl, jtele.read_trace)


def _fill(registry_cls):
    reg = registry_cls()
    reg.counter("serve_admitted_total").inc(3)
    reg.counter("compile_cache", {"outcome": "miss", "kind": "decode"}).inc()
    reg.gauge("serve_tenant_committed_tokens", {"tenant": 'a"b\\c\nd'}).set(12)
    reg.gauge("cache_utilization").set(0.375)
    for v in (1.0, 3.0, 2.5, 0.25):
        reg.histogram("tick_block_ms").observe(v)
    reg.histogram("inference_request.ttft_ms").observe(5.0)
    return reg.dump()


def test_render_prometheus_matches_the_reference():
    text = ttele.render_prometheus(_fill(ttele.MetricsRegistry))
    assert "serve_admitted_total 3" in text
    assert text == jtele.render_prometheus(_fill(jtele.MetricsRegistry))


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, n_faults=5, tick_span=40),
                                dict(seed=3, degrade_last=True),
                                dict(seed=9, kinds=["fetch_hang", "preempt"])])
def test_fault_plans_match_the_reference_byte_for_byte(tmp_path, kw):
    paths = {}
    for name, mod in (("ref", jfaults), ("port", tfaults)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        mod.FaultPlan.synth(**kw).dump(paths[name])
    data = open(paths["port"], "rb").read()
    assert data and data == open(paths["ref"], "rb").read()
    loaded = tfaults.FaultPlan.load(paths["port"])
    assert [f.to_dict() for f in loaded] == [f.to_dict() for f in
                                             jfaults.FaultPlan.load(paths["ref"])]
    assert tfaults.HOOK_POINTS == jfaults.HOOK_POINTS
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


def test_workloads_and_arrivals_match_the_reference(tmp_path):
    for kw in (dict(), dict(prompt_range=(32, 128), new_range=(64, 64)),
               dict(tenants=3, priorities=4, deadline_ms=3000.0)):
        w = tload.synth_workload(48, seed=5, **kw)
        assert w == jload.synth_workload(48, seed=5, **kw)
    for process in ("poisson", "uniform", "burst"):
        assert (tload.gen_arrivals(40, 4.0, process, seed=2, burst_size=5)
                == jload.gen_arrivals(40, 4.0, process, seed=2, burst_size=5))
    for curve in ("diurnal:10:12", "step:3:20", "burst_train:0.5:4"):
        assert tload.parse_rate_curve(curve) == jload.parse_rate_curve(curve)
        for process in ("poisson", "uniform"):
            assert (tload.gen_curve_arrivals(30, 4.0, curve, seed=1, process=process)
                    == jload.gen_curve_arrivals(30, 4.0, curve, seed=1, process=process))
    w = tload.synth_workload(8, seed=1, tenants=2)
    arr = tload.gen_arrivals(8, 3.0, seed=1)
    tload.dump_workload(str(tmp_path / "p.jsonl"), w, arr)
    jload.dump_workload(str(tmp_path / "r.jsonl"), w, arr)
    assert open(tmp_path / "p.jsonl", "rb").read() == open(tmp_path / "r.jsonl", "rb").read()
    assert tload.load_workload(str(tmp_path / "p.jsonl")) == (w, arr)
    for i, item in enumerate(w):
        np.testing.assert_array_equal(tload._item_prompt(item, i, 3, 128),
                                      jload._item_prompt(item, i, 3, 128))


class _TickingClock(FakeClock):
    """A fake clock that moves a little on every read, so an open-loop run
    on it admits, queues and finishes as a real one does."""

    def __call__(self) -> float:
        self.t += 0.002
        return self.t


def _load_run(side, mod):
    clock = _TickingClock()
    cb = side.build_cb(max_slots=2, cache_len=64)
    srv = side.serving.ServingEngine(cb, clock=clock, policy="edf", max_queue_depth=2)
    work = mod.synth_workload(10, seed=3, prompt_range=(4, 12), new_range=(3, 6),
                              deadline_ms=60.0)
    arrivals = mod.gen_arrivals(10, 200.0, seed=3)
    records, wall_s = mod.run_load(srv, work, arrivals, seed=3, clock=clock,
                                   sleep=clock.advance)
    summary = mod.summarize(records, wall_s, tick_stats=srv.tick_stats())
    summary["chaos"] = mod.chaos_scorecard(records, wall_s, srv.recovery_stats())
    return records, summary


def _untimed(summary):
    """A summary without the host's measured times."""
    host = {k: v for k, v in summary["host"].items()
            if k not in ("tick_dispatch_ms_mean", "tick_block_ms_mean", "overlap_frac",
                         "block_ms_per_token")}
    return dict(summary, host=host)


def test_run_load_and_summary_match_the_reference(params):
    """The open-loop harness on a fake clock: the same records (verdicts,
    states, latencies, greedy streams) and the same scorecard but the
    host's timings; the text formats render alike."""
    ref = _load_run(side_of("ref", params), jload)
    port = _load_run(side_of("port", params), tload)
    states = {r.get("state") for r in port[0]}
    assert "finished" in states and states & {"shed", "expired"}
    assert port[0] == ref[0]
    assert _untimed(port[1]) == _untimed(ref[1])
    assert tload.format_summary(port[1]) == jload.format_summary(port[1])
    assert tload.format_ab(port[1], port[1]) == jload.format_ab(port[1], port[1])


# ---------------------------------------------------------------------------
# the port's hub, ops plane, CLI and imports
# ---------------------------------------------------------------------------

def test_hub_disabled_is_inert_and_enabled_writes_schema(tmp_path):
    off = ttele.Telemetry()
    assert off.emit("x", {"a": 1}) is None and not off.registry.dump()["histograms"]
    trace = str(tmp_path / "t.jsonl")
    hub = ttele.Telemetry(ttele.TelemetryConfig(enabled=True, trace_file=trace),
                          role="inference")
    ev = hub.emit("serving_tick", {"emitted": 3, "fused_prefill": True})
    hub.close()
    [line] = list(ttele.read_trace(trace))
    assert line["schema"] == ttele.SCHEMA_VERSION == ev["schema"]
    assert (line["kind"], line["role"], line["emitted"]) == ("serving_tick", "inference", 3)
    assert hub.summary()["metrics"]["histograms"]["serving_tick.emitted"]["count"] == 1
    with pytest.raises(NotImplementedError, match=r"item 11 \(b\)"):
        hub.compile_recorder()
    assert ttele.Telemetry().peak_flops_per_device() == 989e12
    cfg = ttele.TelemetryConfig(peak_tflops_per_device=100.0)
    assert ttele.Telemetry(cfg).peak_flops_per_device() == 100e12


def test_profiler_window_writes_a_chrome_trace(tmp_path):
    """``maybe_capture`` opens a torch.profiler window at
    ``profile_start_step`` and writes its Chrome trace when it closes."""
    import torch

    out = tmp_path / "prof"
    hub = ttele.Telemetry(ttele.TelemetryConfig(
        enabled=True, trace_file="", profile_start_step=2, profile_num_steps=2,
        profile_dir=str(out)))
    for step in range(1, 6):
        hub.maybe_capture(step)
        torch.ones(8) @ torch.ones(8)
        assert (hub._profiler is not None) == (2 <= step < 4)
    hub.close()
    [trace] = list(out.iterdir())
    assert "traceEvents" in json.loads(trace.read_text())


def test_ops_server_scrapes_a_port_serving_engine(params):
    side = side_of("port", params)
    clock = FakeClock()
    cb = side.build_cb(config={"dtype": "float32", "telemetry": {"enabled": True,
                                                                 "trace_file": ""}},
                       max_slots=2, cache_len=64)
    srv = side.serving.ServingEngine(cb, clock=clock)
    ops = srv.start_ops_server(port=0)
    assert srv.start_ops_server() is ops
    for p in prompts((5, 7, 4), seed=2):
        srv.submit(p, max_new_tokens=3)
    while srv.has_work():
        clock.advance(0.1)
        srv.step()
    with urllib.request.urlopen(ops.url + "/metrics", timeout=5) as r:
        metrics = r.read().decode()
    with urllib.request.urlopen(ops.url + "/healthz", timeout=5) as r:
        health = (r.status, json.loads(r.read()))
    with urllib.request.urlopen(ops.url + "/statusz", timeout=5) as r:
        status = json.loads(r.read())
    assert "serve_admitted_total 3" in metrics.splitlines()
    assert "serve_finished_total 3" in metrics.splitlines()
    assert health == (200, {"status": "ok"})
    assert status["requests"] == {"finished": 3} and status["ticks"] > 0
    srv.close()


def test_loadgen_cli_runs_a_toy_serve_on_the_cpu(tmp_path, capsys):
    trace = str(tmp_path / "serve.jsonl")
    plan = str(tmp_path / "plan.jsonl")
    tfaults.FaultPlan([tfaults.Fault(tick=4, kind="preempt")]).dump(plan)
    # all six arrive at once, before the first tick: an arrival during the
    # rebuild's outage would be shed "recovering", on the wall clock's timing
    rc = tload.main(["--device", "cpu", "--preset", "toy", "--requests", "6", "--rate", "200",
                     "--process", "burst", "--burst-size", "6",
                     "--cache-len", "64", "--slots", "2", "--chaos", plan,
                     "--trace-out", trace, "--json"])
    assert rc == 0
    text = capsys.readouterr().out
    summary = json.loads(text[:text.rindex("}") + 1])
    assert summary["requests"] == 6 and summary["chaos"]["rebuilds"] == 1
    assert summary["outcomes"] == {"finished": 6}
    kinds = {e["kind"] for e in ttele.read_trace(trace)}
    assert {"serving_tick", "inference_request", "span", "serving_fault"} <= kinds


@pytest.mark.parametrize("argv,item", [(["--mesh", "1:2"], "item 8"), (["--ab-mesh"], "item 8")])
def test_loadgen_refuses_the_fleet_and_mesh_flags(capsys, argv, item):
    with pytest.raises(SystemExit) as e:
        tload.main(["--device", "cpu"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and item in err


def test_serving_and_telemetry_import_without_jax():
    code = ("import sys; import deepspeed_tpu_torch.serving, deepspeed_tpu_torch.telemetry, "
            "deepspeed_tpu_torch.serving.loadgen, deepspeed_tpu_torch.faults, "
            "deepspeed_tpu_torch.serving.router, deepspeed_tpu_torch.serving.fleet, "
            "deepspeed_tpu_torch.serving.autoscaler, deepspeed_tpu_torch.serving.scenarios; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=root))
    assert out.stdout.strip() == "[]"
