"""Open-loop load generator and trace-replay harness for the serving
layer (counterpart of ``deepspeed_tpu/serving/loadgen.py``): one replica,
or a fleet of them behind a :class:`FleetRouter` (``--replicas``).

Open-loop means arrivals follow a schedule that does NOT wait for the
server — the regime that exposes tail latency and shedding (a closed loop
self-throttles and hides both). The harness:

1. generates (or replays) a workload: arrival times from a Poisson /
   uniform / bursty process or a time-varying rate curve, plus
   per-request prompt/output-length, priority, tenant, and deadline mixes;
2. drives a :class:`ServingEngine` (or a ``FleetRouter`` over several)
   in-process — submit when due, step while there is work;
3. reports what serving stacks are judged on: TTFT / TBT / queue-wait
   percentiles, goodput vs offered load, shed rate, and the host's tick
   overhead.

Workload items are plain dicts (JSONL-serializable for replay):
``{"arrival_s", "prompt_tokens" | "prompt", "max_new_tokens",
"priority", "tenant", "deadline_ms"}`` — ``prompt`` is explicit token ids
(recorded mixes); ``prompt_tokens`` a length the harness fills with
deterministic synthetic ids. The generators give the reference's
workloads and arrivals for the same seeds.

    python -m deepspeed_tpu_torch.serving.loadgen --device cpu --preset toy
    python -m deepspeed_tpu_torch.serving.loadgen --preset gpt2-125m --dtype bfloat16
    python -m deepspeed_tpu_torch.serving.loadgen --device cpu --replicas 1,2 --kill-replica 5:12
    python -m deepspeed_tpu_torch.serving.loadgen --device cpu --replicas 2 --scenario FILE.jsonl
    python -m deepspeed_tpu_torch.serving.loadgen --device cpu --mesh 1:2 --ab-mesh --mesh-out R.json

The fleet's replicas share one device (``--device``) and one host thread.
A serving mesh (``--mesh``, ``--ab-mesh``, ``--mesh-out``,
``--chaos-degrade``) runs on ranks: the command starts the processes its
widest mesh needs itself (``torch.distributed`` over a ``file://`` store
under the temporary directory; gloo on the CPU, or where ranks share a
card), runs the loadgen on rank 0 and ``inference.mesh.serve_worker`` on
the others. A mesh's ``data`` axis over 1 exits naming Queue 1 item 8 (c).
"""

import argparse
import json
import math
import os
import random
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.serving.faults import FaultInjector, FaultPlan
from deepspeed_tpu_torch.serving.recovery import RecoveryConfig
from deepspeed_tpu_torch.telemetry.registry import percentile

_PROCESSES = ("poisson", "uniform", "burst")


# -- workload synthesis ------------------------------------------------
def gen_arrivals(n: int, rate: float, process: str = "poisson",
                 seed: int = 0, burst_size: int = 8) -> List[float]:
    """``n`` arrival offsets (seconds, ascending) at ``rate`` req/s.

    poisson: exponential inter-arrivals — the memoryless open-loop
    baseline. uniform: fixed spacing (the gentlest schedule at a given
    rate). burst: groups of ``burst_size`` arriving together, bursts
    spaced to preserve the average rate — the admission-control stressor.
    """
    if n < 1:
        raise ValueError("n must be >= 1")
    if rate <= 0:
        raise ValueError("rate must be > 0 req/s")
    if process not in _PROCESSES:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(choose from {_PROCESSES})")
    rng = random.Random(seed)
    out, t = [], 0.0
    if process == "poisson":
        for _ in range(n):
            t += rng.expovariate(rate)
            out.append(t)
    elif process == "uniform":
        out = [i / rate for i in range(n)]
    else:  # burst
        if burst_size < 1:
            raise ValueError("burst_size must be >= 1")
        while len(out) < n:
            out.extend([t] * min(burst_size, n - len(out)))
            t += burst_size / rate
    return out


_CURVE_KINDS = ("diurnal", "step", "burst_train")


def parse_rate_curve(spec: str) -> dict:
    """``--rate-curve`` spec -> params dict. Shapes:

    - ``diurnal:PERIOD:PEAK`` — sinusoid between the base rate (trough)
      and PEAK req/s with period PERIOD seconds;
    - ``step:T:RATE`` — base rate until T seconds, RATE after;
    - ``burst_train:GAP:SIZE`` — bursts of SIZE requests arriving
      together every GAP seconds.
    """
    kind, _, rest = spec.partition(":")
    parts = rest.split(":") if rest else []
    if kind not in _CURVE_KINDS or len(parts) != 2:
        raise ValueError(f"rate curve {spec!r} is not KIND:A:B with KIND "
                         f"in {_CURVE_KINDS}")
    a, b = float(parts[0]), float(parts[1])
    if kind == "diurnal":
        if a <= 0:
            raise ValueError(f"diurnal period must be > 0 s (got {a})")
        return {"kind": kind, "period_s": a, "peak": b}
    if kind == "step":
        if a < 0 or b <= 0:
            raise ValueError(f"step needs T >= 0 and RATE > 0 (got {spec!r})")
        return {"kind": kind, "t_s": a, "rate": b}
    if a <= 0 or b < 1:
        raise ValueError(f"burst_train needs GAP > 0 and SIZE >= 1 "
                         f"(got {spec!r})")
    return {"kind": kind, "gap_s": a, "size": int(b)}


def gen_curve_arrivals(n: int, rate: float, curve, seed: int = 0,
                       process: str = "poisson") -> List[float]:
    """``n`` arrival offsets under a time-varying rate curve (see
    :func:`parse_rate_curve`), fully determined by ``seed``.

    The non-homogeneous schedule is generated by the standard
    time-change: unit-rate increments (seeded exponentials for
    ``poisson``, exactly 1.0 for ``uniform``) are mapped through the
    inverse of the cumulative rate Λ(t) = ∫₀ᵗ r(s) ds — so the LOCAL
    arrival rate follows the curve while the draw sequence stays the
    replayable artifact the scenario engine dumps. ``burst_train`` is
    deterministic: groups of SIZE arriving together every GAP seconds
    (the offered rate is SIZE/GAP regardless of the base ``rate``)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    if rate <= 0:
        raise ValueError("rate must be > 0 req/s")
    spec = parse_rate_curve(curve) if isinstance(curve, str) else dict(curve)
    if spec["kind"] == "burst_train":
        gap, size = float(spec["gap_s"]), int(spec["size"])
        out, t = [], 0.0
        while len(out) < n:
            out.extend([t] * min(size, n - len(out)))
            t += gap
        return out
    if spec["kind"] == "diurnal":
        period, peak = float(spec["period_s"]), float(spec["peak"])
        if peak < rate:
            raise ValueError(f"diurnal peak {peak} below base rate {rate}")
        amp = (peak - rate) / 2.0

        def lam(t):  # Λ(t) for r(t) = rate + amp*(1 - cos(2πt/period))
            return (rate + amp) * t - amp * math.sin(
                2.0 * math.pi * t / period) * period / (2.0 * math.pi)
    else:  # step
        t_s, rate2 = float(spec["t_s"]), float(spec["rate"])

        def lam(t):
            if t <= t_s:
                return rate * t
            return rate * t_s + rate2 * (t - t_s)
    if process not in ("poisson", "uniform"):
        raise ValueError(f"curve arrivals support process poisson|uniform "
                         f"(got {process!r}; bursts are the burst_train "
                         f"curve itself)")
    rng = random.Random(seed)
    out, t, target = [], 0.0, 0.0
    for _ in range(n):
        target += rng.expovariate(1.0) if process == "poisson" else 1.0
        # invert Λ by expanding bracket + bisection: Λ is strictly
        # increasing (rate > 0 everywhere), so this is deterministic to
        # float precision — the pinnable part of the artifact
        lo, hi = t, t + 1.0
        while lam(hi) < target:
            lo, hi = hi, hi + 2.0 * (hi - t) + 1.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if lam(mid) < target:
                lo = mid
            else:
                hi = mid
        t = hi
        out.append(round(t, 9))
    return out


def synth_workload(n: int, seed: int = 0, prompt_range=(4, 16),
                   new_range=(4, 16), tenants: int = 1, priorities: int = 1,
                   deadline_ms: Optional[float] = None) -> List[dict]:
    """``n`` request dicts with uniformly mixed prompt/output lengths,
    round-robin-free random tenant/priority assignment, and an optional
    uniform deadline. Fully determined by ``seed``."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        item = {
            "prompt_tokens": int(rs.randint(prompt_range[0], prompt_range[1] + 1)),
            "max_new_tokens": int(rs.randint(new_range[0], new_range[1] + 1)),
        }
        if priorities > 1:
            item["priority"] = int(rs.randint(0, priorities))
        if tenants > 1:
            item["tenant"] = f"tenant{int(rs.randint(0, tenants))}"
        if deadline_ms is not None:
            item["deadline_ms"] = float(deadline_ms)
        out.append(item)
    return out


def dump_workload(path: str, workload: List[dict],
                  arrivals: Optional[List[float]] = None):
    """Write a workload (+ arrival offsets) as replayable JSONL."""
    with open(path, "w") as fh:
        for i, item in enumerate(workload):
            rec = dict(item)
            if arrivals is not None:
                rec["arrival_s"] = arrivals[i]
            fh.write(json.dumps(rec) + "\n")


def load_workload(path: str):
    """(workload, arrivals) from a JSONL trace written by
    :func:`dump_workload` (or recorded elsewhere in the same shape).
    Arrivals is None when no line carries ``arrival_s``."""
    workload, arrivals = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            arrivals.append(rec.pop("arrival_s", None))
            workload.append(rec)
    if not workload:
        raise ValueError(f"no workload records in {path}")
    if any(a is None for a in arrivals):
        return workload, None
    return workload, arrivals


# -- driving the engine ------------------------------------------------
def _item_prompt(item: dict, index: int, seed: int, vocab: int) -> np.ndarray:
    if "prompt" in item:
        return np.asarray(item["prompt"], np.int32)
    n = int(item["prompt_tokens"])
    # per-item stream: prompts don't shift when the mix is resliced
    return np.random.RandomState(seed + index).randint(0, vocab, (n,)).astype(np.int32)


def run_load(serving, workload: List[dict], arrivals: List[float],
             seed: int = 0, clock=time.monotonic, sleep=time.sleep):
    """Drive ``serving`` open-loop: submit each workload item at its
    arrival offset (never waiting for the server), stepping whenever
    there is work. Returns ``(records, wall_s)`` — one record per item
    with the admission verdict and, for admitted requests, the final
    lifecycle numbers (queue/ttft/tbt ms, tokens, deadline_met)."""
    if len(arrivals) != len(workload):
        raise ValueError(f"{len(workload)} workload items but "
                         f"{len(arrivals)} arrival times")
    # works for a single ServingEngine AND a FleetRouter — both expose
    # the same submit/step/reap/vocab_size surface
    vocab = serving.vocab_size
    n = len(workload)
    records: List[dict] = [{} for _ in range(n)]
    rid_to_index: Dict[int, int] = {}
    t0 = clock()
    i = 0
    while i < n or serving.has_work():
        now = clock() - t0
        while i < n and arrivals[i] <= now:
            item = workload[i]
            adm = serving.submit(
                _item_prompt(item, i, seed, vocab),
                int(item.get("max_new_tokens", 32)),
                priority=int(item.get("priority", 0)),
                tenant=str(item.get("tenant", "default")),
                deadline_ms=item.get("deadline_ms"),
            )
            rec = records[i]
            rec["status"] = adm.status
            rec["arrival_s"] = arrivals[i]
            if adm:
                rid_to_index[adm.rid] = i
                rec["rid"] = adm.rid
            else:
                rec["state"] = "shed"
                rec["reason"] = adm.reason
                if adm.retry_after_s is not None:
                    rec["retry_after_s"] = adm.retry_after_s
            i += 1
        if serving.has_work():
            serving.step()
        elif i < n:
            # idle before the next arrival: don't spin the host
            sleep(min(max(arrivals[i] - (clock() - t0), 0.0), 0.002))
    wall_s = clock() - t0
    for rid, req in serving.reap().items():
        rec = records[rid_to_index[rid]]
        rec["state"] = req.state
        rec["tokens"] = len(req.tokens)
        rec["generated"] = list(req.tokens)  # parity checks / replay diffing
        if req.recoveries:
            rec["recoveries"] = req.recoveries
        if req.finish_t is not None:
            # completion timeline (same clock as arrivals): the chaos
            # scorecard bins these to measure the goodput dip
            rec["finish_s"] = req.finish_t - t0
        q = req.queue_ms()
        if q is not None:
            rec["queue_ms"] = q
        t = req.ttft_ms()
        if t is not None:
            rec["ttft_ms"] = t
        if (req.first_token_t is not None and req.finish_t is not None
                and len(req.tokens) > 1):
            rec["tbt_ms"] = ((req.finish_t - req.first_token_t) * 1000.0
                             / (len(req.tokens) - 1))
        if req.deadline_met is not None:  # the shared per-request verdict
            rec["deadline_met"] = req.deadline_met
    return records, wall_s


# -- reporting ---------------------------------------------------------
def _pcts(vals: List[float]) -> dict:
    return {"p50": percentile(vals, 50.0), "p99": percentile(vals, 99.0)}


def host_overhead(tick_stats: dict) -> dict:
    """Host-overhead columns from a ``ServingEngine.tick_stats()`` (or the
    bare engine's) snapshot: mean dispatch vs blocked ms per scheduler
    step, the overlap fraction (host tick-loop time NOT spent blocked on
    device results), and the A/B headline — host-blocked ms per decoded
    token."""
    steps = tick_stats.get("steps", 0)
    out = {
        "pipeline_depth": tick_stats.get("pipeline_depth"),
        "ticks": tick_stats.get("ticks", 0),
        "tick_dispatch_ms_mean": (round(tick_stats["dispatch_ms"] / steps, 4)
                                  if steps else None),
        "tick_block_ms_mean": (round(tick_stats["block_ms"] / steps, 4)
                               if steps else None),
        "overlap_frac": tick_stats.get("overlap_frac"),
        "block_ms_per_token": tick_stats.get("block_ms_per_token"),
        "wasted_tokens": tick_stats.get("wasted_tokens", 0),
    }
    if "utilization" in tick_stats:
        out["tick_utilization"] = tick_stats["utilization"]
    if tick_stats.get("spec_gamma"):
        out["spec_gamma"] = tick_stats["spec_gamma"]
        out["spec_mode"] = tick_stats.get("spec_mode")
        out["spec_drafted"] = tick_stats.get("spec_drafted", 0)
        out["spec_accepted"] = tick_stats.get("spec_accepted", 0)
        out["spec_acceptance"] = tick_stats.get("spec_acceptance")
    return out


def goodput_dip(records: List[dict], wall_s: float, bins: int = 10) -> Optional[dict]:
    """The chaos-scorecard headline: bin finished requests' output tokens
    by completion time (``finish_s``) and compare the worst bin inside
    the active window (first completion .. last completion — zeros in
    between are genuine outage, not warmup/tail) against the median bin.
    Returns ``{bin_s, baseline_tok_s, floor_tok_s, dip_frac}`` or None
    when there are not enough completions to observe a rate."""
    pts = [(float(r["finish_s"]), int(r.get("tokens", 0))) for r in records
           if r.get("state") == "finished" and "finish_s" in r]
    if not pts or wall_s <= 0 or bins < 1:
        return None
    width = wall_s / bins
    if width <= 0:
        return None
    binned = [0.0] * bins
    for t, tok in pts:
        binned[min(bins - 1, max(0, int(t / width)))] += tok
    hot = [i for i, v in enumerate(binned) if v > 0]
    window = binned[hot[0]:hot[-1] + 1]
    if len(window) < 2:
        return None  # one active bin: no dip is observable
    # baseline = the healthy completion rate (median of the BUSY bins —
    # an outage long enough to dominate the window must read as a deep
    # dip, not drag the baseline to zero); floor = the worst bin inside
    # the window, zeros included
    busy = sorted(v / width for v in window if v > 0)
    baseline = busy[len(busy) // 2]
    floor = min(v / width for v in window)
    if baseline <= 0:
        return None
    return {"bin_s": round(width, 3),
            "baseline_tok_s": round(baseline, 3),
            "floor_tok_s": round(floor, 3),
            "dip_frac": round(1.0 - floor / baseline, 4)}


def chaos_scorecard(records: List[dict], wall_s: float, recovery: dict,
                    injected: Optional[List[dict]] = None) -> dict:
    """The ``--chaos`` section: the serving engine's recovery accounting
    (``ServingEngine.recovery_stats()``) + the goodput dip measured from
    the completion timeline + the injector's fired-fault log."""
    out = dict(recovery)
    if injected is not None:
        out["injected"] = len(injected)
    recovered = sum(1 for r in records if r.get("recoveries"))
    out["recovered_requests"] = recovered
    dip = goodput_dip(records, wall_s)
    if dip is not None:
        out["goodput_dip"] = dip
    return out


def fleet_scorecard(router, records: List[dict]) -> dict:
    """The ``fleet`` summary section for a :class:`FleetRouter` run:
    per-replica placement outcomes (from the fleet ``statusz``) plus the
    conservation check the failover contract promises — every admitted
    request ends terminal (finished / shed / expired / cancelled);
    replica death loses none silently."""
    st = router.statusz()
    placed = [r for r in records if "rid" in r]
    terminal = sum(1 for r in placed if "state" in r)
    return {
        "replicas": {
            rid: {"state": info["state"], "admitted": info["admitted"],
                  "shed": info["shed"],
                  "migrated_in": info["migrated_in"],
                  "migrated_out": info["migrated_out"]}
            for rid, info in sorted(st["replicas"].items())
        },
        "submitted": st["submitted"],
        "admitted": st["admitted"],
        "shed": st["shed"],
        "spillovers": st["spillovers"],
        "migrated": st["migrated"],
        "lost": st["lost"],
        "replica_deaths": st["replica_deaths"],
        "conservation_ok": (terminal == len(placed)
                            and len(placed) == st["admitted"]),
    }


def format_fleet_sweep(results: "Dict[str, dict]") -> str:
    """``--replicas 1,2,4``: one scorecard per fleet size plus the
    goodput / SLO-met curve table — the scaling headline of a sweep."""
    lines = []
    for n in sorted(results, key=int):
        lines += [f"== fleet: {n} replica(s) ==",
                  format_summary(results[n]).rstrip(), ""]
    lines.append("replicas  throughput  goodput   shed     deadline-met")
    for n in sorted(results, key=int):
        s = results[n]
        dm = s.get("deadline_met_frac")
        lines.append(f"{n:<9} {s['throughput_tok_s']:<11} "
                     f"{s['goodput_tok_s']:<9} {s['shed_rate']:<8.2%} "
                     f"{f'{dm:.2%}' if dm is not None else '-'}")
    return "\n".join(lines) + "\n"


def fleet_record(results: "Dict[str, dict]", workload_args: dict,
                 device: str = "cuda") -> dict:
    """FLEET_*-style JSON record for a ``--replicas`` sweep: the
    goodput/SLO curve per fleet size plus the full summaries, in the
    shape the repo's committed perf records use. ``device`` is where the
    replicas ran: the record names that device's kind and count."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        device_kind = torch.cuda.get_device_name(dev)
        n_devices = torch.cuda.device_count()
    else:
        device_kind, n_devices = dev.type, 1
    curves = {
        n: {
            "throughput_tok_s": s.get("throughput_tok_s"),
            "goodput_tok_s": s.get("goodput_tok_s"),
            "shed_rate": s.get("shed_rate"),
            "deadline_met_frac": s.get("deadline_met_frac"),
            "ttft_ms": s.get("ttft_ms"),
            "replica_deaths": (s.get("fleet") or {}).get("replica_deaths"),
            "migrated": (s.get("fleet") or {}).get("migrated"),
            "lost": (s.get("fleet") or {}).get("lost"),
            "conservation_ok": (s.get("fleet") or {}).get("conservation_ok"),
        }
        for n, s in results.items()
    }
    return {
        "kind": "serving_fleet_sweep",
        "device_kind": device_kind,
        "n_devices": n_devices,
        "replicas": sorted(int(n) for n in results),
        "curves": curves,
        "workload": workload_args,
        "summaries": results,
    }


def summarize(records: List[dict], wall_s: float,
              tick_stats: Optional[dict] = None) -> dict:
    """The serving scorecard over one run's records: counts per outcome,
    TTFT/TBT/queue-wait p50/p99, offered load, throughput, goodput
    (deadline-met output tokens per second — all finished tokens when the
    workload carries no deadlines), shed rate, deadline-met fraction.
    ``tick_stats`` (ServingEngine.tick_stats()) adds the ``host`` section:
    dispatch/blocked ms, overlap fraction, blocked ms per token."""
    by_state: Dict[str, int] = {}
    for r in records:
        state = r.get("state", r.get("status", "?"))
        by_state[state] = by_state.get(state, 0) + 1
    finished = [r for r in records if r.get("state") == "finished"]
    shed = [r for r in records if r.get("state") in ("shed", "expired")]
    arrivals = [r["arrival_s"] for r in records if "arrival_s" in r]
    span = max(arrivals) if arrivals else 0.0
    out = {
        "requests": len(records),
        "outcomes": dict(sorted(by_state.items())),
        "wall_s": round(wall_s, 3),
        "offered_rps": round(len(records) / span, 3) if span > 0 else None,
        "shed_rate": round(len(shed) / len(records), 4) if records else 0.0,
    }
    # honest-retry accounting per shed reason: how many verdicts carried
    # a retry_after_s hint and the mean hint (a trace report computes the
    # same table from the serving_event stream)
    by_reason: Dict[str, dict] = {}
    for r in records:
        if r.get("state") != "shed":
            continue
        # reaped sheds (admitted, then shed by recovery) carry no
        # admission reason — bucket them separately, they are
        # post-admission losses, not admission-control verdicts
        d = by_reason.setdefault(r.get("reason", "post_admission"),
                                 {"count": 0, "with_hint": 0, "hints": []})
        d["count"] += 1
        if r.get("retry_after_s") is not None:
            d["with_hint"] += 1
            d["hints"].append(float(r["retry_after_s"]))
    if by_reason:
        out["shed_by_reason"] = {
            reason: {
                "count": d["count"],
                "with_hint": d["with_hint"],
                "retry_after_s_mean": (round(sum(d["hints"]) / len(d["hints"]),
                                             4) if d["hints"] else None),
            }
            for reason, d in sorted(by_reason.items())
        }
    for field in ("ttft_ms", "tbt_ms", "queue_ms"):
        vals = [r[field] for r in finished if field in r]
        if vals:
            out[field] = {k: round(v, 3) for k, v in _pcts(vals).items()}
    total_tokens = sum(r.get("tokens", 0) for r in finished)
    out["throughput_tok_s"] = round(total_tokens / wall_s, 3) if wall_s > 0 else 0.0
    with_deadline = [r for r in finished if "deadline_met" in r]
    good_tokens = sum(r.get("tokens", 0) for r in finished
                      if r.get("deadline_met", True))
    out["goodput_tok_s"] = round(good_tokens / wall_s, 3) if wall_s > 0 else 0.0
    if with_deadline:
        out["deadline_met_frac"] = round(
            sum(1 for r in with_deadline if r["deadline_met"])
            / len(with_deadline), 4)
    if tick_stats is not None:
        out["host"] = host_overhead(tick_stats)
    return out


def format_summary(summary: dict) -> str:
    lines = ["== ds_loadgen summary =="]
    oc = " ".join(f"{k}={v}" for k, v in summary["outcomes"].items())
    lines.append(f"requests       {summary['requests']}  ({oc})")
    if summary.get("offered_rps") is not None:
        lines.append(f"offered load   {summary['offered_rps']} req/s over "
                     f"{summary['wall_s']} s wall")
    else:
        lines.append(f"wall time      {summary['wall_s']} s")
    for field, label in (("ttft_ms", "TTFT"), ("tbt_ms", "TBT"),
                         ("queue_ms", "queue wait")):
        if field in summary:
            p = summary[field]
            lines.append(f"{label:<14} p50 {p['p50']:.1f} ms   p99 {p['p99']:.1f} ms")
    lines.append(f"throughput     {summary['throughput_tok_s']} tok/s")
    lines.append(f"goodput        {summary['goodput_tok_s']} tok/s")
    lines.append(f"shed rate      {summary['shed_rate']:.2%}")
    sbr = summary.get("shed_by_reason")
    if sbr:
        parts = []
        for reason, d in sbr.items():
            hint = (f" hint~{d['retry_after_s_mean']}s"
                    if d["retry_after_s_mean"] is not None else "")
            parts.append(f"{reason}={d['count']} "
                         f"({d['with_hint']} hinted{hint})")
        lines.append("shed reasons   " + "   ".join(parts))
    if "deadline_met_frac" in summary:
        lines.append(f"deadline met   {summary['deadline_met_frac']:.2%}")
    host = summary.get("host")
    if host:
        def _ms(v):
            return f"{v:.3f} ms" if isinstance(v, (int, float)) else "-"

        lines.append(f"host overhead  dispatch {_ms(host['tick_dispatch_ms_mean'])}"
                     f"/step   blocked {_ms(host['tick_block_ms_mean'])}/step"
                     + (f"   overlap {host['overlap_frac']:.1%}"
                        if host.get("overlap_frac") is not None else ""))
        lines.append(f"blocked/token  {_ms(host['block_ms_per_token'])}  "
                     f"(pipeline depth {host['pipeline_depth']}, "
                     f"wasted {host['wasted_tokens']} tok)")
        if host.get("spec_gamma"):
            acc = host.get("spec_acceptance")
            per = (f"{acc * host['spec_gamma']:.2f}/{host['spec_gamma']}"
                   if acc is not None else "-")
            lines.append(
                f"speculative    gamma {host['spec_gamma']} "
                f"({host.get('spec_mode') or '?'})   accepted/draft {per}"
                + (f"   acceptance {acc:.1%}" if acc is not None else ""))
    chaos = summary.get("chaos")
    if chaos:
        lines.append(
            f"chaos          faults {chaos.get('faults', 0)}"
            + (f" (injected {chaos['injected']})" if "injected" in chaos else "")
            + f"   retries {chaos.get('retries', 0)}"
              f"   rebuilds {chaos.get('rebuilds', 0)}"
              f"   degrade level {chaos.get('degrade_level', 0)}")
        lines.append(
            f"recovery       lost ticks {chaos.get('lost_ticks', 0)}"
            f"   lost requests {chaos.get('lost_requests', 0)}"
            f"   recovered requests {chaos.get('recovered_requests', 0)}"
            f"   outage {chaos.get('outage_ms_total', 0.0)} ms")
        rms = chaos.get("recovery_ms")
        if rms:
            lines.append(f"recovery_ms    p50 {rms['p50']} ms   "
                         f"max {rms['max']} ms  ({rms['count']} rebuilds)")
        dip = chaos.get("goodput_dip")
        if dip:
            lines.append(f"goodput dip    {dip['dip_frac']:.1%}  "
                         f"(floor {dip['floor_tok_s']} tok/s vs median "
                         f"{dip['baseline_tok_s']} tok/s over "
                         f"{dip['bin_s']}s bins)")
    scaler = summary.get("autoscaler")
    if scaler:
        lines.append(
            f"autoscaler     ups {scaler.get('scale_ups', 0)}   "
            f"downs {scaler.get('scale_downs', 0)}   "
            f"skips {scaler.get('scale_down_skips', 0)}   "
            f"degrade level {scaler.get('degrade_level', 0)}   "
            f"mean replicas {scaler.get('mean_replicas')}")
    if summary.get("scenario"):
        lines.append(f"scenario       {summary['scenario']}")
    fleet = summary.get("fleet")
    if fleet:
        reps = "  ".join(
            f"{rid}:{info['state']} adm={info['admitted']} "
            f"mig={info['migrated_in']}/{info['migrated_out']}"
            for rid, info in fleet["replicas"].items())
        lines.append(f"fleet          {reps}")
        lines.append(
            f"               deaths {fleet['replica_deaths']}   "
            f"migrated {fleet['migrated']}   lost {fleet['lost']}   "
            f"spillovers {fleet['spillovers']}   conservation "
            + ("ok" if fleet["conservation_ok"] else "VIOLATED"))
    return "\n".join(lines) + "\n"


def format_mesh_ab(results: "Dict[str, dict]") -> str:
    """Side-by-side sharded-vs-replicated comparison (``--mesh`` sweep /
    ``--ab-mesh``): one scorecard per mesh width, then the throughput and
    host-blocked ms per token of each width against the replicated
    (``1x1``) side."""
    def _dims(key):  # numeric order: 1x2 before 1x16
        d, _, t = key.partition("x")
        try:
            return (int(d), int(t))
        except ValueError:
            return (1 << 30, 0)

    keys = sorted(results, key=lambda k: (k != "1x1", _dims(k)))
    lines = []
    for key in keys:
        lines += [f"== mesh {key} ==", format_summary(results[key]).rstrip(), ""]
    base = results.get("1x1")
    if base is not None:
        for key in keys:
            if key == "1x1":
                continue
            cur = results[key]
            t0, t1 = base.get("throughput_tok_s"), cur.get("throughput_tok_s")
            if t0 and t1 is not None:
                lines.append(f"throughput tok/s 1x1 -> {key}: {t0} -> {t1} "
                             f"({t1 / t0:.2f}x)")
            b0 = (base.get("host") or {}).get("block_ms_per_token")
            b1 = (cur.get("host") or {}).get("block_ms_per_token")
            if b0 is not None and b1 is not None:
                lines.append(f"host-blocked ms/token 1x1 -> {key}: "
                             f"{b0:.4f} -> {b1:.4f}")
    return "\n".join(lines) + "\n"


def mesh_record(results: "Dict[str, dict]", workload_args: dict,
                device: str = "cuda") -> dict:
    """The JSON serving record of a mesh sweep: per-width throughput and
    host-blocked ms per token, the winning width, the workload and the
    summaries. ``device_kind`` names the ranks' device and ``n_devices``
    the ranks of the world."""
    import torch

    from deepspeed_tpu_torch import comm

    dev = torch.device(device)
    device_kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    per_width = {
        key: {
            "throughput_tok_s": s.get("throughput_tok_s"),
            "goodput_tok_s": s.get("goodput_tok_s"),
            "block_ms_per_token": (s.get("host") or {}).get("block_ms_per_token"),
            "overlap_frac": (s.get("host") or {}).get("overlap_frac"),
            "shed_rate": s.get("shed_rate"),
            "ttft_ms": s.get("ttft_ms"),
        }
        for key, s in results.items()
    }
    winner = max(results, key=lambda k: results[k].get("throughput_tok_s") or 0.0)
    return {
        "kind": "serving_mesh_ab",
        "device_kind": device_kind,
        "n_devices": comm.process_world()[1],
        "meshes": per_width,
        "winner": winner,
        "workload": workload_args,
        "summaries": results,
    }


def format_ab(sync: dict, pipelined: dict) -> str:
    """Side-by-side sync-vs-pipelined comparison (``--pipeline-depth`` A/B):
    the two scorecards plus the headline ratios — host-blocked ms per
    decoded token and throughput."""
    lines = ["== pipeline A/B: sync (depth 0) ==", format_summary(sync).rstrip(),
             "", f"== pipelined (depth {pipelined['host']['pipeline_depth']}) ==",
             format_summary(pipelined).rstrip(), ""]
    b0 = (sync.get("host") or {}).get("block_ms_per_token")
    b1 = (pipelined.get("host") or {}).get("block_ms_per_token")
    if b0 is not None and b1 is not None:
        # a (near-)zero pipelined value is the BEST case, not a missing one
        ratio = f" ({b0 / b1:.2f}x less blocking)" if 0 < b1 < b0 else ""
        lines.append(f"host-blocked ms/token: {b0:.4f} -> {b1:.4f}{ratio}")
    t0, t1 = sync.get("throughput_tok_s"), pipelined.get("throughput_tok_s")
    if t0 is not None and t1 is not None and t0 > 0:
        lines.append(f"throughput tok/s:      {t0} -> {t1} ({t1 / t0:.2f}x)")
    return "\n".join(lines) + "\n"


def format_spec_ab(plain: dict, spec: dict) -> str:
    """Side-by-side plain-vs-speculative comparison (``--ab-spec``): the
    two scorecards over the SAME replayed workload plus the headlines —
    the speculative side's accepted-tokens-per-draft and the decode
    throughput ratio."""
    host = spec.get("host") or {}
    g = host.get("spec_gamma")
    label = (f"gamma {g}, {host.get('spec_mode')}" if g else "speculative")
    lines = ["== spec A/B: plain single-token ticks ==",
             format_summary(plain).rstrip(), "",
             f"== speculative ({label}) ==", format_summary(spec).rstrip(),
             ""]
    acc = host.get("spec_acceptance")
    if g and acc is not None:
        lines.append(f"accepted per draft:    {acc * g:.2f} / {g} "
                     f"(acceptance {acc:.1%}, "
                     f"{host.get('spec_drafted', 0)} drafted)")
    t0, t1 = plain.get("throughput_tok_s"), spec.get("throughput_tok_s")
    if t0 and t1 is not None:
        lines.append(f"decode tok/s:          {t0} -> {t1} ({t1 / t0:.2f}x)")
    return "\n".join(lines) + "\n"


# -- CLI ---------------------------------------------------------------
def _parse_range(spec: str):
    lo, sep, hi = spec.partition(":")
    if not sep:
        return int(lo), int(lo)
    return int(lo), int(hi)


def _parse_kill(spec: str):
    # "12" -> (12, None); "12:40" -> (12, 40)
    tick, sep, restore = spec.partition(":")
    return int(tick), (int(restore) if sep else None)


def _parse_buckets(spec: str):
    # "2x32,1x64" -> [(2, 32), (1, 64)]
    out = []
    for part in spec.split(","):
        slots, sep, length = part.strip().partition("x")
        if not sep:
            raise ValueError(f"bucket spec {part!r} is not SLOTSxLEN")
        out.append((int(slots), int(length)))
    return out


def _mesh_shapes(spec: Optional[str]) -> List[dict]:
    from deepspeed_tpu_torch.parallel.partition import parse_mesh_arg

    return [parse_mesh_arg(x) for x in spec.split(",")] if spec else []


def _mesh_rank(rank: int, world: int, store: str, device: str, argv, rc_file: str):
    """One rank of a loadgen mesh run: the process group, then the loadgen
    on rank 0 and a serving worker on every other rank."""
    import datetime

    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference import mesh as mesh_mod

    torch.set_num_threads(1)
    if device == "cuda":
        backend = "nccl" if torch.cuda.device_count() >= world else "gloo"  # ranks share a card
        dev = f"cuda:{rank % torch.cuda.device_count()}"
    else:
        backend, dev = "gloo", "cpu"
    comm.init_distributed(device=dev, init_method=f"file://{store}", rank=rank, world_size=world,
                          dist_backend=backend, timeout=datetime.timedelta(seconds=600),
                          verbose=False)
    try:
        if rank == 0:
            try:
                rc = main(argv)
            finally:
                mesh_mod.shutdown()
            with open(rc_file, "w") as fh:
                fh.write(str(rc))
        else:
            mesh_mod.serve_worker(dev)
    finally:
        comm.destroy()


def _spawn_mesh_ranks(argv, world: int, device: str) -> int:
    """Run this command as ``world`` ranks (spawned here) and return rank
    0's exit code."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="loadgen-mesh-") as tmp:
        rc_file = os.path.join(tmp, "rc")
        mp.start_processes(_mesh_rank, args=(world, os.path.join(tmp, "store"), device,
                                             list(argv), rc_file),
                           nprocs=world, join=True, start_method="spawn")
        with open(rc_file) as fh:
            return int(fh.read())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="open-loop load generator for the serving layer: "
                    "drives ServingEngine over ContinuousBatchingEngine "
                    "and reports TTFT/TBT/goodput/shed")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--rate", type=float, default=8.0, help="offered req/s")
    p.add_argument("--process", choices=_PROCESSES, default="poisson")
    p.add_argument("--burst-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompt-range", default="4:16", metavar="LO:HI")
    p.add_argument("--new-range", default="4:16", metavar="LO:HI")
    p.add_argument("--tenants", type=int, default=1)
    p.add_argument("--priorities", type=int, default=1,
                   help="priority levels to mix (1 = all equal)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request SLO; enables goodput/deadline stats")
    p.add_argument("--preset", default="toy",
                   help="'toy' (tiny CPU-runnable model) or a "
                        "models/transformer.py preset name")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the engine runs (the port never falls back "
                        "to the CPU on its own)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--buckets", default=None, metavar="SxL,SxL",
                   help="cache_buckets instead of --slots/--cache-len, "
                        "e.g. 6x128,2x512")
    p.add_argument("--tokens-per-tick", type=int, default=1)
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="ticks kept in flight (dispatch-ahead pipelining); "
                        "0 = fully synchronous scheduler")
    p.add_argument("--no-fused-prefill", action="store_true",
                   help="admit via the separate B=1 prefill + splice "
                        "instead of riding prompt chunks inside the tick")
    p.add_argument("--no-donate", action="store_true",
                   help="tick state on copies instead of in place")
    p.add_argument("--ab-pipeline", action="store_true",
                   help="run the SAME workload twice — sync (depth 0) vs "
                        "--pipeline-depth — and report both scorecards "
                        "plus the host-blocked-ms/token ratio")
    p.add_argument("--speculative", default=None, metavar="GAMMA[:MODE]",
                   help="serve with speculative pool ticks: GAMMA draft "
                        "tokens verified per tick, MODE 'ngram' (default) "
                        "or 'draft' (the toy preset builds a 1-layer toy "
                        "draft, other presets need --draft-preset). "
                        "Requires --tokens-per-tick 1")
    p.add_argument("--draft-preset", default=None,
                   help="draft-model preset for --speculative GAMMA:draft "
                        "(must share the target's vocabulary)")
    p.add_argument("--ab-spec", action="store_true",
                   help="run the SAME workload twice — plain single-token "
                        "ticks vs --speculative — and report both "
                        "scorecards plus accepted-per-draft and the "
                        "decode tok/s ratio")
    p.add_argument("--warm", action="store_true",
                   help="run the tick family once and drive one synthetic "
                        "request per prompt bucket BEFORE the measured run "
                        "(tick stats reset afterwards)")
    p.add_argument("--chaos", default=None, metavar="PLAN.jsonl",
                   help="fault-injection plan (FaultPlan JSONL: tick/kind "
                        "lines, kinds dispatch_error|fetch_hang|preempt). "
                        "Arms watchdog+recovery: failed ticks retry with "
                        "backoff, lost engines rebuild and re-admit every "
                        "in-flight request mid-stream; the summary gains "
                        "a recovery-time + goodput-dip scorecard")
    p.add_argument("--tick-retries", type=int, default=2,
                   help="bounded retry budget for a clean tick failure "
                        "before escalating to engine rebuild (--chaos)")
    p.add_argument("--fetch-timeout-s", type=float, default=None,
                   help="watchdog on the per-tick packed-result fetch; "
                        "an over-budget fetch abandons the engine and "
                        "triggers a rebuild (--chaos)")
    p.add_argument("--replicas", default=None, metavar="N[,N..]",
                   help="serve through a FleetRouter over N ServingEngine "
                        "replicas on the one --device; a comma list "
                        "(e.g. 1,2,4) sweeps fleet sizes over the SAME "
                        "workload and reports the goodput/SLO-met curve")
    p.add_argument("--kill-replica", default=None, metavar="TICK[:RESTORE]",
                   help="chaos: abruptly kill the lowest-slot healthy "
                        "replica at router tick TICK (1-based, replayable "
                        "— same surface as the fault plans); live streams "
                        "migrate to survivors and resume bitwise. With "
                        ":RESTORE, a fresh replica joins at that tick")
    p.add_argument("--rolling-restart", type=int, default=None,
                   metavar="TICK", help="start a zero-loss rolling restart "
                        "of the whole fleet at router tick TICK (add the "
                        "replacement first, then drain — capacity never "
                        "dips)")
    p.add_argument("--fleet-out", default=None, metavar="FILE",
                   help="write the --replicas sweep as a FLEET_*-style "
                        "JSON record (goodput/SLO curve per fleet size)")
    p.add_argument("--policy", default="fifo",
                   choices=("fifo", "priority", "edf", "fair"))
    p.add_argument("--queue-depth", type=int, default=64)
    p.add_argument("--kv-budget", type=int, default=None,
                   help="KV token budget (default: 2x pool capacity)")
    p.add_argument("--aging-s", type=float, default=30.0)
    p.add_argument("--ops-port", type=int, default=None, metavar="PORT",
                   help="serve the live ops plane (/metrics /healthz "
                        "/statusz) during the run; 0 binds an ephemeral "
                        "port (printed at start)")
    p.add_argument("--trace-out", default=None,
                   help="telemetry JSONL destination")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   metavar="P",
                   help="request-scoped span sampling probability in "
                        "[0,1] (default 1.0 = trace every request), seeded "
                        "(--seed) and deterministic per request id")
    p.add_argument("--replay", default=None,
                   help="replay a JSONL workload (dump_workload shape) "
                        "instead of synthesizing one")
    p.add_argument("--rate-curve", default=None, metavar="KIND:A:B",
                   help="time-varying arrival rate instead of a flat "
                        "--process schedule: diurnal:PERIOD:PEAK, "
                        "step:T:RATE or burst_train:GAP:SIZE")
    p.add_argument("--scenario", default=None, metavar="FILE.jsonl",
                   help="run a serving/scenarios.py scenario: one seeded "
                        "JSONL artifact composing a rate curve, tenant/"
                        "deadline mixes, and (fleet mode) embedded "
                        "replica chaos — see scenarios/ for the checked-"
                        "in matrix")
    p.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                   help="fleet mode: attach the serving/autoscaler.py "
                        "policy loop — scale between MIN and MAX "
                        "replicas off queue/shed/occupancy signals, "
                        "walking the degradation ladder when capped")
    p.add_argument("--autoscale-cooldown", type=float, default=2.0,
                   metavar="S", help="min seconds between autoscaler "
                        "decisions (hysteresis)")
    p.add_argument("--dump-workload", default=None,
                   help="write the synthesized workload+arrivals as "
                        "replayable JSONL")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the summary as JSON instead of the table")
    p.add_argument("--mesh", default=None, metavar="DATA:TENSOR[,..]",
                   help="serving mesh shape(s), e.g. 1:2: attention heads, "
                        "the MLP's hidden dim, the vocabulary and the KV "
                        "cache's heads split over that many ranks, which "
                        "this command starts itself. A comma list sweeps "
                        "widths over the same workload")
    p.add_argument("--ab-mesh", action="store_true",
                   help="sharded-vs-replicated A/B: the SAME workload on "
                        "the 1:1 mesh AND every --mesh width, per-width "
                        "scorecards and throughput/host-blocked ratios")
    p.add_argument("--mesh-out", default=None, metavar="FILE",
                   help="write the mesh sweep as a JSON serving record "
                        "(per-width throughput, host-blocked ms/token, "
                        "winner)")
    p.add_argument("--chaos-degrade", default=None, metavar="D:T[,..]",
                   help="graceful-degradation ladder for --chaos: mesh "
                        "shape(s) to rebuild on when the full-size "
                        "rebuild fails or a preemption took capacity, "
                        "e.g. 1:1 after serving --mesh 1:2")
    args = p.parse_args(argv)

    try:
        meshes = _mesh_shapes(args.mesh)
        degrade_shapes = _mesh_shapes(args.chaos_degrade)
    except ValueError as e:
        p.error(str(e))
    for shape in meshes + degrade_shapes:
        if shape.get("data", 1) > 1:
            p.error(f"mesh {shape}: a serving mesh with data > 1 is not ported to "
                    f"deepspeed_tpu_torch yet (ROADMAP Queue 1 item 8 (c))")
    if args.chaos_degrade and not args.chaos:
        p.error("--chaos-degrade needs --chaos (it is the rebuild ladder of a "
                "fault-injected run)")
    if args.mesh_out and not meshes:
        p.error("--mesh-out needs --mesh (the record is keyed by the explicit "
                "serving mesh shape)")
    if args.mesh_out and (args.ab_pipeline or args.ab_spec):
        p.error("--mesh-out records a per-width mesh sweep; it does not "
                "combine with --ab-pipeline / --ab-spec")
    if args.chaos and (args.ab_mesh or args.mesh_out or len(meshes) > 1):
        p.error("--chaos measures one fault-injected run; it does not "
                "combine with the mesh A/B or the mesh sweep")
    if args.ab_mesh or len(meshes) > 1:
        if args.ab_pipeline or args.ab_spec:
            p.error("--ab-pipeline / --ab-spec do not combine with --ab-mesh / a "
                    "multi-width --mesh sweep (the sweep runs one configuration a "
                    "width); run the other A/B per width separately")
        if not [m for m in meshes if (m.get("data", 1), m.get("tensor", 1)) != (1, 1)]:
            p.error("--ab-mesh needs at least one non-1x1 --mesh width to compare "
                    "against the replicated baseline, e.g. --mesh 1:2")
    from deepspeed_tpu_torch import comm

    world = max([s.get("data", 1) * s.get("tensor", 1) for s in meshes + degrade_shapes]
                or [1])
    if world > 1 and comm.process_world()[1] == 1:
        return _spawn_mesh_ranks(sys.argv[1:] if argv is None else argv, world, args.device)
    spec = None
    if args.speculative:
        g, _, m = args.speculative.partition(":")
        mode = m or "ngram"
        try:
            gamma = int(g)
        except ValueError:
            p.error(f"--speculative {args.speculative!r} is not "
                    f"GAMMA[:MODE]")
        if mode not in ("ngram", "draft"):
            p.error(f"--speculative mode {mode!r} is not 'ngram' or "
                    f"'draft'")
        if args.tokens_per_tick != 1:
            p.error("--speculative needs --tokens-per-tick 1 (the "
                    "gamma-wide verify round IS the burst)")
        spec = (gamma, mode)
    if args.ab_spec and spec is None:
        p.error("--ab-spec needs --speculative (the side to compare "
                "against plain ticks)")
    if args.ab_spec and args.ab_pipeline:
        p.error("--ab-spec does not combine with --ab-pipeline (one A/B "
                "axis per run)")
    if args.rate_curve and args.process == "burst":
        p.error("--rate-curve replaces --process burst (bursts are the "
                "burst_train:GAP:SIZE curve)")
    if args.chaos and (args.ab_pipeline or args.ab_spec):
        p.error("--chaos measures one fault-injected run; it does not "
                "combine with the A/B modes (compare a chaos run against "
                "a no-chaos run of the same workload)")
    if not 0.0 <= args.trace_sample <= 1.0:
        p.error("--trace-sample must be in [0, 1]")
    if (args.kill_replica or args.rolling_restart is not None
            or args.fleet_out or args.autoscale) and not args.replicas:
        p.error("--kill-replica / --rolling-restart / --fleet-out / "
                "--autoscale need --replicas (they operate on the fleet "
                "router)")
    fleet_sizes = kill_spec = scale_bounds = None
    if args.replicas:
        try:
            fleet_sizes = [int(x) for x in args.replicas.split(",")]
        except ValueError:
            p.error(f"--replicas {args.replicas!r} is not N or N,N,..")
        if any(n < 1 for n in fleet_sizes):
            p.error("--replicas sizes must be >= 1")
        if (args.ab_pipeline or args.ab_spec or args.chaos or args.ab_mesh or meshes
                or args.mesh_out):
            p.error("--replicas does not combine with the pipeline/spec/"
                    "mesh A/B modes or engine-level --chaos — fleet chaos is "
                    "--kill-replica / --rolling-restart (replica-level "
                    "faults through the router's replayable tick hooks)")
        kill_spec = _parse_kill(args.kill_replica) if args.kill_replica \
            else None
        if args.autoscale:
            lo, sep, hi = args.autoscale.partition(":")
            try:
                scale_bounds = (int(lo), int(hi))
            except ValueError:
                p.error(f"--autoscale {args.autoscale!r} is not MIN:MAX")
            if len(fleet_sizes) != 1:
                p.error("--autoscale starts from ONE --replicas size "
                        "(the sweep compares FIXED fleet sizes; run the "
                        "autoscaled side separately)")
    scenario = None
    if args.scenario:
        if args.replay:
            p.error("--scenario IS a replayable workload artifact; it "
                    "does not combine with --replay")
        if args.rate_curve:
            p.error("the rate curve lives in the scenario header; "
                    "--rate-curve does not combine with --scenario")
        from deepspeed_tpu_torch.serving.scenarios import Scenario

        scenario = Scenario.load(args.scenario)
        if scenario.chaos and not args.replicas:
            p.error(f"scenario {scenario.name!r} embeds replica chaos; "
                    f"it needs --replicas (fleet mode)")
        if scenario.chaos and (args.kill_replica
                               or args.rolling_restart is not None):
            p.error("scenario chaos does not combine with --kill-replica "
                    "/ --rolling-restart (one chaos schedule per run)")
        workload, arrivals = scenario.compile()
    elif args.replay:
        workload, arrivals = load_workload(args.replay)
        if arrivals is None and args.rate_curve:
            arrivals = gen_curve_arrivals(len(workload), args.rate,
                                          args.rate_curve, args.seed,
                                          process=args.process)
        elif arrivals is None:
            arrivals = gen_arrivals(len(workload), args.rate, args.process,
                                    args.seed, args.burst_size)
    else:
        workload = synth_workload(
            args.requests, seed=args.seed,
            prompt_range=_parse_range(args.prompt_range),
            new_range=_parse_range(args.new_range), tenants=args.tenants,
            priorities=args.priorities, deadline_ms=args.deadline_ms)
        if args.rate_curve:
            arrivals = gen_curve_arrivals(args.requests, args.rate,
                                          args.rate_curve, args.seed,
                                          process=args.process)
        else:
            arrivals = gen_arrivals(args.requests, args.rate, args.process,
                                    args.seed, args.burst_size)
    if args.dump_workload:
        dump_workload(args.dump_workload, workload, arrivals)

    import torch

    from deepspeed_tpu_torch.inference.continuous import ContinuousBatchingEngine
    from deepspeed_tpu_torch.inference.decoding import read_bucket
    from deepspeed_tpu_torch.models.transformer import TransformerConfig, TransformerModel
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    if args.preset == "toy":
        model = TransformerModel(TransformerConfig(
            vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=max(args.cache_len, 128), dtype=args.dtype))
    else:
        model = TransformerModel.from_preset(args.preset, dtype=args.dtype)
    # weights made once on the host from the seed; each engine build casts
    # them to the model dtype on its device
    params = model.init(torch.Generator().manual_seed(args.seed))

    draft_model = draft_params = None
    if spec is not None and spec[1] == "draft":
        if args.draft_preset:
            draft_model = TransformerModel.from_preset(args.draft_preset,
                                                       dtype=args.dtype)
        elif args.preset == "toy":
            draft_model = TransformerModel(TransformerConfig(
                vocab_size=128, hidden_size=64, num_layers=1, num_heads=4,
                max_seq_len=max(args.cache_len, 128), dtype=args.dtype))
        else:
            p.error("--speculative GAMMA:draft with a non-toy --preset "
                    "needs --draft-preset")
        draft_params = draft_model.init(torch.Generator().manual_seed(args.seed + 1))

    if args.trace_sample >= 1.0:
        span_sampler = None  # trace everything, zero sampling work
    else:
        from deepspeed_tpu_torch.telemetry.spans import make_trace_sampler

        span_sampler = make_trace_sampler(args.trace_sample, seed=args.seed)

    chaos_plan = FaultPlan.load(args.chaos) if args.chaos else None

    def build_cb(depth: int, trace_out=None, spec_side=spec, mesh_shape=None):
        cfg = {"dtype": args.dtype}
        if mesh_shape:
            cfg["mesh"] = {"shape": mesh_shape}
        if trace_out:
            cfg["telemetry"] = {"enabled": True, "trace_file": trace_out}
        elif args.ops_port is not None:
            # --ops-port without --trace-out: /metrics still needs a live
            # registry, so enable the hub registry-only (no trace file)
            cfg["telemetry"] = {"enabled": True, "trace_file": ""}
        engine_kwargs = {}
        if spec_side is not None:
            gamma, mode = spec_side
            cfg["speculative"] = {"enabled": True, "pool": True,
                                  "mode": mode, "num_draft_tokens": gamma}
            if mode == "draft":
                engine_kwargs["draft_model"] = draft_model
                engine_kwargs["draft_params"] = draft_params
        if args.buckets:
            engine_kwargs["cache_buckets"] = _parse_buckets(args.buckets)
        else:
            engine_kwargs["max_slots"] = args.slots
            engine_kwargs["cache_len"] = args.cache_len
        return ContinuousBatchingEngine(
            model, params=params, config=cfg,
            tokens_per_tick=args.tokens_per_tick,
            pipeline_depth=depth,
            fused_prefill=not args.no_fused_prefill,
            donate_cache=not args.no_donate,
            seed=args.seed, device=args.device,
            **engine_kwargs)

    def build_serving(depth: int, trace_out=None, spec_side=spec, mesh_shape=None):
        cb = build_cb(depth, trace_out=trace_out, spec_side=spec_side, mesh_shape=mesh_shape)
        kw = {}
        if chaos_plan is not None:
            cb.fault_hook = FaultInjector(chaos_plan)

            def factory(mesh_shape=None, _depth=depth, _spec=spec_side, _orig=mesh_shape):
                # replacement engines carry no trace file: the serving
                # layer re-injects its hub, so the trace file and the
                # counters stay continuous across rebuilds; mesh_shape is
                # a degrade rung, else the serve's own mesh
                return build_cb(_depth, spec_side=_spec, mesh_shape=mesh_shape or _orig)

            kw = dict(engine_factory=factory, degrade_mesh_shapes=degrade_shapes,
                      recovery=RecoveryConfig(
                          max_tick_retries=args.tick_retries,
                          fetch_timeout_s=args.fetch_timeout_s))
        return ServingEngine(cb, policy=args.policy,
                             max_queue_depth=args.queue_depth,
                             kv_budget_tokens=args.kv_budget,
                             aging_s=args.aging_s,
                             span_sampler=span_sampler, **kw)

    def warm_serving(serving):
        """--warm: run every tick variant once and drive one synthetic
        request per prompt bucket through the UNDERLYING batcher, then
        zero the tick counters so the summary reflects only the measured
        window."""
        cb = serving._cb
        cb.precompile_tick_programs()
        vocab = model.cfg.vocab_size
        lens = {len(_item_prompt(item, i, args.seed, vocab))
                for i, item in enumerate(workload)}
        for b in sorted({read_bucket(n, cb.cache_len) for n in lens}):
            cb.submit(np.zeros((b,), np.int32), max_new_tokens=4)
        while cb.has_work():
            cb.step()
        cb.finished()
        for k, v in cb._tick_stats.items():
            cb._tick_stats[k] = type(v)(0)

    def one_run(depth: int, trace_out=None, spec_side=spec, mesh_shape=None):
        serving = build_serving(depth, trace_out=trace_out, spec_side=spec_side,
                                mesh_shape=mesh_shape)
        if args.warm:
            warm_serving(serving)
        if args.ops_port is not None:
            ops = serving.start_ops_server(port=args.ops_port)
            print(f"ops server live at {ops.url} "
                  f"(/metrics /healthz /statusz)")
        records, wall_s = run_load(serving, workload, arrivals, seed=args.seed)
        summary = summarize(records, wall_s, tick_stats=serving.tick_stats())
        if chaos_plan is not None:
            injector = serving._cb.fault_hook
            summary["chaos"] = chaos_scorecard(
                records, wall_s, serving.recovery_stats(),
                injected=getattr(injector, "fired", None))
        if mesh_shape:
            summary["mesh"] = dict(mesh_shape)
        # close releases the exporter port and flushes the trace
        serving.close()
        return summary

    if fleet_sizes is not None:
        return _run_fleet(args, fleet_sizes, kill_spec, scale_bounds,
                          scenario, workload, arrivals, build_cb,
                          span_sampler)

    def write_mesh_record(results):
        record = mesh_record(results, {
            "requests": len(workload), "rate": args.rate,
            "process": args.process, "pipeline_depth": args.pipeline_depth,
            "donate": not args.no_donate, "slots": args.slots,
            "cache_len": args.cache_len, "preset": args.preset}, device=args.device)
        with open(args.mesh_out, "w") as fh:
            json.dump(record, fh, indent=2, sort_keys=True)
        print(f"mesh record written to {args.mesh_out}")

    if args.ab_mesh or len(meshes) > 1:
        # sharded-vs-replicated sweep: the 1x1 mesh is always the baseline
        # side, each width replays the SAME workload
        sweep = [{"data": 1, "tensor": 1}] + [
            m for m in meshes if (m.get("data", 1), m.get("tensor", 1)) != (1, 1)]
        results = {}
        for shape in sweep:
            key = f"{shape.get('data', 1)}x{shape.get('tensor', 1)}"
            trace = f"{args.trace_out}.{key}.jsonl" if args.trace_out else None
            results[key] = one_run(args.pipeline_depth, trace_out=trace, mesh_shape=shape)
        if args.mesh_out:
            write_mesh_record(results)
        if args.as_json:
            print(json.dumps(results, indent=2, sort_keys=True))
        else:
            sys.stdout.write(format_mesh_ab(results))
        return 0
    mesh_shape = meshes[0] if meshes else None

    if args.ab_spec:
        # SAME replayed workload both sides; the plain side writes a
        # sibling trace so both pay identical telemetry overhead
        plain_trace = (args.trace_out + ".plain.jsonl" if args.trace_out
                       else None)
        plain = one_run(args.pipeline_depth, trace_out=plain_trace, spec_side=None,
                        mesh_shape=mesh_shape)
        spec_sum = one_run(args.pipeline_depth, trace_out=args.trace_out,
                           mesh_shape=mesh_shape)
        if plain_trace:
            print(f"plain-side trace written to {plain_trace}")
        if args.as_json:
            print(json.dumps({"plain": plain, "speculative": spec_sum},
                             indent=2, sort_keys=True))
        else:
            sys.stdout.write(format_spec_ab(plain, spec_sum))
    elif args.ab_pipeline:
        # BOTH sides must pay identical telemetry overhead or the A/B is
        # biased — with --trace-out the sync run writes a sibling trace
        sync_trace = args.trace_out + ".sync.jsonl" if args.trace_out else None
        sync = one_run(0, trace_out=sync_trace, mesh_shape=mesh_shape)
        pipelined = one_run(max(args.pipeline_depth, 1), trace_out=args.trace_out,
                            mesh_shape=mesh_shape)
        if sync_trace:
            print(f"sync-side trace written to {sync_trace}")
        if args.as_json:
            print(json.dumps({"sync": sync, "pipelined": pipelined},
                             indent=2, sort_keys=True))
        else:
            sys.stdout.write(format_ab(sync, pipelined))
    else:
        summary = one_run(args.pipeline_depth, trace_out=args.trace_out, mesh_shape=mesh_shape)
        if args.mesh_out:  # --mesh-out requires --mesh
            write_mesh_record({f"{mesh_shape.get('data', 1)}x{mesh_shape.get('tensor', 1)}":
                               summary})
        if args.as_json:
            print(json.dumps(summary, indent=2, sort_keys=True))
        else:
            sys.stdout.write(format_summary(summary))
    if args.trace_out:
        print(f"trace written to {args.trace_out}")
    return 0


def build_fleet(make_engine, n: int, *, serving_kw: Optional[dict] = None):
    """A :class:`FleetRouter` over ``n`` ``ServingEngine`` replicas that
    share ONE telemetry hub. ``make_engine(first)`` builds a replica's
    batching engine; the first one's hub (``first`` True: build it with the
    run's telemetry config — trace file, ops registry) becomes the base,
    and every replica — including the first, and any kill-restore or
    rolling-restart replacement — talks through a ``ReplicaTelemetry``
    facade that tags its events and metrics with the replica id.
    ``serving_kw`` goes to every replica's ``ServingEngine``."""
    from deepspeed_tpu_torch.serving.engine import ServingEngine
    from deepspeed_tpu_torch.serving.fleet import attach_replica_telemetry
    from deepspeed_tpu_torch.serving.router import FleetRouter

    holder: dict = {}

    def factory(replica_id: str):
        first = "hub" not in holder
        cb = make_engine(first)
        if first:
            holder["hub"] = cb._eng.telemetry
        attach_replica_telemetry(cb, holder["hub"], replica_id)
        return ServingEngine(cb, **(serving_kw or {}))

    return FleetRouter(factory, replicas=n)


def kill_lowest_healthy(router):
    """The replayable chaos kill of ``--kill-replica``: the lowest-slot
    healthy replica dies abruptly."""
    for rid in router.replica_ids():  # slot order
        if router.statusz()["replicas"][rid]["state"] == "healthy":
            router.kill(rid, detail="loadgen --kill-replica")
            return


def fleet_run(router, workload: List[dict], arrivals: List[float], *, seed: int = 0,
              kill: Optional[tuple] = None, rolling_restart: Optional[int] = None,
              scenario=None, autoscale: Optional[tuple] = None,
              autoscale_cooldown: float = 2.0):
    """One open-loop run through a fleet: arm the chaos schedule (``kill``
    = (TICK, RESTORE or None), ``rolling_restart`` = TICK, or the
    scenario's own) and the autoscaler (``autoscale`` = (MIN, MAX)), drive
    :func:`run_load`, and score it. Returns ``(summary, records)``: the
    summary gains the ``fleet`` section, and ``autoscaler``, ``scenario``
    and ``chaos`` where they apply. The router stays open."""
    scaler = None
    if autoscale is not None:
        from deepspeed_tpu_torch.serving.autoscaler import AutoscalerConfig, FleetAutoscaler

        scaler = FleetAutoscaler(router, AutoscalerConfig(
            min_replicas=autoscale[0], max_replicas=autoscale[1],
            cooldown_s=autoscale_cooldown))
    if scenario is not None:
        scenario.arm(router)
    if kill is not None:
        tick, restore = kill
        router.at_tick(tick, kill_lowest_healthy)
        if restore is not None:
            router.at_tick(restore, lambda r: r.add())
    if rolling_restart is not None:
        router.at_tick(rolling_restart, lambda r: r.rolling_restart())
    records, wall_s = run_load(router, workload, arrivals, seed=seed)
    summary = summarize(records, wall_s, tick_stats=router.tick_stats())
    summary["fleet"] = fleet_scorecard(router, records)
    if scaler is not None:
        summary["autoscaler"] = scaler.stats()
    if scenario is not None:
        summary["scenario"] = scenario.name
    if (kill is not None or rolling_restart is not None
            or (scenario is not None and scenario.chaos)):
        summary["chaos"] = chaos_scorecard(records, wall_s, router.recovery_stats())
    return summary, records


def _run_fleet(args, fleet_sizes, kill_spec, scale_bounds, scenario,
               workload, arrivals, build_cb, span_sampler) -> int:
    """``--replicas``: route the workload through a FleetRouter, once per
    fleet size, and print (or record) the fleet scorecards."""
    serving_kw = dict(policy=args.policy, max_queue_depth=args.queue_depth,
                      kv_budget_tokens=args.kv_budget, aging_s=args.aging_s,
                      span_sampler=span_sampler)

    def one_fleet_run(n: int, trace_out=None) -> dict:
        router = build_fleet(
            lambda first: build_cb(args.pipeline_depth,
                                   trace_out=trace_out if first else None),
            n, serving_kw=serving_kw)
        if args.ops_port is not None:
            ops = router.start_ops_server(port=args.ops_port)
            print(f"fleet ops server live at {ops.url} "
                  f"(/metrics /healthz /statusz)")
        summary, _ = fleet_run(router, workload, arrivals, seed=args.seed,
                               kill=kill_spec, rolling_restart=args.rolling_restart,
                               scenario=scenario, autoscale=scale_bounds,
                               autoscale_cooldown=args.autoscale_cooldown)
        router.close()
        return summary

    results = {}
    for n in fleet_sizes:
        trace = args.trace_out
        if trace and len(fleet_sizes) > 1:
            trace = f"{trace}.x{n}.jsonl"
        results[str(n)] = one_fleet_run(n, trace_out=trace)
    if args.fleet_out:
        record = fleet_record(results, {
            "requests": len(workload), "rate": args.rate,
            "process": args.process, "seed": args.seed,
            "pipeline_depth": args.pipeline_depth,
            "slots": args.slots, "cache_len": args.cache_len,
            "deadline_ms": args.deadline_ms, "preset": args.preset,
            "kill_replica": args.kill_replica,
            "rolling_restart": args.rolling_restart,
            "rate_curve": args.rate_curve,
            "scenario": scenario.name if scenario else None,
            "autoscale": args.autoscale}, device=args.device)
        with open(args.fleet_out, "w") as fh:
            json.dump(record, fh, indent=2, sort_keys=True)
        print(f"fleet record written to {args.fleet_out}")
    if args.as_json:
        print(json.dumps(results if len(fleet_sizes) > 1
                         else results[str(fleet_sizes[0])],
                         indent=2, sort_keys=True))
    elif len(fleet_sizes) > 1:
        sys.stdout.write(format_fleet_sweep(results))
    else:
        sys.stdout.write(format_summary(results[str(fleet_sizes[0])]))
    if args.trace_out:
        print(f"trace written to {args.trace_out}"
              + (".x<N>.jsonl per fleet size"
                 if len(fleet_sizes) > 1 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
