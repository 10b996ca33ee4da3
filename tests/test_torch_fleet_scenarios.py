"""The port's declarative scenarios (``deepspeed_tpu_torch/serving/scenarios.py``)
against the reference's and against the repo's ``scenarios/*.jsonl``.

- ``builtin_matrix()`` dumps byte for byte to the checked-in files, and
  ``write_matrix`` writes exactly those files.
- For each of the seven scenarios, ``compile()`` gives the reference's
  workload and arrivals, ``arm()`` schedules the same chaos ticks and the
  same marker event, and a whole run of the scenario through each
  package's loadgen ``run_load`` over a two-replica fake-engine fleet on a
  fake clock gives equal records, fleet scorecards and
  ``scenario_scorecard``s.
- Malformed scenarios raise the reference's errors.
"""

import glob
import os

import pytest
from torch_fleet_common import assert_same, attempt, canon, hub_record, side_of

import deepspeed_tpu.serving.loadgen as jloadgen
import deepspeed_tpu.serving.scenarios as jscenarios
import deepspeed_tpu_torch.serving.loadgen as tloadgen
import deepspeed_tpu_torch.serving.scenarios as tscenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, "scenarios", "*.jsonl")))
NAMES = [os.path.basename(f)[:-len(".jsonl")] for f in FILES]
PACKAGES = {"ref": (jscenarios, jloadgen), "port": (tscenarios, tloadgen)}


def test_builtin_matrix_dumps_byte_for_byte_to_the_checked_in_files(tmp_path):
    matrix = tscenarios.builtin_matrix()
    assert sorted(sc.name for sc in matrix) == NAMES
    for sc in matrix:
        path = tmp_path / f"{sc.name}.jsonl"
        sc.dump(str(path))
        with open(os.path.join(ROOT, "scenarios", f"{sc.name}.jsonl"), "rb") as fh:
            assert path.read_bytes() == fh.read(), sc.name
    out = tmp_path / "matrix"
    out.mkdir()
    written = tscenarios.write_matrix(str(out))
    assert sorted(os.path.basename(p) for p in written) == [os.path.basename(f) for f in FILES]
    assert sorted(sc.name for sc in matrix if sc.chaos) == ["kill_during_peak",
                                                         "rolling_under_load"]


class _TickingFleet:
    """``run_load``'s view of a router whose every fleet tick takes 10 ms
    of the fake clock (idle waits advance it through ``sleep``, by at
    least 1 us: a wait shorter than the clock's ulp would not move it)."""

    def __init__(self, router, clock):
        self._router, self._clock = router, clock
        self.vocab_size = router.vocab_size

    def submit(self, *a, **kw):
        return self._router.submit(*a, **kw)

    def has_work(self):
        return self._router.has_work()

    def step(self):
        out = self._router.step()
        self._clock.advance(0.01)
        return out

    def reap(self):
        return self._router.reap()


def _scenario_run(name, side_name):
    scenarios, loadgen = PACKAGES[side_name]
    side = side_of(side_name)
    sc = scenarios.Scenario.load(os.path.join(ROOT, "scenarios", f"{name}.jsonl"))
    workload, arrivals = sc.compile()
    hub = side.hub()
    router, clock = side.make_fleet(2, slots=4, cache_len=128, telemetry=hub, tag=True)
    armed = sc.arm(router)
    hooks = sorted(router._hooks)
    records, wall_s = loadgen.run_load(_TickingFleet(router, clock), workload, arrivals,
                                       seed=sc.seed, clock=clock,
                                       sleep=lambda s: clock.advance(max(s, 1e-6)))
    summary = loadgen.summarize(records, wall_s, tick_stats=router.tick_stats())
    summary["fleet"] = loadgen.fleet_scorecard(router, records)
    summary["scenario"] = sc.name
    card = scenarios.scenario_scorecard(sc, summary)
    quiet = sc.without_chaos()
    return {"workload": workload, "arrivals": arrivals, "armed": armed, "hooks": hooks,
            "records": records, "summary": summary, "scorecard": card,
            "quiet": (quiet.name, quiet.compile(), len(quiet.chaos)),
            "hub": hub_record(hub)}


@pytest.mark.parametrize("name", NAMES)
def test_scenario_compiles_arms_and_scores_as_the_reference(name):
    rec = {side: canon(_scenario_run(name, side)) for side in ("ref", "port")}
    port = rec["port"]
    assert len(port["workload"]) == len(port["arrivals"]) > 0
    assert port["armed"] == len(port["hooks"])
    card = port["scorecard"]
    assert card["scenario"] == name and card["lost"] == 0
    assert card["conservation_ok"] is True
    assert [p for k, p in port["hub"]["events"]
            if k == "fleet_scale" and p["event"] == "scenario"][0]["scenario"] == name
    assert_same(rec)


def _bad_scenarios(mod, tmp):
    bad_header = os.path.join(tmp, "dup.jsonl")
    with open(bad_header, "w") as fh:
        fh.write('{"record": "scenario", "name": "a"}\n{"record": "scenario", "name": "b"}\n')
    unknown = os.path.join(tmp, "unknown.jsonl")
    with open(unknown, "w") as fh:
        fh.write('{"record": "scenario", "name": "a"}\n{"record": "wat"}\n')
    headless = os.path.join(tmp, "headless.jsonl")
    with open(headless, "w") as fh:
        fh.write('{"record": "chaos", "tick": 3, "action": "kill"}\n')
    return [
        attempt(mod.TenantMix, weight=0),
        attempt(mod.TenantMix, prompt_range=(0, 4)),
        attempt(mod.TenantMix, new_range=(5, 4)),
        attempt(mod.TenantMix, shared_prefix=-1),
        attempt(mod.ChaosAction, tick=0, action="kill"),
        attempt(mod.ChaosAction, tick=3, action="explode"),
        attempt(mod.Scenario, name=""),
        attempt(mod.Scenario, name="x", requests=0),
        attempt(mod.Scenario, name="x", rate=0.0),
        attempt(mod.Scenario.load, bad_header),
        attempt(mod.Scenario.load, unknown),
        attempt(mod.Scenario.load, headless),
    ]


def test_malformed_scenarios_raise_as_the_reference(tmp_path):
    ref = _bad_scenarios(jscenarios, str(tmp_path))
    port = _bad_scenarios(tscenarios, str(tmp_path))
    assert all(r[0] == "raises" for r in port)
    assert port == ref
