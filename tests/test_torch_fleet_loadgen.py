"""The port's load generator in fleet mode (``--replicas``) on the CPU, on
the toy preset: a fleet-size sweep with ``--fleet-out``, a replica kill
with restore, a rolling restart, the autoscaler and a checked-in scenario
each exit 0 with nothing lost and the fleet's books balanced; the fleet
record has the reference's keys; the fleet flags' argument errors are the
reference's, word for word; the summary renders the reference's fleet,
autoscaler and scenario lines from the same summary dict.
"""

import json
import os

import pytest

import deepspeed_tpu.serving.loadgen as jload
import deepspeed_tpu_torch.serving.loadgen as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["--device", "cpu", "--preset", "toy", "--cache-len", "64", "--slots", "2",
       "--prompt-range", "4:8", "--new-range", "4:8", "--process", "uniform"]


def _json_out(capsys):
    text = capsys.readouterr().out
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


def _balanced(summary):
    fleet = summary["fleet"]
    assert fleet["lost"] == 0 and fleet["conservation_ok"] is True
    assert fleet["admitted"] == sum(v for k, v in summary["outcomes"].items()
                                    if k in ("finished", "expired", "cancelled"))
    return fleet


def test_replica_sweep_writes_the_fleet_record(tmp_path, capsys):
    out = str(tmp_path / "fleet.json")
    rc = tload.main(TOY + ["--requests", "8", "--rate", "400", "--replicas", "1,2",
                           "--fleet-out", out, "--json"])
    assert rc == 0
    results = _json_out(capsys)
    assert sorted(results) == ["1", "2"]
    for n, summary in results.items():
        fleet = _balanced(summary)
        assert summary["outcomes"] == {"finished": 8}
        assert len(fleet["replicas"]) == int(n)
    with open(out) as fh:
        record = json.load(fh)
    assert record["kind"] == "serving_fleet_sweep" and record["replicas"] == [1, 2]
    assert record["device_kind"] == "cpu" and record["n_devices"] == 1
    workload = record["workload"]
    ref = jload.fleet_record(results, workload)
    port = tload.fleet_record(results, workload, device="cpu")
    assert sorted(port) == sorted(ref) == sorted(record)
    assert {k: v for k, v in port.items() if k not in ("device_kind", "n_devices")} == {
        k: v for k, v in ref.items() if k not in ("device_kind", "n_devices")}
    assert tload.format_fleet_sweep(results) == jload.format_fleet_sweep(results)


def test_kill_and_restore_migrates_and_loses_nothing(capsys):
    rc = tload.main(TOY + ["--requests", "10", "--rate", "400", "--replicas", "2",
                           "--kill-replica", "5:12", "--json"])
    assert rc == 0
    summary = _json_out(capsys)
    fleet = _balanced(summary)
    assert fleet["replica_deaths"] == 1 and fleet["migrated"] > 0
    assert summary["outcomes"] == {"finished": 10}
    assert sorted(fleet["replicas"]) == ["r0", "r1", "r2"]
    assert fleet["replicas"]["r0"]["state"] == "dead"
    assert summary["chaos"]["fleet_migrated"] == fleet["migrated"]


def test_rolling_restart_replaces_every_replica(capsys):
    # arrivals spread over 0.3 s keep work in the fleet while both replicas
    # are swapped (a drain that starts when the fleet has run dry never retires)
    rc = tload.main(TOY + ["--requests", "16", "--rate", "50", "--replicas", "2",
                           "--rolling-restart", "2", "--json"])
    assert rc == 0
    summary = _json_out(capsys)
    fleet = _balanced(summary)
    assert summary["outcomes"] == {"finished": 16} and fleet["replica_deaths"] == 0
    states = {r: i["state"] for r, i in fleet["replicas"].items()}
    assert states == {"r0": "drained", "r1": "drained", "r2": "healthy", "r3": "healthy"}


def test_autoscale_reports_its_stats(capsys):
    rc = tload.main(TOY + ["--requests", "12", "--rate", "1000", "--replicas", "1",
                           "--autoscale", "1:2", "--autoscale-cooldown", "0", "--json"])
    assert rc == 0
    summary = _json_out(capsys)
    _balanced(summary)
    assert set(summary["autoscaler"]) == {"scale_ups", "scale_downs", "scale_down_skips",
                                          "degrade_level", "mean_replicas"}
    assert summary["outcomes"] == {"finished": 12}


def test_scenario_rolling_under_load(capsys):
    path = os.path.join(ROOT, "scenarios", "rolling_under_load.jsonl")
    rc = tload.main(["--device", "cpu", "--preset", "toy", "--cache-len", "64", "--slots", "4",
                     "--replicas", "2", "--scenario", path])
    assert rc == 0
    text = capsys.readouterr().out
    assert "scenario       rolling_under_load" in text
    assert "lost 0" in text and "conservation ok" in text


@pytest.mark.parametrize("argv", [
    ["--kill-replica", "3"],
    ["--autoscale", "1:2"],
    ["--replicas", "x"],
    ["--replicas", "0"],
    ["--replicas", "1,2", "--autoscale", "1:2"],
    ["--replicas", "1", "--autoscale", "one:two"],
    ["--replicas", "2", "--ab-pipeline"],
    ["--scenario", "scenarios/kill_during_peak.jsonl"],
    ["--scenario", "scenarios/rolling_under_load.jsonl", "--replicas", "2",
     "--kill-replica", "4"],
    ["--scenario", "scenarios/burst_frontend.jsonl", "--rate-curve", "step:1:2"],
], ids=lambda a: " ".join(a))
def test_fleet_argument_errors_are_the_references(capsys, argv):
    argv = ["--preset", "toy", "--requests", "2"] + [
        os.path.join(ROOT, a) if a.startswith("scenarios/") else a for a in argv]
    errors = []
    for main, extra in ((jload.main, []), (tload.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(extra + argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[1] == errors[0]
    assert "error:" in errors[1]


def test_summary_renders_the_fleet_sections_as_the_reference():
    summary = {
        "requests": 4, "outcomes": {"finished": 3, "shed": 1}, "wall_s": 1.5,
        "offered_rps": 2.0, "shed_rate": 0.25, "throughput_tok_s": 10.0,
        "goodput_tok_s": 9.0, "deadline_met_frac": 0.5,
        "autoscaler": {"scale_ups": 1, "scale_downs": 0, "scale_down_skips": 2,
                       "degrade_level": 1, "mean_replicas": 1.5},
        "scenario": "burst_frontend",
        "fleet": {"replicas": {"r0": {"state": "dead", "admitted": 2, "shed": 0,
                                      "migrated_in": 0, "migrated_out": 1},
                               "r1": {"state": "healthy", "admitted": 2, "shed": 1,
                                      "migrated_in": 1, "migrated_out": 0}},
                  "submitted": 4, "admitted": 4, "shed": 1, "spillovers": 1, "migrated": 1,
                  "lost": 0, "replica_deaths": 1, "conservation_ok": True},
    }
    assert tload.format_summary(summary) == jload.format_summary(summary)
    assert "conservation ok" in tload.format_summary(summary)
    assert tload._parse_kill("12") == jload._parse_kill("12") == (12, None)
    assert tload._parse_kill("12:40") == jload._parse_kill("12:40") == (12, 40)
