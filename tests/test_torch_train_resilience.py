"""The port's fault-tolerant training on the CPU: the train fault domain and
the numeric sentinel against the reference's, and the TrainSupervisor's
ladder held to the reference's parity gate
(``tests/unit/runtime/test_resilience.py``).

1. ``faults.py``'s train domain: ``TrainFaultPlan.synth(...).dump`` gives
   the reference's bytes, ``plan_bitflip`` picks the reference's target from
   the same sizes, ``flip_float_bit`` and the poison helpers give its bits.
2. ``runtime/numerics.py``: the same verdicts and stats on the same streams
   of (loss, grad norm, overflow), with a spike, a NaN, a grad explosion, a
   zero-grad stall and the SDC flag.
3. The supervisor on a 2-layer GPT-2 (D 64, vocab 128, S 32; AdamW, GAS 2):
   every chaos plan gives the fault-free loss stream bit for bit (a
   ``micro_dispatch`` error, a ``step_fetch`` hang, a torn write, a
   preemption before any snapshot and one after a committed tag, async saves
   torn at the fence), a poisoned batch is quarantined and the stream equals
   a clean run without that batch, a flipped gradient bit is rewound, and
   the budgets that run out escalate as the reference's do. A clean run with
   the sentinel armed flags nothing.

The data: 64 rows of a cycle through 16 tokens from a random start, after a
marker token 127. The model learns the 16 tokens' unigram within ~4 steps,
so the reference's ``data_poison`` (token ids scrambled in range by
``(31 x + 7) % (max + 1)``, which spreads them over all 128) spikes the loss
by ~7 nats over a plateau. The sentinel of the numeric tests arms after 2
steps, as the reference's test does, and keeps a window of 4 losses so that
the plateau, not the first steps' descent, is its baseline.
"""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu import faults as rfaults
from deepspeed_tpu.runtime import numerics as rnum
from deepspeed_tpu_torch import faults as tfaults
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.runtime import numerics as tnum
from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity
from deepspeed_tpu_torch.runtime.dataloader import TpuDataLoader
from deepspeed_tpu_torch.runtime.resilience import TrainingFailed, TrainSupervisor
from deepspeed_tpu_torch.telemetry import Telemetry, TelemetryConfig, read_trace

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's CPU ops run fastest on one thread, and the suite's
    parallel workers share the cores: more threads a worker oversubscribe
    them (each step then waits on spinning threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# 1. the train fault domain against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(seed=0), dict(seed=7, n_faults=6, first_tick=1, tick_span=20),
    dict(seed=3, kinds=["grad_bitflip", "nan_loss", "data_poison"]),
    dict(seed=5, degrade_last=True)])
def test_train_plan_dumps_the_reference_bytes(kwargs, tmp_path):
    rplan, tplan = rfaults.TrainFaultPlan.synth(**kwargs), tfaults.TrainFaultPlan.synth(**kwargs)
    rplan.dump(str(tmp_path / "r.jsonl"))
    tplan.dump(str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "r.jsonl").read_bytes()
    back = tfaults.TrainFaultPlan.load(str(tmp_path / "r.jsonl"))
    assert [f.to_dict() for f in back] == [f.to_dict() for f in rplan]


def test_train_plan_extra_fields_round_trip_like_the_reference(tmp_path):
    faults = [dict(tick=4, kind="grad_bitflip", leaf="layers.0.attn.wqkv", bit=30),
              dict(tick=2, kind="data_poison", factor=50.0), dict(tick=1, kind="preempt", count=2)]
    rfaults.TrainFaultPlan([rfaults.TrainFault(**f) for f in faults]).dump(str(tmp_path / "r"))
    tfaults.TrainFaultPlan([tfaults.TrainFault(**f) for f in faults]).dump(str(tmp_path / "t"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "r").read_bytes()
    with pytest.raises(ValueError, match="bit"):
        tfaults.TrainFault(tick=1, kind="grad_bitflip", bit=32)


def test_train_injector_fires_like_the_reference():
    def run(mod):
        plan = mod.TrainFaultPlan([mod.TrainFault(tick=2, kind="dispatch_error", count=2),
                                   mod.TrainFault(tick=3, kind="grad_bitflip"),
                                   mod.TrainFault(tick=4, kind="preempt")])
        inj, log = mod.TrainFaultInjector(plan), []
        for step in range(1, 6):
            for point in ("preempt", "micro_dispatch", "micro_dispatch", "step_fetch"):
                try:
                    log.append((step, point, inj(point, {"step": step})))
                except mod.InjectedFault as exc:
                    log.append((step, point, type(exc).__name__, exc.fault))
        return log, inj.fired, inj.pending()

    assert run(tfaults) == run(rfaults)


def test_plan_bitflip_and_the_corruption_helpers_match_the_reference():
    rs = np.random.RandomState(0)
    sizes = {f"layers.{i}.attn.wqkv": int(rs.randint(1, 5000)) for i in range(5)}
    sizes["embed.tok"] = 8192
    for step in range(1, 40):
        for leaf, bit in (("", -1), ("embed.tok", 30), ("", 5)):
            assert tfaults.plan_bitflip(step, sizes, leaf, bit) == rfaults.plan_bitflip(
                step, sizes, leaf, bit)
    g = rs.randn(7, 11).astype(np.float32)
    for elem, bit in ((0, 30), (13, 23), (76, 31), (200, 0)):
        np.testing.assert_array_equal(tfaults.flip_float_bit(g, elem, bit).view(np.uint32),
                                      rfaults.flip_float_bit(g, elem, bit).view(np.uint32))
    for a in (rs.randn(4, 3).astype(np.float32), rs.randint(0, 50, (3, 9)).astype(np.int32),
              rs.randint(0, 128, (2, 5)).astype(np.int64), np.zeros((0,), np.int32)):
        for factor in (tfaults.DEFAULT_POISON_FACTOR, 7.0):
            got, want = tfaults.poison_array(a, factor), rfaults.poison_array(a, factor)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        got, want = tfaults.nan_poison_array(a), rfaults.nan_poison_array(a)
        assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)


# ---------------------------------------------------------------------------
# 2. the numeric sentinel against the reference's
# ---------------------------------------------------------------------------

def _streams():
    """(step, loss, grad_norm, overflow) streams."""
    rs = np.random.RandomState(1)
    clean = [(s, 4.0 - 0.05 * s + 0.01 * rs.randn(), 1.0 + 0.05 * rs.randn(), False)
             for s in range(1, 25)]
    spike = clean[:12] + [(13, 30.0, 1.0, False), (13, 3.3, 1.0, False)] + clean[13:]
    mild = clean[:12] + [(13, 3.45 + 0.9, 1.0, False)] + clean[12:]
    nan = clean[:6] + [(7, float("nan"), 1.0, False), (7, 3.6, float("inf"), False),
                       (7, 3.6, float("nan"), True)] + clean[6:]
    explode = clean[:10] + [(11, 3.5, 150.0, False), (11, 3.5, 1.0, False),
                            (12, 3.45, 15.0, False)] + clean[11:]
    stall = clean[:9] + [(s, 3.5, 0.0, False) for s in range(10, 17)] + clean[16:]
    return {"clean": clean, "spike": spike, "mild_spike": mild, "nan": nan,
            "explode": explode, "stall": stall}


@pytest.mark.parametrize("config", [None, {"min_history": 2, "loss_window": 4},
                                    {"zero_grad_patience": 3, "grad_band_suspect": 5.0}])
@pytest.mark.parametrize("stream", sorted(_streams()))
def test_sentinel_verdicts_match_the_reference(stream, config):
    ref, port = rnum.NumericSentinel(config), tnum.NumericSentinel(config)
    for step, loss, gnorm, overflow in _streams()[stream]:
        for s in (ref, port):
            s._got = (s.check_loss(step, loss), s.check_step(step, gnorm, overflow))
        assert [v.__dict__ for v in port._got] == [v.__dict__ for v in ref._got], step
    assert port.flag_sdc_mismatch(30).__dict__ == ref.flag_sdc_mismatch(30).__dict__
    port.note_rewind(), ref.note_rewind()
    assert port.stats() == ref.stats()
    assert tnum.crc_digest([np.arange(5.0), np.ones(3, np.float32)]) == rnum.crc_digest(
        [np.arange(5.0), np.ones(3, np.float32)])


# ---------------------------------------------------------------------------
# 3. the supervisor
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
            dtype="float32", attn_impl="pallas")
ROWS = 8  # a global batch: 2 micro-batches of 4
SENTINEL = {"min_history": 2, "loss_window": 4}


def _config(async_save=False):
    conf = {"train_batch_size": ROWS, "train_micro_batch_size_per_gpu": ROWS // 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 3e-2, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 2, "warmup_max_lr": 3e-2,
                                     "warmup_type": "linear"}},
            "steps_per_print": 10 ** 6}
    if async_save:
        conf["checkpoint"] = {"async_save": True}
    return conf


def _dataset(n=64, seed=11):
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        row = ((rs.randint(0, 16) + np.arange(32)) % 16).astype(np.int32)
        row[0] = 127
        rows.append({"input_ids": row})
    return rows


def _loader(seed=0):
    return TpuDataLoader(_dataset(), batch_size=ROWS, seed=seed, shuffle=True)


def make_factory(config, telemetry=None):
    """Fresh engines from one seed (the deterministic init a cold restart
    relies on); the first one carries ``telemetry`` when given."""
    model = ttf.TransformerModel(ttf.TransformerConfig(**TINY))

    def factory():
        engine = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu",
                                                seed=0)[0]
        if telemetry is not None:
            engine.telemetry = telemetry
        return engine

    return factory


def _run_fault_free(num_steps, recovery=None, loader=None):
    sup = TrainSupervisor(make_factory(_config()), loader or _loader(), recovery=recovery)
    return sup.run(num_steps), sup


def _assert_bitwise(losses, ref_losses):
    np.testing.assert_array_equal(np.asarray(losses, dtype=np.float32),
                                  np.asarray(ref_losses, dtype=np.float32))


@pytest.fixture(scope="module")
def fault_free():
    """The fault-free loss stream over 10 steps (runs are prefixes)."""
    return _run_fault_free(10)[0]


class TestBitwiseParity:
    def test_chaos_run_matches_fault_free_bitwise(self, tmp_path, fault_free):
        """A clean micro-dispatch retry (step 3), a torn write (step 4, refused
        at the step-5 preemption's restore with fallback to global_step2), a
        preemption (step 5) and a fetch hang (step 7, rebuilt from the
        in-memory step-6 snapshot): the stream equals the fault-free one."""
        plan = tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=3, kind="dispatch_error"),
            tfaults.TrainFault(tick=4, kind="torn_write"),
            tfaults.TrainFault(tick=5, kind="preempt"),
            tfaults.TrainFault(tick=7, kind="fetch_hang")])
        inj = tfaults.TrainFaultInjector(plan)
        snap_dir = str(tmp_path / "snaps")
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"snapshot_every_n_steps": 2, "snapshot_dir": snap_dir,
                                        "backoff_s": 0.0})
        losses = sup.run(8)
        assert inj.pending() == 0
        assert [f["kind"] for f in inj.fired] == ["dispatch_error", "torn_write", "preempt",
                                                  "fetch_hang"]
        _assert_bitwise(losses, fault_free[:8])
        stats = sup.recovery_stats()
        assert stats["retries"] == 1 and stats["rebuilds"] == 2
        assert stats["torn_writes"] == 1 and stats["faults"] >= 4
        assert stats["recovery_ms"]["count"] == 2
        # the replay re-saved global_step4 cleanly over the torn tag
        assert integrity.is_committed(os.path.join(snap_dir, "global_step4"))
        assert integrity.latest_committed_tag(snap_dir) == "global_step8"

    def test_replayable_from_jsonl_plan(self, tmp_path, fault_free):
        plan = tfaults.TrainFaultPlan([tfaults.TrainFault(tick=2, kind="dispatch_error"),
                                       tfaults.TrainFault(tick=3, kind="preempt")])
        plan_path = str(tmp_path / "plan.jsonl")
        plan.dump(plan_path)
        sup = TrainSupervisor(
            make_factory(_config()), _loader(),
            fault_hook=tfaults.TrainFaultInjector(tfaults.TrainFaultPlan.load(plan_path)),
            recovery={"snapshot_every_n_steps": 2, "snapshot_dir": str(tmp_path / "s"),
                      "backoff_s": 0.0})
        _assert_bitwise(sup.run(4), fault_free[:4])

    def test_preempt_before_any_snapshot_cold_restarts_bitwise(self, fault_free):
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=2, kind="preempt")]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"snapshot_every_n_steps": 0, "backoff_s": 0.0})
        _assert_bitwise(sup.run(3), fault_free[:3])
        assert sup.recovery_stats()["rebuilds"] == 1

    def test_preempt_after_a_committed_tag_restores_it_bitwise(self, tmp_path, fault_free):
        """Snapshots every 3 steps on disk: the step-5 preemption restores
        global_step3 (engine state, generator, data cursor) and replays."""
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=5, kind="preempt")]))
        snap_dir = str(tmp_path / "s")
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"snapshot_every_n_steps": 3, "snapshot_dir": snap_dir,
                                        "backoff_s": 0.0})
        _assert_bitwise(sup.run(7), fault_free[:7])
        assert sup.recovery_stats()["rebuilds"] == 1
        assert integrity.latest_committed_tag(snap_dir) == "global_step6"

    def test_async_save_torn_at_fence_still_bitwise(self, tmp_path, fault_free):
        """With ``checkpoint.async_save`` the step-4 save's sidecars ride the
        next fence, where the injected tear surfaces (at the step-5
        preemption), is attributed to global_step4, and the restore falls
        back to global_step2: the marker is never placed later, and
        ``latest`` never names the torn tag."""
        cfg = _config(async_save=True)
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=4, kind="torn_write"),
            tfaults.TrainFault(tick=5, kind="preempt")]))
        snap_dir = str(tmp_path / "snaps")
        latest_seen = []
        sup = TrainSupervisor(make_factory(cfg), _loader(), fault_hook=inj,
                              recovery={"snapshot_every_n_steps": 2, "snapshot_dir": snap_dir,
                                        "backoff_s": 0.0})
        real_restore = sup._restore_from_disk

        def restore(exc):
            real_restore(exc)
            latest_seen.append(open(os.path.join(snap_dir, "latest")).read())
            latest_seen.append(sup.engine.global_steps)

        sup._restore_from_disk = restore
        losses = sup.run(6)
        assert inj.pending() == 0
        _assert_bitwise(losses, fault_free[:6])
        stats = sup.recovery_stats()
        assert stats["torn_writes"] == 1 and stats["rebuilds"] == 1
        assert latest_seen == ["global_step2", 2]  # fell back past the torn tag
        # run() end-fences the last async save, so 'latest' is durable
        assert integrity.latest_committed_tag(snap_dir) == "global_step6"


class TestEscalationLadder:
    def test_fetch_watchdog_poisons_engine(self):
        eng = make_factory(dict(_config(), train_batch_size=4))()  # gas 1
        eng.fetch_timeout_s = 1e-12  # any real fetch overruns
        batch = next(iter(TpuDataLoader(_dataset(), batch_size=4)))
        eng.backward(eng.forward(batch))
        with pytest.raises(TimeoutError, match="metrics fetch"):
            eng.step()
        assert eng.poisoned is True

    def test_max_rebuilds_exhaustion_is_terminal(self, tmp_path):
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=1, kind="preempt", count=99)]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"max_rebuilds": 2, "snapshot_every_n_steps": 0,
                                        "snapshot_dir": str(tmp_path / "s"), "backoff_s": 0.0})
        with pytest.raises(TrainingFailed, match="max_rebuilds=2"):
            sup.run(3)
        assert sup.recovery_stats()["rebuilds"] == 2

    def test_clean_retry_exhaustion_escalates_to_rebuild(self, fault_free):
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=2, kind="dispatch_error", count=3)]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"max_step_retries": 1, "snapshot_every_n_steps": 1,
                                        "backoff_s": 0.0})
        losses = sup.run(3)
        stats = sup.recovery_stats()
        # fire#1 -> retry(1) -> fire#2 exhausts the retry budget -> rebuild;
        # the replay absorbs fire#3 with one more clean retry(2)
        assert stats["retries"] == 2 and stats["rebuilds"] == 1
        _assert_bitwise(losses, fault_free[:3])

    def test_degrading_preemption_is_refused_naming_the_roadmap(self, tmp_path):
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=2, kind="preempt", degrade=True)]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              base_config=_config(),
                              recovery={"snapshot_every_n_steps": 1,
                                        "snapshot_dir": str(tmp_path / "s"),
                                        "degrade_world_sizes": [1], "backoff_s": 0.0})
        with pytest.raises(NotImplementedError, match=r"items 8 and 12.*ROADMAP"):
            sup.run(3)

    def test_spans_and_events_go_to_the_adopted_hub(self, tmp_path, fault_free):
        """The first engine's hub is adopted and re-injected into the rebuilt
        one: one trace holds train_step roots with train_retry and
        train_rebuild children, and the train_fault events."""
        trace = str(tmp_path / "trace.jsonl")
        hub = Telemetry(TelemetryConfig(enabled=True, trace_file=trace), role="train")
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=2, kind="dispatch_error"),
            tfaults.TrainFault(tick=3, kind="fetch_hang")]))
        sup = TrainSupervisor(make_factory(_config(), telemetry=hub), _loader(),
                              fault_hook=inj,
                              recovery={"snapshot_every_n_steps": 1, "backoff_s": 0.0})
        _assert_bitwise(sup.run(4), fault_free[:4])
        assert sup.engine.telemetry is hub
        hub._writer.close()
        events = list(read_trace(trace))
        spans = [e for e in events if e.get("kind") == "span"]
        roots = [(e["trace_id"], e["span_id"]) for e in spans if e["span"] == "train_step"]
        # step 3's first attempt failed and was replayed: two roots
        assert [t for t, _ in roots] == ["step:1", "step:2", "step:3", "step:3", "step:4"]
        (retry,) = [e for e in spans if e["span"] == "train_retry"]
        (rebuild,) = [e for e in spans if e["span"] == "train_rebuild"]
        assert retry["parent_id"] == roots[1][1] and rebuild["parent_id"] == roots[2][1]
        faults = [e["event"] for e in events if e.get("kind") == "train_fault"]
        assert faults.count("fault") == 2 and "rebuild" in faults and "retried" in faults
        assert hub.registry.counter("rebuild_total").value == 1


class TestNumericSentinel:
    """Silent corruption — a poisoned batch, a flipped gradient bit — is
    caught by the sentinel and recovered through quarantine or rewind, with
    the loss stream bit for bit a clean run's (with the quarantined batch
    excluded); and an armed sentinel on a clean run flags nothing."""

    def _ref_with_quarantined(self, num_steps, quarantined=()):
        loader = _loader()
        for epoch, batch in quarantined:
            loader.quarantine(epoch, batch)
        return _run_fault_free(num_steps, loader=loader)[0]

    def test_data_poison_quarantined_bitwise(self):
        """data_poison at step 8 (epoch 0, batch 7): the pre-apply loss spike
        quarantines the batch before its grads were applied."""
        ref_losses = self._ref_with_quarantined(8, [(0, 7)])
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=8, kind="data_poison")]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"numeric_sentinel": SENTINEL, "backoff_s": 0.0,
                                        "snapshot_every_n_steps": 0})
        losses = sup.run(8)
        assert inj.pending() == 0 and inj.fired[0]["kind"] == "data_poison"
        _assert_bitwise(losses, ref_losses)
        stats = sup.recovery_stats()
        assert stats["quarantines"] == 1 and stats["rewinds"] == 0 and stats["rebuilds"] == 0
        assert stats["numeric_anomalies"].get("loss_spike", 0) >= 1
        assert (0, 7) in sup.loader._quarantined

    def test_grad_bitflip_rewound_bitwise(self, fault_free):
        """grad_bitflip (exponent bit 30) at step 7: the corrupted update is
        applied, the post-apply grad-norm verdict goes corrupt, and the
        rewind from the step-6 snapshot restores the stream."""
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=7, kind="grad_bitflip", bit=30)]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"numeric_sentinel": SENTINEL, "backoff_s": 0.0,
                                        "snapshot_every_n_steps": 2})
        losses = sup.run(9)
        assert inj.pending() == 0
        fired = inj.fired[0]
        assert fired["kind"] == "grad_bitflip" and fired["bit"] == 30
        assert fired["leaf"] in sup.engine._leaf_names
        _assert_bitwise(losses, fault_free[:9])
        stats = sup.recovery_stats()
        assert stats["rewinds"] == 1 and stats["quarantines"] == 0 and stats["rebuilds"] == 0

    def test_combined_chaos_plan_bitwise(self, tmp_path):
        """A poisoned batch and a flipped bit in one run, replayed from
        JSONL: quarantine and rewind compose."""
        ref_losses = self._ref_with_quarantined(10, [(0, 7)])
        plan = tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=8, kind="data_poison"),
            tfaults.TrainFault(tick=9, kind="grad_bitflip", bit=30)])
        plan_path = str(tmp_path / "plan.jsonl")
        plan.dump(plan_path)
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan.load(plan_path))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"numeric_sentinel": SENTINEL, "backoff_s": 0.0,
                                        "snapshot_every_n_steps": 2})
        losses = sup.run(10)
        assert inj.pending() == 0
        _assert_bitwise(losses, ref_losses)
        stats = sup.recovery_stats()
        assert stats["quarantines"] == 1 and stats["rewinds"] == 1 and stats["rebuilds"] == 0

    def test_clean_run_zero_false_positives_and_unperturbed(self, fault_free):
        for sentinel in ({}, SENTINEL):
            sup = TrainSupervisor(make_factory(_config()), _loader(),
                                  recovery={"numeric_sentinel": sentinel,
                                            "snapshot_every_n_steps": 4})
            _assert_bitwise(sup.run(10), fault_free)
            stats = sup.recovery_stats()
            assert stats["quarantines"] == 0 and stats["rewinds"] == 0
            assert stats["numeric_anomalies"] == {}

    def test_sdc_probe_deterministic_and_free(self, fault_free):
        sup = TrainSupervisor(make_factory(_config()), _loader(),
                              recovery={"numeric_sentinel": {"sdc_probe_every": 2},
                                        "snapshot_every_n_steps": 0})
        _assert_bitwise(sup.run(6), fault_free[:6])
        stats = sup.recovery_stats()
        assert stats["sdc_probes"] == 3 and stats["sdc_mismatches"] == 0
        assert stats["rewinds"] == 0

    def test_sdc_mismatch_rewinds(self, fault_free):
        """A probe whose two digests differ is corruption: rewind and replay
        (the stream stays the fault-free one: nothing was wrong)."""
        sup = TrainSupervisor(make_factory(_config()), _loader(),
                              recovery={"numeric_sentinel": {"sdc_probe_every": 3},
                                        "snapshot_every_n_steps": 2})
        calls = []
        sup._ensure_engine()
        real = sup.engine.sdc_probe

        def probe(batch, rng_seed=0):
            calls.append(1)
            return real(batch, rng_seed) + (1 if len(calls) == 2 else 0)

        sup.engine.sdc_probe = probe
        _assert_bitwise(sup.run(4), fault_free[:4])
        stats = sup.recovery_stats()
        assert stats["sdc_mismatches"] == 1 and stats["rewinds"] == 1
        assert stats["numeric_anomalies"] == {"sdc_mismatch": 1}

    def test_quarantine_budget_exhaustion_escalates_to_rebuild(self, fault_free):
        """max_quarantines=0: the poisoned batch raises NumericCorruption into
        the ladder; the rebuild from the step-6 snapshot replays the spent
        fault's batch clean."""
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=8, kind="data_poison")]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"numeric_sentinel": SENTINEL, "backoff_s": 0.0,
                                        "max_quarantines": 0, "snapshot_every_n_steps": 2})
        _assert_bitwise(sup.run(9), fault_free[:9])
        stats = sup.recovery_stats()
        assert stats["quarantines"] == 0 and stats["rebuilds"] == 1

    def test_rewind_budget_exhaustion_escalates_to_rebuild(self, fault_free):
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=7, kind="grad_bitflip", bit=30)]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"numeric_sentinel": SENTINEL, "backoff_s": 0.0,
                                        "max_rewinds": 0, "snapshot_every_n_steps": 2})
        _assert_bitwise(sup.run(8), fault_free[:8])
        stats = sup.recovery_stats()
        assert stats["rewinds"] == 0 and stats["rebuilds"] == 1

    def test_corrupt_without_snapshot_escalates_to_cold_rebuild(self, fault_free):
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=4, kind="grad_bitflip", bit=30)]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"numeric_sentinel": SENTINEL, "backoff_s": 0.0,
                                        "snapshot_every_n_steps": 0})
        _assert_bitwise(sup.run(5), fault_free[:5])
        stats = sup.recovery_stats()
        assert stats["rewinds"] == 0 and stats["rebuilds"] == 1

    def test_nan_loss_is_quarantined(self):
        """nan_loss on token ids (no float leaf) NaNs the reported loss: a
        corrupt pre-apply verdict, the batch quarantined."""
        ref_losses = self._ref_with_quarantined(5, [(0, 2)])
        inj = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan([
            tfaults.TrainFault(tick=3, kind="nan_loss")]))
        sup = TrainSupervisor(make_factory(_config()), _loader(), fault_hook=inj,
                              recovery={"numeric_sentinel": SENTINEL, "backoff_s": 0.0,
                                        "snapshot_every_n_steps": 0})
        _assert_bitwise(sup.run(5), ref_losses)
        assert sup.recovery_stats()["numeric_anomalies"] == {"non_finite_loss": 1}
