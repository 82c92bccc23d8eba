"""The batched trial driver: the reference's `run_trial_batch` against the
port's, float64 on the CPU.

Both drivers fly the same `simform8` waves (the `simform1000_flooded`
knobs that apply at n=8: Sinkhorn, flooded localization with two phased
stripes, the assign_eps hysteresis, gain_scale 0.15; ``chunk_ticks`` 120,
``trial_timeout`` cut to 40 s as in `test_torch_trials.py`):

- trials 0 and 1 (seeds 1 and 2), which finish in the same chunk;
- trials 2 and 3, which finish a chunk apart, so the wave is compacted
  from two rows to one for its last chunk.

Each trial's `SummaryTrialFSM` must reach the reference's outcome (state,
tick, convergence times, assignment counts, gridlock episodes) and CSV row
(the distances at atol 1e-9). A scripted `maybe_crash("batch", k)` after
a compaction (trials 5 and 6 with the watchdog at 34 s: trial 6
completes at tick 3055, trial 5 flies on to tick 3401), then a resume
from its checkpoint, must give the uninterrupted wave's rows and final
state bit for bit. `run_trials` and the CLI run waves of ``batch``; the driver's
preconditions raise.
"""
import numpy as np
import pytest
import torch

from aclswarm_torch import convert
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_torch.harness import trials as ttrials
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.resilience import crash as tcrash
from aclswarm_torch.sim import summary as tsum
from aclswarm_tpu.harness import supervisor as jsup
from aclswarm_tpu.harness import trials as jtrials

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

CPU64 = dict(device="cpu", dtype="float64")
WAVE = dict(formation="simform8", seed=1, assignment="sinkhorn",
            localization="flooded", flood_phases=2, assign_eps=0.01,
            gain_scale=0.15, trial_timeout=40.0, chunk_ticks=120,
            verbose=False)
N = 8


def _outcome(fsm, names):
    return (names[fsm.state], fsm.tick_count, list(fsm.times),
            list(fsm.assignments), list(fsm.time_avoidance))


def _assert_rows_equal(row_t, row_j):
    assert len(row_t) == len(row_j) and row_t[0] == row_j[0]
    np.testing.assert_allclose(row_t[1:1 + N], row_j[1:1 + N], rtol=0,
                               atol=1e-9)
    assert row_t[1 + N:] == row_j[1 + N:]


class _Rollouts:
    """Wraps the port's `batched_rollout_summary`: the batch size of every
    chunk and the last batched state."""

    def __init__(self, monkeypatch):
        self.sizes, self.final_state = [], None
        run = tsum.batched_rollout_summary

        def _run(state, *args, **kw):
            self.sizes.append(len(state.v2f))
            self.final_state, carry, summ = run(state, *args, **kw)
            return self.final_state, carry, summ

        monkeypatch.setattr(tsum, "batched_rollout_summary", _run)


def _published(monkeypatch, dev_mod) -> list:
    seen, publish = [], dev_mod.ChunkPublisher.publish
    monkeypatch.setattr(dev_mod.ChunkPublisher, "publish",
                        lambda self, key, tel: (seen.append((key, tel)),
                                                publish(self, key, tel)))
    return seen


@pytest.mark.parametrize("trials", [[0, 1], [2, 3]],
                         ids=["same_chunk", "compacted"])
def test_wave_matches_reference(trials, monkeypatch):
    """The compacted wave flies with ``check_mode`` and ``telemetry`` on
    in both drivers: besides the outcomes and rows, every live trial's
    counters published at every chunk boundary, under its own index, are
    the reference's (integers exactly, ``admm_residual`` at rtol
    1e-12)."""
    from aclswarm_torch.telemetry import device as tdev
    from aclswarm_tpu.telemetry import device as jdev

    rec = _Rollouts(monkeypatch)
    cfg = dict(WAVE, batch=2, trials=4)
    if trials == [2, 3]:
        cfg.update(check_mode="on", telemetry="on")
    tpub, jpub = _published(monkeypatch, tdev), _published(monkeypatch, jdev)
    port = ttrials.run_trial_batch(ttrials.TrialConfig(**cfg, **CPU64),
                                   trials)
    ref = jtrials.run_trial_batch(jtrials.TrialConfig(**cfg), trials)
    for t, (a, b) in enumerate(zip(port, ref)):
        assert _outcome(a, tsup.NAMES) == _outcome(b, jsup.NAMES)
        assert a.completed and b.completed
        _assert_rows_equal(a.csv_row(trials[t]), b.csv_row(trials[t]))
    assert [k for k, _ in tpub] == [k for k, _ in jpub]
    assert bool(tpub) == (trials == [2, 3])
    for (_, a), (_, b) in zip(tpub, jpub):
        a, b = dict(a), dict(b)
        np.testing.assert_allclose(a.pop("admm_residual"),
                                   b.pop("admm_residual"), rtol=1e-12)
        assert a == b
    if tpub:
        assert tpub[-1][1]["auctions"] > 0 and tpub[-1][1]["admm_iters"] > 0
    if trials == [2, 3]:
        # trial 2 finishes at tick 3322, trial 3 in the next chunk
        assert rec.sizes[0] == 2 and rec.sizes[-1] == 1
    else:
        assert set(rec.sizes) == {2}


def _state_leaves(state) -> dict:
    return tckpt._leaves(convert.sim_state_to_numpy(state))


def test_resume_after_compaction_is_bit_identical(tmp_path, monkeypatch):
    """Crash at the chunk boundary after the compaction (the checkpoint
    there holds one live row of two), resume: the same rows, FSM snapshots
    and final batched state bits as the uninterrupted wave."""
    rec = _Rollouts(monkeypatch)
    wave = dict(WAVE, trial_timeout=34.0)
    cfg = ttrials.TrialConfig(**wave, batch=2, trials=4, **CPU64)
    whole = ttrials.run_trial_batch(cfg, [5, 6])
    whole_state, sizes = rec.final_state, list(rec.sizes)
    k = sizes.index(1) + 2          # a boundary after the compaction
    assert len(sizes) > k

    ck = ttrials.TrialConfig(**wave, batch=2, trials=4, **CPU64,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=1)
    tcrash.arm(tcrash.CrashPlan("batch", k))
    try:
        with pytest.raises(tcrash.InjectedCrash):
            ttrials.run_trial_batch(ck, [5, 6])
    finally:
        tcrash.arm(None)
    path = tckpt.latest_checkpoint(tmp_path, "wave00005_b2")
    assert path.name == f"wave00005_b2.c{k:08d}.ckpt"
    payload, _ = tckpt.load_checkpoint(path)
    assert payload["live_rows"] == [0]
    rec.sizes.clear()
    resumed = ttrials.run_trial_batch(ck, [5, 6])
    assert len(rec.sizes) == len(sizes) - k
    assert [f.completed for f in whole] == [False, True]
    for t, (a, b) in zip((5, 6), zip(resumed, whole)):
        assert a.csv_row(t) == b.csv_row(t)
        sa, sb = a.snapshot(), b.snapshot()
        for key in sb:
            np.testing.assert_array_equal(np.asarray(sa[key], dtype=object),
                                          np.asarray(sb[key], dtype=object),
                                          err_msg=key)
    got, want = _state_leaves(rec.final_state), _state_leaves(whole_state)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # a finished wave leaves no interim checkpoint behind
    assert tckpt.latest_checkpoint(tmp_path, "wave00005_b2") is None


def test_cli_runs_batched_waves(tmp_path, capsys):
    """``--set batch=2`` runs `run_trials` in waves: three trials as a wave
    of two and a wave of one, rows appended in trial order, a done-marker
    per wave replayed on a second run."""
    out = tmp_path / "b.csv"
    args = ["-f", "simform8", "-m", "3", "-o", str(out),
            "--set", "batch=2", "--set", "chunk_ticks=120",
            "--set", "device=cpu", "--set", "dtype=float64",
            "--set", "assignment=sinkhorn", "--set", "localization=flooded",
            "--set", "flood_phases=2", "--set", "gain_scale=0.15",
            "--set", "trial_timeout=40.0",
            "--set", f"checkpoint_dir={tmp_path / 'ck'}"]
    assert ttrials.main(args) == 0
    rows = np.loadtxt(out, delimiter=",", ndmin=2)
    assert rows[:, 0].tolist() == [0.0, 1.0, 2.0]
    text = capsys.readouterr().out
    assert "Completion: 100.00 % (3/3)" in text
    for key in ("wave00000", "wave00002"):
        assert tckpt.latest_checkpoint(tmp_path / "ck", f"{key}.done")
    assert ttrials.main(args) == 0            # replayed from the markers
    assert "[resumed]" in capsys.readouterr().out
    assert np.loadtxt(out, delimiter=",", ndmin=2).shape[0] == 3


def test_batched_checks_and_counters_run(monkeypatch):
    """``check_mode='on'`` and ``telemetry='on'`` (which used to raise for
    a batch too) run through `run_trials` with batch=2: a clean wave
    raises nothing and publishes each trial's counters under its own
    index, as many auctions as the wave's chunks held."""
    from aclswarm_torch.telemetry import device as tdev

    ttrials._check_dtype(ttrials.TrialConfig(batch=2, **CPU64))
    seen = []
    publish = tdev.ChunkPublisher.publish
    monkeypatch.setattr(tdev.ChunkPublisher, "publish",
                        lambda self, key, tel: (seen.append((key, tel)),
                                                publish(self, key, tel)))
    cfg = ttrials.TrialConfig(**dict(WAVE, trial_timeout=3.0), batch=2,
                              trials=2, check_mode="on", telemetry="on",
                              **CPU64)
    ttrials.run_trials(cfg)
    assert [k for k, _ in seen] == [0, 1] * (len(seen) // 2)
    assert len(seen) >= 4
    for key, tel in seen[-2:]:
        assert tel["flood_stale_max"] > 0 and tel["ca_ticks"] >= 0
        assert tel["auctions"] == tel["reassigns"] == 0    # pre-dispatch


@pytest.mark.parametrize("bad,match", [
    (dict(chunk_ticks=50), "multiple of assign_every"),
    (dict(record_dir="bags"), "record_dir"),
    (dict(assign_every=121, chunk_ticks=121), "flood_every"),
])
def test_driver_preconditions_raise(bad, match):
    cfg = ttrials.TrialConfig(**dict(WAVE, batch=2, trials=2, **bad),
                              **CPU64)
    with pytest.raises(ValueError, match=match):
        ttrials.run_trial_batch(cfg, [0, 1])
