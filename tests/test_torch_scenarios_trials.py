"""Scenarios through the port's trial harness (`TrialConfig.scenario`),
float64 on the CPU.

- `swarm6_3d` (seed 1, doubleint, the reference's own trial case) under
  the `popup_obstacles` family over the default horizon (the trial
  budget capped at 2400 ticks): the reference's `run_trials` and the
  port's reach the same verdict, supervisor transitions and CSV row
  (distances at 1e-9, as `tests/test_torch_trials.py` holds them). The
  draw-driven axes meet the reference in `test_torch_scenarios*.py`.
- Port-only: a `kitchen_sink` trial on `simform8` (the Sinkhorn + flooded
  knobs of `tests/test_torch_trials.py`, cut at 2.5 s, events inside a
  120-tick horizon, gusts drawn every tick from tick 36) crashed at chunk
  3 and resumed from its checkpoint: the same final state bits,
  scenario leaves included; the batched driver starts each trial of a
  wave with its own draw; the CLI's ``--set scenario=...``.

Serial time of this file on one CPU host: ~22 s.
"""
import numpy as np
import pytest
import torch

from aclswarm_torch.core import config as configlib
from aclswarm_torch.harness import trials as ttrials
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.resilience import crash as tcrash
from aclswarm_torch.sim import summary as tsum
from aclswarm_tpu.harness import trials as jtrials
from test_torch_trials import (CPU64, SIMFORM, _assert_rows_equal,
                               _jax_recorder, _port_recorder, _state_leaves)

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers


def test_run_trials_with_scenario_matches_reference(tmp_path, monkeypatch):
    kw = dict(formation="swarm6_3d", seed=1, dynamics="doubleint",
              scenario="popup_obstacles", verbose=False)
    jrec = _jax_recorder(monkeypatch)
    jstats = jtrials.run_trials(jtrials.TrialConfig(
        **kw, out=str(tmp_path / "j.csv")))
    trec = _port_recorder(monkeypatch)
    tstats = ttrials.run_trials(ttrials.TrialConfig(
        **kw, out=str(tmp_path / "t.csv"), **CPU64))
    assert trec.transitions == jrec.transitions
    assert tstats["trials_completed"] == jstats["trials_completed"] == 1
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[k], v, rtol=0, atol=1e-9,
                                   err_msg=k)
    jrow = np.loadtxt(tmp_path / "j.csv", delimiter=",", ndmin=2)[0]
    trow = np.loadtxt(tmp_path / "t.csv", delimiter=",", ndmin=2)[0]
    _assert_rows_equal(trow.tolist(), jrow.tolist(), 6)
    # the obstacles popped up inside the last formation's phase
    final = trec.final_state
    assert int(final.scenario.obs_appear.min()) < final.tick


def test_scenario_trial_resumes_bit_identical(tmp_path, monkeypatch):
    cfg_kw = dict(SIMFORM, trial_timeout=2.5, scenario="kitchen_sink",
                  scenario_horizon=120, checkpoint_every=1, verbose=False,
                  **CPU64)
    rec = _port_recorder(monkeypatch)
    whole = ttrials.run_trial(ttrials.TrialConfig(**cfg_kw), 0)
    whole_state = rec.final_state
    cfg = ttrials.TrialConfig(**cfg_kw, checkpoint_dir=str(tmp_path))
    tcrash.arm(tcrash.CrashPlan("trial", 3))
    try:
        with pytest.raises(tcrash.InjectedCrash):
            ttrials.run_trial(cfg, 0)
    finally:
        tcrash.arm(None)
    assert tckpt.latest_checkpoint(tmp_path, "trial00000") is not None
    resumed = ttrials.run_trial(cfg, 0)
    assert resumed.csv_row(0) == whole.csv_row(0)
    got, want = _state_leaves(rec.final_state), _state_leaves(whole_state)
    assert got.keys() == want.keys()
    assert any(k.startswith("scenario.") for k in want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _Started(Exception):
    pass


def test_wave_starts_each_trial_with_its_draw(monkeypatch):
    """`run_trial_batch` stacks each trial's own draw (seeded
    ``scenario_seed + t``) into the wave's state, host onsets included,
    as `run_trial` would fly it."""
    cfg = ttrials.TrialConfig(**dict(SIMFORM, chunk_ticks=120, batch=2,
                                     trials=2, scenario="wind_gust",
                                     scenario_seed=7), **CPU64)
    seen = []

    def _first_chunk(state, *args, **kw):
        seen.append(state)
        raise _Started

    monkeypatch.setattr(tsum, "batched_rollout_summary", _first_chunk)
    with pytest.raises(_Started):
        ttrials.run_trial_batch(cfg, [0, 1])
    scen = seen[0].scenario
    for t in (0, 1):
        want = ttrials._trial_scenario(cfg, cfg.seed + t, t, 8,
                                       cfg.trial_timeout, "cpu",
                                       torch.float64)
        for k, v in vars(want).items():
            if not k.startswith("_"):
                assert torch.equal(getattr(scen, k)[t], v), (t, k)
        assert scen._host["wind_tick"][t] == want._host["wind_tick"]


def test_cli_sets_a_scenario(tmp_path):
    path = tmp_path / "cfg.yaml"
    assert ttrials.main(["-f", "swarm4", "--set", "scenario=wind_gust",
                         "--set", "scenario_seed=4",
                         "--set", "scenario_horizon=400",
                         "--save-config", str(path)]) == 0
    cfg = configlib.load_layers(ttrials.TrialConfig, file=path)
    assert (cfg.scenario, cfg.scenario_seed, cfg.scenario_horizon) \
        == ("wind_gust", 4, 400)
