"""Recordings and their replay (`aclswarm_torch.harness.review`,
`harness.rosbag1`) against the reference's, on the reference's own
synthetic recording (`tests/test_review.py`: a ground start, a takeoff
ramp, periodic auctions, convergence at 7 s).

- `record` writes the reference's file format: each package reads the
  other's recording field for field.
- `review` of the port's recording reaches what the reference's `review`
  reaches on the reference's (state, ticks, times, CSV row), on the happy
  path, without a takeoff, and in both cases of the interactive
  `/in_formation` gate (a human call completes a formation the machine
  predicate never would; a call during gridlock aborts the trial).
- A recording exported as a rosbag and read back (`rosbag1`) gives both
  packages the same arrays and the same verdict.
- The CLI (``python -m aclswarm_torch.harness.review``), including the
  stdin gate.

`tests/test_torch_trials.py` records real trials in both packages and
holds each replay against its live trial.
"""
import numpy as np
import pytest
import torch

from aclswarm_torch.harness import review as treview
from aclswarm_torch.harness import rosbag1 as trosbag
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_tpu.harness import review as jreview
from aclswarm_tpu.harness import rosbag1 as jrosbag
from aclswarm_tpu.harness import supervisor as jsup

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers


def _synthetic(T=2200, n=4, takeoff_alt=1.0):
    """The reference's hand-built happy-path recording, as a dict."""
    t = np.arange(T)
    z = np.clip((t - 100) * 0.005, 0.0, takeoff_alt)
    m = dict(q=np.zeros((T, n, 3)), distcmd_norm=np.full((T, n), 2.0),
             ca_active=np.zeros((T, n), bool), reassigned=np.zeros(T, bool),
             auctioned=np.zeros(T, bool), assign_valid=np.ones(T, bool),
             mode=np.full((T, n), 2, np.int32),
             v2f=np.tile(np.arange(n, dtype=np.int32), (T, 1)))
    m["q"][:, :, 0] = np.arange(n)[None, :] * 2.0
    m["q"][:, :, 2] = z[:, None]
    m["distcmd_norm"][t > 700] = 0.1
    m["auctioned"][400::120] = True
    m["reassigned"][400] = True
    return m


def _record_both(tmp_path, m):
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    treview.record(tpath, m, dt=0.01, seed=7, formation="swarm4",
                   trial_timeout=600.0)
    jreview.record(jpath, type("M", (), m)(), dt=0.01, seed=7,
                   formation="swarm4", trial_timeout=600.0)
    return tpath, jpath


def _verdict(fsm, names):
    return (names[fsm.state], fsm.tick_count, list(fsm.times),
            fsm.csv_row(0))


@pytest.mark.parametrize("variant", ["happy", "no_takeoff"])
def test_record_and_review_match_reference(tmp_path, variant):
    m = _synthetic()
    if variant == "no_takeoff":
        m["q"][:, :, 2] = 0.0
    tpath, jpath = _record_both(tmp_path, m)
    for path in (tpath, jpath):
        t_rec, j_rec = treview.Recording(path), jreview.Recording(path)
        for f in treview.FIELDS:
            np.testing.assert_array_equal(getattr(t_rec, f),
                                          getattr(j_rec, f), err_msg=f)
        assert t_rec.dt == j_rec.dt == 0.01
        assert t_rec.meta.keys() == j_rec.meta.keys()
        assert str(t_rec.meta["formation"]) == "swarm4"
        assert (t_rec.n, t_rec.n_ticks) == (4, 2200)
    want = _verdict(jreview.review(jpath, takeoff_alt=1.0), jsup.NAMES)
    got = _verdict(treview.review(tpath, takeoff_alt=1.0), tsup.NAMES)
    assert got == want
    assert _verdict(treview.review(jpath, takeoff_alt=1.0),
                    tsup.NAMES) == want
    assert (want[0] == "COMPLETE") == (variant == "happy")


def test_interactive_gate_matches_reference(tmp_path):
    """The reference's two gate cases: a human call at 15 s completes a
    formation whose signals never converge; a call once the FSM is in
    GRIDLOCK aborts the trial long before the gridlock watchdog."""
    m = _synthetic()
    m["distcmd_norm"][:] = 2.0
    tpath, jpath = _record_both(tmp_path, m)
    calls = {"t": [], "j": []}

    def at_15s(tag):
        def gate(t, fsm):
            calls[tag].append(t)
            return t >= 1500
        return gate

    jf = jreview.review(jpath, takeoff_alt=1.0, in_formation_gate=at_15s("j"))
    tf = treview.review(tpath, takeoff_alt=1.0, in_formation_gate=at_15s("t"))
    assert not treview.review(tpath, takeoff_alt=1.0).completed
    assert tf.completed and _verdict(tf, tsup.NAMES) \
        == _verdict(jf, jsup.NAMES)
    assert calls["t"] == calls["j"] and calls["t"]

    m["ca_active"][900:, :] = True
    tpath, jpath = _record_both(tmp_path, m)

    def in_gridlock(state):
        return lambda t, fsm: fsm.state == state

    jf = jreview.review(jpath, takeoff_alt=1.0, in_formation_gate=in_gridlock(
        jsup.TrialState.GRIDLOCK))
    tf = treview.review(tpath, takeoff_alt=1.0, in_formation_gate=in_gridlock(
        tsup.TrialState.GRIDLOCK))
    assert tf.state == tsup.TrialState.TERMINATE
    assert _verdict(tf, tsup.NAMES) == _verdict(jf, jsup.NAMES)
    assert tf.tick_count * 0.01 < 30.0


def test_bag_roundtrip_matches_reference(tmp_path):
    """The port's recording exported as a rosbag (the port's writer): both
    packages' readers resample it onto the same arrays, and both reviews
    of the bag agree."""
    m = _synthetic(T=1200)
    tpath, _ = _record_both(tmp_path, m)
    bag = str(tmp_path / "t.bag")
    trosbag.recording_to_bag(tpath, bag)
    t_rec, j_rec = treview.Recording(bag), jreview.Recording(bag)
    for f in treview.FIELDS:
        np.testing.assert_array_equal(getattr(t_rec, f), getattr(j_rec, f),
                                      err_msg=f)
    assert t_rec.dt == j_rec.dt
    jbag = str(tmp_path / "j.bag")
    jrosbag.recording_to_bag(tpath, jbag)
    assert open(bag, "rb").read() == open(jbag, "rb").read()
    assert _verdict(treview.review(bag, takeoff_alt=1.0), tsup.NAMES) \
        == _verdict(jreview.review(bag, takeoff_alt=1.0), jsup.NAMES)


def test_cli_reviews_a_recording(tmp_path, capsys, monkeypatch):
    tpath, _ = _record_both(tmp_path, _synthetic())
    assert treview.main([tpath]) == 0
    assert "review: COMPLETE" in capsys.readouterr().out
    # the stdin gate: the operator answers "n" once, then stdin runs dry
    answers = iter(["n"])

    def fake_input(prompt):
        try:
            return next(answers)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", fake_input)
    m = _synthetic()
    m["distcmd_norm"][:] = 2.0
    path = str(tmp_path / "never.npz")
    treview.record(path, m, dt=0.01)
    assert treview.main([path, "--interactive", "--trial-timeout",
                         "20"]) == 1
    assert "review: TERMINATE" in capsys.readouterr().out
