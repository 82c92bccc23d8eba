"""The port's crash-resume smoke (`aclswarm_torch.resilience.smoke`) and
its two overhead tools (`resilience.smoke --overhead`,
`telemetry.overhead`): the chunked driver against the reference
package's (float64, CPU), the SIGKILL drill end to end in a subprocess,
and the overhead tools on a shortened trial."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from aclswarm_torch import convert
from aclswarm_torch.harness import trials as t_trials
from aclswarm_torch.resilience import smoke as t_smoke
from aclswarm_torch.telemetry import overhead as t_overhead
from aclswarm_tpu.resilience import smoke as j_smoke

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ROOT = Path(__file__).resolve().parent.parent
F64 = dict(device="cpu", dtype=torch.float64)


def test_constants_are_the_references():
    assert (t_smoke.N, t_smoke.CHUNK, t_smoke.N_CHUNKS, t_smoke.KILL_AT) \
        == (j_smoke.N, j_smoke.CHUNK, j_smoke.N_CHUNKS, j_smoke.KILL_AT)


def test_problem_is_the_references():
    t_state, t_form, t_cg, t_sp, t_cfg = t_smoke._problem(t_smoke.N, **F64)
    j_state, j_form, j_cg, j_sp, j_cfg = j_smoke._problem(j_smoke.N)
    np.testing.assert_array_equal(t_state.swarm.q.numpy(),
                                  np.asarray(j_state.swarm.q))
    for k in ("points", "adjmat", "gains"):
        np.testing.assert_array_equal(getattr(t_form, k).numpy(),
                                      np.asarray(getattr(j_form, k)))
    assert t_sp.bounds_min == tuple(np.asarray(j_sp.bounds_min))
    assert t_sp.bounds_max == tuple(np.asarray(j_sp.bounds_max))
    assert (t_cfg.assignment, t_cfg.assign_every) == (j_cfg.assignment,
                                                      j_cfg.assign_every)


def test_chunked_run_matches_the_references():
    """Every chunk's metrics and the final state of the uninterrupted
    chunked run: discrete fields exact, floats at 1e-9 (float64)."""
    t_final, t_chunks = t_smoke.chunked_run(**F64)
    j_final, j_chunks = j_smoke.chunked_run()
    assert [k for k, _ in t_chunks] == [k for k, _ in j_chunks] \
        == list(range(t_smoke.N_CHUNKS))
    for (_, tm), (_, jm) in zip(t_chunks, j_chunks):
        for k in ("ca_active", "assign_valid", "reassigned", "auctioned",
                  "mode", "v2f"):
            np.testing.assert_array_equal(getattr(tm, k),
                                          np.asarray(getattr(jm, k)),
                                          err_msg=k)
        for k in ("distcmd_norm", "q"):
            np.testing.assert_allclose(getattr(tm, k),
                                       np.asarray(getattr(jm, k)), rtol=0,
                                       atol=1e-9, err_msg=k)
    out = convert.sim_state_to_numpy(t_final)
    ref = jax.tree.map(np.asarray, j_final)
    np.testing.assert_allclose(out["swarm"]["q"], ref.swarm.q, rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(out["v2f"], ref.v2f)
    assert int(out["tick"]) == int(ref.tick)


def test_resume_in_process_is_bit_identical(tmp_path):
    """The drill without the subprocess: an in-process crash at boundary
    KILL_AT, then a resume from its checkpoint, equals the uninterrupted
    run bit for bit."""
    from aclswarm_torch.resilience import crash

    crash.arm(crash.CrashPlan("smoke", t_smoke.KILL_AT, "raise"))
    try:
        with pytest.raises(crash.InjectedCrash):
            t_smoke.chunked_run(ckpt_dir=tmp_path, resume=False, **F64)
    finally:
        crash.arm(None)
    res_final, res_chunks = t_smoke.chunked_run(ckpt_dir=tmp_path, **F64)
    ref_final, ref_chunks = t_smoke.chunked_run(**F64)
    assert [k for k, _ in res_chunks] == list(range(t_smoke.KILL_AT,
                                                    t_smoke.N_CHUNKS))
    ref = dict(ref_chunks)
    assert all(t_smoke._same(m, ref[k]) for k, m in res_chunks)
    assert t_smoke._same(res_final, ref_final)


def test_a_checkpoint_of_another_dtype_is_refused(tmp_path):
    from aclswarm_torch.resilience import CheckpointMismatch

    t_smoke.chunked_run(ckpt_dir=tmp_path, resume=False, n_chunks=1, **F64)
    with pytest.raises(CheckpointMismatch):
        t_smoke.chunked_run(ckpt_dir=tmp_path, device="cpu",
                            dtype=torch.float32)


def test_smoke_cli_passes_on_the_cpu():
    """`python -m aclswarm_torch.resilience.smoke --device cpu`: the child
    is SIGKILLed at boundary 1, the parent resumes bit for bit."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("ACLSWARM_CRASH", None)
    r = subprocess.run(
        [sys.executable, "-m", "aclswarm_torch.resilience.smoke",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "child SIGKILL'd at chunk boundary 1" in r.stdout
    assert r.stdout.strip().splitlines()[-1].startswith("PASS")


@pytest.fixture
def short_trials(monkeypatch, tmp_path):
    """simform10 trials cut to 2 s (the watchdog), run from an empty
    working directory, with the repository's results listed before."""
    monkeypatch.setattr(t_trials, "TRIAL_TIMEOUT", 2.0)
    monkeypatch.chdir(tmp_path)
    results = ROOT / "benchmarks" / "results"
    return tmp_path, {p: p.stat().st_mtime_ns for p in results.rglob("*")}


def _rows(out: str) -> list:
    import json

    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")]


def _wrote_nothing(cwd, listed):
    results = ROOT / "benchmarks" / "results"
    assert list(cwd.iterdir()) == []
    assert {p: p.stat().st_mtime_ns for p in results.rglob("*")} == listed


def test_checkpoint_overhead_rows(short_trials, capsys):
    cwd, listed = short_trials
    rc = t_smoke.run_overhead(None, reps=1, device="cpu")
    assert rc in (0, 1)      # the 5% bar: timing noise on a 2 s trial
    rows = _rows(capsys.readouterr().out)
    assert [r["name"] for r in rows] == [
        "checkpoint_overhead_frac_n10", "checkpoint_overhead_frac_n10_every1",
        "checkpoint_write_ms_n10"]
    assert rows[0]["chunks"] >= 2 and rows[0]["checkpoint_every"] == 10
    _wrote_nothing(cwd, listed)


def test_telemetry_overhead_rows(short_trials, capsys):
    cwd, listed = short_trials
    rc = t_overhead.main(["--reps", "1", "--device", "cpu"])
    assert rc in (0, 1)
    rows = _rows(capsys.readouterr().out)
    assert [r["name"] for r in rows] == ["telemetry_overhead_frac_n10",
                                         "telemetry_publish_us"]
    assert rows[0]["chunks"] >= 2 and rows[1]["value"] > 0
    _wrote_nothing(cwd, listed)


def test_overhead_writes_only_the_file_asked_for(short_trials, capsys):
    cwd, listed = short_trials
    out = cwd / "rows.jsonl"
    t_smoke.main(["--overhead", "--out", str(out), "--device", "cpu"])
    assert [r["name"] for r in _rows(out.read_text())] == [
        "checkpoint_overhead_frac_n10", "checkpoint_overhead_frac_n10_every1",
        "checkpoint_write_ms_n10"]
    out.unlink()
    _wrote_nothing(cwd, listed)
