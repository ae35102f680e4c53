"""The ZeRO leg of the port's crash/resume trainer, killed at dp 4 and
resumed at dp 2 (the port's twin of ``tests/test_elastic_resume.py``'s
fast leg, ``scripts/elastic_resume_smoke.sh`` with ``MODE=zero``).

``python -m apex_tpu_torch.testing.crash_resume --zero`` on gloo CPU
ranks, each leg a command that starts its ranks: an uninterrupted dp 4
run keeping every checkpoint, and beside it a dp 4 run SIGKILLed (its
process group: the command and its ranks) after three steps, mid-way
through its async sharded saves; then the killed run resumed at dp 2,
where ``restore_latest`` re-chunks the flat-bucket optimizer buffers for
the new world, and beside it the uninterrupted run's checkpoint of the
same step resumed at dp 2 (the clean reshard).  The losses are raw fp32
bits: the killed run's prefix is the uninterrupted run's, its resumed
curve the clean reshard's, and the two final checkpoints' logical digests
(``reshard.load_logical``) are equal.  The dp 2 arithmetic re-associates
the reductions, so the clean dp 2 continuation, not the dp 4 curve, is
the reference after the resume.
"""

import os
import shutil
import signal
import subprocess
import sys
import time

from apex_tpu_torch.resilience import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, KILL_AFTER = 6, 3


def _cmd(work, name, devices, *extra):
    return [sys.executable, "-m", "apex_tpu_torch.testing.crash_resume",
            "--zero", "--device", "cpu", "--devices", str(devices),
            "--global-batch", "8", "--steps", str(STEPS),
            "--ckpt-dir", os.path.join(work, f"ckpt_{name}"),
            "--losses", os.path.join(work, f"losses_{name}.txt"), *extra]


def _start(cmd):
    return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ,
                                                    PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


def _finish(proc, what, timeout=180):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (
        f"{what}: rc {proc.returncode}\n{err.decode(errors='replace')[-3000:]}")
    return err.decode(errors="replace")


def _wait_group_gone(pgid, timeout=30.0):
    """Until every process of the killed group has exited (a rank in a
    system call finishes it, a commit's rename included)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.02)
    raise AssertionError(f"process group {pgid} outlived its SIGKILL")


def _newest_intact(ckpt_dir):
    """The step ``restore_latest`` takes: the newest that verifies (every
    shard written and sound; the commit's rename may not have landed)."""
    mgr = CheckpointManager(ckpt_dir, sharded=True)
    for step in reversed(mgr.all_steps()):
        try:
            mgr.verify(step)
        except (ValueError, OSError, KeyError):
            continue
        return step
    raise AssertionError(f"no intact checkpoint under {ckpt_dir}")


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_zero_flat_bucket_killed_at_dp4_resumes_at_dp2(tmp_path):
    work = str(tmp_path)
    ref = _start(_cmd(work, "ref", 4, "--keep", str(STEPS)))
    crash = _start(_cmd(work, "crash", 4, "--step-delay", "0.6"))
    losses = os.path.join(work, "losses_crash.txt")
    deadline = time.monotonic() + 150
    try:
        while not (os.path.exists(losses)
                   and len(_lines(losses)) >= KILL_AFTER):
            assert crash.poll() is None, crash.stderr.read().decode()
            assert time.monotonic() < deadline, "the kill point never came"
            time.sleep(0.05)
    finally:
        os.killpg(crash.pid, signal.SIGKILL)
        crash.wait()
        _wait_group_gone(crash.pid)
    killed_at = len(_lines(losses))
    assert KILL_AFTER <= killed_at < STEPS
    _finish(ref, "uninterrupted dp 4 run")
    want = _lines(os.path.join(work, "losses_ref.txt"))
    assert [ln.split()[0] for ln in want] == [str(i)
                                              for i in range(1, STEPS + 1)]

    step = _newest_intact(os.path.join(work, "ckpt_crash"))
    clean_dir = os.path.join(work, "ckpt_clean")
    os.makedirs(clean_dir)
    shutil.copytree(os.path.join(work, "ckpt_ref", f"step_{step:08d}"),
                    os.path.join(clean_dir, f"step_{step:08d}"))
    shutil.copy(os.path.join(work, "losses_ref.txt"),
                os.path.join(work, "losses_clean.txt"))
    fps = {n: os.path.join(work, f"{n}.fp") for n in ("crash", "clean")}
    resumed = _start(_cmd(work, "crash", 2, "--resume",
                          "--fingerprint", fps["crash"]))
    clean = _start(_cmd(work, "clean", 2, "--resume",
                        "--fingerprint", fps["clean"]))
    err = _finish(resumed, "killed run resumed at dp 2")
    assert f"resumed from step {step}" in err
    assert f"resumed from step {step}" in _finish(clean, "clean reshard")

    got = _lines(losses)
    assert got[:step] == want[:step]            # the prefix at dp 4
    assert got == _lines(os.path.join(work, "losses_clean.txt"))
    assert len(got) == STEPS
    assert _lines(fps["crash"]) == _lines(fps["clean"])
    assert any("/exp_avg/0[" in ln for ln in _lines(fps["crash"]))
