"""The trainer's SIGTERM guard, end to end in processes of their own.

``python -m flextree_tpu_torch.trainer --ckpt-dir`` is signalled mid-run:
it checkpoints within one step of the signal (at most one ``step N`` log
line is stamped after the signal was sent), prints the JAX trainer's
``(preempted at step N, checkpointed)`` and exits 0; a relaunch resumes
and finishes bitwise where a straight-through run of the same steps ends.
``--no-preempt-checkpoint`` leaves SIGTERM fatal; with the flight
recorder on and no guard, the signal leaves a dump in the obs directory.
"""

from __future__ import annotations

import datetime
import json
import os
import re
import signal
import subprocess
import sys
import time

import torch

from flextree_tpu_torch.parallel.train import tree_leaves
from flextree_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 200
ARGS = ["--cpu", "--vocab", "64", "--d-model", "64", "--n-heads", "4",
        "--n-layers", "2", "--d-ff", "128", "--seq-len", "64", "--batch", "8",
        "--corpus-tokens", "20000", "--steps", str(STEPS), "--log-every", "1",
        "--ckpt-every", "1000"]
STEP_LINE = re.compile(r"^(\S+ \S+) I \S+\] step (\d+) loss ")


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("FT_RANK", None)
    return env


def _run(extra, cwd):
    proc = subprocess.run(
        [sys.executable, "-m", "flextree_tpu_torch.trainer", *ARGS, *extra],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _signalled(extra, cwd, at_step=2):
    """Launch, send SIGTERM once ``step at_step`` is logged; returns
    ``(returncode, stdout, stderr lines, wall time of the signal)``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "flextree_tpu_torch.trainer", *ARGS, *extra],
        cwd=cwd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines, sent = [], None
    for line in proc.stderr:
        lines.append(line)
        m = STEP_LINE.match(line)
        if sent is None and m and int(m.group(2)) >= at_step:
            sent = time.time()
            proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert sent is not None, "".join(lines[-20:])
    return proc.returncode, out, lines, sent


def _stamp(text: str) -> float:
    return datetime.datetime.strptime(text, "%Y-%m-%d %H:%M:%S,%f").timestamp()


def _final(ckpt_dir):
    return tckpt.restore_train_state(ckpt_dir, "cpu")


def test_sigterm_checkpoints_within_one_step_and_resumes_bitwise(tmp_path):
    straight = str(tmp_path / "straight")
    _run(["--ckpt-dir", straight], tmp_path)
    ck = str(tmp_path / "ck")
    rc, out, lines, sent = _signalled(["--ckpt-dir", ck], tmp_path)
    assert rc == 0, "".join(lines[-20:])
    last = out.strip().splitlines()[-1]
    m = re.search(r"\(preempted at step (\d+), checkpointed\)$", last)
    assert m, last
    at = int(m.group(1))
    assert at < STEPS
    # the step in flight when the signal came is the only one logged after
    after = [int(s.group(2)) for s in map(STEP_LINE.match, lines)
             if s and _stamp(s.group(1)) > sent]
    assert len(after) <= 1, after
    assert tckpt.latest_checkpoint(ck).endswith(f"ckpt_{at:08d}.npz")
    assert int(_final(ck)["step"]) == at
    proc = _run(["--ckpt-dir", ck], tmp_path)
    assert f"(resumed from {at})" in proc.stdout.strip().splitlines()[-1]
    got, want = _final(ck), _final(straight)
    assert int(got["step"]) == int(want["step"]) == STEPS
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_no_preempt_checkpoint_leaves_sigterm_fatal_and_dumps(tmp_path):
    """Without the guard the signal terminates the run and writes no
    checkpoint; the flight recorder, on, chains a dump onto it."""
    ck = str(tmp_path / "ck")
    rc, out, lines, _ = _signalled(["--ckpt-dir", ck,
                                    "--no-preempt-checkpoint",
                                    "--flight-recorder"], tmp_path)
    assert rc == -signal.SIGTERM, "".join(lines[-20:])
    assert "preempted" not in out
    assert tckpt.latest_checkpoint(ck) is None
    obs = os.path.join(ck, "obs")
    assert sorted(os.listdir(obs)) == ["flight_00000.dump.json",
                                       "flight_00000.jsonl"]
    with open(os.path.join(obs, "flight_00000.dump.json")) as f:
        assert json.load(f)["reason"] == "signal"
