"""The training launcher's fault-tolerance drill on the CPU:
``python -m repro_torch.launch.train`` run for N steps ends, bit for bit,
where a run crashed by ``--fail-at k`` (exit 42) and then ``--resume``d
ends. ``launcher_drill`` is shared with the card's test in
tests/test_torch_gpu.py (this module imports no JAX)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args, rc):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], env=env, capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == rc, res.stdout + res.stderr
    return res.stdout


def launcher_drill(tmp_path, device: str, steps: int = 6, every: int = 3, fail_at: int = 3, extra=()):
    """Run ``steps`` steps whole, and again crashed at ``fail_at`` then
    resumed; assert that both end in the same checkpoint, bit for bit, and
    print the same metrics for the last step."""
    base = ["--arch", "smollm-135m", "--steps", str(steps), "--seq", "32", "--batch", "4", "--ckpt-every",
            str(every), "--device", device, "--seed", "1", *extra]
    whole = _run([*base, "--ckpt-dir", str(tmp_path / "whole")], 0)
    crashed = _run([*base, "--ckpt-dir", str(tmp_path / "crash"), "--fail-at", str(fail_at)], 42)
    assert f"SIMULATED FAILURE at step {fail_at}" in crashed
    resumed = _run([*base, "--ckpt-dir", str(tmp_path / "crash"), "--resume"], 0)
    assert f"resumed from step {fail_at // every * every}" in resumed
    last = [line.split("(")[0] for line in whole.splitlines() if line.startswith(f"[train] step {steps - 1:4d}")]
    assert last and last == [line.split("(")[0] for line in resumed.splitlines()
                             if line.startswith(f"[train] step {steps - 1:4d}")]
    a, b = tmp_path / "whole" / f"step_{steps}", tmp_path / "crash" / f"step_{steps}"
    assert (a / "manifest.json").read_text() == (b / "manifest.json").read_text()
    with np.load(a / "leaves.npz") as za, np.load(b / "leaves.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            assert za[key].dtype == zb[key].dtype and np.array_equal(za[key], zb[key]), key


@pytest.mark.parametrize("fail_at,extra", [(3, ["--compress"]), (4, [])])
def test_crash_and_resume_is_bit_identical(tmp_path, fail_at, extra):
    """A crash right after a checkpoint (with int8 error feedback, so the
    residual is restored too), and one a step later (the resumed run redoes
    that step from the checkpoint and the data state it saved)."""
    launcher_drill(tmp_path, "cpu", fail_at=fail_at, extra=extra)


def test_launcher_refuses_a_missing_card(tmp_path):
    """``--device cuda`` where no card is visible fails; it does not train
    on the CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "1", "--ckpt-dir",
                          str(tmp_path)], env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
