"""The PyTorch port's twins of the JAX examples (examples/quickstart_torch.py,
serve_tiered_torch.py, train_lm_torch.py) run end to end with ``--device
cpu`` (the kernels' plain versions), each in a subprocess; the train twin
with its steps cut to 10 and its crash-and-resume drill."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(tmp_path, script, *args) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu", *args], env=env,
                         capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res.stdout


def test_quickstart_twin(tmp_path):
    out = run(tmp_path, "quickstart_torch.py")
    assert "tiered decode: 24 of 24 tokens equal to dense decode; each within 0.0000" in out  # the plain versions
    assert out.rstrip().endswith("ok")


def test_serve_tiered_twin(tmp_path):
    out = run(tmp_path, "serve_tiered_torch.py")
    assert "[serve/baseline] 64 tokens" in out and "[serve/skybyte] 64 tokens" in out
    assert "completed requests        : 4/4" in out


def test_train_lm_twin_drill(tmp_path):
    out = run(tmp_path, "train_lm_torch.py", "--drill", "--steps", "10", "--ckpt-dir", str(tmp_path / "ckpt"))
    # resumed from the last checkpoint written before the crash (saves are asynchronous)
    assert "SIMULATED FAILURE at step 6" in out and "resumed from step" in out and out.rstrip().endswith("done")
