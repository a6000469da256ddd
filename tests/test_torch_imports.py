"""The port stands alone: importing every module of repro_torch (the
encoder-decoder, RWKV6, Mamba2 and step-builder modules, the training
path's optimizer, data, checkpoint and launcher modules, and the sharding,
mesh and dry-run modules among them), chip_smoke.py and the example twins
(examples/*_torch.py), pulls in neither JAX nor the JAX package nor
ml_dtypes (the card's machine has none), and builds nothing."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "examples")
for name in ("quickstart_torch", "serve_tiered_torch", "train_lm_torch"):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro.") or m == "ml_dtypes" or m.startswith("ml_dtypes."))
new = ["repro_torch.models.encdec", "repro_torch.models.rwkv6", "repro_torch.models.mamba2",
       "repro_torch.launch.steps", "repro_torch.optim", "repro_torch.optim.adamw",
       "repro_torch.optim.grad_compress", "repro_torch.optim.schedules", "repro_torch.data.pipeline",
       "repro_torch.checkpoint", "repro_torch.checkpoint.checkpointer", "repro_torch.launch.train",
       "repro_torch.distributed", "repro_torch.distributed.sharding", "repro_torch.distributed.groups",
       "repro_torch.launch.mesh", "repro_torch.launch.dryrun"]
assert all(name in names for name in new), names
print(len(names), bad)
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    build_dir = ROOT / "src" / "repro_torch" / "_build"
    before = sorted(build_dir.glob("*")) if build_dir.exists() else []
    res = subprocess.run([sys.executable, "-c", PROBE], env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(maxsplit=1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"
    after = sorted(build_dir.glob("*")) if build_dir.exists() else []
    assert before == after
