"""The port's serving launcher end to end on the CPU (plain versions of the
kernels), and the rule that a missing card is an error, never a silent
switch to the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.models.api import ModelSpec
from repro_torch.serving.engine import TieredEngine

ROOT = Path(__file__).resolve().parent.parent
ARGS = ["--device", "cpu", "--requests", "3", "--prompt-len", "21", "--new-tokens", "12"]


def _serve(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *ARGS, *extra],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("tiering", ["skybyte", "baseline"])
def test_serve_cli_on_cpu(tiering):
    out = _serve("--tiering", tiering)
    assert f"[serve/{tiering}] 36 tokens" in out
    if tiering == "skybyte":
        assert "completed requests        : 3/3" in out
        assert "parks (ctx switches)" in out and "coalesce ratio" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e", "llava-next-34b"])
def test_serve_cli_moe_and_vlm_on_cpu(arch):
    """The launcher serves the moe and vlm archs (the vlm's text only, as in
    JAX) through the tiered engine."""
    out = _serve("--arch", arch, "--tiering", "skybyte")
    assert "[serve/skybyte] 36 tokens" in out
    assert "completed requests        : 3/3" in out


def test_serve_cli_refuses_non_gqa_families():
    """As JAX's launcher: the tiered engine serves the GQA decoder families;
    the others exit with JAX's message, pointing to the step builders."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *ARGS, "--arch", "rwkv6-3b"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert ("tiered serving demo targets GQA decoder families; ssm decode runs via "
            "repro_torch.launch.steps.build_serve_step") in res.stderr


def test_missing_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    spec = ModelSpec(get_reduced("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.init(torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredEngine(spec, {}, TieredKVConfig())  # the default device is cuda
