"""The one-step rules and the rank runner of the port's sharded-step
tests (tests/test_torch_distributed.py, tests/test_torch_tensor_parallel.py,
the split step's ``gpu`` test in tests/test_torch_gpu.py). torch and
repro_torch only, no JAX: the card's machine has none.

``run_ranks`` spawns a worker's ranks as subprocesses on a free local port,
RUN_TIMEOUT seconds at most; ``assert_one_step`` holds one step from a
state to a reference's step from the same state.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import OptimConfig
from repro_torch.models.api import ModelSpec
from torch_dist_worker import reduced_config, restore_target

# The loss is a mean of fp32 log-probabilities over bf16 logits that two
# implementations round alike except where GEMMs sum in another order
# (tests/test_torch_train_cases.py: measured <= 1.09e-5 against JAX).
LOSS_RTOL = 2e-5
ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
RUN_TIMEOUT = 300
LR = 1e-3
GNORM_RTOL = 1e-3  # tests/test_torch_train_step.py's tolerances, step by step
MU_TOL, NU_TOL = 2e-2, 4e-2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tmp: Path, name: str, world: int, worker: Path = WORKER, **case) -> dict:
    """Spawn ``world`` ranks of ``worker`` on ``case``; returns rank 0's
    metrics.json (``torch_tp_worker.py``: its ``out``). Fails if a rank
    fails or the run exceeds RUN_TIMEOUT."""
    case = dict(case, out=str(tmp / name))
    if worker != WORKER:
        case["out"] = str(tmp / name / "metrics.json")
    case_path = tmp / f"{name}.json"
    case_path.write_text(json.dumps(case))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    port = _free_port()
    logs = [open(tmp / f"{name}.rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(case_path), str(r), str(world), str(port)],
                              stdout=log, stderr=subprocess.STDOUT, env=env) for r, log in enumerate(logs)]
    deadline = time.monotonic() + RUN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{name}: the ranks did not finish in {RUN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tail = (tmp / f"{name}.rank{codes.index(next(c for c in codes if c))}.log").read_text()[-4000:]
        pytest.fail(f"{name}: exit codes {codes}\n{tail}")
    return json.loads((tmp / name / "metrics.json").read_text())


def restored(path: Path, arch: str, compress: bool, step: int, replace=None):
    spec = ModelSpec(reduced_config({"arch": arch, "replace": replace or {}}))
    state, _, got = Checkpointer(str(path), async_save=False).restore(restore_target(spec, compress), step=step,
                                                                      device="cpu")
    assert got == step
    return state


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def quant_steps(out, k: int, names):
    """{leaf: int8 quantization step} of step ``k`` of a sharded run."""
    names = sorted(names)
    assert len(out["quant_steps"]) % len(names) == 0 and len(out["quant_steps"]) > k * len(names)
    return dict(zip(names, out["quant_steps"][k * len(names):(k + 1) * len(names)]))


def assert_one_step(before, after, m, want_after, want_m, quant=None, mu_tol=lambda name: MU_TOL,
                    nu_tol=lambda name: NU_TOL, gnorm_rtol: float = GNORM_RTOL):
    """One step from ``before`` against the reference's step from the same
    state, by tests/test_torch_train_step.py's rules: loss within
    LOSS_RTOL, grad norm within GNORM_RTOL (``gnorm_rtol``), mu and nu within MU_TOL
    (``mu_tol``: a leaf's own, by name) / NU_TOL (``nu_tol``) of the leaf's max, master
    moved by at most 2 lr, the residual within half its quantization step
    and within one of the reference's (``quant``: {leaf: step}, where the
    step compressed), params = bf16(master). The first AdamW step is
    sign-like (mhat / sqrt(nhat) = g / (|g| + eps)), so there the masters
    agree to 1e-5 where the two sides' mu agree in sign and both exceed
    1e-6 (a data-parallel gradient is a sum of the ranks' bf16 gradients,
    each rounded apart: one side's may lie near 0 where eps tells); a later
    step's update is a ratio of mu and nu that each side takes from its
    own, so there the master is held to AdamW's update of its own mu and nu
    (within 4e-7 relative: a few fp32 ulps of another order of the same
    operations)."""
    np.testing.assert_allclose(m["loss"], want_m["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], want_m["grad_norm"], rtol=gnorm_rtol)
    assert m["lr"] == want_m["lr"] and m["step"] == want_m["step"] == before["opt"].step + 1
    opt, ref = after["opt"], want_after["opt"]
    assert opt.step == ref.step == before["opt"].step + 1
    for n, p in after["params"].items():
        assert torch.equal(p, opt.master[n].to(torch.bfloat16)), n
        assert _rel(opt.mu[n], ref.mu[n]) <= mu_tol(n), ("mu", n, _rel(opt.mu[n], ref.mu[n]))
        assert _rel(opt.nu[n], ref.nu[n]) <= nu_tol(n), ("nu", n, _rel(opt.nu[n], ref.nu[n]))
        moved = (opt.master[n] - ref.master[n]).abs()
        assert float(moved.max()) <= 2 * LR * 1.001, ("master", n, float(moved.max()))
        if before["opt"].step == 0:
            agree = (torch.sign(opt.mu[n]) == torch.sign(ref.mu[n])) & (torch.minimum(opt.mu[n].abs(), ref.mu[n].abs()) > 1e-6)
            if agree.any():
                assert float(moved[agree].max()) <= 1e-5, ("master where mu agrees", n, float(moved[agree].max()))
        else:
            t, c = opt.step, OptimConfig()
            upd = (opt.mu[n] / (1 - c.b1 ** t)) / (torch.sqrt(opt.nu[n] / (1 - c.b2 ** t)) + c.eps)
            expect = before["opt"].master[n] - m["lr"] * (upd + c.weight_decay * before["opt"].master[n])
            assert torch.allclose(opt.master[n], expect, rtol=4e-7, atol=1e-9), ("master vs its own AdamW update", n)
    for n, q in (quant or {}).items():
        r = after["residual"][n]
        assert float((r - want_after["residual"][n]).abs().max()) <= 1.05 * q, n
        assert float(r.abs().max()) <= 0.5 * q * 1.0001, n


def assert_states_equal(a, b):
    for (n, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), n
        else:
            assert x == y, n


def _leaves(state):
    out = [("opt.step", state["opt"].step)]
    for group in ("params", "residual"):
        out += [(f"{group}.{n}", t) for n, t in sorted(state.get(group, {}).items())]
    for field in ("mu", "nu", "master"):
        out += [(f"opt.{field}.{n}", t) for n, t in sorted(getattr(state["opt"], field).items())]
    return out
