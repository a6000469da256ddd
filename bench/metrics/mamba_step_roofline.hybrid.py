"""Least time of the traced slice's Mamba2 decode-token launches over their
device time, % (bytes bound): each traced decoding step's live rows give
one launch's least time (``roofline/mamba_step.py``), times a launch a Mamba
layer, over the device time of ``mamba_step_kernel``. None where the slice
holds no decoding step with that kernel (a program without it)."""
from benchkit import readers


def read(view):
    s, steps = view.summary, view.rec["traced_steps"]
    if not s or not steps or s["kernels"].get("mamba_step", 0) <= 0:
        return None
    rl = view.roofline("mamba_step")
    least = sum(readers.bound_s(*rl.bytes_flops(view.model, len(st["rows"]))) for st in steps)
    return least * view.model["n_layers"] / s["kernels"]["mamba_step"] * 100
