"""The zamba2 family with its reference off: the reference leaves out each
site's adapter on the shared blocks' gate/up projection, so the tokens the
program served read gaps past the cell's limit and the run is not correct.
Everything else is the benchmark's zamba2 family, loaded as a module of its
own."""
from __future__ import annotations

import importlib.util
import types
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "tiny_zamba2_off_family", Path(__file__).resolve().parents[3] / "families" / "zamba2.py")
_fam = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fam)

layout, program_config, decode_flops = _fam.layout, _fam.program_config, _fam.decode_flops
attention_calls, replays_batches = _fam.attention_calls, _fam.replays_batches


def checked_gaps(run, ctx, control: bool = False):
    """The family's comparison with a reference whose model has no adapters."""
    off = types.SimpleNamespace(**{**vars(ctx), "model": {**ctx.model, "adapter_rank": 0}})
    return _fam.checked_gaps(run, off, control)
