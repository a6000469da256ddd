"""The toy family with its reference off: the reference leaves RoPE out, so
the tokens the program served read gaps far past the cell's limit and the
run is not correct. Everything else is the toy family's."""
from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("tiny_toy_family", Path(__file__).with_name("toy.py"))
_toy = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_toy)

layout, program_config, decode_flops = _toy.layout, _toy.program_config, _toy.decode_flops
attention_calls, replays_batches = _toy.attention_calls, _toy.replays_batches


def checked_gaps(run, ctx, control: bool = False):
    return _toy.checked_gaps(run, ctx, control, rope=False)
