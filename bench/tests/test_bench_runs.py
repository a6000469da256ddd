"""Whole runs on the CPU at reduced width (the kernels' plain versions), on
a fake clock (``fake_clock.py``), through cells that exist only as files in
``tests/tiny/``: the reference
agrees with ``TieredEngine`` for a dense FFN and an MoE; faults planted
under the timed path make ``correct`` false, under the dense cells' widest
gap and the MoE cells' mean gap; the fp8 control reads wider gaps than the
program and, held to the same rules, is not correct."""
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import control  # noqa: E402
import fake_clock  # noqa: E402
import run  # noqa: E402

TINY = BENCH / "tests" / "tiny"
TINY_BENCH = json.loads((TINY / "bench.json").read_text())
DIRS = (TINY, BENCH)


@pytest.fixture(autouse=True)
def _fake_clock_one_thread(monkeypatch):
    """Each run on the fake clock, with one CPU thread: the tiny shapes gain
    nothing from more, and test processes beside this one keep the cores."""
    fake_clock.install(monkeypatch, tick=4e-3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_run(workload, seed=11, seconds=1.5, wrap_step=None, trace=False):
    return run.run_cell(workload, seed, seconds, trace, device="cpu", dirs=DIRS, bench=TINY_BENCH,
                        wrap_step=wrap_step)


def test_a_cell_added_as_files_is_found_and_the_dense_reference_agrees():
    """Waves under a pool that evicts live requests: the checked requests
    were evicted, re-promoted and crossed a compaction."""
    out = tiny_run("tiny-dense.batch", seconds=2.0)
    assert out["correct"], out["checked"]
    assert out["checked"]["evicted_pages"]["value"] > 0 and out["checked"]["checked_evicted_requests"]["value"] >= 1
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checked"


def test_the_open_loop_serves_and_a_traced_run_reads_its_per_layer_metrics():
    out = tiny_run("tiny-dense.chat")
    assert out["correct"], out["checked"]
    assert set(out["metrics"]) == {"ttft_p90_ms", "setup_s"}
    out = tiny_run("tiny-dense.chat", trace=True, seconds=2.0)
    assert out["correct"], out["checked"]
    assert set(out["metrics"]) == {"parks_per_token.chat"}
    assert out["device"]["window_s"] > 0


def test_the_moe_reference_replays_the_engines_batches():
    """Capacity drops follow the program's rows; bf16 routing near ties may
    flip a choice, so a few tokens differ, most agree exactly."""
    out = tiny_run("tiny-moe.batch", seconds=2.0)
    assert out["correct"], out["checked"]
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    r = control.readings("tiny-moe.batch", 11, 2.0, control=False, dirs=DIRS, device="cpu")
    assert r["program"]["share_off"] <= 0.1, r


def _state_unchanged(eng):
    inner = eng.step_fn

    def step(params, state, tokens, req_ids):
        saved = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in state.items()}
        nxt, new = inner(params, state, tokens, req_ids)
        for k, v in saved.items():
            if torch.is_tensor(v):
                new[k].copy_(v)
            else:
                new[k] = v
        return nxt, new

    eng.step_fn = step


def _half_batch(eng):
    inner = eng.step_fn

    def step(params, state, tokens, req_ids):  # the later half of the live rows left out
        n = int((req_ids >= 0).sum())
        kept = req_ids.clone()
        kept[(n + 1) // 2:] = -1
        nxt, state = inner(params, state, tokens, kept)
        nxt = nxt.clone()
        nxt[(n + 1) // 2:] = nxt[0]
        return nxt, state

    eng.step_fn = step


def _token_altered(eng):
    inner = eng.step_fn
    vocab = eng.cfg.vocab

    def step(params, state, tokens, req_ids):
        nxt, state = inner(params, state, tokens, req_ids)
        nxt = nxt.clone()
        nxt[0] = (nxt[0] + 1) % vocab
        return nxt, state

    eng.step_fn = step


FAULTS = [_state_unchanged, _half_batch, _token_altered]
# (cell, the gap statistic it holds, window seconds): the dense cell by its widest gap, the MoE by its mean
CASES = [("tiny-dense.batch", "widest", 2.0, f) for f in FAULTS] + [("tiny-moe.batch", "mean", 3.0, f) for f in FAULTS]


@pytest.mark.parametrize("cell,stat,seconds,fault", CASES,
                         ids=[("moe-" if c[0] == "tiny-moe.batch" else "") + c[3].__name__[1:] for c in CASES])
def test_a_fault_under_the_timed_path_is_not_correct(cell, stat, seconds, fault):
    out = tiny_run(cell, wrap_step=fault, seconds=seconds)
    assert not out["correct"]
    assert out["checked"][f"gap_{stat}"]["value"] > out["checked"][f"gap_{stat}"]["limit"]


@pytest.mark.parametrize("cell,stat,seed,seconds", [("tiny-dense.batch", "widest", 11, 2.0),
                                                    ("tiny-moe.batch", "mean", 12, 3.0)], ids=["dense", "moe"])
def test_the_fp8_control_reads_wider_gaps_than_the_program(cell, stat, seed, seconds):
    """Held to the cell's own rules, the control is not correct and the program is."""
    r = control.readings(cell, seed, seconds, dirs=DIRS, device="cpu")
    assert r["control"][stat] > 3 * max(r["program"][stat], 0.01 if stat == "widest" else 0.0), r
    assert r["control"][stat] > json.loads((TINY / "cells" / f"{cell}.json").read_text())["check"]["gap_limit"]
    assert r["program"]["correct"] and not r["control"]["correct"], r
