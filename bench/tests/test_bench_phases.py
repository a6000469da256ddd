"""``benchkit/phases.py`` on synthetic profiles and recorded counters, and
``engine_phases.py`` through a tiny cell on the CPU."""
import json
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import engine_phases  # noqa: E402
from benchkit import phases  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
TINY = BENCH / "tests" / "tiny"


def ev(name, start, end, device=CPU, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def name_filter(events):
    """``trace.py``'s device-op filter."""
    return [e for e in events if e.device_type == CUDA and not e.name.startswith("bench.")]


def test_device_ops_drop_the_profilers_annotations():
    kernel, copy = ev("paged_split_kernel", 10, 12, CUDA), ev("Memcpy HtoD", 14, 15, CUDA)
    parent_events = [ev("bench.step", 0, 30), ev("bench.step", 9, 16, CUDA, annotation=True), kernel, copy,
                     ev("aten::mm", 9, 10)]
    # a profile of a program whose only ranges are the harness's reads the same either way
    assert phases.device_ops(parent_events) == name_filter(parent_events) == [kernel, copy]
    program = parent_events + [ev("engine.decode", 9, 16, CUDA, annotation=True), ev("engine.decode", 5, 20)]
    assert phases.device_ops(program) == [kernel, copy]
    assert len(name_filter(program)) == 3


def test_innermost_segments_of_nested_ranges():
    spans = [(0, 10, "engine.step"), (2, 5, "engine.promote"), (3, 4, "tier copy"), (6, 8, "engine.decode"),
             (12, 14, "harness")]
    assert phases.innermost(spans) == [(0, 2, "engine.step"), (2, 3, "engine.promote"), (3, 4, "tier copy"),
                                       (4, 5, "engine.promote"), (5, 6, "engine.step"), (6, 8, "engine.decode"),
                                       (8, 10, "engine.step"), (12, 14, "harness")]
    segs = phases.innermost(spans)
    assert phases.label_at(segs, 3.5) == "tier copy" and phases.label_at(segs, 11) == phases.OUTSIDE
    assert phases.innermost([(0, 4, "a"), (0, 2, "b")]) == [(0, 2, "b"), (2, 4, "a")]


def test_idle_by_span_sweeps_each_gap_over_the_ranges_covering_it():
    spans = [(0, 100, "engine.step"), (10, 40, "engine.promote"), (20, 30, "tier copy"), (50, 90, "engine.decode")]
    busy = [(0, 12), (11, 15), (25, 26), (45, 60), (95, 98), (110, 120), (130, 131)]
    idle = phases.idle_by_span(busy, spans, scale=1)
    gaps = phases.gaps(busy)
    assert gaps == [(15, 25), (26, 45), (60, 95), (98, 110), (120, 130)]
    # (15, 25): promote 15-20, tier copy 20-25; (26, 45): tier copy 26-30, promote 30-40, step 40-45;
    # (60, 95): decode 60-90, step 90-95; (98, 110): step 98-100, outside 100-110; (120, 130): outside
    assert idle == {"engine.promote": 15, "tier copy": 9, "engine.step": 12, "engine.decode": 30,
                    phases.OUTSIDE: 20}
    assert sum(idle.values()) == sum(b - a for a, b in gaps) == 86
    assert phases.idle_in_policy_share(idle) == pytest.approx(15 / 86 * 100)
    assert phases.idle_by_span(busy, [], scale=1) == {phases.OUTSIDE: 86}
    assert phases.idle_in_policy_share({}) is None


def test_host_spans_label_harness_ranges_and_keep_program_names():
    events = [ev("bench.copy_pages", 1, 2), ev("engine.promote", 0, 3), ev("model.moe", 4, 5), ev("aten::mm", 1, 2),
              ev("engine.decode", 0, 9, CUDA, annotation=True)]
    assert phases.host_spans(events) == [(1, 2, "tier copy"), (0, 3, "engine.promote"), (4, 5, "model.moe")]


def test_counter_readers_on_a_recorded_window_and_on_a_program_without_counters():
    d = {"steps": 200, "decoded_tokens": 6000, "policy_ns": 1_200_000_000, "dispatch_ns": 4_400_000_000,
         "readback_ns": 20_000_000, "promoted_bytes": 13_000 * 1_835_008, "flushed_host_bytes": 5_900 * 114_688,
         "demand_pages": 200 * 900}
    assert phases.per_step_ms(d, "policy_ns") == pytest.approx(6.0)
    assert phases.per_step_ms(d, "dispatch_ns") == pytest.approx(22.0)
    assert phases.per_step_ms(d, "readback_ns") == pytest.approx(0.1)
    assert phases.host_tier_bytes_per_token(d) == pytest.approx((13_000 * 1_835_008 + 5_900 * 114_688) / 6000)
    assert phases.pool_demand_ratio(d, 448) == pytest.approx(900 / 448)
    parent = {"steps": 200, "decoded_tokens": 6000}  # ServeStats alone
    assert phases.per_step_ms(parent, "policy_ns") is None
    assert phases.host_tier_bytes_per_token(parent) is None and phases.pool_demand_ratio(parent, 448) is None
    assert phases.per_step_ms({**d, "steps": 0}, "policy_ns") is None
    assert phases.counters(types.SimpleNamespace(stats=None)) == {}
    assert phases.counters(types.SimpleNamespace(counters=types.SimpleNamespace(policy_ns=3))) == {"policy_ns": 3}


def test_engine_phases_reads_a_tiny_traced_run():
    bench = json.loads((TINY / "bench.json").read_text())
    out = engine_phases.measure("tiny-dense.chat", 11, 2.0, True, device="cpu", dirs=(TINY, BENCH), bench=bench)
    ph = out["phases"]
    assert out["result"]["metrics"] and ph["trace"] is not None
    for part in ("untraced", "window", "traced"):
        r = ph[part]
        assert r["steps"] > 0 and 0.9 <= r["conservation"] <= 1.0
        assert r["sum_ms"] == pytest.approx(r["policy_ms"] + r["dispatch_ms"] + r["readback_wait_ms"])
        assert r["host_tier_bytes_per_token"] > 0 and r["pool_demand_ratio"] > 0
    assert ph["window"]["steps"] == ph["untraced"]["steps"] + ph["traced"]["steps"]
