"""Configuration families (``families/<family>.py``): a toy family that
exists only as files under ``tests/tiny/`` is drawn, driven, counted and
judged through ``run.run_cell``; its variant whose reference is off is not
correct; and the decoder family gives, for the tiny dense and MoE
configurations, the values the harness gave before it had families."""
import hashlib
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

import fake_clock  # noqa: E402
import run  # noqa: E402
from benchkit import readers, weights  # noqa: E402

TINY = BENCH / "tests" / "tiny"
TINY_BENCH = json.loads((TINY / "bench.json").read_text())
DIRS = (TINY, BENCH)
FUNCTIONS = ("layout", "program_config", "decode_flops", "attention_calls", "replays_batches", "checked_gaps")


@pytest.fixture(autouse=True)
def _fake_clock_one_thread(monkeypatch):
    """Each run on the fake clock, with one CPU thread: the tiny shapes gain
    nothing from more, and test processes beside this one keep the cores."""
    fake_clock.install(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spy_on_families(monkeypatch) -> list:
    """Every call of a family function from here on: (family, function,
    result), in order."""
    calls = []
    load = run.load_module

    def record(family, name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((family, name, out))
            return out
        return call

    def load_spied(path):
        mod = load(path)
        if path.parent.name == "families":
            for name in FUNCTIONS:
                setattr(mod, name, record(path.stem, name, getattr(mod, name)))
        return mod

    monkeypatch.setattr(run, "load_module", load_spied)
    return calls


def test_a_family_added_as_files_is_drawn_driven_counted_and_judged(monkeypatch):
    calls = spy_on_families(monkeypatch)
    out = run.run_cell("tiny-toy.batch", 11, 0.5, False, device="cpu", dirs=DIRS, bench=TINY_BENCH)
    assert out["correct"], out["checked"]
    assert out["checked"]["checked_tokens"]["value"] >= 20 and out["failed"] == 0
    assert {family for family, _, _ in calls} == {"toy"}
    used = [name for _, name, _ in calls]
    assert {"layout", "program_config", "replays_batches", "decode_flops", "checked_gaps"} <= set(used)
    # the weights were drawn in the toy's layout, and every decoding step was counted by the toy
    cfg = json.loads((TINY / "configs" / "tiny-toy.json").read_text())
    layouts = [got for _, name, got in calls if name == "layout"]
    assert layouts == [run.family(cfg, DIRS).layout(cfg["model"])]
    assert used.count("decode_flops") > 10
    gaps, facts = next(got for _, name, got in calls if name == "checked_gaps")
    assert facts["tokens"] == len(gaps["program"]) == out["checked"]["checked_tokens"]["value"]


def test_the_rooflines_count_the_familys_attention_calls(monkeypatch):
    """A traced slice's readings through the toy family's context: the
    least time of a call, times the family's calls, over the kernels' time."""
    calls = spy_on_families(monkeypatch)
    ctx, _ = run.context("tiny-toy.batch", 11, 1.0, device="cpu", dirs=DIRS)
    summary = {"window_s": 1.0, "busy_s": 0.5, "kernels": {"paged_attention": 0.001, "flash_attention": 0.002},
               "spans": {}}
    rec = {"traced_steps": [{"rows": [(100, 96), (20, 16)], "log_rows": 40}], "traced_admits": [64, 128]}
    view = run.View(rec, ctx, summary, DIRS)
    paged = view.roofline("paged_attention").bytes_flops(ctx.model, [(100, 96), (20, 16)], 40, 16)
    flash = [view.roofline("flash_attention").bytes_flops(ctx.model, S) for S in (64, 128)]
    n = ctx.model["n_layers"]
    assert readers.paged_roofline(view) == pytest.approx(readers.bound_s(*paged) * n / 0.001 * 100)
    assert readers.flash_roofline(view) == pytest.approx(sum(readers.bound_s(*f) for f in flash) * n / 0.002 * 100)
    asked = [(family, name) for family, name, _ in calls if name == "attention_calls"]
    assert asked == [("toy", "attention_calls")] * 2


def test_the_toy_familys_flop_count_is_the_decoders_for_the_same_model():
    """Two counts written apart agree on a dense decoder."""
    cfg = json.loads((TINY / "configs" / "tiny-toy.json").read_text())
    dense = json.loads((TINY / "configs" / "tiny-dense.json").read_text())
    assert cfg["model"] == dense["model"]
    toy, decoder = run.family(cfg, DIRS), run.family(dense, DIRS)
    for contexts in ([1], [17, 300], list(range(1, 40))):
        assert toy.decode_flops(cfg["model"], contexts) == decoder.decode_flops(dense["model"], contexts)
    assert toy.attention_calls(cfg["model"]) == decoder.attention_calls(dense["model"])
    assert {n: s for n, s, _, _ in toy.layout(cfg["model"])} == {n: s for n, s, _, _ in decoder.layout(dense["model"])}


def test_a_family_whose_reference_is_off_is_not_correct():
    out = run.run_cell("tiny-toy-off.batch", 11, 0.5, False, device="cpu", dirs=DIRS, bench=TINY_BENCH)
    assert not out["correct"]
    assert out["checked"]["gap_widest"]["value"] > out["checked"]["gap_widest"]["limit"]
    assert out["checked"]["checked_tokens"]["value"] >= 20


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.int16).numpy().tobytes()).hexdigest()[:16]


# Read on the harness as it was before families (commit 61185aa), by this
# test's recipe: weights for seed 2**31 + 7, the FLOPs of a step of contexts
# 1, 17 and 300, and a run of the cell at seed 11 on the fake clock (a
# millisecond a reading).
PINNED = {
    "tiny-dense": {
        "leaves": {
            "blocks.attn_norm": "1ede9ebfa1ad011b", "blocks.k_norm": "26ab507cf4bbb401",
            "blocks.mlp_norm": "1ede9ebfa1ad011b", "blocks.q_norm": "26ab507cf4bbb401",
            "blocks.w_down": "0b57846c475a2010", "blocks.w_gate": "c6485f3602e58733",
            "blocks.w_up": "400aa1635fa3d73d", "blocks.wk": "7ad0f00112dfc783", "blocks.wo": "bbe954d8c2512354",
            "blocks.wq": "95caaa2784e95afe", "blocks.wv": "66736314d0d8e3d0", "embed": "69ee669325c72856",
            "final_norm": "e72710531b01d91e", "lm_head": "394b8bb0efd8a28f"},
        "decode_flops": 728064.0,
        "checked": {"failed": 0, "parks": 291, "evicted_pages": 370, "compactions": 55,
                    "gap_widest": 0.0002932250499725342, "checked_tokens": 79, "checked_evicted_requests": 2,
                    "checked_across_compaction": 5},
        "metrics": {"parks_per_token.chat": 0.3885180240320427, "evicted_pages_per_token.chat": 0.4939919893190921,
                    "coalesce_ratio.chat": 2.511278195488722, "step_mfu.batch": 6.429211241158473e-05},
        "attempted": 56,
    },
    "tiny-moe": {
        "leaves": {
            "blocks.attn_norm": "1ede9ebfa1ad011b", "blocks.k_norm": "26ab507cf4bbb401",
            "blocks.mlp_norm": "1ede9ebfa1ad011b", "blocks.q_norm": "26ab507cf4bbb401",
            "blocks.router": "bbeebf93141a3183", "blocks.we_down": "bc28d84b4687de71",
            "blocks.we_gate": "31c6064536d1ea72", "blocks.we_up": "a886c82acf1b969d", "blocks.wk": "d37341d5c3eca818",
            "blocks.wo": "87d345d5e65937d0", "blocks.wq": "692e50b4b65d7bee", "blocks.wv": "c1c190f27a32d62f",
            "embed": "a4f847c670ad58c8", "final_norm": "e72710531b01d91e", "lm_head": "2ec36a1b431d0a29"},
        "decode_flops": 857088.0,
        "checked": {"failed": 0, "gap_mean": 1.89122195555785e-05, "checked_tokens": 107},
        "metrics": {"parks_per_token.chat": 0.20132450331125828, "evicted_pages_per_token.chat": 0.0,
                    "coalesce_ratio.chat": 2.192926045016077, "step_mfu.batch": 7.903104360920915e-05},
        "attempted": 61,
    },
}
COUNTER_METRICS = ["parks_per_token.chat", "evicted_pages_per_token.chat", "coalesce_ratio.chat", "step_mfu.batch"]


@pytest.mark.parametrize("config", sorted(PINNED))
def test_the_decoder_family_gives_the_values_pinned_before_families(config):
    """Weights bit for bit, decode FLOPs, the checked gaps and the counters'
    readings of a run, equal to the harness's before families."""
    pinned, cell = PINNED[config], f"{config}.batch"
    cfg = json.loads((TINY / "configs" / f"{config}.json").read_text())
    family = run.family(cfg, DIRS)
    assert family.__name__ == "bench_families_decoder"
    drawn = weights.draw(family.layout(cfg["model"]), 2**31 + 7, "cpu")
    assert {k: digest(v) for k, v in drawn.items()} == pinned["leaves"]
    assert family.decode_flops(cfg["model"], [1, 17, 300]) == pinned["decode_flops"]
    bench = {"workloads": [{"name": cell, "config": config, "traffic": "tinybatch", "chips": 1}],
             "end_to_end": [{"name": n, "unit": "x"} for n in COUNTER_METRICS], "per_layer": []}
    out = run.run_cell(cell, 11, 1.0, False, device="cpu", dirs=DIRS, bench=bench)
    assert out["correct"] and out["attempted"] == pinned["attempted"]
    assert {k: c["value"] for k, c in out["checked"].items()} == pinned["checked"]
    assert {k: m["value"] for k, m in out["metrics"].items()} == pinned["metrics"]
