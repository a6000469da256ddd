"""The generator, the metric readers, the roofline and FLOP counts, on
fixtures and hand counts."""
import json
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
from benchkit import flops, readers, traffic  # noqa: E402

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
DECODER = run.load_module(BENCH / "families" / "decoder.py")


@pytest.mark.parametrize("mix", MIXES)
def test_generator_is_deterministic_and_every_seed_gets_the_same_work(mix):
    spec = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    cell = {"rate_per_s": 3.0, "ramp_s": 10}

    def make(seed):
        if spec["arrivals"] == "waves":
            return traffic.wave(spec, seed, 1, 50_000)
        return traffic.open_loop(spec, cell, seed, 40, 50_000)

    a, b, c = make(7), make(7), make(2**33 + 5)
    assert [(x.due, x.prompt, x.max_new_tokens) for x in a] == [(x.due, x.prompt, x.max_new_tokens) for x in b]
    assert [x.prompt for x in a] != [x.prompt for x in c]
    # one schedule for every seed; the seed draws the token ids
    assert [(x.due, len(x.prompt), x.max_new_tokens) for x in a] == \
        [(x.due, len(x.prompt), x.max_new_tokens) for x in c]
    lo, hi = spec["prompt"]["min"], spec["prompt"]["max"]
    assert all(lo <= len(x.prompt) <= hi and all(0 <= t < 50_000 for t in x.prompt) for x in a)
    if spec["arrivals"] == "poisson":
        inside = [x for x in a if 0 <= x.due < 40]
        assert len(inside) == 120 == len([x for x in c if 0 <= x.due < 40])
        assert min(x.due for x in a) == -10


def test_quantile_lengths_hand_values():
    got = traffic.quantile_lengths({"median": 100, "sigma": 0.0, "min": 1, "max": 1000}, 4)
    assert got.tolist() == [100, 100, 100, 100]
    got = traffic.quantile_lengths({"median": 100, "sigma": 1.0, "min": 50, "max": 150}, 3)
    assert got.tolist() == [50, 100, 150]  # exp(+-0.967) x 100 clipped


def _view(rec, seconds=10.0, summary=None, model=None, cell=None, family=DECODER):
    ctx = types.SimpleNamespace(cell=cell or {"kv": {"page_size": 16}}, model=model or {}, seconds=seconds,
                                family=family)
    return run.View(rec, ctx, summary, [BENCH])


def _req(due, tokens, start=None, end=None, done=True, failed=False, traced=False):
    req = types.SimpleNamespace(done=done)
    return {"due": due, "tokens": tokens, "start": due if start is None else start,
            "end": tokens[0] if end is None and tokens else end, "failed": failed, "traced": traced, "req": req}


def test_latency_readers_on_a_recorded_fixture():
    rec = {"requests": [
        _req(-1.0, [-0.5, 0.5, 1.5]),  # due in the ramp: no TTFT
        _req(1.0, [1.2, 1.4, 2.0], start=1.1, end=1.2),  # TTFT 0.2
        _req(2.0, [2.5, 9.0], start=2.25, end=2.5, done=False),  # TTFT 0.5
        _req(3.0, [], failed=True),  # counts as infinite
    ], "unadmitted": [9.5], "steps": [], "setup_s": 12.5}
    view = _view(rec)
    assert readers.ttft_ms(view, 0) == pytest.approx(200.0)
    assert readers.ttft_ms(view, 50) == pytest.approx(500.0)
    assert readers.ttft_ms(view, 100) == float("inf")
    assert readers.tokens_per_s(view) == pytest.approx(7 / 10)
    assert readers.setup_s(view) == 12.5
    assert readers.admit_wait_ms(view) == pytest.approx((0.1 + 0.25) / 2 * 1e3)
    assert readers.prefill_ms(view) == pytest.approx((0.1 + 0.25) / 2 * 1e3)


def test_counter_and_step_readers_on_a_recorded_fixture():
    stats0 = {"steps": 0, "decoded_tokens": 100, "parks": 5, "promoted_pages": 0, "evicted_pages": 2,
              "compactions": 1, "flushed_pages": 10, "flushed_tokens": 40}
    stats1 = dict(stats0, decoded_tokens=300, parks=45, evicted_pages=12, flushed_pages=30, flushed_tokens=200)
    steps = [{"t0": 1.0, "t1": 1.04, "rows": 32, "flops": 4e12, "traced": False},
             {"t0": 2.0, "t1": 2.01, "rows": 0, "flops": 0.0, "traced": False},  # promotion only
             {"t0": 3.0, "t1": 3.06, "rows": 16, "flops": 2e12, "traced": False},
             {"t0": 4.0, "t1": 4.5, "rows": 16, "flops": 2e12, "traced": True},
             {"t0": -1.0, "t1": -0.9, "rows": 16, "flops": 2e12, "traced": False}]
    view = _view({"requests": [], "steps": steps, "window_stats": (stats0, stats1)})
    assert readers.per_token(view, "parks") == pytest.approx(40 / 200)
    assert readers.per_token(view, "evicted_pages") == pytest.approx(10 / 200)
    assert readers.coalesce_ratio(view) == pytest.approx(160 / 20)
    assert readers.decode_step_ms(view) == pytest.approx((0.04 + 0.01 + 0.06) / 2 * 1e3)
    assert readers.step_mfu(view) == pytest.approx(6e12 / (0.10 * flops.PEAK_BF16_FLOPS) * 100)


def test_trace_readers_on_a_recorded_summary():
    model = {"n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16}
    summary = {"window_s": 2.0, "busy_s": 0.5, "kernels": {"paged_attention": 0.001, "flash_attention": 0.002},
               "spans": {"bench.copy_pages": 0.05, "bench.compact_log": 0.05, "bench.moe": 0.2}}
    rec = {"traced_steps": [{"rows": [(100, 96), (20, 16)], "log_rows": 40}], "traced_admits": [64, 128]}
    view = _view(rec, summary=summary, model=model)
    assert readers.idle_share(view) == pytest.approx(75.0)
    assert readers.span_share(view, "bench.copy_pages", "bench.compact_log") == pytest.approx(20.0)
    assert readers.span_share(view, "bench.moe") == pytest.approx(40.0)
    b, f = 120 * 2 * 2 * 16 * 2 + (6 + 1) * 4 + 2 * 2 * 4 * 16 * 2 + 40 * 8, 120 * 4 * 4 * 16
    assert readers.paged_roofline(view) == pytest.approx(
        readers.bound_s(b, f) * 2 / 0.001 * 100)
    least = sum(readers.bound_s(S * 12 * 16 * 2, 4 * 16 * 4 * S * (S + 1) / 2) for S in (64, 128))
    assert readers.flash_roofline(view) == pytest.approx(least * 2 / 0.002 * 100)
    assert readers.idle_share(_view(rec)) is None and readers.paged_roofline(_view(rec, model=model)) is None


def test_paged_roofline_reads_what_the_traced_slice_holds():
    """A batch run traces wave 1's first admissions, then 30 steps from its
    first full batch whose pages are all in the pool (prompts land in the
    host tier and are promoted a budget a step). A slow traced run whose
    window closes before that batch holds prefills alone: flash attention's
    roofline reads, and paged attention's reads nothing, no paged kernel
    having run in the slice. A slice that holds a decoding step reads it."""
    model = {"n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16}
    cut = {"window_s": 0.4, "busy_s": 0.1, "kernels": {"paged_attention": 0.0, "flash_attention": 0.002},
           "spans": {}}
    view = _view({"traced_steps": [], "traced_admits": [64, 128, 256]}, summary=cut, model=model)
    assert readers.paged_roofline(view) is None and readers.flash_roofline(view) > 0
    held = dict(cut, kernels={"paged_attention": 0.001, "flash_attention": 0.002})
    step = {"rows": [(100, 96), (20, 16)], "log_rows": 40}
    view = _view({"traced_steps": [step], "traced_admits": [64, 128, 256]}, summary=held, model=model)
    b, f = 120 * 2 * 2 * 16 * 2 + (6 + 1) * 4 + 2 * 2 * 4 * 16 * 2 + 40 * 8, 120 * 4 * 4 * 16
    assert readers.paged_roofline(view) == pytest.approx(readers.bound_s(b, f) * 2 / 0.001 * 100)


def test_roofline_and_flop_functions_against_hand_counts():
    qwen = json.loads((BENCH / "configs" / "qwen3-1.7b.json").read_text())["model"]
    olmoe = json.loads((BENCH / "configs" / "olmoe-1b-7b.json").read_text())["model"]
    pa = run.load_module(BENCH / "roofline" / "paged_attention.py")
    fa = run.load_module(BENCH / "roofline" / "flash_attention.py")
    # one row attending 1,000 positions, 992 of them in 62 pages; a log of 64 rows
    nbytes, nflops = pa.bytes_flops(qwen, [(1000, 992)], 64, 16)
    assert nbytes == 1000 * 8 * 128 * 2 * 2 + 62 * 4 + 2 * 16 * 128 * 2 + 64 * 8
    assert nflops == 1000 * 4 * 16 * 128
    nbytes, nflops = fa.bytes_flops(qwen, 256)
    assert nbytes == 256 * (32 + 16) * 128 * 2 and nflops == 4 * 128 * 16 * 256 * 257 / 2
    # matmul parameters a token touches: qwen3 28 x (4.19 M + 2 x 2.10 M + 4.19 M + 37.75 M) + 311.2 M
    attn = 2048 * 2048 + 2 * 2048 * 1024 + 2048 * 2048
    assert flops.matmul_params_per_token(qwen) == 28 * (attn + 3 * 2048 * 6144) + 2048 * 151936
    attn = 4 * 2048 * 2048
    assert flops.matmul_params_per_token(olmoe) == 16 * (attn + 2048 * 64 + 8 * 3 * 2048 * 1024) + 2048 * 50304
    n = flops.matmul_params_per_token(qwen)
    assert flops.decode_flops(qwen, [10, 20]) == 2 * (2 * n) + 4 * 28 * 16 * 128 * 30
