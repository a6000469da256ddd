"""The zamba2 family (``families/zamba2.py``, Zamba2-7B-Instruct's cell) on
the CPU: its plain reference is the program's ``models/zamba2_ref.py`` bit
for bit; its layout is the program's schema and draws A_log and dt_bias in
Mamba2's ranges from the seed's one randn; a tiny cell of the family, run
through ``run.run_cell``, reads ``correct`` true, and its variant whose
reference leaves out the sites' adapters reads false; the ``mamba_step``
roofline reader's arithmetic; the cell's prefill and tier-copy readers."""
import json
import math
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
DIRS = (TINY, BENCH)
CELLS = ("tiny-zamba2.batch", "tiny-zamba2-off.batch")
CONFIG = json.loads((TINY / "configs" / "tiny-zamba2.json").read_text())
FULL = json.loads((BENCH / "configs" / "zamba2-7b-instruct.json").read_text())


def tiny_bench() -> dict:
    """The tiny harness's BENCHMARK object with the zamba2 cells beside its own."""
    bench = json.loads((TINY / "bench.json").read_text())
    for name in CELLS:
        bench["workloads"].append({"name": name, "config": name.split(".")[0], "traffic": "tinybatch", "chips": 1})
        next(m for m in bench["end_to_end"] if m["name"] == "tokens_per_s")["workloads"].append(name)
    return bench


@pytest.fixture(autouse=True)
def _fake_clock_one_thread(monkeypatch):
    fake_clock.install(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def family():
    return run.family(CONFIG, DIRS)


def test_the_bench_reference_is_the_programs_bit_for_bit():
    from repro_torch import configs
    from repro_torch.models import zamba2_ref

    model = CONFIG["model"]
    assert family().program_config("zamba2-tiny", model) == configs.zamba2_tiny()  # the program's tests' twin
    params = weights.draw(family().layout(model), 2**31 + 3, "cpu")
    toks = torch.randint(0, model["vocab"], (40,), generator=torch.Generator().manual_seed(0))
    for quant in (None, "fp8"):
        a = zamba2_ref.Zamba2Reference(model, params, quant=quant).forward(toks)
        b = family().Zamba2Reference(model, params, quant=quant).forward(toks)
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,model", [("tiny-zamba2", CONFIG["model"]), ("zamba2-7b-instruct", FULL["model"])])
def test_the_layout_is_the_programs_schema(name, model):
    from repro_torch.models.api import ModelSpec
    from repro_torch.models.common import flat_leaves

    spec = ModelSpec(family().program_config(name, model))
    leaves = family().layout(model)
    assert {n: s for n, s, _, _ in leaves} == {n: leaf.shape for n, leaf in flat_leaves(spec.schema())}
    assert weights.param_bytes(leaves) == 2 * spec.param_count()


def test_a_log_and_dt_bias_are_drawn_in_mamba2s_ranges():
    p = weights.draw(family().layout(CONFIG["model"]), 2**31 + 9, "cpu")
    q = weights.draw(family().layout(CONFIG["model"]), 2**31 + 9, "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    a = -torch.exp(p["mamba.A_log"].float())
    assert float(a.max()) <= -0.99 and float(a.min()) >= -16.1 and float(a.std()) > 1
    dt = torch.nn.functional.softplus(p["mamba.dt_bias"].float())
    assert float(dt.min()) >= 0.9e-3 and float(dt.max()) <= 0.102
    assert float(torch.log(dt).std()) > 0.8  # log-uniform over two decades: std ln(100) / sqrt(12) = 1.33


def test_decode_flops_add_the_shared_attention_per_position():
    m = FULL["model"]
    one, two = family().decode_flops(m, [100]), family().decode_flops(m, [101])
    assert two - one == 4 * 13 * 32 * 224
    assert family().attention_calls(m) == {"paged_attention": 13, "flash_attention": 13}
    # by hand: a Mamba layer's in- and out-projections 3584 x (14704 + 7168), 81 of them; a site's block
    # (wq, wk, wv 7168^2 each, wo 7168 x 3584, gate/up 3584 x 28672, down 14336 x 3584), its adapter
    # (3584 x 128 + 128 x 28672) and linear (3584^2), 13 of them; the tied head 3584 x 32000 -> 2 FLOPs
    # each; then the conv's 2 x 4 x 7424 and the state's 6 x 112 x 64 x 64 a layer
    matrices = 81 * 3584 * (14704 + 7168) + 13 * (3 * 7168 ** 2 + 7168 * 3584 + 3584 * 28672 + 14336 * 3584
                                                  + 3584 * 128 + 128 * 28672 + 3584 ** 2) + 3584 * 32000
    assert family().decode_flops(m, [0]) == 2 * matrices + 81 * (2 * 4 * 7424 + 6 * 112 * 64 * 64)


@pytest.mark.parametrize("seed", [11, 12, 2**31 + 5])
def test_the_tiny_cell_is_correct_and_its_off_variant_is_not(seed):
    bench = tiny_bench()
    good = run.run_cell("tiny-zamba2.batch", seed, 0.5, False, device="cpu", dirs=DIRS, bench=bench)
    assert good["correct"], good["checked"]
    assert good["failed"] == 0 and good["checked"]["checked_tokens"]["value"] >= 20
    bad = run.run_cell("tiny-zamba2-off.batch", seed, 0.5, False, device="cpu", dirs=DIRS, bench=bench)
    assert not bad["correct"]
    assert bad["checked"]["gap_widest"]["value"] > bad["checked"]["gap_widest"]["limit"]
    assert bad["checked"]["checked_tokens"]["value"] >= 20


def test_the_mamba_step_roofline_reader():
    ctx, _ = run.context("zamba2-7b-instruct.batch", 1, 51.0, device="cpu")
    rows = [[(900, 896)] * 16, [(901, 896)] * 12]
    rec = {"traced_steps": [{"rows": r, "log_rows": 32} for r in rows]}
    summary = {"window_s": 1.0, "busy_s": 0.5, "kernels": {"mamba_step": 0.004}, "spans": {}}
    view = run.View(rec, ctx, summary, (BENCH,))
    reader = run.load_module(BENCH / "metrics" / "mamba_step_roofline.hybrid.py")
    per_row = 3802848.0  # bytes a live row a layer at the published widths
    least = sum(len(r) * per_row for r in rows) / 3.35e12 * 81
    assert reader.read(view) == pytest.approx(least / 0.004 * 100)
    assert reader.read(run.View(rec, ctx, {**summary, "kernels": {}}, (BENCH,))) is None
    assert math.isclose(readers.bound_s(per_row, 0.0), per_row / 3.35e12)


def test_the_prefill_and_tier_copy_readers():
    """``prefill_ms.hybrid``: the mean wall time of the window's untraced
    admissions; ``tier_copy_share.hybrid``: the harness's copy and compaction
    ranges over device busy; both None where there is nothing to read."""
    ctx, _ = run.context("zamba2-7b-instruct.batch", 1, 51.0, device="cpu")
    req = dict(due=0.0, failed=False, traced=False)
    rec = {"requests": [dict(req, start=1.0, end=1.25), dict(req, start=2.0, end=2.45),
                        dict(req, start=3.0, end=9.0, traced=True), dict(req, due=-1.0, start=-1.0, end=0.0)]}
    summary = {"window_s": 1.0, "busy_s": 0.5, "kernels": {},
               "spans": {"bench.copy_pages": 0.02, "bench.compact_log": 0.005, "bench.step": 0.4}}
    prefill = run.load_module(BENCH / "metrics" / "prefill_ms.hybrid.py")
    copies = run.load_module(BENCH / "metrics" / "tier_copy_share.hybrid.py")
    assert prefill.read(run.View(rec, ctx, summary, (BENCH,))) == pytest.approx(350.0)
    assert copies.read(run.View(rec, ctx, summary, (BENCH,))) == pytest.approx(5.0)
    assert prefill.read(run.View({"requests": []}, ctx, summary, (BENCH,))) is None
    assert copies.read(run.View(rec, ctx, {**summary, "spans": {}}, (BENCH,))) is None
