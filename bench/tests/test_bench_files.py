"""The benchmark's files: every cell names a configuration (and through it
a family), a mix and a driver that exist; every metric has its reader; the
weights' layout is the program's schema; nothing the harness imports is JAX
or the JAX package."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_names_files_that_exist(name):
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == name)
    cell = json.loads((BENCH / "cells" / f"{name}.json").read_text())
    assert cell["config"] == entry["config"] and cell["traffic"] == entry["traffic"]
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    assert (BENCH / "families" / f"{config.get('family_module', 'decoder')}.py").exists()
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").exists()
    assert (BENCH / "drivers" / f"{cell['driver']}.py").exists()
    assert cell["why"] and "\n" not in cell["why"]
    assert cell["check"]["gap_limit"] > 0


def test_every_metric_has_a_reader_and_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        base = m["name"].split(".")[0]
        if base.endswith("_roofline"):
            assert (BENCH / "roofline" / f"{base[:-len('_roofline')]}.py").exists()
    for m in BENCHMARK["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for cell in CELLS:  # each cell reports set-up, another end-to-end metric and a per-layer one
        names = [m["name"] for m in BENCHMARK["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in names and len(names) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in BENCHMARK["per_layer"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCHMARK["configs"]])
def test_weights_layout_is_the_programs_schema(name):
    """Each configuration's layout, from its family, is the schema of the
    program's configuration that the family builds."""
    import run
    from benchkit import weights
    from repro_torch.models.api import ModelSpec
    from repro_torch.models.common import flat_leaves

    cfg_file = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    family, model = run.family(cfg_file), cfg_file["model"]
    spec = ModelSpec(family.program_config(name, model))
    schema = {n: leaf.shape for n, leaf in flat_leaves(spec.schema())}
    leaves = family.layout(model)
    assert {n: shape for n, shape, _, _ in leaves} == schema
    assert weights.param_bytes(leaves) == cfg_file["memory"]["weights_bytes"] == 2 * spec.param_count()


def test_weights_draw_is_deterministic_in_the_seed():
    import run
    import torch
    from benchkit import weights

    cfg_file = json.loads((BENCH / "tests" / "tiny" / "configs" / "tiny-moe.json").read_text())
    model = cfg_file["model"]
    leaves = run.family(cfg_file).layout(model)
    a, b, c = (weights.draw(leaves, s, "cpu") for s in (5, 5, 2**33 + 1))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["embed"], c["embed"])
    assert a["blocks.wq"].dtype == torch.bfloat16
    assert abs(float(a["blocks.wq"].float().std()) - 1 / math.sqrt(model["d_model"])) < 0.02


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    """Every harness module and the driver's program imports, in a fresh
    process: no top-level name jax, jaxlib, flax or repro; the reference
    imports nothing of repro_torch."""
    code = f"""
import sys, importlib.util, pathlib
bench = pathlib.Path({str(BENCH)!r})
sys.path[:0] = [str(bench), str(bench.parent / "src")]
import benchkit.reference
assert not any(k.split(".")[0] == "repro_torch" for k in sys.modules), "the reference imported the program"
import run, sweep, control
for sub in ("benchkit", "families", "drivers", "metrics", "roofline"):
    for p in sorted((bench / sub).glob("*.py")):
        run.load_module(p)
drv = run.load_module(bench / "drivers" / "tiered_engine.py")
import repro_torch.serving.engine, repro_torch.core.tiering, repro_torch.models.api
bad = sorted({{k.split(".")[0] for k in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}})
print(bad)
assert not bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
