"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell ``bench/cells/<workload>.json`` names
its configuration (``bench/configs/<config>.json``, which may name its family
``bench/families/<family>.py``; ``decoder`` by default), its traffic mix
(``bench/traffic/<mix>.json``) and its driver (``bench/drivers/<driver>.py``);
each metric that ``BENCHMARK.json`` gives the cell is read by
``bench/metrics/<metric>.py`` (``read(view) -> number or None``). With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.

The run needs a CUDA card: without one (or with fewer than the cell asks
for) it prints no result and exits 2. It exits 3, with no result, if JAX or
the JAX package was loaded. The numbers compared for ``correct`` are printed
last on standard error and last in the line, each beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional, Sequence  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths():
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # build and kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
    # one process with few threads: the host loop is the bottleneck, and idle
    # worker pools only contend with it for the machine's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))


def find(kind: str, name: str, dirs: Sequence[Path], suffix: str = ".json") -> Path:
    """``<dir>/<kind>/<name><suffix>`` in the first of ``dirs`` that has it."""
    for d in dirs:
        p = Path(d) / kind / f"{name}{suffix}"
        if p.exists():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under {[str(d) for d in dirs]}")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


class View:
    """What a metric reader sees: the run's record, the cell, the model
    sizes and their family, the window's length and (traced) the trace
    summary."""

    def __init__(self, rec: dict, ctx, summary: Optional[dict], dirs):
        self.rec, self.ctx, self.summary, self.dirs = rec, ctx, summary, dirs
        self.cell, self.model, self.family, self.seconds = ctx.cell, ctx.model, ctx.family, ctx.seconds

    def in_window(self, t: float) -> bool:
        return 0.0 <= t < self.seconds

    def window_requests(self):
        """Requests due inside the window (open loop) or admitted in it."""
        return [r for r in self.rec["requests"] if self.in_window(r["due"])]

    def roofline(self, kernel: str):
        return load_module(find("roofline", kernel, self.dirs, ".py"))


def family(config: dict, dirs: Sequence[Path] = (BENCH,)):
    """The family module of a configuration file: ``families/<name>.py``,
    the name its ``"family_module"`` gives (``decoder`` where it has none)."""
    return load_module(find("families", config.get("family_module", "decoder"), dirs, ".py"))


def context(workload: str, seed: int, seconds: float, trace: bool = False, device: str = "cuda",
            dirs: Sequence[Path] = (BENCH,), cell_overrides: Optional[dict] = None,
            wrap_step: Optional[Callable] = None):
    """(the run's context, its driver module): the cell file, with
    ``cell_overrides`` replacing its keys, and the configuration (with its
    family), mix and driver it names."""
    cell = {**json.loads(find("cells", workload, dirs).read_text()), **(cell_overrides or {})}
    config = json.loads(find("configs", cell["config"], dirs).read_text())
    mix = json.loads(find("traffic", cell["traffic"], dirs).read_text())
    driver = load_module(find("drivers", cell["driver"], dirs, ".py"))
    ctx = types.SimpleNamespace(cell=cell, mix=mix, model=config["model"], config_name=config["name"],
                                family=family(config, dirs), seed=seed, seconds=seconds, trace=trace,
                                device=device, wrap_step=wrap_step)
    return ctx, driver


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             dirs: Sequence[Path] = (BENCH,), bench: Optional[dict] = None,
             wrap_step: Optional[Callable] = None, cell_overrides: Optional[dict] = None,
             check: bool = True) -> dict:
    """One run; returns the result line's object. ``dirs``: where cells,
    configs, families, mixes, drivers, metrics and rooflines are looked up,
    in order;
    ``bench``: the BENCHMARK.json object (default: the checkout's);
    ``cell_overrides``: keys that replace the cell file's (``sweep.py``'s
    rates); ``check=False`` skips the reference (the sweep's runs)."""
    _paths()
    import torch

    from benchkit import judge

    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    ctx, driver = context(workload, seed, seconds, trace, device, dirs, cell_overrides, wrap_step)
    cell = ctx.cell
    log(f"{workload} seed {seed}: {seconds} s window, trace {int(trace)}")
    run = driver.drive(ctx)
    rec = run.rec
    log(f"window closed; set-up {rec['origin'] - T_START:.2f} s")
    rec["setup_s"] = rec["origin"] - T_START
    summary = None
    if trace:
        groups = {}
        for m in cell_metrics(bench, workload, True):
            if m["name"].split(".")[0].endswith("_roofline"):
                kernel = m["name"].split(".")[0][:-len("_roofline")]
                groups[kernel] = load_module(find("roofline", kernel, dirs, ".py")).KERNELS
        summary = run.tracer.summary(groups)
    view = View(rec, ctx, summary, dirs)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = load_module(find("metrics", m["name"], dirs, ".py")).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted, failed = driver.attempted(view)
    device_info = {"platform": "gpu" if device == "cuda" else device, "count": entry["chips"]}
    if device == "cuda":
        device_info["kind"] = torch.cuda.get_device_name(0)
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    else:
        device_info["kind"] = "cpu"
        device_info["memory_peak_bytes"] = 0
    if summary is not None:
        device_info["busy_s"], device_info["window_s"] = summary["busy_s"], summary["window_s"]
    run.free()
    if check:
        log("metrics read; reference check")
        correct, checks = judge.judge(run, ctx, failed)
        log("reference check done")
    else:
        correct, checks = None, {}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    out["live"] = {"middle": rec.get("live_mid"), "end": rec.get("live_end"), "peak_pages": rec.get("peak_live_pages")}
    if rec.get("waves") and hasattr(driver, "waves_seen"):
        out["waves"] = driver.waves_seen(view)
    out["checked"] = {k: {"value": c["value"], "limit": c["limit"], "rule": c["rule"]} for k, c in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark may not load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in out["checked"].items():
        print(f"checked {name}: {c['value']} (limit {c['rule']} {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
