"""One run of a cell, read through the engine's own spans and counters: the
host time of the window's decoding steps split into policy, dispatch and
read-back, the bytes the tiers move a token, the pool's demand, and (with
``--trace 1``) every between-op idle gap put down to an engine phase.

    python3 bench/engine_phases.py --workload qwen3-1.7b.chat-pressure --seed 7 --seconds 51 --trace 0 [--check]

Prints one JSON line: ``result``, the cell's line as ``run.py`` prints it,
and ``phases``. The counters are read around each ``step`` call (a wrapper
on the engine, two dict copies a step inside the harness's timed step), so
the window's steps are taken without the traced slice (``untraced``, what an
untraced run reads), with it (``window``, what deltas at the window's edges
read) and alone (``traced``). ``conservation`` is the counters' time over
the harness's ``step`` time for the same steps; ``counts`` the counters and
``ServeStats`` summed over them. A traced run also gives the slice's device
busy time under ``trace.py``'s device-op filter (``by_name``) and under
``phases.device_ops`` (``by_flag``), the between-op idle, the idle by span
and the ten longest gaps labelled by the innermost range. A program without
``TieredEngine.counters`` reads None for them. Needs a CUDA card; runs the
reference check only with ``--check``.
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def _sum(rows):
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = out.get(k, 0) + v
    return out


def readings(view, log, keep):
    from benchkit import phases

    steps = view.rec["steps"]
    d = _sum(log[i] for i in keep)
    harness_s = sum(steps[i]["t1"] - steps[i]["t0"] for i in keep)
    out = {"steps": d.get("steps", 0), "decoded_tokens": d.get("decoded_tokens", 0), "step_s": harness_s,
           "decode_step_ms": harness_s / d["steps"] * 1e3 if d.get("steps") else None}
    for name, key in (("policy_ms", "policy_ns"), ("dispatch_ms", "dispatch_ns"), ("readback_wait_ms", "readback_ns")):
        out[name] = phases.per_step_ms(d, key)
    if out["policy_ms"] is not None:
        out["sum_ms"] = out["policy_ms"] + out["dispatch_ms"] + out["readback_wait_ms"]
        out["conservation"] = (d["policy_ns"] + d["dispatch_ns"] + d["readback_ns"]) / 1e9 / harness_s
    out["host_tier_bytes_per_token"] = phases.host_tier_bytes_per_token(d)
    out["pool_demand_ratio"] = phases.pool_demand_ratio(d, view.rec["kv"]["n_hbm_pages"])
    out["counts"] = {k: v for k, v in d.items() if not k.endswith("_ns")}
    return out


def trace_readings(tracer):
    import torch

    from benchkit import phases

    cuda = torch.autograd.DeviceType.CUDA
    by_name = {"busy_s": 0.0, "device_op_count": 0}
    by_flag = {"busy_s": 0.0, "device_op_count": 0}
    idle, gaps, between = {}, [], 0.0
    for prof, _ in tracer.pieces:
        events = prof.events()
        old = [e for e in events if e.device_type == cuda and not e.name.startswith("bench.")]
        new = phases.device_ops(events)
        for acc, ops in ((by_name, old), (by_flag, new)):
            acc["busy_s"] += sum(b - a for a, b in phases.merged((e.time_range.start, e.time_range.end) for e in ops)) / 1e6
            acc["device_op_count"] += len(ops)
        busy = [(e.time_range.start, e.time_range.end) for e in new]
        spans = phases.host_spans(events)
        for k, v in phases.idle_by_span(busy, spans).items():
            idle[k] = idle.get(k, 0.0) + v
        segs = phases.innermost(spans)
        piece_gaps = sorted(phases.gaps(busy), key=lambda g: g[0] - g[1])
        gaps += [((b - a) / 1e6, phases.label_at(segs, (a + b) / 2)) for a, b in piece_gaps[:10]]
        between += sum(b - a for a, b in piece_gaps) / 1e6
    gaps.sort(key=lambda g: -g[0])
    return {"by_name": by_name, "by_flag": by_flag, "between_op_idle_s": between,
            "idle_by_span_s": sum(idle.values()),
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "idle_in_policy_share": phases.idle_in_policy_share(idle),
            "idle_gaps": [[label, s] for s, label in gaps[:10]]}


def measure(workload: str, seed: int, seconds: float, trace: bool, check: bool = False, **run_kw) -> dict:
    """One run through ``run.run_cell`` (``run_kw``: its other arguments)
    with the engine's step wrapped; returns the line's object."""
    from benchkit import phases
    from benchkit.trace import Tracer

    log, views, tracers = [], [], []

    def hook(eng):
        inner = eng.step

        def step():
            c0, s0 = phases.counters(eng), vars(eng.stats).copy()
            inner()
            c1, s1 = phases.counters(eng), vars(eng.stats)
            log.append({**{k: c1[k] - c0[k] for k in c1}, **{k: s1[k] - s0[k] for k in s1}})

        eng.step = step

    class KeptView(run.View):
        def __init__(self, *a):
            super().__init__(*a)
            views.append(self)

    view_cls, summary = run.View, Tracer.summary

    def kept_summary(self, groups):
        tracers.append(self)
        return summary(self, groups)

    run.View, Tracer.summary = KeptView, kept_summary
    try:
        out = run.run_cell(workload, seed, seconds, trace, wrap_step=hook, check=check, **run_kw)
    finally:
        run.View, Tracer.summary = view_cls, summary
    view = views[0]
    steps = view.rec["steps"]
    if len(steps) != len(log):
        raise RuntimeError(f"{len(steps)} harness steps against {len(log)} engine steps")
    in_window = [i for i, s in enumerate(steps) if view.in_window(s["t0"])]
    ph = {"untraced": readings(view, log, [i for i in in_window if not steps[i]["traced"]]),
          "window": readings(view, log, in_window)}
    if trace:
        ph["traced"] = readings(view, log, [i for i in in_window if steps[i]["traced"]])
        ph["trace"] = trace_readings(tracers[0]) if tracers else None
    return {"workload": workload, "seed": seed, "trace": int(trace), "phases": ph, "result": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--check", action="store_true", help="run the reference check too")
    args = ap.parse_args(argv)
    run._paths()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure(args.workload, args.seed, args.seconds, bool(args.trace), args.check)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
