"""The readings a cell's gap limit is set from, on the card: for each seed,
one run of the cell (a window of ``--seconds``), then over the same checked
requests the gaps of the tokens the program served (the lower reading) and
of the tokens the reference computed in fp8 puts first (the control, the
upper reading), both against the float32 reference. Each side is then held
to the cell's rules as a run's served tokens are (``judge.verdict``), so
the program's line reads ``"correct": true`` and the control's ``false``.
One process for all seeds. The benchmark's own runs never run the control.

    python3 bench/control.py --workload qwen3-1.7b.chat-pressure --seeds 11,12,13 --seconds 20
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def readings(workload: str, seed: int, seconds: float, control: bool = True, dirs=(run.BENCH,),
             device: str = "cuda") -> dict:
    """{"program": its gaps' statistics, its ``correct`` and the numbers
    compared; "control": the same for the fp8 choices (or None); what was
    checked} of one seed."""
    run._paths()
    from benchkit import judge

    ctx, driver = run.context(workload, seed, seconds, device=device, dirs=dirs)
    r = driver.drive(ctx)
    _, failed = driver.attempted(run.View(r.rec, ctx, None, dirs))
    r.free()
    base = judge.premise_checks(r, ctx, failed)
    gaps, facts = judge.checked_gaps(r, ctx, control=control)
    if gaps is None:
        return {"seed": seed, **facts}

    def side(g):
        correct, checks = judge.verdict(ctx, base, g, facts)
        return {**judge.statistics(g), "correct": correct,
                "checked": {k: {"value": c["value"], "limit": c["limit"], "rule": c["rule"]} for k, c in checks.items()}}

    return {"seed": seed, "program": side(gaps["program"]),
            "control": side(gaps["control"]) if gaps["control"] else None, **facts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-control", action="store_true", help="the program's readings only")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds, not args.no_control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
