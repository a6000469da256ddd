"""Find a chat cell's knee: run the cell once at each of a list of rates
(the rate and nothing else replaced) and print, for each, the live-request
count at the window's middle and end and the cell's end-to-end metrics. The knee is the highest
rate at which the live count does not grow through the window.

    python3 bench/sweep.py --workload qwen3-1.7b.chat-pressure --rates 2,3,4 --seed 7 --seconds 40

Needs a CUDA card. Runs the reference check only with ``--check``.
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--ramp", type=float, default=None, help="ramp_s in place of the cell's")
    ap.add_argument("--check", action="store_true", help="run the reference check too")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        over = {"rate_per_s": rate, **({"ramp_s": args.ramp} if args.ramp is not None else {})}
        out = run.run_cell(args.workload, args.seed, args.seconds, False, cell_overrides=over, check=args.check)
        m = {k: v["value"] for k, v in out["metrics"].items()}
        print(json.dumps({"rate_per_s": rate, "live_middle": out["live"]["middle"], "live_end": out["live"]["end"],
                          "peak_live_pages": out["live"]["peak_pages"], "attempted": out["attempted"], **m,
                          "correct": out["correct"], **{k: c["value"] for k, c in out["checked"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
