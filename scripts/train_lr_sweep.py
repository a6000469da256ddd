#!/usr/bin/env python3
"""The loss of full-width qwen3-1.7b (random weights from a seed) over a
few train steps at several learning rates, on the card: how
``chip_smoke.py``'s phase 7 chose its rate.

    PYTHONPATH=src python3 scripts/train_lr_sweep.py            # ~1.5 min on an H100

The run of phase 7: seq 4096, global batch 4, 4 microbatches, remat,
``SyntheticLM`` data from seed 0, each rate from the same initial weights.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import OptimConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import build_train_step, make_train_state  # noqa: E402
from repro_torch.models.api import ModelSpec  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--runs", default="1e-5:0,3e-5:0,1e-4:0,3e-4:3", help="lr:warmup_steps, comma separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_lr_sweep: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    spec = ModelSpec(cfg)
    data = SyntheticLM(cfg.vocab, 4096, 4, seed=0)
    print(f"{cfg.name}, seq 4096, global batch 4, 4 microbatches — on {card}")
    for run in args.runs.split(","):
        lr, warmup = run.split(":")
        step = build_train_step(spec, OptimConfig(lr=float(lr), warmup_steps=int(warmup), total_steps=args.steps + 1), 4)
        state = make_train_state(spec, torch.Generator(device=dev).manual_seed(0), device=dev)
        losses = []
        for i in range(args.steps):
            state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()})
            losses.append(round(float(m["loss"]), 4))
        print(f"lr {lr} warmup {warmup}: losses {losses}", flush=True)
        del state, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
