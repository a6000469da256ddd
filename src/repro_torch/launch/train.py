"""Training launcher (port of ``repro/launch/train.py``), on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \\
      --steps 50 --seq 256 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu ...   # plain versions
  PYTHONPATH=src python -m repro_torch.launch.train --fail-at 20 ...   # exits 42 at step 20
  PYTHONPATH=src python -m repro_torch.launch.train --resume ...       # from the latest checkpoint

Exercises the train step with gradient accumulation (``--accum``), int8
error-feedback gradient compression (``--compress``), checkpoint and
restart (``--resume``; ``--fail-at N`` simulates a crash at step N, the
fault-tolerance drill) and the restart-safe data pipeline. Weights are
random, drawn from ``--seed``; the data too. A run resumed after
``--fail-at`` ends in the same state as one that never stopped, bit for bit.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, OptimConfig, get_config, get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.steps import build_train_step, make_train_state
from repro_torch.models.api import ModelSpec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=0, help="simulate a crash at this step (recovery drill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    spec = ModelSpec(cfg)
    optim = OptimConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps, compress_grads=args.compress)
    step_fn = build_train_step(spec, optim, accum_steps=args.accum)
    state = make_train_state(spec, torch.Generator(device=dev).manual_seed(args.seed), compress=args.compress,
                             device=dev)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    ckpt = Checkpointer(args.ckpt_dir)

    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, extra, start = ckpt.restore(state)
        data.state.step = int(extra.get("data_step", start))
        print(f"[train] resumed from step {start}")

    print(f"[train] arch={cfg.name} params={spec.param_count():,} accum={args.accum} compress={args.compress} "
          f"device={dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    t0 = time.time()
    for step in range(start, args.steps):
        if args.fail_at and step == args.fail_at:
            print(f"[train] SIMULATED FAILURE at step {step} — restart with --resume to recover")
            raise SystemExit(42)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
        data.state.step = step + 1
        state, metrics = step_fn(state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {step:4d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"({(time.time() - t0):.1f}s)")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, extra={"data_step": data.state.step})
    ckpt.wait()
    print("[train] done")


if __name__ == "__main__":
    main()
