"""End-to-end training driver of the PyTorch port (examples/train_lm.py's
twin): trains the smollm-135m reduced config on the synthetic pipeline
through ``repro_torch.launch.train``, with checkpointing and (optionally)
a simulated crash + recovery.

  PYTHONPATH=src python examples/train_lm_torch.py                    # ~200 steps on the card
  PYTHONPATH=src python examples/train_lm_torch.py --drill            # crash + resume
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20 --ckpt-dir DIR

A thin veneer over the launcher, so the example and the launcher cannot
drift. Checkpoints go under ``artifacts/repro_torch_example_ckpt`` unless
``--ckpt-dir`` says otherwise; the drill clears them first.
"""
import argparse
import shutil

from repro_torch.launch import train as train_launcher


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--drill", action="store_true", help="crash at 60%% of the steps, then resume")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    ap.add_argument("--ckpt-dir", default="artifacts/repro_torch_example_ckpt")
    args = ap.parse_args(argv)
    base = [
        "--arch", "smollm-135m", "--steps", str(args.steps), "--seq", "128",
        "--batch", "8", "--accum", "2", "--lr", "3e-3", "--device", args.device,
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(max(args.steps // 4, 1)),
    ]
    if args.drill:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)  # a resume must start from this run's checkpoints
        try:
            train_launcher.main([*base, "--fail-at", str(args.steps * 3 // 5)])
        except SystemExit as e:
            print(f"[example] crashed as requested (exit {e.code}); resuming...")
        train_launcher.main([*base, "--resume"])
    else:
        train_launcher.main(base)


if __name__ == "__main__":
    main()
