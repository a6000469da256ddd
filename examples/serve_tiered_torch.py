"""Serving example of the PyTorch port: SkyByte tiered KV vs the dense
baseline on the same requests (examples/serve_tiered.py's twin), through
``repro_torch.launch.serve``; prints the paper-style serving metrics.

  PYTHONPATH=src python examples/serve_tiered_torch.py                 # on the card
  PYTHONPATH=src python examples/serve_tiered_torch.py --device cpu    # plain versions
"""
import argparse
import sys

from repro_torch.launch import serve as serve_launcher


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    for tiering in ("baseline", "skybyte"):
        sys.argv = [
            "serve", "--arch", "qwen3-1.7b", "--requests", "4",
            "--prompt-len", "24", "--new-tokens", "16",
            "--tiering", tiering, "--device", args.device,
        ]
        serve_launcher.main()


if __name__ == "__main__":
    main()
