#!/usr/bin/env python3
"""How far the decode of a full-width scan model (the one-token recurrence)
lies from its forward (the chunked scan), in fp32 and in bf16, and how far
bf16 lies from fp32, by depth. Random weights from seed 0; the widths are
the config's, the depth and (optionally) the vocab are cut.

    python3 scripts/scan_precision_probe.py                    # on the card: rwkv6-3b, zamba2-7b
    python3 scripts/scan_precision_probe.py --device cpu --arch rwkv6-3b --layers 2 4 8 --vocab 4096

One line per depth: max |decode - forward| logits in fp32 and in bf16,
max |bf16 - fp32| logits of the forward and of the decode, and the logits'
standard deviation. Two prompts of 130 tokens, 8 teacher-forced steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import decode_cache  # noqa: E402
from repro_torch.models.api import ModelSpec  # noqa: E402

DEPTHS = {"rwkv6-3b": (2, 4, 8, 16, 32), "zamba2-7b": (6, 12, 24, 48, 81)}


def both_ways(spec, params, seq, S):
    """(teacher-forced forward logits, decode logits) at positions S-1..end."""
    fwd = spec.forward(params, seq)[0][:, S - 1:].float()
    logits, cache = spec.prefill(params, seq[:, :S])
    dc = decode_cache(spec, cache, seq.shape[0], seq.shape[1] + 1, device=seq.device)
    rows = [logits]
    for i in range(S, seq.shape[1]):
        logits, dc = spec.decode_step(params, dc, seq[:, i:i + 1], i)
        rows.append(logits)
    return fwd, torch.stack(rows, dim=1).float()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", nargs="*", default=list(DEPTHS))
    ap.add_argument("--layers", nargs="*", type=int, help="depths (default: per arch, up to full)")
    ap.add_argument("--vocab", type=int, default=0, help="cut the vocab (0: the config's)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(torch.cuda.get_device_name(0))
    B, S, n = 2, 130, 8
    for arch in args.arch:
        for L in args.layers or DEPTHS[arch]:
            cfg = dataclasses.replace(get_config(arch), n_layers=L)
            if args.vocab:
                cfg = dataclasses.replace(cfg, vocab=args.vocab)
            spec = ModelSpec(cfg)
            params = spec.init(torch.Generator(device=dev).manual_seed(0), device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            seq = torch.randint(1, cfg.vocab - 1, (B, S + n - 1), generator=gen, device=dev, dtype=torch.int32)
            fwd16, dec16 = both_ways(spec, params, seq, S)
            params = {k: t.float() for k, t in params.items()}
            fwd32, dec32 = both_ways(spec, params, seq, S)
            del params
            mx = lambda a, b: float((a - b).abs().max())  # noqa: E731
            print(f"{arch} layers {L}: |decode - forward| fp32 {mx(dec32, fwd32):.3g} bf16 {mx(dec16, fwd16):.4f}; "
                  f"|bf16 - fp32| forward {mx(fwd16, fwd32):.4f} decode {mx(dec16, dec32):.4f}; "
                  f"logit std {float(fwd32.std()):.3f}", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
