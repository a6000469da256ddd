"""How far full-width rwkv6's bf16 and fp32 gradients lie from fp32 and
fp64, unsharded and split over two "model" ranks (gloo, on the CPU).

    PYTHONPATH=src python scripts/rwkv6_bf16_grad_noise.py [--layers 4] [--seq 1024] [--batch 1] [--vocab 1024] \
        [--device cpu|cuda]

rwkv6-3b at full width (d 2560, 40 heads of 64, d_ff 8960), its depth and
vocab cut as given, random weights from seed 0 (the port's init: ``u``,
``w0`` and ``mu`` zero), one batch of random tokens. Each of two ranks
computes the loss and gradients of the unsharded model in bf16 and in fp32
(the same params cast up), and of the split model ("model" = 2: the time
mix on 20 heads a rank) in bf16 and in fp32; rank 0 also the unsharded
model in fp64. Prints, for each leaf, the largest gap over the fp32
gradient's largest |value|: split bf16 against unsharded bf16, unsharded
bf16 against fp32, split bf16 against fp32, split fp32 against unsharded
fp32, unsharded fp32 against fp64 (the fp32 gradient's own rounding), and
split fp32 against fp64; then the largest of each column, the grad norms
and the losses. ~2 GB a rank at the defaults, a few minutes; at seq 4096
~10 GB on rank 0 and half an hour. With ``--device cuda`` both ranks
compute on card 0 (gloo with CUDA tensors, TF32 off), from the same weights
and tokens (drawn on the host).
"""
import argparse
import dataclasses
import socket
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch.steps import compute_layout  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import ModelSpec  # noqa: E402


def grads(spec, leaves, batch, mesh=None):
    """(loss, {name: gradient}) of ``leaves`` (split on ``mesh`` when given:
    the leaves are DTensors, their local shards get the gradients)."""
    local = {n: sharding.local(p).detach().clone().requires_grad_(True) for n, p in leaves.items()}
    with layers.split_compute(None if mesh is None else compute_layout(spec, mesh, leaves)):
        loss, _ = spec.loss(local, batch)
        loss.backward()
    return float(loss), {n: t.grad for n, t in local.items()}


def whole(g, spec_, mesh, shape):
    """The whole fp64 gradient of this rank's shard ``g`` (each element from
    its first replica, summed over the ranks)."""
    sizes, coord = sharding.mesh_shape(mesh), sharding.mesh_coordinate(mesh)
    out = torch.zeros(shape, dtype=torch.float64)
    if sharding.is_first_replica(spec_, sizes, coord):
        out[sharding.shard_slices(shape, spec_, sizes, coord)] = g.double().cpu()
    dist.all_reduce(out)
    return out


def rank_main(rank: int, port: int, args) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    if args.device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    try:
        mesh = init_device_mesh(args.device, (1, 2), mesh_dim_names=("data", "model"))
        spec = ModelSpec(dataclasses.replace(get_config("rwkv6-3b"), n_layers=args.layers, vocab=args.vocab))
        gen = torch.Generator().manual_seed(0)
        params = {n: p.to(args.device) for n, p in spec.init(gen, device="cpu").items()}
        batch = {"tokens": torch.randint(0, args.vocab, (args.batch, args.seq), generator=gen,
                                         dtype=torch.int32).to(args.device)}
        runs = {}
        for dtype in (torch.bfloat16, torch.float32):
            cast = {n: p.to(dtype) for n, p in params.items()}
            runs[dtype, "unsharded"] = grads(spec, cast, batch)
            placed = sharding.shard_params(spec, cast, mesh)
            loss, g = grads(spec, placed, batch, mesh)
            runs[dtype, "split"] = loss, {n: whole(t, sharding.spec_of(placed[n]), mesh, params[n].shape)
                                          for n, t in g.items()}
            del cast, placed, g
        if rank == 0:  # the fp32 gradient's own rounding: the unsharded model in fp64
            runs[torch.float64, "unsharded"] = grads(spec, {n: p.double() for n, p in params.items()}, batch)
        bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
        norms = {k: float(sum((g.double() ** 2).sum() for g in v[1].values()) ** 0.5) for k, v in runs.items()}
        if rank == 0:
            print(f"rwkv6-3b width, {args.layers} layers, vocab {args.vocab}, batch {args.batch} x {args.seq}, on "
                  f"{args.device}; gaps "
                  "of each leaf's fp32 gradient's max: split bf16 vs unsharded bf16 | unsharded bf16 vs fp32 | "
                  "split bf16 vs fp32 | split fp32 vs unsharded fp32 | unsharded fp32 vs fp64 | split fp32 vs fp64")
            worst = [(0.0, "")] * 6
            for n in sorted(params):
                ref, ref64 = runs[f32, "unsharded"][1][n].double().cpu(), runs[f64, "unsharded"][1][n].cpu()
                scale = float(ref.abs().max())
                gap = lambda a, b: float((a.double().cpu() - b.double().cpu()).abs().max()) / scale  # noqa: E731
                row = (gap(runs[bf, "split"][1][n], runs[bf, "unsharded"][1][n]), gap(runs[bf, "unsharded"][1][n], ref),
                       gap(runs[bf, "split"][1][n], ref), gap(runs[f32, "split"][1][n], ref), gap(ref, ref64),
                       gap(runs[f32, "split"][1][n], ref64))
                worst = [max(w, (g, n)) for w, g in zip(worst, row)]
                print(f"  {n:20s} " + " | ".join(f"{g:.4f}" if i < 3 else f"{g:.2e}" for i, g in enumerate(row)))
            print("  largest of each column: " + " | ".join(f"{g:.3g} ({n})" for g, n in worst))
            name = {bf: "bf16", f32: "fp32", f64: "fp64"}
            print("  grad norm: " + ", ".join(f"{name[d]} {k} {v:.6f}" for (d, k), v in norms.items()))
            print("  loss: " + ", ".join(f"{name[d]} {k} {v[0]:.6f}" for (d, k), v in runs.items()))
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args()
    torch.set_num_threads(4)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(rank_main, args=(port, args), nprocs=2, join=True)


if __name__ == "__main__":
    main()
