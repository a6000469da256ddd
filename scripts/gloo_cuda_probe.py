#!/usr/bin/env python3
"""Probe, on one CUDA card, the collectives the split train step and the
sharded serving steps use when their ranks share the card over gloo (NCCL
refuses two ranks on one device).

    PYTHONPATH=src python3 scripts/gloo_cuda_probe.py

Each check runs in its own pair of processes (``torch.multiprocessing``
spawn) on device 0, over a gloo group on a free local port, so that a
check that kills its processes does not hide the others. On CUDA tensors,
each against the same reduction on the host: all-reduce SUM in fp32, bf16
and int64, all-reduce MAX in fp32; all-gather in bf16 and int64, and the
port's gathers on it (``distributed/groups.py``: ``_all_gather``,
``DataParallelRows``); the subgroups of a (1, 2) ("data", "model")
``DeviceMesh`` on "cuda"; a DTensor placed by ``sharding.distribute`` and
read back (``to_local``, ``sharding.gather``), and torch's own
``DTensor.full_tensor``, which ``sharding.gather`` does not call there (on
torch 2.11.0+cu128 it killed a rank with SIGSEGV);
a CUDA tensor the parent shares with its ranks (CUDA IPC); and the time of
an all-reduce of (1, 4096, 2048) in bf16 and fp32 (one TP all-reduce of
full-width qwen3-1.7b at seq 4096). Also ``all_to_all_single`` and
``all_to_all``, which the port does not rely on: the sharded prefill moves
its K/V from heads to sequence by an all-gather
(``ModelParallel.gather_heads``), which serves every head route. Prints
one line per check; exits non-zero when a check the port relies on fails.
"""
import socket
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

WORLD = 2
CHECKS = ("all_reduce", "all_gather", "the port's gathers", "device mesh", "dtensor", "dtensor full_tensor (torch's)",
          "cuda ipc", "all_to_all_single", "all_to_all", "time")
NOT_RELIED_ON = ("dtensor full_tensor (torch's)", "all_to_all_single", "all_to_all")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check(rank: int, name: str, port: int, shared: torch.Tensor, queue) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import groups, sharding

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=WORLD)
    notes = []
    try:
        if name == "all_reduce":
            for dtype in (torch.float32, torch.bfloat16, torch.int64):
                x = torch.arange(8, device=dev, dtype=dtype) + rank
                dist.all_reduce(x)
                assert torch.equal(x.cpu(), (2 * torch.arange(8) + 1).to(dtype)), dtype
            x = torch.tensor([float(rank), -float(rank)], device=dev)
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
            assert x.cpu().tolist() == [1.0, 0.0]
            notes.append("sum fp32, bf16, int64; max fp32")
        elif name == "all_gather":
            for dtype in (torch.bfloat16, torch.int64):
                parts = [torch.empty(3, device=dev, dtype=dtype) for _ in range(WORLD)]
                dist.all_gather(parts, torch.full((3,), rank, device=dev, dtype=dtype))
                assert [int(p[0]) for p in parts] == [0, 1], dtype
        elif name == "the port's gathers":
            for dtype in (torch.bfloat16, torch.int64, torch.float32):
                got = groups._all_gather(torch.full((2, 3), rank, device=dev, dtype=dtype), dist.group.WORLD, WORLD, 1)
                assert got.shape == (2, 6) and got.cpu().tolist() == [[0] * 3 + [1] * 3] * 2, dtype
            rows = groups.DataParallelRows(dist.group.WORLD)
            assert rows.gather(torch.full((1,), rank, device=dev)).cpu().tolist() == [0, 1]
        elif name == "device mesh":
            mesh = init_device_mesh("cuda", (1, WORLD), mesh_dim_names=("data", "model"))
            y = torch.ones(4, device=dev)
            dist.all_reduce(y, group=mesh.get_group("model"))
            z = torch.ones(4, device=dev)
            dist.all_reduce(z, group=mesh.get_group("data"))
            assert float(y[0]) == WORLD and float(z[0]) == 1
        elif name == "dtensor":
            mesh = init_device_mesh("cuda", (1, WORLD), mesh_dim_names=("data", "model"))
            whole = torch.arange(12, dtype=torch.bfloat16).reshape(4, 3)
            for spec in (sharding.P("model", None), sharding.P(None, None)):
                d = sharding.distribute(whole, mesh, spec)
                assert sharding.spec_of(d) == spec and d.to_local().is_cuda
                assert torch.equal(sharding.gather(d).cpu(), whole), spec
        elif name == "dtensor full_tensor (torch's)":
            mesh = init_device_mesh("cuda", (1, WORLD), mesh_dim_names=("data", "model"))
            whole = torch.arange(12, dtype=torch.bfloat16).reshape(4, 3)
            d = sharding.distribute(whole, mesh, sharding.P("model", None))
            assert torch.equal(d.full_tensor().cpu(), whole)
        elif name == "all_to_all_single":
            x = torch.arange(4, device=dev, dtype=torch.bfloat16) + 10 * rank
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)  # rank r receives block r of every rank
            assert out.cpu().tolist() == [2 * rank, 2 * rank + 1, 10 + 2 * rank, 11 + 2 * rank], out
        elif name == "all_to_all":
            parts = [torch.empty(2, device=dev) for _ in range(WORLD)]
            dist.all_to_all(parts, [torch.full((2,), 10.0 * rank + r, device=dev) for r in range(WORLD)])
            assert [float(p[0]) for p in parts] == [10.0 * r + rank for r in range(WORLD)], parts
        elif name == "cuda ipc":
            assert shared.is_cuda and float(shared.sum()) == float(shared.numel())
        elif name == "time":
            for dtype in (torch.bfloat16, torch.float32):
                t = torch.randn((1, 4096, 2048), device=dev).to(dtype)
                dist.all_reduce(t)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    dist.all_reduce(t)
                torch.cuda.synchronize()
                notes.append(f"all_reduce (1, 4096, 2048) {dtype} {(time.perf_counter() - t0) / 5 * 1e3:.2f} ms")
        dist.barrier()
        if rank == 0:
            queue.put("; ".join(notes))
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    shared = torch.ones(16, device="cuda")
    failed = []
    for name in CHECKS:
        queue = ctx.SimpleQueue()
        try:
            mp.spawn(_check, args=(name, _free_port(), shared, queue), nprocs=WORLD, join=True)
            print(f"ok    {name}: {queue.get()}", flush=True)
        except Exception as e:  # a check's failure is reported and the next check runs
            lines = [line for line in str(e).splitlines() if line.strip()]  # a rank's error ends its traceback
            print(f"FAIL  {name}: {type(e).__name__}: {lines[-1] if lines else ''}", flush=True)
            if name not in NOT_RELIED_ON:
                failed.append(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}; gloo, "
          f"{WORLD} ranks on device 0 (times: gloo staging through the host)")
    if failed:
        print(f"gloo_cuda_probe: failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
