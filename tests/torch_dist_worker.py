"""One rank of the port's sharded train step on a gloo CPU mesh (the
multi-process half of tests/test_torch_distributed.py; it imports torch and
repro_torch only, no JAX).

    python tests/torch_dist_worker.py CASE.json RANK WORLD PORT

CASE.json: arch (reduced config), mesh and axes, device (optional, "cpu";
"cuda": every rank on device 0, still over gloo), accum, lr, compress,
steps, ckpt_in / step_in (the state to start from, restored onto the mesh
by ``param_specs``), batch (an .npy of int32 tokens, the whole global batch
every rank is given), frontend (optional: an .npy of a vlm's fp32 patch
embeddings, given as bf16), compress_from (optional: the state holds a
residual and the steps from this index on compress, those before do not),
out (rank 0 writes ``metrics.json`` there), ckpt_out
and save_after (the state saved whole after each of these step counts, 0:
as restored), routing (record each MoE call's routing: the dropped (token,
choice) pairs of the global microbatch in ``drops``, and in out's
``routing.npz`` rank 0's router probabilities of its own rows and the global
expert ids, call by call), unsharded (one rank: also run the unsharded step
from the same checkpoint, saved in ckpt_out + "_unsharded"). With compress,
each leaf's int8 quantization step is recorded, a step's leaves in sorted
order. A split step (the dense, moe and vlm families) also records the
most weight bytes gathered over "data" alive at once (``gathered_peak``,
counted by the dry run's ``CountingWeights`` in place of the step's
``DataParallelWeights``), and every
step the elements of the fp32 gradient sum AdamW is given against those of
the rank's shards (``grad_elements``, ``shard_elements``). Rank 0's kernel
launches and routes (``repro_torch.kernels``) are recorded too.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import OptimConfig, get_reduced
from repro_torch.distributed.sharding import local, param_specs, spec_of
from repro_torch.kernels import launch_counts, route_counts
from repro_torch.launch import steps
from repro_torch.launch.dryrun import CountingWeights
from repro_torch.launch.steps import abstract_train_state, build_train_step
from repro_torch.models import layers
from repro_torch.models.api import ModelSpec


def restore_target(spec, compress: bool):
    """The train state's structure (an int step, as the port keeps it)."""
    target = abstract_train_state(spec, compress=compress)
    target["opt"] = target["opt"]._replace(step=0)
    return target


def run(step, state, batch, case, ckpt_out):
    """``case["steps"]`` steps (``step``: one function, or a function of
    the step's index); the state saved after each count in ``save_after``.
    Returns each step's metrics."""
    ck = Checkpointer(ckpt_out, keep=10, async_save=False) if ckpt_out else None
    metrics = []
    for i in range(case["steps"] + 1):
        if ck is not None and i in case.get("save_after", ()):
            ck.save(state["opt"].step, state)
        if i < case["steps"]:
            state, m = (step(i) if not hasattr(step, "grads_and_loss") else step)(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def main(case_path: str, rank: int, world: int, port: int) -> None:
    case = json.loads(Path(case_path).read_text())
    torch.set_num_threads(1)
    device = torch.device(case.get("device", "cpu"))
    if device.type == "cuda":  # every rank on the one card, over gloo
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(device.type, tuple(case["mesh"]), mesh_dim_names=tuple(case["axes"]))
        spec = ModelSpec(get_reduced(case["arch"]))
        compress_from = case.get("compress_from")
        has_residual = case["compress"] or compress_from is not None
        ck = Checkpointer(case["ckpt_in"], async_save=False)
        specs = param_specs(spec.schema(), mesh)
        state, _, _ = ck.restore(restore_target(spec, has_residual), step=case["step_in"], mesh=mesh,
                                 specs=specs)
        for name, t in state["params"].items():  # the layout the step reads back from the placements
            assert spec_of(t) == specs[name], (name, spec_of(t), specs[name])
        optim = OptimConfig(lr=case["lr"], warmup_steps=0, total_steps=10, compress_grads=case["compress"])
        batch = {"tokens": torch.from_numpy(np.load(case["batch"])).to(device)}
        if case.get("frontend"):
            batch["frontend"] = torch.from_numpy(np.load(case["frontend"])).to(device, torch.bfloat16)
        drops, probs, ids = [], [], []
        if case.get("routing"):
            inner_route, inner_slots = layers.moe_route, layers.moe_slots

            def route(m, xt, w_router):
                out = inner_route(m, xt, w_router)
                probs.append(out[1].detach().cpu().numpy())
                return out

            def slots(idx, num_experts, cap):
                pos, keep = inner_slots(idx, num_experts, cap)
                drops.append(int((~keep).sum()))
                ids.append(idx.cpu().numpy())
                return pos, keep

            layers.moe_route, layers.moe_slots = route, slots
        quant_steps, grad_elements = [], []
        inner_adamw = steps.adamw_update

        def counting(cfg, opt_state, grads, lr, params, gnorm):
            grad_elements.append(sum(g.numel() for g in grads.values()))
            return inner_adamw(cfg, opt_state, grads, lr, params, gnorm)

        steps.adamw_update = counting
        if has_residual:  # each leaf's quantization step, by the whole leaf's max as the step takes it
            inner_ef = steps.error_feedback_leaf

            def recording(g, residual, amax_reduce=None):
                amax = (g.to(torch.float32) + residual).abs().max()
                amax = amax_reduce(amax.clone()) if amax_reduce is not None else amax
                quant_steps.append(max(float(amax), 1e-12) / 127.0)
                return inner_ef(g, residual, amax_reduce)

            steps.error_feedback_leaf = recording
        counted = []  # each split step's FSDP gather, counting the gathered bytes alive

        def counting_weights(*args):
            counted.append(CountingWeights(*args))
            return counted[-1]

        steps.DataParallelWeights = counting_weights
        step = build_train_step(spec, optim, case["accum"], mesh=mesh)
        fns = [step]
        if compress_from is not None:
            fns.append(build_train_step(spec, dataclasses.replace(optim, compress_grads=True), case["accum"],
                                        mesh=mesh))
        chosen = step if compress_from is None else (lambda i: fns[int(i >= compress_from)])
        result = {"metrics": run(chosen, state, batch, case, case.get("ckpt_out")), "drops": drops,
                  "quant_steps": quant_steps, "grad_elements": grad_elements,
                  "shard_elements": sum(local(p).numel() for p in state["params"].values())}
        result["launches"], result["routes"] = launch_counts(), route_counts()  # kernels launched by rank 0
        if counted:  # the most over the ranks
            peak = torch.tensor([float(max(w.peak for w in counted))])
            dist.all_reduce(peak, op=dist.ReduceOp.MAX)
            result["gathered_peak"] = float(peak)
        if case.get("unsharded"):
            plain, _, _ = ck.restore(restore_target(spec, has_residual), step=case["step_in"], device=device)
            for p in plain["params"].values():
                p.requires_grad_(True)
            result["unsharded"] = run(build_train_step(spec, optim, case["accum"]), plain, batch, case,
                                      case["ckpt_out"] + "_unsharded")
        if rank == 0:
            Path(case["out"]).mkdir(parents=True, exist_ok=True)
            (Path(case["out"]) / "metrics.json").write_text(json.dumps(result))
            if case.get("routing"):
                np.savez(Path(case["out"]) / "routing.npz", probs=np.stack(probs), ids=np.stack(ids))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
