"""One rank of the port's sharded train step on a gloo CPU mesh (the
multi-process half of tests/test_torch_distributed.py; it imports torch and
repro_torch only, no JAX).

    python tests/torch_dist_worker.py CASE.json RANK WORLD PORT

CASE.json: arch (reduced config; replace: fields of it replaced, as
``reduced_config`` reads them), mesh and axes, rules (optional: JAX's
layout profile, "default", "tp_only" or "dp": the state placed by its
rules, the steps built for it), device (optional, "cpu";
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
order. The split step also records the most weight bytes gathered over
"data" alive at once (``gathered_peak``, counted by the dry run's
``CountingWeights`` in place of the step's ``DataParallelWeights``), and
every
step the elements of the fp32 gradient sum AdamW is given against those of
the rank's shards (``grad_elements``, ``shard_elements``), and each rank's
digest of its params' shards after the last step (``param_digests``, in
rank order: equal where the layout replicates the params). Rank 0's kernel
launches and routes (``repro_torch.kernels``) are recorded too. With
``serve_check`` (a 1 x 1 mesh with ``unsharded``), the trained state's
params also serve a prompt through the sharded and the unsharded prefill
and decode steps (``serve`` below): ``serve_equal`` says whether tokens,
logits and every cache entry agree bit for bit.

CASE.json with ``serve`` (the sharded serving steps, no training): params
(an .npz of the whole bf16 params as int16 bit patterns), rules (as above;
"tp_only" is JAX's serving layout without FSDP), tokens (an .npy (B, S) int32
prompt, the global batch every rank is given), frontend (optional, as
above), max_len, new (decode steps), routing (as above: "routing.npz" holds
the prefill's and the decode's calls apart), flops (count rank 0's FLOPs
of the prefill step and of one decode step at ``max_len`` - 1 instead,
``torch.utils.flop_counter``, as the dry run counts them). Rank 0 writes
to ``out``'s metrics.json the next tokens of each step (global batch), the
logits of each step (whole vocab, global rows) in ``logits.npy``, the cache
gathered whole in ``cache.npz`` (every entry; bf16 as bit patterns), each
rank's local shape of each cache entry and the most weight bytes gathered
over "data" alive at once.
"""
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import OptimConfig, get_reduced
from repro_torch.distributed.sharding import LAYOUTS, gather, layout_rules, local, param_specs, shard_params, spec_of
from repro_torch.kernels import launch_counts, route_counts
from repro_torch.launch import steps
from repro_torch.launch.dryrun import CountingWeights
from repro_torch.launch.steps import (abstract_train_state, build_prefill_step, build_serve_step, build_train_step,
                                      decode_cache)
from repro_torch.models import layers
from repro_torch.models.api import ModelSpec

RULES = {name: layout_rules(name) for name in LAYOUTS}


def reduced_config(case):
    """The reduced config of ``case["arch"]``, with ``case["replace"]``'s
    fields replaced (``ssm_heads``: the SSM's head count)."""
    cfg = get_reduced(case["arch"])
    fields = dict(case.get("replace", {}))
    if "ssm_heads" in fields:
        fields["ssm"] = dataclasses.replace(cfg.ssm, heads=fields.pop("ssm_heads"))
    return dataclasses.replace(cfg, **fields)


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


def bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bit patterns (int16) as numpy; others as they are."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def record_routing(probs: list, ids: list, drops: list) -> None:
    """Each MoE call's router probabilities of this rank's rows, its expert
    ids (the global rows') and its dropped (token, choice) pairs, in order."""
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


def recording_greedy(inner, into: list):
    """``steps.greedy`` (``inner``) that also keeps each call's whole logits
    (fp32, every vocab column, the global rows) in ``into``."""

    def greedy(logits, vocab=None, rows=None):
        whole = logits.float()
        if vocab is not None:
            whole = vocab[0].gather(whole, -1, partial_grad=False)
        if rows is not None:
            whole = rows.gather(whole)
        into.append(whole.cpu())
        return inner(logits, vocab, rows)

    return greedy


def serve(spec, mesh, params, tokens, frontend, max_len: int, new: int, marks=None, layout: str = "default"):
    """The prompt ``tokens`` through the prefill step and ``new`` greedy
    decode steps: sharded on ``mesh`` (params placed on it by ``layout``'s
    rules), or unsharded where ``mesh`` is None. ``marks``: called with "decode" between the
    prefill and the decode steps. Returns (next tokens (B, 1 + new), each
    step's whole logits (B, V), every cache entry whole, this rank's shape
    of each cache entry)."""
    logits, inner = [], steps.greedy
    steps.greedy = recording_greedy(inner, logits)
    try:
        tok, cache = build_prefill_step(spec, mesh, layout)(params, tokens, frontend)
        if marks is not None:
            marks("decode")
        n = cache["k"].shape[2] if "k" in cache else cache["length"]  # a vlm's frontend rows included
        dc = decode_cache(spec, cache, tokens.shape[0], max_len, device=tokens.device, mesh=mesh, layout=layout)
        del cache
        step, out = build_serve_step(spec, mesh, layout), [tok]
        for i in range(new):
            tok, dc = step(params, dc, tok, n + i)
            out.append(tok)
    finally:
        steps.greedy = inner
    entries = sorted(k for k, v in dc.items() if isinstance(v, torch.Tensor))
    return (torch.cat(out, dim=1), logits, {k: gather(dc[k]) for k in entries},
            {k: tuple(local(dc[k]).shape) for k in entries})


def serve_check(spec, mesh, params, plain, batch, device, layout: str = "default") -> dict:
    """A prompt of the batch (4 rows of 32 tokens, 4 new) through the
    sharded steps on ``mesh`` and the unsharded steps on ``plain``: whether
    they agree bit for bit (tokens, logits and every cache entry)."""
    tokens, frontend = batch["tokens"][:4, :32], batch.get("frontend")
    if frontend is not None:  # an encdec's frames of the prompt (S // 4, within the cross cache's rows)
        frontend = frontend[:4] if spec.cfg.family != "encdec" else frontend[:4, :tokens.shape[1] // 4]
    max_len = (0 if frontend is None or spec.cfg.family != "vlm" else spec.cfg.n_frontend_tokens) + 40
    got = serve(spec, mesh, params, tokens, frontend, max_len, 4, layout=layout)
    want = serve(spec, None, {n: p.detach() for n, p in plain.items()}, tokens, frontend, max_len, 4)
    same = torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    same = same and len(got[1]) == len(want[1]) and sorted(got[2]) == sorted(want[2])
    same = same and all(torch.equal(got[2][k], want[2][k]) for k in got[2])
    return {"serve_equal": bool(same)}


def serving(case, rank: int, mesh, device, spec) -> None:
    """The ``serve`` case: the sharded prefill and decode steps on the
    mesh (see the module's docstring)."""
    saved = np.load(case["params"])
    whole = {n: torch.from_numpy(saved[n]).view(torch.bfloat16).to(device) for n in saved.files}
    layout = case.get("rules", "default")
    params = shard_params(spec, whole, mesh, RULES[layout])
    del whole
    tokens = torch.from_numpy(np.load(case["tokens"])).to(device)
    frontend = None
    if case.get("frontend"):
        frontend = torch.from_numpy(np.load(case["frontend"])).to(device, torch.bfloat16)
    counted = []  # each step's FSDP gather, counting the gathered bytes alive

    def counting_weights(*args):
        counted.append(CountingWeights(*args))
        return counted[-1]

    steps.DataParallelWeights = counting_weights
    result = {}
    if case.get("flops"):
        from torch.utils.flop_counter import FlopCounterMode

        B, S = tokens.shape
        counters = [FlopCounterMode(display=False) for _ in range(2)]
        with counters[0]:
            tok, cache = build_prefill_step(spec, mesh, layout)(params, tokens, frontend)
        dc = decode_cache(spec, cache, B, S, device=device, mesh=mesh, layout=layout)
        with counters[1]:
            build_serve_step(spec, mesh, layout)(params, dc, tok, S - 1)
        result["flops"] = [c.get_total_flops() for c in counters]
    else:
        phases = {"prefill": ([], [], []), "decode": ([], [], [])}  # probs, ids, drops
        inner_route, inner_slots = layers.moe_route, layers.moe_slots

        def marks(name):  # the MoE calls of each phase apart
            if case.get("routing"):
                layers.moe_route, layers.moe_slots = inner_route, inner_slots
                record_routing(*phases[name])

        marks("prefill")
        out, logits, cache, shape = serve(spec, mesh, params, tokens, frontend, case["max_len"], case["new"], marks,
                                          layout)
        layers.moe_route, layers.moe_slots = inner_route, inner_slots
        shapes = [None] * dist.get_world_size()
        dist.all_gather_object(shapes, shape)
        peak = torch.tensor([float(max((w.peak for w in counted), default=0))])
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        result.update(tokens=out.cpu().tolist(), local_cache_shapes=shapes, gathered_peak=float(peak),
                      drops={k: v[2] for k, v in phases.items()})
        result["launches"], result["routes"] = launch_counts(), route_counts()  # kernels launched by rank 0
    if rank == 0:
        Path(case["out"]).mkdir(parents=True, exist_ok=True)
        (Path(case["out"]) / "metrics.json").write_text(json.dumps(result))
        if not case.get("flops"):
            np.save(Path(case["out"]) / "logits.npy", torch.stack(logits).numpy())
            np.savez(Path(case["out"]) / "cache.npz", **{k: bits(v) for k, v in cache.items()})
            if case.get("routing"):
                np.savez(Path(case["out"]) / "routing.npz",
                         **{f"{k}_{part}": np.stack(v[i]) for k, v in phases.items()
                            for i, part in enumerate(("probs", "ids"))})


def training(case, rank: int, mesh, device, spec) -> None:
    """The train case (see the module's docstring)."""
    compress_from = case.get("compress_from")
    has_residual = case["compress"] or compress_from is not None
    ck = Checkpointer(case["ckpt_in"], async_save=False)
    layout = case.get("rules", "default")
    specs = param_specs(spec.schema(), mesh, RULES[layout])
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
        record_routing(probs, ids, drops)
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
    step = build_train_step(spec, optim, case["accum"], mesh=mesh, layout=layout)
    fns = [step]
    if compress_from is not None:
        fns.append(build_train_step(spec, dataclasses.replace(optim, compress_grads=True), case["accum"],
                                    mesh=mesh, layout=layout))
    chosen = step if compress_from is None else (lambda i: fns[int(i >= compress_from)])
    result = {"metrics": run(chosen, state, batch, case, case.get("ckpt_out")), "drops": drops,
              "quant_steps": quant_steps, "grad_elements": grad_elements,
              "shard_elements": sum(local(p).numel() for p in state["params"].values())}
    result["launches"], result["routes"] = launch_counts(), route_counts()  # kernels launched by rank 0
    digest = hashlib.sha256()  # this rank's shards of the params after the last step
    for name in sorted(state["params"]):
        digest.update(bits(local(state["params"][name])).tobytes())
    result["param_digests"] = [None] * dist.get_world_size()
    dist.all_gather_object(result["param_digests"], digest.hexdigest())
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
        if case.get("serve_check"):  # the trained params served both ways
            result.update(serve_check(spec, mesh, state["params"], plain["params"], batch, device, layout))
    if rank == 0:
        Path(case["out"]).mkdir(parents=True, exist_ok=True)
        (Path(case["out"]) / "metrics.json").write_text(json.dumps(result))
        if case.get("routing"):
            np.savez(Path(case["out"]) / "routing.npz", probs=np.stack(probs), ids=np.stack(ids))


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
        spec = ModelSpec(reduced_config(case))
        (serving if case.get("serve") else training)(case, rank, mesh, device, spec)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
