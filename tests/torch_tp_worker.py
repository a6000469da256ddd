"""One rank of the split compute's checks on a gloo CPU group (the
multi-process half of tests/test_torch_tp_ops.py and of the fp32 checks of
tests/test_torch_tensor_parallel.py; torch and repro_torch only, no JAX).

    python tests/torch_tp_worker.py CASE.json RANK WORLD PORT

CASE.json: "kind" and its fields; rank 0 writes ``out`` (JSON).

- kind "ops": every op of ``distributed/groups.py`` over all WORLD ranks
  as the "model" group (and as the data-parallel group of
  ``DataParallelWeights``), fp64: each forward against the single-process
  function of the whole tensors, each gradient against autograd of that
  function (the ranks' parts gathered), and the vocab-parallel cross
  entropy (fp32) against ``F.cross_entropy`` of the whole logits, with
  rows whose max lies on another rank's range; the serving steps'
  collectives (``serving_ops``). Writes the largest gaps.
- kind "model": ``arch`` (reduced, ``replace``'s fields replaced) on
  ``mesh`` / ``axes`` in fp32 (the params drawn from ``seed`` in fp32 on
  every rank, with ``randomize`` the constant leaves made random, the same
  batch): the
  split step's loss and the gradient of each leaf, summed over the
  data-parallel ranks and gathered whole, against the unsharded loss and
  gradient of the same fp32 params and batch. Writes each leaf's largest
  gap over its largest |value| and the most gathered bytes alive at once.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.groups import DataParallelRows, DataParallelWeights, ModelParallel
from repro_torch.launch.dryrun import CountingWeights
from repro_torch.launch.mesh import data_group, dp_group, dp_index, dp_size, model_group, model_index, model_size
from repro_torch.models import layers
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import flat_leaves
from torch_dist_worker import reduced_config


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def ops_case(case, rank: int, world: int) -> dict:
    group = dist.group.WORLD
    tp = ModelParallel(group, world, rank)
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    whole = torch.randn((world * 3, world * 2), generator=gen, dtype=torch.float64)  # every rank draws the same
    part = whole.chunk(world)[rank].clone().requires_grad_(True)
    gaps = {}

    # copy: identity forward; backward sums each rank's gradient
    w = [torch.randn((3, world * 2), generator=gen, dtype=torch.float64) for _ in range(world)]  # rank r's upstream
    x = whole[:3].clone().requires_grad_(True)
    y = tp.copy(x)
    (y * w[rank]).sum().backward()
    gaps["copy forward"] = _gap(y.detach(), whole[:3])
    gaps["copy backward"] = _gap(x.grad, sum(w))
    # reduce: forward sums the ranks' parts; backward passes the gradient
    x = part
    y = tp.reduce(x)
    (y * w[0]).sum().backward()
    gaps["reduce forward"] = _gap(y.detach(), sum(whole.chunk(world)))
    gaps["reduce backward"] = _gap(x.grad, w[0])
    # gather, partial gradients (a cut KV head): the whole tensor forward;
    # each rank's upstream gradient is a part, summed before the own block
    for dim in (0, 1):
        blocks = whole.chunk(world, dim=dim)
        x = blocks[rank].clone().requires_grad_(True)
        y = tp.gather(x, dim, partial_grad=True)
        ups = [torch.randn(whole.shape, generator=gen, dtype=torch.float64) for _ in range(world)]
        (y * ups[rank]).sum().backward()
        gaps[f"gather dim {dim} forward"] = _gap(y.detach(), whole)
        gaps[f"gather dim {dim} partial backward"] = _gap(x.grad, sum(ups).chunk(world, dim=dim)[rank])
        # replicated compute: every rank's upstream is the same whole gradient
        x = blocks[rank].clone().requires_grad_(True)
        y = tp.gather(x, dim, partial_grad=False)
        (y * ups[0]).sum().backward()
        gaps[f"gather dim {dim} replicated backward"] = _gap(x.grad, ups[0].chunk(world, dim=dim)[rank])
    # FSDP gather over the data-parallel ranks (here the same group): this
    # rank's block along dim 1; the backward sums over the ranks and keeps
    # the block; a leaf not split over data is all-reduced
    weights = DataParallelWeights(group, world, rank, group, world)
    x = whole.chunk(world, dim=1)[rank].clone().requires_grad_(True)
    y = weights.gather(x, 1)
    ups = [torch.randn(whole.shape, generator=gen, dtype=torch.float64) for _ in range(world)]
    (y * ups[rank]).sum().backward()
    gaps["fsdp gather forward"] = _gap(y.detach(), whole)
    gaps["fsdp gather backward"] = _gap(x.grad, sum(ups).chunk(world, dim=1)[rank])
    x = whole.clone().requires_grad_(True)
    (weights.gather(x, None) * ups[rank]).sum().backward()
    gaps["fsdp replicated backward"] = _gap(x.grad, sum(ups))
    # DataParallelRows: rows in rank order; the gradient of the own block
    rows = DataParallelRows(group)
    part = whole.chunk(world)[rank].clone().requires_grad_(True)
    y = rows.gather(part)
    (y * ups[rank][: y.shape[0]]).sum().backward()
    gaps["rows forward"] = _gap(y.detach(), whole)
    gaps["rows backward"] = _gap(part.grad, sum(u[: y.shape[0]] for u in ups).chunk(world)[rank])
    # gradcheck of copy + reduce composed (a TP block): f(x) = reduce(copy(x) @ W_r)
    Ws = [torch.randn((world * 2, 4), generator=gen, dtype=torch.float64) for _ in range(world)]
    xin = torch.randn((3, world * 2), generator=gen, dtype=torch.float64, requires_grad=True)
    fn = lambda t: tp.reduce(tp.copy(t) @ Ws[rank])  # noqa: E731
    gaps["tp block gradcheck"] = 0.0 if torch.autograd.gradcheck(fn, (xin,)) else 1.0
    x_ref = xin.detach().clone().requires_grad_(True)
    out_ref = x_ref @ sum(Ws)
    up = torch.randn(out_ref.shape, generator=gen, dtype=torch.float64)
    (out_ref * up).sum().backward()
    x_tp = xin.detach().clone().requires_grad_(True)
    (fn(x_tp) * up).sum().backward()
    gaps["tp block forward"] = _gap(fn(xin).detach(), out_ref.detach())
    gaps["tp block backward"] = _gap(x_tp.grad, x_ref.grad)
    # column-parallel in (this rank's columns of two projections) and
    # row-parallel out (this rank's rows), fp64: against the whole matmuls
    Wa, Wb = (torch.randn((world * 2, world * 3), generator=gen, dtype=torch.float64) for _ in range(2))
    Wc = torch.randn((world * 3, 4), generator=gen, dtype=torch.float64)
    up = torch.randn((3, 4), generator=gen, dtype=torch.float64)

    def mlp(t, a, b, c, split):
        ya, yb = tp.column_parallel(t, a, b) if split else (t @ a, t @ b)
        h = torch.tanh(ya) * yb
        return tp.row_parallel(h, c) if split else h @ c

    cols = lambda w: w.chunk(world, dim=1)[rank].clone().requires_grad_(True)  # noqa: E731
    parts = [cols(Wa), cols(Wb), Wc.chunk(world, dim=0)[rank].clone().requires_grad_(True)]
    x_tp = xin.detach().clone().requires_grad_(True)
    out_tp = mlp(x_tp, *parts, True)
    (out_tp * up).sum().backward()
    whole_w = [w.clone().requires_grad_(True) for w in (Wa, Wb, Wc)]
    x_ref = xin.detach().clone().requires_grad_(True)
    out_ref = mlp(x_ref, *whole_w, False)
    (out_ref * up).sum().backward()
    gaps["column/row parallel forward"] = _gap(out_tp.detach(), out_ref.detach())
    gaps["column/row parallel input grad"] = _gap(x_tp.grad, x_ref.grad)
    gaps["column/row parallel weight grads"] = max(
        _gap(parts[0].grad, whole_w[0].grad.chunk(world, dim=1)[rank]),
        _gap(parts[1].grad, whole_w[1].grad.chunk(world, dim=1)[rank]),
        _gap(parts[2].grad, whole_w[2].grad.chunk(world, dim=0)[rank]))

    # the vocab-parallel cross entropy, fp32, against F.cross_entropy of the
    # whole logits; every other row's max lies on the last rank's range
    V = 8 * world
    logits = torch.randn((6, 4, V), generator=gen) * 3
    logits[::2, :, -1] += 20.0
    targets = torch.randint(0, V, (6, 4), generator=gen)
    lg = logits.chunk(world, dim=-1)[rank].clone().requires_grad_(True)
    nll = tp.cross_entropy(lg, targets, rank * (V // world))
    nll.mean().backward()
    ref_logits = logits.clone().requires_grad_(True)
    ref = F.cross_entropy(ref_logits.reshape(-1, V), targets.reshape(-1), reduction="none").reshape(6, 4)
    ref.mean().backward()
    # the loss relative to max(1, |loss|): one fp32 ulp of a loss near 20 is 2e-6
    scale = max(1.0, float(ref.abs().max()))
    gaps["cross entropy"] = _gap(nll.detach(), ref.detach()) / scale
    gaps["cross entropy grad"] = _gap(lg.grad, ref_logits.grad.chunk(world, dim=-1)[rank])
    # bf16 logits, as the model gives them: the fp32 loss of the same values
    lg16 = logits.to(torch.bfloat16).chunk(world, dim=-1)[rank]
    ref16 = F.cross_entropy(logits.to(torch.bfloat16).float().reshape(-1, V), targets.reshape(-1),
                            reduction="none").reshape(6, 4)
    gaps["cross entropy bf16 logits"] = _gap(tp.cross_entropy(lg16, targets, rank * (V // world)), ref16) / scale
    gaps["max on another rank's range"] = float(not bool((logits[::2].argmax(-1) == V - 1).all()))
    gaps.update(serving_ops(tp, rank, world, gen))
    out = torch.tensor([gaps[k] for k in sorted(gaps)])
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return dict(zip(sorted(gaps), out.tolist()))


def serving_ops(tp: ModelParallel, rank: int, world: int, gen) -> dict:
    """The sharded serving steps' collectives against their single-process
    functions: decode attention over a sequence split into rank chunks
    (fp32) against ``decode_attention`` on the whole cache, at lengths that
    leave no chunk, the last rank's chunk, and every chunk but the first's
    first position masked (a chunk wholly masked must add exact zeros, no
    NaN); the greedy argmax over vocab-split logits with ties within a
    rank's range and across ranks (the lowest global id); every head
    gathered from head ranges that are disjoint, overlapping and uneven
    (a "kv_gather" route), or whole on every rank."""
    gaps = {"sharded decode attention": 0.0, "sharded decode attention not finite": 0.0}
    B, KV, g, hd, chunk = 2, 2, 2, 8, 5
    S = chunk * world
    q = torch.randn((B, 1, KV * g, hd), generator=gen)
    k, v = (torch.randn((B, S, KV, hd), generator=gen) for _ in range(2))
    own = slice(rank * chunk, (rank + 1) * chunk)
    for length in (S, chunk * (world - 1), 1):
        got = layers.sharded_decode_attention(q, k[:, own], v[:, own], length, tp)
        gaps["sharded decode attention"] = max(gaps["sharded decode attention"],
                                               _gap(got, layers.decode_attention(q, k, v, length)))
        gaps["sharded decode attention not finite"] += float(not bool(torch.isfinite(got).all()))
    V = 4 * world
    logits = torch.randn((4, V), generator=gen).to(torch.bfloat16)
    logits[0, ::4] = 5.0  # the max at every rank's first id: 0
    logits[1, [V - 3, V - 1]] = 7.0  # a tie within the last rank's range
    logits[2, [5, V - 1]] = 9.0  # a tie across ranks 1 and world - 1
    got = tp.argmax(logits.chunk(world, dim=-1)[rank], rank * 4)
    gaps["vocab-split argmax"] = float(not torch.equal(got, torch.argmax(logits.float(), dim=-1)))
    gaps["gather heads"] = 0.0
    n = world + 1
    whole = torch.randn((2, 3, n, 4), generator=gen)
    disjoint = [(r, r + 1) for r in range(world - 1)] + [(world - 1, n)]  # the last rank holds two heads
    overlapping = [(0, 2), (1, n)] if world == 2 else [(0, 1), (0, 2), (1, n)]
    for ranges in (disjoint, overlapping, [(0, n)] * world):
        a, b = ranges[rank]
        gaps["gather heads"] = max(gaps["gather heads"], _gap(tp.gather_heads(whole[:, :, a:b], ranges, 2), whole))
    return gaps


def split_layout(spec, mesh, specs):
    """The step's ``layers.Split`` for the per-layer specs of ``specs``, its
    FSDP gather counting the gathered bytes alive (the dry run's
    ``CountingWeights``)."""
    stacked = {n for n, leaf in flat_leaves(spec.schema()) if leaf.axes[0] == "layers"}
    coord = sharding.mesh_coordinate(mesh)
    weights = CountingWeights(data_group(mesh), sharding.mesh_shape(mesh).get("data", 1), coord.get("data", 0),
                              dp_group(mesh), dp_size(mesh))
    tp = ModelParallel(model_group(mesh), model_size(mesh), model_index(mesh)) if model_size(mesh) > 1 else None
    return layers.Split({n: s[1:] if n in stacked else s for n, s in specs.items()}, weights, tp)


def model_case(case, rank: int, world: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", tuple(case["mesh"]), mesh_dim_names=tuple(case["axes"]))
    spec = ModelSpec(reduced_config(case))
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    schema = spec.schema()
    params = {n: p.float() for n, p in spec.init(gen, device="cpu").items()}
    for name, leaf in flat_leaves(schema):  # constant leaves made random (a per-head slice must be the right one)
        if case.get("randomize") and leaf.init in ("zeros", "ones"):
            params[name] = params[name] + torch.rand(leaf.shape, generator=gen) * 0.5
    batch = spec.smoke_batch(gen, batch=case["batch"], seq=case["seq"], device="cpu")
    if "frontend" in batch:
        batch["frontend"] = batch["frontend"].float()
    # the unsharded reference, on every rank alike
    ref = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    ref_loss, _ = spec.loss(ref, batch)
    ref_loss.backward()
    # the split step's compute: this rank's rows, its local shards
    specs = sharding.param_specs(schema, mesh)
    coord, sizes = sharding.mesh_coordinate(mesh), sharding.mesh_shape(mesh)
    local = {n: p[sharding.shard_slices(p.shape, specs[n], sizes, coord)].clone().requires_grad_(True)
             for n, p in params.items()}
    dp, index = dp_size(mesh), dp_index(mesh)
    n = case["batch"] // dp
    own = {k: v[index * n:(index + 1) * n] for k, v in batch.items()}
    layout = split_layout(spec, mesh, specs)
    with layers.data_parallel_rows(DataParallelRows(dp_group(mesh))), layers.split_compute(layout):
        loss, _ = spec.loss(local, own)
        loss.backward()
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=dp_group(mesh))
    gaps = {"loss": abs(float(loss) / dp - float(ref_loss))}
    for name in sorted(local):  # the whole gradient of the rank-summed shards, as the step's mean over dp
        g = local[name].grad / dp
        whole = torch.zeros(params[name].shape)
        whole[sharding.shard_slices(whole.shape, specs[name], sizes, coord)] = g
        # each shard is held by the ranks its spec does not split: count it once
        if not sharding.is_first_replica(specs[name], sizes, coord):
            whole.zero_()
        dist.all_reduce(whole)
        want = ref[name].grad
        gaps[name] = _gap(whole, want) / max(float(want.abs().max()), 1e-30)
    out = torch.tensor([gaps[k] for k in sorted(gaps)])
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    res = dict(zip(sorted(gaps), out.tolist()))
    peak = torch.tensor([float(layout.weights.peak)])
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    res["gathered_peak_bytes"] = float(peak)
    return res


def main(case_path: str, rank: int, world: int, port: int) -> None:
    case = json.loads(Path(case_path).read_text())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        result = {"ops": ops_case, "model": model_case}[case["kind"]](case, rank, world)
        if rank == 0:
            Path(case["out"]).parent.mkdir(parents=True, exist_ok=True)
            Path(case["out"]).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    np.seterr(all="raise")
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
