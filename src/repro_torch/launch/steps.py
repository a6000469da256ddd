"""Step builders (port of ``repro/launch/steps.py``): the train step, and
greedy prefill and decode steps over a ``ModelSpec``, for every family.

The prefill and decode steps are how the encoder-decoder, RWKV6 and
Mamba2/Zamba2 families are served (the tiered engine serves the GQA decoder
families only, as in JAX). The train step is ``python -m
repro_torch.launch.train``'s; with a mesh it is the sharded step
(``shard_train_state`` places the state), and ``abstract_train_state`` is
the dry run's state on the meta device (``launch/dryrun.py``). With a mesh
the prefill and decode steps of every family serve in JAX's layout (params
by ``sharding.shard_params``, the decode cache by ``decode_cache(mesh=)``);
the dry run counts their bodies (``prefill_local``, ``decode_local``) on
meta.

Every sharded step takes JAX's layout profile (``layout``: "default",
"tp_only" or "dp", ``sharding.LAYOUTS``); the state or params must be
placed by that profile's rules (``sharding.layout_rules``). Under "dp" the
rows split over ("data", "model") (every rank computes all of them where
those do not divide a microbatch), nothing splits over "model" in the
compute, the gradient is the mean over the distinct rows (the pods of a
multi-pod mesh hold the same rows), and a decode cache holds the rank's
rows with the sequence whole (``sharding.layout_cache_pspec``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import OptimConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.groups import DataParallelRows, DataParallelWeights, ModelParallel
from repro_torch.launch.mesh import data_group, dp_group, dp_index, dp_size, model_group, model_index, model_size
from repro_torch.models import dense, layers
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import flat_leaves
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, leaf_square_sums, norm_of_sums
from repro_torch.optim.grad_compress import error_feedback_leaf
from repro_torch.optim.schedules import cosine_schedule

Tensors = Dict[str, torch.Tensor]
# the families whose sharded steps split their compute over "model": every
# family (``models/api.py``)
SPLIT_FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")


def _model_parallel(mesh, layout: str = "default") -> Optional[ModelParallel]:
    """This rank's place on the mesh's "model" axis (None with one rank, or
    under "dp", whose compute splits nothing over it)."""
    m = model_size(mesh)
    return ModelParallel(model_group(mesh), m, model_index(mesh)) if m > 1 and layout != "dp" else None


def compute_layout(spec: ModelSpec, mesh, params, cache=None, layout: str = "default",
                   rows_split: bool = True) -> layers.Split:
    """The split compute layout (``layers.split_compute``) of ``params`` on
    ``mesh``, read from their placements (and a decode cache's, from
    ``cache``'s): each leaf's spec for one layer, the FSDP gather over
    "data", the gradient's sum over the ranks of ``layout``'s batch axes
    (none where the rows are not split: ``rows_split`` False, every rank
    computing every row) and the "model" axis."""
    sizes, coord = sharding.mesh_shape(mesh), sharding.mesh_coordinate(mesh)
    stacked = {name for name, leaf in flat_leaves(spec.schema()) if leaf.axes[0] == "layers"}
    specs = {n: sharding.spec_of(p) for n, p in params.items()}
    axes = sharding.layout_batch_axes(layout, mesh)
    rows = (dp_group(mesh, axes), dp_size(mesh, axes)) if rows_split else (None, 1)
    weights = DataParallelWeights(data_group(mesh), sizes.get("data", 1), coord.get("data", 0), *rows)
    caches = None if cache is None else {k: sharding.spec_of(v) for k, v in cache.items() if isinstance(v, torch.Tensor)}
    return layers.Split({n: s[1:] if n in stacked else s for n, s in specs.items()}, weights,
                        _model_parallel(mesh, layout), caches)


def make_train_state(spec: ModelSpec, generator: torch.Generator, compress: bool = False, device="cuda"):
    """{"params": bf16 params (requiring grad), "opt": AdamWState, and with
    ``compress`` "residual": fp32 zeros like the params}."""
    params = spec.init(generator, device=device)
    for p in params.values():
        p.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["residual"] = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
    return state


def abstract_train_state(spec: ModelSpec, compress: bool = False):
    """The train state's leaves on the meta device (shapes and dtypes, no
    data): bf16 params, an AdamWState of fp32 mu, nu and master with the
    step as a 0-d int32 (JAX's ``ShapeDtypeStruct((), int32)``), and with
    ``compress`` the fp32 residual."""
    params = spec.abstract_params()
    f32like = lambda: {n: torch.empty(p.shape, dtype=torch.float32, device="meta") for n, p in params.items()}  # noqa: E731
    state = {"params": params,
             "opt": AdamWState(torch.empty((), dtype=torch.int32, device="meta"), f32like(), f32like(), f32like())}
    if compress:
        state["residual"] = f32like()
    return state


def shard_train_state(spec: ModelSpec, state: Dict[str, Any], mesh, rules=None) -> Dict[str, Any]:
    """The state on ``mesh``: params, mu, nu, master and the residual as
    DTensors placed by ``param_specs(spec.schema(), mesh, rules)``, each
    rank's shard a fresh copy on the mesh's device (``state`` is left as it
    was, wherever it lies); the step stays a replicated int. The layout is
    this function's alone: the sharded step reads each leaf's shard from its
    placements."""
    place = lambda leaves: sharding.shard_params(spec, leaves, mesh, rules)  # noqa: E731
    opt = state["opt"]
    out = {"params": place(state["params"]),
           "opt": AdamWState(opt.step, place(opt.mu), place(opt.nu), place(opt.master))}
    if "residual" in state:
        out["residual"] = place(state["residual"])
    return out


def build_train_step(spec: ModelSpec, optim: OptimConfig, accum_steps: int = 1, mesh=None,
                     layout: str = "default") -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), updating the
    state IN PLACE (JAX returns a new one). The global batch is split into
    ``accum_steps`` microbatches of consecutive rows (JAX's reshape); each
    runs ``loss.backward()`` into bf16 ``.grad``, which is added to an fp32
    sum and cleared (JAX's ``g_acc + g.astype(f32)``). The sum over
    ``accum_steps``, through error feedback with ``compress_grads``, goes to
    AdamW at the rate ``cosine_schedule`` gives for the step BEFORE the
    increment (JAX's order: with ``warmup_steps > 0`` the first update has
    rate 0). Metrics: loss, grad_norm (before the clip), lr, step.
    ``train_step.grads_and_loss(params, batch)`` is the accumulation alone.

    With ``mesh`` (spanning every process) the state is placed on it
    (``shard_train_state``, or a restore onto the mesh), and the step is
    JAX's function of the global batch. One step:

    (a) computes in JAX's layout (``layers.split_compute``), every family
        (``SPLIT_FAMILIES``): the model is given each leaf's local shard, a
        plain tensor that requires grad, and each weight is gathered over
        "data" where it is used, inside the remat region
        (``layers.use_weight``), leaving its "model" shard: Megatron TP for
        heads (attention's and the recurrences'), ffn and vocab, EP for the
        experts;
    (b) takes this rank's rows of each microbatch by ``layout``'s batch
        spec (``sharding.layout_batch_spec``): its block of the microbatch's
        rows over the batch axes (every rank is given the whole global
        batch; ranks with one coordinate on those axes take the same rows).
        Under "dp", where those axes do not divide the microbatch, every
        rank takes every row (``filter_spec_for_mesh`` replicates them), and
        nothing is summed over ranks;
    (c) runs the accumulation on them, plain tensors all the way down (the
        kernels see no DTensor), with the MoE routing over the global
        microbatch (``layers.data_parallel_rows``);
    (d) sums the gradient over the batch axes' ranks and divides by their
        count (the mean over the distinct rows); each rank keeps its shard,
        as the
        leaf's placements say: the gather's backward sums each microbatch's
        bf16 gradient over the data-parallel ranks into the rank's shard
        (GSPMD's reduce-scatter, in the param dtype; a weight used several
        times a microbatch, zamba2's shared block, once for the sum of its
        uses), and the fp32 sum over microbatches is a sum of shards;
    (e) error feedback with the whole leaf's int8 scale (a max over the
        mesh), then AdamW on the local shards in place, clipped by the norm
        that counts each element once (a shard's sum of squares from its
        first replica only);
    (f) returns global metrics: the loss is the mean over every rank's rows.

    ``layout`` is JAX's profile (``sharding.LAYOUTS``; the state placed by
    its ``layout_rules``): "tp_only" changes the rules alone; "dp" has no
    "model" split in the compute (no TP collective), the rows over ("data",
    "model"), and its gradient reduced over those ranks alone (a multi-pod
    mesh's pods hold the same rows and compute the same sum).

    Without a mesh the same body runs with every part whole: the rows are
    the batch, the gather and the reductions are the identity, and a leaf's
    shard is the leaf."""

    def grads_and_loss(params: Tensors, batch: Dict[str, torch.Tensor]) -> Tuple[Tensors, torch.Tensor]:
        B = batch["tokens"].shape[0]
        if B % accum_steps:
            raise ValueError(f"global batch {B} does not split into {accum_steps} microbatches")
        mb = B // accum_steps
        g_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for i in range(accum_steps):
            loss, metrics = spec.loss(params, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
            loss.backward()
            for n, p in params.items():
                if p.grad is not None:  # a leaf the loss does not reach has grad 0, as in JAX
                    g_sum[n].add_(p.grad)
                    p.grad = None
            loss_sum = loss_sum + metrics["loss"].detach()
        for g in g_sum.values():
            g.div_(accum_steps)
        return g_sum, loss_sum / accum_steps

    if mesh is None:
        place, sizes, coord = None, {}, {}
    else:
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh spans {mesh.size()} of {dist.get_world_size()} processes; the step reduces "
                             "the int8 scale and the clip norm over every process, so the mesh must span them all")
        place, sizes, coord = _Rows(mesh, layout), sharding.mesh_shape(mesh), sharding.mesh_coordinate(mesh)

    def reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, over=None) -> torch.Tensor:
        """All-reduce ``t`` in place over ``over`` (default: every process,
        which the mesh spans); the identity without a mesh."""
        if mesh is not None:
            dist.all_reduce(t, op=op, group=over)
        return t

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        B = batch["tokens"].shape[0]
        dp = 1 if place is None else place.size
        if B % accum_steps or ((B // accum_steps) % dp and layout != "dp"):
            raise ValueError(f"global batch {B} does not split into {accum_steps} microbatches over {dp} data ranks")
        mb = B // accum_steps
        own_rows, rows = slice(0, mb), None
        if place is not None:
            own_rows, rows = place.rows(mb)
        dp = 1 if rows is None else dp  # every rank computes every row: nothing to sum over ranks
        own = {k: torch.cat([v[i * mb:(i + 1) * mb][own_rows] for i in range(accum_steps)]) for k, v in batch.items()}
        params = state["params"]
        specs = {name: sharding.spec_of(p) for name, p in params.items()}
        local = {name: sharding.local(p).detach().requires_grad_(True) for name, p in params.items()}
        layout_ = None if mesh is None else compute_layout(spec, mesh, params, layout=layout,
                                                           rows_split=rows is not None)
        with layers.data_parallel_rows(rows), layers.split_compute(layout_):
            grads, loss = grads_and_loss(local, own)
        del local
        for g in grads.values():  # each a sum of this rank's shards over the data-parallel ranks
            g.div_(dp)
        if rows is not None:
            loss = reduce(loss, over=place.group) / dp
        shards = lambda leaves: {name: sharding.local(t) for name, t in leaves.items()}  # noqa: E731
        if optim.compress_grads:
            residual = shards(state["residual"])
            amax = lambda x: reduce(x.clone(), op=dist.ReduceOp.MAX)  # noqa: E731 (over every rank: replicas agree)
            for name in sorted(grads):  # each fp32 sum is freed as its compressed grad replaces it
                grads[name] = error_feedback_leaf(grads[name], residual[name], amax)
        sums = leaf_square_sums(grads)
        first = torch.tensor([sharding.is_first_replica(specs[name], sizes, coord) for name in sorted(grads)],
                             device=sums.device)
        gnorm = norm_of_sums(reduce(torch.where(first, sums, torch.zeros_like(sums))))
        opt = state["opt"]
        lr = cosine_schedule(optim, opt.step)
        _, new_opt = adamw_update(optim, AdamWState(opt.step, shards(opt.mu), shards(opt.nu), shards(opt.master)),
                                  grads, lr, shards(params), gnorm)
        state["opt"] = AdamWState(new_opt.step, opt.mu, opt.nu, opt.master)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, "step": new_opt.step}

    train_step.grads_and_loss = grads_and_loss
    return train_step


def greedy(logits: torch.Tensor, vocab=None, rows=None) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32: the first index of each row's maximum.
    ``vocab``: (the "model" axis, this rank's first id) where the logits
    are this rank's vocab columns (the lowest global id among equal maxima,
    ``ModelParallel.argmax``); ``rows``: the data-parallel ranks whose rows
    are gathered after it (the global batch, in their order)."""
    ids = torch.argmax(logits, dim=-1) if vocab is None else vocab[0].argmax(logits, vocab[1])
    if rows is not None:
        ids = rows.gather(ids)
    return ids.to(torch.int32)[:, None]


def prefill_local(spec: ModelSpec, params: Tensors, tokens: torch.Tensor, frontend=None, rows=None):
    """The prefill step's body on this rank's rows and params, in whatever
    compute layout is in force (``layers.split_compute``): (the global
    batch's next tokens, the rank's cache)."""
    logits, cache = spec.prefill(params, tokens, frontend)
    return greedy(logits, dense.logits_split(spec.cfg), rows), cache


def decode_local(spec: ModelSpec, params: Tensors, cache, tokens: torch.Tensor, pos: int, rows=None):
    """The serve step's body, as ``prefill_local``'s: (next tokens, cache)."""
    logits, cache = spec.decode_step(params, cache, tokens, pos)
    return greedy(logits, dense.logits_split(spec.cfg), rows), cache


class _Rows:
    """A sharded step's rows on ``mesh`` under ``layout``: this rank's block
    of a batch over the layout's batch axes (``dp_index`` over them), or
    every row where those ranks do not divide the batch, as
    ``filter_spec_for_mesh`` replicates it."""

    def __init__(self, mesh, layout: str = "default"):
        axes = sharding.layout_batch_axes(layout, mesh)
        self.size, self.index, self.group = dp_size(mesh, axes), dp_index(mesh, axes), dp_group(mesh, axes)

    def rows(self, batch: int):
        """(this rank's slice of the global rows, the ranks to gather the
        rows' results over: None where each holds every row)."""
        if batch % self.size:
            return slice(0, batch), None
        n = batch // self.size
        return slice(self.index * n, (self.index + 1) * n), DataParallelRows(self.group)


def decode_cache(spec: ModelSpec, prefill_cache: Dict[str, Any], batch: int, max_len: int, device="cuda", mesh=None,
                 layout: str = "default"):
    """``spec.init_cache(batch, max_len)`` holding ``prefill_cache`` in the
    leading slice of each entry, zeros after it (how JAX's
    ``tests/test_system.py::test_prefill_decode`` hands a prefill to
    decode; an encdec's cross rows beyond the frames stay zero and are
    attended, as in JAX). Entries keep the prefill's dtypes, so an fp32
    prefill gives an fp32 cache.

    With ``mesh``, the cache of the global ``batch`` placed as
    ``cache_pspec`` says, through ``filter_spec_for_mesh``: each entry a
    DTensor of this rank's rows and its block of the dims the spec splits
    over "model" (a K/V cache's chunk of the ``max_len`` positions, every
    KV head whole; rwkv6's WKV state's heads), whole on the others;
    ``length`` as the prefill's. ``prefill_cache`` is the sharded
    prefill's (this rank's rows; the entries its ``heads`` names hold the
    rank's heads, gathered over "model" here by
    ``ModelParallel.gather_heads``). ``device`` is then the mesh's. Under
    ``layout`` "dp" each entry holds the rank's rows and every position
    (``sharding.layout_cache_pspec``)."""
    if mesh is None:
        dc = spec.init_cache(batch, max_len, device=device)
        for key, v in prefill_cache.items():
            if key != "length":
                dc[key] = dc[key].to(v.dtype)
                dc[key][tuple(slice(0, n) for n in v.shape)] = v
        return dc
    from torch.distributed.tensor import DTensor

    tp = _model_parallel(mesh, layout)
    heads, shapes = prefill_cache.get("heads", {}), spec.cache_specs(batch, max_len)
    pspecs = sharding.layout_cache_pspec(layout, spec.cache_pspec())
    out = {"length": prefill_cache["length"]}
    for key, part in prefill_cache.items():
        if key in ("length", "heads"):
            continue
        whole = part if key not in heads else tp.gather_heads(part, heads[key][1], heads[key][0])
        cspec, idx = sharding.cache_layout(pspecs[key], shapes[key].shape, mesh)
        if idx[1].stop - idx[1].start != whole.shape[1]:
            raise ValueError(f"the prefill's {key} holds {whole.shape[1]} rows; this rank's of {batch} under "
                             f"{cspec} are {idx[1]}")
        local = torch.zeros([i.stop - i.start for i in idx], dtype=part.dtype, device=sharding.mesh_device(mesh))
        src, dst = [], []  # the rank's block of each dim that the prefill fills (the rows as they are)
        for d, i in enumerate(idx):
            a, b = (0, whole.shape[1]) if d == 1 else (i.start, min(i.stop, whole.shape[d]))
            src.append(slice(a, max(a, b)))
            dst.append(slice(0, max(b - a, 0)))
        local[tuple(dst)] = whole[tuple(src)]
        out[key] = DTensor.from_local(local, mesh, sharding.placements(cspec, mesh), run_check=False)
    return out


def build_prefill_step(spec: ModelSpec, mesh=None, layout: str = "default") -> Callable:
    """prefill_step(params, tokens, frontend=None) -> (next token (B, 1)
    int32, cache).

    With ``mesh`` (params placed by ``sharding.shard_params``, in any
    rules: the step reads each leaf's layout from its placements) the step
    computes in JAX's layout, every family: this rank's rows of ``tokens``
    and ``frontend`` (every rank is given the global batch), each weight
    gathered over "data" where it is used and split over "model" (heads of
    attention and of the recurrences, ffn, vocab; EP for the experts),
    flash attention on the rank's heads, no grad and no remat, the MoE
    routing over the global rows. Every rank returns the global batch's next
    tokens (JAX's value) and its own cache: its rows, its route's heads
    where the family computes the entry by heads (``decode_cache(mesh=)``
    places them). ``layout``: JAX's profile (the params placed by its
    rules): its batch axes give the rows, and "dp" splits nothing over
    "model". A 1 x 1 mesh is the unsharded step bit for bit."""
    if mesh is None:
        def prefill_step(params, tokens, frontend=None):
            return prefill_local(spec, params, tokens, frontend)

        return prefill_step
    serving = _Rows(mesh, layout)

    def sharded_prefill_step(params, tokens, frontend=None):
        own, rows = serving.rows(tokens.shape[0])
        local = {n: sharding.local(p) for n, p in params.items()}
        with torch.no_grad(), layers.data_parallel_rows(rows), \
                layers.split_compute(compute_layout(spec, mesh, params, layout=layout)):
            return prefill_local(spec, local, tokens[own], None if frontend is None else frontend[own], rows)

    return sharded_prefill_step


def build_serve_step(spec: ModelSpec, mesh=None, layout: str = "default") -> Callable:
    """serve_step(params, cache, tokens (B, 1), pos) -> (next token (B, 1)
    int32, cache): one greedy decode step against the KV/state cache.

    With ``mesh``: the cache is ``decode_cache(mesh=)``'s, updated in place
    in each rank's shard (a K/V sequence split over "model" by
    ``cache_pspec``: the new row written by the rank whose chunk holds
    ``pos``, attention combined over the chunks; rwkv6's WKV state by the
    rank's heads; the token shifts and Mamba2's conv and SSM states whole,
    the same on every rank), ``tokens`` the global batch's, the compute as
    ``build_prefill_step``'s, in ``layout``; every rank returns the global
    batch's next tokens."""
    if mesh is None:
        def serve_step(params, cache, tokens, pos: int):
            return decode_local(spec, params, cache, tokens, pos)

        return serve_step
    serving = _Rows(mesh, layout)

    def sharded_serve_step(params, cache, tokens, pos: int):
        own, rows = serving.rows(tokens.shape[0])
        local = {n: sharding.local(p) for n, p in params.items()}
        shard = {k: sharding.local(v) if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
        with torch.no_grad(), layers.data_parallel_rows(rows), \
                layers.split_compute(compute_layout(spec, mesh, params, cache, layout)):
            nxt, shard = decode_local(spec, local, shard, tokens[own], pos, rows)
        cache["length"] = shard["length"]
        return nxt, cache

    return sharded_serve_step
