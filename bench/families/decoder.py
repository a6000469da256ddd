"""The decoder family: a GQA decoder with qk-norm and RoPE, its FFN SwiGLU
or (``model["moe"]``) the capacity-bounded top-k MoE. The family of every
configuration file without a ``"family_module"`` key.

A family module gives the harness what depends on the architecture: the
weights' layout, the program's configuration object, the model FLOPs of a
decode step, the attention calls of a step and of a prefill, whether the
driver keeps each decode step's batch, and the comparison with the plain
reference (here ``benchkit/reference.py``) that decides ``correct``.

Which requests are checked: for a dense FFN a sample of the finished
requests drawn from the seed, the longest among them, and (where the cell's
premise needs evictions) the most evicted one, each by one causal forward.
For an MoE the whole first complete wave, replayed over the program's own
decode batches, because a pair's capacity drop depends on the rows beside
it. With ``control`` the same reference in fp8 puts its first choice at each
of the same positions in place of the served token.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchkit import flops
from benchkit.reference import Reference
from benchkit.weights import Leaf


def layout(model: dict) -> List[Leaf]:
    """Every leaf in sorted name order: normal leaves N(0, 1/fan_in), the
    embedding, ``lm_head`` and router N(0, 0.02^2), norm gains one."""
    L, d, V = model["n_layers"], model["d_model"], model["vocab"]
    H, KV, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]

    def fan(n: int) -> float:
        return 1.0 / math.sqrt(n)

    leaves: List[Leaf] = [
        ("embed", (V, d), "normal", 0.02),
        ("final_norm", (d,), "ones", 1.0),
        ("blocks.attn_norm", (L, d), "ones", 1.0),
        ("blocks.mlp_norm", (L, d), "ones", 1.0),
        ("blocks.wq", (L, d, H * hd), "normal", fan(d)),
        ("blocks.wk", (L, d, KV * hd), "normal", fan(d)),
        ("blocks.wv", (L, d, KV * hd), "normal", fan(d)),
        ("blocks.wo", (L, H * hd, d), "normal", fan(H * hd)),
    ]
    if model.get("qk_norm"):
        leaves += [("blocks.q_norm", (L, hd), "ones", 1.0), ("blocks.k_norm", (L, hd), "ones", 1.0)]
    moe = model.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        leaves += [
            ("blocks.router", (L, d, E), "normal", 0.02),
            ("blocks.we_gate", (L, E, d, f), "normal", fan(d)),
            ("blocks.we_up", (L, E, d, f), "normal", fan(d)),
            ("blocks.we_down", (L, E, f, d), "normal", fan(f)),
        ]
    else:
        Ff = model["d_ff"]
        leaves += [
            ("blocks.w_gate", (L, d, Ff), "normal", fan(d)),
            ("blocks.w_up", (L, d, Ff), "normal", fan(d)),
            ("blocks.w_down", (L, Ff, d), "normal", fan(Ff)),
        ]
    if not model.get("tie_embeddings"):
        leaves.append(("lm_head", (d, V), "normal", 0.02))
    return sorted(leaves)


def program_config(name: str, model: dict):
    from repro_torch.configs import ModelConfig, MoEConfig

    kw = dict(model)
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(name=name, **kw)


def decode_flops(model: dict, contexts) -> float:
    return flops.decode_flops(model, contexts)


def attention_calls(model: dict) -> Dict[str, int]:
    """Calls of each attention kernel: paged attention in a decode step,
    flash attention in a prefill; every layer attends."""
    return {"paged_attention": model["n_layers"], "flash_attention": model["n_layers"]}


def replays_batches(model: dict) -> bool:
    """An MoE's reference replays the program's decode batches."""
    return bool(model.get("moe"))


def dense_sample(rec: dict, cell: dict, seed: int) -> List[dict]:
    """The checked requests of an open-loop or wave run with a dense FFN."""
    done = [r for r in rec["requests"] if not r["failed"] and r["req"].done]
    if not done:
        return []
    n = min(cell["check"]["requests"], len(done))
    rng = np.random.default_rng([seed, 2])
    picked = {done[i]["key"]: done[i] for i in rng.choice(len(done), size=n, replace=False)}
    longest = max(done, key=lambda r: len(r["req"].out))
    picked.setdefault(longest["key"], longest)
    if cell.get("premise", {}).get("min", {}).get("evicted_pages"):
        most = max(done, key=lambda r: r["evicted"])
        picked.setdefault(most["key"], most)
    return [picked[k] for k in sorted(picked)]


def moe_wave(rec: dict):
    """(prompts, events, served) of the first complete wave, or None."""
    for wave in rec["waves"]:
        if not wave["complete"]:
            continue
        prompts = {r["rid"]: wave["prompts"][r["rid"]] for r in wave["requests"]}
        events: List[tuple] = [("admit", rid) for rid in sorted(prompts)]
        for tokens, req_ids in wave["steps"]:
            t, q = tokens.cpu().view(-1).tolist(), req_ids.cpu().view(-1).tolist()
            events.append(("step", [(rid, tok) for rid, tok in zip(q, t) if rid >= 0], len(q)))
        return prompts, events, wave["out"]
    return None


def _gap(lg: torch.Tensor, token: int) -> float:
    return float(lg.max() - lg[token])


def dense_gaps(model: dict, params, items: List[dict], control: bool = False) -> Dict[str, list]:
    """{"program": [gap a served token], "control": [gap of the fp8
    reference's first choice]} over the checked requests."""
    ref = Reference(model, params)
    ctl = Reference(model, params, quant="fp8") if control else None
    out: Dict[str, list] = {"program": [], "control": []}
    for r in items:
        prompt, served = r["prompt"], list(r["req"].out)
        toks = torch.as_tensor(prompt + served[:-1], device=ref.device)
        lg = ref.forward(toks)[len(prompt) - 1:]
        idx = torch.arange(len(served), device=ref.device)
        best = lg.max(-1).values
        out["program"] += (best - lg[idx, torch.as_tensor(served, device=ref.device)]).tolist()
        if ctl is not None:
            choice = ctl.forward(toks)[len(prompt) - 1:].argmax(-1)
            out["control"] += (best - lg[idx, choice]).tolist()
    return out


def moe_gaps(model: dict, params, wave, control: bool = False) -> Dict[str, list]:
    """Over the whole wave; ``params`` is consumed (the float32 reference
    and its caches need the room of the bf16 weights)."""
    prompts, events, served = wave
    choice = None
    if control:
        ctl = Reference(model, params, quant="fp8")
        choice = ctl.replay(prompts, events, lambda rid, k, lg: int(lg.argmax()))
        del ctl
    ref = Reference(model, params, consume=True)
    got = ref.replay(prompts, events, lambda rid, k, lg: (
        _gap(lg, served[rid][k]), _gap(lg, choice[rid][k]) if choice is not None else None))
    out: Dict[str, list] = {"program": [], "control": []}
    for rid in sorted(got):
        for g, c in got[rid]:
            out["program"].append(g)
            if c is not None:
                out["control"].append(c)
    return out


def checked_gaps(run, ctx, control: bool = False):
    """(gaps, facts about what was checked) of a finished run."""
    rec, model = run.rec, ctx.model
    if model.get("moe"):
        wave = moe_wave(rec)
        if wave is None:
            return None, {"reason": "no complete wave in the window"}
        params, run.params = run.params, None
        gaps = moe_gaps(model, params, wave, control)
        return gaps, {"requests": len(wave[0]), "tokens": len(gaps["program"])}
    items = dense_sample(rec, ctx.cell, ctx.seed)
    if not items:
        return None, {"reason": "no finished request"}
    gaps = dense_gaps(model, run.params, items, control)
    return gaps, {"requests": len(items), "tokens": len(gaps["program"]),
                  "evicted_requests": sum(r["evicted"] > 0 for r in items),
                  "crossed_compaction": sum(r.get("compactions_at_done", 0) > r["compactions_at_admit"]
                                            for r in items)}
