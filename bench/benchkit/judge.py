"""The comparison that decides ``correct``.

What is compared is what the timed path served: once the window has closed
and the program's state is freed, the plain reference (``reference.py``,
float32) runs over each checked request's prompt with the tokens the
program served, and at every served token reads how far that token's logit
lies below its best: the widest such gap over all checked tokens (or, where
the cell's ``check`` names ``gap_statistic`` "mean", their mean) is held to
the cell's limit. Greedy tokens of a bf16 program lie within rounding of the
best; a program that computes wrong, or a step that serves a wrong token,
does not.

Which requests: for a dense FFN a sample of the finished requests drawn from
the seed, the longest among them, and (where the cell's premise needs
evictions) the most evicted one, each by one causal forward. For an MoE the
whole first complete wave, replayed over the program's own decode batches,
because a pair's capacity drop depends on the rows beside it.

The control (``control.py``) runs the same reference in fp8, puts the
token it ranks first at each of the same positions in place of the served
one, and holds those to the same rules (``verdict``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchkit.reference import Reference


def window_deltas(rec: dict) -> Dict[str, int]:
    a, b = rec["window_stats"]
    return {k: b[k] - a[k] for k in b}


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


def statistics(gaps: List[float]) -> Dict[str, float]:
    """The numbers a cell may hold its gaps to: the widest, the mean, and
    the share of tokens that are not the reference's first choice."""
    return {"widest": max(gaps), "mean": sum(gaps) / len(gaps), "share_off": sum(g > 0 for g in gaps) / len(gaps)}


def rule(value, limit, op: str) -> dict:
    ok = value <= limit if op == "<=" else value >= limit
    return {"value": value, "limit": limit, "rule": op, "ok": bool(ok)}


def premise_checks(run, ctx, failed: int) -> Dict[str, dict]:
    """No request failed, and the window's counters hold the cell's premise."""
    checks: Dict[str, dict] = {"failed": rule(failed, 0, "<=")}
    deltas = window_deltas(run.rec)
    premise = ctx.cell.get("premise", {})
    for k, v in premise.get("min", {}).items():
        checks[k] = rule(deltas[k], v, ">=")
    for k, v in premise.get("max", {}).items():
        checks[k] = rule(deltas[k], v, "<=")
    return checks


def verdict(ctx, checks: Dict[str, dict], gaps, facts: dict) -> (bool, Dict[str, dict]):
    """``checks`` with the rules on ``gaps`` (the gap of each judged token:
    the served ones, or in the control the fp8 reference's first choices)
    and on what was checked; ``correct`` is that every rule holds."""
    checks = dict(checks)
    if gaps is None:
        checks["checked_tokens"] = rule(0, 1, ">=")
    else:
        stat = ctx.cell["check"].get("gap_statistic", "widest")
        checks[f"gap_{stat}"] = rule(statistics(gaps)[stat], ctx.cell["check"]["gap_limit"], "<=")
        checks["checked_tokens"] = rule(facts["tokens"], ctx.cell["check"]["min_tokens"], ">=")
        if ctx.cell.get("premise", {}).get("min", {}).get("evicted_pages"):
            checks["checked_evicted_requests"] = rule(facts["evicted_requests"], 1, ">=")
            checks["checked_across_compaction"] = rule(facts["crossed_compaction"], 1, ">=")
    return all(c["ok"] for c in checks.values()), checks


def judge(run, ctx, failed: int) -> (bool, Dict[str, dict]):
    """``correct`` and the numbers compared, each with its limit."""
    gaps, facts = checked_gaps(run, ctx)
    return verdict(ctx, premise_checks(run, ctx, failed), gaps and gaps["program"], facts)
