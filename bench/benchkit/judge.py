"""The comparison that decides ``correct``.

What is compared is what the timed path served: once the window has closed
and the program's state is freed, the configuration's family
(``families/<family>.py``: ``checked_gaps``) runs its plain reference over
the checked requests' prompts with the tokens the program served, and at
every served token reads how far that token's logit lies below its best:
the widest such gap over all checked tokens (or, where the cell's ``check``
names ``gap_statistic`` "mean", their mean) is held to the cell's limit.
Greedy tokens of a bf16 program lie within rounding of the best; a program
that computes wrong, or a step that serves a wrong token, does not.

The control (``control.py``) asks the family for the tokens its reference
ranks first in the precision below the configuration's, at each of the same
positions, and holds those to the same rules (``verdict``).
"""
from __future__ import annotations

from typing import Dict, List


def window_deltas(rec: dict) -> Dict[str, int]:
    a, b = rec["window_stats"]
    return {k: b[k] - a[k] for k in b}


def checked_gaps(run, ctx, control: bool = False):
    """(gaps, facts about what was checked) of a finished run: the family's
    comparison (``families/<family>.py``). ``gaps`` is {"program": [gap of
    each checked token], "control": [gap of the control's choice at each]}
    or None, with the reason in ``facts``; ``facts["tokens"]`` counts the
    checked tokens."""
    return ctx.family.checked_gaps(run, ctx, control)


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
