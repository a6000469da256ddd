"""The engine's own measurements, as a reader sees them: the host ranges
``TieredEngine`` opens under a profiler (``engine.<phase>``, ``model.moe``)
and its counters (``TieredEngine.counters``: host nanoseconds of policy,
dispatch and read-back, bytes the tiers move, pages of demand).

Plain functions over a profile's events and over the counters' deltas in a
window, so that a CPU test reaches each of them:

- ``device_ops`` drops the profiler's own device-side annotations (events
  with ``is_user_annotation``) as well as the harness's ``bench.*`` ranges;
- ``idle_by_span`` puts every between-op idle interval down to the
  innermost host range covering each part of it (a sweep), ``harness
  loop`` for the parts no range covers;
- the counter readers return None where the program has no counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchkit.trace import SPAN_LABEL

OUTSIDE = "harness loop"
POLICY_PHASES = ("engine.compact", "engine.residency", "engine.promote", "engine.schedule", "engine.bookkeeping")
HOST_PREFIXES = ("bench.", "engine.", "model.")


def device_ops(events) -> list:
    """The device ops among a profile's events."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and not e.name.startswith("bench.")]


def host_spans(events) -> List[Tuple[float, float, str]]:
    """(start, end, label) of the harness's and the program's host ranges;
    a ``bench.*`` range reads as its ``SPAN_LABEL`` text, a program range as
    its own name."""
    return [(e.time_range.start, e.time_range.end, SPAN_LABEL.get(e.name, e.name)) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(HOST_PREFIXES)]


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle intervals between device ops (none before the first op or
    after the last)."""
    m = merged(busy)
    return [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)]


def innermost(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Disjoint sorted (start, end, label) segments: at each instant, the
    label of the latest-started range still open (host ranges of one thread
    nest, so that is the innermost)."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []  # (end, label), innermost last
    t = None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, label = stack.pop()
            if end > t:
                out.append((t, end, label))
                t = end

    for a, b, label in sorted(spans, key=lambda s: (s[0], -s[1])):
        if t is not None:
            close_until(a)
            if stack and a > t:
                out.append((t, a, stack[-1][1]))
        t = a if t is None else max(t, a)
        stack.append((b, label))
    if stack:
        close_until(float("inf"))
    return out


def idle_by_span(busy: Sequence[Tuple[float, float]], spans: Sequence[Tuple[float, float, str]],
                 scale: float = 1e-6) -> Dict[str, float]:
    """Every between-op idle interval of ``busy`` split over the innermost
    host range covering each part of it, ``OUTSIDE`` for the rest; values
    are in the intervals' unit times ``scale`` (microseconds to seconds by
    default) and sum to the whole between-op idle."""
    segs = innermost(spans)
    out: Dict[str, float] = {}
    j = 0
    for g0, g1 in gaps(busy):
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, label = segs[k]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                out[label] = out.get(label, 0.0) + part * scale
                covered += part
            k += 1
        if g1 - g0 > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - covered) * scale
    return out


def label_at(segs: Sequence[Tuple[float, float, str]], t: float) -> str:
    """The innermost range open at ``t`` (``innermost``'s segments)."""
    for a, b, label in segs:
        if a <= t < b:
            return label
    return OUTSIDE


def idle_in_policy_share(idle: Dict[str, float]) -> Optional[float]:
    """Idle under the engine's policy phases over all between-op idle, %."""
    total = sum(idle.values())
    return sum(idle.get(p, 0.0) for p in POLICY_PHASES) / total * 100 if total > 0 else None


# ---- counters (window deltas of ServeStats and TieredEngine.counters) ----

def counters(eng) -> Dict[str, int]:
    """The engine's counters, or {} for a program without them."""
    c = getattr(eng, "counters", None)
    return dict(vars(c)) if c is not None else {}


def per_step_ms(d: Dict[str, int], key: str) -> Optional[float]:
    """Nanoseconds of ``key`` over the window's decoding steps, in ms."""
    return d[key] / d["steps"] / 1e6 if key in d and d.get("steps") else None


def host_tier_bytes_per_token(d: Dict[str, int]) -> Optional[float]:
    """Bytes promoted out of and flushed into the host tier a decoded token."""
    if "promoted_bytes" not in d or not d.get("decoded_tokens"):
        return None
    return (d["promoted_bytes"] + d["flushed_host_bytes"]) / d["decoded_tokens"]


def pool_demand_ratio(d: Dict[str, int], n_hbm_pages: int) -> Optional[float]:
    """Pages active requests need a decoding step over the fast pool's pages."""
    return d["demand_pages"] / (d["steps"] * n_hbm_pages) if "demand_pages" in d and d.get("steps") else None
