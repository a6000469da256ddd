"""The arithmetic of the metric readers (``bench/metrics/<name>.py`` each
call one of these with its own arguments). A reader that finds nothing to
read returns None, and the metric is left out of the line."""
from __future__ import annotations

from typing import Optional

from benchkit.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from benchkit.judge import window_deltas


def _percentile(values, q):
    """Linear between the order statistics (numpy's default), an infinite
    one (a failed request) giving infinity."""
    if not values:
        return None
    v = sorted(values)
    at = q / 100 * (len(v) - 1)
    lo, frac = int(at), at - int(at)
    if frac == 0 or v[lo] == float("inf"):
        return float(v[lo])
    hi = v[lo + 1]
    return float("inf") if hi == float("inf") else float(v[lo] + (hi - v[lo]) * frac)


def setup_s(view) -> float:
    return view.rec["setup_s"]


def ttft_ms(view, q: float) -> Optional[float]:
    """Time from due to first token over every request due in the window;
    one without a first token by the window's end counts its wait so far,
    one that failed counts as infinite."""
    vals = []
    for r in view.window_requests():
        if r["failed"]:
            vals.append(float("inf"))
        elif r["tokens"]:
            vals.append(r["tokens"][0] - r["due"])
        else:
            vals.append(view.seconds - r["due"])
    for r in view.rec.get("unadmitted", []):
        vals.append(view.seconds - r)
    v = _percentile(vals, q)
    return None if v is None else v * 1e3


def tokens_per_s(view) -> float:
    n = sum(sum(1 for t in r["tokens"] if view.in_window(t)) for r in view.rec["requests"])
    return n / view.seconds


def _window_admits(view):
    return [r for r in view.window_requests() if not r["failed"] and not r["traced"] and view.in_window(r["start"])]


def admit_wait_ms(view) -> Optional[float]:
    rs = _window_admits(view)
    return sum(r["start"] - r["due"] for r in rs) / len(rs) * 1e3 if rs else None


def prefill_ms(view) -> Optional[float]:
    rs = _window_admits(view)
    return sum(r["end"] - r["start"] for r in rs) / len(rs) * 1e3 if rs else None


def per_token(view, counter: str) -> Optional[float]:
    d = window_deltas(view.rec)
    return d[counter] / d["decoded_tokens"] if d["decoded_tokens"] else None


def coalesce_ratio(view) -> Optional[float]:
    d = window_deltas(view.rec)
    return d["flushed_tokens"] / d["flushed_pages"] if d["flushed_pages"] else None


def _untraced_steps(view):
    return [s for s in view.rec["steps"] if view.in_window(s["t0"]) and not s["traced"]]


def decode_step_ms(view) -> Optional[float]:
    """Time inside ``step`` over the window's decoding steps."""
    steps = _untraced_steps(view)
    n = sum(1 for s in steps if s["rows"])
    return sum(s["t1"] - s["t0"] for s in steps) / n * 1e3 if n else None


def step_mfu(view) -> Optional[float]:
    """Model FLOPs of the decoding steps over their wall time x the bf16 peak, %."""
    steps = [s for s in _untraced_steps(view) if s["rows"]]
    t = sum(s["t1"] - s["t0"] for s in steps)
    return sum(s["flops"] for s in steps) / (t * PEAK_BF16_FLOPS) * 100 if t > 0 else None


def idle_share(view) -> Optional[float]:
    s = view.summary
    return (1 - s["busy_s"] / s["window_s"]) * 100 if s and s["window_s"] > 0 and s["busy_s"] > 0 else None


def span_share(view, *spans: str) -> Optional[float]:
    s = view.summary
    if not s or s["busy_s"] <= 0:
        return None
    t = sum(s["spans"].get(name, 0.0) for name in spans)
    return t / s["busy_s"] * 100 if t > 0 else None


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


def paged_roofline(view) -> Optional[float]:
    """None where the traced slice holds no decoding step with paged
    attention's kernels (a batch run whose window closed before wave 1's
    first full batch, say)."""
    s, steps = view.summary, view.rec["traced_steps"]
    if not s or not steps or s["kernels"].get("paged_attention", 0) <= 0:
        return None
    rl = view.roofline("paged_attention")
    page = view.cell["kv"]["page_size"]
    least = sum(bound_s(*rl.bytes_flops(view.model, st["rows"], st["log_rows"], page)) for st in steps)
    calls = view.family.attention_calls(view.model)["paged_attention"]  # a decode step's
    return least * calls / s["kernels"]["paged_attention"] * 100


def flash_roofline(view) -> Optional[float]:
    s, admits = view.summary, view.rec["traced_admits"]
    if not s or not admits or s["kernels"].get("flash_attention", 0) <= 0:
        return None
    rl = view.roofline("flash_attention")
    least = sum(bound_s(*rl.bytes_flops(view.model, S)) for S in admits)
    calls = view.family.attention_calls(view.model)["flash_attention"]  # a prefill's
    return least * calls / s["kernels"]["flash_attention"] * 100
