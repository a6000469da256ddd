"""The traced slices of a ``--trace 1`` run: torch.profiler pieces opened
and closed by the driver, read after the window closes.

Host spans are the harness's own ``record_function`` ranges, named
``bench.<span>``. From each piece: the union of device-op intervals
(busy), the device time by op name, the device time of the kernels of each
roofline file and of the ops launched inside each span, and the idle gaps
with the innermost span the host was in at the gap's middle.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch

SPAN_LABEL = {"bench.admit": "admission", "bench.step": "policy", "bench.decode": "decode",
              "bench.copy_pages": "tier copy", "bench.compact_log": "compaction", "bench.moe": "decode",
              "bench.engine": "engine build"}


def union(spans: Sequence[tuple]) -> float:
    """Length covered by (start, end) intervals, overlaps once."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(spans):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def ranged(name: str, fn):
    """``fn`` run inside the profiler range ``name``."""
    def run(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return run


class Tracer:
    """Profiler pieces of one run; ``piece()`` is a context manager."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pieces: List[tuple] = []  # (profile, wall seconds)
        self.active = False

    @contextlib.contextmanager
    def piece(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            self.active = True
            try:
                yield
            finally:
                self._sync()
                self.active = False
                wall = time.perf_counter() - t0
        self.pieces.append((prof, wall))

    def warm(self):
        """Start and stop the profiler once (its first start initialises the
        tracer, seconds that belong in set-up, not in the window)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=acts):
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def summary(self, kernel_groups: Dict[str, Sequence[str]]) -> Optional[dict]:
        """Seconds: ``window_s`` (the pieces' wall time), ``busy_s``,
        ``kernels`` {group: device s of ops whose name holds one of its
        names}, ``spans`` {span: device s of ops launched inside it},
        ``device_ops`` and ``idle_gaps`` (the ten largest)."""
        if not self.pieces:
            return None
        window = busy = 0.0
        by_op: Dict[str, float] = {}
        kernels = {g: 0.0 for g in kernel_groups}
        spans: Dict[str, float] = {}
        gaps: List[tuple] = []
        n_ops = 0
        for prof, wall in self.pieces:
            window += wall
            events = prof.events()
            # device ops; the ranges' own device-side annotations are not ops
            dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("bench.")]
            host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("bench.")]
            n_ops += len(dev)
            iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
            busy += union(iv) / 1e6
            for e in dev:
                s = e.time_range.elapsed_us() / 1e6
                by_op[e.name] = by_op.get(e.name, 0.0) + s
                for g, names in kernel_groups.items():
                    if any(n in e.name for n in names):
                        kernels[g] += s
            for e in host:
                spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total / 1e6
            end, piece_gaps = None, []
            for a, b in iv:
                if end is not None and a > end:
                    piece_gaps.append((a - end, (a + end) / 2))
                end = b if end is None else max(end, b)
            piece_gaps.sort(key=lambda g: -g[0])
            gaps += [(us, self._label(host, mid)) for us, mid in piece_gaps[:10]]
        gaps.sort(key=lambda g: -g[0])
        return {
            "window_s": window, "busy_s": busy, "device_op_count": n_ops, "kernels": kernels, "spans": spans,
            "device_ops": sorted(([n, s] for n, s in by_op.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": [[label, us / 1e6] for us, label in gaps[:10]],
        }

    @staticmethod
    def _label(host, t: float) -> str:
        inner = None
        for e in host:
            if e.time_range.start <= t <= e.time_range.end:
                if inner is None or e.time_range.start >= inner.time_range.start:
                    inner = e
        return SPAN_LABEL.get(inner.name, inner.name) if inner is not None else "harness loop"
