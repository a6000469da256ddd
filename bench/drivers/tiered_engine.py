"""Driver of ``repro_torch.serving.engine.TieredEngine``: the entry that the
chat and batch cells time, through its public ``add_request`` (admission,
the batch-1 prefill on the flash kernel, the first token read from the
card) and ``step`` (residency check, parking, promotion, the CFS batch, the
decode step of ``core/tiering.build_paged_decode_step``, compaction).

Open loop (``poisson`` mixes): one engine for the run; before each step
every request now due is admitted, in order; a step runs when a request is
live, else the loop sleeps to the next arrival. Waves: a fresh engine a
wave (built inside the window, as a batch job pays for it), the wave's
requests admitted at its start, steps until all are done; the previous
wave's engine is released first.

The record this returns holds host times (seconds from the window's start)
of every admission, token and step, the engine's counters at the window's
edges, and what the plain reference needs after the window: the prompts and
served tokens, and (where the family's ``replays_batches`` says so, as for
an MoE) each decode step's rows in the program's order, kept at the step
function's boundary. The configuration's family gives the program's
configuration, the weights' layout and each step's model FLOPs.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import torch

from benchkit import traffic
from benchkit.trace import Tracer, ranged

TRACE_ADMITS = 3  # admissions in a traced slice
TRACE_STEPS = 30  # decoding steps in a traced slice


def kv_config(cell: dict, max_requests: int):
    from repro_torch.core.tiering import TieredKVConfig

    return TieredKVConfig(max_requests=max_requests, **cell["kv"])


def _stats(eng) -> Dict[str, int]:
    return dict(vars(eng.stats))


def _clock() -> float:
    return time.perf_counter()


class Run:
    """One run of one cell. ``wrap_step(engine)``, a test hook, may replace
    the engine's step function (faults planted under the timed path)."""

    def __init__(self, ctx):
        from repro_torch.core import tiering
        from repro_torch.models import dense
        from repro_torch.models.api import ModelSpec
        from repro_torch.serving.engine import Request, TieredEngine

        self.ctx = ctx
        self.cell, self.mix, self.model = ctx.cell, ctx.mix, ctx.model
        self.device = torch.device(ctx.device)
        self.family = ctx.family
        self.spec = ModelSpec(self.family.program_config(ctx.config_name, self.model))
        self.Request, self.TieredEngine = Request, TieredEngine
        self.tiering, self.dense = tiering, dense
        self.replay = self.family.replays_batches(self.model)
        self.tracer = Tracer(self.device) if ctx.trace else None
        self.rec: dict = {"requests": [], "steps": [], "waves": [], "traced_steps": [], "traced_admits": []}

    # ---- set-up ----
    def setup(self, params, longest: int):
        """Warm every shape the cell uses: one prefill at the mix's longest
        prompt, a full batch, and decode steps past one compaction."""
        kv = kv_config(self.cell, max_requests=self.cell["kv"]["batch"])
        per_req = kv.max_pages_per_req
        kv = dataclasses.replace(kv, n_hbm_pages=max(kv.n_hbm_pages, kv.batch * 2))
        warm = self.TieredEngine(self.spec, params, kv, device=self.device)
        n_steps = kv.log_slots // kv.batch + 2
        for rid in range(kv.batch):
            n = min(longest, per_req * kv.page_size - n_steps - 1) if rid == 0 else 16
            warm.add_request(self.Request(rid=rid, prompt=[1] * n, max_new_tokens=n_steps))
        for _ in range(4 * n_steps):
            warm.step()
            if all(r.done for r in warm.requests.values()):
                break
        self._sync()
        del warm
        gc.collect()
        if self.tracer is not None:
            self.tracer.warm()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the engine's boundaries ----
    def engine(self, params, max_requests: int):
        eng = self.TieredEngine(self.spec, params, kv_config(self.cell, max_requests), device=self.device)
        steps: List[tuple] = []
        inner = eng.step_fn

        def step_fn(p, state, tokens, req_ids):
            nxt, state = inner(p, state, tokens, req_ids)
            if self.replay:  # device tensors, no read of the card: the reference replays these batches
                steps.append((tokens, req_ids))
            return nxt, state

        eng.step_fn = step_fn
        if self.tracer is not None:
            eng.step_fn = ranged("bench.decode", eng.step_fn)
        if self.ctx.wrap_step is not None:
            self.ctx.wrap_step(eng)
        eng.bench_steps = steps
        return eng

    def instrument(self):
        """Profiler ranges around the module attributes the engine and the
        decode step call (trace runs only)."""
        if self.tracer is None:
            return
        t, d = self.tiering, self.dense
        self._restore = [(t, "copy_pages", t.copy_pages), (t, "compact_log", t.compact_log),
                         (d, "moe_ffn", d.moe_ffn)]
        t.copy_pages = ranged("bench.copy_pages", t.copy_pages)
        t.compact_log = ranged("bench.compact_log", t.compact_log)
        d.moe_ffn = ranged("bench.moe", d.moe_ffn)

    def uninstrument(self):
        for mod, name, fn in getattr(self, "_restore", []):
            setattr(mod, name, fn)

    def admit(self, eng, rid: int, arrival, origin: float, in_trace: bool) -> dict:
        r = {"key": len(self.rec["requests"]), "rid": rid, "due": arrival.due, "prompt": arrival.prompt,
             "max_new": arrival.max_new_tokens, "tokens": [], "failed": False, "evicted": 0,
             "compactions_at_admit": eng.stats.compactions, "traced": in_trace}
        req = self.Request(rid=rid, prompt=arrival.prompt, max_new_tokens=arrival.max_new_tokens)
        r["start"] = _clock() - origin
        try:
            if self.tracer is not None:
                with torch.profiler.record_function("bench.admit"):
                    eng.add_request(req)
            else:
                eng.add_request(req)
        except (ValueError, RuntimeError) as e:
            r["failed"], r["error"] = True, f"{type(e).__name__}: {e}"
        r["end"] = _clock() - origin
        if in_trace and not r["failed"]:
            self.rec["traced_admits"].append(len(arrival.prompt))
        if not r["failed"]:
            r["tokens"].append(r["end"])
            r["req"] = req
        self.rec["requests"].append(r)
        return r

    def step(self, eng, live: Dict[int, dict], origin: float, in_trace: bool) -> int:
        """One ``step``; stamps the tokens it emitted; returns rows decoded."""
        rids = list(live)
        before = eng.page_table[rids] >= 0
        n0 = {rid: len(live[rid]["req"].out) for rid in rids}
        t0 = _clock()
        if self.tracer is not None:
            with torch.profiler.record_function("bench.step"):
                eng.step()
        else:
            eng.step()
        t1 = _clock()
        evicted = (before & ~(eng.page_table[rids] >= 0)).sum(1)
        page = eng.kv.page_size
        demand = int(((eng.lengths[rids] + page - 1) // page).sum())
        self.rec["peak_live_pages"] = max(self.rec.get("peak_live_pages", 0), demand)
        contexts, paged = [], []
        for i, rid in enumerate(rids):
            r = live[rid]
            r["evicted"] += int(evicted[i])
            if len(r["req"].out) > n0[rid]:
                r["tokens"].append(t1 - origin)
                contexts.append(int(eng.lengths[rid]))  # positions attended, the new one included
                paged.append(int(eng.compacted[rid]))
            if r["req"].done:
                r["compactions_at_done"] = eng.stats.compactions
                del live[rid]
        rows = len(contexts)
        self.rec["steps"].append({"t0": t0 - origin, "t1": t1 - origin, "rows": rows,
                                  "flops": self.family.decode_flops(self.model, contexts), "traced": in_trace})
        if in_trace and rows:
            self.rec["traced_steps"].append({"rows": list(zip(contexts, paged)),
                                             "log_rows": int(eng.state["log_tail"])})
        return rows

    # ---- the loops ----
    def open_loop(self, params, seed: int, seconds: float):
        arrivals = traffic.open_loop(self.mix, self.cell, seed, seconds, self.model["vocab"])
        eng = self.engine(params, max_requests=len(arrivals) + 1)
        self.instrument()
        ramp = self.cell["ramp_s"]
        origin = self.rec["origin"] = _clock() + ramp
        end = origin + seconds
        live: Dict[int, dict] = {}
        i = 0
        win_stats = None
        trace_at = seconds / 2
        traced_admits = traced_steps = 0
        piece = None
        while True:
            now = _clock()
            if win_stats is None and now >= origin:
                win_stats = _stats(eng)
            if now >= end:
                break
            if "live_mid" not in self.rec and now >= origin + seconds / 2:
                self.rec["live_mid"] = len(live)
            if self.tracer is not None and piece is None and traced_admits == 0 and i < len(arrivals) \
                    and arrivals[i].due >= trace_at and now >= origin + arrivals[i].due:
                piece = self.tracer.piece()
                piece.__enter__()
            while i < len(arrivals) and origin + arrivals[i].due <= _clock() < end:
                if win_stats is None and _clock() >= origin:
                    win_stats = _stats(eng)
                r = self.admit(eng, i, arrivals[i], origin, piece is not None)
                if not r["failed"]:
                    live[i] = r
                traced_admits += piece is not None
                i += 1
            if win_stats is None and _clock() >= origin:
                win_stats = _stats(eng)
            if live and _clock() < end:
                rows = self.step(eng, live, origin, piece is not None)
                traced_steps += piece is not None and rows > 0
            elif i < len(arrivals):
                time.sleep(max(0.0, min(end, origin + arrivals[i].due) - _clock()))
            if piece is not None and traced_admits >= TRACE_ADMITS and traced_steps >= TRACE_STEPS:
                piece.__exit__(None, None, None)
                piece = None
                traced_admits = -1  # one slice a run
        if piece is not None:
            piece.__exit__(None, None, None)
        self._sync()
        self.rec["window_stats"] = (win_stats or _stats(eng), _stats(eng))
        self.rec["live_end"] = len(live)
        self.rec["unadmitted"] = [a.due for a in arrivals[i:] if 0 <= a.due < seconds]
        self.rec["kv"] = vars(eng.kv)
        self.eng = eng
        self.uninstrument()

    def waves(self, params, seed: int, seconds: float):
        self.instrument()
        origin = self.rec["origin"] = _clock()
        end = origin + seconds
        w = 0
        totals = {k: 0 for k in _stats_keys()}
        while _clock() < end:
            arrivals = traffic.wave(self.mix, seed, w, self.model["vocab"])
            t_build = _clock()
            with torch.profiler.record_function("bench.engine"):
                eng = self.engine(params, max_requests=len(arrivals))
            wave = {"index": w, "start": t_build - origin, "requests": [], "complete": False,
                    "first_step": len(self.rec["steps"])}
            trace_wave = self.tracer is not None and w == 1
            live: Dict[int, dict] = {}
            piece = self.tracer.piece() if trace_wave else None
            if piece is not None:
                piece.__enter__()
            for j, a in enumerate(arrivals):
                if _clock() >= end:
                    break
                a = traffic.Arrival(_clock() - origin, a.prompt, a.max_new_tokens)
                r = self.admit(eng, j, a, origin, piece is not None)
                wave["requests"].append(r)
                if not r["failed"]:
                    live[j] = r
                if piece is not None and j + 1 >= TRACE_ADMITS:
                    piece.__exit__(None, None, None)
                    piece = None
            traced_steps = 0
            while live and _clock() < end:
                full = trace_wave and traced_steps == 0 and piece is None and \
                    min(len(live), eng.kv.batch) == eng.kv.batch and self._ready_full(eng)
                if full:
                    piece = self.tracer.piece()
                    piece.__enter__()
                rows = self.step(eng, live, origin, piece is not None)
                if piece is not None and rows:
                    traced_steps += 1
                    if traced_steps >= TRACE_STEPS:
                        piece.__exit__(None, None, None)
                        piece = None
                        trace_wave = False
            if piece is not None:
                piece.__exit__(None, None, None)
            self._sync()
            wave["end"], wave["last_step"] = _clock() - origin, len(self.rec["steps"])
            wave["complete"] = not live and len(wave["requests"]) == len(arrivals)
            for k, v in _stats(eng).items():
                totals[k] += v
            wave["prompts"] = [a.prompt for a in arrivals]
            wave["steps"] = list(eng.bench_steps)  # device tensors, read after the window
            wave["out"] = {r["rid"]: list(r["req"].out) for r in wave["requests"] if not r["failed"]}
            self.rec["waves"].append(wave)
            del eng, live
            gc.collect()
            w += 1
        self.rec["window_stats"] = ({k: 0 for k in totals}, totals)
        self.rec["kv"] = vars(kv_config(self.cell, self.mix["wave_size"]))
        self.uninstrument()

    def free(self):
        """Release the program's device state (before the reference runs)."""
        self.eng = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def _ready_full(eng) -> bool:
        """Whether every one of the next batch's rows would have its pages
        (a steady, full decode step)."""
        ready = 0
        for r in eng.requests.values():
            if r.done:
                continue
            n = -(-int(eng.compacted[r.rid]) // eng.kv.page_size)
            if all(eng.page_table[r.rid, :n] >= 0):
                ready += 1
        return ready >= eng.kv.batch


def _stats_keys():
    from repro_torch.serving.engine import ServeStats

    return list(vars(ServeStats()))


def waves_seen(view):
    """Each wave's start and end (seconds from the window's start), its
    tokens inside the window, its decoding steps and their mean time: where
    the window's close cut the last wave, and how fast the host stepped."""
    out = []
    for w in view.rec["waves"]:
        steps = [s for s in view.rec["steps"][w["first_step"]:w["last_step"]] if s["rows"]]
        out.append({"start": w["start"], "end": w["end"], "complete": w["complete"],
                    "tokens": sum(sum(1 for t in r["tokens"] if view.in_window(t)) for r in w["requests"]),
                    "steps": len(steps),
                    "step_ms": sum(s["t1"] - s["t0"] for s in steps) / len(steps) * 1e3 if steps else None})
    return out


def attempted(view):
    """(requests attempted, failed): those due in the window (open loop) or
    admitted in it (waves)."""
    rs = view.window_requests()
    return len(rs) + len(view.rec.get("unadmitted", [])), sum(r["failed"] for r in rs)


def drive(ctx) -> Run:
    """Weights from the seed, set-up, the window. The returned ``Run``
    holds the record and the weights; ``free()`` releases the engine."""
    from benchkit import weights

    run = Run(ctx)
    run.params = weights.draw(ctx.family.layout(ctx.model), ctx.seed, run.device)
    run.setup(run.params, traffic.longest_prompt(ctx.mix))
    gc.collect()
    gc.disable()  # no collector pauses inside the ramp and the window
    try:
        if ctx.mix["arrivals"] == "waves":
            run.waves(run.params, ctx.seed, ctx.seconds)
        else:
            run.open_loop(run.params, ctx.seed, ctx.seconds)
    finally:
        gc.enable()
    return run
