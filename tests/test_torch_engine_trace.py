"""The port TieredEngine's own measurements on the CPU, under pool pressure
(evictions, parks, promotions and compactions): the counters of
``eng.counters`` against recounts of what the tiers moved, the host-time
split against the wall time of ``step``, and the ``engine.*`` /
``model.moe`` profiler ranges (nested in order under a profiler, never
opened without one, and changing no token or ServeStats counter)."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.core import tiering
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.models import dense
from repro_torch.models.api import ModelSpec
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Request, TieredEngine

KV = TieredKVConfig(page_size=8, n_hbm_pages=12, max_requests=4, max_pages_per_req=12, log_slots=16, batch=2,
                    promote_pages_per_step=2)
PROMPTS = {0: list(range(7, 27)), 1: list(range(40, 75)), 2: list(range(5, 18)), 3: list(range(90, 120))}
N_NEW = 20
STEP_PHASES = ["engine.compact", "engine.residency", "engine.promote", "engine.schedule", "engine.decode",
               "engine.readback", "engine.bookkeeping"]
ADMIT_PHASES = ["engine.prefill", "engine.place", "engine.first_token"]


def make_engine(arch="qwen3-1.7b"):
    spec = ModelSpec(configs.get_reduced(arch))
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    return TieredEngine(spec, params, KV, device="cpu")


def admit_all(eng):
    for rid, p in PROMPTS.items():
        eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=N_NEW))


def row_bytes(cfg):
    """One position's K and V over every layer, bf16."""
    return cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2


def test_counters_match_recounts_of_what_the_tiers_moved(monkeypatch):
    eng = make_engine()
    copied, flushed_rows = [], []
    copy_pages, compact_log = tiering.copy_pages, tiering.compact_log

    def counting_copy(dst_k, dst_v, src_k, src_v, pairs):
        copied.extend(pairs)
        return copy_pages(dst_k, dst_v, src_k, src_v, pairs)

    def counting_compact(kv, state, flush_hbm, flush_host):
        # the rows the kernel writes into the host tier: distinct logged (request, position)s
        flushed_rows.append(len({(o, p) for o, p in state["log_meta"].tolist() if o >= 0 and p >= 0}))
        return compact_log(kv, state, flush_hbm, flush_host)

    monkeypatch.setattr(tiering, "copy_pages", counting_copy)
    monkeypatch.setattr(tiering, "compact_log", counting_compact)
    admit_all(eng)
    demand, wall_ns = 0, 0
    while not all(r.done for r in eng.requests.values()):
        active = [r.rid for r in eng.requests.values() if not r.done]
        steps = eng.stats.steps
        t0 = time.perf_counter_ns()
        eng.step()
        wall_ns += time.perf_counter_ns() - t0
        if eng.stats.steps > steps:  # a decoding step: pages below each active request's watermark
            demand += sum(-(-int(eng.compacted[rid]) // KV.page_size) for rid in active)
    s, c = eng.stats, eng.counters
    assert s.evicted_pages > 0 and s.parks > 0 and s.compactions > 0
    page = row_bytes(eng.cfg) * KV.page_size
    assert c.promoted_bytes == s.promoted_pages * page == len(copied) * page
    assert c.flushed_host_bytes == sum(flushed_rows) * row_bytes(eng.cfg) == s.flushed_tokens * row_bytes(eng.cfg)
    assert c.demand_pages == demand
    timed = c.policy_ns + c.dispatch_ns + c.readback_ns
    assert 0.9 * wall_ns <= timed <= wall_ns
    assert c.dispatch_ns > 0 and c.readback_ns > 0 and c.policy_ns > 0


def _engine_ranges(prof):
    return sorted((e for e in prof.events() if e.name.startswith(("engine.", "model."))),
                  key=lambda e: (e.time_range.start, -e.time_range.end))


def _inside(outer, events):
    return [e for e in events if e is not outer and outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end]


def test_spans_nest_in_order_under_the_profiler():
    eng = make_engine()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        admit_all(eng)
        for _ in range(12):
            eng.step()
    ranges = _engine_ranges(prof)
    admits = [e for e in ranges if e.name == "engine.admit"]
    assert [e.kwinputs["args"] for e in admits] == [f"rid={rid}" for rid in PROMPTS]
    for a in admits:
        inner = _inside(a, ranges)
        assert [e.name for e in inner] == ADMIT_PHASES
        assert all(e.kwinputs["args"] == a.kwinputs["args"] for e in inner)
    steps = [e for e in ranges if e.name == "engine.step"]
    assert [e.kwinputs["args"] for e in steps] == [f"step={i}" for i in range(1, 13)]
    decoding = compacting = 0
    for st in steps:
        names = [e.name for e in _inside(st, ranges)]
        assert names == [p for p in STEP_PHASES if p in names], names
        assert names[names[0] == "engine.compact":][:3] == STEP_PHASES[1:4]
        decoding += names[-3:] == STEP_PHASES[-3:]
        compacting += names[0] == "engine.compact"
        assert all(e.kwinputs["args"] == st.kwinputs["args"] for e in _inside(st, ranges))
    assert decoding == eng.stats.steps and 0 < decoding < len(steps) and compacting > 0


class _Counting:
    """Stands in for a profiler range type and counts its constructions."""

    n = 0

    def __init__(self, *a, **kw):
        type(self).n += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_no_range_is_opened_without_a_profiler(monkeypatch, arch):
    class Fast(_Counting):
        n = 0

    class User(_Counting):
        n = 0

    monkeypatch.setattr(engine_mod, "_RecordFunctionFast", Fast)
    monkeypatch.setattr(dense, "_RecordFunctionFast", Fast)
    monkeypatch.setattr(torch.profiler, "record_function", User)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", User)
    eng = make_engine(arch)
    admit_all(eng)
    for _ in range(6):
        eng.step()
    assert Fast.n == 0 and User.n == 0 and eng.stats.steps > 0
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    assert Fast.n > 0 and User.n == 0  # the patched names are the ones the engine opens


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_the_profiler_changes_no_token_and_no_counter(arch):
    plain = make_engine(arch)
    admit_all(plain)
    plain.run(max_steps=2000)
    traced = make_engine(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        admit_all(traced)
        traced.run(max_steps=2000)
    assert any(e.name == "engine.step" for e in prof.events())
    assert arch != "olmoe-1b-7b" or any(e.name == "model.moe" for e in prof.events())
    assert {r: q.out for r, q in traced.requests.items()} == {r: q.out for r, q in plain.requests.items()}
    assert vars(traced.stats) == vars(plain.stats)
    c, d = vars(traced.counters), vars(plain.counters)
    assert {k: c[k] for k in c if not k.endswith("_ns")} == {k: d[k] for k in d if not k.endswith("_ns")}
