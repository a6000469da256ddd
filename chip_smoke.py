#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; so does a missing card):
  1. environment — the card's name and power limit; TF32 off for matmul
     and cuDNN.
  2. build — every kernel under src/repro_torch/csrc with nvcc (sm_90a).
  3. kernels — each kernel against its plain PyTorch version at the main
     path's full-width shapes, with times of kernel, plain version and a
     PyTorch library call, and the least time the card could take.
  4. serving — full-width qwen3-1.7b (random weights from a seed) through
     the port's TieredEngine: every kernel launched, ServeStats equal to the
     reduced-width run on the CPU, every emitted token within a near-tie
     tolerance of the maximum of the dense decode's teacher-forced logits;
     tokens/s of the tiered and the dense (baseline) serving loops; then a
     profiled window of decode steps (device busy time and idle share).

The line before the last is the card as nvidia-smi names it, the one
before that a JSON object with one entry per kernel, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

SEED = 0
PROMPT_LENS = [203, 251, 298, 339, 387, 429, 466, 517]  # none a multiple of 16
NEW_TOKENS = 48
NEAR_TIE = 0.125  # logits at full width reach ~4, where bf16 spacing is 1/32
TOL = {"paged_attention": 2e-2, "flash_attention": 3e-2, "kv_log_append": 0.0, "log_compact": 0.0}
REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:117",
    "log_compact": "src/repro/kernels/log_compact/kernel.py:86",
    "kv_log_append": "src/repro/kernels/kv_log_append/kernel.py:45",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:107",
}


@contextlib.contextmanager
def phase(name):
    print(f"[{name}] ...", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s", flush=True)
        raise
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f}s)", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean time of ``fn`` on the card (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(full):
    """Phase 3: each kernel vs its plain version at full-width shapes."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.kv_log_append.ops import kv_log_append
    from repro_torch.kernels.kv_log_append.ref import kv_log_append_ref
    from repro_torch.kernels.log_compact.ops import log_compact
    from repro_torch.kernels.log_compact.ref import log_compact_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention_pages, paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    H, KV, hd, L = full.n_heads, full.n_kv_heads, full.resolved_head_dim, full.n_layers
    g = H // KV
    page, B, S_log, P, N = 16, 4, 64, 96, 40
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    rows = {}

    # ---- paged attention: a decode step's read of one layer ----
    q = randn(B, H, hd)
    pool_k, pool_v = randn(P, page, KV, hd), randn(P, page, KV, hd)
    log_k, log_v = randn(S_log, KV, hd), randn(S_log, KV, hd)
    plen = torch.tensor([400, 496, 288, 0], dtype=torch.int32, device=dev)  # row 3 is padding
    n_log = [11, 9, 13, 0]
    req = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev).tolist()
    table = torch.full((B, N), -1, dtype=torch.int32)
    meta = torch.full((S_log, 2), -1, dtype=torch.int32)
    used, slot_iter = 0, iter(torch.randperm(S_log).tolist())
    for b in range(3):
        npg = -(-int(plen[b]) // page)
        table[b, :npg] = torch.tensor(perm[used:used + npg])
        used += npg
        for i in range(n_log[b]):  # positions past the watermark live in the log
            meta[next(slot_iter)] = torch.tensor([b, int(plen[b]) + i])
    table, meta = table.to(dev), meta.to(dev)
    lengths = plen + torch.tensor(n_log, dtype=torch.int32, device=dev)
    args = (q, pool_k, pool_v, table, lengths, log_k, log_v, meta)
    got = paged_decode_attention(*args, page_lengths=plen, req_ids=req)
    want = paged_decode_attention_ref(*args, page_lengths=plen, req_ids=req)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("paged attention: non-finite output (padded row?)")
    live = req >= 0
    err = (got[live].float() - want[live].float()).abs().max().item()
    if not torch.allclose(got[live].float(), want[live].float(), atol=TOL["paged_attention"], rtol=TOL["paged_attention"]):
        raise AssertionError(f"paged attention: max abs err {err}")
    gk = pool_k[table.clamp(min=0).long()].reshape(B, N * page, KV, hd).repeat_interleave(g, 2).transpose(1, 2)
    gv = pool_v[table.clamp(min=0).long()].reshape(B, N * page, KV, hd).repeat_interleave(g, 2).transpose(1, 2)
    mask = (torch.arange(N * page, device=dev)[None] < plen[:, None])[:, None, None, :]
    valid_tok = int(plen.sum())
    nbytes = 2 * valid_tok * KV * hd * 2 + 2 * q.numel() * 2 + table.numel() * 4 + B * 4
    rows["paged_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: paged_attention_pages(q, pool_k, pool_v, table, plen)),
        plain_ms=cuda_ms(lambda: paged_decode_attention_ref(q, pool_k, pool_v, table, plen)),
        library_ms=cuda_ms(lambda: sdpa(q[:, :, None], gk, gv, attn_mask=mask)),
        bound=bound_ms(nbytes, 4.0 * H * hd * valid_tok),
    )

    # ---- flash attention: one layer of a prefill at a ragged length ----
    S = 381
    fq, fk, fv = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
    got = flash_attention(fq, fk, fv, causal=True)
    want = flash_attention_ref(fq, fk, fv, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=TOL["flash_attention"], rtol=TOL["flash_attention"]):
        raise AssertionError(f"flash attention: max abs err {err}")
    qt = fq.transpose(1, 2)
    kt, vt = fk.repeat_interleave(g, 2).transpose(1, 2), fv.repeat_interleave(g, 2).transpose(1, 2)
    pairs = S * (S + 1) // 2
    rows["flash_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: flash_attention(fq, fk, fv, causal=True)),
        plain_ms=cuda_ms(lambda: flash_attention_ref(fq, fk, fv, causal=True)),
        library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
        bound=bound_ms(2 * (2 * fq.numel() + 2 * fk.numel()), 4.0 * H * hd * pairs),
    )

    # ---- kv log append: one layer of a decode step's write ----
    tail = 20
    base_k, base_v = randn(1, S_log, KV, hd), randn(1, S_log, KV, hd)
    k_new, v_new = randn(1, B, KV, hd), randn(1, B, KV, hd)
    pos = torch.tensor([411, 505, 301, -1], dtype=torch.int32, device=dev)
    outs = []
    for fn in (kv_log_append, kv_log_append_ref):
        lk, lv = base_k.clone(), base_v.clone()
        lm = torch.full((S_log, 2), -1, dtype=torch.int32, device=dev)
        fn(lk, lv, lm, tail, k_new, v_new, req, pos)
        outs.append((lk, lv, lm))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        if not torch.equal(a.view(torch.int16) if a.dtype == bf16 else a, b.view(torch.int16) if b.dtype == bf16 else b):
            raise AssertionError("kv_log_append: kernel and plain version differ")
    lk, lv, lm = outs[0]

    def library_append():
        lk[:, tail:tail + B].copy_(k_new)
        lv[:, tail:tail + B].copy_(v_new)

    rows["kv_log_append"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kv_log_append(lk, lv, lm, tail, k_new, v_new, req, pos)),
        plain_ms=cuda_ms(lambda: kv_log_append_ref(lk, lv, lm, tail, k_new, v_new, req, pos)),
        library_ms=cuda_ms(library_append),
        bound=bound_ms(2 * 2 * k_new.numel() * 2 + 4 * B * 4, 0.0),
    )

    # ---- log compaction: a full log of 4 requests into the fast pool ----
    ck, cv = randn(L, P, page, KV, hd), randn(L, P, page, KV, hd)
    lk, lv = randn(L, S_log, KV, hd), randn(L, S_log, KV, hd)
    starts = [405, 218, 333, 470]  # 16 tokens each, straddling two pages
    cmeta = torch.tensor([[r, starts[r] + i] for i in range(16) for r in range(4)], dtype=torch.int32)
    pages = sorted({(r, (starts[r] + i) // page) for r in range(4) for i in range(16)})
    targets = torch.tensor([[r, lp, perm[j]] for j, (r, lp) in enumerate(pages)], dtype=torch.int32)
    cmeta, targets = cmeta.to(dev), targets.to(dev)
    outs = []
    for fn in (log_compact, log_compact_ref):
        pk, pv = ck.clone(), cv.clone()
        fn(pk, pv, lk, lv, cmeta, targets)
        outs.append((pk, pv))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError("log_compact: kernel and plain version differ")
    pk, pv = outs[0]
    moved = L * S_log * KV * hd * 2 * 2  # every log row matches one target here
    rows["log_compact"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: log_compact(pk, pv, lk, lv, cmeta, targets)),
        plain_ms=cuda_ms(lambda: log_compact_ref(pk, pv, lk, lv, cmeta, targets)),
        library_ms=None,
        bound=bound_ms(2 * moved + cmeta.numel() * 4 + targets.numel() * 4, 0.0),
    )
    del ck, cv, pk, pv, outs
    torch.cuda.empty_cache()
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {name:16s} err {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return rows


def serve(full, reduced, card):
    """Phase 4: full-width qwen3-1.7b through the port's TieredEngine."""
    from repro_torch.core.tiering import TieredKVConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import baseline_serve, dense_decode
    from repro_torch.models.api import ModelSpec
    from repro_torch.serving.engine import Request, TieredEngine

    kv = TieredKVConfig(page_size=16, n_hbm_pages=96, max_requests=8, max_pages_per_req=40,
                        log_slots=64, batch=4, promote_pages_per_step=8)
    demand = sum(-(-(n + NEW_TOKENS) // kv.page_size) for n in PROMPT_LENS)
    print(f"  config {full.name}: {ModelSpec(full).param_count() / 1e9:.3f} B params; {kv}")
    print(f"  prompts {PROMPT_LENS} x {NEW_TOKENS} new tokens; page demand {demand} > fast pool {kv.n_hbm_pages}")
    rng = np.random.default_rng(SEED)
    prompts = {rid: [int(t) for t in rng.integers(1, full.vocab - 1, size=n)] for rid, n in enumerate(PROMPT_LENS)}

    def run_engine(spec, params, vocab, device):
        eng = TieredEngine(spec, params, kv, device=device)
        t0 = time.perf_counter()
        for rid, p in prompts.items():
            eng.add_request(Request(rid=rid, prompt=[t % vocab for t in p], max_new_tokens=NEW_TOKENS))
        stats = eng.run(max_steps=5000)
        if device == "cuda":
            torch.cuda.synchronize()
        return eng, stats, time.perf_counter() - t0

    spec = ModelSpec(full)
    params = spec.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    warm = TieredEngine(spec, params, kv, device="cuda")  # first calls: cuBLAS set-up, allocator
    warm.add_request(Request(rid=0, prompt=prompts[0][:40], max_new_tokens=4))
    warm.run()
    del warm
    reset_launch_counts()
    eng, stats, dt = run_engine(spec, params, full.vocab, "cuda")
    counts = launch_counts()
    print(f"  stats {vars(stats)}; launches {counts}")
    if not all(r.done for r in eng.requests.values()):
        raise AssertionError("not every request finished")
    if min(stats.parks, stats.evicted_pages, stats.compactions) <= 0:
        raise AssertionError("the run must park, evict and compact")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")

    # (b) the policy depends on lengths only: the reduced CPU run agrees
    rspec = ModelSpec(reduced)
    rparams = rspec.init(torch.Generator().manual_seed(SEED), device="cpu")
    _, rstats, _ = run_engine(rspec, rparams, reduced.vocab, "cpu")
    if vars(rstats) != vars(stats):
        raise AssertionError(f"ServeStats differ from the reduced CPU run: {vars(rstats)}")
    print("  ServeStats equal the reduced-width CPU run")

    # (c) near-tie check against the dense decode, teacher-forced
    worst, exact = 0.0, 0
    dense, dt_base = baseline_serve(spec, params, prompts, NEW_TOKENS, device="cuda")
    for rid, p in prompts.items():
        out = eng.requests[rid].out
        _, gaps = dense_decode(spec, params, p, NEW_TOKENS, forced=out, device="cuda")
        worst = max(worst, max(gaps))
        exact += sum(a == b for a, b in zip(out, dense[rid]))
    total = len(prompts) * NEW_TOKENS
    print(f"  near-tie check: worst gap to the dense max logit {worst:.4f} (tol {NEAR_TIE}); "
          f"exact-match rate vs dense greedy {exact}/{total} = {exact / total:.3f}")
    if worst > NEAR_TIE:
        raise AssertionError(f"an emitted token is {worst} below the dense decode's max logit")
    base_total = sum(len(o) for o in dense.values())
    print(f"  tok/s skybyte {stats.decoded_tokens / dt:.1f} ({stats.decoded_tokens} tokens in {dt:.3f}s); "
          f"baseline {base_total / dt_base:.1f} ({base_total} tokens in {dt_base:.3f}s) — on {card}")

    # where a decode step's time goes: a separate run; 4 steps timed without
    # the profiler, then 4 traced (the trace stays out of the tok/s above)
    eng = TieredEngine(spec, params, kv, device="cuda")
    for rid, p in prompts.items():
        eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    for _ in range(8):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 4 * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_device) / 4e3
    by_name = {}
    for e in on_device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 4e3
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]
    print(f"  decode step (untraced) {step_ms:.2f} ms; device busy {busy_ms:.3f} ms/step "
          f"({len(on_device) / 4:.0f} device ops/step); idle share {1 - busy_ms / step_ms:.3f} — on {card}")
    for name, ms in top:
        print(f"    {ms:8.4f} ms/step  {name[:90]}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _build

    with phase("environment"):
        card = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
              f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    with phase("build"):
        info = _build.build()
        print(f"  built {info.library.name} in {info.seconds:.1f}s")
        for line in info.ptxas_log.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line or line.startswith("=="):
                print("   ", line.strip())
    full, reduced = get_config("qwen3-1.7b"), get_reduced("qwen3-1.7b")
    with phase("kernels"):
        rows = check_kernels(full)
    with phase("serving"):
        counts = serve(full, reduced, card)
    kernels = []
    for name in ("paged_attention", "log_compact", "kv_log_append", "flash_attention"):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
