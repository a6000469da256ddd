"""The "zamba2" family (Zamba2-7B-Instruct's published block) on the CPU, at
the width of ``configs.zamba2_tiny``: prefill and TieredEngine decoding
against the plain reference ``models/zamba2_ref.py``, the Mamba2 decode
kernel's plain version, the grouped chunked SSD and the prefill scan's plain
version against the token-by-token recurrence, the scratch slot of padded rows, the engine's state-byte
counter, and the ``model.mamba`` / ``model.shared_attn`` ranges.

The comparisons with the reference run in float32: the port's chunked SSD,
its stepwise decode and the reference's segment sums add the same terms in
other orders, measured at ~1e-6 of the logits' scale, so 2e-5 of it is the
bound; in bf16 the tiny model's logits differ from fp32 by ~0.06 of a 0.5
scale, too loose to catch a wrong equation."""
import dataclasses
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.core import tiering
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.mamba_step.ref import mamba_step_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import mamba2
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import param_count
from repro_torch.models.zamba2_ref import Zamba2Reference
from repro_torch.serving.engine import Request, TieredEngine

CFG = configs.zamba2_tiny()
MODEL = dataclasses.asdict(CFG)
REL = 2e-5  # of the reference logits' largest magnitude (see the module docstring)


def tiny_params(dtype=torch.float32, seed=0):
    """The schema's draw with its zero and one leaves randomised, A_log and
    dt_bias as Mamba2 initialises them."""
    g = torch.Generator().manual_seed(seed)
    p = ModelSpec(CFG).init(g, device="cpu")
    for k, t in p.items():
        if k.endswith("A_log"):
            p[k] = torch.log(1 + 15 * torch.rand(t.shape, generator=g))
        elif k.endswith("dt_bias"):
            dt = torch.exp(torch.rand(t.shape, generator=g) * math.log(100) + math.log(1e-3))
            p[k] = dt + torch.log(-torch.expm1(-dt))
        elif "norm" in k or k.endswith((".D", "conv_b")):
            p[k] = t.float() + 0.2 * torch.randn(t.shape, generator=g)
    return {k: t.to(dtype) for k, t in p.items()}


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= REL * scale


def test_config_published_sizes_and_registry():
    cfg = configs.zamba2_7b_instruct()
    assert param_count(ModelSpec(cfg).schema()) == 7_356_749_648  # 14,713,499,296 bytes in bf16
    assert cfg.n_heads * cfg.resolved_head_dim == 2 * cfg.d_model  # attention over concat(x, x0)
    assert "zamba2-7b-instruct" not in configs.ARCH_IDS and "zamba2-tiny" not in configs.ARCH_IDS
    assert tiering.attention_calls(cfg) == 13


def test_prefill_matches_the_reference():
    params = tiny_params()
    toks = torch.randint(0, CFG.vocab, (1, 45), generator=torch.Generator().manual_seed(1))
    logits, _, (k, v, conv, ssm) = ModelSpec(CFG).forward(params, toks, collect_kv=True)
    _close(logits[0], Zamba2Reference(MODEL, params).forward(toks[0]))
    n_sites = len(CFG.hybrid_layer_ids)
    assert k.shape == v.shape == (n_sites, 1, 45, CFG.n_kv_heads, CFG.head_dim)
    assert conv.shape == (CFG.n_layers, 1, 3, 96) and ssm.shape == (CFG.n_layers, 1, 8, 8, 8)


def test_engine_decoding_matches_the_reference(monkeypatch):
    """Prefill and decode through TieredEngine, past 2 compactions, with
    requests parked, evicted and re-promoted: every logit the engine computes
    (the prefill's and each step's) against the reference's full forward over
    the prompt and the served tokens."""
    params = tiny_params()
    kv = TieredKVConfig(page_size=4, n_hbm_pages=9, max_requests=3, max_pages_per_req=10, log_slots=8, batch=2,
                        promote_pages_per_step=2)
    spec = ModelSpec(CFG)
    eng = TieredEngine(spec, params, kv, device="cpu")
    eng.state = tiering.init_state(kv, CFG, dtype=torch.float32, device="cpu")  # fp32 tiers and slots
    logits, rows = {}, []
    unembed, prefill = tiering.unembed, spec.prefill

    def record(cfg, p, x):
        out = unembed(cfg, p, x)
        rows.append(out)
        return out

    monkeypatch.setattr(tiering, "unembed", record)
    step = eng.step_fn

    def step_fn(p, state, tokens, req_ids):
        nxt, state = step(p, state, tokens, req_ids)
        for i, rid in enumerate(req_ids.tolist()):
            if rid >= 0:
                logits.setdefault(rid, []).append(rows[-1][i])
        return nxt, state

    eng.step_fn = step_fn
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, CFG.vocab, (n,), generator=g).tolist() for n in (13, 9, 15)]
    for rid, prompt in enumerate(prompts):
        first, _ = prefill(params, torch.tensor([prompt]))
        logits[rid] = [first[0]]
        eng.add_request(Request(rid=rid, prompt=prompt, max_new_tokens=12))
    eng.run(200)
    s = eng.stats
    assert s.compactions >= 2 and s.parks > 0 and s.evicted_pages > 0 and s.promoted_pages > s.evicted_pages
    ref = Zamba2Reference(MODEL, params)
    for rid, prompt in enumerate(prompts):
        out = eng.requests[rid].out
        want = ref.forward(torch.tensor(prompt + out[:-1]))[len(prompt) - 1:]
        got = torch.stack(logits[rid])
        assert got.shape == want.shape == (12, CFG.vocab)
        _close(got, want)
        assert want.argmax(-1).tolist() == out


def test_mamba_step_plain_version_follows_the_references_recurrence():
    """``mamba_step_ref`` token by token on one slot against the reference's
    mixer over the whole sequence (its chunked segment sums)."""
    params = tiny_params()
    ref = Zamba2Reference(MODEL, params)
    layer = 2
    p = {k[len("mamba."):]: t[layer] for k, t in params.items() if k.startswith("mamba.")}
    h = torch.randn(37, CFG.d_model, generator=torch.Generator().manual_seed(3))
    want = ref.mamba(layer, h)
    s = CFG.ssm
    C = s.heads * s.head_dim + 2 * CFG.ssm_groups * s.state_dim
    conv = torch.zeros(3, s.conv_dim - 1, C)
    ssm = torch.zeros(3, s.heads, s.head_dim, s.state_dim)
    req = torch.tensor([1], dtype=torch.int32)
    got = []
    for t in range(h.shape[0]):
        y = mamba_step_ref(h[t:t + 1] @ p["in_proj"], conv, ssm, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
                           p["D"], p["norm_y"], req, groups=CFG.ssm_groups)
        got.append(y @ p["out_proj"])
    _close(torch.cat(got), want)
    assert not conv[0].any() and not ssm[0].any()  # the other slots untouched


def _recurrence(x, dt, loga, Bm, Cm, state):
    """S_t = exp(loga_t) S_{t-1} + dt_t x_t (x) B_t; y_t = C_t . S_t, a token
    at a time; B, C (B, S, G, N), head h reading group h // (H / G)."""
    H, G = x.shape[2], Bm.shape[2]
    group = torch.arange(H) // (H // G)
    ys = []
    for t in range(x.shape[1]):
        Bh, Ch = Bm[:, t][:, group], Cm[:, t][:, group]  # (B, H, N)
        state = torch.exp(loga[:, t])[..., None, None] * state + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("S,chunk", [(37, 16), (32, 16), (5, 16)])
def test_grouped_ssd_chunked_matches_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    B, H, P, N, G = 2, 8, 4, 6, 2
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.2
    loga = -dt * (1 + 15 * torch.rand(H, generator=g))
    Bm, Cm = torch.randn(B, S, G, N, generator=g), torch.randn(B, S, G, N, generator=g)
    state0 = torch.randn(B, H, P, N, generator=g)
    y, state = mamba2.ssd_chunked(x, dt, loga, Bm, Cm, state0, chunk)
    y_want, state_want = _recurrence(x, dt, loga, Bm, Cm, state0)
    torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, state_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(37, 16), (32, 16), (5, 16)])
def test_ssd_scan_plain_version_matches_the_recurrence(S, chunk):
    """``ssd_scan`` on the CPU (its plain version, no launch): the scan from
    a zero state over the conv's [x | B | C] output, plus D x."""
    g = torch.Generator().manual_seed(S)
    B, H, P, N, G = 2, 8, 4, 6, 2
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.2
    loga = -dt * (1 + 15 * torch.rand(H, generator=g))
    D = torch.randn(H, generator=g)
    reset_launch_counts()
    y, state = ssd_scan(xbc, dt, loga, D, heads=H, groups=G, state_dim=N, chunk=chunk)
    assert launch_counts()["ssd_scan"] == 0
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:].reshape(B, S, 2, G, N).unbind(2)
    y_want, state_want = _recurrence(x, dt, loga, Bm, Cm, torch.zeros(B, H, P, N))
    torch.testing.assert_close(y, (y_want + D[:, None] * x).reshape(B, S, H * P), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, state_want, rtol=1e-5, atol=1e-5)


def test_a_padded_row_leaves_every_live_slot_bit_equal():
    g = torch.Generator().manual_seed(4)
    s, G = CFG.ssm, CFG.ssm_groups
    H, P, N = s.heads, s.head_dim, s.state_dim
    inner, C = H * P, H * P + 2 * G * N
    p = {k[len("mamba."):]: t[0] for k, t in tiny_params(torch.bfloat16).items() if k.startswith("mamba.")}
    conv = torch.randn(5, s.conv_dim - 1, C, generator=g).to(torch.bfloat16)
    ssm = torch.randn(5, H, P, N, generator=g)
    before = conv.clone(), ssm.clone()
    zx = torch.randn(4, 2 * inner + 2 * G * N + H, generator=g).to(torch.bfloat16)
    req = torch.tensor([2, -1, 0, -1], dtype=torch.int32)
    mamba_step_ref(zx, conv, ssm, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"], p["norm_y"], req,
                   groups=G)
    for slot in (1, 3):  # live slots no row names
        assert torch.equal(conv[slot], before[0][slot]) and torch.equal(ssm[slot], before[1][slot])
    for slot in (0, 2, 4):  # the rows' slots and the scratch slot
        assert not torch.equal(ssm[slot], before[1][slot])


def _tiny_engine(params, kv):
    eng = TieredEngine(ModelSpec(CFG), params, kv, device="cpu")
    g = torch.Generator().manual_seed(5)
    for rid, n in enumerate((11, 20, 7)):
        eng.add_request(Request(rid=rid, prompt=torch.randint(0, CFG.vocab, (n,), generator=g).tolist(),
                                max_new_tokens=6))
    return eng


def test_state_bytes_counts_each_rows_slot_read_and_written():
    kv = TieredKVConfig(page_size=4, n_hbm_pages=24, max_requests=3, max_pages_per_req=8, log_slots=8, batch=2,
                        promote_pages_per_step=8)
    eng = _tiny_engine(tiny_params(torch.bfloat16), kv)
    eng.run(100)
    # a slot: 7 layers x (3 x 96 bf16 conv inputs + 8 x 8 x 8 fp32 state) = 7 x (576 + 2048) bytes
    slot = 7 * (3 * 96 * 2 + 8 * 8 * 8 * 4)
    assert eng.stats.steps > 0
    assert eng.counters.state_bytes == eng.stats.steps * kv.batch * 2 * slot


def test_mamba_and_shared_attention_ranges_under_the_profiler():
    kv = TieredKVConfig(page_size=4, n_hbm_pages=24, max_requests=3, max_pages_per_req=8, log_slots=8, batch=2,
                        promote_pages_per_step=8)
    eng = _tiny_engine(tiny_params(torch.bfloat16), kv)
    quiet = TieredEngine(ModelSpec(CFG), eng.params, kv, device="cpu")
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        quiet.add_request(Request(rid=0, prompt=list(range(9)), max_new_tokens=4))
        for _ in range(3):
            quiet.step()
    events = [e for e in prof.events() if e.name.startswith("model.")]
    mamba = [e for e in events if e.name == "model.mamba"]
    shared = [e for e in events if e.name == "model.shared_attn"]
    n_sites, passes = len(CFG.hybrid_layer_ids), 1 + quiet.stats.steps  # the prefill and each decoding step
    assert quiet.stats.steps >= 1
    assert len(mamba) == passes * CFG.n_layers and len(shared) == passes * n_sites
    assert [e.kwinputs["args"] for e in shared] == [f"site={j}" for j in range(n_sites)] * passes
    eng.run(100)  # no profiler: the same engine decodes with no range open
    assert eng.stats.steps > 0
