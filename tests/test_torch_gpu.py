"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips (inside its fixture) where no CUDA card is
visible. On a machine with one:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Tolerances as in tests/test_torch_kernels.py: fp32 3e-5, bf16 2e-2 (paged)
and 3e-2 (flash), append and compaction bit-exact. The K/V epilogue fused
into the append: 1 bf16 ulp, fp32 1e-5, meta rows exact (the kernel rounds
where the plain ops do and sums the rmsnorm's squares in torch's order, so
it is exact while torch sums that way; see
test_torch_mean_sums_as_the_fused_kernel). bf16 flash attention runs
on the tensor-core route and fp32 on the CUDA-core route; the tests assert
which.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.configs import ModelConfig
from repro_torch.kernels.kv_log_append.ops import kv_log_append, qkv_log_append
from repro_torch.kernels.kv_log_append.ref import kv_log_append_ref, qkv_log_append_ref
from repro_torch.kernels.log_compact.ops import log_compact, log_compact_tiers
from repro_torch.kernels.log_compact.ref import log_compact_ref, log_compact_tiers_ref
from repro_torch.kernels.paged_attention.ops import _paged_attention_cuda, paged_decode_attention
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref, paged_decode_attention_split_ref
from repro_torch.launch.serve import dense_decode, replay_dense
from repro_torch.models import layers
from repro_torch.models.layers import AttnParams
from repro_torch.models.api import ModelSpec
from repro_torch.serving.engine import Request, TieredEngine

pytestmark = pytest.mark.gpu

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, DT[dtype])


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _bits_equal(a, b):
    torch.cuda.synchronize()
    view = (lambda t: t.view(torch.int16)) if a.dtype == torch.bfloat16 else (lambda t: t)
    assert torch.equal(view(a), view(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,page,P,N", [
    (2, 4, 2, 32, 8, 8, 3), (3, 8, 4, 64, 16, 16, 4), (1, 6, 2, 16, 4, 6, 5), (4, 4, 4, 128, 8, 12, 2),
    (4, 16, 8, 128, 16, 96, 40),  # full width
    (4, 16, 16, 128, 16, 96, 40),  # full width, group size 1 (olmoe-1b-7b)
])
def test_paged_attention_kernel(cuda, B, H, KV, hd, page, P, N, dtype):
    rng = np.random.default_rng(B * 100 + H)
    q = _rand(rng, (B, H, hd), dtype, cuda)
    kp, vp = _rand(rng, (P, page, KV, hd), dtype, cuda), _rand(rng, (P, page, KV, hd), dtype, cuda)
    table = rng.choice(P, size=B * N, replace=B * N > P).reshape(B, N).astype(np.int32)
    table[0, N - 1] = -1  # one non-resident page
    table = torch.from_numpy(table).to(cuda)
    lengths = torch.from_numpy(rng.integers(1, N * page + 1, size=B).astype(np.int32)).to(cuda)
    reset_launch_counts()
    got = paged_decode_attention(q, kp, vp, table, lengths)
    assert launch_counts()["paged_attention"] == 1
    _close(got, paged_decode_attention_ref(q, kp, vp, table, lengths), 2e-2 if dtype == "bfloat16" else 3e-5)


def test_paged_attention_log_merge_and_padded_row(cuda):
    rng = np.random.default_rng(7)
    B, H, KV, hd, page, P, N, S = 4, 8, 4, 64, 16, 16, 4, 8
    q = _rand(rng, (B, H, hd), "float32", cuda)
    kp, vp = _rand(rng, (P, page, KV, hd), "float32", cuda), _rand(rng, (P, page, KV, hd), "float32", cuda)
    lk, lv = _rand(rng, (S, KV, hd), "float32", cuda), _rand(rng, (S, KV, hd), "float32", cuda)
    table = torch.from_numpy(rng.choice(P, size=B * N, replace=False).reshape(B, N).astype(np.int32)).to(cuda)
    meta = torch.full((S, 2), -1, dtype=torch.int32)
    meta[0], meta[1] = torch.tensor([1, 60]), torch.tensor([1, 61])
    meta = meta.to(cuda)
    plen = torch.tensor([48, 48, 48, 0], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([48, 62, 48, 0], dtype=torch.int32, device=cuda)
    req = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, lengths, lk, lv, meta)
    got = paged_decode_attention(*args, page_lengths=plen, req_ids=req)
    want = paged_decode_attention_ref(*args, page_lengths=plen, req_ids=req)
    _close(got[:3], want[:3], 3e-5)
    assert torch.isfinite(got[3]).all()  # no valid key at all: finite, not NaN


@pytest.mark.parametrize("pages_per_split", [None, 3, 7])
@pytest.mark.parametrize("KV", [8, 16])
def test_paged_attention_full_width_splits(cuda, KV, pages_per_split):
    """Full width (q (4,16,128), pool (96,16,KV,128), table (4,40), log of
    64; KV 8: qwen3-1.7b, 16: olmoe-1b-7b, a group of one): 3 pages a split
    leaves a partial last split; row 2 has length 0 and no log (every split
    empty); row 3 is padding."""
    rng = np.random.default_rng(12)
    B, H, hd, page, P, N, S = 4, 16, 128, 16, 96, 40, 64
    q = _rand(rng, (B, H, hd), "bfloat16", cuda)
    kp, vp = _rand(rng, (P, page, KV, hd), "bfloat16", cuda), _rand(rng, (P, page, KV, hd), "bfloat16", cuda)
    lk, lv = _rand(rng, (S, KV, hd), "bfloat16", cuda), _rand(rng, (S, KV, hd), "bfloat16", cuda)
    table = np.full((B, N), -1, np.int32)
    table[0, :31] = rng.choice(P, 31, replace=False)
    table[1, :25] = rng.choice(P, 25, replace=False)
    plen = np.array([490, 400, 0, 0], np.int32)
    meta = np.full((S, 2), -1, np.int32)
    for i, slot in enumerate(rng.permutation(S)[:20]):
        meta[slot] = (0, 490 + i) if i < 10 else (1, 400 + i - 10)
    lengths = np.array([500, 410, 0, 0], np.int32)
    req = np.array([0, 1, 2, -1], np.int32)
    t = lambda a: torch.from_numpy(a).to(cuda)
    args = (q, kp, vp, t(table), t(lengths), lk, lv, t(meta))
    reset_launch_counts()
    got = _paged_attention_cuda(q, kp, vp, t(table), t(plen), lk, lv, t(meta), t(lengths), t(req),
                                pages_per_split=pages_per_split)
    assert launch_counts()["paged_attention"] == 1
    want = paged_decode_attention_ref(*args, page_lengths=t(plen), req_ids=t(req))
    _close(got[:2], want[:2], 2e-2)
    split = paged_decode_attention_split_ref(*args, page_lengths=t(plen), req_ids=t(req),
                                             pages_per_split=pages_per_split or 2)
    _close(got, split, 2e-2)
    assert torch.equal(got[2:].float(), torch.zeros_like(got[2:].float()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 96, 6, 2, 16), (1, 13, 4, 2, 16), (2, 35, 6, 3, 128),
    (1, 381, 16, 8, 128),  # full width, ragged prompt
    (1, 517, 16, 16, 128),  # full width, group size 1 (olmoe-1b-7b)
])
def test_flash_attention_kernel(cuda, B, S, H, KV, hd, causal, dtype):
    rng = np.random.default_rng(S + H)
    q = _rand(rng, (B, S, H, hd), dtype, cuda)
    k, v = _rand(rng, (B, S, KV, hd), dtype, cuda), _rand(rng, (B, S, KV, hd), dtype, cuda)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 1
    route = "tensor_core" if dtype == "bfloat16" else "cuda_core"
    assert route_counts()[route] == 1
    _close(got, flash_attention_ref(q, k, v, causal=causal), 3e-2 if dtype == "bfloat16" else 3e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [13, 35, 64, 381, 517])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attention_tensor_cores(cuda, hd, g, S, causal):
    """bf16 through the wgmma route: every head dim it takes, GQA groups of
    1-4 query heads, ragged and whole tiles up to the longest prompt."""
    KV = 2
    rng = np.random.default_rng(hd * 1000 + g * 100 + S)
    q = _rand(rng, (1, S, g * KV, hd), "bfloat16", cuda)
    k, v = _rand(rng, (1, S, KV, hd), "bfloat16", cuda), _rand(rng, (1, S, KV, hd), "bfloat16", cuda)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert route_counts() == {"tensor_core": 1, "cuda_core": 0}
    _close(got, flash_attention_ref(q, k, v, causal=causal), 3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [13, 381])
@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_hd112(cuda, g, S, causal):
    """Head dim 112 (zamba2-7b's shared attention) on the tensor-core route:
    the 128 instantiation over zero-filled columns, 1/sqrt(112) scale."""
    KV = 4
    rng = np.random.default_rng(g * 1000 + S)
    q = _rand(rng, (2, S, g * KV, 112), "bfloat16", cuda)
    k, v = _rand(rng, (2, S, KV, 112), "bfloat16", cuda), _rand(rng, (2, S, KV, 112), "bfloat16", cuda)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert route_counts() == {"tensor_core": 1, "cuda_core": 0}
    _close(got, flash_attention_ref(q, k, v, causal=causal), 3e-2)


def test_flash_attention_hd112_full_width(cuda):
    """zamba2-7b's prefill shape: (4, 381, 32, 112), causal."""
    rng = np.random.default_rng(112)
    q, k, v = (_rand(rng, (4, 381, 32, 112), "bfloat16", cuda) for _ in range(3))
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    assert route_counts() == {"tensor_core": 1, "cuda_core": 0}
    _close(got, flash_attention_ref(q, k, v, causal=True), 3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64, 112])
@pytest.mark.parametrize("S,S_kv", [(381, 103), (35, 9), (103, 103), (9, 70)])
def test_flash_attention_non_causal_cross(cuda, S, S_kv, hd, dtype):
    """Non-causal with S_q != S_kv (whisper's cross-attention: 381 x 103 at
    full width) and S_q == S_kv (its encoder), on both routes."""
    rng = np.random.default_rng(S * 7 + S_kv + hd)
    q = _rand(rng, (2, S, 8, hd), dtype, cuda)
    k, v = _rand(rng, (2, S_kv, 8, hd), dtype, cuda), _rand(rng, (2, S_kv, 8, hd), dtype, cuda)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    route = "tensor_core" if dtype == "bfloat16" else "cuda_core"
    assert route_counts()[route] == 1
    _close(got, flash_attention_ref(q, k, v, causal=False), 3e-2 if dtype == "bfloat16" else 3e-5)


def test_flash_attention_fp32_cuda_cores(cuda):
    rng = np.random.default_rng(3)
    q = _rand(rng, (1, 381, 16, 128), "float32", cuda)
    k, v = _rand(rng, (1, 381, 8, 128), "float32", cuda), _rand(rng, (1, 381, 8, 128), "float32", cuda)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    assert route_counts() == {"tensor_core": 0, "cuda_core": 1}
    _close(got, flash_attention_ref(q, k, v, causal=True), 3e-5)


@pytest.mark.parametrize("L,S,B,KV,hd,tail", [
    (2, 32, 4, 2, 16, 0), (3, 64, 8, 4, 32, 17), (1, 16, 2, 1, 8, 14), (1, 64, 4, 8, 128, 60),
])
def test_kv_log_append_kernel(cuda, L, S, B, KV, hd, tail):
    rng = np.random.default_rng(L * S)
    lk, lv = _rand(rng, (L, S, KV, hd), "bfloat16", cuda), _rand(rng, (L, S, KV, hd), "bfloat16", cuda)
    kn, vn = _rand(rng, (L, B, KV, hd), "bfloat16", cuda), _rand(rng, (L, B, KV, hd), "bfloat16", cuda)
    req = torch.from_numpy(rng.integers(-1, 8, B).astype(np.int32)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, 100, B).astype(np.int32)).to(cuda)
    outs = []
    for fn in (kv_log_append, kv_log_append_ref):
        k, v, m = lk.clone(), lv.clone(), torch.full((S, 2), -1, dtype=torch.int32, device=cuda)
        assert fn(k, v, m, tail, kn, vn, req, pos) == tail + B
        outs.append((k, v, m))
    for a, b in zip(*outs):
        _bits_equal(a, b)


def _bf16_ulps(a, b) -> int:
    """Largest distance between two bf16 tensors in units in the last place
    (bit patterns mapped to a monotone integer line; +0 and -0 both 0)."""
    def line(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((line(a) - line(b)).abs().max())


def _epilogue_case(rng, dev, dtype, L, S, B, H, KV, hd, bias, qk_norm):
    """Raw projections of L layers, their weights, and a log and meta to append to."""
    d = DT[dtype]
    cfg = ModelConfig(name="t", family="dense", n_layers=L, d_model=H * hd, n_heads=H, n_kv_heads=KV,
                      d_ff=64, vocab=64, head_dim=hd, qkv_bias=bias, qk_norm=qk_norm, rope_theta=1e6, norm_eps=1e-6)
    layers = []
    for _ in range(L):
        raw = [_rand(rng, (B, 1, n * hd), dtype, dev) for n in (H, KV, KV)]
        w = {}
        if bias:
            w.update({n: _rand(rng, (m * hd,), dtype, dev) for n, m in (("bq", H), ("bk", KV), ("bv", KV))})
        if qk_norm:
            w.update({n: (1.0 + 0.2 * _rand(rng, (hd,), "float32", dev)).to(d) for n in ("q_norm", "k_norm")})
        layers.append((raw, AttnParams(wq=None, wk=None, wv=None, wo=None, **w)))
    log = _rand(rng, (L, S, KV, hd), dtype, dev), _rand(rng, (L, S, KV, hd), dtype, dev)
    req = torch.from_numpy(rng.integers(0, 8, B).astype(np.int32)).to(dev)
    req[1 % B] = -1  # a padded row: meta (-1, -1), RoPE position 0
    pos = torch.from_numpy(rng.integers(0, 600, B).astype(np.int32)).to(dev)
    pos[1 % B] = 0
    meta_pos = torch.where(req >= 0, pos, -1)
    return cfg, layers, log, req, pos, meta_pos


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("L,S,B,H,KV,hd,tail", [
    (2, 16, 4, 4, 2, 16, 5), (3, 32, 3, 8, 4, 32, 17), (2, 32, 2, 6, 2, 64, 30),
    (2, 64, 4, 16, 8, 128, 20),  # full width (qwen3-1.7b: qk-norm, no bias)
    (2, 64, 4, 16, 16, 128, 20),  # full width, group size 1 (olmoe-1b-7b: 4 x 48 head rows)
])
def test_qkv_log_append_kernel(cuda, L, S, B, H, KV, hd, tail, bias, qk_norm, dtype):
    """The fused K/V epilogue and append against its plain version, layer
    by layer: q and the log within 1 bf16 ulp (fp32: 1e-5), meta exact, one
    launch a layer."""
    rng = np.random.default_rng(L * 1000 + hd + 2 * bias + qk_norm)
    cfg, layers, (lk, lv), req, pos, meta_pos = _epilogue_case(rng, cuda, dtype, L, S, B, H, KV, hd, bias, qk_norm)
    outs, qs = [], []
    reset_launch_counts()
    for fn in (qkv_log_append, qkv_log_append_ref):
        k_log, v_log, meta = lk.clone(), lv.clone(), torch.full((S, 2), -1, dtype=torch.int32, device=cuda)
        q_fn = []
        for layer, (raw, p) in enumerate(layers):
            q, new_tail = fn(cfg, p, *raw, pos, k_log[layer], v_log[layer], meta, tail, req, meta_pos)
            assert new_tail == tail + B and q.shape == (B, H, hd) and q.is_contiguous()
            q_fn.append(q)
        outs.append((k_log, v_log, meta))
        qs.append(torch.stack(q_fn))
    assert launch_counts()["kv_log_append"] == L
    torch.cuda.synchronize()
    assert torch.equal(outs[0][2], outs[1][2])
    for got, want in ((qs[0], qs[1]), (outs[0][0], outs[1][0]), (outs[0][1], outs[1][1])):
        assert torch.isfinite(got).all()
        if dtype == "bfloat16":
            assert _bf16_ulps(got, want) <= 1
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("M", [4, 12, 64])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 128])
def test_torch_mean_sums_as_the_fused_kernel(cuda, D, M):
    """The fused epilogue's rmsnorm adds the squares in the order of torch's
    CUDA mean over a contiguous row: halving the row (D < 128), or summing
    float4 vectors in turn and halving the 32 sums (D = 128). A torch that
    sums otherwise fails here, where the kernel test would show only a rare
    1-ulp difference."""
    sq = (torch.randn(200, M, D, device=cuda) * 3) ** 2
    want = torch.stack([torch.mean(rows, dim=-1) for rows in sq]).cpu()
    v = sq.cpu()
    if D == 128:
        v = v.reshape(200, M, 32, 4)
        v = ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]
    while v.shape[-1] > 1:
        v = v[..., :v.shape[-1] // 2] + v[..., v.shape[-1] // 2:]
    assert torch.equal(v[..., 0] * (1.0 / D), want)


def test_qkv_log_append_raises(cuda):
    """On CUDA tensors the fused op launches its kernel or raises: an
    overflowing tail, a shape or a dtype the kernel does not take."""
    rng = np.random.default_rng(5)
    cfg, layers, (lk, lv), req, pos, meta_pos = _epilogue_case(rng, cuda, "bfloat16", 1, 16, 4, 4, 2, 16, False, True)
    (q, k, v), p = layers[0]
    meta = torch.full((16, 2), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="overflows"):
        qkv_log_append(cfg, p, q, k, v, pos, lk[0], lv[0], meta, 14, req, meta_pos)
    with pytest.raises(ValueError):
        qkv_log_append(cfg, p, q[:, :, :-16], k, v, pos, lk[0], lv[0], meta, 0, req, meta_pos)
    with pytest.raises(ValueError):
        qkv_log_append(cfg, p, q, k, v, pos.long(), lk[0], lv[0], meta, 0, req, meta_pos)


@pytest.mark.parametrize("L,P,HP,page,KV,hd,S,span", [
    (2, 10, 12, 8, 2, 16, 32, 24), (1, 10, 12, 16, 4, 32, 16, 48), (3, 32, 30, 4, 2, 64, 48, 40),
    (28, 96, 320, 16, 8, 128, 64, 48),  # full width; positions repeat: later slot wins
    (16, 96, 320, 16, 16, 128, 64, 48),  # olmoe-1b-7b: 4 KB rows, ~66 KB of shared memory a block
])
def test_log_compact_tiers_kernel(cuda, L, P, HP, page, KV, hd, S, span):
    """Both tiers in one launch against the plain two-tier compaction, bit
    for bit; every third dirty page is not resident in the fast pool."""
    rng = np.random.default_rng(L * 100 + span)
    fk, fv = _rand(rng, (L, P, page, KV, hd), "bfloat16", cuda), _rand(rng, (L, P, page, KV, hd), "bfloat16", cuda)
    hk, hv = _rand(rng, (L, HP, page, KV, hd), "bfloat16", cuda), _rand(rng, (L, HP, page, KV, hd), "bfloat16", cuda)
    lk, lv = _rand(rng, (L, S, KV, hd), "bfloat16", cuda), _rand(rng, (L, S, KV, hd), "bfloat16", cuda)
    meta = np.full((S, 2), -1, np.int32)
    for i in range(S - 2):
        meta[i] = (int(rng.integers(0, 3)), int(rng.integers(0, span)))
    pages = sorted({(int(r), int(p) // page) for r, p in meta if r >= 0})
    n_logical = -(-span // page)
    fast = rng.choice(P, size=len(pages), replace=False)
    rows = [[r, lp, int(fast[j]) if j % 3 else -1, r * n_logical + lp] for j, (r, lp) in enumerate(pages)]
    meta, targets = torch.from_numpy(meta).to(cuda), torch.tensor(rows, dtype=torch.int32, device=cuda)
    outs = []
    reset_launch_counts()
    for fn in (log_compact_tiers, log_compact_tiers_ref):
        pools = [t.clone() for t in (fk, fv, hk, hv)]
        fn(*pools, lk, lv, meta, targets)
        outs.append(pools)
    assert launch_counts()["log_compact"] == 1
    for a, b in zip(*outs):
        _bits_equal(a, b)


@pytest.mark.parametrize("L,P,page,KV,hd,S,F,span", [
    (2, 6, 8, 2, 16, 32, 4, 48), (1, 4, 16, 4, 32, 16, 2, 64), (2, 6, 8, 2, 16, 32, 4, 24),
    (28, 96, 16, 8, 128, 64, 9, 48),  # full width; positions repeat: later slot wins
])
def test_log_compact_kernel(cuda, L, P, page, KV, hd, S, F, span):
    rng = np.random.default_rng(P * page + span)
    kp, vp = _rand(rng, (L, P, page, KV, hd), "bfloat16", cuda), _rand(rng, (L, P, page, KV, hd), "bfloat16", cuda)
    lk, lv = _rand(rng, (L, S, KV, hd), "bfloat16", cuda), _rand(rng, (L, S, KV, hd), "bfloat16", cuda)
    meta = np.full((S, 2), -1, np.int32)
    for i in range(S - 2):
        meta[i] = (int(rng.integers(0, 3)), int(rng.integers(0, span)))
    n_logical = -(-span // page)
    slots = rng.choice(P, size=F - 1, replace=False)
    pairs = rng.choice(3 * n_logical, size=F - 1, replace=False)
    rows = [[int(pr // n_logical), int(pr % n_logical), int(s)] for pr, s in zip(pairs, slots)] + [[-1, 0, -1]]
    meta, ft = torch.from_numpy(meta).to(cuda), torch.tensor(rows, dtype=torch.int32, device=cuda)
    outs = []
    for fn in (log_compact, log_compact_ref):
        k, v = kp.clone(), vp.clone()
        fn(k, v, lk, lv, meta, ft)
        outs.append((k, v))
    for a, b in zip(*outs):
        _bits_equal(a, b)


def test_engine_on_the_card(cuda):
    """Reduced qwen3-1.7b through the engine on the card: every kernel
    launches, ServeStats equal the CPU run's, and each emitted token is
    within bf16 noise (0.02 on logits of ~0.3) of the dense decode's max."""
    cfg = get_reduced("qwen3-1.7b")
    spec = ModelSpec(cfg)
    kv = TieredKVConfig(page_size=8, n_hbm_pages=16, max_requests=4, max_pages_per_req=12,
                        log_slots=32, batch=2, promote_pages_per_step=2)
    prompts = {0: list(range(7, 27)), 1: list(range(40, 75)), 2: list(range(5, 18))}
    stats = {}
    for dev in ("cpu", "cuda"):
        params = spec.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        eng = TieredEngine(spec, params, kv, device=dev)
        reset_launch_counts()
        for rid, p in prompts.items():
            eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=20))
        stats[dev] = vars(eng.run(max_steps=2000))
    counts = launch_counts()
    assert min(counts[name] for name in ("paged_attention", "log_compact", "kv_log_append", "flash_attention")) > 0
    assert counts["moe_routing"] == 0  # a dense FFN
    assert stats["cuda"] == stats["cpu"]
    for rid, p in prompts.items():
        _, gaps = dense_decode(spec, params, p, 20, forced=eng.requests[rid].out, device="cuda")
        assert max(gaps) <= 2e-2, (rid, gaps)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_moe_engine_on_the_card(cuda, arch, monkeypatch):
    """Reduced MoE archs through the engine on the card: the same launch
    counts and ServeStats as the CPU run (the policy depends on lengths
    only), every flash call on the tensor-core route, and each emitted token
    within 0.02 of the max logit of ``replay_dense`` over the engine's own
    batches with its routing forced (a capacity MoE depends on the batch
    beside each row, and a router near-tie can fall either way between the
    paged kernel's rounding and the dense decode's), every routed expert
    within 1/16 of the replay router's own k-th largest logit."""
    spec = ModelSpec(get_reduced(arch))
    kv = TieredKVConfig(page_size=8, n_hbm_pages=16, max_requests=4, max_pages_per_req=12,
                        log_slots=32, batch=2, promote_pages_per_step=2)
    prompts = {0: list(range(7, 27)), 1: list(range(40, 75)), 2: list(range(5, 18))}
    route = layers.moe_route

    def recording(into):  # moe_route, keeping the decode steps' (logits, expert ids)
        def run(m, xt, w_router):
            out = route(m, xt, w_router)
            if xt.shape[0] == kv.batch:
                into.append((out[0], out[3]))
            return out
        return run

    stats, counts = {}, {}
    for dev in ("cpu", "cuda"):
        params = spec.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        eng = TieredEngine(spec, params, kv, device=dev)
        batches, inner, routes = [], eng.step_fn, []

        def step(params_, state, tokens, req_ids, inner=inner, batches=batches):
            batches.append((tokens, req_ids))  # the step's inputs, as the engine gives them
            return inner(params_, state, tokens, req_ids)

        eng.step_fn = step
        monkeypatch.setattr(layers, "moe_route", recording(routes))
        reset_launch_counts()
        for rid, p in prompts.items():
            eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=20))
        stats[dev] = vars(eng.run(max_steps=2000))
        counts[dev] = launch_counts()
    layers_, steps = spec.cfg.n_layers, stats["cuda"]["steps"]
    assert counts["cuda"] == {"paged_attention": layers_ * steps, "kv_log_append": layers_ * steps,
                              "flash_attention": layers_ * len(prompts), "log_compact": stats["cuda"]["compactions"],
                              "moe_routing": 5 * layers_ * (steps + len(prompts)), "mamba_step": 0,
                              "rms_norm_rows": 0, "ssd_scan": 0}
    assert route_counts()["tensor_core"] == layers_ * len(prompts)
    assert stats["cuda"] == stats["cpu"]
    forced = {rid: eng.requests[rid].out for rid in prompts}
    replayed = []
    monkeypatch.setattr(layers, "moe_route", recording(replayed))
    gaps = replay_dense(spec, params, prompts, batches, forced, device="cuda", routes=[idx for _, idx in routes])
    assert max(max(g) for g in gaps.values()) <= 2e-2, gaps
    assert len(replayed) == len(routes) == steps * layers_
    for i, ((_, ran), (logits, own)) in enumerate(zip(routes, replayed)):
        live = batches[i // layers_][1] >= 0
        below = logits.gather(-1, own[:, -1:]) - logits.gather(-1, ran)
        assert float(below.amax(-1)[live].max()) <= 1 / 16, (i, below)


# prefill flash launches of each reduced family: whisper's encoder, decoder
# self- and cross-attention per layer; zamba2's shared block per invocation
FAMILY_FLASH = {"whisper-base": 6, "rwkv6-3b": 0, "zamba2-7b": 2}


@pytest.mark.parametrize("arch", list(FAMILY_FLASH))
def test_family_on_the_card(cuda, arch):
    """Reduced whisper-base, rwkv6-3b and zamba2-7b: prefill and three decode
    steps on the card against the same weights and tokens on the CPU. Logits
    within 3e-2 (cuBLAS sums in another order than the CPU's GEMMs, and the
    flash kernel rounds the softmax weights to bf16 before P.V: noise on
    logits of ~0.1-1); every flash call on the tensor-core route."""
    from repro_torch.launch.steps import build_prefill_step, decode_cache

    spec = ModelSpec(get_reduced(arch))
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    B, S, n = 2, 37, 3
    max_len = S + n + 3
    batch = spec.smoke_batch(torch.Generator().manual_seed(1), batch=B, seq=4 * (max_len // 4), device="cpu")
    prompt = batch["tokens"][:, :S]
    feed = torch.randint(0, spec.cfg.vocab, (n, B, 1), generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    logits = {}
    for dev in ("cpu", "cuda"):
        p = {k: t.to(dev) for k, t in params.items()}
        fe = batch.get("frontend")
        fe = None if fe is None else fe.to(dev)
        reset_launch_counts()
        tok, cache = build_prefill_step(spec)(p, prompt.to(dev), fe)
        if dev == "cuda":
            assert launch_counts()["flash_attention"] == FAMILY_FLASH[arch]
            assert route_counts() == {"tensor_core": FAMILY_FLASH[arch], "cuda_core": 0}
        first, _ = spec.prefill(p, prompt.to(dev), fe)
        dc = decode_cache(spec, cache, B, max_len, device=dev)
        out = [first]
        for i in range(n):
            lg, dc = spec.decode_step(p, dc, feed[i].to(dev), S + i)
            out.append(lg)
        assert dc["length"] == S + n
        logits[dev] = torch.stack(out).float().cpu()
    assert torch.isfinite(logits["cuda"]).all()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=3e-2, rtol=0)


# ---------------------------------------------------------------------------
# training: flash attention's backward, the loss and grads, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,S_kv,causal", [(381, 381, True), (381, 381, False), (1100, 1100, True), (381, 103, False),
                                           (35, 9, False), (100, 250, True)])
@pytest.mark.parametrize("hd,g", [(64, 1), (112, 1), (128, 2)])
def test_flash_attention_backward(cuda, hd, g, S, S_kv, causal, monkeypatch):
    """The wrapper's output carries an autograd node on the card; its
    backward (``flash_attention_bwd``: PyTorch ops in fp32, over query
    chunks of 1024, so S = 1100 takes two) gives autograd-of-the-plain-
    version's dq, dk, dv within the bf16 flash tolerance (3e-2: the kernel
    rounds the softmax weights to bf16 before P.V, so O, and with it
    rowsum(dO o O), differs by a bf16 ulp here and there) and within 1e-2
    of each tensor's max |value| (the CPU tests' bf16 bound), launches no
    kernel and never calls the plain version."""
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(hd + S + S_kv + g)
    KV = 2
    q = _rand(rng, (2, S, KV * g, hd), "bfloat16", cuda).requires_grad_(True)
    k, v = (_rand(rng, (2, S_kv, KV, hd), "bfloat16", cuda).requires_grad_(True) for _ in range(2))
    dout = _rand(rng, (2, S, KV * g, hd), "bfloat16", cuda)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal=causal), (q, k, v), dout)
    out = flash_attention(q, k, v, causal=causal)
    assert out.requires_grad and out.grad_fn is not None
    monkeypatch.setattr(ops, "flash_attention_ref", lambda *a, **kw: pytest.fail("the backward called the plain version"))
    reset_launch_counts()
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert launch_counts()["flash_attention"] == 0
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close(a, b, 3e-2)
        assert float((a.float() - b.float()).abs().max()) <= 1e-2 * float(b.float().abs().max())


# a "model" rank's heads (of 2) at the families' prefill and train shapes:
# whisper-base's encoder, self- and cross-attention (4 heads of 64), and
# zamba2-7b's shared block (16 heads of 112); (B, S, S_kv, H, KV, hd, causal)
SPLIT_FAMILY_FLASH_SHAPES = [
    (4, 103, 103, 4, 4, 64, False), (4, 381, 381, 4, 4, 64, True), (4, 381, 103, 4, 4, 64, False),
    (4, 381, 381, 16, 16, 112, True), (2, 1024, 256, 4, 4, 64, False), (1, 1100, 1100, 16, 16, 112, True),
]


@pytest.mark.parametrize("B,S,S_kv,H,KV,hd,causal", SPLIT_FAMILY_FLASH_SHAPES)
def test_flash_attention_at_split_family_shapes(cuda, B, S, S_kv, H, KV, hd, causal):
    """Flash attention at a split rank's heads of whisper-base and
    zamba2-7b: the forward on the tensor-core route within 3e-2 of the
    plain version, its backward (``flash_attention_bwd``) within 3e-2 and
    1e-2 of each gradient's max |value| of the plain version's autograd."""
    rng = np.random.default_rng(B + S + S_kv + H + hd)
    q = _rand(rng, (B, S, H, hd), "bfloat16", cuda).requires_grad_(True)
    k, v = (_rand(rng, (B, S_kv, KV, hd), "bfloat16", cuda).requires_grad_(True) for _ in range(2))
    dout = _rand(rng, (B, S, H, hd), "bfloat16", cuda)
    reset_launch_counts()
    out = flash_attention(q, k, v, causal=causal)
    assert route_counts() == {"tensor_core": 1, "cuda_core": 0}
    ref = flash_attention_ref(q, k, v, causal=causal)
    _close(out, ref, 3e-2)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for a, b in zip(got, want):
        _close(a, b, 3e-2)
        assert float((a.float() - b.float()).abs().max()) <= 1e-2 * float(b.float().abs().max())


def _train_pair(arch, monkeypatch):
    """Reduced ``arch``: the same random weights on the CPU and the card,
    leaves requiring grad, and one seeded batch (2 x 32) on each. A
    capacity MoE's routes flip under bf16 noise (a flipped token moves the
    gradient sums far more than rounding does), so the card's run takes
    the CPU run's expert choices, call by call (forward and remat
    recompute), with gates from its own router (``moe_ffn``'s forced
    routing)."""
    spec = ModelSpec(get_reduced(arch))
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    batch = spec.smoke_batch(torch.Generator().manual_seed(1), batch=2, seq=32, device="cpu")
    route, recorded = layers.moe_route, []

    def record(m, xt, w_router):
        out = route(m, xt, w_router)
        recorded.append(out[3].cpu())
        return out

    def force(m, xt, w_router, choices=iter(recorded)):
        logits, probs, _, _ = route(m, xt, w_router)
        idx = next(choices).to(xt.device)
        gates = probs.gather(-1, idx)
        return logits, probs, gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), idx

    out = {}
    for dev, wrap in (("cpu", record), ("cuda", force)):
        monkeypatch.setattr(layers, "moe_route", wrap)
        p = {n: t.detach().to(dev).clone().requires_grad_(True) for n, t in params.items()}
        b = {k: t.to(dev) for k, t in batch.items()}
        loss, _ = spec.loss(p, b)
        loss.backward()
        out[dev] = (float(loss.detach()), {n: t.grad.float().cpu() for n, t in p.items()})
    return out


# bf16 noise between the card and the CPU: cuBLAS and the CPU's GEMMs sum in
# other orders and the flash kernel rounds the softmax weights to bf16
# before P.V. Each gradient leaf within this fraction of its max |value|
# (measured on an H100: at most 0.048, zamba2's A_log and rwkv6's mu, and
# 0.013-0.019 on qwen3's wq, wk, wv); the loss within this relative gap
# (measured at most 6.4e-5)
GPU_GRAD_TOL = 0.1
GPU_LOSS_RTOL = 5e-4


def test_attention_grads_on_the_card(cuda, monkeypatch):
    """ROADMAP.md §3 fault 1, pinned: the grads of the attention projections
    of reduced qwen3-1.7b on the card (flash kernel, its backward) are the
    CPU plain path's. Without a gradient through attention, wq's and wk's
    would be exactly 0."""
    out = _train_pair("qwen3-1.7b", monkeypatch)
    for name in ("blocks.wq", "blocks.wk", "blocks.wv"):
        got, want = out["cuda"][1][name], out["cpu"][1][name]
        scale = float(want.abs().max())
        assert scale > 0 and float(got.abs().max()) > 0, name
        err = float((got - want).abs().max())
        print(f"{name}: max |card - cpu| {err:.3g} of max {scale:.3g} ({err / scale:.3g})")
        assert err <= GPU_GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-135m", "qwen2.5-32b", "mistral-large-123b", "olmoe-1b-7b",
                                  "llama4-scout-17b-a16e", "llava-next-34b", "whisper-base", "rwkv6-3b", "zamba2-7b"])
def test_loss_and_grads_on_the_card(cuda, arch, monkeypatch):
    """The loss and every gradient leaf of each reduced arch on the card
    against the CPU, same weights and batch (GPU_LOSS_RTOL, GPU_GRAD_TOL)."""
    out = _train_pair(arch, monkeypatch)
    (loss, grads), (cpu_loss, cpu_grads) = out["cuda"], out["cpu"]
    print(f"{arch}: loss {loss:.6f} cpu {cpu_loss:.6f} ({abs(loss - cpu_loss) / cpu_loss:.3g})")
    assert abs(loss - cpu_loss) <= GPU_LOSS_RTOL * cpu_loss
    worst = (0.0, "")
    for n, g in grads.items():
        assert torch.isfinite(g).all(), n
        scale = float(cpu_grads[n].abs().max())
        rel = float((g - cpu_grads[n]).abs().max()) / max(scale, 1e-30)
        worst = max(worst, (rel, n))
        assert rel <= GPU_GRAD_TOL or scale == 0.0, (n, rel)
    print(f"{arch}: worst gradient leaf {worst[1]} at {worst[0]:.3g} of its max")


def test_train_launcher_crash_and_resume_on_the_card(cuda, tmp_path):
    """``launch.train --device cuda``: a run that crashes at step 3
    (``--fail-at``, exit 42) and resumes ends where an uninterrupted run
    ends, bit for bit."""
    from test_torch_train_drill import launcher_drill

    launcher_drill(tmp_path, "cuda", extra=["--compress"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "whisper-base", "rwkv6-3b", "zamba2-7b"])
def test_sharded_step_on_one_rank_nccl(cuda, arch):
    """The split train step on a 1 x 1 mesh over a one-rank NCCL group
    (its gathers and reductions are copies; olmoe's MoE gathers its routing
    over the group) equals the unsharded step on the card bit for bit: two
    steps with int8 error feedback, metrics and every leaf of the state.
    One arch of each family but the vlm (whisper-base with its frame
    rows)."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import OptimConfig
    from repro_torch.distributed.sharding import local
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, make_train_state, shard_train_state

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_host_mesh("cuda")
        spec = ModelSpec(get_reduced(arch))
        optim = OptimConfig(lr=1e-3, warmup_steps=0, total_steps=10, compress_grads=True)
        state = make_train_state(spec, torch.Generator(device=cuda).manual_seed(0), compress=True, device=cuda)
        sharded = shard_train_state(spec, state, mesh)
        batch = spec.smoke_batch(torch.Generator(device=cuda).manual_seed(1), batch=4, seq=64, device=cuda)
        plain_step, sharded_step = build_train_step(spec, optim, 2), build_train_step(spec, optim, 2, mesh=mesh)
        for _ in range(2):
            state, m = plain_step(state, batch)
            sharded, ms = sharded_step(sharded, batch)
            assert {k: float(v) for k, v in ms.items()} == {k: float(v) for k, v in m.items()}
        assert sharded["opt"].step == state["opt"].step == 2
        for group in ("params", "residual"):
            for n, t in state[group].items():
                assert torch.equal(local(sharded[group][n]), t.detach()), (group, n)
        for field in ("mu", "nu", "master"):
            for n, t in getattr(state["opt"], field).items():
                assert torch.equal(local(getattr(sharded["opt"], field)[n]), t), (field, n)
    finally:
        dist.destroy_process_group()


def _state_to(state, device):
    """A copy of a train state on ``device`` (params requiring grad)."""
    moved = lambda leaves: {n: t.detach().to(device).clone() for n, t in leaves.items()}  # noqa: E731
    out = {"params": {n: t.requires_grad_(True) for n, t in moved(state["params"]).items()},
           "opt": state["opt"]._replace(mu=moved(state["opt"].mu), nu=moved(state["opt"].nu),
                                        master=moved(state["opt"].master))}
    if "residual" in state:
        out["residual"] = moved(state["residual"])
    return out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_split_step_two_ranks_on_the_card(cuda, tmp_path, arch):
    """The split step (TP over "model"; olmoe's experts split over it, EP)
    on a (1, 2) mesh: two ranks on the one card over gloo
    (tests/torch_dist_worker.py with device "cuda"), the flash kernel in
    each. Two steps from the same state, step 1 with int8 error feedback;
    each held to the unsharded step on the card from the same state by the
    one-step rules (``torch_step_rules.assert_one_step``). For olmoe the
    unsharded step's router takes the split run's recorded expert ids (a
    bf16 tie may break the other way under TP's other rounding) and its
    gates are its own probabilities at them; its drops then equal the
    run's."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import OptimConfig
    from repro_torch.launch.steps import build_train_step, make_train_state
    from torch_step_rules import LR, assert_one_step, quant_steps, restored, run_ranks

    spec = ModelSpec(get_reduced(arch))
    moe = spec.cfg.family == "moe"
    Checkpointer(str(tmp_path / "ckpt_in"), async_save=False).save(
        0, make_train_state(spec, torch.Generator().manual_seed(0), compress=True, device="cpu"))
    tokens = np.random.default_rng(1).integers(0, spec.cfg.vocab, (8, 64)).astype(np.int32)
    np.save(tmp_path / "batch.npy", tokens)
    steps = 2
    out = run_ranks(tmp_path, "run", 2, arch=arch, mesh=[1, 2], axes=["data", "model"], device="cuda", accum=2, lr=LR,
                    compress=False, compress_from=1, steps=steps, ckpt_in=str(tmp_path / "ckpt_in"), step_in=0,
                    batch=str(tmp_path / "batch.npy"), ckpt_out=str(tmp_path / "ckpt_out"),
                    save_after=list(range(steps + 1)), routing=moe)
    per_step = spec.cfg.n_layers * 2 * 2  # layers x (forward + remat recompute) x microbatches
    assert out["launches"]["flash_attention"] == steps * per_step
    assert out["routes"] == {"tensor_core": steps * per_step, "cuda_core": 0}
    states = [restored(tmp_path / "ckpt_out", arch, True, k) for k in range(steps + 1)]
    recorded = np.load(tmp_path / "run" / "routing.npz")["ids"] if moe else None
    calls = len(recorded) // steps if moe else 0
    batch = {"tokens": torch.from_numpy(tokens).to(cuda)}
    for k in range(steps):
        optim = OptimConfig(lr=LR, warmup_steps=0, total_steps=10, compress_grads=k >= 1)
        forced, drops = iter(recorded[k * calls:(k + 1) * calls]) if moe else None, []
        inner_route, inner_slots = layers.moe_route, layers.moe_slots

        def route(m, xt, w_router):
            logits, probs, _, _ = inner_route(m, xt, w_router)
            idx = torch.as_tensor(next(forced), device=xt.device)
            gates = probs.gather(-1, idx)
            return logits, probs, gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), idx

        def slots(idx, num_experts, cap):
            pos, keep = inner_slots(idx, num_experts, cap)
            drops.append(int((~keep).sum()))
            return pos, keep

        with pytest.MonkeyPatch.context() as mp:
            if moe:
                mp.setattr(layers, "moe_route", route)
                mp.setattr(layers, "moe_slots", slots)
            new, m = build_train_step(spec, optim, 2)(_state_to(states[k], cuda), batch)
        if moe:
            assert drops == out["drops"][k * calls:(k + 1) * calls] and sum(drops) > 0
            assert next(forced, None) is None
        quant = quant_steps(out, k - 1, states[k]["params"]) if k >= 1 else None
        assert_one_step(states[k], states[k + 1], out["metrics"][k], _state_to(new, "cpu"),
                        {n: float(v) for n, v in m.items()}, quant)


def _nccl_one_rank():
    """A one-rank NCCL process group on a free local port, on this card."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "llava-next-34b", "whisper-base", "rwkv6-3b",
                                  "zamba2-7b"])
def test_sharded_serving_on_one_rank_nccl(cuda, arch):
    """The sharded prefill and decode steps on a 1 x 1 mesh over a one-rank
    NCCL group (``shard_params``, ``decode_cache(mesh=)``; olmoe's MoE
    gathers its routing over the group, llava prepends its frontend rows,
    whisper encodes its frames) equal the unsharded steps on the card bit
    for bit: a prompt of 4 rows of 40 tokens and 6 new tokens, every step's
    tokens and logits and every entry of the final cache. The prefill
    launches flash once an attention layer (whisper: encoder, self and
    cross; zamba2: each application of the shared block; rwkv6: none), on
    the tensor-core route."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_params
    from repro_torch.launch.mesh import make_host_mesh
    from torch_dist_worker import serve

    _nccl_one_rank()
    try:
        mesh = make_host_mesh("cuda")
        spec = ModelSpec(get_reduced(arch))
        params = spec.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
        batch = spec.smoke_batch(torch.Generator(device=cuda).manual_seed(1), batch=4, seq=40, device=cuda)
        cfg = spec.cfg
        max_len = 48 + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
        flash = {"encdec": cfg.enc_layers + 2 * cfg.n_layers, "ssm": 0,
                 "hybrid": cfg.n_layers // (cfg.shared_attn_every or cfg.n_layers + 1)}.get(cfg.family, cfg.n_layers)
        reset_launch_counts()
        got = serve(spec, mesh, shard_params(spec, params, mesh), batch["tokens"], batch.get("frontend"), max_len, 6)
        assert launch_counts()["flash_attention"] == flash
        assert route_counts() == {"tensor_core": flash, "cuda_core": 0}
        want = serve(spec, None, params, batch["tokens"], batch.get("frontend"), max_len, 6)
        assert torch.equal(got[0], want[0]) and len(got[1]) == len(want[1]) == 7
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        assert sorted(got[2]) == sorted(want[2])
        for key in got[2]:
            _bits_equal(got[2][key], want[2][key])
    finally:
        dist.destroy_process_group()


def test_sharded_serving_two_ranks_on_the_card(cuda, tmp_path):
    """Reduced qwen3-1.7b's sharded prefill and decode on (1, 2): two ranks
    on the one card over gloo (tests/torch_dist_worker.py's serve case with
    device "cuda"), the flash kernel on each rank's 2 of 4 heads, the cache's
    sequence split over the ranks (a chunk of 16 of 32 positions), the
    decode crossing the chunk boundary. Against the unsharded steps on the
    card, teacher-forced on the run's tokens: logits within 2e-2 (TP sums
    the ranks' partial products in fp32, the unsharded GEMM in another
    order); a token the unsharded greedy would not pick lies within 2e-2 of
    its max logit; the cache gathered within 3e-2."""
    from repro_torch.launch.steps import decode_cache
    from torch_dist_worker import bits
    from torch_step_rules import run_ranks

    arch, B, S, new, max_len = "qwen3-1.7b", 4, 14, 6, 32
    spec = ModelSpec(get_reduced(arch))
    params = spec.init(torch.Generator().manual_seed(3), device="cpu")
    np.savez(tmp_path / "params.npz", **{n: bits(t) for n, t in params.items()})
    tokens = np.random.default_rng(7).integers(0, spec.cfg.vocab, (B, S)).astype(np.int32)
    np.save(tmp_path / "tokens.npy", tokens)
    out = run_ranks(tmp_path, "serve", 2, arch=arch, mesh=[1, 2], axes=["data", "model"], device="cuda", serve=True,
                    params=str(tmp_path / "params.npz"), tokens=str(tmp_path / "tokens.npy"), max_len=max_len, new=new)
    assert out["launches"]["flash_attention"] == spec.cfg.n_layers
    assert out["routes"] == {"tensor_core": spec.cfg.n_layers, "cuda_core": 0}
    assert [s["k"] for s in out["local_cache_shapes"]] == [[spec.cfg.n_layers, B, max_len // 2, spec.cfg.n_kv_heads,
                                                           16]] * 2
    served = torch.tensor(out["tokens"], dtype=torch.int32, device=cuda)
    logits = torch.from_numpy(np.load(tmp_path / "serve" / "logits.npy")).to(cuda)
    saved = np.load(tmp_path / "serve" / "cache.npz")
    p = {n: t.to(cuda) for n, t in params.items()}
    with torch.no_grad():
        first, cache = spec.prefill(p, torch.from_numpy(tokens).to(cuda))
        dc, plain = decode_cache(spec, cache, B, max_len, device=cuda), [first]
        for i in range(new):
            lg, dc = spec.decode_step(p, dc, served[:, i:i + 1], S + i)
            plain.append(lg)
    plain = torch.stack(plain).float()
    gap = float((logits - plain).abs().max())
    ties = plain.max(-1).values.T - plain.permute(1, 0, 2).gather(-1, served.long()[..., None])[..., 0]
    cache_gap = max(float((torch.from_numpy(saved[k]).view(torch.bfloat16).to(cuda).float() - dc[k].float()).abs().max())
                    for k in ("k", "v"))
    print(f"two ranks on the card: logits {gap:.4g} from the unsharded steps', largest token gap "
          f"{float(ties.max()):.4g}, cache {cache_gap:.4g}")
    assert gap <= 2e-2 and float(ties.max()) <= 2e-2 and cache_gap <= 3e-2


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-base"])
def test_dp_layout_on_one_rank_nccl(cuda, arch):
    """JAX's "dp" layout profile on a 1 x 1 mesh over a one-rank NCCL group
    (the state placed by ``layout_rules("dp")``, the steps built with
    ``layout="dp"``) equals the unsharded steps on the card bit for bit:
    two train steps (metrics and every param), then a prompt of 4 rows of
    40 tokens and 6 new served (tokens, logits, every cache entry)."""
    import torch.distributed as dist

    from repro_torch.configs import OptimConfig
    from repro_torch.distributed.sharding import layout_rules, local, shard_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, make_train_state, shard_train_state
    from torch_dist_worker import serve

    _nccl_one_rank()
    try:
        mesh = make_host_mesh("cuda")
        spec = ModelSpec(get_reduced(arch))
        optim = OptimConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        state = make_train_state(spec, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        sharded = shard_train_state(spec, state, mesh, layout_rules("dp"))
        batch = spec.smoke_batch(torch.Generator(device=cuda).manual_seed(1), batch=4, seq=64, device=cuda)
        plain_step, dp_step = build_train_step(spec, optim, 2), build_train_step(spec, optim, 2, mesh=mesh, layout="dp")
        for _ in range(2):
            state, m = plain_step(state, batch)
            sharded, ms = dp_step(sharded, batch)
            assert {k: float(v) for k, v in ms.items()} == {k: float(v) for k, v in m.items()}
        for n, t in state["params"].items():
            assert torch.equal(local(sharded["params"][n]), t.detach()), n
        params = {n: t.detach() for n, t in state["params"].items()}
        serve_batch = spec.smoke_batch(torch.Generator(device=cuda).manual_seed(2), batch=4, seq=40, device=cuda)
        got = serve(spec, mesh, shard_params(spec, params, mesh, layout_rules("dp")), serve_batch["tokens"],
                    serve_batch.get("frontend"), 48, 6, layout="dp")
        want = serve(spec, None, params, serve_batch["tokens"], serve_batch.get("frontend"), 48, 6)
        assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        assert sorted(got[2]) == sorted(want[2])
        for key in got[2]:
            _bits_equal(got[2][key], want[2][key])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The MoE's routing glue (kernels/moe_routing) against its plain version.
# Routing decisions exact: ids, pos, keep and the dispatch buffer bit for
# bit (the route kernel sums the softmax and the gates in torch's order, and
# equal logits give equal probabilities, so a tie falls to the lower id on
# both sides). Probabilities and gates within 2 fp32 ulps: the kernel's expf
# and torch's are the CUDA library's, but compiled apart. The epilogue
# within 1 bf16 ulp: it rounds where the plain ops do, so it differs only
# where an expf ulp lands on a bf16 rounding boundary. The combine within
# 2^-7 of the sum of its terms' magnitudes: each side rounds its fp32 sum to
# bf16 once (half an ulp each, at most 2^-8 of the value each), and the
# plain einsum's cuBLAS sums the k terms in another order.
# ---------------------------------------------------------------------------
MOE_ROUTING_CASES = [(E, k, T, "random") for E, k in ((64, 8), (8, 2), (16, 1), (4, 1)) for T in (1, 32, 381, 2048)] \
    + [(E, k, 32, "ties") for E, k in ((64, 8), (8, 2), (16, 1), (4, 1))]


def _f32_ulps(a, b) -> int:
    def line(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((line(a) - line(b)).abs().max())


def _moe_routing_case(E, k, T, kind, dev, d=256):
    """Rows sharing a component (the favoured experts overflow their
    capacity), a run of padded rows (one row repeated), router columns that
    tie exactly (expert E-1 a copy of expert 0; "ties": every logit of a row
    equal)."""
    rng = np.random.default_rng(E * 100_000 + k * 10_000 + T)
    x = rng.normal(size=(T, d)) + 1.5 * rng.normal(size=d)
    x[T // 2:T // 2 + T // 4] = x[0]
    w = rng.normal(size=(d, E)) / np.sqrt(d)
    w[:, E - 1] = w[:, 0]
    if kind == "ties":
        w[:] = 0.0
    xt = torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)
    return xt, torch.from_numpy(w.astype(np.float32)).to(dev, torch.bfloat16), max(1, int(T * k * 1.25 / E))


@pytest.mark.parametrize("E,k,T,kind", MOE_ROUTING_CASES)
def test_moe_routing_kernels(cuda, E, k, T, kind):
    from repro_torch.configs import MoEConfig
    from repro_torch.kernels.moe_routing import ops as moe_ops, ref as moe_ref

    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=64)
    xt, w, cap = _moe_routing_case(E, k, T, kind, cuda)
    reset_launch_counts()
    got, want = moe_ops.moe_route(m, xt, w), moe_ref.moe_route(m, xt, w)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[3], want[3])
    ulps = _f32_ulps(got[1], want[1]), _f32_ulps(got[2], want[2])
    assert max(ulps) <= 2, ulps
    if kind == "ties":
        assert got[3].tolist() == [list(range(k))] * T
    idx = want[3]
    pos, keep = moe_ops.moe_slots(idx, E, cap)
    rpos, rkeep = moe_ref.moe_slots(idx, E, cap)
    torch.cuda.synchronize()
    assert torch.equal(pos, rpos) and torch.equal(keep, rkeep)
    if kind == "random" and T >= 32:
        assert not keep.all(), "no (token, choice) was dropped: capacity not exercised"
    _bits_equal(moe_ops.moe_dispatch(xt, idx, pos, keep, E, cap), moe_ref.moe_dispatch(xt, idx, pos, keep, E, cap))

    gen = torch.Generator(device=cuda).manual_seed(T)
    h, u = [(torch.randn((E, cap, 64), generator=gen, device=cuda) * 3).to(torch.bfloat16) for _ in range(2)]
    want_h = torch.nn.functional.silu(h.float()).to(torch.bfloat16) * u
    got_h = moe_ops.swiglu_epilogue(h, u)
    torch.cuda.synchronize()
    assert _bf16_ulps(got_h, want_h) <= 1

    eo = torch.randn((E, cap, xt.shape[1]), generator=gen, device=cuda).to(torch.bfloat16)
    gates = want[2]
    out = moe_ops.moe_combine(eo, idx, pos, gates, keep, cap)
    ref_out = moe_ref.moe_combine(eo, idx, pos, gates, keep, cap)
    terms = ((gates * keep).to(torch.bfloat16).float()[..., None] * eo[idx, pos.clamp(0, cap - 1)].float()).abs()
    torch.cuda.synchronize()
    gap = (out.float() - ref_out.float()).abs()
    assert bool((gap <= terms.sum(1) * 2.0 ** -7 * 1.01).all()), float(gap.max())
    assert launch_counts()["moe_routing"] == 5


def test_moe_ffn_launches(cuda):
    """One decode-shape moe_ffn at olmoe-1b-7b's widths (T = 32, E = 64, k =
    8) launches at most 9 device ops: the router's matmul, route, slots,
    dispatch, the gate and up GEMMs, the epilogue, the down GEMM, combine."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config

    cfg = get_config("olmoe-1b-7b")
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator(device=cuda).manual_seed(3)

    def leaf(*shape, scale):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(torch.bfloat16)

    w = (leaf(d, m.num_experts, scale=d ** -0.5), leaf(m.num_experts, d, m.d_ff_expert, scale=d ** -0.5),
         leaf(m.num_experts, d, m.d_ff_expert, scale=d ** -0.5), leaf(m.num_experts, m.d_ff_expert, d, scale=0.125))
    x = leaf(32, 1, d, scale=1.0)
    for _ in range(2):
        layers.moe_ffn(cfg, x, *w, aux=False)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, _ = layers.moe_ffn(cfg, x, *w, aux=False)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"moe_ffn at decode shape: {len(ops)} device ops: {ops}")
    assert 0 < len(ops) <= 9, ops
    assert launch_counts()["moe_routing"] == 5
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_moe_ffn_autograd_path(cuda, monkeypatch):
    """Where autograd records a graph (inputs and weights that require grad,
    grad mode on) the five kernels run all the same, with the bits of the
    same call under no_grad, and the gradients are the plain version's but
    for the forward's rounding: each kernel's node differentiates the plain
    version recomputed from its saved inputs, and those inputs differ from
    the plain forward's by the gates' 2 fp32 ulps and the combine's bf16
    rounding at most (gradients within 1 % of their norm)."""
    from repro_torch.kernels.moe_routing import ref as moe_ref

    cfg = get_reduced("olmoe-1b-7b")
    spec = ModelSpec(cfg)
    p = spec.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    w = [p[f"blocks.{n}"][0].detach().clone().requires_grad_(True) for n in ("router", "we_gate", "we_up", "we_down")]
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 24, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_(True)
    up = torch.randn((2, 24, cfg.d_model), generator=gen, device=cuda)

    def grads():
        out, aux = layers.moe_ffn(cfg, x, *w)
        return out, torch.autograd.grad((out.float() * up).sum() + aux, (x, *w))

    reset_launch_counts()
    out, got = grads()
    assert launch_counts()["moe_routing"] == 5
    with torch.no_grad():
        fast, _ = layers.moe_ffn(cfg, x, *w, aux=False)
    _bits_equal(fast, out.detach())
    for name in ("moe_route", "moe_slots", "moe_dispatch", "moe_experts", "moe_combine"):
        monkeypatch.setattr(layers, name, getattr(moe_ref, name))
    reset_launch_counts()
    plain, want = grads()
    assert launch_counts()["moe_routing"] == 0
    _close(out.detach(), plain.detach(), 2e-2)
    for name, a, b in zip(("x", "router", "we_gate", "we_up", "we_down"), got, want):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        print(f"{name}: gradient {rel:.2e} of its norm from the plain version's")
        assert bool(torch.isfinite(a).all()) and rel <= 1e-2, (name, rel)


# ---- Zamba2-7B-Instruct: head dim 224, the Mamba2 decode kernel ----------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias", [False, True])
def test_qkv_log_append_hd224(cuda, bias, dtype):
    """The fused epilogue at Zamba2-7B-Instruct's shared attention (32 heads
    of 224, RoPE, no qk-norm; 192 log slots) against its plain version: q and
    the log within 1 bf16 ulp (fp32: 1e-5), meta exact, one launch a call."""
    L, S, B, H, KV, hd, tail = 2, 192, 16, 32, 32, 224, 40
    rng = np.random.default_rng(224 + bias)
    cfg, layers, (lk, lv), req, pos, meta_pos = _epilogue_case(rng, cuda, dtype, L, S, B, H, KV, hd, bias, False)
    outs, qs = [], []
    reset_launch_counts()
    for fn in (qkv_log_append, qkv_log_append_ref):
        k_log, v_log, meta = lk.clone(), lv.clone(), torch.full((S, 2), -1, dtype=torch.int32, device=cuda)
        qs.append(torch.stack([fn(cfg, p, *raw, pos, k_log[layer], v_log[layer], meta, tail, req, meta_pos)[0]
                               for layer, (raw, p) in enumerate(layers)]))
        outs.append((k_log, v_log, meta))
    assert launch_counts()["kv_log_append"] == L
    torch.cuda.synchronize()
    assert torch.equal(outs[0][2], outs[1][2])
    for got, want in ((qs[0], qs[1]), (outs[0][0], outs[1][0]), (outs[0][1], outs[1][1])):
        assert torch.isfinite(got).all()
        if dtype == "bfloat16":
            assert _bf16_ulps(got, want) <= 1
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S,H,KV,causal", [(2, 13, 4, 4, True), (2, 381, 4, 2, True), (1, 1100, 4, 4, True),
                                              (2, 103, 4, 4, False), (1, 768, 32, 32, True)])
def test_flash_attention_hd224(cuda, B, S, H, KV, causal):
    """Head dim 224 (Zamba2-7B-Instruct's shared attention) on the tensor-core
    route: the 256 instantiation over zero-filled columns; the last shape is
    a full-width prefill of the cell's median prompt."""
    rng = np.random.default_rng(S * 10 + H)
    q = _rand(rng, (B, S, H, 224), "bfloat16", cuda)
    k, v = _rand(rng, (B, S, KV, 224), "bfloat16", cuda), _rand(rng, (B, S, KV, 224), "bfloat16", cuda)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert route_counts() == {"tensor_core": 1, "cuda_core": 0}
    _close(got, flash_attention_ref(q, k, v, causal=causal), 3e-2)


def _digest(t) -> str:
    import hashlib

    torch.cuda.synchronize()
    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


# The tensor-core route's outputs at hd 64, 112 and 128 on fixed inputs, read
# on the card from the kernel as it was before the 256 instantiation: adding
# hd 224 leaves the other instantiations' bits alone.
FLASH_BITS = {64: "50ecaad45be61595", 112: "ddd906b73c1a9c71", 128: "6eed9298dcb8d8fc"}


@pytest.mark.parametrize("hd", sorted(FLASH_BITS))
def test_flash_attention_bits_unchanged(cuda, hd):
    g = torch.Generator(device="cuda").manual_seed(hd)
    q, k, v = (torch.randn((2, 381, 8, hd), generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    assert _digest(flash_attention(q, k, v, causal=True)) == FLASH_BITS[hd]


def _mamba_case(dev, B, slots, H=112, P=64, N=64, G=2, W=4, seed=0):
    """Weights, an in-projection row a batch row and filled slots at
    Zamba2-7B-Instruct's widths (A_log and dt_bias drawn as Mamba2 does)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    inner, C = H * P, H * P + 2 * G * N

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    bf = torch.bfloat16
    w = dict(conv_w=rnd(C, W, scale=0.3).to(bf), conv_b=rnd(C, scale=0.1).to(bf),
             dt_bias=torch.log(torch.expm1(torch.exp(torch.rand(H, generator=g) * (math.log(0.1) - math.log(1e-3))
                                                     + math.log(1e-3)))).to(dev, bf),
             A_log=torch.log(1 + 15 * torch.rand(H, generator=g)).to(dev, bf),
             D=(1 + 0.1 * rnd(H)).to(bf), norm_w=(1 + 0.1 * rnd(inner)).to(bf))
    zx = rnd(B, 2 * inner + 2 * G * N + H).to(bf)
    conv = rnd(slots, W - 1, C).to(bf)
    ssm = rnd(slots, H, P, N, scale=0.5)
    return w, zx, conv, ssm


def test_mamba_step_kernel(cuda):
    """One decode token of a Mamba2 layer at published widths (B 16, 112
    heads of 64 in 2 groups, state 64, conv 4 with bias), rows in scattered
    slots and two padded rows: against the plain version, the new SSM states
    within 1e-6 relative (the plain version's rounding points, expf and
    log1pf against torch's), the conv windows exact, y within 2 bf16 ulps
    (the sums' order differs); every slot no live row names untouched but
    the scratch slot; one launch."""
    from repro_torch.kernels.mamba_step.ops import mamba_step
    from repro_torch.kernels.mamba_step.ref import mamba_step_ref

    B, slots = 16, 33
    w, zx, conv, ssm = _mamba_case(cuda, B, slots)
    req = torch.tensor([3, 17, -1, 0, 31, 5, 9, 12, 20, -1, 22, 25, 27, 29, 30, 1], dtype=torch.int32, device=cuda)
    args = (w["conv_w"], w["conv_b"], w["dt_bias"], w["A_log"], w["D"], w["norm_w"], req)
    reset_launch_counts()
    states = []
    for fn in (mamba_step, mamba_step_ref):
        c, s = conv.clone(), ssm.clone()
        y = fn(zx, c, s, *args, groups=2)
        states.append((y, c, s))
    assert launch_counts()["mamba_step"] == 1
    (y, c, s), (y_ref, c_ref, s_ref) = states
    live = req[req >= 0].long()
    untouched = torch.ones(slots, dtype=torch.bool, device=cuda)
    untouched[live] = False
    untouched[-1] = False
    torch.cuda.synchronize()
    assert torch.equal(c[untouched], conv[untouched]) and torch.equal(s[untouched], ssm[untouched])
    assert torch.equal(c[live], c_ref[live])
    torch.testing.assert_close(s[live], s_ref[live], rtol=1e-6, atol=1e-6)
    assert _bf16_ulps(y[req >= 0], y_ref[req >= 0]) <= 2


def test_mamba_step_padded_rows_only_touch_the_scratch_slot(cuda):
    """A batch of padded rows only: every live slot bit-equal after the
    launch."""
    from repro_torch.kernels.mamba_step.ops import mamba_step

    B, slots = 4, 9
    w, zx, conv, ssm = _mamba_case(cuda, B, slots, seed=1)
    req = torch.full((B,), -1, dtype=torch.int32, device=cuda)
    c, s = conv.clone(), ssm.clone()
    mamba_step(zx, c, s, w["conv_w"], w["conv_b"], w["dt_bias"], w["A_log"], w["D"], w["norm_w"], req, groups=2)
    torch.cuda.synchronize()
    assert torch.equal(c[:-1], conv[:-1]) and torch.equal(s[:-1], ssm[:-1])


@pytest.mark.parametrize("B,S", [(1, 768), (1, 300), (2, 517)])
def test_ssd_scan_kernel(cuda, B, S):
    """A Mamba2 layer's prefill scan at published widths (112 heads of 64 in
    2 groups, state 64, chunk 256; S a multiple of the chunk or not) with
    Mamba2's decays: y and the final state within 1e-4 of |plain| + 1 (fp32
    sums in another order); one launch."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    H, P, N, G = 112, 64, 64, 2
    g = torch.Generator(device=cuda).manual_seed(S)
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g, device=cuda)
    xbc = torch.nn.functional.silu(xbc).to(torch.bfloat16)
    dt = torch.exp(torch.rand(B, S, H, generator=g, device=cuda) * math.log(100) + math.log(1e-3))
    loga = dt * -(1 + 15 * torch.rand(H, generator=g, device=cuda))
    D = (1 + 0.1 * torch.randn(H, generator=g, device=cuda)).to(torch.bfloat16)
    kw = dict(heads=H, groups=G, state_dim=N, chunk=256)
    reset_launch_counts()
    y, state = ssd_scan(xbc, dt, loga, D, **kw)
    assert launch_counts()["ssd_scan"] == 1
    y_ref, state_ref = ssd_scan_ref(xbc, dt, loga, D, **kw)
    torch.cuda.synchronize()
    for got, want in ((y, y_ref), (state, state_ref)):
        assert torch.isfinite(got).all()
        assert float(((got - want).abs() / (want.abs() + 1)).max()) <= 1e-4


@pytest.mark.parametrize("rows,d", [(12, 3584), (12, 7168), (3, 64)])
def test_rms_norm_rows_kernel(cuda, rows, d):
    """The decode step's one-launch RMSNorm against ``layers.rmsnorm``:
    within 1 bf16 ulp (the squares summed in another order)."""
    from repro_torch.kernels.mamba_step.ops import rms_norm_rows

    rng = np.random.default_rng(rows * d)
    x = (_rand(rng, (rows, d), "float32", cuda) * 3).to(torch.bfloat16)
    g = (1 + 0.2 * _rand(rng, (d,), "float32", cuda)).to(torch.bfloat16)
    reset_launch_counts()
    got = rms_norm_rows(x, g, 1e-5)
    assert launch_counts()["rms_norm_rows"] == 1
    assert _bf16_ulps(got, layers.rmsnorm(x, g, 1e-5)) <= 1
