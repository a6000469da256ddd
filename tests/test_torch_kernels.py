"""Plain PyTorch versions of the four kernels vs the JAX oracles, over the
shape sweeps of tests/test_kernels.py (CPU).

Tolerances: fp32 3e-5; bf16 2e-2 (paged) and 3e-2 (flash) — the JAX sweep's
own; append and compaction are copies and must be bit-exact (atol 0), and
so is the decode step's K/V epilogue fused into the append (the same ops in
the same order as JAX's project_qkv run op by op).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.kv_log_append.ref import kv_log_append_ref as jax_append_ref
from repro.kernels.log_compact.ref import log_compact_ref as jax_compact_ref
from repro.kernels.paged_attention.kernel import paged_decode_attention_pallas
from repro.kernels.paged_attention.ops import paged_decode_attention as jax_paged_ops
from repro.kernels.paged_attention.ref import paged_decode_attention_ref as jax_paged_ref
from repro.configs.base import ModelConfig as JaxConfig
from repro.models import layers as jax_layers
from repro_torch.configs import ModelConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.kv_log_append.ops import kv_log_append, qkv_log_append
from repro_torch.kernels.log_compact.ops import log_compact, log_compact_tiers
from repro_torch.models import layers
from repro_torch.models.layers import AttnParams
from repro_torch.kernels.paged_attention.ops import paged_decode_attention, split_plan
from repro_torch.kernels.paged_attention.ref import combine_ref, paged_decode_attention_split_ref

torch.set_num_threads(2)

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jd, td = DT[dtype]
    j = jnp.asarray(x, jd)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(j).copy())
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(rng, shape, dtype):
    return _pair(rng.normal(size=shape).astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,hd,page,P,N",
    [(2, 4, 2, 32, 8, 8, 3), (3, 8, 4, 64, 16, 16, 4), (1, 6, 2, 16, 4, 6, 5), (4, 4, 4, 128, 8, 12, 2)],
)
def test_paged_attention_plain_vs_jax(B, H, KV, hd, page, P, N, dtype):
    rng = np.random.default_rng(B * 100 + H)
    jq, q = _rand(rng, (B, H, hd), dtype)
    jk, kp = _rand(rng, (P, page, KV, hd), dtype)
    jv, vp = _rand(rng, (P, page, KV, hd), dtype)
    table = rng.choice(P, size=B * N, replace=B * N > P).reshape(B, N).astype(np.int32)
    table[0, N - 1] = -1  # one non-resident page
    lengths = rng.integers(1, N * page + 1, size=B).astype(np.int32)
    ref = jax_paged_ref(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths))
    out = paged_decode_attention(q, kp, vp, torch.from_numpy(table), torch.from_numpy(lengths))
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def _log_case():
    rng = np.random.default_rng(7)
    B, H, KV, hd, page, P, N, S = 3, 8, 4, 64, 16, 16, 4, 8
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              [(B, H, hd), (P, page, KV, hd), (P, page, KV, hd), (S, KV, hd), (S, KV, hd)]]
    table = rng.choice(P, size=B * N, replace=False).reshape(B, N).astype(np.int32)
    meta = np.full((S, 2), -1, np.int32)
    meta[0], meta[1] = (1, 60), (1, 61)
    page_lengths = np.array([48, 48, 48], np.int32)  # compaction watermark
    lengths = np.array([48, 62, 48], np.int32)  # the log covers the rest
    return arrays, table, meta, page_lengths, lengths


def test_paged_attention_log_merge_vs_jax():
    """With the write log: the plain version against the JAX oracle and the
    JAX ops (Pallas kernel in interpret mode + jnp log merge)."""
    (q, kp, vp, lk, lv), table, meta, plen, lengths = _log_case()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths, lk, lv, meta)]
    ref = jax_paged_ref(*jargs, page_lengths=jnp.asarray(plen))
    pallas = jax_paged_ops(*jargs, page_lengths=jnp.asarray(plen), use_pallas=True)
    targs = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths, lk, lv, meta)]
    out = paged_decode_attention(*targs, page_lengths=torch.from_numpy(plen))
    np.testing.assert_allclose(_np(out), _np(ref), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=3e-5, rtol=3e-5)


def test_merge_log_matches_jax_combine():
    """The plain combine (the CUDA combine kernel's algorithm) fed the Pallas
    kernel's page pass as a single split (acc = out * l), merged with the
    write log, against the JAX ops (Pallas in interpret mode + jnp merge)."""
    (q, kp, vp, lk, lv), table, meta, plen, lengths = _log_case()
    out_p, m_p, l_p = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.asarray(plen)
    )
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths, lk, lv, meta)]
    want = jax_paged_ops(*jargs, page_lengths=jnp.asarray(plen), use_pallas=True)
    B, H, hd = q.shape
    KV = kp.shape[2]
    g = H // KV
    m = torch.from_numpy(np.array(m_p)).reshape(B, KV, 1, g)
    l = torch.from_numpy(np.array(l_p)).reshape(B, KV, 1, g)
    acc = torch.from_numpy(np.array(out_p)).reshape(B, KV, 1, g, hd) * l[..., None]
    got = combine_ref(
        torch.from_numpy(q), acc, m, l, torch.from_numpy(lk), torch.from_numpy(lv),
        torch.from_numpy(meta), torch.from_numpy(lengths), torch.arange(3, dtype=torch.int32),
    )
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def _split_case(dtype):
    """Four rows: pages + log with a non-resident page; every page beyond the
    watermark (log only); all pages, no log; a padded row (request -1)."""
    rng = np.random.default_rng(11)
    B, H, KV, hd, page, P, N, S = 4, 8, 4, 64, 8, 24, 6, 16
    arrays = [_rand(rng, s, dtype) for s in [(B, H, hd), (P, page, KV, hd), (P, page, KV, hd), (S, KV, hd), (S, KV, hd)]]
    table = rng.choice(P, size=B * N, replace=False).reshape(B, N).astype(np.int32)
    table[0, 2] = -1
    plen = np.array([37, 0, 48, 0], np.int32)
    lengths = np.array([41, 6, 48, 0], np.int32)
    req = np.array([0, 1, 2, -1], np.int32)
    meta = np.full((S, 2), -1, np.int32)
    rows = [(0, 37 + i) for i in range(4)] + [(1, i) for i in range(6)] + [(5, 3), (5, 4)]
    for slot, row in zip(rng.permutation(S), rows):
        meta[slot] = row
    return arrays, table, meta, plen, lengths, req


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages_per_split", [1, 2, 4, 6])
def test_paged_split_plain_vs_jax(pages_per_split, dtype):
    """The kernels' split-and-combine algorithm (plain version) against JAX's
    paged_decode_attention with the write log (Pallas, interpret mode): 1, 2,
    4 and all N pages a split; splits without a valid key, a row whose every
    page lies beyond the watermark, and a padded row."""
    pairs, table, meta, plen, lengths, req = _split_case(dtype)
    (jq, q), (jk, kp), (jv, vp), (jlk, lk), (jlv, lv) = pairs
    want = jax_paged_ops(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths), jlk, jlv, jnp.asarray(meta),
        page_lengths=jnp.asarray(plen), req_ids=jnp.asarray(req), use_pallas=True,
    )
    t = torch.from_numpy
    got = paged_decode_attention_split_ref(
        q, kp, vp, t(table), t(lengths), lk, lv, t(meta), page_lengths=t(plen), req_ids=t(req),
        pages_per_split=pages_per_split,
    )
    assert torch.isfinite(got.float()).all()
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(_np(got)[:3], _np(want)[:3], atol=tol, rtol=tol)
    # the padded row has no valid key: a finite 0 (the jnp oracle's softmax
    # over an all-masked row gives the mean of V there, which nothing reads)
    np.testing.assert_array_equal(_np(got)[3], 0.0)


def test_split_plan_covers_the_card():
    assert split_plan(4, 8, 40, 16, 132) == (2, 20)  # full width: 640 blocks
    pps, n_split = split_plan(1, 2, 40, 16, 132)
    assert (pps, n_split) == (1, 40)
    pps, n_split = split_plan(2, 2, 3, 8, 132)
    assert n_split * pps >= 3 and pps == 1


def test_padded_row_is_finite():
    """A padded batch row (request -1) has no valid key: finite, not NaN."""
    (q, kp, vp, lk, lv), table, meta, _, lengths = _log_case()
    plen = np.array([0, 48, 48], np.int32)
    targs = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths, lk, lv, meta)]
    out = paged_decode_attention(
        *targs, page_lengths=torch.from_numpy(plen), req_ids=torch.tensor([-1, 1, 2], dtype=torch.int32)
    )
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 96, 6, 2, 16), (1, 35, 4, 2, 16)])
def test_flash_attention_plain_vs_jax(B, S, H, KV, hd, causal, dtype):
    rng = np.random.default_rng(S + H)
    jq, q = _rand(rng, (B, S, H, hd), dtype)
    jk, k = _rand(rng, (B, S, KV, hd), dtype)
    jv, v = _rand(rng, (B, S, KV, hd), dtype)
    ref = jax_flash_ref(jq, jk, jv, causal=causal)
    out = flash_attention(q, k, v, causal=causal)
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("L,S,B,KV,hd,tail", [(2, 32, 4, 2, 16, 0), (3, 64, 8, 4, 32, 17), (1, 16, 2, 1, 8, 14)])
def test_kv_log_append_plain_vs_jax(L, S, B, KV, hd, tail):
    rng = np.random.default_rng(L * S)
    jlk, lk = _rand(rng, (L, S, KV, hd), "bfloat16")
    jlv, lv = _rand(rng, (L, S, KV, hd), "bfloat16")
    jkn, kn = _rand(rng, (L, B, KV, hd), "bfloat16")
    jvn, vn = _rand(rng, (L, B, KV, hd), "bfloat16")
    req = rng.integers(0, 8, B).astype(np.int32)
    pos = rng.integers(0, 100, B).astype(np.int32)
    meta = np.full((S, 2), -1, np.int32)
    rk, rv, rm, rt = jax_append_ref(jlk, jlv, jnp.asarray(meta), jnp.int32(tail), jkn, jvn,
                                    jnp.asarray(req), jnp.asarray(pos))
    tmeta = torch.from_numpy(meta.copy())
    new_tail = kv_log_append(lk, lv, tmeta, tail, kn, vn, torch.from_numpy(req), torch.from_numpy(pos))
    assert new_tail == int(rt)
    np.testing.assert_array_equal(lk.view(torch.int16).numpy(), np.asarray(rk).view(np.int16))
    np.testing.assert_array_equal(lv.view(torch.int16).numpy(), np.asarray(rv).view(np.int16))
    np.testing.assert_array_equal(tmeta.numpy(), np.asarray(rm))


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("L,S,B,H,KV,hd,tail", [(2, 16, 4, 4, 2, 16, 5), (3, 32, 3, 8, 4, 32, 17)])
def test_qkv_log_append_plain_vs_jax(L, S, B, H, KV, hd, tail, bias, qk_norm):
    """The fused K/V epilogue's plain version against JAX's project_qkv and
    the decode step's inline meta and log writes (core/tiering.py:155-172),
    run op by op, layer by layer: q, the log rows and the meta rows bit for
    bit. Row 1 is padding (request -1, meta position -1, RoPE position 0)."""
    d = 2 * H * hd // 4
    kw = dict(name="t", family="dense", n_layers=L, d_model=d, n_heads=H, n_kv_heads=KV, d_ff=2 * d, vocab=64,
              head_dim=hd, qkv_bias=bias, qk_norm=qk_norm, rope_theta=10_000.0, norm_eps=1e-6)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(L * 10 + bias + 2 * qk_norm)
    jlk, lk = _rand(rng, (L, S, KV, hd), "bfloat16")
    jlv, lv = _rand(rng, (L, S, KV, hd), "bfloat16")
    req = rng.integers(0, 8, B).astype(np.int32)
    req[1] = -1
    pos = rng.integers(0, 600, B).astype(np.int32)
    pos[1] = 0
    meta_pos = np.where(req >= 0, pos, -1).astype(np.int32)
    jmeta, tmeta = jnp.full((S, 2), -1, jnp.int32), torch.full((S, 2), -1, dtype=torch.int32)
    t = torch.from_numpy
    with jax.disable_jit():
        for layer in range(L):
            jx, _ = _rand(rng, (B, 1, d), "bfloat16")
            w = {n: _rand(rng, shape, "bfloat16") for n, shape in
                 (("wq", (d, H * hd)), ("wk", (d, KV * hd)), ("wv", (d, KV * hd)), ("wo", (H * hd, d)))}
            if bias:
                w.update({n: _rand(rng, (m * hd,), "bfloat16") for n, m in (("bq", H), ("bk", KV), ("bv", KV))})
            if qk_norm:
                w.update({n: _pair(1.0 + 0.2 * rng.normal(size=hd), "bfloat16") for n in ("q_norm", "k_norm")})
            jq, jk, jv = jax_layers.project_qkv(
                jcfg, jax_layers.AttnParams(**{n: a for n, (a, _) in w.items()}), jx, jnp.asarray(pos)[:, None])
            jmeta = jax.lax.dynamic_update_slice_in_dim(
                jmeta, jnp.stack([jnp.asarray(req), jnp.asarray(meta_pos)], axis=-1), tail, axis=0)
            jlk = jlk.at[layer].set(jax.lax.dynamic_update_slice_in_dim(jlk[layer], jk[:, 0], tail, axis=0))
            jlv = jlv.at[layer].set(jax.lax.dynamic_update_slice_in_dim(jlv[layer], jv[:, 0], tail, axis=0))
            # the raw projections, as project_qkv forms them
            raw = [_pair(np.asarray(jnp.einsum("bsd,dh->bsh", jx, w[n][0]), np.float32), "bfloat16")[1]
                   for n in ("wq", "wk", "wv")]
            q, new_tail = qkv_log_append(
                cfg, AttnParams(**{n: b for n, (_, b) in w.items()}), *raw, t(pos), lk[layer], lv[layer], tmeta,
                tail, t(req), t(meta_pos))
            assert new_tail == tail + B
            np.testing.assert_array_equal(q.view(torch.int16).numpy(), np.asarray(jq[:, 0]).view(np.int16))
    np.testing.assert_array_equal(lk.view(torch.int16).numpy(), np.asarray(jlk).view(np.int16))
    np.testing.assert_array_equal(lv.view(torch.int16).numpy(), np.asarray(jlv).view(np.int16))
    np.testing.assert_array_equal(tmeta.numpy(), np.asarray(jmeta))


def test_kv_log_append_overflow_raises():
    lk = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="overflows"):
        kv_log_append(lk, lk.clone(), torch.zeros(8, 2, dtype=torch.int32), 6, torch.zeros(1, 3, 1, 16),
                      torch.zeros(1, 3, 1, 16), torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("L,P,page,KV,hd,S,F,seed", [
    (2, 6, 8, 2, 16, 32, 4, 0), (1, 4, 16, 4, 32, 16, 2, 0), (2, 6, 8, 2, 16, 32, 4, 1),
])
def test_log_compact_plain_vs_jax(L, P, page, KV, hd, S, F, seed):
    rng = np.random.default_rng(P * page + seed)
    jkp, kp = _rand(rng, (L, P, page, KV, hd), "bfloat16")
    jvp, vp = _rand(rng, (L, P, page, KV, hd), "bfloat16")
    jlk, lk = _rand(rng, (L, S, KV, hd), "bfloat16")
    jlv, lv = _rand(rng, (L, S, KV, hd), "bfloat16")
    meta = np.full((S, 2), -1, np.int32)
    # a handful of log entries over (request, position); with seed 1 the
    # positions repeat, so "later slot wins" is exercised
    span = P * page if seed == 0 else 3 * page
    for i in range(S // 2):
        meta[i] = (int(rng.integers(0, 3)), int(rng.integers(0, span)))
    slots = rng.choice(P, size=F - 1, replace=False)
    pairs = rng.choice(3 * 3, size=F - 1, replace=False)
    rows = [[int(pr // 3), int(pr % 3), int(s)] for pr, s in zip(pairs, slots)] + [[-1, 0, 0]]
    ft = np.asarray(rows, np.int32)
    rk, rv = jax_compact_ref(jkp, jvp, jlk, jlv, jnp.asarray(meta), jnp.asarray(ft))
    log_compact(kp, vp, lk, lv, torch.from_numpy(meta), torch.from_numpy(ft))
    np.testing.assert_array_equal(kp.view(torch.int16).numpy(), np.asarray(rk).view(np.int16))
    np.testing.assert_array_equal(vp.view(torch.int16).numpy(), np.asarray(rv).view(np.int16))


@pytest.mark.parametrize("L,P,H_pages,page,KV,hd,S,seed", [(2, 10, 12, 8, 2, 16, 32, 0), (1, 10, 9, 16, 4, 32, 16, 1)])
def test_log_compact_tiers_plain_vs_jax(L, P, H_pages, page, KV, hd, S, seed):
    """Compaction into both tiers in one call against two calls of JAX's
    log_compact_ref (fast pool, then host pool), bit for bit; some dirty
    pages are not resident in the fast pool (fast slot -1)."""
    rng = np.random.default_rng(100 + seed)
    jfk, fk = _rand(rng, (L, P, page, KV, hd), "bfloat16")
    jfv, fv = _rand(rng, (L, P, page, KV, hd), "bfloat16")
    jhk, hk = _rand(rng, (L, H_pages, page, KV, hd), "bfloat16")
    jhv, hv = _rand(rng, (L, H_pages, page, KV, hd), "bfloat16")
    jlk, lk = _rand(rng, (L, S, KV, hd), "bfloat16")
    jlv, lv = _rand(rng, (L, S, KV, hd), "bfloat16")
    meta = np.full((S, 2), -1, np.int32)
    for i in range(S - 3):  # positions repeat: later slot wins
        meta[i] = (int(rng.integers(0, 3)), int(rng.integers(0, 3 * page)))
    pages = sorted({(int(r), int(p) // page) for r, p in meta if r >= 0})
    fast_slots = rng.choice(P, size=len(pages), replace=False)
    rows = [[r, lp, int(fast_slots[j]) if j % 3 else -1, r * 3 + lp] for j, (r, lp) in enumerate(pages)]
    targets = np.asarray(rows, np.int32)
    jmeta = jnp.asarray(meta)
    rfk, rfv = jax_compact_ref(jfk, jfv, jlk, jlv, jmeta, jnp.asarray(targets[targets[:, 2] >= 0][:, [0, 1, 2]]))
    rhk, rhv = jax_compact_ref(jhk, jhv, jlk, jlv, jmeta, jnp.asarray(targets[:, [0, 1, 3]]))
    log_compact_tiers(fk, fv, hk, hv, lk, lv, torch.from_numpy(meta), torch.from_numpy(targets))
    for got, want in ((fk, rfk), (fv, rfv), (hk, rhk), (hv, rhv)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


def test_cpu_calls_launch_nothing():
    """On the CPU every wrapper runs its plain version: no launch counted."""
    reset_launch_counts()
    q = torch.zeros(1, 4, 2, 16)
    flash_attention(q, q[:, :, :2], q[:, :, :2])
    layers.moe_slots(torch.tensor([[1, 0], [1, 1]]), 2, 2)
    assert launch_counts() == {"paged_attention": 0, "log_compact": 0, "kv_log_append": 0, "flash_attention": 0,
                               "moe_routing": 0}
