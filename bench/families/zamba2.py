"""The "zamba2" family: Zamba2-7B-Instruct's published block
(``family_module: "zamba2"``), served by the program's ``models/zamba2.py``
through ``TieredEngine``.

What the harness needs of it: the weights' layout (the program's schema
names; ``A_log`` and ``dt_bias`` drawn as Mamba2 initialises them, so that
random decays are realistic), the program's configuration object, the model
FLOPs of a decode step, the attention calls (13 shared-block invocations a
token: 13 paged attention calls a decode step, 13 flash calls a prefill),
and the comparison that decides ``correct``.

Which requests are checked: a sample of the finished requests drawn from
the seed, and the longest among them, each by one full forward of the plain
reference over its prompt and the tokens it was served (no batch replay:
nothing in the model depends on the rows beside a request). With
``control`` the reference in fp8 puts its first choice at each of the same
positions in place of the served token.

The plain reference below (``Zamba2Reference``) is a copy of the program's
``src/repro_torch/models/zamba2_ref.py``, imported from nothing of the
program; a CPU test holds the two equal bit for bit. On the card it runs
after the window with the program's state freed, a layer's weights turned
to float32 where they are used, so that it needs no float32 copy of the
model.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---- the weights' layout ------------------------------------------------------


class Draw:
    """A leaf's ``scale`` that maps the seed's standard normals, in place,
    through their CDF to uniforms u and on to ``fn(u)``: ``benchkit/weights``
    scales each normal leaf by ``mul_(scale)``, which this object's
    ``__torch_function__`` takes over. The draw stays one ``torch.randn``
    from the seed."""

    def __init__(self, fn, what: str):
        self.fn, self.what = fn, what

    def __repr__(self):
        return f"Draw({self.what})"

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is not torch.Tensor.mul_:
            raise TypeError(f"Draw stands for a scale; {func} is not mul_")
        t, draw = args
        return t.copy_(draw.fn(torch.special.ndtr(t.float())))


def _a_log(u: torch.Tensor) -> torch.Tensor:
    """A = -exp(A_log) with -A uniform on [1, 16] (Mamba2's A_init_range)."""
    return torch.log(1 + 15 * u)


def _dt_bias(u: torch.Tensor) -> torch.Tensor:
    """softplus^-1 of dt log-uniform on [0.001, 0.1], floored at 1e-4
    (Mamba2's dt_min, dt_max and dt_init_floor)."""
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001)).clamp(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))


A_LOG, DT_BIAS = Draw(_a_log, "log U[1, 16]"), Draw(_dt_bias, "softplus^-1 of log-uniform [1e-3, 0.1]")


def widths(model: dict):
    """(H, P, N, G, W, inner, conv channels C, in-projection width)."""
    s = model["ssm"]
    H, P, N, G, W = s["heads"], s["head_dim"], s["state_dim"], model["ssm_groups"], s["conv_dim"]
    inner = H * P
    return H, P, N, G, W, inner, inner + 2 * G * N, 2 * inner + 2 * G * N + H


def _matrices(model: dict) -> Dict[str, tuple]:
    """Every matrix leaf: (stack size, fan in, fan out)."""
    d, Ff, r = model["d_model"], model["d_ff"], model["adapter_rank"]
    L, nb, ns = model["n_layers"], model["num_mem_blocks"], len(model["hybrid_layer_ids"])
    H, P, N, G, W, inner, C, width = widths(model)
    q, kv = model["n_heads"] * model["head_dim"], model["n_kv_heads"] * model["head_dim"]
    m = {"mamba.in_proj": (L, d, width), "mamba.out_proj": (L, inner, d),
         "shared.wq": (nb, 2 * d, q), "shared.wk": (nb, 2 * d, kv), "shared.wv": (nb, 2 * d, kv),
         "shared.wo": (nb, q, d), "shared.w_gate_up": (nb, d, 2 * Ff), "shared.w_down": (nb, Ff, d),
         "sites.linear": (ns, d, d)}
    if r:
        m["sites.adapter_in"], m["sites.adapter_out"] = (ns, d, r), (ns, r, 2 * Ff)
    return m


def layout(model: dict) -> List[tuple]:
    """Every leaf in sorted name order: matrices N(0, 1/fan_in), the
    embedding N(0, 0.02^2), the conv's taps and bias N(0, 0.29^2) (the std of
    the published conv's U(-1/2, 1/2) init), A_log and dt_bias by their
    ``Draw``, norm gains and D one."""
    d, V, L = model["d_model"], model["vocab"], model["n_layers"]
    nb = model["num_mem_blocks"]
    H, P, N, G, W, inner, C, width = widths(model)
    leaves = [(name, (n, i, o), "normal", 1.0 / math.sqrt(i)) for name, (n, i, o) in _matrices(model).items()]
    leaves += [
        ("embed", (V, d), "normal", 0.02), ("final_norm", (d,), "ones", 1.0),
        ("mamba.norm", (L, d), "ones", 1.0), ("mamba.conv_w", (L, C, W), "normal", 0.29),
        ("mamba.dt_bias", (L, H), "normal", DT_BIAS), ("mamba.A_log", (L, H), "normal", A_LOG),
        ("mamba.D", (L, H), "ones", 1.0), ("mamba.norm_y", (L, inner), "ones", 1.0),
        ("shared.attn_norm", (nb, 2 * d), "ones", 1.0), ("shared.ffn_norm", (nb, d), "ones", 1.0),
    ]
    if model["conv_bias"]:
        leaves.append(("mamba.conv_b", (L, C), "normal", 0.29))
    if not model["tie_embeddings"]:
        leaves.append(("lm_head", (d, V), "normal", 0.02))
    return sorted(leaves, key=lambda leaf: leaf[0])


def program_config(name: str, model: dict):
    from repro_torch.configs import SSMConfig, Zamba2Config

    kw = dict(model)
    kw["ssm"] = SSMConfig(**kw["ssm"])
    kw["hybrid_layer_ids"] = tuple(kw["hybrid_layer_ids"])
    return Zamba2Config(name=name, **kw)


def decode_flops(model: dict, contexts) -> float:
    """One decode step, a row a context: 2 x the matrix parameters a token
    touches (every layer's in- and out-projections, each site's block, its
    adapter and linear, the logits), the conv's 2 x W a channel and the
    state's 6 a state element a layer (decay, input, sum, C.S), and the
    shared attention's 4 x H x hd a position attended a site."""
    d, V, L = model["d_model"], model["vocab"], model["n_layers"]
    ns, nb = len(model["hybrid_layer_ids"]), model["num_mem_blocks"]
    H, P, N, G, W, inner, C, width = widths(model)
    per_stack = {name: i * o for name, (_, i, o) in _matrices(model).items()}
    mamba = per_stack["mamba.in_proj"] + per_stack["mamba.out_proj"]
    site = sum(v for k, v in per_stack.items() if k.startswith(("shared.", "sites.")))
    per_token = 2 * (L * mamba + ns * site + d * V) + L * (2 * W * C + 6 * H * P * N)
    attn = 4 * ns * model["n_heads"] * model["head_dim"]
    return float(sum(per_token + attn * c for c in contexts))


def attention_calls(model: dict) -> Dict[str, int]:
    """One paged attention call a site a decode step, one flash call a site a prefill."""
    n = len(model["hybrid_layer_ids"])
    return {"paged_attention": n, "flash_attention": n}


def replays_batches(model: dict) -> bool:
    return False


# ---- the comparison -------------------------------------------------------------


def checked_requests(rec: dict, cell: dict, seed: int) -> List[dict]:
    """``check.requests`` finished requests drawn from the seed, and the
    longest served."""
    done = [r for r in rec["requests"] if not r["failed"] and r["req"].done]
    if not done:
        return []
    n = min(cell["check"]["requests"], len(done))
    rng = np.random.default_rng([seed, 2])
    picked = {done[i]["key"]: done[i] for i in rng.choice(len(done), size=n, replace=False)}
    longest = max(done, key=lambda r: len(r["req"].out))
    picked.setdefault(longest["key"], longest)
    return [picked[k] for k in sorted(picked)]


def checked_gaps(run, ctx, control: bool = False):
    """(gaps, facts about what was checked) of a finished run."""
    items = checked_requests(run.rec, ctx.cell, ctx.seed)
    if not items:
        return None, {"reason": "no finished request"}
    ref = Zamba2Reference(ctx.model, run.params)
    ctl = Zamba2Reference(ctx.model, run.params, quant="fp8") if control else None
    gaps: Dict[str, list] = {"program": [], "control": []}
    for r in items:
        prompt, served = r["prompt"], list(r["req"].out)
        toks = torch.as_tensor(prompt + served[:-1], device=ref.device)
        lg = ref.forward(toks)[len(prompt) - 1:]
        idx = torch.arange(len(served), device=ref.device)
        best = lg.max(-1).values
        gaps["program"] += (best - lg[idx, torch.as_tensor(served, device=ref.device)]).tolist()
        if ctl is not None:
            choice = ctl.forward(toks)[len(prompt) - 1:].argmax(-1)
            gaps["control"] += (best - lg[idx, choice]).tolist()
        del lg
    return gaps, {"requests": len(items), "tokens": len(gaps["program"])}


# ---- the plain reference: a copy of src/repro_torch/models/zamba2_ref.py -------

F8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (its amax to
    448), back in float32."""
    amax = t.abs().amax().clamp(min=1e-12)
    scale = F8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def concat_input(x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """The shared block's input: the residual stream beside the embeddings."""
    return torch.cat([x, x0], dim=-1)


class Zamba2Reference:
    def __init__(self, model: dict, params: Dict[str, torch.Tensor], quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.m, self.p = model, params
        self.q = fp8 if quant == "fp8" else (lambda t: t)
        s = model["ssm"]
        self.H, self.P, self.N, self.W = s["heads"], s["head_dim"], s["state_dim"], s["conv_dim"]
        self.G, self.chunk = model["ssm_groups"], s["chunk"]
        self.inner = self.H * self.P
        self.eps = model["norm_eps"]
        self.sites = {layer: j for j, layer in enumerate(model["hybrid_layer_ids"])}
        self.device = params["embed"].device

    # ---- pieces ----
    def w(self, name: str, i: Optional[int] = None) -> torch.Tensor:
        """A weight (of stack entry ``i``) in float32, rounded by the control
        where it is a matrix."""
        t = (self.p[name] if i is None else self.p[name][i]).float()
        return self.q(t) if t.dim() >= 2 else t

    def mm(self, x: torch.Tensor, name: str, i: Optional[int] = None) -> torch.Tensor:
        return self.q(x) @ self.w(name, i)

    def rms(self, x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, heads, hd): rotate-half RoPE over all hd dims."""
        S, hd = x.shape[0], x.shape[-1]
        half = hd // 2
        inv = 1.0 / (self.m["rope_theta"] ** (torch.arange(0, half, device=x.device, dtype=torch.float64) * 2 / hd))
        ang = (torch.arange(S, device=x.device, dtype=torch.float64)[:, None] * inv).float()[:, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Causal attention of one sequence, q/k/v (S, heads, hd), as many
        K/V heads as query heads (Zamba2's 32 and 32) -> (S, heads x hd),
        scores scaled by (hd / 2)^-1/2, in blocks of 256 query rows."""
        S, H, hd = q.shape
        scale = (hd / 2) ** -0.5
        qq, kq, vq = self.q(q), self.q(k), self.q(v)
        out = []
        for i in range(0, S, 256):
            j = min(S, i + 256)
            s = torch.einsum("chd,shd->hcs", qq[i:j], kq[:j]) * scale
            mask = torch.arange(j, device=q.device)[None] > torch.arange(i, j, device=q.device)[:, None]
            w = torch.softmax(s.masked_fill(mask, float("-inf")), -1)
            out.append(torch.einsum("hcs,shd->chd", self.q(w), vq[:j]).reshape(j - i, H * hd))
        return torch.cat(out)

    def shared_block(self, j: int, x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """Site j's invocation of block j mod num_mem_blocks: its output
        after the site's linear."""
        b, m = j % self.m["num_mem_blocks"], self.m
        S, H, hd = x.shape[0], m["n_heads"], m["head_dim"]
        u = self.rms(concat_input(x, x0), self.p["shared.attn_norm"][b], self.eps)
        q = self.rope(self.mm(u, "shared.wq", b).view(S, H, hd))
        k = self.rope(self.mm(u, "shared.wk", b).view(S, m["n_kv_heads"], hd))
        v = self.mm(u, "shared.wv", b).view(S, m["n_kv_heads"], hd)
        a = self.mm(self.attention(q, k, v), "shared.wo", b)
        h = self.rms(a, self.p["shared.ffn_norm"][b], self.eps)
        gu = self.mm(h, "shared.w_gate_up", b)
        if m["adapter_rank"]:
            gu = gu + self.mm(self.mm(h, "sites.adapter_in", j), "sites.adapter_out", j)
        g, up = gu.chunk(2, dim=-1)
        act = F.gelu(g) if m["ffn_act"] == "gelu" else F.silu(g)
        return self.mm(self.mm(act * up, "shared.w_down", b), "sites.linear", j)

    def ssd(self, x, dt, A, Bh, Ch):
        """y (S, H, P) of S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t,
        y_t = C_t . S_t, from a zero state: x (S, H, P), dt (S, H), A (H,),
        Bh / Ch (S, H, N)."""
        S = x.shape[0]
        state = torch.zeros(self.H, self.P, self.N, device=x.device)
        ys = []
        for c0 in range(0, S, self.chunk):
            c1 = min(S, c0 + self.chunk)
            la = dt[c0:c1] * A  # (c, H) log decays
            cum = la.cumsum(0)
            seg = cum[:, None, :] - cum[None, :, :]  # (i, j, H): sum of la over (j, i]
            n = c1 - c0
            keep = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            decay = torch.exp(seg.masked_fill(~keep[..., None], float("-inf")))
            dtx = dt[c0:c1, :, None] * x[c0:c1]  # (c, H, P)
            scores = torch.einsum("ihn,jhn->ijh", Ch[c0:c1], Bh[c0:c1]) * decay
            y = torch.einsum("ijh,jhp->ihp", scores, dtx)
            y = y + torch.einsum("ihn,hpn->ihp", Ch[c0:c1], state) * torch.exp(cum)[..., None]
            tail = torch.exp(cum[-1:] - cum)  # (c, H): decay from each position to the chunk's end
            state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum("jhp,jhn->hpn", dtx * tail[..., None],
                                                                             Bh[c0:c1])
            ys.append(y)
        return torch.cat(ys)

    def mamba(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Mamba2 layer i's mixer over the normed sequence h (S, d)."""
        S, H, P, N, G, inner = h.shape[0], self.H, self.P, self.N, self.G, self.inner
        z, xbc, dt = self.mm(h, "mamba.in_proj", i).split([inner, inner + 2 * G * N, H], dim=-1)
        cw = self.p["mamba.conv_w"][i].float()  # (C, W)
        xp = torch.cat([torch.zeros(self.W - 1, xbc.shape[1], device=h.device), xbc])
        conv = sum(xp[t:t + S] * cw[:, t] for t in range(self.W))
        if self.m["conv_bias"]:
            conv = conv + self.p["mamba.conv_b"][i].float()
        xbc = F.silu(conv)
        x = xbc[:, :inner].view(S, H, P)
        group = torch.arange(H, device=h.device) // (H // G)
        Bh = xbc[:, inner:inner + G * N].view(S, G, N)[:, group]
        Ch = xbc[:, inner + G * N:].view(S, G, N)[:, group]
        dt = F.softplus(dt + self.p["mamba.dt_bias"][i].float())
        A = -torch.exp(self.p["mamba.A_log"][i].float())
        y = self.ssd(x, dt, A, Bh, Ch) + self.p["mamba.D"][i].float()[:, None] * x
        y = y.reshape(S, inner) * F.silu(z)
        yg = y.view(S, G, inner // G)
        y = (yg * torch.rsqrt((yg * yg).mean(-1, keepdim=True) + 1e-5)).reshape(S, inner)
        return self.mm(y * self.p["mamba.norm_y"][i].float(), "mamba.out_proj", i)

    # ---- the whole pass ----
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Causal forward of one sequence (S,) -> logits (S, V), float32."""
        x0 = self.p["embed"][tokens.to(self.device).long()].float()
        x = x0
        for i in range(self.m["n_layers"]):
            m = x
            if i in self.sites:
                m = x + self.shared_block(self.sites[i], x, x0)
            x = x + self.mamba(i, self.rms(m, self.p["mamba.norm"][i], self.eps))
        head = self.w("embed").T if self.m["tie_embeddings"] else self.w("lm_head")
        return self.q(self.rms(x, self.p["final_norm"], self.eps)) @ head
