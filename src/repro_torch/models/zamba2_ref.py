"""The published Zamba2 forward in plain PyTorch: the reference the
"zamba2" family (``models/zamba2.py``) is held to. Float32 with TF32 off,
one sequence, no cache, no batching, no kernel, and nothing of the port's
models or kernels: it takes the sizes (``model``, the keys of
``configs.Zamba2Config`` with ``ssm`` a dict) and the flat parameters the
port's schema names, and converts each weight to float32 where it is used,
so that only the bf16 weights are held. The benchmark keeps a copy in
``bench/families/zamba2.py``; a CPU test holds the two equal bit for bit.

The equations are transformers' Zamba2 (``modeling_zamba2.py``): the shared
block on concat(x, x0) with no residual of its own, its output through the
site's linear into the next Mamba layer's input only; scores scaled by
(hd / 2)^-1/2; the GELU FFN with the site's rank-r adapter on its gate/up
projection; the Mamba2 mixer with a biased conv, B and C in groups (head h
reads group h // (H / G)) and the gated RMS norm per group; a tied head.
The SSD is evaluated chunk by chunk (the published "naive" form: within a
chunk from segment sums of the log decays, across chunks through the
carried state).

``quant="fp8"``: the control. Every matmul and attention operand is rounded
to float8 e4m3 under a per-tensor scale before the product, the precision
below the configuration's bf16.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

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
