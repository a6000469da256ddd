"""The decoder family's plain reference (``families/decoder.py``): a decoder
forward in plain PyTorch, float32 with TF32 off, from the configuration
file's ``model`` sizes (as the program runs them; ``departures`` in the
file says where that differs from the published model). It imports nothing
of the program and takes only the weights and the tokens the benchmark made.

Per layer: x += wo(attn(rope(qknorm(wq h)), rope(qknorm(wk h)), wv h)) with
h = rmsnorm(x); x += ffn(rmsnorm(x)); logits = rmsnorm(x) @ lm_head (or the
embedding's transpose when tied). The FFN is SwiGLU, or the capacity-bounded
top-k MoE: softmax router, the top k by probability (ties to the lower id),
gates renormalised over the k, each expert taking at most
``max(1, int(T k cf / E))`` (token, choice) pairs claimed token-major,
choice-minor, a pair past its expert's capacity dropped.

``Reference.forward`` is the causal forward of one sequence (batch 1: the
program's prefill, and, for a dense FFN, the same math as decoding through
any cache). ``Reference.replay`` follows an engine's admissions and decode
batches (rows in the program's row order, ``T`` the program's batch width)
so that the MoE's capacity sees the same rows; it recomputes every K/V
itself.

``quant="fp8"``: the control. Every matmul and attention operand is rounded
to float8 e4m3 (per-tensor scale) before the product, the precision below
the configuration's bf16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

F8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (its amax to
    448), back in float32."""
    amax = t.abs().amax().clamp(min=1e-12)
    scale = F8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Reference:
    def __init__(self, model: dict, params: Dict[str, torch.Tensor], quant: Optional[str] = None,
                 consume: bool = False):
        """Float32 copies of ``params``; with ``consume`` each leaf is taken
        out of the caller's dict as it is copied (the caller's memory goes
        as the reference's comes)."""
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.m = model
        self.q = (lambda t: fp8(t)) if quant == "fp8" else (lambda t: t)
        self.p = {}
        for name in list(params):
            w = (params.pop(name) if consume else params[name]).float()
            self.p[name] = self.q(w) if w.dim() >= 2 and "norm" not in name else w
        self.L, self.d = model["n_layers"], model["d_model"]
        self.H, self.KV, self.hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
        self.eps = model["norm_eps"]
        self.device = next(iter(self.p.values())).device

    # ---- pieces ----
    def rms(self, x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * g

    def mm(self, x, w):
        return self.q(x) @ w

    def rope(self, x, pos):
        """x (..., S, heads, hd); pos (S,) or (rows,) integer."""
        half = self.hd // 2
        inv = 1.0 / (self.m["rope_theta"] ** (torch.arange(0, half, device=x.device, dtype=torch.float64) * 2
                                              / self.hd))
        ang = (pos.double()[:, None] * inv).float()[:, None, :]  # (S, 1, half)
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def qkv(self, l, h, pos):
        p, n = self.p, h.shape[0]
        q = self.mm(h, p["blocks.wq"][l]).view(n, self.H, self.hd)
        k = self.mm(h, p["blocks.wk"][l]).view(n, self.KV, self.hd)
        v = self.mm(h, p["blocks.wv"][l]).view(n, self.KV, self.hd)
        if self.m.get("qk_norm"):
            q, k = self.rms(q, p["blocks.q_norm"][l]), self.rms(k, p["blocks.k_norm"][l])
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, k, v, valid):
        """q (n, H, hd); k, v (n, S, KV, hd); valid (n, S) bool -> (n, H*hd)."""
        n, S = k.shape[:2]
        g = self.H // self.KV
        qg = self.q(q).view(n, self.KV, g, self.hd)
        s = torch.einsum("nkgh,nskh->nkgs", qg, self.q(k)) / math.sqrt(self.hd)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        w = torch.softmax(s, -1)
        return torch.einsum("nkgs,nskh->nkgh", self.q(w), self.q(v)).reshape(n, self.H * self.hd)

    def ffn(self, l, x, T: Optional[int] = None):
        """x (n, d): SwiGLU, or the MoE with capacity from ``T`` rows (default n)."""
        p, moe = self.p, self.m.get("moe")
        if not moe:
            g = self.mm(x, p["blocks.w_gate"][l])
            u = self.mm(x, p["blocks.w_up"][l])
            return self.mm(torch.nn.functional.silu(g) * u, p["blocks.w_down"][l])
        E, k, cf = moe["num_experts"], moe["top_k"], moe["capacity_factor"]
        n = x.shape[0]
        cap = max(1, int((T or n) * k * cf / E))
        probs = torch.softmax(self.mm(x, p["blocks.router"][l]), -1)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :k], idx[:, :k]
        gates = gates / gates.sum(-1, keepdim=True)
        flat = idx.reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, E)
        slot = ((onehot.cumsum(0) - 1) * onehot).sum(-1)  # pairs claimed before, same expert
        keep = (slot < cap).view(n, k)
        # each kept pair into its expert's (cap, d) buffer, dropped pairs to a spare row
        dest = torch.where(keep, idx * cap + slot.view(n, k), E * cap).reshape(-1)
        buf = torch.zeros(E * cap + 1, self.d, device=x.device)
        buf[dest] = self.q(x)[:, None].expand(n, k, self.d).reshape(-1, self.d)
        xe = buf[:E * cap].view(E, cap, self.d)
        h = torch.nn.functional.silu(xe @ p["blocks.we_gate"][l]) * (xe @ p["blocks.we_up"][l])
        y = (self.q(h) @ p["blocks.we_down"][l]).reshape(E * cap, self.d)
        picked = y[dest.clamp(max=E * cap - 1)].view(n, k, self.d)
        return (picked * (gates * keep)[..., None]).sum(1)

    def logits(self, x):
        w = self.p["embed"].T if self.m.get("tie_embeddings") else self.p["lm_head"]
        return self.mm(self.rms(x, self.p["final_norm"]), w)

    def causal(self, q, k, v):
        """Causal attention of one sequence: q (S, H, hd), k, v (S, KV, hd)
        -> (S, H*hd), in blocks of 256 query rows."""
        S, g = q.shape[0], self.H // self.KV
        qg, kq, vq = self.q(q).view(S, self.KV, g, self.hd), self.q(k), self.q(v)
        out = []
        for i in range(0, S, 256):
            j = min(S, i + 256)
            s = torch.einsum("ckgh,skh->kgcs", qg[i:j], kq[:j]) / math.sqrt(self.hd)
            mask = torch.arange(j, device=q.device)[None] > torch.arange(i, j, device=q.device)[:, None]
            w = torch.softmax(s.masked_fill(mask, float("-inf")), -1)
            out.append(torch.einsum("kgcs,skh->ckgh", self.q(w), vq[:j]).reshape(j - i, -1))
        return torch.cat(out)

    def prefill(self, tokens: torch.Tensor, kv=None) -> torch.Tensor:
        """Causal forward of one sequence (S,) -> final hidden states (S, d);
        ``kv(l, k, v)`` receives each layer's K/V."""
        S = tokens.shape[0]
        pos = torch.arange(S, device=self.device)
        x = self.p["embed"][tokens.long()]
        for l in range(self.L):
            h = self.rms(x, self.p["blocks.attn_norm"][l])
            q, k, v = self.qkv(l, h, pos)
            if kv is not None:
                kv(l, k, v)
            x = x + self.mm(self.causal(q, k, v), self.p["blocks.wo"][l])
            x = x + self.ffn(l, self.rms(x, self.p["blocks.mlp_norm"][l]))
        return x

    # ---- whole passes ----
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Causal forward of one sequence (S,) -> logits (S, V)."""
        return self.logits(self.prefill(tokens.to(self.device)))

    @torch.no_grad()
    def replay(self, prompts: Dict[int, Sequence[int]], events: List[tuple],
               reduce: Callable[[int, int, torch.Tensor], object]) -> Dict[int, list]:
        """Follow an engine: ``events`` in order, each ("admit", rid) or
        ("step", rows, T) with rows [(rid, input token)] in the program's row
        order and T its batch width. ``reduce(rid, k, logits (V,))`` is
        called for the k-th output token of each request (the admission's
        first, then one a step); returns {rid: [its values in order]}."""
        n_tok = {rid: len(p) for rid, p in prompts.items()}
        for ev in events:
            if ev[0] == "step":
                for rid, _ in ev[1]:
                    n_tok[rid] += 1
        # one packed K/V buffer a layer: request r's positions at off[r] + [0, n_tok[r])
        off, total = {}, 0
        for rid in sorted(prompts):
            off[rid], total = total, total + n_tok[rid]
        kc = torch.zeros(self.L, total, self.KV, self.hd, device=self.device)
        vc = torch.zeros_like(kc)
        length = {rid: 0 for rid in prompts}
        out: Dict[int, list] = {rid: [] for rid in prompts}
        for ev in events:
            if ev[0] == "admit":
                rid = ev[1]
                toks = torch.as_tensor(prompts[rid], device=self.device)
                S = toks.shape[0]

                def keep(l, k, v, at=off[rid], S=S):
                    kc[l, at:at + S], vc[l, at:at + S] = k, v

                x = self.prefill(toks, keep)
                length[rid] = S
                out[rid].append(reduce(rid, 0, self.logits(x[-1:])[0]))
                continue
            _, rows, T = ev
            rids = [r for r, _ in rows]
            base = torch.as_tensor([off[r] for r in rids], device=self.device)
            pos = torch.as_tensor([length[r] for r in rids], device=self.device)
            n_ctx = int(pos.max()) + 1
            ar = torch.arange(n_ctx, device=self.device)[None]
            valid = ar <= pos[:, None]
            at = base[:, None] + torch.minimum(ar, pos[:, None])  # (rows, n_ctx) rows of the packed buffer
            x = self.p["embed"][torch.as_tensor([t for _, t in rows], device=self.device).long()]
            for l in range(self.L):
                h = self.rms(x, self.p["blocks.attn_norm"][l])
                q, k, v = self.qkv(l, h, pos)
                kc[l, base + pos], vc[l, base + pos] = k, v
                o = self.attend(q, kc[l][at], vc[l][at], valid)
                x = x + self.mm(o, self.p["blocks.wo"][l])
                x = x + self.ffn(l, self.rms(x, self.p["blocks.mlp_norm"][l]), T)
            lg = self.logits(x)
            for i, r in enumerate(rids):
                length[r] += 1
                out[r].append(reduce(r, len(out[r]), lg[i]))
        return out
