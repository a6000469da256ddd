"""Plain PyTorch version of one decode token of a Mamba2 layer over
per-request state slots (``csrc/mamba_step.cu``; the JAX package has no
such kernel).

Shapes: ``zxbcdt`` (B, 2 x inner + 2 x G x N + H), the in-projection of one
token a row, laid out [z | x, B, C | dt]; ``conv_state`` (slots, W - 1, C)
holds each slot's last W - 1 pre-conv (x, B, C) inputs, C = inner + 2 x G x
N; ``ssm_state`` (slots, H, P, N) fp32. Row b reads and writes slot
``req_ids[b]``; a padded row (-1) the last slot, a scratch slot no request
owns. Both states are updated IN PLACE.

The recipe, and where it rounds (the kernel rounds at the same points):
the conv taps summed in fp32 in tap order, then the bias, then silu, the
result rounded to the storage type; dt = softplus(dt + dt_bias) and
dA = exp(dt x -exp(A_log)) in fp32; S = S dA + (dt x) B, each product and
the sum rounded on its own; y = C.S + D x; y silu(z); RMS-normalised over
each of the G groups of inner / G channels (eps), times ``norm_w``, rounded
to the storage type. Head h reads B and C of group h // (H / G).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def scratch_slot(conv_state: torch.Tensor) -> int:
    return conv_state.shape[0] - 1


def mamba_step_ref(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A_log, D, norm_w, req_ids, *,
                   groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Returns y (B, inner) in ``zxbcdt``'s dtype: the gated, group-normalised
    output, ready for the out-projection."""
    Bsz = zxbcdt.shape[0]
    _, H, P, N = ssm_state.shape
    G, inner = groups, H * P
    C = conv_state.shape[-1]
    z, xbc, dt_raw = zxbcdt.split([inner, C, H], dim=-1)
    slot = torch.where(req_ids >= 0, req_ids, scratch_slot(conv_state)).long()
    full = torch.cat([conv_state[slot], xbc[:, None]], dim=1)  # (B, W, C)
    acc = torch.zeros((Bsz, C), dtype=torch.float32, device=zxbcdt.device)
    for i in range(conv_w.shape[-1]):
        acc = acc + full[:, i].float() * conv_w[:, i].float()
    if conv_b is not None:
        acc = acc + conv_b.float()
    cv = F.silu(acc).to(zxbcdt.dtype).float()
    x = cv[:, :inner].view(Bsz, H, P)
    group = torch.arange(H, device=zxbcdt.device) // (H // G)
    Bh = cv[:, inner:inner + G * N].view(Bsz, G, N)[:, group]  # (B, H, N)
    Ch = cv[:, inner + G * N:].view(Bsz, G, N)[:, group]
    dt = F.softplus(dt_raw.float() + dt_bias.float())  # (B, H)
    dA = torch.exp(dt * -torch.exp(A_log.float()))
    dtx = dt[..., None] * x  # (B, H, P)
    S = ssm_state[slot] * dA[..., None, None] + dtx[..., None] * Bh[:, :, None, :]
    y = (S * Ch[:, :, None, :]).sum(-1) + D.float()[:, None] * x  # (B, H, P)
    y = y.reshape(Bsz, inner) * F.silu(z.float())
    yg = y.view(Bsz, G, inner // G)
    yg = yg * torch.rsqrt((yg * yg).mean(-1, keepdim=True) + eps)
    out = (yg.reshape(Bsz, inner) * norm_w.float()).to(zxbcdt.dtype)
    conv_state[slot] = full[:, 1:]
    ssm_state[slot] = S
    return out
