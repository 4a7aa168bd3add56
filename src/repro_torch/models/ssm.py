"""Mamba (S6) block for the Jamba hybrid, a selective SSM with a conv
frontend: the port of ``repro.models.ssm``.

Train/prefill walk time in a Python loop (carry: the (B, d_inner, d_state)
f32 state); decode is a single recurrence step against a (conv window, ssm
state) cache and returns the new state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import dtensor_mesh, local_region

from .layers import Init, dense_init


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner) trailing inputs
    ssm: torch.Tensor   # (B, d_inner, d_state) f32


def _dims(cfg):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, m.d_state, m.d_conv


def init_mamba(init: Init, cfg):
    """The reference's leaves; ``dt_bias``, ``A_log`` and ``D`` stay f32
    (the first two are used in f32)."""
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    f32 = torch.float32
    dt = torch.clamp(init.uniform((d_inner,)) * (0.1 - 1e-3) + 1e-3, min=1e-4)
    A = torch.arange(1, d_state + 1, dtype=f32, device=init.device)[None].repeat(d_inner, 1)
    return {
        "in_proj": dense_init(init, cfg.d_model, 2 * d_inner),
        "conv_w": init.normal((d_conv, d_inner), 0.1),
        "conv_b": init.zeros((d_inner,)),
        "x_proj": dense_init(init, d_inner, dt_rank + 2 * d_state),
        "dt_proj": dense_init(init, dt_rank, d_inner),
        "dt_bias": torch.log(torch.exp(dt) - 1.0),
        "A_log": torch.log(A),
        "D": torch.ones((d_inner,), dtype=f32, device=init.device),
        "out_proj": dense_init(init, d_inner, cfg.d_model),
    }


def _ssm_step(h, xt, dt, Bt, Ct, A):
    """One recurrence step. h:(B,di,ds) f32; xt,dt:(B,di); Bt,Ct:(B,ds)."""
    dA = torch.exp(dt[..., None] * A[None])                 # (B, di, ds)
    dBx = (dt * xt)[..., None] * Bt[:, None, :]             # (B, di, ds)
    h = h * dA + dBx
    y = torch.einsum("bds,bs->bd", h, Ct)                   # (B, di)
    return h, y


def _scan(h, xcf, dt, Bc, Cc, A):
    """The recurrence over the sequence: (y (B,S,di) f32, final state)."""
    ys = []
    for t in range(xcf.shape[1]):
        h, y = _ssm_step(h, xcf[:, t], dt[:, t], Bc[:, t], Cc[:, t], A)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _pre_scan(p, x, cfg, conv_ctx=None):
    """Shared projections; x: (B,S,D). Returns the scan inputs and the new
    conv window."""
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    B, S, _ = x.shape
    xz = x @ p["in_proj"].to(x.dtype)                       # (B,S,2*di)
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    # depthwise causal conv over time, summed from int 0 as the reference
    ctx = conv_ctx if conv_ctx is not None else torch.zeros(
        (B, d_conv - 1, d_inner), dtype=xi.dtype, device=x.device)
    xpad = torch.cat([ctx.to(xi.dtype), xi], dim=1)
    conv_w = p["conv_w"].to(xi.dtype)
    xc = sum(xpad[:, i:i + S] * conv_w[i] for i in range(d_conv))
    xc = F.silu(xc + p["conv_b"].to(xi.dtype))
    proj = xc @ p["x_proj"].to(xi.dtype)                    # (B,S,dtr+2ds)
    dt_r = proj[..., :dt_rank]
    Bc, Cc = proj[..., dt_rank:dt_rank + d_state], proj[..., dt_rank + d_state:]
    dt = F.softplus((dt_r @ p["dt_proj"].to(xi.dtype)).float() + p["dt_bias"])
    new_ctx = xpad[:, S:, :] if S >= d_conv - 1 else xpad[:, -(d_conv - 1):, :]
    return xc, z, dt, Bc.float(), Cc.float(), new_ctx


def mamba_forward(p, x, cfg, state: Optional[MambaState] = None
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence forward. x: (B,S,D) -> (B,S,D), final state."""
    d_inner, _, d_state, _ = _dims(cfg)
    B = x.shape[0]
    A = -torch.exp(p["A_log"])
    conv_ctx = state.conv if state is not None else None
    xc, z, dt, Bc, Cc, new_ctx = _pre_scan(p, x, cfg, conv_ctx)
    h = state.ssm if state is not None else torch.zeros(
        (B, d_inner, d_state), dtype=torch.float32, device=x.device)
    xcf = xc.float()
    mesh = dtensor_mesh(x)
    if mesh is None:
        y, h = _scan(h, xcf, dt, Bc, Cc, A)
    else:   # the recurrence on each rank's batch rows and channels
        seq, st = ("batch", None, "ffn_hidden"), ("batch", None, None)
        y, h = local_region(_scan, mesh, (h, xcf, dt, Bc, Cc, A),
                            (("batch", "ffn_hidden", None), seq, seq, st, st,
                             ("ffn_hidden", None)), outs=(1, 0))
    y = y.to(x.dtype)                                       # (B,S,di)
    y = y + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, MambaState(new_ctx.to(x.dtype), h)


def mamba_decode(p, x, cfg, state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """Single-token step. x: (B,1,D) -> (out, new state)."""
    A = -torch.exp(p["A_log"])
    xc, z, dt, Bc, Cc, new_ctx = _pre_scan(p, x, cfg, state.conv)
    h, y = _ssm_step(state.ssm, xc[:, 0].float(), dt[:, 0], Bc[:, 0], Cc[:, 0], A)
    y = y.to(x.dtype)[:, None, :] + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, MambaState(new_ctx.to(x.dtype), h)


def init_mamba_state(cfg, batch: int, dtype, device) -> MambaState:
    d_inner, _, d_state, d_conv = _dims(cfg)
    return MambaState(torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
                      torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device))
