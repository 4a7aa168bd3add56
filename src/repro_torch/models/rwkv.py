"""RWKV-6 (Finch) block: attention-free time-mix with data-dependent decay
(arXiv:2404.05892) and a squared-ReLU channel-mix: the port of
``repro.models.rwkv``.

Recurrent state per layer: (tm_shift (B,D), cm_shift (B,D), wkv
(B,H,hd,hd) f32). Train/prefill walk time in a Python loop; decode is the
same on one token, returning the new state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import dtensor_mesh, local_region, merge_dims, split_dim

from .layers import Init, dense_init


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor  # (B, D) previous token (time-mix)
    cm_shift: torch.Tensor  # (B, D) previous token (channel-mix)
    wkv: torch.Tensor       # (B, H, hd, hd) f32 state


def _dims(cfg):
    hd = cfg.rwkv_head_size
    return cfg.d_model // hd, hd


def init_rwkv(init: Init, cfg):
    """The reference's leaves; those it uses in f32 (``w0``, ``wd_w2``,
    ``bonus_u``, ``ln_x_w``, ``ln_x_b``) stay f32."""
    D = cfg.d_model
    H, hd = _dims(cfg)
    lora = dd_lora = 64
    f32 = torch.float32
    return {
        # token-shift mixing coefficients (static part)
        "mu_x": init.full((D,), 0.5, f32),
        "mu": init.full((5, D), 0.5, f32),                  # r,w,k,v,g
        # data-dependent lerp lora (v6 ddlerp)
        "ddl_w1": dense_init(init, D, 5 * lora),
        "ddl_w2": init.normal((5, lora, D), 0.01),
        # projections
        "tm_r": dense_init(init, D, H * hd),
        "tm_k": dense_init(init, D, H * hd),
        "tm_v": dense_init(init, D, H * hd),
        "tm_g": dense_init(init, D, H * hd),
        "tm_o": dense_init(init, H * hd, D),
        # data-dependent decay (v6): w = exp(-exp(w0 + lora(x)))
        "w0": init.full((H * hd,), -6.0, f32),
        "wd_w1": dense_init(init, D, dd_lora),
        "wd_w2": init.normal((dd_lora, H * hd), 0.01, f32),
        "bonus_u": init.normal((H, hd), 0.1, f32),
        "ln_x_w": init.full((H * hd,), 1.0, f32),
        "ln_x_b": init.full((H * hd,), 0.0, f32),
        # channel mix
        "cm_mu_r": init.full((D,), 0.5, f32),
        "cm_mu_k": init.full((D,), 0.5, f32),
        "cm_r": dense_init(init, D, D),
        "cm_k": dense_init(init, D, cfg.d_ff),
        "cm_v": dense_init(init, cfg.d_ff, D),
    }


def _ddlerp(p, x, xx):
    """v6 data-dependent token-shift: per-channel lerp coeffs from a LoRA."""
    xd = xx - x
    base = x + xd * p["mu_x"].to(x.dtype)
    z = torch.tanh(base @ p["ddl_w1"].to(x.dtype))          # (...,5*lora)
    z = split_dim(z, -1, (5, z.shape[-1] // 5))
    off = torch.einsum("...fl,fld->...fd", z, p["ddl_w2"].to(x.dtype))
    mix = p["mu"].to(x.dtype) + off                         # (...,5,D)
    return tuple(x + xd * mix[..., i, :] for i in range(5))  # r,w,k,v,g


def _wkv_step(S, r, k, v, w, u):
    """One WKV recurrence step (all (B,H,hd) except S (B,H,hd,hd) f32).
    y = r . (S + u * k^T v);  S' = diag(w) S + k^T v."""
    kv = k[..., :, None] * v[..., None, :]                  # (B,H,hd,hd)
    y = torch.einsum("bhi,bhij->bhj", r, S + u[None, :, :, None] * kv)
    S = w[..., :, None] * S + kv
    return S, y


def _wkv_scan(Sc, rf, kf, vf, w, u):
    """The WKV recurrence over the sequence: (y (B,S,H,hd), final state)."""
    ys = []
    for t in range(rf.shape[1]):
        Sc, y = _wkv_step(Sc, rf[:, t], kf[:, t], vf[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), Sc


def _shifted(x, prev):
    """The previous token of every position: ``prev`` (B, D) or zeros
    before the first."""
    B, _, D = x.shape
    first = prev[:, None, :].to(x.dtype) if prev is not None else torch.zeros(
        (B, 1, D), dtype=x.dtype, device=x.device)
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(p, x, cfg, state: Optional[RWKVState]):
    """x: (B,S,D) -> (y, new_tm_shift, new_wkv)."""
    B, S, D = x.shape
    H, hd = _dims(cfg)
    xx = _shifted(x, state.tm_shift if state is not None else None)
    xr, xw, xk, xv, xg = _ddlerp(p, x, xx)
    r = split_dim(xr @ p["tm_r"].to(x.dtype), 2, (H, hd))
    k = split_dim(xk @ p["tm_k"].to(x.dtype), 2, (H, hd))
    v = split_dim(xv @ p["tm_v"].to(x.dtype), 2, (H, hd))
    g = F.silu(xg @ p["tm_g"].to(x.dtype))
    # data-dependent decay per channel
    wlog = p["w0"] + (torch.tanh(xw @ p["wd_w1"].to(x.dtype)).float()
                      @ p["wd_w2"].float())
    w = split_dim(torch.exp(-torch.exp(wlog)), 2, (H, hd))  # in (0,1)
    u = p["bonus_u"]

    Sc = state.wkv if state is not None else torch.zeros(
        (B, H, hd, hd), dtype=torch.float32, device=x.device)
    rf, kf, vf = r.float(), k.float(), v.float()
    mesh = dtensor_mesh(x)
    if mesh is None:
        y, Sc = _wkv_scan(Sc, rf, kf, vf, w, u)
    else:   # the recurrence on each rank's batch rows and heads
        seq = ("batch", None, "heads_out", None)
        y, Sc = local_region(_wkv_scan, mesh, (Sc, rf, kf, vf, w, u),
                             (("batch", "heads_out", None, None), seq, seq, seq, seq,
                              ("heads_out", None)), outs=(1, 0))
    y = merge_dims(y, 2)
    # per-head group norm (over hd within a head), population variance
    yf = split_dim(y.float(), 2, (H, hd))
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yf = merge_dims((yf - mu) * torch.rsqrt(var + 64e-5), 2)
    y = (yf * p["ln_x_w"] + p["ln_x_b"]).to(x.dtype)
    out = (y * g) @ p["tm_o"].to(x.dtype)
    return out, x[:, -1, :], Sc


def rwkv_channel_mix(p, x, cfg, state: Optional[RWKVState]):
    xx = _shifted(x, state.cm_shift if state is not None else None)
    xd = xx - x
    xr = x + xd * p["cm_mu_r"].to(x.dtype)
    xk = x + xd * p["cm_mu_k"].to(x.dtype)
    r = torch.sigmoid(xr @ p["cm_r"].to(x.dtype))
    k = torch.square(F.relu(xk @ p["cm_k"].to(x.dtype)))
    return r * (k @ p["cm_v"].to(x.dtype)), x[:, -1, :]


def init_rwkv_state(cfg, batch: int, dtype, device) -> RWKVState:
    H, hd = _dims(cfg)
    return RWKVState(torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
                     torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
                     torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device))
