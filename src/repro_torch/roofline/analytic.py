"""Analytic per-device FLOP/byte model for the roofline terms: the port's
copy of ``repro.roofline.analytic``, its arithmetic in the same order of
operations (so the floats are equal), over the port's ``configs``.

WHY THIS EXISTS: the reference lowers its steps with XLA, whose cost
analysis counts a ``while`` body once, so every scan (over layers, kv
chunks, recurrence steps) under-counts by its trip count. The port's
counterpart of that analysis (:mod:`repro_torch.roofline.analysis`) counts
an eager trace, which runs every layer, so its counts are whole wherever
the whole step is traced. The dry run records both, and the roofline terms
use this analytic model.

Conventions (documented assumptions):
  - matmul-parameter FLOPs: fwd 2NT, bwd 4NT, remat re-fwd +2NT
  - attention scores/PV: full S^2 (the chunked kernel computes masked chunks
    too, unless ``causal_skip``)
  - training params/optimizer in f32 (4B), serving weights in bf16 (2B)
  - activations bf16, k_act ~= 12 streamed tensors per layer per direction

The SpMV lane at the bottom carries the H100's constants.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclass
class AnalyticCost:
    flops_per_device: float
    hbm_bytes_per_device: float
    detail: dict


@functools.lru_cache(maxsize=64)
def param_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(active, total) parameters; each count builds the model on the
    ``meta`` device, so a config's are kept."""
    return cfg.active_param_count(), cfg.param_count()


def _layer_counts(cfg: ModelConfig):
    """(attn_layers, mamba_layers, rwkv_layers)."""
    if cfg.rwkv:
        return 0, 0, cfg.n_layers
    if cfg.attn_period:
        n_attn = cfg.n_layers // cfg.attn_period
        return n_attn, cfg.n_layers - n_attn, 0
    return cfg.n_layers + cfg.encoder_layers, 0, 0


def attention_flops_fwd(cfg: ModelConfig, B: int, Sq: int, Skv: int) -> float:
    """QK + PV for ONE attention layer, full (unskipped) S^2."""
    H = cfg.n_heads
    if cfg.mla is not None:
        hd_qk = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        hd_v = cfg.mla.v_head_dim
    else:
        hd_qk = hd_v = cfg.hd
    return 2.0 * B * H * Sq * Skv * (hd_qk + hd_v)


def recurrence_flops_fwd(cfg: ModelConfig, B: int, S: int) -> float:
    """One mamba or rwkv layer's recurrence (excl. projections = in params)."""
    if cfg.rwkv:
        H = cfg.d_model // cfg.rwkv_head_size
        return 5.0 * B * S * H * cfg.rwkv_head_size ** 2
    if cfg.mamba is not None:
        di = cfg.mamba.expand * cfg.d_model
        return 12.0 * B * S * di * cfg.mamba.d_state
    return 0.0


def cost(cfg: ModelConfig, shape: ShapeCell, chips: int,
         microbatches: int = 1) -> AnalyticCost:
    B, S = shape.global_batch, shape.seq_len
    N, P_total = param_counts(cfg)
    n_attn, n_mamba, n_rwkv = _layer_counts(cfg)
    remat = 1.0 if (cfg.remat == "full" and shape.kind == "train") else 0.0
    # causal chunk skipping computes the lower triangle only (+ diagonal
    # chunk overhead): ~0.52 of the full S^2 at 1k chunks over 4k seq
    attn_frac = 0.52 if cfg.causal_skip else 1.0

    if shape.kind == "train":
        T = B * S
        f_param = (6.0 + 2.0 * remat) * N * T
        f_attn = n_attn * attention_flops_fwd(cfg, B, S, S) * (3.0 + remat) * attn_frac
        f_rec = (n_mamba + n_rwkv) * recurrence_flops_fwd(cfg, B, S) * (3.0 + remat)
        flops = (f_param + f_attn + f_rec) / chips

        pbytes = 4.0  # f32 master params
        # params: fwd + bwd + remat reads, grads rw, opt read p/m/v write p/m/v
        b_param = P_total * pbytes * (2 + remat) + P_total * 4.0 * (2 + 6)
        k_act = 12.0
        L = max(1, cfg.n_layers + cfg.encoder_layers)
        b_act = k_act * L * T * cfg.d_model * 2.0 * (2 + remat)
        b_logits = 3.0 * T * cfg.vocab * 2.0 * 2
        # params shard over TP only (replicated across DP) -> /tp per device;
        # activations/logits shard over batch (and vocab) -> /chips.
        tp = min(chips, 16)
        hbm = b_param / tp + b_logits / chips + b_act / chips
        detail = dict(f_param=f_param, f_attn=f_attn, f_rec=f_rec,
                      b_param=b_param, b_act=b_act, b_logits=b_logits)
        return AnalyticCost(flops, hbm, detail)

    if shape.kind == "prefill":
        T = B * S
        f_param = 2.0 * N * T
        f_attn = n_attn * attention_flops_fwd(cfg, B, S, S)
        f_rec = (n_mamba + n_rwkv) * recurrence_flops_fwd(cfg, B, S)
        flops = (f_param + f_attn + f_rec) / chips
        tp = min(chips, 16)
        b_param = P_total * 2.0 / tp              # bf16 serving weights
        b_act = 8.0 * max(1, cfg.n_layers + cfg.encoder_layers) * T * cfg.d_model * 2.0 / chips
        b_cache = _cache_bytes(cfg, B, S) / chips
        hbm = b_param + b_act + b_cache
        return AnalyticCost(flops, hbm, dict(f_param=f_param, f_attn=f_attn,
                                             f_rec=f_rec, b_param=b_param * tp,
                                             b_act=b_act * chips, b_cache=b_cache * chips))

    # decode: one token, cache of length S
    f_param = 2.0 * N * B
    f_attn = n_attn * attention_flops_fwd(cfg, B, 1, S)
    f_rec = (n_mamba + n_rwkv) * recurrence_flops_fwd(cfg, B, 1)
    flops = (f_param + f_attn + f_rec) / chips
    tp = min(chips, 16)
    b_param = P_total * 2.0 / tp
    b_cache = _cache_bytes(cfg, B, S)            # read whole cache every token
    b_act = 20.0 * max(1, cfg.n_layers) * B * cfg.d_model * 2.0
    hbm = b_param + (b_cache + b_act) / chips
    return AnalyticCost(flops, hbm, dict(f_param=f_param, f_attn=f_attn, f_rec=f_rec,
                                         b_param=b_param * tp, b_cache=b_cache))


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Global KV/state cache bytes (bf16)."""
    n_attn, n_mamba, n_rwkv = _layer_counts(cfg)
    n_attn -= cfg.encoder_layers  # encoder has no decode cache
    total = 0.0
    if cfg.mla is not None:
        total += cfg.n_layers * B * S * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * 2.0
    elif n_attn:
        total += n_attn * 2 * B * S * cfg.n_kv_heads * cfg.hd * 2.0
    if n_mamba and cfg.mamba:
        di = cfg.mamba.expand * cfg.d_model
        total += n_mamba * B * di * (cfg.mamba.d_state * 4.0 + (cfg.mamba.d_conv - 1) * 2.0)
    if n_rwkv:
        H = cfg.d_model // cfg.rwkv_head_size
        total += n_rwkv * B * H * cfg.rwkv_head_size ** 2 * 4.0
    if cfg.is_encdec:
        total += cfg.n_layers * 2 * B * cfg.frontend_tokens * cfg.n_kv_heads * cfg.hd * 2.0
    return total


# ---------------------------------------------------------------- SpMV ----
#
# The SpMV lane of the same idea: SpMV performs 2 FLOPs per nonzero against
# a stream of (value + index) bytes, so it lives on the bandwidth roof at
# every practical density and its speed is set by bytes-per-nnz.

#: streaming bandwidth per platform (bytes/s). gpu: the HBM3 rate of an
#: NVIDIA H100 SXM (data sheet, at its 700 W power limit), the rate every
#: ``bound_ms`` of ``chip_smoke.py`` divides by (``analysis.HBM_BW``); cpu:
#: a typical server-DRAM figure.
SPMV_BANDWIDTH = {"gpu": 3.35e12, "cpu": 20e9}

#: fixed per-call overhead (s): launch, wrapper and dispatch. gpu: the
#: events time of one resident ``dia_spmv`` call at HPCG 13^3 (0.03258 ms,
#: against a 7.6e-5 ms bound, so the whole reading is the per-call floor),
#: ``chip_smoke.py`` phase 2, NVIDIA H100 80GB HBM3 at a 700.00 W limit.
SPMV_LATENCY_S = {"gpu": 3.258e-05, "cpu": 5e-6}


@dataclass
class SpmvRoofline:
    """Bandwidth-model prediction for one SpMV (format, precision) variant."""

    streamed_bytes: float   # matrix storage + x/y traffic
    time_s: float
    gflops: float
    bytes_per_nnz: float


def spmv_roofline(nnz: int, matrix_bytes: float, nrows: int, ncols: int,
                  platform: str = "gpu",
                  bandwidth: float | None = None,
                  x_bytes_per_col: float = 4.0) -> SpmvRoofline:
    """Predict SpMV time/GFLOP/s from streamed bytes on the bandwidth roof.

    ``matrix_bytes`` is the variant's storage volume (e.g.
    ``SparseOperator.nbytes`` or ``core.select.storage_bytes``); x is read
    once and y written once (f32), which is exact for the streaming kernels
    and a lower bound for gather-heavy ones.
    """
    bw = bandwidth if bandwidth is not None else SPMV_BANDWIDTH.get(
        platform, SPMV_BANDWIDTH["gpu"])
    lat = SPMV_LATENCY_S.get(platform, SPMV_LATENCY_S["gpu"])
    streamed = float(matrix_bytes) + x_bytes_per_col * (nrows + ncols)
    t = lat + streamed / bw
    flops = 2.0 * max(1, nnz)
    return SpmvRoofline(streamed, t, flops / t / 1e9,
                        float(matrix_bytes) / max(1, nnz))


def spmv_predicted_speedup(base_bytes: float, variant_bytes: float,
                           nnz: int, nrows: int, ncols: int,
                           platform: str = "gpu",
                           bandwidth: float | None = None) -> float:
    """Predicted throughput ratio variant/baseline from their storage
    volumes alone — the bandwidth saving a compressed/narrow variant buys.
    >1 means the variant should be faster; latency and x/y traffic damp the
    ratio below the raw byte ratio."""
    a = spmv_roofline(nnz, base_bytes, nrows, ncols, platform, bandwidth)
    b = spmv_roofline(nnz, variant_bytes, nrows, ncols, platform, bandwidth)
    return a.time_s / b.time_s
