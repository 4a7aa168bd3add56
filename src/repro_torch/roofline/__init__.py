"""Roofline models of the port on an NVIDIA H100: the analytic per-device
FLOP/byte model of every (arch x shape) cell and the SpMV bandwidth lane
(``analytic``), and the three-term roofline over counts taken from torch
(``analysis``: the card's peaks, :class:`~.analysis.CountingMode`)."""
from .analysis import (F32_FLOPS, HBM_BW, LINK_BW, PEAK_FLOPS, TF32_FLOPS, TF32X3_FLOPS,
                       CollectiveStats, CountingMode, Counts, Roofline, analyze, model_flops)
from .analytic import AnalyticCost, SpmvRoofline, cost, spmv_predicted_speedup, spmv_roofline

__all__ = ["F32_FLOPS", "HBM_BW", "LINK_BW", "PEAK_FLOPS", "TF32_FLOPS", "TF32X3_FLOPS",
           "AnalyticCost", "CollectiveStats", "CountingMode", "Counts", "Roofline",
           "SpmvRoofline", "analyze", "cost", "model_flops", "spmv_predicted_speedup",
           "spmv_roofline"]
