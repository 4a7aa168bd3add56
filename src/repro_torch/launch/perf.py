"""Hill-climb runner: the port of ``repro.launch.perf``. It dry-runs named
config variants of three cells through :func:`repro_torch.launch.dryrun.build_cell`
(on the ``meta`` device) and records the roofline terms per iteration.

  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen3 --iter M1_grouped_dispatch
  PYTHONPATH=src python -m repro_torch.launch.perf --all

``remat="dots"`` and ``causal_skip`` change the traced step (its counted
FLOPs move with the analytic ones); ``seq_parallel``, ``fsdp`` and ``zero``
move the per-device bytes taken from the sharding specs (``zero`` also
makes the compute params bf16 with an f32 master) and the collective term
of the step traced on the production ``DeviceMesh``, not the counted
FLOPs, which come from the one-device trace, as each record's
``placement_note`` says.
Results land in results/perf_torch/<cell>__<iter>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import traceback

from repro_torch.configs import get_config

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "perf_torch"

PLACEMENT_NOTE = ("seq_parallel, fsdp and zero move the per-device bytes from the specs and the "
                  "collective term (the step traced on the DeviceMesh), not the counted FLOPs "
                  "(the one-device trace)")


def _moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


# cell key -> (arch, shape, {iter_name: cfg_transform})
CELLS = {
    "qwen3": ("qwen3-moe-235b-a22b", "train_4k", {
        "M0_baseline": lambda c: c,
        "M1_grouped_dispatch": lambda c: _moe(c, dispatch_impl="grouped"),
        "M2_grouped_dots_remat": lambda c: _moe(c, dispatch_impl="grouped").replace(remat="dots"),
        "M3_grouped_dots_causalskip": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True),
        "M4_M3_plus_seqparallel": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True, seq_parallel=True),
        "M5_M4_fsdp_microbatch8": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True, seq_parallel=True, fsdp=True,
            microbatch=8),
        "M6_zero_mixedprec_mb8": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True, seq_parallel=True, zero=True,
            microbatch=8),
        "M7_zero3_fsdp_params_mb8": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True, seq_parallel=True, zero=True,
            fsdp=True, microbatch=8),
    }),
    "deepseek": ("deepseek-v2-236b", "train_4k", {
        "D0_baseline": lambda c: c,
        "D1_grouped_dispatch": lambda c: _moe(c, dispatch_impl="grouped"),
        "D2_grouped_dots": lambda c: _moe(c, dispatch_impl="grouped").replace(remat="dots"),
        "D3_grouped_dots_causalskip": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True),
        "D4_D3_sp_fsdp_microbatch8": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True, seq_parallel=True, fsdp=True,
            microbatch=8),
        "D5_zero_mixedprec_mb8": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True, seq_parallel=True, zero=True,
            microbatch=8),
        "D6_zero3_fsdp_params_mb8": lambda c: _moe(c, dispatch_impl="grouped").replace(
            remat="dots", causal_skip=True, seq_parallel=True, zero=True,
            fsdp=True, microbatch=8),
    }),
    "commandr": ("command-r-plus-104b", "train_4k", {
        "C0_baseline": lambda c: c,
        "C1_seq_parallel": lambda c: c.replace(seq_parallel=True),
        "C2_sp_dots_remat": lambda c: c.replace(seq_parallel=True, remat="dots"),
        "C3_sp_dots_causalskip": lambda c: c.replace(
            seq_parallel=True, remat="dots", causal_skip=True),
        "C4_C3_fsdp": lambda c: c.replace(
            seq_parallel=True, remat="dots", causal_skip=True, fsdp=True),
        "C5_C4_microbatch16": lambda c: c.replace(
            seq_parallel=True, remat="dots", causal_skip=True, fsdp=True,
            microbatch=16),
        "C6_zero_mixedprec_mb16": lambda c: c.replace(
            seq_parallel=True, remat="dots", causal_skip=True, zero=True,
            microbatch=16),
    }),
}


def run_iter(cell: str, it: str, force=False):
    from repro_torch.launch.dryrun import build_cell

    arch, shape, iters = CELLS[cell]
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / f"{cell}__{it}.json"
    if path.exists() and not force:
        print(f"[cached] {cell}/{it}")
        return json.loads(path.read_text())
    cfg = iters[it](get_config(arch))
    try:
        out = build_cell(arch, shape, multi_pod=False, cfg=cfg)
        out["iteration"] = it
        if cfg.seq_parallel or cfg.fsdp or cfg.zero:
            out["placement_note"] = PLACEMENT_NOTE
    except Exception:
        out = {"status": "FAIL", "iteration": it, "error": traceback.format_exc()}
    path.write_text(json.dumps(out, indent=1))
    if out["status"] == "OK":
        r = out["roofline"]
        print(f"[OK] {cell}/{it}: bottleneck={r['bottleneck']} "
              f"t=({r['t_compute_s']:.3f},{r['t_memory_s']:.3f},{r['t_collective_s']})s "
              f"counted_flops={out['counted']['flops']:.4e} "
              f"args={out['memory_analysis']['argument_size_in_bytes']}B "
              f"trace={out['lower_s']}s", flush=True)
    else:
        print(f"[FAIL] {cell}/{it}: {out['error'].strip().splitlines()[-1]}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    ap.add_argument("--iter", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cells = list(CELLS) if args.all or not args.cell else [args.cell]
    fails = 0
    for c in cells:
        iters = CELLS[c][2]
        names = [args.iter] if args.iter else list(iters)
        for it in names:
            out = run_iter(c, it, force=args.force)
            fails += out["status"] == "FAIL"
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
