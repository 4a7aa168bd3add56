"""Multi-pod dry run on the ``meta`` device: the port of
``repro.launch.dryrun``.

For every (arch x shape) cell on the production meshes it builds the model
and optimizer state with no allocation, takes the per-device memory from the
sharding specs, counts one traced step (the train step with its backward
and the AdamW update, the prefill, or the decode) and records the roofline
terms.

``meta`` is the translation of the reference's ``jax.eval_shape`` plus its
512 forced host devices, not a fallback: a ``meta`` tensor has a shape and
a dtype and no storage, so a step at full width runs through every op of
the port (the dispatch, the MoE lane, the chunked attention) without
touching a device. What XLA gives the reference, the port takes from torch:
``memory_analysis()`` becomes the per-device bytes of each leaf under its
spec, ``cost_analysis()`` and the HLO's collectives become a
:class:`~repro_torch.roofline.analysis.CountingMode` over the traced step.

The trace is whole where the reference's is not (XLA counts a ``while``
body once), but a full-depth trace at 4k or 32k tokens is out of reach for
the recurrent families, whose layers loop over tokens in Python. So each
step is traced with one layer of each layer group, and again with one more
layer of a group, and the difference, times the group's layer count, is
added (the reference's loop multiplier, applied to a whole count). A model
with Mamba or RWKV layers trains and prefills at three short sequences, and
the counts are extended to the cell's by the polynomial through them
(degree 2: linear for the recurrence, quadratic for an attention layer).
The record's ``traced`` entry says what was traced.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys
import time
import traceback
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import (SHAPES, ShapeCell, cell_applicable, get_config, list_archs,
                                 shape_by_name)
from repro_torch.distributed.sharding import (param_paths, params_pspecs, sharding_context,
                                              spec_for)
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import analytic
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.tree import leaves, tree_map

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

META = torch.device("meta")
#: A model with recurrent layers is traced at SEQ_FIT x (1, 2, 3) tokens
#: (train and prefill) and extended to the cell's sequence.
SEQ_FIT = 8
NO_COLLECTIVE = ("not traced: the model places nothing over several cards "
                 "(logical_constraint returns its input), so the traced step holds no "
                 "collective and no collective term exists")
NO_TEMP = "not measured: the model runs on one device"
NO_COMPILE = "no compiled program: the step runs eagerly"


# ------------------------------------------------------------ input specs ----

def input_specs(cfg, shape):
    """``meta`` stand-ins for every model input of this cell (the decode's
    ``pos`` is a Python int: the decode step writes its cache slot there)."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    extra = {}
    if cfg.frontend == "vision":
        extra["patches"] = torch.empty((B, cfg.frontend_tokens, cfg.d_model), dtype=f32,
                                       device=META)
    if cfg.frontend == "audio":
        extra["frames"] = torch.empty((B, cfg.frontend_tokens, cfg.d_model), dtype=f32,
                                      device=META)
    if shape.kind == "train":
        return dict({"tokens": torch.empty((B, S), dtype=i32, device=META),
                     "targets": torch.empty((B, S), dtype=i32, device=META)}, **extra)
    if shape.kind == "prefill":
        return {"tokens": torch.empty((B, S), dtype=i32, device=META), "extra": extra or None}
    # decode: one new token against a seq_len cache
    return {"token": torch.empty((B, 1), dtype=i32, device=META), "pos": S - 1,
            "extra": extra or None}


def batch_shardings(specs, mesh):
    """Spec tuples of :func:`input_specs`' leaves (the reference's
    ``PartitionSpec``s, entry for entry)."""
    out = {}
    for k, v in specs.items():
        if v is None:
            out[k] = None
        elif isinstance(v, dict):
            out[k] = batch_shardings(v, mesh)
        elif not isinstance(v, torch.Tensor) or v.ndim == 0:
            out[k] = ()
        else:
            axes = ("batch",) + (None,) * (v.ndim - 1)
            out[k] = spec_for(v.shape, axes, mesh)
    return out


def cache_spec(shape, mesh, seq_len) -> tuple:
    """Heuristic spec of one cache leaf: (L, B, ...) with a seq dim ->
    seq_kv, otherwise the largest state dim shards over the model axis."""
    shp = tuple(shape)
    axes = [None] * len(shp)
    if len(shp) >= 2:
        axes[1] = "batch"
    seq_dim = None
    for i in range(2, len(shp)):
        if shp[i] == seq_len or shp[i] >= 1024:
            seq_dim = i
            break
    if seq_dim is not None:
        axes[seq_dim] = "seq_kv"
    elif len(shp) > 2:
        big = int(np.argmax(shp[2:])) + 2
        axes[big] = "heads_out"
    return spec_for(shp, axes, mesh)


def cache_shardings(caches, mesh, seq_len):
    """The caches' tree with every leaf replaced by its :func:`cache_spec`."""
    return tree_map(lambda leaf: cache_spec(leaf.shape, mesh, seq_len), caches)


RULES = {"seq_kv": ("model", "data")}


# ------------------------------------------------------- per-device bytes ----

def _spec_bytes(leaf, spec, mesh) -> int:
    """``leaf``'s bytes on one device under ``spec``: divided by the size
    of every mesh axis the spec names."""
    sizes = mesh.shape
    split = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                split *= sizes[ax]
    return roofline.tensor_bytes(leaf) // split


def _batch_bytes(specs, shardings, mesh) -> int:
    """Per-device bytes of :func:`input_specs`' tensors under
    :func:`batch_shardings`."""
    total = 0
    for k, v in specs.items():
        if isinstance(v, dict):
            total += _batch_bytes(v, shardings[k], mesh)
        elif isinstance(v, torch.Tensor):
            total += _spec_bytes(v, shardings[k], mesh)
    return total


def _params_bytes(params, specs: Dict[str, tuple], mesh) -> int:
    """Per-device bytes of a params-shaped tree under ``{path: spec}``."""
    return sum(_spec_bytes(t, specs[path], mesh) for path, t in param_paths(params))


def _as_bf16(params):
    """The float leaves in bf16 (the ZeRO compute params)."""
    return tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, params)


# ---------------------------------------------------------------- tracing ----

def _depth_plan(cfg) -> Tuple[object, List[Tuple[str, int, Callable[[int], object]]]]:
    """(the config with one layer of each layer group, [(group, its full
    layer count, ``k -> the config with k layers of it``)]); a group of one
    layer needs no second trace."""
    if cfg.is_encdec:
        base = cfg.replace(n_layers=1, encoder_layers=1)
        plan = [("decoder", cfg.n_layers, lambda k: base.replace(n_layers=k)),
                ("encoder", cfg.encoder_layers, lambda k: base.replace(encoder_layers=k))]
    elif cfg.rwkv:
        base = cfg.replace(n_layers=1)
        plan = [("rwkv", cfg.n_layers, lambda k: base.replace(n_layers=k))]
    elif cfg.attn_period:
        p = cfg.attn_period
        base = cfg.replace(n_layers=p)
        plan = [("period", cfg.n_layers // p, lambda k: base.replace(n_layers=k * p))]
    elif cfg.moe is not None and cfg.first_dense_layers:
        base = cfg.replace(first_dense_layers=1, n_layers=2)
        plan = [("dense_head", cfg.first_dense_layers,
                 lambda k: base.replace(first_dense_layers=k, n_layers=k + 1)),
                ("moe_body", cfg.n_layers - cfg.first_dense_layers,
                 lambda k: base.replace(n_layers=k + 1))]
    else:
        base = cfg.replace(n_layers=1)
        plan = [("moe_body" if cfg.moe is not None else "body", cfg.n_layers,
                 lambda k: base.replace(n_layers=k))]
    return base, [g for g in plan if g[1] > 1]


def _seq_plan(cfg, shape) -> List[int]:
    """The sequences a step is traced at: the cell's own, or for recurrent
    layers outside decode, ``SEQ_FIT`` x (1, 2, 3)."""
    recurrent = cfg.rwkv or cfg.mamba is not None
    if recurrent and shape.kind != "decode" and shape.seq_len > 3 * SEQ_FIT:
        return [SEQ_FIT, 2 * SEQ_FIT, 3 * SEQ_FIT]
    return [shape.seq_len]


def _combine(terms) -> roofline.Counts:
    """``sum(coef * counts)`` over ``(coef, Counts)`` pairs (integers)."""
    out = roofline.Counts(collectives=None)
    for coef, c in terms:
        out.flops += coef * c.flops
        out.bytes_accessed += coef * c.bytes_accessed
        out.ops += coef * c.ops
    return out


def _extend(points: List[Tuple[int, roofline.Counts]], x: int) -> roofline.Counts:
    """The counts at ``x`` from counts at ``x0, 2 x0[, 3 x0]``: the line or
    the quadratic through them (Lagrange weights, exact in integers)."""
    if len(points) == 1:
        return points[0][1]
    x0 = points[0][0]
    t = x // x0
    if t * x0 != x:
        raise ValueError(f"{x} is not a multiple of the traced {x0}")
    if len(points) == 2:
        return _combine([(2 - t, points[0][1]), (t - 1, points[1][1])])
    w1 = (t - 2) * (t - 3) // 2
    w2 = -(t - 1) * (t - 3)
    w3 = (t - 1) * (t - 2) // 2
    return _combine([(w1, points[0][1]), (w2, points[1][1]), (w3, points[2][1])])


def _trace_step(cfg, shape) -> roofline.Counts:
    """One step of ``cfg`` at ``shape`` traced on ``meta`` under a
    :class:`~repro_torch.roofline.analysis.CountingMode`."""
    model = build_model(cfg, device=META)
    params = model.init()
    if cfg.zero:
        params = _as_bf16(params)
    specs = input_specs(cfg, shape)
    mode = roofline.CountingMode()
    if shape.kind == "train":
        opt = adamw.init(params, keep_master=cfg.zero)
        # grad_shardings (ZeRO-2's reduce-scatter) places gradients over
        # cards: on one device it changes no op of the step
        step = make_train_step(model, adamw.AdamWConfig(keep_master=cfg.zero),
                               microbatches=cfg.microbatch or 1,
                               accum_dtype=torch.bfloat16 if cfg.zero else None)
        with mode:
            step(params, opt, specs)
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        with mode:
            step(params, specs["tokens"], specs["extra"])
    else:
        caches = model.init_caches(shape.global_batch, shape.seq_len)
        step = make_decode_step(model)
        with mode:
            step(params, specs["token"], caches, specs["pos"])
    return mode.counts


@functools.lru_cache(maxsize=128)  # every cell of --all, traced once for both meshes
def _step_counts(cfg, shape, groups_mesh) -> Tuple[roofline.Counts, dict]:
    """The whole step's counts, assembled from traces of one, two (and for
    a train step three) layers of each group, at the sequences of
    :func:`_seq_plan`, and what was traced. A train step's bytes grow as
    the square of a group's depth (the backward of each layer's slice of a
    stacked weight writes a gradient of the whole stack), so its depth fit
    is quadratic. ``groups_mesh`` is the mesh the grouped MoE lane reads
    its group count from (``None`` for every other lane)."""
    t0 = time.perf_counter()
    base, plan = _depth_plan(cfg)
    seqs = _seq_plan(cfg, shape)
    depths = (1, 2, 3) if shape.kind == "train" else (1, 2)
    collectives = traces = 0

    def at_cell(c) -> roofline.Counts:
        nonlocal collectives, traces
        points = []
        for s in seqs:
            with sharding_context(groups_mesh):
                counts = _trace_step(c, ShapeCell(shape.name, s, shape.global_batch, shape.kind))
            collectives += sum(counts.collectives.count_by_kind.values())
            traces += 1
            points.append((s, counts))
        return _extend(points, shape.seq_len)

    c_base = at_cell(base)
    terms = [(1, c_base)]
    for _, n, make in plan:
        points = [(1, c_base)] + [(k, at_cell(make(k))) for k in depths[1:] if k <= n]
        terms += [(1, _extend(points, n)), (-1, c_base)]
    if collectives:
        raise RuntimeError(f"the traced step dispatched {collectives} collectives; "
                           f"the dry run assumes none")
    traced = {"layers": {"base": _layer_desc(base)},
              "multipliers": {g: n for g, n, _ in plan},
              "depths": list(depths),
              "depth_fit": "quadratic" if len(depths) == 3 else "linear",
              "seq_lens": seqs, "seq_fit": "quadratic" if len(seqs) > 1 else "none",
              "traces": traces,
              "trace_s": round(time.perf_counter() - t0, 2)}
    return _combine(terms), traced


def _layer_desc(cfg) -> dict:
    return {"n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "first_dense_layers": cfg.first_dense_layers}


# ------------------------------------------------------------------ cells ----

def build_cell(arch: str, shape_name: str, multi_pod: bool, cfg=None):
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape_by_name(shape_name)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"status": "SKIP", "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    t0 = time.time()

    rules = dict(RULES)
    if cfg.fsdp:
        rules["embed"] = ("data",)   # ZeRO-3/FSDP: weights' embed dim over DP
    opt_rules = dict(RULES, embed=("data",)) if (cfg.fsdp or cfg.zero) else rules
    B, S = shape.global_batch, shape.seq_len

    with sharding_context(mesh, rules):
        model = build_model(cfg, device=META)
        params = model.init()
        if cfg.zero:  # bf16 compute params
            params = _as_bf16(params)
        pspecs = params_pspecs(params, mesh, rules)
        specs = input_specs(cfg, shape)
        p_bytes = _params_bytes(params, pspecs, mesh)
        logits = torch.empty((B, cfg.vocab), dtype=cfg.activation_dtype, device=META)
        logit_bytes = _spec_bytes(logits, spec_for(logits.shape, ("batch", "vocab"), mesh), mesh)

        if shape.kind == "train":
            opt = adamw.init(params, keep_master=cfg.zero)
            fspecs = params_pspecs(params, mesh, opt_rules)
            o_bytes = roofline.tensor_bytes(opt.step) + sum(
                _params_bytes(t, fspecs, mesh) for t in (opt.m, opt.v, opt.master)
                if t is not None)
            b_bytes = _batch_bytes(specs, batch_shardings(specs, mesh), mesh)
            arg = p_bytes + o_bytes + b_bytes
            out_b = p_bytes + o_bytes + 3 * 4          # params, state, metrics
            alias = p_bytes + o_bytes                  # updated in place (donated)
        else:
            caches = model.init_caches(B, S)
            c_bytes = sum(_spec_bytes(t, cache_spec(t.shape, mesh, S), mesh)
                          for t in leaves(caches))
            b_bytes = _batch_bytes(specs, batch_shardings(specs, mesh), mesh)
            arg = p_bytes + b_bytes + (c_bytes if shape.kind == "decode" else 0)
            out_b = logit_bytes + c_bytes
            alias = c_bytes if shape.kind == "decode" else 0
        del model, params, specs
    t_build = time.time() - t0

    grouped = cfg.moe is not None and cfg.moe.dispatch_impl == "grouped"
    counts, traced = _step_counts(cfg, shape, mesh if grouped else None)

    mb = cfg.microbatch or 1
    acost = analytic.cost(cfg, shape, chips, microbatches=mb)
    rl = roofline.analyze(counts, loop_multiplier=1, analytic=acost)
    mem = {"argument_size_in_bytes": int(arg), "output_size_in_bytes": int(out_b),
           "alias_size_in_bytes": int(alias), "temp_size_in_bytes": None,
           "generated_code_size_in_bytes": None,
           "null_reasons": {"temp_size_in_bytes": NO_TEMP,
                            "generated_code_size_in_bytes": NO_COMPILE}}

    n_params, n_active = analytic.param_counts(cfg)[::-1]
    mf = roofline.model_flops(cfg, shape, chips)
    analytic_total = acost.flops_per_device * chips
    out = {
        "status": "OK",
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": chips,
        "params": n_params, "active_params": n_active,
        "lower_s": traced["trace_s"], "compile_s": None, "build_s": round(t_build, 2),
        "memory_analysis": mem,
        "roofline": rl.to_dict(),
        "collective_reason": NO_COLLECTIVE,
        "analytic_detail": {k: float(v) for k, v in acost.detail.items()},
        "model_flops_per_device": mf,
        "useful_flops_frac": (mf / rl.flops) if rl.flops else None,
        "counted": {"flops": counts.flops, "bytes_accessed": counts.bytes_accessed,
                    "ops": counts.ops, "scope": "the whole step on one device"},
        "counted_over_analytic_flops": (counts.flops / analytic_total
                                        if analytic_total else None),
        "traced": traced,
    }
    return out


def _fmt(t):
    return "None" if t is None else f"{t:.4f}"


def run_cell(arch, shape_name, multi_pod, force=False, verbose=True):
    RESULTS.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    path = RESULTS / f"{tag}.json"
    if path.exists() and not force:
        if verbose:
            print(f"[cached] {tag}")
        return json.loads(path.read_text())
    try:
        out = build_cell(arch, shape_name, multi_pod)
    except Exception:
        out = {"status": "FAIL", "arch": arch, "shape": shape_name,
               "mesh": "multi" if multi_pod else "single",
               "error": traceback.format_exc()}
    path.write_text(json.dumps(out, indent=1))
    if verbose:
        s = out["status"]
        extra = ""
        if s == "OK":
            r = out["roofline"]
            extra = (f" trace={out['lower_s']}s bottleneck={r['bottleneck']}"
                     f" t=({_fmt(r['t_compute_s'])},{_fmt(r['t_memory_s'])},"
                     f"{_fmt(r['t_collective_s'])})s"
                     f" counted/analytic={out['counted_over_analytic_flops']:.3f}")
        elif s == "FAIL":
            extra = " " + out["error"].strip().splitlines()[-1]
        print(f"[{s}] {tag}{extra}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape else [args.shape]

    fails = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                out = run_cell(a, s, mp, force=args.force)
                fails += out["status"] == "FAIL"
    if fails:
        sys.exit(1)


if __name__ == "__main__":
    main()
