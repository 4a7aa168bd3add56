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
spec, ``cost_analysis()`` becomes a
:class:`~repro_torch.roofline.analysis.CountingMode` over the traced step
on one device, and the HLO's collectives become a second trace of the
step under the production ``DeviceMesh`` over torch's ``"fake"`` process
group (256 ranks single-pod, 512 multi-pod; :func:`~repro_torch.launch.mesh.device_mesh`),
with the reference's rules: params, batch and caches are DTensors of their
placements on ``meta``, and every collective that DTensor runs (a
constraint's redistribute, or one that an op needs) is counted on its
per-device shard. The fake group sends nothing: these are host work on
``meta`` priced at the data sheet's rates, and the collective term takes
``roofline.analysis.LINK_BW`` (NVLink, 450 GB/s each way) for every link.

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
import contextlib
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
from repro_torch.distributed.sharding import (distribute, param_paths, params_pspecs,
                                              params_shardings, placements_for,
                                              sharding_context, spec_for)
from repro_torch.launch.mesh import make_production_mesh, mesh_chips, mesh_scope
from repro_torch.models import build_model
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import analytic
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.tree import leaves, tree_map

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

META = torch.device("meta")
#: A model with recurrent layers is traced at SEQ_FIT x (1, 2, 3) tokens
#: (train and prefill) and extended to the cell's sequence. On a mesh no
#: length is fitted: DTensor picks among strategies by their bytes, so its
#: collectives change form between lengths (jamba's prefill at 128, 256
#: and 512 tokens takes three plans), and the trace runs at the cell's
#: own length with the recurrences by shape (:func:`_scans_by_shape`).
SEQ_FIT = 8
NO_COLLECTIVE = ("the mesh places nothing of this cell (every leaf replicated), so the "
                 "step holds no collective and no collective term exists")
#: What the collective term's rate stands for.
COLLECTIVE_LINK = {
    "rate_bytes_per_s": roofline.LINK_BW,
    "link": "NVLink 4 within one 8-card host, 450 GB/s each way (H100 data sheet)",
    "note": ("a group of more than 8 ranks (the 16-wide data and model axes, the pod "
             "axis) crosses hosts; the repo has no number for the link between two "
             "hosts, so every collective is priced at the NVLink rate"),
    "measured": "host work on meta over the fake process group: no byte was sent",
}
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


def cell_rules(cfg) -> Tuple[dict, dict]:
    """(the model's rules, the optimizer state's rules) of a cell, as the
    reference's ``build_cell`` sets them: FSDP shards the weights' embed
    dim over data, and FSDP or ZeRO shards the optimizer state so."""
    rules = dict(RULES)
    if cfg.fsdp:
        rules["embed"] = ("data",)   # ZeRO-3/FSDP: weights' embed dim over DP
    opt_rules = dict(RULES, embed=("data",)) if (cfg.fsdp or cfg.zero) else rules
    return rules, opt_rules


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

def _depth_plan(cfg, lo: int = 1) -> Tuple[object, List[Tuple[str, int, int,
                                                             Callable[[int], object]]]]:
    """(the config with ``lo`` layers of each layer group (all of a smaller
    group), [(group, its full layer count, its layers in the base, ``k ->
    the base with k layers of it``)]); a group that the base holds whole
    needs no further trace."""
    def at(n):
        return min(lo, n)

    if cfg.is_encdec:
        nd, ne = at(cfg.n_layers), at(cfg.encoder_layers)
        base = cfg.replace(n_layers=nd, encoder_layers=ne)
        plan = [("decoder", cfg.n_layers, nd, lambda k: base.replace(n_layers=k)),
                ("encoder", cfg.encoder_layers, ne, lambda k: base.replace(encoder_layers=k))]
    elif cfg.rwkv:
        n = at(cfg.n_layers)
        base = cfg.replace(n_layers=n)
        plan = [("rwkv", cfg.n_layers, n, lambda k: base.replace(n_layers=k))]
    elif cfg.attn_period:
        p = cfg.attn_period
        n = at(cfg.n_layers // p)
        base = cfg.replace(n_layers=n * p)
        plan = [("period", cfg.n_layers // p, n, lambda k: base.replace(n_layers=k * p))]
    elif cfg.moe is not None and cfg.first_dense_layers:
        fd = cfg.first_dense_layers
        nd, nb = at(fd), at(cfg.n_layers - fd)
        base = cfg.replace(first_dense_layers=nd, n_layers=nd + nb)
        plan = [("dense_head", fd, nd,
                 lambda k: base.replace(first_dense_layers=k, n_layers=k + nb)),
                ("moe_body", cfg.n_layers - fd, nb, lambda k: base.replace(n_layers=nd + k))]
    else:
        n = at(cfg.n_layers)
        base = cfg.replace(n_layers=n)
        plan = [("moe_body" if cfg.moe is not None else "body", cfg.n_layers, n,
                 lambda k: base.replace(n_layers=k))]
    return base, [g for g in plan if g[1] > g[2]]


def _seq_plan(cfg, shape) -> List[int]:
    """The sequences a step is traced at: the cell's own, or for recurrent
    layers outside decode, ``SEQ_FIT`` x (1, 2, 3)."""
    recurrent = cfg.rwkv or cfg.mamba is not None
    if recurrent and shape.kind != "decode" and shape.seq_len > 3 * SEQ_FIT:
        return [SEQ_FIT, 2 * SEQ_FIT, 3 * SEQ_FIT]
    return [shape.seq_len]


def _combine(terms) -> roofline.Counts:
    """``sum(coef * counts)`` over ``(coef, Counts)`` pairs (integers),
    collectives kind by kind (``None`` where no term has any)."""
    out = roofline.Counts(collectives=None)
    for coef, c in terms:
        out.flops += coef * c.flops
        out.bytes_accessed += coef * c.bytes_accessed
        out.ops += coef * c.ops
        if c.collectives is not None:
            if out.collectives is None:
                out.collectives = roofline.CollectiveStats()
            out.collectives.add_scaled(coef, c.collectives)
    return out


def _extend(points: List[Tuple[int, roofline.Counts]], x: int) -> roofline.Counts:
    """The counts at ``x`` from counts at two or three equally spaced
    points (``x0, 2 x0, 3 x0`` or ``2, 3, 4``): the line or the quadratic
    through them (Lagrange weights, exact in integers)."""
    if len(points) == 1:
        return points[0][1]
    x0, h = points[0][0], points[1][0] - points[0][0]
    t = (x - x0) // h
    if t * h != x - x0:
        raise ValueError(f"{x} is not on the grid of the traced {x0}, {x0 + h}")
    if len(points) == 2:
        return _combine([(1 - t, points[0][1]), (t, points[1][1])])
    w0 = (t - 1) * (t - 2) // 2
    w1 = -t * (t - 2)
    w2 = t * (t - 1) // 2
    return _combine([(w0, points[0][1]), (w1, points[1][1]), (w2, points[2][1])])


def _place_inputs(specs, mesh):
    """:func:`input_specs`' tensors as DTensors of their batch placements."""
    from torch.distributed.tensor import distribute_tensor

    shardings = batch_shardings(specs, mesh)

    def one(v, sh):
        if isinstance(v, dict):
            return {k: one(v[k], sh[k]) for k in v}
        if not isinstance(v, torch.Tensor):
            return v
        return distribute_tensor(v, mesh, placements_for(sh, mesh), src_data_rank=None)

    return one(specs, shardings)


def _ssm_scan_shapes(h, xcf, dt, Bc, Cc, A):
    """``ssm._scan``'s outputs' shapes, each depending on every input,
    without the loop over tokens."""
    y = xcf * dt * (Bc * Cc).sum(-1, keepdim=True)
    return y, h * A + y.sum(1)[..., None]


def _wkv_scan_shapes(Sc, rf, kf, vf, w, u):
    """``rwkv._wkv_scan``'s outputs' shapes, each depending on every input,
    without the loop over tokens."""
    y = rf * kf * vf * w * u
    return y, Sc + y.sum(1)[..., None]


@contextlib.contextmanager
def _scans_by_shape():
    """While held, the Mamba and RWKV recurrences are their shape stand-ins.
    The collective trace holds it: what a recurrence's region sends is
    decided at its edges (its inputs' and outputs' placements, and their
    gradients'), so a scan over 32k tokens need not loop to be counted."""
    saved = ssm_mod._scan, rwkv_mod._wkv_scan
    ssm_mod._scan, rwkv_mod._wkv_scan = _ssm_scan_shapes, _wkv_scan_shapes
    try:
        yield
    finally:
        ssm_mod._scan, rwkv_mod._wkv_scan = saved


@contextlib.contextmanager
def _on_mesh(mesh, rules):
    """The sharding context of a trace on the mesh, with the recurrences by
    shape."""
    with sharding_context(mesh, rules), _scans_by_shape():
        yield


def _trace_step(cfg, shape, mesh=None) -> roofline.Counts:
    """One step of ``cfg`` at ``shape`` traced on ``meta`` under a
    :class:`~repro_torch.roofline.analysis.CountingMode`. With ``mesh`` (a
    ``DeviceMesh`` over the fake group) params, optimizer state, batch and
    caches are DTensors of the cell's placements (:func:`cell_rules`) and
    the step runs under ``sharding_context(mesh, rules)``; only its
    collectives are counted."""
    model = build_model(cfg, device=META)
    params = model.init()
    if cfg.zero:
        params = _as_bf16(params)
    specs = input_specs(cfg, shape)
    grad_shardings = opt_shardings = None
    ctx = contextlib.nullcontext
    if mesh is not None:
        rules, opt_rules = cell_rules(cfg)
        opt_shardings = params_shardings(params, mesh, opt_rules)
        grad_shardings = opt_shardings if cfg.zero else None
        params = distribute(params, mesh, params_shardings(params, mesh, rules))
        specs = _place_inputs(specs, mesh)
        ctx = functools.partial(_on_mesh, mesh, rules)
    mode = roofline.CountingMode(collectives_only=mesh is not None)
    if shape.kind == "train":
        opt = adamw.init(params, keep_master=cfg.zero, shardings=opt_shardings)
        step = make_train_step(model, adamw.AdamWConfig(keep_master=cfg.zero),
                               microbatches=cfg.microbatch or 1,
                               grad_shardings=grad_shardings,
                               accum_dtype=torch.bfloat16 if cfg.zero else None)
        with ctx(), mode:
            step(params, opt, specs)
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        with ctx(), mode:
            step(params, specs["tokens"], specs["extra"])
    else:
        caches = model.init_caches(shape.global_batch, shape.seq_len)
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor

            with sharding_context(mesh, RULES):
                caches = tree_map(lambda t: distribute_tensor(
                    t, mesh, placements_for(cache_spec(t.shape, mesh, shape.seq_len), mesh),
                    src_data_rank=None), caches)
        step = make_decode_step(model)
        with ctx(), mode:
            step(params, specs["token"], caches, specs["pos"])
    return mode.counts


@functools.lru_cache(maxsize=256)  # every cell of --all: once, and once a mesh
def _step_counts(cfg, shape, groups_mesh, multi_pod=None) -> Tuple[roofline.Counts, dict]:
    """The whole step's counts, assembled from traces of one, two (and for
    a train step three) layers of each group, at the sequences of
    :func:`_seq_plan`, and what was traced. A train step's bytes grow as
    the square of a group's depth (the backward of each layer's slice of a
    stacked weight writes a gradient of the whole stack), so its depth fit
    is quadratic. ``groups_mesh`` is the mesh the grouped MoE lane reads
    its group count from (``None`` for every other lane). With
    ``multi_pod`` (``False`` or ``True``) every trace runs on that
    production ``DeviceMesh`` and counts collectives only; they are
    assembled kind by kind, counts and bytes, as FLOPs are."""
    t0 = time.perf_counter()
    # on a mesh a stack of one layer takes other strategies than deeper ones
    # (its gradient's reductions): fit from two layers a group there
    lo = 1 if multi_pod is None else 2
    base, plan = _depth_plan(cfg, lo)
    seqs = _seq_plan(cfg, shape) if multi_pod is None else [shape.seq_len]
    depths = tuple(range(lo, lo + (3 if shape.kind == "train" else 2)))
    traces = 0
    m = None if multi_pod is None else make_production_mesh(multi_pod=multi_pod)
    world = contextlib.nullcontext() if m is None else mesh_scope(m.axis_names, m.sizes, "meta")

    def at_cell(c, mesh) -> roofline.Counts:
        nonlocal traces
        points = []
        for s in seqs:
            with sharding_context(groups_mesh) if mesh is None else contextlib.nullcontext():
                counts = _trace_step(c, ShapeCell(shape.name, s, shape.global_batch, shape.kind),
                                     mesh)
            traces += 1
            points.append((s, counts))
        return _extend(points, shape.seq_len)

    with world as mesh:
        c_base = at_cell(base, mesh)
        terms = [(1, c_base)]
        for _, n, nb, make in plan:
            points = [(nb, c_base)] + [(k, at_cell(make(k), mesh))
                                       for k in range(nb + 1, nb + len(depths)) if k <= n]
            terms += [(1, _extend(points, n)), (-1, c_base)]
    out = _combine(terms)
    st = out.collectives
    if multi_pod is not None and st is not None and (
            min(list(st.bytes_by_kind.values()) + list(st.count_by_kind.values()) + [0]) < 0):
        raise RuntimeError(f"{cfg.name} {shape.name}: the collectives assembled from the traces "
                           f"are negative ({st.count_by_kind}); the traces took other "
                           f"strategies at their depths or lengths")
    traced = {"layers": {"base": _layer_desc(base)},
              "multipliers": {g: n for g, n, _, _ in plan},
              "depths": list(depths),
              "depth_fit": "quadratic" if len(depths) == 3 else "linear",
              "seq_lens": seqs, "seq_fit": "quadratic" if len(seqs) > 1 else "none",
              "traces": traces,
              "trace_s": round(time.perf_counter() - t0, 2)}
    return out, traced


def _layer_desc(cfg) -> dict:
    return {"n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "first_dense_layers": cfg.first_dense_layers}


# ------------------------------------------------------------------ cells ----

def _spec_list(shardings) -> list:
    """The spec tuples of :func:`batch_shardings`' nested dict."""
    out = []
    for v in shardings.values():
        if isinstance(v, dict):
            out += _spec_list(v)
        elif v is not None:
            out.append(v)
    return out


def build_cell(arch: str, shape_name: str, multi_pod: bool, cfg=None):
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape_by_name(shape_name)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"status": "SKIP", "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    t0 = time.time()

    rules, opt_rules = cell_rules(cfg)
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
        placed = any(any(e is not None for e in sp) for sp in pspecs.values()) or \
            any(any(e is not None for e in sp) for sp in _spec_list(
                batch_shardings(specs, mesh)))
        del model, params, specs
    t_build = time.time() - t0

    grouped = cfg.moe is not None and cfg.moe.dispatch_impl == "grouped"
    counts, traced = _step_counts(cfg, shape, mesh if grouped else None)
    if placed:
        sharded, traced_c = _step_counts(cfg, shape, None, multi_pod)
        counts = roofline.Counts(counts.flops, counts.bytes_accessed, counts.ops,
                                 sharded.collectives or roofline.CollectiveStats())
        traced["collective_traces"] = traced_c["traces"]
        traced["collective_trace_s"] = traced_c["trace_s"]
    else:
        counts = roofline.Counts(counts.flops, counts.bytes_accessed, counts.ops, None)

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
        "collective_reason": None if placed else NO_COLLECTIVE,
        "collective_link": COLLECTIVE_LINK if placed else None,
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
