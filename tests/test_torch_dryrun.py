"""The port's dry run (``repro_torch.launch.{mesh,dryrun,perf}``) against
the reference's: ``input_specs``, the batch specs and the cache specs of
every (arch x shape) on both production meshes equal the reference's
``PartitionSpec``s leaf for leaf, and ``perf.CELLS`` has the reference's
cells and variants. The reference's modules set ``XLA_FLAGS`` to 512 host
devices when imported, so they run in one ``run_py(code, devices=512)``
subprocess (~15 s) that hands its results over as JSON.

``build_cell`` on small configs (llama3.2-1b and qwen3-moe-235b-a22b at
their smoke widths, 2 layers) traces on the ``meta`` device: status OK,
the reference's JSON keys, the temporaries null with their reasons, a
numeric collective term with its link, and the counted FLOPs within 2% of
the analytic ones for both families (at these widths attention's full
S^2, which both count, dominates: the counted/analytic ratios read
0.996-1.000; the prefill_32k cells, 0.998 and 0.9975, take 16-18 s each and
are left to ``python -m repro_torch.launch.dryrun``). The counts assembled
from one to three layers of each group (and from three short sequences for
the recurrent models) equal a trace of the whole step; so do the
collectives assembled from traces on the production ``DeviceMesh`` (count
and bytes by kind). One MLP layer's all-reduce bytes equal a count by hand
from the rules. Every trace on a ``DeviceMesh`` runs in one subprocess
(the ``"fake"`` process group is process-global), handed back as JSON.
"""
import json

import pytest
import torch

from conftest import run_py
from repro_torch.configs import SHAPES, get_config, get_smoke_config, list_archs
from repro_torch.distributed.sharding import sharding_context
from repro_torch.launch import dryrun, mesh as mesh_mod, perf
from repro_torch.tree import leaves

REF_CODE = r"""
import json
import jax
from repro.configs import SHAPES, get_config, list_archs
from repro.distributed.sharding import sharding_context
from repro.launch import dryrun as dr
from repro.launch import perf
from repro.launch.mesh import make_production_mesh, mesh_chips
from repro.models import build_model

def spec(s):
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in s]

def desc(specs):
    out = {}
    for k, v in specs.items():
        if v is None:
            out[k] = None
        elif isinstance(v, dict):
            out[k] = desc(v)
        else:
            out[k] = {"shape": list(v.shape), "dtype": str(v.dtype)}
    return out

def shard(sh):
    return {k: (None if v is None else shard(v) if isinstance(v, dict) else spec(v.spec))
            for k, v in sh.items()}

out = {"meshes": {}, "specs": {}, "batch": {}, "cache": {},
       "cells": {k: [a, s, list(it)] for k, (a, s, it) in perf.CELLS.items()}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    out["meshes"][str(mp)] = [dict(mesh.shape), mesh_chips(mesh)]
    with sharding_context(mesh, dr.RULES):
        for arch in list_archs():
            cfg = get_config(arch)
            model = build_model(cfg)
            for shape in SHAPES:
                key = f"{arch}|{shape.name}"
                specs = dr.input_specs(cfg, shape)
                out["specs"][key] = desc(specs)
                out["batch"][f"{key}|{mp}"] = shard(dr.batch_shardings(specs, mesh))
                if shape.kind == "decode" and mp:
                    continue
                if shape.kind == "decode":
                    caches = jax.eval_shape(
                        lambda: model.init_caches(shape.global_batch, shape.seq_len))
                    for m2 in (False, True):
                        mesh2 = make_production_mesh(multi_pod=m2)
                        with sharding_context(mesh2, dr.RULES):
                            cs = dr.cache_shardings(caches, mesh2, shape.seq_len)
                        out["cache"][f"{key}|{m2}"] = [
                            [list(l.shape), spec(s.spec)]
                            for l, s in zip(jax.tree_util.tree_leaves(caches),
                                            jax.tree_util.tree_leaves(cs))]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    text = run_py(REF_CODE, devices=512, timeout=600)
    return json.loads(text.split("JSON", 1)[1])


def _spec(s):
    """A spec as JSON; a one-axis tuple is its axis (``PartitionSpec``
    holds ``("data",)`` as ``"data"``, and the two compare equal)."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in s]


def _desc(specs):
    out = {}
    for k, v in specs.items():
        if v is None:
            out[k] = None
        elif isinstance(v, dict):
            out[k] = _desc(v)
        elif isinstance(v, int):     # the decode's pos: a Python int here
            out[k] = {"shape": [], "dtype": "int32"}
        else:
            out[k] = {"shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")}
    return out


def _shard(sh):
    return {k: (None if v is None else _shard(v) if isinstance(v, dict) else _spec(v))
            for k, v in sh.items()}


def test_production_meshes(ref):
    for mp in (False, True):
        m = mesh_mod.make_production_mesh(multi_pod=mp)
        assert [m.shape, mesh_mod.mesh_chips(m)] == ref["meshes"][str(mp)]


def test_local_mesh():
    m = mesh_mod.make_local_mesh(device="cpu")
    assert m.shape == {"data": 1} and m.home == torch.device("cpu")
    m2 = mesh_mod.make_local_mesh(("data", "model"), device="cpu")
    assert m2.shape == {"data": 1, "model": 1} and mesh_mod.mesh_chips(m2) == 1


def test_local_mesh_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_local_mesh()


@pytest.mark.parametrize("arch", list_archs())
def test_input_and_batch_specs_equal_reference(arch, ref):
    cfg = get_config(arch)
    for shape in SHAPES:
        key = f"{arch}|{shape.name}"
        specs = dryrun.input_specs(cfg, shape)
        assert _desc(specs) == ref["specs"][key], key
        if shape.kind == "decode":
            assert specs["pos"] == shape.seq_len - 1
        for mp in (False, True):
            mesh = mesh_mod.make_production_mesh(multi_pod=mp)
            with sharding_context(mesh, dryrun.RULES):
                got = _shard(dryrun.batch_shardings(specs, mesh))
            assert got == ref["batch"][f"{key}|{mp}"], (key, mp)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_reference(arch, ref):
    from repro_torch.models import build_model

    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    for shape in SHAPES:
        if shape.kind != "decode":
            continue
        caches = model.init_caches(shape.global_batch, shape.seq_len)
        for mp in (False, True):
            mesh = mesh_mod.make_production_mesh(multi_pod=mp)
            with sharding_context(mesh, dryrun.RULES):
                got = [[list(t.shape), _spec(dryrun.cache_spec(t.shape, mesh, shape.seq_len))]
                       for t in leaves(caches)]
                tree = dryrun.cache_shardings(caches, mesh, shape.seq_len)
            assert got == ref["cache"][f"{arch}|{shape.name}|{mp}"], (arch, shape.name, mp)
            assert isinstance(tree, type(caches))


def test_perf_cells_are_the_reference_cells(ref):
    got = {k: [a, s, list(it)] for k, (a, s, it) in perf.CELLS.items()}
    assert got == ref["cells"]


REF_OK_KEYS = {"status", "arch", "shape", "mesh", "chips", "params", "active_params",
               "lower_s", "compile_s", "memory_analysis", "roofline", "analytic_detail",
               "model_flops_per_device", "useful_flops_frac"}
REF_ROOFLINE_KEYS = {"flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
                     "collective_bytes_by_kind", "collective_counts", "raw_cost_analysis",
                     "loop_multiplier", "wire_bytes_per_device", "t_collective_wire_s",
                     "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck", "t_bound_s"}
#: counted / analytic FLOPs of the small configs, per family
FLOPS_RTOL = {"dense": 0.02, "moe": 0.02}


SMOKE_CELLS = [("llama3.2-1b", "train_4k"), ("llama3.2-1b", "decode_32k"),
               ("qwen3-moe-235b-a22b", "train_4k"), ("qwen3-moe-235b-a22b", "decode_32k")]

MESH_CODE = r"""
import json
from repro_torch.configs import ShapeCell, get_config, get_smoke_config
from repro_torch.distributed.sharding import (distribute, logical_constraint, named_sharding,
                                              params_shardings, sharding_context)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_scope
from repro_torch.models.layers import Init, apply_mlp, init_mlp
from repro_torch.roofline.analysis import CountingMode
import torch

def stats(c):
    return {"count": c.collectives.count_by_kind, "bytes": c.collectives.bytes_by_kind}

out = {"cells": {}}
for arch, shape in SMOKE_CELLS:
    out["cells"][f"{arch}|{shape}"] = dryrun.build_cell(arch, shape, False,
                                                        cfg=get_smoke_config(arch))
llama = get_smoke_config("llama3.2-1b")
out["cells"]["fsdp"] = dryrun.build_cell("llama3.2-1b", "train_4k", False,
                                         cfg=llama.replace(fsdp=True))
out["cells"]["rwkv"] = dryrun.build_cell("rwkv6-7b", "train_4k", False,
                                         cfg=get_smoke_config("rwkv6-7b"))
out["cells"]["multi"] = dryrun.build_cell("qwen3-moe-235b-a22b", "train_4k", True,
                                          cfg=get_smoke_config("qwen3-moe-235b-a22b"))
for kind, n in (("prefill", 4), ("train", 5)):
    cfg = llama.replace(n_layers=n)
    shape = ShapeCell(f"{kind}_small", 64, 32, kind)
    got, _ = dryrun._step_counts(cfg, shape, None, False)
    with mesh_scope(("data", "model"), (16, 16), "meta") as mesh:
        whole = dryrun._trace_step(cfg, shape, mesh)
    out[f"depth_{kind}"] = [stats(got), stats(whole)]
# the enc-dec model: two layer groups, each fitted on its own
cfg = get_smoke_config("whisper-base").replace(n_layers=5, encoder_layers=5)
shape = ShapeCell("train_small", 64, 32, "train")
got, _ = dryrun._step_counts(cfg, shape, None, False)
with mesh_scope(("data", "model"), (16, 16), "meta") as mesh:
    whole = dryrun._trace_step(cfg, shape, mesh)
out["depth_encdec_train"] = [stats(got), stats(whole)]
cfg = get_config("llama3.2-1b")
with mesh_scope(("data", "model"), (16, 16), "meta") as mesh:
    p = {"mlp": init_mlp(Init(None, "meta"), cfg.d_model, cfg.d_ff)}
    p = distribute(p, mesh, params_shardings(p, mesh))
    x = torch.empty(256, 128, cfg.d_model, dtype=torch.bfloat16, device="meta")
    x = distribute({"x": x}, mesh, {"x": named_sharding(x.shape, ("batch", None, None), mesh)})
    with sharding_context(mesh), CountingMode(collectives_only=True) as mode:
        logical_constraint(apply_mlp(p["mlp"], x["x"]), ("batch", None, None))
    out["mlp"] = stats(mode.counts)
    out["mlp_placements"] = [str(p["mlp"][k].placements) for k in ("w_gate", "w_up", "w_down")]
print("JSON" + json.dumps(out))
""".replace("SMOKE_CELLS", repr(SMOKE_CELLS))


@pytest.fixture(scope="module")
def on_mesh():
    return json.loads(run_py(MESH_CODE, timeout=900).split("JSON", 1)[1])


@pytest.mark.parametrize("arch,shape_name", SMOKE_CELLS)
def test_build_cell_on_meta(arch, shape_name, on_mesh):
    cfg = get_smoke_config(arch)
    assert cfg.n_layers == 2
    out = on_mesh["cells"][f"{arch}|{shape_name}"]
    assert out["status"] == "OK"
    assert REF_OK_KEYS <= set(out)
    r = out["roofline"]
    assert set(r) == REF_ROOFLINE_KEYS
    assert r["collective_bytes_per_device"] > 0 and r["t_collective_s"] > 0
    assert sum(r["collective_counts"].values()) > 0
    assert r["collective_bytes_per_device"] == sum(r["collective_bytes_by_kind"].values())
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert out["collective_reason"] is None and out["collective_link"]["rate_bytes_per_s"] == 450e9
    mem = out["memory_analysis"]
    assert mem["temp_size_in_bytes"] is None and mem["null_reasons"]["temp_size_in_bytes"]
    assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert out["chips"] == 256 and out["compile_s"] is None
    assert out["counted_over_analytic_flops"] == pytest.approx(1.0, rel=FLOPS_RTOL[cfg.family])
    assert r["raw_cost_analysis"]["flops"] == out["counted"]["flops"]
    assert out["traced"]["multipliers"] == ({"moe_body": 2} if cfg.moe else {"body": 2})
    json.dumps(out)


def test_fsdp_shards_the_weights_over_data(on_mesh):
    a = on_mesh["cells"]["llama3.2-1b|train_4k"]
    b = on_mesh["cells"]["fsdp"]
    assert b["memory_analysis"]["argument_size_in_bytes"] < \
        a["memory_analysis"]["argument_size_in_bytes"]
    assert b["counted"] == a["counted"]
    assert b["roofline"]["collective_counts"] != a["roofline"]["collective_counts"]


def test_coo_lane_fails_on_meta():
    """The ``coo`` MoE lane once read its containers' row order back to the
    host, which a ``meta`` tensor refuses. Its containers now come marked
    ``UNSORTED`` and are sorted without that read (the read a CUDA graph's
    capture refuses too), so its cell traces on ``meta`` as the other
    lanes' do, while the order check on ``meta`` rows still refuses."""
    import dataclasses

    from repro_torch.kernels.coo_spmv import row_sorted

    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="coo"))
    out = dryrun.build_cell("qwen3-moe-235b-a22b", "decode_32k", False, cfg=cfg)
    assert out["status"] == "OK"
    rows = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(Exception, match="meta"):
        row_sorted(rows, rows, torch.zeros(4, device="meta"))


def test_sequence_fit_is_exact_for_a_polynomial():
    from repro_torch.roofline.analysis import Counts

    def at(s):
        return Counts(flops=3 * s * s + 5 * s + 7, bytes_accessed=11 * s + 2, ops=s)

    got = dryrun._extend([(8, at(8)), (16, at(16)), (24, at(24))], 4096)
    assert (got.flops, got.bytes_accessed, got.ops) == (3 * 4096 ** 2 + 5 * 4096 + 7,
                                                        11 * 4096 + 2, 4096)


def test_recurrent_cell_traces_short_sequences(on_mesh):
    out = on_mesh["cells"]["rwkv"]
    assert out["status"] == "OK"
    assert out["traced"]["seq_lens"] == [8, 16, 24] and out["traced"]["seq_fit"] == "quadratic"
    assert out["counted_over_analytic_flops"] > 0
    assert out["roofline"]["t_collective_s"] > 0


def test_multi_pod_cell_has_a_collective_term(on_mesh):
    out = on_mesh["cells"]["multi"]
    assert out["status"] == "OK" and out["chips"] == 512 and out["mesh"] == "multi"
    assert out["roofline"]["t_collective_s"] > 0
    single = on_mesh["cells"]["qwen3-moe-235b-a22b|train_4k"]
    assert out["counted"] == single["counted"]     # FLOPs from the one-device trace


@pytest.mark.parametrize("kind", ["prefill", "train", "encdec_train"])
def test_assembled_collectives_equal_a_whole_trace(on_mesh, kind):
    """Collectives of two to three layers extended to four (prefill,
    linear), or of two to four extended to five (train, quadratic; the
    enc-dec model's decoder and encoder each so), equal a trace of the
    whole step on the mesh, count and bytes kind by kind."""
    got, whole = on_mesh[f"depth_{kind}"]
    assert got == whole and sum(whole["count"].values()) > 0


def test_dense_mlp_all_reduce_by_hand(on_mesh):
    """llama3.2-1b's MLP on the (16, 16) mesh, tokens (256, 128) split over
    data: w_gate and w_up are column-parallel and w_down row-parallel over
    model (the rules' ffn_hidden), so the output is a partial sum over model
    and its constraint to (batch, None, None) all-reduces each rank's shard
    once: (256 / 16) x 128 tokens x 2048 x 2 bytes (bf16) = 8,388,608
    bytes, and nothing else moves."""
    assert on_mesh["mlp_placements"] == ["(Replicate(), Shard(dim=1))"] * 2 + \
        ["(Replicate(), Shard(dim=0))"]
    assert on_mesh["mlp"] == {"count": {"all-reduce": 1},
                              "bytes": {"all-reduce": (256 // 16) * 128 * 2048 * 2}}


def _deeper(cfg):
    """A small config with several layers in every group."""
    if cfg.attn_period:
        return cfg.replace(n_layers=3 * cfg.attn_period)
    if cfg.is_encdec:
        return cfg.replace(n_layers=5, encoder_layers=6)
    if cfg.first_dense_layers:
        return cfg.replace(first_dense_layers=3, n_layers=8)
    return cfg.replace(n_layers=6)


@pytest.mark.parametrize("arch,kind", [
    ("llama3.2-1b", "train"), ("deepseek-v2-236b", "train"), ("deepseek-v2-236b", "prefill"),
    ("whisper-base", "train"), ("rwkv6-7b", "train"), ("jamba-v0.1-52b", "prefill"),
    ("qwen3-moe-235b-a22b", "train"), ("qwen3-moe-235b-a22b", "decode"),
])
def test_assembled_counts_equal_a_whole_trace(arch, kind):
    """The counts assembled from one to three layers a group (and, for the
    recurrent models, from 8, 16 and 24 tokens) equal a trace of the whole
    step, FLOPs, bytes and ops alike (batch 8: the MoE capacity, rounded up
    to 8 slots, stays linear in the tokens, as at every cell of SHAPES)."""
    from repro_torch.configs import ShapeCell

    cfg = _deeper(get_smoke_config(arch))
    shape = ShapeCell(f"{kind}_small", 48, 8, kind)
    got, traced = dryrun._step_counts(cfg, shape, None)
    whole = dryrun._trace_step(cfg, shape)
    assert (got.flops, got.bytes_accessed, got.ops) == \
        (whole.flops, whole.bytes_accessed, whole.ops)
    assert traced["depth_fit"] == ("quadratic" if kind == "train" else "linear")
    assert traced["seq_fit"] == ("quadratic" if cfg.rwkv or cfg.mamba else "none")
