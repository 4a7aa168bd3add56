"""The model's sharding over a ``DeviceMesh`` (``repro_torch.distributed.sharding``,
``launch/mesh.device_mesh``, the sharded init, ``SyntheticTokens(mesh=)``,
``make_train_step(grad_shardings=)``, ``Trainer(mesh=)``) against the
reference's ``NamedSharding`` rules and against the port's unsharded path.

(a) Placements: for every arch on both production meshes (256 and 512 ranks
    of torch's ``"fake"`` group, in a subprocess) each parameter leaf's
    placements and the local shard shape equal the reference's
    ``NamedSharding(mesh, spec)`` and ``shard_shape`` (one
    ``run_py(code, devices=512)`` subprocess, handed back as JSON), under
    the default rules and under FSDP's ``embed -> data``. No parameter
    splits a dim over two axes; the one rule that does, ``seq_kv ->
    ("model", "data")`` on a cache, is held chunk for chunk: every rank's
    offset equals the device's index in the reference's
    ``devices_indices_map``.
(b) Four ``gloo`` ranks on a (2, 2) ``("data", "model")`` mesh, started in a
    subprocess with a ``file://`` rendezvous under ``tmp_path`` (no port to
    collide with other workers), ``OMP_NUM_THREADS=1`` and a timeout of
    their own; every rank calls every collective. ``logical_constraint`` at
    the model's call sites gives the rules' placements and the unsharded
    values; one train step of the llama and qwen3-moe smoke configs (the
    'sort' and 'bsr' lanes, on their plain versions here), with and without
    ``grad_shardings``, and of the 'sort' lane over two microbatches (each
    the reference's global rows, which two data ranks hold: the MoE's
    capacity and aux loss depend on which tokens share a microbatch),
    equals the port's unsharded step at
    ``tests/test_torch_train.py``'s tolerances: loss rtol 1e-5, params
    rtol 1e-4 / atol 1e-5 of max|leaf| (the sums over ranks run in another
    order); ``grad_norm`` at rtol 1e-5.
(c) The reference's ``Trainer(mesh=Mesh(devs.reshape(2, 2), ("data",
    "model")))`` on 4 fake host devices trains 2 steps of the llama smoke
    config; the port's 4-rank ``Trainer`` on the (2, 2) mesh gives its
    losses at rtol 1e-5.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, run_py

#: Seconds a four-rank run may take (the first DTensor step of a process
#: propagates every op's sharding once: ~10 s a config here).
RANKS_TIMEOUT = 420

_PRELUDE = r'''
import json, logging, os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, world, tmp):
    torch.set_num_threads(1)
    # DTensor warns of every two-step redistribute over a 2-D mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rdv"),
                            rank=rank, world_size=world)
    try:
        out = body(rank, world, tmp)
        if rank == 0:
            with open(os.path.join(tmp, "out.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()

'''

_EPILOGUE = r'''

if __name__ == "__main__":
    world, tmp = int(sys.argv[1]), sys.argv[2]
    mp.spawn(_rank, args=(world, tmp), nprocs=world)
'''


def run_ranks(body: str, tmp, world: int = 4, timeout: int = RANKS_TIMEOUT, **env_extra):
    """Run ``body`` (the source of ``def body(rank, world, tmp)``) on
    ``world`` ``gloo`` ranks in a subprocess; rank 0's return value, as
    JSON. ``env_extra`` goes into the ranks' environment."""
    script = os.path.join(str(tmp), "ranks.py")
    with open(script, "w") as f:
        f.write(_PRELUDE + body + _EPILOGUE)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               **env_extra)
    r = subprocess.run([sys.executable, script, str(world), str(tmp)], env=env,
                       timeout=timeout, capture_output=True, text=True)
    assert r.returncode == 0, f"ranks failed:\nSTDOUT:{r.stdout}\nSTDERR:{r.stderr[-6000:]}"
    with open(os.path.join(str(tmp), "out.json")) as f:
        return json.load(f)


# ------------------------------------------------------- (a) placements ----

REF_PLACEMENTS = r"""
import json
import jax
from jax.sharding import NamedSharding
from repro.configs import get_config, list_archs
from repro.distributed.sharding import params_shardings
from repro.launch.mesh import make_production_mesh
from repro.models import build_model

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in list_archs():
        model = build_model(get_config(arch))
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        for tag, rules in (("default", None), ("fsdp", {"embed": ("data",)})):
            sh = params_shardings(shapes, mesh, rules)
            flat = jax.tree_util.tree_flatten_with_path(sh)[0]
            leaves = jax.tree_util.tree_leaves(shapes)
            out[f"{mp}|{arch}|{tag}"] = [
                [jax.tree_util.keystr(p, simple=True, separator="/"), spec(s.spec),
                 list(s.shard_shape(l.shape))] for (p, s), l in zip(flat, leaves)]
# the one multi-axis rule: a decode cache's seq dim over ("model", "data")
from jax.sharding import PartitionSpec as P
mesh = make_production_mesh()
shape = (2, 1, 1024, 8, 4)
s = NamedSharding(mesh, P(None, None, ("model", "data")))
idx = s.devices_indices_map(shape)
pos = {}
for i in range(mesh.devices.shape[0]):
    for j in range(mesh.devices.shape[1]):
        pos[i * mesh.devices.shape[1] + j] = idx[mesh.devices[i, j]][2].start
out["seq_kv"] = {"shape": list(shape), "starts": pos}
print("JSON" + json.dumps(out))
"""

PORT_PLACEMENTS = r"""
import json
import torch
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import params_shardings, placements_for
from repro_torch.launch.mesh import make_production_mesh, mesh_scope
from repro_torch.models import build_model

def desc(pl):
    return [[type(p).__name__, getattr(p, "dim", None)] for p in pl]

out = {}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    with mesh_scope(m.axis_names, m.sizes, "meta") as mesh:
        for arch in list_archs():
            shapes = build_model(get_config(arch), device="meta").init()
            for tag, rules in (("default", None), ("fsdp", {"embed": ("data",)})):
                rows = []
                for path, pl in params_shardings(shapes, mesh, rules).items():
                    leaf = shapes
                    for k in path.split("/"):
                        leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
                    local = distribute_tensor(leaf, mesh, pl, src_data_rank=None).to_local()
                    rows.append([path, desc(pl), list(local.shape)])
                out[f"{mp}|{arch}|{tag}"] = rows
# the seq_kv chunk of every rank (the fake group's rank set per run)
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
shape = (2, 1, 1024, 8, 4)
starts = {}
for r in (0, 1, 15, 16, 17, 100, 255):
    dist.init_process_group("fake", store=FakeStore(), rank=r, world_size=256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    pl = placements_for((None, None, ("model", "data")), mesh)
    starts[r] = compute_local_shape_and_global_offset(shape, mesh, pl)[1][2]
    dist.destroy_process_group()
out["seq_kv"] = {"starts": starts, "placements": desc(pl)}
print("JSON" + json.dumps(out))
"""


def _json(stdout):
    return json.loads(stdout.split("JSON", 1)[1])


@pytest.fixture(scope="module")
def placements():
    return _json(run_py(REF_PLACEMENTS, devices=512)), _json(run_py(PORT_PLACEMENTS))


def _want(spec, axis_names):
    """The placements a reference spec names: ``Shard(d)`` on each mesh axis
    that dim ``d`` lists, ``Replicate`` on the others."""
    out = [["Replicate", None] for _ in axis_names]
    for d, e in enumerate(spec):
        for ax in ([] if e is None else e if isinstance(e, list) else [e]):
            out[axis_names.index(ax)] = ["Shard", d]
    return out


ARCHS = ["command-r-plus-104b", "deepseek-v2-236b", "internvl2-26b", "jamba-v0.1-52b",
         "llama3.2-1b", "mistral-nemo-12b", "qwen1.5-4b", "qwen3-moe-235b-a22b", "rwkv6-7b",
         "whisper-base"]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_equal_reference(placements, arch, multi_pod):
    ref, port = placements
    axis_names = ["pod", "data", "model"] if multi_pod else ["data", "model"]
    for tag in ("default", "fsdp"):
        want = ref[f"{multi_pod}|{arch}|{tag}"]
        got = port[f"{multi_pod}|{arch}|{tag}"]
        assert [r[0] for r in got] == [r[0] for r in want]   # leaf order too
        for (path, spec, shard_shape), (_, pl, local) in zip(want, got):
            assert pl == _want(spec, axis_names), (tag, path, spec, pl)
            assert local == shard_shape, (tag, path)


def test_multi_axis_dim_takes_the_reference_chunks(placements):
    """``("model", "data")`` shards model-major: the minor axis, first in
    mesh order, takes a ``_StridedShard``, and every rank's chunk starts
    where the reference's device's does. No parameter splits a dim over
    two axes, so this cache rule is the only one whose order matters."""
    ref, port = placements
    assert port["seq_kv"]["placements"] == [["_StridedShard", 2], ["Shard", 2]]
    for r, start in port["seq_kv"]["starts"].items():
        assert start == ref["seq_kv"]["starts"][r], r


def test_placements_for_and_named_sharding():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding

    code = r"""
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed.sharding import named_sharding, placements_for, spec_for
from repro_torch.launch.mesh import mesh_scope
with mesh_scope(("data", "model"), (2, 4), "meta") as mesh:
    assert placements_for((None, "model"), mesh) == (Replicate(), Shard(1))
    assert placements_for((("data", "model"),), mesh) == (Shard(0), Shard(0))
    # 6 rows: model does not divide them, data does
    assert named_sharding((6, 8), ("batch", "vocab"), mesh) == (Shard(0), Shard(1))
    assert named_sharding((6, 6), (None, "vocab"), mesh) == (Replicate(), Replicate())
print("OK")
"""
    assert "OK" in run_py(code)
    # no DeviceMesh: nothing placed, and a plain tensor passes the constraint
    import torch

    x = torch.ones(4, 4)
    assert sharding.named_sharding((4, 4), ("batch", None)) is None
    assert sharding.logical_constraint(x, ("batch", None)) is x
    with sharding.sharding_context({"data": 2, "model": 2}):
        assert sharding.logical_constraint(x, ("batch", None)) is x
    assert Replicate() != Shard(0)


# ------------------------------------------------ (b) four gloo ranks ----

RANK_BODY = r'''
CASES = [("llama", "llama3.2-1b", None, False, 1),
         ("llama_zero2", "llama3.2-1b", None, True, 1),
         ("moe_sort", "qwen3-moe-235b-a22b", "sort", False, 1),
         ("moe_sort_zero2", "qwen3-moe-235b-a22b", "sort", True, 1),
         ("moe_bsr", "qwen3-moe-235b-a22b", "bsr", False, 1),
         ("moe_bsr_zero2", "qwen3-moe-235b-a22b", "bsr", True, 1),
         ("moe_sort_mb2", "qwen3-moe-235b-a22b", "sort", False, 2)]
B, S = 4, 16


def _cfg(arch, lane):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if lane is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=lane))
    return cfg


def _batch(cfg):
    import numpy as np
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))
            for k in ("tokens", "targets")}


def _close(got, want, rtol, atol):
    import numpy as np
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def constraints(mesh):
    """The model's constraint sites on DTensors: placements and values."""
    from repro_torch.distributed.sharding import (distribute, named_sharding, params_shardings,
                                                  sharding_context)
    from repro_torch.models import build_model
    cfg = _cfg("llama3.2-1b", None)
    model = build_model(cfg, device="cpu")
    full = model.init(0)
    params = model.init(0, mesh=mesh)
    tok = _batch(cfg)["tokens"]
    tok_d = distribute({"t": tok}, mesh, {"t": named_sharding(tok.shape, ("batch", None), mesh)})["t"]
    with torch.no_grad():
        x_want = model._embed(full, tok)
        logits_want, _ = model.forward_train(full, tok)
        with sharding_context(mesh):
            x = model._embed(params, tok_d)
            logits, _ = model.forward_train(params, tok_d)
            want_x = named_sharding(x.shape, ("batch", None, None), mesh)
            want_l = named_sharding(logits.shape, ("batch", None, "vocab"), mesh)
    return {"embed_placements": str(x.placements) == str(want_x),
            "logits_placements": str(logits.placements) == str(want_l),
            "embed_equal": bool(torch.equal(x.full_tensor(), x_want)),
            "logits_close": _close(logits.full_tensor().numpy(), logits_want.numpy(), 1e-5,
                                   1e-6)}


def steps(mesh):
    import numpy as np
    from repro_torch.distributed.sharding import (distribute, named_sharding, params_shardings,
                                                  sharding_context)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves
    ocfg = adamw.AdamWConfig(total_steps=10)
    out = {}
    for name, arch, lane, zero, mb in CASES:
        cfg = _cfg(arch, lane)
        model = build_model(cfg, device="cpu")
        batch = _batch(cfg)
        params = model.init(0)
        new, _, m = make_train_step(model, ocfg, mb)(params, adamw.init(params), batch)
        want = [t.numpy().copy() for t in leaves(new)]
        meta = build_model(cfg, device="meta").init()
        gsh = params_shardings(meta, mesh, {"embed": ("data",)}) if zero else None
        params = model.init(0, mesh=mesh)
        bsh = {k: named_sharding(v.shape, ("batch", None), mesh) for k, v in batch.items()}
        with sharding_context(mesh):
            new_d, opt_d, md = make_train_step(model, ocfg, mb, grad_shardings=gsh)(
                params, adamw.init(params), distribute(batch, mesh, bsh))
        got = [t.full_tensor().numpy() for t in leaves(new_d)]   # every rank gathers
        ok = [_close(g, w, 1e-4, 1e-5 * float(np.abs(w).max())) for g, w in zip(got, want)]
        same_pl = all(str(a.placements) == str(b.placements)
                      for a, b in zip(leaves(new_d), leaves(opt_d.m)))
        out[name] = {"loss": [float(md["loss"]), float(m["loss"])],
                     "grad_norm": [float(md["grad_norm"]), float(m["grad_norm"])],
                     "params_ok": ok, "n_leaves": len(want), "moments_placed": same_pl,
                     "sharded": all(type(t).__name__ == "DTensor" for t in leaves(new_d))}
    return out


def trainer(mesh, tmp):
    """The reference's initial state (its step-0 checkpoint) restored onto
    the mesh, then two steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")
    tc = TrainerConfig(n_steps=2, global_batch=4, seq_len=32, log_every=100,
                       ckpt_dir=os.environ["REF_CKPT"], checkpoint_every=100)
    hist = Trainer(cfg, tc, adamw.AdamWConfig(total_steps=10), mesh=mesh).train(resume=True)
    return [[h["step"], h["loss"]] for h in hist]


def body(rank, world, tmp):
    from repro_torch.launch.mesh import device_mesh
    mesh = device_mesh(("data", "model"), (2, 2), device="cpu")
    return {"constraints": constraints(mesh), "steps": steps(mesh),
            "trainer": trainer(mesh, tmp)}
'''


@pytest.fixture(scope="module")
def ref_trainer(tmp_path_factory):
    """(the reference's step-0 checkpoint, its sharded Trainer's losses)."""
    ckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    return ckpt, _json(run_py(REF_TRAINER.replace("CKPT", repr(ckpt)), devices=4))


@pytest.fixture(scope="module")
def four_ranks(ref_trainer, tmp_path_factory):
    return run_ranks(RANK_BODY, tmp_path_factory.mktemp("ranks"), REF_CKPT=ref_trainer[0])


def test_logical_constraint_at_the_model_call_sites(four_ranks):
    c = four_ranks["constraints"]
    assert c == {"embed_placements": True, "logits_placements": True, "embed_equal": True,
                 "logits_close": True}


@pytest.mark.parametrize("case", ["llama", "llama_zero2", "moe_sort", "moe_sort_zero2",
                                  "moe_bsr", "moe_bsr_zero2", "moe_sort_mb2"])
def test_sharded_train_step_equals_unsharded(four_ranks, case):
    r = four_ranks["steps"][case]
    assert r["sharded"] and r["moments_placed"]
    np.testing.assert_allclose(*r["loss"], rtol=1e-5)
    np.testing.assert_allclose(*r["grad_norm"], rtol=1e-5)
    assert all(r["params_ok"]) and len(r["params_ok"]) == r["n_leaves"]


REF_TRAINER = r"""
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.checkpoint.manager import CheckpointManager, config_hash
from repro.configs import get_smoke_config
from repro.optim import adamw
from repro.train.trainer import Trainer, TrainerConfig
devs = np.array(jax.devices())
mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
cfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")
tc = TrainerConfig(n_steps=2, global_batch=4, seq_len=32, log_every=100)
tr = Trainer(cfg, tc, adamw.AdamWConfig(total_steps=10), mesh=mesh)
params, opt = tr.state
assert len(params["embed"].sharding.device_set) == 4
CheckpointManager(CKPT).save(0, {"params": params, "opt": opt},
                             meta={"data_state": {"step": 0}, "config_hash": config_hash(cfg)})
print("JSON" + json.dumps([h["loss"] for h in tr.train()]))
"""


def test_sharded_trainer_equals_reference_sharded_trainer(ref_trainer, four_ranks):
    """The port's 4-rank ``Trainer`` starts from the reference's initial
    state (its checkpoint, restored with ``restore_sharded``) and trains the
    same two steps as the reference's ``Trainer`` on its (2, 2) mesh."""
    got = four_ranks["trainer"]
    assert [s for s, _ in got] == [0, 1]
    np.testing.assert_allclose([l for _, l in got], ref_trainer[1], rtol=1e-5)


# ------------------------------------------- the mesh helper, the launcher ----

MESH_HELPER = r"""
import torch.distributed as dist
from repro_torch.launch.mesh import device_mesh, mesh_scope
with mesh_scope(("data", "model"), (1, 1), "cpu") as m:
    assert dist.get_backend() == "gloo" and m.mesh_dim_names == ("data", "model")
assert not dist.is_initialized()                      # the scope tore down its group
a = device_mesh(("data", "model"), (16, 16), "meta")  # the fake group, 256 ranks
b = device_mesh(("pod", "data", "model"), (2, 16, 16), "meta")   # started again at 512
assert dist.get_backend() == "fake" and dist.get_world_size() == 512
assert tuple(b.shape) == (2, 16, 16)
try:
    device_mesh(("data",), (4,), "cpu")               # a fake group is up: refused
except ValueError as e:
    print("REFUSED", e)
dist.destroy_process_group()
try:
    device_mesh(("data",), (4,), "cpu")               # four ranks need torchrun
except RuntimeError as e:
    print("NEEDS", e)
"""


def test_device_mesh_helper():
    out = run_py(MESH_HELPER)
    assert "REFUSED" in out and "NEEDS" in out and "torchrun" in out


def _train_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                           "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32",
                           *args], env=env, capture_output=True, text=True, timeout=300)


def test_train_launcher_mesh_local():
    """``--mesh local`` from a lone process: a world of one, (1, 1) over
    ``("data", "model")`` on ``gloo``; its losses are the unsharded run's
    bits. ``--mesh prod`` needs 256 ranks and says so."""
    local, none = _train_cli("--mesh", "local"), _train_cli("--mesh", "none")
    assert local.returncode == 0, local.stderr[-3000:]
    assert "mesh=local" in local.stdout
    def losses(r):   # "final loss: L (first L0)", the step's time cut off
        return [ln.split(";")[0] for ln in r.stdout.splitlines() if ln.startswith("final loss")]

    assert losses(local) and losses(local) == losses(none)
    prod = _train_cli("--mesh", "prod")
    assert prod.returncode != 0 and "needs 256 ranks" in prod.stderr
