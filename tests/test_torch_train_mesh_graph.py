"""The train step on a ``DeviceMesh`` in the form a CUDA graph records, the
host's side of the captured mesh step (``Trainer(mesh=...)`` through
``repro_torch.train.CapturedTrainStep``), the port's form of the
reference's ``jax.jit(step_fn, in_shardings=(pshard, oshard, None),
out_shardings=..., donate_argnums=(0, 1))`` (``repro.train.trainer``).

``gloo`` ranks in a subprocess (``test_torch_sharding.run_ranks``: a
``file://`` rendezvous under ``tmp_path``, ``OMP_NUM_THREADS=1``, a timeout
of their own), on meshes of 1 rank (1, 1), 2 ranks (2, 1) and 4 ranks
(2, 2) over ``("data", "model")``:

  (1) the qwen3-moe smoke config (f32) on the ``bsr`` and ``sort`` lanes,
      with and without ``grad_shardings`` (ZeRO-2's ``embed -> data``), and
      the ``sort`` lane over 2 microbatches: the step as a capture runs it
      (under ``torch.no_grad()``, each batch's local shards copied into the
      same static DTensors, the params and AdamW state written in place)
      gives the eager mesh step's loss, grad_norm and every local shard of
      the params and moments bit for bit over three steps; and after the
      warm-up step it reads nothing from the device. The mode is
      ``tests/test_torch_train_graph.py``'s ``_NoHostRead``, made to see
      through DTensor's dispatch: it hands every call on a DTensor on
      (``NotImplemented``), so it also sees the local operations that
      DTensor runs for it (its redistributes, its sharding strategies'
      masks); it catches DTensor's own vocab-sharded gather, which masks
      its input with a host-made scalar (``t[mask] = 0``);
  (2) ``Trainer.restore`` on the 2-rank mesh writes every leaf's local
      tensor in place (each ``data_ptr`` kept), a ``fail_at`` restart
      replays the clean run's loss curve bit for bit, and a live leaf
      placed otherwise than the checkpoint restores it raises;
  (3) ``graph=True`` raises on the host, on a ``gloo`` mesh and on a
      stand-in CUDA mesh of 2 ranks; ``graph=None`` is eager there and
      captured on a CUDA mesh of one rank (``train.trainer.step_graph``).

The captured mesh step itself runs only on the card
(``tests/test_torch_train_mesh_graph_cuda.py``, ``-m cuda``). This file
imports no JAX: the eager mesh step is the reference here, and
``tests/test_torch_sharding.py`` holds that step to the reference's.
"""
import pytest
import torch

from test_torch_sharding import run_ranks

from repro_torch.configs import get_smoke_config
from repro_torch.train.trainer import Trainer, TrainerConfig, step_graph

#: Seconds a mesh's run may take (each rank propagates DTensor's sharding
#: once a config, then 6 steps a case).
MESH_TIMEOUT = 420

CASES = ["bsr", "bsr_zero2", "sort", "sort_zero2", "sort_mb2"]
MESHES = {1: (1, 1), 2: (2, 1), 4: (2, 2)}

MESH_BODY = r'''
CASES = {"bsr": ("bsr", False, 1), "bsr_zero2": ("bsr", True, 1), "sort": ("sort", False, 1),
         "sort_zero2": ("sort", True, 1), "sort_mb2": ("sort", False, 2)}
B, S, STEPS = 4, 16, 3
READS = {"_local_scalar_dense", "nonzero", "unique", "_unique", "_unique2", "unique_dim",
         "unique_consecutive", "lift_fresh", "lift_fresh_copy"}

from torch.utils._python_dispatch import TorchDispatchMode


class _NoHostRead(TorchDispatchMode):
    """Fails on every operation that hands a device value to the host or
    makes a tensor of host data, DTensor's local work included."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor dispatches it, with this mode still on
        if func.overloadpacket.__name__ in READS:
            raise AssertionError(f"the mesh step read the device or made a host tensor: {func}")
        return func(*args, **(kwargs or {}))


def _cfg(lane):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=lane))


def _run(mesh, lane, zero, mb, capture_form):
    """STEPS steps of the mesh step from the same seed: eagerly, or as a
    capture runs it. Returns the metrics, the final local shards and
    whether every leaf kept its local tensor."""
    from repro_torch.core import use_backend
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.sharding import params_shardings, sharding_context
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves
    cfg = _cfg(lane)
    model = build_model(cfg, device="cpu")
    meta = build_model(cfg, device="meta").init()
    params = model.init(0, mesh=mesh, shardings=params_shardings(meta, mesh))
    opt = adamw.init(params)
    gsh = params_shardings(meta, mesh, {"embed": ("data",)}) if zero else None
    step = make_train_step(model, adamw.AdamWConfig(total_steps=10), mb, grad_shardings=gsh)
    data = SyntheticTokens(cfg.vocab, S, B, seed=0, mesh=mesh, device="cpu")
    ptrs = [t.to_local().data_ptr() for t in leaves((params, opt.m, opt.v))]
    metrics = []
    with use_backend("cuda"), sharding_context(mesh):
        if not capture_form:
            for i in range(STEPS):
                m = step(params, opt, data._put(data.batch_at(i)))[2]
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
        else:
            static = {k: v.clone() for k, v in data._put(data.batch_at(0)).items()}
            with torch.no_grad():
                for i in range(STEPS):
                    batch = data._put(data.batch_at(i))
                    for k, v in static.items():
                        v.to_local().copy_(batch[k].to_local())
                    if i == 0:          # the warm-up
                        m = step(params, opt, static)[2]
                    else:
                        with _NoHostRead():
                            m = step(params, opt, static)[2]
                    metrics.append([float(m["loss"]), float(m["grad_norm"])])
    in_place = [t.to_local().data_ptr() for t in leaves((params, opt.m, opt.v))] == ptrs
    return metrics, [t.to_local().clone() for t in leaves((params, opt.m, opt.v))], in_place


def capture_form(mesh):
    out = {}
    for name, (lane, zero, mb) in CASES.items():
        want, want_t, _ = _run(mesh, lane, zero, mb, False)
        got, got_t, in_place = _run(mesh, lane, zero, mb, True)
        out[name] = {"want": want, "got": got, "in_place": in_place,
                     "leaves_equal": len(got_t) == len(want_t) and all(
                         torch.equal(a, b) for a, b in zip(got_t, want_t))}
    return out


def mode_sees_through_dtensor(mesh):
    """DTensor's gather on logits split over the vocab runs ``t[mask] = 0``
    on its local input: the mode must catch it (on a mesh that splits the
    vocab; elsewhere nothing is masked)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.sharding import sharding_context
    from repro_torch.models.model import _gold_logits
    lf = torch.arange(4 * 8, dtype=torch.float32).reshape(1, 4, 8)
    idx = torch.tensor([[[1], [5], [7], [0]]])
    pl = [Replicate()] * (mesh.ndim - 1) + [Shard(2)]
    lf_d = distribute_tensor(lf, mesh, pl, src_data_rank=None)
    idx_d = distribute_tensor(idx, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    caught = None
    with torch.no_grad(), sharding_context(mesh):
        torch.gather(lf_d, -1, idx_d)           # the warm-up: strategies cached
        try:
            with _NoHostRead():
                torch.gather(lf_d, -1, idx_d)
        except AssertionError as e:
            caught = str(e)
        with _NoHostRead():
            gold = _gold_logits(lf_d, idx_d)
        equal = bool(torch.equal(gold.full_tensor(), torch.gather(lf, -1, idx)))
    return {"caught": caught, "vocab_parallel_equal": equal}


def graph_rules(mesh):
    """``graph=True`` raises on a ``gloo`` mesh, ``None`` is eager there; a
    ``CapturedTrainStep`` refuses DTensors whose local tensors lie on the
    host, before any step runs."""
    from repro_torch.train import CapturedTrainStep
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tc = TrainerConfig(n_steps=1, global_batch=B, seq_len=S, log_every=100)
    try:
        Trainer(_cfg("bsr"), tc, mesh=mesh, graph=True)
        raised = None
    except ValueError as e:
        raised = str(e)
    tr = Trainer(_cfg("bsr"), tc, mesh=mesh)
    try:
        CapturedTrainStep(tr.model, tr._step, *tr.state, tr.data._put(tr.data.batch_at(0)))
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"raised": raised, "none_graph": tr.graph, "refused": refused,
            "ran": int(tr.state[1].step)}


def restore(mesh, tmp):
    """A 12-step run with checkpoints every 4 on the mesh, clean and with a
    failure at step 10 (restored from step 8); each leaf's local tensor
    kept; then a leaf placed otherwise makes ``restore`` raise."""
    from torch.distributed.tensor import Replicate
    from repro_torch.core import use_backend
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    def trainer(name):
        tc = TrainerConfig(n_steps=12, global_batch=B, seq_len=S, log_every=100,
                           ckpt_dir=os.path.join(tmp, name), checkpoint_every=4)
        return Trainer(_cfg("bsr"), tc, adamw.AdamWConfig(total_steps=12), mesh=mesh)

    with use_backend("cuda"):
        clean = trainer("clean").train()
        tr = trainer("failed")
        ptrs = [t.to_local().data_ptr() if hasattr(t, "to_local") else t.data_ptr()
                for t in leaves(tr.state)]
        failed = tr.train(fail_at=10)
    kept = ptrs == [t.to_local().data_ptr() if hasattr(t, "to_local") else t.data_ptr()
                    for t in leaves(tr.state)]
    by_step = {h["step"]: h["loss"] for h in failed}
    embed = tr.state[0]["embed"]
    tr.state[0]["embed"] = embed.redistribute(mesh, [Replicate()] * mesh.ndim)
    try:
        tr.restore()
        misplaced = None
    except ValueError as e:
        misplaced = str(e)
    return {"kept": kept, "replayed_8": [h["step"] for h in failed].count(8),
            "clean": [h["loss"] for h in clean], "failed": [by_step[i] for i in range(12)],
            "final_step": int(tr.state[1].step), "misplaced": misplaced,
            "embed_placements": str(embed.placements)}


def body(rank, world, tmp):
    from repro_torch.launch.mesh import device_mesh
    shape = {1: (1, 1), 2: (2, 1), 4: (2, 2)}[world]
    mesh = device_mesh(("data", "model"), shape, device="cpu")
    out = {"capture_form": capture_form(mesh), "mode": mode_sees_through_dtensor(mesh)}
    if world == 1:
        out["graph"] = graph_rules(mesh)
    if world == 2:
        out["restore"] = restore(mesh, tmp)
    return out
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's results, run once (every rank calls every collective)."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_ranks(MESH_BODY, tmp_path_factory.mktemp(f"ranks{world}"),
                                     world=world, timeout=MESH_TIMEOUT)
        return cache[world]

    return get


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", sorted(MESHES))
def test_capture_form_mesh_step_reads_nothing_and_gives_the_eager_bits(ranks, world, case):
    r = ranks(world)["capture_form"][case]
    assert r["got"] == r["want"]
    assert r["leaves_equal"] and r["in_place"]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_the_mode_sees_through_dtensor_dispatch(ranks, world):
    """On the (2, 2) mesh the vocab is split: DTensor's own gather masks its
    input on the host and the mode catches it, while the port's
    vocab-parallel gather passes and gives the gather's values."""
    r = ranks(world)["mode"]
    assert r["vocab_parallel_equal"]
    if MESHES[world][1] > 1:
        assert r["caught"] and "lift_fresh" in r["caught"]
    else:
        assert r["caught"] is None


def test_mesh_restore_writes_in_place_and_replays_the_clean_curve(ranks):
    r = ranks(2)["restore"]
    assert r["kept"] and r["replayed_8"] == 2 and r["final_step"] == 12
    assert r["failed"] == r["clean"]
    assert r["misplaced"] and "Trainer.restore: the live leaf params/embed" in r["misplaced"]


def test_graph_true_raises_on_a_gloo_mesh_and_none_is_eager(ranks):
    r = ranks(1)["graph"]
    assert r["raised"] and "graph=True" in r["raised"] and "on a mesh" in r["raised"]
    assert r["none_graph"] is False
    assert r["refused"] and "CapturedTrainStep captures a CUDA graph" in r["refused"]
    assert r["ran"] == 0


class _Mesh:
    """A stand-in for a ``DeviceMesh``: its device type and rank count."""

    def __init__(self, device_type, ranks):
        self.device_type, self.ranks = device_type, ranks

    def size(self):
        return self.ranks


CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")


@pytest.mark.parametrize("device,mesh,want", [
    (CPU, None, False), (CPU, _Mesh("cpu", 1), False), (CPU, _Mesh("cpu", 4), False),
    (CUDA, None, True), (CUDA, _Mesh("cuda", 1), True), (CUDA, _Mesh("cuda", 2), False)],
    ids=["host", "gloo-1", "gloo-4", "card", "cuda-mesh-1", "cuda-mesh-2"])
def test_graph_none_resolves_by_device_and_mesh(device, mesh, want):
    assert step_graph(None, device, mesh) is want
    assert step_graph(False, device, mesh) is False
    if want:
        assert step_graph(True, device, mesh) is True
    else:
        with pytest.raises(ValueError, match="graph=True"):
            step_graph(True, device, mesh)


def test_graph_true_on_a_cuda_mesh_of_two_ranks_names_the_collectives():
    with pytest.raises(ValueError, match="NCCL collectives .* not been verified"):
        step_graph(True, CUDA, _Mesh("cuda", 2))


def test_graph_true_raises_on_the_host():
    tc = TrainerConfig(n_steps=1, global_batch=2, seq_len=16)
    with pytest.raises(ValueError, match="graph=True .* CUDA device"):
        Trainer(get_smoke_config("llama3.2-1b"), tc, device="cpu", graph=True)
    assert Trainer(get_smoke_config("llama3.2-1b"), tc, device="cpu").graph is False
