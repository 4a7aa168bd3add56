"""The train step in the form a CUDA graph records, the host's side of the
captured one-device train step (``repro_torch.train.CapturedTrainStep``),
the port's form of the reference's ``jax.jit(step_fn,
donate_argnums=(0, 1))`` (``repro.train.trainer``).

Smoke-size models, seeded numpy batches, on the CPU:

  (a) the step as a capture runs it (under ``torch.no_grad()``, each batch
      copied into the same static tensors, params and AdamW state written
      in place) against the reference's jitted, donated step over three
      steps, on weights carried across (``params_from_reference``), f32
      activations; llama3.2-1b and qwen3-moe on the ``bsr`` and ``sort``
      lanes, microbatches 1 and 2, ``keep_master`` off (f32 params) and on
      (bf16 params beside an f32 master). Tolerances,
      ``tests/test_torch_train.py``'s, each with its reason there: loss
      rtol 1e-5, grad_norm rtol 1e-4, lr rtol 1e-6; parameters (and the
      master) atol 2 lr a step, so ``2 k lr_k`` after ``k`` steps (lr grows
      through the warm-up, so ``lr_k`` is the largest), bf16 parameters
      also rtol 2^-8 (one rounding of the master); the moments hold to the
      gradients' rtol 1e-4 with atol 1e-5 of the leaf's largest element,
      and with bf16 params (bf16 gradients, rounded in each framework's
      own place) to one bf16 step: rtol 2^-8, atol 2^-8 of the largest;
  (b) after a warm-up step, one step reads nothing from the device and
      makes no tensor on the host: under a ``TorchDispatchMode`` that fails
      on ``aten._local_scalar_dense``, ``nonzero``, ``unique*`` and
      ``lift_fresh`` (``torch.tensor`` of host data), the host's proxy for
      "a capture will not raise". The plain and ``cuda`` policies, the
      lanes that train (``coo`` under plain only: on host tensors its
      ``cuda`` branch loops over a bound it reads, which the card never
      does, ``kernels/coo_spmv.py``), remat ``full`` and ``none``; and the
      mode catches the update's old ``torch.tensor(cfg.b1, device=...)``;
  (c) ``Trainer.restore`` writes into the live tensors (every leaf's and
      the step counter's ``data_ptr`` kept) and a restart replays the
      clean run's loss curve bit for bit;
  (d) ``Trainer(graph=True)`` raises on the host and on a ``gloo`` mesh;
      ``graph=None`` on the host trains eagerly, ``graph=False``'s bits.

The captured step itself runs only on the card
(``tests/test_torch_train_graph_cuda.py``, ``-m cuda``).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.core import use_backend
from repro_torch.models import build_model
from repro_torch.models.from_reference import params_from_reference
from repro_torch.optim import adamw
from repro_torch.train import CapturedTrainStep
from repro_torch.train.steps import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = "qwen3-moe-235b-a22b"
DENSE = "llama3.2-1b"
OCFG = dict(total_steps=10)
B, S, STEPS = 4, 16, 3
#: the host reads, and the host-made tensors, a capture does not take
READS = {"_local_scalar_dense", "nonzero", "unique", "_unique", "_unique2", "unique_dim",
         "unique_consecutive", "lift_fresh", "lift_fresh_copy"}


def _cfg(get, arch, lane, remat="none", dtype=None):
    cfg = get(arch).replace(remat=remat)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    if lane is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=lane))
    return cfg


def _batches(vocab, n=STEPS, b=B, s=S):
    rng = np.random.default_rng(7)
    return [{k: rng.integers(1, vocab, (b, s)).astype(np.int32) for k in ("tokens", "targets")}
            for _ in range(n)]


class _NoHostRead(TorchDispatchMode):
    """Fails on every operation that hands a device value to the host or
    makes a tensor of host data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in READS:
            raise AssertionError(f"the train step read the device or made a host tensor: {func}")
        return func(*args, **(kwargs or {}))


# ------------------------------------------------- (a) against the reference


def _leaf_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _reference(arch, lane, microbatches, keep_master):
    """The reference's initial params, and each of ``STEPS`` steps' metrics
    and, after the last, params, m, v and master, through its jitted,
    donated step, as numpy."""
    model = jbuild(_cfg(jget_smoke, arch, lane, dtype="float32"))
    params = model.init(jax.random.PRNGKey(0))
    if keep_master:     # bf16 params beside an f32 master
        params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    init = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32), params)
    opt = jadamw.init(params, keep_master=keep_master)
    step = jax.jit(jmake_train_step(model, jadamw.AdamWConfig(**OCFG, keep_master=keep_master),
                                    microbatches), donate_argnums=(0, 1))
    metrics = []
    for batch in _batches(model.cfg.vocab):
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    master = _leaf_np(opt.master) if keep_master else None
    return init, metrics, _leaf_np(params), _leaf_np(opt.m), _leaf_np(opt.v), master


CAPTURE_FORM = [(a, lane, mb, km) for a, lane in ((DENSE, None), (MOE, "bsr"), (MOE, "sort"))
                for mb in (1, 2) for km in (False, True)]


@pytest.mark.parametrize("arch,lane,microbatches,keep_master", CAPTURE_FORM, ids=[
    f"{a}-{lane}-mb{mb}-{'master' if km else 'nomaster'}" for a, lane, mb, km in CAPTURE_FORM])
def test_capture_form_step_matches_reference_jitted_donated_step(arch, lane, microbatches,
                                                                 keep_master):
    init, jmetrics, jparams, jm, jv, jmaster = _reference(arch, lane, microbatches, keep_master)
    cfg = _cfg(get_smoke_config, arch, lane, dtype="float32")
    model = build_model(cfg, device="cpu")
    params = params_from_reference(cfg, init, device="cpu")
    if keep_master:
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
    opt = adamw.init(params, keep_master=keep_master)
    ptrs = [t.data_ptr() for t in leaves((params, opt))]
    ocfg = adamw.AdamWConfig(**OCFG, keep_master=keep_master)
    step = make_train_step(model, ocfg, microbatches)
    batches = _batches(cfg.vocab)
    static = {k: torch.zeros(v.shape, dtype=torch.int32) for k, v in batches[0].items()}
    with use_backend("cuda"), torch.no_grad():
        for i, (batch, want) in enumerate(zip(batches, jmetrics)):
            for k, v in static.items():
                v.copy_(torch.from_numpy(batch[k]))
            out_params, out_opt, m = step(params, opt, static)
            assert out_params is params and out_opt is opt
            assert all(v.dim() == 0 for v in m.values())
            np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5, err_msg=i)
            np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"], rtol=1e-4,
                                       err_msg=i)
            np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=1e-6, err_msg=i)
    assert int(opt.step) == STEPS
    assert [t.data_ptr() for t in leaves((params, opt))] == ptrs
    atol = 2 * STEPS * jmetrics[-1]["lr"]
    # a bf16 parameter is its master rounded: masters that differ by less
    # than atol may round one bf16 step (2^-8 of the value) apart
    rtol = 2.0 ** -8 if keep_master else 0
    for t, w in zip(leaves(params), jparams):
        assert not t.requires_grad
        np.testing.assert_allclose(t.float().numpy(), w.astype(np.float32), rtol=rtol, atol=atol)
    if keep_master:
        for t, w in zip(leaves(opt.master), jmaster):
            np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=atol)
    else:
        assert opt.master is None
    # the gradients' tolerance; bf16 params have bf16 gradients, each
    # rounded in its framework's own place: one bf16 step (2^-8) of the
    # element, or of the leaf's largest where the steps' gradients cancel
    rtol, atol_of_max = (2.0 ** -8, 2.0 ** -8) if keep_master else (1e-4, 1e-5)
    for got, want in ((opt.m, jm), (opt.v, jv)):
        for t, w in zip(leaves(got), want):
            np.testing.assert_allclose(t.numpy(), w, rtol=rtol,
                                       atol=atol_of_max * float(np.abs(w).max()))


# ------------------------------------------------------ (b) no host reads


def _no_read_step(arch, lane, remat, policy, microbatches=1):
    cfg = _cfg(get_smoke_config, arch, lane, remat)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(**OCFG), microbatches)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab, 1, b=2)[0].items()}
    with use_backend(policy), torch.no_grad():
        step(params, opt, batch)   # the warm-up: first-call caches are built here
        with _NoHostRead():
            return step(params, opt, batch)


NO_READ = [(a, lane, remat, policy)
           for a, lane in [(DENSE, None)] + [(MOE, x) for x in ("bsr", "sort", "onehot",
                                                                 "grouped", "coo")]
           for remat in ("none", "full") for policy in ("plain", "cuda")
           if not (lane == "coo" and policy == "cuda")]


@pytest.mark.parametrize("arch,lane,remat,policy", NO_READ, ids=[
    f"{a}-{lane}-{r}-{p}" if lane else f"{a}-{r}-{p}" for a, lane, r, p in NO_READ])
def test_warm_step_reads_nothing_from_the_device(arch, lane, remat, policy):
    _, opt, m = _no_read_step(arch, lane, remat, policy)
    assert int(opt.step) == 2 and bool(torch.isfinite(m["loss"]))


def test_warm_step_with_microbatches_reads_nothing_from_the_device():
    _, opt, m = _no_read_step(MOE, "bsr", "full", "cuda", microbatches=2)
    assert int(opt.step) == 2 and bool(torch.isfinite(m["loss"]))


def test_the_mode_catches_a_host_made_base():
    """The update's bias-correction base as it was made before, with
    ``torch.tensor`` (host data copied to the params' device, which a
    capture refuses), fails under the mode; as it is made now, and the
    whole update, pass."""
    stepf = torch.ones((), dtype=torch.float32)
    with _NoHostRead():
        with pytest.raises(AssertionError, match="lift_fresh"):
            torch.pow(torch.tensor(0.9, device=stepf.device), stepf)
        torch.pow(torch.full((), 0.9, dtype=torch.float32, device=stepf.device), stepf)
        params = {"w": torch.ones((3, 2))}
        opt = adamw.init(params)
        adamw.update(adamw.AdamWConfig(), {"w": torch.full((3, 2), 0.5)}, opt, params)
    assert int(opt.step) == 1


# ----------------------------------------------- (c) restore in place, (d) graph=


def _trainer(n_steps, ckpt_dir=None, device="cpu", **kw):
    return Trainer(get_smoke_config(DENSE),
                   TrainerConfig(n_steps=n_steps, global_batch=2, seq_len=32, ckpt_dir=ckpt_dir,
                                 checkpoint_every=4, log_every=100), device=device, **kw)


def test_restore_writes_the_live_tensors_and_replays_the_clean_curve(tmp_path):
    clean = _trainer(12, str(tmp_path / "a")).train()
    tr = _trainer(12, str(tmp_path / "b"))
    ptrs = [t.data_ptr() for t in leaves(tr.state)]
    step_ptr = tr.state[1].step.data_ptr()
    failed = tr.train(fail_at=10)    # restores step 8's checkpoint
    assert [t.data_ptr() for t in leaves(tr.state)] == ptrs
    assert tr.state[1].step.data_ptr() == step_ptr and int(tr.state[1].step) == 12
    by_step = {h["step"]: h["loss"] for h in failed}
    assert [h["step"] for h in failed].count(8) == 2
    assert [by_step[i] for i in range(12)] == [h["loss"] for h in clean]
    (params, opt), step = tr.restore()
    assert step == 12 and params is tr.state[0] and opt is tr.state[1]
    assert [t.data_ptr() for t in leaves(tr.state)] == ptrs


def test_graph_true_raises_on_the_host():
    with pytest.raises(ValueError, match="graph=True .* CUDA device"):
        _trainer(2, graph=True)


def test_captured_step_raises_on_the_host():
    tr = _trainer(1)
    batch = tr.data._put(tr.data.batch_at(0))
    with pytest.raises(ValueError, match="CapturedTrainStep captures a CUDA graph"):
        CapturedTrainStep(tr.model, tr._step, *tr.state, batch)
    assert int(tr.state[1].step) == 0   # nothing ran


def test_graph_none_on_the_host_is_the_eager_step():
    tr = _trainer(4)
    assert tr.graph is False
    auto = tr.train()
    assert tr.captured is None
    eager = _trainer(4, graph=False).train()
    assert [(h["loss"], h["grad_norm"], h["lr"]) for h in auto] == \
        [(h["loss"], h["grad_norm"], h["lr"]) for h in eager]


MESH_SCRIPT = """
import pytest
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import mesh_scope
from repro_torch.train.trainer import Trainer, TrainerConfig
cfg, tcfg = get_smoke_config("llama3.2-1b"), TrainerConfig(n_steps=1, global_batch=2, seq_len=16)
with mesh_scope(("data", "model"), (1, 1), "cpu") as mesh:
    with pytest.raises(ValueError, match="graph=True .* on a mesh"):
        Trainer(cfg, tcfg, mesh=mesh, graph=True)
    assert Trainer(cfg, tcfg, mesh=mesh).graph is False
print("ok")
"""


def test_graph_true_raises_on_a_gloo_mesh(tmp_path):
    """A lone process's (1, 1) ``gloo`` mesh (the group on a local store),
    in a subprocess: the process group is process-wide."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env, capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
