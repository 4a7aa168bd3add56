"""The train step on a ``DeviceMesh`` captured in one CUDA graph, on the
card (``-m cuda``; skipped without one): the ``Trainer`` on a (1, 1)
``("data", "model")`` mesh over NCCL, one rank on the card (``launch.train
--mesh local`` in a lone process), trains the qwen3-moe smoke config on the
'bsr' lane under ``use_backend("cuda")``:

  - captured (``graph=None``: step 0 the warm-up and the capture, every
    later step a replay) it gives the eager mesh ``Trainer``'s
    (``graph=False``) loss and grad_norm at every step and its local
    shards at the end, and the unsharded eager ``Trainer``'s losses and
    grad_norms, bit for bit; the graph launches ``bsr_spmm`` and its
    backward kernels;
  - a failure at step 10 restores step 8's checkpoint into the graph's
    local tensors and replays: the losses equal the clean captured run's;
  - a step that reads the host fails its capture with ``CaptureError``,
    which the ``Trainer`` raises past its Supervisor, with no eager step
    run in its place.

Imports no JAX: the card's machine has none. The run is one subprocess
(the process group is process-global) with a timeout of its own.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import dataclasses, json, os, tempfile
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
from torch.distributed.tensor import DTensor
from repro_torch.capture import CaptureError
from repro_torch.configs import get_smoke_config
from repro_torch.core import use_backend
from repro_torch.launch.mesh import mesh_scope
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves

cfg = get_smoke_config("qwen3-moe-235b-a22b")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="bsr"))
tmp = tempfile.mkdtemp()


def trainer(graph, mesh=None, steps=6, ckpt=None, fail=False):
    tc = TrainerConfig(n_steps=steps, global_batch=4, seq_len=32, log_every=100,
                       ckpt_dir=os.path.join(tmp, ckpt) if ckpt else None, checkpoint_every=4)
    return Trainer(cfg, tc, adamw.AdamWConfig(total_steps=steps), mesh=mesh, graph=graph)


def local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def curve(hist):
    return [[h["step"], h["loss"], h["grad_norm"]] for h in hist]


out = {}
with use_backend("cuda"):
    unsharded = curve(trainer(False).train())
    with mesh_scope(("data", "model"), (1, 1), "cuda") as mesh:
        eager = trainer(False, mesh)
        want = curve(eager.train())
        tr = trainer(None, mesh)
        ptrs = [local(t).data_ptr() for t in leaves(tr.state)]
        got = curve(tr.train())
        st = tr.captured.stats()
        out["bits"] = {
            "graph": tr.graph, "got": got, "want": want, "unsharded": unsharded,
            "sharded": all(isinstance(t, DTensor) for t in leaves(tr.state[0])),
            "in_place": [local(t).data_ptr() for t in leaves(tr.state)] == ptrs,
            "leaves_equal": all(torch.equal(local(a), local(b))
                                for a, b in zip(leaves(tr.state), leaves(eager.state))),
            "nodes": st["nodes"], "launches": st["launches"]}
        del eager, tr

        clean = [h["loss"] for h in trainer(None, mesh, 12, "clean").train()]
        tr = trainer(None, mesh, 12, "failed")
        ptrs = [local(t).data_ptr() for t in leaves(tr.state)]
        failed = tr.train(fail_at=10)
        by_step = {h["step"]: h["loss"] for h in failed}
        out["restart"] = {
            "clean": clean, "failed": [by_step[i] for i in range(12)],
            "replayed_8": [h["step"] for h in failed].count(8),
            "in_place": [local(t).data_ptr() for t in leaves(tr.state)] == ptrs,
            "captured": tr.captured is not None, "final_step": int(tr.state[1].step)}
        del tr

        tr = trainer(None, mesh, 3)
        step, calls = tr._step, []

        def reads_the_loss(params, opt, batch):
            res = step(params, opt, batch)
            calls.append(float(res[2]["loss"]))   # a host read: fine eagerly, not captured
            return res

        tr._step = reads_the_loss
        try:
            tr.train()
            err = None
        except CaptureError as e:
            err = str(e)
        out["host_read"] = {"error": err, "calls": len(calls), "history": len(tr.history),
                            "draws": bool(torch.randn(8, device="cuda").isfinite().all())}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def card_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", CODE], env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, f"STDOUT:{r.stdout[-3000:]}\nSTDERR:{r.stderr[-6000:]}"
    return json.loads(r.stdout.split("JSON", 1)[1])


@pytest.mark.cuda
def test_captured_mesh_trainer_gives_the_eager_and_unsharded_bits(card_run):
    r = card_run["bits"]
    assert r["graph"] and r["sharded"] and r["in_place"] and r["leaves_equal"]
    assert r["got"] == r["want"]
    assert [x[1:] for x in r["got"]] == [x[1:] for x in r["unsharded"]]
    assert r["nodes"] > 0
    assert all(r["launches"].get(k, 0) > 0 for k in ("bsr_spmm", "bsr_spmm_t", "bsr_sddmm"))


@pytest.mark.cuda
def test_captured_mesh_restart_replays_the_clean_run(card_run):
    r = card_run["restart"]
    assert r["captured"] and r["in_place"] and r["final_step"] == 12
    assert r["replayed_8"] == 2 and r["failed"] == r["clean"]


@pytest.mark.cuda
def test_a_host_read_in_the_mesh_step_fails_the_capture(card_run):
    r = card_run["host_read"]
    assert r["error"] and "the train step" in r["error"]
    assert r["calls"] == 1 and r["history"] == 0   # the warm-up ran; nothing in its place
    assert r["draws"]
