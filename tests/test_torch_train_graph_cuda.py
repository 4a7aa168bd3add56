"""The one-device train step captured in one CUDA graph, on the card
(``-m cuda``; imports no JAX: the card's machine has none). Smoke-size
models through the ``Trainer`` on the serving policy (``use_backend("cuda")``)
under its deterministic mode:

  - the captured ``Trainer`` (``graph=None``: step 0 the warm-up and the
    capture, every later step a replay) gives the eager ``Trainer``'s
    (``graph=False``) loss, grad_norm and lr at every step, and its params
    and AdamW state at the end, bit for bit: llama3.2-1b and qwen3-moe on
    the ``bsr`` lane, without microbatches and f32, and with 2
    microbatches and ``keep_master``;
  - a failure at step 10 restores step 8's checkpoint into the graph's
    tensors and replays: the run's losses equal the clean captured run's;
  - the hand-written kernels the graph launches a step are the eager
    step's, and a replay runs no Python (no launch counter moves);
  - a step that reads the host fails its capture with ``CaptureError``,
    which the ``Trainer`` raises at once, with nothing run in its place,
    and the device's random generator still draws.

Every test skips without a card.
"""
import dataclasses
import os

import pytest
import torch

from repro_torch.capture import CaptureError
from repro_torch.configs import get_smoke_config
from repro_torch.core import use_backend
from repro_torch.kernels import launch_counts
from repro_torch.optim import adamw
from repro_torch.train import CapturedTrainStep
from repro_torch.train.trainer import Trainer, TrainerConfig, deterministic
from repro_torch.tree import leaves

# cuBLAS repeats its bits under the trainer's deterministic mode only with
# this workspace setting, read before the process's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

pytestmark = pytest.mark.cuda

CASES = [(arch, lane, mb, km) for arch, lane in (("llama3.2-1b", None),
                                                 ("qwen3-moe-235b-a22b", "bsr"))
         for mb, km in ((1, False), (2, True))]
IDS = [f"{a}-mb{mb}-{'master' if km else 'f32'}" for a, _, mb, km in CASES]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _trainer(arch, lane, graph, steps=6, ckpt_dir=None, microbatches=1, keep_master=False):
    cfg = get_smoke_config(arch)
    if lane:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=lane))
    tcfg = TrainerConfig(n_steps=steps, global_batch=4, seq_len=32, microbatches=microbatches,
                         ckpt_dir=ckpt_dir, checkpoint_every=4, log_every=100)
    return Trainer(cfg, tcfg, adamw.AdamWConfig(total_steps=steps, keep_master=keep_master),
                   device="cuda", graph=graph)


def _run(tr, **kw):
    with use_backend("cuda"):
        return tr.train(**kw)


def _curve(hist):
    return [(h["step"], h["loss"], h["grad_norm"], h["lr"]) for h in hist]


@pytest.mark.parametrize("arch,lane,microbatches,keep_master", CASES, ids=IDS)
def test_captured_trainer_gives_the_eager_bits(cuda, arch, lane, microbatches, keep_master):
    kw = dict(microbatches=microbatches, keep_master=keep_master)
    eager = _trainer(arch, lane, False, **kw)
    want = _run(eager)
    tr = _trainer(arch, lane, None, **kw)
    assert tr.graph
    ptrs = [t.data_ptr() for t in leaves(tr.state)]
    got = _run(tr)
    assert _curve(got) == _curve(want)
    assert [t.data_ptr() for t in leaves(tr.state)] == ptrs
    for a, b in zip(leaves(tr.state), leaves(eager.state)):
        assert torch.equal(a, b)
    st = tr.captured.stats()
    assert st["nodes"] > 0 and st["capture_s"] > 0 and st["instantiate_s"] > 0
    if lane == "bsr":
        assert all(st["launches"].get(k, 0) > 0 for k in ("bsr_spmm", "bsr_spmm_t",
                                                            "bsr_sddmm"))


@pytest.mark.parametrize("arch,lane", [("llama3.2-1b", None), ("qwen3-moe-235b-a22b", "bsr")])
def test_captured_restart_replays_the_clean_run(cuda, tmp_path, arch, lane):
    clean = _run(_trainer(arch, lane, None, steps=12, ckpt_dir=str(tmp_path / "a")))
    tr = _trainer(arch, lane, None, steps=12, ckpt_dir=str(tmp_path / "b"))
    ptrs = [t.data_ptr() for t in leaves(tr.state)]
    failed = _run(tr, fail_at=10)
    captured = tr.captured
    assert [h["step"] for h in failed].count(8) == 2
    by_step = {h["step"]: (h["loss"], h["grad_norm"]) for h in failed}
    assert [by_step[i] for i in range(12)] == [(h["loss"], h["grad_norm"]) for h in clean]
    assert [t.data_ptr() for t in leaves(tr.state)] == ptrs
    assert tr.captured is captured and int(tr.state[1].step) == 12


def test_a_replay_launches_the_eager_steps_kernels(cuda):
    """One eager step's launch counts (from the same state) against the
    capture's; replays move no counter."""
    tr = _trainer("qwen3-moe-235b-a22b", "bsr", None, steps=3)
    eager = _trainer("qwen3-moe-235b-a22b", "bsr", False, steps=3)
    params, opt = eager.state
    batch = eager.data._put(eager.data.batch_at(0))
    with use_backend("cuda"), deterministic(eager.device):
        before = launch_counts()
        eager._step(params, opt, batch)
        after = launch_counts()
    one_step = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    with use_backend("cuda"), deterministic(tr.device):
        step = CapturedTrainStep(tr.model, tr._step, *tr.state,
                                 tr.data._put(tr.data.batch_at(0)))
        before = launch_counts()
        for i in (1, 2):
            step(tr.data._put(tr.data.batch_at(i)))
        torch.cuda.synchronize()
    assert launch_counts() == before
    assert step.launches == one_step and one_step.get("bsr_sddmm", 0) > 0


def test_a_host_read_in_the_step_fails_the_capture(cuda, monkeypatch):
    tr = _trainer("llama3.2-1b", None, None, steps=3)
    step = tr._step
    calls = []

    def reads_the_loss(params, opt, batch):
        out = step(params, opt, batch)
        calls.append(float(out[2]["loss"]))   # a host read: fine eagerly, not in a capture
        return out

    monkeypatch.setattr(tr, "_step", reads_the_loss)
    with pytest.raises(CaptureError, match="the train step"):
        _run(tr)
    assert len(calls) == 1 and tr.history == []    # the warm-up ran; nothing ran in its place
    # the failed capture left the device's random generator usable
    assert torch.randn(8, device=cuda).isfinite().all()
