"""The port's ``Trainer`` (``repro_torch.train.trainer``) on the host: twins
of the reference's training tests of ``tests/test_resilience.py``, at smoke
size and not marked slow (the port's steps take tens of milliseconds here),
and a run resumed across the packages.

Cross-package resume: the reference's ``Trainer`` trains steps 0-4 and
checkpoints; the port's ``Trainer(resume=True, device="cpu")`` restores
that checkpoint (params and AdamW state, keys and config hash the
reference's) and trains steps 5-9, whose losses hold to the reference's
own steps 5-9 at rtol 1e-5. Both run at f32 activations: in bf16 each
framework rounds at its own places, a few parts in 1e4 of the loss.
"""
import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "llama3.2-1b"


def _trainer(n_steps, ckpt_dir=None, every=4, batch=2, seq=32, **kw):
    cfg = get_smoke_config(ARCH)
    return Trainer(cfg, TrainerConfig(n_steps=n_steps, global_batch=batch, seq_len=seq,
                                      ckpt_dir=ckpt_dir, checkpoint_every=every,
                                      log_every=100, **kw), device="cpu")


def test_failure_restart_is_bitexact(tmp_path):
    h1 = _trainer(12, str(tmp_path / "a")).train()
    h2 = _trainer(12, str(tmp_path / "b")).train(fail_at=10)  # restores step 8
    l1 = [h["loss"] for h in h1]
    l2 = {h["step"]: h["loss"] for h in h2}
    assert abs(l1[-1] - l2[11]) < 1e-6
    # the replayed steps (8, 9) match too (data replay)
    assert abs(l1[8] - [h["loss"] for h in h2 if h["step"] == 8][-1]) < 1e-6
    assert abs(l1[9] - l2[9]) < 1e-6
    assert [h["step"] for h in h2].count(8) == 2


def test_resume_from_checkpoint(tmp_path):
    _trainer(10, str(tmp_path), every=5).train()
    h2 = _trainer(20, str(tmp_path), every=5).train(resume=True)
    steps = [h["step"] for h in h2]
    assert min(steps) == 10 and max(steps) == 19   # no recompute of 0-9


def test_loss_decreases():
    h = _trainer(30, batch=4, seq=64).train()
    first = np.mean([x["loss"] for x in h[:5]])
    last = np.mean([x["loss"] for x in h[-5:]])
    assert last < first - 0.05, (first, last)


def test_resume_across_packages(tmp_path):
    from repro.configs import get_smoke_config as jget_smoke
    from repro.optim import adamw as jadamw
    from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig

    tc = dict(global_batch=2, seq_len=32, checkpoint_every=5, log_every=100)
    cut = str(tmp_path / "cut")
    jcfg = jget_smoke(ARCH).replace(dtype="float32")
    JTrainer(jcfg, JTrainerConfig(n_steps=5, ckpt_dir=cut, **tc),
             jadamw.AdamWConfig(total_steps=10)).train()
    want = JTrainer(jcfg, JTrainerConfig(n_steps=10, **tc),
                    jadamw.AdamWConfig(total_steps=10)).train()
    port = Trainer(get_smoke_config(ARCH).replace(dtype="float32"),
                   TrainerConfig(n_steps=10, ckpt_dir=cut, **tc),
                   adamw.AdamWConfig(total_steps=10), device="cpu")
    got = port.train(resume=True)
    assert [h["step"] for h in got] == [5, 6, 7, 8, 9]
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want[5:]],
                               rtol=1e-5)
    assert int(port.state[1].step) == 10
