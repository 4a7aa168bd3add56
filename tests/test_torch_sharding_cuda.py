"""The model's sharding on the card (``-m cuda``; skipped without one): the
``Trainer`` on a (1, 1) ``("data", "model")`` ``DeviceMesh`` over NCCL,
one rank on the card, trains the qwen3-moe smoke config on the 'bsr' lane
(``bsr_spmm`` and its backward kernels launched from the MoE's
``local_map`` region) with losses and grad_norms equal in bits to the
unsharded ``Trainer``'s: every mesh axis has size 1, so every local shard
is the whole tensor and every collective is skipped.

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
import dataclasses, json, os
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke_config
from repro_torch.core import use_backend
from repro_torch.kernels.bsr_spmm import bsr_sddmm, bsr_spmm, bsr_spmm_t
from repro_torch.launch.mesh import mesh_scope
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves

cfg = get_smoke_config("qwen3-moe-235b-a22b")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="bsr"))
tc = dict(n_steps=3, global_batch=8, seq_len=64, log_every=100)
with use_backend("cuda"):
    want = Trainer(cfg, TrainerConfig(**tc), adamw.AdamWConfig(total_steps=3)).train()
    with mesh_scope(("data", "model"), (1, 1), "cuda") as mesh:
        tr = Trainer(cfg, TrainerConfig(**tc), adamw.AdamWConfig(total_steps=3), mesh=mesh)
        for fn in (bsr_spmm, bsr_spmm_t, bsr_sddmm):
            fn.launches = 0
        got = tr.train()
        sharded = all(isinstance(t, DTensor) for t in leaves(tr.state[0]))
print("JSON" + json.dumps({
    "want": [[h["loss"], h["grad_norm"]] for h in want],
    "got": [[h["loss"], h["grad_norm"]] for h in got], "sharded": sharded,
    "launches": [bsr_spmm.launches, bsr_spmm_t.launches, bsr_sddmm.launches]}))
"""


@pytest.mark.cuda
def test_sharded_step_equals_unsharded_bits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", CODE], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, f"STDOUT:{r.stdout}\nSTDERR:{r.stderr[-6000:]}"
    out = json.loads(r.stdout.split("JSON", 1)[1])
    assert out["sharded"]
    assert out["got"] == out["want"]
    assert all(n > 0 for n in out["launches"]), out["launches"]
