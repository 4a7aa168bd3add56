"""The decode step captured in one CUDA graph, on the card (``-m cuda``;
imports no JAX: the card's machine has none). Smoke-size models of every
family in their served dtype (bf16 activations), on the serving policy
(``use_backend("cuda")``):

  - ``CapturedDecode``'s replays give the eager step's logits bit for bit
    over a prompt and greedy generation, and so the same tokens;
  - a second batch of requests after ``reset_caches`` repeats the first
    one's bits in the same buffers;
  - the graph has nodes, and the hand-written kernels it launches a step
    are the eager step's;
  - a position outside the caches raises before any replay.

Every test skips without a card.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import use_backend
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model, reset_caches
from repro_torch.serve import CapturedDecode
from repro_torch.tree import leaves

# cuBLAS picks its kernels by workspace: the same one on every stream
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

pytestmark = pytest.mark.cuda

LANES = ("bsr", "sort", "onehot", "grouped", "coo")
FAMILIES = ([("llama3.2-1b", None)] + [("qwen3-moe-235b-a22b", lane) for lane in LANES]
            + [("deepseek-v2-236b", "bsr"), ("jamba-v0.1-52b", "bsr"), ("rwkv6-7b", None),
               ("whisper-base", None)])
IDS = [f"{a}-{lane}" if lane else a for a, lane in FAMILIES]
B, S, G = 2, 5, 4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _model(arch, lane, device):
    cfg = get_smoke_config(arch)
    if lane and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=lane))
    model = build_model(cfg, device)
    prompt = np.random.default_rng(5).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    return model, model.init(0), torch.from_numpy(prompt).to(device)


def _serve(step, prompt):
    """Every step's logits: the prompt, then greedy tokens."""
    out, tok = [], prompt[:, :1]
    for t in range(S + G):
        logits = step(tok, t)
        out.append(logits)
        tok = prompt[:, t + 1:t + 2] if t + 1 < S else logits.argmax(-1).to(torch.int32)[:, None]
    return out


def _launched(before):
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("arch,lane", FAMILIES, ids=IDS)
def test_replays_give_the_eager_bits(cuda, arch, lane):
    model, params, prompt = _model(arch, lane, cuda)
    with use_backend("cuda"), torch.no_grad():
        caches = model.init_caches(B, S + G)
        before = launch_counts()
        model.decode_step(params, prompt[:, :1], caches, 0)
        one_step = _launched(before)
        reset_caches(caches)
        eager = _serve(lambda tok, pos: model.decode_step(params, tok, caches, pos)[0], prompt)
        static = model.init_caches(B, S + G)
        step = CapturedDecode(model, params, static, B)
        ptrs = [t.data_ptr() for t in leaves(static)]
        first = _serve(step, prompt)
        reset_caches(static)
        second = _serve(step, prompt)
    torch.cuda.synchronize()
    for t, (e, a, b) in enumerate(zip(eager, first, second)):
        assert torch.equal(a, e), f"step {t}: the replay's logits differ from the eager step's"
        assert torch.equal(b, a), f"step {t}: the second batch differs from the first"
    assert step.nodes > 0 and step.capture_s > 0 and step.instantiate_s > 0
    assert step.launches == one_step
    if lane == "bsr":
        assert step.launches.get("bsr_spmm", 0) > 0
    assert [t.data_ptr() for t in leaves(static)] == ptrs


def test_position_outside_the_caches_raises(cuda):
    model, params, prompt = _model("llama3.2-1b", None, cuda)
    with use_backend("cuda"):
        step = CapturedDecode(model, params, model.init_caches(B, S), B)
        with pytest.raises(ValueError, match="outside"):
            step(prompt[:, :1], S)
        with pytest.raises(ValueError, match="captured for tokens"):
            step(prompt[:1, :1], 0)
