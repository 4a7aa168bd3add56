"""The serving path's rules on the card, where dispatch runs a ``cuda``
kernel or raises (imports no JAX: the card's machine has none).

  - a coalesced tile equals per-request SpMV bit for bit on every ``cuda``
    format (the SpMM lane is the SpMV kernel once per column);
  - ``select_spmv`` reports what dispatch runs on the card: a quarantined
    ``cuda`` key on a CUDA-resident container is still its answer, so the
    engine's admission count, ``coalescible`` and the tile's retarget read
    the lane that really runs;
  - under an armed kernel fault the engine itself moves off the failing
    kernel (dispatch will not): every ticket resolves, the breaker
    quarantines the key, and the degraded results equal the plain lane bit
    for bit;
  - a kernel that really fails (no fault planted) is never served around:
    its requests resolve to ``kind="execution"`` with no retry, before and
    after the breaker quarantines the key.

The ``-m cuda`` tests skip without a card; each has a CPU twin that runs
here, with the container's device or the engine's and dispatch's on-card
test stubbed, so the host tensors take the card's rules.
"""
import importlib

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import DispatchKey, ExecutionPolicy, as_operator
from repro_torch.core import matrices as M
from repro_torch.core.health import HealthRegistry, use_health
from repro_torch.kernels import ops  # noqa: F401  (registers the cuda backend)
from repro_torch.resilience import FaultPlan, FaultSpec
from repro_torch.serve import ServeEngine, coalescible

tspmv = importlib.import_module("repro_torch.core.spmv")
tengine = importlib.import_module("repro_torch.serve.engine")

CUDA_FORMATS = ("coo", "csr", "dia", "ell", "sell")

_N = 96
_S = (M.banded(_N, 3, seed=0) + M.random_uniform(_N, 0.02, seed=1)).tocsr()
_RHS = [np.random.default_rng(10 + i).standard_normal(_N).astype(np.float32)
        for i in range(6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.fixture
def as_on_card(monkeypatch):
    """Host tensors under the card's rules: dispatch and the engine both
    take them for CUDA operands (the kernels' plain versions run)."""
    monkeypatch.setattr(tspmv, "_on_card", lambda x: True)
    monkeypatch.setattr(tengine, "_on_card", lambda op: True)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


# ------------------------------------------------------- coalesced tiles ----


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", CUDA_FORMATS)
def test_coalesced_equals_per_request_on_card(cuda, fmt):
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    batched = ServeEngine(fmt=fmt, policy=pol, tune_mode=None, max_batch=8, device=cuda)
    singles = ServeEngine(fmt=fmt, policy=pol, tune_mode=None, max_batch=1, device=cuda)
    t_b = [batched.submit(_S, x) for x in _RHS]
    t_s = [singles.submit(_S, x) for x in _RHS]
    batched.flush()
    singles.flush()
    op = batched.workspace.lookup(batched.fingerprint(_S))
    for tb, ts, x in zip(t_b, t_s, _RHS):
        y = tb.result()
        assert y.device.type == "cuda"
        assert torch.equal(y, ts.result()) and torch.equal(y, op @ x), fmt
    assert all(t.record.coalesced for t in t_b)
    want = torch.from_numpy((_S @ np.stack(_RHS, 1).astype(np.float64)).T.astype(np.float32))
    np.testing.assert_allclose(torch.stack([t.result() for t in t_b]).cpu().numpy(),
                               want.numpy(), rtol=2e-4, atol=2e-4)
    out = batched.summary()
    assert out["dispatch_fallbacks"] == 0 and out["degraded_requests"] == 0


# ------------------------------------------------------ select_spmv fix ----


class _OnCard:
    """A host container that reports a CUDA device."""

    device = torch.device("cuda")

    def __init__(self, A):
        self._A = A

    def __getattr__(self, name):
        return getattr(self._A, name)


def _quarantined_select(A):
    key = DispatchKey(A.format, "cuda")
    reg = HealthRegistry(failure_threshold=1, cooldown_s=1e9)
    pol = ExecutionPolicy(backends=("cuda", "plain"))
    with use_health(reg):
        reg.record_failure(key)
        assert reg.blocked(key)
        return T.select_spmv(A, pol).key


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", CUDA_FORMATS)
def test_select_spmv_reports_quarantined_cuda_key_on_card(cuda, fmt):
    A = T.from_dense(_S, fmt, device=cuda)
    assert _quarantined_select(A) == DispatchKey(fmt, "cuda")
    assert coalescible(as_operator(A).using("cuda"))


@pytest.mark.parametrize("fmt", CUDA_FORMATS)
def test_select_spmv_reports_quarantined_cuda_key_on_card_stub(fmt):
    A = T.from_dense(_S, fmt, device="cpu")
    assert _quarantined_select(_OnCard(A)) == DispatchKey(fmt, "cuda")
    # on the host the breaker's order stands: plain goes first
    assert _quarantined_select(A) == DispatchKey(fmt, "plain")


# ------------------------------------------------------ degraded serving ----


def _chaos(device, fmt, times=3):
    """A fault on ``(fmt, cuda)`` during one flush of 4, then a clean flush
    of 4; returns the engine, tickets and plan."""
    clk = FakeClock()
    eng = ServeEngine(fmt=fmt, policy=ExecutionPolicy.for_impl("cuda"), tune_mode=None,
                      max_batch=4, clock=clk, device=device,
                      health=HealthRegistry(cooldown_s=1e9, clock=clk))
    plan = FaultPlan([FaultSpec("kernel", key=(fmt, "cuda"), times=times)])
    with plan:
        tickets = [eng.submit(_S, x) for x in _RHS[:4]]
        eng.flush()
        tickets += [eng.submit(_S, x) for x in _RHS[2:6]]
        eng.flush()
    return eng, tickets, plan


def _check_degraded(eng, tickets, plan, device, fmt):
    plain = as_operator(_S, fmt, device=device).using("plain")
    assert all(t.ok for t in tickets)
    assert eng.health.quarantined(DispatchKey(fmt, "cuda"))
    for t, x in zip(tickets, _RHS[:4] + _RHS[2:6]):
        assert torch.equal(t.result(), plain @ x), fmt
    out = eng.summary()
    # the coalesced tile failed and split; the first request retried off
    # cuda and quarantined it; the rest of that tile ran without the blocked
    # key; the next flush's tile retargeted to plain, each request degraded
    assert plan.fired("kernel") == 2
    assert out["batch_splits"] == 1 and out["retries"] == 1
    assert [t.record.retries for t in tickets[:4]] == [1, 0, 0, 0]
    assert [t.record.degraded for t in tickets] == [False] * 4 + [True] * 4
    assert out["degraded_requests"] == 4 and out["errors"] == 0
    assert all(t.record.coalesced for t in tickets[4:])
    assert out["health"]["quarantined_now"] == [f"{fmt}/cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_armed_kernel_fault_degrades_to_plain_on_card(cuda, fmt):
    eng, tickets, plan = _chaos(cuda, fmt)
    _check_degraded(eng, tickets, plan, cuda, fmt)


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_armed_kernel_fault_degrades_to_plain_on_card_stub(as_on_card, fmt):
    eng, tickets, plan = _chaos("cpu", fmt)
    _check_degraded(eng, tickets, plan, "cpu", fmt)


def test_card_rules_without_the_engine_would_fail_every_request(as_on_card):
    """The reason for the engine's lane: with dispatch alone (chain
    ``cuda, plain``, no retry), every request under the fault resolves to
    ``kind="execution"`` on the card."""
    clk = FakeClock()
    eng = ServeEngine(fmt="csr", policy=ExecutionPolicy.for_impl("cuda"), tune_mode=None,
                      max_batch=1, max_retries=0, clock=clk, device="cpu",
                      health=HealthRegistry(failure_threshold=100, clock=clk))
    with FaultPlan([FaultSpec("kernel", key=("csr", "cuda"), times=3)]):
        tickets = [eng.submit(_S, x) for x in _RHS[:3]]
        eng.flush()
    assert [t.error.kind for t in tickets] == ["execution"] * 3


def test_strict_policy_is_not_degraded_on_card(as_on_card):
    """``allow_fallback=False`` means this backend or an error: a blocked
    strict cuda lane still runs (and here serves once the fault is spent)."""
    clk = FakeClock()
    eng = ServeEngine(fmt="csr", policy=ExecutionPolicy(backends=("cuda",), allow_fallback=False),
                      tune_mode=None, max_batch=1, max_retries=0, clock=clk, device="cpu",
                      health=HealthRegistry(failure_threshold=1, cooldown_s=1e9, clock=clk))
    with FaultPlan([FaultSpec("kernel", key=("csr", "cuda"), times=1)]):
        tickets = [eng.submit(_S, x) for x in _RHS[:2]]
        eng.flush()
    assert tickets[0].error.kind == "execution" and tickets[1].ok
    assert not tickets[1].record.degraded


def _really_failing(device, monkeypatch, armed):
    """The dia kernel raises as a failed launch would, over flushes of 4, 2
    and 1 requests (with ``armed``, under a plan that targets another key
    and so plants nothing here); returns the engine, tickets and the
    kernel's calls."""
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ops, "dia_spmv_from_container", broken)
    clk = FakeClock()
    eng = ServeEngine(fmt="dia", policy=ExecutionPolicy.for_impl("cuda"), tune_mode=None,
                      max_batch=4, clock=clk, device=device,
                      health=HealthRegistry(cooldown_s=1e9, clock=clk))
    plan = FaultPlan([FaultSpec("kernel", key=("csr", "cuda"), times=3)] if armed else [])
    tickets = []
    with plan:
        for xs in (_RHS[:4], _RHS[4:6], _RHS[:1]):
            tickets += [eng.submit(_S, x) for x in xs]
            eng.flush()
    assert plan.fired() == 0
    return eng, tickets, calls


def _check_not_served_around(eng, tickets, calls):
    assert [t.error.kind if t.error else None for t in tickets] == ["execution"] * 7
    assert all(isinstance(t.error.cause, T.KernelExecutionError) for t in tickets)
    assert [t.record.retries for t in tickets] == [0] * 7
    # one cuda launch a tile: the coalesced tile fails whole, unsplit, and
    # the quarantined key still runs (and fails) in the third flush
    assert len(calls) == 3
    assert eng.health.quarantined(DispatchKey("dia", "cuda"))
    out = eng.summary()
    assert out["retries"] == 0 and out["degraded_requests"] == 0
    assert out["batch_splits"] == 0 and out["errors"] == 7


@pytest.mark.cuda
@pytest.mark.parametrize("armed", [False, True])
def test_really_failing_kernel_is_not_served_from_plain_on_card(cuda, monkeypatch, armed):
    _check_not_served_around(*_really_failing(cuda, monkeypatch, armed))


@pytest.mark.parametrize("armed", [False, True])
def test_really_failing_kernel_is_not_served_from_plain_on_card_stub(as_on_card, monkeypatch,
                                                                     armed):
    _check_not_served_around(*_really_failing("cpu", monkeypatch, armed))
