"""The port's resilience lane (``repro_torch.resilience`` and the engine's
degraded serving) against the reference's on the CPU.

Mirrors the tests of ``tests/test_chaos.py`` and ``tests/test_resilience.py``
that do not need ``train/`` (the training supervisors wait for it), the
halo site on ``repro_torch.distributed_op`` included. Everything runs on
fake clocks. Beyond the mirrored checks, the port is held to the reference:

  - a fault plan fires the same event sequence for a seed;
  - the acceptance run, and the other fault scenarios, resolve the same
    tickets to the same ``ServeError`` kinds, with the same stats counters;
  - the monitors and ``RestartPolicy`` behave the same on the same inputs.

The reference's ``pallas`` keys are the port's ``cuda`` keys; engines run on
``device="cpu"``, where a ``cuda`` entry runs its kernel's plain version and
dispatch keeps the reference's fall-down-the-chain semantics.
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as J
import repro.resilience as JR
import repro.serve as JS
from repro.resilience import monitor as JMon

from repro_torch.core import (
    AdmissionError,
    BackendUnsupportedError,
    ExecutionPolicy,
    InjectedFault,
    KernelExecutionError,
    SparseInputError,
    as_operator,
    from_dense,
    spmv,
)
from repro_torch.core import matrices as M
from repro_torch.core.health import HealthRegistry, fault_plan, use_health
from repro_torch.core.spmv import DispatchKey, dispatch_table, select_spmv
from repro_torch.resilience import FaultPlan, FaultSpec, SITES
from repro_torch.resilience import monitor as Mon
from repro_torch.resilience.monitor import (
    HeartbeatMonitor,
    RestartPolicy,
    StragglerMonitor,
    Supervisor,
    serve_under_supervision,
)
from repro_torch.serve import ServeEngine, ServeError

tspmv = importlib.import_module("repro_torch.core.spmv")

_N = 32
_A = (M.banded(_N, 3, seed=0) + M.random_uniform(_N, 0.05, seed=1)).tocsr()
_RHS = [np.random.default_rng(50 + i).standard_normal(_N).astype(np.float32)
        for i in range(8)]


class FakeClock:
    """Deterministic monotonic clock: every read advances 1ms; tests jump
    it explicitly to cross breaker cooldowns."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


COOLDOWN = 10.0  # far beyond what auto-advance reaches inside one test


def _knobs(kw, clk, registry, impl):
    kw.setdefault("policy", ExecutionPolicy.for_impl(impl) if registry is HealthRegistry
                  else J.ExecutionPolicy.for_impl(impl))
    kw.setdefault("fmt", "csr")
    kw.setdefault("tune_mode", None)
    kw.setdefault("capacity", 4)
    kw.setdefault("max_batch", 4)
    kw.setdefault("check_finite", True)
    kw.setdefault("health", registry(cooldown_s=COOLDOWN, clock=clk))
    return kw


def _engine(clk=None, **kw):
    clk = clk or FakeClock()
    return ServeEngine(clock=clk, device="cpu", **_knobs(kw, clk, HealthRegistry, "cuda")), clk


def _ref_engine(clk=None, **kw):
    from repro.core.health import HealthRegistry as JHealth

    clk = clk or FakeClock()
    return JS.ServeEngine(clock=clk, **_knobs(kw, clk, JHealth, "pallas")), clk


def _ref_spec(spec):
    key = spec.key
    if isinstance(key, tuple):
        key = tuple("pallas" if k == "cuda" else k for k in key)
    elif key == "cuda":
        key = "pallas"
    return JR.FaultSpec(site=spec.site, key=key, times=spec.times, start=spec.start, p=spec.p)


def _kinds(tickets):
    return [None if t.ok else t.error.kind for t in tickets]


STAT_KEYS = ("requests", "batches", "errors", "error_kinds", "availability",
             "deadline_misses", "degraded_requests", "retries", "batch_splits",
             "plan_failures", "admission_retries", "admission_failures")


def _same_stats(eng, jeng):
    out, jout = eng.summary(), jeng.summary()
    assert {k: out[k] for k in STAT_KEYS} == {k: jout[k] for k in STAT_KEYS}
    h, jh = out["health"], jout["health"]
    assert {k: h[k] for k in ("quarantines", "probes", "recoveries")} == {
        k: jh[k] for k in ("quarantines", "probes", "recoveries")}
    assert h["quarantined_now"] == [k.replace("pallas", "cuda") for k in jh["quarantined_now"]]


def _scenario(specs, seed=0, engine_kw=None, submit=None):
    """Run the same fault scenario on both engines; returns the port's and
    the reference's (engine, tickets, plan)."""
    out = []
    for make, plan_cls, spec_of in ((_engine, FaultPlan, lambda s: s),
                                    (_ref_engine, JR.FaultPlan, _ref_spec)):
        eng, clk = make(**dict(engine_kw or {}))
        plan = plan_cls([spec_of(s) for s in specs], seed=seed)
        with plan:
            tickets = submit(eng, clk) if submit else [eng.submit(_A, r) for r in _RHS[:4]]
            eng.flush()
        out.append((eng, tickets, plan))
    return out


# ------------------------------------------------------------- acceptance ----


def test_chaos_acceptance_fake_clock():
    """Recoverable faults at every site, 100% success, degraded bit-identity,
    probe recovery within the cooldown — and the reference's story event for
    event."""
    runs = []
    for make, plan_cls, spec_of in ((_engine, FaultPlan, lambda s: s),
                                    (_ref_engine, JR.FaultPlan, _ref_spec)):
        engine, clk = make(admission_retries=2)
        specs = [FaultSpec(site="kernel", key="cuda", times=2),
                 FaultSpec(site="admission", times=1),
                 FaultSpec(site="plan", times=1)]
        plan = plan_cls([spec_of(s) for s in specs], seed=0)
        with plan:
            tickets = [engine.submit(_A, r) for r in _RHS[:4]]
            engine.flush()
            t_deg = engine.submit(_A, _RHS[4])
            engine.flush()
        clk.advance(COOLDOWN)
        t_rec = engine.submit(_A, _RHS[5])
        engine.flush()
        runs.append((engine, tickets + [t_deg, t_rec], plan))
    (engine, tickets, plan), (jengine, jtickets, jplan) = runs

    assert all(t.ok for t in tickets)
    assert engine.stats.availability == 1.0 and engine.stats.errors == 0
    assert (plan.fired("kernel"), plan.fired("admission"), plan.fired("plan")) == (2, 1, 1)
    assert engine.stats.plan_failures == 1 and engine.stats.admission_retries == 1
    t_deg, t_rec = tickets[4], tickets[5]
    assert t_deg.record.degraded and engine.stats.degraded_requests >= 1
    plain_ref = as_operator(_A, "csr", device="cpu").using("plain")
    # degraded bit-identity: the rerouted lane's result is the plain lane's
    for t, r in zip(tickets[:5], _RHS[:5]):
        assert torch.equal(t.result(), plain_ref @ r)
    snap = engine.health.snapshot()
    assert snap["recoveries"] == 1 and snap["probes"] >= 1
    assert snap["quarantined_now"] == [] and not engine.health.any_quarantined()
    assert engine.summary()["health"]["recoveries"] == 1

    # the reference's run, event for event
    assert [e[0] for e in plan.events] == [e[0] for e in jplan.events]
    assert _kinds(tickets) == _kinds(jtickets)
    assert [t.record.degraded for t in tickets] == [t.record.degraded for t in jtickets]
    _same_stats(engine, jengine)
    assert [e[0] for e in engine.health.events] == [e[0] for e in jengine.health.events]
    for t, jt in zip(tickets, jtickets):
        np.testing.assert_allclose(t.result().numpy(), np.asarray(jt.result()),
                                   rtol=2e-4, atol=2e-4)


def test_fault_hooks_are_noops_when_inactive(monkeypatch):
    """No plan armed: two identical runs produce identical dispatch counts
    and bit-identical results — the injection sites cost one None-check."""
    calls = {"n": 0}
    orig = tspmv.KernelEntry.call

    def counted(self, A, *operands, policy):
        calls["n"] += 1
        return orig(self, A, *operands, policy=policy)

    monkeypatch.setattr(tspmv.KernelEntry, "call", counted)
    assert fault_plan() is None
    results, counts = [], []
    for _ in range(2):
        engine, _ = _engine(check_finite=False)
        before = calls["n"]
        tickets = [engine.submit(_A, r) for r in _RHS[:4]]
        engine.flush()
        counts.append(calls["n"] - before)
        results.append([t.result() for t in tickets])
    assert counts[0] == counts[1] > 0
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_plan_cannot_nest_and_clears_on_exit():
    with FaultPlan([FaultSpec(site="kernel")]):
        with pytest.raises(RuntimeError, match="already"):
            with FaultPlan([FaultSpec(site="plan")]):
                pass
    assert fault_plan() is None


def test_corrupt_and_drop_hooks():
    y = torch.ones(4)
    with FaultPlan([FaultSpec(site="nonfinite", times=1), FaultSpec(site="halo", times=1)]) as p:
        assert torch.isnan(p.corrupt("nonfinite", DispatchKey("csr", "cuda"), y)).all()
        assert torch.equal(p.corrupt("nonfinite", DispatchKey("csr", "cuda"), y), y)
        assert torch.equal(p.drop("halo", None, y), torch.zeros(4))
    assert p.fired() == 2 and p.fired("halo") == 1
    assert SITES == JR.SITES


# ---------------------------------------------------------- chain coverage ----


@pytest.fixture
def chain_failure_injector(monkeypatch):
    """Force selected keys' kernels to raise while recording every attempt."""
    state = {"fail": set(), "attempts": []}
    orig = tspmv.KernelEntry.call

    def failing(self, A, *operands, policy):
        state["attempts"].append(self.key)
        if self.key in state["fail"]:
            raise RuntimeError(f"forced failure for {self.key}")
        return orig(self, A, *operands, policy=policy)

    monkeypatch.setattr(tspmv.KernelEntry, "call", failing)
    return state


@pytest.fixture
def fresh_health():
    reg = HealthRegistry()
    with use_health(reg):
        yield reg


def _matrix_for(fmt: str):
    d = np.asarray(M.banded(8, 2, seed=3).todense(), np.float32)
    return from_dense(d, fmt, device="cpu")


def test_every_key_hands_off_exactly_once(chain_failure_injector, fresh_health):
    """For every registered SpMV key: force its kernel to raise and assert
    dispatch reaches the next chain entry exactly once, with the right
    product."""
    x = torch.ones(8)
    covered = 0
    for key, entry in sorted(dispatch_table("spmv").items(),
                             key=lambda kv: (kv[0].format, kv[0].backend)):
        A = _matrix_for(key.format)
        chain = (key.backend,) + tuple(b for b in ("plain", "dense") if b != key.backend)
        pol = ExecutionPolicy(backends=chain)
        if not entry.ok(A, pol):
            assert select_spmv(A, pol).key != key
            continue
        fresh_health.reset()
        chain_failure_injector["fail"] = {key}
        chain_failure_injector["attempts"] = []
        y = spmv(A, x, policy=pol)
        attempts = chain_failure_injector["attempts"]
        assert attempts.count(key) == 1 and len(attempts) == 2, (key, attempts)
        assert attempts[0] == key and attempts[1] != key
        np.testing.assert_allclose(y.numpy(), (A.to_dense() @ x).numpy(),
                                   rtol=1e-5, atol=1e-5)
        covered += 1
    assert covered >= 6


def test_backend_unsupported_only_when_chain_exhausted(chain_failure_injector,
                                                       fresh_health):
    A = _matrix_for("csr")
    x = torch.ones(8)
    with pytest.raises(BackendUnsupportedError):
        spmv(A, x, policy=ExecutionPolicy(backends=("no-such-backend",),
                                          allow_fallback=False))
    with pytest.raises(KeyError):
        spmv(A, x, policy=ExecutionPolicy(backends=("no-such-backend",)))
    chain = ExecutionPolicy(backends=("plain", "dense"))
    chain_failure_injector["fail"] = {DispatchKey("csr", "plain"),
                                      DispatchKey("csr", "dense")}
    with pytest.raises(KernelExecutionError):
        spmv(A, x, policy=chain)
    assert [k.backend for k in chain_failure_injector["attempts"]] == ["plain", "dense"]
    chain_failure_injector["fail"] = set()
    chain_failure_injector["attempts"] = []
    spmv(A, x, policy=chain)
    assert len(chain_failure_injector["attempts"]) == 1


def test_strict_mode_failure_raises_and_skips_health(chain_failure_injector,
                                                     fresh_health):
    A = _matrix_for("csr")
    chain_failure_injector["fail"] = {DispatchKey("csr", "plain")}
    with pytest.raises(KernelExecutionError):
        spmv(A, torch.ones(8), policy=ExecutionPolicy(backends=("plain", "dense"),
                                                      allow_fallback=False))
    assert len(chain_failure_injector["attempts"]) == 1


# ------------------------------------------------------------- the breaker ----


def test_health_registry_quarantine_probe_recover_cycle():
    t = {"now": 0.0}
    reg = HealthRegistry(failure_threshold=2, cooldown_s=5.0, clock=lambda: t["now"])
    key = DispatchKey("csr", "cuda")
    reg.record_failure(key)
    assert not reg.quarantined(key)
    reg.record_failure(key)
    assert reg.quarantined(key) and reg.blocked(key)
    t["now"] = 4.9
    assert reg.blocked(key)
    t["now"] = 5.1
    assert not reg.blocked(key) and reg.quarantined(key)
    reg.record_failure(key)
    assert reg.blocked(key)
    t["now"] = 10.3
    assert not reg.blocked(key)
    reg.record_success(key)
    assert not reg.quarantined(key)
    assert [e[0] for e in reg.events] == \
        ["quarantine", "probe", "requarantine", "probe", "recover"]
    snap = reg.snapshot()
    assert snap["quarantines"] == 2 and snap["recoveries"] == 1
    assert snap["max_recovery_s"] == pytest.approx(10.3)


def test_health_registry_nonfinite_threshold_and_order():
    reg = HealthRegistry(nonfinite_threshold=1, cooldown_s=5.0, clock=lambda: 0.0)
    k1, k2 = DispatchKey("csr", "cuda"), DispatchKey("csr", "plain")
    reg.record_nonfinite(k1)
    assert reg.quarantined(k1)

    class E:
        def __init__(self, key):
            self.key = key

    assert [e.key for e in reg.order([E(k1), E(k2)])] == [k2, k1]
    assert [e.key for e in HealthRegistry().order([E(k1), E(k2)])] == [k1, k2]


# ------------------------------------------------------- degraded serving ----


def test_deadline_expiry_resolves_structured_error():
    def submit(eng, clk):
        t = eng.submit(_A, _RHS[0], deadline_s=0.5)
        clk.advance(1.0)
        return [t]

    (eng, (t,), _), (jeng, jts, _) = _scenario([], submit=submit)
    assert t.done and not t.ok
    with pytest.raises(ServeError) as ei:
        t.result()
    assert ei.value.kind == "deadline"
    assert eng.stats.deadline_misses == 1 and eng.stats.availability == 0.0
    assert _kinds([t]) == _kinds(jts)
    _same_stats(eng, jeng)


def test_poison_request_cannot_fail_its_batch():
    def submit(eng, clk):
        bad = _RHS[1].copy()
        bad[3] = np.nan
        return [eng.submit(_A, _RHS[0]), eng.submit(_A, bad)]

    kw = {"policy": None}
    (eng, (t_good, t_bad), _), (jeng, jts, _) = _scenario(
        [], submit=submit, engine_kw=kw)
    assert eng.stats.batch_splits == 1
    assert t_good.ok and not t_bad.ok and t_bad.error.kind == "input"
    assert isinstance(t_bad.error.cause, SparseInputError)
    ref = as_operator(_A, "csr", device="cpu").using("plain") @ _RHS[0]
    assert torch.equal(t_good.result(), ref)
    assert eng.stats.error_kinds == {"input": 1}
    assert _kinds([t_good, t_bad]) == _kinds(jts)
    _same_stats(eng, jeng)


def test_admission_retry_backoff_then_success():
    (eng, (t,), _), (jeng, jts, _) = _scenario(
        [FaultSpec(site="admission", times=2)], submit=lambda e, c: [e.submit(_A, _RHS[0])],
        engine_kw={"admission_retries": 2, "admission_backoff_s": 1.0})
    assert t.ok
    assert eng.stats.admission_failures == 2 and eng.stats.admission_retries == 2
    assert eng.stats.availability == 1.0
    _same_stats(eng, jeng)


def test_admission_exhaustion_fails_fingerprint_group():
    (eng, tickets, _), (jeng, jts, _) = _scenario(
        [FaultSpec(site="admission", times=1)],
        submit=lambda e, c: [e.submit(_A, _RHS[0]), e.submit(_A, _RHS[1])],
        engine_kw={"admission_retries": 0})
    for t in tickets:
        assert t.done and not t.ok and t.error.kind == "admission"
        assert isinstance(t.error.cause, AdmissionError)
    assert eng.stats.error_kinds == {"admission": 2}
    assert _kinds(tickets) == _kinds(jts)
    _same_stats(eng, jeng)
    t3 = eng.submit(_A, _RHS[2])
    eng.flush()
    assert t3.ok


def test_unknown_fingerprint_still_raises_keyerror():
    engine, _ = _engine()
    t = engine.submit("deadbeef" * 8, _RHS[0])
    with pytest.raises(KeyError, match="unknown"):
        engine.flush()
    assert not t.done


def test_execution_retry_with_degradation():
    """A kernel that keeps raising exhausts the chain; the per-request retry
    re-runs on an extended (plain/dense-terminated) chain and still serves,
    with the reference's retry count."""
    (eng, (t,), _), (jeng, jts, _) = _scenario(
        [FaultSpec(site="kernel", times=4)], submit=lambda e, c: [e.submit(_A, _RHS[0])],
        engine_kw={"max_retries": 1})
    assert t.ok and t.record.retries >= 1 and eng.stats.retries >= 1
    assert t.record.retries == jts[0].record.retries
    _same_stats(eng, jeng)


@pytest.mark.parametrize("kind", ["nonfinite", "kernel"])
def test_fault_mix_equals_reference(kind):
    """Faults on the cuda lane over several requests: the same tickets fail
    or degrade as in the reference. Tiles of one request: the reference's
    coalesced tile is one vmapped dispatch where the port's is one per
    column, so only per-request serving meets the plan's events one for
    one."""
    def submit(eng, clk):
        return [eng.submit(_A, r) for r in _RHS]

    (eng, tickets, plan), (jeng, jts, jplan) = _scenario(
        [FaultSpec(site=kind, key=("csr", "cuda"), times=3, start=1)], submit=submit,
        engine_kw={"max_batch": 1})
    assert plan.events == [(s, k.replace("pallas", "cuda"), i) for s, k, i in jplan.events]
    assert _kinds(tickets) == _kinds(jts)
    assert [t.record.degraded for t in tickets] == [t.record.degraded for t in jts]
    _same_stats(eng, jeng)


# ----------------------------------------------------- determinism of faults ----


def test_fault_plan_is_seed_deterministic():
    def run(seed, ref=False, max_batch=4):
        spec = FaultSpec(site="kernel", key="cuda", p=0.5, times=3)
        plan = (JR.FaultPlan([_ref_spec(spec)], seed=seed) if ref
                else FaultPlan([spec], seed=seed))
        engine, _ = (_ref_engine if ref else _engine)(max_batch=max_batch)
        with plan:
            for r in _RHS[:6]:
                engine.submit(_A, r)
            engine.flush()
        return [(s, k.replace("pallas", "cuda"), i) for s, k, i in plan.events]

    assert run(7) == run(7)
    for seed in (0, 7, 11):  # per-request tiles: one dispatch a request in both
        assert run(seed, max_batch=1) == run(seed, ref=True, max_batch=1), seed


def test_fault_plan_sequence_equals_reference():
    """The same stream of site events through both packages' plans fires the
    same events for a seed (probabilistic, windowed and keyed specs)."""
    keys = [DispatchKey(f, b) for f in ("csr", "dia", "ell") for b in ("cuda", "plain")] * 6
    jkeys = [J.DispatchKey(k.format, "pallas" if k.backend == "cuda" else k.backend)
             for k in keys]
    specs = [FaultSpec(site="kernel", key="cuda", p=0.4, times=5, start=2),
             FaultSpec(site="nonfinite", key=("dia", "cuda"), p=0.7, times=3),
             FaultSpec(site="admission", key="ab", times=2, start=1)]
    for seed in (0, 3, 99):
        plan = FaultPlan(specs, seed=seed)
        jplan = JR.FaultPlan([_ref_spec(s) for s in specs], seed=seed)
        for p, ks in ((plan, keys), (jplan, jkeys)):
            for k in ks:
                try:
                    p.fire("kernel", k)
                except (InjectedFault, J.InjectedFault):
                    pass
                p._trigger("nonfinite", k)
                p._trigger("admission", "abc")
        assert plan.events == [(s, k.replace("pallas", "cuda"), i)
                               for s, k, i in jplan.events], seed
        assert plan.fired("kernel") > 0 and plan.fired("admission") == 2


def test_fault_spec_matching_and_validation():
    with pytest.raises(ValueError, match="site"):
        FaultSpec(site="not-a-site")
    spec = FaultSpec(site="kernel", key=("csr", "cuda"))
    assert spec.matches(DispatchKey("csr", "cuda"))
    assert not spec.matches(DispatchKey("ell", "cuda"))
    by_backend = FaultSpec(site="kernel", key="cuda")
    assert by_backend.matches(DispatchKey("ell", "cuda"))
    assert not by_backend.matches(DispatchKey("ell", "plain"))
    assert FaultSpec(site="plan").matches(None)
    assert FaultSpec(site="admission", key="ab").matches("abcdef")


def test_injected_fault_outside_resilience_taxonomy():
    from repro_torch.core import ResilienceError

    assert not issubclass(InjectedFault, ResilienceError)


# ------------------------------------------------------------- halo + solver ----


def test_halo_drop_detectably_corrupts_distributed_matvec():
    from repro_torch.core import PartMesh
    from repro_torch.distributed_op import DistributedOperator

    mesh = PartMesh.on("cpu", parts=1)
    s = M.banded(8, 1, seed=0)
    op = DistributedOperator.build(s, mesh, "data", local="csr", mode="rowblock")
    x = op.device_put(np.arange(1, 9, dtype=np.float32))
    y_ok = op @ x
    with FaultPlan([FaultSpec(site="halo", times=1)]) as plan:
        y_bad = op @ x
    assert plan.fired("halo") == 1
    assert not torch.allclose(y_bad, y_ok)  # a dropped exchange is loud
    torch.testing.assert_close(op @ x, y_ok)  # and transient


def test_cg_exits_on_nonfinite_residual():
    from repro_torch.solvers import cg

    info = cg(lambda p: p * float("inf"), torch.ones(8), maxiter=100)
    assert int(info.iters) < 100
    assert not bool(torch.isfinite(torch.as_tensor(info.rel_res)))


def test_cg_guarded_raises_on_divergence_and_stall():
    from repro_torch.core import SolverDivergenceError
    from repro_torch.solvers.cg import cg_guarded, diagnose_cg

    b = torch.ones(8)
    with pytest.raises(SolverDivergenceError, match="non-finite"):
        cg_guarded(lambda p: p * float("nan"), b)
    rng = np.random.default_rng(0)
    d = rng.standard_normal((8, 8)).astype(np.float32)
    spd = d @ d.T + 8 * np.eye(8, dtype=np.float32)
    A = as_operator(sp.csr_matrix(spd), device="cpu")
    with pytest.raises(SolverDivergenceError, match="stalled"):
        cg_guarded(A, b, tol=1e-12, maxiter=1)
    info, diag = cg_guarded(A, b, tol=1e-5, maxiter=200)
    assert diag.converged and diag.finite and not diag.stalled
    assert diagnose_cg(info, tol=1e-5, maxiter=200).converged


def test_cg_guarded_restart_recovers_on_degraded_matvec():
    """restart=True retries a non-finite run on the plain-first lane."""
    from repro_torch.solvers.cg import _degraded_matvec, cg_guarded

    spd = sp.csr_matrix(4.0 * sp.eye(8, format="csr", dtype=np.float32))
    A = as_operator(spd, device="cpu").using("cuda")
    b = torch.ones(8)
    assert torch.equal(_degraded_matvec(A)(b), A @ b)
    with FaultPlan([FaultSpec(site="kernel", key="cuda", times=50)]):
        info, diag = cg_guarded(A, b, tol=1e-8, restart=True)
    assert diag.converged
    np.testing.assert_allclose(info.x.numpy(), 0.25 * b.numpy(), rtol=1e-6)


# --------------------------------------------------------------- monitors ----


def test_straggler_monitor_equals_reference():
    times = [0.1] * 10 + [0.5, 0.11, 0.3, 0.05, 0.9]
    m, jm = StragglerMonitor(window=20, factor=2.0), JMon.StragglerMonitor(window=20, factor=2.0)
    assert [m.record(t) for t in times] == [jm.record(t) for t in times]
    assert m.flagged == jm.flagged == [11, 13, 15]
    assert m.median == jm.median


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(timeout_s=10)
    hb.beat("w0", now=100.0)
    hb.beat("w1", now=105.0)
    assert hb.dead_workers(now=109.0) == []
    assert hb.dead_workers(now=112.0) == ["w0"]
    assert not hb.healthy(now=120.0)
    clk = FakeClock()
    hb = HeartbeatMonitor(timeout_s=0.0015, clock=clk)
    hb.beat("w0")
    assert hb.dead_workers() == [] and hb.dead_workers() == ["w0"]


def test_restart_policy_aborts_after_max():
    p = RestartPolicy(max_restarts=2, window_s=1000)
    assert [p.on_failure() for _ in range(3)] == ["restart", "restart", "abort"]


def test_supervisor_gives_up_on_persistent_failure():
    def bad_step(state, i):
        raise RuntimeError("always fails")

    sup = Supervisor(bad_step, save_fn=lambda s, i: None, restore_fn=lambda: (0, 0),
                     policy=RestartPolicy(max_restarts=2, window_s=1000))
    with pytest.raises(RuntimeError):
        sup.run(0, 0, 5)
    assert sup.restarts == 2


def test_median_even_window_is_true_median():
    assert Mon._median([1.0, 2.0, 3.0]) == 2.0
    assert Mon._median([1.0, 2.0, 3.0, 4.0]) == 2.5
    assert Mon._median([0.1, 0.9]) == pytest.approx(0.5)
    m = StragglerMonitor(window=4, factor=2.0)
    for t in (0.1, 0.2, 0.3, 0.4):
        m.record(t)
    assert m.median == pytest.approx(0.25)


def test_straggler_threshold_uses_even_median():
    m = StragglerMonitor(window=6, factor=2.0)
    for t in (0.10, 0.10, 0.10, 0.20, 0.20, 0.20):
        m.record(t)
    assert m.record(0.35) is True


def test_restart_policy_backoff_equals_reference():
    """Exponential backoff doubles per recent failure, is recorded, and
    sleeps only through sleep_fn — the reference's schedule exactly."""
    def run(cls):
        t = {"now": 0.0}
        sleeps = []
        p = cls(max_restarts=3, window_s=1000.0, backoff_base_s=2.0,
                clock=lambda: t["now"], sleep_fn=sleeps.append)
        out = []
        for now in (0.0, 10.0, 20.0, 30.0):
            t["now"] = now
            out.append((p.on_failure(), p.last_delay_s, p.next_allowed_at))
        p.reset()
        out.append((p.history, p.on_failure(), p.last_delay_s))
        q = cls(max_restarts=1, backoff_base_s=5.0, clock=lambda: 100.0, sleep_fn=None)
        out.append((q.on_failure(), q.next_allowed_at))
        return out, sleeps

    mine, ref = run(RestartPolicy), run(JMon.RestartPolicy)
    assert mine == ref
    assert mine[1] == [2.0, 4.0, 8.0, 2.0]
    assert mine[0][3][0] == "abort"


def test_serve_under_supervision_with_real_engine():
    """The Supervisor wired to a real ServeEngine: a clean run needs no
    restarts; a flush whose tickets resolve to ServeError restores to the
    last completed batch and replays it, as often as the reference does."""
    A = M.banded(16, 2, seed=0).tocsr()
    rng = np.random.default_rng(3)
    batches = [[(A, rng.standard_normal(16).astype(np.float32)) for _ in range(2)]
               for _ in range(3)]

    def run(ref):
        tick = {"now": 0.0}

        def clock():
            tick["now"] += 1e-3
            return tick["now"]

        def fresh_engine():
            if ref:
                return JS.ServeEngine(policy=J.ExecutionPolicy.for_impl("plain"), fmt="csr",
                                      tune_mode=None, capacity=4, max_batch=4,
                                      admission_retries=0, clock=clock)
            return ServeEngine(policy=ExecutionPolicy.for_impl("plain"), fmt="csr",
                               tune_mode=None, capacity=4, max_batch=4,
                               admission_retries=0, clock=clock, device="cpu")

        supervise = JMon.serve_under_supervision if ref else serve_under_supervision
        policy_cls = JMon.RestartPolicy if ref else RestartPolicy
        clean, sup0 = supervise(fresh_engine(), batches, clock=clock)
        plan = (JR.FaultPlan([JR.FaultSpec(site="admission", times=1)]) if ref
                else FaultPlan([FaultSpec(site="admission", times=1)]))
        with plan:
            results, sup = supervise(
                fresh_engine(), batches,
                policy=policy_cls(max_restarts=2, window_s=1000.0, clock=clock), clock=clock)
        return clean, sup0.restarts, results, sup.restarts

    clean, r0, results, r1 = run(False)
    jclean, jr0, jresults, jr1 = run(True)
    assert (r0, r1) == (jr0, jr1) and r0 == 0 and r1 >= 1
    assert len(results) == 3 and all(len(b) == 2 for b in results)
    for got, want in zip(sum(clean + results, []), sum(jclean + jresults, [])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    for got, (_, r) in zip(results[-1], batches[-1]):
        np.testing.assert_allclose(got.numpy(), A @ r, rtol=1e-5, atol=1e-5)
