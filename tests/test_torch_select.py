"""The port's zero-run selector (``repro_torch.core.select``) against the
reference's on the CPU.

With ``platform="cpu"`` the port prices with the reference's table
(``pallas`` renamed ``cuda``), so ``rank``, ``predict``,
``prune_candidates``, ``infeasible`` and ``estimate_us`` must give the
reference's answers: keys equal and in the same order, estimates equal to
1e-9 relative, on the small suite under the default policy and under a
48-column ``max_resident_cols``, and pruned races over the recorded
autotune tables (``tests/fixtures/autotune_tables.json``) must keep and win
the same keys. The ``"cuda"`` table is the port's own: it must give back
the H100 times it was drawn through. Predict mode must run no kernel.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.select as JS
from repro.core import matrices as M
from repro.core.autotune import DEFAULT_CANDIDATES as J_CANDIDATES

import repro_torch.core as T
import repro_torch.core.select as TS
from repro_torch.core import DispatchKey
from repro_torch.core.autotune import DEFAULT_CANDIDATES as T_CANDIDATES
from repro_torch.kernels import ops as tops

tspmv = importlib.import_module("repro_torch.core.spmv")
tconv = importlib.import_module("repro_torch.core.convert")

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "autotune_tables.json")

POLICIES = {
    "default": (J.DEFAULT_POLICY, T.DEFAULT_POLICY),
    "tiny": (J.ExecutionPolicy(max_resident_cols=48), T.ExecutionPolicy(max_resident_cols=48)),
}
#: the recorded fixture's name for each policy
FIXTURE_POLICY = {"default": "default", "tiny": "tiny-vmem"}


def _port_key(key):
    """A reference key in the port's spelling."""
    fmt, backend = key
    return (fmt, "cuda" if backend == "pallas" else backend)


def _same_ranking(jr, tr, what):
    assert [_port_key(p.key) for p in jr] == [tuple(p.key) for p in tr], what
    for a, b in zip(jr, tr):
        assert b.est_us == pytest.approx(a.est_us, rel=1e-9), (what, a, b)
        assert a.reason == b.reason, (what, a, b)


def test_default_candidates_are_the_references():
    assert [tuple(k) for k in T_CANDIDATES] == [_port_key(k) for k in J_CANDIDATES]


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_rank_and_predict_equal_reference(suite_small, pol):
    jp, tp = POLICIES[pol]
    for name, s in suite_small.items():
        jf, tf = J.extract_features(s), T.extract_features(s)
        _same_ranking(JS.rank(jf, policy=jp, platform="cpu"),
                      TS.rank(tf, policy=tp, platform="cpu"), (name, pol))
        assert tuple(TS.predict(tf, policy=tp, platform="cpu").key) == _port_key(
            JS.predict(jf, policy=jp, platform="cpu").key), (name, pol)
        for keep in (1, 2, 4):
            assert [tuple(k) for k in TS.prune_candidates(tf, keep, policy=tp, platform="cpu")] \
                == [_port_key(k) for k in JS.prune_candidates(jf, keep, policy=jp,
                                                                platform="cpu")], (name, keep)


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_infeasible_and_estimates_equal_reference(suite_small, pol):
    jp, tp = POLICIES[pol]
    for name, s in suite_small.items():
        jf, tf = J.extract_features(s), T.extract_features(s)
        for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr", "dense"):
            assert TS.infeasible(tf, fmt) == JS.infeasible(jf, fmt), (name, fmt)
            for dim in (4, 64):
                assert TS.infeasible(tf, fmt, dia_max_diags=dim) == JS.infeasible(
                    jf, fmt, dia_max_diags=dim), (name, fmt, dim)
        for jk, tk in zip(J_CANDIDATES, T_CANDIDATES):
            want = JS.estimate_us(jf, jk, jp, platform="cpu")
            assert TS.estimate_us(tf, tk, tp, platform="cpu") == pytest.approx(
                want, rel=1e-9), (name, pol, tk)
            assert TS.bytes_per_nnz(tf, tk.format, tp) == JS.bytes_per_nnz(
                jf, jk.format, jp), (name, tk)


@pytest.fixture(scope="module")
def recorded_tables():
    with open(FIXTURE) as f:
        doc = json.load(f)
    return {label: {tuple(k.split("/")): v for k, v in table.items()}
            for label, table in doc.items()}


def _replay(table, port: bool):
    def time_fn(fn, A, x, key, iters, warmup):
        fmt, backend = key
        if port and backend == "cuda":
            backend = "pallas"
        return table.get((fmt, backend), 1e12)
    return time_fn


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_pruned_race_over_recorded_tables_equals_reference(recorded_tables, suite_small, pol):
    """``autotune_spmv(prune=4)`` on the host ranks with the ``"cpu"``
    table: it keeps, skips and wins the keys the reference's does when both
    replay the recorded tables."""
    jp, tp = POLICIES[pol]
    for name, s in suite_small.items():
        table = recorded_tables[f"{name}/{FIXTURE_POLICY[pol]}"]
        j = J.autotune_spmv(s, policy=jp, prune=4, time_fn=_replay(table, False),
                            iters=1, warmup=0)
        t = T.autotune_spmv(s, policy=tp, prune=4, time_fn=_replay(table, True), iters=1,
                            warmup=0, device="cpu")
        assert (t.format, t.impl) == _port_key((j.format, j.impl)), name
        assert sorted(t.table) == sorted(_port_key(k) for k in j.table), name
        assert sorted((*_port_key(sk[:2]), sk[2]) for sk in j.skipped) == sorted(t.skipped), name


def test_pruned_skip_reasons_stay_structural():
    s = M.random_uniform(512, 0.1, seed=1)  # > 512 occupied diagonals
    res = T.autotune_spmv(s, prune=2, time_fn=lambda *a, **k: 1.0, iters=1, warmup=0,
                          device="cpu")
    reasons = {(f, i): why for f, i, why in res.skipped}
    assert reasons[("dia", "plain")].startswith("ndiags=")
    assert "pruned by selector" in set(reasons.values())


def test_selection_drifted_equals_reference():
    a, b = M.banded(256, 3, seed=0), M.random_uniform(256, 0.05, seed=1)
    for before, after in ((a, a), (a, b)):
        want = JS.selection_drifted(J.extract_features(before), J.extract_features(after),
                                    platform="cpu")
        assert TS.selection_drifted(T.extract_features(before), T.extract_features(after),
                                    platform="cpu") == want


def test_predict_selects_bsr_on_block_matrix():
    """The reference's block matrix: BSR ranks first on the ``"cpu"``
    table, as in the reference, and predict mode retargets a host operator
    to a working bsr operator."""
    s = M.block_random(512, bs=32, block_density=0.05, seed=8)
    pred = TS.predict(T.extract_features(s), platform="cpu")
    assert tuple(pred.key) == _port_key(JS.predict(J.extract_features(s), platform="cpu").key)
    assert pred.key.format == "bsr"
    tuned = T.as_operator(s, "csr", device="cpu").tune(mode="predict")
    assert (tuned.format, tuned.policy.backends[0]) == ("bsr", pred.key.backend)
    x = np.ones(512, np.float32)
    np.testing.assert_allclose(tuned @ x, s @ x, rtol=1e-4, atol=1e-4)


@pytest.fixture
def dispatch_calls(monkeypatch):
    calls = []
    orig = tspmv.KernelEntry.call

    def counted(self, A, *operands, policy):
        calls.append(self.key)
        return orig(self, A, *operands, policy=policy)

    monkeypatch.setattr(tspmv.KernelEntry, "call", counted)
    return calls


def test_predict_mode_dispatches_no_kernel(dispatch_calls):
    s = M.banded(96, 4, seed=0)
    op = T.as_operator(s, "csr", device="cpu")
    tuned = op.tune(mode="predict")
    assert dispatch_calls == []
    y = tuned @ torch.ones(96)
    assert len(dispatch_calls) == 1
    np.testing.assert_allclose(y.numpy(), s @ np.ones(96), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        op.tune(mode="guess")


def test_predict_mode_rebuilds_a_stale_plan():
    """A csr operator built before its tiny policy gets the plan that policy
    needs, so dispatch takes the predicted cuda key."""
    s = M.banded(200, 4, seed=0)
    tiny = T.ExecutionPolicy(max_resident_cols=48)
    op = T.as_operator(s, "csr", device="cpu").with_policy(tiny)
    tuned = op.tune(mode="predict", candidates=(DispatchKey("csr", "cuda"),))
    assert tuned.format == "csr" and tuned.container.plan.ct <= tiny.resident_cols()
    assert tspmv.select_spmv(tuned.container, tuned.policy).key == DispatchKey("csr", "cuda")


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia", "ell", "sell", "bsr"])
def test_cuda_table_prices_every_key_rank_proposes(fmt):
    """Each key ``rank`` may propose on the card has a ``"cuda"`` row, a line
    ``a + c * kentries`` with a, c > 0, so no estimate is infinite."""
    for (f_, backend, _), (a, b, c, d) in TS.COST["cuda"].items():
        if f_ == fmt:
            assert a > 0 and c > 0 and b == d == 0, (backend, a, b, c, d)
    for s in (M.fdm27(4, 4, 4), M.banded(200, 9, seed=0),
              M.block_random(96, bs=32, block_density=0.3, seed=8)):
        for pol in (T.DEFAULT_POLICY, T.ExecutionPolicy(max_resident_cols=48)):
            for p in TS.rank(s, policy=pol, platform="cuda"):
                if p.key.format == fmt:
                    assert 0 < p.est_us < float("inf"), (p, pol)


def test_cuda_table_picks_dia_on_hpcg():
    """On HPCG's 27-point grid the card's table ranks dia/cuda first, as
    the race on the card picks it."""
    assert TS.predict(M.fdm27(13, 13, 13), platform="cuda").key == DispatchKey("dia", "cuda")


def test_platform_follows_the_operand():
    """A host operand ranks on the ``"cpu"`` table; inputs on no device
    (features, scipy) on the ``"cuda"`` one, as the card does."""
    s = M.banded(256, 3, seed=0)
    f = T.extract_features(s)
    keys = lambda preds: [(p.key, p.est_us) for p in preds]  # noqa: E731
    host = T.as_operator(s, "csr", device="cpu")
    assert TS.platform_of(host) == "cpu" and TS.platform_of(s) == "cuda"
    assert keys(TS.rank(host)) == keys(TS.rank(f, platform="cpu"))
    assert keys(TS.rank(s)) == keys(TS.rank(f, platform="cuda"))
    assert keys(TS.rank(f)) == keys(TS.rank(f, platform="cuda"))
    assert TS.predict(f).key == DispatchKey("dia", "cuda")


@pytest.mark.parametrize("policy", [
    T.ExecutionPolicy(), T.ExecutionPolicy(max_resident_cols=48),
    T.ExecutionPolicy(max_onehot_rows=16), T.ExecutionPolicy(value_dtype="float64")])
def test_rank_proposes_a_cuda_key_iff_its_predicate_accepts(policy):
    """A ranked ``cuda`` key is one whose predicate accepts the container
    the tuner builds under the policy: on the card dispatch never runs
    plain under its label."""
    for s in (M.fdm27(4, 4, 4), M.banded(200, 9, seed=0),
              M.block_random(96, bs=32, block_density=0.3, seed=8)):
        ranked = {p.key for p in TS.rank(s, policy=policy)}
        n = s.shape[1]
        for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr"):
            key = DispatchKey(fmt, "cuda")
            if TS.infeasible(T.extract_features(s), fmt) is not None:
                assert key not in ranked
                continue
            kw = dict(policy.storage_kw(fmt))
            if fmt in ("coo", "csr", "dia", "ell", "sell"):
                kw["col_tile"] = tconv.col_tile_for_policy(fmt, n, policy.col_tile(n))
            A = tconv.from_dense(s, fmt, device="cpu", **kw)
            assert (key in ranked) == T.dispatch_table("spmv")[key].ok(A, policy), (fmt, policy)


def test_cuda_strategy_for_equals_cuda_strategy(suite_small):
    """The feature-level strategy is the one ``kernels.ops`` picks on the
    built container."""
    for pol in (T.DEFAULT_POLICY, T.ExecutionPolicy(max_resident_cols=48)):
        for name, s in list(suite_small.items())[:6]:
            f = T.extract_features(s)
            n = s.shape[1]
            for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr"):
                kw = {}
                if fmt != "bsr":
                    kw["col_tile"] = tconv.col_tile_for_policy(fmt, n, pol.col_tile(n))
                A = tconv.from_dense(s, fmt, device="cpu", **kw)
                assert TS.cuda_strategy_for(f, pol, fmt) == tops.cuda_strategy(A, pol), (
                    name, fmt)
