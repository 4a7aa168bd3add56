"""The port's dynamic-matrix lane (``repro_torch.core.dynamic``) against the
reference's on the CPU.

Mirrors ``tests/test_dynamic.py`` — overlay exactness, bookkeeping, drift,
refresh, scenarios, the fingerprint regression — and holds the port's
``DeltaOverlay`` to ``repro.core.dynamic.DeltaOverlay`` driven by the same
mutation stream: the host mirror (``to_scipy``), ``nnz``/``ndelta``, the
incremental ``features``, ``drift`` and every ``RefreshResult`` field equal
the reference's exactly (keys with ``pallas`` read as ``cuda``); ``ov @ x``
agrees within rtol 2e-4; ``compact`` is bit-identical to a from-scratch
rebuild inside the port. Overlays live on ``device="cpu"``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as J
from repro.sparsify import prune_step

from repro_torch.core import (
    DEFAULT_DRIFT_THRESHOLD,
    DeltaOverlay,
    SpmvWorkspace,
    as_operator,
    extract_features,
    selection_drifted,
)
from repro_torch.core import matrices as M
from repro_torch.core.dynamic import RefreshResult

import importlib

tspmv = importlib.import_module("repro_torch.core.spmv")


def _op(s, fmt="csr"):
    return as_operator(s, fmt, device="cpu")


def _int_csr(n=48, density=0.08, seed=0):
    """Integer-valued random CSR: every product/sum in SpMV is exactly
    representable in float32, so bit-identity tests pure structure."""
    rng = np.random.default_rng(seed)
    s = sp.random(n, n, density=density, random_state=rng, format="csr")
    s.data[:] = rng.integers(1, 8, s.nnz).astype(np.float64)
    s.sum_duplicates()
    s.sort_indices()
    return s


def _int_x(n, seed=1):
    return np.random.default_rng(seed).integers(-4, 5, n).astype(np.float32)


def _mutate_stream(ov, seed=2, steps=40):
    """A deterministic insert/update/delete mix (integer values)."""
    rng = np.random.default_rng(seed)
    n = ov.shape[0]
    for _ in range(steps):
        i, j = int(rng.integers(n)), int(rng.integers(n))
        op = rng.integers(3)
        if op == 0:
            ov.set(i, j, float(rng.integers(1, 8)))      # insert/update
        elif op == 1:
            ov.delete(i, j)                              # delete (maybe noop)
        else:
            ov.add(i, j, float(rng.integers(-3, 4)))     # increment


def _port_key(key):
    fmt, backend = key
    return (fmt, "cuda" if backend == "pallas" else backend)


def _close(got, want, rtol=2e-4):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _same_scipy(a, b):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _same_state(ov, jov):
    """Mirror, counters, features and drift equal the reference's exactly."""
    _same_scipy(ov.to_scipy(), jov.to_scipy())
    assert (ov.nnz, ov.ndelta, ov.shape) == (jov.nnz, jov.ndelta, jov.shape)
    assert ov.features().asdict() == jov.features().asdict()
    assert ov.drift().asdict() == jov.drift().asdict()
    assert ov.drifted() == jov.drifted()
    assert ov.base_fingerprint == jov.base_fingerprint


def _pair(s, fmt="csr", **kw):
    return (DeltaOverlay(_op(s, fmt), **kw),
            J.DeltaOverlay(J.as_operator(s, fmt), **kw))


# ------------------------------------------------------ against the reference ----


class TestEqualsReference:
    @pytest.mark.parametrize("fmt", ["csr", "coo", "dia", "ell", "sell"])
    def test_state_after_a_mutation_stream(self, fmt):
        ov, jov = _pair(_int_csr(n=40), fmt)
        _same_state(ov, jov)
        for seed in (2, 3):
            _mutate_stream(ov, seed=seed, steps=30)
            _mutate_stream(jov, seed=seed, steps=30)
            _same_state(ov, jov)
        x = _int_x(40)
        _close(ov @ x, np.asarray(jov @ x))
        _close(ov @ x, ov.to_scipy() @ x.astype(np.float64))

    @pytest.mark.parametrize("mode,threshold", [("predict", 0.0), ("predict", 1e9),
                                                (None, 0.0)])
    def test_refresh_result_fields(self, mode, threshold):
        ov, jov = _pair(M.tridiag(64))
        for o in (ov, jov):
            for j in range(8, 63, 4):
                o.set(0, j, 1.0)
        res = ov.refresh(threshold=threshold, mode=mode)
        jres = jov.refresh(threshold=threshold, mode=mode)
        assert res.drift.asdict() == jres.drift.asdict()
        assert (res.compacted, res.retuned, res.reselected) == (
            jres.compacted, jres.retuned, jres.reselected)
        assert (res.key_before, res.key_after) == (
            _port_key(jres.key_before), _port_key(jres.key_after))
        assert (res.fingerprint_before, res.fingerprint_after) == (
            jres.fingerprint_before, jres.fingerprint_after)
        assert res.operator.format == jres.operator.format
        _same_state(ov, jov)

    def test_prune_scenario_equals_reference(self):
        ov, jov = _pair(M.banded(48, 9, seed=0), drift_threshold=0.25)
        steps = 0
        while not ov.drifted():
            assert prune_step(ov, fraction=0.15) == prune_step(jov, fraction=0.15)
            steps += 1
        assert jov.drifted() and steps > 0
        _same_state(ov, jov)
        res, jres = ov.refresh(), jov.refresh()
        assert res.retuned and jres.retuned
        assert res.key_after == _port_key(jres.key_after)

    def test_perturb_fdm27_equals_reference(self):
        from repro.core import matrices as JM

        ov, jov = _pair(M.fdm27(4, 4, 4))
        for step in range(4):
            assert M.perturb_fdm27(ov, step, 4, 4, 4) == JM.perturb_fdm27(jov, step, 4, 4, 4)
            _same_state(ov, jov)


# ----------------------------------------------------------- exactness ----


class TestOverlayExactness:
    def test_matvec_bit_identical_to_rebuilt_csr_plain(self):
        s = _int_csr()
        ov = DeltaOverlay(_op(s).using("plain", fallback=False))
        _mutate_stream(ov)
        assert ov.ndelta > 0
        x = _int_x(ov.shape[1])
        rebuilt = _op(ov.to_scipy()).using("plain", fallback=False)
        assert torch.equal(ov @ x, rebuilt @ x)

    @pytest.mark.parametrize("fmt", ["csr", "coo", "dia", "ell", "sell"])
    def test_matvec_matches_scipy_every_base_format(self, fmt):
        ov = DeltaOverlay(_op(_int_csr(n=32), fmt))
        _mutate_stream(ov, steps=25)
        x = _int_x(32)
        _close(ov @ x, ov.to_scipy() @ x.astype(np.float64))

    def test_delta_runs_on_the_bases_device_without_a_plan(self):
        """The delta's COO has no column-tile plan (the reference builds it
        so), on the base's device and under its policy."""
        ov = DeltaOverlay(_op(_int_csr(n=32)).using("cuda"))
        ov.set(0, 31, 2.0)
        d = ov.delta_operator()
        assert d.format == "coo" and d.container.plan is None
        assert d.device == ov.base.device and d.policy == ov.base.policy

    def test_matmat_matches_scipy(self):
        ov = DeltaOverlay(_op(_int_csr(n=24)))
        _mutate_stream(ov, steps=15)
        X = np.stack([_int_x(24, seed=i) for i in range(3)], axis=1)
        _close(ov.matmat(X), ov.to_scipy() @ X.astype(np.float64))

    def test_clean_overlay_is_base_exactly(self):
        base = _op(_int_csr(n=16))
        ov = DeltaOverlay(base)
        x = _int_x(16)
        assert ov.delta_operator() is None
        assert torch.equal(ov @ x, base @ x)

    def test_compact_bit_identical_to_from_scratch_rebuild(self):
        rng = np.random.default_rng(5)
        s = sp.random(40, 40, density=0.1, random_state=rng, format="csr")
        ov = DeltaOverlay(_op(s))
        for _ in range(20):
            ov.set(int(rng.integers(40)), int(rng.integers(40)),
                   float(rng.standard_normal()))
        merged = ov.to_scipy()
        compacted = ov.compact()
        fresh = _op(merged)
        for got, want in zip(compacted.container.tensors(), fresh.container.tensors()):
            assert torch.equal(got, want)
        x = _int_x(40)
        assert torch.equal(compacted @ x, fresh @ x)

    @pytest.mark.parametrize("fmt", ["coo", "dia", "ell", "sell", "bsr"])
    def test_compact_keeps_format_and_policy(self, fmt):
        ov = DeltaOverlay(_op(_int_csr(n=32), fmt).using("cuda"))
        _mutate_stream(ov, steps=20)
        op = ov.compact()
        fresh = as_operator(ov.to_scipy(), fmt, device="cpu", **(
            {"C": ov.base.container.C} if fmt == "sell" else {}))
        assert op.format == fmt and op.policy == ov.base.policy
        for got, want in zip(op.container.tensors(), fresh.container.tensors()):
            assert torch.equal(got, want)

    def test_compact_idempotent(self):
        ov = DeltaOverlay(_op(_int_csr(n=20)))
        _mutate_stream(ov, steps=10)
        op1 = ov.compact()
        assert ov.compact() is op1
        assert ov.ndelta == 0


# ---------------------------------------------------------- bookkeeping ----


class TestOverlayBookkeeping:
    def test_value_insert_update_delete_cycle(self):
        ov = DeltaOverlay(sp.eye(8, format="csr") * 2.0, device="cpu")
        assert ov.value(0, 0) == 2.0 and ov.nnz == 8
        ov.insert(0, 5, 3.0)
        assert ov.value(0, 5) == 3.0 and ov.nnz == 9 and ov.ndelta == 1
        ov.update(0, 5, 4.0)
        assert ov.value(0, 5) == 4.0 and ov.nnz == 9
        ov.delete(0, 5)
        assert ov.value(0, 5) == 0.0 and ov.nnz == 8
        ov.delete(1, 1)
        assert ov.nnz == 7
        assert ov.to_scipy().nnz == 7

    def test_revert_clears_delta(self):
        ov = DeltaOverlay(sp.eye(4, format="csr") * 2.0, device="cpu")
        ov.set(2, 2, 5.0)
        assert ov.ndelta == 1
        ov.set(2, 2, 2.0)
        assert ov.ndelta == 0

    def test_add_accumulates(self):
        ov = DeltaOverlay(sp.eye(4, format="csr") * 2.0, device="cpu")
        ov.add(1, 1, 1.5)
        ov.add(1, 1, 1.5)
        assert ov.value(1, 1) == 5.0

    def test_set_many_and_validation(self):
        ov = DeltaOverlay(sp.eye(6, format="csr"), device="cpu")
        ov.set_many([0, 1], [5, 4], [2.0, 3.0])
        assert ov.value(0, 5) == 2.0 and ov.value(1, 4) == 3.0
        with pytest.raises(ValueError, match="set_many"):
            ov.set_many([0], [1, 2], [1.0, 2.0])
        with pytest.raises(IndexError):
            ov.set(6, 0, 1.0)

    def test_tracked_features_match_extracted(self):
        ov = DeltaOverlay(_op(_int_csr(n=30)))
        _mutate_stream(ov, steps=30)
        got = ov.features()
        want = extract_features(ov.to_scipy())
        assert (got.nnz, got.ndiags, got.band_extent, got.rownnz_max) \
            == (want.nnz, want.ndiags, want.band_extent, want.rownnz_max)
        assert got.rownnz_mean == pytest.approx(want.rownnz_mean)
        assert got.rownnz_std == pytest.approx(want.rownnz_std)


# ---------------------------------------------------------------- drift ----


class TestDrift:
    def test_clean_overlay_has_zero_drift(self):
        ov = DeltaOverlay(_op(M.banded(32, 3)))
        assert ov.drift().score == 0.0
        assert not ov.drifted()

    def test_monotone_under_growing_insertions(self):
        ov = DeltaOverlay(_op(M.tridiag(64)))
        scores = []
        for j in range(3, 60, 4):
            ov.set(0, j, 1.0)
            scores.append(ov.drift().score)
        assert all(b >= a for a, b in zip(scores, scores[1:]))
        assert scores[-1] > scores[0] > 0.0

    def test_compaction_preserves_drift_baseline(self):
        ov = DeltaOverlay(_op(M.tridiag(64)))
        for j in range(10, 30, 4):
            ov.set(0, j, 1.0)
        before = ov.drift().score
        assert before > 0.0
        ov.compact()
        assert ov.drift().score == pytest.approx(before)

    def test_retune_resets_drift_baseline(self):
        ov = DeltaOverlay(_op(M.tridiag(64)))
        for j in range(10, 50, 4):
            ov.set(0, j, 1.0)
        assert ov.refresh(threshold=0.0, mode="predict").retuned
        assert ov.drift().score == 0.0

    def test_selection_drifted_helper(self):
        tri = extract_features(M.tridiag(256))
        scatter = extract_features(M.powerlaw(256, seed=3))
        assert not selection_drifted(tri, tri, platform="cpu")
        assert selection_drifted(tri, scatter, platform="cpu")


# -------------------------------------------------------------- refresh ----


@pytest.fixture
def dispatch_calls(monkeypatch):
    """Every kernel invocation through the port's dispatch tables."""
    calls = []
    orig = tspmv.KernelEntry.call

    def counted(self, A, *operands, policy):
        calls.append(self.key)
        return orig(self, A, *operands, policy=policy)

    monkeypatch.setattr(tspmv.KernelEntry, "call", counted)
    return calls


class TestRefresh:
    def _drifting_overlay(self, n=64):
        ov = DeltaOverlay(_op(M.tridiag(n)))
        for j in range(8, n - 1, 4):        # band-widening inserts into row 0
            ov.set(0, j, 1.0)
        return ov

    def test_no_retune_below_threshold_zero_dispatches(self, dispatch_calls):
        ov = self._drifting_overlay()
        res = ov.refresh(threshold=1000.0, mode="run")
        assert not res.retuned and res.compacted
        assert dispatch_calls == []

    def test_retune_above_threshold_predict_zero_dispatches(self, dispatch_calls):
        res = self._drifting_overlay().refresh(threshold=0.0, mode="predict")
        assert res.retuned
        assert dispatch_calls == []

    def test_retune_above_threshold_run_mode_dispatches(self, dispatch_calls):
        res = self._drifting_overlay(n=32).refresh(threshold=0.0, mode="run", device="cpu")
        assert res.retuned
        assert len(dispatch_calls) > 0

    def test_refresh_result_fields(self):
        ov = self._drifting_overlay()
        fp0 = ov.base_fingerprint
        res = ov.refresh(threshold=0.0, mode="predict")
        assert isinstance(res, RefreshResult)
        assert res.compacted and res.retuned
        assert res.fingerprint_before == fp0
        assert res.fingerprint_after == ov.base_fingerprint != fp0
        assert res.operator is ov.base
        assert res.reselected == (res.key_after != res.key_before)
        x = _int_x(ov.shape[1])
        _close(ov @ x, ov.to_scipy() @ x.astype(np.float64))

    def test_mode_none_compacts_only(self):
        res = self._drifting_overlay().refresh(threshold=0.0, mode=None)
        assert res.compacted and not res.retuned

    def test_operator_mutable_and_refresh_delegate(self):
        op = _op(M.tridiag(32))
        ov = op.mutable()
        assert ov.drift_threshold == DEFAULT_DRIFT_THRESHOLD
        ov.set(0, 20, 1.0)
        out = op.refresh(ov, threshold=10.0)
        assert out is ov.base and ov.ndelta == 0
        ov.set(0, 25, 1.0)
        with pytest.raises(ValueError, match="overlay"):
            op.refresh(ov)

    def test_overlay_keeps_buffering_after_refresh(self):
        ov = self._drifting_overlay()
        ov.refresh(threshold=0.0)
        ov.set(1, 30, 2.0)
        x = _int_x(ov.shape[1])
        _close(ov @ x, ov.to_scipy() @ x.astype(np.float64))


# ------------------------------------------------------------ scenarios ----


class TestScenarios:
    def test_perturb_fdm27_drift_grows_across_steps(self):
        ov = DeltaOverlay(_op(M.fdm27(4, 4, 4)))
        scores = []
        for step in range(5):
            assert M.perturb_fdm27(ov, step, 4, 4, 4) > 0
            scores.append(ov.drift().score)
        assert all(b >= a for a, b in zip(scores, scores[1:]))
        assert scores[-1] >= DEFAULT_DRIFT_THRESHOLD
        x = _int_x(64)
        _close(ov @ x, ov.to_scipy() @ x.astype(np.float64))

    def test_prune_step_deletes_smallest_magnitudes(self):
        ov = DeltaOverlay(_op(M.banded(48, 5, seed=1)))
        nnz0 = ov.nnz
        deleted = prune_step(ov, fraction=0.25)
        assert deleted == max(1, int(0.25 * nnz0))
        assert ov.nnz == nnz0 - deleted
        assert ov.drift().nnz == pytest.approx(deleted / nnz0)

    def test_pruning_to_threshold_then_refresh(self):
        ov = DeltaOverlay(_op(M.banded(48, 9, seed=0)), drift_threshold=0.25)
        while not ov.drifted():
            prune_step(ov, fraction=0.15)
        assert ov.refresh().retuned


# ---------------------------------------------------- fingerprint bugfix ----


class TestFingerprintCollision:
    def _pair(self):
        indptr = np.arange(9, dtype=np.int64)
        data = np.ones(8)
        a = sp.csr_matrix((data, np.arange(8) % 4, indptr), shape=(8, 8))
        b = sp.csr_matrix((data, (np.arange(8) % 4) + 4, indptr), shape=(8, 8))
        return a, b

    def test_same_rows_and_values_different_columns_distinct(self):
        a, b = self._pair()
        assert SpmvWorkspace.fingerprint(a) != SpmvWorkspace.fingerprint(b)
        assert SpmvWorkspace.fingerprint(a) == J.SpmvWorkspace.fingerprint(a)

    def test_cached_spmv_distinguishes_column_shifts(self):
        a, b = self._pair()
        ws = SpmvWorkspace(max_entries=4)
        x = np.arange(8, dtype=np.float32)
        ya = ws.spmv(a, x, device="cpu").numpy()
        yb = ws.spmv(b, x, device="cpu").numpy()
        assert np.array_equal(ya, (a @ x).astype(np.float32))
        assert np.array_equal(yb, (b @ x).astype(np.float32))
        assert not np.array_equal(ya, yb)
