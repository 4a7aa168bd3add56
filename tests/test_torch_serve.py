"""The port's serving layer (``repro_torch.serve`` over
``repro_torch.core.registry``) against the reference's on the CPU.

Mirrors ``tests/test_serve.py`` — deterministic batching, coalesced-SpMM
bit-identity across the format x backend grid, warm-pool LRU eviction and
re-tune on readmission, the stats-counter invariants, dynamic tenants — and
holds the port to ``repro.serve`` / ``repro.core.registry`` on the same
seeded inputs: fingerprints, ``plan_batches`` tiles and traffic streams are
equal exactly; over the same hot and churn traffic the summary's counters
are equal (``tune_mode=None`` on csr/plain, and ``tune_mode="predict"`` with
the reference's ``pallas`` keys read as ``cuda``), and every served vector
agrees with the reference engine's within rtol 2e-4.

Every engine here runs on ``device="cpu"``, where a ``cuda`` entry runs its
kernel's plain PyTorch version.
"""
import asyncio

import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as JS
from repro.core import matrices as JM

from repro_torch.core import ExecutionPolicy, SpmvWorkspace, as_operator
from repro_torch.core import matrices as M
from repro_torch.serve import (
    ServeEngine,
    TrafficGenerator,
    TrafficSpec,
    coalescible,
    plan_batches,
    run_traffic,
)
from repro_torch.serve.batcher import ServeRequest

_N = 96
_S = (M.banded(_N, 3, seed=0) + M.random_uniform(_N, 0.02, seed=1)).tocsr()
_RHS = [np.random.default_rng(10 + i).standard_normal(_N).astype(np.float32)
        for i in range(6)]

SERVE_FORMATS = ("coo", "csr", "dia", "ell", "sell")
ALL_FORMATS = SERVE_FORMATS + ("bsr", "dense")


class FakeClock:
    """Deterministic monotonic clock: every read advances 1ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def _engine(**kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("device", "cpu")
    return ServeEngine(**kw)


def _ref_engine(**kw):
    kw.setdefault("clock", FakeClock())
    return JS.ServeEngine(**kw)


def _port_key(key):
    """A reference (format, backend) in the port's spelling."""
    fmt, backend = key
    return (fmt, "cuda" if backend == "pallas" else backend)


def _np(y):
    return np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y, np.float32)


def _close(got, want, rtol=2e-4):
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------ fingerprint ----


class TestFingerprintEqualsReference:
    def test_scipy_and_dense(self):
        assert SpmvWorkspace.fingerprint(_S) == J.SpmvWorkspace.fingerprint(_S)
        d = np.asarray(_S.todense(), np.float32)
        assert SpmvWorkspace.fingerprint(d) == J.SpmvWorkspace.fingerprint(d)
        # a tensor holding the same array hashes as the array
        assert SpmvWorkspace.fingerprint(torch.from_numpy(d)) == J.SpmvWorkspace.fingerprint(d)

    @pytest.mark.parametrize("cap", [None, 48], ids=["resident", "tiled"])
    @pytest.mark.parametrize("fmt", ALL_FORMATS)
    def test_container(self, fmt, cap):
        """Fields in order, then the plan's arrays: the reference's pytree
        leaves, subsampled the same way (a 48-column cap gives the
        plan-carrying formats their tiled plans)."""
        kw = {} if cap is None else {"max_resident_cols": cap}
        A_t = as_operator(_S, fmt, policy=ExecutionPolicy(**kw), device="cpu")
        A_j = J.as_operator(_S, fmt, policy=J.ExecutionPolicy(**kw))
        assert SpmvWorkspace.fingerprint(A_t) == J.SpmvWorkspace.fingerprint(A_j)
        assert SpmvWorkspace.fingerprint(A_t.container) == SpmvWorkspace.fingerprint(A_t)

    @pytest.mark.parametrize("vdt", ["bfloat16", "float16"])
    def test_narrow_values(self, vdt):
        A_t = as_operator(_S, "csr", policy=ExecutionPolicy(value_dtype=vdt), device="cpu")
        A_j = J.as_operator(_S, "csr", policy=J.ExecutionPolicy(value_dtype=vdt))
        assert SpmvWorkspace.fingerprint(A_t) == J.SpmvWorkspace.fingerprint(A_j)

    def test_caches_are_not_hashed(self):
        A = as_operator(_S, "csr", device="cpu").using("cuda")
        before = SpmvWorkspace.fingerprint(A)
        A @ _RHS[0]  # fills the plan's cache
        A.container.plan.cache["extra"] = torch.ones(3)
        assert SpmvWorkspace.fingerprint(A) == before


# ---------------------------------------------------------------- batcher ----


def _queue_from_traffic(spec, num, gen_cls=TrafficGenerator, fp=SpmvWorkspace.fingerprint):
    """Materialise a traffic stream as the engine's queue would see it."""
    gen = gen_cls(spec)
    queue = []
    for i, (name, mat, rhs) in enumerate(gen.requests(num)):
        queue.append(ServeRequest(i, fp(mat), rhs, t_submit=float(i)))
    return queue


def _tiles(plan):
    return [(t.fingerprint, tuple(r.rid for r in t.requests)) for t in plan]


class TestBatcher:
    def test_plan_is_deterministic_on_seeded_traffic(self):
        spec = TrafficSpec(mix="churn", n=32, n_matrices=4, seed=7)
        p1 = plan_batches(_queue_from_traffic(spec, 24), max_batch=5)
        p2 = plan_batches(_queue_from_traffic(spec, 24), max_batch=5)
        assert _tiles(p1) == _tiles(p2)

    @pytest.mark.parametrize("mix", ["hot", "churn", "mixed"])
    def test_plan_equals_reference(self, mix):
        from repro.serve.batcher import ServeRequest as JRequest

        spec = TrafficSpec(mix=mix, n=32, n_matrices=4, seed=7)
        jspec = JS.TrafficSpec(mix=mix, n=32, n_matrices=4, seed=7)
        mine = plan_batches(_queue_from_traffic(spec, 24), max_batch=5)
        jq = [JRequest(i, J.SpmvWorkspace.fingerprint(mat), rhs, float(i))
              for i, (_, mat, rhs) in enumerate(JS.TrafficGenerator(jspec).requests(24))]
        assert _tiles(mine) == _tiles(JS.plan_batches(jq, max_batch=5))

    def test_groups_first_arrival_order_fifo_chunks(self):
        def req(i, fp):
            return ServeRequest(i, fp, np.zeros(4, np.float32), float(i))

        queue = [req(0, "b"), req(1, "a"), req(2, "a"), req(3, "b"), req(4, "a")]
        tiles = plan_batches(queue, max_batch=2)
        assert _tiles(tiles) == [("b", (0, 3)), ("a", (1, 2)), ("a", (4,))]
        assert all(t.size <= 2 for t in tiles)

    def test_max_batch_validated(self):
        with pytest.raises(ValueError, match="max_batch"):
            plan_batches([], max_batch=0)

    def test_coalescible_grid(self):
        # plain/cuda SpMV-per-column lanes coalesce; the dense backend's
        # matmul reassociates and must not, nor may bsr's native SpMM
        for fmt in SERVE_FORMATS:
            op = as_operator(_S, fmt, device="cpu")
            assert coalescible(op.using("plain", fallback=False))
            assert coalescible(op.using("cuda")), fmt
            assert not coalescible(op.using("dense", fallback=False))
        assert not coalescible(as_operator(_S, "bsr", device="cpu").using("cuda"))


# ---------------------------------------------------------------- traffic ----


class TestTrafficEqualsReference:
    @pytest.mark.parametrize("mix", ["hot", "churn", "mixed"])
    def test_streams_bit_for_bit(self, mix):
        spec = TrafficSpec(mix=mix, n=40, n_matrices=5, seed=11)
        jspec = JS.TrafficSpec(mix=mix, n=40, n_matrices=5, seed=11)
        mine = list(TrafficGenerator(spec).requests(17))
        ref = list(JS.TrafficGenerator(jspec).requests(17))
        assert [n for n, _, _ in mine] == [n for n, _, _ in ref]
        for (_, a, x), (_, b, y) in zip(mine, ref):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            assert (a != b).nnz == 0 and a.dtype == b.dtype

    def test_matrix_pool_equals_reference(self):
        from repro_torch.serve import matrix_pool

        mine, ref = matrix_pool(64, 6, seed=2), JS.matrix_pool(64, 6, seed=2)
        assert [n for n, _ in mine] == [n for n, _ in ref]
        assert all(SpmvWorkspace.fingerprint(a) == J.SpmvWorkspace.fingerprint(b)
                   for (_, a), (_, b) in zip(mine, ref))


# ----------------------------------------------------------- bit-identity ----


class TestCoalescedBitIdentity:
    @pytest.mark.parametrize("backend", ["plain", "cuda"])
    @pytest.mark.parametrize("fmt", SERVE_FORMATS)
    def test_coalesced_equals_per_request(self, fmt, backend):
        """One SpMM tile vs k independent matvecs: bit-for-bit, per cell,
        under the strict no-fallback policy the conformance grid uses."""
        pol = ExecutionPolicy(backends=(backend,), allow_fallback=False)
        batched = _engine(fmt=fmt, policy=pol, tune_mode=None, max_batch=8)
        singles = _engine(fmt=fmt, policy=pol, tune_mode=None, max_batch=1)
        t_b = [batched.submit(_S, x) for x in _RHS]
        t_s = [singles.submit(_S, x) for x in _RHS]
        batched.flush()
        singles.flush()
        for tb, ts in zip(t_b, t_s):
            assert torch.equal(tb.result(), ts.result()), (fmt, backend)
        assert all(t.record.coalesced and t.record.batch_size == len(_RHS)
                   for t in t_b)
        assert all(not t.record.coalesced and t.record.batch_size == 1
                   for t in t_s)

    def test_coalesced_equals_direct_operator_matvec(self):
        eng = _engine(fmt="csr", tune_mode=None, max_batch=8)
        tickets = [eng.submit(_S, x) for x in _RHS]
        eng.flush()
        op = eng.workspace.lookup(eng.fingerprint(_S))
        for t, x in zip(tickets, _RHS):
            assert torch.equal(t.result(), op @ x)

    def test_dense_backend_served_per_request(self):
        """A non-bit-stable lane must not coalesce — and still be exact."""
        pol = ExecutionPolicy(backends=("dense",), allow_fallback=False)
        eng = _engine(fmt="csr", policy=pol, tune_mode=None, max_batch=8)
        tickets = [eng.submit(_S, x) for x in _RHS]
        eng.flush()
        assert all(not t.record.coalesced for t in tickets)
        op = eng.workspace.lookup(eng.fingerprint(_S))
        for t, x in zip(tickets, _RHS):
            assert torch.equal(t.result(), op @ x)

    def test_batched_matvec_validates_shapes(self):
        op = as_operator(_S, "csr", device="cpu")
        with pytest.raises(ValueError, match="ndim"):
            op.batched_matvec(np.zeros(_N, np.float32))
        with pytest.raises(ValueError, match="columns"):
            op.batched_matvec(np.zeros((2, _N + 1), np.float32))
        ys = op.batched_matvec(np.stack(_RHS[:2]))
        assert ys.shape == (2, _N)
        assert torch.equal(ys[0], op @ _RHS[0])

    def test_rhs_lands_on_the_engine_device_once(self):
        eng = _engine(tune_mode=None)
        t = eng.submit(_S, _RHS[0])
        assert eng._queue[0].rhs.device.type == "cpu"
        assert t.result().device.type == "cpu"


# --------------------------------------------------------------- warm pool ----


class TestWarmPool:
    def test_eviction_then_readmission_retunes(self):
        A, B = M.banded(32, 3, seed=1), M.tridiag(32, seed=2)
        eng = _engine(capacity=1, max_batch=4)  # pool holds ONE tenant
        x = np.ones(32, np.float32)

        eng.submit(A, x); eng.flush()       # admit A (tune #1)
        eng.submit(B, x); eng.flush()       # admit B, evict A (tune #2)
        eng.submit(A, x); eng.flush()       # readmit A: re-tune (tune #3)
        assert eng.stats.tunes == 3
        assert eng.stats.cache_hits == 0
        assert eng.workspace.stats()["evictions"] == 2

        eng.submit(A, x); eng.flush()       # warm now: hit, no new tune
        assert eng.stats.tunes == 3
        assert eng.stats.cache_hits == 1

    def test_one_admission_per_group_per_flush(self):
        eng = _engine(capacity=4, max_batch=2)
        x = np.ones(32, np.float32)
        A = M.banded(32, 3, seed=1)
        for _ in range(5):                  # 5 requests -> 3 tiles, 1 group
            eng.submit(A, x)
        eng.flush()
        assert eng.stats.admissions == 1
        assert len(eng.stats.batches) == 3

    def test_fingerprint_only_submission(self):
        eng = _engine(capacity=2)
        x = np.ones(32, np.float32)
        A = M.banded(32, 3, seed=1)
        t0 = eng.submit(A, x); eng.flush()
        t1 = eng.submit(eng.fingerprint(A), x)
        assert torch.equal(t1.result(), t0.result())

    def test_unknown_fingerprint_raises_at_flush(self):
        eng = _engine()
        eng.submit("deadbeef", np.ones(8, np.float32))
        with pytest.raises(KeyError, match="unknown"):
            eng.flush()

    def test_ticket_result_flushes_and_await_works(self):
        eng = _engine()
        A = M.tridiag(16, seed=0)
        t = eng.submit(A, np.ones(16, np.float32))
        assert not t.done
        y = t.result()                      # lazy flush
        assert t.done and y.shape == (16,)

        async def roundtrip():
            return await eng.submit(A, np.ones(16, np.float32))

        assert asyncio.run(roundtrip()).shape == (16,)


# ---------------------------------------------------- registry / LRU edges ----


class TestWorkspaceCache:
    def test_stats_counters(self):
        ws = SpmvWorkspace(max_entries=2)
        A, B, C = (M.banded(16, 3, seed=i) for i in range(3))
        ws.get_operator(A, "csr", device="cpu")
        ws.get_operator(A, "csr", device="cpu")
        assert ws.stats() == {"hits": 1, "misses": 1, "evictions": 0,
                              "size": 1, "capacity": 2}
        ws.get_operator(B, "csr", device="cpu")
        ws.get_operator(C, "csr", device="cpu")  # evicts A (LRU)
        assert ws.stats()["evictions"] == 1
        assert ws.stats()["size"] == 2

    def test_hit_refreshes_recency_before_insert(self):
        ws = SpmvWorkspace(max_entries=2)
        A, B, C = (M.banded(16, 3, seed=i) for i in range(3))
        for m in (A, B, A, C):
            ws.get_operator(m, "csr", device="cpu")
        keys = ws.keys()
        assert any(k.startswith(ws.fingerprint(A)) for k in keys)
        assert not any(k.startswith(ws.fingerprint(B)) for k in keys)

    def test_keys_equal_reference(self):
        """``get_operator`` keys ``fingerprint:fmt:kwargs`` as the
        reference does, and the LRU keeps the same ones."""
        ws, jws = SpmvWorkspace(max_entries=2), J.SpmvWorkspace(max_entries=2)
        for i in (0, 1, 0, 2):
            m = M.banded(16, 3, seed=i)
            ws.get_operator(m, "dia", device="cpu")
            jws.get_operator(m, "dia")
        assert ws.keys() == jws.keys() and ws.stats() == jws.stats()

    def test_admit_same_call_hit_keeps_recency(self):
        ws = SpmvWorkspace(max_entries=2)
        A, B, C = (M.banded(16, 3, seed=i) for i in range(3))
        fpa, fpb, fpc = (ws.fingerprint(m) for m in (A, B, C))
        ws.admit(fpa, lambda: as_operator(A, "csr", device="cpu"))
        ws.admit(fpb, lambda: as_operator(B, "csr", device="cpu"))

        def build_c():
            assert ws.lookup(fpa) is not None  # same-call hit refreshes A
            return as_operator(C, "csr", device="cpu")

        op, was_hit = ws.admit(fpc, build_c)  # insert evicts B, NOT A
        assert not was_hit
        assert set(ws.keys()) == {fpa, fpc}

    def test_admit_hit_path(self):
        ws = SpmvWorkspace(max_entries=2)
        A = M.banded(16, 3, seed=0)
        fp = ws.fingerprint(A)
        op1, hit1 = ws.admit(fp, lambda: as_operator(A, "csr", device="cpu"))
        op2, hit2 = ws.admit(fp, lambda: (_ for _ in ()).throw(AssertionError))
        assert (hit1, hit2) == (False, True)
        assert op1 is op2

    def test_spmv_cached_matches_scipy(self):
        ws = SpmvWorkspace(max_entries=4)
        x = np.arange(_N, dtype=np.float32)
        y = ws.spmv(_S, x, "csr", device="cpu")
        _close(y, (_S @ x.astype(np.float64)).astype(np.float32))
        ws.spmv(_S, x, "csr", device="cpu")
        assert ws.stats()["hits"] == 1


# ------------------------------------------------------- stats invariants ----


class TestStatsInvariants:
    def test_counters_over_churn_traffic(self):
        eng = _engine(capacity=2, max_batch=4)
        spec = TrafficSpec(mix="churn", n=48, n_matrices=4, seed=3)
        out = run_traffic(eng, spec, 20, flush_every=8)
        s = eng.stats

        assert len(s.requests) == 20
        assert sum(b.size for b in s.batches) == 20
        assert all(1 <= b.size <= 4 for b in s.batches)
        assert s.cache_hits + s.cache_misses == s.admissions
        assert s.tunes == s.cache_misses        # every cold admission tuned
        assert s.dispatch_fallbacks == 0
        for r in s.requests:
            assert 0.0 <= r.queue_wait_s <= r.latency_s
        assert out["latency_p50_s"] <= out["latency_p99_s"]
        assert out["queue_wait_p50_s"] <= out["queue_wait_p99_s"]
        assert out["throughput_rps"] > 0
        ws = out["workspace"]
        assert ws["hits"] == s.cache_hits
        assert ws["misses"] == s.cache_misses
        assert ws["size"] <= ws["capacity"] == 2

    def test_hot_mix_saturates_batches_and_hits(self):
        eng = _engine(capacity=2, max_batch=4)
        out = run_traffic(eng, TrafficSpec(mix="hot", n=48, seed=0), 16, flush_every=8)
        assert out["batch_size_max"] == 4
        assert out["coalesced_fraction"] == 1.0
        assert eng.stats.cache_misses == 1
        assert eng.stats.cache_hits == eng.stats.admissions - 1

    def test_on_flush_sees_each_window_served(self):
        spec = TrafficSpec(mix="churn", n=48, n_matrices=4, seed=3)
        windows = []
        out = run_traffic(_engine(capacity=2, max_batch=4), spec, 20, flush_every=8,
                          on_flush=windows.append)
        plain = run_traffic(_engine(capacity=2, max_batch=4), spec, 20, flush_every=8)
        assert [len(w) for w in windows] == [8, 8, 4]
        sent = list(TrafficGenerator(spec).requests(20))
        got = [item for w in windows for item in w]
        assert [name for name, _, _ in got] == [name for name, _, _ in sent]
        assert all(np.array_equal(rhs, want) for (_, rhs, _), (_, _, want) in zip(got, sent))
        assert all(t.ok for _, _, t in got)
        for k in ("admissions", "batches", "tunes", "workspace"):
            assert out[k] == plain[k], k

    def test_traffic_generator_deterministic(self):
        spec = TrafficSpec(mix="mixed", n=32, n_matrices=4, seed=11)
        a = [(n, rhs.tobytes()) for n, _, rhs in TrafficGenerator(spec).requests(15)]
        b = [(n, rhs.tobytes()) for n, _, rhs in TrafficGenerator(spec).requests(15)]
        assert a == b

    def test_traffic_rejects_unknown_mix(self):
        with pytest.raises(ValueError, match="mix"):
            TrafficSpec(mix="flood")


# ------------------------------------------- the same traffic, both engines ----

#: Counters that depend on the tenant sequence alone (host logic).
COUNTERS = ("requests", "batches", "admissions", "cache_hits", "cache_misses",
            "tunes", "coalesced_fraction", "batch_size_max")


def _drive_both(mix, num, flush_every, **kw):
    """The same spec through both engines, request by request; returns
    (port engine, reference engine, port tickets, reference tickets)."""
    spec = dict(mix=mix, n=48, n_matrices=5, seed=3)
    eng, jeng = _engine(**kw), _ref_engine(**kw)
    mine, ref = [], []
    reqs = zip(TrafficGenerator(TrafficSpec(**spec)).requests(num),
               JS.TrafficGenerator(JS.TrafficSpec(**spec)).requests(num))
    for i, ((_, a, x), (_, b, y)) in enumerate(reqs):
        mine.append(eng.submit(a, x))
        ref.append(jeng.submit(b, y))
        if (i + 1) % flush_every == 0:
            eng.flush()
            jeng.flush()
    eng.flush()
    jeng.flush()
    return eng, jeng, mine, ref


@pytest.mark.parametrize("tune_mode", [None, "predict"], ids=["untuned", "predict"])
@pytest.mark.parametrize("mix", ["hot", "churn"])
def test_summary_and_results_equal_reference(mix, tune_mode):
    eng, jeng, mine, ref = _drive_both(mix, 18, 7, capacity=2, max_batch=4,
                                       tune_mode=tune_mode)
    out, jout = eng.summary(), jeng.summary()
    assert {k: out[k] for k in COUNTERS} == {k: jout[k] for k in COUNTERS}
    for k in ("hits", "misses", "evictions", "size"):
        assert out["workspace"][k] == jout["workspace"][k], k
    # the warm pool holds the same tenants, tuned to the same keys
    assert eng.workspace.keys() == jeng.workspace.keys()
    for fp in eng.workspace.keys():
        op, jop = eng.workspace._ops[fp], jeng.workspace._ops[fp]
        assert (op.format, op._effective_policy().backends[0]) == _port_key(
            (jop.format, jop._effective_policy().backends[0]))
    for t, jt in zip(mine, ref):
        assert t.ok and jt.ok
        assert t.record.coalesced == jt.record.coalesced
        assert t.record.batch_size == jt.record.batch_size
        _close(t.result(), jt.result())
    # on the port nothing fell off its preferred lane
    assert out["dispatch_fallbacks"] == 0 and out["degraded_requests"] == 0


# ------------------------------------------------------ capacity invariant ----


class TestCapacityInvariant:
    def test_capacity_zero_never_retains(self):
        ws = SpmvWorkspace(max_entries=0)
        A = M.banded(16, 3, seed=0)
        op = ws.get_operator(A, "csr", device="cpu")
        assert op.format == "csr"
        st = ws.stats()
        assert st["size"] == 0 and st["capacity"] == 0
        op2, hit = ws.admit(ws.fingerprint(A), lambda: as_operator(A, "csr", device="cpu"))
        assert not hit
        assert ws.stats()["size"] == 0 and len(ws) == 0

    def test_size_never_exceeds_capacity_under_churn(self):
        ws = SpmvWorkspace(max_entries=2)
        for i in range(5):
            ws.get_operator(M.banded(16, 3, seed=i), "csr", device="cpu")
            assert ws.stats()["size"] <= ws.stats()["capacity"]

    def test_negative_capacity_rejected(self):
        with pytest.raises(ValueError, match="max_entries"):
            SpmvWorkspace(max_entries=-1)

    def test_insert_and_discard(self):
        ws = SpmvWorkspace(max_entries=2)
        ws.insert("fp-a", as_operator(M.banded(16, 3, seed=0), "csr", device="cpu"))
        assert ws.keys() == ("fp-a",)
        assert ws.stats()["hits"] == ws.stats()["misses"] == 0
        assert ws.discard("fp-a") and not ws.discard("fp-a")
        assert ws.stats()["evictions"] == 0  # invalidation, not eviction


# ------------------------------------------------------------- percentile ----


class TestNearestRankPercentile:
    def test_even_length_p50_is_lower_middle(self):
        from repro_torch.serve.stats import _percentile

        assert _percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0

    def test_nearest_rank_equals_reference(self):
        from repro.serve.stats import _percentile as jp
        from repro_torch.serve.stats import _percentile

        vals = [10.0, 20.0, 30.0, 40.0, 50.0]
        for p in (0, 20, 21, 50, 99, 100):
            assert _percentile(vals, p) == jp(vals, p)
        assert _percentile([], 50) == 0.0
        assert _percentile([7.0], 99) == 7.0

    def test_fake_clock_latency_percentiles(self):
        eng = _engine(fmt="csr", tune_mode=None, max_batch=1)
        for x in _RHS[:4]:
            eng.submit(_S, x)
        eng.flush()
        lats = sorted(r.latency_s for r in eng.stats.requests)
        out = eng.summary()
        assert out["latency_p50_s"] == pytest.approx(lats[1])
        assert out["latency_p99_s"] == pytest.approx(lats[3])
        # the same engine knobs on the reference's fake clock read the same
        jeng = _ref_engine(fmt="csr", tune_mode=None, max_batch=1)
        for x in _RHS[:4]:
            jeng.submit(_S, x)
        jeng.flush()
        jout = jeng.summary()
        assert (out["latency_p50_s"], out["latency_p99_s"]) == pytest.approx(
            (jout["latency_p50_s"], jout["latency_p99_s"]))


# ------------------------------------------------------- dynamic tenants ----


class TestEngineRefresh:
    def _mutated_engine(self, threshold, **kw):
        eng = _engine(capacity=4, drift_threshold=threshold, **kw)
        ov = eng.mutable(M.tridiag(48, seed=0))
        for j in range(6, 42, 4):          # band-widening inserts
            ov.set(0, j, 1.0)
        return eng, ov

    def test_below_threshold_compacts_without_retune(self):
        eng, ov = self._mutated_engine(threshold=1e9)
        tunes0 = eng.stats.tunes
        res = eng.refresh(ov)
        assert res.compacted and not res.retuned
        assert eng.stats.refreshes == 1 and eng.stats.refresh_retunes == 0
        assert eng.stats.tunes == tunes0
        out = eng.summary()
        assert out["refreshes"] == 1 and out["refresh_retunes"] == 0

    def test_above_threshold_retunes_and_readmits(self):
        eng, ov = self._mutated_engine(threshold=0.0)
        old_fp = ov.base_fingerprint
        assert eng.workspace.lookup(old_fp) is not None
        eng.stats.cache_hits += 1            # keep ws/engine counters aligned
        res = eng.refresh(ov)
        assert res.retuned and res.fingerprint_after != old_fp
        assert res.fingerprint_after in eng.workspace.keys()
        assert old_fp not in eng.workspace.keys()
        assert eng.workspace.stats()["evictions"] == 0
        assert eng.stats.refreshes == 1 == eng.stats.refresh_retunes
        x = np.ones(48, np.float32)
        y = eng.submit(res.fingerprint_after, x).result()
        _close(y, ov.to_scipy() @ x.astype(np.float64))

    def test_refresh_equals_reference(self):
        """The same mutations through both engines: the same fingerprints
        before and after, the same keys, the same counters."""
        eng, ov = self._mutated_engine(threshold=0.25)
        jeng = _ref_engine(capacity=4, drift_threshold=0.25)
        jov = jeng.mutable(JM.tridiag(48, seed=0))
        for j in range(6, 42, 4):
            jov.set(0, j, 1.0)
        res, jres = eng.refresh(ov), jeng.refresh(jov)
        assert (res.fingerprint_before, res.fingerprint_after) == (
            jres.fingerprint_before, jres.fingerprint_after)
        assert (res.key_before, res.key_after) == (
            _port_key(jres.key_before), _port_key(jres.key_after))
        assert (res.compacted, res.retuned) == (jres.compacted, jres.retuned)
        assert eng.workspace.keys() == jeng.workspace.keys()
        x = np.random.default_rng(5).standard_normal(48).astype(np.float32)
        _close(eng.submit(res.fingerprint_after, x).result(),
               jeng.submit(jres.fingerprint_after, x).result())

    def test_refresh_is_amortised_across_clean_calls(self):
        eng, ov = self._mutated_engine(threshold=0.25)
        assert eng.refresh(ov).retuned
        res2 = eng.refresh(ov)
        assert not res2.compacted and not res2.retuned
        assert eng.stats.refreshes == 2 and eng.stats.refresh_retunes == 1

    def test_untuned_engine_never_retunes_on_refresh(self):
        eng, ov = self._mutated_engine(threshold=0.0, tune_mode=None)
        res = eng.refresh(ov)
        assert res.compacted and not res.retuned
        x = np.ones(48, np.float32)
        _close(eng.submit(res.fingerprint_after, x).result(),
               ov.to_scipy() @ x.astype(np.float64))

    def test_mutable_admission_counts_like_flush(self):
        eng = _engine(capacity=4)
        A = M.tridiag(32, seed=1)
        eng.mutable(A)
        assert eng.stats.admissions == 1 and eng.stats.cache_misses == 1
        eng.mutable(A)
        assert eng.stats.cache_hits == 1


def test_launch_serve_on_the_host(capsys):
    from repro_torch.launch.serve import main

    main(["--traffic", "churn", "--n", "64", "--requests", "16", "--capacity", "2",
          "--max-batch", "4", "--flush-every", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mix=churn n=64" in out and "warm pool: hit rate" in out
