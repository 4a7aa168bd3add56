"""The serving engine's captured lanes (``repro_torch.serve.CapturedLane``,
the port's form of the reference's jitted ``_mv`` and ``_mm``) on the host.

A CUDA graph needs the card, so here the on-card tests are stubbed
(dispatch's, the engine's and the lanes'), host tensors take the card's
rules (a ``cuda`` entry runs its kernel's plain version), and
``repro_torch.serve.lanes.capture`` is replaced by a stub that records
each capture, warms the lane up once, runs it once more under a
``TorchDispatchMode`` that fails on every host read (the host's proxy for
"the capture will not raise"), and replays by running the lane again into
the static output. On those terms:

  - a lane is captured once per (operator, lane, width, dtype, policy) and
    replayed after that; its graphs die with the warm-pool entry (LRU
    eviction, ``discard``, ``refresh``) and a readmission captures again;
  - a tile runs eagerly, capturing and replaying nothing, while a fault
    plan is armed, under ``check_finite`` and while any key is
    quarantined, as the reference's engine does;
  - a malformed rhs resolves to ``kind="input"`` alone and splits its
    tile; a capture that fails resolves its tile to ``kind="execution"``
    with no eager result;
  - a warm lane of every coalescible format, resident and column-tiled,
    under ``plain`` and ``cuda``, and ``bsr``'s ``mv`` lane, reads nothing
    from the device (``coo`` under ``cuda`` excepted: on host tensors the
    COO kernel's plain version loops over the longest row, a bound it
    reads, on a branch the card never takes; ``kernels/coo_spmv.py``);
  - over the reference engine's traffic the captured engine's results
    agree with ``repro.serve.ServeEngine``'s (its jitted lanes) within
    rtol 2e-4, with equal counters and tiles;
  - ``graph=True`` on a host device, and a lane over host tensors, raise.

The captured lanes themselves run on the card
(``tests/test_torch_serve_graph_cuda.py``, ``-m cuda``).
"""
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.serve as JS

from repro_torch.capture import Captured
from repro_torch.core import DispatchKey, ExecutionPolicy, as_operator, use_backend
from repro_torch.core.formats import DIA
from repro_torch.core import matrices as M
from repro_torch.kernels import ops  # noqa: F401  (registers the cuda backend)
from repro_torch.resilience import FaultPlan
from repro_torch.serve import CapturedLane, ServeEngine, TrafficGenerator, TrafficSpec

tspmv = importlib.import_module("repro_torch.core.spmv")
tengine = importlib.import_module("repro_torch.serve.engine")
tlanes = importlib.import_module("repro_torch.serve.lanes")

COALESCIBLE = ("coo", "csr", "dia", "ell", "sell")
READS = {"_local_scalar_dense", "nonzero", "unique", "_unique", "_unique2", "unique_dim",
         "unique_consecutive"}
CUDA = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
#: ``tests/test_torch_serve.py``'s: the reference's own CPU faults (its
#: dia x pallas caveat) degrade some of its requests, which the port serves
COUNTERS = ("requests", "batches", "admissions", "cache_hits", "cache_misses",
            "tunes", "coalesced_fraction", "batch_size_max")

_N = 96
_S = (M.banded(_N, 3, seed=0) + M.random_uniform(_N, 0.02, seed=1)).tocsr()
_RHS = [np.random.default_rng(10 + i).standard_normal(_N).astype(np.float32)
        for i in range(6)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


class _NoHostRead(TorchDispatchMode):
    """Fails on every operation that hands a device value to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in READS:
            raise AssertionError(f"the captured lane read the device: {func}")
        return func(*args, **(kwargs or {}))


class _Replay:
    """A graph's stand-in: a replay runs the lane again into its output."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        with torch.no_grad():
            self.out.copy_(self.fn())


class CaptureStub:
    """``capture`` on the host: records ``what``, warms up, captures under
    ``_NoHostRead`` (unless ``reads`` is allowed), or raises ``fail``."""

    def __init__(self):
        self.calls, self.reads, self.fail = [], False, None

    def __call__(self, fn, device, what):
        self.calls.append(what)
        if self.fail is not None:
            raise self.fail
        with torch.no_grad():
            fn()
            if self.reads:
                out = fn()
            else:
                with _NoHostRead():
                    out = fn()
        return Captured(_Replay(fn, out), out, 0.0, 0.0, 1, {})


@pytest.fixture
def card(monkeypatch):
    """Host tensors under the card's rules, and the capture stub."""
    stub = CaptureStub()
    monkeypatch.setattr(tspmv, "_on_card", lambda x: True)
    monkeypatch.setattr(tengine, "_on_card", lambda op: True)
    monkeypatch.setattr(tlanes, "_on_card", lambda op: True)
    monkeypatch.setattr(tlanes, "capture", stub)
    return stub


def _engine(graph=True, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("fmt", "csr")
    kw.setdefault("policy", CUDA)
    kw.setdefault("tune_mode", None)
    eng = ServeEngine(device="cpu", graph=False, **kw)
    eng.graph = graph  # the card's default, on host tensors
    return eng


def _serve(eng, rhs, matrix=_S):
    tickets = [eng.submit(matrix, x) for x in rhs]
    eng.flush()
    return tickets


def _close(got, want, rtol=2e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------ capture and replay ----


@pytest.mark.parametrize("fmt", COALESCIBLE)
def test_one_capture_per_key_then_replays_with_the_eager_bits(card, fmt):
    card.reads = fmt == "coo"  # the host's coo/cuda branch reads (module docstring)
    eng, eager = _engine(fmt=fmt, max_batch=4), _engine(graph=False, fmt=fmt, max_batch=4)
    widths = (4, 4, 1, 3, 1, 3)
    got, want = [], []
    for k in widths:
        got += _serve(eng, _RHS[:k])
        want += _serve(eager, _RHS[:k])
    for t, w in zip(got, want):
        assert t.ok and torch.equal(t.result(), w.result())
        assert t.record.coalesced == w.record.coalesced
    # (mm, 4), (mv, 1), (mm, 3): each captured once, every tile a replay
    assert [c.split("(k=")[1] for c in card.calls] == ["4)", "1)", "3)"]
    g = eng.graph_stats()
    assert g["captures"] == 3 and g["live"] == 3 and g["nodes"] == 3
    assert g["replays"] == 6  # four mm tiles, two mv requests
    assert eager.graph_stats() == dict(captures=0, replays=0, capture_s=0.0,
                                       instantiate_s=0.0, nodes=0, live=0)
    out, want = eng.summary(), eager.summary()
    assert {k: out[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}


def test_the_lane_key_holds_dtype_and_policy(card):
    eng = _engine(max_batch=4, policy=None)  # the ambient policy
    _serve(eng, _RHS[:2])
    _serve(eng, [x.astype(np.float64) for x in _RHS[:2]])
    fp = eng.fingerprint(_S)
    op = eng.workspace._ops[fp]
    ambient = op._effective_policy()
    with use_backend("cuda"):
        _serve(eng, _RHS[:2])
        scoped = op._effective_policy()
    assert scoped != ambient
    assert set(eng.workspace.lanes(fp, op)) == {
        ("mm", 2, torch.float32, ambient), ("mm", 2, torch.float64, ambient),
        ("mm", 2, torch.float32, scoped)}
    # a tile of mixed dtypes takes the promoted dtype's lane, as torch.stack does
    eager = _engine(graph=False, max_batch=4, policy=None)
    mixed = [_RHS[0], _RHS[1].astype(np.float64)]
    for t, w in zip(_serve(eng, mixed), _serve(eager, mixed)):
        assert torch.equal(t.result(), w.result())
    assert eng.graph_stats()["captures"] == 3  # the float64 lane served it


def test_bsr_serves_through_the_mv_lane(card):
    eng, eager = _engine(fmt="bsr", max_batch=4), _engine(graph=False, fmt="bsr", max_batch=4)
    got, want = _serve(eng, _RHS[:3]), _serve(eager, _RHS[:3])
    for t, w in zip(got, want):
        assert not t.record.coalesced and torch.equal(t.result(), w.result())
    assert len(card.calls) == 1 and "mv lane of a bsr operator" in card.calls[0]
    assert eng.graph_stats()["replays"] == 3


# -------------------------------------------------- lanes die with entries ----


def test_lanes_die_on_eviction_and_a_readmission_captures_again(card):
    eng = _engine(capacity=1, max_batch=4)
    other = M.tridiag(_N, seed=4)
    _serve(eng, _RHS[:2])
    assert eng.graph_stats()["live"] == 1
    lanes = eng.workspace.lanes(eng.fingerprint(_S), eng.workspace._ops[eng.fingerprint(_S)])
    _serve(eng, _RHS[:2], other)  # evicts _S
    assert not lanes and eng.graph_stats()["live"] == 1
    assert eng.workspace.stats()["evictions"] == 1
    _serve(eng, _RHS[:2])  # readmitted: captured again
    assert eng.graph_stats()["captures"] == 3 and eng.graph_stats()["live"] == 1


def test_lanes_die_on_discard_and_on_a_replacing_insert(card):
    eng = _engine(capacity=4, max_batch=4)
    _serve(eng, _RHS[:2])
    fp = eng.fingerprint(_S)
    held = eng.workspace._ops[fp]
    eng.workspace.insert(fp, held)  # the same entry: its lanes stay
    assert eng.graph_stats()["live"] == 1
    eng.workspace.insert(fp, as_operator(_S, "csr", policy=CUDA, device="cpu"))
    assert eng.graph_stats()["live"] == 0
    assert eng.workspace.lanes(fp, held) == {}  # not the entry: nothing kept
    _serve(eng, _RHS[:2])
    assert eng.graph_stats()["live"] == 1
    assert eng.workspace.discard(fp) and eng.graph_stats()["live"] == 0


def test_refresh_releases_the_old_fingerprints_lanes(card):
    eng = _engine(capacity=4, max_batch=4)
    A = M.banded(_N, 3, seed=2)
    _serve(eng, _RHS[:3], A)
    ov = eng.mutable(A)
    ov.set_many(np.arange(0, 60, 3), np.arange(30, 90, 3), np.ones(20))
    res = eng.refresh(ov)
    assert res.fingerprint_after != res.fingerprint_before == eng.fingerprint(A)
    assert eng.graph_stats()["live"] == 0
    got = [eng.submit(res.fingerprint_after, x) for x in _RHS[:3]]
    eng.flush()
    for t, x in zip(got, _RHS[:3]):
        assert torch.equal(t.result(), res.operator @ torch.from_numpy(x))
    assert eng.graph_stats()["captures"] == 2 and eng.graph_stats()["live"] == 1


# ------------------------------------------------- the reference's eager rule ----


def _arm(kind, eng):
    if kind == "plan":
        return FaultPlan([])
    if kind == "quarantine":
        # a key this tile does not run: the tile is not degraded, only eager
        for _ in range(eng.health.failure_threshold):
            eng.health.record_failure(DispatchKey("bsr", "cuda"))
        assert eng.health.any_quarantined()
    import contextlib

    return contextlib.nullcontext()


@pytest.mark.parametrize("kind", ["plan", "check_finite", "quarantine"])
def test_eager_while_a_plan_is_armed_under_check_finite_and_quarantine(card, kind):
    eng = _engine(max_batch=4, check_finite=kind == "check_finite")
    eager = _engine(graph=False, max_batch=4)
    with _arm(kind, eng):
        got = _serve(eng, _RHS[:3]) + _serve(eng, _RHS[3:4])
    want = _serve(eager, _RHS[:3]) + _serve(eager, _RHS[3:4])
    for t, w in zip(got, want):
        assert t.ok and not t.record.degraded and torch.equal(t.result(), w.result())
    assert card.calls == [] and eng.graph_stats()["replays"] == 0
    assert got[0].record.coalesced
    # back to health: the captured lanes take over
    if kind != "check_finite":
        eng.health.reset()
        _serve(eng, _RHS[:3])
        assert eng.graph_stats()["replays"] == 1


# -------------------------------------------------------------- failures ----


@pytest.mark.parametrize("bad", ["short", "matrix"])
def test_a_malformed_rhs_resolves_to_input_alone(card, bad):
    eng = _engine(max_batch=4)
    poison = _RHS[1][:-1] if bad == "short" else np.stack([_RHS[1], _RHS[1]], 1)
    tickets = _serve(eng, [_RHS[0], poison, _RHS[2]])
    good = [tickets[0], tickets[2]]
    assert all(t.ok for t in good) and not tickets[1].ok
    assert tickets[1].error.kind == "input"
    assert eng.stats.batch_splits == 1 and eng.stats.error_kinds == {"input": 1}
    ref = as_operator(_S, "csr", policy=CUDA, device="cpu")
    for t, x in zip(good, (_RHS[0], _RHS[2])):
        assert torch.equal(t.result(), ref @ torch.from_numpy(x))
    # the split served the good requests through the mv lane, not eagerly
    assert [c.split("(k=")[1] for c in card.calls] == ["1)"]
    assert eng.graph_stats()["replays"] == 2


@pytest.mark.parametrize("width", [1, 3])
def test_a_failed_capture_resolves_to_execution_with_no_eager_result(card, width, monkeypatch):
    eng = _engine(max_batch=4)
    card.fail = RuntimeError("capturing the lane in a CUDA graph failed: a host read")
    eager_calls = []
    monkeypatch.setattr(eng, "_serve_one", lambda *a: eager_calls.append(a))
    tickets = _serve(eng, _RHS[:width])
    assert all(not t.ok and t.error.kind == "execution" for t in tickets)
    assert "host read" in str(tickets[0].error)
    assert eager_calls == [] and eng.stats.retries == 0 and eng.stats.batch_splits == 0
    assert DispatchKey("csr", "cuda") in eng._failed_on_card
    assert eng.graph_stats()["live"] == 0


# ----------------------------------------------------------- host reads ----


NO_READ = [(fmt, tiled, backend) for fmt in COALESCIBLE + ("bsr",)
           for tiled in (False, True) for backend in ("plain", "cuda")
           if not (fmt == "coo" and backend == "cuda") and not (fmt == "bsr" and tiled)]


@pytest.mark.parametrize("fmt,tiled,backend", NO_READ,
                         ids=["-".join((f, "tiled" if t else "resident", b))
                              for f, t, b in NO_READ])
def test_a_warm_lane_reads_nothing_from_the_device(monkeypatch, fmt, tiled, backend):
    """The stub captures each lane under ``_NoHostRead`` after its warm-up;
    a 48-column limit gives the plan-carrying formats their tiled plans."""
    stub = CaptureStub()
    monkeypatch.setattr(tlanes, "_on_card", lambda op: True)
    monkeypatch.setattr(tlanes, "capture", stub)
    kw = {"max_resident_cols": 48} if tiled else {}
    op = as_operator(_S, fmt, policy=ExecutionPolicy(backends=(backend,),
                                                     allow_fallback=False, **kw),
                     device="cpu")
    if tiled and fmt in ("coo", "dia", "ell"):
        assert op.container.plan is not None and op.container.plan.kind.endswith("-cols")
    xs = [torch.from_numpy(x) for x in _RHS[:4]]
    for lane, k in (("mv", 1), ("mm", 4)) if fmt != "bsr" else (("mv", 1),):
        got = CapturedLane(op, lane, k, torch.float32)(xs[:k])
        want = op @ xs[0] if lane == "mv" else op.batched_matvec(torch.stack(xs))
        assert torch.equal(got, want)
    assert len(stub.calls) == (1 if fmt == "bsr" else 2)


def test_a_dia_container_without_its_extent_reads_it_once(monkeypatch):
    """A DIA built directly (no ``to_dia``) has no recorded extent: the
    cuda predicate reads it from the offsets at the warm-up, never again."""
    stub = CaptureStub()
    monkeypatch.setattr(tlanes, "_on_card", lambda op: True)
    monkeypatch.setattr(tlanes, "capture", stub)
    built = as_operator(_S, "dia", device="cpu").container
    bare = DIA(built.offsets, built.data, built.shape)
    assert bare.extent is None
    op = as_operator(bare, policy=CUDA, device="cpu")
    x = torch.from_numpy(_RHS[0])
    assert torch.equal(CapturedLane(op, "mv", 1, torch.float32)([x]),
                       as_operator(_S, "dia", policy=CUDA, device="cpu") @ x)
    assert bare.cache["extent"] == int(built.offsets.abs().max())


# ---------------------------------------------------- against the reference ----


@pytest.mark.parametrize("tune_mode", [None, "predict"], ids=["untuned", "predict"])
@pytest.mark.parametrize("mix", ["hot", "churn"])
def test_results_equal_the_reference_engines(card, mix, tune_mode):
    """The reference's jitted lanes against the port's captured ones on the
    same seeded traffic (``tests/test_torch_serve.py``'s spec)."""
    card.reads = True  # a predicted coo/cuda tenant takes the host's reading branch
    spec = dict(mix=mix, n=48, n_matrices=5, seed=3)
    kw = dict(capacity=2, max_batch=4, tune_mode=tune_mode)
    eng = _engine(policy=None, **kw)
    jeng = JS.ServeEngine(clock=FakeClock(), **kw)
    mine, ref = [], []
    reqs = zip(TrafficGenerator(TrafficSpec(**spec)).requests(18),
               JS.TrafficGenerator(JS.TrafficSpec(**spec)).requests(18))
    for i, ((_, a, x), (_, b, y)) in enumerate(reqs):
        mine.append(eng.submit(a, x))
        ref.append(jeng.submit(b, y))
        if (i + 1) % 7 == 0:
            eng.flush()
            jeng.flush()
    eng.flush()
    jeng.flush()
    out, jout = eng.summary(), jeng.summary()
    assert {k: out[k] for k in COUNTERS} == {k: jout[k] for k in COUNTERS}
    for t, jt in zip(mine, ref):
        assert t.ok and jt.ok
        assert (t.record.coalesced, t.record.batch_size) == (jt.record.coalesced,
                                                              jt.record.batch_size)
        _close(t.result(), np.asarray(jt.result()))
    g = eng.graph_stats()
    assert g["replays"] == sum(1 if b.coalesced else b.size for b in eng.stats.batches)
    assert 0 < g["captures"] <= g["replays"]


# ---------------------------------------------------------------- host ----


def test_graph_true_on_a_host_device_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        ServeEngine(device="cpu", graph=True)
    assert not ServeEngine(device="cpu").graph
    assert not ServeEngine(device="cpu", graph=False).graph


def test_a_lane_over_host_tensors_raises():
    op = as_operator(_S, "csr", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedLane(op, "mv", 1, torch.float32)
    with pytest.raises(ValueError, match="lane"):
        CapturedLane(op, "mt", 1, torch.float32)


def test_launch_serve_traffic_prints_the_lanes_counters(capsys):
    from repro_torch.launch.serve import main

    main(["--traffic", "hot", "--n", "64", "--requests", "8", "--max-batch", "4",
          "--flush-every", "4", "--device", "cpu", "--no-graph"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("graph lanes: off captures=0 replays=0")
    assert lines[1].startswith("mix=hot n=64")
    with pytest.raises(ValueError, match="CUDA device"):
        main(["--traffic", "hot", "--n", "64", "--requests", "4", "--device", "cpu",
              "--graph"])
