"""The port's roofline models (``repro_torch.roofline``) against the
reference's (``repro.roofline``): the analytic per-device cost of every
(arch x applicable shape) cell at 1, 16, 256 and 512 chips equal as floats,
the SpMV lane and ``model_flops`` equal, twins of the reference's
``tests/test_roofline_dryrun.py`` checks, and the counting mode that takes
the place of XLA's cost analysis and HLO parse: FLOPs of a ``meta`` matmul,
its bytes, and the ``_c10d_functional`` collectives under torch's fake
process group (kinds, bytes, scopes and the wire rule of
``test_collective_parser_kinds_and_scopes``, an all_to_all standing in for
the HLO's collective-permute, which torch has no functional op for).
Also the H100 peaks ``chip_smoke.py`` takes from here, and that the port
imports neither JAX nor the reference and covers its every module."""
import functools
import importlib.util
import pathlib
import re

import pytest
import torch

import repro.configs.base as ref_base
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.roofline import analysis as ref_analysis
from repro.roofline import analytic as ref_analytic
from repro_torch.configs import SHAPES, cell_applicable, get_config, list_archs, shape_by_name
from repro_torch.roofline import analysis, analytic

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHIPS = (1, 16, 256, 512)


@pytest.fixture
def ref_counts_cached(monkeypatch):
    """The reference's parameter counts kept per config (each builds the
    model through ``jax.eval_shape``); the values are the reference's."""
    for name in ("param_count", "active_param_count"):
        monkeypatch.setattr(ref_base.ModelConfig, name,
                            functools.lru_cache(maxsize=None)(getattr(ref_base.ModelConfig, name)))


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_cost_equals_reference(arch, ref_counts_cached):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (rcfg.param_count(), rcfg.active_param_count())
    n = 0
    for shape, rshape in zip(SHAPES, REF_SHAPES):
        assert shape.name == rshape.name
        ok, _ = cell_applicable(cfg, shape)
        if not ok:
            continue
        for chips in CHIPS:
            got = analytic.cost(cfg, shape, chips)
            want = ref_analytic.cost(rcfg, rshape, chips)
            assert got.flops_per_device == want.flops_per_device, (shape.name, chips)
            assert got.hbm_bytes_per_device == want.hbm_bytes_per_device, (shape.name, chips)
            assert got.detail == want.detail, (shape.name, chips)
            n += 1
        assert analytic._cache_bytes(cfg, shape.global_batch, shape.seq_len) == \
            ref_analytic._cache_bytes(rcfg, rshape.global_batch, rshape.seq_len)
        got_mf = analysis.model_flops(cfg, shape, 256)
        assert got_mf == ref_analysis.model_flops(rcfg, rshape, 256)
    assert n >= 3 * len(CHIPS)


@pytest.mark.parametrize("nnz,mbytes,nrows,ncols,bw", [
    (29_791_000, 29_791_000 * 6.0, 1_124_864, 1_124_864, 3.35e12),
    (1_000, 8_000.0, 100, 120, 20e9),
    (0, 0.0, 1, 1, 1e9),
])
def test_spmv_lane_equals_reference(nnz, mbytes, nrows, ncols, bw):
    """The reference's arithmetic at a given bandwidth ("cpu": the latency
    both packages keep)."""
    got = analytic.spmv_roofline(nnz, mbytes, nrows, ncols, "cpu", bw)
    want = ref_analytic.spmv_roofline(nnz, mbytes, nrows, ncols, "cpu", bw)
    assert (got.streamed_bytes, got.time_s, got.gflops, got.bytes_per_nnz) == \
        (want.streamed_bytes, want.time_s, want.gflops, want.bytes_per_nnz)
    assert analytic.spmv_predicted_speedup(mbytes + 1, mbytes / 2, nnz, nrows, ncols, "cpu",
                                           bw) == \
        ref_analytic.spmv_predicted_speedup(mbytes + 1, mbytes / 2, nnz, nrows, ncols, "cpu",
                                            bw)


def test_spmv_lane_takes_the_h100_constants():
    assert analytic.SPMV_BANDWIDTH == {"gpu": 3.35e12, "cpu": 20e9}
    assert analytic.SPMV_BANDWIDTH["gpu"] == analysis.HBM_BW
    assert analytic.SPMV_LATENCY_S["gpu"] == 3.258e-05
    r = analytic.spmv_roofline(1000, 8000.0, 100, 100)  # default platform: the card
    assert r.time_s == 3.258e-05 + (8000.0 + 4.0 * 200) / 3.35e12


def test_analytic_flops_at_least_model_flops():
    """Twin of the reference's: analytic >= 6*N*D (train) for every
    runnable cell."""
    chips = 256
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, _ = cell_applicable(cfg, shape)
            if not ok:
                continue
            ac = analytic.cost(cfg, shape, chips)
            mf = analysis.model_flops(cfg, shape, chips)
            assert ac.flops_per_device >= 0.99 * mf, (arch, shape.name)


def test_decode_memory_dominated_by_cache():
    ac = analytic.cost(get_config("command-r-plus-104b"), shape_by_name("decode_32k"), 256)
    assert ac.detail["b_cache"] > ac.detail["b_param"]


def test_h100_peaks():
    """The data sheet's rates (NVIDIA H100 SXM, 700 W), and the roofline's
    terms over them."""
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert (analysis.F32_FLOPS, analysis.TF32_FLOPS) == (67e12, 495e12)
    assert analysis.TF32X3_FLOPS == 495e12 / 3
    rl = analysis.Roofline(989e12, 3.35e12 * 2, 450e9 * 3, {}, {})
    assert (rl.t_compute, rl.t_memory, rl.t_collective) == (1.0, 2.0, 3.0)
    assert rl.bottleneck == "collective" and rl.t_bound == 3.0


def test_chip_smoke_takes_its_peaks_from_the_roofline():
    """``chip_smoke.py``'s bound rates are the roofline's, equal to the
    literals every ``bound_ms`` of PERF.md was computed with."""
    spec = importlib.util.spec_from_file_location("chip_smoke_peaks", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.HBM_BYTES_PER_S is analysis.HBM_BW and smoke.HBM_BYTES_PER_S == 3.35e12
    assert smoke.F32_FLOPS is analysis.F32_FLOPS and smoke.F32_FLOPS == 67e12
    assert smoke.TF32X3_FLOPS is analysis.TF32X3_FLOPS and smoke.TF32X3_FLOPS == 495e12 / 3
    assert smoke.bound(3.35e12, 1) == (3.35e12 / 3.35e12 * 1e3, "bytes")
    assert smoke.bound(1, 67e12) == (1e3, "operations")


def test_counting_mode_matmul():
    M, K, N = 64, 48, 32
    a = torch.empty(M, K, device="meta")
    b = torch.empty(K, N, dtype=torch.float32, device="meta")
    with analysis.CountingMode() as mode:
        y = a @ b
    assert y.device.type == "meta"
    assert mode.counts.flops == 2 * M * N * K
    assert mode.counts.bytes_accessed == (M * K + K * N + M * N) * 4
    assert mode.counts.collectives.count_by_kind == {}
    rl = analysis.analyze(mode.counts)
    assert rl.flops == 2 * M * N * K and rl.raw_hbm_bytes == (M * K + K * N + M * N) * 4
    assert rl.t_collective == 0.0


def test_counting_mode_views_move_nothing():
    a = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    with analysis.CountingMode() as mode:
        a.t()
        a.view(-1)[:8].view(2, 4).unsqueeze(0)
    assert mode.counts.bytes_accessed == 0 and mode.counts.ops > 0


def test_shape_bytes():
    assert analysis.shape_bytes((128, 256), torch.float32) == 131072
    assert analysis.shape_bytes((8,), torch.bfloat16) == 16
    assert analysis.shape_bytes((), torch.bool) == 1
    assert analysis.tensor_bytes(torch.empty(2, 2, dtype=torch.int64, device="meta")) == 32


@pytest.fixture
def fake_world():
    """torch's ``"fake"`` process group (no peers, no wire), world 4."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist.group.WORLD.group_name
    finally:
        dist.destroy_process_group()


def test_collectives_kinds_and_scopes(fake_world):
    c10d = torch.ops._c10d_functional
    a = torch.empty(128, 256, device="meta")
    p0 = torch.empty(1024, device="meta")
    mode = analysis.CountingMode()
    with mode:
        with mode.body():           # a loop body, traced once for many runs
            ag = c10d.all_gather_into_tensor(a, 4, fake_world)
        ar = c10d.all_reduce(p0, "sum", fake_world)
        a2a = c10d.all_to_all_single(ar, [256] * 4, [256] * 4, fake_world)
        for t in (ag, ar, a2a):
            c10d.wait_tensor(t)
    assert tuple(ag.shape) == (512, 256)
    st = mode.counts.collectives
    assert st.count_by_kind == {"all-gather": 1, "all-reduce": 1, "all-to-all": 1}
    assert st.bytes_by_kind["all-gather"] == 128 * 256 * 4
    assert st.body_bytes == 128 * 256 * 4
    assert st.entry_bytes == 2 * 1024 * 4
    assert st.corrected_bytes(10) == 2 * 1024 * 4 + 10 * 128 * 256 * 4
    # ring wire: all-reduce 2x its operand, all-gather its full result
    assert st.entry_wire == 2 * 1024 * 4 + 1024 * 4
    assert st.body_wire == 512 * 256 * 4
    rl = analysis.analyze(mode.counts, loop_multiplier=10)
    assert rl.collective_bytes == st.corrected_bytes(10)
    assert rl.wire_bytes == st.corrected_wire(10)
    assert rl.raw_collective_bytes == st.total_bytes
    assert rl.t_collective == st.corrected_bytes(10) / 450e9


def test_analyze_without_collective_term():
    counts = analysis.Counts(flops=989e12, bytes_accessed=1, collectives=None)
    rl = analysis.analyze(counts)
    d = rl.to_dict()
    assert rl.t_collective is None and rl.bottleneck == "compute" and rl.t_bound == 1.0
    assert d["collective_bytes_per_device"] is None and d["t_collective_s"] is None
    ref_keys = set(ref_analysis.Roofline(1.0, 1.0, 1.0, {}, {}).to_dict())
    assert set(d) == ref_keys


def test_analyze_takes_the_analytic_cost():
    cfg, shape = get_config("llama3.2-1b"), shape_by_name("train_4k")
    ac = analytic.cost(cfg, shape, 256)
    rl = analysis.analyze(analysis.Counts(flops=7, bytes_accessed=11), analytic=ac)
    assert (rl.flops, rl.hbm_bytes) == (ac.flops_per_device, ac.hbm_bytes_per_device)
    assert (rl.raw_flops, rl.raw_hbm_bytes) == (7.0, 11.0)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_imports_neither_jax_nor_the_reference_and_covers_it():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad
    ref = {p.relative_to(ROOT / "src" / "repro") for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src" / "repro_torch")
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert ref - port == set()
