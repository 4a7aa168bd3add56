"""The port's twins of the reference's examples (``examples/*_torch.py``)
and ``run_hpcg``'s ``graph`` default, on the CPU.

  - ``examples/quickstart_torch.py``, ``dynamic_fdm_torch.py`` and
    ``chaos_serve_torch.py`` run to exit 0 with ``--device cpu``, each in a
    subprocess with a timeout, beside the reference's example run the same
    way (``JAX_PLATFORMS=cpu``). The host-side numbers they print equal the
    reference's, its ``pallas`` backend named ``cuda`` in the port:
    quickstart's matrices, conversions, the three backends' ``|y|`` and the
    workspace's counts (the tuner's picks are timings: not compared);
    dynamic_fdm's whole trajectory (the mutations and drift at each step,
    the step at which ``refresh`` re-tunes, the summary); chaos_serve's
    injected faults, the breaker's timeline (quarantine, probe, recover on
    ``csr/cuda``) and every request served (availability 100%, no error).
    The port's chaos run trips its breaker one batch sooner than the
    reference's: its SpMM falls to one SpMV dispatch a column, each of
    which the fault plan may claim, where the reference's vmapped SpMV
    claims one a tile; the test does not hold the per-batch lanes.
  - ``run_hpcg`` and ``run_hpcg_distributed`` with no ``graph`` argument run
    eagerly on the host (``HPCGResult.graph`` False) and give
    ``graph=False``'s iterations and residual bits; ``graph=True`` there
    still raises; ``graph=None`` resolves captured on one CUDA device only.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.apps.hpcg import _resolve_graph, run_hpcg, run_hpcg_distributed
from repro_torch.core import PartMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _run(script, *args, reference=False):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    extra = () if reference else ("--device", "cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args, *extra],
                       env=env, capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO)
    assert r.returncode == 0, f"{script}:\nSTDOUT:{r.stdout[-3000:]}\nSTDERR:{r.stderr[-3000:]}"
    return r.stdout


def _port_names(text: str) -> str:
    return text.replace("pallas", "cuda")


def _lines(out: str, start: str, stop: str) -> list:
    """The lines of ``out`` from the section headed ``start`` up to ``stop``,
    each with its runs of blanks made one (a backend's name is padded to
    its width)."""
    body = out.split(start, 1)[1].split(stop, 1)[0]
    return [" ".join(ln.split()) for ln in body.strip().splitlines()]


def test_quickstart_twin_prints_the_reference_numbers():
    got, want = _run("quickstart_torch.py"), _run("quickstart.py", reference=True)
    for start, stop in (("== 1.", "== 2."), ("== 2.", "== 3."), ("== 3.", "== 4.")):
        assert _lines(got, start, stop) == _lines(_port_names(want), start, stop)
    assert _lines(got, "== 5.", "\n\n") == _lines(want, "== 5.", "\n\n")
    tuned = _lines(got, "== 4.", "== 5.")
    assert len(tuned) == 4 and all(re.search(r"-> \w+/(plain|dense|cuda) \(", ln)
                                   for ln in tuned[1:])


@pytest.mark.parametrize("args", [(), ("--grid", "5", "--steps", "6", "--threshold", "0.1")],
                         ids=["defaults", "grid5-threshold0.1"])
def test_dynamic_fdm_twin_gives_the_reference_trajectory(args):
    got = _run("dynamic_fdm_torch.py", *args)
    want = _port_names(_run("dynamic_fdm.py", *args, reference=True))
    assert got == want
    assert "RETUNED" in got and "MISMATCH" not in got


def _timeline(out: str) -> list:
    """``[event, key]`` of each line of the breaker's timeline (its times
    are the run's own)."""
    return [ln.split()[-2:] for ln in _lines(out, "== breaker event timeline ==",
                                             "availability=")]


def test_chaos_serve_twin_gives_the_reference_timeline_and_full_success():
    got, want = _run("chaos_serve_torch.py"), _port_names(_run("chaos_serve.py", reference=True))
    assert _timeline(got) == _timeline(want) == [["quarantine", "csr/cuda"],
                                                 ["probe", "csr/cuda"],
                                                 ["recover", "csr/cuda"]]
    injected = [ln.split("injected: ", 1)[1] for ln in got.splitlines() if "injected:" in ln]
    assert injected == [ln.split("injected: ", 1)[1] for ln in want.splitlines()
                        if "injected:" in ln]
    served = [ln.split(": ", 1)[1].split(",")[0] for ln in got.splitlines() if " batch " in ln]
    assert served == ["4/4 ok"] * 7
    summary = {k: v for k, v in re.findall(r"(\w+)=(\S+)", got.split("availability", 1)[1])}
    want_summary = {k: v for k, v in re.findall(r"(\w+)=(\S+)", want.split("availability", 1)[1])}
    assert got.split("availability=", 1)[1].split()[0] == "100%"
    for k in ("served", "errors", "retries"):
        assert summary[k] == want_summary[k], k
    assert got.strip().endswith("every request served; cuda lane recovered.")


# ------------------------------------------------- run_hpcg's graph default


def test_run_hpcg_default_graph_is_eager_on_the_host():
    auto = run_hpcg(8, 8, 8, device="cpu", timed=False, verbose=False)
    eager = run_hpcg(8, 8, 8, device="cpu", timed=False, verbose=False, graph=False)
    assert auto.graph is False and auto.conv_graphs == {} and auto.graphs == {}
    assert auto.pcg_iters == eager.pcg_iters and auto.rel_res == eager.rel_res
    assert auto.valid and auto.bitwise and auto.chosen and eager.chosen


def test_run_hpcg_default_graph_times_the_eager_loop_on_the_host():
    res = run_hpcg(8, 8, 8, device="cpu", reps=1, verbose=False,
                   candidates=[("csr", "plain"), ("dia", "plain")])
    assert res.graph is False and res.valid and res.ref_time_s > 0 and res.opt_time_s > 0
    assert res.ref_eager_s == res.ref_time_s and not res.graph_equal


def test_run_hpcg_distributed_default_graph_is_eager_on_a_host_mesh():
    mesh = PartMesh.on("cpu", parts=2)
    auto = run_hpcg_distributed(mesh, 8, 8, 8, timed=False, verbose=False)
    eager = run_hpcg_distributed(mesh, 8, 8, 8, timed=False, verbose=False, graph=False)
    assert auto.graph is False and auto.conv_graphs == {}
    assert auto.pcg_iters == eager.pcg_iters and auto.rel_res == eager.rel_res
    assert auto.valid and auto.bitwise


def test_run_hpcg_graph_true_still_raises_on_the_host():
    with pytest.raises(ValueError, match="graph=True .* CUDA device"):
        run_hpcg(8, 8, 8, device="cpu", timed=False, verbose=False, graph=True)
    with pytest.raises(ValueError, match="graph=True .* CUDA device"):
        run_hpcg_distributed(PartMesh.on("cpu", parts=2), 8, 8, 8, timed=False,
                             verbose=False, graph=True)


CUDA0, CUDA1, CPU = torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cpu")


@pytest.mark.parametrize("devices,want", [((CUDA0,), True), ((CUDA0, CUDA0), True),
                                          ((CUDA0, CUDA1), False), ((CPU,), False),
                                          ((CPU, CPU), False)],
                         ids=["card", "parts-of-one-card", "two-cards", "host", "host-parts"])
def test_graph_none_resolves_by_device(devices, want):
    assert _resolve_graph(None, devices) is want
    assert _resolve_graph(False, devices) is False
    if want:
        assert _resolve_graph(True, devices) is True
    else:
        with pytest.raises(ValueError, match="graph=True"):
            _resolve_graph(True, devices)
