"""Draw the selector's ``"cuda"`` cost lines for the SCS and BSR keys from a
``chip_smoke.py`` result file.

  python examples/cuda_cost_lines.py [chiprun_out/chip_smoke.json]

Each line is ``a + c * kentries`` (``core/select.py``, ``COST["cuda"]``):
``a`` is the host time of one call, the CUDA-event ms minus the kernel's
profiler ms (one reading, which moves by tens of µs between runs; a line
whose wrapper did not change may keep its earlier ``a``), and ``c`` the
device time per thousand stored entries at
int32/f32 width (the kernel's µs over ``storage_entries / 1e3`` times the
plan's bytes-per-entry ratio, as ``estimate_us`` scales it). The keys and
their measurements: ``csr``/``sell`` ``tiled`` from ``scs_spmv`` on the
HPCG 104^3 plan, ``resident`` from 52^3, ``bsr`` ``block`` from
``bsr_spmm`` at one column on ``block_random(65536, 32, 16/2048)``.
Runs on the CPU: it rebuilds each matrix's features, not its kernels.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import matrices as M  # noqa: E402
from repro_torch.core.features import extract_features  # noqa: E402
from repro_torch.core.select import DEFAULT_POLICY, storage_bytes, storage_entries  # noqa: E402
from repro_torch.core.select import _UNCOMPRESSED  # noqa: E402


def line(rec, s, fmt, strategy):
    f = extract_features(s)
    ratio = (storage_bytes(f, fmt, DEFAULT_POLICY, strategy)
             / storage_bytes(f, fmt, _UNCOMPRESSED, strategy))
    a = (rec["ms"] - rec["kernel_ms"]) * 1e3
    c = rec["kernel_ms"] * 1e3 / (storage_entries(f, fmt) / 1e3 * ratio)
    return round(a, 2), c


def main(path):
    res = json.load(open(path))["results"]
    fine, coarse = M.fdm27(104, 104, 104), M.fdm27(52, 52, 52)
    block = M.block_random(65536, 32, block_density=16 / 2048, seed=0)
    for fmt in ("csr", "sell"):
        for strategy, s, name in (("resident", coarse, "scs_spmv_coarse"),
                                  ("tiled", fine, "scs_spmv_finest")):
            a, c = line(res[name], s, fmt, strategy)
            print(f'("{fmt}", "cuda", "{strategy}"): ({a}, 0.0, {c:.6g}, 0.0),')
    a, c = line(res["bsr_spmm_nf1"], block, "bsr", "block")
    print(f'("bsr", "cuda", "block"): ({a}, 0.0, {c:.6g}, 0.0),')


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/chip_smoke.json")
