"""What the kernel A/B scripts share: build versions of one CUDA source side
by side, and time them in rounds that alternate their order.

Used by ``examples/ell_kernel_ab.py``, ``examples/scoo_kernel_ab.py``,
``examples/coo_kernel_ab.py``, ``examples/scs_kernel_ab.py``,
``examples/bsr_kernel_ab.py``, ``examples/bsr_grad_kernel_ab.py`` and
``examples/dia_kernel_ab.py``. The build prints each kernel's registers and
spills as ptxas reports them. Needs a CUDA card and nvcc.
"""
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.kernels import _build  # noqa: E402

ROUNDS, REPS = 8, 20


def build(sources, dirname, entries):
    """One shared library per source in ``build/<dirname>/``, every nvcc
    process started together, with the port's flags; the C ``entries`` a
    library has get their argument types (``entries`` names them, or maps
    each name to its ctypes argument types where the port's table lacks
    it, as for an entry only an older source has). Returns ``{source:
    library}``."""
    out = os.path.join(os.path.dirname(str(_build.BUILD_ROOT)), dirname)
    os.makedirs(out, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        so = os.path.join(out, f"{i}_{os.path.splitext(os.path.basename(src))[0]}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.SRC_DIR),
               src, "-o", so]
        procs.append((src, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
        kernel = None
        for line in log.splitlines():  # ptxas: each kernel's registers and spills
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("registers" in line or "spill" in line):
                print(f"ptxas {src} {kernel}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(so)
        for name in entries:
            if hasattr(lib, name):
                args = entries[name] if isinstance(entries, dict) else _build._SIGNATURES[name]
                getattr(lib, name).argtypes = list(args)
        libs[src] = lib
    return libs


def device_ms(fn, reps=REPS):
    """Device time of one ``fn()`` in ms, every kernel it runs, from
    ``torch.profiler`` over ``reps`` calls: for a kernel shorter than its
    launch, CUDA events around back-to-back launches time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if e.device_type != DeviceType.CPU)
    return us / reps / 1e3


def time_versions(sources, calls, rounds=ROUNDS, reps=REPS):
    """Time ``calls`` (``{(case, source): launch once}``) in ``rounds``
    rounds, the sources in their order and then reversed: per round and
    call, one warm launch and CUDA events around ``reps`` launches; and,
    in every other round, the device time of the call (:func:`device_ms`).
    Prints the card's name and power limit, then the median, min and max
    ms per launch of each call and the median device ms."""
    times = {key: [] for key in calls}
    dev = {key: [] for key in calls}
    for rnd in range(rounds):
        for src in (sources if rnd % 2 == 0 else sources[::-1]):
            for (case, s), fn in calls.items():
                if s != src:
                    continue
                if rnd % 2:
                    dev[(case, s)].append(device_ms(fn))
                fn()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                end.synchronize()
                times[(case, s)].append(start.elapsed_time(end) / reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    for (case, src), t in times.items():
        t, d = sorted(t), sorted(dev[(case, src)])
        print(f"{case} {src}: median_ms={t[len(t) // 2]} min_ms={t[0]} max_ms={t[-1]} "
              f"device_ms={d[len(d) // 2] if d else None}")
