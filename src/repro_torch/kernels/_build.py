"""Build and load the CUDA kernels of ``src/repro_torch/csrc``.

At the first launch of any kernel, every ``csrc/*.cu`` is compiled for
``sm_90a`` by its own ``nvcc`` process (all started together), and the
objects are linked into one shared library with a plain C interface, loaded
with ``ctypes``. The library lands in ``build/repro_torch/<hash>/`` of the
checkout, keyed by a hash of the sources and the flags, so an unchanged
tree builds once. A failed build raises with nvcc's output.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent.parent / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Type codes of the C interface (csrc/common.cuh).
VALUE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}
INDEX_CODES = {"int8": 0, "int16": 1, "int32": 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_dia_spmv": (_P, _P, _P, _P, _P, _I, _LL, _LL, _I, _P),
    "repro_dia_spmv_tiled": (_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _LL, _LL,
                             _LL, _I, _P),
    "repro_scs_spmv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL,
                       _LL, _LL, _I, _I, _P),
}


class KernelLibrary:
    """The loaded shared library and what its build reported."""

    def __init__(self, path: Path, log: str, seconds: float):
        self.path = path
        self.log = log            # nvcc/ptxas output (registers, spills)
        self.seconds = seconds    # build time of this process, 0 when cached
        self.lib = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        self.lib.repro_error_string.argtypes = [ctypes.c_int]
        self.lib.repro_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Launch through ``name``; raise on a non-zero cudaError_t."""
        code = getattr(self.lib, name)(*args)
        if code != 0:
            msg = self.lib.repro_error_string(code).decode()
            raise RuntimeError(f"{name} failed to launch: cudaError {code} ({msg})")


_LOCK = threading.Lock()
_LIBRARY: KernelLibrary | None = None
_BUILD_ERROR: RuntimeError | None = None  # a failed build is not retried per call


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    nvcc = _nvcc()
    cus, _ = _sources()
    procs = []
    for src in cus:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    lib = out_dir / "librepro_torch_kernels.so"
    link = [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{res.stdout}{res.stderr}")
    return "\n".join(log)


def library() -> KernelLibrary:
    """The kernels' library, built on first use (thread- and process-safe:
    a build goes to a fresh directory that is renamed into place)."""
    global _LIBRARY, _BUILD_ERROR
    with _LOCK:
        if _LIBRARY is not None:
            return _LIBRARY
        if _BUILD_ERROR is not None:
            raise _BUILD_ERROR
        try:
            _LIBRARY = _load()
        except RuntimeError as e:
            _BUILD_ERROR = e
            raise
        return _LIBRARY


def _load() -> KernelLibrary:
    final = BUILD_ROOT / source_hash()
    lib_path = final / "librepro_torch_kernels.so"
    t0 = time.perf_counter()
    seconds = 0.0
    if not lib_path.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
        try:
            (tmp / "build.log").write_text(_compile(tmp))
            try:
                os.replace(tmp, final)
            except OSError:  # another process finished the same build first
                pass
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        seconds = time.perf_counter() - t0
    log_path = final / "build.log"
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib_path, log, seconds)
