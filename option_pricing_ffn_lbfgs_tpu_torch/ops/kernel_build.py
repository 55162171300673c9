"""Build and load the port's CUDA kernels (nvcc into plain-C shared objects).

Each ``csrc/<name>.cu`` compiles, at first use, into
``_build/lib<name>.so`` inside the package (git-ignored), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

plus a file's own flags from ``FILE_FLAGS`` (``lbfgs_trip.cu`` and
``lm_trip.cu``, the L-BFGS and LM trips, are built with ``-fmad=false`` so
that their decisions round as eager PyTorch's ``a * b + c`` does), and is
loaded with ``ctypes``. No
PyTorch header is included, so a build takes seconds rather than minutes,
and no ``--use_fast_math``: the float64 kernels need the accurate
exp/log/sin/cos/atan2. A library is rebuilt when
any file in ``csrc/`` is newer than it. ptxas' register/spill report of the
last build of ``<name>`` is kept in ``_build/<name>.log``.

Nothing here runs at import time: the CPU-only test environment imports
every module but never builds.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FILE_FLAGS = {"lbfgs_trip": ["-fmad=false"], "lm_trip": ["-fmad=false"]}

_LIBS = {}
_ENTRIES = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _stale(name: str) -> bool:
    so = BUILD / f"lib{name}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return so.stat().st_mtime < newest


def _start(name: str):
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *FILE_FLAGS.get(name, ()), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(*names: str) -> float:
    """Compile the named kernels that are missing or stale, in parallel.
    Returns the wall seconds spent; raises if nvcc fails."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names if _stale(n)}
    for name, (proc, tmp) in jobs.items():
        log = proc.communicate()[0]
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, BUILD / f"lib{name}.so")
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
    return _LIBS[name]


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, bound once with
    ``argtypes`` and an ``int`` (cudaError_t) result."""
    if (name, symbol) not in _ENTRIES:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name, symbol] = fn
    return _ENTRIES[name, symbol]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
