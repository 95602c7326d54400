"""Build and load the package's CUDA kernels at first use.

The sources under ``csrc/`` are compiled with ``nvcc``, one process for each
source and all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library is cached in
``pdecontrolgym_tpu_torch/_build/`` under a name keyed by a hash of the
sources, the headers and the flags, written to a temporary name and renamed
into place, so concurrent first uses do not see a half-written file and a
changed source is never served a stale build.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (
    _PKG / "csrc" / "interval1d.cu",
    _PKG / "csrc" / "interval1d_pcr.cu",
    _PKG / "csrc" / "ns_fused.cu",
)
HEADERS = (_PKG / "csrc" / "interval1d_common.cuh",)
BUILD_DIR = _PKG / "_build"
# -fmad=false: no FMA contraction, so the kernels round as the plain PyTorch
# version does (see csrc/interval1d.cu, point 4). Division and square root stay
# IEEE (no -use_fast_math). One flag set serves every source: csrc/ns_fused.cu
# keeps it for its stencil passes and calls fmaf by name in its products.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the CUDA "
        "kernels of pdecontrolgym_tpu_torch are built from source at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpdecg_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no build of the current sources exists; return
    the library's path. ``verbose`` adds ``-Xptxas -v`` to a fresh build and
    prints the compiler's report (registers, shared memory, spills)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    report = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp, contextlib.ExitStack() as logs:
        # one compiler process for each source, all started together; each
        # writes its messages to a file, so none waits on a full pipe
        jobs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *report, "-c", "-o", obj, str(src)]
            log = logs.enter_context(open(obj + ".log", "w+"))
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failures = []
        for cmd, _obj, log, proc in jobs:
            returncode = proc.wait()
            log.seek(0)
            messages = log.read()
            if returncode != 0:
                failures.append((cmd, returncode, messages))
            elif verbose:
                print(messages, end="")
        for failure in failures:
            _raise_if_failed(*failure)
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _, _ in jobs)]
        linked = subprocess.run(link, capture_output=True, text=True)
        _raise_if_failed(link, linked.returncode, linked.stdout + linked.stderr)
        os.replace(lib, out)
    return out


def _raise_if_failed(cmd, returncode, messages):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{messages}")


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        common = [
            p, p, p, p,  # u, beta, ctrl, t0
            p, p, p, p,  # u_out, norms, bsum, t_out
            i, i, i, i, i,  # B, nx, S, nt, Wp
            ctypes.POINTER(ctypes.c_int), i,  # positions, n_pos
        ]
        tail = [i, p]  # device, stream
        # body, neumann, c0..c3
        lib.interval1d_launch.argtypes = common + [i, i, f, f, f, f] + tail
        lib.interval1d_launch.restype = ctypes.c_int
        # neumann, has_eb, dt, 2F, th, -th*F, 1-th, (1-th)*F, dx
        lib.interval1d_pcr_launch.argtypes = common + [i, i] + [f] * 7 + tail
        lib.interval1d_pcr_launch.restype = ctypes.c_int
        # u, v, act, consts, uref, vref, u_out, v_out, p_out, tsum; B, ny, nx,
        # np, ld, prec; bc; 0.5/dx, 0.5/dy, 1/(dx*dy), dt, nu, -dx*dy*rho/dt, dt/rho
        lib.ns_fused_launch.argtypes = (
            [p] * 10 + [i] * 6 + [ctypes.POINTER(ctypes.c_int)] + [f] * 7 + tail)
        lib.ns_fused_launch.restype = ctypes.c_int
        lib.interval1d_error_string.argtypes = [ctypes.c_int]
        lib.interval1d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
