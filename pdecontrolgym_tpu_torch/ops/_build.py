"""Build and load the package's CUDA kernels at first use.

The sources under ``csrc/`` are compiled with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``. The library is cached in
``pdecontrolgym_tpu_torch/_build/`` under a name keyed by a hash of the sources
and the flags, written to a temporary name and renamed into place, so
concurrent first uses do not see a half-written file and a changed source is
never served a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "interval1d.cu",)
BUILD_DIR = _PKG / "_build"
# -fmad=false: no FMA contraction, so the kernel rounds as the plain PyTorch
# version does (see csrc/interval1d.cu, point 4)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
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
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpdecg_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no build of the current sources exists; return
    the library's path. ``verbose`` adds ``-Xptxas -v`` to a fresh build and
    prints the compiler's report (registers, spills)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.interval1d_launch.argtypes = [
            i, i,  # body, neumann
            p, p, p, p,  # u, beta, ctrl, t0
            p, p, p, p,  # u_out, norms, bsum, t_out
            i, i, i, i, i,  # B, nx, S, nt, Wp
            ctypes.POINTER(ctypes.c_int), i,  # positions, n_pos
            f, f, f, f,  # c0..c3
            i, p,  # device, stream
        ]
        lib.interval1d_launch.restype = ctypes.c_int
        lib.interval1d_error_string.argtypes = [ctypes.c_int]
        lib.interval1d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
