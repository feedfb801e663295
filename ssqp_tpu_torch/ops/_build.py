"""Build and load the package's CUDA kernels.

The sources under ``ops/csrc/`` are compiled with ``nvcc`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``build/`` at the repository root; the library's file
name carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = _CSRC.parents[2] / "build"  # listed in .gitignore
_SOURCES = ("cg.cu",)
# No --use_fast_math: it approximates divisions and flushes denormals,
# which breaks the 1e-30 and finfo.tiny floors the solver relies on.
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH or under /usr/local/cuda)")


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("ssqp_cg_rows_f32", "ssqp_cg_rows_f64"):
        fn = getattr(lib, name)
        # Vt, vstride, inst, fm, dinv, B, tol2, X, rr, C, N, iters, stream
        fn.argtypes = [p, i64, p, p, p, p, p, p, p, i32, i32, i32, p]
        fn.restype = i32


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [_CSRC / s for s in _SOURCES]
        h = hashlib.sha256(" ".join(_FLAGS).encode())
        for s in srcs:
            h.update(s.read_bytes())
        out = _BUILD / f"libssqp_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            cmd = [_nvcc(), *_FLAGS, "-o", tmp, *map(str, srcs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib
