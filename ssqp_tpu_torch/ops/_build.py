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
_SOURCES = ("cg.cu", "chol.cu")
# No --use_fast_math: it approximates divisions and flushes denormals,
# which breaks the 1e-30 and finfo.tiny floors the solver relies on.
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

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
    for name in ("ssqp_chol_fits_smem_f32", "ssqp_chol_fits_smem_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [i32, i32]  # n, K
        fn.restype = i32
    for name in ("ssqp_chol_solve_f32", "ssqp_chol_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, i32, i32, i32, i32, p]  # A, X, B, n, K, smem, stream
        fn.restype = i32


def _run(cmds):
    """Run the commands concurrently; raise with a failed one's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}\n{err}")


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed: one nvcc
    process per source, started together, then one link."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [_CSRC / s for s in _SOURCES]
        h = hashlib.sha256(" ".join(_FLAGS + ("-shared",)).encode())
        for s in srcs:
            h.update(s.read_bytes())
        out = _BUILD / f"libssqp_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
                objs = [str(Path(tmpdir) / (s.stem + ".o")) for s in srcs]
                _run([[nvcc, *_FLAGS, "-c", "-o", o, str(s)]
                      for s, o in zip(srcs, objs)])
                tmp = str(Path(tmpdir) / out.name)
                _run([[nvcc, *_FLAGS, "-shared", "-o", tmp, *objs]])
                os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib
