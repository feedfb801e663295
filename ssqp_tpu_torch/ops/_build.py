"""Build and load the package's CUDA kernels.

The sources under ``ops/csrc/`` are compiled with ``nvcc`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``build/`` at the repository root (or the directory
given to :func:`set_build_dir`); the library's file name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as is. ptxas's report of each kernel's
registers, shared memory and spills (``-Xptxas -v``) is kept beside the
library and returned by :func:`ptxas_report`. Nothing here runs at import
time.
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
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_lib_path = None


def set_build_dir(path) -> Path:
    """Build and cache the kernel library under ``path`` from now on (the
    default is ``build/`` at the repository root). A library already loaded
    in this process stays loaded."""
    global _BUILD
    with _lock:
        _BUILD = Path(path).resolve()
        return _BUILD


def build_dir() -> Path:
    """Where the kernel library is built and cached."""
    return _BUILD


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
        # Vt, vstride, inst, fm, dinv, B, tol2, X, R, rr, C, N, iters, stream
        fn.argtypes = [p, i64, p, p, p, p, p, p, p, p, i32, i32, i32, p]
        fn.restype = i32
    lib.ssqp_cg_tile_rows_f32.argtypes = [i32, i32]  # C, N
    lib.ssqp_cg_tile_rows_f32.restype = i32
    for name in ("ssqp_chol_body_f32", "ssqp_chol_body_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [i32, i32]  # n, K
        fn.restype = ctypes.c_char_p  # the body's name, None on error
    for name in ("ssqp_chol_solve_f32", "ssqp_chol_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i32, i32, i32, p]  # A, RHS, X, B, n, K, stream
        fn.restype = i32


def _run(cmds):
    """Run the commands concurrently; raise with a failed one's output,
    else return their standard error streams joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}\n{err}")
    return "".join(err for _, err in outs)


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed: one nvcc
    process per source, started together, then one link."""
    global _lib, _lib_path
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
                report = _run([[nvcc, *_FLAGS, "-c", "-o", o, str(s)]
                               for s, o in zip(srcs, objs)])
                _report_path(out).write_text(report)
                tmp = str(Path(tmpdir) / out.name)
                _run([[nvcc, *_FLAGS, "-shared", "-o", tmp, *objs]])
                os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        _lib_path = out
        return lib


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report() -> str:
    """ptxas's ``-v`` output from the build of the loaded library ("" when
    the library was built before reports were kept)."""
    if _lib_path is None:
        raise RuntimeError("ptxas_report: the kernel library is not loaded")
    path = _report_path(_lib_path)
    return path.read_text() if path.exists() else ""
