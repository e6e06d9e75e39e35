"""Build and load the CUDA kernels: one ``nvcc -c`` per source (a source of
``PARTS`` once for each of its parts), all started together, then one link
into a shared library with a plain C interface, loaded through ``ctypes``.

The library is built at first use into ``kernels/_build/``, named by a hash
of the sources and the flags, so a changed source builds anew and an
unchanged one loads the library already there.  Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("stencil.cu", "fused.cu", "fused_resident.cu", "fused_kskip.cu", "fused_kskip_resident.cu")
HEADERS = ("stencil.cuh", "reduce.cuh", "resident.cuh")
# sources compiled once for each of their parts (-DKSKIP_PART=p), each
# part holding some of the kernel instances, so that no one nvcc holds the
# build up
PARTS = {"fused_kskip_resident.cu": 4}
MAX_TERMS = 16  # most stencil terms the kernels take (KRYLOV_MAX_TERMS)
# compile flags of every source; the link adds -shared
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", f"-DKRYLOV_MAX_TERMS={MAX_TERMS}",
)

_lib = None
build_seconds = None  # wall time of the build (or load) that made _lib


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    return h.hexdigest()[:16]


def _run(cmds) -> None:
    """Run the commands at once; raise with the output of the first that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError(failed[0])


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [(s, [], f"{Path(s).stem}.o") for s in SOURCES if s not in PARTS]
        units += [(s, [f"-DKSKIP_PART={p}"], f"{Path(s).stem}_{p}.o") for s, n in PARTS.items() for p in range(n)]
        objs = [str(Path(tmp) / o) for _, _, o in units]
        _run([nvcc(), *FLAGS, *defs, "-c", "-o", o, str(_CSRC / s)] for (s, defs, _), o in zip(units, objs))
        lib = str(Path(tmp) / "lib.so")
        _run([[nvcc(), *FLAGS[:2], "-shared", "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    geom = [i, i, i, i, i, p]  # ns, g0, g1, g2, is_const, disp
    lib.krylov_stencil2d.argtypes = [i, p, p, p, i, p, p]  # dtype, coef, x, y, batch, params, stream
    lib.krylov_stencil2d.restype = i
    lib.krylov_fused_workspace.argtypes = [
        i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.krylov_fused_workspace.restype = i
    lib.krylov_fused_solve.argtypes = [i, i, i, p, p, p, p, p, p, p, p, *geom, i, i, p]
    lib.krylov_fused_solve.restype = i
    lib.krylov_resident_solve.argtypes = [i, i, i, i, i, i, i, p, p, p, p, p, p, p, p, *geom, i, i, p]
    lib.krylov_resident_solve.restype = i
    lib.krylov_sync_probe.argtypes = [i, i, i, i, p, p]
    lib.krylov_sync_probe.restype = i
    lib.krylov_kskip_workspace.argtypes = [
        i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i),
    ]
    lib.krylov_kskip_workspace.restype = i
    lib.krylov_kskip_solve.argtypes = [i, i, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p, *geom, i, i, p]
    lib.krylov_kskip_solve.restype = i
    lib.krylov_kskip_resident_solve.argtypes = [i] * 10 + [p] * 10 + [*geom, i, i, p]
    lib.krylov_kskip_resident_solve.restype = i
    lib.krylov_kskip_probe.argtypes = [i] * 7 + [p, p, p]
    lib.krylov_kskip_probe.restype = i
    lib.krylov_error_string.argtypes = [i]
    lib.krylov_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        path = BUILD_DIR / f"libkrylov_kernels_{_digest()}.so"
        if not path.exists():
            _compile(path)
        _lib = _bind(ctypes.CDLL(str(path)))
        build_seconds = time.perf_counter() - t0
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        name = library().krylov_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError {err} ({name})")
