"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` holds one kernel and a plain C launch function.  It is
compiled on first use into ``build/repro_torch_kernels/lib<name>.so`` at the
root of the checkout, for ``sm_90a`` (Hopper), and rebuilt when its source is
newer than the library.  Nothing here runs at import: the CPU tests import
every module of the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "kron_matvec" / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}   # guarded-by: _LOCK
# One lock for the check, the build and the load: two threads of one process
# that reach a kernel first (a server's worker and a registering caller)
# build it once and share one handle.
_LOCK = threading.RLock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return path


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names: Iterable[str], force: bool = False) -> Dict[str, str]:
    """Compile the named kernels, one nvcc process each, all at once.

    Returns each kernel's ptxas report (registers, shared memory, spills).
    Raises with the compiler's output if any build fails.
    """
    with _LOCK:
        names = [n for n in names if force or _stale(n)]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in names:
            # The process and thread ids in the name: two builds, in two
            # processes or in two threads of one, never write one file.
            tmp = BUILD_DIR / (f"lib{name}.so.{os.getpid()}."
                               f"{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT,
                                                 text=True))
        reports, failed = {}, []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)          # the launch path: no lock once loaded
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib
