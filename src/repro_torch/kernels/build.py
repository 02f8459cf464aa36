"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone into ``build/kernels/lib<name>.so`` under the repository root — a few
seconds each, no PyTorch headers.  A library is built on first use (or when
its source is newer), and :func:`build` starts one ``nvcc`` per source, all
at once.  Nothing here runs at import time: CPU-only hosts import the
kernel modules and never reach the toolchain.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "offload_pack", "flash_attention", "ssd_scan",
           "gemm_os")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = library_path(name)
    return (not so.exists()
            or so.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every stale library among ``names`` in parallel.

    Returns ``{name: {"seconds": wall time, "log": nvcc's ptxas report}}``
    for the ones it built; raises with nvcc's output on a failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---"
                          f"\n{out}")
            continue
        os.replace(tmp, library_path(name))
        report[name] = {"seconds": time.perf_counter() - t0, "log": out}
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return report


def function(lib: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of ``lib<lib>.so`` (built on first use), with its
    argument types declared; every entry returns a ``cudaError_t`` code."""
    with _LOCK:
        if lib not in _LIBS:
            build([lib])
            _LIBS[lib] = ctypes.CDLL(str(library_path(lib)))
        f = getattr(_LIBS[lib], fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f
