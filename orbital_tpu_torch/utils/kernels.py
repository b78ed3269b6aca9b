"""Build and load the hand-written CUDA kernels in ``orbital_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` holds kernels plus a plain C interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds. It is built at first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``) as

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

and loaded with ``ctypes``. ``<hash>`` covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. ``nvcc`` is
taken from ``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``.
:func:`build` starts one ``nvcc`` per missing library, all at once.

Calling convention of every C entry point: device pointers and the CUDA
stream are ``ctypes.c_void_p``; the function returns the ``cudaError_t`` of
its launch (``cudaGetLastError()``), and :func:`check` raises on nonzero.
Each library also exports ``ot_error_string(int)``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build", "load", "check",
           "build_log", "build_seconds"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every source in csrc/, by library name
SOURCES = ("nbody_forces", "fused_rollout", "collisions", "nbody_jerk", "neighbor",
           "tree_near", "nbody_forces_sym", "nbody_forces_mxu", "p3m_short",
           "collision_roots")

_loaded: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _library_path(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every library of ``names`` (``SOURCES`` for all) that is
    missing or stale, one ``nvcc`` process per source, all running at once.
    Raises if ``nvcc`` is missing or any build fails (with the compiler's
    output)."""
    started = []
    for name in names:
        src, out = _library_path(name)
        if name in _loaded or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in started:
        _logs[name] = proc.communicate()[0]
        _seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {src.name} (rc={proc.returncode}):\n"
                          f"{_logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing or stale, load it
    once per process and return it."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_library_path(name)[1]))
    lib.ot_error_string.restype = ctypes.c_char_p
    lib.ot_error_string.argtypes = [ctypes.c_int]
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.ot_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for a
    library built by this process; empty if it was loaded from the cache."""
    return _logs.get(name, "")


def build_seconds(name: str) -> float:
    """Wall seconds this process spent compiling ``name`` (0 if cached)."""
    return _seconds.get(name, 0.0)
