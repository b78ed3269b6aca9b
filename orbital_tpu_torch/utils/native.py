"""ctypes bindings for the C++ f64 verification oracle (``native/``).

The oracle evaluates the exact softened potential / accelerations in f64,
for drift measurement and kernel verification at sizes where numpy's
chunked path would allocate multi-GB temporaries. The shared library is
built at first use with ``make -C native`` (the same build the JAX
package's binding runs); where it cannot be built or loaded the functions
compute with numpy instead. :func:`backend` reports which path is active:
``"oracle"`` or ``"numpy"``.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["backend", "potential_f64", "accelerations_f64"]

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / "libnbody_ref.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and load the oracle; None when unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and _LIB_PATH.parent.exists():
        subprocess.run(["make", "-C", str(_LIB_PATH.parent)],
                       capture_output=True, check=False)
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.nbody_potential.restype = ctypes.c_double
    lib.nbody_potential.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
    ]
    lib.nbody_accelerations.restype = None
    lib.nbody_accelerations.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return _lib


def backend() -> str:
    """The active f64 path: ``"oracle"`` (C++) or ``"numpy"``."""
    return "oracle" if _load() is not None else "numpy"


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _rows(pos, eps2, s, e):
    """Per-coordinate differences and inverse distances of rows [s, e)
    against all bodies, self pairs zeroed."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dx = x[None, :] - x[s:e, None]
    dy = y[None, :] - y[s:e, None]
    dz = z[None, :] - z[s:e, None]
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + dz * dz + eps2)
    rows = np.arange(s, e)
    inv[rows - s, rows] = 0.0
    return dx, dy, dz, inv


def potential_f64(pos: np.ndarray, mass: np.ndarray, eps2: float,
                  G: float = 1.0) -> float:
    """Exact softened pairwise potential (each pair once), f64."""
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    mass = np.ascontiguousarray(mass, dtype=np.float64)
    n = len(mass)
    lib = _load()
    if lib is not None:
        return float(lib.nbody_potential(_as_c(pos), _as_c(mass), n,
                                         float(eps2), float(G)))
    U = 0.0
    chunk = max(1, min(n, 2**24 // max(n, 1)))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        _, _, _, inv = _rows(pos, eps2, s, e)
        U += -0.5 * G * float(np.sum(mass[s:e, None] * mass[None, :] * inv))
    return U


def accelerations_f64(pos: np.ndarray, mass: np.ndarray, eps2: float,
                      G: float = 1.0) -> np.ndarray:
    """Exact softened accelerations [N, 3], f64."""
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    mass = np.ascontiguousarray(mass, dtype=np.float64)
    n = len(mass)
    lib = _load()
    if lib is not None:
        acc = np.empty((n, 3), dtype=np.float64)
        lib.nbody_accelerations(_as_c(pos), _as_c(mass), n, float(eps2),
                                float(G), _as_c(acc))
        return acc
    acc = np.zeros((n, 3))
    chunk = max(1, min(n, 2**24 // max(n, 1)))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dx, dy, dz, inv = _rows(pos, eps2, s, e)
        w = mass[None, :] * inv**3
        acc[s:e, 0] = np.sum(w * dx, axis=1)
        acc[s:e, 1] = np.sum(w * dy, axis=1)
        acc[s:e, 2] = np.sum(w * dz, axis=1)
    return G * acc
