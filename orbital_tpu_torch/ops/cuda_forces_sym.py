"""The hand-written CUDA half-pair force sweep (``csrc/nbody_forces_sym.cu``).

Replaces ``orbital_tpu/ops/pallas_forces_sym.py::_sym_kernel`` behind
``pairwise_acc_pallas_sym`` (``force_impl="pallas_sym"``), with its
contract: f32 arithmetic, acc [N, 3] from the effective masses m * alive,
acc times alive, and U returned as 0 whatever ``track_potential`` says (the
kernel has no PE sum); ``ValueError`` when eps2 <= 0 and when N does not
divide by a tile halved from 512 down to 128.

The kernel evaluates each upper-triangle tile pair once and writes both
halves to per-tile-pair partial slots, which a second kernel sums in a fixed
order (no float atomics; see the note at the top of the source). The partial
buffer, 12 N^2 / tile bytes (100.7 MB at N = 65,536), is allocated here.

For CPU tensors :func:`pairwise_acc_sym_cuda` computes the plain version
:func:`pairwise_acc_sym_plain`, the chunked full sweep under B12's contract:
the same function, summed over all ordered pairs. For CUDA tensors it
launches the kernels or raises; it never falls back.
``pairwise_acc_sym_cuda.launches`` counts the launches of the tile kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .forces import pairwise_acc_chunked
from ..utils.kernels import in_f32, refuse_grad

__all__ = ["pairwise_acc_sym_cuda", "pairwise_acc_sym_plain", "sym_tile"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("nbody_forces_sym")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nbody_forces_sym.restype = ctypes.c_int
        lib.nbody_forces_sym.argtypes = [p, i, i, f, f, p, p, p, i]
        _lib = lib
    return _lib


TILE = 512  # the JAX wrapper's default tile
CHUNK = 1024  # rows a block of the plain version


def sym_tile(n: int, eps2: float) -> int:
    """The tile of B12's contract (``pallas_forces_sym.py:133-140``):
    512 halved down to 128 until it divides N. Raises ``ValueError`` when
    eps2 <= 0 or no such tile divides N."""
    if eps2 <= 0.0:
        raise ValueError("symmetric kernel requires eps2 > 0")
    tb = TILE
    while tb > 128 and n % tb != 0:
        tb //= 2
    if n % tb != 0:
        raise ValueError(f"N={n} must divide by the tile size")
    return tb


def pairwise_acc_sym_plain(pos, mass, alive=None, *, G: float, eps2: float):
    """The plain PyTorch version of the kernel, on any device: the chunked
    full sweep in float32 under B12's contract."""
    sym_tile(pos.shape[0], eps2)
    acc, _ = pairwise_acc_chunked(pos.to(torch.float32), mass.to(torch.float32), alive,
                                  G=G, eps2=eps2, chunk=min(CHUNK, max(pos.shape[0], 1)))
    return acc.to(pos.dtype), torch.zeros((), dtype=pos.dtype, device=pos.device)


def pairwise_acc_sym_cuda(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-pair softened accelerations [N, 3] and U = 0."""
    if pos.device.type == "cpu":
        return pairwise_acc_sym_plain(pos, mass, alive, G=G, eps2=eps2)
    if pos.dtype == torch.float64:  # f32 inside, as pallas_forces_sym.py:142-156
        return in_f32(pairwise_acc_sym_cuda, pos, mass, alive, G=G, eps2=eps2)
    from .cuda_forces import _check_inputs

    _check_inputs("pairwise_acc_sym_cuda", pos, mass, alive)
    refuse_grad("pairwise_acc_sym_cuda", pos, mass)
    n = pos.shape[0]
    tile = sym_tile(n, eps2)
    mass_eff = mass if alive is None else mass * alive.to(mass.dtype)
    pts = torch.cat([pos, mass_eff.to(torch.float32)[:, None]], dim=1).contiguous()
    n_tiles = n // tile
    part = torch.empty(n_tiles * n_tiles * 3 * tile, dtype=torch.float32, device=pos.device)
    acc = torch.empty((n, 3), dtype=torch.float32, device=pos.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.nbody_forces_sym(pts.data_ptr(), n, tile, float(G), float(eps2),
                               part.data_ptr(), acc.data_ptr(), stream,
                               pos.device.index or 0)
    check(lib, err, "nbody_forces_sym launch")
    pairwise_acc_sym_cuda.launches += 1

    if alive is not None:
        acc = acc * alive[:, None].to(acc.dtype)
    return acc, torch.zeros((), dtype=torch.float32, device=pos.device)


pairwise_acc_sym_cuda.launches = 0
