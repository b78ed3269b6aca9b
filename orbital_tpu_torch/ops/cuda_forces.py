"""The hand-written CUDA force sweep (``csrc/nbody_forces.cu``).

Replaces ``orbital_tpu/ops/pallas_forces.py::_nbody_kernel`` behind
``pairwise_acc_pallas``, with the same contract: f32 in, (acc [N, 3],
scalar U) out, dead bodies inert, and with ``with_potential=False`` the PE
sum is skipped in the kernel and U is 0.

The kernel is arithmetic-bound (~20 flops and one rsqrtf per pair; see the
note at the top of the source): one thread per i body, j streamed through
shared memory in float4 tiles, sums in registers, the ragged last tile cut
in the kernel. The bookkeeping stays here, as in the JAX wrapper: the alive
mask, the analytic self-PE subtraction m_i/eps (the kernel masks nothing
when eps2 > 0) and U = -1/2 G sum m pe.

For CPU tensors the wrapper computes the plain version,
``ops.forces.pairwise_acc_chunked``. For CUDA tensors it launches the
kernel or raises; it never falls back. ``pairwise_acc_cuda.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .forces import pairwise_acc_chunked

__all__ = ["pairwise_acc_cuda", "pairwise_acc_plain"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("nbody_forces")
        lib.nbody_forces.restype = ctypes.c_int
        lib.nbody_forces.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        _lib = lib
    return _lib


def pairwise_acc_plain(pos, mass, alive=None, *, G: float, eps2: float,
                       with_potential: bool = True, chunk: int = 1024):
    """The plain PyTorch version of the kernel, on any device."""
    acc, U = pairwise_acc_chunked(pos, mass, alive, G=G, eps2=eps2,
                                  chunk=min(chunk, max(pos.shape[0], 1)))
    if not with_potential:
        U = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return acc, U


def pairwise_acc_cuda(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
    with_potential: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Softened pairwise accelerations [N, 3] and total potential U."""
    if pos.device.type == "cpu":
        return pairwise_acc_plain(pos, mass, alive, G=G, eps2=eps2,
                                  with_potential=with_potential)
    if pos.device.type != "cuda":
        raise ValueError(f"pairwise_acc_cuda: unsupported device {pos.device}")
    if pos.dtype != torch.float32:
        raise TypeError(f"pairwise_acc_cuda computes in float32, got {pos.dtype}")
    if pos.ndim != 2 or pos.shape[1] != 3 or mass.shape != pos.shape[:1]:
        raise ValueError(f"pairwise_acc_cuda: need pos [N, 3] and mass [N], got "
                         f"{tuple(pos.shape)} and {tuple(mass.shape)}")
    if mass.device != pos.device or (alive is not None and alive.device != pos.device):
        raise ValueError("pairwise_acc_cuda: all tensors must be on one device")
    n = pos.shape[0]
    mass_eff = mass if alive is None else mass * alive.to(mass.dtype)
    mass32 = mass_eff.to(torch.float32)
    pts = torch.cat([pos, mass32[:, None]], dim=1).contiguous()  # [N, 4]
    out = torch.empty((n, 4), dtype=torch.float32, device=pos.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.nbody_forces(pts.data_ptr(), n, float(G), float(eps2),
                           int(with_potential), out.data_ptr(), stream,
                           pos.device.index or 0)
    check(lib, err, "nbody_forces launch")
    pairwise_acc_cuda.launches += 1

    acc = out[:, 0:3]
    if alive is not None:
        acc = acc * alive[:, None].to(acc.dtype)
    if with_potential:
        pe_row = out[:, 3]
        if eps2 > 0.0:
            # remove the analytic self-term m_i/eps of the mask-free kernel
            pe_row = pe_row - mass32 * (1.0 / float(eps2) ** 0.5)
        U = -0.5 * G * torch.sum(mass32 * pe_row)
    else:
        U = torch.zeros((), dtype=torch.float32, device=pos.device)
    return acc, U


pairwise_acc_cuda.launches = 0
