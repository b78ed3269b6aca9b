"""The hand-written CUDA Gram-identity force sweep (``csrc/nbody_forces_mxu.cu``).

Replaces ``orbital_tpu/ops/pallas_forces_mxu.py::_mxu_kernel`` behind
``pairwise_acc_pallas_mxu`` (``force_impl="pallas_mxu"``), with its
contract and packing: the i rows A = (-2x, -2y, -2z, |r|^2, 1, 0, 0, 0), the
j rows B = (x, y, z, 1, |r|^2, m, 0, 0), r2 = A . B (8 deep) clamped at 0,
w = m_j rsqrt(r2 + eps2)^3 with the self diagonal masked, S = sum_j w (x, y,
z, 1), and here acc = G (S[:, 0:3] - pos * S[:, 3]) times alive and
U = -1/2 G sum m pe (the kernel's pe row is already free of the self term).
With ``with_potential=False`` the kernel skips the pe sum, its acc is
bit-equal to the PE-on acc, and U is 0. ``ValueError`` when eps2 <= 0 and
when N breaks the tile rule of :func:`check_tiles` (a copy of what
``pallas_forces.py::_pick_tiles`` enforces).

The kernel's function is :func:`gram_sums_cuda`: (S, pe) from the packed
rows. Its plain version :func:`gram_sums_plain` forms r2 as the same
packed 8-deep product A . B, its five nonzero terms summed in one fixed
order with each product and sum rounded on its own, and S as a
full-float32 product, row-blocked. The kernel forms r2 on the tensor cores
from an exact three-piece TF32 split of the packed entries
(``csrc/nbody_forces_mxu.cu``), an order of its own as the TPU kernel's
is. The identity is ill-conditioned on close pairs: one ulp of r2 moves a
close pair's weight by ~|r|^2 2^-24 / eps2, so the two part there by ~1e-3
of max |acc|, and acc = S[:, 0:3] - pos * S[:, 3] cancels the f32 rounding
of two sums of 65,536 terms. So chip_smoke.py holds the kernel's pe to the
plain version's and its S to the exact S of the packed rows (f64), and
its accelerations to the plain version's only in RMS.

For CPU tensors the wrappers compute the plain versions
(:func:`pairwise_acc_mxu_plain` is the packing, :func:`gram_sums_plain` and
the same bookkeeping). For CUDA tensors they launch the kernel or raise;
they never fall back. ``gram_sums_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .mxu_forces import full_f32_matmul, gram_rows
from ..utils.kernels import in_f32, refuse_grad

__all__ = ["pairwise_acc_mxu_cuda", "pairwise_acc_mxu_plain", "gram_sums_cuda",
           "gram_sums_plain", "check_tiles", "pack_gram"]

PAD_TO = 2048  # JAX's DEFAULT_TILE_J, named in the error text
CHUNK = 1024  # rows a block of the plain version

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("nbody_forces_mxu")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nbody_forces_mxu.restype = ctypes.c_int
        lib.nbody_forces_mxu.argtypes = [p, p, i, f, i, p, p, p, i]
        _lib = lib
    return _lib


def check_tiles(n: int) -> None:
    """The JAX wrappers' tile rule (``pallas_forces.py:145-164``): its
    default tiles halve down to 8 (i) and 128 (j) until each divides N, so
    it raises exactly when N % 128 != 0. The kernel's blocks are 128 rows."""
    if n % 128 != 0:
        raise ValueError(
            f"N={n} must be a multiple of the tile sizes (pad the state via "
            f"make_state(pad_to={PAD_TO}))")


def pack_gram(pos32, mass32):
    """JAX's packing: (A [N, 8], B [N, 8]) in float32."""
    n = pos32.shape[0]
    sq = torch.sum(pos32 * pos32, dim=-1)[:, None]
    ones = torch.ones((n, 1), dtype=torch.float32, device=pos32.device)
    zeros = torch.zeros((n, 3), dtype=torch.float32, device=pos32.device)
    iA = torch.cat([-2.0 * pos32, sq, ones, zeros], dim=1)
    jB = torch.cat([pos32, ones, sq, mass32[:, None], zeros[:, :2]], dim=1)
    return iA, jB


def _check(n: int, eps2: float) -> None:
    if eps2 <= 0.0:
        raise ValueError("the MXU (Gram) kernel requires eps2 > 0")
    check_tiles(n)


def _finish(s, pe_row, pos32, mass32, alive, G: float, with_potential: bool, dtype):
    acc = G * (s[:, 0:3] - pos32 * s[:, 3:4])
    if alive is not None:
        acc = acc * alive[:, None].to(acc.dtype)
    U = (-0.5 * G * torch.sum(mass32 * pe_row) if with_potential
         else torch.zeros((), dtype=torch.float32, device=pos32.device))
    return acc.to(dtype), U.to(dtype)


def gram_sums_plain(iA, jB, *, eps2: float, with_potential: bool = True):
    """The plain PyTorch version of the kernel, on any device: (S [N, 4],
    pe_row [N] or None) from the packed rows."""
    n = iA.shape[0]
    rhs, mass32 = jB[:, 0:4], jB[:, 5]  # (x, y, z, 1) and m
    s_blocks, pe_blocks = [], []
    with full_f32_matmul():
        for start in range(0, n, CHUNK):
            a = iA[start:start + CHUNK, None, :]
            b = jB[None, :, :]
            # A . B in the kernel's order; A_3 B_3 = |r_i|^2, A_4 B_4 = |r_j|^2
            r2 = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            r2 = r2 + a[..., 2] * b[..., 2]
            r2 = r2 + a[..., 3]
            r2 = r2 + b[..., 4]
            s, pe = gram_rows(r2, start, rhs, mass32, eps2, with_potential)
            s_blocks.append(s)
            pe_blocks.append(pe)
    return torch.cat(s_blocks), (torch.cat(pe_blocks) if with_potential else None)


def _check_packed(iA, jB) -> None:
    n = iA.shape[0]
    if iA.device.type != "cuda" or jB.device != iA.device:
        raise ValueError(f"gram_sums_cuda: unsupported device {iA.device} / {jB.device}")
    if iA.dtype != torch.float32 or jB.dtype != torch.float32 or \
            tuple(iA.shape) != (n, 8) or tuple(jB.shape) != (n, 8):
        raise ValueError("gram_sums_cuda: need float32 iA and jB of shape [N, 8]")


def gram_sums_cuda(iA: torch.Tensor, jB: torch.Tensor, *, eps2: float,
                   with_potential: bool = True):
    """The kernel: (S [N, 4], pe_row [N] or None) from the packed rows
    (f32 [N, 8] each, N a multiple of 128, eps2 > 0)."""
    if iA.device.type == "cpu":
        return gram_sums_plain(iA, jB, eps2=eps2, with_potential=with_potential)
    _check_packed(iA, jB)
    refuse_grad("gram_sums_cuda", iA, jB)
    n = iA.shape[0]
    iA, jB = iA.contiguous(), jB.contiguous()
    sums = torch.empty((n, 4), dtype=torch.float32, device=iA.device)
    pe_row = torch.empty(n if with_potential else 1, dtype=torch.float32, device=iA.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(iA.device).cuda_stream
    err = lib.nbody_forces_mxu(iA.data_ptr(), jB.data_ptr(), n, float(eps2),
                               int(with_potential), sums.data_ptr(), pe_row.data_ptr(),
                               stream, iA.device.index or 0)
    check(lib, err, "nbody_forces_mxu launch")
    gram_sums_cuda.launches += 1
    return sums, (pe_row if with_potential else None)


gram_sums_cuda.launches = 0


def _gram_acc(sums_fn, pos, mass, alive, G: float, eps2: float, with_potential: bool):
    _check(pos.shape[0], eps2)
    pos32 = pos.to(torch.float32)
    mass32 = (mass if alive is None else mass * alive.to(mass.dtype)).to(torch.float32)
    iA, jB = pack_gram(pos32, mass32)
    s, pe_row = sums_fn(iA, jB, eps2=eps2, with_potential=with_potential)
    return _finish(s, pe_row, pos32, mass32, alive, G, with_potential, pos.dtype)


def pairwise_acc_mxu_plain(pos, mass, alive=None, *, G: float, eps2: float,
                           with_potential: bool = True):
    """The plain PyTorch version of :func:`pairwise_acc_mxu_cuda`, on any
    device."""
    return _gram_acc(gram_sums_plain, pos, mass, alive, G, eps2, with_potential)


def pairwise_acc_mxu_cuda(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
    with_potential: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gram-identity softened accelerations [N, 3] and total potential U."""
    if pos.device.type == "cpu":
        return pairwise_acc_mxu_plain(pos, mass, alive, G=G, eps2=eps2,
                                      with_potential=with_potential)
    if pos.dtype == torch.float64:  # f32 inside, as pallas_forces_mxu.py:162-164
        return in_f32(pairwise_acc_mxu_cuda, pos, mass, alive, G=G, eps2=eps2,
                      with_potential=with_potential)
    from .cuda_forces import _check_inputs

    _check_inputs("pairwise_acc_mxu_cuda", pos, mass, alive)
    return _gram_acc(gram_sums_cuda, pos, mass, alive, G, eps2, with_potential)
