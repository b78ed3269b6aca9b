"""The Gram-matrix form of the pairwise force sweep (``force_impl="mxu"``).

A copy of ``orbital_tpu/ops/mxu_forces.py``'s function in plain PyTorch:

    r2_ij = |r_i|^2 + |r_j|^2 - 2 (pos @ pos^T)_ij, clamped at >= 0
    W_ij  = m_j (r2_ij + eps^2)^(-3/2),  W_ii = 0
    S     = W @ [pos, 1]               (the weighted position and row sums)
    acc   = G (S[:, 0:3] - pos * S[:, 3])

row-blocked over [chunk, N] panels, with the optional pe row masked on the
diagonal and U = -1/2 G sum m pe. The JAX package leaves both products to
XLA, so here they are ``torch.matmul``, on every device. They run in full
float32 (no TF32 on the card, no reduced-precision CPU matmul), set for the
call alone: the Gram identity cancels ~log2(|r|^2 / r2) bits on close pairs,
and TF32's 10-bit mantissa would lose them. Positions are cast to float32
inside and the result back to ``pos.dtype``, as JAX does.

:func:`gram_rows` is the part after r2, shared with the plain version of the
Gram kernel (``ops.cuda_forces_mxu``), which forms r2 as JAX's packed 8-deep
product instead.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["pairwise_acc_mxu", "gram_rows", "full_f32_matmul"]


@contextlib.contextmanager
def full_f32_matmul():
    """Full-float32 matrix products for the duration of the block (the
    caller's setting is restored after it)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def gram_rows(r2, start: int, rhs, mass32, eps2: float, with_potential: bool):
    """(S [C, 4], pe_i [C]) of the rows ``start .. start + C`` from their
    squared distances ``r2`` [C, N]: the clamp, the softened weights with
    the diagonal masked, and ``W @ rhs`` (``rhs`` = [pos, 1])."""
    c, n = r2.shape
    inv = torch.rsqrt(torch.clamp(r2, min=0.0) + eps2)
    diag = (start + torch.arange(c, device=r2.device))[:, None] == \
        torch.arange(n, device=r2.device)[None, :]
    w = torch.where(diag, 0.0, mass32[None, :] * (inv * inv * inv))
    s = w @ rhs
    pe = (torch.sum(torch.where(diag, 0.0, mass32[None, :] * inv), dim=1) if with_potential
          else None)
    return s, pe


def pairwise_acc_mxu(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 2048,
    with_potential: bool = True,
    _dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gram/accumulation-matmul force evaluation; the contract of
    ``ops.forces.pairwise_acc_dense``. Requires eps2 > 0 and N % chunk == 0
    (``ValueError`` otherwise). ``_dtype`` is the compute type: float32, as
    JAX computes, or float64 for a reference of the same formula."""
    if eps2 <= 0.0:
        raise ValueError("the Gram formulation requires eps2 > 0")
    n = pos.shape[0]
    if n % chunk != 0:
        raise ValueError(f"N={n} must be a multiple of chunk={chunk}")
    pos32 = pos.to(_dtype)
    mass32 = (mass if alive is None else mass * alive.to(mass.dtype)).to(_dtype)
    sq = torch.sum(pos32 * pos32, dim=-1)
    rhs = torch.cat([pos32, torch.ones((n, 1), dtype=_dtype, device=pos.device)], 1)
    acc_blocks, pe_blocks = [], []
    with full_f32_matmul():
        for start in range(0, n, chunk):
            pos_i = pos32[start:start + chunk]
            gram = pos_i @ pos32.T
            r2 = sq[start:start + chunk, None] + sq[None, :] - 2.0 * gram
            s, pe = gram_rows(r2, start, rhs, mass32, eps2, with_potential)
            acc_blocks.append(G * (s[:, 0:3] - pos_i * s[:, 3:4]))
            pe_blocks.append(pe)
    acc = torch.cat(acc_blocks)
    if alive is not None:
        acc = acc * alive[:, None].to(acc.dtype)
    U = (-0.5 * G * torch.sum(mass32 * torch.cat(pe_blocks)) if with_potential
         else torch.zeros((), dtype=_dtype, device=pos.device))
    return acc.to(pos.dtype), U.to(pos.dtype)
