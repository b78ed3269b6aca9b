"""Softened O(N^2) pairwise gravity as plain tensor ops.

For every pair,

    a_i += G m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^(3/2)
    U   += -G m_i m_j / sqrt(|r_j - r_i|^2 + eps^2)   (each pair once)

Dead/padding bodies participate with mass 0, so they exert no force and
contribute no potential; their own acceleration rows are zeroed by the
alive mask.

Two flavors, both on whatever device the tensors live on:
  * :func:`pairwise_acc_dense`   -- materializes [N, N] per-coordinate
    difference matrices (the path at N <= 4096).
  * :func:`pairwise_acc_chunked` -- a loop over row blocks, O(chunk * N)
    live memory; the CPU path at larger N and the plain version the CUDA
    force kernel (``ops.cuda_forces``) is checked against. The last block
    may be short, so N need not divide by ``chunk``.

The Hermite integrator also needs the jerk (da/dt) from the same sweep,

    j_i = G sum_j m_j [v_ij / s^3 - 3 (r_ij . v_ij) r_ij / s^5],
    s^2 = |r_ij|^2 + eps^2, r_ij = r_j - r_i, v_ij = v_j - v_i,

in the same three shapes: :func:`accel_jerk_dense`,
:func:`accel_jerk_chunked` (ragged row blocks) and :func:`accel_jerk_subset`
(a list of target rows against all N sources, the block-timestep inner
evaluation; ragged column blocks). They are the CPU paths and the plain
versions the CUDA acc + jerk kernel (``ops.cuda_jerk``) is checked against.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["pairwise_acc_dense", "pairwise_acc_chunked", "soften_potential_pairs",
           "block_acc_potential", "accel_jerk_dense", "accel_jerk_chunked",
           "accel_jerk_subset"]


def _masked_inverse_r(r2, mask, eps2):
    """1/sqrt(r2 + eps2) with masked entries (self-pairs, dead bodies)
    forced to exactly zero, avoiding inf/NaN when eps = 0."""
    r2s = r2 + eps2
    safe = r2s > 0.0
    inv_r = torch.where(safe, torch.rsqrt(torch.where(safe, r2s, torch.ones_like(r2s))),
                        torch.zeros_like(r2s))
    return torch.where(mask, inv_r, torch.zeros_like(inv_r))


def _block_acc_potential(pos_i, pos_j, mass_j, mask, eps2, G):
    """Accelerations on a row block of bodies from a column block.

    pos_i: [I, 3], pos_j: [J, 3], mass_j: [J], mask: [I, J] valid-pair mask.
    Returns (acc [I, 3], pe_row [I]) where pe_row_i = sum_j m_j * inv_r_ij
    (caller multiplies by -G m_i and halves for double counting).
    """
    dx = pos_j[None, :, 0] - pos_i[:, None, 0]
    dy = pos_j[None, :, 1] - pos_i[:, None, 1]
    dz = pos_j[None, :, 2] - pos_i[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz
    inv_r = _masked_inverse_r(r2, mask, eps2)
    inv_r3 = inv_r * inv_r * inv_r
    w = mass_j[None, :] * inv_r3  # [I, J]
    ax = torch.sum(w * dx, dim=1)
    ay = torch.sum(w * dy, dim=1)
    az = torch.sum(w * dz, dim=1)
    pe_row = torch.sum(mass_j[None, :] * inv_r, dim=1)
    return G * torch.stack([ax, ay, az], dim=-1), pe_row


def block_acc_potential(pos_i, pos_j, mass_j, *, G: float, eps2: float, rows: int = 1024):
    """Partial forces of body block j on body block i in row blocks of
    ``rows``: (acc [I, 3], pe_row [I]) in the inputs' dtype, nothing masked
    but r2 + eps2 = 0 (with eps2 > 0 an i == j term adds m/eps to pe_row
    and nothing to acc; dead bodies carry mass 0)."""
    keep = torch.ones((), dtype=torch.bool, device=pos_i.device)
    parts = [_block_acc_potential(pos_i[s:s + rows], pos_j, mass_j, keep, eps2, G)
             for s in range(0, pos_i.shape[0], rows)]
    return torch.cat([a for a, _ in parts]), torch.cat([pe for _, pe in parts])


def _effective_mass(mass, alive):
    return mass if alive is None else mass * alive.to(mass.dtype)


def pairwise_acc_dense(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense softened pairwise accelerations and total potential.

    Args:
        pos: [N, 3] positions. mass: [N]. alive: optional [N] bool mask.

    Returns:
        acc [N, 3] and the scalar softened potential U (pairs counted once).
    """
    n = pos.shape[0]
    mass_eff = _effective_mass(mass, alive)
    mask = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    acc, pe_row = _block_acc_potential(pos, pos, mass_eff, mask, eps2, G)
    if alive is not None:
        acc = acc * alive[:, None].to(acc.dtype)
    U = -0.5 * G * torch.sum(mass_eff * pe_row)
    return acc, U


def pairwise_acc_chunked(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-blocked pairwise accelerations: O(chunk * N) live memory."""
    n = pos.shape[0]
    mass_eff = _effective_mass(mass, alive)
    col_ids = torch.arange(n, device=pos.device)
    acc_blocks, pe_blocks = [], []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        mask = col_ids[start:stop, None] != col_ids[None, :]
        a, pe = _block_acc_potential(pos[start:stop], pos, mass_eff, mask, eps2, G)
        acc_blocks.append(a)
        pe_blocks.append(pe)
    acc = torch.cat(acc_blocks) if acc_blocks else torch.zeros_like(pos)
    pe_row = torch.cat(pe_blocks) if pe_blocks else torch.zeros_like(mass_eff)
    if alive is not None:
        acc = acc * alive[:, None].to(acc.dtype)
    U = -0.5 * G * torch.sum(mass_eff * pe_row)
    return acc, U


def soften_potential_pairs(pos: torch.Tensor, mass: torch.Tensor, *, G: float,
                           eps2: float) -> torch.Tensor:
    """Total softened potential only (diagnostics helper): the dense
    sweep's U, every body alive."""
    _, U = pairwise_acc_dense(pos, mass, G=G, eps2=eps2)
    return U


def _block_accel_jerk(pos_i, vel_i, pos_j, vel_j, mass_j, mask, eps2, G):
    """Acc + jerk of a column block on a row block (shared by the dense,
    chunked and subset paths). Returns (acc [I, 3], jerk [I, 3], pe_row [I])."""
    dx = pos_j[None, :, 0] - pos_i[:, None, 0]
    dy = pos_j[None, :, 1] - pos_i[:, None, 1]
    dz = pos_j[None, :, 2] - pos_i[:, None, 2]
    dvx = vel_j[None, :, 0] - vel_i[:, None, 0]
    dvy = vel_j[None, :, 1] - vel_i[:, None, 1]
    dvz = vel_j[None, :, 2] - vel_i[:, None, 2]

    r2 = dx * dx + dy * dy + dz * dz
    inv_r = _masked_inverse_r(r2, mask, eps2)
    inv_r2 = inv_r * inv_r
    inv_r3 = inv_r2 * inv_r
    w = mass_j[None, :] * inv_r3                         # m_j / s^3
    rv = dx * dvx + dy * dvy + dz * dvz                  # r_ij . v_ij
    c = 3.0 * rv * inv_r2                                # 3 (r.v) / s^2

    acc = G * torch.stack(
        [torch.sum(w * dx, 1), torch.sum(w * dy, 1), torch.sum(w * dz, 1)], dim=-1)
    jerk = G * torch.stack(
        [torch.sum(w * (dvx - c * dx), 1),
         torch.sum(w * (dvy - c * dy), 1),
         torch.sum(w * (dvz - c * dz), 1)], dim=-1)
    pe_row = torch.sum(mass_j[None, :] * inv_r, dim=1)
    return acc, jerk, pe_row


def _keep_alive(acc, jerk, alive):
    if alive is None:
        return acc, jerk
    keep = alive[:, None].to(acc.dtype)
    return acc * keep, jerk * keep


def accel_jerk_dense(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softened accelerations AND jerks for Hermite integration: (acc
    [N, 3], jerk [N, 3], U), U the softened potential (pairs once)."""
    n = pos.shape[0]
    mass_eff = _effective_mass(mass, alive)
    mask = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    acc, jerk, pe_row = _block_accel_jerk(pos, vel, pos, vel, mass_eff, mask, eps2, G)
    U = -0.5 * G * torch.sum(mass_eff * pe_row)
    return (*_keep_alive(acc, jerk, alive), U)


def accel_jerk_chunked(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-blocked acc + jerk: O(chunk * N) live memory, any N (the last
    block may be short)."""
    n = pos.shape[0]
    mass_eff = _effective_mass(mass, alive)
    col_ids = torch.arange(n, device=pos.device)
    acc_b, jerk_b, pe_b = [], [], []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        mask = col_ids[start:stop, None] != col_ids[None, :]
        a, j, pe = _block_accel_jerk(pos[start:stop], vel[start:stop], pos, vel, mass_eff,
                                     mask, eps2, G)
        acc_b.append(a)
        jerk_b.append(j)
        pe_b.append(pe)
    if not acc_b:
        return torch.zeros_like(pos), torch.zeros_like(pos), pos.new_zeros(())
    pe_row = torch.cat(pe_b)
    U = -0.5 * G * torch.sum(mass_eff * pe_row)
    return (*_keep_alive(torch.cat(acc_b), torch.cat(jerk_b), alive), U)


def accel_jerk_subset(
    idx_i: torch.Tensor,
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Acc + jerk ON the ``idx_i`` rows from ALL bodies (the block-timestep
    Hermite inner evaluation: F fast targets x N sources). Self pairs are
    excluded by global index. ``chunk > 0`` streams the sources in column
    blocks (live memory O(F * chunk)), the last one possibly short.
    Returns (acc [F, 3], jerk [F, 3]); target rows are not alive-masked."""
    n = pos.shape[0]
    mass_eff = _effective_mass(mass, alive)
    pos_i = pos[idx_i]
    vel_i = vel[idx_i]
    col_ids = torch.arange(n, device=pos.device)
    if chunk <= 0:
        mask = idx_i[:, None] != col_ids[None, :]
        acc, jerk, _ = _block_accel_jerk(pos_i, vel_i, pos, vel, mass_eff, mask, eps2, G)
        return acc, jerk
    accs, jerks = [], []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        mask = idx_i[:, None] != col_ids[None, start:stop]
        a, j, _ = _block_accel_jerk(pos_i, vel_i, pos[start:stop], vel[start:stop],
                                    mass_eff[start:stop], mask, eps2, G)
        accs.append(a)
        jerks.append(j)
    return torch.stack(accs).sum(0), torch.stack(jerks).sum(0)
