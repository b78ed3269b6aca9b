"""Sphere collisions as masked tensor ops: the bounce sweep and contact counts.

A port of ``orbital_tpu/ops/collisions.py``'s bounce mode. For every
approaching overlapping pair (i, j) the reference applies a restitution
impulse and a mass-weighted positional de-overlap (reference:
core/physics.py:391-422); here all pair impulses are computed at once from
the pre-collision velocities and summed per body. For isolated contacts this
matches the reference's sequential sweep exactly; simultaneous multi-contacts
differ by impulse ordering.

  * :func:`bounce_deltas` -- dense [N, N] pair matrices (the path at
    N <= 4096 on CPU tensors), the JAX package's formulation (sqrt distances).
  * :func:`bounce_deltas_chunked` -- row blocks of the same sweep in the
    formulation of the tiled kernel (``csrc/collisions.cu``, the TPU
    kernel's ``_collision_kernel``): r2 <= (R_i+R_j)^2, one rsqrt, one
    reciprocal. O(chunk * N) memory; the CPU path above 4096 bodies and the
    plain version the CUDA kernel is checked against. Ragged N.
  * :func:`count_contacts_dense` / :func:`count_contacts_chunked` -- the
    directed touching-pair count that gates the sweep.

Merge and resolve (``merge_groups``, ``collision_roots*``,
``resolve_outcomes*``) are not ported yet: ROADMAP.md queue A item A.7b.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["bounce_deltas", "bounce_deltas_chunked", "count_contacts_dense",
           "count_contacts_chunked", "restitution_clip"]


def restitution_clip(restitution: float) -> float:
    """The coefficient of restitution clipped to [0, 1], as both sweeps use it."""
    return min(max(float(restitution), 0.0), 1.0)


def _pair_geometry(pos, radius, alive):
    """Shared pair quantities. Returns (n_hat components, dist, touching)."""
    dx = pos[:, None, 0] - pos[None, :, 0]  # r_i - r_j (normal points at i)
    dy = pos[:, None, 1] - pos[None, :, 1]
    dz = pos[:, None, 2] - pos[None, :, 2]
    r2 = dx * dx + dy * dy + dz * dz
    dist = torch.sqrt(r2)
    n = pos.shape[0]
    valid = (~torch.eye(n, dtype=torch.bool, device=pos.device)
             & alive[:, None] & alive[None, :])
    touching = valid & (dist <= radius[:, None] + radius[None, :]) & (dist > 0.0)
    pos_d = dist > 0.0
    inv_d = torch.where(pos_d, 1.0 / torch.where(pos_d, dist, torch.ones_like(dist)),
                        torch.zeros_like(dist))
    return (dx * inv_d, dy * inv_d, dz * inv_d), dist, touching


def bounce_deltas(pos, vel, mass, radius, alive, *, restitution: float = 1.0):
    """Velocity and position corrections from restitution impulses.

    For each approaching overlapping pair (i, j): impulse magnitude
    j = -(1+e) v_rel.n / (1/m_i + 1/m_j) along n = (r_i - r_j)/|.|, applied
    +j n / m_i to i and -j n / m_j to j, plus a mass-weighted positional
    de-overlap. Returns (dpos [N, 3], dvel [N, 3]) to be *added* to the state.
    """
    (nx, ny, nz), dist, touching = _pair_geometry(pos, radius, alive)

    dvx = vel[:, None, 0] - vel[None, :, 0]
    dvy = vel[:, None, 1] - vel[None, :, 1]
    dvz = vel[:, None, 2] - vel[None, :, 2]
    v_rel_n = dvx * nx + dvy * ny + dvz * nz  # [N, N]
    active = touching & (v_rel_n < 0.0)

    pos_m = mass > 0.0
    inv_m = torch.where(pos_m, 1.0 / torch.where(pos_m, mass, torch.ones_like(mass)),
                        torch.zeros_like(mass))
    inv_m_sum = inv_m[:, None] + inv_m[None, :]
    e = restitution_clip(restitution)
    zero = torch.zeros_like(v_rel_n)
    j_mag = torch.where(active, -(1.0 + e) * v_rel_n / inv_m_sum, zero)

    # dv_i = sum_j (j_ij / m_i) n_ij; the (j, i) entry carries the equal and
    # opposite impulse since n and v_rel both flip sign
    scale_v = j_mag * inv_m[:, None]
    dvel = torch.stack([torch.sum(scale_v * nx, dim=1), torch.sum(scale_v * ny, dim=1),
                        torch.sum(scale_v * nz, dim=1)], dim=-1)

    overlap = radius[:, None] + radius[None, :] - dist
    corr = torch.where(active & (overlap > 0.0), overlap / inv_m_sum, zero)
    scale_r = corr * inv_m[:, None]
    dpos = torch.stack([torch.sum(scale_r * nx, dim=1), torch.sum(scale_r * ny, dim=1),
                        torch.sum(scale_r * nz, dim=1)], dim=-1)
    return dpos, dvel


def _bounce_block(p_i, v_i, m_i, r_i, pos, vel, mass, radius, e):
    """Deltas of a row block from all columns, as the tiled kernel computes
    them: with dd = r_j - r_i, s = dd . (v_j - v_i) < 0 approaching,

        dv_i += (1+e) s / r2 * base * dd
        dr_i -= (rsum / |dd| - 1) * base * dd,   base = m_i^-1 / (m_i^-1 + m_j^-1)
    """
    ddx = pos[None, :, 0] - p_i[:, None, 0]
    ddy = pos[None, :, 1] - p_i[:, None, 1]
    ddz = pos[None, :, 2] - p_i[:, None, 2]
    r2 = ddx * ddx + ddy * ddy + ddz * ddz
    s = (ddx * (vel[None, :, 0] - v_i[:, None, 0]) + ddy * (vel[None, :, 1] - v_i[:, None, 1])
         + ddz * (vel[None, :, 2] - v_i[:, None, 2]))
    rsum = r_i[:, None] + radius[None, :]
    touching = ((r2 <= rsum * rsum) & (r2 > 0.0) & (s < 0.0)
                & (mass[None, :] > 0.0) & (m_i[:, None] > 0.0))

    def inv(m):
        pos_m = m > 0.0
        return torch.where(pos_m, 1.0 / torch.where(pos_m, m, torch.ones_like(m)),
                           torch.zeros_like(m))

    inv_mi, inv_mj = inv(m_i)[:, None], inv(mass)[None, :]
    inv_sum = inv_mi + inv_mj
    base = (1.0 / torch.where(inv_sum > 0.0, inv_sum, torch.ones_like(inv_sum))) * inv_mi
    inv_d = torch.rsqrt(torch.where(touching, r2, torch.ones_like(r2)))
    zero = torch.zeros_like(r2)
    fv = torch.where(touching, (1.0 + e) * s * (inv_d * inv_d), zero) * base
    h = torch.where(touching, rsum * inv_d - 1.0, zero) * base
    dvel = torch.stack([torch.sum(fv * ddx, dim=1), torch.sum(fv * ddy, dim=1),
                        torch.sum(fv * ddz, dim=1)], dim=-1)
    dpos = -torch.stack([torch.sum(h * ddx, dim=1), torch.sum(h * ddy, dim=1),
                         torch.sum(h * ddz, dim=1)], dim=-1)
    return dpos, dvel


def bounce_deltas_chunked(pos, vel, mass, radius, alive: Optional[torch.Tensor] = None, *,
                          restitution: float = 1.0, chunk: int = 1024):
    """Row-blocked bounce sweep in the tiled kernel's formulation: same
    contract as :func:`bounce_deltas`, O(chunk * N) live memory, any N.
    Dead rows (``alive`` False, or mass 0) come back exactly 0."""
    n = pos.shape[0]
    mass_eff = mass if alive is None else mass * alive.to(mass.dtype)
    e = restitution_clip(restitution)
    dpos_blocks, dvel_blocks = [], []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        dp, dv = _bounce_block(pos[start:stop], vel[start:stop], mass_eff[start:stop],
                               radius[start:stop], pos, vel, mass_eff, radius, e)
        dpos_blocks.append(dp)
        dvel_blocks.append(dv)
    if not dpos_blocks:
        return torch.zeros_like(pos), torch.zeros_like(vel)
    return torch.cat(dpos_blocks), torch.cat(dvel_blocks)


def _contacts_block(pos_i, radius_i, alive_i, ids_i, pos, radius, alive, ids):
    """Directed touching-pair count of all columns on a row block: the
    sqrt-free test r^2 <= (R_i+R_j)^2 (reference detection:
    core/physics.py:513-518)."""
    dx = pos_i[:, None, 0] - pos[None, :, 0]
    dy = pos_i[:, None, 1] - pos[None, :, 1]
    dz = pos_i[:, None, 2] - pos[None, :, 2]
    r2 = dx * dx + dy * dy + dz * dz
    # slightly inflated threshold: strictly conservative against the
    # resolution sweeps' tests (a grazing pair may cost a redundant sweep
    # but can never skip a real one)
    rsum = (radius_i[:, None] + radius[None, :]) * 1.00001
    touch = ((r2 <= rsum * rsum) & (ids_i[:, None] != ids[None, :])
             & alive_i[:, None] & alive[None, :])
    return torch.sum(touch, dtype=torch.int32)


def count_contacts_dense(pos, radius, alive):
    """Directed touching-pair count between live bodies (int32 0-dim tensor
    on the state's device); 0 exactly when no resolution sweep is needed."""
    ids = torch.arange(pos.shape[0], device=pos.device)
    return _contacts_block(pos, radius, alive, ids, pos, radius, alive, ids)


def count_contacts_chunked(pos, radius, alive, *, chunk: int = 1024):
    """Row-blocked :func:`count_contacts_dense` (O(chunk * N) memory, any N)."""
    n = pos.shape[0]
    ids = torch.arange(n, device=pos.device)
    total = torch.zeros((), dtype=torch.int32, device=pos.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        total = total + _contacts_block(pos[start:stop], radius[start:stop],
                                        alive[start:stop], ids[start:stop],
                                        pos, radius, alive, ids)
    return total
