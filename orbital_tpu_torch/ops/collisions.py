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

And merge mode: overlapping bodies are grouped by pointer jumping to the
lowest-index root of each contact chain and reduced into it.

  * :func:`collision_roots` / :func:`collision_roots_chunked` -- the roots,
    from the dense [N, N] touching matrix or from column blocks
    (:func:`collision_parents_chunked`, the plain version of the CUDA root
    search in ``csrc/collision_roots.cu``), then :func:`pointer_jump`.
  * :func:`merge_groups` -- each chain's mass, momentum, mass-weighted
    centre and summed R^3 into its root; the others dead and parked far.

Resolve (``resolve_outcomes*``) is not ported yet: ROADMAP.md queue A item
A.7b.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["bounce_deltas", "bounce_deltas_chunked", "count_contacts_dense",
           "count_contacts_chunked", "restitution_clip", "collision_roots",
           "collision_roots_chunked", "collision_parents_chunked", "pointer_jump",
           "merge_groups"]


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


def _touching(pos_i, radius_i, alive_i, pos_j, radius_j, alive_j):
    """JAX's touching test (``_pair_geometry``) of rows i against columns j:
    ``sqrt((dx dx + dy dy) + dz dz) <= R_i + R_j``, ``dist > 0``, both
    alive, with dx = r_i - r_j."""
    dx = pos_i[:, None, 0] - pos_j[None, :, 0]
    dy = pos_i[:, None, 1] - pos_j[None, :, 1]
    dz = pos_i[:, None, 2] - pos_j[None, :, 2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return ((dist <= radius_i[:, None] + radius_j[None, :]) & (dist > 0.0)
            & alive_i[:, None] & alive_j[None, :])


def pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """Roots of monotone parents (``parent[j] <= j``): ceil(log2 N) rounds
    of ``root = root[root]``, as the JAX module runs them."""
    root = parent
    for _ in range(max(1, int(parent.shape[0] - 1).bit_length())):
        root = root[root]
    return root


def collision_roots(pos, radius, alive):
    """Lowest-index root of each overlap chain: parent[j] = min{i < j :
    touching(i, j)} (else j) over the dense [N, N] matrix, then
    :func:`pointer_jump`."""
    n = pos.shape[0]
    idx = torch.arange(n, device=pos.device)
    lower = _touching(pos, radius, alive, pos, radius, alive) & (idx[:, None] < idx[None, :])
    parent = torch.where(lower, idx[:, None], n).amin(0)
    return pointer_jump(torch.minimum(parent, idx))


def _column_chunk(n: int, chunk: int) -> int:
    """The JAX module's column block: ``min(chunk, n)`` halved until it
    divides n."""
    chunk = min(int(chunk), n)
    while chunk > 1 and n % chunk:
        chunk //= 2
    return max(chunk, 1)


def collision_parents_chunked(pos, radius, alive, *, chunk: int = 512):
    """parent[j] = min(j, min{i < j : touching(i, j)}) by column blocks of
    [N, chunk] (O(N chunk) memory): the plain version of the CUDA root
    search."""
    n = pos.shape[0]
    chunk = _column_chunk(n, chunk)
    ids = torch.arange(n, device=pos.device)
    parts = []
    for start in range(0, n, chunk):
        cols = ids[start:start + chunk]
        touching = _touching(pos, radius, alive, pos[start:start + chunk],
                             radius[start:start + chunk], alive[start:start + chunk])
        touching &= ids[:, None] < cols[None, :]
        parts.append(torch.minimum(torch.where(touching, ids[:, None], n).amin(0), cols))
    return torch.cat(parts) if parts else ids


def collision_roots_chunked(pos, radius, alive, *, chunk: int = 512):
    """Column-blocked :func:`collision_roots` (the JAX module's chunk rule)."""
    return pointer_jump(collision_parents_chunked(pos, radius, alive, chunk=chunk))


def merge_groups(pos, vel, mass, radius, alive, *, chunk=None,
                 root: Optional[torch.Tensor] = None):
    """Merge every overlap chain into its lowest-index member.

    Conserves mass and momentum; the merged position is the mass-weighted
    centre and the merged radius is volume-additive (reference:
    core/physics.py:519-531). Non-root members become dead: alive False,
    mass, velocity and radius 0, parked at far (1 + 1e-3 idx, 1, 1) with
    far = 1e8 (1 + max live |pos|), capped at 1e17 in float32 (out of reach
    of any live radius, mutually non-coincident). Returns (pos, vel, mass,
    radius, alive).

    ``root`` is each body's chain root (e.g. the CUDA root search's); when
    None it is computed dense, or by column blocks with ``chunk``, as the JAX
    module does. Each group is summed in member-index order (a stable sort
    on the root, then one sequential sum a segment), never by atomics, so a
    merge is the same from run to run on every device."""
    n, dev = pos.shape[0], pos.device
    if root is None:
        root = (collision_roots_chunked(pos, radius, alive, chunk=min(int(chunk), n))
                if chunk else collision_roots(pos, radius, alive))
    idx = torch.arange(n, device=dev)
    is_root = root == idx

    # segment sums over the roots 0..n-1 in member order: m, m v, m r, R^3,
    # live count (exact in the float type for any n below 2^24)
    vals = torch.cat([mass[:, None], mass[:, None] * vel, mass[:, None] * pos,
                      (radius ** 3)[:, None], alive.to(pos.dtype)[:, None]], dim=1)
    order = torch.argsort(root, stable=True)
    offsets = torch.searchsorted(root[order], torch.arange(n + 1, device=dev))
    seg = torch.segment_reduce(vals[order], "sum", offsets=offsets, axis=0, initial=0.0)
    m_seg, p_seg, mr_seg, r3_seg, size_seg = (seg[:, 0], seg[:, 1:4], seg[:, 4:7],
                                              seg[:, 7], seg[:, 8])

    # only members of a multi-body chain change; the rest (massless tracers
    # included) pass through untouched
    changed = size_seg[root] > 1
    absorbed = changed & ~is_root
    merged_root = changed & is_root
    safe_m = torch.where(m_seg > 0.0, m_seg, 1.0)[:, None]
    zero = torch.zeros((), dtype=pos.dtype, device=dev)
    new_mass = torch.where(merged_root, m_seg, torch.where(absorbed, zero, mass))
    new_vel = torch.where(merged_root[:, None], p_seg / safe_m,
                          torch.where(absorbed[:, None], zero, vel))
    # absorbed bodies park far off the live scene (index-spaced so that no
    # two coincide, even in float32)
    live_mag = torch.max(torch.abs(pos) * alive[:, None].to(pos.dtype))
    far = 1e8 * (1.0 + live_mag)
    if pos.dtype == torch.float32:
        far = torch.clamp(far, max=1e17)  # keep far^2 finite in float32
    ones = torch.ones((n,), dtype=pos.dtype, device=dev)
    far_pos = torch.stack([far * (1.0 + 1e-3 * idx.to(pos.dtype)), ones * far, ones * far],
                          dim=-1)
    new_pos = torch.where(merged_root[:, None], mr_seg / safe_m,
                          torch.where(absorbed[:, None], far_pos, pos))
    new_radius = torch.where(merged_root, torch.pow(r3_seg, 1.0 / 3.0),
                             torch.where(absorbed, zero, radius))
    return new_pos, new_vel, new_mass, new_radius, alive & ~absorbed
