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

And resolve mode, the outcome model (reference: core/physics.py:361-388):
absorption above a mass ratio of 10, fragmentation with a logistic
probability in the collision energy (with optional debris), elastic bounce
for the rest.

  * :func:`resolve_outcomes` -- one simultaneous round over dense [N, N]
    pair matrices, its random draws passed in.
  * :func:`resolve_outcomes_subset` -- the touching bodies (and dead slots
    for debris) gathered into a small dense scene, resolved, and scattered
    back: the path above 4096 bodies, and on CUDA tensors at every N.
  * :func:`contact_marks_chunked` -- the row blocks that mark every body in
    contact (the plain version of the CUDA sweep's mark mode).
  * :func:`resolve_draws` -- the draws, on the device, from a counter-based
    hash of (frag_seed, step, pair): the JAX package's threefry cannot be
    reproduced, so its draws are inputs here and parity tests pass JAX's in.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["bounce_deltas", "bounce_deltas_chunked", "count_contacts_dense",
           "count_contacts_chunked", "restitution_clip", "collision_roots",
           "collision_roots_chunked", "collision_parents_chunked", "pointer_jump",
           "merge_groups", "contact_marks_chunked", "resolve_draws", "resolve_outcomes",
           "resolve_outcomes_subset"]


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


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``vals`` [M, C] summed by segment ``seg`` [M] into [n, C], each
    segment in member-index order (a stable sort on ``seg``, then one
    sequential sum a segment): the same bits from run to run on every
    device, where ``index_add_`` on CUDA adds by atomics in no fixed order."""
    order = torch.argsort(seg, stable=True)
    offsets = torch.searchsorted(seg[order], torch.arange(n + 1, device=seg.device))
    return torch.segment_reduce(vals[order], "sum", offsets=offsets, axis=0, initial=0.0)


def _far_positions(pos: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Park positions [N, 3] off the live scene: far (1 + 1e-3 idx, 1, 1),
    far = 1e8 (1 + max live |pos|), capped at 1e17 in float32 (far^2 stays
    finite); index-spaced so that no two coincide, even in float32."""
    n = pos.shape[0]
    live_mag = torch.max(torch.abs(pos) * alive[:, None].to(pos.dtype))
    far = 1e8 * (1.0 + live_mag)
    if pos.dtype == torch.float32:
        far = torch.clamp(far, max=1e17)
    ones = torch.ones((n,), dtype=pos.dtype, device=pos.device)
    idx = torch.arange(n, device=pos.device).to(pos.dtype)
    return torch.stack([far * (1.0 + 1e-3 * idx), ones * far, ones * far], dim=-1)


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
    module does. Each group is summed in member-index order
    (:func:`_segment_sum`), never by atomics, so a merge is the same from
    run to run on every device."""
    n, dev = pos.shape[0], pos.device
    if root is None:
        root = (collision_roots_chunked(pos, radius, alive, chunk=min(int(chunk), n))
                if chunk else collision_roots(pos, radius, alive))
    idx = torch.arange(n, device=dev)
    is_root = root == idx

    # segment sums over the roots 0..n-1: m, m v, m r, R^3, live count
    # (exact in the float type for any n below 2^24)
    seg = _segment_sum(torch.cat([mass[:, None], mass[:, None] * vel, mass[:, None] * pos,
                                  (radius ** 3)[:, None], alive.to(pos.dtype)[:, None]],
                                 dim=1), root, n)
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
    new_pos = torch.where(merged_root[:, None], mr_seg / safe_m,
                          torch.where(absorbed[:, None], _far_positions(pos, alive), pos))
    new_radius = torch.where(merged_root, torch.pow(r3_seg, 1.0 / 3.0),
                             torch.where(absorbed, zero, radius))
    return new_pos, new_vel, new_mass, new_radius, alive & ~absorbed


def contact_marks_chunked(pos, radius, alive, *, chunk: int = 1024):
    """touch_any [N] (bool): each body touching any other, by row blocks of
    [chunk, N] (JAX's ``i_block`` in ``resolve_outcomes_subset``: the sqrt
    test of ``_pair_geometry``, ``dist > 0`` excluding the body itself).
    The plain version of the CUDA sweep's mark mode."""
    n = pos.shape[0]
    parts = [_touching(pos[s:s + chunk], radius[s:s + chunk], alive[s:s + chunk],
                       pos, radius, alive).any(1) for s in range(0, n, chunk)]
    return torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.bool,
                                                      device=pos.device)


# resolve_draws' counter hash: a 32-bit mixer (xor-shift and multiply) in
# int64 torch ops; every product stays below 2^59, so no int64 overflow
_M32 = 0xFFFFFFFF
_MIX, _CHAIN = 0x45D9F3B, 0x6A09E667


def _hash32(*words):
    """A 32-bit hash (as int64 in [0, 2^32)) of a sequence of words, each an
    int or an int64 tensor in [0, 2^32); tensors broadcast."""
    h = 0
    for w in words:
        h = ((h * _CHAIN) & _M32) ^ w
        for _ in range(2):
            h = h ^ (h >> 16)
            h = (h * _MIX) & _M32
        h = h ^ (h >> 16)
    return h


def resolve_draws(frag_seed: int, step, T: int, B: int, K: int, *,
                  dtype: torch.dtype = torch.float32, device=None):
    """The random draws of one resolve round: ``(u [T, T], d [B, K, 3] or
    None)``, made on the device from a counter-based hash of (frag_seed,
    step, counter), with no host read of ``step`` (the state's 0-dim step
    counter, or an int).

    ``u`` is the fragmentation roll, uniform in [0, 1) on a 2^-24 grid and
    symmetric by construction (counter min(i, j) T + max(i, j)); ``d`` the
    debris spread directions, standard normals by Box-Muller from two such
    uniforms (counters from T^2 on; None when ``K`` or ``B`` is 0).
    Deterministic for (frag_seed, step) and fresh at every step, as the JAX
    stepper's ``fold_in(PRNGKey(frag_seed), step)`` key is; its threefry
    bits are not reproduced, so a rollout agrees with JAX's in distribution
    only."""
    if T * T + 6 * B * K >= 2 ** 32:
        raise ValueError(f"resolve_draws: T={T} is past the 32-bit counter (T < 65,536)")
    if isinstance(step, torch.Tensor):
        device = step.device if device is None else device
        step = step.to(device=device, dtype=torch.int64) & _M32
    else:
        step = int(step) & _M32
    key = _hash32(int(frag_seed) & _M32, step)
    i = torch.arange(T, device=device, dtype=torch.int64)
    pair = torch.minimum(i[:, None], i[None, :]) * T + torch.maximum(i[:, None], i[None, :])
    grid = 2.0 ** -24
    u = (_hash32(key, pair) >> 8).to(dtype) * grid
    if K <= 0 or B <= 0:
        return u, None
    c = T * T + torch.arange(2 * B * K * 3, device=device, dtype=torch.int64)
    u12 = ((_hash32(key, c) >> 8).to(dtype) * grid).reshape(2, B, K, 3)
    d = torch.sqrt(-2.0 * torch.log1p(-u12[0])) * torch.cos((2.0 * math.pi) * u12[1])
    return u, d


def _inv(x):
    pos_x = x > 0.0
    return torch.where(pos_x, 1.0 / torch.where(pos_x, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def resolve_outcomes(pos, vel, mass, radius, alive, u, d=None, *,
                     restitution: float = 1.0, debris_k: int = 0, debris_max_pairs: int = 4,
                     debris_energy_frac: float = 0.3, debris_sep: float = 1.0):
    """The collision outcome model as one simultaneous masked round, over
    dense [N, N] pair matrices (the JAX package's ``resolve_outcomes``).

    For each touching pair of live bodies: a mass ratio > 10 is an
    **absorption** (the smaller body dies into its largest absorber, ties to
    the lowest index; the absorber gains mass and volume-additive radius and
    keeps its position and velocity, as the reference does); otherwise the
    pair **fragments** when ``u[i, j] < sigmoid(5 (E_coll / E_thresh - 1))``,
    E_coll = mu v_rel^2 / 2, E_thresh = (m_i + m_j) 1e3 / 2 (both bodies
    die); the rest **bounce** elastically with ``restitution``. Outcomes
    classify from the pre-round state, fragmentation before absorption
    before bounce for each body. New dead bodies are parked far, massless,
    without radius.

    With ``debris_k`` = K > 0, up to B = min(debris_max_pairs, N // K)
    mutually-first fragmenting pairs each spawn K fragments into K slots
    that were dead at entry (only if all K are free): the pair's mass split
    equally, its momentum kept by zero-sum spread velocities carrying
    ``debris_energy_frac`` of E_coll, its volume split K ways, placed
    ``debris_sep`` (R_i + R_j) from the pair's centre of mass.

    ``u`` [N, N] is the fragmentation roll (only its upper triangle is read:
    it is symmetrised as JAX symmetrises its draw) and ``d`` [B, K, 3] the
    debris spread directions, from :func:`resolve_draws` or, in tests,
    JAX's own ``jax.random`` draws. Returns (pos, vel, mass, radius,
    alive)."""
    n, dev, dt = pos.shape[0], pos.device, pos.dtype
    (nx, ny, nz), dist, touching = _pair_geometry(pos, radius, alive)
    idx = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    m_i, m_j = mass[:, None], mass[None, :]
    m_small = torch.minimum(m_i, m_j)
    m_small_safe = torch.where(m_small > 0.0, m_small, one)
    absorb = touching & (m_small > 0.0) & (torch.maximum(m_i, m_j) > 10.0 * m_small_safe)

    upper = idx[:, None] < idx[None, :]
    u = torch.where(upper, u, u.T)
    dv = vel[:, None, :] - vel[None, :, :]
    v_rel2 = torch.sum(dv * dv, dim=-1)
    m_sum = m_i + m_j
    mu_red = m_i * m_j / torch.where(m_sum > 0.0, m_sum, one)
    e_coll = 0.5 * mu_red * v_rel2
    e_thresh = 0.5 * m_sum * 1e3
    p_frag = torch.sigmoid(5.0 * (e_coll / torch.where(e_thresh > 0.0, e_thresh, one) - 1.0))
    frag = touching & ~absorb & (u < p_frag)

    # fragmentation: both ends of any fragmenting pair die
    frag_dead = torch.any(frag, dim=1)
    # absorption: the smaller side dies into its largest live absorber (the
    # ratio > 10 is strict, so a pair's smaller body is unique)
    is_smaller = absorb & (m_i < m_j) & ~frag_dead[:, None] & ~frag_dead[None, :]
    absorbed_dead = torch.any(is_smaller, dim=1)
    absorber = torch.argmax(torch.where(is_smaller, m_j, -one), dim=1)
    gained = _segment_sum(torch.stack([torch.where(absorbed_dead, mass, zero),
                                       torch.where(absorbed_dead, radius ** 3, zero)], dim=1),
                          absorber, n)
    gained_m, gained_r3 = gained[:, 0], gained[:, 1]

    dead = frag_dead | absorbed_dead
    new_mass = torch.where(dead, zero, mass + gained_m)
    # bodies that absorbed nothing keep their radius bit for bit
    new_radius = torch.where(dead, zero, torch.where(
        gained_r3 > 0.0, torch.pow(radius ** 3 + gained_r3, 1.0 / 3.0), radius))
    new_alive = alive & ~dead

    # elastic bounce for the remaining touching pairs
    survive_pair = ~dead[:, None] & ~dead[None, :]
    dv_n = dv[..., 0] * nx + dv[..., 1] * ny + dv[..., 2] * nz
    active = touching & ~absorb & ~frag & survive_pair & (dv_n < 0.0)
    inv_m = _inv(mass)
    inv_m_sum = inv_m[:, None] + inv_m[None, :]
    e = restitution_clip(restitution)
    j_mag = torch.where(active, -(1.0 + e) * dv_n / inv_m_sum, zero)
    scale_v = j_mag * inv_m[:, None]
    dvel = torch.stack([torch.sum(scale_v * nx, dim=1), torch.sum(scale_v * ny, dim=1),
                        torch.sum(scale_v * nz, dim=1)], dim=-1)
    overlap = radius[:, None] + radius[None, :] - dist
    corr = torch.where(active & (overlap > 0.0), overlap / inv_m_sum, zero)
    scale_r = corr * inv_m[:, None]
    dpos = torch.stack([torch.sum(scale_r * nx, dim=1), torch.sum(scale_r * ny, dim=1),
                        torch.sum(scale_r * nz, dim=1)], dim=-1)

    new_pos = torch.where(dead[:, None], _far_positions(pos, new_alive), pos + dpos)
    new_vel = torch.where(dead[:, None], zero, vel + dvel)
    K = int(debris_k)
    B = min(int(debris_max_pairs), n // K) if K > 0 else 0
    if B <= 0:
        return new_pos, new_vel, new_mass, new_radius, new_alive
    if d is None or tuple(d.shape) != (B, K, 3):
        raise ValueError(f"resolve_outcomes: debris_k={K} needs d of shape {(B, K, 3)}")

    # debris into entry-dead slots: mutually-first fragmenting pairs (chain
    # members that are not each other's first partner die without debris)
    partner = torch.argmax(frag.to(torch.uint8), dim=1)
    mutual = frag_dead & (partner[partner] == idx) & (idx < partner)
    pi = torch.argsort((~mutual).to(torch.uint8), stable=True)[:B]   # matched rows first
    pj = partner[pi]
    free = ~alive
    # the first B K entry-dead slots, K a pair; a pair spawns only if all K
    # of its slots are free (a partial spawn would break conservation)
    slots = torch.argsort((~free).to(torch.uint8), stable=True)[:B * K].reshape(B, K)
    spawn = mutual[pi] & torch.all(free[slots], dim=1)

    m1, m2 = mass[pi], mass[pj]
    mt = m1 + m2
    mt_safe = torch.where(mt > 0.0, mt, one)[:, None]
    x_com = (m1[:, None] * pos[pi] + m2[:, None] * pos[pj]) / mt_safe
    v_com = (m1[:, None] * vel[pi] + m2[:, None] * vel[pj]) / mt_safe
    # zero-sum spread directions: the momentum is kept exactly
    e_vec = d.to(dt) - torch.mean(d.to(dt), dim=1, keepdim=True)
    m_f = mt / K
    e2sum = torch.sum(e_vec * e_vec, dim=(1, 2))
    ke = debris_energy_frac * e_coll[pi, pj]
    s = torch.sqrt(2.0 * ke / (torch.where(e2sum > 0.0, e2sum, one)
                               * torch.where(m_f > 0.0, m_f, one)))
    s = torch.where(e2sum > 0.0, s, zero)
    v_frag = v_com[:, None, :] + s[:, None, None] * e_vec
    e_norm = torch.sqrt(torch.sum(e_vec * e_vec, dim=-1, keepdim=True))
    u_vec = e_vec / torch.where(e_norm > 0.0, e_norm, one)
    sep = debris_sep * (radius[pi] + radius[pj])
    x_frag = x_com[:, None, :] + sep[:, None, None] * u_vec
    r_f = torch.pow((radius[pi] ** 3 + radius[pj] ** 3) / K, 1.0 / 3.0)

    flat = slots.reshape(-1)   # unique indices: a prefix of a permutation
    okf = torch.repeat_interleave(spawn, K)
    ok3 = okf[:, None]
    new_mass = new_mass.index_copy(0, flat, torch.where(okf, m_f.repeat_interleave(K),
                                                        new_mass[flat]))
    new_radius = new_radius.index_copy(0, flat, torch.where(okf, r_f.repeat_interleave(K),
                                                            new_radius[flat]))
    new_alive = new_alive.index_copy(0, flat, okf | new_alive[flat])
    new_pos = new_pos.index_copy(0, flat, torch.where(ok3, x_frag.reshape(-1, 3),
                                                      new_pos[flat]))
    new_vel = new_vel.index_copy(0, flat, torch.where(ok3, v_frag.reshape(-1, 3),
                                                      new_vel[flat]))
    return new_pos, new_vel, new_mass, new_radius, new_alive


def resolve_sizes(n: int, subset: Optional[int], debris_k: int,
                  debris_max_pairs: int) -> tuple[int, int]:
    """(T, B): the bodies of the dense scene a resolve round runs on (n, or
    min(n, subset + debris_max_pairs debris_k) for the subset path when
    ``subset`` is given) and its debris budget B = min(debris_max_pairs,
    T // debris_k) (0 without debris): the shapes of its draws."""
    K = int(debris_k)
    T = n if subset is None else min(n, int(subset) + (int(debris_max_pairs) * K if K > 0
                                                       else 0))
    return T, (min(int(debris_max_pairs), T // K) if K > 0 else 0)


def resolve_outcomes_subset(pos, vel, mass, radius, alive, u, d=None, *, subset: int = 512,
                            chunk: int = 1024, touch_any: Optional[torch.Tensor] = None,
                            **kw):
    """:func:`resolve_outcomes` past the dense [N, N] ceiling (the JAX
    package's ``resolve_outcomes_subset``): every body in contact is marked
    (``touch_any``, given, e.g. by the CUDA sweep's mark mode, or
    :func:`contact_marks_chunked` in row blocks of ``chunk``); one stable
    priority sort (contacts, then dead slots for debris, then the rest)
    picks T = min(N, subset + debris_max_pairs debris_k) rows; the dense
    model runs on that scene with ``u`` [T, T] and ``d``; the results
    scatter back through the (unique) gathered indices. Bodies outside it
    pass through unchanged.

    Returns (pos, vel, mass, radius, alive, deferred), ``deferred`` (int32,
    on the device) the touching bodies beyond ``subset`` this round: they
    are still in contact next step and resolved then."""
    n = pos.shape[0]
    T, _ = resolve_sizes(n, subset, kw.get("debris_k", 0), kw.get("debris_max_pairs", 4))
    if touch_any is None:
        touch_any = contact_marks_chunked(pos, radius, alive, chunk=chunk)
    deferred = torch.clamp(torch.sum(touch_any, dtype=torch.int32) - int(subset), min=0)
    prio = torch.where(touch_any, 0, torch.where(alive, 2, 1)).to(torch.int32)
    idx = torch.argsort(prio, stable=True)[:T]
    out = resolve_outcomes(pos[idx], vel[idx], mass[idx], radius[idx], alive[idx], u, d, **kw)
    return tuple(a.index_copy(0, idx, b) for a, b in
                 zip((pos, vel, mass, radius, alive), out)) + (deferred,)
