r"""Multilevel tree gravity: multipole far field by convolution + exact near
field over chunk pairs (``near="kernel"``).

A port of ``orbital_tpu/ops/tree.py``. How the pairs are partitioned across
levels, and why the far field is a convolution, is that module's docstring.
In short: level ``l`` has ``2^l`` cells per side; a pair whose level-``l``
cells are more than ``ws`` cells apart while their parents are within
``ws`` is claimed by level ``l``, every other pair by the exact near sweep
over the finest cells. The far field anchors source moments (monopole,
dipole, and the quadrupole at ``order=2``) and target expansions
(acceleration A, Jacobian J, Hessian H at ``order=2``, potential phi) at
cell centers, so every level's sweep is a convolution of octant-packed
moment channels with static taps, followed by a Taylor push-down to the
next level's centers and a final per-body Taylor step.

What the port carries over, and what it changes:

  * The far field with the default ``"push"`` combine and the octant-major
    finest layout (``far_id``), with the same channel arithmetic. Each
    level runs as ONE ``conv3d`` over [8 Mo, s, s, s] (channels first, x y
    z); the JAX module runs 2ws+1 batched 2-D convolutions with x-plane
    shifts because 3-D convolutions compiled badly on its TPU. The conv
    is a library call outside any kernel and runs in full float32: cuDNN's
    TF32 is switched off around it (``_level_conv``), as the JAX module asks
    for ``Precision.HIGHEST``. The layout-study flags ``"lazy"`` and
    ``_FAR_NHWC`` are not ported (ROADMAP.md A.13).
  * The near field for ``near="kernel"`` only (``ops/tree_near_wl.py`` and
    its CUDA kernel); ``"cells"``, ``"columns"`` and ``"pairs"`` raise
    ``NotImplementedError`` (A.13), as do the sharded arguments (A.15).
  * The stable multi-payload sort is ``torch.sort(stable=True)`` and
    gathers. The NGP deposit is ``index_add_``, which on CUDA uses float
    atomics: the deposited moments, and so the far field, may differ in
    the last bits between runs on the card (never on the CPU).
  * The budget probes take host or CPU arrays, run torch on the CPU and
    return Python ints; they stand in for the JAX module's CPU-pinned
    ``_host_probe``. The force itself never reads a value back to the
    host: its overflow stays a device int32 tensor.

Also here, shared with the multirate stepper's neighbor search
(``ops/neighbor.py``): ``_compact_sorted``, ``_segment_bounds`` and
``_pairs_geometry`` in its per-column rank-table form (``_PAIRS_CF ==
"table"``); the JAX module's suffix-scan locator exists only to get a TPU
compile through (tree.py:1393-1400) and is left out. That code is eager
integer tensor code: ``jnp.nonzero(size=K)`` becomes a cumsum-and-scatter
compaction, ``.at[].set(mode="drop")`` a scatter into one spare row that is
sliced off, ``.at[].min`` a ``scatter_reduce``, the associative min/max
scans ``cummin``/``cummax`` (reversed by flipping). Indices are int64
inside; the integer results equal the JAX module's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .pm import _bounding_cube

__all__ = ["tree_acc_potential", "tree_acc_potential_staged", "tree_occupancy_probe",
           "tree_stencil", "_compact_sorted", "_segment_bounds", "_pairs_geometry"]

i64 = torch.int64
f32 = torch.float32

# the near modes of the JAX module; only "kernel" is ported
_NEAR_MODES = ("cells", "columns", "pairs", "kernel")


def _check_near(near: str) -> None:
    if near not in _NEAR_MODES:
        raise ValueError("near must be 'cells', 'columns', 'pairs', or 'kernel'")
    if near != "kernel":
        raise NotImplementedError(
            f"tree near={near!r} is not ported to orbital_tpu_torch yet (ROADMAP.md "
            "queue A item A.13); the port's tree near field is near='kernel'")


def tree_stencil(ws: int) -> list[tuple[int, int, int]]:
    """Static claim stencil: all offsets with ``ws < max|d| <= 2 ws + 1``."""
    p = 2 * ws + 1
    return [(a, b, c) for a in range(-p, p + 1) for b in range(-p, p + 1)
            for c in range(-p, p + 1) if max(abs(a), abs(b), abs(c)) > ws]


def _apply_sym(j6: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a symmetric 3x3 (packed xx,yy,zz,xy,xz,yz) to vectors [..., 3]."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    ax = j6[..., 0] * vx + j6[..., 3] * vy + j6[..., 4] * vz
    ay = j6[..., 3] * vx + j6[..., 1] * vy + j6[..., 5] * vz
    az = j6[..., 4] * vx + j6[..., 5] * vy + j6[..., 2] * vz
    return torch.stack([ax, ay, az], dim=-1)


# ---------------------------------------------------------------------------
# far field: octant-channel convolution
# ---------------------------------------------------------------------------

# channel layouts (octant index o = ox*4 + oy*2 + oz).
# order 1: moments (m, px, py, pz); fields (A 3, J 6, phi 1).
# order 2: + quadrupole Q (6, packed xx yy zz xy xz yz) in, + Hessian H
# (18, H[i,(jk)] i-major) out.
_N_MOM = {1: 4, 2: 10}
_N_FLD = {1: 10, 2: 28}
# symmetric 6-pack contraction weights (off-diagonals appear twice)
_C6 = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)
_Q6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _conv_taps(ws: int) -> dict:
    """Static tap geometry: {Dx: [((Dy, Dz), d, o_t, o_s), ...]} grouped by
    parent x-offset. Claim: max|2D + o_s - o_t| > ws."""
    octs = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    groups: dict = {}
    for Dx in range(-ws, ws + 1):
        for Dy in range(-ws, ws + 1):
            for Dz in range(-ws, ws + 1):
                for ot in octs:
                    for os_ in octs:
                        d = (2 * Dx + os_[0] - ot[0], 2 * Dy + os_[1] - ot[1],
                             2 * Dz + os_[2] - ot[2])
                        if max(abs(c) for c in d) <= ws:
                            continue
                        groups.setdefault(Dx, []).append(((Dy, Dz), d, ot, os_))
    return groups


def _conv_weights(ws: int, h: torch.Tensor, G: float, eps2: float,
                  order: int) -> torch.Tensor:
    """3-D conv weights [..., 8F, 8Mo, p, p, p] (p = 2ws+1, kernel axes x y
    z at index D + ws) for cell widths ``h`` [...] (one set per entry of
    ``h``: every level's taps in one pass). The x-slab ``[..., Dx + ws]`` is
    the JAX module's ``_conv_weights(...)[Dx]``, with the same arithmetic.
    Tap weight blocks follow the source-shift Taylor expansion about cell
    centers with r = c_target - c_source = -d*h, R^2 = |r|^2 + eps2:
      A   +=  m W_A       - J p       + 1/2 T : Q      (W_A = -G r / R^3)
      J   +=  m J         - T p                  (J_ij = 3G r_i r_j/R^5
                                                        - G delta_ij/R^3)
      H   +=  m T                     (T_ijk = d J_ij / d r_k, order 2)
      phi +=  m g         + W_A . p   - 1/2 J : Q         (g = -G / R)
    """
    p = 2 * ws + 1
    F, Mo = _N_FLD[order], _N_MOM[order]
    taps = [(Dx,) + t for Dx, ts in _conv_taps(ws).items() for t in ts]
    dev = h.device
    dvec = torch.tensor(np.array([t[2] for t in taps], np.float32), device=dev).to(h.dtype)
    kx = torch.tensor([t[0] + ws for t in taps], device=dev)
    ky = torch.tensor([t[1][0] + ws for t in taps], device=dev)
    kz = torch.tensor([t[1][1] + ws for t in taps], device=dev)
    o_t = torch.tensor([t[3][0] * 4 + t[3][1] * 2 + t[3][2] for t in taps], device=dev)
    o_s = torch.tensor([t[4][0] * 4 + t[4][1] * 2 + t[4][2] for t in taps], device=dev)
    n_t = len(taps)

    r = -dvec * h[..., None, None]                          # [..., T, 3]
    R2 = torch.sum(r * r, dim=-1) + eps2
    inv = torch.rsqrt(R2)
    inv3 = inv * inv * inv
    inv5 = inv3 * inv * inv
    inv7 = inv5 * inv * inv
    W_A = -G * r * inv3[..., None]                          # [..., T, 3]
    rc = [r[..., 0], r[..., 1], r[..., 2]]

    def Jel(i, j):
        base = 3.0 * G * rc[i] * rc[j] * inv5
        return base - G * inv3 if i == j else base

    Jt = [Jel(*q) for q in _Q6]                             # 6 x [..., T]
    g = -G * inv
    zero = torch.zeros_like(g)
    # blk[f][mo]: the tap weight of moment mo into field f, [..., T]
    blk = [[zero] * Mo for _ in range(F)]
    phi_row = F - 1
    for k in range(3):
        blk[k][0] = W_A[..., k]                             # m -> A
        blk[phi_row][1 + k] = W_A[..., k]                   # p -> phi: W_A . p
    for q in range(6):
        blk[3 + q][0] = Jt[q]                               # m -> J
    blk[phi_row][0] = g
    Jm = ((0, 3, 4), (3, 1, 5), (4, 5, 2))
    for i in range(3):
        for k in range(3):
            blk[i][1 + k] = -Jt[Jm[i][k]]                   # p -> A: -J p
    if order == 2:
        def Tel(i, j, k):
            t = -5.0 * G * rc[i] * rc[j] * rc[k] * inv7 * 3.0
            if i == j:
                t = t + 3.0 * G * rc[k] * inv5
            if i == k:
                t = t + 3.0 * G * rc[j] * inv5
            if j == k:
                t = t + 3.0 * G * rc[i] * inv5
            return t

        Tp = [[Tel(i, q[0], q[1]) for q in _Q6] for i in range(3)]
        for i in range(3):
            for q in range(6):
                blk[9 + i * 6 + q][0] = Tp[i][q]            # m -> H
        for qi, (i, j) in enumerate(_Q6):
            for k in range(3):
                blk[3 + qi][1 + k] = -Tel(i, j, k)          # p -> J: -T p
        for i in range(3):
            for q in range(6):
                blk[i][4 + q] = 0.5 * _C6[q] * Tp[i][q]     # Q -> A
        for q in range(6):
            blk[phi_row][4 + q] = -0.5 * _C6[q] * Jt[q]     # Q -> phi

    vals = torch.stack([torch.stack(row, dim=-1) for row in blk], dim=-2)  # [..., T, F, Mo]
    batch = tuple(h.shape)
    w = torch.zeros(batch + (8 * F, 8 * Mo, p, p, p), dtype=h.dtype, device=dev)
    oc = (o_t[:, None] * F + torch.arange(F, device=dev)[None, :])[:, :, None]
    ic = (torch.arange(Mo, device=dev)[None, :] * 8 + o_s[:, None])[:, None, :]
    shape = (n_t, F, Mo)
    idx = tuple(t.expand(shape) for t in (oc, ic, kx[:, None, None], ky[:, None, None],
                                          kz[:, None, None]))
    for b in np.ndindex(*batch):
        w[b].index_put_(idx, vals[b], accumulate=True)
    return w


def _level_conv(moments: torch.Tensor, w: torch.Tensor, ws: int) -> torch.Tensor:
    """One level's far-field sweep: octant-packed parent moments [8 Mo, s,
    s, s] -> per-target-octant fields [8 F, s, s, s]. Zero padding at the
    grid edge is exact (cells outside the grid are empty). cuDNN runs it in
    full float32 (its TF32 default would keep ~3 decimal digits of the far
    field)."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return torch.nn.functional.conv3d(moments[None], w, padding=ws)[0]


def _coarsen2(c: torch.Tensor, mm: int) -> torch.Tensor:
    """2x2x2-coarsen a flat x-major ``[(2 mm)^3]`` grid to ``[mm^3]``, one
    axis at a time (the JAX module's summation order)."""
    M = 2 * mm
    g = c.reshape(M, M, M)
    g = g[:, :, 0::2] + g[:, :, 1::2]
    g = g[:, 0::2, :] + g[:, 1::2, :]
    g = g[0::2, :, :] + g[1::2, :, :]
    return g.reshape(-1)


def _octant_pack(flat_chans, m: int) -> torch.Tensor:
    """Mo flat x-major [m^3] moment grids -> octant-packed parent grid [8 Mo,
    s, s, s] (s = m/2; channel = moment*8 + octant, octant = ox*4+oy*2+oz)."""
    s = m // 2
    parts = [c.reshape(s, 2, s, 2, s, 2).permute(1, 3, 5, 0, 2, 4).reshape(8, s, s, s)
             for c in flat_chans]
    return torch.cat(parts, dim=0)


def _unpack_fields(out: torch.Tensor, n_fields: int) -> tuple:
    """Conv output [8 F, s, s, s] -> F flat x-major child-grid channels
    [m^3] (m = 2s)."""
    s = out.shape[1]
    g = out.reshape(2, 2, 2, n_fields, s, s, s).permute(3, 4, 0, 5, 1, 6, 2)
    g = g.reshape(n_fields, -1)
    return tuple(g[f] for f in range(n_fields))


def _taylor_shift(up, d, dx, dy, dz, order: int) -> tuple:
    """Shift field expansions by delta = (dx, dy, dz) (target center -
    source center): the same channel tuple re-expanded about the shifted
    centers, keeping every term available at this order. ``up`` maps a flat
    channel to its broadcast-ready view. Channel layout: A (3), J (6: xx yy
    zz xy xz yz), [order 2: H (18)], phi."""
    A = [up(d[k]) for k in range(3)]
    J = [up(d[3 + q]) for q in range(6)]
    phi = up(d[-1])
    Ax_c = A[0] + J[0] * dx + J[3] * dy + J[4] * dz
    Ay_c = A[1] + J[3] * dx + J[1] * dy + J[5] * dz
    Az_c = A[2] + J[4] * dx + J[5] * dy + J[2] * dz
    phi_c = phi - (A[0] * dx + A[1] * dy + A[2] * dz) - 0.5 * (
        J[0] * dx * dx + J[1] * dy * dy + J[2] * dz * dz
        + 2.0 * (J[3] * dx * dy + J[4] * dx * dz + J[5] * dy * dz))
    if order == 1:
        return (Ax_c, Ay_c, Az_c) + tuple(J) + (phi_c,)
    H = [up(d[9 + t]) for t in range(18)]

    def hquad(i):
        b = i * 6
        return (H[b + 0] * dx * dx + H[b + 1] * dy * dy + H[b + 2] * dz * dz
                + 2.0 * (H[b + 3] * dx * dy + H[b + 4] * dx * dz + H[b + 5] * dy * dz))

    Ax_c = Ax_c + 0.5 * hquad(0)
    Ay_c = Ay_c + 0.5 * hquad(1)
    Az_c = Az_c + 0.5 * hquad(2)
    # J_(ij) += H_i(jk) delta_k (fully symmetric H)
    Jxx_c = J[0] + H[0] * dx + H[3] * dy + H[4] * dz
    Jyy_c = J[1] + H[9] * dx + H[7] * dy + H[11] * dz
    Jzz_c = J[2] + H[16] * dx + H[17] * dy + H[14] * dz
    Jxy_c = J[3] + H[3] * dx + H[1] * dy + H[5] * dz
    Jxz_c = J[4] + H[4] * dx + H[5] * dy + H[2] * dz
    Jyz_c = J[5] + H[10] * dx + H[11] * dy + H[8] * dz
    return ((Ax_c, Ay_c, Az_c, Jxx_c, Jyy_c, Jzz_c, Jxy_c, Jxz_c, Jyz_c)
            + tuple(H) + (phi_c,))


def _octant_centers(levels: int, dev, dtype: torch.dtype) -> list[torch.Tensor]:
    """Per-axis integer cell coordinates of the finest grid in octant-major
    order (coord_k = 2 i_k + o_k over (octant, x-major parent)), as floats."""
    s = 2 ** levels // 2
    o = torch.arange(8, device=dev).view(8, 1, 1, 1)
    out = []
    for k in range(3):
        shape = [1, 1, 1, 1]
        shape[k + 1] = s
        i_k = torch.arange(s, device=dev).view(shape)
        out.append(((i_k << 1) | ((o >> (2 - k)) & 1)).expand(8, s, s, s)
                   .to(dtype).reshape(-1))
    return out


def _far_field(chans: dict, levels: int, ws: int, half: torch.Tensor, origin: torch.Tensor,
               G: float, eps2: float, order: int) -> tuple:
    """Conv far field over all levels, push combine. ``chans[levels]`` is
    octant-major (``far_id``), the coarser levels x-major. Returns F flat
    finest-grid field channels [M^3] about the finest cell centers, in
    octant-major order (order 1: Ax..Az, Jxx..Jyz, phi; order 2 inserts the
    18 Hessian channels before phi)."""
    dev = origin.device
    nf = _N_FLD[order]
    levs = list(range(2, levels + 1))
    h_all = torch.stack([2.0 * half / (2 ** lev) for lev in levs])
    w_all = _conv_weights(ws, h_all, G, eps2, order)
    acc = None          # running expansion about the previous level's centers
    for li, lev in enumerate(levs):
        m = 2 ** lev
        h_lev = h_all[li]
        mflat = chans[lev][0]
        if lev == levels:
            ctr = _octant_centers(levels, dev, origin.dtype)
        else:
            ar = torch.arange(m, device=dev, dtype=origin.dtype)
            ctr = [ar.view(m, 1, 1).expand(m, m, m).reshape(-1),
                   ar.view(1, m, 1).expand(m, m, m).reshape(-1),
                   ar.view(1, 1, m).expand(m, m, m).reshape(-1)]
        cc = [origin[k] + (ctr[k] + 0.5) * h_lev for k in range(3)]
        # dipole about centers: p = sum(m x) - m c
        moms = [mflat] + [chans[lev][1 + k] - mflat * cc[k] for k in range(3)]
        if order == 2:
            # Q_(ij) = sum(m x_i x_j) - c_i Mx_j - c_j Mx_i + m c_i c_j
            for q, (i, j) in enumerate(_Q6):
                moms.append(chans[lev][4 + q] - cc[i] * chans[lev][1 + j]
                            - cc[j] * chans[lev][1 + i] + mflat * cc[i] * cc[j])
        if lev == levels:
            # octant-major flats: channel (mo, o) is block o of moment mo
            s = m // 2
            packed = torch.cat([c.reshape(8, s, s, s) for c in moms], dim=0)
            out = _level_conv(packed, w_all[li], ws)

            def fslice(o, f, _out=out):
                return _out[o * nf + f].reshape(-1)

            if acc is None:
                return tuple(torch.cat([fslice(o, f) for o in range(8)]) for f in range(nf))
            # push the running expansion (x-major over parents) to each child
            # octant with its static +-h/2 delta and add that octant's block:
            # the result is octant-major by construction
            F_parts = []
            for o in range(8):
                d_o = [(0.5 * h_lev) if (o >> (2 - k)) & 1 else (-0.5 * h_lev)
                       for k in range(3)]
                sh = _taylor_shift(lambda c: c, acc, d_o[0], d_o[1], d_o[2], order)
                F_parts.append(tuple(sh[f] + fslice(o, f) for f in range(nf)))
            return tuple(torch.cat([F_parts[o][f] for o in range(8)]) for f in range(nf))
        out = _level_conv(_octant_pack(moms, m), w_all[li], ws)
        dF = _unpack_fields(out, nf)
        if acc is None:
            acc = dF
            continue
        # acc holds the levels above about level lev-1 centers ([s^3] flats):
        # shift it to this level's child centers (+-h_lev/2 per axis) and add
        s = m // 2
        sides = torch.tensor([-1.0, 1.0], dtype=origin.dtype, device=dev) * (0.5 * h_lev)
        shifted = _taylor_shift(lambda c: c.reshape(s, 1, s, 1, s, 1), acc,
                                sides.reshape(1, 2, 1, 1, 1, 1),
                                sides.reshape(1, 1, 1, 2, 1, 1),
                                sides.reshape(1, 1, 1, 1, 1, 2), order)
        tgt = (s, 2, s, 2, s, 2)
        acc = tuple(p.expand(tgt).reshape(-1) + c for p, c in zip(shifted, dF))
    raise AssertionError("unreachable: the finest level returns")


def _box_tensors(box, dev, dtype: torch.dtype = f32) -> tuple[torch.Tensor, torch.Tensor]:
    """(center [3], half []) of a pinned box as tensors on ``dev``."""
    return (torch.as_tensor(box[0], dtype=dtype, device=dev).reshape(3),
            torch.as_tensor(box[1], dtype=dtype, device=dev).reshape(()))


def _cells(pos32: torch.Tensor, center: torch.Tensor, half: torch.Tensor, M: int):
    """(h, origin, per-axis finest cell coordinates [N, 3] int64), clipped
    into the grid (clipped in float first, so a far body cannot overflow
    the integer cast)."""
    h = 2.0 * half / M
    origin = center - half
    cc = torch.clamp(torch.floor((pos32 - origin) / h), 0, M - 1).to(i64)
    return h, origin, cc


def _bin(pos, mass, alive, M: int, box, dtype: torch.dtype):
    """The binning of :func:`tree_acc_potential`, in ``dtype``: (pos, alive,
    alive as 0/1, alive-masked mass, the cube's half-width, the cell width
    h, the grid origin, per-axis cell coordinates [N, 3])."""
    dev = pos.device
    n = pos.shape[0]
    pos32 = pos.to(dtype)
    alive_b = (torch.ones((n,), dtype=torch.bool, device=dev) if alive is None
               else alive.to(torch.bool))
    alive_f = alive_b.to(dtype)
    m_eff = mass.to(dtype) * alive_f
    if box is None:
        center, half = _bounding_cube(pos32, alive_f, M)
    else:
        center, half = _box_tensors(box, dev, dtype)
    h, origin, cc = _cells(pos32, center, half, M)
    return pos32, alive_b, alive_f, m_eff, half, h, origin, cc


def _sort_cells(cc: torch.Tensor, alive_b: torch.Tensor, M: int):
    """The near field's ONE stable sort by finest cell id (dead bodies last,
    at M^3): (sorted ids, permutation)."""
    cell_id = (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]
    cell_id = torch.where(alive_b, cell_id, M ** 3)
    return torch.sort(cell_id, stable=True)


def tree_acc_potential(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G_grav: float,
    eps2: float,
    levels: int = 6,
    ws: int = 1,
    with_potential: bool = True,
    order: int = 1,
    max_chunks: int = 0,
    near: str = "cells",
    chunk: int = 32,
    wl_entries: int = 0,
    wl_rj: int = 8,
    box=None,
    _phase: str = "both",
    _n_parts: int = 1,
    _psum_axis: Optional[str] = None,
    _dtype: torch.dtype = f32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tree accelerations, potential, and the near-field overflow count.

    The arguments are the JAX function's for ``near="kernel"``: ``levels``
    (near field on ``2^levels`` cells per side), ``ws`` (well-separation, 1
    or 2), ``order`` (1 monopole+dipole, 2 + quadrupole and second-order
    target Taylor), ``max_chunks`` and ``wl_entries`` (static budgets; size
    them with ``ops.tree_near_wl.tree_wl_budgets``), ``chunk`` and
    ``wl_rj`` (chunk rows, and j-block height in chunks), ``box`` (optional
    (center [3], half) pinning the grid; default refits the live bounding
    cube every call). ``_phase`` is ``"both"``, ``"far"`` or ``"near"``
    (:func:`tree_acc_potential_staged`). ``_dtype`` is the compute type,
    float32 as in the JAX function; float64 (plain versions only) serves as
    the reference of the checks.

    Returns (acc [N, 3] and U [] in ``pos``'s dtype, overflow int32 [] on
    ``pos``'s device), computed in ``_dtype``. ``overflow`` counts live bodies
    excluded from the near-field sum; results are only trustworthy at 0.
    Requires ``eps2 > 0``."""
    if eps2 <= 0.0:
        raise ValueError("the tree solver requires eps2 > 0")
    if ws not in (1, 2):
        raise ValueError("ws must be 1 or 2")
    if order not in (1, 2):
        raise ValueError("order must be 1 (monopole+dipole) or 2 (+quad)")
    _check_near(near)
    if _n_parts > 1 or _psum_axis is not None:
        raise NotImplementedError("the sharded tree is not ported to orbital_tpu_torch yet "
                                  "(ROADMAP.md queue A item A.15)")
    if wl_entries <= 0:
        raise ValueError("near='kernel' needs a worklist budget: pass wl_entries sized with "
                         "ops.tree_near_wl.tree_wl_budgets")
    if levels < 2 or levels > 8:
        raise ValueError("levels must be in [2, 8]")
    if _phase not in ("both", "far", "near"):
        raise ValueError(f"bad _phase {_phase!r}")
    dev = pos.device
    n = pos.shape[0]
    M = 2 ** levels
    G = float(G_grav)
    eps2 = float(eps2)
    pos32, alive_b, alive_f, m_eff, half, h, origin, cc = _bin(pos, mass, alive, M, box,
                                                               _dtype)
    if _phase == "near":
        a_far = torch.zeros((n, 3), dtype=_dtype, device=dev)
        U_far = torch.zeros((), dtype=_dtype, device=dev)
    else:
        a_far, U_far = _far_phase(pos32, m_eff, alive_b, cc, h, half, origin, levels, ws,
                                  G, eps2, order, with_potential)
    if _phase == "far":
        return ((a_far * alive_f[:, None]).to(pos.dtype), U_far.to(pos.dtype),
                torch.zeros((), dtype=torch.int32, device=dev))

    from .tree_near_wl import _near_wl

    sc, sort_idx = _sort_cells(cc, alive_b, M)
    idx, acc_s, pe_s, cap_overflow, cell_overflow = _near_wl(
        sc, pos32[sort_idx], m_eff[sort_idx], sort_idx, n, M, ws, eps2, G, max_chunks,
        chunk, wl_entries, wl_rj)
    # every body owns one row: scatter the sorted rows back to body order
    acc_near = torch.zeros((n, 3), dtype=_dtype, device=dev).index_put_((idx,), acc_s)
    pe_near = torch.zeros((n,), dtype=_dtype, device=dev).index_put_((idx,), pe_s)

    acc = (a_far + acc_near) * alive_f[:, None]
    overflow = (cap_overflow + cell_overflow).to(torch.int32)
    if with_potential:
        U = U_far - 0.5 * G * torch.sum(m_eff * pe_near)
    else:
        U = torch.zeros((), dtype=_dtype, device=dev)
    return acc.to(pos.dtype), U.to(pos.dtype), overflow


def _far_ids(cc: torch.Tensor, alive_b: torch.Tensor, M: int) -> torch.Tensor:
    """Octant-major finest-cell ids: octant of the parent (o = ox*4 + oy*2 +
    oz) major, x-major parent cell minor; dead bodies at M^3. The far field's
    finest channels are deposited, produced and gathered in this order, so
    the finest level needs only contiguous block slices."""
    s_fin = M // 2
    oct_b = ((cc[:, 0] & 1) * 2 + (cc[:, 1] & 1)) * 2 + (cc[:, 2] & 1)
    par_b = ((cc[:, 0] >> 1) * s_fin + (cc[:, 1] >> 1)) * s_fin + (cc[:, 2] >> 1)
    return torch.where(alive_b, oct_b * (s_fin ** 3) + par_b, M ** 3)


def _far_phase(pos32, m_eff, alive_b, cc, h, half, origin, levels: int, ws: int, G: float,
               eps2: float, order: int, with_potential: bool):
    """The multipole pyramid (NGP deposit of the moments at the octant-major
    finest ids, then coarsening), the conv far field, the per-body Taylor
    step, and the cell-wise far potential. Returns (a_far [N, 3], U_far [])."""
    dev, dt = pos32.device, pos32.dtype
    M = 2 ** levels
    M3 = M * M * M
    far_id = _far_ids(cc, alive_b, M)

    raw = [m_eff, m_eff * pos32[:, 0], m_eff * pos32[:, 1], m_eff * pos32[:, 2]]
    if order == 2:
        raw += [m_eff * pos32[:, i] * pos32[:, j] for i, j in _Q6]
    chans = {levels: tuple(
        torch.zeros((M3 + 1,), dtype=dt, device=dev).index_add_(0, far_id, c)[:M3]
        for c in raw)}
    for lev in range(levels - 1, 1, -1):
        if lev == levels - 1:
            # the 8 children of parent p are the octant blocks at minor index p
            chans[lev] = tuple(c.reshape(8, -1).sum(dim=0) for c in chans[lev + 1])
            continue
        chans[lev] = tuple(_coarsen2(c, 2 ** lev) for c in chans[lev + 1])

    F_ch = _far_field(chans, levels, ws, half, origin, G, eps2, order)
    idx_b = torch.clamp(far_id, max=M3)
    zpad = torch.zeros((1,), dtype=dt, device=dev)
    Fb = [torch.cat([c, zpad])[idx_b] for c in F_ch]        # F x [N]
    A_b = torch.stack(Fb[0:3], dim=-1)
    J_b = torch.stack(Fb[3:9], dim=-1)
    dx = pos32 - (origin + (cc.to(dt) + 0.5) * h)
    a_far = A_b + _apply_sym(J_b, dx)
    if order == 2:
        H = Fb[9:27]
        dxc = [dx[:, 0], dx[:, 1], dx[:, 2]]

        def hquad_b(i):
            b = i * 6
            acc = torch.zeros_like(H[0])
            for q, (j, k) in enumerate(_Q6):
                acc = acc + _C6[q] * H[b + q] * dxc[j] * dxc[k]
            return acc

        a_far = a_far + 0.5 * torch.stack([hquad_b(0), hquad_b(1), hquad_b(2)], dim=-1)
    if not with_potential:
        return a_far, torch.zeros((), dtype=dt, device=dev)

    # sum_b m_b phi(x_b) aggregated per finest cell from the deposited
    # moments: sum_cells [m phi_c - A.p (- J:Q/2 at order 2)], octant-major
    ctr = _octant_centers(levels, dev, dt)
    ccell = [origin[k] + (ctr[k] + 0.5) * h for k in range(3)]
    mflat = chans[levels][0]
    p = [chans[levels][1 + k] - mflat * ccell[k] for k in range(3)]
    tot = mflat * F_ch[-1]
    for k in range(3):
        tot = tot - F_ch[k] * p[k]
    if order == 2:
        for q, (i, j) in enumerate(_Q6):
            Qq = (chans[levels][4 + q] - ccell[i] * chans[levels][1 + j]
                  - ccell[j] * chans[levels][1 + i] + mflat * ccell[i] * ccell[j])
            tot = tot - 0.5 * _C6[q] * F_ch[3 + q] * Qq
    return a_far, 0.5 * torch.sum(tot)


def tree_acc_potential_staged(pos, mass, alive=None, **kwargs):
    """The JAX package's two-program tree evaluation, kept by name: the same
    arguments and return contract as :func:`tree_acc_potential`, and here
    one call of it. The JAX package splits the far field and the near sweep
    into two programs only because one program crashed its TPU platform's
    compiler at N >= 512k, levels = 8; on the card one call queues the same
    work."""
    return tree_acc_potential(pos, mass, alive, **kwargs)


# ---------------------------------------------------------------------------
# budget probes: host or CPU inputs, torch on the CPU, Python ints out
# ---------------------------------------------------------------------------

def _host(x, dtype: torch.dtype) -> torch.Tensor:
    """A host or device array as a CPU tensor of ``dtype``."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", dtype)
    return torch.tensor(np.asarray(x)).to(dtype)


def _probe_sorted_cells(pos, alive, levels: int, box) -> tuple[torch.Tensor, int, int]:
    """Shared preamble of the probes: the finest-level cell ids on the CPU,
    binned exactly as :func:`tree_acc_potential` bins them (same box fit and
    clipping), sorted with dead bodies last at M^3. Returns ``(sc, n, M)``."""
    pos32 = _host(pos, f32)
    n, M = pos32.shape[0], 2 ** levels
    alive_t = None if alive is None else _host(alive, torch.bool)
    box_t = None if box is None else tuple(_host(b, f32) for b in box)
    _, alive_b, *_, cc = _bin(pos32, torch.zeros(n), alive_t, M, box_t, f32)
    return _sort_cells(cc, alive_b, M)[0], n, M


def tree_occupancy_probe(pos, alive=None, *, levels: int = 6, box=None) -> tuple[int, int]:
    """(max bodies per finest cell, occupied finest-cell count), binned
    exactly like :func:`tree_acc_potential`; the ``tree_levels="auto"``
    sizer of ``simulate()``."""
    sc, _, M = _probe_sorted_cells(pos, alive, levels, box)
    counts = torch.bincount(sc, minlength=M ** 3 + 1)[:M ** 3]
    return int(counts.max()), int((counts > 0).sum())


# ---------------------------------------------------------------------------
# chunk/run geometry of the chunk-pair near field
# ---------------------------------------------------------------------------

def _compact_sorted(flags: torch.Tensor, values: torch.Tensor, K: int,
                    sentinel: int) -> torch.Tensor:
    """Values at flagged positions, order-preserved, padded with
    ``sentinel`` to length K (flags and values aligned; ascending values give
    an ascending result). Flagged values past the first K are dropped."""
    dest = torch.cumsum(flags.to(i64), 0) - 1
    dest = torch.where(flags & (dest < K), dest, K)
    out = torch.full((K + 1,), sentinel, dtype=values.dtype, device=values.device)
    out[dest] = values  # unflagged rows all land in the spare row K
    return out[:K]


def _segment_bounds(sorted_keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(first, last) occurrence index per element of a sorted int key array:
    ``searchsorted(keys, keys, 'left'/'right')`` by two running scans."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, dtype=i64, device=sorted_keys.device)
    boundary = sorted_keys[1:] != sorted_keys[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=sorted_keys.device)
    is_start = torch.cat([one, boundary])
    is_end = torch.cat([boundary, one])
    first = torch.cummax(torch.where(is_start, idx, 0), 0).values
    last = torch.where(is_end, idx + 1, n).flip(0).cummin(0).values.flip(0)
    return first, last


def _pairs_geometry(sc: torch.Tensor, n: int, M: int, ws: int, C: int,
                    K_ch: int) -> dict:
    """Chunk every (x, y) column of the cell-id-sorted bodies (``sc`` [n],
    dead bodies sorted last at id M^3) into consecutive C-body chunks, and
    locate for every (chunk, neighbor column) the z-trimmed run of j-chunks
    whose z-cells can meet the chunk's |dz| <= ws band, through a
    (column, z-cell) -> first-sorted-position table.

    Returns, as ``orbital_tpu.ops.tree._pairs_geometry``: per-body ``col_s /
    rank_c / valid_b / chunk_ord / keep``; per-chunk ``ids_chunk_col /
    chunk_valid / j_lo [K_ch, (2ws+1)^2] / cnt / S_ch``."""
    dev = sc.device
    sc = sc.to(i64)
    M2 = M * M
    col_s = torch.clamp(sc // M, max=M2)  # sorted ascending; dead -> M2
    first_c, last_c = _segment_bounds(col_s)
    pos_i = torch.arange(n, dtype=i64, device=dev)
    rank_c = pos_i - first_c
    valid_b = col_s < M2
    is_first_c = (rank_c == 0) & valid_b

    chunk_start = valid_b & (rank_c % C == 0)
    chunk_ord = torch.cumsum(chunk_start.to(i64), 0) - 1
    keep = valid_b & (chunk_ord < K_ch)
    in_budget = chunk_start & (chunk_ord < K_ch)
    ids_chunk_col = _compact_sorted(in_budget, col_s, K_ch, M2)
    chunk_valid = ids_chunk_col < M2

    def column_map(fill: int, vals: torch.Tensor) -> torch.Tensor:
        """[M2 + 1] map column -> ``vals`` at each column's first body
        (``fill`` elsewhere; the other bodies all write ``fill`` to M2)."""
        out = torch.full((M2 + 1,), fill, dtype=i64, device=dev)
        out[torch.where(is_first_c, col_s, M2)] = torch.where(is_first_c, vals, fill)
        return out

    first_chunk_map = column_map(K_ch, chunk_ord)
    colfirst = column_map(n, first_c)
    colend = column_map(n, last_c)

    # (column, z-cell) -> first sorted position with that column and z-cell
    # >= z: a scatter-min of positions and a suffix min along z
    zrow = torch.where(valid_b, sc % M, M)
    rt = torch.full(((M2 + 1) * (M + 1),), n, dtype=i64, device=dev)
    rt.scatter_reduce_(0, torch.where(valid_b, col_s, M2) * (M + 1) + zrow, pos_i,
                       "amin", include_self=True)
    rt_flat = rt.view(M2 + 1, M + 1).flip(1).cummin(1).values.flip(1).reshape(-1)

    # per-chunk z-cell bounds (z-cells are monotone within a column); an
    # empty chunk's bounds are never read (its runs are masked below)
    z_s = torch.where(valid_b, sc % M, 0)
    ord_c = torch.where(keep, chunk_ord, K_ch)
    zlo_ch = torch.zeros((K_ch + 1,), dtype=i64, device=dev)
    zlo_ch[torch.where(in_budget, chunk_ord, K_ch)] = torch.where(in_budget, z_s, 0)
    zhi_ch = torch.zeros((K_ch + 1,), dtype=i64, device=dev).scatter_reduce(
        0, ord_c, torch.where(keep, z_s, 0), "amax", include_self=True)
    zlo_ch, zhi_ch = zlo_ch[:K_ch], zhi_ch[:K_ch]

    nb2 = [(a, b) for a in range(-ws, ws + 1) for b in range(-ws, ws + 1)]
    col_k = torch.where(chunk_valid, ids_chunk_col, 0)
    cy, cx = col_k % M, col_k // M
    zb_lo = torch.clamp(zlo_ch - ws, 0, M)
    zb_hi = torch.clamp(zhi_ch + ws + 1, max=M)
    j_lo_l, cnt_l = [], []
    for a, b in nb2:
        nx, ny = cx + a, cy + b
        ok = (0 <= nx) & (nx < M) & (0 <= ny) & (ny < M) & chunk_valid
        nc = torch.where(ok, nx * M + ny, M2)
        ce = colend[nc]
        p_lo = torch.minimum(rt_flat[nc * (M + 1) + zb_lo], ce)
        p_hi = torch.minimum(rt_flat[nc * (M + 1) + zb_hi], ce)
        base_p = colfirst[nc]
        lo_q = torch.where(ok, (p_lo - base_p) // C, 0)
        hi_q = torch.where(ok, -(-(p_hi - base_p) // C), 0)
        cnt_l.append(torch.where(ok & (p_hi > p_lo), hi_q - lo_q, 0))
        j_lo_l.append(torch.clamp(first_chunk_map[nc] + lo_q, max=K_ch))
    j_lo = torch.stack(j_lo_l, dim=1)                   # [K_ch, 9]
    cnt = torch.stack(cnt_l, dim=1)                     # [K_ch, 9]
    return dict(col_s=col_s, rank_c=rank_c, valid_b=valid_b,
                chunk_ord=chunk_ord, keep=keep,
                ids_chunk_col=ids_chunk_col, chunk_valid=chunk_valid,
                j_lo=j_lo, cnt=cnt, S_ch=torch.sum(cnt, dim=-1))
