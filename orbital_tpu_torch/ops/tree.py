r"""Multilevel tree gravity: multipole far field by convolution + exact near
field over occupied cells, columns or chunk pairs.

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

  * The far field with the same channel arithmetic. Each level runs as ONE
    ``conv3d`` over [8 Mo, s, s, s] (channels first, x y z); the JAX module
    runs 2ws+1 batched 2-D convolutions with x-plane shifts because 3-D
    convolutions compiled badly on its TPU. The conv is a library call
    outside any kernel and runs in full float32: cuDNN's TF32 is switched
    off around it (``_level_conv``), as the JAX module asks for
    ``Precision.HIGHEST``.
  * The JAX module's four layout-study flags, module attributes read at
    every call (the port is eager: there is no program cache to clear),
    each defaulting to JAX's default: ``_SKIP`` (from ``TREE_SKIP`` at
    import, with JAX's warning: ``"near"`` / ``"far"`` drop that part of
    the acceleration, a debug mode whose results are not physical);
    ``_FAR_NHWC`` (the conv's input and weights in ``channels_last_3d``,
    the same sums); ``_FAR_COMBINE`` (``"push"``, level by level onto the
    octant-major finest layout ``far_id``, or ``"lazy"``, each level
    shifted straight to the x-major finest cell centres); and
    ``_PAIRS_CF`` (``"table"`` or the legacy ``"scan"`` locator of
    ``_pairs_geometry``, the same integers).
  * All four near modes. ``"kernel"`` runs the chunk-pair sweep through the
    B7 wrapper (``ops/tree_near_wl.py`` and its CUDA kernel). ``"cells"``,
    ``"columns"`` and ``"pairs"`` are the JAX module's plain XLA gathers and
    sums (``_near_cells``, ``_near_columns``, ``_near_pairs``), here eager
    tensor code on the device: the ``lax.map`` over blocks becomes a loop
    over blocks sized by the same 32 MB rule, every clamped gather an explicit
    clamp and every dropped scatter a write into a spare row that is never
    read or is sliced off; packed-row sentinels (positions 1e30, mass 0, idx
    n) are masked by select.
  * The body-sharded force, :func:`tree_sharded_force` (one rank's code
    against a ``parallel.mesh.Comm``): the bodies gathered, the far field
    replicated, and each rank sweeping a contiguous 1/P slice of every near
    list (``_n_parts``, ``_part_index``; for ``"kernel"`` a slice of the
    worklist, which B7 takes as the runs clipped to it), the per-body near
    sums psum'd.
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
"table"``) or the global cell-id suffix scan (``"scan"``). That code is eager
integer tensor code: ``jnp.nonzero(size=K)`` becomes a cumsum-and-scatter
compaction, ``.at[].set(mode="drop")`` a scatter into one spare row that is
sliced off, ``.at[].min`` a ``scatter_reduce``, the associative min/max
scans ``cummin``/``cummax`` (reversed by flipping). Indices are int64
inside; the integer results equal the JAX module's.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from .pm import _bounding_cube

# debug-only phase isolation for performance attribution (the JAX module's
# TREE_SKIP, orbital_tpu/ops/tree.py:93-104): zeroing a field phase gives
# WRONG PHYSICS, so importing this module with TREE_SKIP set warns
_SKIP = os.environ.get("TREE_SKIP", "")
if _SKIP:
    warnings.warn(
        f"TREE_SKIP={_SKIP!r} is set: the tree force will OMIT its "
        f"'{_SKIP}'-field contribution. This is a perf-attribution debug "
        "mode; results are not physical.",
        RuntimeWarning, stacklevel=2)

# the conv's memory layout: False for channels first, True for
# torch.channels_last_3d input and weights (the JAX module's NHWC study flag,
# tree.py:262-270; the same sums either way)
_FAR_NHWC = False
# how the levels' conv outputs combine into finest-grid expansions (the JAX
# module's tree.py:358-375): "push" shifts the running expansion one level
# at a time onto the octant-major finest layout; "lazy" shifts each level's
# term straight to the x-major finest cell centres and adds it there
_FAR_COMBINE = "push"
# how _pairs_geometry locates a neighbor column's z-trimmed run (the JAX
# module's tree.py:1393-1400): "table", a (column, z-cell) rank table with a
# length-(M + 1) suffix min, or "scan", the legacy suffix min over the whole
# M^3 cell-id grid; the same integers
_PAIRS_CF = "table"

__all__ = ["tree_acc_potential", "tree_acc_potential_staged", "tree_sharded_force",
           "tree_occupancy_probe",
           "tree_class_probe", "tree_column_probe", "tree_pairs_probe", "tree_pairs_budgets",
           "tree_stencil", "_compact_sorted", "_segment_bounds", "_pairs_geometry"]

i64 = torch.int64
f32 = torch.float32

_NEAR_MODES = ("cells", "columns", "pairs", "kernel")
# pair elements a block of the eager near sweeps holds in each temporary (the
# JAX module's budget, tree.py:1107)
_BLOCK_ELEMS = 32 * 1024 * 1024


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
    field). Under ``_FAR_NHWC`` the input and weights are laid out
    ``channels_last_3d``."""
    x = moments[None]
    if _FAR_NHWC:
        x = x.contiguous(memory_format=torch.channels_last_3d)
        w = w.contiguous(memory_format=torch.channels_last_3d)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return torch.nn.functional.conv3d(x, w, padding=ws)[0]


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
    """Conv far field over all levels, combined as ``_FAR_COMBINE`` says.
    Under "push" ``chans[levels]`` is octant-major (``far_id``) and so are
    the returned channels; under "lazy" every level is x-major. The coarser
    levels are x-major. Returns F flat finest-grid field channels [M^3]
    about the finest cell centers (order 1: Ax..Az, Jxx..Jyz, phi; order 2
    inserts the 18 Hessian channels before phi)."""
    dev = origin.device
    nf = _N_FLD[order]
    M = 2 ** levels
    push = _FAR_COMBINE == "push"
    levs = list(range(2, levels + 1))
    h_all = torch.stack([2.0 * half / (2 ** lev) for lev in levs])
    w_all = _conv_weights(ws, h_all, G, eps2, order)
    h_fin = 2.0 * half / M
    acc = None          # push: expansion about the previous level's centers; lazy: finest
    for li, lev in enumerate(levs):
        m = 2 ** lev
        h_lev = h_all[li]
        mflat = chans[lev][0]
        if lev == levels and push:
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
        if lev == levels and push:
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
        if not push:
            # lazy: shift this level's term straight to the finest centers;
            # the 6-d view (m, r, m, r, m, r) of the flat x-major [M^3] grid
            # is a free reshape, and delta is constant within each r-block
            if acc is None:
                acc = [torch.zeros((M ** 3,), dtype=origin.dtype, device=dev)
                       for _ in range(nf)]
            if lev == levels:
                acc = [a + c for a, c in zip(acc, dF)]
                continue
            r = M // m

            def dl(axis: int, _r=r):
                dv = (torch.arange(_r, dtype=origin.dtype, device=dev) + 0.5 - 0.5 * _r) * h_fin
                shape = [1, 1, 1, 1, 1, 1]
                shape[2 * axis + 1] = _r
                return dv.reshape(shape)

            shifted = _taylor_shift(lambda c, _m=m: c.reshape(_m, 1, _m, 1, _m, 1), dF,
                                    dl(0), dl(1), dl(2), order)
            tgt = (m, r, m, r, m, r)
            acc = [a + sh.expand(tgt).reshape(-1) for a, sh in zip(acc, shifted)]
            continue
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
    if push:
        raise AssertionError("unreachable: the finest level returns")
    return tuple(acc)


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
    capacity: int = 48,
    ws: int = 1,
    max_cells: int = 0,
    cell_block: int = 0,
    with_potential: bool = True,
    order: int = 1,
    max_big: int = 0,
    max_frontier: int = 0,
    max_chunks: int = 0,
    near: str = "cells",
    chunk: int = 32,
    pair_entries: tuple = (),
    wl_entries: int = 0,
    wl_rj: int = 8,
    box=None,
    _phase: str = "both",
    _n_parts: int = 1,
    _part_index: int = 0,
    _comm=None,
    _dtype: torch.dtype = f32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tree accelerations, potential, and the near-field overflow count.

    The arguments are the JAX function's: ``levels`` (near field on
    ``2^levels`` cells per side), ``ws`` (well-separation, 1 or 2), ``order``
    (1 monopole+dipole, 2 + quadrupole and second-order target Taylor),
    ``box`` (optional (center [3], half) pinning the grid; default refits the
    live bounding cube every call), and the near mode ``near`` with its
    static budgets:

      * ``"cells"``: each occupied finest cell against its (2ws+1)^3
        neighbor cells; ``capacity`` bodies a cell, ``max_cells`` occupied
        cells (0 = min(N, 8^levels)), ``max_big`` / ``max_frontier`` for the
        occupancy classes (size them with :func:`tree_class_probe`);
      * ``"columns"``: each occupied (x, y) column against its (2ws+1)^2
        neighbor columns with a |dz| <= ws band mask; the same budgets per
        column, plus ``max_chunks`` for the big sweep's i-side chunks (size
        them with :func:`tree_column_probe`, ``with_chunks=True``);
      * ``"pairs"``: ``chunk``-body chunk pairs with octave-padded j widths;
        ``max_chunks`` and ``pair_entries`` (:func:`tree_pairs_budgets`);
      * ``"kernel"``: the same chunk pairs through B7; ``max_chunks`` and
        ``wl_entries`` (``ops.tree_near_wl.tree_wl_budgets``) and ``wl_rj``.

    ``cell_block`` is the eager sweeps' block of list entries (0 = the
    32 MB rule). ``_phase`` is ``"both"``, ``"far"`` or ``"near"``
    (:func:`tree_acc_potential_staged`). With ``_n_parts`` > 1 the near
    sweep covers only part ``_part_index`` of every list (the JAX module's
    contiguous 1/``_n_parts`` slices), and ``_comm`` (a
    ``parallel.mesh.Comm``), when given, psums the per-body near sums
    (:func:`tree_sharded_force`). ``_dtype`` is the compute type,
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
    if near not in _NEAR_MODES:
        raise ValueError("near must be 'cells', 'columns', 'pairs', or 'kernel'")
    if near == "pairs" and not pair_entries:
        raise ValueError("near='pairs' needs per-octave i-chunk budgets: pass pair_entries "
                         "sized with tree_pairs_probe")
    if not 0 <= _part_index < max(1, _n_parts):
        raise ValueError(f"_part_index {_part_index} outside {_n_parts} parts")
    if near == "kernel" and wl_entries <= 0:
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
        # the f64 route is the one that keeps SI units (the float32 and
        # ds32 routes take natural units): its far phase runs in units of
        # powers of two, the others' as given, with no added launch
        far = _far_phase_pow2 if pos.dtype == torch.float64 else _far_phase
        a_far, U_far = far(pos32, m_eff, alive_b, cc, h, half, origin, levels, ws, G, eps2,
                           order, with_potential)
    if _phase == "far":
        return ((a_far * alive_f[:, None]).to(pos.dtype), U_far.to(pos.dtype),
                torch.zeros((), dtype=torch.int32, device=dev))

    sc, sort_idx = _sort_cells(cc, alive_b, M)
    pos_s, m_s = pos32[sort_idx], m_eff[sort_idx]
    if near == "kernel":
        from .tree_near_wl import _near_wl

        idx, acc_s, pe_s, cap_overflow, cell_overflow = _near_wl(
            sc, pos_s, m_s, sort_idx, n, M, ws, eps2, G, max_chunks, chunk, wl_entries,
            wl_rj, _n_parts, _part_index)
        # every body owns one row: scatter the sorted rows back to body order
        acc_near = torch.zeros((n, 3), dtype=_dtype, device=dev).index_put_((idx,), acc_s)
        pe_near = torch.zeros((n,), dtype=_dtype, device=dev).index_put_((idx,), pe_s)
    else:
        pack = _row_packer(pos_s, m_s, sort_idx, n)
        sweep = _Sweep(M, ws, eps2, G, cell_block, origin[2], h, _n_parts, _part_index)
        if near == "cells":
            K = min(n, M ** 3) if max_cells <= 0 else int(max_cells)
            cap_overflow, cell_overflow = _near_cells(sc, pack, sweep, n, M, K, capacity,
                                                      max_big, max_frontier)
        elif near == "columns":
            cap_overflow, cell_overflow = _near_columns(sc, pack, sweep, n, M, capacity,
                                                        max_cells, max_big, max_frontier,
                                                        max_chunks)
        else:
            cap_overflow, cell_overflow = _near_pairs(sc, pack, sweep, n, M, max_chunks,
                                                      chunk, pair_entries)
        if not sweep.parts:  # a part with no entries of any list
            sweep.parts.append((torch.full((1,), n, dtype=i64, device=dev),
                                torch.zeros((1, 3), dtype=_dtype, device=dev),
                                torch.zeros((1,), dtype=_dtype, device=dev)))
        # each swept row adds into its body's slot; padding rows carry idx n
        # into the spare row n, sliced off
        idx = sweep.idx()
        acc_near = torch.zeros((n + 1, 3), dtype=_dtype, device=dev).index_add_(
            0, idx, sweep.acc())[:n]
        pe_near = torch.zeros((n + 1,), dtype=_dtype, device=dev).index_add_(
            0, idx, sweep.pe())[:n]

    if _comm is not None:
        # each rank swept a disjoint slice of the lists: the per-body sums
        # of every rank, one psum each
        acc_near, pe_near = _comm.psum(acc_near), _comm.psum(pe_near)
    if "near" in _SKIP:
        acc_near, pe_near = torch.zeros_like(acc_near), torch.zeros_like(pe_near)
    if "far" in _SKIP:
        # as the JAX module: the far acceleration goes; its cell-wise far
        # potential stays (JAX zeroes the per-body phi, which U does not read)
        a_far = torch.zeros_like(a_far)
    acc = (a_far + acc_near) * alive_f[:, None]
    overflow = (cap_overflow + cell_overflow).to(torch.int32)
    if with_potential:
        U = U_far - 0.5 * G * torch.sum(m_eff * pe_near)
    else:
        U = torch.zeros((), dtype=_dtype, device=dev)
    return acc.to(pos.dtype), U.to(pos.dtype), overflow


# ---------------------------------------------------------------------------
# the eager near sweeps ("cells", "columns", "pairs")
# ---------------------------------------------------------------------------

def _dense_slot_map(ids_list: torch.Tensor, K: int, id_max: int) -> torch.Tensor:
    """Dense ``[id_max + 1]`` map: id -> its slot in ``ids_list`` (a K-long
    padded id list with sentinel ``id_max``), K for absent ids. The sentinel
    entries all write K into row ``id_max``."""
    out = torch.full((id_max + 1,), K, dtype=i64, device=ids_list.device)
    slots = torch.arange(K, dtype=i64, device=ids_list.device)
    out[torch.clamp(ids_list, max=id_max)] = torch.where(ids_list < id_max, slots, K)
    return out


def _lookup_slot(sorted_ids: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Row index of ``query`` in the sorted (sentinel-padded) id list, or K
    (one past the end) when absent."""
    K = sorted_ids.shape[0]
    slot = torch.clamp(torch.searchsorted(sorted_ids, query), max=K - 1)
    return torch.where(sorted_ids[slot] == query, slot, K)


def _dense_flags(ids: torch.Tensor, flags: torch.Tensor, id_max: int) -> torch.Tensor:
    """Dense ``[id_max + 1]`` bool map: True at each flagged id. Unflagged
    entries write False into the spare row ``id_max``."""
    out = torch.zeros((id_max + 1,), dtype=torch.bool, device=ids.device)
    out[torch.where(flags, ids, id_max)] = flags
    return out


def _row_packer(pos_s: torch.Tensor, m_s: torch.Tensor, sort_idx: torch.Tensor, n: int):
    """``pack(slot_b, rank_b, keep_b, Kcap, Wd) -> [Kcap + 1, 5 Wd]``: packed
    rows px | py | pz | m | idx (idx as a float, exact for n < 2^24) with body
    ``b`` (cell-sorted order) at row ``slot_b``, lane ``rank_b``. Dropped
    bodies write their channel's sentinel (1e30, 0 or n) into the spare row
    Kcap, which therefore stays all sentinel and serves as the absent row."""
    dt = pos_s.dtype
    cols = (pos_s[:, 0], pos_s[:, 1], pos_s[:, 2], m_s, sort_idx.to(dt))
    sent = (1e30, 1e30, 1e30, 0.0, float(n))

    def pack(slot_b, rank_b, keep_b, Kcap: int, Wd: int) -> torch.Tensor:
        s = torch.where(keep_b, slot_b, Kcap)
        r = torch.clamp(rank_b, 0, Wd - 1)
        P = torch.empty((Kcap + 1, 5, Wd), dtype=dt, device=pos_s.device)
        for c, (v, sv) in enumerate(zip(cols, sent)):
            P[:, c] = sv
            P[s, c, r] = torch.where(keep_b, v, torch.full_like(v, sv))
        return P.reshape(Kcap + 1, 5 * Wd)
    return pack


def _block_size(blk: int, per_entry: int, floor: int, entries: int) -> int:
    """Entries a block: ``blk`` if given, else the largest power of two with
    at most ``_BLOCK_ELEMS`` pair elements (``per_entry`` a list entry),
    between ``floor`` and 4,096 (the JAX module's rule); never more than the
    list's ``entries`` (the JAX module pads a short list to a whole block)."""
    if blk <= 0:
        budget = _BLOCK_ELEMS // max(1, per_entry)
        blk = max(floor, min(4096, 1 << (max(floor, budget).bit_length() - 1)))
    return max(1, min(int(blk), entries))


class _Sweep:
    """The exact pair sums of the eager near modes, block by block: each
    block's i rows (packed [B, 5 Wi]) against its j rows (packed [B, 5, J]),
    with an optional |dz| <= ws cell-band mask computed with the deposit's
    own binning arithmetic (same f32 ops on the same values give the same
    cell, so the level partition stays exact). The per-row results collect
    here: ``idx()`` (body index, n on padding rows), ``acc()`` (including G)
    and ``pe()`` (sum m_j / r)."""

    def __init__(self, M: int, ws: int, eps2: float, G: float, cell_block: int,
                 oz: torch.Tensor, h: torch.Tensor, n_parts: int = 1, part: int = 0):
        self.M, self.ws, self.eps2, self.G = M, ws, eps2, G
        self.cell_block, self.oz, self.h = cell_block, oz, h
        self.n_parts, self.part = max(1, int(n_parts)), int(part)
        self.parts = []

    def span(self, K: int) -> tuple[int, int]:
        """The entries [base, end) of a K-long list that this part sweeps:
        the JAX module's contiguous slices of ceil(K / parts) entries (a
        block never runs past ``end`` into the next part's)."""
        k_part = -(-K // self.n_parts)
        base = self.part * k_part
        return base, min(K, base + k_part)

    def zcell(self, z: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.floor((z - self.oz) / self.h), 0, self.M - 1)

    def block(self, my: torch.Tensor, Wi: int, i_cap: int, rows: torch.Tensor,
              band: bool) -> None:
        pi = [my[:, k * Wi:k * Wi + i_cap] for k in range(3)]
        idx_my = my[:, 4 * Wi:4 * Wi + i_cap]
        pj = [rows[:, k] for k in range(3)]                   # [B, J]
        mj, idx_nb = rows[:, 3], rows[:, 4]
        dx = pj[0][:, None, :] - pi[0][:, :, None]             # [B, Ci, J]
        dy = pj[1][:, None, :] - pi[1][:, :, None]
        dz = pj[2][:, None, :] - pi[2][:, :, None]
        inv_r = torch.rsqrt(dx * dx + dy * dy + dz * dz + self.eps2)
        take = idx_my[:, :, None] != idx_nb[:, None, :]
        if band:
            zci, zcj = self.zcell(pi[2]), self.zcell(pj[2])
            take = take & (torch.abs(zci[:, :, None] - zcj[:, None, :]) <= self.ws)
        zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
        w = torch.where(take, mj[:, None, :] * (inv_r * inv_r * inv_r), zero)
        acc = self.G * torch.stack([torch.sum(w * dx, -1), torch.sum(w * dy, -1),
                                    torch.sum(w * dz, -1)], dim=-1)
        pe = torch.sum(torch.where(take, mj[:, None, :] * inv_r, zero), -1)
        self.parts.append((idx_my.reshape(-1).to(i64), acc.reshape(-1, 3), pe.reshape(-1)))

    def idx(self) -> torch.Tensor:
        return torch.cat([p[0] for p in self.parts])

    def acc(self) -> torch.Tensor:
        return torch.cat([p[1] for p in self.parts])

    def pe(self) -> torch.Tensor:
        return torch.cat([p[2] for p in self.parts])

    def neighbor_sweep(self, ids_list: torch.Tensor, slot_of: torch.Tensor, id_max: int,
                       offsets, decode, i_cap: int, P: torch.Tensor, width: int,
                       Pi: Optional[torch.Tensor] = None, band: bool = False) -> None:
        """Sweep the listed cells or columns (``ids_list``, sentinel
        ``id_max``): each entry's i rows (its own row of ``P``, or row ``list
        position`` of ``Pi``, width ``i_cap``) against one row of ``P`` (width
        ``width``) per neighbor at ``offsets`` of its ``decode``d
        coordinates."""
        Ki = ids_list.shape[0]
        dev = ids_list.device
        n_nb = len(offsets)
        base, end = self.span(Ki)
        blk = _block_size(self.cell_block, i_cap * width * n_nb, 8, max(1, end - base))
        M = self.M
        for s0 in range(base, end, blk):
            slots_l = s0 + torch.arange(blk, dtype=i64, device=dev)
            ids = ids_list[torch.clamp(slots_l, max=Ki - 1)]
            valid = (slots_l < end) & (ids < id_max)
            coords = decode(torch.where(valid, ids, 0))
            nb = []
            for off in offsets:
                moved = [c + d for c, d in zip(coords, off)]
                ok = valid
                for c in moved:
                    ok = ok & (0 <= c) & (c < M)
                nid = moved[0]
                for c in moved[1:]:
                    nid = nid * M + c
                nb.append(slot_of[torch.where(ok, nid, id_max)])
            nb = torch.stack(nb, dim=1)                          # [B, n_nb]
            if Pi is None:
                my, Wi = P[slot_of[torch.where(valid, ids, id_max)]], width
            else:
                my, Wi = Pi[torch.clamp(slots_l, max=Ki - 1)], i_cap
            rows = P[nb].reshape(blk, n_nb, 5, width).transpose(1, 2).reshape(blk, 5, -1)
            self.block(my, Wi, i_cap, rows, band)


def _class_split(occ: torch.Tensor, occ_valid: torch.Tensor, keys_s: torch.Tensor,
                 count_b: torch.Tensor, slot_b: torch.Tensor, K: int, id_max: int,
                 c_small: int, max_big: int, max_frontier: int, nb_offsets, decode,
                 M: int):
    """The occupancy classes of the cell and column sweeps. Occupied ids
    ``occ`` (sorted, sentinel ``id_max``) split into BIG (more than
    ``c_small`` bodies), FRONTIER (small with a big neighbor at
    ``nb_offsets``) and clean small ones. Returns the three id lists (big
    ``K_big`` long, frontier ``K_f`` long, small K long), the per-body big
    flag and big-list slot (cell-sorted order, ``keys_s`` the bodies' ids),
    and the bodies whose big or frontier entry fell past its list budget."""
    occ_counts = torch.where(occ_valid, torch.searchsorted(keys_s, occ, right=True)
                             - torch.searchsorted(keys_s, occ), 0)
    big = occ_valid & (occ_counts > c_small)
    K_big = min(K, max(256, K // 8)) if max_big <= 0 else min(K, int(max_big))
    K_f = min(K, max(512, K // 4)) if max_frontier <= 0 else min(K, int(max_frontier))
    ids_big = _compact_sorted(big, occ, K_big, id_max)
    big_flag = _dense_flags(torch.clamp(ids_big, max=id_max), ids_big < id_max, id_max)
    coords = decode(torch.where(occ_valid, occ, 0))
    any_big = torch.zeros_like(occ_valid)
    for off in nb_offsets:
        moved = [c + d for c, d in zip(coords, off)]
        ok = torch.ones_like(occ_valid)
        for c in moved:
            ok = ok & (0 <= c) & (c < M)
        nid = moved[0]
        for c in moved[1:]:
            nid = nid * M + c
        any_big = any_big | big_flag[torch.where(ok, nid, id_max)]
    small = occ_valid & ~big
    frontier = small & any_big
    ids_small = _compact_sorted(small & ~any_big, occ, K, id_max)
    ids_front = _compact_sorted(frontier, occ, K_f, id_max)

    # bodies whose cell fell past its list budget lose their target sweep
    # (their source role through the tables is unaffected): counted
    live = (keys_s < id_max) & (slot_b < K)
    body_big = count_b > c_small
    key_c = torch.clamp(keys_s, max=id_max)
    slot_big = _dense_slot_map(ids_big, K_big, id_max)[key_c]
    big_drop = torch.sum(body_big & live & (slot_big >= K_big))
    front_dense = _dense_flags(occ, frontier, id_max)
    slot_f = _dense_slot_map(ids_front, K_f, id_max)[key_c]
    front_drop = torch.sum(front_dense[key_c] & live & (slot_f >= K_f))
    return (ids_big, K_big, ids_front, ids_small, body_big, slot_big,
            big_drop + front_drop)


def _near_cells(sc, pack, sweep: _Sweep, n: int, M: int, K: int, capacity: int,
                max_big: int, max_frontier: int):
    """Near field at CELL granularity (the JAX module's
    ``_near_cells_body``): each occupied finest cell sweeps its (2ws+1)^3
    neighbor cells, one packed row each, split by occupancy class (big cells
    at full ``capacity``, frontier cells at i-width 16 against full-width
    rows, clean small cells at width 16 both sides). Returns the capacity
    and cell overflows (int64 device scalars)."""
    M3 = M ** 3
    ws = sweep.ws
    dev = sc.device
    first, last = _segment_bounds(sc)
    rank = torch.arange(n, dtype=i64, device=dev) - first
    cell_count = last - first
    occ_idx = _compact_sorted((rank == 0) & (sc < M3), sc, K, M3)
    slot_of = _dense_slot_map(occ_idx, K, M3)
    slot = slot_of[torch.clamp(sc, max=M3)]
    in_list = (sc < M3) & (slot < K)
    keep = (rank < capacity) & in_list
    cap_overflow = torch.sum((rank >= capacity) & in_list)
    cell_overflow = torch.sum((slot >= K) & (sc < M3))

    def decode(ids):
        return ids // (M * M), (ids // M) % M, ids % M

    offsets = [(a, b, c) for a in range(-ws, ws + 1) for b in range(-ws, ws + 1)
               for c in range(-ws, ws + 1)]
    split = capacity > 16
    c_small = 16 if split else capacity
    if split:
        ids_big, _, ids_front, ids_small, body_big, _, dropped = _class_split(
            occ_idx, occ_idx < M3, sc, cell_count, slot, K, M3, c_small, max_big,
            max_frontier, offsets, decode, M)
        cell_overflow = cell_overflow + dropped
        # width-16 rows holding only small cells' bodies (their rank is < 16)
        P_s = pack(slot, rank, keep & ~body_big, K, c_small)
        P_full = pack(slot, rank, keep, K, capacity)
    else:
        ids_small = occ_idx
        P_s = P_full = pack(slot, rank, keep, K, capacity)
    sweep.neighbor_sweep(ids_small, slot_of, M3, offsets, decode, c_small, P_s, c_small)
    if split:
        sweep.neighbor_sweep(ids_front, slot_of, M3, offsets, decode, c_small, P_full,
                             capacity)
        sweep.neighbor_sweep(ids_big, slot_of, M3, offsets, decode, capacity, P_full,
                             capacity)
    return cap_overflow, cell_overflow


def _near_columns(sc, pack, sweep: _Sweep, n: int, M: int, capacity: int, max_cells: int,
                  max_big: int, max_frontier: int, max_chunks: int):
    """Near field at COLUMN granularity (the JAX module's ``_near_columns``):
    each occupied (x, y) column sweeps its (2ws+1)^2 neighbor columns with
    the |dz| <= ws cell-band claim as a mask. The budgets are per column
    (c_small = 32); big columns are swept in 32-row i-chunks (``max_chunks``
    of them, 0 = min(K_big ceil(capacity / 32), max(512, 4 K_big))). Returns
    the capacity and cell overflows."""
    M2 = M * M
    ws = sweep.ws
    dev = sc.device
    col_s = torch.clamp(sc // M, max=M2)
    first_c, last_c = _segment_bounds(col_s)
    rank_c = torch.arange(n, dtype=i64, device=dev) - first_c
    col_count = last_c - first_c
    Kc = min(n, M2) if max_cells <= 0 else int(max_cells)
    occ_c = _compact_sorted((rank_c == 0) & (col_s < M2), col_s, Kc, M2)
    slot_c = _dense_slot_map(occ_c, Kc, M2)
    slot_b = slot_c[col_s]
    in_list = (col_s < M2) & (slot_b < Kc)
    keep = (rank_c < capacity) & in_list
    cap_overflow = torch.sum((rank_c >= capacity) & in_list)
    cell_overflow = torch.sum((slot_b >= Kc) & (col_s < M2))

    def decode(ids):
        return ids // M, ids % M

    offsets = [(a, b) for a in range(-ws, ws + 1) for b in range(-ws, ws + 1)]
    c_small = 32 if capacity > 32 else capacity
    split = capacity > c_small
    if split:
        ids_big, K_big, ids_front, ids_small, body_big, slot_big, dropped = _class_split(
            occ_c, occ_c < M2, col_s, col_count, slot_b, Kc, M2, c_small, max_big,
            max_frontier, offsets, decode, M)
        cell_overflow = cell_overflow + dropped
        P_s = pack(slot_b, rank_c, keep & ~body_big, Kc, c_small)
        P_full = pack(slot_b, rank_c, keep, Kc, capacity)
        # the big sweep's i side in c_small-row chunks of the kept big-column
        # bodies (row = chunk ordinal, lane = rank within the chunk)
        cpc = -(-capacity // c_small)
        keep_big = keep & body_big & (slot_big < K_big)
        chunk_start = keep_big & (rank_c % c_small == 0)
        K_ch = (min(K_big * cpc, max(512, 4 * K_big)) if max_chunks <= 0
                else min(int(max_chunks), K_big * cpc))
        chunk_ord = torch.cumsum(chunk_start.to(i64), 0) - 1
        keep_ch = keep_big & (chunk_ord < K_ch)
        cell_overflow = cell_overflow + torch.sum(keep_big & ~keep_ch)
        P_ch = pack(torch.clamp(chunk_ord, 0, K_ch), rank_c % c_small, keep_ch, K_ch,
                    c_small)
        ids_chunk = _compact_sorted(chunk_start & (chunk_ord < K_ch), col_s, K_ch, M2)
    else:
        ids_small = occ_c
        P_s = P_full = pack(slot_b, rank_c, keep, Kc, capacity)
    sweep.neighbor_sweep(ids_small, slot_c, M2, offsets, decode, c_small, P_s, c_small,
                         band=True)
    if split:
        sweep.neighbor_sweep(ids_front, slot_c, M2, offsets, decode, c_small, P_full,
                             capacity, band=True)
        sweep.neighbor_sweep(ids_chunk, slot_c, M2, offsets, decode, c_small, P_full,
                             capacity, Pi=P_ch, band=True)
    return cap_overflow, cell_overflow


def _octave_of(S_ch: torch.Tensor, base_w: int, n_oct: int) -> torch.Tensor:
    """Octave of each chunk: the smallest o with its trimmed neighborhood
    j-chunk total ``S_ch`` <= base_w 2^o (n_oct past the last)."""
    oct_of = torch.zeros_like(S_ch)
    for k in range(n_oct):
        oct_of = oct_of + (S_ch > base_w * (1 << k)).to(S_ch.dtype)
    return oct_of


def _near_pairs(sc, pack, sweep: _Sweep, n: int, M: int, max_chunks: int, chunk: int,
                pair_entries: tuple):
    """Near field at CHUNK-PAIR granularity (the JAX module's
    ``_near_pairs``): every column is cut into ``chunk``-body i-chunks, and
    each sweeps exactly the z-trimmed j-chunk runs of its (2ws+1)^2 neighbor
    columns, padded to the next octave of its j-chunk total (octave o holds
    chunks whose total is at most (2ws+1)^2 2^o; ``pair_entries[o]`` of them
    are swept). Chunks past their octave's budget, or past the last octave,
    lose their target sweep and are counted. Returns the capacity and cell
    overflows."""
    ws = sweep.ws
    C = int(chunk)
    K_ch = int(max_chunks) if max_chunks > 0 else (-(-n // C) + min(n, M * M))
    g = _pairs_geometry(sc, n, M, ws, C, K_ch)
    dev = sc.device
    cap_overflow = torch.sum(g["valid_b"] & (g["chunk_ord"] >= K_ch))
    P = pack(g["chunk_ord"], g["rank_c"] % C, g["keep"], K_ch, C)
    chunk_valid, j_lo, cnt = g["chunk_valid"], g["j_lo"], g["cnt"]
    n_nb = (2 * ws + 1) ** 2
    n_oct = len(pair_entries)
    oct_of = _octave_of(g["S_ch"], n_nb, n_oct)
    chunk_rows = torch.arange(K_ch, dtype=i64, device=dev)
    # chunks past the last compiled octave lose their target sweep too
    drop_flag = chunk_valid & (oct_of >= n_oct)
    for o, E_o in enumerate(pair_entries):
        in_o = chunk_valid & (oct_of == o)
        if E_o <= 0:
            drop_flag = drop_flag | in_o
            continue
        E_o = int(E_o)
        W = n_nb * (1 << o)  # j width in chunk rows
        ord_o = torch.cumsum(in_o.to(i64), 0) - 1
        drop_flag = drop_flag | (in_o & (ord_o >= E_o))
        ids_o = _compact_sorted(in_o & (ord_o < E_o), chunk_rows, E_o, K_ch)
        base, end = sweep.span(E_o)
        blk = _block_size(sweep.cell_block, C * W * C, 1, max(1, end - base))
        p = torch.arange(W, dtype=i64, device=dev)[None, :]      # [1, W]
        for s0 in range(base, end, blk):
            slots_l = s0 + torch.arange(blk, dtype=i64, device=dev)
            ci = ids_o[torch.clamp(slots_l, max=E_o - 1)]
            valid = (slots_l < end) & (ci < K_ch)
            cic = torch.where(valid, torch.clamp(ci, max=K_ch - 1), K_ch - 1)
            # the trimmed (chunk, neighbor) j runs, laid end to end
            cj = torch.where(valid[:, None], cnt[cic], 0)          # [B, n_nb]
            j0 = j_lo[cic]
            ci = torch.where(valid, ci, K_ch)
            cum = torch.cumsum(cj, 1)                              # inclusive
            cum0 = cum - cj
            # segment of slot p: the number of neighbors wholly before it
            seg = torch.sum(p[:, :, None] >= cum[:, None, :], -1)  # [B, W]
            segc = torch.clamp(seg, max=n_nb - 1)
            j_row = torch.gather(j0, 1, segc) + p - torch.gather(cum0, 1, segc)
            j_row = torch.where(p < cum[:, -1:], torch.clamp(j_row, max=K_ch), K_ch)
            rows = P[j_row].reshape(blk, W, 5, C).transpose(1, 2).reshape(blk, 5, -1)
            sweep.block(P[ci], C, C, rows, band=True)
    # dropped i-chunks lose their TARGET sweep: count their kept bodies
    dropped_b = torch.cat([drop_flag, drop_flag.new_zeros(1)])[
        torch.clamp(g["chunk_ord"], max=K_ch)]
    cell_overflow = torch.sum(g["keep"] & dropped_b)
    return cap_overflow, cell_overflow


def _far_ids(cc: torch.Tensor, alive_b: torch.Tensor, M: int) -> torch.Tensor:
    """Octant-major finest-cell ids: octant of the parent (o = ox*4 + oy*2 +
    oz) major, x-major parent cell minor; dead bodies at M^3. The far field's
    finest channels are deposited, produced and gathered in this order, so
    the finest level needs only contiguous block slices."""
    s_fin = M // 2
    oct_b = ((cc[:, 0] & 1) * 2 + (cc[:, 1] & 1)) * 2 + (cc[:, 2] & 1)
    par_b = ((cc[:, 0] >> 1) * s_fin + (cc[:, 1] >> 1)) * s_fin + (cc[:, 2] >> 1)
    return torch.where(alive_b, oct_b * (s_fin ** 3) + par_b, M ** 3)


def _pow2_inverse(x: torch.Tensor) -> torch.Tensor:
    """2^-e for x = f 2^e with f in [0.5, 1) (1 for x = 0), computed
    exactly: f / x is a power of two."""
    f, _ = torch.frexp(x)
    return torch.where(f > 0, f / torch.where(f > 0, x, 1.0), 1.0)


def _far_phase_pow2(pos32, m_eff, alive_b, cc, h, half, origin, levels: int, ws: int,
                    G: float, eps2: float, order: int, with_potential: bool):
    """:func:`_far_phase` in units of powers of two: lengths over ``lam``,
    the power of two next to the grid's half-width, masses over ``mu``, the
    one next to the largest mass. The far phase is homogeneous in both, and
    scaling by a power of two is exact, so the result is the same bits as
    in the given units wherever those keep every float32 intermediate
    normal. On a scene in SI units they do not: at cell widths of ~1e9 m
    the taps' R^-5 and R^-7 are 1e-40 to 1e-45 (subnormal or 0) and the
    order-2 moments m x_i x_j pass float32's range; in these units every
    one of them is of order G. Returns (a_far [N, 3], U_far [])."""
    lam, mu = _pow2_inverse(half), _pow2_inverse(torch.amax(m_eff))
    # eps2 rounded to the compute type, then scaled (no copy to the device)
    a_far, U_far = _far_phase(
        pos32 * lam, m_eff * mu, alive_b, cc, h * lam, half * lam, origin * lam, levels, ws,
        G, lam * lam * eps2, order, with_potential)
    # a = G m / r^2 and U = G m^2 / r back in the given units, one factor
    # at a time (mu^-2 alone may pass float32's range where U does not)
    return a_far / mu * (lam * lam), U_far / mu * lam / mu


def _far_phase(pos32, m_eff, alive_b, cc, h, half, origin, levels: int, ws: int, G: float,
               eps2: float, order: int, with_potential: bool):
    """The multipole pyramid (NGP deposit of the moments at the octant-major
    finest ids, then coarsening), the conv far field, the per-body Taylor
    step, and the cell-wise far potential. Returns (a_far [N, 3], U_far [])."""
    dev, dt = pos32.device, pos32.dtype
    M = 2 ** levels
    M3 = M * M * M
    # the finest layout: octant-major under the push combine, x-major cell
    # ids under "lazy" (the JAX module's oct_layout, tree.py:777)
    push = _FAR_COMBINE == "push"
    far_id = (_far_ids(cc, alive_b, M) if push else
              torch.where(alive_b, (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2], M3))

    raw = [m_eff, m_eff * pos32[:, 0], m_eff * pos32[:, 1], m_eff * pos32[:, 2]]
    if order == 2:
        raw += [m_eff * pos32[:, i] * pos32[:, j] for i, j in _Q6]
    chans = {levels: tuple(
        torch.zeros((M3 + 1,), dtype=dt, device=dev).index_add_(0, far_id, c)[:M3]
        for c in raw)}
    for lev in range(levels - 1, 1, -1):
        if lev == levels - 1 and push:
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
    # moments: sum_cells [m phi_c - A.p (- J:Q/2 at order 2)], in far_id's
    # layout
    if push:
        ctr = _octant_centers(levels, dev, dt)
    else:
        ar = torch.arange(M, device=dev, dtype=dt)
        ctr = [ar.view(M, 1, 1).expand(M, M, M).reshape(-1),
               ar.view(1, M, 1).expand(M, M, M).reshape(-1),
               ar.view(1, 1, M).expand(M, M, M).reshape(-1)]
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


def tree_sharded_force(pos, mass, alive=None, *, comm, _phase: str = "both",
                       with_overflow: bool = False, **kwargs) -> tuple:
    """The tree force of one rank of a body-sharded mesh (the JAX module's
    ``tree_sharded_force``): the rank's shard of (pos, mass, alive) in, its
    shard of the accelerations and the global potential out, with
    ``with_overflow`` also the near-field overflow (int32 0-dim, pmax'd).
    ``kwargs`` are :func:`tree_acc_potential`'s.

    The body arrays are all-gathered, so the deposit, the pyramid and the
    far field run replicated on every rank; the near sweep is split: each
    rank sweeps a contiguous 1/P slice of every near list (for ``"kernel"``
    of the worklist, through B7's slice), and one psum each adds the
    per-body sums. U is the same on every rank up to the far field's
    rounding (the NGP deposit's float atomics on CUDA) and comes out as
    psum(U) / P, as in the JAX module; the overflow counts come from the
    replicated lists and are pmax'd."""
    block = pos.shape[0]
    g = comm.all_gather
    acc, U, ovf = tree_acc_potential(
        g(pos), g(mass), None if alive is None else g(alive), _phase=_phase,
        _n_parts=comm.size, _part_index=comm.rank, _comm=comm, **kwargs)
    U = comm.psum(U) / float(comm.size)
    acc_local = acc[comm.rank * block:(comm.rank + 1) * block]
    if not with_overflow:
        return acc_local, U
    return acc_local, U, comm.pmax(ovf)


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


def _probe_cells(pos, alive, levels: int, box) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Per-axis finest cell coordinates [N, 3] and the alive mask on the CPU,
    binned exactly as :func:`tree_acc_potential` bins them, and M."""
    pos32 = _host(pos, f32)
    n, M = pos32.shape[0], 2 ** levels
    alive_t = None if alive is None else _host(alive, torch.bool)
    box_t = None if box is None else tuple(_host(b, f32) for b in box)
    _, alive_b, *_, cc = _bin(pos32, torch.zeros(n), alive_t, M, box_t, f32)
    return cc, alive_b, M


def _probe_sorted_cells(pos, alive, levels: int, box) -> tuple[torch.Tensor, int, int]:
    """Shared preamble of the probes: the finest-level cell ids on the CPU,
    binned exactly as :func:`tree_acc_potential` bins them (same box fit and
    clipping), sorted with dead bodies last at M^3. Returns ``(sc, n, M)``."""
    cc, alive_b, M = _probe_cells(pos, alive, levels, box)
    return _sort_cells(cc, alive_b, M)[0], cc.shape[0], M


def tree_occupancy_probe(pos, alive=None, *, levels: int = 6, box=None) -> tuple[int, int]:
    """(max bodies per finest cell, occupied finest-cell count), binned
    exactly like :func:`tree_acc_potential`; the ``tree_levels="auto"``
    sizer of ``simulate()``."""
    sc, _, M = _probe_sorted_cells(pos, alive, levels, box)
    counts = torch.bincount(sc, minlength=M ** 3 + 1)[:M ** 3]
    return int(counts.max()), int((counts > 0).sum())


def _class_census(counts: torch.Tensor, c_small: int, ws: int) -> tuple:
    """(max count, occupied, big [> c_small], frontier [small with a big
    neighbor within ws on every axis]) of a dense count grid [M]*d."""
    big = counts > c_small
    k, d = 2 * ws + 1, counts.dim()
    pool = torch.nn.functional.max_pool3d if d == 3 else torch.nn.functional.max_pool2d
    any_big = pool(big.to(f32)[None, None], k, stride=1, padding=ws)[0, 0] > 0
    occupied = counts > 0
    frontier = occupied & ~big & any_big
    return (int(counts.max()), int(occupied.sum()), int(big.sum()), int(frontier.sum()))


def tree_class_probe(pos, alive=None, *, levels: int = 6, ws: int = 1, c_small: int = 16,
                     box=None) -> tuple[int, int, int, int]:
    """Occupancy-class census for sizing the ``near="cells"`` budgets:
    (max bodies per finest cell, occupied cells, BIG cells [> c_small
    bodies], FRONTIER cells [small with a big (2ws+1)^3 neighbor]), the
    sizers of ``capacity`` / ``max_cells`` / ``max_big`` / ``max_frontier``,
    binned exactly like :func:`tree_acc_potential`. Takes host or device
    arrays, runs torch on the CPU and returns Python ints."""
    cc, alive_b, M = _probe_cells(pos, alive, levels, box)
    cell_id = torch.where(alive_b, (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2], M ** 3)
    counts = torch.bincount(cell_id, minlength=M ** 3 + 1)[:M ** 3].reshape(M, M, M)
    return _class_census(counts, c_small, ws)


def tree_column_probe(pos, alive=None, *, levels: int = 6, ws: int = 1, c_small: int = 32,
                      box=None, with_chunks: bool = False) -> tuple:
    """Column-occupancy census for sizing the ``near="columns"`` budgets:
    (max bodies per (x, y) column, occupied columns, BIG columns [>
    c_small bodies], FRONTIER columns [small with a big (2ws+1)^2
    neighbor]), binned exactly like :func:`tree_acc_potential`. With
    ``with_chunks=True`` a fifth value: the c_small-row i-chunks over big
    columns (sum of ceil(count / c_small)), the ``max_chunks`` sizer. Python
    ints, computed on the CPU."""
    cc, alive_b, M = _probe_cells(pos, alive, levels, box)
    col_id = torch.where(alive_b, cc[:, 0] * M + cc[:, 1], M * M)
    counts = torch.bincount(col_id, minlength=M * M + 1)[:M * M].reshape(M, M)
    out = _class_census(counts, c_small, ws)
    if with_chunks:
        big = counts > c_small
        out = out + (int(torch.sum(torch.where(big, -(-counts // c_small), 0))),)
    return out


def tree_pairs_probe(pos, alive=None, *, levels: int = 6, ws: int = 1, chunk: int = 32,
                     n_octaves: int = 16, box=None) -> tuple[int, tuple]:
    """Chunk census for sizing the ``near="pairs"`` budgets: (total chunk
    count, per-octave i-chunk counts [n_octaves]), the ``max_chunks`` /
    ``pair_entries`` sizers. Shares :func:`_pairs_geometry` and the octave
    rule with the sweep, so the budgets cannot drift from its accounting;
    chunks past the last octave are dropped from the counts, as the sweep
    drops them. Python ints, computed on the CPU."""
    sc, n, M = _probe_sorted_cells(pos, alive, levels, box)
    C = int(chunk)
    k_safe = -(-n // C) + min(n, M * M)  # every column adds <= 1 partial chunk
    g = _pairs_geometry(sc, n, M, ws, C, k_safe)
    oct_of = _octave_of(g["S_ch"], (2 * ws + 1) ** 2, n_octaves)
    per_oct = torch.bincount(oct_of[g["chunk_valid"]], minlength=n_octaves + 1)[:n_octaves]
    return int(g["chunk_valid"].sum()), tuple(int(v) for v in per_oct)


def tree_pairs_budgets(pos, alive=None, *, levels: int, ws: int = 1, chunk: int = 32,
                       box=None, headroom: float = 1.5) -> tuple[int, tuple]:
    """Host-side ``(max_chunks, pair_entries)`` for ``near="pairs"``: one
    :func:`tree_pairs_probe` call, trailing zero octaves trimmed,
    ``headroom``-scaled and alignment-rounded (the JAX module's policy)."""
    total, per_oct = tree_pairs_probe(pos, alive, levels=levels, ws=ws, chunk=chunk, box=box)
    per = list(per_oct)
    while per and per[-1] == 0:
        per.pop()
    entries = tuple((max(32, -(-int(v * headroom) // 32) * 32) if v else 0) for v in per)
    max_chunks = max(256, -(-int(total * headroom) // 256) * 256)
    return max_chunks, entries


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
    (column, z-cell) -> first-sorted-position table, or under ``_PAIRS_CF
    = "scan"`` a cell id -> first-sorted-position suffix min over the M^3
    grid (the same integers).

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
    table = _PAIRS_CF == "table"
    if table:
        # (column, z-cell) -> first sorted position with that column and
        # z-cell >= z: a scatter-min of positions and a suffix min along z,
        # queries clamped to the column's end
        colend = column_map(n, last_c)
        zrow = torch.where(valid_b, sc % M, M)
        rt = torch.full(((M2 + 1) * (M + 1),), n, dtype=i64, device=dev)
        rt.scatter_reduce_(0, torch.where(valid_b, col_s, M2) * (M + 1) + zrow, pos_i,
                           "amin", include_self=True)
        rt_flat = rt.view(M2 + 1, M + 1).flip(1).cummin(1).values.flip(1).reshape(-1)
    else:
        # cell id -> first sorted position with cell >= id, a suffix min
        # over the whole grid (dead bodies sort last at M^3, so
        # cellfirst[M^3] is the live count)
        M3 = M2 * M
        cf = torch.full((M3 + 2,), n, dtype=i64, device=dev)
        cf.scatter_reduce_(0, torch.clamp(sc, max=M3), pos_i, "amin", include_self=True)
        cellfirst = cf.flip(0).cummin(0).values.flip(0)

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
        if table:
            ce = colend[nc]
            p_lo = torch.minimum(rt_flat[nc * (M + 1) + zb_lo], ce)
            p_hi = torch.minimum(rt_flat[nc * (M + 1) + zb_hi], ce)
        else:
            p_lo = cellfirst[torch.clamp(nc * M + zb_lo, max=M3 + 1)]
            p_hi = cellfirst[torch.clamp(nc * M + zb_hi, max=M3 + 1)]
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
