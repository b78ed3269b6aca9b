"""Switched short-range neighbor force for the multirate (RESPA) stepper.

The multirate integrator (``engine/multirate.py``) splits the softened pair
potential into a smooth near/far pair by a quintic switch S(r) on the true
pair distance (S = 1 below r1, 0 above rc):

    V_near(r) = V(r) S(r),    V_far(r) = V(r) (1 - S(r))

Both parts are exact gradients of fixed smooth Hamiltonians, so the
impulse multiple-time-step composition is symplectic. The cell geometry
below is only a search structure for the pairs where S > 0: it never enters
the dynamics.

This module is the port of ``orbital_tpu/ops/neighbor.py``:

  * ``neighbor_geometry`` bins live bodies on an M^3 grid of cell size
    ``cell = rc + skin``, sorts them by cell id (a stable sort: cell ids tie
    constantly and the slots follow the order of ties), chunks each (x, y)
    column into C-body rows (``ops.tree._pairs_geometry``) and flattens each
    chunk's z-trimmed 9-column runs into a table ``jbl`` of RJ-row j-blocks
    (``ops.tree_near_wl._wl_runs``), and optionally into the row-major
    worklist of its live entries. Frozen for a macro window; a pair within
    rc at any substep was within rc + skin at the build (each body moves at
    most skin/2, which the stepper checks).
  * ``pack_slots`` / ``unpack_slots`` (also under the JAX package's names
    for the row form, ``pack_rows`` / ``unpack_rows``) scatter body values
    or rows into the chunk-slot table and back.
  * ``near_acc_slots`` is the plain PyTorch sweep over the j-block table,
    the plain version of the CUDA kernel in ``ops/cuda_neighbor.py``;
    ``near_acc_dense`` is the O(N^2) oracle.
  * ``neighbor_budgets`` sizes the static budgets on the host: its probe
    runs as torch on the CPU, whatever device the run is on.

Budgets follow the repo's contract: bodies or blocks past them are dropped
and counted, never lost silently. The geometry reads nothing back to the
host, so a rollout that rebuilds it only queues work.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .tree import _pairs_geometry
from .tree_near_wl import _wl_runs

__all__ = [
    "neighbor_geometry", "neighbor_budgets", "pack_slots", "unpack_slots",
    "pack_rows", "unpack_rows",
    "near_acc_slots", "near_acc_dense", "switch_terms", "SENTINEL_POS",
]

f32 = torch.float32
i32 = torch.int32
i64 = torch.int64

# parked position of padding slots: far from any live body, with the squared
# distance still finite in f32 ((2e15)^2 = 4e30 < 3.4e38)
SENTINEL_POS = 1.0e15


def switch_terms(r2t: torch.Tensor, r1: float, rc: float):
    """Quintic-smoothstep switch on the true squared distance r2t:
    s = clip((rc^2 - r2t) / (rc^2 - r1^2), 0, 1), S = s^3 (10 - 15 s + 6 s^2).
    Returns ``(S, sp_over_D)`` with ``sp_over_D = (dS/ds) / (rc^2 - r1^2)``,
    the factor of the conservative shell term:

        a_near(i <- j) = G dx [m_j (S invr^3 + 2 sp_over_D invr)]
    """
    inv_d = 1.0 / (rc * rc - r1 * r1)
    s = torch.clamp((rc * rc - r2t) * inv_d, 0.0, 1.0)
    s2 = s * s
    S = s * s2 * (10.0 + s * (-15.0 + 6.0 * s))
    sp = 30.0 * s2 * (1.0 - s) * (1.0 - s)
    return S, sp * inv_d


def _cell_ids(pos32: torch.Tensor, origin: torch.Tensor, cell: float, M: int) -> torch.Tensor:
    cc = torch.clamp(torch.floor((pos32 - origin) * (1.0 / cell)).to(i64), 0, M - 1)
    return (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]


def neighbor_geometry(
    pos: torch.Tensor,
    alive: torch.Tensor,
    *,
    cell: float,
    m_grid: int,
    chunk: int = 32,
    max_chunks: int = 512,
    w_blk: int = 8,
    rj: int = 4,
    origin: Optional[torch.Tensor] = None,
    wl_entries: int = 0,
) -> dict:
    """Frozen neighbor-search geometry for one macro window.

    Bins live bodies on an ``m_grid``^3 grid of size ``cell`` anchored at
    ``origin`` (default: the live minimum less half a cell, refit on every
    call), sorts by cell id, chunks columns into ``chunk``-body rows and
    flattens each chunk's neighbor runs into ``jbl [max_chunks, w_blk]`` of
    RJ-row j-block indices; the live entries of a row are its prefix, and the
    rest hold the sentinel ``max_chunks // rj``, the all-dead block past the
    table.

    Returns a dict of tensors on ``pos``'s device:
      ``slot`` [n] int32, body -> chunk slot (``n_slots = (max_chunks + rj)
      * chunk`` for dropped bodies); ``jbl`` [max_chunks, w_blk] int32;
      ``cap_overflow`` (live bodies past the chunk budget) and
      ``w_overflow`` (chunks whose blocks overflow ``w_blk``), 0-dim int32;
      ``origin`` [3].

    With ``wl_entries > 0``, also the row-major compaction of ``jbl``'s live
    entries: ``wl_i`` / ``wl_jb`` [wl_entries] int32 (chunk ``max_chunks``
    and the sentinel block for the inert tail), ``wl_first`` (1 where a
    chunk's run starts), ``wl_row_live`` [max_chunks * chunk] bool (rows of
    the chunks the worklist visits) and ``q_overflow`` (live entries past the
    budget; their chunks' farthest blocks are dropped).
    """
    n = pos.shape[0]
    dev = pos.device
    C, K_ch, RJ, W = int(chunk), int(max_chunks), int(rj), int(w_blk)
    if K_ch % RJ:
        raise ValueError(f"max_chunks={K_ch} must be a multiple of rj={RJ}")
    M = int(m_grid)
    pos32 = pos.to(f32)
    alive_b = alive.to(torch.bool)
    if origin is None:
        pmin = torch.amin(torch.where(alive_b[:, None], pos32, 3.0e38), dim=0)
        origin = pmin - 0.5 * cell
    sc_unsorted = torch.where(alive_b, _cell_ids(pos32, origin, cell, M), M * M * M)
    sort_idx = torch.argsort(sc_unsorted, stable=True)
    g = _pairs_geometry(sc_unsorted[sort_idx], n, M, 1, C, K_ch)

    n_slots = (K_ch + RJ) * C
    slot = torch.empty((n,), dtype=i32, device=dev)
    slot[sort_idx] = torch.where(g["keep"], g["chunk_ord"] * C + g["rank_c"] % C,
                                 n_slots).to(i32)
    cap_overflow = torch.sum(g["valid_b"] & (g["chunk_ord"] >= K_ch)).to(i32)

    start_blk, n_blk = _wl_runs(g, RJ, K_ch, K_ch)      # [K_ch, 9]
    cum = torch.cumsum(n_blk, dim=1)
    cum0 = cum - n_blk
    total = cum[:, -1]
    w_overflow = torch.sum((total > W) & g["chunk_valid"]).to(i32)

    p = torch.arange(W, dtype=i64, device=dev)[None, :]             # [1, W]
    seg = torch.sum(p[:, :, None] >= cum[:, None, :], dim=-1)        # [K_ch, W]
    segc = torch.clamp(seg, max=n_blk.shape[1] - 1)
    jbl = (torch.take_along_dim(start_blk, segc, dim=1) + p
           - torch.take_along_dim(cum0, segc, dim=1))
    live = (p < torch.clamp(total, max=W)[:, None]) & g["chunk_valid"][:, None]
    jbl = torch.where(live, jbl, K_ch // RJ)

    out = dict(slot=slot, jbl=jbl.to(i32), cap_overflow=cap_overflow,
               w_overflow=w_overflow, origin=origin)
    if wl_entries:
        Q = int(wl_entries)
        lv = live.reshape(-1)                       # row-major: chunk-sorted
        dest = torch.cumsum(lv.to(i64), 0) - 1
        total_real = dest[-1] + 1
        dest = torch.where(lv & (dest < Q), dest, Q)  # past the budget: dropped
        rows = torch.arange(K_ch, dtype=i64, device=dev).repeat_interleave(W)
        wl_i = torch.full((Q + 1,), K_ch, dtype=i64, device=dev)
        wl_i[dest] = rows
        wl_jb = torch.full((Q + 1,), K_ch // RJ, dtype=i64, device=dev)
        wl_jb[dest] = jbl.reshape(-1)
        wl_i, wl_jb = wl_i[:Q], wl_jb[:Q]
        wl_first = torch.cat([torch.ones((1,), dtype=i64, device=dev),
                              (wl_i[1:] != wl_i[:-1]).to(i64)])
        visited = torch.zeros((K_ch + 1,), dtype=torch.bool, device=dev)
        visited[wl_i] = True
        out.update(wl_i=wl_i.to(i32), wl_jb=wl_jb.to(i32), wl_first=wl_first.to(i32),
                   wl_row_live=visited[:K_ch].repeat_interleave(C),
                   q_overflow=torch.clamp(total_real - Q, min=0).to(i32))
    return out


def pack_slots(slot: torch.Tensor, vals: torch.Tensor, n_slots: int, fill) -> torch.Tensor:
    """Scatter per-body values [n] (or rows [n, CH]) into the chunk-slot
    table. Dropped bodies carry ``slot == n_slots`` and vanish; untouched
    slots keep ``fill``, a scalar or a [CH] row (``SENTINEL_POS`` for
    positions, 0 for masses and velocities, so padding is force-inert by
    value). The table's type follows ``vals``."""
    out = torch.empty((n_slots + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out[:] = torch.as_tensor(fill, dtype=vals.dtype, device=vals.device)
    out[slot] = vals  # dropped bodies all land in the spare row
    return out[:n_slots]


def unpack_slots(slot: torch.Tensor, table: torch.Tensor, fallback: torch.Tensor,
                 valid_below: int) -> torch.Tensor:
    """Gather per-body values (or rows) back from the slot table; bodies whose
    slot is at or past ``valid_below`` (dropped) take ``fallback`` instead."""
    safe = torch.clamp(slot, max=table.shape[0] - 1)
    cond = (slot < valid_below).reshape(slot.shape + (1,) * (table.ndim - 1))
    return torch.where(cond, table[safe], fallback.to(table.dtype))


# the JAX package's names for the row forms (one op for all channels)
pack_rows = pack_slots
unpack_rows = unpack_slots


def near_acc_slots(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, ms: torch.Tensor,
    jbl: torch.Tensor,
    *,
    r1: float, rc: float, G: float, eps2: float,
    chunk: int = 32, rj: int = 4, block: int = 64,
    i0: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Switched near-field sweep over the frozen j-block table: the plain
    PyTorch version of the CUDA kernel (``ops.cuda_neighbor``), gathering
    the j side of ``block`` chunks at a time.

    Inputs are slot-space channels [n_slots] (``pack_slots``). Returns
    ``(acc [max_chunks * chunk, 3], pe [max_chunks * chunk])`` in slot order;
    ``pe[i] = sum_j m_j invr S`` without the self pair: multiply by -G/2 and
    sum for the near potential energy. Chunk c's i rows are the slots
    ``[c * chunk, (c + 1) * chunk)``, which the JAX sweep pads its channels to
    reach without clamping.

    ``i0`` (an int, the mesh-sharding hook) sweeps only the i chunks
    ``[i0, i0 + jbl.shape[0])`` of the slot table, ``jbl`` being their rows
    of the block table, against the whole j side: the rows come back for
    those chunks alone (``[jbl.shape[0] * chunk]``).
    """
    K_ch, W = jbl.shape
    C, RJ = int(chunk), int(rj)
    base = 0 if i0 is None else int(i0)
    blkw = RJ * C
    n_blocks = xs.shape[0] // blkw
    P = torch.stack([xs, ys, zs, ms], dim=0).reshape(4, n_blocks, blkw)
    B = max(1, min(int(block), K_ch))
    accs, pes = [], []
    for k0 in range(0, K_ch, B):
        k1 = min(k0 + B, K_ch)
        b = k1 - k0
        xi, yi, zi = (v[(base + k0) * C:(base + k1) * C].reshape(b, C, 1)
                      for v in (xs, ys, zs))
        jb = jbl[k0:k1]                                     # [b, W]
        xj, yj, zj, mj = (P[k][jb].reshape(b, 1, W * blkw) for k in range(4))
        dx = xj - xi
        dy = yj - yi
        dz = zj - zi
        r2t = dx * dx + dy * dy + dz * dz
        S, spd = switch_terms(r2t, r1, rc)
        inv_r = torch.rsqrt(r2t + eps2)
        w = mj * (S * (inv_r * inv_r * inv_r) + (2.0 * spd) * inv_r)
        accs.append(G * torch.stack([torch.sum(w * dx, -1), torch.sum(w * dy, -1),
                                     torch.sum(w * dz, -1)], dim=-1))   # [b, C, 3]
        pes.append(torch.sum(mj * inv_r * S, -1))                       # [b, C]
    acc = torch.cat(accs).reshape(K_ch * C, 3)
    # the self pair adds no acceleration (dx = 0) but m_i rsqrt(eps2) S(0)
    # to the PE sum: subtract it (S(0) = 1 since r1 > 0)
    pe = torch.cat(pes).reshape(K_ch * C) - ms[base * C:(base + K_ch) * C] * (
        float(eps2) ** -0.5)
    return acc, pe


def near_acc_dense(pos, mass, alive, *, r1: float, rc: float, G: float, eps2: float):
    """O(N^2) switched near force, f32: the brute-force oracle of tests."""
    alive_f = alive.to(f32)
    m = (mass * alive.to(mass.dtype)).to(f32)
    p = pos.to(f32)
    d = p[None, :, :] - p[:, None, :]                       # [N, N, 3]
    r2t = torch.sum(d * d, dim=-1)
    S, spd = switch_terms(r2t, r1, rc)
    inv_r = torch.rsqrt(r2t + eps2)
    off = 1.0 - torch.eye(pos.shape[0], dtype=f32, device=pos.device)
    w = m[None, :] * (S * inv_r ** 3 + (2.0 * spd) * inv_r) * off   # exact self-zero
    acc = G * torch.einsum("ij,ijk->ik", w, d) * alive_f[:, None]
    pe = torch.sum(m[None, :] * inv_r * S * off, dim=-1)
    return acc, pe


def _budget_probe(pos32, alive, origin, cell: float, m_grid: int, chunk: int, rj: int):
    """(chunks, max blocks of a chunk, total blocks) of the geometry with a
    chunk budget that cannot overflow."""
    n = pos32.shape[0]
    M, C = int(m_grid), int(chunk)
    sc = torch.sort(torch.where(alive, _cell_ids(pos32, origin, cell, M), M * M * M)).values
    K_safe = -(-n // C) + min(n, M * M)
    K_safe = -(-K_safe // rj) * rj
    g = _pairs_geometry(sc, n, M, 1, C, K_safe)
    _, n_blk = _wl_runs(g, rj, K_safe, K_safe)
    per_chunk = torch.where(g["chunk_valid"], torch.sum(n_blk, dim=1), 0)
    return int(torch.sum(g["chunk_valid"])), int(torch.max(per_chunk)), int(torch.sum(per_chunk))


def neighbor_budgets(
    pos: np.ndarray,
    alive=None,
    *,
    cell: float,
    chunk: int = 32,
    rj: int = 4,
    headroom: float = 1.5,
    span_margin: float = 1.5,
    with_wl: bool = False,
    w_headroom: Optional[float] = None,
) -> tuple[int, ...]:
    """Host-side ``(m_grid, max_chunks, w_blk)`` from the initial distribution,
    through the sweep's own ``_pairs_geometry`` and ``_wl_runs`` so that the
    accounting cannot drift. ``m_grid`` covers ``span_margin`` times the live
    extent, so that the per-window origin refit keeps every body binned
    unclipped as the system breathes. ``with_wl=True`` appends the worklist
    budget ``wl_entries``, sized from the total live block count as ``w_blk``
    is from the largest. ``w_headroom`` (default ``headroom``) sizes ``w_blk``
    on its own. The probe runs as torch on the CPU, whatever device the run
    is on."""
    pos = np.asarray(pos)
    n = pos.shape[0]
    alive_np = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
    live = pos[alive_np]
    span = float(np.max(live.max(0) - live.min(0))) if live.size else 1.0
    m_grid = max(4, int(np.ceil(span * span_margin / cell)) + 2)
    center = (live.max(0) + live.min(0)) / 2.0 if live.size else np.zeros(3)
    origin = torch.tensor(center - 0.5 * m_grid * cell, dtype=f32)
    total, max_w, sum_w = _budget_probe(
        torch.tensor(pos, dtype=f32), torch.from_numpy(alive_np), origin, float(cell),
        m_grid, int(chunk), int(rj))
    lcm = int(np.lcm(rj, 8))
    max_chunks = max(lcm, -(-int(total * headroom) // lcm) * lcm)
    wh = headroom if w_headroom is None else w_headroom
    w_blk = max(4, int(np.ceil(max_w * wh)) + 1)
    if with_wl:
        wl_entries = max(64, int(np.ceil(sum_w * headroom)) + 1)
        return m_grid, max_chunks, w_blk, wl_entries
    return m_grid, max_chunks, w_blk
