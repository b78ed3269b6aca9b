r"""P3M gravity: the particle-mesh far field plus an exact short-range sum.

Ported from ``orbital_tpu/ops/p3m.py``. The softened kernel is split (Ewald,
Hockney & Eastwood):

    1/sqrt(r^2+eps^2) = erf(r/2s)/r  +  [1/sqrt(r^2+eps^2) - erf(r/2s)/r]
                        \__ mesh __/     \__ short range, ~0 past ~4.5 s __/

The mesh solves the smooth erf kernel through ``ops.pm._pm_core`` (split
scale s = ``sigma_cells`` mesh cells); the short-range remainder is summed
exactly over the 27 neighbour cells of an r_cut-sized cell grid:

  * bodies are binned by a stable argsort of their cell id; the rank in the
    cell comes from ``ops.tree._segment_bounds``;
  * a [cells + 1, capacity] table holds up to ``capacity`` bodies a cell (the
    extra row is an all-sentinel pad for dead bodies); bodies past capacity
    are dropped from the short-range sum and counted (``overflow``);
  * the sum over each cell's bodies against its 27 neighbours' is the CUDA
    kernel ``csrc/p3m_short.cu`` on CUDA tensors (``ops.cuda_p3m``), which
    stands in for the JAX module's ``lax.map`` over cell blocks of
    [M] x [27 M] masked tiles; on CPU tensors its plain version,
    :func:`p3m_short_plain`, computes those tiles.

:func:`p3m_ring_force` is the body-sharded form (one rank's code against a
``parallel.mesh.Comm``): the mesh part is the sharded PM pipeline (a local
deposit, one psum of the grid, a replicated FFT), and the short range rides
a ring: each shard is binned into the global cell grid once, on its owner,
and its view (the kept rows in the kernel's order) visits every rank, where
each local cell sums its bodies against the visitor's 27 neighbour cells
(the two-table form of the kernel, whose plain version is
:func:`p3m_short_pair_plain`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .pm import _bounding_cube, _pm_core
from .tree import _segment_bounds

__all__ = ["p3m_acc_potential", "p3m_ring_force", "p3m_overflow_probe",
           "p3m_max_occupancy", "p3m_cell_table", "p3m_short_plain", "p3m_short_pair_plain",
           "_short_factors"]

f32 = torch.float32
i64 = torch.int64
# the 27 neighbour offsets, in the JAX module's order
_OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]
# the position of an empty table slot (with mass 0)
SENTINEL = 1e30
# the plain sum's pair slots a block of cells (~130 MB a float32 temporary)
_PLAIN_SLOTS = 1 << 25


def _short_factors(r2: torch.Tensor, sigma, eps2: float):
    """Short-range acceleration factor g(r) (acc = G m_j g(r) (r_j - r_i))
    and potential kernel K_short(r), both finite at r = 0: g(0) = 0 and
    K_short(0) = 1/eps - 2 alpha / sqrt(pi), alpha = 1 / (2 sigma). ``sigma``
    is a number or a 0-dim tensor."""
    alpha = 1.0 / (2.0 * sigma)
    safe = r2 > 0.0
    r2s = torch.where(safe, r2, 1.0)
    r = torch.sqrt(r2s)
    inv_r = 1.0 / r
    inv_r3 = inv_r * inv_r * inv_r
    erf_t = torch.special.erf(alpha * r)
    gauss = (2.0 * alpha / math.sqrt(math.pi)) * torch.exp(-(alpha * r) ** 2)
    g_exact = torch.rsqrt(r2 + eps2) / (r2 + eps2)
    g_long = (erf_t - gauss * r) * inv_r3
    g = torch.where(safe, g_exact - g_long, 0.0)
    k0 = eps2 ** -0.5 - 2.0 * alpha / math.sqrt(math.pi)
    k_short = torch.where(safe, torch.rsqrt(r2s + eps2) - erf_t * inv_r, k0)
    return g, k_short


def _cell_grid(g: int, sigma_cells: float, cut_sigma: float) -> int:
    """Short-range cells a side: each at least r_cut wide."""
    return max(1, int(g / (sigma_cells * cut_sigma)))


def _cell_ids(pos32: torch.Tensor, alive_b: torch.Tensor, center: torch.Tensor,
              half: torch.Tensor, gc: int) -> torch.Tensor:
    """Flat short-range cell id of each body (clipped into the grid), dead
    bodies at the pad id gc^3."""
    s_cell = 2.0 * half / gc
    cc = torch.clamp(torch.floor((pos32 - (center - half)) / s_cell).to(i64), 0, gc - 1)
    cell_id = (cc[:, 0] * gc + cc[:, 1]) * gc + cc[:, 2]
    return torch.where(alive_b, cell_id, gc ** 3)


def p3m_cell_table(pos32: torch.Tensor, m_eff: torch.Tensor, alive_b: torch.Tensor,
                   center: torch.Tensor, half: torch.Tensor, *, gc: int,
                   capacity: int) -> dict:
    """The short-range cell table, as the JAX module builds it: ``order``
    (the stable argsort of the cell ids), ``rank`` (each sorted body's place
    in its cell), ``keep`` (ranked under capacity, live), ``overflow`` (live
    bodies past capacity, int32 0-dim), ``count`` [gc^3] (kept bodies a
    cell, int32: each cell's row holds them as a prefix), ``table``
    [gc^3 + 1, capacity] of body indices (N in empty slots), ``cell_pos`` [gc^3 + 1, capacity, 3]
    (SENTINEL in empty slots) and ``cell_m`` [gc^3 + 1, capacity] (0 there).
    Dropped scatters go to one spare row that is sliced off."""
    n, dev = pos32.shape[0], pos32.device
    gc3 = gc ** 3
    cell_id = _cell_ids(pos32, alive_b, center, half, gc)
    order = torch.argsort(cell_id, stable=True)
    sc = cell_id[order]
    first, _ = _segment_bounds(sc)
    rank = torch.arange(n, dtype=i64, device=dev) - first
    keep = (rank < capacity) & (sc < gc3)
    overflow = torch.sum((rank >= capacity) & (sc < gc3), dtype=torch.int32)
    s_row = torch.where(keep, sc, gc3)
    r_col = torch.clamp(rank, 0, capacity - 1)
    # rows of [gc3 + 2, capacity]: row gc3 + 1 takes the dropped scatters
    slot = torch.where(keep, s_row * capacity + r_col, (gc3 + 1) * capacity)
    rows = (gc3 + 2) * capacity
    table = torch.full((rows,), n, dtype=i64, device=dev)
    table[slot] = torch.where(keep, order, n)
    cell_pos = torch.full((rows, 3), SENTINEL, dtype=f32, device=dev)
    cell_pos[slot] = torch.where(keep[:, None], pos32[order],
                                 torch.tensor(SENTINEL, dtype=f32, device=dev))
    cell_m = torch.zeros((rows,), dtype=f32, device=dev)
    cell_m[slot] = torch.where(keep, m_eff[order], torch.zeros((), dtype=f32, device=dev))
    cut = (gc3 + 1) * capacity
    count = torch.bincount(s_row, minlength=gc3 + 1)[:gc3].to(torch.int32)
    return dict(order=order, rank=rank, keep=keep, overflow=overflow, count=count,
                table=table[:cut].reshape(gc3 + 1, capacity),
                cell_pos=cell_pos[:cut].reshape(gc3 + 1, capacity, 3),
                cell_m=cell_m[:cut].reshape(gc3 + 1, capacity))


def _neighbour_cells(cells: torch.Tensor, gc: int) -> torch.Tensor:
    """[B, 27] ids of each cell's neighbours in _OFFSETS order, gc^3 (the
    pad row) outside the grid or for cells >= gc^3."""
    gc3 = gc ** 3
    valid = cells < gc3
    cz, cy, cx = cells % gc, (cells // gc) % gc, cells // (gc * gc)
    ids = []
    for a, b, c in _OFFSETS:
        nx, ny, nz = cx + a, cy + b, cz + c
        ok = ((0 <= nx) & (nx < gc) & (0 <= ny) & (ny < gc) & (0 <= nz) & (nz < gc) & valid)
        ids.append(torch.where(ok, (nx * gc + ny) * gc + nz, gc3))
    return torch.stack(ids, dim=1)


def p3m_short_plain(table: torch.Tensor, cell_pos: torch.Tensor, cell_m: torch.Tensor, *,
                    gc: int, n: int, G: float, sigma, rcut2, eps2: float,
                    cell_block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """The short-range sum in the JAX module's tile form: each block of
    cells, its [M] bodies against its 27 neighbours' [27 M] rows, pairs with
    idx_i != idx_j and r^2 < rcut2, then the rows scattered back to the
    bodies. A block holds at most ``cell_block`` cells and _PLAIN_SLOTS
    pair slots (each body sits in one slot, so the blocking does not change
    the sums). ``sigma`` and ``rcut2`` are numbers or 0-dim tensors. Returns
    (acc [n, 3] = G sum m_j g (r_j - r_i), pe [n] = sum m_j K_short) in the
    table's float type; bodies outside the table (overflowed, dead) get 0.
    The kernel's plain version."""
    return _short_tiles(table, cell_pos, table, cell_pos, cell_m, table, table < n, gc=gc,
                        n=n, G=G, sigma=sigma, rcut2=rcut2, eps2=eps2, cell_block=cell_block)


def p3m_short_pair_plain(table_i: torch.Tensor, cell_pos_i: torch.Tensor,
                         gid_i: torch.Tensor, cell_pos_j: torch.Tensor,
                         cell_m_j: torch.Tensor, gid_j: torch.Tensor, *, gc: int, n: int,
                         G: float, sigma, rcut2, eps2: float,
                         cell_block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring round's short-range sum (the JAX module's ``sweep`` in
    ``p3m_ring_force``): the bodies of table i (``table_i`` [gc^3 + 1, M]
    of local indices, n in empty slots, ``cell_pos_i``) against the rows of
    table j (``cell_pos_j``, ``cell_m_j``) in the 27 cells around each,
    pairs with gid_i != gid_j and r^2 < rcut2. ``gid_i`` and ``gid_j`` are
    the tables' global ids ([gc^3 + 1, M], -2 and -1 in empty slots), so
    self pairs drop out in the diagonal round. Returns (acc [n, 3], pe [n])
    for the bodies of table i, as :func:`p3m_short_plain` does. The plain
    version of the kernel's two-table form."""
    return _short_tiles(table_i, cell_pos_i, gid_i, cell_pos_j, cell_m_j, gid_j, gid_j >= 0,
                        gc=gc, n=n, G=G, sigma=sigma, rcut2=rcut2, eps2=eps2,
                        cell_block=cell_block)


def _short_tiles(table, pos_i, key_i, pos_j, m_j, key_j, used_j, *, gc: int, n: int,
                 G: float, sigma, rcut2, eps2: float, cell_block: int):
    """The tile form over an i table (body indices ``table``, ``pos_i``)
    and a j table (``pos_j``, ``m_j``, its occupied slots ``used_j``), pairs
    whose keys differ. Each cell's kept bodies are a prefix of its row, so
    the tiles stop at the fullest cell of each table: the slots past it are
    empty on every row and add nothing (a one-time host read of each
    width)."""
    gc3, dev = gc ** 3, table.device
    w_i = max(1, int((table < n).sum(1).max()))
    w_j = max(1, int(used_j.sum(1).max()))
    table, pos_i, key_i = table[:, :w_i], pos_i[:, :w_i], key_i[:, :w_i]
    pos_j, m_j, key_j = pos_j[:, :w_j], m_j[:, :w_j], key_j[:, :w_j]
    ft = pos_i.dtype
    block = max(1, min(cell_block, _PLAIN_SLOTS // (27 * w_i * w_j)))
    acc = torch.zeros((n + 1, 3), dtype=ft, device=dev)
    pe = torch.zeros((n + 1,), dtype=ft, device=dev)
    for c0 in range(0, gc3, block):
        cells = torch.arange(c0, min(c0 + block, gc3), device=dev)
        b = cells.shape[0]
        nb = _neighbour_cells(cells, gc)                         # [B, 27]
        idx_my = table[cells]                                    # [B, M]
        key_my = key_i[cells]                                    # [B, M]
        key_nb = key_j[nb].reshape(b, -1)                        # [B, 27M]
        pi = pos_i[cells]                                        # [B, M, 3]
        pj = pos_j[nb].reshape(b, -1, 3)                         # [B, 27M, 3]
        mj = m_j[nb].reshape(b, -1)                              # [B, 27M]
        d = pj[:, None, :, :] - pi[:, :, None, :]                # [B, M, 27M, 3]
        r2 = (d * d).sum(-1)
        ok = (key_my[:, :, None] != key_nb[:, None, :]) & (r2 < rcut2)
        gsh, ksh = _short_factors(r2, sigma, eps2)
        w = torch.where(ok, mj[:, None, :] * gsh, 0.0)
        acc_b = G * (w[..., None] * d).sum(2)                   # [B, M, 3]
        pe_b = torch.where(ok, mj[:, None, :] * ksh, 0.0).sum(-1)
        flat = idx_my.reshape(-1)
        acc.index_add_(0, flat, acc_b.reshape(-1, 3))
        pe.index_add_(0, flat, pe_b.reshape(-1))
    return acc[:n], pe[:n]


def _erf_kernel(sigma_cells: float):
    """The mesh part's smooth kernel erf(r / 2 sigma) / r (its limit
    1 / (sigma sqrt(pi)) at r = 0), sigma = sigma_cells cells."""
    def kern_long(r2_grid, h):
        sigma = sigma_cells * h
        rg = torch.sqrt(r2_grid)
        safe = rg > 0.0
        return torch.where(safe,
                           torch.special.erf(rg / (2.0 * sigma))
                           / torch.where(safe, rg, torch.ones_like(rg)),
                           1.0 / (sigma * math.sqrt(math.pi)))
    return kern_long


def p3m_acc_potential(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G_grav: float,
    eps2: float,
    grid: int = 64,
    sigma_cells: float = 1.5,
    cut_sigma: float = 4.5,
    capacity: int = 64,
    cell_block: int = 32,
    with_potential: bool = True,
    deconvolve: bool = True,
    box=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P3M accelerations, potential and the short-range overflow count:
    (acc [N, 3], U, overflow int32 0-dim on the device), computed in
    float32, acc and U in ``pos``'s dtype.

    ``box = (center [3], half)`` pins the mesh and the short-range cell grid
    (a fixed split makes the total force conservative). ``overflow`` counts
    live bodies that did not fit their cell's ``capacity`` and were left out
    of the short-range sum (0 = exact within the split's truncation).
    ``cell_block`` is the plain version's cells a block. Requires eps2 > 0."""
    if eps2 <= 0.0:
        raise ValueError("the P3M solver requires eps2 > 0")
    from .cuda_p3m import p3m_short_cuda

    n, g, dev = pos.shape[0], int(grid), pos.device
    pos32 = pos.to(f32)
    alive_b = (torch.ones((n,), dtype=torch.bool, device=dev) if alive is None
               else alive.to(torch.bool))
    alive_f = alive_b.to(f32)
    m_eff = mass.to(f32) * alive_f

    acc_mesh, phi_at, h, center, half = _pm_core(
        pos32, m_eff, alive_f, g=g, G_grav=G_grav, kern_builder=_erf_kernel(sigma_cells),
        with_potential=with_potential, deconvolve=deconvolve, box=box)
    # the split scale and the cut on the device, in float32 as JAX traces
    # them: no host read
    sigma = sigma_cells * h
    rcut2 = (cut_sigma * sigma) ** 2

    gc = _cell_grid(g, sigma_cells, cut_sigma)
    tab = p3m_cell_table(pos32, m_eff, alive_b, center, half, gc=gc, capacity=capacity)
    acc_short, pe_short = p3m_short_cuda(tab["table"], tab["cell_pos"], tab["cell_m"],
                                         count=tab["count"], gc=gc, n=n, G=G_grav, sigma=sigma,
                                         rcut2=rcut2, eps2=eps2, cell_block=cell_block)
    acc = (acc_mesh + acc_short) * alive_f[:, None]
    if with_potential:
        # the mesh self-interaction under the erf kernel: -G m K_long(0)
        self_phi = -G_grav * m_eff * (1.0 / (sigma * math.sqrt(math.pi)))
        U_mesh = 0.5 * torch.sum(m_eff * (phi_at - self_phi))
        U = U_mesh + (-0.5 * G_grav) * torch.sum(m_eff * pe_short)
    else:
        U = torch.zeros((), dtype=f32, device=dev)
    return acc.to(pos.dtype), U.to(pos.dtype), tab["overflow"]


def p3m_ring_force(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G_grav: float,
    eps2: float,
    grid: int = 64,
    sigma_cells: float = 1.5,
    cut_sigma: float = 4.5,
    capacity: int = 64,
    cell_block: int = 32,
    with_potential: bool = True,
    deconvolve: bool = True,
    box=None,
    comm,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Body-sharded P3M, one rank's code against ``comm`` (a
    ``parallel.mesh.Comm``): the rank's shard of (pos, mass, alive) in, its
    shard of the accelerations and the global potential out, as
    :func:`p3m_acc_potential` would give them for the whole system.

    The mesh part is ``ops.pm._pm_core`` with the communicator (the cube by
    pmin/pmax unless ``box`` pins it, one psum of the density grid). The
    short range is a ring: this rank bins its shard into the global cell
    grid once and builds its view (``ops.cuda_p3m.p3m_short_view_cuda``:
    the kept rows in the kernel's order, their global ids, each cell's runs
    and run boxes); every round sums this rank's view against a visiting
    one (the kernel's two-table form, ``ops.cuda_p3m.p3m_short_round_cuda``,
    adding into the rank's outputs), then passes the visitor's rows on
    (``ops.cuda_p3m.SHIPPED``), so no rank bins or reorders another's
    shard. Each rank's pair work is its own bodies against the visitors
    within reach, about 1/P of the single-card sum; the JAX module's tile
    form repeats every cell block in every round.

    The capacity overflow is not returned (the JAX function's contract):
    size ``capacity`` with :func:`p3m_max_occupancy` on the whole system.
    Binned per shard, a cell holds fewer bodies than binned whole, so the
    ring drops no more than the single-card sum does; the two agree when
    neither overflows. Requires eps2 > 0."""
    if eps2 <= 0.0:
        raise ValueError("the P3M solver requires eps2 > 0")
    from .cuda_p3m import SHIPPED, p3m_short_round_cuda, p3m_short_view_cuda, short_params

    nloc, g, dev = pos.shape[0], int(grid), pos.device
    pos32 = pos.to(f32)
    alive_b = (torch.ones((nloc,), dtype=torch.bool, device=dev) if alive is None
               else alive.to(torch.bool))
    alive_f = alive_b.to(f32)
    m_eff = mass.to(f32) * alive_f

    acc_mesh, phi_at, h, center, half = _pm_core(
        pos32, m_eff, alive_f, g=g, G_grav=G_grav, kern_builder=_erf_kernel(sigma_cells),
        with_potential=with_potential, deconvolve=deconvolve, box=box, comm=comm)
    sigma = sigma_cells * h
    rcut2 = (cut_sigma * sigma) ** 2
    gc = _cell_grid(g, sigma_cells, cut_sigma)
    kw = dict(gc=gc, n=nloc, G=G_grav, sigma=sigma, rcut2=rcut2, eps2=eps2,
              cell_block=cell_block)
    if dev.type == "cuda":
        kw["params"] = short_params(sigma, rcut2, dev)

    gid = comm.rank * nloc + torch.arange(nloc, dtype=i64, device=dev)
    tab = p3m_cell_table(pos32, m_eff, alive_b, center, half, gc=gc, capacity=capacity)
    # this shard's view, built once: every round reads it, and the ring
    # carries it to the other ranks
    view_i = p3m_short_view_cuda(tab, gc, nloc, gid)
    visit = tuple(view_i[k] for k in SHIPPED)
    out = None
    for k in range(comm.size):
        # round 0 visits this rank's own shard
        view_j = view_i if k == 0 else dict(zip(SHIPPED, visit))
        out = p3m_short_round_cuda(view_i, view_j, out=out, **kw)
        if k < comm.size - 1:
            visit = comm.ppermute(visit)
    acc_s, pe_s = out

    acc = (acc_mesh + acc_s) * alive_f[:, None]
    if with_potential:
        self_phi = -G_grav * m_eff * (1.0 / (sigma * math.sqrt(math.pi)))
        u_local = (0.5 * torch.sum(m_eff * (phi_at - self_phi))
                   + (-0.5 * G_grav) * torch.sum(m_eff * pe_s))
        U = comm.psum(u_local)
    else:
        U = torch.zeros((), dtype=f32, device=dev)
    return acc.to(pos.dtype), U.to(pos.dtype)


def p3m_max_occupancy(pos: torch.Tensor, alive: Optional[torch.Tensor] = None, *,
                      grid: int = 64, sigma_cells: float = 1.5, cut_sigma: float = 4.5,
                      box=None) -> int:
    """The most live bodies in any short-range cell, binned as
    :func:`p3m_acc_potential` bins them (the capacity sizer)."""
    n, g, dev = pos.shape[0], int(grid), pos.device
    pos32 = pos.to(f32)
    alive_b = (torch.ones((n,), dtype=torch.bool, device=dev) if alive is None
               else alive.to(torch.bool))
    gc = _cell_grid(g, sigma_cells, cut_sigma)
    if box is None:
        center, half = _bounding_cube(pos32, alive_b.to(f32), g)
    else:
        center = torch.as_tensor(box[0], dtype=f32, device=dev)
        half = torch.as_tensor(box[1], dtype=f32, device=dev)
    cell_id = _cell_ids(pos32, alive_b, center, half, gc)
    counts = torch.bincount(cell_id, weights=None, minlength=gc ** 3 + 1)
    return int(counts[:gc ** 3].max())


def p3m_overflow_probe(state, cfg) -> int:
    """Short-range capacity check of a state: a nonzero return means
    ``cfg.p3m_capacity`` must grow (or the box or grid change) before the
    results can be trusted. The stepper's force path drops the count."""
    box = cfg.pm_box_arrays()
    if box is not None:
        box = tuple(torch.as_tensor(b, dtype=f32, device=state.pos.device) for b in box)
    _, _, ov = p3m_acc_potential(state.pos, state.mass, state.alive, G_grav=cfg.G,
                                 eps2=cfg.eps2, grid=cfg.pm_grid, capacity=cfg.p3m_capacity,
                                 with_potential=False, box=box)
    return int(ov)
