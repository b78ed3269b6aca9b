"""The tree's worklist near field (``near="kernel"``): geometry, budgets and
the plain version of its sweep.

A port of ``orbital_tpu/ops/tree_near_wl.py``. Every i-chunk's trimmed
j-runs (consecutive chunk rows of the slot-major body table, one run per
neighbor column, from ``ops/tree.py::_pairs_geometry``) are rounded to
RJ-row blocks and deduplicated (:func:`_wl_runs`). Every pair of an
(i-chunk, j-block) entry is gated by the exact finest-cell band
``|c_i - c_j|_inf <= ws`` and the self-pair mask ``idx_i != idx_j``
(:func:`_entry_math`), so block rounding never adds a pair and the near/far
partition stays exact. The potential adds no self term and subtracts none.

The sweep runs on the CUDA kernel of ``ops/cuda_tree.py`` (B7), which walks
each i-chunk's runs ``(start_blk, n_blk)`` directly and writes one
(ax, ay, az, pe) row per slot. Its plain version here,
:func:`tree_near_plain`, follows the JAX module: the flat worklist of
:func:`_wl_expand`, :func:`_entry_math` per entry, and a segment-sum by
slot. The budgets, ``max_chunks`` and ``wl_entries``, come from
:func:`tree_wl_budgets`, which shares the geometry with the sweep; an
i-chunk whose runs do not fit in ``wl_entries`` loses its whole sweep and
its kept bodies are counted in the overflow, never silently lost.

Layout of the body table, as the JAX module's ``Pbods`` (f32, exact for
idx and cell coordinates below 2^24):

  pbods [kpad*C, 8]   slot-major   x y z m idx cx cy cz

Sentinel rows carry position 1e30 (r^2 overflows to +inf and rsqrt(inf) is
0), mass 0, idx n and cells 1e9 (the band fails against every real cell),
so padded rows are inert by value and by select, never by a 0/1 product.
"""
from __future__ import annotations

from typing import Optional

import torch

from .tree import _pairs_geometry, _probe_sorted_cells

__all__ = ["tree_wl_probe", "tree_wl_budgets", "tree_near_plain", "wl_span", "clip_runs"]

i64 = torch.int64

# the sentinel row of the body table (see the module docstring)
_SENTINEL = (1e30, 1e30, 1e30, 0.0, None, 1e9, 1e9, 1e9)
# worklist entries per batch of the plain sweep (each is C x RJ*C pairs)
_PLAIN_BATCH = 512
# the JAX module's worklist entries a grid step (its ``wl_group``), which
# rounds the parts of a sharded sweep
WL_GROUP = 8


def _wl_runs(g: dict, rj: int, k_ch: int, kpad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """RJ-aligned, deduplicated j-block runs per (i-chunk, neighbor column).

    ``_pairs_geometry`` emits the neighbor runs of a chunk in increasing
    table order, so a running coverage watermark removes the overlap that
    rounding to RJ-row blocks brings between adjacent runs (without it a
    block shared by two rounded runs of one chunk would count twice).

    Returns ``(start_blk, n_blk)`` [k_ch, n_nb] in j-block units."""
    j_lo, cnt = g["j_lo"], g["cnt"]  # [k_ch, n_nb], chunk-row units
    max_blk = kpad // rj
    has = cnt > 0
    lo_blk = torch.where(has, j_lo // rj, 0)
    hi_blk = torch.where(has, torch.clamp(-(-(j_lo + cnt) // rj), max=max_blk), 0)
    watermark = torch.zeros((k_ch,), dtype=j_lo.dtype, device=j_lo.device)
    starts, counts = [], []
    for t in range(j_lo.shape[1]):
        s = torch.maximum(lo_blk[:, t], watermark)
        c = torch.where(has[:, t], torch.clamp(hi_blk[:, t] - s, min=0), 0)
        starts.append(torch.where(c > 0, s, 0))
        counts.append(c)
        watermark = torch.where(has[:, t], torch.maximum(watermark, hi_blk[:, t]), watermark)
    return torch.stack(starts, dim=1), torch.stack(counts, dim=1)


def _wl_drop(n_blk: torch.Tensor, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(exclusive offsets of the runs in chunk-major order, per-chunk drop
    flags): a chunk is dropped when any of its runs ends past the budget
    ``q``. Kept chunks are exactly those whose whole sweep fits."""
    k_ch, n_nb = n_blk.shape
    cnt_f = n_blk.reshape(-1)
    off = torch.cumsum(cnt_f, 0) - cnt_f
    over_run = (off + cnt_f > q) & (cnt_f > 0)
    return off, torch.any(over_run.reshape(k_ch, n_nb), dim=1)


def _wl_expand(start_blk: torch.Tensor, n_blk: torch.Tensor, k_ch: int, q: int,
               qp: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten the per-(chunk, neighbor) block runs into the worklist.

    Entry q of run r (exclusive-cumsum offsets) carries ``(i_chunk,
    start_blk[r] + (q - off[r]))``. An i-chunk whose sweep does not fit
    inside the ``q`` budget loses its WHOLE sweep (entries masked to the
    sentinel chunk ``k_ch``) and is reported in ``drop_chunk``. Returns
    ``(wl_i, wl_jb, drop_chunk)``, the first two of length ``qp``; the
    integers equal the JAX module's."""
    dev = n_blk.device
    n_nb = n_blk.shape[1]
    cnt_f = n_blk.reshape(-1).to(i64)
    start_f = start_blk.reshape(-1).to(i64)
    off, drop_chunk = _wl_drop(n_blk.to(i64), q)
    drop_f = drop_chunk.repeat_interleave(n_nb)

    # scatter each emitted run's index at its offset, forward-max fills
    emit = (cnt_f > 0) & (off < q)
    n_runs = cnt_f.shape[0]
    run_mark = torch.zeros((qp + 1,), dtype=i64, device=dev)
    run_mark.scatter_reduce_(0, torch.where(emit, off, qp),
                             torch.arange(1, n_runs + 1, dtype=i64, device=dev), "amax")
    run = torch.cummax(run_mark[:qp], 0).values - 1
    runc = torch.clamp(run, 0, n_runs - 1)
    pos_q = torch.arange(qp, dtype=i64, device=dev)
    local = pos_q - off[runc]
    valid = (run >= 0) & (local < cnt_f[runc]) & ~drop_f[runc] & (pos_q < q)
    wl_i = torch.where(valid, runc // n_nb, k_ch).to(torch.int32)
    wl_jb = torch.where(valid, start_f[runc] + local, 0).to(torch.int32)
    return wl_i, wl_jb, drop_chunk


def _entry_math(ib: torch.Tensor, jb: torch.Tensor, ws: int, eps2: float) -> torch.Tensor:
    """(i-chunk, j-block) interactions, batched over leading dims: ``ib``
    [..., C, 8] (x y z m idx cx cy cz), ``jb`` [..., 8, W] its channel-major
    counterpart; returns the [..., C, 8] rows ax ay az pe idx 0 0 0 (acc
    without G). The mask is the exact cell band and the self-pair exclusion,
    applied by select: sentinel pairs give r^2 = inf, rsqrt 0, and are
    masked."""
    xi, yi, zi = ib[..., 0:1], ib[..., 1:2], ib[..., 2:3]
    idx_i = ib[..., 4:5]
    cxi, cyi, czi = ib[..., 5:6], ib[..., 6:7], ib[..., 7:8]
    xj, yj, zj = jb[..., 0:1, :], jb[..., 1:2, :], jb[..., 2:3, :]
    mj, idx_j = jb[..., 3:4, :], jb[..., 4:5, :]
    cxj, cyj, czj = jb[..., 5:6, :], jb[..., 6:7, :], jb[..., 7:8, :]

    dx = xj - xi  # [..., C, W]
    dy = yj - yi
    dz = zj - zi
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv_r = torch.rsqrt(r2)
    wsf = float(ws)
    take = ((torch.abs(cxj - cxi) <= wsf) & (torch.abs(cyj - cyi) <= wsf)
            & (torch.abs(czj - czi) <= wsf) & (idx_i != idx_j))
    zero = torch.zeros((), dtype=ib.dtype, device=ib.device)
    w = torch.where(take, mj * (inv_r * inv_r * inv_r), zero)
    pe = torch.sum(torch.where(take, mj * inv_r, zero), dim=-1, keepdim=True)
    ax = torch.sum(w * dx, dim=-1, keepdim=True)
    ay = torch.sum(w * dy, dim=-1, keepdim=True)
    az = torch.sum(w * dz, dim=-1, keepdim=True)
    return torch.cat([ax, ay, az, pe, idx_i, torch.zeros_like(ib[..., :3])], dim=-1)


def tree_near_plain(pbods: torch.Tensor, start_blk: torch.Tensor, n_blk: torch.Tensor, *,
                    wl_entries: int, chunk: int, rj: int, ws: int,
                    eps2: float) -> torch.Tensor:
    """The plain version of the B7 sweep, on any device: the worklist of
    :func:`_wl_expand`, :func:`_entry_math` over its entries in batches, and
    a segment-sum of the rows by slot. Returns ``[k_ch * chunk, 4]`` (ax, ay,
    az, pe) per slot, acc without G; slots of dropped or empty chunks are 0.
    """
    c, w = int(chunk), int(rj) * int(chunk)
    k_ch = n_blk.shape[0]
    q = int(wl_entries)
    wl_i, wl_jb, _ = _wl_expand(start_blk, n_blk, k_ch, q, q)
    live = wl_i < k_ch
    wl_i, wl_jb = wl_i[live].to(i64), wl_jb[live].to(i64)
    out = torch.zeros(((k_ch + 1) * c, 4), dtype=pbods.dtype, device=pbods.device)
    ar_c = torch.arange(c, device=pbods.device)
    ar_w = torch.arange(w, device=pbods.device)
    for b0 in range(0, wl_i.shape[0], _PLAIN_BATCH):
        ii, jj = wl_i[b0:b0 + _PLAIN_BATCH], wl_jb[b0:b0 + _PLAIN_BATCH]
        rows_i = ii[:, None] * c + ar_c                       # [E, C]
        ib = pbods[rows_i]                                    # [E, C, 8]
        jb = pbods[jj[:, None] * w + ar_w].transpose(1, 2)    # [E, 8, W]
        res = _entry_math(ib, jb, ws, eps2)[..., :4]
        out.index_add_(0, rows_i.reshape(-1), res.reshape(-1, 4))
    return out[:k_ch * c]


def _wl_table(sc, pos_srt, m_srt, sort_idx, n: int, M: int, ws: int, max_chunks: int,
              chunk: int, wl_entries: int, wl_rj: int) -> dict:
    """Everything the B7 sweep takes, from the cell-sorted bodies: the
    slot-major body table ``pbods``, the block runs ``start_blk`` and
    ``n_blk`` [k_ch, (2ws+1)^2] (the counts of the chunks that the worklist
    budget drops set to 0) and ``off``, their exclusive offsets in the flat
    chunk-major worklist (B7's slice cuts the runs to a span by them), all
    three int32 and contiguous, as the kernel reads them; per sorted body
    its ``slot`` and ``keep`` flag; with the overflows (int64 device
    scalars): bodies past the chunk budget (``cap_overflow``) and kept
    bodies of chunks the worklist budget drops (``cell_overflow``)."""
    c, rj = int(chunk), int(wl_rj)
    if (rj * c) % 128 != 0:
        raise ValueError(f"near='kernel' needs wl_rj*chunk % 128 == 0 for lane alignment "
                         f"(got {rj}*{c}={rj * c})")
    if c % 8 != 0:
        raise ValueError(f"near='kernel' needs chunk % 8 == 0 (got {c})")
    q = int(wl_entries)
    if q <= 0:
        raise ValueError("near='kernel' needs wl_entries > 0: size it with "
                         "ops.tree_near_wl.tree_wl_budgets")
    k_ch = int(max_chunks) if max_chunks > 0 else (-(-n // c) + min(n, M * M))
    kpad = -(-(k_ch + 1) // rj) * rj
    dev = sc.device

    g = _pairs_geometry(sc, n, M, ws, c, k_ch)
    cap_overflow = torch.sum(g["valid_b"] & (g["chunk_ord"] >= k_ch))
    start_blk, n_blk = _wl_runs(g, rj, k_ch, kpad)
    off, drop_chunk = _wl_drop(n_blk, q)
    # dropped i-chunks lose their target sweep: count their kept bodies
    dropped_b = torch.cat([drop_chunk, torch.zeros((1,), dtype=torch.bool, device=dev)])[
        torch.clamp(g["chunk_ord"], max=k_ch)]
    keep = g["keep"]
    cell_overflow = torch.sum(keep & dropped_b)
    # the dropped chunks are a suffix of the non-empty ones in worklist
    # order, so zeroing their runs leaves every kept entry's offset as it was
    n_blk = torch.where(drop_chunk[:, None], 0, n_blk)
    i32 = torch.int32
    runs = dict(start_blk=start_blk.to(i32).contiguous(), n_blk=n_blk.to(i32).contiguous(),
                off=off.reshape(n_blk.shape).to(i32).contiguous())

    # slot-major body table (dead and unkept bodies write sentinel rows)
    slot = torch.where(keep, g["chunk_ord"] * c + g["rank_c"] % c, k_ch * c)
    col_valid = g["col_s"] < M * M
    dt = pos_srt.dtype
    cx = torch.where(col_valid, g["col_s"] // M, 0).to(dt)
    cy = torch.where(col_valid, g["col_s"] % M, 0).to(dt)
    cz = torch.where(col_valid, sc % M, 0).to(dt)
    sent = torch.tensor([float(n) if v is None else v for v in _SENTINEL], dtype=dt,
                        device=dev)
    vals = torch.stack([pos_srt[:, 0], pos_srt[:, 1], pos_srt[:, 2], m_srt,
                        sort_idx.to(dt), cx, cy, cz], dim=1)
    vals = torch.where(keep[:, None], vals, sent)
    pbods = sent.expand(kpad * c, 8).clone()
    pbods[slot] = vals
    return dict(pbods=pbods, slot=slot, keep=keep, k_ch=k_ch, cap_overflow=cap_overflow,
                cell_overflow=cell_overflow, **runs)


def wl_span(wl_entries: int, n_parts: int, part: int) -> tuple[int, int]:
    """The worklist entries [lo, hi) that part ``part`` of ``n_parts``
    sweeps: the JAX module's ``q_part``, the budget rounded up to whole
    groups of WL_GROUP entries, split in ``n_parts`` and rounded up to a
    group again, so that the padded tail lands on the last part."""
    q, g, parts = int(wl_entries), WL_GROUP, max(1, int(n_parts))
    q_part = -(-(-(-q // g) * g) // parts)
    q_part = -(-q_part // g) * g
    return part * q_part, (part + 1) * q_part


def clip_runs(start_blk: torch.Tensor, n_blk: torch.Tensor, lo: int, hi: int,
              off: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The runs ``(start_blk, n_blk)`` cut to the worklist entries [lo, hi):
    the flat worklist lays the runs end to end in chunk-major order (their
    exclusive offsets ``off``, or the exclusive cumsum of ``n_blk``), and
    each run keeps the part of it that falls inside the span, its start
    moved past the entries before ``lo``. B7 over the clipped runs sums
    exactly the entries of the JAX module's slice of the worklist; B7's
    slice cuts them so inside the kernel (``csrc/tree_near.cu``,
    ``load_run``). Returns int64 runs."""
    cnt = n_blk.reshape(-1).to(i64)
    off = torch.cumsum(cnt, 0) - cnt if off is None else off.reshape(-1).to(i64)
    before = torch.clamp(lo - off, min=0)
    after = torch.clamp(off + cnt - hi, min=0)
    kept = torch.clamp(cnt - before - after, min=0)
    start = torch.where(kept > 0, start_blk.reshape(-1).to(i64) + before, 0)
    return start.reshape(n_blk.shape), kept.reshape(n_blk.shape)


def _near_wl(sc, pos_srt, m_srt, sort_idx, n: int, M: int, ws: int, eps2: float,
             G: float, max_chunks: int, chunk: int, wl_entries: int, wl_rj: int,
             n_parts: int = 1, part: int = 0):
    """Near field at chunk-pair granularity through the B7 wrapper
    (``ops/cuda_tree.py``: the kernel for CUDA tensors, the plain version for
    CPU ones). Returns ``(idx, acc, pe, cap_overflow, cell_overflow)``: one
    row per sorted body, ``idx`` its body index (each body once), ``acc``
    including G and ``pe`` = sum_j m_j / r, 0 for bodies outside the kept
    chunks; the overflows are int64 device scalars. With ``n_parts`` > 1
    only the entries of :func:`wl_span`'s slice are summed (B7's slice,
    ``cuda_tree.tree_near_part_cuda``); the overflows are the whole
    worklist's."""
    from . import cuda_tree

    t = _wl_table(sc, pos_srt, m_srt, sort_idx, n, M, ws, max_chunks, chunk, wl_entries,
                  wl_rj)
    c = int(chunk)
    kw = dict(wl_entries=wl_entries, chunk=c, rj=wl_rj, ws=ws, eps2=eps2)
    if n_parts > 1:
        out = cuda_tree.tree_near_part_cuda(t["pbods"], t["start_blk"], t["n_blk"], t["off"],
                                            span=wl_span(wl_entries, n_parts, part), **kw)
    else:
        out = cuda_tree.tree_near_cuda(t["pbods"], t["start_blk"], t["n_blk"], **kw)
    rows = out[torch.clamp(t["slot"], max=t["k_ch"] * c - 1)]
    rows = torch.where(t["keep"][:, None], rows, 0.0)
    return sort_idx, G * rows[:, 0:3], rows[:, 3], t["cap_overflow"], t["cell_overflow"]


def tree_wl_probe(pos, alive=None, *, levels: int = 6, ws: int = 1, chunk: int = 32,
                  rj: int = 8, box=None) -> tuple[int, int]:
    """Worklist census for ``near="kernel"``: (total chunk count, total
    j-block worklist entries), the ``max_chunks`` / ``wl_entries`` sizers.
    Shares ``_pairs_geometry`` and :func:`_wl_runs` with the sweep (same box
    fit, dead-body handling, chunking, z-trimmed runs, RJ rounding and
    dedup), so the budgets cannot drift from its accounting. Takes host or
    device arrays and runs torch on the CPU."""
    sc, n, M = _probe_sorted_cells(pos, alive, levels, box)
    c = int(chunk)
    k_safe = -(-n // c) + min(n, M * M)
    kpad = -(-(k_safe + 1) // int(rj)) * int(rj)
    g = _pairs_geometry(sc, n, M, ws, c, k_safe)
    _, n_blk = _wl_runs(g, int(rj), k_safe, kpad)
    return int(g["chunk_valid"].sum()), int(n_blk.sum())


def tree_wl_budgets(pos, alive=None, *, levels: int, ws: int = 1, chunk: int = 32,
                    rj: int = 8, box=None, headroom: float = 1.5) -> tuple[int, int]:
    """Host-side ``(max_chunks, wl_entries)`` for ``near="kernel"``: one
    :func:`tree_wl_probe` call, headroom-scaled and alignment-rounded."""
    total, entries = tree_wl_probe(pos, alive, levels=levels, ws=ws, chunk=chunk, rj=rj,
                                   box=box)
    max_chunks = max(256, -(-int(total * headroom) // 256) * 256)
    wl_entries = max(64, -(-int(entries * headroom) // 64) * 64)
    return max_chunks, wl_entries
