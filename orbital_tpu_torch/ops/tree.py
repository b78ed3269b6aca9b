"""The chunk/run search geometry of the tree's ``near="pairs"`` sweep, which
the multirate stepper's neighbor search (``ops/neighbor.py``) shares.

Ported so far from ``orbital_tpu/ops/tree.py``: ``_compact_sorted``,
``_segment_bounds`` and ``_pairs_geometry`` in its per-column rank-table form
(``_PAIRS_CF == "table"``). The JAX module's other locator, a suffix scan
over the whole M^3 cell grid, exists only because the table form was needed
to get a TPU compile through (tree.py:1393-1400); it is left out. The tree
solver itself (far field, near sweeps, probes, staged evaluation) is
ROADMAP.md queue A item A.13.

Everything here is eager integer tensor code that never reads a value back to
the host. The JAX constructs translate as follows: ``jnp.nonzero(size=K)``
becomes a cumsum-and-scatter compaction, ``.at[].set(mode="drop")`` a scatter
into one spare row that is sliced off, ``.at[].min`` a ``scatter_reduce``,
the associative min/max scans ``cummin``/``cummax`` (reversed by flipping).
Indices are int64 inside; the integer results equal the JAX module's.
"""
from __future__ import annotations

import torch

__all__ = ["_compact_sorted", "_segment_bounds", "_pairs_geometry"]

i64 = torch.int64


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
