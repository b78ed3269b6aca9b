"""Block runs of the tree's worklist near field, which the multirate
stepper's neighbor search (``ops/neighbor.py``) shares.

Ported so far from ``orbital_tpu/ops/tree_near_wl.py``: ``_wl_runs``. The
tree's worklist kernel itself (``_wl_kernel``, B7) and its budgets are
ROADMAP.md queue A item A.13.
"""
from __future__ import annotations

import torch

__all__ = ["_wl_runs"]


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
