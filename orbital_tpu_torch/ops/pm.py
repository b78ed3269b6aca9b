"""The bounding cube of the live bodies, which the tree solver bins in.

Ported so far from ``orbital_tpu/ops/pm.py``: ``_bounding_cube``, without its
``axis_name`` collective (the sharded solvers are ROADMAP.md queue A item
A.15). The particle-mesh solver itself is item A.12.
"""
from __future__ import annotations

import torch

__all__ = ["_bounding_cube"]


def _bounding_cube(pos32: torch.Tensor, alive_f: torch.Tensor,
                   g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Center [3] and half-width (0-dim) of the live bodies' bounding cube,
    with a 2%-plus-one-cell margin (``g`` cells per side), in float32."""
    big = torch.tensor(3.4e38, dtype=torch.float32, device=pos32.device)
    live = (alive_f > 0)[:, None]
    lo = torch.where(live, pos32, big).amin(dim=0)
    hi = torch.where(live, pos32, -big).amax(dim=0)
    center = 0.5 * (lo + hi)
    half = torch.clamp((0.5 * (hi - lo)).amax(), min=1e-30) * (1.02 + 2.0 / g)
    return center, half
