"""Host-side scene arrays, the input of :func:`orbital_tpu_torch.simulate`.

Only the :class:`SceneArrays` container is ported so far; compiling a
Keplerian ``System`` or an ``ObjectCollection`` into it
(``orbital_tpu.models.scene.compile_system`` / ``compile_objects``) comes
with the rest of ``models/`` (ROADMAP.md queue A item A.10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["SceneArrays"]


@dataclass
class SceneArrays:
    """Host-side f64 SoA arrays in physical (scene) units."""

    pos: np.ndarray      # [N, 3]
    vel: np.ndarray      # [N, 3]
    mass: np.ndarray     # [N]
    radius: np.ndarray   # [N]
    names: list[str]
    uuids: Optional[list[str]] = None

    @property
    def n(self) -> int:
        return len(self.mass)
