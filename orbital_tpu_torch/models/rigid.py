"""Rigid-body helpers (host-side).

Same formulas and surface as the reference (reference: core/physics.py:73-122):
moment of inertia for solid sphere / cylinder / thin rod, and a random
angular-velocity generator (random unit axis scaled by U(0, max_rps)).
"""
from __future__ import annotations

from typing import Literal, Optional

import numpy as np

__all__ = ["moment_of_inertia", "random_angular_velocity"]


def moment_of_inertia(
    mass: float,
    radius: float,
    length: Optional[float] = None,
    shape: Literal["sphere", "cylinder", "rod"] = "sphere",
) -> float:
    """Moment of inertia for common shapes (kg*m^2).

    sphere:   I = (2/5) m r^2   (solid, about center)
    cylinder: I = (1/2) m r^2   (solid, about axis)
    rod:      I = (1/12) m L^2  (thin, about center; requires ``length``)
    (reference: core/physics.py:94-106)
    """
    if shape == "sphere":
        return (2.0 / 5.0) * mass * radius**2
    if shape == "cylinder":
        return 0.5 * mass * radius**2
    if shape == "rod":
        if length is None:
            raise ValueError("Length must be provided for rod shape.")
        return (1.0 / 12.0) * mass * length**2
    raise ValueError(f"Unknown shape: {shape}")


def random_angular_velocity(
    max_rotation_rps: float = 1.0,
    dim: int = 3,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random angular-velocity vector: random unit axis times U(0, max_rps)
    (reference: core/physics.py:109-122). Accepts an optional numpy
    Generator for reproducibility (the reference uses the global RNG)."""
    rng_ = rng if rng is not None else np.random.default_rng()
    axis = rng_.standard_normal(dim)
    axis /= np.linalg.norm(axis)
    omega = rng_.uniform(0.0, max_rotation_rps)
    return omega * axis
