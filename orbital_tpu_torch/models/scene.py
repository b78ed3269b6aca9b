"""Scene compilation: host scene objects -> SoA arrays for device state.

The bridge between the two body abstractions (see SURVEY: the reference
keeps static Keplerian ``Body`` and dynamic ``Object`` separate; the bridge
is ``Body.get_state()`` -> ``Object`` at app/app.py:36-49 and
examples.py:207-215). Here the bridge lands directly in numpy SoA arrays
ready for ``engine.state.make_state``. A copy of
``orbital_tpu.models.scene``, so that this package never imports the JAX one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .body import Body, System
from .objects import Object, ObjectCollection

__all__ = ["SceneArrays", "compile_system", "compile_objects"]


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


def compile_system(system: System, compose_parents: bool = True) -> SceneArrays:
    """Keplerian System -> state arrays (SI units).

    Standardizes the system to SI in place, converts each body's elements to
    a state vector, and (single-level, like the reference app at
    app/app.py:37-40) adds the parent's heliocentric state for moons when
    ``compose_parents`` is set.
    """
    system.standardize_units(
        mass_unit="kilograms", distance_unit="meters",
        angle_unit="radians", time_unit="seconds",
    )
    pos, vel, mass, radius, names = [], [], [], [], []
    for body in system:
        r, v = body.get_state()
        r, v = np.asarray(r, np.float64), np.asarray(v, np.float64)
        if compose_parents and body.parent is not None and body.parent.parent is not None:
            pr, pv = body.parent.get_state()
            r = r + np.asarray(pr)
            v = v + np.asarray(pv)
        pos.append(r)
        vel.append(v)
        mass.append(body.mass.value)
        radius.append(body.radius.value)
        names.append(body.name)
    return SceneArrays(
        pos=np.stack(pos), vel=np.stack(vel),
        mass=np.asarray(mass), radius=np.asarray(radius), names=names,
    )


def compile_objects(objects: ObjectCollection | list[Object]) -> SceneArrays:
    """Dynamic ObjectCollection -> state arrays (their own units)."""
    objs = list(objects)
    return SceneArrays(
        pos=np.stack([o.position() for o in objs]).astype(np.float64),
        vel=np.stack([np.asarray(o.velocity, np.float64) for o in objs]),
        mass=np.asarray([o.mass for o in objs], np.float64),
        radius=np.asarray([o.radius for o in objs], np.float64),
        names=[o.name for o in objs],
        uuids=[o.uuid for o in objs],
    )
