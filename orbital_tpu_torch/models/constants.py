"""Unit profiles: the gravitational constant of each unit system.

The part of ``orbital_tpu.models.constants`` that ``simulate()`` needs,
copied (pure Python) so that this package never imports the JAX one.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

__all__ = ["UnitSystem", "UnitProfile", "ASTRO", "STANDARD"]


class UnitSystem(str, Enum):
    ASTRO = "astro"  # AU, M_sun, day
    SI = "si"        # m, kg, s


@dataclass(frozen=True)
class UnitProfile:
    """An internally consistent unit system for the dynamics.

    ``G`` is expressed in the profile's own units; the AU/M_SUN/DAY anchors
    give the size of one astronomical unit / solar mass / day in the
    profile's distance/mass/time units (identity in ASTRO).
    """

    name: UnitSystem
    G: float
    distance_unit: str
    mass_unit: str
    time_unit: str
    AU: float
    M_SUN: float
    DAY: float


ASTRO = UnitProfile(
    name=UnitSystem.ASTRO,
    G=0.0002959122082855911,  # AU^3 / (M_sun * day^2)
    distance_unit="AU",
    mass_unit="M_sun",
    time_unit="day",
    AU=1.0,
    M_SUN=1.0,
    DAY=1.0,
)

STANDARD = UnitProfile(
    name=UnitSystem.SI,
    G=6.67430e-11,  # m^3 / (kg * s^2)
    distance_unit="m",
    mass_unit="kg",
    time_unit="s",
    AU=1.495978707e11,  # meters
    M_SUN=1.98847e30,   # kg
    DAY=86400.0,        # seconds
)
