"""Tagged unit scalars for orbital mechanics.

A copy of ``orbital_tpu.models.units`` (pure Python and numpy), so that
this package never imports the JAX one.

Host-side (pure Python / numpy) unit system with the same public surface as
the reference's ``core/units.py`` (reference: core/units.py:11-86): ``Unit``
subclasses carrying a float value and a unit tag, pairwise converters
(``Meters.to_au`` etc.), angle normalization at construction, and
addition/subtraction that refuses mixed units.

Design differences from the reference:
  * values may be numpy arrays as well as scalars, so whole element tables
    can be converted vectorized before being compiled into device state;
  * a generic :func:`convert` registry drives ``System.standardize_units``
    instead of an if-chain, and makes the set of unit tags introspectable.
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np

__all__ = [
    "AU_METERS",
    "KG_SOLAR",
    "SECONDS_PER_DAY",
    "Unit",
    "Radians",
    "Degrees",
    "Meters",
    "AU",
    "Kilograms",
    "SolarMasses",
    "Seconds",
    "Days",
    "UNIT_BY_TAG",
]

# Conversion anchors (reference: core/units.py:7-8).
AU_METERS = 1.495978707e11  # meters per astronomical unit
KG_SOLAR = 1.98847e30       # kilograms per solar mass
SECONDS_PER_DAY = 86400.0

Number = Union[float, int, np.ndarray]


class Unit:
    """A value tagged with a unit.

    Mixed-unit addition/subtraction raises ``ValueError`` (reference:
    core/units.py:19-27). Values are coerced to float (or float64 ndarray).
    """

    #: canonical tag string, set by subclasses
    tag: str = ""

    def __init__(self, value: Number, unit: str | None = None):
        if isinstance(value, np.ndarray):
            self.value = value.astype(np.float64)
        else:
            self.value = float(value)
        self.unit = unit if unit is not None else self.tag

    def __repr__(self) -> str:
        return f"{self.unit.upper()}({self.value})"

    def __add__(self, other: "Unit") -> "Unit":
        if self.unit != other.unit:
            raise ValueError("Cannot add objects of different types.")
        return self.__class__(self.value + other.value)

    def __sub__(self, other: "Unit") -> "Unit":
        if self.unit != other.unit:
            raise ValueError("Cannot subtract objects of different types.")
        return self.__class__(self.value - other.value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Unit):
            return self.unit == other.unit and np.all(self.value == other.value)
        return NotImplemented

    def __hash__(self):
        return hash((self.unit, float(np.asarray(self.value).sum())))


class Radians(Unit):
    """Angle in radians; normalized to [0, 2pi) at construction
    (reference: core/units.py:32)."""

    tag = "radians"

    def __init__(self, value: Number):
        super().__init__(np.mod(value, 2.0 * math.pi) if isinstance(value, np.ndarray)
                         else float(value) % (2.0 * math.pi))

    def to_degrees(self) -> "Degrees":
        return Degrees(np.degrees(self.value) if isinstance(self.value, np.ndarray)
                       else math.degrees(self.value))


class Degrees(Unit):
    """Angle in degrees; normalized to [0, 360) at construction
    (reference: core/units.py:40)."""

    tag = "degrees"

    def __init__(self, value: Number):
        super().__init__(np.mod(value, 360.0) if isinstance(value, np.ndarray)
                         else float(value) % 360.0)

    def to_radians(self) -> Radians:
        return Radians(np.radians(self.value) if isinstance(self.value, np.ndarray)
                       else math.radians(self.value))


class Meters(Unit):
    tag = "meters"

    def to_au(self) -> "AU":
        return AU(self.value / AU_METERS)


class AU(Unit):
    tag = "au"

    def to_meters(self) -> Meters:
        return Meters(self.value * AU_METERS)


class Kilograms(Unit):
    tag = "kilograms"

    def to_solar_masses(self) -> "SolarMasses":
        return SolarMasses(self.value / KG_SOLAR)


class SolarMasses(Unit):
    tag = "m_solar"

    def to_kilograms(self) -> Kilograms:
        return Kilograms(self.value * KG_SOLAR)


class Seconds(Unit):
    tag = "seconds"

    def to_days(self) -> "Days":
        return Days(self.value / SECONDS_PER_DAY)


class Days(Unit):
    tag = "days"

    def to_seconds(self) -> Seconds:
        return Seconds(self.value * SECONDS_PER_DAY)


#: tag -> class registry used by System.standardize_units and (de)serializers.
UNIT_BY_TAG: dict[str, type[Unit]] = {
    cls.tag: cls
    for cls in (Radians, Degrees, Meters, AU, Kilograms, SolarMasses, Seconds, Days)
}

# Conversion graph: (from_tag, to_tag) -> method name.
_CONVERTERS: dict[tuple[str, str], str] = {
    ("radians", "degrees"): "to_degrees",
    ("degrees", "radians"): "to_radians",
    ("meters", "au"): "to_au",
    ("au", "meters"): "to_meters",
    ("kilograms", "m_solar"): "to_solar_masses",
    ("m_solar", "kilograms"): "to_kilograms",
    ("seconds", "days"): "to_days",
    ("days", "seconds"): "to_seconds",
}


def convert(value: Unit, to_tag: str) -> Unit:
    """Convert a tagged value to another unit tag; identity if already there.

    Raises ``ValueError`` for conversions between incompatible dimensions.
    """
    if not isinstance(value, Unit):
        raise TypeError(f"expected Unit, got {type(value)!r}")
    if value.unit == to_tag:
        return value
    method = _CONVERTERS.get((value.unit, to_tag))
    if method is None:
        raise ValueError(f"no conversion from {value.unit!r} to {to_tag!r}")
    return getattr(value, method)()
