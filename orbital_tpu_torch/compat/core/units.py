"""Compat: reference core/units.py surface (orbital_tpu_torch.models.units)."""
from orbital_tpu_torch.models.units import (  # noqa: F401
    AU,
    AU_METERS,
    KG_SOLAR,
    Days,
    Degrees,
    Kilograms,
    Meters,
    Radians,
    Seconds,
    SolarMasses,
    Unit,
)
