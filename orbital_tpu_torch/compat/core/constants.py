"""Compat: reference core/constants.py surface (orbital_tpu_torch.models.constants)."""
from orbital_tpu_torch.models.constants import (  # noqa: F401
    ASTRO,
    AU,
    DAY,
    DEFAULT_ASTRO_INTEGRATOR,
    DEFAULT_STANDARD_INTEGRATOR,
    J2000_JD,
    JULIAN_DAY,
    STANDARD,
    IntegratorParams,
    UnitProfile,
    UnitSystem,
    get_unit_profile,
)
