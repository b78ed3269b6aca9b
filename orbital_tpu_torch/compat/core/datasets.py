"""Compat: reference core/datasets.py surface (orbital_tpu_torch.models.datasets)."""
from orbital_tpu_torch.models.body import System  # noqa: F401
from orbital_tpu_torch.models.datasets import (  # noqa: F401
    EPOCH,
    solar_system,
    solar_system_v2,
)
