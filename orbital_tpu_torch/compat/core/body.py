"""Compat: reference core/body.py surface (orbital_tpu_torch.models.body)."""
from orbital_tpu_torch.models.body import Body, System  # noqa: F401
from orbital_tpu_torch.models.constants import STANDARD  # noqa: F401

G = STANDARD.G
