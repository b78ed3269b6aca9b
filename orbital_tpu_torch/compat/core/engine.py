"""Compat: reference core/engine.py surface, the port's engine
(orbital_tpu_torch.engine.engine) on the device ``core.use_device`` chose."""
from orbital_tpu_torch.engine.engine import SimulationEngine as _Engine
from orbital_tpu_torch.engine.engine import run_simulation  # noqa: F401

from . import default_device


class SimulationEngine(_Engine):
    """``orbital_tpu_torch.SimulationEngine`` with ``device`` defaulting to
    :func:`core.default_device` (the card unless ``core.use_device`` said
    otherwise)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=default_device() if device is None else device,
                         **kwargs)
