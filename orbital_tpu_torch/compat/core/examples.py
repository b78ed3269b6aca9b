"""Compat: reference core/examples.py surface (orbital_tpu_torch.models.examples),
each preset on the device ``core.use_device`` chose."""
import functools

from orbital_tpu_torch.models import examples as _examples

from . import default_device

__all__ = ["sol_from_kepler_dataset", "sun_earth_moon", "three_body_equilateral",
           "two_body_problem"]


def _on_default_device(preset):
    @functools.wraps(preset)
    def run(*args, device=None, **kwargs):
        return preset(*args, device=default_device() if device is None else device, **kwargs)
    return run


sol_from_kepler_dataset = _on_default_device(_examples.sol_from_kepler_dataset)
sun_earth_moon = _on_default_device(_examples.sun_earth_moon)
three_body_equilateral = _on_default_device(_examples.three_body_equilateral)
two_body_problem = _on_default_device(_examples.two_body_problem)
