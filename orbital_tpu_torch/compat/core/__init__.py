"""Drop-in compatibility package: the reference's ``core.*`` import layout
backed by the PyTorch port.

With ``orbital_tpu_torch/compat`` on ``sys.path`` (ahead of the repository's
own ``core``, which serves the same layout from the JAX package), user code
written against ``trevormcguire/orbital-physics`` (``from core.engine import
SimulationEngine`` etc.) runs unchanged on the port. Engines and examples run
on the card; a caller that wants the CPU says so once, before the user code,
with ``core.use_device("cpu")``. There is no silent fallback: on a machine
without CUDA an engine raises until the caller asks for the CPU. New code
should import ``orbital_tpu_torch`` directly and pass ``device=`` itself.
"""
from __future__ import annotations

import torch

from orbital_tpu_torch.engine.engine import engine_device

__all__ = ["use_device", "default_device"]

# the process-wide choice of use_device(), as the reference layout has no
# device argument to carry it (the JAX layout's counterpart is JAX's own
# platform setting)
_DEVICE = {"device": "cuda"}


def use_device(device: torch.device | str) -> None:
    """Run every engine and example built through ``core.*`` on ``device``
    (``"cuda"`` by default). Raises if it names CUDA and CUDA is not
    available."""
    _DEVICE["device"] = str(engine_device(device))


def default_device() -> str:
    """The device that :func:`use_device` chose."""
    return _DEVICE["device"]
