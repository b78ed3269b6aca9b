"""Checkpoint / resume for device state.

The full SoA state (the ds32 compensation tensors, the Hermite jerk, the
clock and the step counter included) goes to one ``.npz`` through one
device -> host copy, and :func:`load_state` restores it exactly on the
device it is given. The archive holds the same arrays under the same names
as the JAX package's (``orbital_tpu/engine/checkpoint.py``), with the
metadata as JSON bytes under ``_meta``, so a file written by either package
loads in the other. The JAX package's other form, an orbax checkpoint
directory, has no counterpart here: a path without the ``.npz`` suffix
raises ``ValueError``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .state import NBodyState, state_from_arrays

__all__ = ["save_state", "load_state"]

_ARRAY_FIELDS = ["pos", "vel", "mass", "radius", "alive", "acc",
                 "potential", "time", "step", "pos_lo", "vel_lo", "jerk"]


def _npz_path(path: str | Path) -> Path:
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"checkpoint path {str(path)!r} must end in .npz (the orbax "
                         "directory form is the JAX package's)")
    return path


def save_state(state: NBodyState, path: str | Path, meta: Optional[dict] = None) -> None:
    """Write the state (and optional JSON-serializable metadata) to the
    ``.npz`` archive ``path``."""
    path = _npz_path(path)
    arrays = {}
    for f in _ARRAY_FIELDS:
        v = getattr(state, f)
        if v is not None:
            arrays[f] = v.detach().cpu().numpy()
    if meta:
        arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_state(path: str | Path, device: torch.device | str = "cuda"
               ) -> tuple[NBodyState, dict]:
    """Restore a state written by :func:`save_state` (or by the JAX
    package's) onto ``device``. Returns (state, meta)."""
    path = _npz_path(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode()) if "_meta" in data else {}
        fields = {f: data[f] for f in _ARRAY_FIELDS if f in data}
    return state_from_arrays(fields, device), meta
