"""Structure-of-arrays device state for the N-body system.

One frozen dataclass of tensors on one device: positions, velocities,
masses, radii, an alive mask (masks replace list removal on merges), the
cached accelerations of the last force evaluation, and the scalar clock and
step counter as 0-d tensors, so that a rollout never has to read a value
back to the host between steps. An ensemble (``parallel.ensemble``) is the
same dataclass with a leading member axis E on every field, as the JAX
package's vmapped state: [E, N, 3], [E, N], and potential, time and step [E].

Precision policy (see ``dsfloat``):
  * ``f32``  -- plain float32 state.
  * ``ds32`` -- float32 state with compensation tensors ``pos_lo/vel_lo``
               (double-single); all force math stays in f32.
  * ``f64``  -- float64 state: the CPU golden path, and on the card the JAX
               package's routes (the kernels cast it to f32 at entry, the
               XLA-equivalent code and ``force_impl="chunked"`` stay f64).

Scenes are defined in physical units but the state is kept in *internal
units* chosen so positions/velocities are O(1) and G = 1 (``Rescale``).
Every constructor takes its ``device`` explicitly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

__all__ = ["NBodyState", "Rescale", "Precision", "make_state", "pad_count",
           "far_positions", "state_from_arrays"]

Precision = str  # "f32" | "ds32" | "f64"

_VALID_PRECISIONS = ("f32", "ds32", "f64")


@dataclasses.dataclass(frozen=True)
class NBodyState:
    """Immutable SoA simulation state; N is the body axis (the second last of
    pos), and an ensemble adds a leading member axis to every field."""

    pos: torch.Tensor              # [(E,) N, 3] positions (internal units)
    vel: torch.Tensor              # [(E,) N, 3] velocities
    mass: torch.Tensor             # [(E,) N] masses; 0 for padding bodies
    radius: torch.Tensor           # [(E,) N] collision radii
    alive: torch.Tensor            # [(E,) N] bool; False for padding
    acc: torch.Tensor              # [(E,) N, 3] accelerations of last force eval
    potential: torch.Tensor        # [(E,)] softened potential of last force eval
    time: torch.Tensor             # [(E,)] elapsed simulation time
    step: torch.Tensor             # [(E,)] int32 step counter
    pos_lo: Optional[torch.Tensor] = None  # ds32 compensation terms, else None
    vel_lo: Optional[torch.Tensor] = None
    jerk: Optional[torch.Tensor] = None    # [N, 3] da/dt cache (Hermite)

    @property
    def n_bodies(self) -> int:
        return self.pos.shape[-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def is_ds(self) -> bool:
        return self.pos_lo is not None

    def replace(self, **kwargs) -> "NBodyState":
        return dataclasses.replace(self, **kwargs)

    def pos_full(self) -> torch.Tensor:
        """Best-precision positions (hi+lo collapsed for ds32)."""
        return self.pos if self.pos_lo is None else self.pos + self.pos_lo

    def vel_full(self) -> torch.Tensor:
        return self.vel if self.vel_lo is None else self.vel + self.vel_lo


@dataclasses.dataclass(frozen=True)
class Rescale:
    """Exact change of units between scene (physical) and internal state.

    Internal quantities: pos_i = pos_phys / length, vel_i = vel_phys *
    time / length, mass_i = mass_phys / mass, with the time scale chosen so
    G_internal = G_phys * mass * time^2 / length^3 (1.0 when derived via
    :meth:`natural`).
    """

    length: float = 1.0
    mass: float = 1.0
    time: float = 1.0

    @classmethod
    def natural(cls, pos: np.ndarray, mass: np.ndarray, G: float) -> "Rescale":
        """Scales making positions O(1) and G = 1: L0 = RMS radius,
        M0 = total mass, T0 = sqrt(L0^3 / (G M0))."""
        r = np.linalg.norm(np.asarray(pos, dtype=np.float64), axis=-1)
        L0 = float(np.sqrt(np.mean(r**2))) or 1.0
        M0 = float(np.sum(mass)) or 1.0
        T0 = math.sqrt(L0**3 / (G * M0))
        return cls(length=L0, mass=M0, time=T0)

    @classmethod
    def identity(cls) -> "Rescale":
        return cls()

    def g_internal(self, G_phys: float) -> float:
        return G_phys * self.mass * self.time**2 / self.length**3

    @property
    def velocity(self) -> float:
        return self.length / self.time

    @property
    def energy(self) -> float:
        return self.mass * self.velocity**2

    @property
    def angular_momentum(self) -> float:
        return self.mass * self.velocity * self.length


def pad_count(n: int, multiple: int) -> int:
    """Round a body count up to a multiple (padding bodies are dead)."""
    if multiple <= 1:
        return n
    return -(-n // multiple) * multiple


def far_positions(k: int, scale: float, dtype=np.float64, start: int = 0) -> np.ndarray:
    """Spread-out parking positions for dead/padding bodies.

    Far enough that no live body's radius can reach them, and mutually
    non-coincident (index-proportional spacing that stays representable in
    f32). ``scale`` is the live-scene magnitude (max |pos|); ``start`` is
    the global row index of the first parked body."""
    far = 1e8 * (1.0 + abs(scale))
    if np.dtype(dtype) == np.float32:
        far = min(far, 1e17)  # keep far^2 finite in f32
    out = np.full((k, 3), far, dtype=np.float64)
    out[:, 0] *= 1.0 + 1e-3 * (start + np.arange(k))
    return out


def make_state(
    pos: np.ndarray,
    vel: np.ndarray,
    mass: np.ndarray,
    radius: Optional[np.ndarray] = None,
    *,
    device: torch.device | str,
    precision: Precision = "f32",
    rescale: Optional[Rescale] = None,
    pad_to: int = 1,
    spare: int = 0,
    time: float = 0.0,
) -> NBodyState:
    """Build state on ``device`` from host f64 arrays in *physical* units
    (pass ``rescale`` to convert to internal units on the way in).

    ``spare`` allocates that many extra DEAD slots beyond ``pad_to``
    alignment. ``acc``/``potential`` are zero; ``engine.rollout.
    init_forces`` performs the first force evaluation.
    """
    if precision not in _VALID_PRECISIONS:
        raise ValueError(f"precision must be one of {_VALID_PRECISIONS}, got {precision!r}")
    device = torch.device(device)
    rs = rescale if rescale is not None else Rescale.identity()

    pos = np.asarray(pos, dtype=np.float64) / rs.length
    vel = np.asarray(vel, dtype=np.float64) / rs.velocity
    mass = np.asarray(mass, dtype=np.float64) / rs.mass
    n = pos.shape[0]
    radius = (
        np.asarray(radius, dtype=np.float64) / rs.length
        if radius is not None
        else np.zeros(n)
    )

    if spare < 0:
        raise ValueError(f"spare must be >= 0, got {spare}")
    n_pad = pad_count(n + int(spare), pad_to)
    alive = np.zeros(n_pad, dtype=bool)
    alive[:n] = True
    if n_pad != n:
        pad = n_pad - n
        # mass 0 keeps padding force-inert; far parking keeps it out of
        # reach of live radii for contact detection
        scale = float(np.max(np.abs(pos))) if n else 1.0
        dt_pad = np.float32 if precision in ("f32", "ds32") else np.float64
        pos = np.concatenate([pos, far_positions(pad, scale, dt_pad, start=n)])
        vel = np.concatenate([vel, np.zeros((pad, 3))])
        mass = np.concatenate([mass, np.zeros(pad)])
        radius = np.concatenate([radius, np.zeros(pad)])

    np_dt = np.float64 if precision == "f64" else np.float32
    dt_ = torch.float64 if precision == "f64" else torch.float32

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pos_lo = vel_lo = None
    if precision == "ds32":
        pos32 = pos.astype(np.float32)
        vel32 = vel.astype(np.float32)
        pos_lo = dev((pos - pos32).astype(np.float32))
        vel_lo = dev((vel - vel32).astype(np.float32))
        pos_dev, vel_dev = dev(pos32), dev(vel32)
    else:
        pos_dev = dev(pos.astype(np_dt))
        vel_dev = dev(vel.astype(np_dt))

    return NBodyState(
        pos=pos_dev,
        vel=vel_dev,
        mass=dev(mass.astype(np_dt)),
        radius=dev(radius.astype(np_dt)),
        alive=dev(alive),
        acc=torch.zeros((n_pad, 3), dtype=dt_, device=device),
        potential=torch.zeros((), dtype=dt_, device=device),
        time=torch.tensor(time, dtype=dt_, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        pos_lo=pos_lo,
        vel_lo=vel_lo,
    )


def state_from_arrays(fields: dict, device: torch.device | str) -> NBodyState:
    """Carry a state given as numpy arrays (for example every field of an
    ``orbital_tpu`` ``NBodyState`` passed through ``np.asarray``) onto
    ``device`` unchanged, so that two implementations can step the
    identical state. Missing optional fields (``pos_lo``, ``vel_lo``,
    ``jerk``) or ``None`` values stay ``None``. A vmapped ensemble state
    (a leading member axis on every field) carries over as it is."""
    device = torch.device(device)
    names = {f.name for f in dataclasses.fields(NBodyState)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown NBodyState fields: {sorted(unknown)}")
    return NBodyState(**{k: torch.from_numpy(np.array(a)).to(device)
                         for k, a in fields.items() if a is not None})
