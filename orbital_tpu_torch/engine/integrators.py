"""Leapfrog KDK stepper.

The step -- half-kick, drift, force re-evaluation, half-kick -- is a
function ``NBodyState -> NBodyState`` built once per :class:`SimConfig`.
It runs eagerly on the state's device and never reads a value back to the
host, so a loop of steps queues work without synchronizing.

Under the ds32 precision policy, position/velocity accumulation uses
compensated double-single arithmetic (see ``dsfloat``): the *increments*
(a*dt, v*dt) are plain f32, the *accumulators* carry a correction term.

Only ``integrator="kdk"`` with ``collisions="none"`` is ported; the other
integrators and the collision modes raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.config import SimConfig
from .dsfloat import ds_add
from .state import NBodyState

__all__ = ["make_step_fn", "ForceFn"]

# (pos, mass, alive) -> (acc, potential)
ForceFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]

# ROADMAP.md queue A items that port what this slice leaves out
_NOT_PORTED = {
    "euler": "A.4", "rk4": "A.4", "yoshida4": "A.4",
    "hermite": "A.8", "respa": "A.14",
}


def _accumulate(hi, lo: Optional[torch.Tensor], *increments):
    """hi(+lo) += sum(increments), compensated when lo is present."""
    if lo is None:
        for inc in increments:
            hi = hi + inc
        return hi, None
    for inc in increments:
        hi, lo = ds_add(hi, lo, inc)
    return hi, lo


def make_step_fn(cfg: SimConfig, force_fn: ForceFn) -> Callable[[NBodyState], NBodyState]:
    """Build the single-step function for a config.

    KDK (velocity-Verlet) order matches the reference: the cached
    ``state.acc`` is a(t), the closing force evaluation is cached for the
    next step.
    """
    if cfg.integrator != "kdk":
        raise NotImplementedError(
            f"integrator={cfg.integrator!r} is not ported to orbital_tpu_torch "
            f"yet (ROADMAP.md queue A item {_NOT_PORTED[cfg.integrator]}); "
            "only 'kdk' is")
    if cfg.collisions != "none":
        raise NotImplementedError(
            f"collisions={cfg.collisions!r} is not ported to orbital_tpu_torch "
            "yet (ROADMAP.md queue A item A.7); only 'none' is")
    dt = cfg.dt

    def kdk(state: NBodyState) -> NBodyState:
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, 0.5 * dt * state.acc)
        if vel_lo is None:
            pos, pos_lo = _accumulate(state.pos, state.pos_lo, dt * vel)
        else:
            pos, pos_lo = _accumulate(state.pos, state.pos_lo, dt * vel, dt * vel_lo)
        acc, potential = force_fn(pos, state.mass, state.alive)
        vel, vel_lo = _accumulate(vel, vel_lo, 0.5 * dt * acc)
        return state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=acc, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )

    return kdk
