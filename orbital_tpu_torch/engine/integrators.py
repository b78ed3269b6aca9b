"""Steppers: leapfrog KDK, semi-implicit Euler, RK4 and Yoshida-4, with
bounce collisions.

Each step is a function ``NBodyState -> NBodyState`` built once per
:class:`SimConfig`. It runs eagerly on the state's device and never reads a
value back to the host, so a loop of steps queues work without
synchronizing.

Under the ds32 precision policy, position/velocity accumulation uses
compensated double-single arithmetic (see ``dsfloat``): the *increments*
(a*dt, v*dt) are plain f32, the *accumulators* carry a correction term.

Collisions: ``"bounce"`` runs after the step's closing force evaluation.
When the force sweep also counted contacts (``force_detect_fn``), the
bounce result is kept only where that count is > 0, selected on the device
with ``torch.where``: a contact-free step leaves the state bit-for-bit as
it was, as the JAX stepper's ``lax.cond`` does, and the host never reads the
count. On CUDA the bounce kernel reads the same count and skips its sweep.
Hermite, RESPA and the merge/resolve collision modes raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import collisions as coll
from ..utils.config import SimConfig
from .dsfloat import ds_add
from .state import NBodyState

__all__ = ["make_step_fn", "resolve_bounce_fn", "ForceFn", "ForceDetectFn"]

# (pos, mass, alive) -> (acc, potential)
ForceFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]
# (pos, mass, radius, alive) -> (acc, potential, contacts)
ForceDetectFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                         tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

# ROADMAP.md queue A items that port what is left out
_NOT_PORTED = {"hermite": "A.8", "respa": "A.14", "merge": "A.7b", "resolve": "A.7b"}

# above this body count the dense [N, N] bounce sweep on CPU tensors gives
# way to the row-blocked one (CUDA tensors take the kernel at every N)
_DENSE_BOUNCE_MAX_N = 4096


def _accumulate(hi, lo: Optional[torch.Tensor], *increments):
    """hi(+lo) += sum(increments), compensated when lo is present."""
    if lo is None:
        for inc in increments:
            hi = hi + inc
        return hi, None
    for inc in increments:
        hi, lo = ds_add(hi, lo, inc)
    return hi, lo


def resolve_bounce_fn(n: int, device: torch.device | str):
    """The bounce sweep for a body count and device:
    ``fn(pos, vel, mass, radius, alive, restitution, contacts) -> (dpos, dvel)``.
    CUDA tensors take the kernel at every N, so that the device-held count
    can skip it; CPU tensors take the dense sweep at N <= 4096 and the
    row-blocked one above."""
    if torch.device(device).type == "cuda":
        from ..ops import cuda_collisions

        def kernel(pos, vel, mass, radius, alive, restitution, contacts):
            return cuda_collisions.bounce_deltas_cuda(
                pos, vel, mass, radius, alive, restitution=restitution,
                contacts=contacts)
        return kernel
    if n <= _DENSE_BOUNCE_MAX_N:
        return lambda pos, vel, mass, radius, alive, restitution, contacts: \
            coll.bounce_deltas(pos, vel, mass, radius, alive, restitution=restitution)
    return lambda pos, vel, mass, radius, alive, restitution, contacts: \
        coll.bounce_deltas_chunked(pos, vel, mass, radius, alive, restitution=restitution)


def _apply_collisions(cfg: SimConfig, state: NBodyState,
                      contacts: Optional[torch.Tensor] = None) -> NBodyState:
    """The bounce sweep on the hi words of the state, its deltas added with
    :func:`_accumulate`; with a fused ``contacts`` count, gated on the
    device by ``contacts > 0``."""
    if cfg.collisions == "none":
        return state
    bounce = resolve_bounce_fn(state.n_bodies, state.device)
    dpos, dvel = bounce(state.pos, state.vel, state.mass, state.radius, state.alive,
                        cfg.restitution, contacts)
    pos, pos_lo = _accumulate(state.pos, state.pos_lo, dpos)
    vel, vel_lo = _accumulate(state.vel, state.vel_lo, dvel)
    new = dict(pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo)
    if contacts is not None:
        hit = contacts > 0
        new = {k: None if v is None else torch.where(hit, v, getattr(state, k))
               for k, v in new.items()}
    return state.replace(**new)


def make_step_fn(cfg: SimConfig, force_fn: ForceFn,
                 force_detect_fn: Optional[ForceDetectFn] = None
                 ) -> Callable[[NBodyState], NBodyState]:
    """Build the single-step function for a config.

    ``force_detect_fn(pos, mass, radius, alive) -> (acc, U, contacts)``
    fuses contact detection into the step's closing force evaluation
    (``rollout.resolve_force_detect_fn``); with it, the bounce result is
    gated on ``contacts > 0`` on the device. Without it the bounce sweep
    runs and applies every step. All four steppers evaluate their closing
    forces at the collision-time positions.

    KDK (velocity-Verlet) order matches the reference: the cached
    ``state.acc`` is a(t), the closing force evaluation is cached for the
    next step, collisions run after the second kick and the acceleration
    cache is not refreshed afterwards.
    """
    for value in (cfg.integrator, cfg.collisions):
        if value in _NOT_PORTED:
            raise NotImplementedError(
                f"{value!r} is not ported to orbital_tpu_torch yet "
                f"(ROADMAP.md queue A item {_NOT_PORTED[value]})")
    dt = cfg.dt
    fuse_detect = force_detect_fn is not None and cfg.collisions != "none"

    def closing_forces(pos, state):
        """(acc, potential, contacts or None) at the step's final positions."""
        if fuse_detect:
            return force_detect_fn(pos, state.mass, state.radius, state.alive)
        return (*force_fn(pos, state.mass, state.alive), None)

    def drift(pos, pos_lo, vel, vel_lo, h):
        if vel_lo is None:
            return _accumulate(pos, pos_lo, h * vel)
        return _accumulate(pos, pos_lo, h * vel, h * vel_lo)

    def kdk(state: NBodyState) -> NBodyState:
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, 0.5 * dt * state.acc)
        pos, pos_lo = drift(state.pos, state.pos_lo, vel, vel_lo, dt)
        acc, potential, contacts = closing_forces(pos, state)
        vel, vel_lo = _accumulate(vel, vel_lo, 0.5 * dt * acc)
        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=acc, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    def yoshida4(state: NBodyState) -> NBodyState:
        """4th-order symplectic integrator (Yoshida 1990): the KDK step
        composed three times with weights (w1, w0, w1), w1 = 1/(2-2^(1/3)),
        w0 = 1 - 2 w1 (the middle sub-step runs backwards). Three force
        evaluations per step; detection rides the closing one."""
        s = state
        contacts = None
        w1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
        for i, w in enumerate((w1, 1.0 - 2.0 * w1, w1)):
            h = w * dt
            vel, vel_lo = _accumulate(s.vel, s.vel_lo, 0.5 * h * s.acc)
            pos, pos_lo = drift(s.pos, s.pos_lo, vel, vel_lo, h)
            if i == 2:
                acc, potential, contacts = closing_forces(pos, s)
            else:
                acc, potential = force_fn(pos, s.mass, s.alive)
            vel, vel_lo = _accumulate(vel, vel_lo, 0.5 * h * acc)
            s = s.replace(pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
                          acc=acc, potential=potential)
        s = s.replace(time=state.time + dt, step=state.step + 1)
        return _apply_collisions(cfg, s, contacts)

    def rk4(state: NBodyState) -> NBodyState:
        """Classical RK4: 4 force evaluations per step (the cached
        ``state.acc`` serves as k1's acceleration; the closing evaluation at
        r(t+dt) is cached for the next step and for energy diagnostics)."""
        r0 = state.pos_full()
        v0 = state.vel_full()
        a1 = state.acc
        half = 0.5 * dt

        r2 = r0 + half * v0
        v2 = v0 + half * a1
        a2, _ = force_fn(r2, state.mass, state.alive)

        r3 = r0 + half * v2
        v3 = v0 + half * a2
        a3, _ = force_fn(r3, state.mass, state.alive)

        r4 = r0 + dt * v3
        v4 = v0 + dt * a3
        a4, _ = force_fn(r4, state.mass, state.alive)

        dr = (dt / 6.0) * (v0 + 2.0 * v2 + 2.0 * v3 + v4)
        dv = (dt / 6.0) * (a1 + 2.0 * a2 + 2.0 * a3 + a4)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dr)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dv)

        acc, potential, contacts = closing_forces(pos, state)
        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=acc, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    def euler(state: NBodyState) -> NBodyState:
        # v(t+dt) = v(t) + a(t) dt; r(t+dt) = r(t) + v(t+dt) dt (reference
        # Object.update, core/physics.py:315-332), then refresh forces
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dt * state.acc)
        pos, pos_lo = drift(state.pos, state.pos_lo, vel, vel_lo, dt)
        acc, potential, contacts = closing_forces(pos, state)
        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=acc, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    return {"kdk": kdk, "euler": euler, "rk4": rk4, "yoshida4": yoshida4}[cfg.integrator]
