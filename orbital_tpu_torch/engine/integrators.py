"""Steppers: leapfrog KDK, semi-implicit Euler, RK4, Yoshida-4 and the
4th-order Hermite family (fixed dt, adaptive dt, block timesteps with one or
several rungs), with bounce collisions.

Each step is a function ``NBodyState -> NBodyState`` built once per
:class:`SimConfig`. It runs eagerly on the state's device. All steppers but
the block-timestep ones never read a value back to the host, so a loop of
steps queues work without synchronizing (adaptive Hermite keeps its dt as a
0-dim tensor on the device). The block steppers read one integer per macro
step, the substep count (:func:`block_plan`): eager PyTorch cannot loop a
device-held number of times, where the JAX stepper runs
``lax.cond(any_fast, fori_loop(0, m, ...))``.

Under the ds32 precision policy, position/velocity accumulation uses
compensated double-single arithmetic (see ``dsfloat``): the *increments*
(a*dt, v*dt) are plain f32, the *accumulators* carry a correction term.

Collisions: ``"bounce"``, ``"merge"`` and ``"resolve"`` run after the
step's closing force evaluation. When the force sweep also counted contacts
(``force_detect_fn``), their result is kept only where that count is > 0,
selected on the device with ``torch.where``: a contact-free step leaves the
state bit-for-bit as it was, as the JAX stepper's ``lax.cond`` does, and the
host never reads the count. On CUDA the bounce kernel, the merge root search
and resolve's contact mark read the same count and skip their pair work.
On f64 state the merge root search and the contact mark run the contact
sweep's f64 instance, the bounce kernel computes in f32 inside (the dense
f64 sweep at N <= 4096), as the JAX package routes them.
Hermite's force evaluation is at the *predicted* positions, so its gate
tests predicted separations; the sweep itself runs on the corrected state.
RESPA has no single-step function (nor has the JAX package):
``engine.multirate.respa_rollout`` runs it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import collisions as coll
from ..utils.config import SimConfig
from .dsfloat import ds_add
from .state import NBodyState

__all__ = ["make_step_fn", "resolve_bounce_fn", "resolve_roots_fn", "resolve_marks_fn",
           "block_plan", "ForceFn", "ForceDetectFn", "AccelJerkFn", "AccelJerkDetectFn",
           "AccelJerkSubsetFn"]

# (pos, mass, alive) -> (acc, potential)
ForceFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]
# (pos, mass, radius, alive) -> (acc, potential, contacts)
ForceDetectFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                         tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
# (pos, vel, mass, alive) -> (acc, jerk, potential)
AccelJerkFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                       tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
# (pos, vel, mass, radius, alive) -> (acc, jerk, potential, contacts)
AccelJerkDetectFn = Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                        torch.Tensor]]
# (idx [F], pos, vel, mass, alive) -> (acc [F, 3], jerk [F, 3])
AccelJerkSubsetFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]

# above this body count the dense [N, N] bounce sweep, root search and
# resolve round on CPU tensors give way to the blocked ones and the contact
# subset (CUDA tensors take the kernels and the subset at every N)
_DENSE_BOUNCE_MAX_N = 4096
# the merge root search's column block on CPU tensors above it, the JAX
# stepper's (and resolve's row block, JAX's default)
_MERGE_CHUNK = 1024


def _accumulate(hi, lo: Optional[torch.Tensor], *increments):
    """hi(+lo) += sum(increments), compensated when lo is present."""
    if lo is None:
        for inc in increments:
            hi = hi + inc
        return hi, None
    for inc in increments:
        hi, lo = ds_add(hi, lo, inc)
    return hi, lo


def resolve_bounce_fn(n: int, device: torch.device | str,
                      dtype: torch.dtype = torch.float32):
    """The bounce sweep for a body count, device and dtype:
    ``fn(pos, vel, mass, radius, alive, restitution, contacts) -> (dpos, dvel)``.
    CUDA tensors take the kernel at every N, so that the device-held count
    can skip it, except f64 state at N <= 4096, which takes the dense f64
    sweep as the JAX stepper does (``orbital_tpu/engine/integrators.py:
    96-107``; above 4,096 the kernel computes in f32 inside, as JAX's B6).
    CPU tensors take the dense sweep at N <= 4096 and the row-blocked one
    above."""
    if torch.device(device).type == "cuda" and (dtype != torch.float64
                                                or n > _DENSE_BOUNCE_MAX_N):
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


def resolve_roots_fn(n: int, device: torch.device | str):
    """The merge root search for a body count and device:
    ``fn(pos, radius, alive, contacts) -> root``, the identity where a given
    ``contacts`` count is 0. CUDA tensors take the kernel at every N, so
    that the device-held count can skip it; CPU tensors take the dense
    search at N <= 4096 and the column-blocked one above, as the JAX stepper
    does. On f64 state the kernel's f64 instance runs, as JAX's XLA search
    runs in the state's dtype."""
    if torch.device(device).type == "cuda":
        from ..ops import cuda_collisions

        return lambda pos, radius, alive, contacts: cuda_collisions.collision_roots_cuda(
            pos, radius, alive, contacts=contacts)

    def roots(pos, radius, alive, contacts):
        root = (coll.collision_roots(pos, radius, alive) if n <= _DENSE_BOUNCE_MAX_N else
                coll.collision_roots_chunked(pos, radius, alive, chunk=min(_MERGE_CHUNK, n)))
        if contacts is None:
            return root
        return torch.where(contacts > 0, root, torch.arange(n, device=pos.device))
    return roots


def resolve_marks_fn(n: int, device: torch.device | str):
    """Resolve's contact mark for a body count and device:
    ``fn(pos, radius, alive, contacts) -> touch_any``. CUDA tensors take the
    kernel (gated on a given count: no marks at 0; its f64 instance on f64
    state); CPU tensors the row blocks of the JAX stepper's subset path."""
    if torch.device(device).type == "cuda":
        from ..ops import cuda_collisions

        return lambda pos, radius, alive, contacts: cuda_collisions.contact_marks_cuda(
            pos, radius, alive, contacts=contacts)
    return lambda pos, radius, alive, contacts: coll.contact_marks_chunked(
        pos, radius, alive, chunk=_MERGE_CHUNK)


def _resolve(cfg: SimConfig, state: NBodyState, contacts: Optional[torch.Tensor]):
    """One resolve round on the collapsed hi + lo state: (pos, vel, mass,
    radius, alive). Dense at N <= 4096 on CPU tensors, as the JAX stepper;
    the contact subset above it and on CUDA tensors at every N, its mark
    from :func:`resolve_marks_fn`. The draws come from (frag_seed, the
    state's step) on the device (``ops.collisions.resolve_draws``)."""
    n = state.n_bodies
    kw = dict(restitution=cfg.restitution, debris_k=cfg.debris_k,
              debris_max_pairs=cfg.debris_max_pairs,
              debris_energy_frac=cfg.debris_energy_frac, debris_sep=cfg.debris_sep)
    dense = state.device.type != "cuda" and n <= _DENSE_BOUNCE_MAX_N
    T, B = coll.resolve_sizes(n, None if dense else cfg.resolve_subset, cfg.debris_k,
                              cfg.debris_max_pairs)
    u, d = coll.resolve_draws(cfg.frag_seed, state.step, T, B, cfg.debris_k,
                              dtype=state.dtype, device=state.device)
    fields = (state.pos_full(), state.vel_full(), state.mass, state.radius, state.alive)
    if dense:
        return coll.resolve_outcomes(*fields, u, d, **kw)
    touch = resolve_marks_fn(n, state.device)(fields[0], state.radius, state.alive, contacts)
    return coll.resolve_outcomes_subset(*fields, u, d, subset=cfg.resolve_subset,
                                        touch_any=touch, **kw)[:5]


def _apply_collisions(cfg: SimConfig, state: NBodyState,
                      contacts: Optional[torch.Tensor] = None,
                      bounce: Optional[Callable] = None) -> NBodyState:
    """The bounce sweep on the hi words of the state, its deltas added with
    :func:`_accumulate`; or the merge of every contact chain into its root,
    or a resolve round (pos, vel, mass, radius and alive rewritten from the
    collapsed hi + lo words, the lo words of every body dropped, as the JAX
    stepper drops them); with a fused ``contacts`` count, gated on the device
    by ``contacts > 0``. ``bounce`` replaces :func:`resolve_bounce_fn`'s
    sweep (the mesh's ring passes its own)."""
    if cfg.collisions == "none":
        return state
    # at a count of 0 the merge's roots are the identity and its mass,
    # radius and alive come back unchanged: only these fields need the gate;
    # resolve's need it all (JAX's lax.cond keeps every field at 0)
    gated = ("pos", "pos_lo", "vel", "vel_lo")
    if cfg.collisions == "resolve":
        pos, vel, mass, radius, alive = _resolve(cfg, state, contacts)
        zeros = None if state.pos_lo is None else torch.zeros_like(state.pos_lo)
        new = dict(pos=pos, vel=vel, mass=mass, radius=radius, alive=alive,
                   pos_lo=zeros, vel_lo=zeros)
        gated = tuple(new)
    elif cfg.collisions == "merge":
        pos = state.pos_full()
        root = resolve_roots_fn(state.n_bodies, state.device)(pos, state.radius,
                                                               state.alive, contacts)
        pos, vel, mass, radius, alive = coll.merge_groups(
            pos, state.vel_full(), state.mass, state.radius, state.alive, root=root)
        zeros = None if state.pos_lo is None else torch.zeros_like(state.pos_lo)
        new = dict(pos=pos, vel=vel, mass=mass, radius=radius, alive=alive,
                   pos_lo=zeros, vel_lo=zeros)
    else:
        bounce = bounce or resolve_bounce_fn(state.n_bodies, state.device, state.dtype)
        dpos, dvel = bounce(state.pos, state.vel, state.mass, state.radius, state.alive,
                            cfg.restitution, contacts)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dpos)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dvel)
        new = dict(pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo)
    if contacts is not None:
        hit = contacts > 0
        new.update({k: None if new[k] is None else torch.where(hit, new[k], getattr(state, k))
                    for k in gated})
    return state.replace(**new)


def _aarseth_dt(acc, jerk, alive, eta: float) -> torch.Tensor:
    """Per-body Aarseth step eta * sqrt(|a| / |jerk|), inf for dead bodies."""
    a_mag = torch.linalg.vector_norm(acc, dim=-1)
    j_mag = torch.linalg.vector_norm(jerk, dim=-1) + 1e-30
    return torch.where(alive, eta * torch.sqrt(a_mag / j_mag), math.inf)


def block_plan(state: NBodyState, cfg: SimConfig) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The block-timestep selection of a macro step (``hermite_fast_cap``):
    ``(idx_f, fast, m)``.

    ``idx_f`` [F] holds the F = min(hermite_fast_cap, N) bodies of smallest
    Aarseth dt_i, fastest first (a stable sort, as ``jnp.argsort``);
    ``fast`` [F] marks those with dt_i < dt; ``m`` is the number of substeps
    (fine steps), ceil(dt / clip(min fast dt_i, dt_min, dt)) clipped to
    ``hermite_max_substeps``, rounded up to a power of two when
    ``hermite_rungs > 1``, and 0 when no body is fast. ``m`` is the block
    steppers' one host read per macro step; the rest stays on the device.
    """
    dt = cfg.dt
    F = min(cfg.hermite_fast_cap, state.n_bodies)
    dt_i = _aarseth_dt(state.acc, state.jerk, state.alive, cfg.adaptive_eta)
    idx_f = torch.argsort(dt_i, stable=True)[:F]
    dt_f = dt_i[idx_f]
    fast = dt_f < dt
    any_fast = torch.any(fast)
    dt_f_min = torch.min(torch.where(fast, dt_f, math.inf))
    # clip in float before the int cast, as the JAX stepper does: a tiny
    # dt_min can push ceil(dt / dt_min) past 2^31
    need = torch.where(any_fast, torch.ceil(dt / torch.clip(dt_f_min, cfg.dt_min, dt)),
                       1.0)
    if cfg.hermite_rungs > 1:
        log2_ms = int(np.log2(cfg.hermite_max_substeps))
        e = torch.clip(torch.ceil(torch.log2(torch.clamp(need, min=1.0))), 0.0,
                       float(log2_ms)).to(torch.int32)
        m = torch.bitwise_left_shift(torch.ones_like(e), e)
    else:
        m = torch.clip(need, 1.0, float(cfg.hermite_max_substeps)).to(torch.int32)
    return idx_f, fast, int(torch.where(any_fast, m, 0))


def make_step_fn(cfg: SimConfig, force_fn: Optional[ForceFn] = None,
                 force_detect_fn: Optional[ForceDetectFn] = None, *,
                 accel_jerk_fn: Optional[AccelJerkFn] = None,
                 accel_jerk_detect_fn: Optional[AccelJerkDetectFn] = None,
                 accel_jerk_subset_fn: Optional[AccelJerkSubsetFn] = None,
                 collide: Optional[Callable[[NBodyState, Optional[torch.Tensor]],
                                            NBodyState]] = None,
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

    Hermite uses ``accel_jerk_fn(pos, vel, mass, alive) -> (acc, jerk, U)``
    (default: the dense plain path), ``accel_jerk_detect_fn(pos, vel, mass,
    radius, alive) -> (acc, jerk, U, contacts)`` for the gate when
    collisions are on, and ``accel_jerk_subset_fn(idx, pos, vel, mass,
    alive) -> (acc, jerk)`` for the block steppers' substeps (default:
    ``ops.forces.accel_jerk_subset``); ``rollout.resolve_accel_jerk*_fn``
    route them.

    ``collide(state, contacts) -> state`` replaces the collision step
    (default: :func:`_apply_collisions`); the sharded steps of
    ``parallel.sharded`` pass theirs.
    """
    if cfg.integrator == "respa":
        raise ValueError("integrator='respa' advances by macro windows of respa_k "
                         "substeps: use engine.multirate.respa_rollout")
    dt = cfg.dt
    fuse_detect = force_detect_fn is not None and cfg.collisions != "none"
    if collide is None:
        def collide(state, contacts):
            return _apply_collisions(cfg, state, contacts)

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
        return collide(state, contacts)

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
        return collide(s, contacts)

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
        return collide(state, contacts)

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
        return collide(state, contacts)

    if accel_jerk_fn is None:
        from ..ops.forces import accel_jerk_dense

        def accel_jerk_fn(pos, vel, mass, alive):
            return accel_jerk_dense(pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2)
    if accel_jerk_subset_fn is None:
        from ..ops.forces import accel_jerk_subset

        def accel_jerk_subset_fn(idx, pos, vel, mass, alive):
            chunk = cfg.chunk if pos.shape[0] > _DENSE_BOUNCE_MAX_N else 0
            return accel_jerk_subset(idx, pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2,
                                     chunk=chunk)
    detect_jerk = accel_jerk_detect_fn is not None and cfg.collisions != "none"

    def jerk_forces(rp, vp, state):
        """(acc, jerk, potential, contacts or None) at predicted positions."""
        if detect_jerk:
            return accel_jerk_detect_fn(rp, vp, state.mass, state.radius, state.alive)
        return (*accel_jerk_fn(rp, vp, state.mass, state.alive), None)

    def hermite(state: NBodyState) -> NBodyState:
        """4th-order Hermite predictor-corrector (Makino & Aarseth 1992): one
        acc + jerk evaluation per step, at the predicted state, with the
        cached (acc, jerk) as the step's initial derivatives.

        With ``cfg.adaptive_eta`` the step is clip(eta * min sqrt(|a|/|j|),
        dt_min, cfg.dt), a 0-dim tensor on the device that ``time``
        accumulates: nothing is read back to the host."""
        r0, v0, a0, j0 = state.pos_full(), state.vel_full(), state.acc, state.jerk
        if cfg.adaptive_eta is not None:
            a_mag = torch.linalg.vector_norm(a0, dim=-1)
            j_mag = torch.linalg.vector_norm(j0, dim=-1) + 1e-30
            ratio = torch.where(state.alive, a_mag / j_mag, math.inf)
            h = torch.clip(cfg.adaptive_eta * torch.sqrt(torch.min(ratio)), cfg.dt_min, dt)
        else:
            h = dt
        h2 = h * h
        rp = r0 + h * v0 + (0.5 * h2) * a0 + (h2 * h / 6.0) * j0
        vp = v0 + h * a0 + (0.5 * h2) * j0
        a1, j1, potential, contacts = jerk_forces(rp, vp, state)
        dv = (0.5 * h) * (a0 + a1) + (h2 / 12.0) * (j0 - j1)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dv)
        v1 = vel if vel_lo is None else vel + vel_lo
        dr = (0.5 * h) * (v0 + v1) + (h2 / 12.0) * (a0 - a1)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dr)
        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=a1, jerk=j1, potential=potential,
            time=state.time + h, step=state.step + 1,
        )
        return collide(state, contacts)

    def macro_close(state, r0, v0, a0, j0, idx, upd, rf, vf) -> NBodyState:
        """The block steppers' closing full-system Hermite step at t + dt,
        with the substepped rows' final positions as sources and as results.
        Under ds32 those rows drop their lo words (their motion is
        substep-dominated; the others keep full compensation)."""
        rp = r0 + dt * v0 + (0.5 * dt * dt) * a0 + (dt ** 3 / 6.0) * j0
        vp = v0 + dt * a0 + (0.5 * dt * dt) * j0
        rp = rp.index_copy(0, idx, torch.where(upd, rf, rp[idx]))
        vp = vp.index_copy(0, idx, torch.where(upd, vf, vp[idx]))
        a1, j1, potential, contacts = jerk_forces(rp, vp, state)
        dv = (0.5 * dt) * (a0 + a1) + (dt * dt / 12.0) * (j0 - j1)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dv)
        v1 = vel if vel_lo is None else vel + vel_lo
        dr = (0.5 * dt) * (v0 + v1) + (dt * dt / 12.0) * (a0 - a1)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dr)
        pos = pos.index_copy(0, idx, torch.where(upd, rf.to(pos.dtype), pos[idx]))
        vel = vel.index_copy(0, idx, torch.where(upd, vf.to(vel.dtype), vel[idx]))
        if pos_lo is not None:
            z = torch.zeros_like(pos_lo[idx])
            pos_lo = pos_lo.index_copy(0, idx, torch.where(upd, z, pos_lo[idx]))
            vel_lo = vel_lo.index_copy(0, idx, torch.where(upd, z, vel_lo[idx]))
        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=a1, jerk=j1, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return collide(state, contacts)

    def hermite_block(state: NBodyState) -> NBodyState:
        """Block-timestep Hermite (individual timesteps in static shapes):
        the F fastest bodies by the Aarseth criterion (F = hermite_fast_cap)
        substep at dt/m against the other bodies' macro predictions, then
        one full-system Hermite step closes the macro step. Cost per macro
        step: N^2 + m F N instead of the m N^2 of a globally shrunk dt.

        Reads m once from the device (:func:`block_plan`) and loops m times
        on the host. Scalar coefficients are rounded in the state's float
        type, as the JAX stepper's traced ``h`` is. Collisions are detected
        at the macro boundary only."""
        r0, v0, a0, j0 = state.pos_full(), state.vel_full(), state.acc, state.jerk
        idx_f, fast, m = block_plan(state, cfg)
        upd = fast[:, None]
        rf, vf = r0[idx_f], v0[idx_f]
        af, jf = a0[idx_f].to(r0.dtype), j0[idx_f].to(r0.dtype)
        if m:
            S = np.float32 if r0.dtype == torch.float32 else np.float64
            h = S(dt) / S(m)
            c2, c3 = S(0.5) * h * h, h * h * h / S(6.0)
            k1, k2 = S(0.5) * h, h * h / S(12.0)
            for k in range(m):
                tau = S(k + 1) * h
                t2, t3 = S(0.5) * tau * tau, tau * tau * tau / S(6.0)
                # predict the fast rows by h, every source by its macro
                # polynomial; fast rows ride their own substepped trajectory
                rp = rf + float(h) * vf + float(c2) * af + float(c3) * jf
                vp = vf + float(h) * af + float(c2) * jf
                rs = r0 + float(tau) * v0 + float(t2) * a0 + float(t3) * j0
                vs = v0 + float(tau) * a0 + float(t2) * j0
                rs = rs.index_copy(0, idx_f, torch.where(upd, rp, rs[idx_f]))
                vs = vs.index_copy(0, idx_f, torch.where(upd, vp, vs[idx_f]))
                a1, j1 = accel_jerk_subset_fn(idx_f, rs, vs, state.mass, state.alive)
                a1, j1 = a1.to(r0.dtype), j1.to(r0.dtype)
                dv = float(k1) * (af + a1) + float(k2) * (jf - j1)
                v1 = vf + dv
                dr = float(k1) * (vf + v1) + float(k2) * (af - a1)
                rf, vf, af, jf = (torch.where(upd, rf + dr, rf), torch.where(upd, v1, vf),
                                  torch.where(upd, a1, af), torch.where(upd, j1, jf))
        return macro_close(state, r0, v0, a0, j0, idx_f, upd, rf, vf)

    def hermite_block_rungs(state: NBodyState) -> NBodyState:
        """Multi-rung block-timestep Hermite (``cfg.hermite_rungs`` = L):
        each fast body gets a power-of-two substep period by its position in
        the dt-sorted list (the fastest F >> (L-1) every fine step, the next
        quota every 2nd, ..., the last every 2^(L-1)-th), so the active rows
        at fine step s are always a prefix and one subset evaluation of that
        prefix serves them. m is rounded up to a power of two; a row whose
        period exceeds m closes with the macro step instead.

        With ``cfg.hermite_reselect``, at every coarsest-rung boundary (all
        riding rows freshly corrected at the same time) the riding prefix is
        re-sorted by its current Aarseth dt (a stable sort; non-riding rows
        keep their place at the tail) and the position-keyed rungs re-apply.
        Reads m once from the device; the rung level of each fine step is a
        host integer."""
        F = min(cfg.hermite_fast_cap, state.n_bodies)
        L = cfg.hermite_rungs
        r0, v0, a0, j0 = state.pos_full(), state.vel_full(), state.acc, state.jerk
        idx, fast, m = block_plan(state, cfg)

        # rung per sorted position (quota halving) and the prefix sizes
        pos_p = np.arange(F)
        rung = np.zeros(F, np.int32)
        for r in range(1, L):
            rung += (pos_p >= (F >> (L - r))).astype(np.int32)
        period = torch.as_tensor(1 << rung, device=r0.device)
        T = [max(1, F >> (L - 1 - r)) for r in range(L)]
        T[-1] = F

        ride = fast & (period <= m)
        rl, vl = r0[idx], v0[idx]
        al, jl = a0[idx].to(r0.dtype), j0[idx].to(r0.dtype)
        tl = torch.zeros((F,), dtype=r0.dtype, device=r0.device)
        per_f = period.to(r0.dtype)
        if m:
            S = np.float32 if r0.dtype == torch.float32 else np.float64
            h = S(dt) / S(m)
            rd = ride[:, None]
            for s in range(1, m + 1):
                tau = S(s) * h
                t2, t3 = S(0.5) * tau * tau, tau * tau * tau / S(6.0)
                # coarsest active rung at fine step s (finer ones included)
                level = sum(1 for r in range(1, L) if s % (1 << r) == 0)
                Tr = T[level]
                # sources at tau: macro polynomials, with the riding rows on
                # their own carried polynomials
                rs = r0 + float(tau) * v0 + float(t2) * a0 + float(t3) * j0
                vs = v0 + float(tau) * a0 + float(t2) * j0
                dlt = (float(tau) - tl)[:, None]
                rpf = rl + dlt * vl + (0.5 * dlt * dlt) * al + (dlt * dlt * dlt / 6.0) * jl
                vpf = vl + dlt * al + (0.5 * dlt * dlt) * jl
                rs = rs.index_copy(0, idx, torch.where(rd, rpf, rs[idx]))
                vs = vs.index_copy(0, idx, torch.where(rd, vpf, vs[idx]))
                a1, j1 = accel_jerk_subset_fn(idx[:Tr], rs, vs, state.mass, state.alive)
                a1, j1 = a1.to(r0.dtype), j1.to(r0.dtype)
                act = ride[:Tr] & ((s % period[:Tr]) == 0)
                he = (per_f[:Tr] * float(h))[:, None]
                dv = (0.5 * he) * (al[:Tr] + a1) + (he * he / 12.0) * (jl[:Tr] - j1)
                v1 = vl[:Tr] + dv
                dr = (0.5 * he) * (vl[:Tr] + v1) + (he * he / 12.0) * (al[:Tr] - a1)
                am = act[:, None]
                rl = torch.cat([torch.where(am, rl[:Tr] + dr, rl[:Tr]), rl[Tr:]])
                vl = torch.cat([torch.where(am, v1, vl[:Tr]), vl[Tr:]])
                al = torch.cat([torch.where(am, a1, al[:Tr]), al[Tr:]])
                jl = torch.cat([torch.where(am, j1, jl[:Tr]), jl[Tr:]])
                tl = torch.cat([torch.where(act, float(tau), tl[:Tr]), tl[Tr:]])
                if cfg.hermite_reselect and level == L - 1:
                    # every riding row was just corrected at tau, so the
                    # carry permutes exactly
                    dt_new = cfg.adaptive_eta * torch.sqrt(
                        torch.linalg.vector_norm(al, dim=-1)
                        / (torch.linalg.vector_norm(jl, dim=-1) + 1e-30))
                    perm = torch.argsort(torch.where(ride, dt_new, math.inf), stable=True)
                    idx, rl, vl, al, jl, tl = (x[perm] for x in (idx, rl, vl, al, jl, tl))
        return macro_close(state, r0, v0, a0, j0, idx, ride[:, None], rl, vl)

    if cfg.integrator == "hermite" and cfg.hermite_fast_cap > 0:
        return hermite_block_rungs if cfg.hermite_rungs > 1 else hermite_block
    return {"kdk": kdk, "euler": euler, "rk4": rk4, "hermite": hermite,
            "yoshida4": yoshida4}[cfg.integrator]
