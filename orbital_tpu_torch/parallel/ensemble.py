"""Monte-Carlo ensembles: E perturbed copies of a system rolled out together.

The JAX package runs an ensemble as one ``jax.vmap`` of its rollout over a
leading member axis (BASELINE config 5: 1,024 perturbed solar systems). Here
the member axis is written out on every field of the state ([E, N, 3],
[E, N], potential, time and step [E]), and :func:`ensemble_rollout` takes
one of three routes, chosen by configuration (:func:`ensemble_route`) and
never by failure:

  * ``"kernel"``: CUDA tensors of a KDK, collision-free, softened
    (eps2 > 0) exact-force configuration ("auto", "dense" or "pallas") in f32
    or ds32 with N <= ENSEMBLE_MAX_N. Every member's steps run inside
    ``ops.fused_ensemble``'s CUDA kernel: one launch for an unrecorded
    rollout, one for each ``record_every`` block of a recorded one.
  * ``"plain"``: the same configurations on CPU tensors, in any precision
    (f64 included): the kernel's plain version, the batch written out.
  * ``"members"``: everything else (collisions, the tree and mesh solvers,
    Hermite, RESPA, eps2 = 0, larger N): each member goes through the port's
    own ``rollout`` and the results are stacked. Correct and slow;
    ``member_loop.runs`` counts its uses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..engine.rollout import Trajectory, _snapshot, init_forces, rollout
from ..engine.state import NBodyState
from ..ops.fused_ensemble import ENSEMBLE_MAX_N, fused_ensemble
from ..utils.config import SimConfig

__all__ = ["make_ensemble", "ensemble_rollout", "energy_drift", "ensemble_route",
           "member_loop"]

# the force policies whose KDK force is the dense pair formula at N <=
# ENSEMBLE_MAX_N (the batched routes' formula)
_BATCHED_IMPLS = ("auto", "dense", "pallas")


def _member(states: NBodyState, e: int) -> NBodyState:
    """Member ``e`` of a batched state, as an unbatched one."""
    return NBodyState(**{f.name: None if getattr(states, f.name) is None
                         else getattr(states, f.name)[e]
                         for f in dataclasses.fields(NBodyState)})


def _stack(members: list[NBodyState]) -> NBodyState:
    """Unbatched states stacked along a new leading member axis."""
    return NBodyState(**{f.name: None if getattr(members[0], f.name) is None
                         else torch.stack([getattr(s, f.name) for s in members])
                         for f in dataclasses.fields(NBodyState)})


def make_ensemble(
    state: NBodyState,
    n_ensemble: int,
    generator: Optional[torch.Generator],
    pos_sigma: float = 0.0,
    vel_sigma: float = 0.0,
    perturb: Optional[Callable[[Optional[torch.Generator], NBodyState], NBodyState]] = None,
) -> NBodyState:
    """Tile a base state E times with Gaussian perturbations of the (hi)
    positions and velocities, drawn from ``generator`` on the state's device,
    or with a custom ``perturb(generator, state) -> state`` called once a
    member. Returns a state with leading axis E. Member 0 is always the
    unperturbed base (a control)."""
    e = int(n_ensemble)
    if e < 1:
        raise ValueError(f"n_ensemble must be >= 1, got {n_ensemble}")
    if perturb is not None:
        return _stack([state] + [perturb(generator, state) for _ in range(1, e)])
    shape = (e,) + tuple(state.pos.shape)
    kw = dict(generator=generator, dtype=state.pos.dtype, device=state.device)
    dpos = pos_sigma * torch.randn(shape, **kw)
    dvel = vel_sigma * torch.randn(shape, **kw)
    out = _stack([state] * e)
    pos, vel = state.pos + dpos, state.vel + dvel
    pos[0], vel[0] = state.pos, state.vel  # member 0 stays unperturbed
    return out.replace(pos=pos, vel=vel)


def ensemble_route(cfg: SimConfig, n: int, device: torch.device | str,
                   dtype: torch.dtype) -> str:
    """The route :func:`ensemble_rollout` takes for a config, body count,
    device and state dtype: ``"kernel"``, ``"plain"`` or ``"members"`` (see
    the module's docstring)."""
    device = torch.device(device)
    batched = (cfg.integrator == "kdk" and cfg.collisions == "none" and cfg.eps2 > 0.0
               and cfg.force_impl in _BATCHED_IMPLS and n <= ENSEMBLE_MAX_N)
    if batched and device.type == "cuda" and dtype == torch.float32:
        return "kernel"
    if batched and device.type == "cpu":
        return "plain"
    return "members"


def member_loop(states: NBodyState, cfg: SimConfig, steps: int, record_every: int = 0
                ) -> tuple[NBodyState, Optional[Trajectory]]:
    """Each member through ``init_forces`` and the port's own ``rollout``,
    the finals and trajectories stacked along the member axis."""
    member_loop.runs += 1
    outs = [rollout(init_forces(_member(states, e), cfg), cfg, steps, record_every)
            for e in range(states.pos.shape[0])]
    finals = _stack([o[0] for o in outs])
    if outs[0][1] is None:
        return finals, None
    return finals, Trajectory(**{f.name: torch.stack([getattr(o[1], f.name) for o in outs])
                                 for f in dataclasses.fields(Trajectory)})


member_loop.runs = 0


def ensemble_rollout(states: NBodyState, cfg: SimConfig, steps: int,
                     record_every: int = 0) -> tuple[NBodyState, Optional[Trajectory]]:
    """Roll every member of a batched state out ``steps`` steps, forces
    re-initialised for each member; returns ``(finals, trajectories)``, the
    trajectory fields [E, R, ...] as the JAX package's vmap gives them (None
    without recording). With recording, ``steps`` must divide into records
    of ``record_every`` steps, and the snapshot after each block is kept."""
    steps, record_every = int(steps), int(record_every)
    if states.pos.ndim != 3:
        raise ValueError("ensemble_rollout takes a batched state ([E, N, 3] positions)")
    route = ensemble_route(cfg, states.n_bodies, states.device, states.dtype)
    if route == "members":
        return member_loop(states, cfg, steps, record_every)
    if record_every <= 0:
        return fused_ensemble(states, cfg, steps), None
    if steps % record_every != 0:
        raise ValueError(f"steps={steps} not divisible by record_every={record_every}")
    records = []
    for _ in range(steps // record_every):
        states = fused_ensemble(states, cfg, record_every)
        records.append(_snapshot(states))
    return states, Trajectory(**{k: torch.stack([r[k] for r in records], dim=1)
                                 for k in records[0]})


def energy_drift(traj: Trajectory) -> np.ndarray:
    """Per-member relative energy drift |E_t - E_0| / |E_0| -> [E], the
    maximum over the recording window (the ensembles' stability metric)."""
    E = np.asarray(traj.energy.detach().cpu().double().numpy()
                   if isinstance(traj.energy, torch.Tensor) else traj.energy, np.float64)
    E0 = E[..., :1]
    return np.max(np.abs(E - E0) / np.abs(E0), axis=-1)
