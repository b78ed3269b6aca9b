"""One-call convenience API: scene arrays in, trajectory out.

Wraps natural-unit rescaling, the precision policy, force-path selection,
the rollout and the unit conversion back to physical units behind a single
function. Ported so far: the exact-force kdk, euler, rk4, yoshida4 and
Hermite steppers (Hermite with fixed or adaptive dt and block timesteps),
with or without bounce collisions; RESPA, the merge and resolve collision
modes and the approximate force solvers raise ``NotImplementedError``
(ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .engine.rollout import init_forces, rollout
from .engine.state import NBodyState, Rescale, make_state
from .models.constants import STANDARD, UnitProfile
from .models.scene import SceneArrays
from .utils.config import SimConfig

__all__ = ["simulate", "SimResult"]


@dataclasses.dataclass
class SimResult:
    """Physical-unit outputs of :func:`simulate`."""

    pos: np.ndarray        # [R, N, 3] recorded positions (physical units)
    vel: np.ndarray        # [R, N, 3]
    time: np.ndarray       # [R]
    energy: np.ndarray     # [R]
    ang_mom: np.ndarray    # [R, 3]
    names: list[str]
    final_state: NBodyState
    rescale: Rescale
    config: SimConfig

    @property
    def energy_drift(self) -> float:
        """max |E_t - E_0| / |E_0| over the recording."""
        return float(np.max(np.abs(self.energy - self.energy[0])
                            / abs(self.energy[0])))


def simulate(
    scene: SceneArrays,
    *,
    steps: int,
    dt: float,
    device: torch.device | str,
    softening: float = 0.0,
    record_every: Optional[int] = None,
    precision: Optional[str] = None,
    integrator: str = "kdk",
    collisions: str = "none",
    restitution: float = 1.0,
    force_impl: str = "auto",
    adaptive_eta: Optional[float] = None,
    dt_min: float = 0.0,
    hermite_fast_cap: int = 0,
    hermite_max_substeps: int = 64,
    hermite_rungs: int = 1,
    unit_profile: UnitProfile = STANDARD,
    rescale: Optional[Rescale] = None,
) -> SimResult:
    """Simulate a scene on ``device`` and return its recorded trajectory in
    physical units.

    ``precision`` defaults to ``"f64"`` on the CPU (the golden path) and
    ``"ds32"`` on CUDA. ``record_every`` defaults to ~100 evenly spaced
    records. ``softening`` and ``dt`` are in scene units.
    ``collisions="bounce"`` bounces touching spheres (``scene.radius``)
    with coefficient of restitution ``restitution``.
    ``integrator="hermite"`` takes ``adaptive_eta`` (Aarseth steps clipped
    to [dt_min, dt]; ``dt_min`` in scene units) and the block-timestep knobs
    ``hermite_fast_cap``, ``hermite_max_substeps`` and ``hermite_rungs``
    (see :class:`SimConfig`).
    """
    if not isinstance(scene, SceneArrays):
        raise NotImplementedError(
            "simulate() takes SceneArrays in orbital_tpu_torch so far; "
            "compiling a System or ObjectCollection is ROADMAP.md queue A "
            "item A.10")
    device = torch.device(device)
    if precision is None:
        precision = "f64" if device.type == "cpu" else "ds32"
    if rescale is None:
        rescale = (Rescale.identity() if precision == "f64"
                   else Rescale.natural(scene.pos, scene.mass, unit_profile.G))

    if record_every is None:
        record_every = max(1, steps // 100)
        while steps % record_every:
            record_every -= 1

    cfg = SimConfig(
        dt=dt / rescale.time,
        G=rescale.g_internal(unit_profile.G),
        eps2=(softening / rescale.length) ** 2,
        integrator=integrator,
        collisions=collisions,
        restitution=restitution,
        force_impl=force_impl,
        adaptive_eta=adaptive_eta,
        dt_min=dt_min / rescale.time if dt_min else 0.0,
        hermite_fast_cap=hermite_fast_cap,
        hermite_max_substeps=hermite_max_substeps,
        hermite_rungs=hermite_rungs,
    )
    state = make_state(scene.pos, scene.vel, scene.mass, scene.radius,
                       precision=precision, rescale=rescale, device=device)
    state = init_forces(state, cfg)
    final, traj = rollout(state, cfg, steps, record_every)

    def host(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy().astype(np.float64)

    return SimResult(
        pos=host(traj.pos) * rescale.length,
        vel=host(traj.vel) * rescale.velocity,
        time=host(traj.time) * rescale.time,
        energy=host(traj.energy) * rescale.energy,
        ang_mom=host(traj.ang_mom) * rescale.angular_momentum,
        names=list(scene.names),
        final_state=final,
        rescale=rescale,
        config=cfg,
    )
