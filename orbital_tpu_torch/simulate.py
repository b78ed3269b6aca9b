"""One-call convenience API: scene arrays in, trajectory out.

Wraps natural-unit rescaling, the precision policy, force-path selection,
the rollout and the unit conversion back to physical units behind a single
function. Ported so far: the exact-force kdk, euler, rk4, yoshida4 and
Hermite steppers (Hermite with fixed or adaptive dt and block timesteps)
and the multirate (RESPA) stepper on one device, with or without bounce
collisions; the merge and resolve collision modes and the approximate force
solvers raise ``NotImplementedError`` (ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .engine.multirate import respa_rollout
from .engine.rollout import init_forces, rollout
from .engine.state import NBodyState, Rescale, make_state
from .models.constants import STANDARD, UnitProfile
from .models.scene import SceneArrays
from .ops.neighbor import neighbor_budgets
from .utils.config import SimConfig

__all__ = ["simulate", "SimResult"]


def _respa_fields(scene: SceneArrays, steps: int, dt: float, softening: float,
                  rescale: Rescale, *, respa_k: int, respa_rc: float, respa_r1: float,
                  respa_cell: float, respa_impl: str, respa_refresh: int) -> dict:
    """The ``respa_*`` fields of the config in internal units: rc defaults
    to 5 softening lengths, the cell to the larger of 2 rc and rc plus twice
    the distance the 99th-percentile speed covers in one frozen-geometry
    window (each body may move half the skin), and the budgets come from the
    probe with a chunk of 32 and blocks of 4 chunks."""
    if steps % respa_k:
        raise ValueError(f"steps={steps} must divide by respa_k={respa_k}")
    eps2_i = (softening / rescale.length) ** 2
    if eps2_i <= 0:
        raise ValueError("integrator='respa' requires softening > 0")
    rc_i = respa_rc / rescale.length if respa_rc else 5.0 * eps2_i ** 0.5
    pos_i = np.asarray(scene.pos, np.float64) / rescale.length
    if respa_cell:
        cell_i = respa_cell / rescale.length
    else:
        vel_i = np.asarray(scene.vel, np.float64) / rescale.velocity
        vmag = np.linalg.norm(vel_i, axis=1)
        v99 = float(np.quantile(vmag, 0.99)) if vmag.size else 0.0
        cell_i = max(2.0 * rc_i,
                     rc_i + 4.0 * respa_refresh * respa_k * (dt / rescale.time) * v99)
    m_grid, k_ch, w_blk, wl_q = neighbor_budgets(pos_i, cell=cell_i, chunk=32, rj=4,
                                                  with_wl=True)
    return dict(respa_k=respa_k, respa_rc=rc_i,
                respa_r1=respa_r1 / rescale.length if respa_r1 else 0.0,
                respa_cell=cell_i, respa_m=m_grid, respa_max_chunks=k_ch,
                respa_w_blk=w_blk, respa_chunk=32, respa_rj=4, respa_impl=respa_impl,
                respa_wl_entries=wl_q, respa_refresh=respa_refresh)


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
    respa_k: int = 8,
    respa_rc: float = 0.0,
    respa_r1: float = 0.0,
    respa_cell: float = 0.0,
    respa_impl: str = "auto",
    respa_refresh: int = 1,
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

    ``integrator="respa"`` runs the multirate stepper: one exact force
    evaluation per ``respa_k`` leapfrog substeps and the switched near force
    every substep (``engine.multirate``). ``steps`` counts substeps and must
    divide by ``respa_k``; ``record_every`` is rounded to a multiple of it.
    ``respa_rc`` (switch radius, default 5 softening lengths) and
    ``respa_cell`` (neighbor-grid cell, default from rc and the 99th
    percentile speed) are in scene units; the search budgets are sized from
    the initial distribution (``ops.neighbor.neighbor_budgets``). A nonzero
    overflow or skin counter, read once after the run, raises a
    ``RuntimeWarning``: near pairs may have been missed.
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
        if integrator == "respa":
            # snapshots exist at macro boundaries only
            record_every = (record_every // respa_k) * respa_k
            while record_every and steps % record_every:
                record_every -= respa_k
            record_every = record_every or respa_k

    respa_fields = {}
    if integrator == "respa":
        respa_fields = _respa_fields(scene, steps, dt, softening, rescale, respa_k=respa_k,
                                     respa_rc=respa_rc, respa_r1=respa_r1,
                                     respa_cell=respa_cell, respa_impl=respa_impl,
                                     respa_refresh=respa_refresh)
    cfg = SimConfig(
        **respa_fields,
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
    if integrator == "respa":
        final, traj, rdiag = respa_rollout(state, cfg, steps, record_every)
        overflow, skin = int(rdiag["overflow"]), int(rdiag["skin_violation"])
        if overflow or skin:
            warnings.warn(
                f"respa window diagnostics nonzero (overflow={overflow}, "
                f"skin_violation={skin}): near pairs may have been missed; enlarge "
                "respa_cell (skin) or re-run in segments so budgets re-size.",
                RuntimeWarning, stacklevel=2)
    else:
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
