"""orbital_tpu_torch: the PyTorch / CUDA port of ``orbital_tpu`` for one
NVIDIA H100.

It mirrors ``orbital_tpu``'s layout (``engine/ ops/ utils/ models/``) with
the same module and function names; each Pallas kernel module
``pallas_X.py`` becomes ``cuda_X.py`` over a hand-written CUDA source in
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use. This package
imports ``torch`` and never ``jax``.

Ported so far: the exact-force kdk, euler, rk4, yoshida4 and Hermite
steppers (Hermite with fixed or adaptive dt and one- or multi-rung block
timesteps) with f32/ds32/f64 state, bounce collisions gated on a contact
count that stays on the device, the CUDA force sweep (with and without
contact detection, and over separate i and j blocks), the exact-force
variants (the CUDA half-pair and Gram-identity sweeps, and the Gram form in
plain torch), the CUDA acc + jerk sweep (full, detecting and row-subset),
the CUDA bounce sweep, the fused whole-rollout kernel, the multirate
(RESPA) stepper with its CUDA near-field sweep (``engine.multirate``), the
tree force solver (``force_impl="tree"``) with its CUDA near-field sweep
and the staged large-N loop, the particle-mesh and P3M solvers
(``force_impl="pm"``, ``"p3m"``; P3M's short range a CUDA kernel), recorded
rollouts, the host scene layer (``models/``: units, constants, Keplerian
``Body``/``System``, the bundled solar system, ``Object``/``ObjectCollection``
and their compilation into scene arrays; ``ops.kepler`` in torch), and
``simulate()`` for a ``System``, an ``ObjectCollection``, a list of ``Object``
or scene arrays, Monte-Carlo ensembles (``parallel.ensemble``: E
perturbed systems stepped together, the KDK ones by the CUDA ensemble
kernel), the object facade (``SimulationEngine``, ``run_simulation``) with
``.npz`` checkpoints (``save_state``, ``load_state``), run metrics, offline
plots and video (``viz``), the bundled examples (``models.examples``), the
live viewer (``serve``) and the CLI (``python -m orbital_tpu_torch``), the
tree's four near modes (``"cells"``, ``"columns"``, ``"pairs"`` and the CUDA
``"kernel"``) with their probes and ``simulate(tree_accuracy=)``, orbit
determination (``fitting``: ``fit_initial_conditions``,
``fit_orbital_elements``), the reference's ``core.*`` import layout
(``compat/core``), and body-sharded meshes (``parallel.mesh``: one-card
ranks or a ``torch.distributed`` group, of one axis or the (ensemble x
body) two; ``parallel.sharded``: the exact-force ring on the CUDA block
sweep with bounce, merge and resolve across shards, the sharded PM, P3M's
ring, the sharded tree and its staged route, the sharded RESPA, the
ensemble mesh step, ``simulate(mesh=)``). See ROADMAP.md queue A for the
rest.
"""
from .models.constants import (ASTRO, J2000_JD, STANDARD, IntegratorParams, UnitProfile,
                               UnitSystem, get_unit_profile)
from .models.body import Body, System
from .models.datasets import solar_system, solar_system_v2
from .models.kepler import solve_kepler, state_to_elements
from .models.objects import (Coordinates, Object, ObjectCollection, collide_spheres,
                             pairwise_accelerations, set_circular_orbit)
from .models.rigid import moment_of_inertia, random_angular_velocity
from .engine.checkpoint import load_state, save_state
from .engine.engine import SimulationEngine, run_simulation
from .engine.rollout import (Trajectory, init_forces, init_forces_staged, rollout,
                             rollout_staged)
from .engine.state import NBodyState, Rescale, make_state
from .ops.p3m import p3m_acc_potential
from .ops.pm import pm_acc_potential
from .ops.tree import tree_acc_potential
from .simulate import SimResult, simulate
from .utils.config import SimConfig

__all__ = ["ASTRO", "J2000_JD", "STANDARD", "IntegratorParams", "UnitProfile",
           "UnitSystem", "get_unit_profile",
           "Body", "System", "solar_system", "solar_system_v2", "solve_kepler",
           "state_to_elements",
           "Coordinates", "Object", "ObjectCollection", "collide_spheres",
           "pairwise_accelerations", "set_circular_orbit",
           "moment_of_inertia", "random_angular_velocity",
           "SimConfig", "NBodyState", "Rescale", "make_state", "init_forces",
           "rollout", "init_forces_staged", "rollout_staged", "Trajectory", "simulate",
           "SimResult", "pm_acc_potential", "p3m_acc_potential", "tree_acc_potential",
           "SimulationEngine", "run_simulation", "save_state", "load_state",
           "fit_initial_conditions", "fit_orbital_elements", "FitResult",
           "make_mesh", "make_sharded_step", "make_sharded_rollout",
           "make_sharded_respa_rollout", "make_sharded_ensemble_step", "shard_state",
           "gather_state", "shard_ensemble", "gather_ensemble"]

_PARALLEL = ("make_mesh", "make_sharded_step", "make_sharded_rollout",
             "make_sharded_respa_rollout", "make_sharded_ensemble_step", "shard_state",
             "gather_state", "shard_ensemble", "gather_ensemble")


def __getattr__(name):
    # lazy, as the JAX package's: fitting is a specialty path
    if name in ("fit_initial_conditions", "fit_orbital_elements", "FitResult"):
        from . import fitting

        return getattr(fitting, name)
    if name in _PARALLEL:  # multi-device: a specialty path
        from . import parallel

        return getattr(parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
