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
and the staged large-N loop, recorded rollouts and ``simulate()`` for scene
arrays. See ROADMAP.md queue A for the rest.
"""
from .engine.rollout import (Trajectory, init_forces, init_forces_staged, rollout,
                             rollout_staged)
from .engine.state import NBodyState, Rescale, make_state
from .simulate import SimResult, simulate
from .utils.config import SimConfig

__all__ = ["SimConfig", "NBodyState", "Rescale", "make_state", "init_forces",
           "rollout", "init_forces_staged", "rollout_staged", "Trajectory", "simulate",
           "SimResult"]
