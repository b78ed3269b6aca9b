"""simulate(force_impl="tree", tree_near="kernel") of the PyTorch port
against the JAX package's on the paths that tests/test_torch_tree.py leaves
out: f64 (the CPU default), f32 with bounce collisions (the tree has no
contact-detecting variant, so the bounce sweep runs every step in both
packages), and the euler, rk4 and yoshida4 steppers. N = 256 at levels 4,
10 steps recorded every 5, inputs from a numpy seed.

JAX's simulate() runs as it is, except that its ``rollout_jit`` is replaced
by JAX's own stepper (``make_step_fn`` with ``resolve_force_fn``'s tree)
called step by step: the tree evaluation, jitted on its own, then compiles
once per dtype (19 s in f64, 14 s in f32) instead of once per stepper inside
each whole-rollout program (12-32 s each), and the stepper's few elementwise
ops run eagerly.

Tolerances (the same formulas in another summation order), each ~5x what
was measured on this scene: f64 positions within 2e-14 of max |pos|
(measured <= 3.9e-15), velocities within 5e-11 of max |vel| (5.8e-12) and
energies rel 1e-8 (8.0e-10); f32 with bounce within 1e-6 of max |pos| and
max |vel| (positions equal, velocities 1.1e-9: an f32 ulp) and energies rel
1e-6 (8.5e-8).
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine import rollout as jroll
from orbital_tpu.engine.integrators import make_step_fn
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu_torch.models.scene import SceneArrays as TScene

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _stepwise_rollout(state, cfg, steps, record_every):
    """``rollout_jit``'s result from JAX's stepper called step by step."""
    n = state.n_bodies
    fd = (jroll.resolve_force_detect_fn(cfg, n) if cfg.collisions != "none" else None)
    step = make_step_fn(cfg, jroll.resolve_force_fn(cfg, n), force_detect_fn=fd)
    snaps = []
    for _ in range(steps // record_every):
        for _ in range(record_every):
            state = step(state)
        snaps.append(jroll._snapshot(state))
    return state, jroll.Trajectory(**{k: jnp.stack([s[k] for s in snaps])
                                      for k in snaps[0]})


def _scenes(n=256, seed=9):
    """The concentrated blob of tests/test_torch_tree.py in scene units."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1, (n, 3)) * rng.uniform(0.05, 1.0, (n, 1))
    kw = dict(pos=pos, vel=0.1 * rng.normal(size=(n, 3)),
              mass=rng.uniform(0.5, 1.5, n) * 1e4, radius=np.full(n, 2e-2),
              names=[f"b{i}" for i in range(n)])
    return JScene(**kw), TScene(**kw)


@pytest.mark.parametrize("case", [dict(precision="f64"),
                                  dict(precision="f32", collisions="bounce"),
                                  dict(precision="f64", integrator="euler"),
                                  dict(precision="f64", integrator="rk4"),
                                  dict(precision="f64", integrator="yoshida4")],
                         ids=["f64", "f32-bounce", "euler", "rk4", "yoshida4"])
def test_simulate_tree_matches_jax(case, monkeypatch):
    monkeypatch.setattr(sys.modules["orbital_tpu.simulate"], "rollout_jit",
                        _stepwise_rollout)
    js, ts = _scenes()
    kw = dict(steps=10, dt=1e-3, softening=1e-2, record_every=5, force_impl="tree",
              tree_near="kernel", tree_levels=4, restitution=0.5, **case)
    ref = jot.simulate(js, **kw)
    out = tot.simulate(ts, device="cpu", **kw)
    for f in ("tree_levels", "tree_max_chunks", "tree_wl_entries", "integrator",
              "collisions", "eps2", "dt"):
        assert getattr(out.config, f) == getattr(ref.config, f), f
    assert dataclasses.astuple(out.rescale) == dataclasses.astuple(ref.rescale)
    f32 = case["precision"] == "f32"
    for f, tol in (("pos", 1e-6 if f32 else 2e-14), ("vel", 1e-6 if f32 else 5e-11)):
        a, b = getattr(out, f), getattr(ref, f)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(), err_msg=f)
    np.testing.assert_allclose(out.energy, ref.energy, rtol=1e-6 if f32 else 1e-8)
    if case.get("collisions") == "bounce":  # the bounces moved the run
        free = tot.simulate(ts, device="cpu", **dict(kw, collisions="none"))
        assert np.abs(out.vel - free.vel).max() > 1e-2 * np.abs(free.vel).max()
