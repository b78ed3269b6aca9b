"""Monte-Carlo ensembles of the PyTorch port (``parallel.ensemble``,
``ops.fused_ensemble``) against the JAX package's vmapped ensemble rollout.

``jax.random`` and ``torch.Generator`` draw different numbers, so the
perturbed members are built once with numpy and handed to both packages
(JAX's members stacked with ``jnp``, carried over with
``state_from_arrays``); ``make_ensemble`` itself is tested for its contract
and in distribution. On CPU tensors the KDK configurations take the batched
plain route (the CUDA kernel's plain version, the batch written out as
[E, N, N] broadcasts), the others the member loop.

Tolerances (max |d| / max |ref| over every member):
  * f64: the same formulas in another summation order, 1e-12 (measured
    <= 1.7e-15 over 20 steps).
  * f32 and ds32: f32 force sums in other orders (XLA:CPU's against
    torch's, measured acc 3.6e-7, potential 1.7e-7) carried through 20 steps
    (positions <= 1.6e-9, velocities <= 1.6e-7), and XLA:CPU contracting
    FMAs into the ds32 two-sums. The recorded f32 energy adds the f32
    potential's rounding (measured 7.0e-7). Held to 1e-6 (state, angular
    momentum), 2e-6 (acc) and 5e-6 (potential, energy), ~3-7x the readings.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.parallel.ensemble import energy_drift as j_energy_drift
from orbital_tpu.parallel.ensemble import ensemble_rollout as j_ensemble_rollout
from orbital_tpu_torch.ops.fused_ensemble import (ENSEMBLE_MAX_N, ensemble_acc_potential_plain,
                                                  fused_ensemble, fused_ensemble_plain)
from orbital_tpu_torch.parallel import ensemble as ens

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

E = 8
STEPS = 20
TOL = {"f64": dict(state=1e-12, acc=1e-12, potential=1e-12, energy=1e-12, ang_mom=1e-12),
       "f32": dict(state=1e-6, acc=2e-6, potential=5e-6, energy=5e-6, ang_mom=1e-6)}
TOL["ds32"] = TOL["f32"]


def _port(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")


def _scene(kind):
    """(pos, vel, mass, radius, rescale or None, jax cfg, sigma) of a member."""
    if kind == "solar":
        sc = jot.models.scene.compile_system(jot.solar_system_v2(moons=True))
        rs = jot.Rescale.natural(sc.pos, sc.mass, jot.STANDARD.G)
        cfg = jot.SimConfig(dt=1800.0 / rs.time, G=rs.g_internal(jot.STANDARD.G),
                            eps2=(1e6 / rs.length) ** 2)
        return sc.pos, sc.vel, sc.mass, sc.radius, rs, cfg, 1e-8 * rs.length
    rng = np.random.default_rng(5)
    n = 8
    pos, vel = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass, None, None, jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4), 1e-3


def _members(kind, precision, **cfg_kw):
    """E members (member 0 the base, the rest with numpy-drawn position
    offsets) in both packages, and both configs."""
    pos, vel, mass, rad, rs, cfg, sigma = _scene(kind)
    rng = np.random.default_rng(11)
    states = [jot.make_state(pos + (0.0 if e == 0 else rng.normal(size=pos.shape) * sigma),
                             vel, mass, rad, precision=precision, rescale=rs)
              for e in range(E)]
    js = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    cfg = cfg.replace(**cfg_kw)
    return js, _port(js), cfg, tot.SimConfig(**dataclasses.asdict(cfg))


def _full(s, f):
    a = np.asarray(getattr(s, f), np.float64)
    lo = getattr(s, f + "_lo")
    return a if lo is None else a + np.asarray(lo, np.float64)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = np.abs(b).max()
    err = np.abs(a - b).max() / (scale if scale > 0 else 1.0)
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


@pytest.mark.parametrize("record_every", [0, 5])
@pytest.mark.parametrize("precision", ["f64", "f32", "ds32"])
@pytest.mark.parametrize("kind", ["random8", "solar"])
def test_ensemble_rollout_matches_jax(kind, precision, record_every):
    js, ts, jcfg, tcfg = _members(kind, precision)
    assert ens.ensemble_route(tcfg, ts.n_bodies, "cpu", ts.dtype) == "plain"
    runs = ens.member_loop.runs
    jf, jt = j_ensemble_rollout(js, jcfg, STEPS, record_every)
    tf, tt = ens.ensemble_rollout(ts, tcfg, STEPS, record_every)
    assert ens.member_loop.runs == runs
    tol = TOL[precision]
    for f in ("pos", "vel"):
        _close(_full(tf, f), _full(jf, f), tol["state"], f)
    _close(tf.acc, jf.acc, tol["acc"], "acc")
    _close(tf.potential, jf.potential, tol["potential"], "potential")
    np.testing.assert_array_equal(tf.time.numpy(), np.asarray(jf.time))
    np.testing.assert_array_equal(tf.step.numpy(), np.asarray(jf.step))
    assert tf.dtype == ts.dtype and tf.is_ds == (precision == "ds32")
    if not record_every:
        assert tt is None and jt is None
        return
    n = ts.n_bodies
    r = STEPS // record_every
    assert tuple(tt.pos.shape) == (E, r, n, 3) and tuple(tt.alive.shape) == (E, r, n)
    for f in ("pos", "vel", "ang_mom"):
        _close(getattr(tt, f), getattr(jt, f), tol["ang_mom" if f == "ang_mom" else "state"],
               "traj." + f)
    _close(tt.energy, jt.energy, tol["energy"], "traj.energy")
    np.testing.assert_array_equal(tt.time.numpy(), np.asarray(jt.time))
    np.testing.assert_array_equal(tt.alive.numpy(), np.asarray(jt.alive))
    np.testing.assert_allclose(ens.energy_drift(tt), j_energy_drift(jt),
                               rtol=1e-9 if precision == "f64" else 1.0,
                               atol=1e-9 if precision == "f64" else 5e-6)


def test_energy_drift_equal(rng):
    energy = -1.0 - rng.uniform(0.0, 1e-6, size=(E, 7))
    want = j_energy_drift(types.SimpleNamespace(energy=energy))
    got = ens.energy_drift(types.SimpleNamespace(energy=torch.from_numpy(energy)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ens.energy_drift(types.SimpleNamespace(energy=energy)), want)


def test_steps_zero_evaluates_forces(rng):
    """A rollout of 0 steps is the force initialisation: each member's acc
    and potential of the dense single-system path."""
    _, ts, _, tcfg = _members("random8", "f64")
    ts = ts.replace(acc=torch.zeros_like(ts.acc), potential=torch.zeros_like(ts.potential))
    fin, traj = ens.ensemble_rollout(ts, tcfg, 0)
    assert traj is None
    for e in range(E):
        acc, U = tot.ops.forces.pairwise_acc_dense(ts.pos[e], ts.mass[e], ts.alive[e],
                                                   G=tcfg.G, eps2=tcfg.eps2)
        np.testing.assert_allclose(fin.acc[e].numpy(), acc.numpy(), rtol=1e-14, atol=1e-14)
        assert float(fin.potential[e]) == pytest.approx(float(U), rel=1e-14)
    torch.testing.assert_close(fin.pos, ts.pos, rtol=0, atol=0)


def test_plain_route_matches_single_rollouts_with_dead_bodies():
    """The batched plain route against the port's own rollout of each member
    (dense, fused="never"), with dead bodies in some members."""
    _, ts, _, tcfg = _members("random8", "ds32")
    alive = ts.alive.clone()
    alive[1, 3] = alive[4, 0] = alive[4, 7] = False
    ts = ts.replace(alive=alive, mass=ts.mass * alive)
    fin, traj = ens.ensemble_rollout(ts, tcfg, 12, record_every=4)
    for e in range(E):
        one = ens._member(ts, e)
        f1, t1 = tot.rollout(tot.init_forces(one, tcfg), tcfg, 12, record_every=4,
                             fused="never")
        for f in ("pos", "vel", "acc"):
            _close(_full(fin, f)[e] if f != "acc" else fin.acc[e], _full(f1, f)
                   if f != "acc" else f1.acc, 1e-6, f)
        _close(traj.energy[e], t1.energy, 5e-6, "energy")
    assert bool((fin.acc[~alive] == 0).all())


def test_acc_potential_plain_matches_dense(rng):
    pos = torch.from_numpy(rng.normal(size=(3, 17, 3)))
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, (3, 17)))
    alive = torch.from_numpy(rng.uniform(size=(3, 17)) > 0.2)
    acc, U = ensemble_acc_potential_plain(pos, mass, alive, G=2.0, eps2=1e-3)
    assert acc.shape == (3, 17, 3) and U.shape == (3,)
    for e in range(3):
        a1, u1 = tot.ops.forces.pairwise_acc_dense(pos[e], mass[e], alive[e], G=2.0,
                                                   eps2=1e-3)
        np.testing.assert_allclose(acc[e].numpy(), a1.numpy(), rtol=1e-14, atol=1e-14)
        assert float(U[e]) == pytest.approx(float(u1), rel=1e-14)


def _base(precision="f64"):
    pos, vel, mass, rad, rs, _, _ = _scene("solar")
    return tot.make_state(pos, vel, mass, rad, precision=precision, rescale=rs, device="cpu")


def test_make_ensemble_contract():
    base = _base("ds32")
    st = ens.make_ensemble(base, 16, torch.Generator().manual_seed(7), pos_sigma=1e-6,
                           vel_sigma=1e-6)
    assert st.pos.shape == (16, 26, 3) and st.time.shape == (16,) and st.step.shape == (16,)
    for f in dataclasses.fields(tot.NBodyState):
        a, b = getattr(st, f.name), getattr(base, f.name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape[1:] == b.shape
        assert torch.equal(a[0], b), f.name  # member 0 is the base, bit for bit
        if f.name not in ("pos", "vel"):
            assert bool((a == b).all()), f.name  # only positions and velocities move
    assert not torch.equal(st.pos[1], base.pos) and not torch.equal(st.vel[1], base.vel)
    again = ens.make_ensemble(base, 16, torch.Generator().manual_seed(7), pos_sigma=1e-6,
                              vel_sigma=1e-6)
    other = ens.make_ensemble(base, 16, torch.Generator().manual_seed(8), pos_sigma=1e-6,
                              vel_sigma=1e-6)
    assert torch.equal(again.pos, st.pos) and torch.equal(again.vel, st.vel)
    assert not torch.equal(other.pos[1:], st.pos[1:])
    calm = ens.make_ensemble(base, 3, torch.Generator().manual_seed(7))
    assert torch.equal(calm.pos, base.pos.expand(3, -1, -1))


@pytest.mark.parametrize("field,sigma", [("pos", 1e-3), ("vel", 2e-4)])
def test_make_ensemble_sigma(field, sigma):
    base = _base("f64")
    kw = {"pos_sigma": sigma if field == "pos" else 0.0,
          "vel_sigma": sigma if field == "vel" else 0.0}
    st = ens.make_ensemble(base, 64, torch.Generator().manual_seed(3), **kw)
    d = (getattr(st, field)[1:] - getattr(base, field)).flatten().numpy()
    n = d.size
    s = float(np.sqrt(np.mean(d * d)))
    # the standard error of the sample deviation is sigma / sqrt(2 n)
    assert abs(s - sigma) <= 4.0 * sigma / np.sqrt(2 * n), (s, sigma)
    assert abs(float(np.mean(d))) <= 4.0 * sigma / np.sqrt(n)
    other = "vel" if field == "pos" else "pos"
    assert torch.equal(getattr(st, other), getattr(base, other).expand_as(getattr(st, other)))


def test_make_ensemble_custom_perturb():
    base = _base("f64")
    seen = []

    def perturb(gen, state):
        seen.append(gen)
        return state.replace(mass=state.mass * (1.0 + len(seen)))

    g = torch.Generator().manual_seed(1)
    st = ens.make_ensemble(base, 4, g, perturb=perturb)
    assert len(seen) == 3 and all(x is g for x in seen)
    assert torch.equal(st.mass[0], base.mass)
    for e in range(1, 4):
        torch.testing.assert_close(st.mass[e], base.mass * (1.0 + e), rtol=0, atol=0)


def _single(states, cfg, steps, record_every):
    outs = [tot.rollout(tot.init_forces(ens._member(states, e), cfg), cfg, steps,
                        record_every) for e in range(states.pos.shape[0])]
    return outs


@pytest.mark.parametrize("case", ["bounce", "tree"])
def test_member_loop_equals_single_rollouts(case, rng):
    n = 64
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    if case == "bounce":
        cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, collisions="bounce")
        rad = np.full(n, 0.05)
        base = tot.make_state(pos, vel, mass, rad, precision="f64", device="cpu")
    else:
        cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="tree", tree_levels=3,
                            tree_near="kernel", tree_chunk=16, tree_max_chunks=64,
                            tree_wl_entries=4096, tree_wl_rj=8, pm_box=(0.0, 0.0, 0.0, 6.0))
        base = tot.make_state(pos, vel, mass, precision="f32", device="cpu")
    states = ens.make_ensemble(base, 4, torch.Generator().manual_seed(2), pos_sigma=1e-2)
    assert ens.ensemble_route(cfg, n, "cpu", base.dtype) == "members"
    runs = ens.member_loop.runs
    fin, traj = ens.ensemble_rollout(states, cfg, 6, record_every=3)
    assert ens.member_loop.runs == runs + 1
    assert traj.pos.shape == (4, 2, n, 3) and traj.energy.shape == (4, 2)
    for e, (f1, t1) in enumerate(_single(states, cfg, 6, 3)):
        for f in ("pos", "vel", "acc", "potential", "time", "step", "alive"):
            assert torch.equal(getattr(fin, f)[e], getattr(f1, f)), (e, f)
        for f in ("pos", "vel", "energy", "ang_mom", "alive", "time"):
            assert torch.equal(getattr(traj, f)[e], getattr(t1, f)), (e, f)
    fin2, none = ens.ensemble_rollout(states, cfg, 6)
    assert none is None and torch.equal(fin2.pos, fin.pos)


@pytest.mark.parametrize("change,device,dtype,route", [
    ({}, "cuda", torch.float32, "kernel"),
    ({}, "cpu", torch.float32, "plain"),
    ({}, "cpu", torch.float64, "plain"),
    ({}, "cuda", torch.float64, "members"),
    ({"force_impl": "dense"}, "cuda", torch.float32, "kernel"),
    ({"force_impl": "pallas"}, "cuda", torch.float32, "kernel"),
    ({"force_impl": "pallas_sym"}, "cuda", torch.float32, "members"),
    ({"force_impl": "tree"}, "cpu", torch.float32, "members"),
    ({"force_impl": "pm"}, "cuda", torch.float32, "members"),
    ({"collisions": "bounce"}, "cuda", torch.float32, "members"),
    ({"collisions": "merge"}, "cpu", torch.float64, "members"),
    ({"integrator": "hermite"}, "cuda", torch.float32, "members"),
    ({"integrator": "rk4"}, "cpu", torch.float64, "members"),
    ({"eps2": 0.0}, "cuda", torch.float32, "members"),
    ({"eps2": 0.0}, "cpu", torch.float64, "members"),
    ({}, "meta", torch.float32, "members"),
])
def test_route_choice(change, device, dtype, route):
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4).replace(**change)
    assert ens.ensemble_route(cfg, 26, device, dtype) == route


def test_route_choice_by_body_count():
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4)
    assert ens.ensemble_route(cfg, ENSEMBLE_MAX_N, "cuda", torch.float32) == "kernel"
    assert ens.ensemble_route(cfg, ENSEMBLE_MAX_N + 1, "cuda", torch.float32) == "members"
    assert ens.ensemble_route(cfg, ENSEMBLE_MAX_N + 1, "cpu", torch.float64) == "members"


def test_wrapper_contract():
    _, ts, _, tcfg = _members("random8", "f32")
    fused_ensemble.launches = 0
    out = fused_ensemble(ts, tcfg, 3)
    ref = fused_ensemble_plain(ts, tcfg, 3)
    assert fused_ensemble.launches == 0  # CPU tensors take the plain version
    for f in ("pos", "vel", "acc", "potential", "time", "step"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ensemble(ts.replace(pos=ts.pos.to("meta")), tcfg, 1)
    with pytest.raises(ValueError, match="eps2"):
        fused_ensemble(ts, tcfg.replace(eps2=0.0), 1)
    with pytest.raises(ValueError, match="collisions"):
        fused_ensemble(ts, tcfg.replace(collisions="bounce"), 1)
    with pytest.raises(ValueError, match="batched"):
        fused_ensemble(ens._member(ts, 0), tcfg, 1)
    with pytest.raises(ValueError, match="batched"):
        ens.ensemble_rollout(ens._member(ts, 0), tcfg, 1)
    with pytest.raises(ValueError, match="divisible"):
        ens.ensemble_rollout(ts, tcfg, 5, record_every=2)


def test_solar_ensemble_conserves_energy_on_the_plain_route():
    """BASELINE config 5's scene, cut to 4 members and 200 steps of 1,800 s,
    in f64: each member's |dE/E| from the energies the route returns (the
    kinetic sum and the closing potential)."""
    base = _base("f64")
    _, _, _, _, rs, _, _ = _scene("solar")
    cfg = tot.SimConfig(dt=1800.0 / rs.time, G=rs.g_internal(tot.STANDARD.G),
                        eps2=(1e6 / rs.length) ** 2)
    states = ens.make_ensemble(base, 4, torch.Generator().manual_seed(7), pos_sigma=1e-8)

    def energies(s):
        return (tot.ops.diagnostics.kinetic_energy(s.vel, s.mass) + s.potential).numpy()

    e0 = energies(ens.ensemble_rollout(states, cfg, 0)[0])
    drift = np.abs((energies(ens.ensemble_rollout(states, cfg, 200)[0]) - e0) / e0)
    assert drift.shape == (4,) and drift.max() < 1e-6, drift
