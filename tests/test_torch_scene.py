"""The PyTorch port's scene layer (``orbital_tpu_torch.models``,
``ops.kepler`` and ``simulate()`` on scene objects) against the JAX package.

``models/`` is a numpy copy of the JAX package's host scene code, so its
outputs are held bit-equal. ``ops.kepler`` is a torch transcription of the
jitted solver: f64 within 1e-12 (XLA may fuse and reorder the elementwise
chains). ``simulate()`` on a ``System`` runs the f64 golden path in both
packages on the same compiled scene: the same formulas in another summation
order, within 1e-12. ``System.standardize_units`` converts the system in
place, so a scene fed to both packages is built twice.
"""
import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.models import constants as jconst
from orbital_tpu.models import kepler as jkep_host
from orbital_tpu.models import units as junits
from orbital_tpu.models.scene import compile_objects as j_compile_objects
from orbital_tpu.models.scene import compile_system as j_compile_system
from orbital_tpu.ops import kepler as jkep
from orbital_tpu_torch.models import constants as tconst
from orbital_tpu_torch.models import kepler as tkep_host
from orbital_tpu_torch.models import units as tunits
from orbital_tpu_torch.models.scene import compile_objects, compile_system
from orbital_tpu_torch.ops import kepler as tkep

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.mark.parametrize("name", ["AU", "DAY", "JULIAN_DAY", "J2000_JD", "ASTRO", "STANDARD",
                                  "DEFAULT_STANDARD_INTEGRATOR", "DEFAULT_ASTRO_INTEGRATOR"])
def test_constants_equal(name):
    a, b = getattr(tconst, name), getattr(jconst, name)
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        ad, bd = dataclasses.asdict(a), dataclasses.asdict(b)
        assert {k: str(v) for k, v in ad.items()} == {k: str(v) for k, v in bd.items()}
    else:
        assert a == b
    assert sorted(tconst.__all__) == sorted(jconst.__all__)
    for key in ("si", "astro", "SI", tconst.UnitSystem.ASTRO):
        assert dataclasses.asdict(tconst.get_unit_profile(key)) == dataclasses.asdict(
            jconst.get_unit_profile(key))
    with pytest.raises(ValueError):
        tconst.get_unit_profile("cgs")


_UNIT_VALUES = [("Radians", 7.5), ("Degrees", -400.0), ("Meters", 3.2e11), ("AU", 1.7),
                ("Kilograms", 6e24), ("SolarMasses", 0.3), ("Seconds", 9e5), ("Days", 12.5)]


@pytest.mark.parametrize("cls,value", _UNIT_VALUES)
def test_units_convert_equal(cls, value):
    assert tunits.__all__ == junits.__all__
    t, j = getattr(tunits, cls)(value), getattr(junits, cls)(value)
    assert t.value == j.value and t.unit == j.unit
    for tag in tunits.UNIT_BY_TAG:
        try:
            jv = junits.convert(j, tag)
        except ValueError:
            with pytest.raises(ValueError):
                tunits.convert(t, tag)
            continue
        tv = tunits.convert(t, tag)
        assert (tv.value, tv.unit) == (jv.value, jv.unit)
    arr = np.linspace(-1.0, 9.0, 7) * value
    ta, ja = getattr(tunits, cls)(arr), getattr(junits, cls)(arr)
    np.testing.assert_array_equal(ta.value, ja.value)


def test_host_kepler_equal(rng):
    M = rng.uniform(0, 2 * math.pi, 64)
    e = np.concatenate([[0.0, 0.5, 0.95, 0.99], rng.uniform(0, 0.97, 60)])
    np.testing.assert_array_equal(tkep_host.solve_kepler(M, e), jkep_host.solve_kepler(M, e))
    for i in range(8):
        assert tkep_host.solve_kepler(float(M[i]), float(e[i])) == \
            jkep_host.solve_kepler(float(M[i]), float(e[i]))
    pos = rng.normal(size=(16, 3)) * 1e11
    vel = rng.normal(size=(16, 3)) * 1e3
    mu = 1.327e20
    for a, b in zip(tkep_host.state_to_elements(pos[0], vel[0], mu),
                    jkep_host.state_to_elements(pos[0], vel[0], mu)):
        assert a == b


@pytest.mark.parametrize("moons", [False, True])
def test_compile_system_bit_equal(moons):
    ts, js = tot.solar_system_v2(moons=moons), jot.solar_system_v2(moons=moons)
    assert [b.name for b in ts] == [b.name for b in js]
    ts.standardize_units(mass_unit="kilograms", distance_unit="meters",
                         angle_unit="radians", time_unit="seconds")
    js.standardize_units(mass_unit="kilograms", distance_unit="meters",
                         angle_unit="radians", time_unit="seconds")
    for tb, jb in zip(ts, js):
        tr, tv = tb.get_state()
        jr, jv = jb.get_state()
        assert tr == jr and tv == jv, tb.name
    for compose in (False, True):
        t = compile_system(tot.solar_system_v2(moons=moons), compose_parents=compose)
        j = j_compile_system(jot.solar_system_v2(moons=moons), compose_parents=compose)
        assert t.n == j.n == (26 if moons else 15)
        assert t.names == j.names and t.uuids == j.uuids
        for f in ("pos", "vel", "mass", "radius"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_body_from_state_round_trip_equal():
    ts, js = tot.solar_system_v2(moons=True), jot.solar_system_v2(moons=True)
    for sys_ in (ts, js):
        sys_.standardize_units(mass_unit="kilograms", distance_unit="meters",
                               angle_unit="radians", time_unit="seconds")
    for tb, jb in zip(ts, js):
        if tb.parent is None:
            continue
        r, v = tb.get_state()
        tn = tot.Body.from_state(tb.name, r, v, tb.mass, tb.radius, parent=tb.parent)
        jn = jot.Body.from_state(jb.name, r, v, jb.mass, jb.radius, parent=jb.parent)
        assert tn.get_state() == jn.get_state(), tb.name
        np.testing.assert_allclose(tn.get_state()[0], r, rtol=0, atol=1e-9 * np.linalg.norm(r))


def _objects(pkg, rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    objs = []
    for k in range(6):
        objs.append(pkg.Object(mass=float(rng.uniform(1e20, 1e24)),
                               radius=float(rng.uniform(1e5, 1e6)),
                               velocity=rng.normal(size=3) * 1e3,
                               coordinates=pkg.Coordinates.from_iterable(rng.normal(size=3) * 1e9),
                               angular_velocity=np.zeros(3), uuid=f"{k:032x}",
                               name=f"body{k}"))
    pkg.set_circular_orbit(objs[0], objs[1])
    return objs


@pytest.mark.parametrize("as_collection", [False, True])
def test_compile_objects_equal(as_collection):
    t, j = _objects(tot), _objects(jot)
    if as_collection:
        t, j = tot.ObjectCollection(t), jot.ObjectCollection(j)
    ta, ja = compile_objects(t), j_compile_objects(j)
    assert ta.names == ja.names and ta.uuids == ja.uuids
    for f in ("pos", "vel", "mass", "radius"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), err_msg=f)
    tacc, tU = tot.pairwise_accelerations(list(t), eps=1e3)
    jacc, jU = jot.pairwise_accelerations(list(j), eps=1e3)
    assert tU == jU and all(np.array_equal(tacc[k], jacc[k]) for k in jacc)


def _elements(rng, n=48):
    """Bound elements with circular (e = 0) and equatorial (inc = 0) rows."""
    a = rng.uniform(0.3, 40.0, n) * 1.496e11
    e = rng.uniform(0.0, 0.9, n)
    inc = rng.uniform(0.0, math.pi, n)
    e[:8] = 0.0
    inc[4:12] = 0.0
    inc[12] = math.pi  # retrograde equatorial
    return (a, e, inc, rng.uniform(0, 2 * math.pi, n), rng.uniform(0, 2 * math.pi, n),
            rng.uniform(0, 2 * math.pi, n), np.full(n, 1.327e20))


def test_ops_solve_kepler_matches_jax(rng):
    M = rng.uniform(0.0, 2 * math.pi, 256)
    e = np.concatenate([[0.0, 0.79, 0.8, 0.99], rng.uniform(0, 0.99, 252)])
    t = tkep.solve_kepler(torch.from_numpy(M), torch.from_numpy(e)).numpy()
    j = np.asarray(jkep.solve_kepler(jnp.asarray(M), jnp.asarray(e)))
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t - e * np.sin(t), M, atol=1e-10)


def test_ops_elements_to_state_matches_jax(rng):
    el = _elements(rng)
    tp, tv = tkep.elements_to_state(*(torch.from_numpy(x) for x in el))
    jp, jv = jkep.elements_to_state(*(jnp.asarray(x) for x in el))
    assert tp.shape == (48, 3) and tp.dtype == torch.float64
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jp)).max())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jv)).max())
    # a leading batch axis, as for ensembles of perturbed elements
    bp, _ = tkep.elements_to_state(*(torch.from_numpy(x).reshape(6, 8) for x in el))
    np.testing.assert_array_equal(bp.reshape(48, 3).numpy(), tp.numpy())


def test_ops_state_to_elements_matches_jax_and_round_trips(rng):
    el = _elements(rng)
    pos, vel = tkep.elements_to_state(*(torch.from_numpy(x) for x in el))
    mu = torch.from_numpy(el[-1])
    t = tkep.state_to_elements(pos, vel, mu)
    j = jkep.state_to_elements(jnp.asarray(pos.numpy()), jnp.asarray(vel.numpy()),
                               jnp.asarray(el[-1]))
    for k, (x, y) in enumerate(zip(t, j)):
        y = np.asarray(y)
        # angles wrap at 2 pi: compare on the circle
        d = x.numpy() - y
        if k >= 3:
            d = (d + math.pi) % (2 * math.pi) - math.pi
        assert np.abs(d).max() <= 1e-12 * max(1.0, np.abs(y).max()), k
    back = tkep.elements_to_state(*t, mu)
    np.testing.assert_allclose(back[0].numpy(), pos.numpy(), rtol=0,
                               atol=1e-9 * float(pos.abs().max()))
    np.testing.assert_allclose(back[1].numpy(), vel.numpy(), rtol=0,
                               atol=1e-9 * float(vel.abs().max()))
    # the scalar mu broadcasts as JAX's does
    t1 = tkep.state_to_elements(pos[:3], vel[:3], 1.327e20)
    for x, y in zip(t1, t):
        np.testing.assert_allclose(x.numpy(), y[:3].numpy(), rtol=1e-14, atol=1e-14)


@pytest.fixture(scope="module")
def jax_sim16():
    """JAX's simulate() on the solar system with moons, f64, 16 steps of 1 h
    (compiled once)."""
    return jot.simulate(jot.solar_system_v2(moons=True), steps=16, dt=3600.0,
                        record_every=4, precision="f64")


def test_simulate_system_matches_compiled_and_jax(jax_sim16):
    out = tot.simulate(tot.solar_system_v2(moons=True), steps=16, dt=3600.0,
                       record_every=4, device="cpu", precision="f64")
    ref = tot.simulate(compile_system(tot.solar_system_v2(moons=True)), steps=16, dt=3600.0,
                       record_every=4, device="cpu", precision="f64")
    assert out.names == ref.names == jax_sim16.names
    for f in ("pos", "vel", "time", "energy", "ang_mom"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
        a, b = getattr(out, f), np.asarray(getattr(jax_sim16, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max(), err_msg=f)


@pytest.mark.parametrize("as_collection", [False, True])
def test_simulate_objects(as_collection):
    objs = _objects(tot)
    scene = tot.ObjectCollection(objs) if as_collection else objs
    out = tot.simulate(scene, steps=8, dt=60.0, softening=1e3, device="cpu")
    ref = tot.simulate(compile_objects(_objects(tot)), steps=8, dt=60.0, softening=1e3,
                       device="cpu")
    assert out.names == [f"body{k}" for k in range(6)]
    np.testing.assert_array_equal(out.pos, ref.pos)
    jout = jot.simulate(jot.ObjectCollection(_objects(jot)), steps=8, dt=60.0, softening=1e3,
                        precision="f64")
    np.testing.assert_allclose(out.pos, np.asarray(jout.pos), rtol=1e-12,
                               atol=1e-12 * np.abs(out.pos).max())
