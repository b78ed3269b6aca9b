"""Hermite in the PyTorch port against the JAX package: the plain acc + jerk
paths, the CUDA wrappers' plain paths, the fixed-dt, adaptive and
block-timestep steppers, Hermite with bounce collisions, simulate(), and
the routing.

The JAX Pallas jerk kernel runs in interpret mode with tile_i=64,
tile_j=128 at N = 256, as tests/test_pallas_forces.py runs it. Tolerances:
  * f64 plain paths and steppers: rtol 1e-12 (summation order only); the
    block steppers in f64 first check that both packages chose the same
    substep count m and the same fast rows idx_f on every macro step.
  * f32 sweeps against the Pallas kernel: acc, jerk and U relative 1e-5 of
    their largest entry (f32 summation order, as tests/test_torch_forces.py;
    measured 6.0e-7 on acc and 3.4e-7 on jerk at N = 256).
  * ds32 and f32 steppers against jitted JAX: atol 1e-6 on positions and
    velocities, acc and jerk relative 1e-5 (XLA:CPU contracts multiply-adds
    in the predictor and the two-sums that the port's eager ops round
    separately; measured 1.2e-7 on positions over 20 Hermite steps at
    N = 96 and over 2 at N = 4,160).
  * the ds32 block step against the JAX f64 one: atol 5e-6 (measured
    5.0e-7 on the binary's velocities, f32 forces).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine.integrators import make_step_fn as j_make_step_fn
from orbital_tpu.engine.rollout import resolve_accel_jerk_detect_fn as j_resolve_ajd
from orbital_tpu.engine.rollout import resolve_accel_jerk_fn as j_resolve_aj
from orbital_tpu.engine.state import far_positions
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu.ops import forces as jforces
from orbital_tpu.ops.collisions import count_contacts_dense as j_count_dense
from orbital_tpu.ops.pallas_jerk import accel_jerk_detect_pallas, accel_jerk_pallas
from orbital_tpu_torch.engine import integrators as I
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.models.scene import SceneArrays as TScene
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.ops import cuda_jerk
from orbital_tpu_torch.ops import forces as tforces

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F32_RTOL = 1e-5
JERK_F32_RTOL = 1e-5
F32_STATE_ATOL = 1e-6


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _scene(rng, n, dtype=np.float64, radius=0.15):
    """Cluster with random radii and ~15% dead bodies parked at spread far
    positions, as the detecting kernel requires."""
    pos = rng.normal(size=(n, 3)).astype(dtype)
    vel = rng.normal(size=(n, 3)).astype(dtype)
    mass = rng.uniform(0.1, 2.0, n).astype(dtype)
    rad = rng.uniform(0.0, radius, n).astype(dtype)
    alive = rng.uniform(size=n) > 0.15
    pos[~alive] = far_positions(int((~alive).sum()), 2.0, dtype).astype(dtype)
    return pos, vel, mass, rad, alive


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")


F64 = dict(atol=1e-12, rtol=1e-12)
F32 = dict(atol=F32_STATE_ATOL, rtol=JERK_F32_RTOL)


def _assert_states_close(ts, js, fields=("pos", "vel", "acc", "jerk"), *, atol, rtol):
    """Positions and velocities within ``atol``; acc and jerk, whose terms
    cancel, within ``rtol`` of their largest entry."""
    for f in fields:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        bound = atol if f in ("pos", "vel", "pos_lo", "vel_lo") else rtol * np.abs(b).max()
        assert np.abs(a - b).max() <= bound, (f, np.abs(a - b).max(), bound)


@pytest.mark.parametrize("path", ["dense", "chunked", "subset"])
@pytest.mark.parametrize("eps2", [1e-4, 0.0])
def test_plain_accel_jerk_matches_jax(rng, path, eps2):
    """f64, 300 bodies with dead ones; chunked and subset in ragged blocks
    of 64 (300 = 4 * 64 + 44), the subset with self rows among its targets."""
    pos, vel, mass, _, alive = _scene(rng, 300)
    args = _t(pos, vel, mass, alive)
    if path == "subset":
        idx = np.array([5, 17, 3, 299, 0, 42, 41])
        a_ref, j_ref = jforces.accel_jerk_subset(idx, pos, vel, mass, alive, G=1.3, eps2=eps2)
        for chunk in (0, 64):
            a, j = tforces.accel_jerk_subset(torch.from_numpy(idx), *args, G=1.3, eps2=eps2,
                                             chunk=chunk)
            np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), rtol=1e-12, atol=1e-12)
        return
    a_ref, j_ref, U_ref = jforces.accel_jerk_dense(pos, vel, mass, alive, G=1.3, eps2=eps2)
    if path == "dense":
        a, j, U = tforces.accel_jerk_dense(*args, G=1.3, eps2=eps2)
    else:
        a, j, U = tforces.accel_jerk_chunked(*args, G=1.3, eps2=eps2, chunk=64)
    assert a.dtype == j.dtype == torch.float64
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(a.numpy()[~alive], 0.0)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-12)


@pytest.mark.parametrize("variant", ["full", "detect", "subset"])
@pytest.mark.parametrize("eps2", [1e-4, 0.0])
def test_cuda_wrappers_cpu_paths_match_jax(rng, variant, eps2):
    """The wrappers on CPU tensors run their plain versions (no launch) and
    agree with the JAX Pallas kernel in interpret mode (f32, N = 256)."""
    pos, vel, mass, rad, alive = _scene(rng, 256, np.float32)
    args = _t(pos, vel, mass)
    kw = dict(G=1.0, eps2=eps2)
    a_ref, j_ref, U_ref = accel_jerk_pallas(pos, vel, mass, alive, tile_i=64, tile_j=128, **kw)
    wrapper = {"full": cuda_jerk.accel_jerk_cuda, "detect": cuda_jerk.accel_jerk_detect_cuda,
               "subset": cuda_jerk.accel_jerk_subset_cuda}[variant]
    before = wrapper.launches
    if variant == "subset":
        idx = np.array([3, 200, 17, 255, 0])
        a, j = wrapper(torch.from_numpy(idx), *args, torch.from_numpy(alive), **kw)
        a_ref, j_ref = np.asarray(a_ref)[idx], np.asarray(j_ref)[idx]
        alive = alive[idx]
    elif variant == "full":
        a, j, U = wrapper(*args, torch.from_numpy(alive), **kw)
    else:
        _, _, _, c_ref = accel_jerk_detect_pallas(pos, vel, mass, rad, alive, tile_i=64,
                                                  tile_j=128, **kw)
        a, j, U, c = wrapper(*args, *_t(rad, alive), **kw)
        assert int(c_ref) > 0 and c.dtype == torch.int32 and c.ndim == 0
        assert int(c) == int(c_ref) == int(j_count_dense(pos, rad * alive, alive))
    assert wrapper.launches == before  # CPU tensors: the plain version
    assert a.dtype == j.dtype == torch.float32
    assert _relerr(a.numpy()[alive], np.asarray(a_ref)[alive]) < F32_RTOL
    assert _relerr(j.numpy()[alive], np.asarray(j_ref)[alive]) < JERK_F32_RTOL
    if variant != "subset":
        np.testing.assert_array_equal(j.numpy()[~alive], 0.0)
        assert float(U) == pytest.approx(float(U_ref), rel=F32_RTOL)


def _cluster(rng, n):
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _hermite_pair(rng, precision, n, adaptive, pad_to=32, **kw):
    pos, vel, mass = _cluster(rng, n)
    extra = dict(adaptive_eta=0.002, dt_min=1e-6) if adaptive else {}
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="hermite", **extra, **kw)
    cfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.make_state(pos, vel, mass, precision=precision, pad_to=pad_to)
    return jcfg, cfg, js, _port_state(js)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("precision", ["f64", "ds32"])
def test_hermite_rollout_matches_jax(rng, precision, adaptive):
    """init_forces (acc and jerk), one step, then a recorded rollout, at
    N = 96 padded to 128 (the dense path)."""
    jcfg, cfg, js, ts = _hermite_pair(rng, precision, 96, adaptive)
    js, ts = jot.init_forces(js, jcfg), tot.init_forces(ts, cfg)
    assert ts.jerk is not None and ts.jerk.shape == ts.acc.shape
    tol = F64 if precision == "f64" else F32
    _assert_states_close(ts, js, ("acc", "jerk"), **tol)
    j1 = jax.jit(j_make_step_fn(jcfg, None, accel_jerk_fn=j_resolve_aj(jcfg, 128)))(js)
    t1 = I.make_step_fn(cfg, accel_jerk_fn=R.resolve_accel_jerk_fn(cfg, 128, "cpu",
                                                                   ts.dtype))(ts)
    _assert_states_close(t1, j1, **tol)
    jf, jt = jot.rollout_jit(js, jcfg, 20, 5)
    tf, tt = tot.rollout(ts, cfg, 20, record_every=5)
    for f in ("pos", "vel", "time", "energy"):
        rtol = 1e-12 if precision == "f64" else (1e-5 if f == "energy" else 0)
        atol = 1e-13 if precision == "f64" else (0 if f == "energy" else F32_STATE_ATOL)
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    assert int(tf.step) == int(jf.step) == 20
    if adaptive:  # the adaptive step stays a tensor on the device
        assert float(tf.time) < 20 * 1e-3 and ts.time.ndim == 0


def test_hermite_chunked_rollout_matches_jax(rng):
    """Above 4,096 bodies both sides take the chunked acc + jerk sweep
    (4,100 live bodies padded to 4,160 = 65 chunks of 64), ds32, adaptive."""
    jcfg, cfg, js, ts = _hermite_pair(rng, "ds32", 4100, True, pad_to=64, chunk=64)
    assert ts.n_bodies == 4160
    jf, jt = jot.rollout_jit(jot.init_forces(js, jcfg), jcfg, 2, 1)
    tf, tt = tot.rollout(tot.init_forces(ts, cfg), cfg, 2, record_every=1)
    for f in ("pos", "vel", "time"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                   rtol=0, atol=F32_STATE_ATOL, err_msg=f)
    np.testing.assert_array_equal(tf.pos[4100:].numpy(), np.asarray(jf.pos)[4100:])


def _binary_in_ring(n_out=30, s_b=0.02, seed=0):
    """The scene of tests/test_hermite_block.py: a tight equal-mass binary
    inside a ring of light distant bodies."""
    m_b, R_out = 0.5, 4.0
    v_b = np.sqrt(2 * m_b / s_b) / 2.0
    v_out = np.sqrt(1.0 / R_out)
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
    pos = np.concatenate([[[-s_b / 2, 0, 0], [s_b / 2, 0, 0]],
                          np.stack([R_out * np.cos(ang), R_out * np.sin(ang),
                                    0.05 * rng.standard_normal(n_out)], 1)])
    vel = np.concatenate([[[0, -v_b, 0], [0, v_b, 0]],
                          np.stack([-v_out * np.sin(ang), v_out * np.cos(ang),
                                    np.zeros(n_out)], 1)])
    mass = np.concatenate([[m_b, m_b], np.full(n_out, 1e-5)])
    return pos, vel, mass, 2 * np.pi * np.sqrt(s_b ** 3 / (2 * m_b))


def _j_block_plan(js, jcfg):
    """The JAX stepper's selection (orbital_tpu/engine/integrators.py:364-381
    and :504-519), for comparing the chosen m and idx_f."""
    a_mag = jnp.linalg.norm(js.acc, axis=-1)
    j_mag = jnp.linalg.norm(js.jerk, axis=-1) + 1e-30
    dt_i = jnp.where(js.alive, jcfg.adaptive_eta * jnp.sqrt(a_mag / j_mag), jnp.inf)
    idx_f = jnp.argsort(dt_i)[:min(jcfg.hermite_fast_cap, js.n_bodies)]
    fast = dt_i[idx_f] < jcfg.dt
    dt_f_min = jnp.min(jnp.where(fast, dt_i[idx_f], jnp.inf))
    need = jnp.where(jnp.any(fast), jnp.ceil(jcfg.dt / jnp.clip(dt_f_min, jcfg.dt_min,
                                                                 jcfg.dt)), 1.0)
    if jcfg.hermite_rungs > 1:
        e = jnp.clip(jnp.ceil(jnp.log2(jnp.maximum(need, 1.0))), 0.0,
                     float(np.log2(jcfg.hermite_max_substeps))).astype(jnp.int32)
        m = 1 << int(e)
    else:
        m = int(jnp.clip(need, 1.0, float(jcfg.hermite_max_substeps)))
    return np.asarray(idx_f), m if bool(jnp.any(fast)) else 0


@pytest.mark.parametrize("rungs,reselect", [(1, True), (3, True), (3, False)])
def test_block_steppers_match_jax(rungs, reselect):
    """hermite_block and hermite_block_rungs on the binary-in-ring scene at
    macro dt = T_binary / 4, f64, macro step by macro step: the same m and
    idx_f first, then the states."""
    pos, vel, mass, T_b = _binary_in_ring()
    dt = T_b / 4.0
    jcfg = jot.SimConfig(dt=dt, G=1.0, eps2=1e-10, integrator="hermite", adaptive_eta=0.02,
                         dt_min=dt / 4096, hermite_fast_cap=8, hermite_max_substeps=64,
                         hermite_rungs=rungs, hermite_reselect=reselect)
    cfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.init_forces(jot.make_state(pos, vel, mass, precision="f64"), jcfg)
    ts = tot.init_forces(_port_state(js), cfg)
    j_step = jax.jit(j_make_step_fn(jcfg, None, accel_jerk_fn=j_resolve_aj(jcfg, 32)))
    t_step = I.make_step_fn(cfg, accel_jerk_fn=R.resolve_accel_jerk_fn(cfg, 32, "cpu",
                                                                       torch.float64))
    ms = []
    for _ in range(6):
        j_idx, j_m = _j_block_plan(js, jcfg)
        t_idx, _, t_m = I.block_plan(ts, cfg)
        assert t_m == j_m
        np.testing.assert_array_equal(t_idx.numpy(), j_idx)
        ms.append(t_m)
        js, ts = j_step(js), t_step(ts)
        _assert_states_close(ts, js, **F64)
    assert min(ms) >= 4  # the binary substeps on every macro step
    s_b = np.linalg.norm(pos[0] - pos[1])
    assert abs(float(torch.linalg.vector_norm(ts.pos[0] - ts.pos[1])) - s_b) / s_b < 0.05


def test_block_stepper_ds32_drops_lo_words_of_fast_rows():
    """ds32: the substepped rows drop their compensation words on the macro
    step, as the JAX stepper does. The JAX block stepper does not trace in
    ds32 under x64 (its substep carry mixes f32 and f64), so the port's ds32
    macro step is held against the JAX f64 one, after the same m and idx_f."""
    pos, vel, mass, T_b = _binary_in_ring()
    dt = T_b / 4.0
    kw = dict(dt=dt, G=1.0, eps2=1e-10, integrator="hermite", adaptive_eta=0.02,
              dt_min=dt / 4096, hermite_fast_cap=4, hermite_max_substeps=64)
    jcfg, cfg = jot.SimConfig(**kw), tot.SimConfig(**kw)
    js = jot.init_forces(jot.make_state(pos, vel, mass, precision="f64"), jcfg)
    ts = tot.init_forces(tot.make_state(pos, vel, mass, precision="ds32", device="cpu"), cfg)
    j_idx, j_m = _j_block_plan(js, jcfg)
    t_idx, fast, t_m = I.block_plan(ts, cfg)
    assert t_m == j_m >= 4 and int(fast.sum()) == 2
    # the binary's two members tie in dt_i: f32 and f64 may order them
    # either way, which one rung cannot tell apart
    np.testing.assert_array_equal(np.sort(t_idx.numpy()), np.sort(j_idx))
    js = jax.jit(j_make_step_fn(jcfg, None, accel_jerk_fn=j_resolve_aj(jcfg, 32)))(js)
    ts = tot.rollout(ts, cfg, 1)[0]
    rows = t_idx.numpy()[fast.numpy()]
    assert not ts.pos_lo[rows].any() and not ts.vel_lo[rows].any()
    assert ts.pos_lo.abs().sum() > 0  # the slow rows keep theirs
    for f in ("pos_full", "vel_full"):
        a = getattr(ts, f)().double().numpy()
        np.testing.assert_allclose(a, np.asarray(getattr(js, f)()), rtol=0, atol=5e-6,
                                   err_msg=f)


def _head_on(precision, **kw):
    """tests/test_torch_collisions.py's head-on pair plus bystanders."""
    pos = np.array([[-1.0, 0, 0], [1.0, 0, 0], [0, 5.0, 0], [0, -5.0, 0]])
    vel = np.array([[0.5, 0, 0], [-0.5, 0, 0], [0, 0, 0], [0, 0, 0]])
    mass = np.array([1.0, 1.0, 1e-3, 1e-3])
    radius = np.array([0.3, 0.3, 0.01, 0.01])
    jcfg = jot.SimConfig(dt=0.05, G=1e-4, eps2=1e-6, collisions="bounce", restitution=0.8,
                         force_impl="dense", integrator="hermite", **kw)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision=precision), jcfg)
    return jcfg, tot.SimConfig(**dataclasses.asdict(jcfg)), js, _port_state(js)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_hermite_bounce_matches_jax(precision, adaptive):
    extra = dict(adaptive_eta=0.5, dt_min=1e-3) if adaptive else {}
    jcfg, cfg, js, ts = _head_on(precision, **extra)
    j_step = jax.jit(j_make_step_fn(jcfg, None, accel_jerk_fn=j_resolve_aj(jcfg, 4),
                                    accel_jerk_detect_fn=j_resolve_ajd(jcfg, 4)))
    t_step = I.make_step_fn(
        cfg, accel_jerk_fn=R.resolve_accel_jerk_fn(cfg, 4, "cpu", ts.dtype),
        accel_jerk_detect_fn=R.resolve_accel_jerk_detect_fn(cfg, 4, "cpu", ts.dtype))
    for _ in range(80):
        js, ts = j_step(js), t_step(ts)
    assert float(ts.vel[0, 0]) < 0 and float(js.vel[0, 0]) < 0  # the pair bounced
    _assert_states_close(ts, js, **(F64 if precision == "f64" else F32))
    assert int(ts.step) == int(js.step) == 80


def test_hermite_gated_bounce_matches_unconditional():
    """The device-gated Hermite stepper is bit-equal to the one that sweeps
    and applies every step, through contact-free and colliding steps."""
    _, cfg, _, s_a = _head_on("f32")
    s_b = s_a
    aj = R.resolve_accel_jerk_fn(cfg, 4, "cpu")
    step_plain = I.make_step_fn(cfg, accel_jerk_fn=aj)
    step_gated = I.make_step_fn(cfg, accel_jerk_fn=aj,
                                accel_jerk_detect_fn=R.resolve_accel_jerk_detect_fn(cfg, 4,
                                                                                    "cpu"))
    gated_off = 0
    for _ in range(80):
        s_a, s_b = step_plain(s_a), step_gated(s_b)
        for f in ("pos", "vel", "acc", "jerk"):
            np.testing.assert_array_equal(getattr(s_a, f).numpy(), getattr(s_b, f).numpy())
        gated_off += int(tcoll.count_contacts_dense(s_b.pos, s_b.radius, s_b.alive)) == 0
    assert float(s_a.vel[0, 0]) < 0
    assert 0 < gated_off < 80  # both gate branches ran


def _earth_moon(rng):
    n = 6
    pos, vel = np.zeros((n, 3)), np.zeros((n, 3))
    mass = np.array([5.972e24, 7.348e22] + [1e3] * (n - 2))
    pos[1, 0], vel[1, 1] = 3.844e8, 1022.0
    pos[2:] = rng.normal(size=(n - 2, 3)) * 1e7 + np.array([4e7, 0, 0])
    vel[2:, 1] = 3.0e3
    names = [f"b{i}" for i in range(n)]
    radius = np.full(n, 1e3)
    return (JScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names),
            TScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names))


@pytest.mark.parametrize("precision", ["f64", "ds32"])
def test_simulate_hermite_adaptive_matches_jax(rng, precision):
    js, ts = _earth_moon(rng)
    kw = dict(steps=60, dt=600.0, softening=1e3, record_every=15, precision=precision,
              integrator="hermite", adaptive_eta=0.05, dt_min=1.0)
    ref = jot.simulate(js, **kw)
    out = tot.simulate(ts, device="cpu", **kw)
    for f in ("dt", "G", "eps2", "integrator", "adaptive_eta", "dt_min", "hermite_fast_cap",
              "hermite_max_substeps", "hermite_rungs"):
        assert getattr(out.config, f) == getattr(ref.config, f), f
    assert out.time[-1] < 60 * 600.0  # the adaptive step shrank below dt
    rtol = 1e-12 if precision == "f64" else 1e-6
    for f in ("pos", "vel", "time", "energy", "ang_mom"):
        a, b = getattr(out, f), getattr(ref, f)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=f)


def test_simulate_block_hermite_matches_jax():
    """simulate() passes the block knobs through (the scene of
    tests/test_hermite_block.py::test_simulate_block_hermite_passthrough)."""
    prof = dataclasses.replace(tot.models.constants.STANDARD, G=1.0)
    s_b, m_b = 0.02, 0.5
    v_b = np.sqrt(2 * m_b / s_b) / 2
    arrays = dict(pos=np.array([[-s_b / 2, 0, 0], [s_b / 2, 0, 0], [4, 0, 0]]),
                  vel=np.array([[0, -v_b, 0], [0, v_b, 0], [0, 0, 0.5]]),
                  mass=np.array([m_b, m_b, 1e-5]), radius=np.zeros(3), names=["a", "b", "c"])
    T_b = 2 * np.pi * np.sqrt(s_b ** 3 / (2 * m_b))
    kw = dict(steps=16, dt=T_b / 4, softening=1e-5, integrator="hermite", adaptive_eta=0.02,
              dt_min=T_b / 4096, hermite_fast_cap=2, hermite_max_substeps=256,
              record_every=4, hermite_rungs=2)
    ref = jot.simulate(JScene(**arrays), unit_profile=dataclasses.replace(jot.STANDARD, G=1.0),
                       **kw)
    out = tot.simulate(TScene(**arrays), device="cpu", unit_profile=prof, **kw)
    assert out.config.hermite_fast_cap == 2 and out.config.hermite_rungs == 2
    np.testing.assert_allclose(out.pos, ref.pos, rtol=1e-12, atol=1e-12)
    sep = np.linalg.norm(out.pos[-1, 0] - out.pos[-1, 1])
    assert abs(sep - s_b) / s_b < 0.05


def test_jerk_routing(rng, monkeypatch):
    """auto: dense at N <= 4096 on any device; above it the kernels for CUDA
    tensors and the chunked plain paths for CPU tensors; the exact-force
    policies of other force kernels route to the jerk path."""
    calls = []

    def spy(name):
        plain = getattr(cuda_jerk, name.replace("_cuda", "_plain"))

        def fn(*a, **k):
            calls.append(name)
            return plain(*a, **k)
        return fn

    for name in ("accel_jerk_cuda", "accel_jerk_detect_cuda", "accel_jerk_subset_cuda"):
        monkeypatch.setattr(cuda_jerk, name, spy(name))
    n = 4100
    pos, vel, mass, rad, alive = (torch.from_numpy(a) for a in _scene(rng, n, np.float32))
    idx = torch.tensor([3, 7, 4099])
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, integrator="hermite", collisions="bounce")
    a, j, U = R.resolve_accel_jerk_fn(cfg, n, "cpu")(pos, vel, mass, alive)
    a_ref, j_ref, U_ref = tforces.accel_jerk_chunked(pos, vel, mass, alive, G=1.0, eps2=1e-4)
    np.testing.assert_array_equal(j.numpy(), j_ref.numpy())
    R.resolve_accel_jerk_detect_fn(cfg, n, "cpu")(pos, vel, mass, rad, alive)
    R.resolve_accel_jerk_subset_fn(cfg, n, "cpu")(idx, pos, vel, mass, alive)
    R.resolve_accel_jerk_fn(cfg, 64, "cuda")(pos[:64], vel[:64], mass[:64], alive[:64])
    R.resolve_accel_jerk_subset_fn(cfg, 64, "cuda")(idx[:2], pos[:64], vel[:64], mass[:64],
                                                    alive[:64])
    assert not calls  # plain paths: CPU tensors, and N <= 4096 on any device
    for impl in ("auto", "pallas", "pallas_sym", "mxu", "pallas_mxu", "ring"):
        c = cfg.replace(force_impl=impl)
        R.resolve_accel_jerk_fn(c, n, "cuda")(pos, vel, mass, alive)
    R.resolve_accel_jerk_detect_fn(cfg, n, "cuda")(pos, vel, mass, rad, alive)
    R.resolve_accel_jerk_subset_fn(cfg, n, "cuda")(idx, pos, vel, mass, alive)
    assert calls == ["accel_jerk_cuda"] * 6 + ["accel_jerk_detect_cuda",
                                               "accel_jerk_subset_cuda"]
    # f64 state takes the same kernel routes (B5 f32 inside, the subset's
    # f64 instance), as the JAX package
    calls.clear()
    p64, v64, m64 = pos.double(), vel.double(), mass.double()
    R.resolve_accel_jerk_fn(cfg, n, "cuda", torch.float64)(p64, v64, m64, alive)
    R.resolve_accel_jerk_subset_fn(cfg, n, "cuda", torch.float64)(idx, p64, v64, m64, alive)
    assert calls == ["accel_jerk_cuda", "accel_jerk_subset_cuda"]


@pytest.mark.parametrize("impl", ["pm", "p3m", "tree"])
def test_jerk_routing_refuses_mesh_and_tree(impl):
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, integrator="hermite", force_impl=impl)
    for resolve in (R.resolve_accel_jerk_fn, R.resolve_accel_jerk_detect_fn,
                    R.resolve_accel_jerk_subset_fn):
        with pytest.raises(ValueError, match="exact per-pair jerks"):
            resolve(cfg, 8192, "cpu")
    with pytest.raises(ValueError, match="exact per-pair jerks"):
        tot.init_forces(tot.make_state(np.zeros((2, 3)), np.zeros((2, 3)), np.ones(2),
                                       device="cpu"), cfg)


def test_jerk_wrappers_launch_or_raise():
    """Off the CPU the wrappers launch their kernel or raise: a tensor on a
    device they do not serve raises instead of being computed another way."""
    pos = torch.empty((8, 3), device="meta")
    vec = torch.empty((8,), device="meta")
    alive = torch.empty((8,), dtype=torch.bool, device="meta")
    idx = torch.empty((2,), dtype=torch.int64, device="meta")
    for call in (lambda: cuda_jerk.accel_jerk_cuda(pos, pos, vec, alive, G=1.0, eps2=1e-4),
                 lambda: cuda_jerk.accel_jerk_detect_cuda(pos, pos, vec, vec, alive, G=1.0,
                                                          eps2=1e-4),
                 lambda: cuda_jerk.accel_jerk_subset_cuda(idx, pos, pos, vec, alive, G=1.0,
                                                          eps2=1e-4)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("n", [1, 255, 256, 5000, 65536, 1048576])
def test_subset_plan_covers_every_source_once(n):
    """The row subset kernel's j split (``cuda_jerk.subset_plan``), walked as
    the kernel walks it (split q sweeps sources [q split, min((q + 1) split,
    n))): every source once, no empty split, a whole number of staged rounds
    a split, and a grid of row tiles x splits that fills at least half of
    the SMs where the sources allow and overshoots them by at most a column
    of row tiles."""
    for f in (1, 16, 37, 64, 200):
        splits, split = cuda_jerk.subset_plan(n, f)
        assert splits >= 1 and split % cuda_jerk.SUBSET_TILE == 0
        seen = np.zeros(n, np.int64)
        for q in range(splits):
            lo, hi = q * split, min((q + 1) * split, n)
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all()
        tiles = -(-f // cuda_jerk.SUBSET_ROWS)
        most = tiles * -(-n // cuda_jerk.SUBSET_TILE)
        assert tiles * splits <= cuda_jerk.SM_COUNT + tiles
        assert 2 * tiles * splits >= min(cuda_jerk.SM_COUNT, most)
