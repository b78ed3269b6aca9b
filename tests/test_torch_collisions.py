"""Bounce collisions of the PyTorch port against the JAX package's: the
sweeps, the contact counts, the detecting force sweep, the gated steppers,
rollout and simulate(), and the routing on CPU and CUDA device names.

The JAX Pallas kernels run in interpret mode, with tile_i=64, tile_j=128 at
N = 256 as tests/test_pallas_forces.py runs them. Tolerances:
  * bounce sweeps in f32: dv atol 5e-5, dp atol 1e-5, the JAX package's own
    dense-vs-tiled tolerance (sqrt and division against rsqrt and
    reciprocal); dead rows exactly 0.
  * contact counts: exact.
  * detecting force sweep: acc and U relative 1e-5 (f32 summation order, as
    tests/test_torch_forces.py), count exact.
  * steppers: f64 rtol 1e-12 (summation order only); f32 against jitted JAX
    atol 1e-6 over 80 steps (XLA:CPU contracts multiply-adds that the port's
    eager ops round; measured at most 1.2e-7, one ulp of the O(1) state).
  * ds32 rollout at N = 4,224: atol 1e-7, as tests/test_torch_rollout.py
    (measured 3e-8 over 4 steps with bounces).
  * ds32 simulate(): rtol 2e-6; the bounce impulse is f32 arithmetic on the
    hi words on both sides, in another rounding order (measured 9.1e-7 on
    the angular momentum, 4.2e-7 on the velocities).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine.integrators import make_step_fn as j_make_step_fn
from orbital_tpu.engine.rollout import resolve_force_detect_fn as j_resolve_detect
from orbital_tpu.engine.rollout import resolve_force_fn as j_resolve_force
from orbital_tpu.engine.state import far_positions
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu.ops import collisions as jcoll
from orbital_tpu.ops.pallas_collisions import bounce_deltas_pallas
from orbital_tpu.ops.pallas_forces import pairwise_acc_detect_pallas
from orbital_tpu_torch.engine import integrators as I
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.models.scene import SceneArrays as TScene
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.ops import cuda_collisions, cuda_forces

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F32_RTOL = 1e-5


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _bounce_scene(rng, n=256):
    """The scene of tests/test_pallas_forces.py::test_pallas_bounce_matches_dense."""
    pos = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    radius = np.full(n, 0.12, np.float32)
    alive = np.ones(n, bool)
    alive[250:] = False
    return pos, vel, mass, radius, alive


def _contact_scene(rng, n=256):
    """Random radii and dead bodies parked at spread far positions, as the
    detecting kernel requires (tests/test_pallas_forces.py)."""
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    radius = rng.uniform(0.0, 0.15, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.15
    pos[~alive] = far_positions(int((~alive).sum()), 2.0, np.float32).astype(np.float32)
    return pos, mass, radius, alive


@pytest.mark.parametrize("port", ["dense", "chunked"])
@pytest.mark.parametrize("ref", ["dense", "pallas"])
def test_bounce_deltas_match_jax(rng, port, ref):
    pos, vel, mass, radius, alive = _bounce_scene(rng)
    if ref == "dense":
        dp_ref, dv_ref = jcoll.bounce_deltas(pos, vel, mass, radius, alive, restitution=0.8)
    else:
        dp_ref, dv_ref = bounce_deltas_pallas(pos, vel, mass, radius, alive,
                                              restitution=0.8, tile_i=64, tile_j=128)
    args = _t(pos, vel, mass, radius, alive)
    if port == "dense":
        dp, dv = tcoll.bounce_deltas(*args, restitution=0.8)
    else:  # 256 = 2 * 100 + a ragged 56
        dp, dv = tcoll.bounce_deltas_chunked(*args, restitution=0.8, chunk=100)
    dp, dv = dp.numpy(), dv.numpy()
    assert np.abs(dv).max() > 0  # collisions occurred
    np.testing.assert_allclose(dv, np.asarray(dv_ref), rtol=0, atol=5e-5)
    np.testing.assert_allclose(dp, np.asarray(dp_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(dv[~alive], 0.0)
    np.testing.assert_array_equal(dp[~alive], 0.0)
    # every pair impulse is equal and opposite
    p = (mass[:, None].astype(np.float64) * dv).sum(0)
    assert np.abs(p).max() <= 1e-5 * (mass[:, None] * np.abs(dv)).sum()


@pytest.mark.parametrize("count", [0, 3])
def test_bounce_plain_gated_by_count(rng, count):
    pos, vel, mass, radius, alive = _bounce_scene(rng)
    args = _t(pos, vel, mass, radius, alive)
    dp_ref, dv_ref = tcoll.bounce_deltas_chunked(*args, restitution=0.8)
    contacts = torch.tensor(count, dtype=torch.int32)
    before = cuda_collisions.bounce_deltas_cuda.launches
    for fn in (cuda_collisions.bounce_deltas_plain, cuda_collisions.bounce_deltas_cuda):
        dp, dv = fn(*args, restitution=0.8, contacts=contacts)
        for got, ref in ((dp, dp_ref), (dv, dv_ref)):
            want = ref.numpy() if count else np.zeros_like(ref.numpy())
            np.testing.assert_array_equal(got.numpy(), want)
    assert cuda_collisions.bounce_deltas_cuda.launches == before  # CPU: plain version


@pytest.mark.parametrize("n", [256, 300])
@pytest.mark.parametrize("port", ["dense", "chunked"])
def test_contact_counts_match_jax(rng, n, port):
    pos, _, radius, alive = _contact_scene(rng, n)
    want = int(jcoll.count_contacts_dense(pos, radius, alive))
    if n % 64 == 0:
        assert int(jcoll.count_contacts_chunked(pos, radius, alive, chunk=64)) == want
    args = _t(pos, radius, alive)
    if port == "dense":
        got = tcoll.count_contacts_dense(*args)
    else:  # 300 = 4 * 64 + a ragged 44
        got = tcoll.count_contacts_chunked(*args, chunk=64)
    assert want > 0 and got.dtype == torch.int32 and got.ndim == 0
    assert int(got) == want


@pytest.mark.parametrize("eps2", [1e-4, 0.0])
@pytest.mark.parametrize("with_potential", [True, False])
def test_detect_plain_matches_pallas(rng, eps2, with_potential):
    pos, mass, radius, alive = _contact_scene(rng)
    a_ref, U_ref, c_ref = pairwise_acc_detect_pallas(
        pos, mass, radius, alive, G=1.0, eps2=eps2, tile_i=64, tile_j=128,
        with_potential=with_potential)
    before = cuda_forces.pairwise_acc_detect_cuda.launches
    a, U, c = cuda_forces.pairwise_acc_detect_cuda(*_t(pos, mass, radius, alive), G=1.0,
                                                   eps2=eps2, with_potential=with_potential)
    assert cuda_forces.pairwise_acc_detect_cuda.launches == before  # CPU: plain version
    assert int(c_ref) > 0 and c.dtype == torch.int32 and int(c) == int(c_ref)
    assert _relerr(a.numpy()[alive], np.asarray(a_ref)[alive]) < F32_RTOL
    np.testing.assert_array_equal(a.numpy()[~alive], 0.0)
    if with_potential:
        assert float(U) == pytest.approx(float(U_ref), rel=F32_RTOL)
    else:
        assert float(U) == 0.0 == float(U_ref)


@pytest.mark.parametrize("scene", ["padded", "separated"])
def test_detect_counts_zero_when_nothing_touches(rng, scene):
    if scene == "padded":  # live radii reach nothing; 28 far-parked padding rows
        n = 100
        pos, vel, mass = 100.0 * rng.normal(size=(n, 3)), np.zeros((n, 3)), np.ones(n)
        js = jot.make_state(pos, vel, mass, np.full(n, 1e-3), precision="f32", pad_to=128)
        ts = tot.make_state(pos, vel, mass, np.full(n, 1e-3), precision="f32", pad_to=128,
                            device="cpu")
        np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
        assert ts.n_bodies == 128
        fields = (ts.pos, ts.mass, ts.radius, ts.alive)
        jfields = (js.pos, js.mass, js.radius, js.alive)
    else:
        n = 128
        pos = (10.0 * np.arange(n, dtype=np.float32))[:, None] * np.ones(3, np.float32)
        jfields = (pos, np.ones(n, np.float32), np.full(n, 0.1, np.float32), np.ones(n, bool))
        fields = _t(*jfields)
    _, _, c_ref = pairwise_acc_detect_pallas(*jfields, G=1.0, eps2=1e-4, tile_i=64,
                                             tile_j=128)
    _, _, c = cuda_forces.pairwise_acc_detect_plain(*fields, G=1.0, eps2=1e-4)
    assert int(c) == int(c_ref) == 0
    assert int(tcoll.count_contacts_dense(fields[0], fields[2], fields[3])) == 0


def _head_on(precision, integrator):
    """The head-on scene of tests/test_pallas_forces.py::
    test_cond_gated_bounce_matches_unconditional: a pair that collides
    mid-rollout, plus bystanders."""
    pos = np.array([[-1.0, 0, 0], [1.0, 0, 0], [0, 5.0, 0], [0, -5.0, 0]])
    vel = np.array([[0.5, 0, 0], [-0.5, 0, 0], [0, 0, 0], [0, 0, 0]])
    mass = np.array([1.0, 1.0, 1e-3, 1e-3])
    radius = np.array([0.3, 0.3, 0.01, 0.01])
    jcfg = jot.SimConfig(dt=0.05, G=1e-4, eps2=1e-6, collisions="bounce",
                         restitution=0.8, force_impl="dense", integrator=integrator)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision=precision), jcfg)
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    ts = tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")
    return jcfg, tot.SimConfig(**dataclasses.asdict(jcfg)), js, ts


@pytest.mark.parametrize("integrator", ["kdk", "euler", "rk4", "yoshida4"])
def test_gated_bounce_matches_unconditional(integrator):
    """The device-gated stepper is bit-equal to the always-sweep stepper,
    through contact-free and colliding steps."""
    _, cfg, _, s_a = _head_on("f32", integrator)
    s_b = s_a
    force = R.resolve_force_fn(cfg, 4, "cpu")
    step_plain = I.make_step_fn(cfg, force)
    step_gated = I.make_step_fn(cfg, force,
                                force_detect_fn=R.resolve_force_detect_fn(cfg, 4, "cpu"))
    gated_off = 0
    for _ in range(80):
        s_a = step_plain(s_a)
        s_b = step_gated(s_b)
        for f in ("pos", "vel"):
            np.testing.assert_array_equal(getattr(s_a, f).numpy(), getattr(s_b, f).numpy())
        gated_off += int(tcoll.count_contacts_dense(s_b.pos, s_b.radius, s_b.alive)) == 0
    assert float(s_a.vel[0, 0]) < 0  # the pair bounced (vx signs flipped)
    assert 0 < gated_off < 80  # both gate branches ran


@pytest.mark.parametrize("integrator", ["kdk", "euler", "rk4", "yoshida4"])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_gated_steppers_match_jax(integrator, precision):
    jcfg, cfg, js, ts = _head_on(precision, integrator)
    j_step = jax.jit(j_make_step_fn(jcfg, j_resolve_force(jcfg, 4),
                                    force_detect_fn=j_resolve_detect(jcfg, 4)))
    t_step = I.make_step_fn(cfg, R.resolve_force_fn(cfg, 4, "cpu", ts.dtype),
                            force_detect_fn=R.resolve_force_detect_fn(cfg, 4, "cpu", ts.dtype))
    for _ in range(80):
        js, ts = j_step(js), t_step(ts)
    assert float(ts.vel[0, 0]) < 0 and float(js.vel[0, 0]) < 0
    tol = dict(rtol=1e-12, atol=1e-12) if precision == "f64" else dict(rtol=0, atol=1e-6)
    for f in ("pos", "vel", "acc"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   err_msg=f, **tol)
    assert int(ts.step) == int(js.step) == 80


def test_bounce_rollout_matches_jax_chunked(rng):
    """4,100 live bodies padded to 4,224 (the JAX tiled sweep needs a
    multiple of 128), ds32 on CPU tensors: above 4,096 both sides take the
    chunked forces and counts; the port bounces with the chunked sweep, JAX
    with its tiled kernel in interpret mode."""
    n = 4100
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 0.015)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, collisions="bounce", restitution=0.8,
                         force_impl="chunked", chunk=128)
    cfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.make_state(pos, vel, mass, radius, precision="ds32", pad_to=128)
    ts = tot.make_state(pos, vel, mass, radius, precision="ds32", pad_to=128, device="cpu")
    assert ts.n_bodies == 4224
    contacts0 = int(tcoll.count_contacts_dense(ts.pos, ts.radius, ts.alive))
    assert contacts0 > 0
    jf, jt = jot.rollout_jit(jot.init_forces(js, jcfg), jcfg, 4, 2)
    tf, tt = tot.rollout(tot.init_forces(ts, cfg), cfg, 4, record_every=2)
    assert not np.array_equal(tf.vel_full().numpy(), tot.rollout(
        tot.init_forces(ts, cfg.replace(collisions="none")),
        cfg.replace(collisions="none"), 4)[0].vel_full().numpy())  # bounces happened
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(tf.pos[n:].numpy(), np.asarray(jf.pos)[n:])  # parked


def _collision_scene():
    """Two 1e10 kg spheres of radius 100 m closing head-on at 10 m/s, plus
    bystanders; SI units."""
    pos = np.array([[-500.0, 0, 0], [500.0, 30.0, 0], [0, 5e3, 0], [0, -5e3, 0],
                    [4e3, 0, 2e3]])
    vel = np.array([[5.0, 0, 0], [-5.0, 0, 0], [0, 0, 0], [0.1, 0, 0], [0, 0.2, 0]])
    mass = np.array([1e10, 2e10, 1e6, 1e6, 1e6])
    radius = np.array([100.0, 100.0, 1.0, 1.0, 1.0])
    names = [f"b{i}" for i in range(5)]
    return (JScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names),
            TScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names))


@pytest.mark.parametrize("precision", ["f64", "ds32"])
def test_simulate_bounce_matches_jax(precision):
    js, ts = _collision_scene()
    kw = dict(steps=200, dt=1.0, softening=1.0, record_every=20, precision=precision,
              collisions="bounce", restitution=0.8)
    ref = jot.simulate(js, **kw)
    out = tot.simulate(ts, device="cpu", **kw)
    assert out.config.collisions == "bounce" and out.config.restitution == 0.8
    assert out.vel[-1, 0, 0] < 0 < out.vel[-1, 1, 0]  # the pair bounced
    # f64: summation order only; ds32: f32 forces and impulses in another
    # rounding order (jitted JAX against eager torch)
    rtol = 1e-12 if precision == "f64" else 2e-6
    for f in ("pos", "vel", "time", "ang_mom"):
        a, b = getattr(out, f), getattr(ref, f)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=f)


def test_force_detect_routing(rng, monkeypatch):
    """auto: dense plus the dense count at N <= 4096 on any device; above it
    the detecting kernel for CUDA tensors, chunked forces and count for CPU
    tensors; "pallas" names the kernel at any N."""
    calls = []

    def spy(*a, **k):
        calls.append(k)
        return cuda_forces.pairwise_acc_detect_plain(*a, **k)

    monkeypatch.setattr(cuda_forces, "pairwise_acc_detect_cuda", spy)
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, collisions="bounce")
    n = 4100
    pos, mass = _t(rng.normal(size=(n, 3)), rng.uniform(0.5, 1.5, n) / n)
    radius = torch.full((n,), 0.02, dtype=torch.float64)
    alive = torch.ones(n, dtype=torch.bool)
    a, U, c = R.resolve_force_detect_fn(cfg, n, "cpu", torch.float64)(pos, mass, radius,
                                                                      alive)
    a_ref, U_ref = tot.ops.forces.pairwise_acc_chunked(pos, mass, alive, G=1.0, eps2=1e-4)
    np.testing.assert_array_equal(a.numpy(), a_ref.numpy())
    assert int(c) == int(tcoll.count_contacts_chunked(pos, radius, alive)) > 0
    assert not calls
    small = R.resolve_force_detect_fn(cfg, 64, "cuda")
    a, _, c = small(pos[:64].float(), mass[:64].float(), radius[:64].float(), alive[:64])
    assert not calls  # dense at N <= 4096 on any device
    np.testing.assert_array_equal(a.numpy(), tot.ops.forces.pairwise_acc_dense(
        pos[:64].float(), mass[:64].float(), alive[:64], G=1.0, eps2=1e-4)[0].numpy())
    big = R.resolve_force_detect_fn(cfg.replace(track_potential=False), n, "cuda")
    big(pos.float(), mass.float(), radius.float(), alive)
    assert calls == [dict(G=1.0, eps2=1e-4, with_potential=False)]
    R.resolve_force_detect_fn(cfg.replace(force_impl="pallas"), 64, "cpu")(
        pos[:64], mass[:64], radius[:64], alive[:64])
    assert len(calls) == 2
    for impl in ("pm", "p3m"):  # the mesh solvers have no detecting variant
        assert R.resolve_force_detect_fn(cfg.replace(force_impl=impl), n, "cpu") is None


def test_bounce_routing(rng, monkeypatch):
    """CUDA device names take the bounce kernel at every N (the count on the
    device can skip it); CPU tensors the dense sweep at N <= 4096 and the
    chunked one above."""
    calls = []

    def spy(*a, **k):
        calls.append(k)
        return cuda_collisions.bounce_deltas_plain(*a, **k)

    monkeypatch.setattr(cuda_collisions, "bounce_deltas_cuda", spy)
    pos, vel, mass, radius, alive = _t(*_bounce_scene(rng))
    c = torch.tensor(2, dtype=torch.int32)
    for n in (256, 8192):
        I.resolve_bounce_fn(n, "cuda")(pos, vel, mass, radius, alive, 0.8, c)
    assert calls == [dict(restitution=0.8, contacts=c)] * 2
    dense = I.resolve_bounce_fn(4096, "cpu")(pos, vel, mass, radius, alive, 0.8, c)
    chunked = I.resolve_bounce_fn(4097, "cpu")(pos, vel, mass, radius, alive, 0.8, c)
    for got, ref in zip(dense, tcoll.bounce_deltas(pos, vel, mass, radius, alive,
                                                   restitution=0.8)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    for got, ref in zip(chunked, tcoll.bounce_deltas_chunked(pos, vel, mass, radius, alive,
                                                             restitution=0.8)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert len(calls) == 2


def test_collision_wrappers_launch_or_raise():
    """Off the CPU the wrappers launch their kernel or raise: a tensor on a
    device they do not serve raises instead of being computed another way."""
    pos = torch.empty((8, 3), device="meta")
    vec = torch.empty((8,), device="meta")
    alive = torch.empty((8,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_forces.pairwise_acc_detect_cuda(pos, vec, vec, alive, G=1.0, eps2=1e-4)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_collisions.bounce_deltas_cuda(pos, pos, vec, vec, alive)
