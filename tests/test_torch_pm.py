"""The particle-mesh solver of the PyTorch port (``force_impl="pm"``) against
the JAX package's: the CIC corners, whole evaluations, KDK rollouts, a RESPA
far field, simulate()'s pinned cube and warnings, and the routing.

Inputs come from a numpy seed and go through both packages; JAX runs on the
CPU as its own tests run it (tests/conftest.py turns x64 on). Sizes: the
JAX package's smooth cluster (tests/test_pm.py: N = 2,048, eps^2 = 0.09) at
grid 32 and 64. Tolerances, measured on this comparison and stated with why:
  * CIC corner indices: equal. Weights: within 2^-22 (the same f32
    formulas; products of three weights in another association may differ
    by an ulp).
  * acc: max |da| <= 2e-5 max |a|, U to rel 1e-6. The port solves in f32,
    as JAX does without x64; under x64 JAX's deconvolution frequencies
    (``fftfreq``/``rfftfreq``) come out in f64 and promote its Green's
    function, potential and field to f64 while the deposit stays f32, so the
    two part by the f32 FFT's rounding: measured 1.06e-6 to 3.90e-6 of max
    |a| and 0 to 1.8e-7 on U over the cases below.
  * KDK rollouts over 10 steps at dt = 1e-3: atol 5e-7 on f32 positions and
    velocities of magnitude up to ~4, two ulps there (forces ~1e-6 relative
    apart move the state by ~dt |da|, far below an ulp, so the states part
    by the rounding of single updates: measured one ulp, 1.19e-7 at 1.08);
    1e-7 on the f64 RESPA state; recorded energies rel 1e-5 (the f32 mesh
    potential).
"""
import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine import multirate as jmr
from orbital_tpu.engine.state import far_positions
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu.ops import neighbor as jn
from orbital_tpu.ops import pm as jpm
from orbital_tpu_torch.engine import multirate as tmr
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.models.scene import SceneArrays
from orbital_tpu_torch.ops import pm as tpm

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

EPS2 = 0.09
BOX = (np.zeros(3, np.float32), np.float32(4.0))
ACC_RTOL, U_RTOL = 2e-5, 1e-6


def _smooth(n=2048, seed=3, dead=False):
    """The JAX package's smooth cluster; with ``dead`` every third body dead
    and parked far, as make_state parks them."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    alive = None
    if dead:
        alive = np.ones(n, bool)
        alive[::3] = False
        pos[~alive] = far_positions(int((~alive).sum()), 3.0, np.float32)
    return pos, mass, alive


def _t(*xs):
    return tuple(None if x is None else torch.as_tensor(x) for x in xs)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def test_cic_corners_match_jax():
    pos, _, _ = _smooth(512)
    pos[0] = [50.0, -50.0, 0.0]  # clipped into the grid on two axes
    origin, h, g = np.float32(-3.5), np.float32(7.0 / 32), 32
    jf, jw = jpm._cic_corners(jnp.asarray(pos), origin, h, g)
    tf, tw = tpm._cic_corners(torch.as_tensor(pos), torch.tensor(origin), torch.tensor(h), g)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=2.0 ** -22)
    i0, fr = tpm._cic_weights(torch.tensor([[0.25, 3.75, 1.0]]))
    assert i0.tolist() == [[0, 3, 1]] and fr.tolist() == [[0.25, 0.75, 0.0]]


@pytest.mark.parametrize("grid,deconvolve,pinned,dead,with_potential", [
    (32, True, False, False, True), (32, False, False, False, True),
    (32, True, True, True, True), (32, True, False, True, False),
    (64, True, False, False, True), (64, False, True, False, True),
    (64, True, True, True, True), (64, True, True, False, False)])
def test_pm_matches_jax(grid, deconvolve, pinned, dead, with_potential):
    pos, mass, alive = _smooth(dead=dead)
    kw = dict(G_grav=1.0, eps2=EPS2, grid=grid, deconvolve=deconvolve,
              with_potential=with_potential)
    ja, jU = jpm.pm_acc_potential(jnp.asarray(pos), jnp.asarray(mass),
                                  None if alive is None else jnp.asarray(alive),
                                  box=BOX if pinned else None, **kw)
    ta, tU = tpm.pm_acc_potential(*_t(pos, mass, alive),
                                  box=_t(*BOX) if pinned else None, **kw)
    assert ta.dtype == torch.float32 and ta.shape == (len(mass), 3)
    assert _rel(ta.numpy(), ja) <= ACC_RTOL
    if with_potential:
        assert float(tU) == pytest.approx(float(jU), rel=U_RTOL)
    else:
        assert float(tU) == 0.0
    if dead:
        assert not ta[torch.as_tensor(~alive)].any()  # dead bodies inert


def test_pm_dead_bodies_leave_the_live_force_alone():
    """Dead bodies parked far take no part: the masked evaluation equals the
    live bodies' own (the bounding cube is fitted over the live bodies)."""
    pos, mass, alive = _smooth(dead=True)
    a_live, U_live = tpm.pm_acc_potential(*_t(pos[alive], mass[alive]), G_grav=1.0,
                                          eps2=EPS2, grid=32)
    a_mask, U_mask = tpm.pm_acc_potential(*_t(pos, mass, alive), G_grav=1.0, eps2=EPS2,
                                          grid=32)
    np.testing.assert_allclose(a_mask.numpy()[alive], a_live.numpy(), rtol=0,
                               atol=1e-6 * float(a_live.abs().max()))
    assert float(U_mask) == pytest.approx(float(U_live), rel=1e-6)


def test_pm_conserves_momentum_and_needs_softening():
    pos, mass, _ = _smooth()
    a, _ = tpm.pm_acc_potential(*_t(pos, mass), G_grav=1.0, eps2=EPS2, grid=32)
    net = np.abs((mass[:, None] * a.numpy()).sum(0)).max()
    assert net < 1e-4 * float(a.abs().max()) * mass.max()
    with pytest.raises(ValueError, match="the PM solver requires eps2 > 0"):
        tpm.pm_acc_potential(*_t(pos, mass), G_grav=1.0, eps2=0.0)
    a64, U64 = tpm.pm_acc_potential(*_t(pos.astype(np.float64), mass), G_grav=1.0,
                                    eps2=EPS2, grid=32)
    assert a64.dtype == torch.float64 and U64.dtype == torch.float64  # computed in f32


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")


@pytest.mark.parametrize("precision", ["f32", "ds32"])
def test_kdk_rollout_matches_jax(precision):
    """10 KDK steps on the PM force (grid 32, a pinned box) against JAX's
    compiled rollout, both from the port's ``init_forces``."""
    pos, mass, _ = _smooth(1024, 5)
    vel = 0.3 * np.random.default_rng(6).normal(size=(1024, 3))
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=EPS2, force_impl="pm", pm_grid=32,
                         pm_box=(0.0, 0.0, 0.0, float(BOX[1])))
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.make_state(pos, vel, mass, precision=precision)
    ts = tot.init_forces(_port_state(js), tcfg)
    js = js.replace(acc=jnp.asarray(ts.acc.numpy()), potential=jnp.asarray(ts.potential.numpy()))
    jf, jtr = jot.rollout_jit(js, jcfg, 10, 5)
    tf, ttr = tot.rollout(ts, tcfg, 10, 5)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(ttr, f).numpy(), np.asarray(getattr(jtr, f)),
                                   rtol=0, atol=5e-7, err_msg=f)
    np.testing.assert_allclose(ttr.energy.numpy(), np.asarray(jtr.energy), rtol=1e-5)
    assert int(tf.step) == 10


def test_respa_with_pm_far_field_matches_jax():
    """RESPA reaches the mesh through resolve_force_fn: the PM total force
    every K substeps, the exact near force in between (f64 state, the plain
    near sweep on both sides)."""
    rng = np.random.default_rng(21)
    n = 128
    pos = rng.normal(size=(n, 3)) * 0.6
    vel = rng.normal(size=(n, 3)) * 0.2
    mass = rng.uniform(0.5, 1.5, n) / n
    m, k_ch, w_blk, q = jn.neighbor_budgets(pos, cell=0.6, chunk=8, rj=16, with_wl=True)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-2, integrator="respa", respa_k=4,
                         respa_rc=0.3, respa_cell=0.6, respa_m=m, respa_max_chunks=k_ch,
                         respa_w_blk=w_blk, respa_chunk=8, respa_rj=16, respa_wl_entries=q,
                         respa_impl="xla", force_impl="pm", pm_grid=16,
                         pm_box=(0.0, 0.0, 0.0, 4.0))
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.init_forces(jot.make_state(pos, vel, mass, precision="f64"), jcfg)
    ts = tot.init_forces(_port_state(js), tcfg)
    np.testing.assert_allclose(ts.acc.numpy(), np.asarray(js.acc), rtol=0,
                               atol=ACC_RTOL * float(np.abs(np.asarray(js.acc)).max()))
    jf, _, _ = jmr.respa_rollout_jit(js, jcfg, 8)
    tf, _, _ = tmr.respa_rollout(ts, tcfg, 8)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    assert int(tf.step) == 8


def _scenes(n=256, seed=9, spread=1.0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * spread + np.array([1.0, -2.0, 0.5])
    vel = 0.05 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    names = [f"b{i}" for i in range(n)]
    kw = dict(pos=pos, vel=vel, mass=mass, radius=np.zeros(n), names=names)
    return SceneArrays(**kw), JScene(**kw, uuids=[f"u{i}" for i in range(n)])


def test_simulate_pins_the_cube_as_jax_and_warns():
    """simulate(force_impl="pm") pins the cube from the initial extent as the
    JAX package does, warns when eps is below half a mesh cell, and warns at
    the end when a live body left the cube."""
    scene, jscene = _scenes()
    kw = dict(steps=4, dt=1e-3, softening=0.05, force_impl="pm", pm_grid=16,
              precision="f32", rescale=tot.Rescale.identity(), record_every=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = jot.simulate(jscene, **{**kw, "rescale": jot.Rescale.identity()})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tot.simulate(scene, device="cpu", **kw)
    assert res.config.pm_box == pytest.approx(jres.config.pm_box, rel=1e-15)
    msgs = [str(w.message) for w in caught]
    assert any("below half the mesh cell spacing" in m for m in msgs)
    assert not any("left the pinned" in m for m in msgs)
    np.testing.assert_allclose(res.pos, np.asarray(jres.pos), rtol=0, atol=1e-5)
    assert res.config.pm_grid == 16
    # a body flung out of the cube: the end-of-run escape warning
    scene.vel[0] = [1e4, 0.0, 0.0]
    with pytest.warns(RuntimeWarning, match="1 bodies left the pinned pm/p3m mesh cube"):
        tot.simulate(scene, device="cpu", **{**kw, "softening": 1.0})


def test_routing_to_the_mesh(monkeypatch):
    """force_impl="pm" and "p3m" resolve to the mesh functions on every
    device name with the config's grid, capacity and pinned box; neither
    has a detecting variant; Hermite raises."""
    from orbital_tpu_torch.ops import p3m as tp3m

    calls = []
    monkeypatch.setattr(tpm, "pm_acc_potential",
                        lambda *a, **k: calls.append(("pm", k)) or (a[0], a[0][0, 0]))
    monkeypatch.setattr(tp3m, "p3m_acc_potential",
                        lambda *a, **k: calls.append(("p3m", k)) or (a[0], a[0][0, 0], None))
    cfg = tot.SimConfig(dt=1.0, eps2=1e-2, pm_grid=48, p3m_capacity=40,
                        pm_box=(0.0, 1.0, 0.0, 3.0))
    pos, mass = torch.zeros((8, 3)), torch.ones(8)
    for impl in ("pm", "p3m"):
        for dev in ("cpu", "cuda"):
            fn = R.resolve_force_fn(cfg.replace(force_impl=impl), 8192, dev)
            if dev == "cpu":
                out = fn(pos, mass, None)
                assert len(out) == 2
            assert R.resolve_force_detect_fn(cfg.replace(force_impl=impl), 8192, dev) is None
        with pytest.raises(ValueError, match="exact per-pair jerks"):
            R.resolve_accel_jerk_fn(cfg.replace(force_impl=impl), 8192, "cpu")
    (k1, pm_kw), (k2, p3_kw) = calls
    assert (k1, k2) == ("pm", "p3m")
    assert pm_kw["grid"] == 48 and p3_kw["grid"] == 48 and p3_kw["capacity"] == 40
    for kw in (pm_kw, p3_kw):
        center, half = kw["box"]
        assert center.tolist() == [0.0, 1.0, 0.0] and float(half) == 3.0
