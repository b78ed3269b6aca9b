"""The PyTorch port's slice as a whole against the JAX package: init_forces
+ recorded rollout and simulate() on identical state (carried over with
``state_from_arrays``), routing, and the import boundary.

Tolerances:
  * f64 (torch float64 on CPU vs JAX x64): the same formulas in another
    summation order, rtol 1e-12.
  * ds32: JAX's rollout is compiled, and XLA:CPU may contract dt*v into the
    two-sum as a fused multiply-add (up to ~2e-10 from the exactly rounded
    double-single sum), while the port's eager ops round every step; forces
    differ in f32 summation order (~1e-7 relative). Over 20 steps at
    dt = 1e-3 that stays far below atol 1e-7 on positions and velocities.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine import rollout as jrollout
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.models.scene import SceneArrays as TScene

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _cluster(rng, n):
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")


def _run_both(rng, precision, force_impl, n=96, steps=20, record_every=5, **cfg_kw):
    pos, vel, mass = _cluster(rng, n)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl=force_impl, **cfg_kw)
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.make_state(pos, vel, mass, precision=precision, pad_to=32)
    ts = _port_state(js)
    js = jot.init_forces(js, jcfg)
    ts = tot.init_forces(ts, tcfg)
    jf, jt = jot.rollout_jit(js, jcfg, steps, record_every)
    tf, tt = tot.rollout(ts, tcfg, steps, record_every)
    return (js, jf, jt), (ts, tf, tt)


@pytest.mark.parametrize("force_impl,chunk", [("dense", 1024), ("chunked", 32),
                                              ("auto", 1024)])
def test_f64_rollout_matches_jax(rng, force_impl, chunk):
    (js, jf, jt), (ts, tf, tt) = _run_both(rng, "f64", force_impl, chunk=chunk)
    np.testing.assert_allclose(ts.acc.numpy(), np.asarray(js.acc), rtol=1e-12, atol=1e-12)
    assert float(ts.potential) == pytest.approx(float(js.potential), rel=1e-12)
    for f in ("pos", "vel", "time", "energy", "ang_mom"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                   rtol=1e-12, atol=1e-13, err_msg=f)
    np.testing.assert_array_equal(tt.alive.numpy(), np.asarray(jt.alive))
    assert tt.n_records == jt.n_records == 4
    np.testing.assert_allclose(tf.pos.numpy(), np.asarray(jf.pos), rtol=1e-12, atol=1e-13)
    assert int(tf.step) == int(jf.step) == 20


@pytest.mark.parametrize("track_potential", [True, False])
def test_ds32_rollout_matches_jax(rng, track_potential):
    (_, jf, jt), (_, tf, tt) = _run_both(rng, "ds32", "auto",
                                         track_potential=track_potential)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
        full_t = getattr(tf, f + "_full")().double().numpy()
        full_j = np.asarray(getattr(jf, f + "_full")(), np.float64)
        np.testing.assert_allclose(full_t, full_j, rtol=0, atol=1e-7)
    # recorded energies use the f32 potential of the last force evaluation
    np.testing.assert_allclose(tt.energy.numpy(), np.asarray(jt.energy), rtol=1e-5)
    assert tf.pos_lo is not None and tf.pos_lo.dtype == torch.float32


@pytest.mark.parametrize("integrator", ["euler", "rk4", "yoshida4"])
@pytest.mark.parametrize("precision", ["f64", "ds32"])
def test_integrators_match_jax(rng, integrator, precision):
    """The other steppers without collisions, to the tolerances above."""
    (js, jf, jt), (ts, tf, tt) = _run_both(rng, precision, "auto", integrator=integrator)
    tol = dict(rtol=1e-12, atol=1e-13) if precision == "f64" else dict(rtol=0, atol=1e-7)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                   err_msg=f, **tol)
    assert int(tf.step) == int(jf.step) == 20


def test_unrecorded_rollout_equals_recorded_final(rng):
    pos, vel, mass = _cluster(rng, 64)
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4)
    st = tot.init_forces(tot.make_state(pos, vel, mass, precision="ds32", device="cpu"), cfg)
    a, none = tot.rollout(st, cfg, 12)
    b, traj = tot.rollout(st, cfg, 12, record_every=4)
    assert none is None and traj.n_records == 3
    for f in ("pos", "pos_lo", "vel", "vel_lo", "acc", "potential", "time", "step"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
    np.testing.assert_array_equal(traj.pos[-1].numpy(), b.pos_full().numpy())
    with pytest.raises(ValueError, match="divisible"):
        tot.rollout(st, cfg, 10, record_every=4)


def _scene(rng):
    """Earth-Moon-like pair plus light satellites, SI units."""
    n = 6
    pos = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    mass = np.array([5.972e24, 7.348e22] + [1e3] * (n - 2))
    pos[1, 0] = 3.844e8
    vel[1, 1] = 1022.0
    pos[2:] = rng.normal(size=(n - 2, 3)) * 1e7 + np.array([4e7, 0, 0])
    vel[2:, 1] = 3.0e3
    radius = np.full(n, 1e3)
    names = [f"b{i}" for i in range(n)]
    return (JScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names),
            TScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names))


@pytest.mark.parametrize("precision", ["f64", "ds32"])
def test_simulate_matches_jax(rng, precision):
    js, ts = _scene(rng)
    kw = dict(steps=60, dt=60.0, softening=1e3, record_every=15, precision=precision)
    ref = jot.simulate(js, **kw)
    out = tot.simulate(ts, device="cpu", **kw)
    assert out.names == ref.names
    for f in ("dt", "G", "eps2", "integrator", "collisions", "force_impl"):
        assert getattr(out.config, f) == getattr(ref.config, f), f
    assert dataclasses.astuple(out.rescale) == dataclasses.astuple(ref.rescale)
    # f64: summation order only. ds32: states carry ~1e-7 relative f32
    # force error through 60 steps; the recorded energy adds the f32
    # potential, a few f32 ulps (6e-8 each) apart between the two sums
    for f in ("pos", "vel", "time", "energy", "ang_mom"):
        rtol = 1e-12 if precision == "f64" else (1e-6 if f == "energy" else 1e-7)
        a, b = getattr(out, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=f)
    if precision == "f64":
        assert out.energy_drift == pytest.approx(ref.energy_drift, rel=1e-3, abs=1e-12)
    else:  # both at the f32 potential's noise floor
        assert out.energy_drift < 1e-6 and ref.energy_drift < 1e-6


def test_simulate_defaults_and_unported_inputs(rng):
    _, ts = _scene(rng)
    out = tot.simulate(ts, steps=10, dt=60.0, softening=1e3, device="cpu")
    assert out.final_state.dtype == torch.float64  # f64 on the CPU by default
    assert out.pos.shape == (10, 6, 3)  # ~100 records, capped by the steps
    # a System, an ObjectCollection or a list of Object is compiled (A.10);
    # anything else is refused
    with pytest.raises(TypeError, match="SceneArrays"):
        tot.simulate([1, 2, 3], steps=1, dt=1.0, device="cpu")
    # resolve collisions (ROADMAP A.7b) are ported: the call runs
    res = tot.simulate(ts, steps=1, dt=1.0, device="cpu", collisions="resolve")
    assert res.final_state.alive.all()


def test_cpu_tensors_take_the_plain_paths(rng, monkeypatch):
    """auto: dense at N <= 4096, chunked above on the CPU; the CUDA kernel
    is chosen for CUDA tensors only."""
    from orbital_tpu_torch.ops import cuda_forces

    calls = []

    def spy(*a, **k):
        calls.append(k)
        return cuda_forces.pairwise_acc_plain(*a, **k)

    monkeypatch.setattr(cuda_forces, "pairwise_acc_cuda", spy)
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, chunk=1024)
    pos, _, mass = (torch.from_numpy(a) for a in _cluster(rng, 4100))
    alive = torch.ones(4100, dtype=torch.bool)
    a_auto, U_auto = R.resolve_force_fn(cfg, 4100, "cpu", torch.float64)(pos, mass, alive)
    a_ch, U_ch = tot.ops.forces.pairwise_acc_chunked(pos, mass, alive, G=1.0, eps2=1e-4,
                                                     chunk=1024)
    np.testing.assert_array_equal(a_auto.numpy(), a_ch.numpy())
    assert not calls
    small = R.resolve_force_fn(cfg, 64, "cuda")
    small(pos[:64], mass[:64], alive[:64])
    assert not calls  # dense at N <= 4096 on any device
    big = R.resolve_force_fn(cfg.replace(track_potential=False), 4100, "cuda")
    big(pos.float(), mass.float(), alive)
    assert calls == [dict(G=1.0, eps2=1e-4, with_potential=False)]
    R.resolve_force_fn(cfg.replace(force_impl="pallas"), 64, "cpu")(pos[:64], mass[:64],
                                                                      alive[:64])
    assert len(calls) == 2  # "pallas" names the kernel at any N


@pytest.mark.parametrize("impl,item", [("tree", "A.13"), ("ring", "A.15")])
def test_unported_force_paths_raise(impl, item):
    """The ring (A.15, ported in A.15a) is built by
    ``parallel.sharded.make_sharded_step`` and cannot be resolved from a
    config: ``resolve_force_fn`` raises the JAX package's ``ValueError``
    (orbital_tpu/engine/rollout.py:142-148), where it raised
    ``NotImplementedError`` naming A.15 before. The tree with SimConfig's
    defaults (near="cells", capacity 48; A.13 once raised here) now resolves
    and evaluates as the JAX package's does (levels 3 to keep JAX's program
    small; a cluster of 512, a few dead): acc within 2e-6 RMS|a| (+ 1e-6
    |a|, f32 sums in another order) and U within rel 1e-6, overflows
    equal."""
    cfg = tot.SimConfig(dt=1.0, force_impl=impl)
    if impl == "ring":
        with pytest.raises(ValueError, match="make_sharded_step .it needs a Mesh"):
            R.resolve_force_fn(cfg, 8192, "cpu")
        with pytest.raises(ValueError, match="make_sharded_step"):
            jrollout.resolve_force_fn(jot.SimConfig(dt=1.0, force_impl=impl), 8192)
        return
    from orbital_tpu.ops.tree import tree_acc_potential as jax_tree

    pos, _, mass = _cluster(np.random.default_rng(13), 512)
    alive = np.ones(512, bool)
    alive[::9] = False
    cfg = cfg.replace(eps2=1e-4, tree_levels=3)
    acc, U = R.resolve_force_fn(cfg, 512, "cpu")(*(torch.from_numpy(x) for x in
                                                   (pos, mass, alive)))
    ja, jU, jov = jax_tree(pos, mass, alive, G_grav=1.0, eps2=1e-4, levels=3,
                           near=cfg.tree_near, capacity=cfg.tree_capacity)
    _, _, ov = tot.tree_acc_potential(*(torch.from_numpy(x) for x in (pos, mass, alive)),
                                      G_grav=1.0, eps2=1e-4, levels=3)
    ja = np.asarray(ja)
    rms = float(np.sqrt(np.mean(np.sum(ja.astype(np.float64) ** 2, -1))))
    assert acc.dtype == torch.float64 and int(ov) == int(jov)
    np.testing.assert_allclose(acc.numpy(), ja, rtol=1e-6, atol=2e-6 * rms)
    assert float(U) == pytest.approx(float(jU), rel=1e-6)


def test_f64_on_cuda_raises(monkeypatch):
    """f64 state on CUDA above 4,096 bodies takes B1 under "auto", as the
    JAX package routes it (this raised before f64 opened on the card); the
    wrapper, spied here, gets the f64 tensors and casts them itself."""
    from orbital_tpu_torch.ops import cuda_forces

    seen = []
    monkeypatch.setattr(cuda_forces, "pairwise_acc_cuda",
                        lambda pos, *a, **k: seen.append(pos.dtype))
    R.resolve_force_fn(tot.SimConfig(dt=1.0), 8192, "cuda", torch.float64)(
        torch.zeros((8192, 3), dtype=torch.float64), None, None)
    assert seen == [torch.float64]


@pytest.mark.parametrize("change,item", [
    (dict(integrator="hermite", collisions="resolve"), "A.7b"),
    (dict(integrator="respa", respa_rc=0.1, respa_cell=0.2, collisions="resolve"), "A.7b"),
    (dict(integrator="euler", collisions="resolve"), "A.7b"),
    (dict(collisions="resolve"), "A.7b")])
def test_unported_steppers_raise(rng, change, item):
    """These steppers raised naming ROADMAP item ``item`` until resolve
    collisions were ported: they run now (RESPA through respa_rollout),
    and the routing keeps no table of unported paths (its last entry, the
    ring, went with A.15a), so none names the item."""
    pos, vel, mass = _cluster(rng, 16)
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, **change)
    st = tot.init_forces(tot.make_state(pos, vel, mass, device="cpu"), cfg)
    if cfg.integrator == "respa":
        from orbital_tpu_torch.engine.multirate import respa_rollout

        cfg = cfg.replace(respa_chunk=8, respa_rj=16, respa_max_chunks=16, respa_w_blk=4,
                          respa_m=8)
        fin = respa_rollout(st, cfg, 2 * cfg.respa_k)[0]
    else:
        fin, _ = tot.rollout(st, cfg, 2)
    assert bool(torch.isfinite(fin.pos).all()) and int(fin.step) > 0
    assert "_NOT_PORTED" not in vars(R)


def test_import_leaves_jax_out():
    code = ("import sys, importlib, pkgutil, orbital_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'orbital_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'orbital_tpu'))\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith('orbital_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 18  # every module of the slice was imported


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py must fail, and print no result, where there is no GPU."""
    from pathlib import Path

    root = Path(__file__).parents[1]
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=str(root))
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert torch.cuda.is_available() or "CUDA is not available" in out.stderr
