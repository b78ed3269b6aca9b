"""Merge collisions of the PyTorch port against the JAX package's: the root
search (dense, column-blocked, and the CUDA wrapper's plain version),
``merge_groups``, the gated steppers (kdk, yoshida4, Hermite, the block
stepper and RESPA) on the JAX package's own merge scenes and on a small
scene with chains, and the routing.

Inputs come from a numpy seed and go to both packages. Tolerances:
  * roots, parents and ``alive``: equal (integers).
  * ``merge_groups`` in f64: mass, pos, vel and radius within rtol 1e-14
    (JAX's ``segment_sum`` and the port's ``segment_reduce`` add each group
    in member order on the CPU; ``jnp.cbrt`` against ``pow(x, 1/3)``); in
    f32 within 4 ulps (rtol 2.4e-7, the cube root the only difference).
  * f64 rollouts: rtol 1e-12 / atol 1e-13 (summation order only); merged
    bodies equal in alive, mass and radius.
  * the f32 gated merge scene of tests/test_pallas_forces.py: atol 1e-6 (f32
    state of O(1), XLA:CPU contracting multiply-adds the port rounds).
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
from orbital_tpu.engine import multirate as jmr
from orbital_tpu.ops import collisions as jcoll
from orbital_tpu.ops import neighbor as jn
from orbital_tpu_torch.engine import integrators as I
from orbital_tpu_torch.engine import multirate as tmr
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.ops import cuda_collisions

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F64_TOL = dict(rtol=1e-12, atol=1e-13)
_j_merge = jax.jit(jcoll.merge_groups, static_argnames=("chunk",))
_j_roots = jax.jit(jcoll.collision_roots)
_j_roots_chunked = jax.jit(jcoll.collision_roots_chunked, static_argnames=("chunk",))


def _chain_scene(dtype=np.float64, n=96, seed=5):
    """Bodies in a unit box with radii that make a few contact chains, plus
    two planted chains of four: one in index order (12, 25, 33, 44: each
    body's parent is the one before, so the root is reached transitively)
    and one out of order (40, 7, 63, 21: body 21 touches only 63 > 21, so
    JAX's parent rule leaves it a root of its own); two coincident live
    bodies (dist 0 never touches), dead bodies inside the contact range and a
    massless live tracer touching a body."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = rng.uniform(0.02, 0.06, n)
    alive = np.ones(n, bool)
    base = np.array([2.0, 2.0, 2.0])
    for row, chain in enumerate(((12, 25, 33, 44), (40, 7, 63, 21))):
        for k, j in enumerate(chain):
            pos[j] = base + [0.09 * k, 0.5 * row, 0.0]
            radius[j] = 0.05
    pos[11] = pos[30] = [3.0, 3.0, 3.0]          # coincident
    radius[11] = radius[30] = 0.01
    alive[[5, 17, 50]] = False                    # dead, one touching the chain
    pos[50] = base + [0.02, 0.0, 0.0]
    mass[77] = 0.0                                # a massless tracer on body 78
    pos[77] = pos[78] + [0.01, 0.0, 0.0]
    return [a.astype(dtype) for a in (pos, vel, mass, radius)] + [alive]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_roots_match_jax(dtype):
    """Dense and column-blocked roots (and the CUDA wrapper's plain version,
    at every chunk) integer-equal to JAX's on chains, coincident, dead and
    massless bodies; the planted chain shares one root, its lowest index."""
    pos, _, _, radius, alive = _chain_scene(dtype)
    ref = np.asarray(_j_roots(pos, radius, alive))
    assert ref[[12, 25, 33, 44]].tolist() == [12] * 4
    assert ref[[7, 40, 63]].tolist() == [7] * 3 and ref[21] == 21
    assert ref[11] == 11 and ref[30] == 30 and ref[50] == 50 and ref[78] == 77
    assert len(set(ref.tolist())) < len(ref) - 4
    tp, tr, ta = _t(pos, radius, alive)
    np.testing.assert_array_equal(tcoll.collision_roots(tp, tr, ta).numpy(), ref)
    for chunk in (512, 96, 64, 40, 7):
        np.testing.assert_array_equal(
            np.asarray(_j_roots_chunked(pos, radius, alive, chunk=chunk)), ref)
        np.testing.assert_array_equal(
            tcoll.collision_roots_chunked(tp, tr, ta, chunk=chunk).numpy(), ref)
        np.testing.assert_array_equal(
            cuda_collisions.collision_roots_plain(tp, tr, ta, chunk=chunk).numpy(), ref)


@pytest.mark.parametrize("count,expect", [(0, "identity"), (3, "roots")])
def test_roots_cuda_plain_path_gated(count, expect):
    """On CPU tensors the CUDA wrapper runs the plain column-blocked search,
    gated by the device-held count as the kernel is: identity at 0."""
    pos, _, _, radius, alive = _chain_scene(np.float32)
    tp, tr, ta = _t(pos, radius, alive)
    c = torch.tensor(count, dtype=torch.int32)
    root = cuda_collisions.collision_roots_cuda(tp, tr, ta, contacts=c)
    parent = cuda_collisions.collision_parents_cuda(tp, tr, ta, contacts=c)
    want = (np.arange(len(pos)) if expect == "identity"
            else np.asarray(_j_roots(pos, radius, alive)))
    np.testing.assert_array_equal(root.numpy(), want)
    assert bool((parent <= torch.arange(len(pos))).all())
    assert cuda_collisions.collision_roots_cuda.launches == 0  # CPU: no launch


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("chunk", [None, 32])
def test_merge_groups_matches_jax(dtype, chunk):
    pos, vel, mass, radius, alive = _chain_scene(dtype)
    ref = [np.asarray(x) for x in _j_merge(pos, vel, mass, radius, alive, chunk=chunk)]
    out = [x.numpy() for x in tcoll.merge_groups(*_t(pos, vel, mass, radius, alive),
                                                 chunk=chunk)]
    np.testing.assert_array_equal(out[4], ref[4])
    assert (~ref[4]).sum() > 3 + (~alive).sum()  # merges happened
    rtol = 1e-14 if dtype == np.float64 else 4 * 2.0 ** -24
    for k, name in enumerate(("pos", "vel", "mass", "radius")):
        np.testing.assert_allclose(out[k], ref[k], rtol=rtol, atol=0, err_msg=name)
    # conserved: mass, momentum and the mass-weighted centre
    m0, m1 = mass.astype(np.float64), out[2].astype(np.float64)
    tol = 1e-13 if dtype == np.float64 else 1e-6
    assert abs(m1.sum() - m0.sum()) < tol
    np.testing.assert_allclose((m1[:, None] * out[1]).sum(0), (m0[:, None] * vel).sum(0),
                               atol=tol)
    absorbed = alive & ~out[4]
    assert (out[2][absorbed] == 0).all() and (out[3][absorbed] == 0).all()
    assert (np.abs(out[0][absorbed]) > 1e8).all()


def test_merge_given_roots_and_noop():
    """``root=`` takes the roots from elsewhere (the kernel's on the card);
    identity roots leave every input as it was, bit for bit."""
    pos, vel, mass, radius, alive = _t(*_chain_scene(np.float32))
    roots = tcoll.collision_roots(pos, radius, alive)
    a = tcoll.merge_groups(pos, vel, mass, radius, alive)
    b = tcoll.merge_groups(pos, vel, mass, radius, alive, root=roots)
    ident = tcoll.merge_groups(pos, vel, mass, radius, alive, root=torch.arange(len(pos)))
    for x, y, z in zip(a, b, ident):
        assert torch.equal(x, y)
    for x, z in zip((pos, vel, mass, radius, alive), ident):
        assert torch.equal(x, z)


def test_chunked_route_above_4096_equals_dense():
    """On CPU tensors the stepper's root search is dense at N <= 4096 and
    column-blocked (chunk 1024) above; both give the same roots."""
    rng = np.random.default_rng(3)
    n = 4160
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    radius = np.full(n, 0.012, np.float32)
    alive = rng.uniform(size=n) > 0.05
    tp, tr, ta = _t(pos, radius, alive)
    dense = tcoll.collision_roots(tp, tr, ta)
    chunked = I.resolve_roots_fn(n, "cpu")(tp, tr, ta, None)
    assert torch.equal(chunked, dense) and int((dense != torch.arange(n)).sum()) > 50
    assert torch.equal(I.resolve_roots_fn(4096, "cpu")(tp[:4096], tr[:4096], ta[:4096], None),
                       tcoll.collision_roots(tp[:4096], tr[:4096], ta[:4096]))


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def _assert_final(tf, jf, tol=F64_TOL):
    np.testing.assert_array_equal(tf.alive.numpy(), np.asarray(jf.alive))
    for f in ("pos", "vel", "mass", "radius", "acc"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                   err_msg=f, **tol)
    assert int(tf.step) == int(jf.step)


@pytest.mark.parametrize("integrator", ["kdk", "hermite"])
def test_two_body_merge_matches_jax(integrator):
    """tests/test_engine_core.py:489 and :524: two spheres approach and
    merge into body 0 (mass 5, momentum conserved)."""
    pos = np.array([[0.0, 0, 0], [5.0, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    cfg = jot.SimConfig(dt=0.05, G=1e-20, collisions="merge", integrator=integrator)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="f64"), cfg)
    jf, jt = jot.rollout_jit(js, cfg, 200, record_every=50)
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg))
    tf, tt = tot.rollout(tot.init_forces(_port_state(js), tcfg), tcfg, 200, record_every=50)
    assert tf.alive.tolist() == [True, False] and float(tf.mass[0]) == 5.0
    np.testing.assert_allclose(tf.vel[0].numpy(), [(2 - 3) / 5.0, 0, 0], atol=1e-12)
    _assert_final(tf, jf)
    np.testing.assert_array_equal(tt.alive.numpy(), np.asarray(jt.alive))


def test_gated_f32_merge_matches_jax():
    """tests/test_pallas_forces.py:378: merge through the fused gate in f32:
    body 1 merges into 0, parks far, and the state stays stable after."""
    pos = np.array([[-0.5, 0, 0], [0.5, 0, 0], [0, 8.0, 0]])
    vel = np.array([[0.2, 0, 0], [-0.2, 0, 0], [0, 0, 0]])
    mass = np.array([2.0, 1.0, 1e-3])
    radius = np.array([0.2, 0.2, 0.01])
    cfg = jot.SimConfig(dt=0.1, G=1e-6, eps2=1e-8, collisions="merge", force_impl="dense")
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="f32"), cfg)
    jf, _ = jot.rollout_jit(js, cfg, 60)
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg))
    tf, _ = tot.rollout(_port_state(js), tcfg, 60)
    assert tf.alive.tolist() == [True, False, True]
    assert float(tf.mass[0]) == pytest.approx(3.0) and float(tf.pos[1].norm()) > 1e6
    _assert_final(tf, jf, dict(rtol=0, atol=1e-6))


def _merge_cluster(n=64, seed=9):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 0.5
    vel = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass, np.full(n, 0.08)


@pytest.mark.parametrize("integrator,extra", [
    ("kdk", {}), ("yoshida4", {}), ("hermite", {}),
    ("hermite", dict(hermite_fast_cap=8, adaptive_eta=0.02, dt_min=1e-6,
                     hermite_max_substeps=8))])
def test_merge_steppers_match_jax(integrator, extra):
    """f64 rollouts with merges under each stepper, gated on the closing
    evaluation's count (the block stepper at its macro boundaries)."""
    pos, vel, mass, radius = _merge_cluster()
    cfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, collisions="merge",
                        integrator=integrator, **extra)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="f64"), cfg)
    jf, _ = jot.rollout_jit(js, cfg, 12)
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg))
    tf, _ = tot.rollout(_port_state(js), tcfg, 12)
    assert int((~tf.alive).sum()) >= 2
    _assert_final(tf, jf)
    if integrator == "hermite":
        np.testing.assert_allclose(tf.jerk.numpy(), np.asarray(jf.jerk), **F64_TOL)


def test_respa_merge_matches_jax():
    """RESPA with merges at the macro boundaries (the geometry rebuilt every
    window, as collisions require, with the parked bodies dead in it): the
    state and every counter equal to JAX's."""
    pos, vel, mass, radius = _merge_cluster()
    chunk, rj = 8, 16
    m, k_ch, w_blk, q = jn.neighbor_budgets(pos, cell=0.6, chunk=chunk, rj=rj, with_wl=True)
    cfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa", respa_k=4,
                        respa_rc=0.3, respa_cell=0.6, respa_m=m, respa_max_chunks=k_ch,
                        respa_w_blk=w_blk, respa_chunk=chunk, respa_rj=rj,
                        respa_wl_entries=q, collisions="merge")
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="f64"), cfg)
    jf, _, jd = jmr.respa_rollout_jit(js, cfg, 16)
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg))
    tf, _, td = tmr.respa_rollout(_port_state(js), tcfg, 16)
    assert int((~tf.alive).sum()) >= 2
    _assert_final(tf, jf, dict(rtol=1e-11, atol=1e-12))
    for k in jd:
        assert int(td[k]) == int(jd[k]), k


def test_merge_gate_bit_equal_when_nothing_touches():
    """A merge-armed run whose bodies never touch is bit-equal to the
    collision-free run (ds32: the lo words kept, as at a count of 0 on the
    card)."""
    pos, vel, mass, _ = _merge_cluster(n=64, seed=2)
    st = tot.init_forces(tot.make_state(pos, vel, mass, np.full(64, 1e-6), precision="ds32",
                                        device="cpu"), tot.SimConfig(dt=1e-3, eps2=1e-4))
    a, _ = tot.rollout(st, tot.SimConfig(dt=1e-3, eps2=1e-4, collisions="merge"), 10)
    b, _ = tot.rollout(st, tot.SimConfig(dt=1e-3, eps2=1e-4), 10)
    for f in ("pos", "pos_lo", "vel", "vel_lo", "mass", "radius", "alive"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_simulate_merge_matches_jax():
    from orbital_tpu.models.scene import SceneArrays as JScene
    from orbital_tpu_torch.models.scene import SceneArrays as TScene

    pos, vel, mass, radius = _merge_cluster()
    names = [f"b{i}" for i in range(len(mass))]
    kw = dict(steps=10, dt=1e-3, softening=1e-2, collisions="merge", precision="f64",
              record_every=5)
    ref = jot.simulate(JScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names), **kw)
    got = tot.simulate(TScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names),
                       device="cpu", **kw)
    alive = got.final_state.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(ref.final_state.alive))
    assert (~alive).sum() >= 2
    np.testing.assert_allclose(got.pos, np.asarray(ref.pos), **F64_TOL)


def test_merge_routing(monkeypatch):
    """CUDA device names route the root search to the kernel's wrapper with
    the contact count; CPU ones dense at N <= 4096 and column-blocked above;
    resolve, which raised naming A.7b before it was ported, runs."""
    calls = []
    monkeypatch.setattr(cuda_collisions, "collision_roots_cuda",
                        lambda pos, radius, alive, contacts=None: calls.append(contacts))
    I.resolve_roots_fn(8, "cuda")(None, None, None, "count")
    assert calls == ["count"]
    monkeypatch.setattr(tcoll, "collision_roots", lambda *a: "dense")
    monkeypatch.setattr(tcoll, "collision_roots_chunked", lambda *a, chunk: ("chunked", chunk))
    assert I.resolve_roots_fn(4096, "cpu")(None, None, None, None) == "dense"
    assert I.resolve_roots_fn(8192, "cpu")(None, None, None, None) == ("chunked", 1024)
    st = tot.make_state(*_merge_cluster(n=8)[:3], device="cpu")
    for change in (dict(collisions="resolve"),
                   dict(collisions="resolve", integrator="hermite")):
        cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, **change)
        fin, _ = R.rollout(tot.init_forces(st, cfg), cfg, 1)
        assert int(fin.step) == 1


def test_roots_wrapper_refuses_other_devices():
    z = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_collisions.collision_roots_cuda(z, z[:, 0])
