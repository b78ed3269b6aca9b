"""The (ensemble x body) mesh of the PyTorch port: multi-axis meshes
(``make_mesh(shape, axis_names)``: a communicator a line of each axis, one
baton over one-card ranks), ``make_sharded_ensemble_step`` with
``shard_ensemble`` / ``gather_ensemble``, against the JAX package's
``make_sharded_ensemble_step`` on a (2 x 4) mesh of conftest's 8 virtual CPU
devices.

Scenes are the JAX tests' (tests/test_parallel.py:256, 543, 760, 851 and
tests/test_pm.py:145): E = 4 members of N = 32 perturbed by a numpy seed
(the same members go to both packages), the ring on the dense block; merge
and resolve at radius 0.12 so that they happen; resolve with the JAX
package's ``jax.random`` draws passed in through ``ops.collisions.
resolve_draws`` (the port's own draws are its own); PM on the smooth cluster
(N = 512, grid 32) with two different members; the tree on two copies of
a 64-body Plummer sphere.

Tolerances, from the JAX tests' own bounds and the errors measured here:
  * steps against JAX's mesh step: rtol 3e-5 / atol 3e-6 on positions and
    velocities (tests/test_parallel.py:256; f32 ring sums in other orders),
    potential rtol 1e-4; alive masks equal;
  * each member against the port's own single-device step: the same;
  * PM: rtol 1e-5 / atol 1e-7 (tests/test_pm.py:145); the tree: rtol 1e-6 /
    atol 1e-7 (tests/test_parallel.py:543).
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine.integrators import make_step_fn as j_make_step_fn
from orbital_tpu.engine.rollout import resolve_force_fn as j_resolve_force_fn
from orbital_tpu.parallel import sharded as jsh
from orbital_tpu.parallel.mesh import make_mesh as j_make_mesh
from orbital_tpu_torch.engine.integrators import make_step_fn
from orbital_tpu_torch.engine.rollout import resolve_force_fn
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.parallel import mesh as tmesh
from orbital_tpu_torch.parallel.ensemble import _member, _stack

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

AXES = ("ensemble", "body")
STEP = dict(rtol=3e-5, atol=3e-6)


def _t_mesh():
    return tot.make_mesh(shape=(2, 4), axis_names=AXES, devices="cpu")


def _j_mesh():
    return j_make_mesh(shape=(2, 4), axis_names=AXES)


def test_multi_axis_mesh():
    """Ranks laid out row-major; each rank's body communicator spans its row
    and its ensemble communicator its column; a rank that raises releases
    every line's barrier; shapes and the 1-D accessors are checked."""
    mesh = _t_mesh()
    assert mesh.shape == {"ensemble": 2, "body": 4} and mesh.size == 8 and mesh.local
    assert mesh.ranks == [(e, b) for e in range(2) for b in range(4)]
    vals = [torch.tensor([float(10 * e + b)]) for e, b in mesh.ranks]
    rows = mesh.run(lambda c, x: (c.rank, c.size, c.psum(x), c.all_gather(x)), vals,
                    axis="body")
    for (e, b), (rank, size, s, g) in zip(mesh.ranks, rows):
        assert (rank, size) == (b, 4) and float(s) == 40 * e + 6
        assert g.tolist() == [10 * e + k for k in range(4)]
    cols = mesh.run(lambda c, x: c.ppermute([x])[0], vals, axis="ensemble")
    for (e, b), got in zip(mesh.ranks, cols):
        assert float(got) == 10 * ((e - 1) % 2) + b
    with pytest.raises(ValueError, match="axis_comms"):
        mesh.comms
    assert tot.make_mesh(shape=(4,), devices="cpu").ranks == [0, 1, 2, 3]

    def fail_one(c, x):
        if c.rank == 1 and float(x) >= 10:
            raise RuntimeError("rank (1, 1) fails")
        return c.psum(x)
    with pytest.raises(RuntimeError, match="rank"):
        mesh.run(fail_one, vals, axis="body")
    # the mesh works again after the failure
    assert float(mesh.run(lambda c, x: c.psum(x), vals, axis="body")[0]) == 6
    with pytest.raises(ValueError, match="shape"):
        tot.make_mesh(shape=(2, 4), axis_names=("body",), devices="cpu")
    with pytest.raises(ValueError, match="shape required"):
        tot.make_mesh(axis_names=AXES, devices="cpu")
    assert isinstance(mesh.axis_comms("body")[0]._slots.baton, type(threading.Lock()))
    assert mesh.axis_comms("body")[0]._slots.baton is mesh.axis_comms("ensemble")[5]._slots.baton
    assert tmesh._lines((2, 4), 1) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert tmesh._lines((2, 4), 0) == [[0, 4], [1, 5], [2, 6], [3, 7]]


def _members(n=32, E=4, seed=0, scale=1.0, vscale=0.1, radius=None, sigma=1e-3,
             heavy=1.0):
    """E perturbed copies of a Gaussian cluster (numpy), body 0's mass
    ``heavy`` times its draw; with ``radius``, body 17 planted 0.05 from
    body 0 (touching, in another body shard)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * scale
    vel = rng.normal(size=(n, 3)) * vscale
    mass = rng.uniform(0.5, 1.5, n) / n
    mass[0] *= heavy
    if radius is not None:
        pos[17] = pos[0] + np.array([0.05, 0.0, 0.0])
    out = []
    for e in range(E):
        out.append((pos + sigma * rng.normal(size=(n, 3)), vel, mass, radius))
    return out


def _batched(members, cfg_j, force_impl="dense"):
    """The JAX batched state (acc and potential from the dense force) and
    the port's, field for field."""
    force = j_resolve_force_fn(cfg_j.replace(force_impl=force_impl), members[0][0].shape[0])
    states = []
    for pos, vel, mass, radius in members:
        s = jot.make_state(pos, vel, mass, radius, precision="f32")
        acc, U = force(s.pos, s.mass, s.alive)
        states.append(s.replace(acc=acc, potential=U))
    js = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    ts = state_from_arrays({k: None if v is None else np.asarray(v) for k, v in fields.items()},
                           device="cpu")
    return js, ts, force


def _run(cfg_j, js, ts, steps):
    jmesh = _j_mesh()
    jstep, shardings = jsh.make_sharded_ensemble_step(cfg_j, jmesh, js)
    jout = jax.device_put(js, shardings)
    for _ in range(steps):
        jout = jstep(jout)
    mesh = _t_mesh()
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg_j))
    step, place = tot.make_sharded_ensemble_step(tcfg, mesh, ts)
    shards = place(ts)
    for _ in range(steps):
        shards = step(shards)
    return jout, tot.gather_ensemble(mesh, shards), tcfg


def _assert_members(out, ref, alive):
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out, f).numpy()[alive],
                                   np.asarray(getattr(ref, f))[alive], err_msg=f, **STEP)


@pytest.mark.parametrize("mode", ["none", "bounce", "merge", "resolve"])
def test_ensemble_step_matches_jax(mode, monkeypatch):
    """The mesh step over (2 x 4) ranks against JAX's, 2 steps without
    collisions, 3 with bounce, merge and resolve (every step ungated, as
    under JAX's vmap); each member also against the port's single-device
    step of its own."""
    radius = {"none": None, "bounce": np.full(32, 0.12)}.get(mode, np.full(32, 0.12))
    # resolve: an absorb-branch pair somewhere (tests/test_parallel.py:863)
    members = _members(radius=radius, scale=0.6 if mode != "none" else 1.0,
                       vscale=0.2 if mode != "none" else 0.1, seed=3,
                       heavy=60.0 if mode == "resolve" else 1.0)
    if mode == "resolve":
        def jax_draws(frag_seed, step, T, B, K, *, dtype, device):
            key = jax.random.fold_in(jax.random.PRNGKey(frag_seed), int(step))
            u = torch.from_numpy(np.array(jax.random.uniform(key, (T, T), dtype=np.float32)))
            return u.to(dtype), None
        monkeypatch.setattr(tcoll, "resolve_draws", jax_draws)
    cfg = jot.SimConfig(dt=1e-3 if mode == "none" else 1e-2, G=1.0, eps2=1e-4,
                        collisions=mode, restitution=0.5, frag_seed=11)
    js, ts, _ = _batched(members, cfg)
    steps = 2 if mode == "none" else 3
    jout, out, tcfg = _run(cfg, js, ts, steps)
    alive = np.asarray(jout.alive)
    np.testing.assert_array_equal(out.alive.numpy(), alive)
    _assert_members(out, jout, alive)
    np.testing.assert_allclose(out.potential.numpy(), np.asarray(jout.potential), rtol=1e-4)
    assert out.step.tolist() == [steps] * 4
    if mode in ("merge", "resolve"):
        assert not alive.all()  # not a vacuous test
    # each member against the port's own single-device steps
    one_cfg = tcfg.replace(force_impl="dense")
    one = make_step_fn(one_cfg, resolve_force_fn(one_cfg, 32, "cpu"))
    for e in range(4):
        s = _member(ts, e)
        for _ in range(steps):
            s = one(s)
        np.testing.assert_array_equal(s.alive.numpy(), out.alive[e].numpy())
        np.testing.assert_allclose(out.pos[e].numpy()[alive[e]], s.pos.numpy()[alive[e]],
                                   **STEP)


def test_pm_ensemble_mesh_matches_jax():
    """tests/test_pm.py:145 mirrored: PM under the (2 x 4) mesh, the cube
    agreed by pmin/pmax in each member's body line and one grid psum a
    member; member 1 perturbed (scaled positions, halved velocities) so that
    a mix-up of members would show."""
    rng = np.random.default_rng(9)
    n = 512
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    cfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=0.09, force_impl="pm", pm_grid=32)
    members = [(pos, vel, mass, None), (pos * np.float32(1.05), vel * 0.5, mass, None)]
    js, ts, _ = _batched(members, cfg, force_impl="pm")
    jmesh = _j_mesh()
    jstep, shardings = jsh.make_sharded_ensemble_step(cfg, jmesh, js)
    jout = jstep(jax.device_put(js, shardings))
    mesh = _t_mesh()
    step, place = tot.make_sharded_ensemble_step(tot.SimConfig(**dataclasses.asdict(cfg)),
                                                 mesh, ts)
    out = tot.gather_ensemble(mesh, step(place(ts)))
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos), rtol=1e-5, atol=1e-7)
    j_one = j_make_step_fn(cfg, j_resolve_force_fn(cfg, n))
    for e in range(2):
        ref = j_one(jax.tree_util.tree_map(lambda x: x[e], js))
        np.testing.assert_allclose(out.pos[e].numpy(), np.asarray(ref.pos), rtol=1e-5,
                                   atol=1e-7)


def test_tree_ensemble_mesh_matches_single_device():
    """tests/test_parallel.py:543 mirrored: two copies of a 64-body Plummer
    sphere stepped over the (2 x 4) mesh on the sharded tree (each member's
    body line gathers, splits the near lists and psums) against the JAX
    package's single-device tree step."""
    from orbital_tpu.ops.tree import tree_occupancy_probe

    rng = np.random.default_rng(2)
    n = 64
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    pos = r[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
    vel, mass = 0.05 * rng.normal(size=(n, 3)), np.full(n, 1.0 / n)
    st = jot.make_state(pos, vel, mass, precision="f32")
    occ, ncells = tree_occupancy_probe(st.pos, st.alive, levels=3)
    cfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-3, force_impl="tree", tree_levels=3,
                        tree_capacity=max(16, -(-int(occ) // 8) * 8),
                        tree_max_cells=-(-int(ncells) // 64) * 64)
    st = jot.init_forces(st, cfg)
    ref = j_make_step_fn(cfg, j_resolve_force_fn(cfg, n))(st)
    fields = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    one = state_from_arrays({k: None if v is None else np.asarray(v)
                             for k, v in fields.items()}, device="cpu")
    ts = _stack([one, one])
    mesh = _t_mesh()
    step, place = tot.make_sharded_ensemble_step(tot.SimConfig(**dataclasses.asdict(cfg)),
                                                 mesh, ts)
    out = tot.gather_ensemble(mesh, step(place(ts)))
    for e in range(2):
        np.testing.assert_allclose(out.pos[e].numpy(), np.asarray(ref.pos), rtol=1e-6,
                                   atol=1e-7)


def test_ensemble_contract():
    """Members and bodies must divide across the mesh; Hermite and RESPA
    have no mesh step; a 1-D mesh has no ensemble axis."""
    ts = _batched(_members(n=30, E=4), jot.SimConfig(dt=1e-3, eps2=1e-4))[1]
    mesh = _t_mesh()
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4)
    with pytest.raises(ValueError, match="divide across 4 shards"):
        tot.make_sharded_ensemble_step(cfg, mesh, ts)
    ts = _batched(_members(n=32, E=3), jot.SimConfig(dt=1e-3, eps2=1e-4))[1]
    with pytest.raises(ValueError, match="3 members x 32 bodies"):
        tot.shard_ensemble(mesh, ts)
    with pytest.raises(NotImplementedError, match="accel_jerk_fn"):
        tot.make_sharded_ensemble_step(cfg.replace(integrator="hermite"), mesh, ts)
    with pytest.raises(KeyError):
        tot.shard_ensemble(tot.make_mesh(shape=(4,), devices="cpu"), ts)
