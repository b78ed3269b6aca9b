"""P3M's body-sharded ring in the PyTorch port (``ops.p3m.p3m_ring_force``,
the two-table short-range sum, ``make_sharded_step`` and ``simulate(mesh=)``
with ``force_impl="p3m"``) against the JAX package's ``p3m_ring_force`` and
sharded step on conftest's 8 virtual CPU devices.

The port runs on one-card meshes of CPU ranks (threads); one test runs the
ring in 2 gloo processes (``tests/torch_dist_worker.py``) and requires it
bit-equal to the one-card mesh at 2 ranks. Inputs come from a numpy seed and
go to both packages. Sizes: the JAX package's uniform box (tests/test_p3m.py,
N = 2,048 in [-1, 1]^3 at grid 64; N = 1,024 at grid 32 over 8 ranks), every
third body dead and parked far, ``capacity`` from ``p3m_max_occupancy`` on
the whole set (the ring returns no overflow, as in the JAX package).

Tolerances, from the errors measured on these scenes:
  * the ring's acc against JAX's: max |da| <= 2e-5 max |a| (measured 1.8e-6
    to 3.2e-6: f32 FFTs and pair sums in other orders, as in
    tests/test_torch_p3m.py), U to rel 1e-6 (measured <= 1.5e-7);
  * against the port's single-card ``p3m_acc_potential``: the same bounds
    (measured <= 1.2e-6: the psum'd grid and the rounds' partial sums);
  * the two-table plain sum of one table against itself: bit-equal to the
    single-table sum; summed over the visiting shards' tables, within
    1e-6 of max |a| (f32 sums of the same pairs in rounds);
  * the sharded KDK step against JAX's: positions and velocities to the
    JAX test's own rtol 1e-4 / atol 1e-6 (tests/test_p3m.py:85), U rel
    1e-4, the accelerations to the ring's bound above;
  * gloo against the one-card mesh: equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine.state import far_positions
from orbital_tpu.ops import p3m as jp3m
from orbital_tpu.parallel import sharded as jsh
from orbital_tpu.parallel.mesh import make_mesh as j_make_mesh
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import cuda_p3m
from orbital_tpu_torch.ops import p3m as tp3m

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ACC_RTOL, U_RTOL = 2e-5, 1e-6
BOX = (np.array([0.1, -0.1, 0.0], np.float32), np.float32(1.5))
HERE = Path(__file__).resolve().parent
# the plain sum's cells a block: every cell of the grid in one block keeps
# the CPU's Python loop short (each body sits in one slot, so the blocking
# does not change the sums)
CELLS = 1024


def _uniform(n=2048, seed=4, dead=True):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    alive = np.ones(n, bool)
    if dead:
        alive[::3] = False
        pos[~alive] = far_positions(int((~alive).sum()), 1.0, np.float32)
    return pos, mass, alive


def _t(*xs):
    return tuple(None if x is None else torch.as_tensor(x) for x in xs)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _capacity(pos, alive, grid, box):
    return tp3m.p3m_max_occupancy(*_t(pos, alive), grid=grid,
                                  box=None if box is None else _t(*box))


def _j_ring(p, box, **kw):
    mesh = j_make_mesh(shape=(p,), devices=jax.devices()[:p])
    jbox = None if box is None else (jnp.asarray(box[0]), jnp.asarray(box[1]))
    return jax.jit(jax.shard_map(
        lambda x, m, a: jp3m.p3m_ring_force(x, m, a, axis_name="body", n_shards=p, box=jbox,
                                            **kw),
        mesh=mesh, in_specs=(JP("body", None), JP("body"), JP("body")),
        out_specs=(JP("body", None), JP())))


def _t_ring(p, pos, mass, alive, box, **kw):
    mesh = tot.make_mesh(shape=(p,), devices="cpu")
    tbox = None if box is None else _t(*box)

    def cut(x):
        return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(p))
    out = mesh.run(lambda c, x, m, a: tp3m.p3m_ring_force(x, m, a, comm=c, box=tbox,
                                                          cell_block=CELLS, **kw),
                   cut(pos), cut(mass), cut(alive))
    return torch.cat([o[0] for o in out]).numpy(), float(out[0][1])


@pytest.mark.parametrize("p,grid,n,box", [(1, 64, 2048, BOX), (2, 64, 2048, None),
                                          (4, 64, 2048, BOX), (8, 32, 1024, BOX)])
def test_ring_force_matches_jax(p, grid, n, box):
    """The ring at 1, 2, 4 and 8 ranks against JAX's, pinned box and the
    cube agreed by pmin/pmax, and against the port's single-card solve."""
    pos, mass, alive = _uniform(n)
    kw = dict(G_grav=1.0, eps2=1e-4, grid=grid, capacity=_capacity(pos, alive, grid, box),
              with_potential=True)
    ja, jU = _j_ring(p, box, **kw)(jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive))
    ta, tU = _t_ring(p, pos, mass, alive, box, **kw)
    assert _rel(ta, ja) <= ACC_RTOL
    assert abs(tU - float(jU)) <= U_RTOL * abs(float(jU))
    a1, U1, ov = tp3m.p3m_acc_potential(*_t(pos, mass, alive), box=None if box is None
                                        else _t(*box), cell_block=CELLS, **kw)
    assert int(ov) == 0
    assert _rel(ta, a1.numpy()) <= ACC_RTOL
    assert abs(tU - float(U1)) <= U_RTOL * abs(float(U1))
    assert np.all(ta[~alive] == 0.0)


def test_pair_sum_plain_and_wrapper():
    """The two-table form: one table against itself is the single-table sum
    bit for bit; this shard's table against each shard's table, summed,
    is the whole system's short range for this shard's bodies; the CPU
    wrapper computes the plain version and never counts a launch; the
    diagonal round needs one table and one id vector."""
    pos, mass, alive = _uniform(2048)
    p32, m_eff, al = torch.from_numpy(pos), torch.from_numpy(mass * alive), torch.from_numpy(
        alive)
    center, half = torch.from_numpy(BOX[0]), torch.tensor(BOX[1])
    gc = tp3m._cell_grid(64, 1.5, 4.5)
    h = 2.0 * half / 64
    sigma = 1.5 * h
    kw = dict(gc=gc, G=1.0, sigma=sigma, rcut2=(4.5 * sigma) ** 2, eps2=1e-4,
              cell_block=CELLS)
    cap = _capacity(pos, alive, 64, BOX)

    def table(sl):
        return tp3m.p3m_cell_table(p32[sl], m_eff[sl], al[sl], center, half, gc=gc,
                                   capacity=cap)
    whole = table(slice(None))
    a_ref, pe_ref = tp3m.p3m_short_plain(whole["table"], whole["cell_pos"], whole["cell_m"],
                                         n=2048, **kw)
    gid = torch.arange(2048)
    a_d, pe_d = cuda_p3m.p3m_short_pair_cuda(whole, whole, gid, gid, n=2048, **kw)
    assert torch.equal(a_d, a_ref) and torch.equal(pe_d, pe_ref)
    launches = cuda_p3m.p3m_short_pair_cuda.launches
    shards = [slice(r * 512, (r + 1) * 512) for r in range(4)]
    tabs = [table(sl) for sl in shards]
    gids = [gid[sl] for sl in shards]
    for i in range(4):
        a = pe = 0.0
        for j in range(4):
            a_r, pe_r = cuda_p3m.p3m_short_pair_cuda(tabs[i], tabs[j], gids[i], gids[j],
                                                     n=512, **kw)
            a, pe = a + a_r, pe + pe_r
        assert _rel(a.numpy(), a_ref[shards[i]].numpy()) <= 1e-6
        assert _rel(pe.numpy(), pe_ref[shards[i]].numpy()) <= 1e-6
    assert cuda_p3m.p3m_short_pair_cuda.launches == launches
    with pytest.raises(ValueError, match="diagonal round"):
        cuda_p3m.p3m_short_pair_cuda(tabs[0], tabs[0], gids[0], gids[0].clone(), n=512, **kw)
    meta = {k: v.to("meta") for k, v in tabs[0].items() if torch.is_tensor(v)}
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_p3m.p3m_short_pair_cuda(meta, dict(meta), gids[0], gids[1], n=512, **kw)


def test_view_slice_list_matches_a_count():
    """The plain view (``cuda_p3m.p3m_short_view``, in the kernel's order and
    in the table's): each cell's kept rows one segment of the compact rows
    after the cells before it, the table's rows and body indices there, and
    the slice list equal to a numpy count of each cell's non-empty 32-row
    slices (a dense core puts cells past 32 rows)."""
    pos, mass, alive = _uniform(2048, seed=6)
    pos[:600] *= 0.25
    center, half = _t(*BOX)
    gc = tp3m._cell_grid(64, 1.5, 4.5)
    p32, al = torch.from_numpy(pos), torch.from_numpy(alive)
    cap = _capacity(pos, alive, 64, BOX)
    tab = tp3m.p3m_cell_table(p32, torch.from_numpy(mass) * al, al, center, half, gc=gc,
                              capacity=cap)
    count = tab["count"].numpy().astype(np.int64)
    assert count.max() > 64
    want = [(c << 9) | k for c in range(gc ** 3) for k in range(-(-int(count[c]) // 32))]
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    for reorder in (True, False):
        v = cuda_p3m.p3m_short_view(tab, gc, 2048, torch.arange(2048) + 7, reorder=reorder)
        assert v["slices"].tolist() == want and v["nslices"].tolist() == [len(want), 0, 0]
        off = v["run_off"].numpy()
        assert np.array_equal(off[:, 0], start) and np.array_equal(off[:, -1] - off[:, 0], count)
        assert bool((np.diff(off, axis=1) >= 0).all())
        kept = int(count.sum())
        for c in np.flatnonzero(count)[::7]:
            seg = slice(start[c], start[c] + count[c])
            body = v["body"][seg]
            if not reorder:
                assert torch.equal(body, tab["table"][c, :count[c]])
            assert sorted(body.tolist()) == sorted(tab["table"][c, :count[c]].tolist())
            assert torch.equal(v["rows"][seg, :3], p32[body])
            assert torch.equal(v["gid"][seg], body + 7)
        assert bool((v["body"][kept:] == 2048).all()) and bool((v["gid"][kept:] == -1).all())


@pytest.mark.parametrize("p", [2, 4])
def test_ring_ships_views_equal_to_rebuilding_them(p, monkeypatch):
    """The ring with each shard's view built by its owner and passed round
    (``p3m_ring_force``) against the same ring whose rounds build the
    visitor's table and view again from its bodies, as the ring did before
    views were shipped: equal bit for bit on the plain route; and within
    the ring's tolerances of JAX's ``p3m_ring_force``."""
    pos, mass, alive = _uniform(2048)
    kw = dict(G_grav=1.0, eps2=1e-4, grid=64, capacity=_capacity(pos, alive, 64, BOX),
              with_potential=True)
    ta, tU = _t_ring(p, pos, mass, alive, BOX, **kw)
    ja, jU = _j_ring(p, BOX, **kw)(jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive))
    assert _rel(ta, ja) <= ACC_RTOL
    assert abs(tU - float(jU)) <= U_RTOL * abs(float(jU))
    # the route that rebuilds: each rank's table arguments kept by its first
    # global id, and every visitor's table and view made anew from them
    nloc = 2048 // p
    made, table, view, round_ = {}, tp3m.p3m_cell_table, cuda_p3m.p3m_short_view_cuda, \
        cuda_p3m.p3m_short_round_cuda

    def kept_table(*args, **k):
        tab = table(*args, **k)
        tab["_args"] = (args, k)
        return tab

    def kept_view(tab, gc, n, gid=None):
        made[int(gid[0])] = (tab.pop("_args"), gc, n, gid)
        return view(tab, gc, n, gid)

    def rebuilt(view_i, view_j, **k):
        if view_j is not view_i:
            ids = view_j["gid"]
            (args, tk), gc, n, gid = made[int(ids[ids >= 0].min()) // nloc * nloc]
            view_j = view(table(*args, **tk), gc, n, gid)
        return round_(view_i, view_j, **k)

    monkeypatch.setattr(tp3m, "p3m_cell_table", kept_table)
    monkeypatch.setattr(cuda_p3m, "p3m_short_view_cuda", kept_view)
    monkeypatch.setattr(cuda_p3m, "p3m_short_round_cuda", rebuilt)
    ra, rU = _t_ring(p, pos, mass, alive, BOX, **kw)
    assert len(made) == p
    assert np.array_equal(ra, ta) and rU == tU


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def test_sharded_step_matches_jax():
    """tests/test_p3m.py:85 mirrored: one KDK step of the sharded P3M over
    8 ranks (grid 32, capacity 64) against JAX's sharded step on its 8
    devices, from the same state; the port's step also against its own
    single-card step."""
    rng = np.random.default_rng(7)
    n = 2048
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="p3m", pm_grid=32,
                         p3m_capacity=64)
    js = jot.init_forces(jot.make_state(pos, vel, mass, precision="f32"), jcfg)
    jmesh = j_make_mesh()
    jout = jsh.make_sharded_step(jcfg, jmesh, js)(jsh.shard_state(jmesh, js))
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    ts = _port_state(js)
    mesh = tot.make_mesh(shape=(8,), devices="cpu")
    out = tot.gather_state(mesh, tot.make_sharded_step(tcfg, mesh, ts)(
        tot.shard_state(mesh, ts)))
    one = tot.rollout(ts, tcfg, 1)[0]
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(getattr(out, f).numpy(), getattr(one, f).numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    assert _rel(out.acc.numpy(), jout.acc) <= ACC_RTOL
    assert _rel(out.acc.numpy(), one.acc.numpy()) <= ACC_RTOL
    assert float(out.potential) == pytest.approx(float(jout.potential), rel=1e-4)
    assert int(out.step) == 1


def test_simulate_mesh_p3m_matches_jax():
    """simulate(mesh=, force_impl="p3m") against the JAX package's
    simulate(mesh=) on 4 of its devices: the same auto capacity and pinned
    cube, the records within the f32 step bounds."""
    from orbital_tpu.models.scene import SceneArrays as JScene
    from orbital_tpu_torch.models.scene import SceneArrays

    pos, mass, _ = _uniform(1024, seed=12, dead=False)
    n = len(mass)
    kw = dict(pos=pos.astype(np.float64), vel=np.zeros((n, 3)), mass=mass.astype(np.float64),
              radius=np.zeros(n), names=[f"b{i}" for i in range(n)])
    run = dict(steps=2, dt=1e-3, softening=1e-2, force_impl="p3m", pm_grid=64,
               precision="f32", record_every=1)
    jres = jot.simulate(JScene(**kw, uuids=[f"u{i}" for i in range(n)]),
                        rescale=jot.Rescale.identity(),
                        mesh=j_make_mesh(shape=(4,), devices=jax.devices()[:4]), **run)
    tres = tot.simulate(SceneArrays(**kw), rescale=tot.Rescale.identity(), device="cpu",
                        mesh=tot.make_mesh(shape=(4,), devices="cpu"), **run)
    assert tres.config.p3m_capacity == jres.config.p3m_capacity
    assert tres.config.pm_box == pytest.approx(jres.config.pm_box)
    np.testing.assert_allclose(tres.pos, jres.pos, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tres.energy, jres.energy, rtol=1e-5)
    assert tres.final_state.n_bodies == n


def test_gloo_processes_match_the_one_card_mesh(tmp_path):
    """P3M's ring and the sharded tree (``"kernel"``) in 2 gloo processes
    (``torch_dist_worker.py solvers``) against the one-card mesh at 2
    ranks: equal."""
    sys.path.insert(0, str(HERE))
    import torch_dist_worker as worker

    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_dist_worker.py"), str(store),
                               str(r), str(tmp_path), "solvers"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK {r} OK" in out, out[-3000:]
    got = np.load(tmp_path / "rank0.npz")
    # the workers run torch on one thread: the tree's far-field convolution
    # blocks its sums by thread, so the reference does too
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = worker.run_solvers(tot.make_mesh(shape=(2,), devices="cpu"))
    finally:
        torch.set_num_threads(threads)
    assert set(got.files) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
