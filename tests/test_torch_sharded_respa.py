"""The mesh-sharded multirate (RESPA) stepper of the PyTorch port
(``make_respa_macro(shard=)``, the near sweep's row offset ``i0`` and its
CUDA wrapper's CPU path, ``make_sharded_respa_rollout`` and
``simulate(mesh=, integrator="respa")``) against the JAX package's on
conftest's 8 virtual CPU devices.

The port runs on one-card meshes of CPU ranks (threads). Sizes are the JAX
package's (tests/test_parallel.py:894-960: chunk 8, rj 16, N = 128 and 64,
f64; the near sweep's Pallas kernel in interpret mode at N = 96); inputs
from a numpy seed. The test skins are wide (cell 0.6 against rc 0.3 over a
few windows of velocity 0.3 at dt 1e-3), so that ``skin_violation`` cannot
fire, and the budgets come from the probe, so that ``overflow`` counts only
dead bodies (RESPA counts them, in both packages).

Tolerances, from the errors measured here:
  * the near sweep with ``i0`` against JAX's plain sweep and its Pallas
    B10 kernel: rtol 1e-5 / atol 1e-6 (the JAX package's kernel-vs-sweep
    bound, as tests/test_torch_respa.py holds the unsharded sweep); the
    ranks' slices against the unsliced port sweep: equal (the same rows
    summed the same way);
  * f64 rollouts: positions atol 1e-11 of their scale, velocities 1e-11,
    energies rtol 1e-12 (tests/test_parallel.py:894's own bounds: the
    ring's blocks reorder the closing sum); the diagnostics equal;
  * ds32 with bounce collisions against JAX: atol 1e-6 on positions and
    velocities (f32 ring sums in another order over 16 substeps);
  * simulate(): rtol 1e-9 / atol 1e-11 (tests/test_parallel.py:946).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu.ops import neighbor as jn
from orbital_tpu.ops import neighbor_pallas as jp
from orbital_tpu.parallel import sharded as jsh
from orbital_tpu.parallel.mesh import make_mesh as j_make_mesh
from orbital_tpu_torch.engine import multirate as tmr
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.models.scene import SceneArrays as TScene
from orbital_tpu_torch.ops import cuda_neighbor as cn
from orbital_tpu_torch.ops import neighbor as tn

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

CHUNK, RJ = 8, 16
SWEEP = dict(r1=0.2, rc=0.4, G=1.0, eps2=1e-4, chunk=CHUNK, rj=RJ)
F32 = torch.float32


def _cluster(n, seed, vscale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)), vscale * rng.normal(size=(n, 3)),
            rng.uniform(0.5, 1.5, n) / n)


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


@pytest.fixture(scope="module")
def sweep96():
    """N = 96 with a dead body: the geometry (its chunk budget a multiple of
    8, to divide across 2, 4 and 8 ranks) and packed f32 channels in both
    packages."""
    n, cell = 96, 0.6
    pos, _, mass = _cluster(n, 5)
    alive = np.ones(n, bool)
    alive[40] = False
    m, k_ch, w_blk = tn.neighbor_budgets(pos, alive, cell=cell, chunk=CHUNK, rj=RJ)
    g = tn.neighbor_geometry(torch.tensor(pos, dtype=F32), torch.from_numpy(alive),
                             cell=cell, m_grid=m, chunk=CHUNK, max_chunks=k_ch, w_blk=w_blk,
                             rj=RJ)
    n_slots = (k_ch + RJ) * CHUNK
    m_eff = np.where(alive, mass, 0.0)
    vals = [(pos[:, k], tn.SENTINEL_POS) for k in range(3)] + [(m_eff, 0.0)]
    ch_t = [tn.pack_slots(g["slot"], torch.tensor(v, dtype=F32), n_slots, f) for v, f in vals]
    ch_j = [jnp.asarray(c.numpy()) for c in ch_t]
    return dict(k_ch=k_ch, jbl=g["jbl"], ch_t=ch_t, ch_j=ch_j)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_near_sweep_offset_matches_jax(sweep96, parts):
    """Each rank's rows (``i0 = rank * K_ch / P``, its rows of the block
    table) through the plain sweep and the rows wrapper's CPU path against
    JAX's plain sweep and its B10 Pallas kernel with the same ``i0``
    (interpret mode); the ranks' rows end to end are the unsliced sweep."""
    s = sweep96
    kd = s["k_ch"] // parts
    full = tn.near_acc_slots(*s["ch_t"], s["jbl"], **SWEEP)
    rows = []
    for r in range(parts):
        i0 = r * kd
        jbl = s["jbl"][i0:i0 + kd]
        out = cn.near_acc_slots_rows_cuda(*s["ch_t"], jbl, i0=i0, **SWEEP)
        assert all(torch.equal(a, b) for a, b in zip(
            out, tn.near_acc_slots(*s["ch_t"], jbl, i0=i0, **SWEEP)))
        assert all(torch.equal(a, b) for a, b in zip(
            out, cn.near_acc_slots_cuda_sb(*s["ch_t"], jbl, i0=i0, **SWEEP)))
        jbl_j = jnp.asarray(jbl.numpy())
        ref = jn.near_acc_slots(*s["ch_j"], jbl_j, i0=jnp.int32(i0), **SWEEP)
        if r == parts - 1:  # the interpret-mode kernel once a case
            ref_k = jp.near_acc_slots_pallas_sb(*s["ch_j"], jbl_j, i0=jnp.int32(i0),
                                                interpret=True, **SWEEP)
            for a, b in zip(out, ref_k):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
        rows.append(out)
    for k in range(2):
        assert torch.equal(torch.cat([o[k] for o in rows]), full[k])
    assert cn.near_acc_slots_rows_cuda.launches == 0  # CPU tensors never launch
    with pytest.raises(ValueError, match="unsupported device"):
        cn.near_acc_slots_rows_cuda(*(c.to("meta") for c in s["ch_t"]), s["jbl"].to("meta"),
                                    i0=0, **SWEEP)


def _pair(n, seed, precision, *, vscale=0.3, radius=None, **cfg_kw):
    """JAX and port states and configs of one sharded multirate run: rc 0.3,
    cell 0.6, chunk budgets from the probe (a multiple of lcm(rj, 8), so they
    divide across 8 ranks), no worklist."""
    pos, vel, mass = _cluster(n, seed, vscale)
    m_grid, k_ch, w_blk = jn.neighbor_budgets(pos, cell=0.6, chunk=CHUNK, rj=RJ)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa", respa_k=4,
                         respa_rc=0.3, respa_cell=0.6, respa_m=m_grid, respa_max_chunks=k_ch,
                         respa_w_blk=w_blk, respa_chunk=CHUNK, respa_rj=RJ, **cfg_kw)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision=precision), jcfg)
    return (js, jcfg), (_port_state(js), tot.SimConfig(**dataclasses.asdict(jcfg)))


def _j_roll(jcfg, js, steps, record_every):
    mesh = j_make_mesh()
    roll = jsh.make_sharded_respa_rollout(jcfg, mesh, js, steps=steps,
                                          record_every=record_every, axis="body")
    return roll(jsh.shard_state(mesh, js))


def _t_roll(tcfg, ts, steps, record_every, p=8):
    mesh = tot.make_mesh(shape=(p,), devices="cpu")
    roll = tot.make_sharded_respa_rollout(tcfg, mesh, ts, steps, record_every)
    shards, traj, diag = roll(tot.shard_state(mesh, ts))
    return tot.gather_state(mesh, shards), traj, diag


def test_sharded_respa_f64_matches_jax():
    """tests/test_parallel.py:894 mirrored: 32 substeps (K = 4, the geometry
    refreshed every 2 windows) in f64 over 8 ranks, recorded every 16,
    against JAX's sharded rollout on its 8 devices and the port's
    single-device rollout; a dead body counted in the overflow, as in
    both packages."""
    (js, jcfg), (ts, tcfg) = _pair(128, 1, "f64", respa_impl="xla", respa_refresh=2)
    js = js.replace(alive=js.alive.at[7].set(False))
    ts = ts.replace(alive=ts.alive.clone())
    ts.alive[7] = False
    jout, jtraj, jdiag = _j_roll(jcfg, js, 32, 16)
    out, traj, diag = _t_roll(tcfg, ts, 32, 16)
    one, one_traj, one_diag = tot.engine.multirate.respa_rollout(ts, tcfg, 32, 16)
    scale = float(np.abs(np.asarray(jout.pos)).max())
    for ref, rtraj, rdiag in ((jout, jtraj, jdiag), (one, one_traj, one_diag)):
        assert {k: int(v) for k, v in diag.items()} == {k: int(v) for k, v in rdiag.items()}
        np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), rtol=0,
                                   atol=1e-11 * scale)
        np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel), rtol=0, atol=1e-11)
        np.testing.assert_allclose(traj.pos.numpy(), np.asarray(rtraj.pos), rtol=0,
                                   atol=1e-11 * scale)
        np.testing.assert_allclose(traj.energy.numpy(), np.asarray(rtraj.energy), rtol=1e-12)
    assert int(diag["overflow"]) == 1 and int(diag["skin_violation"]) == 0
    assert tuple(traj.pos.shape) == (2, 128, 3) and int(out.step) == 32
    assert float(out.time) == pytest.approx(float(jout.time))


def test_sharded_respa_ds32_bounce_matches_jax(monkeypatch):
    """ds32 with bounce collisions over 2 and 4 ranks (the detecting closing
    evaluation and the bounce on the replicated state), 16 substeps against
    JAX's sharded rollout; a planted pair touches."""
    pos, vel, mass = _cluster(128, 2)
    pos[77] = pos[3] + np.array([0.01, 0.0, 0.0])
    vel[77], vel[3] = [-0.5, 0, 0], [0.5, 0, 0]
    radius = np.full(128, 0.006)
    m_grid, k_ch, w_blk = jn.neighbor_budgets(pos, cell=0.6, chunk=CHUNK, rj=RJ)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa", respa_k=4,
                         respa_rc=0.3, respa_cell=0.6, respa_m=m_grid, respa_max_chunks=k_ch,
                         respa_w_blk=w_blk, respa_chunk=CHUNK, respa_rj=RJ,
                         collisions="bounce", restitution=0.5)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="ds32"), jcfg)
    jout, _, jdiag = _j_roll(jcfg, js, 16, 0)
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    for p in (2, 4):
        out, traj, diag = _t_roll(tcfg, _port_state(js), 16, 0, p=p)
        assert traj is None
        assert {k: int(v) for k, v in diag.items()} == {k: int(v) for k, v in jdiag.items()}
        for f in ("pos", "vel"):
            np.testing.assert_allclose(out.pos_full().numpy() if f == "pos"
                                       else out.vel_full().numpy(),
                                       np.asarray(getattr(jout, f)) + np.asarray(
                                           getattr(jout, f + "_lo")), rtol=0, atol=1e-6,
                                       err_msg=f)
    # the pair bounced: its approach reversed
    assert float((out.vel[77] - out.vel[3])[0]) > 0


def test_simulate_mesh_respa_matches_jax():
    """tests/test_parallel.py:946 mirrored: simulate(integrator="respa",
    mesh=) over 8 ranks against the JAX package's simulate(mesh=) on its 8
    devices: the mesh's budget rule (the chunk budget a multiple of lcm(8,
    8), no worklist) and the records."""
    rng = np.random.default_rng(4)
    n = 64
    pos, vel, mass = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.1, rng.uniform(
        0.5, 1.5, n)
    kw = dict(pos=pos, vel=vel, mass=mass, radius=np.full(n, 1e-3),
              names=[f"b{i}" for i in range(n)])
    run = dict(steps=24, dt=1e-3, softening=1e-2, record_every=12, precision="f64",
               integrator="respa", respa_k=4)
    jres = jot.simulate(JScene(**kw, uuids=[f"u{i}" for i in range(n)]), mesh=j_make_mesh(),
                        unit_profile=dataclasses.replace(jot.STANDARD, G=1.0), **run)
    tres = tot.simulate(TScene(**kw), mesh=tot.make_mesh(shape=(8,), devices="cpu"),
                        device="cpu", unit_profile=dataclasses.replace(tot.STANDARD, G=1.0),
                        **run)
    one = tot.simulate(TScene(**kw), device="cpu",
                       unit_profile=dataclasses.replace(tot.STANDARD, G=1.0), **run)
    assert tres.config.respa_max_chunks == jres.config.respa_max_chunks
    assert tres.config.respa_max_chunks % 8 == 0
    assert tres.config.respa_wl_entries == jres.config.respa_wl_entries == 0
    assert one.config.respa_wl_entries > 0
    np.testing.assert_allclose(tres.pos, jres.pos, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tres.energy, jres.energy, rtol=1e-9)
    np.testing.assert_allclose(tres.pos, one.pos, rtol=1e-9, atol=1e-11)


def test_sharded_respa_contract():
    """The mesh variant's contract, as the JAX package states it: the chunk
    budget divides across the ranks and the worklist is off; the step
    count divides by K and records fall on window boundaries."""
    (_, _), (ts, tcfg) = _pair(64, 3, "f64")
    mesh = tot.make_mesh(shape=(2,), devices="cpu")
    with pytest.raises(ValueError, match="divide across 3 shards"):
        tmr.make_respa_macro(tcfg.replace(respa_max_chunks=tcfg.respa_max_chunks + 1),
                             None, shard=tot.make_mesh(shape=(3,), devices="cpu").comms[0])
    with pytest.raises(ValueError, match="respa_wl_entries=0"):
        tmr.make_respa_macro(tcfg.replace(respa_wl_entries=64), None, shard=mesh.comms[0])
    with pytest.raises(ValueError, match="divide by respa_k"):
        tot.make_sharded_respa_rollout(tcfg, mesh, ts, 6)
    with pytest.raises(ValueError, match="multiple of respa_k"):
        tot.make_sharded_respa_rollout(tcfg, mesh, ts, 8, record_every=2)
    with pytest.raises(ValueError, match="make_sharded_respa_rollout"):
        tot.make_sharded_step(tcfg, mesh, ts)
