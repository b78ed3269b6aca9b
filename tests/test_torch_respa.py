"""The multirate (RESPA) stepper of the PyTorch port against the JAX
package's: the search geometry (``_pairs_geometry``, ``_wl_runs``,
``neighbor_geometry``), the budgets, packing, the plain near sweep, each
CUDA wrapper's CPU path against its Pallas kernel, the macro step and
``respa_rollout`` (with geometry refresh, bounce collisions and starved
budgets), simulate(), and the routing.

Sizes are the JAX package's own (tests/test_respa.py): chunk 8, rj 16,
N <= 700, inputs from a numpy seed; the Pallas kernels run in interpret
mode at N = 96 to keep their grids small. Tolerances:
  * geometry, budgets, packing and the integer diagnostics: equal.
  * plain f32 sweep against JAX's: rtol 1e-5, atol 1e-7 (the same f32
    formulas summed in another order); in f64 rtol 1e-12.
  * the CUDA wrappers' CPU paths against the Pallas kernels: rtol 1e-5,
    atol 1e-6, the JAX package's own kernel-vs-sweep tolerance.
  * f64 rollouts: rtol 1e-12 (summation order only).
  * ds32 rollouts: atol 1e-7 on positions and velocities. The near and far
    forces differ by f32 summation order (~1e-7 relative) and XLA:CPU
    contracts multiply-adds into the two-sums that the port rounds
    separately (ROADMAP.md §C); over 16 substeps at dt = 1e-3 both move the
    state far less than 1e-7.
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
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu.ops import neighbor as jn
from orbital_tpu.ops import neighbor_pallas as jp
from orbital_tpu.ops.tree import _pairs_geometry as j_pairs_geometry
from orbital_tpu.ops.tree_near_wl import _wl_runs as j_wl_runs
from orbital_tpu_torch.engine import integrators as I
from orbital_tpu_torch.engine import multirate as tmr
from orbital_tpu_torch.models.scene import SceneArrays as TScene
from orbital_tpu_torch.ops import cuda_neighbor as cn
from orbital_tpu_torch.ops import neighbor as tn
from orbital_tpu_torch.ops.tree import _pairs_geometry as t_pairs_geometry
from orbital_tpu_torch.ops.tree_near_wl import _wl_runs as t_wl_runs

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

CHUNK, RJ = 8, 16
SWEEP = dict(r1=0.15, rc=0.3, G=2.0, eps2=1e-4, chunk=CHUNK, rj=RJ)
F32 = torch.float32

# the JAX geometry compiled once per shape (op-by-op dispatch compiles each
# small op on its own); its integer results are the same either way
_j_geometry = jax.jit(jn.neighbor_geometry, static_argnames=(
    "cell", "m_grid", "chunk", "max_chunks", "w_blk", "rj", "wl_entries"))
_j_pairs = jax.jit(j_pairs_geometry, static_argnums=(1, 2, 3, 4, 5))


def _cluster(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _alive(n):
    alive = np.ones(n, bool)
    alive[n // 3] = False  # a dead body must drop out
    return alive


def _equal(jax_dict, torch_dict, keys=None):
    for k in keys or jax_dict:
        np.testing.assert_array_equal(torch_dict[k].cpu().numpy(), np.asarray(jax_dict[k]),
                                      err_msg=k)


def _geometries(pos, alive, cell, budgets):
    m, k, w, q = budgets
    kw = dict(cell=cell, m_grid=m, chunk=CHUNK, max_chunks=k, w_blk=w, rj=RJ, wl_entries=q)
    gj = _j_geometry(jnp.asarray(pos, jnp.float32), jnp.asarray(alive), **kw)
    gt = tn.neighbor_geometry(torch.tensor(pos, dtype=F32), torch.from_numpy(alive), **kw)
    return gj, gt


def _channels(pos, mass, alive, slot, n_slots, dtype=F32):
    """Slot channels (xs, ys, zs, ms) for both packages."""
    m = np.where(alive, mass, 0.0)
    vals = [(pos[:, k], tn.SENTINEL_POS) for k in range(3)] + [(m, 0.0)]
    t = [tn.pack_slots(slot, torch.tensor(v, dtype=dtype), n_slots, f) for v, f in vals]
    np_dtype = np.float32 if dtype == F32 else np.float64
    j = [jn.pack_slots(jnp.asarray(slot.numpy()), jnp.asarray(v, np_dtype), n_slots, f)
         for v, f in vals]
    return t, j


@pytest.fixture(scope="module")
def scene300():
    """N = 300 with one dead body at cell 0.45: budgets, geometry with a
    worklist, and packed f32 channels in both packages."""
    n, cell = 300, 0.45
    pos, _, mass = _cluster(n, 0)
    alive = _alive(n)
    budgets = jn.neighbor_budgets(pos, alive, cell=cell, chunk=CHUNK, rj=RJ, with_wl=True)
    gj, gt = _geometries(pos, alive, cell, budgets)
    n_slots = (budgets[1] + RJ) * CHUNK
    ch_t, ch_j = _channels(pos, mass, alive, gt["slot"], n_slots)
    return dict(pos=pos, mass=mass, alive=alive, budgets=budgets, gj=gj, gt=gt,
                ch_t=ch_t, ch_j=ch_j, n_slots=n_slots)


def test_switch_terms_match_jax():
    r2 = np.linspace(0.0, 0.12, 97)
    for dt_np, dt_t in ((np.float32, F32), (np.float64, torch.float64)):
        S_j, sp_j = jn.switch_terms(jnp.asarray(r2, dt_np), 0.15, 0.3)
        S_t, sp_t = tn.switch_terms(torch.tensor(r2, dtype=dt_t), 0.15, 0.3)
        np.testing.assert_array_equal(S_t.numpy(), np.asarray(S_j))
        np.testing.assert_array_equal(sp_t.numpy(), np.asarray(sp_j))


def test_pairs_geometry_and_wl_runs_equal_jax():
    """The chunk/run geometry on cell-sorted ids at ws = 2 with the chunk
    budget starved (ws = 1 with room runs in every geometry test below), and
    the block runs of it at two block heights."""
    n, k_ch, ws = 400, 24, 2
    pos, _, _ = _cluster(n, n)
    alive = _alive(n)
    M, cell = 14, 0.45
    cc = np.clip(np.floor((pos - pos.min(0)) / cell).astype(np.int64), 0, M - 1)
    sc = np.sort(np.where(alive, (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2], M ** 3))
    K = -(-k_ch // RJ) * RJ
    gj = _j_pairs(jnp.asarray(sc, jnp.int32), n, M, ws, CHUNK, K)
    gt = t_pairs_geometry(torch.from_numpy(sc), n, M, ws, CHUNK, K)
    _equal(gj, gt)
    assert int(gj["S_ch"].sum()) > 0
    assert int(np.sum(np.asarray(gj["valid_b"] & (gj["chunk_ord"] >= K)))) > 0
    for rj in (4, RJ):
        for a, b in zip(j_wl_runs(gj, rj, K, K), t_wl_runs(gt, rj, K, K)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("starved", [False, True])
def test_neighbor_geometry_equals_jax(scene300, starved):
    """slot, jbl, the worklist and the overflow counters, equal; with every
    budget starved all three overflow counters are nonzero."""
    s = scene300
    gj, gt = s["gj"], s["gt"]
    if starved:
        m = s["budgets"][0]
        gj, gt = _geometries(s["pos"], s["alive"], 0.45, (m, 32, 1, 20))
        for k in ("cap_overflow", "w_overflow", "q_overflow"):
            assert int(gt[k]) > 0, k
    else:
        assert all(int(gt[k]) == 0 for k in ("cap_overflow", "w_overflow", "q_overflow"))
    _equal(gj, gt)
    assert gt["jbl"].dtype == torch.int32 and gt["cap_overflow"].ndim == 0


@pytest.mark.parametrize("kw", [dict(), dict(with_wl=True, headroom=2.2, w_headroom=1.5),
                                dict(with_wl=True, rj=4, chunk=32, dead=True)])
def test_neighbor_budgets_equal_jax(scene300, kw):
    kw = dict(kw)
    pos = scene300["pos"]
    alive = scene300["alive"] if kw.pop("dead", False) else None
    kw = dict(dict(cell=0.45, chunk=CHUNK, rj=RJ), **kw)
    assert tn.neighbor_budgets(pos, alive, **kw) == jn.neighbor_budgets(pos, alive, **kw)


def test_pack_and_unpack_equal_jax(scene300):
    s = scene300
    slot_t, n_slots = s["gt"]["slot"], s["n_slots"]
    slot_j = jnp.asarray(slot_t.numpy())
    valid_below = s["budgets"][1] * CHUNK
    for t, j in zip(s["ch_t"], s["ch_j"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rows = np.concatenate([s["pos"], s["mass"][:, None]], 1)
    fill = [tn.SENTINEL_POS] * 3 + [0.0]
    tab_t = tn.pack_rows(slot_t, torch.from_numpy(rows), n_slots,
                         torch.tensor(fill, dtype=torch.float64))
    tab_j = jn.pack_rows(slot_j, jnp.asarray(rows), n_slots, jnp.asarray(fill))
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
    fb = -np.ones_like(rows)
    np.testing.assert_array_equal(
        tn.unpack_rows(slot_t, tab_t, torch.from_numpy(fb), valid_below).numpy(),
        np.asarray(jn.unpack_rows(slot_j, tab_j, jnp.asarray(fb), valid_below)))
    np.testing.assert_array_equal(
        tn.unpack_slots(slot_t, tab_t[:, 3], torch.zeros(300, dtype=torch.float64),
                        valid_below).numpy(),
        np.asarray(jn.unpack_slots(slot_j, tab_j[:, 3], jnp.zeros(300), valid_below)))


@pytest.mark.parametrize("dtype", [F32, torch.float64])
def test_near_acc_slots_matches_jax(scene300, dtype):
    s = scene300
    if dtype == F32:
        ch_t, ch_j, tol = s["ch_t"], s["ch_j"], dict(rtol=1e-5, atol=1e-7)
    else:
        ch_t, ch_j = _channels(s["pos"], s["mass"], s["alive"], s["gt"]["slot"],
                               s["n_slots"], dtype)
        tol = dict(rtol=1e-12, atol=1e-13)
    acc_j, pe_j = jn.near_acc_slots(*ch_j, s["gj"]["jbl"], **SWEEP)
    for block in (64, 7):
        acc_t, pe_t = tn.near_acc_slots(*ch_t, s["gt"]["jbl"], block=block, **SWEEP)
        assert acc_t.dtype == dtype
        np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), **tol)
        np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), **tol)
    # against the dense oracle, through the slots
    acc_d, _ = tn.near_acc_dense(torch.from_numpy(s["pos"]), torch.from_numpy(s["mass"]),
                                 torch.from_numpy(s["alive"]), **{k: SWEEP[k] for k in
                                                                  ("r1", "rc", "G", "eps2")})
    acc_b = tn.unpack_slots(s["gt"]["slot"], acc_t.to(F32), torch.zeros(300, 3),
                            s["budgets"][1] * CHUNK)
    np.testing.assert_allclose(acc_b.numpy(), acc_d.numpy(),
                               atol=3e-5 * float(acc_d.abs().max()))
    assert not acc_b[~torch.from_numpy(s["alive"])].any()


def test_near_acc_dense_matches_jax():
    pos, _, mass = _cluster(64, 9)
    alive = _alive(64)
    kw = {k: SWEEP[k] for k in ("r1", "rc", "G", "eps2")}
    acc_j, pe_j = jn.near_acc_dense(jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive),
                                    **kw)
    acc_t, pe_t = tn.near_acc_dense(torch.from_numpy(pos), torch.from_numpy(mass),
                                    torch.from_numpy(alive), **kw)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def scene96():
    """N = 96 for the Pallas kernels in interpret mode (small grids). Both
    packages sweep the port's geometry (held equal to JAX's above)."""
    n, cell = 96, 0.6
    pos, _, mass = _cluster(n, 5)
    alive = np.ones(n, bool)
    m, k_ch, w_blk, q = tn.neighbor_budgets(pos, alive, cell=cell, chunk=CHUNK, rj=RJ,
                                             with_wl=True)
    geoms = {}
    for name, q_ in (("full", q), ("starved", 8)):
        g = tn.neighbor_geometry(torch.tensor(pos, dtype=F32), torch.from_numpy(alive),
                                 cell=cell, m_grid=m, chunk=CHUNK, max_chunks=k_ch,
                                 w_blk=w_blk, rj=RJ, wl_entries=q_)
        geoms[name] = (g, {k: jnp.asarray(v.numpy()) for k, v in g.items()})
    ch_t, ch_j = _channels(pos, mass, alive, geoms["full"][0]["slot"], (k_ch + RJ) * CHUNK)
    return dict(geoms=geoms, ch_t=ch_t, ch_j=ch_j)


@pytest.mark.parametrize("variant", ["B8", "B11", "B9", "B9-starved", "B10"])
def test_cuda_wrappers_cpu_path_match_pallas(scene96, variant):
    """Each wrapper's CPU path (its plain version) against the TPU kernel it
    replaces, in interpret mode: B8 streaming and B11 resident behind
    near_acc_slots_cuda, B9 behind the worklist adapter (also with its
    budget starved: unvisited chunks exactly 0), B10 behind the superblock
    adapter."""
    s = scene96
    kw = dict(SWEEP, rc=0.4, r1=0.2, G=1.0)
    gt, gj = s["geoms"]["starved" if variant == "B9-starved" else "full"]
    assert (int(gt["q_overflow"]) > 0) == (variant == "B9-starved")
    if variant in ("B8", "B11"):
        ref = jp.near_acc_slots_pallas(*s["ch_j"], gj["jbl"], interpret=True,
                                       resident=variant == "B11", **kw)
        out = cn.near_acc_slots_cuda(*s["ch_t"], gt["jbl"], **kw)
    elif variant == "B10":
        ref = jp.near_acc_slots_pallas_sb(*s["ch_j"], gj["jbl"], interpret=True, **kw)
        out = cn.near_acc_slots_cuda_sb(*s["ch_t"], gt["jbl"], **kw)
    else:
        ref = jp.near_acc_slots_pallas_wl(*s["ch_j"], gj["wl_i"], gj["wl_jb"], gj["wl_first"],
                                          gj["wl_row_live"], interpret=True, **kw)
        out = cn.near_acc_slots_cuda_wl(*s["ch_t"], gt["wl_i"], gt["wl_jb"], **kw)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if variant == "B9-starved":
        unvisited = ~gt["wl_row_live"]
        assert unvisited.any() and not out[0][unvisited].any()
    assert cn.near_acc_slots_cuda.launches == 0  # CPU tensors never launch


def _respa_pair(n, seed, precision, *, k=4, steps_cfg=None, pos=None, vel=None, mass=None,
                radius=None, **cfg_kw):
    """JAX and port states and configs of one multirate run: rc 0.3, cell
    0.6, budgets from the JAX probe."""
    if pos is None:
        pos, vel, mass = _cluster(n, seed)
    rc, cell = 0.3, cfg_kw.pop("cell", 0.6)
    budgets = cfg_kw.pop("budgets", None) or jn.neighbor_budgets(
        pos, cell=cell, chunk=CHUNK, rj=RJ, with_wl=True)
    m, k_ch, w_blk, q = budgets
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa", respa_k=k,
                         respa_rc=rc, respa_cell=cell, respa_m=m, respa_max_chunks=k_ch,
                         respa_w_blk=w_blk, respa_chunk=CHUNK, respa_rj=RJ,
                         respa_wl_entries=q, **cfg_kw)
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision=precision), jcfg)
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    ts = tot.engine.state.state_from_arrays(
        {k_: None if v is None else np.asarray(v) for k_, v in fields.items()}, device="cpu")
    return (js, jcfg), (ts, tcfg)


def _assert_states(tf, jf, tol):
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                   err_msg=f, **tol)
    # the closing force evaluation, in the state's float type
    acc_tol = dict(rtol=1e-12, atol=1e-13) if tf.dtype == torch.float64 else dict(
        rtol=0, atol=1e-5 * float(np.abs(np.asarray(jf.acc)).max()))
    np.testing.assert_allclose(tf.acc.numpy(), np.asarray(jf.acc), **acc_tol)
    for f in ("pos_lo", "vel_lo"):
        if getattr(jf, f) is not None:
            np.testing.assert_allclose(getattr(tf, f).numpy() + getattr(tf, f[:3]).numpy(),
                                       np.asarray(getattr(jf, f)) + np.asarray(
                                           getattr(jf, f[:3])), err_msg=f, **tol)
    assert int(tf.step) == int(jf.step)


def _assert_diag(td, jd):
    assert set(td) == set(jd)
    for k in jd:
        assert td[k].dtype == torch.int32 and td[k].ndim == 0
        assert int(td[k]) == int(jd[k]), k


def test_respa_rollout_f64_bounce_matches_jax():
    """A recorded f64 rollout (the plain sweep on both sides) with bounce
    collisions at the macro boundaries, gated on the closing evaluation's
    count, on a scene with contacts."""
    rng = np.random.default_rng(21)
    n = 128
    pos = rng.normal(size=(n, 3)) * 0.6
    vel = rng.normal(size=(n, 3)) * 0.4
    mass = rng.uniform(0.5, 1.5, n) / n
    (js, jcfg), (ts, tcfg) = _respa_pair(n, 0, "f64", pos=pos, vel=vel, mass=mass,
                                         radius=np.full(n, 0.05), collisions="bounce",
                                         restitution=0.8)
    jf, jt, jd = jmr.respa_rollout_jit(js, jcfg, 16, record_every=8)
    tf, tt, td = tmr.respa_rollout(ts, tcfg, 16, record_every=8)
    free, _, _ = tmr.respa_rollout(ts, tcfg.replace(collisions="none"), 16)
    assert float((tf.vel - free.vel).abs().max()) > 1e-3  # the bounces acted
    # f64 summation order only; the impulses of touching pairs amplify it
    # (measured 3.7e-13 on positions after 3 macro steps)
    tol = dict(rtol=1e-11, atol=1e-12)
    _assert_states(tf, jf, tol)
    for f in ("pos", "vel", "time", "energy", "ang_mom"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                   err_msg=f, **tol)
    assert tt.n_records == 2 and float(tf.potential) == pytest.approx(float(jf.potential),
                                                                     rel=1e-11)
    _assert_diag(td, jd)
    assert int(td["overflow"]) == 0 and int(td["skin_violation"]) == 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_respa_rollout_ds32_matches_jax(impl):
    """ds32 with the geometry refreshed every 2 macro windows, through the
    plain sweep ("xla") and through the wrappers' CPU paths ("pallas", with
    the worklist)."""
    (js, jcfg), (ts, tcfg) = _respa_pair(200, 13, "ds32", respa_impl=impl, respa_refresh=2)
    jf, _, jd = jmr.respa_rollout_jit(js, jcfg.replace(respa_impl="xla"), 16)
    tf, _, td = tmr.respa_rollout(ts, tcfg, 16)
    _assert_states(tf, jf, dict(rtol=0, atol=1e-7))
    assert tf.pos_lo is not None and tf.pos.dtype == F32
    _assert_diag(td, jd)


def test_k1_matches_plain_kdk():
    """K = 1 collapses the composition to KDK on the total force."""
    pos, vel, mass = _cluster(128, 11)
    m, k_ch, w_blk = tn.neighbor_budgets(pos, cell=0.6, chunk=CHUNK, rj=RJ)
    kcfg = tot.SimConfig(dt=1e-3, eps2=1e-4, force_impl="dense")
    tcfg = kcfg.replace(integrator="respa", respa_k=1, respa_rc=0.3, respa_cell=0.6,
                        respa_m=m, respa_max_chunks=k_ch, respa_w_blk=w_blk,
                        respa_chunk=CHUNK, respa_rj=RJ)
    st = tot.make_state(pos, vel, mass, precision="f64", device="cpu")
    tf, _, td = tmr.respa_rollout(tot.init_forces(st, tcfg), tcfg, 10)
    kf, _ = tot.rollout(tot.init_forces(st, kcfg), kcfg, 10)
    np.testing.assert_allclose(tf.pos.numpy(), kf.pos.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf.vel.numpy(), kf.vel.numpy(), rtol=0, atol=1e-11)
    assert int(td["overflow"]) == 0


def test_starved_budgets_and_dyn_rollout():
    """Starved chunk and block budgets (tests/test_respa.py's): drops are
    counted, and the dropped bodies move exactly on the ballistic path of
    the held total force; respa_rollout_dyn equals respa_rollout."""
    pos, vel, mass = _cluster(96, 19)
    cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa", respa_k=4,
                        respa_rc=0.3, respa_cell=0.6, respa_m=10, respa_max_chunks=16,
                        respa_w_blk=4, respa_chunk=CHUNK, respa_rj=RJ)
    st = tot.init_forces(tot.make_state(pos, vel, mass, precision="f64", device="cpu"), cfg)
    dropped = tmr.make_respa_macro(cfg, None).build_geom(st)["slot"] >= 16 * CHUNK
    tf, _, td = tmr.respa_rollout(st, cfg, 8)
    assert int(td["cap_overflow"]) > 0 and int(td["overflow"]) >= int(dropped.sum()) > 0
    delta = 4 * cfg.dt
    pos_fb = st.pos + delta * st.vel + (0.5 * delta * delta) * st.acc
    vel_fb = st.vel + delta * st.acc
    once, _, _ = tmr.respa_rollout(st, cfg, 4)
    np.testing.assert_array_equal(once.pos[dropped].numpy(), pos_fb[dropped].numpy())
    np.testing.assert_array_equal(once.vel[dropped].numpy(), vel_fb[dropped].numpy())
    assert bool((once.pos[~dropped] != pos_fb[~dropped]).any(1).all())
    df, dd = tmr.respa_rollout_dyn(st, cfg, 2)
    for f in ("pos", "vel", "acc", "time", "step"):
        np.testing.assert_array_equal(getattr(df, f).numpy(), getattr(tf, f).numpy())
    assert all(int(dd[k]) == int(td[k]) for k in td)


def _respa_scene():
    """The SI-like scene of tests/test_respa.py's simulate() case: its fast
    bodies outrun the default skin, so both packages warn."""
    pos, vel, mass = _cluster(128, 29)
    m = 32
    kw = dict(pos=pos[:m] * 1e9, vel=vel[:m] * 1e2, mass=mass[:m] * 1e20,
              radius=np.zeros(m), names=[f"b{i}" for i in range(m)])
    return JScene(uuids=[f"u{i}" for i in range(m)], **kw), TScene(**kw)


def test_simulate_respa_matches_jax():
    js, ts = _respa_scene()
    kw = dict(steps=16, dt=50.0, softening=1e7, integrator="respa", respa_k=4)
    with pytest.warns(RuntimeWarning, match="skin_violation=1"):
        ref = jot.simulate(js, **kw)
    with pytest.warns(RuntimeWarning, match="skin_violation=1"):
        out = tot.simulate(ts, device="cpu", **kw)
    for f in ("respa_rc", "respa_cell", "respa_m", "respa_max_chunks", "respa_w_blk",
              "respa_wl_entries", "respa_k", "dt", "eps2"):
        assert getattr(out.config, f) == getattr(ref.config, f), f
    assert out.pos.shape == ref.pos.shape == (4, 32, 3)  # record_every rounded to 4
    for f in ("pos", "vel", "time", "energy", "ang_mom"):
        a, b = getattr(out, f), getattr(ref, f)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max(),
                                   err_msg=f)


def test_sweep_routing(monkeypatch):
    """CUDA tensors take the kernel for every respa_impl but "xla" (the
    worklist adapter under "auto"/"pallas" with a worklist budget); CPU
    tensors take the plain sweep under "auto"; f64 on CUDA raises."""
    calls = []
    for name in ("near_acc_slots_cuda", "near_acc_slots_cuda_sb", "near_acc_slots_cuda_wl"):
        monkeypatch.setattr(cn, name, lambda *a, _n=name, **k: calls.append(_n) or (None, None))
    monkeypatch.setattr(tmr, "near_acc_slots", lambda *a, **k: calls.append("plain") or
                        (None, None))
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, integrator="respa", respa_rc=0.1,
                        respa_cell=0.2, respa_chunk=CHUNK, respa_rj=RJ)
    geom = dict(jbl=None, wl_i=None, wl_jb=None)
    cases = [("cuda", "auto", 0, "near_acc_slots_cuda"),
             ("cuda", "auto", 64, "near_acc_slots_cuda_wl"),
             ("cuda", "pallas", 64, "near_acc_slots_cuda_wl"),
             ("cuda", "pallas_interpret", 0, "near_acc_slots_cuda"),
             ("cuda", "pallas_sb", 64, "near_acc_slots_cuda_sb"),
             ("cuda", "xla", 64, "plain"), ("cpu", "auto", 64, "plain"),
             ("cpu", "pallas_sb", 0, "near_acc_slots_cuda_sb")]
    for device, impl, q, want in cases:
        c = cfg.replace(respa_impl=impl, respa_wl_entries=q)
        tmr._resolve_sweep(c, F32, device)(None, None, None, None, geom)
        assert calls.pop() == want, (device, impl, q)
    tmr._resolve_sweep(cfg.replace(respa_impl="pallas"), torch.float64, "cpu")(
        None, None, None, None, geom)
    assert calls.pop() == "plain"
    # f64 state on CUDA takes the plain sweep in f64: the JAX package forces
    # "xla" for non-f32 state (orbital_tpu/engine/multirate.py:88-89)
    tmr._resolve_sweep(cfg, torch.float64, "cuda")(None, None, None, None, geom)
    assert calls.pop() == "plain"


def test_unported_respa_paths_raise():
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, integrator="respa", respa_rc=0.1,
                        respa_cell=0.2, respa_chunk=CHUNK, respa_rj=RJ, respa_max_chunks=16,
                        respa_w_blk=4, respa_m=8)
    # the mesh variant and the sweep's row offset are ported (A.15b): the
    # sharded macro builds on a rank's communicator, and the offset sweep
    # returns its chunks' rows
    comm = tot.make_mesh(shape=(2,), devices="cpu").comms[1]
    assert callable(tmr.make_respa_macro(cfg, None, shard=comm).build_geom)
    z = torch.zeros((32 * CHUNK,))
    acc, pe = tn.near_acc_slots(z, z, z, z, torch.zeros((8, 4), dtype=torch.int32),
                                i0=8, **SWEEP)
    assert acc.shape == (8 * CHUNK, 3) and pe.shape == (8 * CHUNK,)
    # resolve (ROADMAP A.7b) is ported: its macro step builds
    assert callable(tmr.make_respa_macro(cfg.replace(collisions="resolve"), None).build_geom)
    assert callable(tmr.make_respa_macro(cfg.replace(collisions="merge"), None).build_geom)
    with pytest.raises(ValueError, match="respa_rollout"):
        I.make_step_fn(cfg)
    st = tot.make_state(*_cluster(16, 1), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tmr.respa_rollout(st, cfg, 6)


def _near_pairs(s, starved):
    """Every (chunk row, j row) pair of JAX's geometry for the N = 300 scene
    (its jbl held equal to the port's first): the rows' f32 positions and
    slots, whether each i row is live, the kernel's box rule for it (the
    chunk's live rows' [min - h, max + h] on each axis, rounded outward in
    f32, h of ``near_params``), and ``used`` for the live jbl entries."""
    gj, gt = s["gj"], s["gt"]
    if starved:
        gj, gt = _geometries(s["pos"], s["alive"], 0.45, (s["budgets"][0], 32, 1, 20))
    jbl = np.asarray(gj["jbl"])
    np.testing.assert_array_equal(gt["jbl"].numpy(), jbl)
    k_ch, n_slots = jbl.shape[0], (jbl.shape[0] + RJ) * CHUNK
    ch, _ = _channels(s["pos"], s["mass"], s["alive"], gt["slot"], n_slots)
    pos = np.stack([c.numpy() for c in ch[:3]], 1)                  # [n_slots, 3] f32
    blkw = RJ * CHUNK
    used = jbl != n_slots // blkw - 1
    i_slot = np.arange(k_ch * CHUNK).reshape(k_ch, CHUNK)
    j_slot = jbl[:, :, None] * blkw + np.arange(blkw)               # [k_ch, W, blkw]
    live = ~(pos >= 5e14).all(1)
    h = np.float32(cn.near_params(SWEEP["r1"], SWEEP["rc"], SWEEP["G"], SWEEP["eps2"])["h"])
    p_i = pos[i_slot]                                               # [k_ch, C, 3]
    li = live[i_slot][..., None]
    with np.errstate(invalid="ignore"):
        lo = np.where(li, p_i, np.inf).min(1).astype(np.float64) - np.float64(h)
        hi = np.where(li, p_i, -np.inf).max(1).astype(np.float64) + np.float64(h)
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    p_j = pos[j_slot]                                               # [k_ch, W, blkw, 3]
    in_box = ((p_j >= lo32[:, None, None]) & (p_j <= hi32[:, None, None])).all(-1)
    return dict(jbl=jbl, ch=ch, pos=pos, used=used, i_slot=i_slot, j_slot=j_slot,
                live=live, in_box=in_box & used[..., None], p_i=p_i, p_j=p_j, gt=gt)


@pytest.mark.parametrize("starved", [False, True])
def test_near_box_rule_keeps_every_nonzero_pair(scene300, starved):
    """The CUDA near sweep visits only each chunk's live rows against the
    rows of its live entries inside the chunk's box (csrc/neighbor.cu). On
    JAX's geometry, every pair whose plain-sweep term is nonzero (s > 0 in
    the plain f32 arithmetic, and in the kernel's, r^2 + eps2 against
    rc^2 + eps2) lies inside that rule, and so do the pairs within rc."""
    t = _near_pairs(scene300, starved)
    d = t["p_j"][:, None] - t["p_i"][:, :, None, None]              # [k_ch, C, W, blkw, 3]
    r2 = torch.from_numpy(np.sum(d * d, -1, dtype=np.float32))
    S, spd = tn.switch_terms(r2, SWEEP["r1"], SWEEP["rc"])
    k = cn.near_params(SWEEP["r1"], SWEEP["rc"], SWEEP["G"], SWEEP["eps2"])
    r2e = (r2.double() + k["eps2"]).float().double()
    s_kernel = r2e * k["neg_inv_d"] + k["sc"] > 0
    nonzero = ((S > 0) | (spd > 0) | s_kernel).numpy() | (r2.numpy() < SWEEP["rc"] ** 2)
    nonzero &= t["used"][:, None, :, None] & t["live"][t["i_slot"]][:, :, None, None]
    visits = t["live"][t["i_slot"]][:, :, None, None] & t["in_box"][:, None]
    assert nonzero.sum() > 0 and not (nonzero & ~visits).any()
    assert visits.sum() < (t["used"][:, None, :, None] & np.ones_like(visits)).sum()


@pytest.mark.parametrize("starved", [False, True])
def test_near_work_counts_equal_brute_force(scene300, starved):
    """chip_smoke.near_work's walked, live, visited, issued and needed pairs
    equal a count pair by pair over the same geometry."""
    import chip_smoke

    t = _near_pairs(scene300, starved)
    live_i = t["live"][t["i_slot"]]                                 # [k_ch, C]
    live_j = t["live"][t["j_slot"]] & t["used"][..., None]          # [k_ch, W, blkw]
    n_i = live_i.sum(1)
    in_box = t["in_box"].sum((1, 2))
    width = np.array([1 << int(np.ceil(np.log2(max(v, 1)))) for v in n_i])
    d = t["p_j"][:, None] - t["p_i"][:, :, None, None]
    r2 = np.sum(d.astype(np.float64) ** 2, -1)
    self_pair = t["i_slot"][:, :, None, None] == t["j_slot"][:, None]
    near = (r2 < SWEEP["rc"] ** 2) & live_i[:, :, None, None] & live_j[:, None] & ~self_pair
    want = dict(walked=int(t["used"].sum()) * CHUNK * RJ * CHUNK,
                live=int((n_i * live_j.sum((1, 2))).sum()),
                visited=int((n_i * in_box).sum()),
                issued=int(np.where(n_i > 0, 32 * -(-in_box // (32 // width)), 0).sum()),
                needed=int(near.sum()))
    work = chip_smoke.near_work({"jbl": torch.tensor(t["jbl"])}, t["ch"], SWEEP["rc"],
                                CHUNK, RJ, eps2=SWEEP["eps2"], r1=SWEEP["r1"])
    assert {k: work[k] for k in want} == want
    assert work["needed"] < work["visited"] <= work["issued"] and \
        work["visited"] < work["live"] < work["walked"]


def test_near_wrappers_refuse_other_devices():
    """The near wrappers run their plain versions only for CPU tensors: on
    any other device they launch the kernel or raise."""
    z = torch.zeros((4 * RJ * CHUNK,), device="meta")
    jbl = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    for fn, args in ((cn.near_acc_slots_cuda, (jbl,)), (cn.near_acc_slots_cuda_sb, (jbl,)),
                     (cn.near_acc_slots_cuda_wl, (jbl[0], jbl[0]))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(z, z, z, z, *args, **SWEEP)
