"""The body-sharded tree of the PyTorch port (``ops.tree.tree_sharded_force``
in its four near modes, B7's slice of the worklist, the sharded KDK step,
the staged route ``init_forces_staged``/``rollout_staged(mesh=)`` and
``simulate(mesh=, force_impl="tree")``) against the JAX package's sharded
functions on conftest's 8 virtual CPU devices.

The port runs on one-card meshes of CPU ranks (threads); inputs come from a
numpy seed and go to both packages. Scenes are the JAX package's: the
concentrated blob of tests/test_tree.py (N = 1,024 at levels 4, every 7th
body dead, chunks of 32, a pinned box) with probe-sized budgets and starved
ones (every mode's overflow compared), and the Plummer sphere of
tests/test_parallel.py:386 (N = 128) for the steps and the staged route.

Tolerances, from the errors measured on these scenes:
  * forces against JAX's sharded force: max |da| <= 2e-6 RMS|a| + 1e-6 |a|
    per component (measured <= 2.2e-6 of the RMS; per-body f32 sums of the
    same pairs in another order, as tests/test_torch_tree_modes.py holds
    the unsharded modes), U to rel 1e-6 (measured <= 7.5e-8), overflow
    equal;
  * the psum of the ranks' slices against the unsliced sweep: the same
    bounds (the psum reorders each body's near sum; measured <= 6.3e-7 of
    the RMS, often 0), and B7's slices summed against B7 over the whole
    worklist within 1e-6 of max |row|, every entry swept by one part;
  * steps, the staged route and simulate() against JAX: positions rtol 0 /
    atol 1e-6 and energies rel 1e-5 (tests/test_parallel.py:664's bounds).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine import rollout as jro
from orbital_tpu.ops import tree as jt
from orbital_tpu.ops import tree_near_wl as jw
from orbital_tpu.parallel.mesh import make_mesh as j_make_mesh
from orbital_tpu_torch.engine import rollout as tro
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import cuda_tree
from orbital_tpu_torch.ops import tree as tt
from orbital_tpu_torch.ops import tree_near_wl as tw

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

LEVELS, CHUNK, RJ, EPS2 = 4, 32, 4, 1e-4
BOX = (np.zeros(3, np.float32), np.float32(4.0))
MODES = ("kernel", "cells", "columns", "pairs")


def _blob(n=1024, seed=0):
    """The concentrated blob (tests/test_tree.py:748-751), every 7th body
    dead."""
    rng = np.random.default_rng(seed)
    pos = (rng.normal(0, 1, (n, 3)) * rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::7] = False
    return pos, mass, alive


def _budgets(mode, pos, alive, starve):
    """A mode's probe-sized budgets (the port's probes, which
    tests/test_torch_tree_modes.py holds equal to JAX's), or short ones that
    drop bodies in the ways the mode counts."""
    kw = dict(levels=LEVELS, ws=1, box=BOX)
    if mode == "kernel":
        k_ch, q = tw.tree_wl_budgets(pos, alive, chunk=CHUNK, rj=RJ, **kw)
        return dict(max_chunks=k_ch, wl_entries=q // 4 if starve else q, wl_rj=RJ,
                    chunk=CHUNK)
    if mode == "pairs":
        k_ch, entries = tt.tree_pairs_budgets(pos, alive, chunk=CHUNK, **kw)
        if starve:
            return dict(max_chunks=k_ch // 2, chunk=CHUNK,
                        pair_entries=tuple(max(1, e // 3) for e in entries[:-1]))
        return dict(max_chunks=k_ch, pair_entries=entries, chunk=CHUNK)
    if mode == "columns":
        occ, ncol, nbig, nfront, nch = tt.tree_column_probe(pos, alive, with_chunks=True, **kw)
        if starve:
            return dict(capacity=max(40, occ // 2), max_cells=ncol - 4,
                        max_big=max(1, nbig - 2), max_frontier=max(1, nfront // 2),
                        max_chunks=max(1, nch // 2))
        return dict(capacity=occ + 8, max_cells=ncol + 32, max_big=nbig + 8,
                    max_frontier=nfront + 8, max_chunks=nch + 8)
    occ, ncell, nbig, nfront = tt.tree_class_probe(pos, alive, **kw)
    if starve:
        return dict(capacity=max(20, occ // 2), max_cells=ncell - 8, max_big=max(1, nbig - 1),
                    max_frontier=max(1, nfront // 2))
    return dict(capacity=occ + 8, max_cells=ncell + 32, max_big=nbig + 8,
                max_frontier=nfront + 8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rms(a):
    return float(np.sqrt(np.mean(np.sum(np.asarray(a, np.float64) ** 2, -1))))


def _close(a, ref, U=None, U_ref=None):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(a - ref) <= 2e-6 * _rms(ref) + 1e-6 * np.abs(ref))
    if U is not None:
        assert abs(U - U_ref) <= 1e-6 * abs(U_ref)


def _t_sharded(p, pos, mass, alive, **kw):
    mesh = tot.make_mesh(shape=(p,), devices="cpu")
    tbox = tuple(torch.as_tensor(b) for b in BOX)
    out = mesh.run(lambda c, x, m, a: tt.tree_sharded_force(
        x, m, a, comm=c, box=tbox, with_overflow=True, **kw),
        *[list(t.chunk(p)) for t in _t(pos, mass, alive)])
    return (torch.cat([o[0] for o in out]).numpy(), float(out[0][1]), int(out[0][2]),
            [int(o[2]) for o in out])


@pytest.mark.parametrize("mode,p,starve", [("kernel", 4, True), ("cells", 4, True),
                                           ("columns", 2, True), ("pairs", 8, False)])
def test_sharded_force_matches_jax(mode, p, starve):
    """tree_sharded_force against JAX's under shard_map, each near mode
    (B7's slice for "kernel"), starved budgets with the overflow pmax'd
    and equal on every rank (tests/test_parallel.py:409, 441, 571, 602)."""
    pos, mass, alive = _blob()
    kw = dict(G_grav=1.0, eps2=EPS2, levels=LEVELS, ws=1, near=mode,
              **_budgets(mode, pos, alive, starve))
    mesh = j_make_mesh(shape=(p,), devices=jax.devices()[:p])
    jbox = (jnp.asarray(BOX[0]), jnp.asarray(BOX[1]))
    f = jax.jit(jax.shard_map(
        lambda x, m, a: jt.tree_sharded_force(x, m, a, axis_name="body", n_shards=p,
                                              box=jbox, with_overflow=True, **kw),
        mesh=mesh, in_specs=(JP("body", None), JP("body"), JP("body")),
        out_specs=(JP("body", None), JP(), JP()), check_vma=False))
    ja, jU, jov = f(jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive))
    ta, tU, tov, per_rank = _t_sharded(p, pos, mass, alive, **kw)
    _close(ta, ja, tU, float(jU))
    assert tov == int(jov) and len(set(per_rank)) == 1
    assert (tov > 0) == starve
    assert np.all(ta[~alive] == 0.0)


@pytest.mark.parametrize("mode", MODES)
def test_slices_sum_to_the_full_sweep(mode):
    """Each mode's near phase summed over 3 and 8 parts (no communicator:
    the parts added here) against the unsliced near phase, with starved
    budgets; the overflow is every part's."""
    pos, mass, alive = _blob()
    kw = dict(G_grav=1.0, eps2=EPS2, levels=LEVELS, ws=1, near=mode, _phase="near",
              box=tuple(torch.as_tensor(b) for b in BOX), **_budgets(mode, pos, alive, True))
    args = _t(pos, mass, alive)
    a1, U1, ov1 = tt.tree_acc_potential(*args, **kw)
    for parts in (3, 8):
        outs = [tt.tree_acc_potential(*args, _n_parts=parts, _part_index=r, **kw)
                for r in range(parts)]
        assert all(int(o[2]) == int(ov1) for o in outs)
        _close(sum(o[0] for o in outs).numpy(), a1.numpy())
        # U's near part is -G/2 sum m pe: linear in the slices
        assert abs(sum(float(o[1]) for o in outs) - float(U1)) <= 1e-6 * abs(float(U1))
    with pytest.raises(ValueError, match="_part_index"):
        tt.tree_acc_potential(*args, _n_parts=2, _part_index=2, **kw)


def test_b7_slices_cover_the_worklist():
    """B7's slice (``cuda_tree.tree_near_part_cuda``, its CPU path) over
    ``wl_span``'s parts at 1-8 ranks: the spans tile [0, parts * q_part)
    with q_part a multiple of the group, the clipped runs sweep every entry
    of the worklist once (their counts add up to the runs'), and the slices'
    rows add up to B7's over the whole worklist."""
    pos, mass, alive = _blob()
    args = [torch.from_numpy(x) for x in (pos, mass, alive)]
    M = 2 ** LEVELS
    box = tuple(torch.as_tensor(b) for b in BOX)
    k_ch, q = tw.tree_wl_budgets(pos, alive, levels=LEVELS, chunk=CHUNK, rj=RJ, box=BOX)
    pos32, _, _, m_eff, _, _, _, cc = tt._bin(*args, M, box, torch.float32)
    sc, sort_idx = tt._sort_cells(cc, args[2], M)
    for q_b in (q, q // 4):
        tab = tw._wl_table(sc, pos32[sort_idx], m_eff[sort_idx], sort_idx, len(pos), M, 1,
                           k_ch, CHUNK, q_b, RJ)
        kw = dict(wl_entries=q_b, chunk=CHUNK, rj=RJ, ws=1, eps2=EPS2)
        whole = cuda_tree.tree_near_cuda(tab["pbods"], tab["start_blk"], tab["n_blk"], **kw)
        for parts in (1, 2, 3, 8):
            spans = [tw.wl_span(q_b, parts, r) for r in range(parts)]
            q_part = spans[0][1]
            assert q_part % tw.WL_GROUP == 0 and q_part * parts >= q_b
            assert all(lo == r * q_part and hi == lo + q_part
                       for r, (lo, hi) in enumerate(spans))
            counts = sum(tw.clip_runs(tab["start_blk"], tab["n_blk"], *sp)[1]
                         for sp in spans)
            assert torch.equal(counts, tab["n_blk"].to(torch.int64))
            rows = sum(cuda_tree.tree_near_part_cuda(tab["pbods"], tab["start_blk"],
                                                     tab["n_blk"], tab["off"], span=sp, **kw)
                       for sp in spans)
            scale = float(whole.abs().max())
            assert float((rows - whole).abs().max()) <= 1e-6 * scale
    assert cuda_tree.tree_near_part_cuda.launches == 0  # CPU tensors never launch
    t = torch.zeros((4 * CHUNK * RJ, 8), device="meta")
    runs = torch.zeros((1, 9), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_tree.tree_near_part_cuda(t, runs, runs, runs, span=(0, 8), wl_entries=8,
                                      chunk=CHUNK, rj=RJ, ws=1, eps2=EPS2)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_b7_slice_from_offsets_matches_clip_and_jax(parts):
    """B7's slice cut from the runs' offsets (``_wl_table``'s ``off``, the
    kernel's in-kernel clip; its plain version ``tree_near_part_plain``)
    for every rank's span of ``wl_span``: the runs equal ``clip_runs``'
    from the cumsum, the rows equal ``clip_runs`` plus ``tree_near_plain``
    bit for bit, and they hold to JAX's ``q_part`` slice of its worklist
    (``_wl_expand`` cut to the span, ``_entry_math`` an entry, summed by slot
    in f64) within 1e-6 of max |row|; at 8 ranks the last rank's span lies
    in the padded tail and its slice is empty and 0. The offsets are int32
    and kept entries keep the offsets the whole worklist gives them."""
    pos, mass, alive = _blob()
    args = [torch.from_numpy(x) for x in (pos, mass, alive)]
    M = 2 ** LEVELS
    box = tuple(torch.as_tensor(b) for b in BOX)
    k_ch, q = tw.tree_wl_budgets(pos, alive, levels=LEVELS, chunk=CHUNK, rj=RJ, box=BOX)
    pos32, _, _, m_eff, _, _, _, cc = tt._bin(*args, M, box, torch.float32)
    sc, sort_idx = tt._sort_cells(cc, args[2], M)
    tab = tw._wl_table(sc, pos32[sort_idx], m_eff[sort_idx], sort_idx, len(pos), M, 1, k_ch,
                       CHUNK, q, RJ)
    start, n_blk, off = tab["start_blk"], tab["n_blk"], tab["off"]
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in (start, n_blk, off))
    cnt = n_blk.reshape(-1).long()
    assert torch.equal(off.reshape(-1).long()[cnt > 0], (torch.cumsum(cnt, 0) - cnt)[cnt > 0])
    kw = dict(wl_entries=q, chunk=CHUNK, rj=RJ, ws=1, eps2=EPS2)
    spans = [tw.wl_span(q, parts, r) for r in range(parts)]
    qp = spans[-1][1]
    wl_i, wl_jb, _ = jax.jit(jw._wl_expand, static_argnums=(2, 3, 4))(
        jnp.asarray(start.numpy()), jnp.asarray(n_blk.numpy()), k_ch, q, qp)
    wl_i, wl_jb = np.asarray(wl_i), np.asarray(wl_jb)
    rows_np, W = tab["pbods"].numpy(), RJ * CHUNK
    entry = jax.jit(jax.vmap(lambda i, j: jw._entry_math(i, j, 1, EPS2)))
    empty = []
    for lo, hi in spans:
        s_off, n_off = tw.clip_runs(start, n_blk, lo, hi, off=off)
        s_ref, n_ref = tw.clip_runs(start, n_blk, lo, hi)
        assert torch.equal(s_off, s_ref) and torch.equal(n_off, n_ref)
        got = cuda_tree.tree_near_part_cuda(tab["pbods"], start, n_blk, off, span=(lo, hi),
                                            **kw)
        assert torch.equal(got, cuda_tree.tree_near_plain(tab["pbods"], s_ref, n_ref, **kw))
        # JAX's slice of its worklist
        ii, jj = wl_i[lo:hi], wl_jb[lo:hi]
        live = ii < k_ch
        ref = np.zeros(((k_ch + 1) * CHUNK, 4))
        if live.any():
            ib = rows_np[ii[live, None] * CHUNK + np.arange(CHUNK)]
            jb = rows_np[jj[live, None] * W + np.arange(W)].transpose(0, 2, 1)
            res = np.asarray(entry(jnp.asarray(ib), jnp.asarray(jb)))[..., :4]
            np.add.at(ref, (ii[live, None] * CHUNK + np.arange(CHUNK)).reshape(-1),
                      res.reshape(-1, 4).astype(np.float64))
        assert int(n_off.sum()) == int(live.sum())
        ref = ref[:k_ch * CHUNK]
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-6 * scale
        empty.append(int(n_off.sum()) == 0)
    if parts == 8:  # the budgets' headroom lands on the last ranks
        assert empty[-1] and not any(empty[:2])
        assert not cuda_tree.tree_near_part_cuda(tab["pbods"], start, n_blk, off,
                                                 span=spans[-1], **kw).any()


def _plummer(n=128, seed=3):
    """The Plummer sphere of tests/test_parallel.py:386."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return r[:, None] * v, 0.05 * rng.normal(size=(n, 3)), np.full(n, 1.0 / n)


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def test_staged_route_matches_jax():
    """rollout_staged(mesh=) over 8 ranks (tests/test_parallel.py:664): the
    Plummer sphere at levels 3, near "pairs", 8 steps recorded every 4,
    against JAX's staged rollout over its 8 devices from the same state;
    overflow 0 in both, and against the port's unsharded staged rollout."""
    pos, vel, mass = _plummer()
    js = jot.make_state(pos, vel, mass, precision="f32")
    kch, entries = jt.tree_pairs_budgets(js.pos, js.alive, levels=3)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-3, force_impl="tree", tree_levels=3,
                         tree_near="pairs", tree_max_chunks=int(kch),
                         tree_pair_entries=tuple(int(e) for e in entries))
    jmesh = j_make_mesh()
    jfin, jtraj, jov = jro.rollout_staged(jro.init_forces_staged(js, jcfg, mesh=jmesh), jcfg,
                                          8, record_every=4, mesh=jmesh)
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    ts = _port_state(js)
    mesh = tot.make_mesh(shape=(8,), devices="cpu")
    fin, traj, ov = tro.rollout_staged(tro.init_forces_staged(ts, tcfg, mesh=mesh), tcfg, 8,
                                       record_every=4, mesh=mesh)
    one, one_traj, ov1 = tro.rollout_staged(tro.init_forces_staged(ts, tcfg), tcfg, 8,
                                            record_every=4)
    assert ov == int(jov) == ov1 == 0
    for ref, ref_traj in ((jfin, jtraj), (one, one_traj)):
        np.testing.assert_allclose(fin.pos.numpy(), np.asarray(ref.pos), rtol=0, atol=1e-6)
        np.testing.assert_allclose(traj.pos.numpy(), np.asarray(ref_traj.pos), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(traj.energy.numpy(), np.asarray(ref_traj.energy),
                                   rtol=1e-5)
        assert float(fin.potential) == pytest.approx(float(ref.potential), rel=1e-5)
    assert fin.n_bodies == 128 and int(fin.step) == 8


def test_simulate_mesh_tree_matches_jax(monkeypatch):
    """simulate(mesh=, force_impl="tree") against JAX's simulate(mesh=) on 4
    devices (the sharded step with the probed budgets, near "kernel"); with
    the thresholds lowered, as tests/test_tree.py:1107 does, the same call
    takes the staged route, rollout_staged with the mesh, and gives the
    same records."""
    import importlib

    from orbital_tpu.models.scene import SceneArrays as JScene
    from orbital_tpu_torch.models.scene import SceneArrays

    tsim = importlib.import_module("orbital_tpu_torch.simulate")
    pos, vel, mass = _plummer(256, seed=5)
    n = len(mass)
    kw = dict(pos=pos, vel=vel, mass=mass, radius=np.zeros(n),
              names=[f"b{i}" for i in range(n)])
    run = dict(steps=4, dt=1e-3, softening=0.03, force_impl="tree", tree_levels=4,
               tree_near="kernel", precision="f32", record_every=2)
    jmesh = j_make_mesh(shape=(4,), devices=jax.devices()[:4])
    tmesh = tot.make_mesh(shape=(4,), devices="cpu")
    seen = []
    inner = tsim.rollout_staged
    monkeypatch.setattr(tsim, "rollout_staged",
                        lambda *a, **k: seen.append(k["mesh"]) or inner(*a, **k))
    jres = jot.simulate(JScene(**kw, uuids=[f"u{i}" for i in range(n)]), mesh=jmesh,
                        rescale=jot.Rescale.identity(), **run)
    tres = tot.simulate(SceneArrays(**kw), mesh=tmesh, device="cpu",
                        rescale=tot.Rescale.identity(), **run)
    assert (tres.config.tree_max_chunks, tres.config.tree_wl_entries) == \
        (jres.config.tree_max_chunks, jres.config.tree_wl_entries)
    monkeypatch.setattr(tsim, "_STAGED_MIN_LEVELS", 4)
    monkeypatch.setattr(tsim, "_STAGED_MIN_N", 64)
    staged = tot.simulate(SceneArrays(**kw), mesh=tmesh, device="cpu",
                          rescale=tot.Rescale.identity(), **run)
    assert seen == [tmesh]
    for res in (tres, staged):
        np.testing.assert_allclose(res.pos, jres.pos, rtol=0, atol=1e-6)
        np.testing.assert_allclose(res.energy, jres.energy, rtol=1e-5)
