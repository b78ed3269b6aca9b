"""The tree's eager near modes of the PyTorch port (``tree_near="cells"``,
``"columns"``, ``"pairs"``), their probes and budgets, ``simulate()``'s
budget sizing and ``tree_accuracy=``, and ``SimulationEngine(force_impl=
"tree")`` with ``SimConfig``'s defaults, against the JAX package.

Scenes are the JAX package's own (tests/test_tree.py:739-830): a concentrated
blob of N = 1,024 at levels 4 (every 7th body dead here), chunks of 32; the
accuracy ladder on N = 512 at levels 2 (one JAX program a rung); inputs from
a numpy seed. Each JAX reference is compiled once per module. Tolerances, as
``test_torch_tree.py`` holds ``near="kernel"``:
  * probes, budgets, overflow counts and the chosen rung: equal;
  * evaluations: |da| <= 2e-6 RMS|a| + 1e-6 |a| per component and U to
    rel 1e-6 (per-body f32 sums of the same pairs in another order; the JAX
    package's own pairs-vs-cells tolerance, tests/test_tree.py:761-764, plus
    ~2 f32 ulps of a body's own acceleration, which a few close-pair bodies
    at ~10x the RMS need);
  * the engine: positions and velocities rel 1e-6 of their scale after
    ``step()`` and ``run(20)`` (f64 state on f32 tree forces ~1e-6 apart).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.ops import tree as jt
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import tree as tt
from orbital_tpu_torch.ops import tree_near_wl as tw

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

LEVELS, CHUNK, EPS2 = 4, 32, 1e-4
BOX = (np.zeros(3, np.float32), np.float32(4.0))
MODES = ("cells", "columns", "pairs")


def _blob(n, seed, dead=7):
    """Concentrated blob (tests/test_tree.py:748-751), every ``dead``-th
    body dead."""
    rng = np.random.default_rng(seed)
    pos = (rng.normal(0, 1, (n, 3)) * rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::dead] = False
    return pos, mass, alive


def _jbox(box):
    return None if box is None else (jnp.asarray(box[0]), jnp.asarray(box[1]))


def _rms(a):
    return float(np.sqrt(np.mean(np.sum(np.asarray(a, np.float64) ** 2, -1))))


@pytest.fixture(scope="module")
def blob():
    return _blob(1024, 0)


def _budgets(mode, pos, alive, ws, box, starve=False):
    """Probe-sized budgets of a mode (the port's probes, held equal to JAX's
    below), or short ones that drop bodies in every way the mode counts."""
    if mode == "pairs":
        k_ch, entries = tt.tree_pairs_budgets(pos, alive, levels=LEVELS, ws=ws, chunk=CHUNK,
                                              box=box)
        if starve:  # a short chunk table, starved octaves and the last octave missing
            return dict(max_chunks=k_ch // 2,
                        pair_entries=tuple(max(1, e // 3) for e in entries[:-1]))
        return dict(max_chunks=k_ch, pair_entries=entries, chunk=CHUNK)
    if mode == "columns":
        occ, ncol, nbig, nfront, nch = tt.tree_column_probe(pos, alive, levels=LEVELS, ws=ws,
                                                            box=box, with_chunks=True)
        if starve:  # capacity, columns, big and frontier lists and big chunks short
            return dict(capacity=max(40, occ // 2), max_cells=ncol - 4,
                        max_big=max(1, nbig - 2), max_frontier=max(1, nfront // 2),
                        max_chunks=max(1, nch // 2))
        return dict(capacity=occ + 8, max_cells=ncol + 32, max_big=nbig + 8,
                    max_frontier=nfront + 8, max_chunks=nch + 8)
    occ, ncell, nbig, nfront = tt.tree_class_probe(pos, alive, levels=LEVELS, ws=ws, box=box)
    if starve:
        return dict(capacity=max(20, occ // 2), max_cells=ncell - 8, max_big=max(1, nbig - 1),
                    max_frontier=max(1, nfront // 2))
    return dict(capacity=occ + 8, max_cells=ncell + 32, max_big=nbig + 8,
                max_frontier=nfront + 8)


# (mode, ws, order, box) of the JAX references, each with starved budgets so
# that the overflow is compared too
_J_CASES = {"cells": ("cells", 1, 1, None), "columns": ("columns", 1, 1, BOX),
            "pairs": ("pairs", 2, 1, BOX)}


@pytest.fixture(scope="module")
def jax_refs(blob):
    pos, mass, alive = blob
    out = {}
    for name, (mode, ws, order, box) in _J_CASES.items():
        kw = dict(G_grav=1.0, eps2=EPS2, levels=LEVELS, ws=ws, order=order, near=mode,
                  **_budgets(mode, pos, alive, ws, box, starve=True))
        a, U, ov = jt.tree_acc_potential(jnp.asarray(pos), jnp.asarray(mass),
                                         jnp.asarray(alive), box=_jbox(box), **kw)
        out[name] = dict(kw=kw, box=box, a=np.asarray(a), U=float(U), ov=int(ov))
    return out


def _port(pos, mass, alive, box=None, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (pos, mass, alive)]
    return tt.tree_acc_potential(*t, box=box, **kw)


# ---------------------------------------------------------------------------
# probes and slot maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws,box,dead", [(1, None, 7), (2, BOX, 3)])
def test_probes_equal_jax(blob, ws, box, dead):
    pos, _, _ = blob
    alive = _blob(1024, 0, dead)[2]
    jp, ja, jb = jnp.asarray(pos), jnp.asarray(alive), _jbox(box)
    ref = jt.tree_class_probe(jp, ja, levels=LEVELS, ws=ws, box=jb)
    assert tt.tree_class_probe(pos, alive, levels=LEVELS, ws=ws, box=box) == \
        tuple(int(v) for v in ref)
    ref = jt.tree_column_probe(jp, ja, levels=LEVELS, ws=ws, box=jb, with_chunks=True)
    got = tt.tree_column_probe(pos, alive, levels=LEVELS, ws=ws, box=box, with_chunks=True)
    assert got == tuple(int(v) for v in ref) and len(got) == 5
    assert tt.tree_column_probe(pos, alive, levels=LEVELS, ws=ws, box=box,
                                c_small=4) == tuple(
        int(v) for v in jt.tree_column_probe(jp, ja, levels=LEVELS, ws=ws, box=jb, c_small=4))
    for chunk in (32, 64):
        total, per = jt.tree_pairs_probe(jp, ja, levels=LEVELS, ws=ws, chunk=chunk, box=jb)
        assert tt.tree_pairs_probe(pos, alive, levels=LEVELS, ws=ws, chunk=chunk, box=box) \
            == (int(total), tuple(int(v) for v in per))
        assert tt.tree_pairs_budgets(pos, alive, levels=LEVELS, ws=ws, chunk=chunk,
                                     box=box) == jt.tree_pairs_budgets(
            jp, ja, levels=LEVELS, ws=ws, chunk=chunk, box=jb)
    # chunks past the last octave drop out of the counts in both packages
    total, per = jt.tree_pairs_probe(jp, ja, levels=LEVELS, ws=ws, n_octaves=2, box=jb)
    assert tt.tree_pairs_probe(pos, alive, levels=LEVELS, ws=ws, n_octaves=2, box=box) == \
        (int(total), tuple(int(v) for v in per))


def test_slot_maps_equal_jax(blob):
    """``_dense_slot_map`` and ``_lookup_slot`` on the sorted occupied cells
    (sentinel-padded), integer for integer."""
    import jax

    pos, _, alive = blob
    sc, n, M = tt._probe_sorted_cells(pos, alive, LEVELS, None)
    M3 = M ** 3
    first, _ = tt._segment_bounds(sc)
    rank = torch.arange(n) - first
    K = 600
    occ = tt._compact_sorted((rank == 0) & (sc < M3), sc, K, M3)
    assert int((occ < M3).sum()) < K  # sentinel padding present
    ref = jax.jit(jt._dense_slot_map, static_argnums=(1, 2))(jnp.asarray(occ.numpy()), K, M3)
    np.testing.assert_array_equal(tt._dense_slot_map(occ, K, M3).numpy(), np.asarray(ref))
    query = torch.cat([sc, torch.tensor([0, M3 - 1, M3 + 5])])
    ref = jax.jit(jt._lookup_slot)(jnp.asarray(occ.numpy()), jnp.asarray(query.numpy()))
    np.testing.assert_array_equal(tt._lookup_slot(occ, query).numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# evaluations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(_J_CASES))
def test_mode_matches_jax_with_starved_budgets(blob, jax_refs, case):
    """Each mode against the JAX package in the same mode with the same
    short budgets: acc, U, and the overflow (capacity and cell drops
    summed, as both packages return them), > 0."""
    ref = jax_refs[case]
    a, U, ov = _port(*blob, box=ref["box"], **ref["kw"])
    assert int(ov) == ref["ov"] > 0 and ov.dtype == torch.int32
    np.testing.assert_allclose(a.numpy(), ref["a"], rtol=1e-6, atol=2e-6 * _rms(ref["a"]))
    assert float(U) == pytest.approx(ref["U"], rel=1e-6)
    np.testing.assert_array_equal(a[~torch.from_numpy(blob[2])].numpy(), 0.0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ws,order,box", [(1, 1, None), (2, 2, BOX)])
def test_mode_matches_kernel_mode(blob, mode, ws, order, box):
    """With probe-sized budgets every mode sums the same near pairs as the
    port's ``"kernel"`` mode (B7's plain version on the CPU), with overflow
    0: the same far field, and near fields within f32 summation order."""
    pos, mass, alive = blob
    kw = dict(G_grav=1.0, eps2=EPS2, levels=LEVELS, ws=ws, order=order)
    k_ch, q = tw.tree_wl_budgets(pos, alive, levels=LEVELS, ws=ws, chunk=CHUNK, rj=4,
                                 box=box)
    a_k, U_k, ov_k = _port(pos, mass, alive, box, near="kernel", max_chunks=k_ch,
                           wl_entries=q, chunk=CHUNK, wl_rj=4, **kw)
    a, U, ov = _port(pos, mass, alive, box, near=mode,
                     **_budgets(mode, pos, alive, ws, box), **kw)
    assert int(ov) == int(ov_k) == 0
    np.testing.assert_allclose(a.numpy(), a_k.numpy(), rtol=1e-6, atol=2e-6 * _rms(a_k))
    assert float(U) == pytest.approx(float(U_k), rel=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_overflow_counts_short_budgets(blob, mode):
    """Every short budget is counted, never silent: the starved run's
    overflow is > 0, the far phase carries none, and the f64 compute type
    counts the same bodies."""
    pos, mass, alive = blob
    kw = dict(G_grav=1.0, eps2=EPS2, levels=LEVELS, near=mode,
              **_budgets(mode, pos, alive, 1, None, starve=True))
    _, _, ov = _port(pos, mass, alive, **kw)
    _, _, ov_far = _port(pos, mass, alive, _phase="far", **kw)
    _, _, ov64 = _port(pos, mass, alive, _dtype=torch.float64, **kw)
    assert int(ov) > 0 and int(ov_far) == 0 and int(ov64) == int(ov)
    if mode != "pairs":  # one short budget at a time: capacity alone
        full = _budgets(mode, pos, alive, 1, None)
        _, _, ov_cap = _port(pos, mass, alive, **dict(kw, **dict(full, capacity=20)))
        assert int(ov_cap) > 0


def test_dead_bodies_inert_in_every_mode():
    """Masked bodies exert and feel no force in every mode: the masked run
    equals the run on the live subset (same pinned box)."""
    pos, mass, alive = _blob(512, 4, dead=3)
    sub = alive.nonzero()[0]
    for mode in MODES:
        kw = dict(G_grav=1.0, eps2=EPS2, levels=LEVELS, near=mode)
        a_m, U_m, ov_m = _port(pos, mass, alive, BOX,
                               **_budgets(mode, pos, alive, 1, BOX), **kw)
        a_s, U_s, ov_s = _port(pos[sub], mass[sub], np.ones(len(sub), bool), BOX,
                               **_budgets(mode, pos[sub], None, 1, BOX), **kw)
        assert int(ov_m) == int(ov_s) == 0
        np.testing.assert_array_equal(a_m[~torch.from_numpy(alive)].numpy(), 0.0)
        np.testing.assert_allclose(a_m[torch.from_numpy(alive)].numpy(), a_s.numpy(),
                                   rtol=1e-6, atol=2e-6 * _rms(a_s))
        assert float(U_m) == pytest.approx(float(U_s), rel=1e-6)


def test_routing_passes_every_budget(blob, monkeypatch):
    """resolve_force_fn hands tree_acc_potential every budget of the config,
    and the default config (near="cells", capacity 48, lists from K) runs."""
    pos, mass, alive = blob
    seen = []
    inner = tt.tree_acc_potential

    def spy(*a, **k):
        seen.append(k)
        return inner(*a, **k)

    monkeypatch.setattr(tt, "tree_acc_potential", spy)
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2, force_impl="tree", tree_levels=LEVELS,
                        tree_near="pairs", tree_max_chunks=512, tree_pair_entries=(64, 32),
                        tree_capacity=40, tree_max_cells=300, tree_max_big=9,
                        tree_max_frontier=11, tree_wl_entries=7, tree_wl_rj=4)
    t = [torch.from_numpy(x) for x in (pos, mass, alive)]
    R.resolve_force_fn(cfg, len(pos), "cpu")(*t)
    R.resolve_force_fn(tot.SimConfig(dt=1e-3, eps2=EPS2, force_impl="tree"), len(pos),
                       "cpu")(*t)
    want = dict(near="pairs", max_chunks=512, pair_entries=(64, 32), capacity=40,
                max_cells=300, max_big=9, max_frontier=11, wl_entries=7, wl_rj=4, chunk=32)
    assert {k: seen[0][k] for k in want} == want
    assert seen[1]["near"] == "cells" and seen[1]["capacity"] == 48


# ---------------------------------------------------------------------------
# simulate(): budgets, tree_capacity, tree_accuracy
# ---------------------------------------------------------------------------

def _states(pos, vel, mass, alive=None):
    js = jot.make_state(pos.astype(np.float64), vel, mass.astype(np.float64), precision="f32")
    fields = {f: np.asarray(getattr(js, f)) if getattr(js, f) is not None else None
              for f in ("pos", "vel", "mass", "radius", "alive", "acc", "potential", "time",
                        "step", "pos_lo", "vel_lo")}
    if alive is not None:
        js = js.replace(alive=jnp.asarray(alive))
        fields["alive"] = alive
    return js, state_from_arrays(fields, device="cpu")


_BUDGET_FIELDS = ("tree_levels", "tree_near", "tree_capacity", "tree_max_cells", "tree_max_big",
                  "tree_max_frontier", "tree_max_chunks", "tree_chunk", "tree_pair_entries",
                  "tree_wl_entries")


@pytest.mark.parametrize("near", ["cells", "columns", "pairs", "kernel"])
@pytest.mark.parametrize("capacity,levels", [("auto", 4), (64, "auto")])
def test_simulate_budgets_equal_jax(blob, near, capacity, levels):
    """simulate()'s budget sizing (``_tree_budget_cfg``) equals the JAX
    package's on the same state: per cell, per column, per chunk octave or
    per worklist, with ``tree_capacity`` an int or "auto" and
    ``tree_levels`` an int or "auto"."""
    jsim = sys.modules["orbital_tpu.simulate"]

    sim = sys.modules["orbital_tpu_torch.simulate"]
    pos, mass, alive = blob
    js, ts = _states(pos, np.zeros_like(pos, np.float64), mass, alive)
    # simulate() builds its config with the requested mode, then sizes it
    kw = dict(dt=1e-3, eps2=EPS2, force_impl="tree", tree_wl_rj=4, tree_near=near,
              pm_box=(0.0, 0.0, 0.0, 4.0))
    args = dict(tree_near=near, tree_levels=levels, tree_capacity=capacity)
    jc = jsim._tree_budget_cfg(jot.SimConfig(**kw), js, **args)
    tc = sim._tree_budget_cfg(tot.SimConfig(**kw), ts, **args)
    assert {f: getattr(tc, f) for f in _BUDGET_FIELDS} == \
        {f: getattr(jc, f) for f in _BUDGET_FIELDS}


def test_tree_capacity_auto_raises_as_jax():
    """A cell (above 4,096 bodies with headroom) or a column (above 16,384)
    too dense for "auto" raises the JAX package's ValueError in both
    packages; so does a bad tree_capacity string."""
    jsim = sys.modules["orbital_tpu.simulate"]

    sim = sys.modules["orbital_tpu_torch.simulate"]
    rng = np.random.default_rng(5)
    n = 11008
    pos = np.concatenate([rng.normal(0, 1e-4, (n - 8, 3)), rng.normal(0, 1, (8, 3))])
    js, ts = _states(pos.astype(np.float32), np.zeros((n, 3)), np.ones(n, np.float32))
    for near, unit in (("cells", "cell"), ("columns", "column")):
        for mod, state, cls in ((jsim, js, jot.SimConfig), (sim, ts, tot.SimConfig)):
            with pytest.raises(ValueError, match=f"densest {unit} holds [0-9]+ bodies"):
                mod._tree_budget_cfg(cls(dt=1e-3, eps2=EPS2, force_impl="tree"), state,
                                     tree_near=near, tree_levels=2, tree_capacity="auto")
    with pytest.raises(ValueError, match="tree_capacity must be"):
        tot.simulate(_scene(64), steps=1, dt=1e-4, softening=1e-2, device="cpu",
                     force_impl="tree", tree_capacity="big")


def _scene(n=256, seed=9):
    from orbital_tpu_torch.models.scene import SceneArrays

    pos, mass, _ = _blob(n, seed)
    vel = 0.1 * np.random.default_rng(seed).normal(size=(n, 3))
    return SceneArrays(pos=pos.astype(np.float64), vel=vel, mass=mass.astype(np.float64) * 1e4,
                       radius=np.full(n, 1e-3), names=[f"b{i}" for i in range(n)])


@pytest.mark.parametrize("near", MODES)
def test_simulate_runs_each_mode(near, monkeypatch):
    """simulate(force_impl="tree", tree_near=...) runs each mode end to end
    on its probed budgets (the end-of-run probe of that mode finds them not
    outgrown), and starved budgets make that probe warn."""
    sim = sys.modules["orbital_tpu_torch.simulate"]
    res = tot.simulate(_scene(), steps=4, dt=1e-4, softening=1e-2, device="cpu",
                       force_impl="tree", precision="f32", record_every=2, tree_levels=LEVELS,
                       tree_near=near)
    assert res.config.tree_near == near and np.isfinite(res.pos).all()
    assert not sim._tree_outgrown(res.config, res.final_state)
    short = res.config.replace(tree_max_chunks=1, tree_pair_entries=(1,), tree_capacity=1,
                               tree_max_cells=1)
    assert sim._tree_outgrown(short, res.final_state)


@pytest.fixture(scope="module")
def ladder_states():
    """The accuracy ladder's scene: 512 blob bodies (levels 2, so that each
    rung is a small JAX program), f32."""
    pos, mass, _ = _blob(512, 6)
    mass = mass / 512
    return _states(pos, np.zeros((512, 3)), mass)


@pytest.mark.parametrize("target", [1e-1, 1e-2])
def test_tree_accuracy_picks_jax_rung(ladder_states, target):
    """tree_accuracy= walks the (order, ws) ladder and takes the first rung
    whose measured RMS force error meets the target: the JAX package's
    rung, with its budgets."""
    jsim = sys.modules["orbital_tpu.simulate"]

    sim = sys.modules["orbital_tpu_torch.simulate"]
    js, ts = ladder_states
    kw = dict(dt=1e-3, eps2=EPS2, force_impl="tree", tree_near="pairs")
    args = dict(target=target, tree_near="pairs", tree_levels=2, tree_capacity="auto")
    jc = jsim._tree_accuracy_probe(jot.SimConfig(**kw), js, **args)
    tc = sim._tree_accuracy_probe(tot.SimConfig(**kw), ts, **args)
    assert (tc.tree_order, tc.tree_ws) == (jc.tree_order, jc.tree_ws)
    assert {f: getattr(tc, f) for f in _BUDGET_FIELDS} == \
        {f: getattr(jc, f) for f in _BUDGET_FIELDS}


def test_tree_accuracy_raises_when_no_rung_meets(ladder_states):
    """An unreachable target raises JAX's ValueError, listing every rung's
    measured error: the port's within 1e-2 relative of JAX's (the message
    keeps 3 digits) or 1e-7 absolute (the ws 2 rungs sit at the f32 floor,
    ~1e-6, where two summation orders part)."""
    import re

    jsim = sys.modules["orbital_tpu.simulate"]

    sim = sys.modules["orbital_tpu_torch.simulate"]
    js, ts = ladder_states
    kw = dict(dt=1e-3, eps2=EPS2, force_impl="tree", tree_near="pairs")
    args = dict(target=1e-9, tree_near="pairs", tree_levels=2, tree_capacity="auto")
    msgs = []
    for mod, state, cls in ((jsim, js, jot.SimConfig), (sim, ts, tot.SimConfig)):
        with pytest.raises(ValueError, match="no tree configuration meets") as err:
            mod._tree_accuracy_probe(cls(**kw), state, **args)
        msgs.append([float(x) for x in re.findall(r": ([0-9.]+e[-+][0-9]+)", str(err.value))])
    assert len(msgs[0]) == len(msgs[1]) == 4
    np.testing.assert_allclose(msgs[1], msgs[0], rtol=1e-2, atol=1e-7)


def test_simulate_tree_accuracy_end_to_end():
    res = tot.simulate(_scene(), steps=2, dt=1e-4, softening=1e-2, device="cpu",
                       force_impl="tree", precision="f32", record_every=2, tree_levels=LEVELS,
                       tree_near="columns", tree_accuracy=1e-1)
    assert (res.config.tree_order, res.config.tree_ws) == (1, 1)
    assert np.isfinite(res.pos).all()


# ---------------------------------------------------------------------------
# the facade with SimConfig's defaults
# ---------------------------------------------------------------------------

def test_engine_tree_with_default_config_matches_jax():
    """SimulationEngine(force_impl="tree") runs with SimConfig's tree
    defaults (near="cells", capacity 48, levels 6) as the JAX engine does:
    step() then run(20), against the JAX engine. The scene is in the ASTRO
    profile (AU, solar masses, days): at SI magnitudes the f32 far field's
    coarse-level tap weights (~G r^2 / R^5) fall below f32's normal range,
    where XLA on the CPU flushes them to 0 and torch keeps them, so the two
    far fields part by ~0.5% there."""
    rng = np.random.default_rng(11)
    n = 96
    pos = rng.normal(0, 1.0, (n, 3))
    vel = rng.normal(0, 5e-3, (n, 3))
    mass = rng.uniform(0.5, 1.5, n) * 1e-3

    def objects(pkg):
        return pkg.ObjectCollection([
            pkg.Object(mass=float(m), radius=1e-6, velocity=v.copy(),
                       coordinates=pkg.Coordinates(*p.tolist()))
            for m, v, p in zip(mass, vel, pos)])

    kw = dict(dt=0.5, softening=1e-2, cache=False, max_hist=None, force_impl="tree")
    je = jot.SimulationEngine(objects(jot), unit_profile=jot.ASTRO, **kw)
    te = tot.SimulationEngine(objects(tot), unit_profile=tot.ASTRO, device="cpu", **kw)
    assert te.config.tree_near == je.config.tree_near == "cells"
    for drive in (lambda e: e.step(), lambda e: e.run(20)):
        drive(je)
        drive(te)
        for f in ("pos", "vel"):
            ref = np.asarray(getattr(je.state, f), np.float64)
            got = getattr(te.state, f).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f)
    assert te.step_idx == je.step_idx == 21
