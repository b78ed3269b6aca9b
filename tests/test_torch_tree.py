"""The tree force solver of the PyTorch port (``force_impl="tree"``,
``tree_near="kernel"``) against the JAX package's: cell and octant ids, the
worklist geometry and budgets, the probes, the far-field conv weights, the
far field, the near sweep (JAX's Pallas kernel B7 in interpret mode, the
port's CUDA wrapper on its CPU path), the whole evaluation, KDK rollouts,
simulate() and the routing.

Sizes are the JAX package's own (tests/test_tree.py): a concentrated blob of
N = 1,024 at levels 4 (N = 512 at levels 3 for order 2, whose JAX program
takes longest to compile), chunk 32, j-blocks of 4 chunks; inputs from a
numpy seed. Each JAX reference is compiled once per module, and the order-1
whole evaluation's reference is JAX's far phase plus its near phase, so that
three JAX programs serve every evaluation test. Tolerances:
  * ids, worklists, budgets, probes and overflow counts: equal.
  * conv weights: max |dw| <= 4e-6 max |w| per tensor (the same f32
    formulas; rsqrt may differ by an ulp between XLA and torch, and order
    2's T_ijk carries it to the 7th power through partly cancelling terms:
    measured 1.06e-6 of max |w| at ws = 2).
  * far field: max |da| <= 1e-6 RMS|a| and U to rel 1e-6 (f32 conv sums in
    another order).
  * near field and whole evaluations: max |da| <= 2e-6 RMS|a| and U to rel
    1e-6, the JAX package's own kernel-vs-cells tolerance
    (tests/test_tree.py:988-991): per-body f32 sums of up to a few hundred
    pairs in another order.
  * KDK rollouts over 10 steps at dt = 1e-3: atol 1e-7 on positions and
    velocities (forces ~1e-6 relative apart move the state by ~dt |da|);
    the recorded energies rel 1e-5 (the f32 tree potential).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.ops import tree as jt
from orbital_tpu.ops import tree_near_wl as jw
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.models.scene import SceneArrays
from orbital_tpu_torch.ops import cuda_tree
from orbital_tpu_torch.ops import tree as tt
from orbital_tpu_torch.ops import tree_near_wl as tw

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

CHUNK, RJ = 32, 4
F32 = torch.float32
BOX = (np.zeros(3, np.float32), np.float32(4.0))
EPS2 = 1e-4


def _blob(n, seed):
    """Concentrated blob (tests/test_tree.py:974-977) with every 7th body
    dead."""
    rng = np.random.default_rng(seed)
    pos = (rng.normal(0, 1, (n, 3)) * rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::7] = False
    return pos, mass, alive


def _jbox(box):
    return None if box is None else (jnp.asarray(box[0]), jnp.asarray(box[1]))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rms(a):
    return float(np.sqrt(np.mean(np.sum(np.asarray(a, np.float64) ** 2, -1))))


@pytest.fixture(scope="module")
def blob():
    return _blob(1024, 0)


# the JAX package's evaluations, each compiled once for this module
_J_CASES = {
    # (phase, order, levels, ws, box, budgets): the far and the near phase
    # (the interpret-mode B7 with overflow) at order 1 in a pinned box with
    # starved budgets, and order 2's whole evaluation
    "o1_far": ("far", 1, 4, 1, BOX, "starved"),
    "o1_near": ("near", 1, 4, 1, BOX, "starved"),
    "o2_starved": ("both", 2, 3, 1, None, "starved"),
}


def _budgets(pos, alive, levels, ws, box, kind):
    if kind == "probed":
        return tw.tree_wl_budgets(pos, alive, levels=levels, ws=ws, chunk=CHUNK, rj=RJ, box=box)
    total, entries = tw.tree_wl_probe(pos, alive, levels=levels, ws=ws, chunk=CHUNK, rj=RJ,
                                      box=box)
    return total - total // 4, entries // 4


@pytest.fixture(scope="module")
def jax_refs():
    out = {}
    for name, (phase, order, levels, ws, box, kind) in _J_CASES.items():
        n = 1024 if levels == 4 else 512
        pos, mass, alive = _blob(n, levels)
        k_ch, q = _budgets(pos, alive, levels, ws, box, kind)
        kw = dict(G_grav=1.0, eps2=EPS2, levels=levels, ws=ws, order=order, near="kernel",
                  max_chunks=k_ch, wl_entries=q, chunk=CHUNK, wl_rj=RJ, _phase=phase)
        a, U, ov = jt.tree_acc_potential(jnp.asarray(pos), jnp.asarray(mass),
                                         jnp.asarray(alive), box=_jbox(box), **kw)
        out[name] = dict(pos=pos, mass=mass, alive=alive, box=box, kw=kw,
                         a=np.asarray(a), U=float(U), ov=int(ov))
    # order 1's whole evaluation on the same bodies: JAX's "both" is the sum
    # of its two phases (tree.py's _phase contract)
    far, near = out["o1_far"], out["o1_near"]
    out["o1"] = dict(far, kw=dict(far["kw"], _phase="both"), a=far["a"] + near["a"],
                     U=far["U"] + near["U"], ov=near["ov"])
    return out


def _port_eval(ref, **over):
    kw = dict(ref["kw"], **over)
    return tt.tree_acc_potential(*_t(ref["pos"], ref["mass"], ref["alive"]), box=ref["box"],
                                 **kw)


# ---------------------------------------------------------------------------
# ids, geometry, probes, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("box", [None, BOX])
def test_cell_and_octant_ids(blob, box):
    """Sorted cell ids equal JAX's (same box fit, clipping and dead-body
    sentinel); every live body's octant-major far id decodes, through the
    far field's center table, to the body's own cell."""
    pos, _, alive = blob
    levels = 4
    sc_j, n_j, M_j = jt._probe_sorted_cells(jnp.asarray(pos), jnp.asarray(alive), levels,
                                            _jbox(box))
    sc_t, n_t, M_t = tt._probe_sorted_cells(pos, alive, levels, box)
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    assert (n_t, M_t) == (n_j, M_j)
    M = 2 ** levels
    p, m, a = _t(pos, np.ones(len(pos), np.float32), alive)
    *_, cc = tt._bin(p, m, a, M, box, F32)
    far_id = tt._far_ids(cc, a, M)
    assert bool((far_id[~a] == M ** 3).all())
    ctr = tt._octant_centers(levels, "cpu", F32)
    for k in range(3):
        np.testing.assert_array_equal(ctr[k][far_id[a]].numpy(), cc[a, k].float().numpy())


@pytest.mark.parametrize("starve", [1, 3])
def test_wl_expand_equals_jax(blob, starve):
    """The flattened worklist, with the budget that fits every run and with
    one third of it (whole chunks dropped), integer for integer."""
    pos, _, alive = blob
    levels, ws = 4, 1
    sc, n, M = tt._probe_sorted_cells(pos, alive, levels, None)
    k_ch = -(-n // CHUNK) + min(n, M * M)
    kpad = -(-(k_ch + 1) // RJ) * RJ
    g = tt._pairs_geometry(sc, n, M, ws, CHUNK, k_ch)
    start, cnt = tw._wl_runs(g, RJ, k_ch, kpad)
    q = int(cnt.sum()) // starve
    qp = -(-q // 8) * 8
    expand = jax.jit(jw._wl_expand, static_argnums=(2, 3, 4))
    ref = expand(jnp.asarray(start.numpy(), jnp.int32), jnp.asarray(cnt.numpy(), jnp.int32),
                 k_ch, q, qp)
    got = tw._wl_expand(start, cnt, k_ch, q, qp)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(got[2].any()) == (starve > 1)


@pytest.mark.parametrize("levels,ws,box", [(4, 1, None), (5, 2, BOX)])
def test_probes_equal_jax(blob, levels, ws, box):
    pos, _, alive = blob
    jp, ja = jnp.asarray(pos), jnp.asarray(alive)
    ref = jw.tree_wl_probe(jp, ja, levels=levels, ws=ws, chunk=CHUNK, rj=RJ, box=_jbox(box))
    assert tw.tree_wl_probe(pos, alive, levels=levels, ws=ws, chunk=CHUNK, rj=RJ,
                            box=box) == tuple(int(v) for v in ref)
    assert tw.tree_wl_budgets(pos, alive, levels=levels, ws=ws, chunk=CHUNK, rj=RJ,
                              box=box) == jw.tree_wl_budgets(jp, ja, levels=levels, ws=ws,
                                                             chunk=CHUNK, rj=RJ, box=_jbox(box))
    ref = jt.tree_occupancy_probe(jp, ja, levels=levels, box=_jbox(box))
    assert tt.tree_occupancy_probe(torch.from_numpy(pos), torch.from_numpy(alive),
                                   levels=levels, box=box) == tuple(int(v) for v in ref)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("ws", [1, 2])
def test_conv_weights_equal_jax(order, ws):
    """Every x-slab of the port's 3-D weights is JAX's 2-D slab."""
    h, G = 0.171875, 1.7
    ref = jax.jit(jt._conv_weights, static_argnums=(0, 2, 3, 4))(ws, jnp.float32(h), G,
                                                                 EPS2, order)
    got = tt._conv_weights(ws, torch.tensor(h, dtype=F32), G, EPS2, order)
    assert got.shape[-3:] == (2 * ws + 1,) * 3
    for Dx, w in ref.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[:, :, Dx + ws].numpy(), w, rtol=0,
                                   atol=4e-6 * np.abs(w).max())
    assert len(tt.tree_stencil(ws)) == (4 * ws + 3) ** 3 - (2 * ws + 1) ** 3


# ---------------------------------------------------------------------------
# far field, near sweep, whole evaluation
# ---------------------------------------------------------------------------

def test_far_field_matches_jax(jax_refs):
    ref = jax_refs["o1_far"]
    a, U, ov = _port_eval(ref)
    scale = _rms(ref["a"])
    np.testing.assert_allclose(a.numpy(), ref["a"], rtol=0, atol=1e-6 * scale)
    assert float(U) == pytest.approx(ref["U"], rel=1e-6)
    assert int(ov) == 0 and a.dtype == F32


def test_near_wrapper_cpu_path_matches_jax_kernel(jax_refs, monkeypatch):
    """The near phase in a pinned box with starved budgets: the port's B7
    wrapper on CPU tensors (its plain version) against JAX's Pallas kernel
    run in interpret mode, per body, with equal overflow counts. (ws = 2
    meets JAX in test_entry_math_matches_jax and test_probes_equal_jax.)"""
    ref = jax_refs["o1_near"]
    calls = []
    inner = cuda_tree.tree_near_cuda

    def spy(*a, **k):
        calls.append(k)
        return inner(*a, **k)

    monkeypatch.setattr(cuda_tree, "tree_near_cuda", spy)
    a, U, ov = _port_eval(ref)
    assert len(calls) == 1 and calls[0]["ws"] == 1
    assert int(ov) == ref["ov"] > 0
    np.testing.assert_allclose(a.numpy(), ref["a"], rtol=0, atol=2e-6 * _rms(ref["a"]))
    assert float(U) == pytest.approx(ref["U"], rel=1e-6)


def test_entry_math_matches_jax():
    """One (i-chunk, j-block) entry with sentinel rows, a self pair and cells
    outside the band, against JAX's ``_entry_math``."""
    rng = np.random.default_rng(3)
    c, w, n = 8, 32, 100
    rows = np.zeros((c + w, 8), np.float32)
    rows[:, :3] = rng.normal(size=(c + w, 3))
    rows[:, 3] = rng.uniform(0.5, 1.5, c + w)
    rows[:, 4] = rng.permutation(n)[:c + w]
    rows[:, 5:] = rng.integers(3, 6, (c + w, 3))
    rows[c + 2, :] = rows[1, :]                                   # the self pair
    rows[c + 5:c + 9, :] = (1e30, 1e30, 1e30, 0.0, n, 1e9, 1e9, 1e9)  # sentinels
    rows[6, :] = (1e30, 1e30, 1e30, 0.0, n, 1e9, 1e9, 1e9)
    ib, jb = rows[:c], rows[c:].T.copy()
    for ws in (1, 2):
        ref = np.asarray(jw._entry_math(jnp.asarray(ib), jnp.asarray(jb), ws, EPS2))
        got = tw._entry_math(torch.from_numpy(ib), torch.from_numpy(jb), ws, EPS2).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6 * np.abs(ref[:, :4]).max())


@pytest.mark.parametrize("case", ["o1", "o2_starved"])
def test_tree_matches_jax(jax_refs, case):
    """Whole evaluations with dead bodies and starved budgets (equal overflow
    counts): order 1 in a pinned box, and order 2."""
    ref = jax_refs[case]
    a, U, ov = _port_eval(ref)
    assert int(ov) == ref["ov"] > 0
    np.testing.assert_allclose(a.numpy(), ref["a"], rtol=0, atol=2e-6 * _rms(ref["a"]))
    assert float(U) == pytest.approx(ref["U"], rel=1e-6)
    np.testing.assert_array_equal(a[~torch.from_numpy(ref["alive"])].numpy(), 0.0)


@pytest.mark.parametrize("case", ["o1", "o2_starved"])
def test_far_plus_near_is_both(jax_refs, case):
    """The far phase plus the near phase equals the single call, and so does
    the staged evaluation; the near phase carries the whole overflow."""
    ref = jax_refs[case]
    kw = {k: v for k, v in ref["kw"].items() if k != "_phase"}
    args = _t(ref["pos"], ref["mass"], ref["alive"])
    a, U, ov = tt.tree_acc_potential(*args, box=ref["box"], **kw)
    a_f, U_f, ov_f = tt.tree_acc_potential(*args, box=ref["box"], _phase="far", **kw)
    a_n, U_n, ov_n = tt.tree_acc_potential(*args, box=ref["box"], _phase="near", **kw)
    np.testing.assert_array_equal((a_f + a_n).numpy(), a.numpy())
    assert float(U_f + U_n) == float(U) and int(ov_f) == 0 and int(ov_n) == int(ov)
    a_s, U_s, ov_s = tt.tree_acc_potential_staged(*args, box=ref["box"], **kw)
    np.testing.assert_array_equal(a_s.numpy(), a.numpy())
    assert float(U_s) == float(U) and int(ov_s) == int(ov)


def test_dead_bodies_parked_far_are_inert():
    """Dead bodies parked far away (as the state pads them) exert and feel
    no force: the masked run equals the run on the live subset."""
    from orbital_tpu_torch.engine.state import far_positions

    pos, mass, alive = _blob(1024, 5)
    pos[~alive] = far_positions(int((~alive).sum()), float(np.abs(pos).max()), np.float32)
    levels = 4
    kw = dict(G_grav=1.0, eps2=EPS2, levels=levels, near="kernel", chunk=CHUNK, wl_rj=RJ)
    k_m, q_m = tw.tree_wl_budgets(pos, alive, levels=levels, chunk=CHUNK, rj=RJ)
    a_m, U_m, ov_m = tt.tree_acc_potential(*_t(pos, mass, alive), max_chunks=k_m,
                                           wl_entries=q_m, **kw)
    sub = alive.nonzero()[0]
    k_s, q_s = tw.tree_wl_budgets(pos[sub], levels=levels, chunk=CHUNK, rj=RJ)
    a_s, U_s, ov_s = tt.tree_acc_potential(*_t(pos[sub], mass[sub]), max_chunks=k_s,
                                           wl_entries=q_s, **kw)
    assert int(ov_m) == int(ov_s) == 0
    assert bool(torch.isfinite(a_m).all())
    np.testing.assert_array_equal(a_m[~torch.from_numpy(alive)].numpy(), 0.0)
    np.testing.assert_allclose(a_m[torch.from_numpy(alive)].numpy(), a_s.numpy(), rtol=0,
                               atol=2e-6 * _rms(a_s.numpy()))
    assert float(U_m) == pytest.approx(float(U_s), rel=1e-6)


def test_f64_compute_type_agrees_with_f32(jax_refs):
    """``_dtype=float64`` (the reference of the card's checks) computes the
    same tree: the f32 evaluation sits within f32 rounding of it."""
    ref = jax_refs["o1"]
    a32, U32, _ = _port_eval(ref)
    a64, U64, _ = _port_eval(ref, _dtype=torch.float64)
    assert a64.dtype == F32  # returned in the input's type
    np.testing.assert_allclose(a32.numpy(), a64.numpy(), rtol=0, atol=2e-6 * _rms(ref["a"]))
    assert float(U32) == pytest.approx(float(U64), rel=1e-6)


# ---------------------------------------------------------------------------
# rollouts, simulate(), routing
# ---------------------------------------------------------------------------

def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")


@pytest.mark.parametrize("precision", ["f32", "ds32"])
def test_kdk_rollout_matches_jax(precision):
    """10 KDK steps on the tree force (levels 3, a pinned box) against
    JAX's compiled rollout. Both start from the port's ``init_forces`` (the
    same tree evaluation as every step's; JAX's would be one more compile of
    it)."""
    pos, mass, _ = _blob(256, 7)
    mass = mass / 256  # total mass ~1, as the cluster scenes
    vel = 0.3 * np.random.default_rng(8).normal(size=(256, 3))
    levels = 3
    k_ch, q = tw.tree_wl_budgets(pos, levels=levels, chunk=CHUNK, rj=RJ, box=BOX)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=EPS2, force_impl="tree", tree_levels=levels,
                         tree_near="kernel", tree_chunk=CHUNK, tree_wl_rj=RJ,
                         tree_max_chunks=k_ch, tree_wl_entries=q,
                         pm_box=(0.0, 0.0, 0.0, float(BOX[1])))
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.make_state(pos, vel, mass, precision=precision)
    ts = tot.init_forces(_port_state(js), tcfg)
    js = js.replace(acc=jnp.asarray(ts.acc.numpy()), potential=jnp.asarray(ts.potential.numpy()))
    jf, jtr = jot.rollout_jit(js, jcfg, 10, 5)
    tf, ttr = tot.rollout(ts, tcfg, 10, 5)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(ttr, f).numpy(), np.asarray(getattr(jtr, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(ttr.energy.numpy(), np.asarray(jtr.energy), rtol=1e-5)
    assert int(tf.step) == 10 and (tf.pos_lo is not None) == (precision == "ds32")


def _scene(n=256, seed=9):
    pos, mass, _ = _blob(n, seed)
    vel = 0.1 * np.random.default_rng(seed).normal(size=(n, 3))
    return SceneArrays(pos=pos.astype(np.float64), vel=vel, mass=mass.astype(np.float64) * 1e4,
                       radius=np.full(n, 1e-3), names=[f"b{i}" for i in range(n)])


def _sim(scene, **kw):
    args = dict(steps=10, dt=1e-4, softening=1e-2, device="cpu", force_impl="tree",
                precision="f32", record_every=5, tree_wl_rj=RJ)
    args.update(kw)
    return tot.simulate(scene, **args)


def test_simulate_tree_budgets_and_auto(blob):
    """simulate() resolves tree_near='auto' to 'kernel' and sizes the budgets
    with tree_wl_budgets (equal to JAX's, test_probes_equal_jax) on the
    internal-unit state; 'auto' levels take the smallest of 5-8 whose
    densest cell holds <= 64 bodies."""
    scene = _scene()
    res = _sim(scene, tree_levels=4)
    c = res.config
    assert c.tree_near == "kernel" and c.tree_levels == 4
    pos_i = (scene.pos / res.rescale.length).astype(np.float32)
    ref = tw.tree_wl_budgets(pos_i, levels=4, ws=1, chunk=CHUNK, rj=RJ)
    assert (c.tree_max_chunks, c.tree_wl_entries) == ref
    assert res.pos.shape == (2, 256, 3) and np.isfinite(res.pos).all()
    auto = _sim(scene, tree_levels="auto", steps=5, record_every=5)
    occ = {lv: tt.tree_occupancy_probe(np.asarray(pos_i), levels=lv)[0] for lv in (5, 6, 7)}
    want = next((lv for lv in (5, 6, 7) if occ[lv] <= 64), 8)
    assert auto.config.tree_levels == want


def test_simulate_routes_large_tree_to_staged(monkeypatch):
    """At the staged shape (thresholds lowered here) simulate() takes
    rollout_staged, whose trajectory equals the single-call rollout's."""
    sim_mod = sys.modules["orbital_tpu_torch.simulate"]
    scene = _scene()
    plain = _sim(scene, tree_levels=4)
    calls = []
    orig = sim_mod.rollout_staged

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(sim_mod, "_STAGED_MIN_LEVELS", 4)
    monkeypatch.setattr(sim_mod, "_STAGED_MIN_N", 64)
    monkeypatch.setattr(sim_mod, "rollout_staged", spy)
    staged = _sim(scene, tree_levels=4)
    assert calls
    for f in ("pos", "vel", "energy"):
        np.testing.assert_array_equal(getattr(staged, f), getattr(plain, f))


def test_simulate_warns_on_outgrown_budgets(monkeypatch):
    """Starved budgets: the end-of-run probe warns on the compiled-loop path
    and the per-step overflow check warns on the staged path."""
    sim_mod = sys.modules["orbital_tpu_torch.simulate"]
    monkeypatch.setattr(sim_mod, "tree_wl_budgets", lambda *a, **k: (8, 4))
    scene = _scene()
    with pytest.warns(RuntimeWarning, match="outgrown"):
        _sim(scene, tree_levels=4)
    monkeypatch.setattr(sim_mod, "_STAGED_MIN_LEVELS", 4)
    monkeypatch.setattr(sim_mod, "_STAGED_MIN_N", 64)
    with pytest.warns(RuntimeWarning) as seen:
        _sim(scene, tree_levels=4)
    said = " ".join(str(w.message) for w in seen)
    assert "overflow" in said and "outgrown" in said


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_tree_routes_to_the_b7_wrapper(blob, device, monkeypatch):
    """resolve_force_fn builds the tree force on any device; its near sweep
    goes through the B7 wrapper (which runs the kernel for CUDA tensors)."""
    pos, mass, alive = blob
    calls = []
    inner = cuda_tree.tree_near_cuda

    def shim(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(cuda_tree, "tree_near_cuda", shim)
    k_ch, q = tw.tree_wl_budgets(pos, alive, levels=4, chunk=CHUNK, rj=RJ)
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2, force_impl="tree", tree_levels=4,
                        tree_near="kernel", tree_wl_rj=RJ, tree_max_chunks=k_ch,
                        tree_wl_entries=q)
    acc, U = R.resolve_force_fn(cfg, len(pos), device)(*_t(pos, mass, alive))
    assert calls == [1] and acc.shape == (len(pos), 3) and U.dim() == 0


@pytest.mark.parametrize("near", ["cells", "columns", "pairs"])
def test_unported_near_modes_raise(near):
    cfg = tot.SimConfig(dt=1.0, eps2=EPS2, force_impl="tree", tree_near=near)
    with pytest.raises(NotImplementedError, match="A.13"):
        R.resolve_force_fn(cfg, 8192, "cpu")
    with pytest.raises(NotImplementedError, match="A.13"):
        _sim(_scene(), tree_near=near)


def test_unported_tree_options_raise(blob):
    pos, mass, alive = blob
    with pytest.raises(NotImplementedError, match="A.13"):
        _sim(_scene(), tree_accuracy=1e-2)
    with pytest.raises(NotImplementedError, match="A.15"):
        tt.tree_acc_potential(*_t(pos, mass), G_grav=1.0, eps2=EPS2, near="kernel",
                              wl_entries=64, _n_parts=2)
    cfg = tot.SimConfig(dt=1.0, eps2=EPS2, force_impl="tree", tree_near="kernel",
                        integrator="hermite")
    with pytest.raises(ValueError, match="hermite"):
        R.resolve_accel_jerk_fn(cfg, 8192, "cpu")


def test_b7_wrapper_refuses_other_devices():
    """The wrapper runs its plain version only for CPU tensors: on any other
    device it launches the kernel or raises."""
    t = torch.zeros((4 * CHUNK * RJ, 8), device="meta")
    runs = torch.zeros((1, 9), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_tree.tree_near_cuda(t, runs, runs, wl_entries=8, chunk=CHUNK, rj=RJ, ws=1,
                                 eps2=EPS2)


@pytest.mark.parametrize("ws", [1, 2])
def test_b7_box_rule_keeps_every_taken_pair(ws):
    """B7 visits only each chunk's live rows (cells below 1e9) against the
    rows of its entries inside the chunk's cell box, [min c - ws, max c + ws]
    on each axis over those live rows (csrc/tree_near.cu). On a Plummer blob
    of 1,200 bodies, a third dead and parked far, at levels 5: every pair
    that JAX's ``_entry_math`` takes over JAX's worklist (``_wl_expand``)
    lies inside that rule, and chip_smoke.tree_near_work counts the rule's
    pairs and, as its needed pairs, exactly the taken ones."""
    import chip_smoke

    smoke = chip_smoke.Smoke(0, 10)
    pos, mass, alive = smoke.ragged_tree_scene(1200)
    levels, M = 5, 32
    k_ch, q = tw.tree_wl_budgets(pos, alive, levels=levels, ws=ws, chunk=CHUNK, rj=RJ)
    p32, alive_b, _, m_eff, _, _, _, cc = tt._bin(*_t(pos.astype(np.float32),
                                                      mass.astype(np.float32), alive),
                                                  M, None, F32)
    sc, idx = tt._sort_cells(cc, alive_b, M)
    tab = tw._wl_table(sc, p32[idx], m_eff[idx], idx, len(pos), M, ws, k_ch, CHUNK, q, RJ)
    assert int(tab["cap_overflow"]) == int(tab["cell_overflow"]) == 0
    rows = tab["pbods"].numpy()
    ref_i, ref_jb, _ = jax.jit(jw._wl_expand, static_argnums=(2, 3, 4))(
        jnp.asarray(tab["start_blk"].numpy(), jnp.int32),
        jnp.asarray(tab["n_blk"].numpy(), jnp.int32), k_ch, q, q)
    ent = np.asarray(ref_i) < k_ch
    wl_i, wl_jb = np.asarray(ref_i)[ent], np.asarray(ref_jb)[ent]
    W = RJ * CHUNK
    ib = rows[wl_i[:, None] * CHUNK + np.arange(CHUNK)]             # [E, C, 8]
    jb = rows[wl_jb[:, None] * W + np.arange(W)]                    # [E, W, 8]
    # JAX's take, pair by pair: _entry_math's pe of each j row alone, with
    # every mass 1 (> 0 exactly where it takes the pair)
    jb1 = jb.copy()
    jb1[..., 3] = 1.0
    one = jax.vmap(lambda i, j: jw._entry_math(i, j, ws, EPS2), in_axes=(None, 0))
    pe = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(ib), jnp.asarray(jb1[..., None])))[
        ..., 3]                                                     # [E, W, C]
    taken = pe.transpose(0, 2, 1) > 0                               # [E, C, W]
    # the kernel's rule
    live_i = ib[..., 5] < 1e9                                       # [E, C]
    cells = np.where(live_i[..., None], ib[..., 5:8], np.nan)
    lo, hi = np.nanmin(cells, 1) - ws, np.nanmax(cells, 1) + ws    # [E, 3]
    in_box = np.all((jb[..., 5:8] >= lo[:, None]) & (jb[..., 5:8] <= hi[:, None]), -1)
    visits = live_i[:, :, None] & in_box[:, None, :]
    assert taken.sum() > 0 and not (taken & ~visits).any()
    work = chip_smoke.tree_near_work(tab, len(pos), levels, ws, CHUNK, RJ)
    assert work["visited"] == int(visits.sum()) and work["needed"] == int(taken.sum())
    assert work["needed"] <= work["visited"] <= work["issued"] and \
        work["visited"] < work["live"] < work["walked"]
