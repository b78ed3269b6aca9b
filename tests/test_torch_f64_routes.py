"""f64 state on the card's routes (ROADMAP G.1), checked on the CPU.

On CUDA a route resolves from the config and N as for f32, JAX's TPU route;
then f64 state takes it as the JAX package does: where JAX's route is a
Pallas kernel, the port's kernel casts the state to f32 once at entry and
returns f64 (``utils.kernels.in_f32``); where JAX runs XLA in the state's
dtype, the port computes in f64 (the contact sweep's and the B5 row subset's
f64 instances, RESPA's plain near sweep, the dense and chunked routes).

Here, without a card: the whole route table resolved for ``"cuda"`` with the
wrappers monkeypatched to record their calls (each spy runs the plain
version on the CPU tensors); the cast helper, with sentinel and parked rows;
the plain f64 versions of the two f64 instances against JAX's f64 XLA
functions on scenes with grazing pairs that touch in f64 and not in f32
(roots and marks equal, the subset within 1e-12 of max |.|); B2's plain
count on f32-cast positions counting a pair that touches by one f64 ulp;
and ``soften_potential_pairs`` against JAX's (rel 1e-12).
"""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu_torch as tot
from orbital_tpu.ops import collisions as jc
from orbital_tpu.ops import forces as jf
from orbital_tpu_torch.engine import integrators as I
from orbital_tpu_torch.engine import multirate
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.ops import (cuda_collisions, cuda_forces, cuda_forces_mxu,
                                   cuda_forces_sym, cuda_jerk, mxu_forces, p3m, pm, tree)
from orbital_tpu_torch.ops import forces as tf
from orbital_tpu_torch.parallel import ensemble, sharded
from orbital_tpu_torch.utils.kernels import in_f32

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F64 = torch.float64
EPS2 = 1e-4
BIG = 4224  # above the dense ceiling, a multiple of 128 (B12's tile)

# (module, wrapper) of every spied CUDA wrapper and plain-route function
SPIED = {
    "pairwise_acc_cuda": cuda_forces, "pairwise_acc_detect_cuda": cuda_forces,
    "pairwise_acc_sym_cuda": cuda_forces_sym, "pairwise_acc_mxu_cuda": cuda_forces_mxu,
    "pairwise_acc_mxu": mxu_forces, "accel_jerk_cuda": cuda_jerk,
    "accel_jerk_detect_cuda": cuda_jerk, "accel_jerk_subset_cuda": cuda_jerk,
    "bounce_deltas_cuda": cuda_collisions, "collision_roots_cuda": cuda_collisions,
    "contact_marks_cuda": cuda_collisions, "pairwise_acc_dense": R,
    "pairwise_acc_chunked": R, "bounce_deltas": I.coll,
}
# the functions whose spies return zeros (the solvers' f32-inside routes are
# the CPU's, and RESPA's plain sweep in the state's dtype: held by their own
# test files)
STUBBED = {"tree_acc_potential": tree, "pm_acc_potential": pm, "p3m_acc_potential": p3m,
           "near_acc_slots": multirate}


@pytest.fixture
def calls(monkeypatch):
    """Every spied function records (name, dtype of its first float tensor)
    and runs the original on the CPU tensors."""
    log = []

    def spy(name, fn):
        def run(*a, **k):
            first = next((t for t in a if isinstance(t, torch.Tensor)
                          and t.is_floating_point()), None)
            log.append((name, None if first is None else first.dtype))
            return fn(*a, **k)
        return run

    for name, mod in SPIED.items():
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    for name, mod in STUBBED.items():
        def zeros(pos, *a, _n=name, **k):
            log.append((_n, pos.dtype))
            return torch.zeros_like(pos), torch.zeros((), dtype=pos.dtype), torch.zeros(
                (), dtype=torch.int32)
        monkeypatch.setattr(mod, name, zeros)
    return log


def _scene(n, seed=0, radius=1e-3):
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.normal(size=(n, 3)))
    vel = torch.tensor(rng.normal(size=(n, 3)) * 0.1)
    mass = torch.tensor(rng.uniform(0.5, 1.5, n) / n)
    rad = torch.full((n,), radius, dtype=F64)
    alive = torch.ones(n, dtype=torch.bool)
    alive[::5] = False
    return pos, vel, mass, rad, alive


def _force(impl, n):
    pos, _, mass, _, alive = _scene(n)
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2, force_impl=impl, chunk=128)
    return R.resolve_force_fn(cfg, n, "cuda", F64)(pos, mass, alive)


def _detect(impl, n):
    pos, _, mass, rad, alive = _scene(n)
    return R.resolve_force_detect_fn(
        tot.SimConfig(dt=1e-3, eps2=EPS2, force_impl=impl, collisions="bounce"), n, "cuda",
        F64)(pos, mass, rad, alive)


def _bounce(n):
    pos, vel, mass, rad, alive = _scene(n, radius=0.05)
    return I.resolve_bounce_fn(n, "cuda", F64)(pos, vel, mass, rad, alive, 1.0,
                                               torch.tensor(1, dtype=torch.int32))


def _roots(n):
    pos, _, _, rad, alive = _scene(n, radius=0.05)
    return (I.resolve_roots_fn(n, "cuda")(pos, rad, alive, None),
            I.resolve_marks_fn(n, "cuda")(pos, rad, alive, None))


def _jerk(kind, n):
    pos, vel, mass, rad, alive = _scene(n)
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2, integrator="hermite")
    if kind == "full":
        return R.resolve_accel_jerk_fn(cfg, n, "cuda", F64)(pos, vel, mass, alive)
    if kind == "detect":
        return R.resolve_accel_jerk_detect_fn(cfg, n, "cuda", F64)(pos, vel, mass, rad, alive)
    return R.resolve_accel_jerk_subset_fn(cfg, n, "cuda", F64)(
        torch.tensor([3, 7, n - 1]), pos, vel, mass, alive)


def _respa(n):
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2, integrator="respa", respa_rc=0.1,
                        respa_cell=0.2)
    xs = torch.zeros(n, dtype=F64)
    return multirate._resolve_sweep(cfg, F64, "cuda")(xs, xs, xs, xs, {"jbl": None})


# the route table, f64 state on CUDA: (id, call, want) with want the spied
# names in call order (the first float argument float64 each time)
ROUTES = [
    ("auto-above-4096-B1", lambda: _force("auto", BIG), ["pairwise_acc_cuda"]),
    ("pallas-B1", lambda: _force("pallas", 64), ["pairwise_acc_cuda"]),
    ("auto-at-4096-dense", lambda: _force("auto", 64), ["pairwise_acc_dense"]),
    ("dense", lambda: _force("dense", 64), ["pairwise_acc_dense"]),
    ("chunked-all-f64", lambda: _force("chunked", BIG), ["pairwise_acc_chunked"]),
    ("pallas_sym-B12", lambda: _force("pallas_sym", BIG), ["pairwise_acc_sym_cuda"]),
    ("pallas_mxu-B13", lambda: _force("pallas_mxu", BIG), ["pairwise_acc_mxu_cuda"]),
    ("mxu", lambda: _force("mxu", BIG), ["pairwise_acc_mxu"]),
    ("tree", lambda: _force("tree", BIG), ["tree_acc_potential"]),
    ("pm", lambda: _force("pm", BIG), ["pm_acc_potential"]),
    ("p3m", lambda: _force("p3m", BIG), ["p3m_acc_potential"]),
    ("detect-B2", lambda: _detect("auto", BIG), ["pairwise_acc_detect_cuda"]),
    ("detect-dense", lambda: _detect("auto", 64), ["pairwise_acc_dense"]),
    ("detect-chunked", lambda: _detect("chunked", BIG), ["pairwise_acc_chunked"]),
    ("bounce-B6", lambda: _bounce(BIG), ["bounce_deltas_cuda"]),
    ("bounce-dense-f64", lambda: _bounce(64), ["bounce_deltas"]),
    ("merge-and-resolve-f64-sweep", lambda: _roots(64),
     ["collision_roots_cuda", "contact_marks_cuda"]),
    ("hermite-B5", lambda: _jerk("full", BIG), ["accel_jerk_cuda"]),
    ("hermite-B5-detect", lambda: _jerk("detect", BIG), ["accel_jerk_detect_cuda"]),
    ("block-subset-f64", lambda: _jerk("subset", BIG), ["accel_jerk_subset_cuda"]),
    ("hermite-dense", lambda: _jerk("full", 64), []),
    ("respa-plain-f64", lambda: _respa(64), ["near_acc_slots"]),
]


@pytest.mark.parametrize("call,want", [r[1:] for r in ROUTES], ids=[r[0] for r in ROUTES])
def test_route_table_f64_on_cuda(call, want, calls):
    """Each route of the table, resolved for "cuda" with float64 state,
    reaches the wrapper or plain function the JAX package's route maps to,
    with float64 tensors (the wrappers cast inside); nothing raises, and
    what comes back is float64."""
    out = call()
    assert [name for name, _ in calls] == want
    assert all(dt == F64 for _, dt in calls)
    first = out[0] if isinstance(out, tuple) else out
    if first.is_floating_point():
        assert first.dtype == F64


def test_route_table_f64_fused_ring_and_ensembles():
    """The rest of the table: B4 stays f32-only (f64 takes the step loop);
    the collision-free ring takes B3 under "auto" and "pallas" whatever the
    dtype (JAX's sharded.py:254-257), and collisions under a CUDA mesh in
    f64 are accepted (B3 detect's and the block bounce's f64 instances);
    ensembles run member by member."""
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2)
    pos = SimpleNamespace(device=torch.device("cuda"), dtype=F64, ndim=2)
    state = SimpleNamespace(pos=pos, dtype=F64, n_bodies=4096, device=torch.device("cuda"))
    assert not R._fused_eligible(state, cfg)
    assert R._fused_eligible(SimpleNamespace(pos=pos, dtype=torch.float32, n_bodies=4096,
                                             device=torch.device("cuda")), cfg)
    for impl in ("auto", "pallas"):
        assert sharded._ring_block_impl(cfg.replace(ring_block_impl=impl), 16384,
                                        pos) == "pallas"
    mesh = SimpleNamespace(shape={"body": 4}, device=torch.device("cuda"))
    example = SimpleNamespace(n_bodies=65536, dtype=F64, pos=pos)
    assert sharded._prepare(cfg.replace(collisions="merge"), mesh, example,
                            None)[0].collisions == "merge"
    assert sharded._prepare(cfg, mesh, example, None)[0] is not None
    assert ensemble.ensemble_route(cfg, 64, "cuda", F64) == "members"


def test_in_f32_casts_once_and_returns_the_state_dtype():
    """The cast helper hands the wrapper float32 copies of float64 tensors
    (integer, bool and float32 tensors and other arguments as they are) and
    returns every floating output in float64, integer ones as they are."""
    seen = {}

    def fn(a, b, c, d, *, k):
        seen.update(a=a.dtype, b=b.dtype, c=c.dtype, d=d, k=k)
        return a.clone(), torch.tensor(3, dtype=torch.int32), b

    x = torch.tensor([1.0, 2.0 ** 130, -1e300], dtype=F64)
    out = in_f32(fn, x, torch.ones(3, dtype=torch.bool), torch.ones(3), None, k=5)
    assert seen == dict(a=torch.float32, b=torch.bool, c=torch.float32, d=None, k=5)
    assert [o.dtype for o in out] == [F64, torch.int32, torch.bool]
    assert out[0].tolist() == [1.0, 2.0 ** 100, -2.0 ** 100]  # clamped, never inf
    single = in_f32(lambda t: t + 1, torch.zeros(2, dtype=F64))
    assert single.dtype == F64


def test_in_f32_sentinel_and_parked_rows_give_no_nan():
    """f64 state with dead rows parked at 1e21 (``make_state``'s far = 1e8
    (1 + scale) of a scene in SI units; far^2 past float32's range; the live
    bodies here in natural units), sentinel rows at 1e30 and rows past float32's range
    (1e40, clamped to 2^100) through the f32-inside wrappers' plain
    versions: every output finite, the live rows' acc within 1e-5 of the f64 dense sum of
    the live bodies, and the count the live contacts'."""
    n_live = 96
    pos, vel, mass, rad, _ = _scene(n_live)
    far = 1e21
    parked = torch.tensor([[far * (1 + 1e-3 * k), far, far] for k in range(8)], dtype=F64)
    sentinel = torch.full((4, 3), 1e30, dtype=F64)
    beyond = torch.tensor([[1e40, 1e40, 1e40], [-1e40, 2e40, 0.0]], dtype=F64)
    pos = torch.cat([pos, parked, sentinel, beyond])
    n = pos.shape[0]
    vel = torch.cat([vel, torch.zeros((n - n_live, 3), dtype=F64)])
    mass = torch.cat([mass, torch.zeros(n - n_live, dtype=F64)])
    rad = torch.cat([rad * 200, torch.zeros(n - n_live, dtype=F64)])
    alive = torch.arange(n) < n_live
    kw = dict(G=1.0, eps2=EPS2)
    acc, U = in_f32(cuda_forces.pairwise_acc_plain, pos, mass, alive, **kw)
    a2, U2, count = in_f32(cuda_forces.pairwise_acc_detect_plain, pos, mass, rad, alive, **kw)
    a3, j3, U3 = in_f32(cuda_jerk.accel_jerk_plain, pos, vel, mass, alive, **kw)
    dp, dv = in_f32(cuda_collisions.bounce_deltas_plain, pos, vel, mass, rad, alive)
    for t in (acc, U, a2, U2, a3, j3, U3, dp, dv):
        assert t.dtype == F64 and bool(torch.isfinite(t).all())
    ref, _ = tf.pairwise_acc_dense(pos[:n_live], mass[:n_live], G=1.0, eps2=kw["eps2"])
    scale = float(ref.abs().max())
    np.testing.assert_allclose(acc[:n_live].numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)
    assert not acc[n_live:].any() and not a3[n_live:].any()
    live_count = tot.ops.collisions.count_contacts_dense(pos[:n_live].float(),
                                                         rad[:n_live].float(),
                                                         alive[:n_live])
    assert int(count) == int(live_count)


def _grazing(n_pairs=96, seed=5):
    """Pairs planted at contact distance, each pair alone in its own grid
    cell, kept where f64 and f32 disagree on touching (the JAX test in the
    state's dtype, ``_pair_geometry``'s): (pos, radius) in f64 with the
    pairs' rows in and out of index order, and the count of each kind."""
    rng = np.random.default_rng(seed)
    rows, radii, kinds = [], [], []
    k = 0
    while len(kinds) < n_pairs:
        k += 1
        base = np.array([k % 16, (k // 16) % 16, k // 256], np.float64) * 0.5 + rng.uniform(
            -0.1, 0.1, 3)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        r = rng.uniform(1e-3, 2e-3, 2)
        d = (r[0] + r[1]) * (1.0 + rng.uniform(-2e-8, 2e-8))
        p = np.stack([base, base + d * u])
        t64 = _touch(p, r, np.float64)
        t32 = _touch(p, r, np.float32)
        if t64 == t32:
            continue
        kinds.append(t64)
        order = [0, 1] if len(kinds) % 2 else [1, 0]
        rows.append(p[order])
        radii.append(r[order])
    return np.concatenate(rows), np.concatenate(radii), kinds


def _touch(p, r, dt) -> bool:
    p, r = p.astype(dt), r.astype(dt)
    d = p[0] - p[1]
    dist = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return bool(dist <= r[0] + r[1])


def test_plain_f64_roots_and_marks_equal_jax_on_grazing_pairs():
    """``collision_roots_plain`` and ``contact_marks_plain`` in f64 against
    JAX's f64 XLA search (``collision_roots_chunked``) and marks
    (``_pair_geometry``'s touching, any over j, the formula of resolve's
    ``i_block``), on pairs that touch in f64 and not in f32 and the other way
    round, with dead bodies: roots and marks equal; in f32 they differ."""
    pos, rad, kinds = _grazing()
    n = pos.shape[0]
    alive = np.ones(n, bool)
    alive[-4:] = False
    assert 0 < sum(kinds) < len(kinds)
    tp, tr, ta = torch.from_numpy(pos), torch.from_numpy(rad), torch.from_numpy(alive)
    roots = cuda_collisions.collision_roots_plain(tp, tr, ta, chunk=64)
    marks = cuda_collisions.contact_marks_plain(tp, tr, ta, chunk=64)
    jp, jr, ja = jnp.asarray(pos), jnp.asarray(rad), jnp.asarray(alive)
    want_roots = np.asarray(jc.collision_roots_chunked(jp, jr, ja, chunk=64))
    want_marks = np.asarray(jnp.any(jc._pair_geometry(jp, jr, ja)[2], axis=1))
    np.testing.assert_array_equal(roots.numpy(), want_roots)
    np.testing.assert_array_equal(marks.numpy(), want_marks)
    linked = int((roots != torch.arange(n)).sum())
    assert linked > 0 and int(marks.sum()) == 2 * linked
    r32 = cuda_collisions.collision_roots_plain(tp.float(), tr.float(), ta, chunk=64)
    m32 = cuda_collisions.contact_marks_plain(tp.float(), tr.float(), ta, chunk=64)
    assert not torch.equal(r32, roots) and not torch.equal(m32, marks)


def test_accel_jerk_subset_plain_f64_against_jax():
    """``accel_jerk_subset_plain`` in f64 (the f64 subset instance's plain
    version) against JAX's f64 ``accel_jerk_subset``, softened and not, with
    dead bodies and a repeated index: within 1e-12 of max
    |acc| and max |jerk|."""
    pos, vel, mass, _, alive = _scene(1024, seed=9)
    idx = torch.tensor([0, 5, 5, 1023, 17, 640, 3])
    for eps2 in (EPS2, 0.0):
        a, j = cuda_jerk.accel_jerk_subset_plain(idx, pos, vel, mass, alive, G=1.0, eps2=eps2,
                                                 chunk=256)
        ja, jj = jf.accel_jerk_subset(jnp.asarray(idx.numpy()), *(jnp.asarray(t.numpy())
                                                                  for t in (pos, vel, mass,
                                                                            alive)),
                                      G=1.0, eps2=eps2, chunk=256)
        ja, jj = np.asarray(ja), np.asarray(jj)
        assert a.dtype == F64
        np.testing.assert_allclose(a.numpy(), ja, rtol=0, atol=1e-12 * np.abs(ja).max())
        np.testing.assert_allclose(j.numpy(), jj, rtol=0, atol=1e-12 * np.abs(jj).max())


def test_b2_plain_count_on_cast_positions_counts_a_one_ulp_contact():
    """B2's plain version on the f32-cast positions (its 1e-5 radius
    inflation, ``pallas_forces.py:102-106``) counts a pair that overlaps by
    one f64 ulp, which the f64 merge search then links; a pair one ulp
    apart is not linked in f64, whatever the gate counts."""
    R_ = 2.0 ** -10
    x = 0.25 + 2.0 ** -9
    touch = np.nextafter(x, 0.0)   # overlaps by one ulp of its position
    apart = np.nextafter(x, 1.0)
    pos = np.array([[0.25, 0.5, 0.5], [touch, 0.5, 0.5],
                    [0.25, -0.5, 0.5], [apart, -0.5, 0.5]], np.float64)
    rad = np.full(4, R_)
    alive = torch.ones(4, dtype=torch.bool)
    mass = torch.full((4,), 0.25, dtype=F64)
    tp, tr = torch.from_numpy(pos), torch.from_numpy(rad)
    _, _, count = in_f32(cuda_forces.pairwise_acc_detect_plain, tp[:2], mass[:2], tr[:2],
                         alive[:2], G=1.0, eps2=EPS2)
    assert int(count) == 2  # both directions
    roots = cuda_collisions.collision_roots_plain(tp, tr, alive)
    assert roots.tolist() == [0, 0, 2, 3]
    jroots = jc.collision_roots_chunked(jnp.asarray(pos), jnp.asarray(rad),
                                        jnp.ones(4, bool), chunk=4)
    assert np.asarray(jroots).tolist() == [0, 0, 2, 3]


def test_soften_potential_pairs_against_jax():
    """``ops.forces.soften_potential_pairs`` against JAX's in f64."""
    pos, _, mass, _, _ = _scene(300, seed=11)
    U = tf.soften_potential_pairs(pos, mass, G=1.0, eps2=EPS2)
    want = float(jf.soften_potential_pairs(jnp.asarray(pos.numpy()), jnp.asarray(mass.numpy()),
                                           G=1.0, eps2=EPS2))
    assert U.dtype == F64 and float(U) == pytest.approx(want, rel=1e-12)
