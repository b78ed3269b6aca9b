"""The mesh solvers' contact count under a mesh: the port's count ring
(``parallel.sharded.ring_contacts_fn``) on the contact sweep's count mode
(``csrc/collision_roots.cu``, ``count_kernel<T>``, through
``ops.cuda_collisions.block_contacts_cuda``), against the JAX package's
``_contacts_block`` and sharded steps on conftest's virtual CPU devices.

The kernel runs only on the card; here its arithmetic is held by mirrors in
numpy: its exact test pair by pair, in f32 and f64 (the plain count,
``ops.collisions.block_contacts``, integer-equal to it and to JAX's eager
``_contacts_block``, on pairs planted a few ulps either side of the inflated
threshold, where in f32 the rounding of ``(R_i + R_j) * 1.00001`` decides),
and its prefilter (each row's bound T_i from the tile's largest live column
radius, by the formula of the source's header, rounded upward exactly;
the FMA r^2 of each counted pair rounded as fmaf/fma round) holding every
pair the exact test counts. JAX is called eagerly, op by op: jitted XLA:CPU
may contract the products into FMAs. A routing case fakes the CUDA route and
checks that the count ring calls the wrapper P^2 times a step with the
rounds' global offsets, adding into one count, and never the plain count.
The sharded P3M with bounce and the sharded tree with merge are held to
JAX's ``make_sharded_step``.

Tolerances: counts equal (integers). P3M + bounce, f32, one step against
JAX's sharded step: rtol 1e-4 / atol 1e-6 (tests/test_p3m.py:85's bound for
the sharded P3M step; f32 FFTs and pair sums in other orders). Tree + merge,
f32, one step: positions and velocities rtol 0 / atol 1e-6
(tests/test_parallel.py:664's bound for the sharded tree), masses rtol 1e-6,
alive masks equal.
"""
import dataclasses
import os
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.ops import collisions as jcoll
from orbital_tpu.ops import tree as jt
from orbital_tpu.parallel import sharded as jsh
from orbital_tpu.parallel.mesh import make_mesh as j_make_mesh
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.ops import cuda_collisions
from orbital_tpu_torch.parallel import sharded as tsh

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TILE = cuda_collisions.SWEEP_TILE
DTYPES = (np.float32, np.float64)


def _mirror_count(p_i, r_i, a_i, i_off, p_j, r_j, a_j, j_off):
    """The count kernel's exact test pair by pair, in the tables' dtype:
    d = r_i - r_j, r2 = (dx dx + dy dy) + dz dz, rho = (R_i + R_j) c with c
    = 1.00001 in the dtype, counted when r2 <= rho rho, the global ids
    differ and both are alive. numpy's f32 and f64 operations are correctly
    rounded and fuse nothing, as the kernel's __fsub_rn, __fmul_rn,
    __fadd_rn (and their double forms)."""
    dt = p_i.dtype.type
    d = p_i[:, None, :] - p_j[None, :, :]
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    rho = (r_i[:, None] + r_j[None, :]) * dt(1.00001)
    ids = np.arange(len(p_i))[:, None] + i_off != np.arange(len(p_j))[None, :] + j_off
    return (r2 <= rho * rho) & ids & a_i[:, None] & a_j[None, :]


def _planted(dt, n=256, seed=17):
    """n bodies in dtype ``dt``; body i + n/2 planted from body i at 1.00001
    (R_i + R_j)(1 + k u), u the dtype's ulp at 1 and k from -8 to 7, along a
    random direction (so that its rounded r2 falls either side of the
    threshold); a few dead, the rest apart."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50, 50, (n, 3))
    radius = rng.uniform(0.01, 0.2, n).astype(dt)
    u = 2.0 ** (-23 if dt == np.float32 else -52)
    h = n // 2
    for i in range(h):
        v = rng.normal(size=3)
        v /= np.linalg.norm(v)
        dist = 1.00001 * (float(radius[i]) + float(radius[i + h])) * (1.0 + (i % 16 - 8) * u)
        pos[i + h] = pos[i] + dist * v
    alive = np.ones(n, bool)
    alive[[5, h + 7]] = False
    return pos.astype(dt), radius, alive


def _sides(pos, radius, alive, offsets):
    """The two blocks of a round at global offsets (i_off, j_off): the
    tables themselves at equal offsets (the diagonal round), else the
    reversed tables."""
    i0, j0 = offsets
    if i0 == j0:
        return (pos, radius, alive, i0, pos, radius, alive, j0)
    return (pos, radius, alive, i0, pos[::-1].copy(), radius[::-1].copy(),
            alive[::-1].copy(), j0)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("offsets", [(0, 0), (0, 256), (512, 256)])
def test_count_at_the_threshold_matches_jax_and_the_mirror(dt, offsets):
    """The plain count (the kernel's plain version), JAX's eager
    ``_contacts_block`` and the kernel's mirror, integer-equal on pairs
    planted within a few ulps either side of the inflated threshold, in f32
    and f64; the planted pairs split both ways; in f32 the count differs
    from the same r2 against the exactly inflated threshold (R_i + R_j)
    1.00001 in f64: the rounding of the inflation and of rho rho decides
    pairs, as the kernel rounds them."""
    pos, radius, alive = _planted(dt)
    args = _sides(pos, radius, alive, offsets)
    p_i, r_i, a_i, i0, p_j, r_j, a_j, j0 = args
    ref = int(jcoll._contacts_block(p_i, r_i, a_i, np.arange(i0, i0 + len(p_i)), p_j, r_j,
                                    a_j, np.arange(j0, j0 + len(p_j))))
    mirror = _mirror_count(*args)
    t = [torch.from_numpy(x) for x in (p_i, r_i, a_i, p_j, r_j, a_j)]
    got = tcoll.block_contacts(t[0], t[1], t[2], i0, t[3], t[4], t[5], j0)
    wrapped = cuda_collisions.block_contacts_cuda(t[0], t[1], t[2], i0, t[3], t[4], t[5], j0)
    assert got.dtype == torch.int32 and int(got) == int(wrapped) == ref == int(mirror.sum())
    h = len(pos) // 2
    d = pos[h:] - pos[:h]
    r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    rho = (radius[:h] + radius[h:]) * dt(1.00001)
    inside = r2 <= rho * rho
    assert 16 <= inside.sum() <= h - 16
    if dt == np.float32:
        exact = r2.astype(np.float64) <= ((radius[:h].astype(np.float64)
                                           + radius[h:].astype(np.float64)) * 1.00001) ** 2
        assert (inside != exact).any()


def test_block_contacts_cuda_cpu_path_and_devices():
    """On CPU tensors the wrapper is its plain version: a new count, or the
    count added into ``out`` in place (as the ring's rounds add), never a
    launch; other devices raise."""
    pos, radius, alive = _planted(np.float32, n=128)
    t = [torch.from_numpy(x) for x in (pos, radius, alive)]
    ref = int(tcoll.block_contacts(*t, 0, *t, 128))
    before = cuda_collisions.block_contacts_cuda.launches
    out = torch.full((), 5, dtype=torch.int32)
    got = cuda_collisions.block_contacts_cuda(*t, 0, *t, 128, out=out)
    assert got is out and int(out) == 5 + ref > 5
    assert cuda_collisions.block_contacts_cuda.launches == before
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_collisions.block_contacts_cuda(*meta, 0, *meta, 128)


# --- the prefilter: a proven superset of the exact test ----------------------

def _round(x: Fraction, dt, up: bool = False):
    """The dtype value nearest to ``x`` (ties to even), or with ``up`` the
    least one >= ``x``."""
    f = dt(float(x))
    while _q(f) > x:
        f = np.nextafter(f, dt(-np.inf))
    while _q(np.nextafter(f, dt(np.inf))) <= x:
        f = np.nextafter(f, dt(np.inf))
    if _q(f) == x:
        return f
    g = np.nextafter(f, dt(np.inf))
    if up:
        return g
    lo, hi = x - _q(f), _q(g) - x
    if lo == hi:
        return f if int(np.array(f).view(np.uint32 if dt == np.float32 else np.uint64)) % 2 == 0 \
            else g
    return f if lo < hi else g


def _q(v):
    return Fraction(float(v))


def _bound(a, dt):
    """The kernel's T_i from a = fl(R_i + Rmax): Ops::bound(Ops::mul_up(a,
    c)) = ((a c)_up^2)_up (1 + 16 u))_up + the smallest normal, rounded up,
    exactly."""
    u16 = 2.0 ** -20 if dt == np.float32 else 2.0 ** -49
    tiny = 2.0 ** -126 if dt == np.float32 else 2.0 ** -1022
    a2 = _round(_q(a) * _q(dt(1.00001)), dt, up=True)
    s = _round(_q(a2) * _q(a2), dt, up=True)
    s = _round(_q(s) * _q(dt(1.0 + u16)), dt, up=True)
    return _round(_q(s) + _q(dt(tiny)), dt, up=True)


def _fma_r2(dx, dy, dz, dt):
    """The prefilter's r2 = fma(dz, dz, fma(dy, dy, dx dx)), each FMA
    rounded once, exactly."""
    s = dt(dx * dx)
    s = _round(_q(dy) * _q(dy) + _q(s), dt)
    return _round(_q(dz) * _q(dz) + _q(s), dt)


def _prefilter_scene(kind, dt, n=768, seed=29):
    """A scene of the prefilter case: the bench row's and the contact-rich
    radii on a compact cluster, the rich one far from the origin, and the
    planted threshold pairs; a quarter of the bodies dead (parked far)."""
    rng = np.random.default_rng(seed)
    if kind == "planted":
        pos, radius, alive = _planted(dt, n=n)
    else:
        pos = rng.normal(size=(n, 3)) * (0.0015 if kind == "bench" else 0.015)
        if kind == "far":
            pos = pos + 3e3
        radius = np.full(n, 1e-4 if kind == "bench" else 3e-3) * rng.uniform(0.5, 1.5, n)
        alive = rng.uniform(size=n) >= 0.25
        pos[~alive] = 1e17
    return pos.astype(dt), radius.astype(dt), alive


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["bench", "rich", "far", "planted"])
def test_prefilter_holds_every_counted_pair(kind, dt):
    """Every pair the exact test counts passes the kernel's prefilter: its
    FMA r2 (as the kernel rounds it) <= T_i, the row's bound from the
    largest live column radius of the column's tile of 128, by the formula
    of the source's header (evaluated exactly, with its upward roundings).
    The scenes count pairs; the prefilter flags few pairs the test
    rejects."""
    pos, radius, alive = _prefilter_scene(kind, dt)
    counted = _mirror_count(pos, radius, alive, 0, pos, radius, alive, 0)
    assert counted.sum() >= 4
    n = len(pos)
    rmax = np.array([max([dt(0)] + [radius[j] for j in range(s, min(s + TILE, n)) if alive[j]])
                     for s in range(0, n, TILE)], dtype=dt)
    bounds = {}
    for i, j in zip(*np.nonzero(counted)):
        key = (i, j // TILE)
        if key not in bounds:
            bounds[key] = _bound(radius[i] + rmax[j // TILE], dt)
        d = pos[i] - pos[j]
        assert _q(_fma_r2(d[0], d[1], d[2], dt)) <= _q(bounds[key])
    # tightness: the flagged pairs (the f64 sum of squares against the bound
    # in f64, a close stand-in) stay within a few of the counted ones
    d = pos[:, None, :].astype(np.float64) - pos[None, :, :].astype(np.float64)
    r2 = (d * d).sum(-1)
    a = (radius[:, None].astype(np.float64) + rmax[np.arange(n) // TILE][None, :]) * 1.00001
    flagged = (r2 <= a * a * (1 + 2.0 ** -19)) & alive[:, None] & alive[None, :]
    np.fill_diagonal(flagged, False)  # self pairs: flagged, then refused by their ids
    assert counted.sum() <= flagged.sum() <= 4 * counted.sum() + 64


# --- routing: the count ring on the kernel ------------------------------------

def _cluster(n, seed=9):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 0.3
    vel = rng.normal(size=(n, 3)) * 0.1
    return pos, vel, np.full(n, 1.0 / n)


@pytest.mark.parametrize("precision", ["ds32", "f64"])
def test_count_ring_runs_on_the_kernel(monkeypatch, precision):
    """With the CUDA route faked (``block_contacts_cuda`` recording and
    counting by the kernel's numpy mirror), a PM + bounce step over 4 ranks
    calls it P^2 = 16 times, once for each (rank, round) with the blocks'
    global offsets, each rank's rounds adding into one int32 (``out=``) in
    the state's dtype (float32 for ds32's hi words, float64 for f64), and
    never the plain count; the step equals the one on the plain count."""
    calls = []

    def kernel(pos_i, radius_i, alive_i, i_off, pos_j, radius_j, alive_j, j_off, *, out):
        calls.append((i_off, j_off, pos_i.dtype, radius_j.dtype, id(out)))
        hits = _mirror_count(*(x.numpy() for x in (pos_i, radius_i, alive_i)), i_off,
                             *(x.numpy() for x in (pos_j, radius_j, alive_j)), j_off)
        return out.add_(int(hits.sum()))

    def plain(*a, **k):
        raise AssertionError("the plain count ran on the kernel route")

    n, P = 512, 4
    pos, vel, mass = _cluster(n)
    st = tot.make_state(pos, vel, mass, np.full(n, 0.02), precision=precision, device="cpu")
    cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-2, force_impl="pm", pm_grid=16,
                        pm_box=(0.0, 0.0, 0.0, 4.0), collisions="bounce", restitution=0.8)
    st = tot.init_forces(st, cfg)
    mesh = tot.make_mesh(shape=(P,), devices="cpu")
    ref = tot.gather_state(mesh, tot.make_sharded_step(cfg, mesh, st)(tot.shard_state(mesh, st)))
    monkeypatch.setattr(cuda_collisions, "block_contacts_cuda", kernel)
    for mod in (tcoll, cuda_collisions, tsh):
        monkeypatch.setattr(mod, "block_contacts", plain)
    out = tot.gather_state(mesh, tot.make_sharded_step(cfg, mesh, st)(tot.shard_state(mesh, st)))
    free = tot.gather_state(mesh, tot.make_sharded_step(cfg.replace(collisions="none"), mesh,
                                                        st)(tot.shard_state(mesh, st)))
    b = n // P
    dt = torch.float64 if precision == "f64" else torch.float32
    assert sorted(c[:2] for c in calls) == sorted((b * r, b * ((r - k) % P)) for r in range(P)
                                                  for k in range(P))
    assert all(c[2] == c[3] == dt for c in calls)
    assert len({c[4] for c in calls}) == P  # one count a rank, its rounds adding in place
    for f in ("pos", "vel", "pos_lo", "vel_lo"):
        a, r = getattr(out, f), getattr(ref, f)
        assert (a is None and r is None) or torch.equal(a, r)
    assert float((out.vel - free.vel).abs().max()) > 1e-3  # bodies bounced


# --- the sharded mesh solvers with collisions against JAX ---------------------

def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def _jax_and_port_step(jcfg, js, P):
    jmesh = j_make_mesh(shape=(P,), devices=jax.devices()[:P])
    jout = jsh.make_sharded_step(jcfg, jmesh, js, axis="body")(
        jsh.shard_state(jmesh, js, "body"))
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    ts = _port_state(js)
    mesh = tot.make_mesh(shape=(P,), devices="cpu")
    out = tot.gather_state(mesh, tot.make_sharded_step(tcfg, mesh, ts)(
        tot.shard_state(mesh, ts)))
    free = tot.gather_state(mesh, tot.make_sharded_step(tcfg.replace(collisions="none"), mesh,
                                                        ts)(tot.shard_state(mesh, ts)))
    return jout, out, free


def test_sharded_p3m_bounce_matches_jax():
    """P3M with bounce over 4 ranks (the uniform box of tests/test_p3m.py,
    N = 2,048 at grid 32, radius 0.02: ~70 touching pairs), one KDK step
    against JAX's sharded step: the count ring (the port's count mode's
    plain version here) gates the bounce ring, and bodies bounce."""
    rng = np.random.default_rng(7)
    n = 2048
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="p3m", pm_grid=32,
                         p3m_capacity=64, collisions="bounce", restitution=0.8)
    js = jot.init_forces(jot.make_state(pos, vel, mass, np.full(n, 0.02), precision="f32"),
                         jcfg)
    jout, out, free = _jax_and_port_step(jcfg, js, 4)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    assert (np.abs(out.vel.numpy() - free.vel.numpy()).max(1) > 1e-3).sum() >= 10


def test_sharded_tree_merge_matches_jax():
    """The tree (levels 3, near "pairs" with JAX's budgets) with merge over 4
    ranks on a 256-body Plummer sphere at radius 0.05 (4 touching pairs),
    one KDK step against JAX's sharded step: the count ring's count > 0
    sends both through the gathered merge; alive masks equal, masses and
    live states within the sharded tree's bounds, and bodies merged."""
    rng = np.random.default_rng(3)
    n = 256
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    pos = (r[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    vel = (0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    js = jot.make_state(pos, vel, mass, np.full(n, 0.05), precision="f32")
    kch, entries = jt.tree_pairs_budgets(js.pos, js.alive, levels=3)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-3, force_impl="tree", tree_levels=3,
                         tree_near="pairs", tree_max_chunks=int(kch),
                         tree_pair_entries=tuple(int(e) for e in entries), collisions="merge")
    js = jot.init_forces(js, jcfg)
    jout, out, free = _jax_and_port_step(jcfg, js, 4)
    alive = np.asarray(jout.alive)
    np.testing.assert_array_equal(out.alive.numpy(), alive)
    assert (~alive).sum() >= 2 and free.alive.all()
    np.testing.assert_allclose(out.mass.numpy(), np.asarray(jout.mass), rtol=1e-6)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out, f).numpy()[alive],
                                   np.asarray(getattr(jout, f))[alive], rtol=0, atol=1e-6,
                                   err_msg=f)
