"""f64 state with collisions under a mesh (the ring's count and bounce in
double) against the JAX package's own f64 sharded functions on conftest's 8
virtual CPU devices, and the arithmetic of the two f64 kernel instances
that serve it on the card: B3 detect's (``csrc/nbody_forces.cu``,
``block_detect_f64_kernel``) and the block bounce's (``csrc/collisions.cu``,
``bounce_block_f64_kernel``).

On CPU tensors the port's ring runs the dense block and the wrappers their
plain versions, so the mesh cases hold the port's f64 paths (bounce at 2 and
8 ranks, merge and resolve with JAX's draws handed over, PM with bounce on
the count ring, the (ensemble x body) bounce step) to JAX's. The kernels'
own arithmetic is held here by mirrors: the plain f64 count (the double
test the f64 instance makes, pair by pair) against JAX's
``_contacts_block`` on pairs planted a few ulps either side of the
threshold, and the f32 prefilter both f64 instances run first (each row's
nearest f32 r^2 of the cast tables in a tile against ``reach2``, a bound
rounded outward) in numpy: it keeps every pair that the double tests keep,
on the bench row, at the contact-rich radius, on an SI-scale scene and on
a cluster far from the origin. A routing case checks that the f64 ring on
the kernel route hands its f64 tables to both wrappers uncast, P^2 calls
each a collision step.

Tolerances: f64 steps against JAX rtol 1e-12 / atol 1e-14 (torch and XLA
sum each round's block in other orders; the ring's acc measured within
2.3e-16 of max |a|, ``tests/test_torch_sharded.py``); PM with bounce rtol
1e-5 / atol 1e-7 (both deposit in f32 in other orders; the JAX package's
own PM bound); counts, alive masks and masses equal.
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
from orbital_tpu.engine.rollout import resolve_force_fn as j_resolve_force_fn
from orbital_tpu.engine.state import make_state as j_make_state
from orbital_tpu.ops import collisions as jcoll
from orbital_tpu.parallel import sharded as jsh
from orbital_tpu.parallel.mesh import make_mesh as j_make_mesh
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.ops import cuda_collisions, cuda_forces

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F64 = dict(rtol=1e-12, atol=1e-14)
PM = dict(rtol=1e-5, atol=1e-7)
U = 2.0 ** -24


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def _tcfg(jcfg):
    return tot.SimConfig(**dataclasses.asdict(jcfg))


def _mesh(p):
    return tot.make_mesh(shape=(p,), devices="cpu")


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), err_msg=what, **tol)


def _jax_draws(frag_seed, step, T, B, K, *, dtype, device):
    """JAX's resolve draws in the state's dtype (``ops/collisions.py:268``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(frag_seed), int(step))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return torch.from_numpy(np.array(jax.random.uniform(key, (T, T), dtype=jdt))), None


def _dense_bounce_scene(n=32, seed=42):
    """JAX ``test_parallel.py:113``'s dense cluster with large radii."""
    rng = np.random.default_rng(seed)
    pos, vel = rng.normal(size=(n, 3)) * 0.8, rng.normal(size=(n, 3)) * 0.3
    return pos, vel, rng.uniform(0.5, 1.5, n) / n, np.full(n, 0.15)


# --- the mesh paths against JAX's f64 sharded functions ----------------------

@pytest.mark.parametrize("p", [2, 8])
def test_f64_sharded_bounce_matches_jax(p):
    """3 f64 steps of the ring's bounce at p ranks against JAX's sharded
    step (its count ring and ``_block_bounce`` in f64); collisions
    happened."""
    pos, vel, mass, radius = _dense_bounce_scene()
    jcfg = jot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="bounce", restitution=0.8)
    js = jot.init_forces(j_make_state(pos, vel, mass, radius, precision="f64"), jcfg)
    jmesh = j_make_mesh(shape=(p,), devices=jax.devices()[:p])
    jstep = jsh.make_sharded_step(jcfg, jmesh, js, axis="body")
    mesh = _mesh(p)
    st = _port_state(js)
    step = tot.make_sharded_step(_tcfg(jcfg), mesh, st)
    free = tot.make_sharded_step(_tcfg(jcfg).replace(collisions="none"), mesh, st)
    jo, to, fo = jsh.shard_state(jmesh, js, "body"), tot.shard_state(mesh, st), \
        tot.shard_state(mesh, st)
    for _ in range(3):
        jo, to, fo = jstep(jo), step(to), free(fo)
    tf = tot.gather_state(mesh, to)
    assert tf.pos.dtype == torch.float64
    for f in ("pos", "vel", "acc"):
        _close(getattr(tf, f).numpy(), getattr(jo, f), F64, f)
    _close(tf.potential.numpy(), jo.potential, dict(rtol=1e-12, atol=0.0), "potential")
    dv = np.abs(tf.vel.numpy() - tot.gather_state(mesh, fo).vel.numpy()).max(1)
    assert (dv > 1e-3).sum() >= 4  # bounces happened


@pytest.mark.parametrize("mode", ["merge", "resolve"])
def test_f64_sharded_merge_and_resolve_match_jax(mode, monkeypatch):
    """JAX ``test_parallel.py:69, 803``'s planted cross-shard pairs in f64
    over 8 ranks: the contact step (gather, the global merge or resolve
    with JAX's f64 draws handed to the port, slice) and a contact-free one,
    against JAX's sharded step; alive masks and masses equal."""
    rng = np.random.default_rng(42)
    n = 64
    pos = rng.normal(size=(n, 3)) * 5.0
    vel = rng.normal(size=(n, 3)) * 0.01
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 1e-3)
    pos[9], pos[63] = pos[0] + 5e-4, pos[17] - 5e-4
    if mode == "resolve":
        mass[9] = mass[0] * 40.0
    jcfg = jot.SimConfig(dt=1e-3, G=1e-4, eps2=1e-4, collisions=mode, frag_seed=7)
    js = jot.init_forces(j_make_state(pos, vel, mass, radius, precision="f64"),
                         jcfg.replace(force_impl="dense"))
    jmesh = j_make_mesh()
    jstep = jsh.make_sharded_step(jcfg, jmesh, js)
    j1 = jstep(jsh.shard_state(jmesh, js))
    j2 = jstep(j1)
    monkeypatch.setattr(tcoll, "resolve_draws", _jax_draws)
    mesh = _mesh(8)
    step = tot.make_sharded_step(_tcfg(jcfg), mesh, _port_state(js))
    t1 = step(tot.shard_state(mesh, _port_state(js)))
    t2 = step(t1)
    for t, j in ((tot.gather_state(mesh, t1), j1), (tot.gather_state(mesh, t2), j2)):
        alive = np.asarray(j.alive)
        assert not alive.all() and t.pos.dtype == torch.float64
        np.testing.assert_array_equal(t.alive.numpy(), alive)
        np.testing.assert_array_equal(t.mass.numpy(), np.asarray(j.mass))
        _close(t.pos.numpy()[alive], np.asarray(j.pos)[alive], F64, "pos")
        _close(t.vel.numpy()[alive], np.asarray(j.vel)[alive], F64, "vel")


def test_f64_sharded_pm_bounce_matches_jax():
    """PM with bounce in f64 over 4 ranks: the count from the count ring
    after the step (``ring_contacts_fn``, the port's torch count in f64, as
    JAX's), the bounce ring gated on it; 3 steps against JAX's sharded step,
    with bounces on them."""
    rng = np.random.default_rng(5)
    n = 256
    pos, vel = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 0.08)
    jcfg = jot.SimConfig(dt=1e-2, G=1.0, eps2=0.09, force_impl="pm", pm_grid=16,
                         pm_box=(0.0, 0.0, 0.0, 8.0), collisions="bounce", restitution=0.8)
    js = jot.init_forces(j_make_state(pos, vel, mass, radius, precision="f64"), jcfg)
    jmesh = j_make_mesh(shape=(4,), devices=jax.devices()[:4])
    jstep = jsh.make_sharded_step(jcfg, jmesh, js, axis="body")
    mesh = _mesh(4)
    st = _port_state(js)
    step = tot.make_sharded_step(_tcfg(jcfg), mesh, st)
    free = tot.make_sharded_step(_tcfg(jcfg).replace(collisions="none"), mesh, st)
    jo, to, fo = jsh.shard_state(jmesh, js, "body"), tot.shard_state(mesh, st), \
        tot.shard_state(mesh, st)
    for _ in range(3):
        jo, to, fo = jstep(jo), step(to), free(fo)
    tf = tot.gather_state(mesh, to)
    for f in ("pos", "vel"):
        _close(getattr(tf, f).numpy(), getattr(jo, f), PM, f)
    dv = np.abs(tf.vel.numpy() - tot.gather_state(mesh, fo).vel.numpy()).max(1)
    assert (dv > 1e-3).sum() >= 4  # bounces happened


def test_f64_ensemble_mesh_bounce_matches_jax():
    """The (ensemble x body) bounce step in f64 over (2 x 4) ranks against
    JAX's ``make_sharded_ensemble_step`` (its vmapped ``_block_bounce`` in
    f64, every step): 4 perturbed members of a 32-body cluster with a
    planted cross-shard pair, 3 steps."""
    rng = np.random.default_rng(3)
    n, E = 32, 4
    base = rng.normal(size=(n, 3)) * 0.6
    base[17] = base[0] + np.array([0.05, 0.0, 0.0])
    vel = rng.normal(size=(n, 3)) * 0.2
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 0.12)
    jcfg = jot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="bounce", restitution=0.5)
    force = j_resolve_force_fn(jcfg.replace(force_impl="dense"), n)
    states = []
    for _ in range(E):
        s = j_make_state(base + 1e-3 * rng.normal(size=(n, 3)), vel, mass, radius,
                         precision="f64")
        acc, U_ = force(s.pos, s.mass, s.alive)
        states.append(s.replace(acc=acc, potential=U_))
    js = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    axes = ("ensemble", "body")
    jstep, shardings = jsh.make_sharded_ensemble_step(
        jcfg, j_make_mesh(shape=(2, 4), axis_names=axes), js)
    jo = jax.device_put(js, shardings)
    ts = _port_state(js)
    mesh = tot.make_mesh(shape=(2, 4), axis_names=axes, devices="cpu")
    step, place = tot.make_sharded_ensemble_step(_tcfg(jcfg), mesh, ts)
    shards = place(ts)
    for _ in range(3):
        jo, shards = jstep(jo), step(shards)
    out = tot.gather_ensemble(mesh, shards)
    assert out.pos.dtype == torch.float64
    for f in ("pos", "vel"):
        _close(getattr(out, f).numpy(), getattr(jo, f), F64, f)
    moved = np.abs(out.vel.numpy() - vel[None]).max(-1)
    assert (moved > 0.05).sum() >= 2  # the planted pair bounced in the members


# --- the f64 count: the double test the f64 instance makes ---------------------

def _kernel_count(p_i, r_i, a_i, i_off, p_j, r_j, a_j, j_off):
    """A pair-by-pair mirror of ``count_row_f64`` (``csrc/nbody_forces.cu``):
    d = r_i - r_j, r2 = (dx dx + dy dy) + dz dz, rsum = (R_i + R_j) 1.00001,
    counted when r2 <= rsum rsum, ids different, both alive; numpy's f64
    operations are correctly rounded and fuse nothing, as the kernel's
    __dsub_rn, __dmul_rn and __dadd_rn."""
    d = p_i[:, None, :] - p_j[None, :, :]
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    rsum = (r_i[:, None] + r_j[None, :]) * 1.00001
    ids = np.arange(len(p_i))[:, None] + i_off != np.arange(len(p_j))[None, :] + j_off
    return int(((r2 <= rsum * rsum) & ids & a_i[:, None] & a_j[None, :]).sum())


def _planted_at_threshold(n=128, seed=17):
    """n bodies; body i + n/2 planted from body i at 1.00001 (R_i + R_j)
    (1 + k 2^-52), k from -8 to 7, along a random direction (so that its
    rounded r^2 falls either side); a few dead, and the rest apart."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50, 50, (n, 3))
    radius = rng.uniform(0.01, 0.2, n)
    h = n // 2
    for i in range(h):
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        dist = 1.00001 * (radius[i] + radius[i + h]) * (1.0 + (i % 16 - 8) * 2.0 ** -52)
        pos[i + h] = pos[i] + dist * u
    alive = np.ones(n, bool)
    alive[[5, 70]] = False
    return pos, radius, alive


@pytest.mark.parametrize("offsets", [(0, 0), (0, 128), (256, 128)])
def test_f64_count_at_the_threshold_matches_jax(offsets):
    """The plain f64 count (``block_contacts``, the f64 instance's plain
    version) against JAX's ``_contacts_block`` in f64 and the kernel's
    pair-by-pair mirror, on pairs planted within a few ulps either side of
    1.00001 (R_i + R_j): integer-equal, and the planted pairs split both
    ways. At equal offsets the tables coincide (the diagonal round)."""
    pos, radius, alive = _planted_at_threshold()
    i0, j0 = offsets
    h = len(pos) // 2
    p_i, r_i, a_i = pos, radius, alive
    p_j, r_j, a_j = (pos, radius, alive) if i0 == j0 else (pos[::-1].copy(),
                                                           radius[::-1].copy(),
                                                           alive[::-1].copy())
    ref = int(jcoll._contacts_block(p_i, r_i, a_i, np.arange(i0, i0 + len(p_i)), p_j, r_j,
                                    a_j, np.arange(j0, j0 + len(p_j))))
    mirror = _kernel_count(p_i, r_i, a_i, i0, p_j, r_j, a_j, j0)
    t = [torch.from_numpy(x) for x in (p_i, r_i, a_i, p_j, r_j, a_j)]
    got = tcoll.block_contacts(t[0], t[1], t[2], i0, t[3], t[4], t[5], j0)
    assert got.dtype == torch.int32 and int(got) == ref == mirror
    # the planted pairs alone: some in, some out, at one ulp's distance
    d = pos[h:] - pos[:h]
    r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    rs = (radius[:h] + radius[h:]) * 1.00001
    inside = r2 <= rs * rs
    assert 8 <= inside.sum() <= h - 8


def test_f64_detect_plain_is_b3_on_the_cast_tables():
    """The f64 instance's plain version: its forces bit-equal to
    ``block_acc_plain`` on the tables cast as ``in_f32`` casts them (a
    coordinate beyond 2^100 clamped), returned in f64, and its count the
    f64 ``block_contacts``."""
    rng = np.random.default_rng(2)
    p_i, p_j = rng.normal(size=(128, 3)), rng.normal(size=(256, 3))
    m_j, r_i, r_j = rng.uniform(0.5, 1.5, 256), np.full(128, 0.1), np.full(256, 0.1)
    a_i, a_j = np.ones(128, bool), np.ones(256, bool)
    a_j[7], m_j[7], p_j[7] = False, 0.0, 3e30  # parked beyond 2^100
    t = [torch.from_numpy(x) for x in (p_i, r_i, a_i, p_j, m_j, r_j, a_j)]
    acc, pe, count = cuda_forces.block_acc_detect_cuda(t[0], t[1], t[2], 0, t[3], t[4], t[5],
                                                       t[6], 128, G=1.0, eps2=1e-4)
    big = 2.0 ** 100
    cast = [x.clamp(-big, big).float() for x in (t[0], t[3], t[4])]
    a3, pe3 = cuda_forces.block_acc_plain(*cast, G=1.0, eps2=1e-4)
    assert acc.dtype == pe.dtype == torch.float64
    assert torch.equal(acc, a3.double()) and torch.equal(pe, pe3.double())
    assert torch.isfinite(acc).all()
    assert int(count) == int(tcoll.block_contacts(t[0], t[1], t[2], 0, t[3], t[5], t[6], 128))
    assert int(count) > 0


# --- routing: the f64 ring hands its f64 tables to both kernels --------------

def test_f64_ring_hands_f64_tables_to_both_kernels(monkeypatch):
    """On the kernel route (``ring_block_impl="pallas"``, wrappers
    monkeypatched to record and run their CPU paths) an f64 collision step
    calls B3 detect and the block bounce P^2 times each, with float64
    positions, masses and radii, uncast; the count and the step equal the
    dense route's count and the step on the plain f64 versions (the forces
    f32 inside, as on the card)."""
    seen = {"B3D": [], "BB": []}
    b3d_real, bb_real = cuda_forces.block_acc_detect_cuda, cuda_collisions.bounce_block_cuda

    def b3d(pos_i, r_i, a_i, i_off, pos_j, m_j, r_j, a_j, j_off, **k):
        seen["B3D"].append({t.dtype for t in (pos_i, r_i, pos_j, m_j, r_j)})
        out = b3d_real(pos_i, r_i, a_i, i_off, pos_j, m_j, r_j, a_j, j_off, **k)
        seen.setdefault("counts", []).append(int(out[2]))
        return out

    def bb(*a, **k):
        seen["BB"].append({t.dtype for t in a[:4] + a[5:9]} | {
            o.dtype for o in (k.get("out") or ())})
        return bb_real(*a, **k)

    monkeypatch.setattr(cuda_forces, "block_acc_detect_cuda", b3d)
    monkeypatch.setattr(cuda_collisions, "bounce_block_cuda", bb)
    pos, vel, mass, radius = _dense_bounce_scene(n=512, seed=9)
    radius[:] = 0.05
    cfg = tot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, ring_block_impl="pallas",
                        collisions="bounce", restitution=0.8)
    st = tot.init_forces(tot.make_state(pos, vel, mass, radius, precision="f64",
                                        device="cpu"), cfg.replace(force_impl="dense"))
    mesh = _mesh(4)
    out = tot.gather_state(mesh, tot.make_sharded_step(cfg, mesh, st)(
        tot.shard_state(mesh, st)))
    assert len(seen["B3D"]) == 16 and len(seen["BB"]) == 16
    assert all(d == {torch.float64} for d in seen["B3D"] + seen["BB"])
    dense = tot.make_sharded_step(cfg.replace(ring_block_impl="dense"), mesh, st)
    ref = tot.gather_state(mesh, dense(tot.shard_state(mesh, st)))
    assert sum(seen["counts"]) > 0 and out.pos.dtype == torch.float64
    # the f32-inside forces part from the dense f64 ones at f32 rounding
    _close(out.vel.numpy(), ref.vel.numpy(), dict(rtol=2e-5, atol=1e-6), "vel")
    assert np.abs(out.vel.numpy() - st.vel.numpy()).max() > 0.1  # bounces happened


# --- the f32 prefilter of both f64 instances ---------------------------------

def _cast(x):
    """``utils.kernels.in_f32``'s cast in numpy."""
    return np.clip(x, -2.0 ** 100, 2.0 ** 100).astype(np.float32)


def _fma32(a, b, c):
    """fmaf in numpy: the f32 product is exact in f64, so one rounding of the
    f64 sum to f32 is fmaf's result but for a double rounding (at most one
    f32 ulp off, which the bound's 2^-20 covers many times)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(
        np.float32)


def _reach2(rsum, scale, c):
    """``reach2`` of both sources, in f64 without its upward rounding (so at
    or below the kernels' f32 value)."""
    e = scale * (U / (1 - U)) + 2.0 ** -149
    lin = e * np.sqrt(3.0) + (rsum + 2.0 ** -149) * c
    return lin * lin * (1.0 + 2.0 ** -20) + 2.0 ** -146


def _prefilter_scene(kind, n=1024, seed=23):
    """A scene of the prefilter case, with 64 pairs planted a few ulps either
    side of the thresholds (32 at R_i + R_j, the bounce's, and 32 at 1.00001
    (R_i + R_j), the count's)."""
    rng = np.random.default_rng(seed)
    if kind == "si":  # positions sigma 1e9 m, radii 3e8 m
        pos, radius = rng.normal(size=(n, 3)) * 1e9, np.full(n, 3e8)
    else:
        pos = rng.normal(size=(n, 3)) * 0.3
        if kind == "bench":
            radius = np.full(n, 1e-4)
        elif kind == "rich":
            pos, radius = pos * 0.05, np.full(n, 3e-3)
        else:  # "far": the rich cluster 3e3 from the origin, where a cast
            # coordinate's error (~2e-4) is a tenth of the contact distance
            pos, radius = pos * 0.05 + 3e3, np.full(n, 3e-3)
    for i in range(64):
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        c = 1.0 if i < 32 else 1.00001
        dist = c * (radius[i] + radius[i + 64]) * (1.0 + (i % 16 - 8) * 2.0 ** -52)
        pos[i + 64] = pos[i] + dist * u
    return pos, radius


@pytest.mark.parametrize("kind", ["bench", "rich", "si", "far"])
def test_f64_prefilter_keeps_every_counted_pair(kind):
    """The f32 prefilter of both f64 instances (a pair passes when the f32
    r^2 of the cast rows is <= reach2 at its cast radii and coordinate
    scales, which the tile's largest radius and scale only raise) keeps
    every pair that the double tests keep: B3 detect's count (r^2 <= ((R_i +
    R_j) 1.00001)^2, c = 1.00002, its r^2 as fmaf(dz, dz, fmaf(dx, dx, dy
    dy)) of d = r_j - r_i) and the block bounce's touching test (r^2 <=
    (R_i + R_j)^2, c = 1.000001, fmaf(dz, dz, fmaf(dy, dy, dx dx))). A
    quarter of the bodies are dead, and the scenes have pairs both tests
    keep. The bound stays tight: it flags few pairs that the test rejects."""
    pos, radius = _prefilter_scene(kind)
    rng = np.random.default_rng(3)
    live = rng.uniform(size=len(pos)) >= 0.25
    # the double tests
    d = pos[:, None, :] - pos[None, :, :]  # r_i - r_j
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    both = live[:, None] & live[None, :] & ~np.eye(len(pos), dtype=bool)
    rs = (radius[:, None] + radius[None, :])
    counted = both & (r2 <= (rs * 1.00001) ** 2)
    touching = both & (r2 <= rs * rs) & (r2 > 0)
    assert touching.sum() >= 10 and counted.sum() >= touching.sum()
    # the f32 side
    c32 = _cast(pos)
    dd = c32[None, :, :] - c32[:, None, :]  # f32 r_j - r_i (exact negation of r_i - r_j)
    dx, dy, dz = dd[..., 0], dd[..., 1], dd[..., 2]
    r2_b3 = _fma32(dz, dz, _fma32(dx, dx, dy * dy))
    r2_bb = _fma32(dz, dz, _fma32(dy, dy, dx * dx))
    rad32 = _cast(radius).astype(np.float64)
    scale = np.abs(c32).max(1).astype(np.float64)
    rsum = rad32[:, None] + rad32[None, :]
    sc = scale[:, None] + scale[None, :]
    keep_b3 = r2_b3 <= _reach2(rsum, sc, np.float32(1.00002))
    keep_bb = r2_bb <= _reach2(rsum, sc, np.float32(1.000001))
    assert not (counted & ~keep_b3).any(), "B3 detect f64's prefilter drops a counted pair"
    assert not (touching & ~keep_bb).any(), "the f64 block bounce's prefilter drops a pair"
    # not loose: each flags at most twice the pairs the count keeps (the
    # far cluster's cast error widens the reach by ~10%; the bench row's
    # by ~1e-3, which takes in the pairs planted at the count's threshold)
    for keep in (keep_b3, keep_bb):
        assert (keep & both).sum() <= 2 * counted.sum() + 16, (kind, keep.sum(),
                                                                counted.sum())
