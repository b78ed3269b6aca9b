"""The body-sharded paths of the PyTorch port (``parallel.mesh``,
``parallel.sharded``, the sharded PM, ``simulate(mesh=)``) against the JAX
package's own sharded functions on conftest's 8 virtual CPU devices.

The port runs each case on a one-card mesh of CPU ranks (threads); one test
runs the same steps in 2 gloo processes (``tests/torch_dist_worker.py``)
and requires them bit-equal to the one-card mesh at 2 ranks: the CPU
arithmetic is the same code in the same order, and a 2-rank sum is
commutative. Inputs come from a numpy seed and go to both packages.

Tolerances, from the errors measured on these scenes:
  * f64 ring forces and steps: rtol 1e-12 / atol 1e-14 (each round's block
    is summed in another order by torch and XLA; the ring's acc measured
    within 2.3e-16 of max |a| at 1-8 ranks).
  * f32 and ds32: the JAX tests' own bounds (rtol 2e-5, atol 1e-6 a step;
    the ring's acc measured within 2.5e-7 of max |a|), the ring's U within
    rel 1e-6 (measured <= 1.1e-7).
  * contact counts, alive masks, merged bodies: equal.
  * the plain block bounce (the CUDA kernel's formulation: r^2 tests, one
    rsqrt) against JAX's ``_block_bounce`` (sqrt distances): f64, max |d| /
    max |ref| <= 1e-12 (measured 1.0e-16).
  * the sharded PM against JAX's sharded PM: rtol 1e-5 / atol 1e-7 (the
    JAX test's bounds against its own unsharded solve; both deposit in
    float32 in another order); against the port's single-rank step the
    accelerations within the f32 bounds above (eight partial grids summed
    against one deposit).
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine.integrators import make_step_fn as j_make_step_fn
from orbital_tpu.engine.rollout import resolve_force_fn as j_resolve_force_fn
from orbital_tpu.engine.state import make_state as j_make_state
from orbital_tpu.ops import collisions as jcoll
from orbital_tpu.parallel import sharded as jsh
from orbital_tpu.parallel.mesh import make_mesh as j_make_mesh
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.ops import cuda_collisions, cuda_forces
from orbital_tpu_torch.parallel import mesh as tmesh
from orbital_tpu_torch.parallel import sharded as tsh
from orbital_tpu_torch.parallel.ensemble import _stack
from orbital_tpu_torch.utils import kernels

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F64 = dict(rtol=1e-12, atol=1e-14)
F32 = dict(rtol=2e-5, atol=1e-6)
HERE = Path(__file__).resolve().parent


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def _tcfg(jcfg):
    return tot.SimConfig(**dataclasses.asdict(jcfg))


def _mesh(p):
    return tot.make_mesh(shape=(p,), devices="cpu")


def _cluster(n=64, seed=42, scale=1.0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * scale
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), err_msg=what, **tol)


def _assert_states(ts, js, tol, fields=("pos", "vel", "acc")):
    for f in fields:
        _close(getattr(ts, f).numpy(), getattr(js, f), tol, f)
    _close(ts.potential.numpy(), js.potential, dict(rtol=max(tol["rtol"], 1e-6), atol=0.0),
           "potential")
    assert int(ts.step) == int(js.step)


def _j_ring(cfg, p, n_dev=None):
    """JAX's ring force on p of the 8 virtual devices, jitted."""
    mesh = j_make_mesh(shape=(p,), devices=jax.devices()[:p])
    return jax.jit(jax.shard_map(
        jsh.ring_force_fn(cfg, p), mesh=mesh,
        in_specs=(JP("body", None), JP("body"), JP("body")),
        out_specs=(JP("body", None), JP()), check_vma=cfg.ring_block_impl != "pallas"))


def _t_ring(cfg, mesh, pos, mass, alive, detect=False, radius=None):
    """The port's ring over a one-card mesh: (acc [N, 3], U[, contacts])."""
    p = mesh.size
    fns = [tsh.ring_force_fn(cfg, c, detect=detect) for c in mesh.comms]

    def cut(x):
        return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(p))

    if detect:
        out = mesh.run(lambda comm, fn, *a: fn(*a), fns, cut(pos), cut(mass), cut(radius),
                       cut(alive))
    else:
        out = mesh.run(lambda comm, fn, *a: fn(*a), fns, cut(pos), cut(mass), cut(alive))
    return (torch.cat([o[0] for o in out]),) + tuple(out[0][1:])


# --- the mesh and its collectives -------------------------------------------

def test_make_mesh_and_errors():
    mesh = tot.make_mesh(shape=(4,), devices=["cpu"])
    assert mesh.shape == {"body": 4} and mesh.axis_names == ("body",) and mesh.local
    assert mesh.ranks == [0, 1, 2, 3] and mesh.device == torch.device("cpu")
    assert tot.make_mesh(devices=["cpu"] * 3).size == 3
    assert tot.make_mesh(shape=(2,), devices=["cpu"] * 8).size == 2
    assert tmesh.BODY_AXIS == "body" and tmesh.ENSEMBLE_AXIS == "ensemble"
    with pytest.raises(ValueError, match="shape required"):
        tot.make_mesh(axis_names=("ensemble", "body"), devices="cpu")
    # the (ensemble x body) mesh is ported (A.15b): it builds
    assert tot.make_mesh(shape=(2, 4), axis_names=("ensemble", "body"),
                         devices="cpu").shape == {"ensemble": 2, "body": 4}
    with pytest.raises(ValueError, match="one device"):
        tot.make_mesh(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="over 2 devices"):
        tot.make_mesh(shape=(4,), devices=["cpu", "cpu"])


def test_local_collectives_match_jax_semantics():
    """ppermute is JAX's forward ring (rank r receives rank r - 1's), psum,
    pmin, pmax reduce in rank order on every rank, all_gather is tiled."""
    mesh = _mesh(4)
    blocks = [torch.arange(3, dtype=torch.float64) + 10 * r for r in range(4)]

    def per_rank(comm, x):
        recv, flag = comm.ppermute((x, x > 15))
        return (recv, flag, comm.psum(x), comm.pmin(x), comm.pmax(x), comm.all_gather(x),
                comm.axis_index)

    out = mesh.run(per_rank, blocks)
    for r, (recv, flag, s, lo, hi, g, idx) in enumerate(out):
        assert idx == r and torch.equal(recv, blocks[(r - 1) % 4])
        assert flag.dtype == torch.bool and torch.equal(flag, blocks[(r - 1) % 4] > 15)
        assert torch.equal(s, blocks[0] + blocks[1] + blocks[2] + blocks[3])
        assert torch.equal(lo, blocks[0]) and torch.equal(hi, blocks[3])
        assert torch.equal(g, torch.cat(blocks))
    assert mesh.exchange_seconds() > 0.0


def test_a_failing_rank_releases_the_others():
    mesh = _mesh(3)

    def per_rank(comm):
        if comm.rank == 1:
            raise RuntimeError("rank 1 fails")
        return comm.psum(torch.ones(1))

    with pytest.raises(RuntimeError, match="rank 1 fails"):
        mesh.run(per_rank)
    # the mesh is usable again
    assert [float(x) for x in mesh.run(lambda comm: comm.psum(torch.ones(1)))] == [3.0] * 3


def test_threads_under_stress():
    """More threads than cores with a shortened switch interval: launch
    counts from several threads all land, and a 12-rank mesh's ring shifts
    and psums stay exact over many rounds (no slot read before it is
    written or after it is reused)."""
    workers = (os.cpu_count() or 1) + 4
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                kernels.count_launch(bump)

        bump.launches = 0
        threads = [threading.Thread(target=bump) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert bump.launches == workers * 2000

        mesh = _mesh(12)

        def per_rank(comm):
            x = torch.tensor([float(comm.rank)])
            for k in range(1, 61):
                (x,) = comm.ppermute((x,))
                assert float(x) == (comm.rank - k) % 12
                assert float(comm.psum(x)) == 66.0
            return float(x)

        assert mesh.run(per_rank) == [float(r) for r in range(12)]
    finally:
        sys.setswitchinterval(interval)


# --- the plain block kernels against JAX's blocks ---------------------------

def _blocks(seed=7, n_i=96, n_j=80):
    """Two overlapping clouds with touching pairs across and inside them,
    dead bodies on both sides (one inside the contact range) and, as row 3
    of i and row 0 of j, a body present in both tables (the ring's diagonal
    round)."""
    rng = np.random.default_rng(seed)
    p_i, p_j = rng.uniform(0, 1, (n_i, 3)), rng.uniform(0, 1, (n_j, 3))
    v_i, v_j = rng.normal(size=(n_i, 3)), rng.normal(size=(n_j, 3))
    m_i, m_j = rng.uniform(0.5, 1.5, n_i), rng.uniform(0.5, 1.5, n_j)
    r_i, r_j = rng.uniform(0.02, 0.08, n_i), rng.uniform(0.02, 0.08, n_j)
    a_i, a_j = np.ones(n_i, bool), np.ones(n_j, bool)
    a_i[[2, 40]] = False
    a_j[[5, 60]] = False
    p_j[0], v_j[0], m_j[0], r_j[0] = p_i[3], v_i[3], m_i[3], r_i[3]
    m_j[9] = 0.0
    return p_i, v_i, m_i, r_i, a_i, p_j, v_j, m_j, r_j, a_j


def test_block_bounce_plain_matches_jax():
    p_i, v_i, m_i, r_i, a_i, p_j, v_j, m_j, r_j, a_j = _blocks()
    m_eff_i, m_eff_j = m_i * a_i, m_j * a_j
    jdp, jdv = jsh._block_bounce(p_i, v_i, m_eff_i, r_i, p_j, v_j, m_eff_j, r_j, a_j,
                                 restitution=0.7)
    t = [torch.from_numpy(x) for x in (p_i, v_i, m_i, r_i, a_i, p_j, v_j, m_j, r_j, a_j)]
    dp, dv = cuda_collisions.bounce_block_cuda(*t, restitution=0.7)
    jdp, jdv = np.asarray(jdp), np.asarray(jdv)
    assert np.abs(jdv).max() > 0.1 and (np.abs(jdv).sum(1) > 0).sum() >= 10
    for got, ref in ((dp, jdp), (dv, jdv)):
        ref = ref * a_i[:, None]  # the ring's caller keeps live rows only
        assert np.abs(got.numpy() * a_i[:, None] - ref).max() <= 1e-12 * np.abs(ref).max()
    # gated: a zero count writes zeros, a positive one the same deltas
    z = cuda_collisions.bounce_block_cuda(*t, restitution=0.7,
                                          contacts=torch.tensor(0, dtype=torch.int32))
    assert not z[0].any() and not z[1].any()
    g = cuda_collisions.bounce_block_cuda(*t, restitution=0.7,
                                          contacts=torch.tensor(3, dtype=torch.int32))
    assert torch.equal(g[0], dp) and torch.equal(g[1], dv)


def _covers_every_pair_once(p, n_i, n_j, rows, warps):
    """Walk a launch plan of B3's form as its kernels walk it (block u takes
    i tile u % tiles against j split u // tiles; warp w of a block sweeps
    the split's j tiles w, w + warps, ..., cut at the split's end): every (i
    tile, j) pair once, no empty split, whole j tiles a split."""
    tiles, splits, split_len = p["tiles"], p["splits"], p["split_len"]
    assert tiles == -(-n_i // rows) and p["units"] == p["grid"] == tiles * splits
    assert split_len % 128 == 0 and (splits - 1) * split_len < n_j
    assert n_j <= splits * split_len
    seen = set()
    cover = np.zeros(n_j, np.int64)  # every i tile meets the same splits
    for u in range(p["grid"]):
        t, s_ = u % tiles, u // tiles
        assert (t, s_) not in seen
        seen.add((t, s_))
        if t:
            continue
        end = min((s_ + 1) * split_len, n_j)
        swept = 0
        for w in range(warps):
            for j0 in range(s_ * split_len + 128 * w, end, 128 * warps):
                cover[j0:min(j0 + 128, end)] += 1
                swept += min(j0 + 128, end) - j0
        assert swept == end - s_ * split_len > 0
    assert len(seen) == tiles * splits and bool((cover == 1).all())


@pytest.mark.parametrize("n_i", [8192, 16384, 65536])
def test_block_plan_covers_every_pair_once(n_i):
    """B3's launch plan (``cuda_forces.block_plan``), walked as
    csrc/nbody_forces.cu's block_forces_kernel walks it (block u takes i
    tile u % tiles against j split u // tiles; warp w of a block sweeps the
    split's j tiles w, w + warps, ..., cut at the split's end): every (i
    tile, j) pair once, no empty split, whole j tiles a split, and at least
    2 x 132 blocks where n_i <= 16,384, the ring's shards at 8 and 4 ranks
    of the 65,536-body row (n_j the shards the ring meets there and one
    other size), at three block shapes and three co-resident counts on 132
    SMs; at 65,536^2 one split, so that B3 keeps B1's summation order."""
    sms = 132
    for n_j in (n_i, 2 * n_i, 4992):
        for rows, warps in ((64, 16), (128, 8), (128, 16)):
            for resident in (132, 264, 528):
                p = cuda_forces.block_plan(n_i, n_j, rows, warps, 128, resident, sms)
                if n_i <= 16384:
                    assert p["grid"] >= 2 * sms, (n_i, n_j, rows, warps, resident, p)
                if n_i == n_j == 65536:
                    assert p["splits"] == 1
                _covers_every_pair_once(p, n_i, n_j, rows, warps)
    with pytest.raises(ValueError, match="must be >= 1"):
        cuda_forces.block_plan(n_i, 0, 64, 16, 128, 264, sms)


@pytest.mark.parametrize("n_i, n_j", [(16384, 16384), (8192, 8192), (65536, 65536),
                                      (2000, 3000)])
def test_bounce_plan_covers_every_pair_once(n_i, n_j):
    """The block bounce's launch plan (``cuda_collisions.bounce_plan``),
    walked as csrc/collisions.cu's bounce_block_kernel walks it: every (i
    tile, j) pair once at the ring's 16,384^2 and 8,192^2 (4 and 8 ranks of
    the 65,536-body row), at 65,536^2 and on the ragged pair of phase 51
    (2,000 x 3,000), at the kernel's shape (4 i bodies a thread, 8 warps)
    and two others, two and four blocks an SM of 132 SMs: at 16,384^2 and
    8,192^2 one wave with a block on every SM, at 65,536^2 one split (B6's
    order); the plan pinned to one split (the check against B6) too."""
    sms = 132
    for k, q in ((4, 8), (4, 4), (2, 8)):
        for per_sm in (2, 4):
            p = cuda_collisions.bounce_plan(n_i, n_j, k, q, 128, per_sm * sms, sms)
            if n_i in (8192, 16384):
                assert sms <= p["grid"] <= per_sm * sms, (k, q, per_sm, p)
            if n_i == 65536:
                assert p["splits"] == 1
            _covers_every_pair_once(p, n_i, n_j, 32 * k, q)
            one = cuda_collisions.bounce_plan(n_i, n_j, k, q, 128, per_sm * sms, sms, 1)
            assert one["splits"] == 1 and one["grid"] == -(-n_i // (32 * k))
            _covers_every_pair_once(one, n_i, n_j, 32 * k, q)
    p = cuda_collisions.bounce_plan(n_i, n_j, 4, 8, 128, 264, sms)
    assert p["splits"] == {16384: 2, 8192: 4, 65536: 1}.get(n_i, p["splits"])


def _ring_bounce_today(comm, pos, vel, mass, radius, alive, restitution, contacts):
    """The ring bounce as it summed its rounds before the accumulate form:
    each round a fresh block (the plain version), cast and added."""
    visit, dpos, dvel = (pos, vel, mass, radius, alive), None, None
    for k in range(comm.size):
        dp, dv = cuda_collisions.bounce_block_plain(pos, vel, mass, radius, alive, *visit,
                                                    restitution=restitution,
                                                    contacts=contacts)
        dp, dv = dp.to(pos.dtype), dv.to(vel.dtype)
        dpos, dvel = (dp, dv) if k == 0 else (dpos + dp, dvel + dv)
        if k < comm.size - 1:
            visit = comm.ppermute(visit)
    keep = alive[:, None].to(dpos.dtype)
    return dpos * keep, dvel * keep


@pytest.mark.parametrize("p", [2, 4])
def test_ring_bounce_accumulates_bit_equal_and_matches_jax(p):
    """The f32 ring bounce (``ring_bounce_fn``: round 0 writes, each later
    round adds its block into the rank's sums in place, ``out=``; here the
    plain version's form), round by round on the one-card mesh's threads:
    bit-equal to the rounds summed as before (a fresh block a round, then
    ``dpos + dp``), zeros at a count of 0 and the ungated sums at a count >
    0, and within 2e-6 of max |d| of JAX's ``ring_bounce_fn`` under
    ``shard_map`` (f32 sums of the same impulses in another form)."""
    rng = np.random.default_rng(11)
    n = 96 * 4
    pos, vel = rng.uniform(0, 1, (n, 3)), rng.normal(size=(n, 3))
    mass, radius = rng.uniform(0.5, 1.5, n), rng.uniform(0.02, 0.06, n)
    alive = np.ones(n, bool)
    alive[::13] = False
    f32 = [np.asarray(x, np.float32) for x in (pos, vel, mass, radius)] + [alive]
    cfg = tot.SimConfig(dt=1e-3, restitution=0.7, collisions="bounce")
    mesh = _mesh(p)
    shards = [list(torch.from_numpy(x).chunk(p)) for x in f32]
    fns = [tsh.ring_bounce_fn(cfg, c) for c in mesh.comms]
    for count in (None, 3, 0):
        contacts = None if count is None else torch.tensor(count, dtype=torch.int32)
        new = mesh.run(lambda comm, fn, *a: fn(*a, 0.7, contacts), fns, *shards)
        old = mesh.run(lambda comm, *a: _ring_bounce_today(comm, *a, 0.7, contacts),
                       *shards)
        for (dp, dv), (rp, rv) in zip(new, old):
            assert dp.dtype == torch.float32 and torch.equal(dp, rp) and torch.equal(dv, rv)
        got = [torch.cat([o[i] for o in new]).numpy() for i in (0, 1)]
        if count is None:
            ungated = got
        elif count:
            assert all(np.array_equal(g, u) for g, u in zip(got, ungated))
        else:
            assert not any(g.any() for g in got)
    jcfg = jot.SimConfig(dt=1e-3, restitution=0.7, collisions="bounce", shard_axis="body")
    jmesh = j_make_mesh(shape=(p,), devices=jax.devices()[:p])
    body = (JP("body", None), JP("body", None), JP("body"), JP("body"), JP("body"))
    jfn = jax.jit(jax.shard_map(jsh.ring_bounce_fn(jcfg, p), mesh=jmesh, in_specs=body,
                                out_specs=(JP("body", None), JP("body", None))))
    ref = [np.asarray(x) for x in jfn(*f32)]
    assert np.abs(ref[1]).max() > 0.1 and (np.abs(ref[1]).sum(1) > 0).sum() >= 20
    for g, r in zip(ungated, ref):
        assert np.abs(g - r).max() <= 2e-6 * np.abs(r).max()


@pytest.mark.parametrize("offsets", [(0, 0), (96, 0), (0, 96), (192, 288)])
def test_block_count_plain_matches_jax(offsets):
    """The plain detecting block (B3's plain forces and the count with
    global ids) against JAX's ``_contacts_block``. At equal offsets the
    tables coincide, as in the ring's diagonal round: the self pairs are
    excluded by id, and a coincident pair of distinct bodies is counted."""
    p_i, _, m_i, r_i, a_i, p_j, _, m_j, r_j, a_j = _blocks(n_i=128, n_j=128)
    i0, j0 = offsets
    if i0 == j0:
        p_j, m_j, r_j, a_j = p_i, m_i, r_i, a_i
    ref = int(jcoll._contacts_block(p_i, r_i, a_i, np.arange(i0, i0 + 128), p_j, r_j, a_j,
                                    np.arange(j0, j0 + 128)))
    t = [torch.from_numpy(x) for x in (p_i, r_i, a_i, p_j, m_j, r_j, a_j)]
    acc, pe, count = cuda_forces.block_acc_detect_cuda(t[0], t[1], t[2], i0, t[3], t[4], t[5],
                                                       t[6], j0, G=1.0, eps2=1e-4)
    a3, pe3 = cuda_forces.block_acc_plain(t[0], t[3], t[4], G=1.0, eps2=1e-4)
    assert ref > 20 and int(count) == ref and count.dtype == torch.int32
    assert torch.equal(acc, a3) and torch.equal(pe, pe3)
    if i0 == j0:  # the same tables apart: every live body's self pair counts
        apart = cuda_forces.block_acc_detect_plain(t[0], t[1], t[2], 0, t[3], t[4], t[5],
                                                   t[6], 128, G=1.0, eps2=1e-4)[2]
        assert int(apart) == ref + int(a_i.sum())


# --- the ring force -------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_force_matches_jax(p):
    """JAX ``test_parallel.py:31, 203``: f32 and f64 at N = 64 (dense
    blocks); the port's psum'd U and acc against JAX's sharded ring."""
    pos, _, mass = _cluster()
    alive = np.ones(64, bool)
    alive[[3, 40]] = False
    for dtype, tol in ((np.float32, F32), (np.float64, F64)):
        jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, shard_axis="body")
        ja, jU = _j_ring(jcfg, p)(pos.astype(dtype), mass.astype(dtype), alive)
        ta, tU = _t_ring(_tcfg(jcfg), _mesh(p), pos.astype(dtype), mass.astype(dtype), alive)
        _close(ta.numpy(), ja, tol, f"acc {dtype.__name__}")
        _close(tU.numpy(), jU, dict(rtol=tol["rtol"] * 0.05, atol=0.0), "U")


@pytest.mark.parametrize("p", [2, 8])
def test_ring_force_pallas_blocks_match_jax(p):
    """JAX ``test_parallel.py:286``: N = 1,024, ring_block_impl="pallas"
    (JAX's Pallas block kernel in interpret mode, the port's B3 plain
    version on CPU tensors), and the ring's fused count against JAX's count
    ring on planted cross-shard contacts."""
    pos, _, mass = _cluster(1024, seed=5)
    radius = np.full(1024, 2e-3)
    alive = np.ones(1024, bool)
    alive[[7, 500, 900]] = False
    pos[1000] = pos[3] + 1e-3
    pos[600] = pos[130] - 1e-3
    pos[901] = pos[900] + 1e-3  # a dead partner: not counted
    pos, mass = pos.astype(np.float32), mass.astype(np.float32)
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, shard_axis="body",
                         ring_block_impl="pallas")
    ja, jU = _j_ring(jcfg, p)(pos, mass, alive)
    jmesh = j_make_mesh(shape=(p,), devices=jax.devices()[:p])
    jc = jax.jit(jax.shard_map(jsh.ring_contacts_fn(jcfg, p), mesh=jmesh,
                               in_specs=(JP("body", None), JP("body"), JP("body")),
                               out_specs=JP()))(pos, radius.astype(np.float32), alive)
    mesh = _mesh(p)
    ta, tU, tc = _t_ring(_tcfg(jcfg), mesh, pos, mass, alive, detect=True,
                         radius=radius.astype(np.float32))
    _close(ta.numpy(), ja, F32, "acc")
    _close(tU.numpy(), jU, dict(rtol=1e-6, atol=0.0), "U")
    assert int(tc) == int(jc) == 4
    t2a, t2U = _t_ring(_tcfg(jcfg), mesh, pos, mass, alive)
    assert torch.equal(t2a, ta) and torch.equal(t2U, tU)


# --- the sharded step -------------------------------------------------------

@pytest.mark.parametrize("precision", ["f64", "ds32"])
def test_sharded_step_matches_jax(precision):
    """JAX ``test_parallel.py:50``: two collision-free KDK steps over 8
    shards against JAX's sharded step on the same initial state."""
    pos, vel, mass = _cluster()
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    js = jot.init_forces(j_make_state(pos, vel, mass, precision=precision), jcfg)
    jstep = jsh.make_sharded_step(jcfg, j_make_mesh(), js, axis="body")
    jf = jstep(jstep(jsh.shard_state(j_make_mesh(), js, "body")))
    mesh = _mesh(8)
    step = tot.make_sharded_step(_tcfg(jcfg), mesh, _port_state(js), axis="body")
    tf = tot.gather_state(mesh, step(step(tot.shard_state(mesh, _port_state(js), "body"))))
    tol = F64 if precision == "f64" else F32
    _assert_states(tf, jf, tol)
    if precision == "ds32":
        _close(tf.pos_full().numpy(), np.asarray(jf.pos) + np.asarray(jf.pos_lo), F32)


def test_sharded_bounce_matches_jax():
    """JAX ``test_parallel.py:113``: a dense cluster with large radii, 3
    steps of the ring bounce (f32) against JAX's; collisions happened."""
    rng = np.random.default_rng(42)
    n = 32
    pos, vel = rng.normal(size=(n, 3)) * 0.8, rng.normal(size=(n, 3)) * 0.3
    mass, radius = rng.uniform(0.5, 1.5, n) / n, np.full(n, 0.15)
    jcfg = jot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="bounce", restitution=0.8)
    js = jot.init_forces(j_make_state(pos, vel, mass, radius, precision="f32"), jcfg)
    jmesh = j_make_mesh()
    jstep = jsh.make_sharded_step(jcfg, jmesh, js, axis="body")
    mesh = _mesh(8)
    step = tot.make_sharded_step(_tcfg(jcfg), mesh, _port_state(js))
    jo, to = jsh.shard_state(jmesh, js), tot.shard_state(mesh, _port_state(js))
    free = tot.make_sharded_step(_tcfg(jcfg).replace(collisions="none"), mesh,
                                 _port_state(js))
    fo = tot.shard_state(mesh, _port_state(js))
    for _ in range(3):
        jo, to, fo = jstep(jo), step(to), free(fo)
    tf = tot.gather_state(mesh, to)
    _assert_states(tf, jo, dict(rtol=3e-5, atol=3e-6), ("pos", "vel"))
    assert not np.allclose(tf.vel.numpy(), tot.gather_state(mesh, fo).vel.numpy())


def test_sharded_bounce_skip_is_bit_equal():
    """JAX ``test_parallel.py:725``: nothing can touch, so the bounce step
    is bit-equal to the collision-free step (the count gates the ring)."""
    rng = np.random.default_rng(42)
    n = 32
    pos = np.stack(np.meshgrid(*[np.arange(4)] * 3), -1).reshape(-1, 3)[:n] * 10.0
    vel = rng.normal(size=(n, 3)) * 1e-3
    st = tot.make_state(pos, vel, np.ones(n) / n, np.full(n, 1e-3), precision="ds32",
                        device="cpu")
    cfg = tot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="bounce", restitution=0.5)
    st = tot.init_forces(st, cfg)
    mesh = _mesh(8)
    sb = tot.make_sharded_step(cfg, mesh, st)
    sn = tot.make_sharded_step(cfg.replace(collisions="none"), mesh, st)
    b = n_ = tot.shard_state(mesh, st)
    for _ in range(3):
        b, n_ = sb(b), sn(n_)
    gb, gn = tot.gather_state(mesh, b), tot.gather_state(mesh, n_)
    for f in ("pos", "pos_lo", "vel", "vel_lo", "acc"):
        assert torch.equal(getattr(gb, f), getattr(gn, f)), f


def _planted(seed=42, resolve=False):
    """JAX ``test_parallel.py:69, 803``'s scene: 64 bodies, two planted
    cross-shard pairs (8 bodies a shard); for resolve one extreme mass
    ratio (absorption) and one comparable pair (a roll)."""
    rng = np.random.default_rng(seed)
    n = 64
    pos = rng.normal(size=(n, 3)) * 5.0
    vel = rng.normal(size=(n, 3)) * 0.01
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 1e-3)
    pos[9] = pos[0] + 5e-4
    pos[63] = pos[17] - 5e-4
    if resolve:
        mass[9] = mass[0] * 40.0
    return pos, vel, mass, radius


@pytest.mark.parametrize("mode", ["merge", "resolve"])
def test_sharded_merge_and_resolve_match_jax(mode, monkeypatch):
    """Two steps: the contact step (gather, the global merge or resolve
    with JAX's draws handed to the port, slice) and a contact-free one (the
    skip), against JAX's sharded step; alive and mass equal."""
    pos, vel, mass, radius = _planted(resolve=mode == "resolve")
    jcfg = jot.SimConfig(dt=1e-3, G=1e-4, eps2=1e-4, collisions=mode, frag_seed=7)
    js = jot.init_forces(j_make_state(pos, vel, mass, radius, precision="f32"),
                         jcfg.replace(force_impl="dense"))
    jmesh = j_make_mesh()
    jstep = jsh.make_sharded_step(jcfg, jmesh, js)
    j1 = jstep(jsh.shard_state(jmesh, js))
    j2 = jstep(j1)

    def jax_draws(frag_seed, step, T, B, K, *, dtype, device):
        key = jax.random.fold_in(jax.random.PRNGKey(frag_seed), int(step))
        u = torch.from_numpy(np.array(jax.random.uniform(key, (T, T), dtype=np.float32)))
        return u.to(dtype), None

    monkeypatch.setattr(tcoll, "resolve_draws", jax_draws)
    mesh = _mesh(8)
    step = tot.make_sharded_step(_tcfg(jcfg), mesh, _port_state(js))
    t1 = step(tot.shard_state(mesh, _port_state(js)))
    t2 = step(t1)
    for t, j in ((tot.gather_state(mesh, t1), j1), (tot.gather_state(mesh, t2), j2)):
        alive = np.asarray(j.alive)
        assert not alive.all()
        np.testing.assert_array_equal(t.alive.numpy(), alive)
        _close(t.mass.numpy(), j.mass, dict(rtol=2e-6, atol=0.0), "mass")
        _close(t.pos.numpy()[alive], np.asarray(j.pos)[alive], F32, "pos")
        _close(t.vel.numpy()[alive], np.asarray(j.vel)[alive], F32, "vel")


def test_sharded_merge_resets_the_lo_words():
    """ds32 merge: on a contact step every shard's lo words are reset (the
    gathered merge runs on hi + lo), as on one card; the result equals the
    single-card merge step's."""
    pos, vel, mass, radius = _planted()
    cfg = tot.SimConfig(dt=1e-3, G=1e-4, eps2=1e-4, collisions="merge")
    st = tot.init_forces(tot.make_state(pos, vel, mass, radius, precision="ds32",
                                        device="cpu"), cfg.replace(force_impl="dense"))
    mesh = _mesh(4)
    out = tot.gather_state(mesh, tot.make_sharded_step(cfg, mesh, st)(
        tot.shard_state(mesh, st)))
    ref = tot.rollout(st, cfg.replace(force_impl="dense"), 1)[0]
    assert not out.pos_lo.any() and not out.vel_lo.any()
    np.testing.assert_array_equal(out.alive.numpy(), ref.alive.numpy())
    _close(out.pos.numpy(), ref.pos.numpy(), dict(rtol=1e-6, atol=1e-7))


# --- rollouts, PM, simulate --------------------------------------------------

@pytest.fixture(scope="module")
def jax_rollouts():
    """JAX's sharded rollouts over 8 devices, compiled once: 40 steps
    recorded every 10, and 30 unrecorded."""
    pos, vel, mass = _cluster()
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    js = jot.init_forces(j_make_state(pos, vel, mass, precision="f32"), jcfg)
    jmesh = j_make_mesh()
    rec = jsh.make_sharded_rollout(jcfg, jmesh, js, steps=40, record_every=10, axis="body")(
        jsh.shard_state(jmesh, js))
    unrec = jsh.make_sharded_rollout(jcfg, jmesh, js, steps=30, axis="body")(
        jsh.shard_state(jmesh, js))
    return jcfg, js, rec, unrec


def test_sharded_rollout_recorded_matches_jax(jax_rollouts):
    """JAX ``test_parallel.py:493`` (cut to 40 steps): the final state and
    the global records (pos, energy from psum'd K and the ring's U, angular
    momentum)."""
    jcfg, js, (jf, jt), _ = jax_rollouts
    mesh = _mesh(8)
    roll = tot.make_sharded_rollout(_tcfg(jcfg), mesh, _port_state(js), steps=40,
                                    record_every=10, axis="body")
    shards, tt = roll(tot.shard_state(mesh, _port_state(js)))
    tf = tot.gather_state(mesh, shards)
    assert tt.pos.shape == (4, 64, 3) and tt.alive.shape == (4, 64)
    _assert_states(tf, jf, dict(rtol=5e-5, atol=1e-6), ("pos", "vel"))
    for f, tol in (("pos", dict(rtol=5e-5, atol=1e-6)), ("energy", dict(rtol=1e-6, atol=0)),
                   ("ang_mom", dict(rtol=1e-5, atol=1e-7)), ("time", dict(rtol=1e-6, atol=0))):
        _close(getattr(tt, f).numpy(), getattr(jt, f), tol, f)
    np.testing.assert_array_equal(tt.alive.numpy(), np.asarray(jt.alive))


def test_sharded_rollout_unrecorded_matches_jax(jax_rollouts):
    """JAX ``test_parallel.py:526``."""
    jcfg, js, _, (jf, jnone) = jax_rollouts
    mesh = _mesh(8)
    shards, tnone = tot.make_sharded_rollout(_tcfg(jcfg), mesh, _port_state(js), steps=30)(
        tot.shard_state(mesh, _port_state(js)))
    assert jnone is None and tnone is None
    _assert_states(tot.gather_state(mesh, shards), jf, dict(rtol=2e-5, atol=1e-6),
                   ("pos", "vel"))


@pytest.mark.parametrize("pinned", [False, True])
def test_sharded_pm_matches_jax(pinned):
    """``test_pm.py:91``: a PM step body-sharded over 8 ranks (the cube by
    pmin/pmax, or pinned; one psum of the grid) against JAX's sharded PM
    step, and against the port's own single-rank step."""
    rng = np.random.default_rng(42)
    n = 2048
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    box = (0.0, 0.0, 0.0, 6.0) if pinned else None
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=0.09, force_impl="pm", pm_grid=32, pm_box=box)
    js = jot.init_forces(j_make_state(pos, vel, mass, precision="f32"), jcfg)
    jmesh = j_make_mesh()
    jo = jsh.make_sharded_step(jcfg, jmesh, js)(jsh.shard_state(jmesh, js))
    mesh = _mesh(8)
    tcfg = _tcfg(jcfg)
    to = tot.gather_state(mesh, tot.make_sharded_step(tcfg, mesh, _port_state(js))(
        tot.shard_state(mesh, _port_state(js))))
    tol = dict(rtol=1e-5, atol=1e-7)
    _assert_states(to, jo, tol, ("pos", "vel"))
    single = tot.rollout(_port_state(js), tcfg, 1)[0]
    _assert_states(to, single, tol, ("pos", "vel"))
    # eight partial f32 grids summed against one deposit: acc to f32 sums
    _close(to.acc.numpy(), single.acc.numpy(), F32, "acc")


def test_simulate_mesh_matches_jax():
    """JAX ``test_parallel.py:698``: ``simulate(mesh=...)`` in f64 against
    JAX's, and against the port's single-device run."""
    from orbital_tpu.models.scene import SceneArrays as JScene

    rng = np.random.default_rng(42)
    n = 64
    pos, vel = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n)
    kw = dict(steps=20, dt=1e-3, softening=1e-2, record_every=10, precision="f64")
    jres = jot.simulate(JScene(pos=pos, vel=vel, mass=mass, radius=np.full(n, 1e-3),
                               names=[f"b{i}" for i in range(n)]), mesh=j_make_mesh(),
                        unit_profile=dataclasses.replace(jot.STANDARD, G=1.0), **kw)
    scene = tot.models.scene.SceneArrays(pos=pos, vel=vel, mass=mass,
                                         radius=np.full(n, 1e-3),
                                         names=[f"b{i}" for i in range(n)])
    prof = dataclasses.replace(tot.STANDARD, G=1.0)
    tres = tot.simulate(scene, mesh=_mesh(8), device="cpu", unit_profile=prof, **kw)
    single = tot.simulate(scene, device="cpu", unit_profile=prof, **kw)
    for ref in (jres, single):
        np.testing.assert_allclose(tres.pos, ref.pos, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(tres.energy, ref.energy, rtol=1e-10)
        np.testing.assert_allclose(tres.ang_mom, ref.ang_mom, rtol=1e-9, atol=1e-12)
    assert tres.final_state.n_bodies == n and int(tres.final_state.step) == 20


# --- routing -----------------------------------------------------------------

def test_ring_block_routing():
    """``ring_block_impl="auto"`` takes B3 for shards on CUDA that tile by
    128 with eps2 > 0, float64 ones too (f32 inside, as JAX's rule takes the
    kernel whatever the dtype), and the dense block otherwise (CPU tensors,
    an untileable shard, eps2 = 0); "pallas" with float64 on CUDA takes B3
    (it raised before f64 opened on the card). ``_prepare`` accepts f64
    state with collisions under a CUDA mesh (B3 detect's and the block
    bounce's f64 instances)."""
    from types import SimpleNamespace

    def pos(device, dtype=torch.float32):
        return SimpleNamespace(device=torch.device(device), dtype=dtype)

    cfg = tot.SimConfig(dt=1.0, eps2=1e-4)
    assert tsh._ring_block_impl(cfg, 16384, pos("cuda")) == "pallas"
    assert tsh._ring_block_impl(cfg, 16384, pos("cpu")) == "dense"
    assert tsh._ring_block_impl(cfg, 16380, pos("cuda")) == "dense"
    assert tsh._ring_block_impl(cfg.replace(eps2=0.0), 16384, pos("cuda")) == "dense"
    assert tsh._ring_block_impl(cfg, 16384, pos("cuda", torch.float64)) == "pallas"
    assert tsh._ring_block_impl(cfg.replace(ring_block_impl="dense"), 16384,
                                pos("cuda")) == "dense"
    assert tsh._ring_block_impl(cfg.replace(ring_block_impl="pallas"), 128,
                                pos("cpu")) == "pallas"
    assert tsh._ring_block_impl(cfg.replace(ring_block_impl="pallas"), 16384,
                                pos("cuda", torch.float64)) == "pallas"
    mesh = SimpleNamespace(shape={"body": 4}, device=torch.device("cuda"))
    state = SimpleNamespace(n_bodies=4 * 16384, dtype=torch.float64,
                            pos=pos("cuda", torch.float64))
    for mode in ("bounce", "merge", "resolve"):
        got, mesh_solver = tsh._prepare(cfg.replace(collisions=mode), mesh, state, None)
        assert got.collisions == mode and got.force_impl == "ring" and not mesh_solver


def test_ring_rounds_launch_the_block_kernels(monkeypatch):
    """On the B3 route each rank's ring calls B3 (collision-free
    evaluations) or B3 detect (the closing evaluation with collisions) once
    a round and the block bounce once a round: P^2 calls an evaluation over
    the mesh, with the visiting shard's global offset, and nothing else; the
    bounce's first round of each rank writes its sums and the P - 1 others
    add into them (``out=``)."""
    calls = {"B3": 0, "B3D": [], "BB": []}

    def b3(*a, **k):
        calls["B3"] += 1
        return cuda_forces.block_acc_plain(*a, **k)

    def b3d(pos_i, r_i, a_i, i_off, pos_j, m_j, r_j, a_j, j_off, **k):
        calls["B3D"].append((i_off, j_off))
        return cuda_forces.block_acc_detect_plain(pos_i, r_i, a_i, i_off, pos_j, m_j, r_j, a_j,
                                                  j_off, **k)

    def bb(*a, out=None, checked=False, **k):
        calls["BB"].append(out is not None)
        return cuda_collisions.bounce_block_plain(*a, out=out, **k)

    for name, fn in (("block_acc_cuda", b3), ("block_acc_detect_cuda", b3d)):
        monkeypatch.setattr(cuda_forces, name, fn)
    monkeypatch.setattr(cuda_collisions, "bounce_block_cuda", bb)
    pos, vel, mass = _cluster(512, seed=9)
    st = tot.make_state(pos, vel, mass, np.full(512, 0.05), precision="f32", device="cpu")
    cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, ring_block_impl="pallas",
                        collisions="bounce")
    st = tot.init_forces(st, cfg)
    mesh = _mesh(4)
    out = tot.make_sharded_step(cfg, mesh, st)(tot.shard_state(mesh, st))
    assert calls["B3"] == 0 and len(calls["BB"]) == 16 and len(calls["B3D"]) == 16
    assert calls["BB"].count(False) == 4  # one write a rank, in the baton's order
    assert sorted(calls["B3D"]) == sorted((128 * i, 128 * j) for i in range(4)
                                          for j in range(4))
    tot.make_sharded_step(cfg.replace(collisions="none"), mesh, st)(out)
    assert calls["B3"] == 16 and len(calls["BB"]) == 16


# --- refusals ----------------------------------------------------------------

def test_sharded_refusals():
    pos, vel, mass = _cluster(60)
    st = tot.make_state(pos, vel, mass, precision="f32", device="cpu")
    cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    with pytest.raises(ValueError, match="must divide across 8 shards"):
        tot.make_sharded_step(cfg, _mesh(8), st)
    with pytest.raises(ValueError, match="must divide across 8 shards"):
        tot.shard_state(_mesh(8), st)
    st = tot.make_state(*_cluster(64), precision="f32", device="cpu")
    with pytest.raises(ValueError, match="ring_block_impl='pallas' needs eps2 > 0"):
        tot.make_sharded_step(cfg.replace(ring_block_impl="pallas"), _mesh(2), st)
    with pytest.raises(ValueError, match="ring_block_impl='pallas' needs eps2 > 0"):
        tot.make_sharded_step(cfg.replace(ring_block_impl="pallas", eps2=0.0), _mesh(1),
                              tot.make_state(*_cluster(128), precision="f32", device="cpu"))
    # P3M's ring, the sharded tree, the sharded RESPA and the (ensemble x
    # body) step are ported (A.15b): they build; Hermite under a mesh still
    # raises, for want of a JAX reference
    for kw in (dict(force_impl="p3m"), dict(force_impl="tree")):
        assert callable(tot.make_sharded_step(cfg.replace(**kw), _mesh(2), st))
    with pytest.raises(NotImplementedError, match="accel_jerk_fn"):
        tot.make_sharded_step(cfg.replace(integrator="hermite"), _mesh(2), st)
    rcfg = cfg.replace(integrator="respa", respa_rc=0.1, respa_cell=0.2, respa_chunk=8,
                       respa_rj=16, respa_max_chunks=16, respa_w_blk=4, respa_m=8)
    assert callable(tsh.make_sharded_respa_rollout(rcfg, _mesh(2), st, 8))
    batched = _stack([st, st])
    step, place = tsh.make_sharded_ensemble_step(
        cfg, tot.make_mesh(shape=(2, 2), axis_names=("ensemble", "body"), devices="cpu"),
        batched)
    assert callable(step) and len(place(batched)) == 4
    scene = tot.models.scene.SceneArrays(pos=pos[:60], vel=vel[:60], mass=mass[:60],
                                         radius=np.zeros(60), names=["b"] * 60)
    with pytest.raises(ValueError, match="must divide across the mesh's 8 'body' shards"):
        tot.simulate(scene, steps=2, dt=1e-3, softening=1e-2, device="cpu", mesh=_mesh(8))
    for kw in (dict(force_impl="p3m", pm_grid=16), dict(force_impl="tree", tree_levels=3),
               dict(integrator="respa")):
        res = tot.simulate(scene, steps=8, dt=1e-3, softening=1e-2, device="cpu",
                           mesh=_mesh(2), **kw)
        assert res.final_state.n_bodies == 60 and np.isfinite(res.pos).all()
    with pytest.raises(NotImplementedError, match="accel_jerk_fn"):
        tot.simulate(scene, steps=8, dt=1e-3, softening=1e-2, device="cpu", mesh=_mesh(2),
                     integrator="hermite")


def test_gloo_processes_match_the_one_card_mesh(tmp_path):
    """Two gloo processes (``torch_dist_worker.py``) against the one-card
    mesh at 2 ranks on the same steps: merge (a gather) and bounce steps on
    B3's and B3 detect's plain versions, and a recorded ds32 rollout (the
    records gathered), every field bit-equal."""
    sys.path.insert(0, str(HERE))
    import torch_dist_worker as worker

    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_dist_worker.py"), str(store),
                               str(r), str(tmp_path)], stdout=subprocess.PIPE,
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
    ref = worker.run(_mesh(2))
    assert set(got.files) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not ref["merge_alive"].all()
