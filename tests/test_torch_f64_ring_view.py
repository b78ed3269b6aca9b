"""The cast views that the f64 ring ships with its shards (B3 detect's and the
block bounce's f64 instances stage a shard's rows from them in every round
after the first; ``csrc/nbody_forces.cu``, ``csrc/collisions.cu``).

A view is the f32 data those kernels used to build in every block that staged
a row: each row cast as ``utils.kernels.in_f32`` casts it, the row's radius
or NaN where it cannot touch (B3 detect: not alive; the bounce: not alive or
mass <= 0, decided in float64), and each 128-row tile's largest radius and
largest |cast coordinate| over its live rows. Here the plain views
(``cuda_forces.detect_view_plain``, ``cuda_collisions.bounce_view_plain``)
are held bit for bit to a numpy mirror of the kernels' staging, on dead rows,
a live mass below 2^-150, sentinels at +-1e30 and past 2^100, an alive row of
mass 0, a NaN coordinate and a ragged last tile; the f32 prefilter, evaluated
at the view's tile-wide radius and scale, keeps every pair that the double
tests keep (the exact-rational bound of ``test_torch_f64_ring.py``'s
prefilter test, on its four scenes); and the ring on the kernel route (the
CUDA route faked, the wrappers on their CPU paths) asks each shard's first
round to write its view and hands every later round the rank's and the
visitor's, with the tables they were made from, while the step equals the
dense route's. The kernels themselves run on the card (``chip_smoke.py``
phase 69 holds each view to its plain version bit for bit).

Tolerances: the views bit-equal to the mirror (NaN where it has NaN); the
step against the dense route as ``test_torch_f64_ring.py``'s routing test
(the forces f32 inside: rtol 2e-5, atol 1e-6 on the velocities).
"""
import os
import threading

import numpy as np
import pytest
import torch

import orbital_tpu_torch as tot
from orbital_tpu_torch.ops import cuda_collisions, cuda_forces
from orbital_tpu_torch.parallel import sharded
from test_torch_f64_ring import (_cast, _close, _dense_bounce_scene, _fma32,
                                 _prefilter_scene, _reach2)

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TILE = 128


def _scene(n, seed=5):
    """f64 rows with a third dead, a live mass below 2^-150, live sentinels at
    +-1e30 and +-3e30 (past 2^100), an alive row of mass 0 and a live row with
    a NaN x."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = rng.uniform(1e-3, 4e-3, n)
    alive = rng.uniform(size=n) >= 1 / 3
    live = np.flatnonzero(alive)
    mass[live[0]] = 5e-46
    pos[live[1:5], 0] = (1e30, -1e30, 3e30, -3e30)
    mass[live[5]] = 0.0
    pos[live[6], 0] = np.nan
    return pos, mass, radius, alive


def _mirror_tiles(rad, scale, keep):
    """Each tile's (largest rad, largest scale) as the kernels take them:
    fmaxf from 0 over the staged rows (NaN skipped), scale over ``keep``."""
    out = []
    for t in range(0, len(rad), TILE):
        r = np.fmax.reduce(rad[t:t + TILE], initial=np.float32(0))
        k = keep[t:t + TILE]
        a = np.fmax.reduce(scale[t:t + TILE][k], initial=np.float32(0))
        out += [r, a]
    return np.asarray(out, dtype=np.float32)


def _scale(geo):
    """The kernels' coord_scale: fmaxf(|x|, fmaxf(|y|, |z|)), NaN skipped."""
    a = np.abs(geo[:, :3])
    return np.fmax(a[:, 0], np.fmax(a[:, 1], a[:, 2]))


def _same(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    nan = np.isnan(ref)
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), ref[~nan].view(np.int32))


@pytest.mark.parametrize("n", [384, 300])
def test_detect_view_plain_matches_its_mirror(n):
    """B3 detect f64's view: geo (x, y, z, m) cast, m the shipped mass times
    alive; rad cast or NaN where dead; each tile's largest rad (every staged
    row, NaN skipped) and largest |coordinate| of an alive row."""
    pos, mass, radius, alive = _scene(n)
    m_eff = mass * alive
    view = cuda_forces.detect_view_plain(*(torch.from_numpy(x) for x in
                                           (pos, m_eff, radius, alive)))
    assert view.dtype == torch.float32 and view.numel() == cuda_forces.detect_view_size(n)
    geo = np.concatenate([_cast(pos), _cast(m_eff)[:, None]], axis=1)
    rad = np.where(alive, _cast(radius), np.float32(np.nan)).astype(np.float32)
    tiles = _mirror_tiles(rad, _scale(geo), alive)
    _same(view, np.concatenate([geo.ravel(), rad, tiles]))
    v = view.numpy()
    assert v[4 * np.flatnonzero(alive)[0] + 3] == 0.0  # a live mass below 2^-150
    assert np.max(v[5 * n + 1::2]) == np.float32(2.0 ** 100)  # the clamped sentinels


@pytest.mark.parametrize("n", [384, 300])
def test_bounce_view_plain_matches_its_mirror(n):
    """The block bounce f64's view: (x, y, z, R) cast, R NaN unless alive and
    mass > 0 in float64 (the mass below 2^-150 is live, the alive row of mass
    0 is not); each tile's largest R and |coordinate| over the rows whose R
    is not NaN, a ragged last tile cut at n."""
    pos, mass, radius, alive = _scene(n)
    view = cuda_collisions.bounce_view_plain(*(torch.from_numpy(x) for x in
                                               (pos, mass, radius, alive)))
    assert view.dtype == torch.float32 and view.numel() == cuda_collisions.bounce_view_size(n)
    live = alive & (mass > 0.0)
    geo = np.concatenate([_cast(pos), np.where(live, _cast(radius), np.nan)[:, None]],
                         axis=1).astype(np.float32)
    tiles = _mirror_tiles(geo[:, 3], _scale(geo), ~np.isnan(geo[:, 3]))
    _same(view, np.concatenate([geo.ravel(), tiles]))
    first = np.flatnonzero(alive)
    R = view.numpy()[:4 * n].reshape(n, 4)[:, 3]
    assert not np.isnan(R[first[0]]) and np.isnan(R[first[5]])


@pytest.mark.parametrize("kind", ["bench", "rich", "si", "far"])
def test_prefilter_at_the_views_tile_bounds_keeps_every_kept_pair(kind):
    """The f32 prefilter as the view forms run it: a row's f32 r^2 against
    reach2 at (its cast radius + the j tile's largest radius of the view,
    its |cast coordinate| + the tile's largest of the view), B3 detect's at
    c = 1.00002 and the bounce's at c = 1.000001, with reach2 in f64 without
    its upward rounding (at or below the kernels' f32 value). It keeps every
    pair that the double tests keep: B3 detect's count and the bounce's
    touching test, a quarter of the bodies dead."""
    pos, radius = _prefilter_scene(kind)
    n = len(pos)
    rng = np.random.default_rng(3)
    live = rng.uniform(size=n) >= 0.25
    mass = rng.uniform(0.5, 1.5, n)
    d = pos[:, None, :] - pos[None, :, :]
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    both = live[:, None] & live[None, :] & ~np.eye(n, dtype=bool)
    rs = radius[:, None] + radius[None, :]
    counted = both & (r2 <= (rs * 1.00001) ** 2)
    touching = both & (r2 <= rs * rs) & (r2 > 0)
    assert touching.sum() >= 10
    c32 = _cast(pos)
    dd = c32[None, :, :] - c32[:, None, :]
    dx, dy, dz = dd[..., 0], dd[..., 1], dd[..., 2]
    r2_b3 = _fma32(dz, dz, _fma32(dx, dx, dy * dy))
    r2_bb = _fma32(dz, dz, _fma32(dy, dy, dx * dx))
    t = [torch.from_numpy(x) for x in (pos, mass, radius, live)]
    dview = cuda_forces.detect_view_plain(t[0], t[1] * t[3], t[2], t[3]).numpy()
    bview = cuda_collisions.bounce_view_plain(*t).numpy()
    tile_of = np.arange(n) // TILE
    for keep_ref, view, rows, c, r2_f in (
            (counted, dview, 5 * n, 1.00002, r2_b3), (touching, bview, 4 * n, 1.000001, r2_bb)):
        maxima = view[rows:].reshape(-1, 2).astype(np.float64)
        rad_i = _cast(radius).astype(np.float64)
        scale_i = np.abs(c32).max(1).astype(np.float64)
        rsum = rad_i[:, None] + maxima[tile_of, 0][None, :]
        sc = scale_i[:, None] + maxima[tile_of, 1][None, :]
        keep = r2_f <= _reach2(rsum, sc, np.float32(c))
        assert not (keep_ref & ~keep).any(), "the prefilter at the view's bounds drops a pair"


def _ring_calls(monkeypatch, ships: bool):
    """The f64 bounce step on the kernel route over 4 ranks with the two
    wrappers recording each call (its rank, its tables and view arguments)
    and running their CPU paths, and with ``_ships_views`` faked True for
    float64 shards when ``ships``; returns the calls, the step's state and
    the dense route's, and the state it started from."""
    calls = {"B3D": [], "BB": []}
    b3d_real, bb_real = cuda_forces.block_acc_detect_cuda, cuda_collisions.bounce_block_cuda

    def rank():
        return int(threading.current_thread().name.rsplit("-", 1)[-1])

    def b3d(pos_i, r_i, a_i, i_off, pos_j, m_j, r_j, a_j, j_off, **k):
        out = b3d_real(pos_i, r_i, a_i, i_off, pos_j, m_j, r_j, a_j, j_off, **k)
        calls["B3D"].append(dict(rank=rank(), i=(pos_i, i_off), j=(pos_j, m_j, r_j, a_j, j_off),
                                 view_out=k.get("view_out"), views=k.get("views")))
        return out

    def bb(*a, **k):
        out = bb_real(*a, **k)
        calls["BB"].append(dict(rank=rank(), i=a[:5], j=a[5:10], view_out=k.get("view_out"),
                                views=k.get("views")))
        return out

    monkeypatch.setattr(cuda_forces, "block_acc_detect_cuda", b3d)
    monkeypatch.setattr(cuda_collisions, "bounce_block_cuda", bb)
    if ships:
        monkeypatch.setattr(sharded, "_ships_views", lambda pos: pos.dtype == torch.float64)
    pos, vel, mass, radius = _dense_bounce_scene(n=512, seed=9)
    radius[:] = 0.05
    mass[7] = 0.0  # an alive row of mass 0: live for the count, not for the bounce
    cfg = tot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, ring_block_impl="pallas",
                        collisions="bounce", restitution=0.8)
    st = tot.init_forces(tot.make_state(pos, vel, mass, radius, precision="f64",
                                        device="cpu"), cfg.replace(force_impl="dense"))
    mesh = tot.make_mesh(shape=(4,), devices="cpu")
    out = tot.gather_state(mesh, tot.make_sharded_step(cfg, mesh, st)(
        tot.shard_state(mesh, st)))
    first = {k: list(v) for k, v in calls.items()}  # the dense step's stay out
    dense = tot.make_sharded_step(cfg.replace(ring_block_impl="dense"), mesh, st)
    ref = tot.gather_state(mesh, dense(tot.shard_state(mesh, st)))
    return first, out, ref, st


def test_f64_ring_ships_each_shards_view_to_its_later_rounds(monkeypatch):
    """With the CUDA route faked, an f64 bounce step calls each wrapper P^2
    times; each rank's first call of each ring asks its diagonal round (i
    and j its own shard, equal offsets) to write its view, and every later
    round gets the rank's view and the visitor's, each the plain view of the
    tables it comes with (the visitor's those of the shard at its j_off);
    the step equals the dense route's."""
    calls, out, ref, st = _ring_calls(monkeypatch, ships=True)
    P = 4
    assert len(calls["B3D"]) == P * P and len(calls["BB"]) == P * P
    own_rows = {c["i"][1]: c["i"][0] for c in calls["B3D"]}
    for kind, plain in (("B3D", cuda_forces.detect_view_plain),
                        ("BB", cuda_collisions.bounce_view_plain)):
        for r in range(P):
            mine = [c for c in calls[kind] if c["rank"] == r]
            assert len(mine) == P
            first, later = mine[0], mine[1:]
            assert first["view_out"] is not None and first["views"] is None
            if kind == "B3D":
                assert first["i"][1] == first["j"][4] == r * 128
                own_view = plain(*first["j"][:4])
            else:
                assert first["i"][0] is first["j"][0]
                own_view = plain(first["j"][0], *first["j"][2:])
            _same(first["view_out"], own_view)
            seen = set()
            for c in later:
                assert c["view_out"] is None and len(c["views"]) == 2
                assert c["views"][0] is first["view_out"]
                _same(c["views"][1], plain(*c["j"][:4]) if kind == "B3D"
                      else plain(c["j"][0], *c["j"][2:]))
                if kind == "B3D":
                    j_off = c["j"][4]
                    seen.add(j_off)
                    assert torch.equal(c["j"][0], own_rows[j_off])
            if kind == "B3D":
                assert seen == {((r - k) % P) * 128 for k in range(1, P)}
    _close(out.vel.numpy(), ref.vel.numpy(), dict(rtol=2e-5, atol=1e-6), "vel")
    _close(out.pos.numpy(), ref.pos.numpy(), dict(rtol=2e-5, atol=1e-6), "pos")
    assert np.abs(out.vel.numpy() - st.vel.numpy()).max() > 0.1  # bounces happened


def test_f64_ring_on_cpu_shards_ships_no_view(monkeypatch):
    """CPU shards (no faked route) take no view: every call of both wrappers
    comes without view arguments, as before the views."""
    calls = _ring_calls(monkeypatch, ships=False)[0]
    assert len(calls["B3D"]) == 16 and len(calls["BB"]) == 16
    assert all(c["view_out"] is None and c["views"] is None
               for c in calls["B3D"] + calls["BB"])


@pytest.mark.parametrize("wrapper", ["B3D", "BB"])
def test_view_arguments_are_checked(wrapper):
    """A view on float32 tables, one of the wrong size or dtype, both
    arguments at once, or views that are not a pair raise; nothing falls
    back."""
    n = 128
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.normal(size=(n, 3)))
    vel = torch.from_numpy(rng.normal(size=(n, 3)))
    mass = torch.full((n,), 1.0 / n, dtype=torch.float64)
    radius = torch.full((n,), 1e-3, dtype=torch.float64)
    alive = torch.ones(n, dtype=torch.bool)
    if wrapper == "B3D":
        size = cuda_forces.detect_view_size(n)

        def call(p, m, r, **k):
            return cuda_forces.block_acc_detect_cuda(p, r, alive, 0, p, m, r, alive, 0,
                                                     G=1.0, eps2=1e-4, **k)
        good = cuda_forces.detect_view_plain(pos, mass, radius, alive)
    else:
        size = cuda_collisions.bounce_view_size(n)

        def call(p, m, r, **k):
            side = (p, vel.to(p.dtype), m, r, alive)
            return cuda_collisions.bounce_block_cuda(*side, *side, **k)
        good = cuda_collisions.bounce_view_plain(pos, mass, radius, alive)
    assert good.numel() == size
    call(pos, mass, radius, views=(good, good))  # a well-formed read
    out = torch.empty(size)
    call(pos, mass, radius, view_out=out)
    _same(out, good)
    with pytest.raises(TypeError):
        call(pos.float(), mass.float(), radius.float(), view_out=torch.empty(size))
    with pytest.raises(ValueError):
        call(pos, mass, radius, view_out=torch.empty(size + 1))
    with pytest.raises(ValueError):
        call(pos, mass, radius, view_out=torch.empty(size, dtype=torch.float64))
    with pytest.raises(ValueError):
        call(pos, mass, radius, view_out=out, views=(good, good))
    with pytest.raises(ValueError):
        call(pos, mass, radius, views=(good,))
