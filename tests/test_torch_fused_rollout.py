"""Fused whole-rollout path of the PyTorch port against the JAX package's
``fused_rollout`` (Pallas interpret mode, N = 256, tiles 64/128), mirroring
tests/test_fused_rollout.py.

On CPU tensors the port runs the kernel's plain version (a loop of the
eager KDK step on plain forces). The JAX kernel carries ds32 compensation
even for f32 state and sums forces in another order, so positions and
velocities are held to atol 1e-6 after 10 steps: the tolerance the JAX
package holds its own fused kernel to against its stepper.
"""
import dataclasses

import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.ops.fused_rollout import fused_rollout as j_fused
from orbital_tpu_torch.ops.fused_rollout import (FUSED_MAX_N, fused_rollout,
                                                 fused_rollout_plain, launch_plan)

ATOL = 1e-6
TILES = dict(tile_i=64, tile_j=128)


@pytest.fixture
def cluster(rng):
    n = 256
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _pair(pos, vel, mass, precision, **kw):
    """The same initial state in both packages (a(t) seeded by JAX)."""
    cfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="dense")
    js = jot.init_forces(jot.make_state(pos, vel, mass, precision=precision, **kw), cfg)
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    ts = tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")
    return js, ts, cfg, tot.SimConfig(**dataclasses.asdict(cfg))


def _full(s, f):
    a = np.asarray(getattr(s, f), np.float64)
    lo = getattr(s, f + "_lo")
    return a + np.asarray(lo, np.float64) if lo is not None else a


@pytest.mark.parametrize("precision", ["f32", "ds32"])
def test_plain_matches_jax_fused(cluster, precision):
    js, ts, jcfg, tcfg = _pair(*cluster, precision)
    ref = j_fused(js, jcfg, 10, **TILES)
    before = fused_rollout.launches
    out = fused_rollout(ts, tcfg, 10)
    assert fused_rollout.launches == before  # CPU tensors: plain version
    for f in ("pos", "vel"):
        np.testing.assert_allclose(_full(out, f), _full(ref, f), rtol=0, atol=ATOL)
    assert out.is_ds == (precision == "ds32")
    assert float(out.time) == pytest.approx(float(ref.time))
    assert int(out.step) == int(ref.step) == 10


def test_dynamic_step_count(cluster):
    js, ts, jcfg, tcfg = _pair(*cluster, "f32")
    for steps in (5, 9):
        ref = j_fused(js, jcfg, steps, **TILES)
        out = fused_rollout(ts, tcfg, steps)
        assert int(out.step) == steps
        np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), atol=ATOL)
    assert int(fused_rollout(ts, tcfg, 0).step) == 0


def test_dead_bodies_inert(cluster):
    pos, vel, mass = (a[:200] for a in cluster)
    js, ts, jcfg, tcfg = _pair(pos, vel, mass, "ds32", pad_to=128)
    assert ts.n_bodies == 256 and int(ts.alive.sum()) == 200
    ref = j_fused(js, jcfg, 5, **TILES)
    out = fused_rollout(ts, tcfg, 5)
    alive = ts.alive.numpy()
    np.testing.assert_allclose(_full(out, "pos")[alive], _full(ref, "pos")[alive],
                               atol=ATOL)
    # dead rows feel no force and exert none: parked exactly where they were
    np.testing.assert_array_equal(out.pos.numpy()[~alive], ts.pos.numpy()[~alive])
    np.testing.assert_array_equal(out.vel.numpy()[~alive], 0.0)


def test_plain_version_is_the_stepper_loop(cluster):
    """Seeded from the positions, the plain version is exactly the port's
    own KDK loop (same eager ops), whatever acc the state carried."""
    _, ts, _, tcfg = _pair(*cluster, "ds32")
    ref, _ = tot.rollout(tot.init_forces(ts, tcfg), tcfg, 7, fused="never")
    out = fused_rollout_plain(ts.replace(acc=torch.zeros_like(ts.acc)), tcfg, 7)
    for f in ("pos", "pos_lo", "vel", "vel_lo"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), getattr(ref, f).numpy())
    np.testing.assert_array_equal(out.acc.numpy(), 0.0)  # caches untouched


def test_guards():
    st = tot.make_state(np.zeros((8, 3)), np.zeros((8, 3)), np.ones(8), device="cpu")
    for cfg in (tot.SimConfig(dt=1.0, eps2=0.0),
                tot.SimConfig(dt=1.0, eps2=1.0, collisions="bounce"),
                tot.SimConfig(dt=1.0, eps2=1.0, integrator="rk4")):
        with pytest.raises(ValueError):
            fused_rollout(st, cfg, 1)
    big = tot.make_state(np.zeros((1, 3)), np.zeros((1, 3)), np.ones(1), device="cpu",
                         pad_to=FUSED_MAX_N + 1)
    with pytest.raises(ValueError, match="FUSED_MAX_N"):
        fused_rollout(big, tot.SimConfig(dt=1.0, eps2=1.0), 1)
    meta = st.replace(pos=torch.empty((8, 3), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_rollout(meta, tot.SimConfig(dt=1.0, eps2=1.0), 1)


def test_rollout_routes_to_fused(cluster, monkeypatch):
    """rollout() routes unrecorded eligible rollouts to fused_rollout and
    refreshes the acc/potential caches (eligibility forced: on CPU tensors
    the real gate says no)."""
    from orbital_tpu_torch.engine import rollout as R

    _, ts, _, tcfg = _pair(*cluster, "ds32")
    ref, _ = R.rollout(ts, tcfg, 12, fused="never")
    assert not R._fused_eligible(ts, tcfg)

    routed = {}

    def spy(s, c):
        routed["checked"] = True
        return True

    monkeypatch.setattr(R, "_fused_eligible", spy)
    out, traj = R.rollout(ts, tcfg, 12)
    assert routed.get("checked") and traj is None
    np.testing.assert_allclose(out.pos.numpy(), ref.pos.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.vel.numpy(), ref.vel.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.acc.numpy(), ref.acc.numpy(), atol=1e-5)
    assert float(out.potential) == pytest.approx(float(ref.potential), rel=1e-5)
    assert int(out.step) == 12
    out2, traj2 = R.rollout(ts, tcfg, 12, record_every=6)  # recording: never fused
    assert traj2 is not None and traj2.pos.shape[0] == 2


@pytest.mark.parametrize("change,eligible", [
    ({}, True), ({"force_impl": "pallas"}, True), ({"force_impl": "chunked"}, False),
    ({"eps2": 0.0}, False), ({"collisions": "merge"}, False), ({"n": FUSED_MAX_N + 1}, False),
    ({"dtype": torch.float64}, False), ({"device": "cpu"}, False)])
def test_fused_eligibility_gate(change, eligible):
    """The routing gate of rollout(), on a stand-in state that reports a
    CUDA device (only shapes, dtype and device are read)."""
    from types import SimpleNamespace

    from orbital_tpu_torch.engine import rollout as R

    change = dict(change)
    n = change.pop("n", 4096)
    state = SimpleNamespace(pos=torch.empty((n, 3), device="meta"), n_bodies=n,
                            dtype=change.pop("dtype", torch.float32),
                            device=torch.device(change.pop("device", "cuda")))
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4).replace(**change)
    assert R._fused_eligible(state, cfg) is eligible


@pytest.mark.parametrize("n", [1, 127, 4096, 5000, 32768])
def test_launch_plan_covers_every_pair_once(n):
    """B4's launch plan, walked as csrc/fused_rollout.cu walks it (block b
    takes units b, b + grid, ...; unit u is i tile u % tiles against j split
    u // tiles; warp w sweeps split_len * s + warp_len * w onward, cut at the
    split's end and n): every (i tile, j) pair once, at most the co-resident
    blocks, no empty split, and a critical path within 1.5x of an even share
    of the work (plus a warp's granule), so that the blocks fill the card
    where n allows: 128 of 132 at 4,096 bodies in tiles of 128."""
    for rows, warps in ((128, 8), (64, 4), (256, 16)):
        for resident in (1, 66, 132, 264):
            p = launch_plan(n, rows, warps, resident)
            tiles, splits, grid = p["tiles"], p["splits"], p["grid"]
            assert tiles == -(-n // rows) and p["units"] == tiles * splits
            assert 1 <= grid <= min(resident, p["units"])
            assert (splits - 1) * p["split_len"] < n <= splits * p["split_len"]
            assert p["split_len"] % 32 == 0 and p["warp_len"] % 32 == 0
            assert warps * p["warp_len"] >= p["split_len"]
            cover = np.zeros((tiles, n), np.int64)
            rounds = 0
            for b in range(grid):
                units = range(b, p["units"], grid)
                rounds = max(rounds, len(units))
                for u in units:
                    t, s = u % tiles, u // tiles
                    end = min(n, (s + 1) * p["split_len"])
                    for w in range(warps):
                        a = min(n, s * p["split_len"] + w * p["warp_len"])
                        cover[t, a:min(end, a + p["warp_len"])] += 1
            np.testing.assert_array_equal(cover, 1)
            assert rounds == -(-p["units"] // grid)
            even = tiles * n / (resident * warps)
            assert rounds * p["warp_len"] <= 1.5 * even + 32, (rows, warps, resident, p)
    if n == 4096:
        assert launch_plan(n, 128, 8, 132)["grid"] >= 128
