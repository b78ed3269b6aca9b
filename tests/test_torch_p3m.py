"""The P3M solver of the PyTorch port (``force_impl="p3m"``) against the JAX
package's: the short-range factors, the cell table, whole evaluations with
their overflow, the probes, KDK rollouts, simulate()'s capacity and the
routing of the short-range sum to its CUDA wrapper.

Inputs come from a numpy seed and go through both packages; JAX runs on the
CPU as its own tests run it (tests/conftest.py turns x64 on). Sizes: the
JAX package's uniform box (tests/test_p3m.py: N = 2,048 in [-1, 1]^3, grid
64). Tolerances, measured on this comparison and stated with why:
  * the cell table (order, rank, keep, table, overflow), the probes: equal.
  * ``_short_factors``: |dg| <= 1e-6 |g| + 8 ulp(erf(a r)) / r^3 and
    |dK| <= 1e-6 |K| + 8 ulp(1) / r. Both packages form g as 1/s^3 minus the
    long-range part (erf(a r) - 2 a r e^{-a^2 r^2} / sqrt(pi)) / r^3, whose
    two terms cancel for r << sigma, so an ulp of XLA's or torch's erf
    becomes ulp(erf) / r^3 in g (measured up to 5.3 such ulps, 1e-4 of |g|
    at r^2 = 1e-8); K cancels 1/s against erf(a r)/r for r >> sigma. At
    r = 0 both give the same branch values.
  * evaluations: max |da| <= 2e-5 max |a| (measured 6.6e-7 to 1.8e-6: f32
    FFTs and sums in other orders, under x64 JAX's mesh in f64 as in
    tests/test_torch_pm.py), U to rel 1e-6 (measured 1.9e-7).
  * KDK rollouts over 10 steps at dt = 1e-3: atol 5e-7 on f32 state of
    magnitude up to ~1 (a few ulps); energies rel 1e-5.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine.state import far_positions
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu.ops import p3m as jp3m
from orbital_tpu.ops import pm as jpm
from orbital_tpu.ops import tree as jt
from orbital_tpu_torch.models.scene import SceneArrays
from orbital_tpu_torch.ops import cuda_p3m
from orbital_tpu_torch.ops import p3m as tp3m
from orbital_tpu_torch.ops import pm as tpm

ACC_RTOL, U_RTOL = 2e-5, 1e-6
BOX = (np.array([0.1, -0.1, 0.0], np.float32), np.float32(1.5))
ULP1 = 2.0 ** -23


def _uniform(n=2048, seed=4, dead=False):
    """The JAX package's uniform box; with ``dead`` every third body dead
    and parked far."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    alive = None
    if dead:
        alive = np.ones(n, bool)
        alive[::3] = False
        pos[~alive] = far_positions(int((~alive).sum()), 1.0, np.float32)
    return pos, mass, alive


def _t(*xs):
    return tuple(None if x is None else torch.as_tensor(x) for x in xs)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("sigma,eps2", [(0.05, 1e-4), (0.05, 1e-6), (0.3, 1e-4),
                                        (0.3, 1e-6)])
def test_short_factors_match_jax(sigma, eps2):
    r2 = np.concatenate([[0.0], np.geomspace(1e-8, 10.0, 400)]).astype(np.float32)
    jg, jk = (np.asarray(x, np.float64) for x in jp3m._short_factors(jnp.asarray(r2), sigma,
                                                                     eps2))
    tg, tk = (x.numpy().astype(np.float64)
              for x in tp3m._short_factors(torch.as_tensor(r2), sigma, eps2))
    r = np.sqrt(np.maximum(r2.astype(np.float64), 1e-300))
    erf = np.array([math.erf(x / (2.0 * sigma)) for x in r])
    g_noise = np.where(r2 > 0, 8 * ULP1 * erf / r ** 3, 0.0)
    k_noise = np.where(r2 > 0, 8 * ULP1 / r, 0.0)
    assert np.all(np.abs(tg - jg) <= 1e-6 * np.abs(jg) + g_noise)
    assert np.all(np.abs(tk - jk) <= 1e-6 * np.abs(jk) + k_noise)
    assert tg[0] == jg[0] == 0.0 and tk[0] == pytest.approx(
        eps2 ** -0.5 - 1.0 / (sigma * math.sqrt(math.pi)), rel=1e-6)
    # a 0-dim f32 tensor sigma (the device form of p3m_acc_potential), whose
    # alpha rounds in f32 as JAX's traced one does, within the same bounds
    sg, sk = (x.numpy().astype(np.float64)
              for x in tp3m._short_factors(torch.as_tensor(r2), torch.tensor(sigma), eps2))
    assert np.all(np.abs(sg - jg) <= 1e-6 * np.abs(jg) + g_noise)
    assert np.all(np.abs(sk - jk) <= 1e-6 * np.abs(jk) + k_noise)


def _jax_table(pos, alive, center, half, gc, capacity):
    """orbital_tpu/ops/p3m.py:146-171 as the JAX module runs them."""
    n, gc3 = pos.shape[0], gc ** 3
    origin = center - half
    s_cell = 2.0 * half / gc
    cc = jnp.clip(jnp.floor((pos - origin) / s_cell).astype(jnp.int32), 0, gc - 1)
    cell_id = (cc[:, 0] * gc + cc[:, 1]) * gc + cc[:, 2]
    cell_id = jnp.where(alive, cell_id, gc3)
    order = jnp.argsort(cell_id)
    sc = cell_id[order]
    first, _ = jt._segment_bounds(sc)
    rank = jnp.arange(n, dtype=jnp.int32) - first
    keep = (rank < capacity) & (sc < gc3)
    overflow = jnp.sum((rank >= capacity) & (sc < gc3), dtype=jnp.int32)
    s_row = jnp.where(keep, sc, gc3)
    r_col = jnp.clip(rank, 0, capacity - 1)
    table = jnp.full((gc3 + 1, capacity), n, jnp.int32).at[s_row, r_col].set(
        jnp.where(keep, order.astype(jnp.int32), n))
    cell_pos = jnp.broadcast_to(jnp.full((3,), 1e30, jnp.float32), (gc3 + 1, capacity, 3))
    cell_pos = cell_pos.at[s_row, r_col].set(jnp.where(keep[:, None], pos[order], 1e30),
                                             mode="drop")
    return dict(order=order, rank=rank, keep=keep, overflow=overflow, table=table,
                cell_pos=cell_pos)


@pytest.mark.parametrize("capacity,pinned,dead", [(64, False, False), (2, False, True),
                                                  (8, True, True)])
def test_cell_table_matches_jax(capacity, pinned, dead):
    pos, mass, alive = _uniform(dead=dead)
    alive = np.ones(len(mass), bool) if alive is None else alive
    g, gc = 64, tp3m._cell_grid(64, 1.5, 4.5)
    if pinned:
        jc, jh = BOX
        tc, th = _t(*BOX)
    else:
        jc, jh = jpm._bounding_cube(jnp.asarray(pos), jnp.asarray(alive, jnp.float32), g, None)
        tc, th = tpm._bounding_cube(*_t(pos), torch.as_tensor(alive).float(), g)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert float(th) == float(jh)
    ref = _jax_table(jnp.asarray(pos), jnp.asarray(alive), jc, jh, gc, capacity)
    tab = tp3m.p3m_cell_table(*_t(pos), torch.as_tensor(mass), torch.as_tensor(alive), tc, th,
                              gc=gc, capacity=capacity)
    for k in ("order", "rank", "keep", "overflow", "table"):
        np.testing.assert_array_equal(tab[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(tab["cell_pos"].numpy(), np.asarray(ref["cell_pos"]))
    live = tab["table"][:-1] != len(mass)
    assert tab["count"].tolist() == live.sum(1).tolist()
    assert bool((live[:, 1:] <= live[:, :-1]).all())  # each cell's kept bodies a prefix
    assert (int(tab["overflow"]) > 0) == (capacity < 64)


@pytest.mark.parametrize("eps2,capacity,pinned,dead", [
    (1e-4, 64, False, False), (1e-6, 64, False, False), (1e-4, 2, False, False),
    (1e-4, 64, True, True)])
def test_p3m_matches_jax(eps2, capacity, pinned, dead):
    pos, mass, alive = _uniform(dead=dead)
    kw = dict(G_grav=1.0, eps2=eps2, grid=64, capacity=capacity)
    ja, jU, jov = jp3m.p3m_acc_potential(jnp.asarray(pos), jnp.asarray(mass),
                                         None if alive is None else jnp.asarray(alive),
                                         box=BOX if pinned else None, **kw)
    ta, tU, tov = tp3m.p3m_acc_potential(*_t(pos, mass, alive),
                                         box=_t(*BOX) if pinned else None, **kw)
    assert tov.dtype == torch.int32 and tov.ndim == 0 and int(tov) == int(jov)
    assert (int(tov) > 0) == (capacity == 2)
    assert _rel(ta.numpy(), ja) <= ACC_RTOL
    assert float(tU) == pytest.approx(float(jU), rel=U_RTOL)
    if dead:
        assert not ta[torch.as_tensor(~alive)].any()


def test_short_range_sum_blocking_and_f64():
    """The plain sum does not depend on its cell blocking, the CUDA wrapper's
    CPU path is the plain version, and the f32 sum sits near the same sum
    in f64 (what chip_smoke.py holds the kernel to)."""
    pos, mass, alive = _uniform(1500, 8, dead=True)
    g, gc = 32, tp3m._cell_grid(32, 1.5, 4.5)
    c, half = _t(*BOX)
    tab = tp3m.p3m_cell_table(*_t(pos, mass), torch.as_tensor(alive), c, half, gc=gc,
                              capacity=48)
    sigma = 1.5 * (2.0 * float(half) / g)
    kw = dict(gc=gc, n=len(mass), G=1.0, sigma=sigma, rcut2=(4.5 * sigma) ** 2, eps2=1e-4)
    a, p = tp3m.p3m_short_plain(tab["table"], tab["cell_pos"], tab["cell_m"], **kw)
    a1, p1 = tp3m.p3m_short_plain(tab["table"], tab["cell_pos"], tab["cell_m"], cell_block=1,
                                  **kw)
    assert torch.equal(a, a1) and torch.equal(p, p1)
    a2, p2 = cuda_p3m.p3m_short_cuda(tab["table"], tab["cell_pos"], tab["cell_m"],
                                     count=tab["count"], **kw)
    assert torch.equal(a, a2) and torch.equal(p, p2) and cuda_p3m.p3m_short_cuda.launches == 0
    a64, p64 = tp3m.p3m_short_plain(tab["table"], tab["cell_pos"].double(),
                                    tab["cell_m"].double(), **kw)
    assert a64.dtype == torch.float64
    assert _rel(a.numpy(), a64.numpy()) < 1e-5 and _rel(p.numpy(), p64.numpy()) < 1e-5
    kept = torch.zeros(len(mass), dtype=torch.bool)
    kept[tab["order"][tab["keep"]]] = True
    assert bool(a[~kept].eq(0).all()) and bool(p[~kept].eq(0).all()) and bool(p[kept].ne(0).any())


def test_probes_match_jax():
    pos, mass, alive = _uniform(dead=True)
    for box in (None, BOX):
        j = int(jp3m.p3m_max_occupancy(jnp.asarray(pos), jnp.asarray(alive), grid=64,
                                       box=box))
        t = tp3m.p3m_max_occupancy(*_t(pos, alive), grid=64,
                                   box=None if box is None else _t(*box))
        assert t == j > 0
    for cap in (2, 64):
        jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="p3m", pm_grid=64,
                             p3m_capacity=cap, pm_box=(0.1, -0.1, 0.0, 1.5))
        js = jot.make_state(pos, np.zeros_like(pos), mass, precision="f32")
        ts = tot.make_state(pos, np.zeros_like(pos), mass, precision="f32", device="cpu")
        tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
        assert tp3m.p3m_overflow_probe(ts, tcfg) == jp3m.p3m_overflow_probe(js, jcfg)
    with pytest.raises(NotImplementedError, match="A.15"):
        tp3m.p3m_ring_force()
    with pytest.raises(ValueError, match="the P3M solver requires eps2 > 0"):
        tp3m.p3m_acc_potential(*_t(pos, mass), G_grav=1.0, eps2=0.0)


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")


def test_kdk_rollout_matches_jax():
    """10 KDK steps on the P3M force (grid 32, a pinned box) against JAX's
    compiled rollout, both from the port's ``init_forces``."""
    pos, mass, _ = _uniform(1024, 5)
    vel = 0.1 * np.random.default_rng(6).normal(size=(1024, 3))
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="p3m", pm_grid=32,
                         p3m_capacity=96, pm_box=(0.0, 0.0, 0.0, 1.5))
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.make_state(pos, vel, mass, precision="f32")
    ts = tot.init_forces(_port_state(js), tcfg)
    ja, _, jov = jp3m.p3m_acc_potential(js.pos, js.mass, js.alive, G_grav=1.0, eps2=1e-4,
                                        grid=32, capacity=96, box=jcfg.pm_box_arrays())
    assert int(jov) == 0
    assert _rel(ts.acc.numpy(), ja) <= ACC_RTOL
    js = js.replace(acc=jnp.asarray(ts.acc.numpy()), potential=jnp.asarray(ts.potential.numpy()))
    jf, jtr = jot.rollout_jit(js, jcfg, 10, 5)
    tf, ttr = tot.rollout(ts, tcfg, 10, 5)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(ttr, f).numpy(), np.asarray(getattr(jtr, f)),
                                   rtol=0, atol=5e-7, err_msg=f)
    np.testing.assert_allclose(ttr.energy.numpy(), np.asarray(jtr.energy), rtol=1e-5)
    assert int(tf.step) == 10


def _scenes(pos, mass):
    n = len(mass)
    kw = dict(pos=np.asarray(pos, np.float64), vel=np.zeros((n, 3)),
              mass=np.asarray(mass, np.float64), radius=np.zeros(n),
              names=[f"b{i}" for i in range(n)])
    return SceneArrays(**kw), JScene(**kw, uuids=[f"u{i}" for i in range(n)])


def test_simulate_auto_capacity_as_jax():
    """p3m_capacity="auto" probes the initial density as the JAX package
    does (same capacity, same pinned cube, the same trajectory); a string
    other than "auto" and a too-concentrated scene raise."""
    pos, mass, _ = _uniform(1024, 12)
    scene, jscene = _scenes(pos, mass)
    kw = dict(steps=4, dt=1e-3, softening=1e-2, force_impl="p3m", pm_grid=64,
              p3m_capacity="auto", precision="f32", record_every=2)
    jres = jot.simulate(jscene, rescale=jot.Rescale.identity(), **kw)
    res = tot.simulate(scene, device="cpu", rescale=tot.Rescale.identity(), **kw)
    assert res.config.p3m_capacity == jres.config.p3m_capacity >= 32
    assert res.config.pm_box == pytest.approx(jres.config.pm_box, rel=1e-15)
    np.testing.assert_allclose(res.pos, np.asarray(jres.pos), rtol=0, atol=5e-7)
    with pytest.raises(ValueError, match="p3m_capacity must be an int or 'auto'"):
        tot.simulate(scene, device="cpu", **{**kw, "p3m_capacity": "big"})
    clump, _ = _scenes(np.full((5000, 3), 0.25) + 1e-6 * np.arange(5000)[:, None],
                       np.full(5000, 1.0 / 5000))
    with pytest.raises(ValueError, match="too concentrated for P3M"):
        tot.simulate(clump, device="cpu", rescale=tot.Rescale.identity(),
                     pm_box=(0.0, 0.0, 0.0, 10.0), **kw)


def test_short_range_routing(monkeypatch):
    """p3m_acc_potential sums its short range through the CUDA wrapper,
    which takes the plain version for CPU tensors only and raises on other
    devices before any launch."""
    pos, mass, _ = _uniform(256, 2)
    seen = []
    inner = cuda_p3m.p3m_short_cuda
    monkeypatch.setattr(cuda_p3m, "p3m_short_cuda",
                        lambda *a, **k: seen.append(k["gc"]) or inner(*a, **k))
    tp3m.p3m_acc_potential(*_t(pos, mass), G_grav=1.0, eps2=1e-4, grid=32)
    assert seen == [tp3m._cell_grid(32, 1.5, 4.5)] and inner.launches == 0
    t = torch.zeros((9, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        inner(t, torch.zeros((9, 4, 3), device="meta"), torch.zeros((9, 4), device="meta"),
              count=torch.zeros(8, device="meta"), gc=2, n=5, G=1.0, sigma=0.1, rcut2=0.2,
              eps2=1e-4)
