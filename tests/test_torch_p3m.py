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
import os

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

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

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
    # the body-sharded ring runs (ported): over one rank it is the single-card
    # solve, bit for bit
    tp, tm, ta = _t(pos, mass, alive)
    kw = dict(G_grav=1.0, eps2=1e-4, grid=64, capacity=64)
    a_r, U_r = tot.make_mesh(shape=(1,), devices="cpu").run(
        lambda c: tp3m.p3m_ring_force(tp, tm, ta, comm=c, **kw))[0]
    a_1, U_1, _ = tp3m.p3m_acc_potential(tp, tm, ta, **kw)
    assert torch.equal(a_r, a_1) and torch.equal(U_r, U_1)
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
    # the reorder kernel's wrapper: the plain version on CPU tensors, else
    # the kernel or a refusal
    tab = tp3m.p3m_cell_table(*_t(pos, mass), torch.ones(256, dtype=torch.bool),
                              *_t(*BOX), gc=2, capacity=96)
    args = (tab["table"], tab["cell_pos"], tab["cell_m"], tab["count"], 2)
    got, want = cuda_p3m.p3m_short_order_cuda(*args), cuda_p3m.p3m_short_order(*args)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert cuda_p3m.p3m_short_order_cuda.launches == 0
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_p3m.p3m_short_order_cuda(t, torch.zeros((9, 4, 3), device="meta"),
                                      torch.zeros((9, 4), device="meta"),
                                      torch.zeros(8, device="meta"), 2)


# --- the redesigned short-range kernel's visiting rule and arithmetic
# (csrc/p3m_short.cu), mirrored on the CPU ---

def _kernel_constants():
    """kSMax and the polynomial coefficients kF and kG, read from the
    kernel's source."""
    import re
    from pathlib import Path

    src = (Path(cuda_p3m.__file__).parent.parent / "csrc" / "p3m_short.cu").read_text()
    smax = float(re.search(r"kSMax = ([0-9.e+-]+)f;", src).group(1))
    coef = {k: [float(x) for x in re.findall(r"([-0-9.e+]+)f", re.search(
        rf"__constant__ float {k}\[\d+\] = \{{(.*?)\}};", src, re.S).group(1))]
        for k in ("kF", "kG")}
    return smax, coef["kF"], coef["kG"]


def _kernel_factors(r2, sigma, eps2):
    """The kernel's g and K in float32: Fl and Gl as polynomials in
    u = min(a^2 r^2, kSMax) 2 / kSMax - 1 (Horner), g = 1/s^3 - a^3 Gl,
    K = 1/s - a Fl."""
    smax, kf, kg = _kernel_constants()
    f32 = torch.float32
    alpha = (1.0 / (2.0 * torch.as_tensor(sigma, dtype=f32))).to(f32)
    u = torch.clamp(alpha * alpha * r2.to(f32), max=smax) * np.float32(2.0 / smax) - 1.0
    F = torch.full_like(u, kf[-1])
    for c in reversed(kf[:-1]):
        F = F * u + c
    Gl = torch.full_like(u, kg[-1])
    for c in reversed(kg[:-1]):
        Gl = Gl * u + c
    inv_s = torch.rsqrt(r2.to(f32) + np.float32(eps2))
    g = inv_s * inv_s * inv_s - (alpha * alpha * alpha) * Gl
    return g.to(r2.dtype), (inv_s - alpha * F).to(r2.dtype)


def _short_tables():
    """The P3M bench row's geometry at 4,096 bodies (uniform in [-4, 4]^3,
    grid 64, box (0, 0, 0, 6), chip_smoke.py's capacity rule) and the ragged
    scene (a third dead, grid 32, cube fitted): (name, table, gc, sigma,
    rcut2, n) with sigma and rcut2 rounded in float32 as the solver does."""
    rng = np.random.default_rng(11)
    bench = (rng.uniform(-4, 4, (4096, 3)).astype(np.float32),
             np.full(4096, 1.0 / 4096, np.float32), None)
    out = []
    for name, (pos, mass, alive), g, box in (
            ("bench", bench, 64, (np.zeros(3, np.float32), np.float32(6.0))),
            ("ragged", _uniform(1500, 8, dead=True), 32, None)):
        p, m = _t(pos, mass)
        a = torch.ones(len(m), dtype=torch.bool) if alive is None else torch.as_tensor(alive)
        if box is None:
            c, half = tpm._bounding_cube(p, a.float(), g)
        else:
            c, half = _t(*box)
        gc = tp3m._cell_grid(g, 1.5, 4.5)
        occ = tp3m.p3m_max_occupancy(p, a, grid=g, box=None if box is None else (c, half))
        tab = tp3m.p3m_cell_table(p, m * a, a, c, half, gc=gc,
                                  capacity=max(32, -(-int(occ * 1.5) // 8) * 8))
        sigma = 1.5 * (2.0 * half / g)
        out.append((name, tab, gc, float(sigma), float((4.5 * sigma) ** 2), len(mass)))
    return out


@pytest.fixture(scope="module")
def short_tables():
    return _short_tables()


def test_short_order_permutes_within_each_prefix(short_tables):
    """The kernel's reorder permutes each cell's kept prefix only: the
    table's bodies, counts, positions and masses are unchanged as multisets;
    run_off cuts the prefix into 8 ascending runs whose boxes hold their
    rows; the cell table itself is untouched."""
    for name, tab, gc, *_ in short_tables:
        before = {k: v.clone() for k, v in tab.items()}
        o = cuda_p3m.p3m_short_order(tab["table"], tab["cell_pos"], tab["cell_m"],
                                     tab["count"], gc)
        gc3, cap = gc ** 3, tab["table"].shape[1]
        cnt = tab["count"].long()
        k = torch.arange(cap)
        inside = k[None] < cnt[:, None]
        perm = o["perm"]
        assert torch.equal(torch.sort(torch.where(inside, perm, cap), 1).values,
                           torch.where(inside, k, cap).expand(gc3, -1))
        assert torch.equal(perm[~inside], k.expand(gc3, -1)[~inside])
        assert torch.equal(o["table"], torch.gather(tab["table"][:gc3], 1, perm))
        rows = torch.cat([tab["cell_pos"][:gc3], tab["cell_m"][:gc3, :, None]], -1)
        assert torch.equal(o["rows"], torch.gather(rows, 1, perm[..., None].expand(-1, -1, 4)))
        off = o["run_off"].long()
        assert off.dtype == torch.long and torch.equal(off[:, -1], cnt)
        assert bool((off[:, 1:] >= off[:, :-1]).all()) and bool((off[:, 0] == 0).all())
        for c in torch.nonzero(cnt).flatten().tolist()[:200]:
            for r in range(8):
                p = o["rows"][c, off[c, r]:off[c, r + 1], :3]
                if len(p):
                    assert bool((p >= o["run_box"][c, r, :3]).all())
                    assert bool((p <= o["run_box"][c, r, 3:]).all())
        for key, v in before.items():
            assert torch.equal(tab[key], v), (name, key)


def _slice_pairs(tab, gc, rcut2):
    """Every (slice row i, neighbour kept row j) pair of the reordered
    table: f32 r^2 in two summation orders, j within reach of the slice's
    box (``in_box``), j's run within reach of it, self pairs, and each
    neighbour's run offsets and which of its runs are within reach."""
    import chip_smoke

    o = cuda_p3m.p3m_short_order(tab["table"], tab["cell_pos"], tab["cell_m"], tab["count"],
                                 gc)
    sl = chip_smoke.p3m_slices(o, gc, rcut2)
    gc3, cap = gc ** 3, tab["table"].shape[1]
    nb = tp3m._neighbour_cells(sl["cell"], gc)                         # [S, 27]
    ok = nb < gc3
    ids = torch.where(ok, nb, 0)
    cnt = tab["count"].long()
    k = torch.arange(cap)
    live_j = ok[..., None] & (k < cnt[ids][..., None])                 # [S, 27, M]
    ki = sl["s0"][:, None] + torch.arange(32)
    live_i = ki < cnt[sl["cell"], None]                                 # [S, 32]
    pi = o["rows"][sl["cell"][:, None], ki.clamp(max=cap - 1), :3]      # [S, 32, 3]
    pj = o["rows"][ids][..., :3]                                        # [S, 27, M, 3]
    d = pj[:, None] - pi[:, :, None, None]                              # [S, 32, 27, M, 3]
    r2a = (d * d).sum(-1)
    r2b = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    lo, hi = sl["lo"][:, None, None], sl["hi"][:, None, None]
    in_box = (chip_smoke.p3m_within_reach(lo, hi, sl["reach2"], pj.double(), pj.double())
              & live_j)
    octant = torch.searchsorted(o["run_off"][:, 1:].long().contiguous(),
                                k.expand(gc3, -1).contiguous(), right=True)[ids]
    b = o["run_box"][ids].double()
    meets = chip_smoke.p3m_within_reach(lo, hi, sl["reach2"], b[..., :3], b[..., 3:])
    staged = live_j & torch.gather(meets, 2, octant.clamp(max=7))
    self_pair = (ids[:, None, :, None] == sl["cell"][:, None, None, None]) & (
        k[None, None, None, :] == ki[:, :, None, None])
    off = torch.where(ok[..., None], o["run_off"][ids].long(), 0)
    meets &= ok[..., None] & (off[..., 1:] > off[..., :-1])
    return dict(sl=sl, live_i=live_i, live_j=live_j, r2a=r2a, r2b=r2b, in_box=in_box,
                staged=staged, self_pair=self_pair, pj=pj, pi=pi, meets=meets, off=off)


def test_short_box_rule_keeps_every_pair(short_tables):
    """The kernel visits a slice's rows against the rows within reach of its
    box (squared distance to the box, rounded down, below p3m_short_reach2)
    of the neighbour runs whose box is within reach. Every pair with an f32
    r^2 < rcut^2, in either summation order, is among them, on the bench
    geometry and the ragged scene."""
    for name, tab, gc, sigma, rcut2, n in short_tables:
        t = _slice_pairs(tab, gc, rcut2)
        pair = t["live_i"][:, :, None, None] & t["live_j"][:, None] & ~t["self_pair"]
        need = pair & ((t["r2a"] < rcut2) | (t["r2b"] < rcut2))
        visit = pair & (t["in_box"] & t["staged"])[:, None]
        assert int(need.sum()) > 0 and not bool((need & ~visit).any()), name
        assert bool((t["in_box"] <= t["staged"]).all())
        assert int(visit.sum()) < int(pair.sum())


def test_short_work_counts_equal_brute_force(short_tables):
    """chip_smoke.p3m_short_work's staged, visited, issued and needed pairs
    equal a pair-by-pair count; the lane slots by stepping each warp's
    buffer as the kernel does (8 warps): the rows of the runs within reach,
    in run order, as one flat sequence, warp w taking its rounds of 32 rows
    w, w + 8, ..., a sweep of the largest multiple of G rows once its buffer
    holds 64, the rest at the end."""
    import chip_smoke

    for name, tab, gc, sigma, rcut2, n in short_tables:
        t = _slice_pairs(tab, gc, rcut2)
        rows = t["live_i"].sum(1).tolist()
        in_box, meets, off = t["in_box"].tolist(), t["meets"].tolist(), t["off"].tolist()
        issued = 0
        for s in range(len(rows)):
            G = 32 >> int(math.ceil(math.log2(max(rows[s], 1))))
            flags = [f for r in range(27 * 8) if meets[s][r // 8][r % 8]
                     for f in in_box[s][r // 8][off[s][r // 8][r % 8]:off[s][r // 8][r % 8 + 1]]]
            for w in range(8):
                fill = it = 0
                for f0 in range(32 * w, len(flags), 32 * 8):
                    fill += sum(flags[f0:f0 + 32])
                    if fill >= 64:
                        it += fill // G
                        fill %= G
                it += -(-fill // G)
                issued += 32 * it
        pair = t["live_i"][:, :, None, None] & t["live_j"][:, None] & ~t["self_pair"]
        d64 = t["pj"].double()[:, None] - t["pi"].double()[:, :, None, None]
        rows_t = t["live_i"].sum(1)
        want = dict(staged=int((rows_t * t["staged"].sum((1, 2))).sum()),
                    visited=int((rows_t * t["in_box"].sum((1, 2))).sum()),
                    needed=int((pair & ((d64 ** 2).sum(-1) < rcut2)).sum()), issued=issued)
        work = chip_smoke.p3m_short_work(tab, gc, n, rcut2)
        assert {k: work[k] for k in want} == want, name
        assert work["needed"] < work["visited"] <= work["staged"] <= work["walked"]
        assert work["visited"] <= work["issued"]


def test_kernel_factors_hold_the_short_range_gate(short_tables, monkeypatch):
    """The kernel's polynomial g and K (a mirror in float32, coefficients
    read from the source) summed over the cell table sit within SHORT_RTOL
    = 1e-5 (chip_smoke.py's gate for the kernel) of the plain f32 sum and
    of the f64 sum, on both scenes; pointwise the polynomials hold erf(x)/x
    and the long-range part within 4 and 6 ulps on [0, kSMax]."""
    import mpmath

    smax, _, _ = _kernel_constants()
    s = torch.linspace(0.0, smax, 401, dtype=torch.float64)
    sigma = 0.5  # a = 1: the factors' long-range parts are Fl and Gl
    g, K = _kernel_factors(s.float(), sigma, 1e30)
    x = [mpmath.sqrt(v) for v in s.tolist()]
    fl = torch.tensor([float(mpmath.erf(v) / v) if v else 2 / math.sqrt(math.pi) for v in x],
                      dtype=torch.float64)
    c = 2 / mpmath.sqrt(mpmath.pi)
    gl = torch.tensor([float((mpmath.erf(v) - c * v * mpmath.exp(-v * v)) / v ** 3)
                       if v else 4 / (3 * math.sqrt(math.pi)) for v in x], dtype=torch.float64)
    # eps2 = 1e30 leaves 1/s ~ 1e-15: K = -Fl and g = -Gl to f32 rounding
    assert float(((-K.double() - fl) / fl).abs().max()) < 4 * 2.0 ** -24
    assert float(((-g.double() - gl) / gl).abs().max()) < 6 * 2.0 ** -24
    for name, tab, gc, sigma, rcut2, n in short_tables:
        kw = dict(gc=gc, n=n, G=1.0, sigma=sigma, rcut2=rcut2, eps2=1e-4)
        args = (tab["table"], tab["cell_pos"], tab["cell_m"])
        a0, p0 = tp3m.p3m_short_plain(*args, **kw)
        a64, p64 = tp3m.p3m_short_plain(tab["table"], tab["cell_pos"].double(),
                                        tab["cell_m"].double(), **kw)
        with monkeypatch.context() as mp:
            mp.setattr(tp3m, "_short_factors", _kernel_factors)
            a, p = tp3m.p3m_short_plain(*args, **kw)
        for ref_a, ref_p in ((a0, p0), (a64, p64)):
            assert _rel(a, ref_a) < 1e-5 and _rel(p, ref_p) < 1e-5, name
