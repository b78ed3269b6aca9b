"""Resolve collisions (the outcome model) of the PyTorch port against the
JAX package's: ``resolve_outcomes`` on the JAX package's own scenes and a
seeded scene with chains, ``resolve_outcomes_subset`` at a ragged N above
4,096, the contact marks, the port's draws, absorption-only rollouts under
kdk, Hermite, the block stepper and RESPA, the ds32 gate, ``simulate()``
with debris, and the contact sweep's tile plan.

JAX draws with threefry, which torch does not reproduce: the port takes its
draws as inputs, so these tests hand JAX's own ``jax.random`` draws for the
same key to the port (the fragmentation uniforms [T, T] and the debris
normals [B, K, 3], as JAX's ``resolve_outcomes`` makes them), and the
rollouts use scenes whose outcomes need no roll. Tolerances:
  * integers and masks (alive, marks, deferred): equal.
  * f64: rtol 1e-12, atol 1e-12 of each field's largest magnitude (row sums
    in another order; ``jnp.cbrt`` against ``pow(x, 1/3)``).
  * f32: 8 ulps (rtol 4.8e-7) of each field's largest magnitude: the same
    operations, summed in another order and, in jitted XLA:CPU, with
    multiply-adds contracted.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine import multirate as jmr
from orbital_tpu.ops import collisions as jcoll
from orbital_tpu.ops import neighbor as jn
from orbital_tpu_torch.engine import integrators as I
from orbital_tpu_torch.engine import multirate as tmr
from orbital_tpu_torch.engine.state import state_from_arrays
from orbital_tpu_torch.ops import collisions as tcoll
from orbital_tpu_torch.ops import cuda_collisions

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

DEBRIS = ("debris_k", "debris_max_pairs", "debris_energy_frac", "debris_sep")
_j_subset = jax.jit(jcoll.resolve_outcomes_subset,
                    static_argnames=("subset", "chunk", "restitution", *DEBRIS))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_draws(key, n, dtype, debris_k=0, debris_max_pairs=4):
    """JAX's draws inside ``resolve_outcomes`` for ``key`` at n bodies: the
    raw [n, n] uniforms and the [B, K, 3] normals (None without debris)."""
    u = np.asarray(jax.random.uniform(key, (n, n), dtype=dtype))
    B = min(debris_max_pairs, n // debris_k) if debris_k > 0 else 0
    if B <= 0:
        return u, None
    d = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (B, debris_k, 3),
                                     dtype=dtype))
    return u, d


def _close(got, ref, dtype, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if ref.size else 0.0
    rtol = 1e-12 if dtype == np.float64 else 8 * 2.0 ** -24
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


def _hold(out, ref, dtype, parked=None):
    """The port's (pos, vel, mass, radius, alive) against JAX's: alive equal,
    the rest by ``_close``; rows of ``parked`` only far off (> 1e7)."""
    out = [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]
    ref = [np.asarray(r) for r in ref]
    np.testing.assert_array_equal(out[4], ref[4])
    keep = slice(None) if parked is None else ~parked
    _close(out[0][keep], ref[0][keep], dtype, "pos")
    if parked is not None:
        assert (np.abs(out[0][parked]).max(axis=1) > 1e7).all()
    for k, name in ((1, "vel"), (2, "mass"), (3, "radius")):
        _close(out[k], ref[k], dtype, name)


def _scenes():
    """The JAX package's resolve scenes (tests/test_engine_core.py:196-410):
    (pos, vel, mass, radius, alive, key seed, debris kwargs)."""
    two = dict(pos=[[0.0, 0, 0], [1.5, 0, 0]], radius=[1.0, 1.0], alive=[True, True])
    spare = dict(pos=[[0.0, 0, 0], [1.5, 0, 0], [1e6, 0, 0], [1e6, 1, 0], [1e6, 2, 0],
                      [1e6, 3, 0]],
                 vel=[[500.0, 0, 0], [-500.0, 0, 0]] + [[0.0, 0, 0]] * 4,
                 mass=[2.0, 3.0, 0, 0, 0, 0], radius=[1.0, 1.0, 0, 0, 0, 0],
                 alive=[True, True, False, False, False, False])
    return {
        "absorb": (dict(pos=[[0.0, 0, 0], [1.5, 0, 0], [50.0, 0, 0]],
                        vel=[[0.5, 0, 0], [-0.5, 0, 0], [0.0, 0, 0]], mass=[100.0, 1.0, 4.0],
                        radius=[1.0, 1.0, 1.0], alive=[True] * 3), 0, {}),
        "fragment": (dict(two, vel=[[500.0, 0, 0], [-500.0, 0, 0]], mass=[2.0, 3.0]), 1, {}),
        "bounce": (dict(two, vel=[[0.1, 0, 0], [-0.1, 0, 0]], mass=[5.0, 5.0]), 0, {}),
        "debris": (spare, 7, dict(debris_k=4, debris_energy_frac=0.3)),
        "no_slots": (dict(two, vel=[[500.0, 0, 0], [-500.0, 0, 0]], mass=[2.0, 3.0]), 0,
                     dict(debris_k=3)),
    }


def _chain_scene(dtype, n=64, seed=11):
    """A seeded scene with every outcome: comparable-mass chains at a speed
    where p ~ 1/2 (some fragment, some bounce: the roll decides), two heavy
    absorbers each touching light bodies (one light body touching both),
    dead slots for debris and a dead body inside the contact range."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 4.0, (n, 3))
    vel = rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    radius = np.full(n, 0.05)
    alive = np.ones(n, bool)
    v = math.sqrt(4e3) / 2.0          # E_coll = E_thresh for equal unit masses
    for row in range(3):              # chains of three along x, v_rel^2 = 4e3
        for k in range(3):
            j = 3 * row + k
            pos[j] = [10.0 + 0.09 * k, 2.0 * row, 0.0]
            vel[j] = [v * (-1) ** k, 0.0, 0.0]
            mass[j] = 1.0
    pos[20], pos[21], pos[22] = [20.0, 0, 0], [20.08, 0, 0], [20.0, 0.08, 0]
    pos[23], pos[24] = [20.2, 0, 0], [20.28, 0, 0]
    pos[25] = [20.14, 0, 0]           # touches both absorbers 20 and 23
    mass[[20, 23]] = [50.0, 80.0]
    mass[[21, 22, 24, 25]] = 1.0
    radius[[20, 23]] = 0.06
    alive[40:48] = False              # debris slots
    alive[30] = False
    pos[30] = pos[0] + [0.02, 0, 0]
    return [a.astype(dtype) for a in (pos, vel, mass, radius)] + [alive]


@pytest.mark.parametrize("name", list(_scenes()))
def test_resolve_outcomes_match_jax_on_its_scenes(name):
    scene, seed, kw = _scenes()[name]
    pos, mass, radius, alive = (np.array(scene[k], dtype=t) for k, t in
                                (("pos", float), ("mass", float), ("radius", float),
                                 ("alive", bool)))
    vel = np.array(scene["vel"], float)
    key = jax.random.PRNGKey(seed)
    ref = jcoll.resolve_outcomes(pos, vel, mass, radius, alive, key, **kw)
    u, d = _jax_draws(key, len(pos), jnp.float64, kw.get("debris_k", 0))
    out = tcoll.resolve_outcomes(*_t(pos, vel, mass, radius, alive, u),
                                 None if d is None else _t(d)[0], **kw)
    _hold(out, ref, np.float64)
    if name == "debris":
        assert out[4].tolist() == [False, False, True, True, True, True]
        assert float(out[2].sum()) == pytest.approx(5.0, rel=1e-14)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [3, 4])
def test_resolve_outcomes_match_jax_on_chains(dtype, seed):
    """Every outcome at once (p ~ 1/2 pairs, shared absorbers, debris), with
    JAX's draws for the key."""
    pos, vel, mass, radius, alive = _chain_scene(dtype)
    kw = dict(debris_k=2, debris_max_pairs=3, restitution=0.8)
    key = jax.random.PRNGKey(seed)
    ref = jcoll.resolve_outcomes(pos, vel, mass, radius, alive, key, **kw)
    u, d = _jax_draws(key, len(pos), dtype, 2, 3)
    out = tcoll.resolve_outcomes(*_t(pos, vel, mass, radius, alive, u, d), **kw)
    _hold(out, ref, dtype)
    new_alive = np.asarray(ref[4])
    assert not new_alive[[21, 22, 24, 25]].any()       # absorbed
    np.testing.assert_array_equal(np.asarray(ref[2])[[20, 23]], [52.0, 82.0])
    assert (~new_alive[:9]).sum() >= 2                 # fragmented
    assert (new_alive & ~alive).sum() >= 2             # debris spawned


def _jax_marks(pos, radius, alive, B=1024):
    """JAX's contact marks, transcribed from ``resolve_outcomes_subset``'s
    ``i_block`` (orbital_tpu/ops/collisions.py:443-464): padding rows at
    1e17 / 1e30, radius 0, dead."""
    n = pos.shape[0]
    npad = -(-n // B) * B

    def pad(a, fill):
        return jnp.pad(a, ((0, npad - n),) + ((0, 0),) * (a.ndim - 1), constant_values=fill)

    pos_p = pad(pos, 1.0e17 if pos.dtype == jnp.float32 else 1.0e30)
    rad_p, alive_p = pad(radius, 0.0), pad(alive, False)

    def i_block(i0):
        pi = jax.lax.dynamic_slice(pos_p, (i0, 0), (B, 3))
        ri = jax.lax.dynamic_slice(rad_p, (i0,), (B,))
        ai = jax.lax.dynamic_slice(alive_p, (i0,), (B,))
        dx = pi[:, None, 0] - pos_p[None, :, 0]
        dy = pi[:, None, 1] - pos_p[None, :, 1]
        dz = pi[:, None, 2] - pos_p[None, :, 2]
        dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        touch = (ai[:, None] & alive_p[None, :]
                 & (dist <= ri[:, None] + rad_p[None, :]) & (dist > 0.0))
        return jnp.any(touch, axis=1)

    return jax.lax.map(i_block, jnp.arange(0, npad, B)).reshape(npad)[:n]


_j_marks = jax.jit(_jax_marks, static_argnames=("B",))


def _ragged_scene(dtype, n=4200, seed=5):
    """A ragged cluster above the dense ceiling: sparse random contacts, a
    certain absorption and a certain fragmentation far apart, coincident
    bodies (dist 0 never touches) and dead slots for debris."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(1.0, 2.0, n)
    radius = np.full(n, 0.007)
    alive = np.ones(n, bool)
    alive[100:130] = False
    pos[0], pos[1], mass[0], mass[1] = [5.0, 0, 0], [5.006, 0, 0], 100.0, 1.0
    pos[2], pos[3], vel[2], vel[3] = [7.0, 0, 0], [7.006, 0, 0], [500.0, 0, 0], [-500.0, 0, 0]
    pos[4] = pos[5] = [9.0, 0, 0]
    return [a.astype(dtype) for a in (pos, vel, mass, radius)] + [alive]


@pytest.mark.parametrize("dtype,subset", [(np.float64, 48), (np.float32, 48),
                                          (np.float64, 8)])
def test_resolve_subset_matches_jax(dtype, subset):
    """At N = 4,200 with dead slots: the marks integer-equal to JAX's
    ``i_block`` (the plain version and the CUDA wrapper's CPU path), the
    deferral equal, and the outputs JAX's, with JAX's draws on the subset
    scene. At subset 8 contacts are deferred."""
    pos, vel, mass, radius, alive = _ragged_scene(dtype)
    kw = dict(debris_k=2, debris_max_pairs=2)
    key = jax.random.PRNGKey(3)
    ref = _j_subset(pos, vel, mass, radius, alive, key, subset=subset, chunk=1024, **kw)
    marks = np.asarray(_j_marks(pos, radius, alive))
    tp, tr, ta = _t(pos, radius, alive)
    np.testing.assert_array_equal(tcoll.contact_marks_chunked(tp, tr, ta).numpy(), marks)
    np.testing.assert_array_equal(
        cuda_collisions.contact_marks_cuda(tp, tr, ta, contacts=torch.tensor(
            3, dtype=torch.int32)).numpy(), marks)
    assert not cuda_collisions.contact_marks_cuda(tp, tr, ta, contacts=torch.tensor(
        0, dtype=torch.int32)).any()
    assert 16 < marks.sum() < 48 and not marks[[4, 5]].any() and marks[[0, 1, 2, 3]].all()
    T, B = tcoll.resolve_sizes(len(pos), subset, 2, 2)
    u, d = _jax_draws(key, T, dtype, 2, 2)
    out = tcoll.resolve_outcomes_subset(*_t(pos, vel, mass, radius, alive, u, d),
                                        subset=subset, **kw)
    assert int(out[5]) == int(ref[5]) == max(int(marks.sum()) - subset, 0)
    # newly dead rows park by the subset scene's extent in both
    _hold(out[:5], ref[:5], dtype)
    assert cuda_collisions.contact_marks_cuda.launches == 0  # CPU: no launch


def test_contact_marks_plain_edge_cases():
    """Dead, coincident and ragged-chunk cases of the row blocks against
    JAX's marks, and the gate of the plain version."""
    pos, _, _, radius, alive = _chain_scene(np.float32)
    tp, tr, ta = _t(pos, radius, alive)
    ref = np.asarray(_j_marks(pos, radius, alive, B=1024))
    for chunk in (1024, 7):
        np.testing.assert_array_equal(
            tcoll.contact_marks_chunked(tp, tr, ta, chunk=chunk).numpy(), ref)
    assert not ref[30] and ref[[0, 20, 25]].all()
    zero = torch.tensor(0, dtype=torch.int32)
    assert not cuda_collisions.contact_marks_plain(tp, tr, ta, contacts=zero).any()


def test_resolve_draws():
    """Deterministic for (seed, step); symmetric; in [0, 1); fresh a step and
    a seed; a device step tensor is not read; the normals' moments."""
    step = torch.tensor(7, dtype=torch.int32)
    u, d = tcoll.resolve_draws(11, step, 64, 4, 2)
    u2, d2 = tcoll.resolve_draws(11, 7, 64, 4, 2)
    assert torch.equal(u, u2) and torch.equal(d, d2) and d.shape == (4, 2, 3)
    assert torch.equal(u, u.T) and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert u.dtype == torch.float32
    u3, _ = tcoll.resolve_draws(11, 8, 64, 4, 2)
    u4, _ = tcoll.resolve_draws(12, 7, 64, 4, 2)
    assert float((u3 == u).float().mean()) < 0.01 and float((u4 == u).float().mean()) < 0.01
    big, z = tcoll.resolve_draws(0, 3, 512, 4096, 4, dtype=torch.float64)
    assert big.dtype == torch.float64 and tcoll.resolve_draws(0, 3, 4, 0, 4)[1] is None
    upper = big[torch.triu(torch.ones(512, 512, dtype=torch.bool), diagonal=1)]
    assert abs(float(upper.mean()) - 0.5) < 0.005 and abs(float(upper.var()) - 1 / 12) < 0.002
    assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1.0) < 0.03


def test_fragmentation_frequency_at_threshold():
    """At E_coll = E_thresh the fragmentation probability is 1/2: over 512
    steps of the port's draws the frequency is within 0.40-0.60, as
    tests/test_engine_core.py:258 holds JAX's."""
    v = math.sqrt(4e3) / 2.0
    pos, vel = _t([[0.0, 0, 0], [1.5, 0, 0]], [[v, 0, 0], [-v, 0, 0]])
    mass, radius, alive = torch.ones(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64), \
        torch.ones(2, dtype=torch.bool)
    frag = 0
    for step in range(512):
        u, _ = tcoll.resolve_draws(42, torch.tensor(step, dtype=torch.int32), 2, 0, 0,
                                   dtype=torch.float64)
        frag += int(not tcoll.resolve_outcomes(pos, vel, mass, radius, alive, u)[4][0])
    assert 0.40 < frag / 512 < 0.60


def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return state_from_arrays({k: None if v is None else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def _assert_final(tf, jf, tol=dict(rtol=1e-12, atol=1e-13)):
    np.testing.assert_array_equal(tf.alive.numpy(), np.asarray(jf.alive))
    for f in ("pos", "vel", "mass", "radius", "acc"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                   err_msg=f, **tol)
    assert int(tf.step) == int(jf.step)


def _absorb_cluster(n=64, seed=9):
    """Eight heavy bodies (mass 1, radius 0.08) on a grid 1.5 apart, each
    with light bodies (mass 0.01, radius 1e-3) falling onto it; the light
    bodies and the heavy ones never meet their own kind in 16 steps, so every
    contact is an absorption and no outcome needs a roll."""
    rng = np.random.default_rng(seed)
    heavy = np.array([[x, y, z] for x in (0, 1.5) for y in (0, 1.5) for z in (0, 1.5)], float)
    pos = np.concatenate([heavy, heavy[np.arange(n - 8) % 8]
                          + rng.normal(size=(n - 8, 3)) * 0.05 + 0.12])
    vel = np.zeros((n, 3))
    vel[8:] = -3.0 * (pos[8:] - heavy[np.arange(n - 8) % 8])
    mass = np.concatenate([np.ones(8), np.full(n - 8, 0.01)])
    radius = np.concatenate([np.full(8, 0.08), np.full(n - 8, 1e-3)])
    return pos, vel, mass, radius


@pytest.mark.parametrize("integrator,extra", [
    ("kdk", {}), ("hermite", {}),
    ("hermite", dict(hermite_fast_cap=8, adaptive_eta=0.02, dt_min=1e-6,
                     hermite_max_substeps=8))])
def test_resolve_steppers_match_jax(integrator, extra):
    """f64 rollouts with absorptions under each stepper, gated on the
    closing evaluation's count (the block stepper at its macro boundaries)."""
    pos, vel, mass, radius = _absorb_cluster()
    cfg = jot.SimConfig(dt=2e-2, G=1e-3, eps2=1e-4, collisions="resolve", frag_seed=3,
                        integrator=integrator, **extra)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="f64"), cfg)
    jf, _ = jot.rollout_jit(js, cfg, 16)
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg))
    tf, _ = tot.rollout(_port_state(js), tcfg, 16)
    assert int((~tf.alive).sum()) >= 6
    assert float(tf.mass.sum()) == pytest.approx(float(mass.sum()), rel=1e-14)
    _assert_final(tf, jf)


def test_resolve_respa_matches_jax():
    """RESPA with absorptions at the macro boundaries: the state and every
    counter equal to JAX's (its `overflow` counts the bodies dead at a
    window's start in both packages)."""
    pos, vel, mass, radius = _absorb_cluster()
    chunk, rj = 8, 16
    m, k_ch, w_blk, q = jn.neighbor_budgets(pos, cell=0.6, chunk=chunk, rj=rj, with_wl=True)
    cfg = jot.SimConfig(dt=2e-2, G=1e-3, eps2=1e-4, integrator="respa", respa_k=4,
                        respa_rc=0.3, respa_cell=0.6, respa_m=m, respa_max_chunks=k_ch,
                        respa_w_blk=w_blk, respa_chunk=chunk, respa_rj=rj,
                        respa_wl_entries=q, collisions="resolve")
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="f64"), cfg)
    jf, _, jd = jmr.respa_rollout_jit(js, cfg, 16)
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg))
    tf, _, td = tmr.respa_rollout(_port_state(js), tcfg, 16)
    assert int((~tf.alive).sum()) >= 6
    _assert_final(tf, jf, dict(rtol=1e-11, atol=1e-12))
    for k in jd:
        assert int(td[k]) == int(jd[k]), k


def test_resolve_respa_debris_without_a_slot_matches_jax():
    """A debris fragment revived into a dead slot at a window's close: the
    geometry is rebuilt every window (both packages refuse respa_refresh > 1
    with collisions), so it has no slot only until the next window's build,
    and its first far kick takes the acceleration cached for the dead slot,
    in both packages; `overflow` counts the slots dead at a window's start.
    Certain fragmentation (v_rel 1,000), no spread energy and no separation
    (coincident fragments never touch): the outcome needs no roll and the
    debris no direction."""
    pos = np.array([[-0.05, 0, 0], [0.05, 0, 0], [3.0, 3.0, 3.0], [-3.0, 3.0, 0.0],
                    [9.0, 9.0, 9.0], [9.0, 9.0, 8.0]])
    vel = np.array([[500.0, 0, 0], [-500.0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
                    [0, 0, 0]])
    mass = np.array([2.0, 3.0, 1.0, 1.0, 0.0, 0.0])
    radius = np.array([0.1, 0.1, 0.01, 0.01, 0.0, 0.0])
    alive = np.array([True] * 4 + [False] * 2)
    chunk, rj = 8, 16
    m, k_ch, w_blk, q = jn.neighbor_budgets(pos[:4], cell=1.0, chunk=chunk, rj=rj,
                                            with_wl=True)
    cfg = jot.SimConfig(dt=1e-4, G=1e-3, eps2=1e-4, integrator="respa", respa_k=2,
                        respa_rc=0.5, respa_cell=1.0, respa_m=m, respa_max_chunks=k_ch,
                        respa_w_blk=w_blk, respa_chunk=chunk, respa_rj=rj,
                        respa_wl_entries=q, collisions="resolve",
                        debris_k=2, debris_energy_frac=0.0, debris_sep=0.0)
    js = jot.init_forces(jot.make_state(pos, vel, mass, radius, precision="f64"), cfg)
    js = js.replace(alive=jnp.asarray(alive))
    jf, _, jd = jmr.respa_rollout_jit(js, cfg, 4)
    tcfg = tot.SimConfig(**dataclasses.asdict(cfg))
    tf, _, td = tmr.respa_rollout(_port_state(js), tcfg, 4)
    assert tf.alive.tolist() == [False, False, True, True, True, True]
    _assert_final(tf, jf, dict(rtol=1e-11, atol=1e-12))
    assert int(td["overflow"]) == int(jd["overflow"]) >= 2
    for k in jd:
        assert int(td[k]) == int(jd[k]), k


def test_resolve_gate_keeps_every_field_at_count_zero(monkeypatch):
    """ds32: at a fused count of 0 every field resolve writes (pos, vel,
    mass, radius, alive and both lo words) stays bit-equal, though bodies
    touch and would be absorbed, on the dense and the subset route; a
    resolve-armed run whose bodies never touch is bit-equal to the
    collision-free run."""
    pos, vel, mass, radius = _absorb_cluster()
    pos[8] = pos[0] + [0.05, 0, 0]   # touching heavy body 0 now
    st = tot.make_state(pos, vel, mass, radius, precision="ds32", device="cpu")
    st = st.replace(pos_lo=torch.full_like(st.pos, 1e-9), vel_lo=torch.full_like(st.vel, -1e-9))
    cfg = tot.SimConfig(dt=1e-3, eps2=1e-4, collisions="resolve")
    fields = ("pos", "pos_lo", "vel", "vel_lo", "mass", "radius", "alive")
    for route in ("dense", "subset"):
        if route == "subset":  # the route CUDA tensors take, here on the row blocks
            monkeypatch.setattr(I, "_DENSE_BOUNCE_MAX_N", 0)
        for count in (0, 5):
            out = I._apply_collisions(cfg, st, torch.tensor(count, dtype=torch.int32))
            same = {f: torch.equal(getattr(out, f), getattr(st, f)) for f in fields}
            if count == 0:
                assert all(same.values()), (route, same)
            else:
                assert not (same["alive"] or same["pos_lo"] or same["mass"]), (route, same)
    far = tot.make_state(pos, vel, mass, np.full(64, 1e-6), precision="ds32", device="cpu")
    far = tot.init_forces(far, tot.SimConfig(dt=1e-3, eps2=1e-4))
    a, _ = tot.rollout(far, cfg, 10)
    b, _ = tot.rollout(far, tot.SimConfig(dt=1e-3, eps2=1e-4), 10)
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_simulate_resolve_with_debris():
    """simulate(collisions="resolve", debris_k=2, spare=...) runs on the CPU,
    spawns debris and conserves mass when every fragmentation spawned it;
    the same seed repeats bit for bit, and JAX's simulate() with the same
    options fragments the same pair."""
    from orbital_tpu.models.scene import SceneArrays as JScene
    from orbital_tpu_torch.models.scene import SceneArrays as TScene

    pos = np.array([[-0.5, 0, 0], [0.5, 0, 0], [0.0, 5.0, 0.0], [0.0, -5.0, 0.0]])
    vel = np.array([[500.0, 0, 0], [-500.0, 0, 0], [0.0, 0, 0], [0.0, 0, 0]])
    mass, radius = np.array([2.0, 3.0, 1.0, 1.0]), np.array([0.2, 0.2, 0.01, 0.01])
    names = [f"b{i}" for i in range(4)]
    kw = dict(steps=20, dt=1e-4, softening=1e-2, collisions="resolve", precision="f64",
              record_every=10, frag_seed=5, debris_k=2, debris_energy_frac=0.2, spare=4)
    res = tot.simulate(TScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names),
                       device="cpu", **kw)
    again = tot.simulate(TScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names),
                         device="cpu", **kw)
    ref = jot.simulate(JScene(pos=pos, vel=vel, mass=mass, radius=radius, names=names), **kw)
    fin = res.final_state
    assert fin.n_bodies == 8 and res.pos.shape == (2, 8, 3)
    assert fin.alive.tolist() == [False, False, True, True, True, True, False, False]
    np.testing.assert_array_equal(fin.alive.numpy(), np.asarray(ref.final_state.alive))
    assert float(fin.mass.sum()) == pytest.approx(7.0, rel=1e-14)
    m, v = fin.mass.numpy(), fin.vel.numpy()
    np.testing.assert_allclose((m[:, None] * v).sum(0)[0], 2 * 500.0 - 3 * 500.0, rtol=1e-9)
    for f in ("pos", "vel", "mass", "alive"):
        assert torch.equal(getattr(fin, f), getattr(again.final_state, f)), f


def test_resolve_routing(monkeypatch):
    """CUDA device names route the mark to the kernel's wrapper with the
    count; CPU ones to the row blocks. Resolve runs under every stepper (no
    item left unported)."""
    calls = []
    monkeypatch.setattr(cuda_collisions, "contact_marks_cuda",
                        lambda pos, radius, alive, contacts=None: calls.append(contacts))
    I.resolve_marks_fn(8, "cuda")(None, None, None, "count")
    assert calls == ["count"]
    monkeypatch.setattr(tcoll, "contact_marks_chunked", lambda *a, chunk: ("rows", chunk))
    assert I.resolve_marks_fn(8192, "cpu")(None, None, None, None) == ("rows", 1024)
    pos, vel, mass, radius = _absorb_cluster(n=16)
    st = tot.make_state(pos, vel, mass, radius, device="cpu")
    for integrator in ("euler", "rk4", "yoshida4"):
        cfg = tot.SimConfig(dt=2e-2, G=1e-3, eps2=1e-4, collisions="resolve",
                            integrator=integrator)
        fin, _ = tot.rollout(tot.init_forces(st, cfg), cfg, 16)
        assert bool(torch.isfinite(fin.pos).all()) and int((~fin.alive).sum()) >= 1


@pytest.mark.parametrize("n", [1, 255, 4096, 5000, 65536])
def test_sweep_plan_covers_each_pair_once(n):
    """The contact sweep's tile walk (mirrored from csrc/collision_roots.cu)
    covers every tile (bi, bj), bi <= bj, exactly once, so each pair i < j is
    swept once; each warp's tiles are in order, and the warps' counts differ
    by at most one (132 SMs x 8 blocks x 4 warps, and fewer)."""
    nb = -(-n // cuda_collisions.SWEEP_TILE)
    want = {(bi, bj) for bi in range(nb) for bj in range(bi, nb)}
    for warps in (1, 7, 4224):
        plan = cuda_collisions.sweep_plan(n, warps)
        seen = [t for tiles in plan for t in tiles]
        assert len(seen) == len(want) and set(seen) == want
        counts = [len(t) for t in plan]
        assert max(counts) - min(counts) <= 1
        assert all(a < b for tiles in plan for a, b in zip(tiles, tiles[1:]))
