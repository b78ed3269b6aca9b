"""Orbit determination of the PyTorch port (``orbital_tpu_torch.fitting``)
against the JAX package's (``orbital_tpu/fitting.py``), on the CPU in f64.

Scenes are the JAX package's own (tests/test_fitting.py): the Earth-Moon pair
in SI units observed every 24 one-hour steps, and two planets about a unit
mass observed every 40 steps of 2e-3, with the same perturbed guesses.
Tolerances:
  * the loss and its gradient at the initial guess: rel 1e-9 against
    ``jax.value_and_grad`` of the same loss written from the JAX package's
    public functions (``make_state``, ``init_forces``, ``rollout``,
    ``ops.kepler.elements_to_state``): both are f64 sums of the same terms
    in the same order, apart from libm's last bits;
  * 30-iteration fits (loss histories and fitted parameters): rel 1e-6
    (Adam in two libraries over the same gradients: optax and torch add eps
    to the root of the second moment alike, and the rounding of the update
    differs by ulps);
  * the JAX tests' recovery gates and validation errors, as they are.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.ops.kepler import elements_to_state as j_elements_to_state
from orbital_tpu_torch import fitting
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.utils.kernels import refuse_grad

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

G_SI = 6.6743e-11
LOSS_RTOL, HIST_RTOL = 1e-9, 1e-6


def _em_truth():
    """Earth-Moon circular two-body ICs (tests/test_fitting.py:11-22)."""
    R_ = 3.844e8
    m1, m2 = 5.972e24, 7.348e22
    mu = G_SI * (m1 + m2)
    v2 = np.sqrt(mu / R_) * (m1 / (m1 + m2))
    v1 = -np.sqrt(mu / R_) * (m2 / (m1 + m2))
    pos = np.array([[0.0, 0.0, 0.0], [R_, 0.0, 0.0]])
    vel = np.array([[0.0, v1, 0.0], [0.0, v2, 0.0]])
    return pos, vel, np.array([m1, m2])


def _cfgs(**kw):
    jcfg = jot.SimConfig(**kw)
    return jcfg, tot.SimConfig(**kw)


def _observe(pos, vel, mass, cfg, steps, record_every):
    st = jot.init_forces(jot.make_state(pos, vel, mass, precision="f64"), cfg)
    _, traj = jot.rollout(st, cfg, steps, record_every=record_every)
    return np.asarray(traj.pos)


@pytest.fixture(scope="module")
def em():
    """The Earth-Moon scene, its observations (240 steps, every 24th) and the
    two guesses of the JAX tests (velocity 3% off; primary 10% heavy)."""
    pos, vel, mass = _em_truth()
    jcfg, tcfg = _cfgs(dt=3600.0, G=G_SI, eps2=1e6)
    obs = _observe(pos, vel, mass, jcfg, 240, 24)
    rng = np.random.default_rng(0)
    vel_guess = vel * (1.0 + 0.03 * rng.standard_normal(vel.shape))
    return dict(pos=pos, vel=vel, mass=mass, jcfg=jcfg, tcfg=tcfg, obs=obs,
                vel_guess=vel_guess, mass_guess=mass * np.array([1.10, 1.0]))


_EL_TRUE = dict(a=np.array([1.0, 1.8]), e=np.array([0.05, 0.12]), inc=np.array([0.02, 0.1]),
                long_node=np.array([0.3, 1.1]), arg_peri=np.array([0.7, 2.0]),
                mean_anom=np.array([0.1, 2.5]))
_NAMES = ("a", "e", "inc", "long_node", "arg_peri", "mean_anom")


@pytest.fixture(scope="module")
def planets():
    """Two planets about a unit mass (tests/test_fitting.py:95-123): 400
    steps observed every 40th, central-relative; a and mean_anom off."""
    m_c, m_sat = 1.0, np.array([1e-4, 5e-5])
    jcfg, tcfg = _cfgs(dt=2e-3, G=1.0, eps2=1e-12)
    mu = 1.0 * (m_c + m_sat)
    ps, vs = j_elements_to_state(*(_EL_TRUE[k] for k in _NAMES), mu)
    v_c = -(m_sat[:, None] * np.asarray(vs)).sum(0) / m_c
    pos = np.concatenate([np.zeros((1, 3)), np.asarray(ps)])
    vel = np.concatenate([v_c[None], np.asarray(vs)])
    mass = np.concatenate([[m_c], m_sat])
    st = jot.init_forces(jot.make_state(pos, vel, mass, precision="f64"), jcfg)
    _, traj = jot.rollout(st, jcfg, 400, record_every=40)
    obs = np.asarray(traj.pos[:, 1:] - traj.pos[:, :1])
    guess = {k: v.copy() for k, v in _EL_TRUE.items()}
    guess["a"] = _EL_TRUE["a"] * np.array([1.02, 0.985])
    guess["mean_anom"] = _EL_TRUE["mean_anom"] + np.array([0.03, -0.02])
    return dict(m_c=m_c, m_sat=m_sat, jcfg=jcfg, tcfg=tcfg, obs=obs, guess=guess)


# ---------------------------------------------------------------------------
# the loss and its gradient at the initial guess
# ---------------------------------------------------------------------------

def _jax_ic_loss(obs, record_every, cfg, pos0, vel0, mass0, obs_mask=None):
    """The JAX fit's loss, written from the JAX package's public functions:
    (loss(params), params at the guess)."""
    obs = jnp.asarray(obs)
    w = jnp.ones(obs.shape[:2]) if obs_mask is None else jnp.broadcast_to(
        jnp.asarray(obs_mask), obs.shape[:2])
    pscale = float(np.sqrt(np.mean(pos0 * pos0)))
    vscale = float(np.sqrt(np.mean(vel0 * vel0)))
    mscale = float(np.mean(mass0))
    template = jot.make_state(pos0, vel0, mass0, precision="f64")
    steps = obs.shape[0] * record_every

    def loss(p):
        st = template.replace(
            pos=p["pos_n"] * pscale if "pos_n" in p else template.pos,
            vel=p["vel_n"] * vscale if "vel_n" in p else template.vel,
            mass=(jnp.logaddexp(p["mass_raw"], 0.0) * mscale if "mass_raw" in p
                  else template.mass))
        st = jot.init_forces(st, cfg)
        _, traj = jot.rollout(st, cfg, steps, record_every=record_every, fused="never")
        resid = (traj.pos - obs) * w[..., None]
        return jnp.sum(resid * resid) / jnp.maximum(jnp.sum(w), 1.0)

    y = mass0 / mscale
    params = {"pos_n": jnp.asarray(pos0 / pscale), "vel_n": jnp.asarray(vel0 / vscale),
              "mass_raw": jnp.asarray(y + np.log(-np.expm1(-y)))}
    return loss, params


def _held(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("free,mask", [(("vel",), None), (("mass",), None),
                                       (("pos", "vel", "mass"), [0.0, 1.0])])
def test_ic_loss_and_gradient_match_jax(em, free, mask):
    guess = dict(vel0=em["vel_guess"], mass=em["mass"]) if "vel" in free else \
        dict(vel0=em["vel"], mass=em["mass_guess"])
    loss, params, _ = fitting._ic_problem(em["obs"], 24, em["tcfg"], pos0=em["pos"],
                                          free=free, obs_mask=mask, precision="f64",
                                          device="cpu", **guess)
    val = loss(params)
    grads = torch.autograd.grad(val, list(params.values()))
    jloss, jparams = _jax_ic_loss(em["obs"], 24, em["jcfg"], em["pos"], guess["vel0"],
                                  guess["mass"], mask)
    names = {"pos": "pos_n", "vel": "vel_n", "mass": "mass_raw"}
    jp = {names[f]: jparams[names[f]] for f in free}
    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jp)
    assert float(val.detach()) == pytest.approx(float(jval), rel=LOSS_RTOL) and float(jval) > 0
    for (k, p), g in zip(params.items(), grads):
        _held(p.detach().numpy(), jp[k], 1e-15)
        _held(g.numpy(), jgrad[k], LOSS_RTOL)


def test_elements_loss_and_gradient_match_jax(planets):
    free = ("a", "e", "mean_anom")
    loss, params, _, _ = fitting._elements_problem(
        planets["obs"], 40, planets["tcfg"], central_mass=planets["m_c"],
        sat_masses=planets["m_sat"], elements0=planets["guess"], free=free, obs_mask=None,
        precision="f64", device="cpu")
    val = loss(params)
    grads = torch.autograd.grad(val, list(params.values()))

    el0 = {k: jnp.asarray(planets["guess"][k]) for k in _NAMES}
    m_sat = jnp.asarray(planets["m_sat"])
    mu = jnp.asarray(planets["jcfg"].G * (planets["m_c"] + planets["m_sat"]))
    a_scale = jnp.abs(el0["a"])
    template = jot.make_state(np.zeros((3, 3)), np.zeros((3, 3)),
                              np.concatenate([[planets["m_c"]], planets["m_sat"]]),
                              precision="f64")
    obs = jnp.asarray(planets["obs"])

    def jloss(p):
        el = dict(el0, a=p["a"] * a_scale, e=jax.nn.sigmoid(p["e"]), mean_anom=p["mean_anom"])
        ps, vs = j_elements_to_state(*(el[k] for k in _NAMES), mu)
        v_c = -(m_sat[:, None] * vs).sum(0) / planets["m_c"]
        st = template.replace(pos=jnp.concatenate([jnp.zeros((1, 3)), ps]),
                              vel=jnp.concatenate([v_c[None], vs]))
        st = jot.init_forces(st, planets["jcfg"])
        _, traj = jot.rollout(st, planets["jcfg"], 400, record_every=40, fused="never")
        resid = traj.pos[:, 1:] - traj.pos[:, :1] - obs
        return jnp.sum(resid * resid) / float(obs.shape[0] * obs.shape[1])

    e0 = el0["e"]
    jp = {"a": el0["a"] / a_scale, "e": jnp.log(e0 / (1.0 - e0)), "mean_anom": el0["mean_anom"]}
    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jp)
    assert float(val.detach()) == pytest.approx(float(jval), rel=LOSS_RTOL) and float(jval) > 0
    for (k, p), g in zip(params.items(), grads):
        _held(p.detach().numpy(), jp[k], 1e-15)
        _held(g.numpy(), jgrad[k], LOSS_RTOL)


# ---------------------------------------------------------------------------
# 30-iteration fits against the JAX package's
# ---------------------------------------------------------------------------

def _fits_agree(tres, jres):
    _held(tres.loss_history, jres.loss_history, HIST_RTOL)
    for f in ("pos", "vel", "mass"):
        _held(getattr(tres, f), getattr(jres, f), HIST_RTOL)


@pytest.mark.parametrize("free", [("vel",), ("mass",)])
def test_ic_fit_matches_jax_over_30_iterations(em, free):
    kw = dict(pos0=em["pos"], free=free, iterations=30,
              learning_rate=3e-2 if free == ("vel",) else 5e-2)
    kw.update(dict(vel0=em["vel_guess"], mass=em["mass"]) if free == ("vel",)
              else dict(vel0=em["vel"], mass=em["mass_guess"]))
    jres = jot.fit_initial_conditions(em["obs"], 24, em["jcfg"], **kw)
    tres = tot.fit_initial_conditions(em["obs"], 24, em["tcfg"], device="cpu", **kw)
    _fits_agree(tres, jres)
    assert tres.iterations == 30 and tres.loss_history[-1] < tres.loss_history[0]


def test_elements_fit_matches_jax_over_30_iterations(planets):
    kw = dict(central_mass=planets["m_c"], sat_masses=planets["m_sat"],
              elements0=planets["guess"], free=("a", "mean_anom"), iterations=30,
              learning_rate=2e-2)
    jel, jres = jot.fit_orbital_elements(planets["obs"], 40, planets["jcfg"], **kw)
    tel, tres = tot.fit_orbital_elements(planets["obs"], 40, planets["tcfg"], device="cpu",
                                         **kw)
    _fits_agree(tres, jres)
    for k in _NAMES:
        _held(tel[k], jel[k], HIST_RTOL)


def test_optimizer_factory_matches_optax(em):
    """``optimizer=`` takes a factory of a torch optimizer, the counterpart
    of the optax transformation: plain Adam at a constant rate against
    ``optax.adam(3e-2)``."""
    import optax

    kw = dict(pos0=em["pos"], vel0=em["vel_guess"], mass=em["mass"], iterations=30)
    jres = jot.fit_initial_conditions(em["obs"], 24, em["jcfg"], optimizer=optax.adam(3e-2),
                                      **kw)
    tres = tot.fit_initial_conditions(em["obs"], 24, em["tcfg"], device="cpu",
                                      optimizer=lambda p: torch.optim.Adam(p, lr=3e-2), **kw)
    _fits_agree(tres, jres)


# ---------------------------------------------------------------------------
# the JAX tests' recovery gates and validation errors (tests/test_fitting.py)
# ---------------------------------------------------------------------------

def test_fit_recovers_perturbed_velocity(em):
    res = tot.fit_initial_conditions(em["obs"], 24, em["tcfg"], pos0=em["pos"],
                                     vel0=em["vel_guess"], mass=em["mass"], free=("vel",),
                                     iterations=250, learning_rate=3e-2, device="cpu")
    vel = em["vel"]
    verr0 = np.abs(em["vel_guess"] - vel).max() / np.abs(vel).max()
    verr1 = np.abs(res.vel - vel).max() / np.abs(vel).max()
    assert verr1 < 1e-3 < verr0
    assert res.loss_history[-1] < res.loss_history[0] * 1e-4


def test_fit_recovers_central_mass(em):
    res = tot.fit_initial_conditions(em["obs"], 24, em["tcfg"], pos0=em["pos"], vel0=em["vel"],
                                     mass=em["mass_guess"], free=("mass",), iterations=300,
                                     learning_rate=5e-2, device="cpu")
    assert abs(res.mass[0] - em["mass"][0]) / em["mass"][0] < 1e-3
    assert res.loss_history[-1] < res.loss_history[0] * 1e-3


def test_fit_obs_mask_and_validation(em):
    pos, vel, mass = em["pos"], em["vel"], em["mass"]
    cfg = em["tcfg"]
    obs = _observe(pos, vel, mass, em["jcfg"], 48, 24)
    rng = np.random.default_rng(1)
    vel_guess = vel * (1.0 + 0.02 * rng.standard_normal(vel.shape))
    res = tot.fit_initial_conditions(obs, 24, cfg, pos0=pos, vel0=vel_guess, mass=mass,
                                     free=("vel",), obs_mask=np.array([0.0, 1.0]),
                                     iterations=30, learning_rate=1e-2, device="cpu")
    assert res.loss_history[-1] < res.loss_history[0]
    with pytest.raises(ValueError, match="collisions"):
        tot.fit_initial_conditions(obs, 24, cfg.replace(collisions="bounce"), pos0=pos,
                                   vel0=vel, mass=mass, device="cpu")
    with pytest.raises(ValueError, match="subset"):
        tot.fit_initial_conditions(obs, 24, cfg, pos0=pos, vel0=vel, mass=mass,
                                   free=("spin",), device="cpu")
    with pytest.raises(ValueError, match="ds32"):
        tot.fit_initial_conditions(obs, 24, cfg, pos0=pos, vel0=vel, mass=mass,
                                   precision="ds32", device="cpu")
    with pytest.raises(ValueError, match=r"\[R, N, 3\]"):
        tot.fit_initial_conditions(obs[..., :2], 24, cfg, pos0=pos, vel0=vel, mass=mass,
                                   device="cpu")


def test_fit_orbital_elements_two_planets(planets):
    el_fit, res = tot.fit_orbital_elements(
        planets["obs"], 40, planets["tcfg"], central_mass=planets["m_c"],
        sat_masses=planets["m_sat"], elements0=planets["guess"], free=("a", "mean_anom"),
        iterations=200, learning_rate=2e-2, device="cpu")
    assert np.abs(el_fit["a"] - _EL_TRUE["a"]).max() < 2e-3
    assert np.abs(el_fit["mean_anom"] - _EL_TRUE["mean_anom"]).max() < 5e-3
    assert res.loss_history[-1] < res.loss_history[0] * 1e-3


def test_fit_orbital_elements_validation():
    cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-12)
    obs = np.zeros((2, 1, 3))
    el = dict(a=np.ones(1), e=np.zeros(1) + 0.1, inc=np.zeros(1), long_node=np.zeros(1),
              arg_peri=np.zeros(1), mean_anom=np.zeros(1))
    with pytest.raises(ValueError, match="element names"):
        tot.fit_orbital_elements(obs, 1, cfg, central_mass=1.0, sat_masses=np.ones(1),
                                 elements0=el, free=("velocity",), device="cpu")
    bad = {k: v for k, v in el.items() if k != "e"}
    with pytest.raises(ValueError, match="missing"):
        tot.fit_orbital_elements(obs, 1, cfg, central_mass=1.0, sat_masses=np.ones(1),
                                 elements0=bad, device="cpu")


def test_f32_fit_matches_jax(planets):
    """precision='f32': float32 state (JAX promotes the residual to f64 under
    x64, and so does the port), on the planets in natural units (SI
    magnitudes need f64's range, as the JAX docstring says). f32 rollouts
    in two libraries part by f32 roundings, so this holds to rel 1e-4."""
    kw = dict(central_mass=planets["m_c"], sat_masses=planets["m_sat"],
              elements0=planets["guess"], free=("a", "mean_anom"), iterations=10,
              learning_rate=2e-2, precision="f32")
    jel, jres = jot.fit_orbital_elements(planets["obs"], 40, planets["jcfg"], **kw)
    tel, tres = tot.fit_orbital_elements(planets["obs"], 40, planets["tcfg"], device="cpu",
                                         **kw)
    assert tres.pos.dtype == np.float32 and np.isfinite(tres.loss_history).all()
    _held(tres.loss_history, jres.loss_history, 1e-4)
    for k in ("a", "mean_anom"):
        _held(tel[k], jel[k], 1e-4)


def test_fit_defaults_to_the_card(em):
    """The fit runs on the card unless the caller asks for the CPU; without
    CUDA it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tot.fit_initial_conditions(em["obs"], 24, em["tcfg"], pos0=em["pos"], vel0=em["vel"],
                                   mass=em["mass"])


# ---------------------------------------------------------------------------
# the two repairs fitting needs: kernels refuse autograd, f64 on CUDA is dense
# ---------------------------------------------------------------------------

def test_refuse_grad_raises_on_grad_requiring_inputs():
    x = torch.zeros(4, 3, requires_grad=True)
    y = torch.zeros(4)
    with pytest.raises(RuntimeError, match="no backward pass.*dense route"):
        refuse_grad("pairwise_acc_cuda", x, y)
    refuse_grad("pairwise_acc_cuda", x.detach(), None, y)
    with torch.no_grad():
        refuse_grad("pairwise_acc_cuda", x, y)


def test_cpu_plain_paths_keep_autograd():
    """The wrappers' CPU paths are plain PyTorch and differentiate."""
    from orbital_tpu_torch.ops import cuda_forces

    rng = np.random.default_rng(2)
    pos = torch.tensor(rng.normal(size=(16, 3)), requires_grad=True)
    mass = torch.tensor(rng.uniform(0.5, 1.5, 16))
    acc, U = cuda_forces.pairwise_acc_cuda(pos, mass, G=1.0, eps2=1e-2)
    (g,) = torch.autograd.grad(U, pos)
    # -dU/dx_i = m_i a_i for the softened potential
    np.testing.assert_allclose(-g.numpy(), (mass[:, None] * acc).detach().numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,impl,route", [(64, "auto", "dense"), (4096, "auto", "dense"),
                                          (4097, "auto", "pallas"), (64, "dense", "dense"),
                                          (64, "chunked", "chunked"), (64, "mxu", "mxu"),
                                          (64, "pallas", "pallas"), (64, "tree", "tree")])
def test_f64_on_cuda_takes_the_dense_route_only(n, impl, route):
    """f64 state on CUDA resolves as f32 does, as the JAX package routes it
    (this test asserted the refusal of every route but "dense" before f64
    opened on the card): each policy's route, the kernels computing in f32
    inside and "dense" / "chunked" in f64."""
    cfg = tot.SimConfig(dt=1.0, force_impl=impl)
    dev = torch.device("cuda")
    assert R._resolve_impl(cfg, n, dev) == route
    assert callable(R.resolve_force_fn(cfg, n, dev, torch.float64))
    assert R._resolve_impl(cfg, n, dev) == (
        impl if impl != "auto" else ("dense" if n <= 4096 else "pallas"))


def test_f64_on_cuda_keeps_the_other_resolvers_raising(monkeypatch):
    """The detecting (collision) resolver, Hermite's and RESPA's resolve f64
    state on CUDA (they raised before f64 opened on the card): the dense
    detecting evaluation at N <= 4,096, the acc + jerk evaluation, and
    RESPA's plain near sweep in f64, which the JAX package forces for
    non-f32 state."""
    from orbital_tpu_torch.engine import multirate

    cfg = tot.SimConfig(dt=1.0, eps2=1e-4)
    assert R._resolve_impl(cfg, 64, torch.device("cuda")) == "dense"
    rng = np.random.default_rng(3)
    pos = torch.tensor(rng.normal(size=(64, 3)))
    mass = torch.full((64,), 1.0 / 64, dtype=torch.float64)
    rad = torch.full((64,), 1e-3, dtype=torch.float64)
    alive = torch.ones(64, dtype=torch.bool)
    acc, U, c = R.resolve_force_detect_fn(cfg.replace(collisions="bounce"), 64, "cuda",
                                          torch.float64)(pos, mass, rad, alive)
    assert acc.dtype == torch.float64 and c.dtype == torch.int32
    aj = R.resolve_accel_jerk_fn(cfg.replace(integrator="hermite"), 64, "cuda", torch.float64)
    a, j, _ = aj(pos, torch.zeros_like(pos), mass, alive)
    assert a.dtype == torch.float64 and torch.equal(a, acc)
    calls = []
    monkeypatch.setattr(multirate, "near_acc_slots", lambda *a, **k: calls.append(k["i0"]))
    multirate._resolve_sweep(cfg, torch.float64, "cuda")(None, None, None, None, {"jbl": None})
    assert calls == [None]
