"""Gradient-based orbit determination through the rollout.

A port of ``orbital_tpu/fitting.py``. The stepper is plain differentiable
tensor code on the dense route, so the whole trajectory is differentiable,
and fitting initial conditions to observations is one loop:

    params -> NBodyState -> rollout -> recorded positions
           -> masked MSE against observations -> torch.optim optimizer

What the port carries over, and what it changes:

  * The math is the JAX module's: scale-normalised parameters, softplus as
    ``logaddexp(x, 0)`` for masses, a logit for the eccentricity, the central
    body's momentum-zeroing counter-velocity, and the masked mean-square loss
    over ``rollout(..., record_every=..., fused="never")`` after
    ``init_forces``.
  * optax's Adam under ``cosine_decay_schedule(lr, iterations)`` becomes
    ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8, eps added to the root
    of the second moment as optax adds it) under a ``LambdaLR`` of the same
    factor 0.5 (1 + cos(pi min(t, T) / T)), stepped once an iteration.
  * The fit runs on ``device`` (the card unless the caller asks for the CPU)
    in f64 or f32. Autograd runs through the plain PyTorch steps of the dense
    route (N <= 4,096 under ``force_impl="auto"``), as the JAX fits take the
    dense XLA route; a CUDA kernel wrapper refuses a grad-requiring input
    (``utils.kernels.refuse_grad``), so a fit on a kernel route raises rather
    than return a wrong gradient. JAX's ``_check_x64`` warning has no
    counterpart: torch keeps f64 whatever the process settings.
  * The loss reads nothing back to the host inside an iteration: the loss
    history stays on the device until the last iteration. On the card the
    loss and its backward run as CUDA graphs (``_graphable``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .engine.engine import engine_device
from .engine.rollout import init_forces, resolve_force_fn, rollout
from .engine.state import make_state
from .utils.config import SimConfig

__all__ = ["FitResult", "fit_initial_conditions", "fit_orbital_elements"]


@dataclass
class FitResult:
    """Outcome of :func:`fit_initial_conditions` (device-free numpy)."""

    pos: np.ndarray          # fitted initial positions [N, 3]
    vel: np.ndarray          # fitted initial velocities [N, 3]
    mass: np.ndarray         # fitted (or pass-through) masses [N]
    loss_history: np.ndarray  # [iters] masked-MSE per iteration
    iterations: int

    @property
    def final_loss(self) -> float:
        return float(self.loss_history[-1])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _softplus_inv(y: torch.Tensor) -> torch.Tensor:
    y = torch.clamp(y, min=1e-30)
    return y + torch.log(-torch.expm1(-y))


def _precision_dtype(precision: str) -> torch.dtype:
    if precision not in ("f32", "f64"):
        raise ValueError("fitting supports precision 'f32' or 'f64' "
                         "(ds32's hi/lo split is not a trainable layout)")
    return torch.float64 if precision == "f64" else torch.float32


def _weights(obs: torch.Tensor, obs_mask) -> torch.Tensor:
    """[R, N] float64 weights: ones, or ``obs_mask`` broadcast to them."""
    shape = tuple(obs.shape[:2])
    if obs_mask is None:
        return torch.ones(shape, dtype=torch.float64, device=obs.device)
    mask = torch.as_tensor(np.asarray(obs_mask), dtype=torch.float64, device=obs.device)
    return torch.broadcast_to(mask, shape)


def _masked_mse(pred: torch.Tensor, obs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    resid = (pred - obs) * weights[..., None]
    return torch.sum(resid * resid) / torch.clamp(torch.sum(weights), min=1.0)


def _graphable(loss_fn: Callable, params: dict, cfg: SimConfig) -> Callable:
    """``loss(*leaves)`` over the parameters in ``params``' order. On CUDA it
    is one CUDA graph of the loss and one of its backward
    (``torch.cuda.make_graphed_callables``, three warm-up passes first): an
    iteration is ~25 k tiny kernels (a few hundred KDK steps of a few
    bodies), which eagerly took 0.42-0.67 s of host launches an iteration on
    an H100 80GB HBM3 at 700 W and replayed as graphs 49-87 ms
    (``chip_smoke.py`` phase 47); the graphs replay the same kernels in the
    same order, so the results are the eager ones. Every stepper but
    the block-timestep Hermite ones (``hermite_fast_cap`` > 0) reads nothing
    back to the host, so those alone run eagerly. The graphs' output is
    overwritten by the next replay."""
    names = list(params)
    leaves = list(params.values())

    def loss(*xs):
        return loss_fn(dict(zip(names, xs)))

    block = cfg.integrator == "hermite" and cfg.hermite_fast_cap > 0
    if leaves[0].device.type != "cuda" or block:
        return loss
    return torch.cuda.make_graphed_callables(loss, tuple(leaves))


def _optimize(loss_fn: Callable, params: dict, iterations: int, learning_rate: float,
              optimizer, cfg: SimConfig) -> np.ndarray:
    """Run the optimizer on ``params`` (leaf tensors, updated in place) and
    return the loss history, each value taken before its iteration's
    update. The history stays on the device until the end."""
    leaves = list(params.values())
    loss = _graphable(loss_fn, params, cfg) if iterations > 0 else None
    if optimizer is None:
        opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        horizon = max(iterations, 1)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, horizon) / horizon)))
    else:
        opt, sched = optimizer(leaves), None
    history = []
    for _ in range(iterations):
        opt.zero_grad(set_to_none=True)
        val = loss(*leaves)
        val.backward()
        opt.step()
        if sched is not None:
            sched.step()
        history.append(val.detach().clone())
    if not history:
        return np.empty(0, np.float64)
    return torch.stack(history).to("cpu", torch.float64).numpy()


def _ic_problem(observations, record_every: int, cfg: SimConfig, *, pos0, vel0, mass,
                free: Sequence[str], obs_mask, precision: str, device):
    """The validated set-up of :func:`fit_initial_conditions`: ``(loss,
    params, fitted)``, ``loss(params)`` the masked MSE (``params`` holds any
    of the leaf tensors ``pos_n``, ``vel_n``, ``mass_raw``, scale-normalized)
    and ``fitted(params) -> (pos, vel, mass)`` as host arrays."""
    if cfg.collisions != "none":
        raise ValueError("fitting requires cfg.collisions='none' "
                         "(contact events are not usefully differentiable)")
    bad = set(free) - {"pos", "vel", "mass"}
    if bad:
        raise ValueError(f"free must be a subset of pos/vel/mass, got {bad}")
    dev = engine_device(device)
    obs = torch.as_tensor(np.array(observations), device=dev)
    if obs.ndim != 3 or obs.shape[-1] != 3:
        raise ValueError(f"observations must be [R, N, 3], got {tuple(obs.shape)}")
    fdt = _precision_dtype(precision)
    weights = _weights(obs, obs_mask)
    steps = obs.shape[0] * record_every

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=fdt, device=dev)

    pos0, vel0, mass0 = tensor(pos0), tensor(vel0), tensor(mass)
    # optimize in scale-normalized units: SI magnitudes (1e8 m, 1e3 m/s,
    # 1e24 kg) would otherwise make any single learning rate nonsense
    pscale = float(torch.sqrt(torch.mean(pos0 * pos0))) or 1.0
    vscale = float(torch.sqrt(torch.mean(vel0 * vel0))) or 1.0
    mscale = float(torch.mean(mass0)) or 1.0

    params = {}
    if "pos" in free:
        params["pos_n"] = (pos0 / pscale).requires_grad_()
    if "vel" in free:
        params["vel_n"] = (vel0 / vscale).requires_grad_()
    if "mass" in free:
        params["mass_raw"] = _softplus_inv(mass0 / mscale).requires_grad_()

    force_fn = resolve_force_fn(cfg, obs.shape[1], dev, fdt)
    template = make_state(pos0.cpu().numpy(), vel0.cpu().numpy(), mass0.cpu().numpy(),
                          precision=precision, device=dev)

    def fields(p: dict):
        pos = p["pos_n"] * pscale if "pos_n" in p else pos0
        vel = p["vel_n"] * vscale if "vel_n" in p else vel0
        mass = _softplus(p["mass_raw"]) * mscale if "mass_raw" in p else mass0
        return pos.to(fdt), vel.to(fdt), mass.to(fdt)

    def loss(p: dict) -> torch.Tensor:
        pos, vel, mass = fields(p)
        st = init_forces(template.replace(pos=pos, vel=vel, mass=mass), cfg, force_fn)
        _, traj = rollout(st, cfg, steps, record_every=record_every, force_fn=force_fn,
                          fused="never")
        return _masked_mse(traj.pos, obs, weights)

    def fitted(p: dict):
        with torch.no_grad():
            return tuple(x.cpu().numpy() for x in fields(p))
    return loss, params, fitted


def fit_initial_conditions(
    observations,
    record_every: int,
    cfg: SimConfig,
    *,
    pos0,
    vel0,
    mass,
    free: Sequence[str] = ("vel",),
    obs_mask=None,
    iterations: int = 200,
    learning_rate: float = 1e-2,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    precision: str = "f64",
    device: torch.device | str = "cuda",
) -> FitResult:
    """Fit initial conditions so the rollout reproduces ``observations``.

    Args:
        observations: [R, N, 3] observed positions; record ``r`` is
            compared against the state after ``(r+1) * record_every``
            steps (the rollout's recording convention: the initial
            state is not a record).
        record_every: steps between observation epochs.
        cfg: simulation config used for the rollout (dt, G, eps2,
            integrator, force_impl...). Collisions are disallowed:
            merge/bounce events are not usefully differentiable.
        pos0 / vel0 / mass: initial guess arrays [N, 3] / [N, 3] / [N].
        free: subset of {"pos", "vel", "mass"} to optimize; everything
            else stays at its guess.
        obs_mask: optional broadcastable-to-[R, N] weight/mask (e.g.
            observe only some bodies or epochs).
        iterations: optimizer steps.
        learning_rate: DIMENSIONLESS Adam learning rate (parameters are
            optimized in units of their initial-guess RMS scale, so 0.02
            means ~2% of the natural scale per step); cosine-decayed to 0
            over ``iterations``. Used when ``optimizer`` is None.
        optimizer: a factory ``params -> torch.optim.Optimizer`` (``params``
            the list of scale-normalized leaf tensors) to use instead, with
            no schedule: the counterpart of the JAX function's optax
            transformation.
        precision: state precision for the fit, "f64" (recommended:
            fitting real-unit scenes needs the range) or "f32".
        device: where the fit runs, the card by default; pass "cpu" for
            the CPU. There is no fallback.

    Returns a :class:`FitResult` with the fitted ICs and loss history.
    """
    loss, params, fitted = _ic_problem(observations, record_every, cfg, pos0=pos0,
                                       vel0=vel0, mass=mass, free=free, obs_mask=obs_mask,
                                       precision=precision, device=device)
    history = _optimize(loss, params, iterations, learning_rate, optimizer, cfg)
    pos_f, vel_f, mass_f = fitted(params)
    return FitResult(pos=pos_f, vel=vel_f, mass=mass_f, loss_history=history,
                     iterations=iterations)


_ELEMENT_NAMES = ("a", "e", "inc", "long_node", "arg_peri", "mean_anom")


def _elements_problem(observations, record_every: int, cfg: SimConfig, *,
                      central_mass: float, sat_masses, elements0: dict,
                      free: Sequence[str], obs_mask, precision: str, device):
    """The validated set-up of :func:`fit_orbital_elements`: ``(loss, params,
    decode, build)``: ``loss(params)`` the masked MSE of the central-relative
    satellite positions, ``decode(name, params)`` an element (optimized or
    not) and ``build(params)`` the initial state: the satellites about a
    central body at the origin, which takes the momentum-zeroing
    counter-velocity."""
    from .ops.kepler import elements_to_state

    if cfg.collisions != "none":
        raise ValueError("fitting requires cfg.collisions='none'")
    bad = set(free) - set(_ELEMENT_NAMES)
    if bad:
        raise ValueError(f"free must be element names, got {bad}")
    missing = set(_ELEMENT_NAMES) - set(elements0)
    if missing:
        raise ValueError(f"elements0 missing {missing}")
    dev = engine_device(device)
    obs = torch.as_tensor(np.array(observations), device=dev)
    fdt = _precision_dtype(precision)
    weights = _weights(obs, obs_mask)
    steps = obs.shape[0] * record_every

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=fdt, device=dev)

    el0 = {k: tensor(elements0[k]) for k in _ELEMENT_NAMES}
    m_sat = tensor(sat_masses)
    mu = tensor(cfg.G * (central_mass + np.asarray(sat_masses)))
    a_scale = torch.clamp(torch.abs(el0["a"]), min=1e-30)

    def enc(name: str) -> torch.Tensor:
        v = el0[name]
        if name == "a":
            return v / a_scale
        if name == "e":
            v = torch.clamp(v, 1e-9, 1.0 - 1e-9)
            return torch.log(v / (1.0 - v))        # logit: e stays in (0, 1)
        return v.clone()                           # angles: raw radians

    def decode(name: str, p: dict) -> torch.Tensor:
        if name not in p:
            return el0[name]
        if name == "a":
            return p[name] * a_scale
        if name == "e":
            return torch.sigmoid(p[name])
        return p[name]

    params = {k: enc(k).requires_grad_() for k in free}
    n = obs.shape[1] + 1
    force_fn = resolve_force_fn(cfg, n, dev, fdt)
    mass_all = np.concatenate([[central_mass], np.asarray(sat_masses)])
    template = make_state(np.zeros((n, 3)), np.zeros((n, 3)), mass_all, precision=precision,
                          device=dev)
    zero = torch.zeros((1, 3), dtype=fdt, device=dev)

    def build(p: dict):
        ps, vs = elements_to_state(*(decode(k, p) for k in _ELEMENT_NAMES), mu)
        v_c = -(m_sat[:, None] * vs).sum(0) / central_mass
        pos = torch.cat([zero, ps.to(fdt)])
        vel = torch.cat([v_c[None].to(fdt), vs.to(fdt)])
        return template.replace(pos=pos, vel=vel)

    def loss(p: dict) -> torch.Tensor:
        st = init_forces(build(p), cfg, force_fn)
        _, traj = rollout(st, cfg, steps, record_every=record_every, force_fn=force_fn,
                          fused="never")
        # observations are central-relative
        return _masked_mse(traj.pos[:, 1:] - traj.pos[:, :1], obs, weights)
    return loss, params, decode, build


def fit_orbital_elements(
    observations,
    record_every: int,
    cfg: SimConfig,
    *,
    central_mass: float,
    sat_masses,
    elements0: dict,
    free: Sequence[str] = ("a", "e", "mean_anom"),
    obs_mask=None,
    iterations: int = 300,
    learning_rate: float = 2e-2,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    precision: str = "f64",
    device: torch.device | str = "cuda",
):
    """Fit Keplerian orbital elements to observed satellite positions.

    Satellites are parameterized by osculating elements about a central
    body at the origin; the differentiable chain is

        elements -> (fixed-iteration Kepler solve, ops/kepler.py)
                 -> state vectors -> N-body rollout -> masked MSE,

    so the gradients account for the full N-body dynamics
    (satellite-satellite perturbations included), not just two-body motion.

    Args:
        observations: [R, S, 3] observed central-relative satellite
            positions (S satellites; the central body is not observed).
        record_every / cfg / obs_mask / iterations / learning_rate /
            optimizer / precision / device: as in
            :func:`fit_initial_conditions` (the learning rate is
            dimensionless; elements are optimized in natural units: a in
            units of its initial guess, e via a logit, angles raw radians).
        central_mass: mass of the central body (pinned at the origin
            with the system's momentum-zeroing velocity).
        sat_masses: [S] satellite masses.
        elements0: dict with "a", "e", "inc", "long_node", "arg_peri",
            "mean_anom" arrays [S] (radians; semi-major axis in the same
            length units as the observations).
        free: subset of element names to optimize.

    Returns (elements dict, FitResult): the FitResult's pos/vel are the
    fitted initial state vectors.
    """
    loss, params, decode, build = _elements_problem(
        observations, record_every, cfg, central_mass=central_mass, sat_masses=sat_masses,
        elements0=elements0, free=free, obs_mask=obs_mask, precision=precision,
        device=device)
    history = _optimize(loss, params, iterations, learning_rate, optimizer, cfg)
    with torch.no_grad():
        el_fit = {k: decode(k, params).cpu().numpy() for k in _ELEMENT_NAMES}
        final = build(params)
    mass_all = np.concatenate([[central_mass], np.asarray(sat_masses)])
    res = FitResult(pos=final.pos.cpu().numpy(), vel=final.vel.cpu().numpy(),
                    mass=mass_all, loss_history=history, iterations=iterations)
    return el_fit, res
