"""Batched Kepler solver and elements <-> state conversion in torch.

The torch counterparts of the host scene math (``models.kepler.solve_kepler``
and ``models.body.Body.get_state``; reference: core/physics.py:43-71,
core/body.py:184-249) and of ``orbital_tpu.ops.kepler``: a fixed-iteration
Newton solve and the batched perifocal -> inertial rotation, elementwise over
any leading shape on the tensors' own device. They run once a scene (or once
a fit's residual), so they are plain tensor code and not a kernel: useful for
generating Monte-Carlo ensembles of perturbed orbital elements directly on
the device, and for fitting orbital elements (ROADMAP.md queue A item A.11).
"""
from __future__ import annotations

import math

import torch

__all__ = ["solve_kepler", "elements_to_state", "state_to_elements"]

_NEWTON_ITERS = 30  # fixed count; converges quadratically


def _t(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """A tensor of ``x`` (numpy arrays and Python floats keep float64), on
    ``like``'s device and of its dtype when given."""
    if like is None:
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def solve_kepler(M, e) -> torch.Tensor:
    """Solve M = E - e sin E for E, elementwise (elliptic, e in [0, 1)).

    Thirty Newton iterations from the reference's initial guess (E = M for
    e < 0.8, else pi), as ``orbital_tpu.ops.kepler.solve_kepler``: quadratic
    convergence makes the tail iterations free of error, and a fixed count
    reads nothing back from the device.
    """
    M = _t(M)
    e = _t(e, M)
    E = torch.where(e < 0.8, M, torch.full_like(M, math.pi))
    for _ in range(_NEWTON_ITERS):
        f = E - e * torch.sin(E) - M
        fp = 1.0 - e * torch.cos(E)
        E = E - f / fp
    return E


def elements_to_state(a, e, inc, long_node, arg_peri, mean_anom,
                      mu_parent) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Keplerian elements -> (pos [..., 3], vel [..., 3]).

    All angles in radians, ``a`` in length units consistent with
    ``mu_parent`` (GM of the central body). Same construction as the
    reference (core/body.py:184-249): perifocal state from the eccentric
    anomaly, then R = Rz(Omega) Rx(i) Rz(omega).
    """
    a = _t(a)
    e, inc, long_node, arg_peri, mean_anom, mu_parent = (
        _t(x, a) for x in (e, inc, long_node, arg_peri, mean_anom, mu_parent))
    E = solve_kepler(mean_anom, e)
    cE, sE = torch.cos(E), torch.sin(E)
    b = a * torch.sqrt(1.0 - e * e)
    n = torch.sqrt(mu_parent / (a * a * a))
    denom = 1.0 - e * cE

    x_op = a * (cE - e)
    y_op = b * sE
    vx_op = -a * n * sE / denom
    vy_op = a * n * torch.sqrt(1.0 - e * e) * cE / denom

    cw, sw = torch.cos(arg_peri), torch.sin(arg_peri)
    ci, si = torch.cos(inc), torch.sin(inc)
    cO, sO = torch.cos(long_node), torch.sin(long_node)
    R11 = cO * cw - sO * sw * ci
    R12 = -cO * sw - sO * cw * ci
    R21 = sO * cw + cO * sw * ci
    R22 = -sO * sw + cO * cw * ci
    R31 = sw * si
    R32 = cw * si

    pos = torch.stack([R11 * x_op + R12 * y_op,
                       R21 * x_op + R22 * y_op,
                       R31 * x_op + R32 * y_op], dim=-1)
    vel = torch.stack([R11 * vx_op + R12 * vy_op,
                       R21 * vx_op + R22 * vy_op,
                       R31 * vx_op + R32 * vy_op], dim=-1)
    return pos, vel


def state_to_elements(pos, vel, mu_parent) -> tuple[torch.Tensor, ...]:
    """Batched (pos [..., 3], vel [..., 3]) -> osculating Keplerian elements.

    The exact inverse of :func:`elements_to_state` for elliptic orbits:
    returns ``(a, e, inc, long_node, arg_peri, mean_anom)`` in the same
    conventions the forward conversion consumes (angles in radians). State
    vectors are relative to the parent (its GM is ``mu_parent``).

    Degenerate-orbit conventions (chosen so that the round trip
    ``elements_to_state(*state_to_elements(r, v, mu))`` reproduces the state
    even in the degenerate cases):
      * equatorial (no node): ``long_node = 0``, the node axis taken as +x;
      * circular (no periapsis): ``arg_peri = 0``, anomalies measured from
        the node axis, so ``mean_anom`` is the mean argument of latitude.

    Elliptic contract: bound orbits only (specific energy < 0). Hyperbolic
    states return a < 0 / e > 1 with the anomaly columns meaningless, the
    same domain restriction as :func:`solve_kepler`. NaN-free.
    """
    pos = _t(pos)
    vel = _t(vel, pos)
    mu = _t(mu_parent, pos)
    tiny = 1e-12

    def zeros(x):
        return torch.zeros_like(x)

    r = torch.linalg.norm(pos, dim=-1)
    v2 = torch.sum(vel * vel, dim=-1)

    # vis-viva 1/a = 2/r - v^2/mu, guarded relative to the 2/r scale
    # (inv_a carries 1/length units; near-parabolic pins to finite |a|)
    inv_a = 2.0 / r - v2 / mu
    floor = tiny * 2.0 / r
    a = 1.0 / torch.where(torch.abs(inv_a) > floor, inv_a, floor)

    # specific angular momentum and eccentricity vector
    h_vec = torch.linalg.cross(pos, vel)
    h = torch.linalg.norm(h_vec, dim=-1)
    h_safe = torch.where(h > 0, h, torch.ones_like(h))
    mu_col = mu[..., None] if mu.ndim else mu
    e_vec = torch.linalg.cross(vel, h_vec) / mu_col - pos / r[..., None]
    e = torch.linalg.norm(e_vec, dim=-1)

    inc = torch.arccos(torch.clamp(h_vec[..., 2] / h_safe, -1.0, 1.0))

    # node vector n = z_hat x h = (-h_y, h_x, 0); equatorial -> +x axis
    n_xy = torch.stack([-h_vec[..., 1], h_vec[..., 0]], dim=-1)
    n_mag = torch.linalg.norm(n_xy, dim=-1)
    node_ok = n_mag > tiny * h_safe
    long_node = torch.where(node_ok, torch.atan2(h_vec[..., 0], -h_vec[..., 1]),
                            zeros(n_mag))
    n_div = torch.where(node_ok, n_mag, torch.ones_like(n_mag))
    nx = torch.where(node_ok, n_xy[..., 0] / n_div, torch.ones_like(n_mag))
    ny = torch.where(node_ok, n_xy[..., 1] / n_div, zeros(n_mag))
    n_hat = torch.stack([nx, ny, zeros(nx)], dim=-1)

    # in-plane basis (x = node axis, y = h x x); periapsis direction
    z_hat = h_vec / h_safe[..., None]
    y_hat = torch.linalg.cross(z_hat, n_hat)
    circ = e <= tiny
    e_safe = torch.where(circ, torch.ones_like(e), e)
    p_hat = torch.where(circ[..., None], n_hat, e_vec / e_safe[..., None])
    arg_peri = torch.where(
        circ, zeros(e),
        torch.atan2(torch.sum(e_vec * y_hat, dim=-1), torch.sum(e_vec * n_hat, dim=-1)))

    # true anomaly from the periapsis axis, then E, then M
    q_hat = torch.linalg.cross(z_hat, p_hat)
    nu = torch.atan2(torch.sum(pos * q_hat, dim=-1), torch.sum(pos * p_hat, dim=-1))
    # E from nu: tan(E/2) = sqrt((1-e)/(1+e)) tan(nu/2), in atan2 form
    ecc_clip = torch.clamp(e, 0.0, 1.0 - 1e-15)
    root = torch.sqrt(torch.clamp(1.0 - ecc_clip * ecc_clip, min=0.0))
    E = torch.atan2(root * torch.sin(nu), ecc_clip + torch.cos(nu))
    two_pi = 2.0 * math.pi
    mean_anom = torch.remainder(E - ecc_clip * torch.sin(E), two_pi)
    return (a, e, inc, torch.remainder(long_node, two_pi),
            torch.remainder(arg_peri, two_pi), mean_anom)
