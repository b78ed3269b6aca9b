"""Host-side Kepler equation solver (vectorized Newton-Raphson).

Matches the reference solver's semantics (reference: core/physics.py:43-71):
solve M = E - e*sin(E) for the eccentric anomaly E with a Newton iteration,
initial guess E=M for e < 0.8 and E=pi otherwise, tol=1e-12, max_iter=50.

Unlike the reference (scalar ``math``-based loop), this implementation is
vectorized over numpy arrays so an entire element table converts to state
vectors in one shot before being compiled into device state. A batched
torch version lives in ``orbital_tpu_torch.ops.kepler``. A copy of
``orbital_tpu.models.kepler``, so that this package never imports the JAX one.
"""
from __future__ import annotations

import numpy as np

__all__ = ["solve_kepler", "state_to_elements"]


def solve_kepler(M, e, tol: float = 1e-12, max_iter: int = 50):
    """Solve Kepler's equation M = E - e*sin(E) for E (elliptic orbits).

    Args:
        M: mean anomaly in radians (scalar or array).
        e: eccentricity in [0, 1) (scalar or array, broadcastable with M).
        tol: convergence tolerance on the Newton update.
        max_iter: maximum Newton iterations.

    Returns:
        The eccentric anomaly E in radians, same shape as broadcast(M, e).
        Returns a Python float when both inputs are scalars.
    """
    M_arr = np.asarray(M, dtype=np.float64)
    e_arr = np.asarray(e, dtype=np.float64)
    scalar = M_arr.ndim == 0 and e_arr.ndim == 0

    M_b, e_b = np.broadcast_arrays(M_arr, e_arr)
    # Initial guess: E = M for near-circular orbits, pi otherwise
    # (reference: core/physics.py:62).
    E = np.where(e_b < 0.8, M_b, np.pi).astype(np.float64)

    active = np.ones(E.shape, dtype=bool)
    for _ in range(max_iter):
        f = E - e_b * np.sin(E) - M_b
        fp = 1.0 - e_b * np.cos(E)
        dE = -f / fp
        E = np.where(active, E + dE, E)
        active = active & (np.abs(dE) >= tol)
        if not active.any():
            break
    return float(E) if scalar else E


def state_to_elements(pos, vel, mu_parent):
    """(pos [..., 3], vel [..., 3]) -> osculating elements, host/numpy.

    Inverse of ``Body.get_state`` / ``ops.kepler.elements_to_state`` for
    elliptic orbits (the reference only ships the forward direction,
    core/body.py:184-249). Returns ``(a, e, inc, long_node, arg_peri,
    mean_anom)`` — angles in radians, wrapped to [0, 2*pi); ``a`` in the
    length units consistent with ``mu_parent``.

    Degenerate conventions match the device version
    (``ops.kepler.state_to_elements``): equatorial -> long_node = 0 (node
    axis +x); circular -> arg_peri = 0 (mean_anom = mean argument of
    latitude). Vectorized over leading axes; scalar-in, float-out for a
    single state.
    """
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)
    mu = np.asarray(mu_parent, dtype=np.float64)
    scalar = pos.ndim == 1
    if scalar:
        pos, vel = pos[None], vel[None]
    tiny = 1e-12

    r = np.linalg.norm(pos, axis=-1)
    v2 = np.sum(vel * vel, axis=-1)
    # vis-viva, guarded RELATIVE to the 2/r scale (inv_a carries 1/length
    # units; near-parabolic states pin to a huge-but-finite |a|)
    inv_a = 2.0 / r - v2 / mu
    floor = tiny * 2.0 / r
    inv_a_safe = np.where(np.abs(inv_a) > floor, inv_a, floor)
    a = 1.0 / inv_a_safe

    h_vec = np.cross(pos, vel)
    h = np.linalg.norm(h_vec, axis=-1)
    h_safe = np.where(h > 0, h, 1.0)
    mu_col = mu[..., None] if mu.ndim else mu
    e_vec = np.cross(vel, h_vec) / mu_col - pos / r[..., None]
    e = np.linalg.norm(e_vec, axis=-1)

    inc = np.arccos(np.clip(h_vec[..., 2] / h_safe, -1.0, 1.0))

    n_xy = np.stack([-h_vec[..., 1], h_vec[..., 0]], axis=-1)
    n_mag = np.linalg.norm(n_xy, axis=-1)
    node_ok = n_mag > tiny * h_safe
    long_node = np.where(node_ok,
                         np.arctan2(h_vec[..., 0], -h_vec[..., 1]), 0.0)
    n_safe = np.where(node_ok, n_mag, 1.0)
    n_hat = np.stack([np.where(node_ok, n_xy[..., 0] / n_safe, 1.0),
                      np.where(node_ok, n_xy[..., 1] / n_safe, 0.0),
                      np.zeros_like(n_mag)], axis=-1)

    z_hat = h_vec / h_safe[..., None]
    y_hat = np.cross(z_hat, n_hat)
    circ = e <= tiny
    e_safe = np.where(circ, 1.0, e)
    p_hat = np.where(circ[..., None], n_hat, e_vec / e_safe[..., None])
    arg_peri = np.where(circ, 0.0,
                        np.arctan2(np.sum(e_vec * y_hat, axis=-1),
                                   np.sum(e_vec * n_hat, axis=-1)))

    q_hat = np.cross(z_hat, p_hat)
    nu = np.arctan2(np.sum(pos * q_hat, axis=-1),
                    np.sum(pos * p_hat, axis=-1))
    ecc = np.clip(e, 0.0, 1.0 - 1e-15)
    root = np.sqrt(np.maximum(1.0 - ecc * ecc, 0.0))
    E = np.arctan2(root * np.sin(nu), ecc + np.cos(nu))
    mean_anom = np.mod(E - ecc * np.sin(E), 2.0 * np.pi)
    two_pi = 2.0 * np.pi
    out = (a, e, inc, np.mod(long_node, two_pi),
           np.mod(arg_peri, two_pi), mean_anom)
    if scalar:
        return tuple(float(x[0]) for x in out)
    return out
