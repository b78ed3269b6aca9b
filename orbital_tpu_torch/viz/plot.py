"""Offline matplotlib orbit plots.

Capability parity with the reference's ``plot_orbits`` (core/plot.py:15-141):
plane projection, stride/last-k subsampling, combined or per-body subplots,
velocity arrows, mass-weighted barycenter marker and trail, equal axes,
save/show. Works against anything with ``.objects`` and ``.history``
(the engine facade or the lightweight view used by the video renderer) and
against device-recorded :class:`~orbital_tpu_torch.engine.rollout.Trajectory`
buffers via :func:`plot_trajectory` — one host copy of the records, not
per-step Python state. Host code in numpy; matplotlib is imported inside
the functions that draw.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["plot_orbits", "plot_trajectory"]

_PLANES = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}


def _numpy(x, dtype=None) -> np.ndarray:
    """A host array of a tensor on any device, or of an array-like."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _axes_grid(plt, n: int, separate: bool):
    if separate:
        cols = 2 if n > 1 else 1
        rows = int(np.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 5 * rows))
        return fig, np.atleast_1d(axes).ravel()
    fig, ax = plt.subplots(figsize=(8, 8))
    return fig, np.array([ax])


def _plot_core(
    plt, trajs, names, masses, velocities, plane, every_n, last_k, separate,
    with_velocity, equal_axes, labels, alpha, linewidth, markersize,
    show_barycenter, barycenter_trail, bary_marker, bary_size,
):
    ix, iy = _PLANES[plane]
    n_bodies = len(trajs)
    fig, axes = _axes_grid(plt, n_bodies, separate)

    # common truncation/subsampling
    T = min(len(t) for t in trajs) if trajs else 0
    sl = slice(None if last_k is None else -int(last_k), None)
    step = max(1, int(every_n))
    trajs = [np.asarray(t, float)[:T][sl][::step] for t in trajs]

    target_axes = axes if separate else [axes[0]] * n_bodies
    for k, (traj, name, ax) in enumerate(zip(trajs, names, target_axes)):
        if traj.shape[0] == 0:
            continue
        x, y = traj[:, ix], traj[:, iy]
        label = f"{name} (m={masses[k]:.2e})" if labels else None
        ax.plot(x, y, alpha=alpha, linewidth=linewidth, label=label)
        ax.scatter([x[-1]], [y[-1]], s=markersize, marker="o")
        if with_velocity and velocities is not None:
            vx, vy = velocities[k][ix], velocities[k][iy]
            vnorm = float(np.hypot(vx, vy)) + 1e-12
            span = max(np.ptp(x), np.ptp(y), 1.0)
            L = 0.05 * span
            ax.arrow(x[-1], y[-1], L * vx / vnorm, L * vy / vnorm,
                     head_width=0.08 * L, length_includes_head=True,
                     linewidth=1.0)
        ax.set_xlabel(plane[0])
        ax.set_ylabel(plane[1])
        ax.grid(True, alpha=0.2)
        if equal_axes:
            ax.set_aspect("equal", adjustable="datalim")

    if show_barycenter and trajs and trajs[0].shape[0] > 0:
        m = np.asarray(masses, float)
        stack = np.stack(trajs, axis=0)  # [B, T', 3]
        # NaN records mark dead bodies (far-parked; see plot_trajectory) —
        # weight each record's barycenter over its finite entries only
        fin = np.isfinite(stack).all(axis=-1)          # [B, T']
        w = m[:, None] * fin
        num = np.einsum("bt,btk->tk", w, np.nan_to_num(stack))
        rcm = num / np.maximum(w.sum(axis=0), 1e-300)[:, None]
        bx, by = rcm[:, ix], rcm[:, iy]
        for ax in axes:
            if barycenter_trail and len(bx) > 1:
                ax.plot(bx, by, linestyle="--", linewidth=1.2, alpha=0.7,
                        label=("barycenter trail" if labels else None))
            ax.scatter([bx[-1]], [by[-1]], s=bary_size, marker=bary_marker,
                       zorder=5, label=("barycenter" if labels else None))

    if labels:
        for ax in (axes if separate else axes[:1]):
            ax.legend(frameon=False, loc="best")
    axes[0].set_title(f"Orbital Trajectories ({plane}-plane), every {every_n} steps")
    return fig, axes


def plot_orbits(
    engine,
    every_n: int = 1,
    plane: str = "xy",
    separate: bool = False,
    with_velocity: bool = True,
    equal_axes: bool = True,
    labels: bool = True,
    alpha: float = 0.9,
    linewidth: float = 1.5,
    markersize: float = 50,
    last_k: Optional[int] = None,
    savepath: Optional[str] = None,
    show: bool = True,
    show_barycenter: bool = True,
    barycenter_trail: bool = False,
    bary_marker: str = "x",
    bary_size: float = 120,
):
    """Plot per-body trajectories from an engine's recorded history."""
    import matplotlib.pyplot as plt

    if plane not in _PLANES:
        raise ValueError("plane must be one of 'xy', 'xz', 'yz'")
    objs = list(engine.objects)
    trajs = [engine.history[o.uuid] for o in objs]
    names = [o.name for o in objs]
    masses = [o.mass for o in objs]
    velocities = [np.asarray(o.velocity, float) for o in objs] if with_velocity else None

    fig, axes = _plot_core(
        plt, trajs, names, masses, velocities, plane, every_n, last_k,
        separate, with_velocity, equal_axes, labels, alpha, linewidth,
        markersize, show_barycenter, barycenter_trail, bary_marker, bary_size,
    )
    if savepath:
        fig.savefig(savepath, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return fig, axes


def plot_trajectory(
    traj,
    names: Optional[list[str]] = None,
    masses: Optional[np.ndarray] = None,
    length_scale: float = 1.0,
    **kwargs,
):
    """Plot a device-recorded Trajectory ([R, N, 3] positions) directly.

    ``length_scale`` converts internal units back to physical ones (pass
    ``engine.rescale.length`` when the state was rescaled).
    """
    import matplotlib.pyplot as plt

    pos = _numpy(traj.pos, float) * length_scale  # [R, N, 3]
    n = pos.shape[1]
    # dead/padding bodies are parked at far positions (see
    # engine.state.far_positions) — NaN them out per record so trails stop
    # at the merge and axis limits stay on the live scene
    if hasattr(traj, "alive") and traj.alive is not None:
        alive = _numpy(traj.alive, bool)  # [R, N]
        pos = np.where(alive[:, :, None], pos, np.nan)
        keep = alive.any(axis=0)              # drop never-alive padding rows
        pos = pos[:, keep]
        n = pos.shape[1]
        if names is not None:
            names = [nm for nm, k in zip(names, keep) if k]
        if masses is not None:
            masses = _numpy(masses, float)[keep]
    names = names or [f"body{i}" for i in range(n)]
    masses = _numpy(masses, float) if masses is not None else np.ones(n)
    trajs = [pos[:, i, :] for i in range(n)]
    vel = _numpy(traj.vel, float)[-1] if hasattr(traj, "vel") else None
    velocities = [vel[i] for i in range(n)] if vel is not None else None

    plane = kwargs.pop("plane", "xy")
    if plane not in _PLANES:
        raise ValueError("plane must be one of 'xy', 'xz', 'yz'")
    savepath = kwargs.pop("savepath", None)
    show = kwargs.pop("show", True)
    fig, axes = _plot_core(
        plt, trajs, names, masses, velocities, plane,
        kwargs.pop("every_n", 1), kwargs.pop("last_k", None),
        kwargs.pop("separate", False), kwargs.pop("with_velocity", False),
        kwargs.pop("equal_axes", True), kwargs.pop("labels", True),
        kwargs.pop("alpha", 0.9), kwargs.pop("linewidth", 1.5),
        kwargs.pop("markersize", 50), kwargs.pop("show_barycenter", True),
        kwargs.pop("barycenter_trail", False), kwargs.pop("bary_marker", "x"),
        kwargs.pop("bary_size", 120),
    )
    if savepath:
        fig.savefig(savepath, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return fig, axes
