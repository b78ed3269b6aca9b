"""Multi-step rollouts with trajectory recording on the device.

The JAX package compiles a rollout into one ``lax.scan``. Here the loop is
Python driving eager steps: no step reads a value back to the host (no
``.item()``, no ``float()``), so the host only queues work, and the strided
snapshots are written into record tensors preallocated on the state's
device. The host gets the records when it asks for them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.collisions import count_contacts_chunked, count_contacts_dense
from ..ops.forces import (accel_jerk_chunked, accel_jerk_dense, accel_jerk_subset,
                          pairwise_acc_chunked, pairwise_acc_dense)
from ..utils.config import SimConfig
from .integrators import (AccelJerkDetectFn, AccelJerkFn, AccelJerkSubsetFn, ForceDetectFn,
                          ForceFn, make_step_fn)
from .state import NBodyState

__all__ = ["Trajectory", "resolve_force_fn", "resolve_force_detect_fn",
           "resolve_accel_jerk_fn", "resolve_accel_jerk_detect_fn",
           "resolve_accel_jerk_subset_fn", "init_forces", "rollout", "init_forces_staged",
           "rollout_staged"]

# Above this body count the dense [N, N] path gives way to the CUDA kernel
# (CUDA tensors) or the row-blocked path (CPU tensors) under "auto".
_DENSE_MAX_N = 4096

# ROADMAP.md queue A items that port the force paths this slice leaves out
_NOT_PORTED = {"ring": "A.15"}


# exact-force policies whose Hermite evaluation is the acc + jerk sweep
# (orbital_tpu/engine/rollout.py:213-219), whatever their kdk force path
_EXACT_IMPLS = ("auto", "pallas", "pallas_sym", "mxu", "pallas_mxu", "ring")


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Strided rollout recording, time-major: [n_records, ...]."""

    pos: torch.Tensor      # [R, N, 3]
    vel: torch.Tensor      # [R, N, 3]
    time: torch.Tensor     # [R]
    energy: torch.Tensor   # [R] kinetic + cached softened potential
    ang_mom: torch.Tensor  # [R, 3]
    alive: torch.Tensor    # [R, N] bool per-record alive mask

    @property
    def n_records(self) -> int:
        return self.pos.shape[0]


def _resolve_impl(cfg: SimConfig, n: int, device: torch.device,
                  dtype: torch.dtype) -> str:
    """``"auto"``: dense at N <= 4096; above it the CUDA kernel ("pallas")
    for CUDA tensors and the row-blocked plain path for CPU tensors."""
    if device.type == "cuda" and dtype == torch.float64:
        raise NotImplementedError(
            "precision='f64' on CUDA: the CUDA kernels compute in float32; "
            "use ds32 on the card and f64 on the CPU")
    impl = cfg.force_impl
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"force_impl={impl!r} is not ported to orbital_tpu_torch yet "
            f"(ROADMAP.md queue A item {_NOT_PORTED[impl]})")
    if impl == "auto":
        if n <= _DENSE_MAX_N:
            return "dense"
        return "pallas" if device.type == "cuda" else "chunked"
    return impl


def resolve_force_fn(cfg: SimConfig, n: int, device: torch.device | str,
                     dtype: torch.dtype = torch.float32) -> ForceFn:
    """Pick the force implementation for a config, body count and device.

    ``"auto"``: dense at N <= 4096; above it the CUDA kernel for CUDA
    tensors and the row-blocked plain path for CPU tensors. ``"pallas"``
    names the exact-force kernel and maps to the CUDA kernel at any N;
    ``"pallas_sym"`` (half-pair, U = 0) and ``"pallas_mxu"`` (Gram) map to
    their CUDA kernels the same way, and ``"mxu"`` to the plain-torch Gram
    form on every device. Each takes its plain version on CPU tensors. The
    kernels are f32, so f64 state on CUDA raises (f64 is the CPU golden
    path).
    ``"tree"`` is ``ops.tree.tree_acc_potential`` with ``tree_near="kernel"``
    (its near sweep the B7 kernel on CUDA tensors); its overflow counter is
    dropped here, so size the budgets first (``simulate()`` probes them).
    ``"pm"`` is ``ops.pm.pm_acc_potential`` and ``"p3m"``
    ``ops.p3m.p3m_acc_potential`` (its short range the CUDA kernel on CUDA
    tensors) on ``cfg.pm_grid`` and the pinned ``cfg.pm_box``; P3M's overflow
    counter is dropped here, so size ``cfg.p3m_capacity`` first
    (``simulate()`` probes it).
    """
    impl = _resolve_impl(cfg, n, torch.device(device), dtype)
    if impl in ("pm", "p3m"):
        box = _box_on(cfg)
        if impl == "pm":
            from ..ops.pm import pm_acc_potential

            return lambda pos, mass, alive: pm_acc_potential(
                pos, mass, alive, G_grav=cfg.G, eps2=cfg.eps2, grid=cfg.pm_grid,
                with_potential=cfg.track_potential, box=box(pos.device))
        from ..ops.p3m import p3m_acc_potential

        def p3m(pos, mass, alive):
            acc, U, _ = p3m_acc_potential(pos, mass, alive, G_grav=cfg.G, eps2=cfg.eps2,
                                          grid=cfg.pm_grid, capacity=cfg.p3m_capacity,
                                          with_potential=cfg.track_potential,
                                          box=box(pos.device))
            return acc, U
        return p3m
    if impl == "tree":
        from ..ops.tree import tree_acc_potential

        kw = _tree_kwargs(cfg, torch.device(device))

        def tree(pos, mass, alive):
            acc, U, _ = tree_acc_potential(pos, mass, alive, **kw)
            return acc, U
        return tree
    if impl == "dense":
        return lambda pos, mass, alive: pairwise_acc_dense(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2)
    if impl == "chunked":
        return lambda pos, mass, alive: pairwise_acc_chunked(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2, chunk=min(cfg.chunk, n))
    if impl == "pallas":
        from ..ops.cuda_forces import pairwise_acc_cuda

        return lambda pos, mass, alive: pairwise_acc_cuda(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2,
            with_potential=cfg.track_potential)
    if impl == "pallas_sym":
        from ..ops.cuda_forces_sym import pairwise_acc_sym_cuda

        return lambda pos, mass, alive: pairwise_acc_sym_cuda(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2)
    if impl == "mxu":
        from ..ops.mxu_forces import pairwise_acc_mxu

        return lambda pos, mass, alive: pairwise_acc_mxu(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2, chunk=min(cfg.chunk, n),
            with_potential=cfg.track_potential)
    if impl == "pallas_mxu":
        from ..ops.cuda_forces_mxu import pairwise_acc_mxu_cuda

        return lambda pos, mass, alive: pairwise_acc_mxu_cuda(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2,
            with_potential=cfg.track_potential)
    raise ValueError(f"unknown force_impl {impl!r}")


def _box_tensors(cfg: SimConfig, device: torch.device):
    """``cfg.pm_box`` as (center [3], half) float32 tensors on ``device``, or
    None."""
    box = cfg.pm_box_arrays()
    if box is not None:
        box = tuple(torch.as_tensor(b, dtype=torch.float32, device=device) for b in box)
    return box


def _box_on(cfg: SimConfig):
    """``device -> _box_tensors(cfg, device)``, made once a device, so that
    an evaluation copies nothing from the host."""
    made = {}

    def on(device: torch.device):
        if device not in made:
            made[device] = _box_tensors(cfg, device)
        return made[device]
    return on


def _tree_kwargs(cfg: SimConfig, device: torch.device) -> dict:
    """``tree_acc_potential``'s keyword arguments for a config, the pinned
    box as tensors on ``device``. Near modes other than "kernel" raise
    naming ROADMAP.md A.13."""
    from ..ops.tree import _check_near

    _check_near(cfg.tree_near)
    box = _box_tensors(cfg, device)
    return dict(G_grav=cfg.G, eps2=cfg.eps2, levels=cfg.tree_levels, ws=cfg.tree_ws,
                order=cfg.tree_order, near=cfg.tree_near, max_chunks=cfg.tree_max_chunks,
                chunk=cfg.tree_chunk, wl_entries=cfg.tree_wl_entries, wl_rj=cfg.tree_wl_rj,
                with_potential=cfg.track_potential, box=box)


def resolve_force_detect_fn(cfg: SimConfig, n: int, device: torch.device | str,
                            dtype: torch.dtype = torch.float32
                            ) -> Optional[ForceDetectFn]:
    """Force evaluation with fused contact detection:
    ``fn(pos, mass, radius, alive) -> (acc, U, contacts)``, ``contacts`` an
    int32 0-dim tensor on the state's device counting directed touching
    pairs (0 exactly when no live bodies overlap). The stepper gates the
    bounce sweep on it without a host read.

    Routed as :func:`resolve_force_fn`: dense forces plus the dense count at
    N <= 4096; above it the detecting CUDA kernel for CUDA tensors and the
    chunked forces plus the chunked count for CPU tensors. Returns None for
    a force path without a detecting variant ("pallas_sym", "mxu",
    "pallas_mxu", "tree", "pm", "p3m"): the stepper then runs the bounce
    sweep ungated, as the JAX package does.
    """
    impl = _resolve_impl(cfg, n, torch.device(device), dtype)
    if impl == "pallas":
        from ..ops.cuda_forces import pairwise_acc_detect_cuda

        return lambda pos, mass, radius, alive: pairwise_acc_detect_cuda(
            pos, mass, radius, alive, G=cfg.G, eps2=cfg.eps2,
            with_potential=cfg.track_potential)
    if impl == "dense":
        def dense(pos, mass, radius, alive):
            acc, U = pairwise_acc_dense(pos, mass, alive, G=cfg.G, eps2=cfg.eps2)
            return acc, U, count_contacts_dense(pos, radius, alive)
        return dense
    if impl == "chunked":
        chunk = min(cfg.chunk, n)

        def chunked(pos, mass, radius, alive):
            acc, U = pairwise_acc_chunked(pos, mass, alive, G=cfg.G, eps2=cfg.eps2,
                                          chunk=chunk)
            return acc, U, count_contacts_chunked(pos, radius, alive, chunk=chunk)
        return chunked
    return None


def _resolve_jerk_impl(cfg: SimConfig, n: int, device: torch.device,
                       dtype: torch.dtype) -> str:
    """The Hermite evaluation's path: "dense", "chunked" or "kernel".
    Every exact-force policy maps to dense at N <= 4096 and above it to the
    CUDA kernel for CUDA tensors, the row-blocked plain path for CPU ones;
    the mesh and tree solvers have no per-pair jerk."""
    if device.type == "cuda" and dtype == torch.float64:
        raise NotImplementedError(
            "precision='f64' on CUDA: the CUDA kernels compute in float32; "
            "use ds32 on the card and f64 on the CPU")
    impl = cfg.force_impl
    if impl in ("pm", "p3m", "tree"):
        raise ValueError(
            "integrator='hermite' needs exact per-pair jerks, which the "
            f"mesh/tree solvers cannot provide; use kdk/euler/rk4 with "
            f"force_impl={impl!r}, or an exact force path for hermite")
    if impl in _EXACT_IMPLS:
        if n <= _DENSE_MAX_N:
            return "dense"
        return "kernel" if device.type == "cuda" else "chunked"
    return impl


def resolve_accel_jerk_fn(cfg: SimConfig, n: int, device: torch.device | str,
                          dtype: torch.dtype = torch.float32) -> AccelJerkFn:
    """The Hermite force evaluation ``fn(pos, vel, mass, alive) -> (acc,
    jerk, U)`` for a body count and device: dense at N <= 4096; above it the
    CUDA acc + jerk kernel for CUDA tensors and the row-blocked plain path
    for CPU tensors (``force_impl="dense"``/``"chunked"`` pick those)."""
    impl = _resolve_jerk_impl(cfg, n, torch.device(device), dtype)
    if impl == "dense":
        return lambda pos, vel, mass, alive: accel_jerk_dense(
            pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2)
    if impl == "chunked":
        return lambda pos, vel, mass, alive: accel_jerk_chunked(
            pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2, chunk=min(cfg.chunk, n))
    from ..ops.cuda_jerk import accel_jerk_cuda

    return lambda pos, vel, mass, alive: accel_jerk_cuda(
        pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2)


def resolve_accel_jerk_detect_fn(cfg: SimConfig, n: int, device: torch.device | str,
                                 dtype: torch.dtype = torch.float32) -> AccelJerkDetectFn:
    """Hermite acc + jerk with fused contact detection:
    ``fn(pos, vel, mass, radius, alive) -> (acc, jerk, U, contacts)``,
    ``contacts`` an int32 0-dim tensor on the state's device. Routed as
    :func:`resolve_accel_jerk_fn`: the detecting kernel for CUDA tensors
    above 4,096 bodies, else the plain sweep plus the plain count at the
    same (predicted) positions."""
    impl = _resolve_jerk_impl(cfg, n, torch.device(device), dtype)
    if impl == "kernel":
        from ..ops.cuda_jerk import accel_jerk_detect_cuda

        return lambda pos, vel, mass, radius, alive: accel_jerk_detect_cuda(
            pos, vel, mass, radius, alive, G=cfg.G, eps2=cfg.eps2)
    aj = resolve_accel_jerk_fn(cfg, n, device, dtype)
    chunk = min(cfg.chunk, n)

    def plain(pos, vel, mass, radius, alive):
        acc, jerk, U = aj(pos, vel, mass, alive)
        if impl == "dense":
            return acc, jerk, U, count_contacts_dense(pos, radius, alive)
        return acc, jerk, U, count_contacts_chunked(pos, radius, alive, chunk=chunk)
    return plain


def resolve_accel_jerk_subset_fn(cfg: SimConfig, n: int, device: torch.device | str,
                                 dtype: torch.dtype = torch.float32) -> AccelJerkSubsetFn:
    """The block steppers' inner evaluation ``fn(idx, pos, vel, mass, alive)
    -> (acc [F, 3], jerk [F, 3])``, which the JAX package calls as plain XLA:
    the CUDA subset kernel where :func:`resolve_accel_jerk_fn` takes the
    kernel, else ``ops.forces.accel_jerk_subset`` (streamed in column blocks
    above 4,096 bodies, as the JAX stepper does)."""
    impl = _resolve_jerk_impl(cfg, n, torch.device(device), dtype)
    if impl == "kernel":
        from ..ops.cuda_jerk import accel_jerk_subset_cuda

        return lambda idx, pos, vel, mass, alive: accel_jerk_subset_cuda(
            idx, pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2)
    chunk = cfg.chunk if n > _DENSE_MAX_N else 0
    return lambda idx, pos, vel, mass, alive: accel_jerk_subset(
        idx, pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2, chunk=chunk)


def _force_fn_for(state: NBodyState, cfg: SimConfig) -> ForceFn:
    return resolve_force_fn(cfg, state.n_bodies, state.device, state.dtype)


def init_forces(state: NBodyState, cfg: SimConfig,
                force_fn: Optional[ForceFn] = None) -> NBodyState:
    """Seed the acceleration cache (the reference does this in the engine
    constructor). Hermite also seeds the jerk cache."""
    if cfg.integrator == "hermite":
        aj = resolve_accel_jerk_fn(cfg, state.n_bodies, state.device, state.dtype)
        acc, jerk, potential = aj(state.pos, state.vel, state.mass, state.alive)
        return state.replace(acc=acc, jerk=jerk, potential=potential)
    fn = force_fn or _force_fn_for(state, cfg)
    acc, potential = fn(state.pos, state.mass, state.alive)
    return state.replace(acc=acc, potential=potential)


def _snapshot(state: NBodyState) -> dict:
    from ..ops import diagnostics as diag

    vel = state.vel_full()
    pos = state.pos_full()
    return dict(
        pos=pos,
        vel=vel,
        time=state.time,
        energy=diag.total_energy(vel, state.mass, state.potential),
        ang_mom=diag.angular_momentum(pos, vel, state.mass),
        alive=state.alive,
    )


def _fused_eligible(state: NBodyState, cfg: SimConfig) -> bool:
    """Route to the whole-rollout CUDA kernel? (kdk, no collisions,
    softened, unbatched f32/ds32 state within FUSED_MAX_N, exact-force
    policy, CUDA tensors)."""
    from ..ops.fused_rollout import FUSED_MAX_N

    return (
        cfg.integrator == "kdk"
        and cfg.collisions == "none"
        and cfg.eps2 > 0.0
        and cfg.force_impl in ("auto", "pallas")
        and state.pos.ndim == 2
        and state.dtype == torch.float32
        and state.n_bodies <= FUSED_MAX_N
        and state.device.type == "cuda"
    )


def rollout(
    state: NBodyState,
    cfg: SimConfig,
    steps: int,
    record_every: int = 0,
    force_fn: Optional[ForceFn] = None,
    fused: str = "auto",
    force_detect_fn: Optional[ForceDetectFn] = None,
    accel_jerk_fn: Optional[AccelJerkFn] = None,
    accel_jerk_detect_fn: Optional[AccelJerkDetectFn] = None,
) -> tuple[NBodyState, Optional[Trajectory]]:
    """Advance ``steps`` steps; optionally record every ``record_every``-th.

    With recording, ``steps`` must divide into records; the snapshot after
    each block of ``record_every`` steps is stored (the initial state is
    not included).

    Unrecorded eligible rollouts route to ``ops.fused_rollout`` (all steps
    inside one kernel launch), then refresh the acceleration/potential
    caches so the final state matches the stepper's. Pass
    ``fused="never"`` to force the step loop.

    With collisions on, the closing force evaluation of kdk, euler, rk4 and
    yoshida4 also counts contacts (``force_detect_fn``, by default
    :func:`resolve_force_detect_fn`'s choice) and the bounce sweep is gated
    on that count on the device.

    Hermite takes its evaluations from ``accel_jerk_fn`` and, with
    collisions on, ``accel_jerk_detect_fn``, by default the
    ``resolve_accel_jerk*_fn`` choices, and the block steppers' subset
    evaluation from :func:`resolve_accel_jerk_subset_fn`; the kdk force
    path is not resolved for it.
    """
    n, dev, dtype = state.n_bodies, state.device, state.dtype
    if cfg.integrator == "hermite":
        collide = cfg.collisions != "none"
        step_fn = make_step_fn(
            cfg, force_fn,
            accel_jerk_fn=accel_jerk_fn or resolve_accel_jerk_fn(cfg, n, dev, dtype),
            accel_jerk_detect_fn=(accel_jerk_detect_fn or resolve_accel_jerk_detect_fn(
                cfg, n, dev, dtype)) if collide else None,
            accel_jerk_subset_fn=resolve_accel_jerk_subset_fn(cfg, n, dev, dtype))
    else:
        fn = force_fn or _force_fn_for(state, cfg)
        if (record_every <= 0 and steps > 0 and fused == "auto"
                and _fused_eligible(state, cfg)):
            from ..ops.fused_rollout import fused_rollout

            final = fused_rollout(state, cfg, steps)
            acc, potential = fn(final.pos, final.mass, final.alive)
            return final.replace(acc=acc, potential=potential), None
        fd = None
        if cfg.collisions != "none":
            fd = force_detect_fn or resolve_force_detect_fn(cfg, n, dev, dtype)
        step_fn = make_step_fn(cfg, fn, force_detect_fn=fd)

    if record_every <= 0:
        for _ in range(steps):
            state = step_fn(state)
        return state, None

    if steps % record_every != 0:
        raise ValueError(f"steps={steps} not divisible by record_every={record_every}")
    n_records = steps // record_every
    first = _snapshot(state)
    records = {k: torch.empty((n_records,) + tuple(v.shape), dtype=v.dtype,
                              device=v.device)
               for k, v in first.items()}
    for r in range(n_records):
        for _ in range(record_every):
            state = step_fn(state)
        for k, v in _snapshot(state).items():
            records[k][r] = v
    return state, Trajectory(**records)


def init_forces_staged(state: NBodyState, cfg: SimConfig) -> NBodyState:
    """:func:`init_forces` through ``ops.tree.tree_acc_potential_staged``,
    the companion of :func:`rollout_staged`."""
    from ..ops.tree import tree_acc_potential_staged

    acc, potential, _ = tree_acc_potential_staged(state.pos, state.mass, state.alive,
                                                  **_tree_kwargs(cfg, state.device))
    return state.replace(acc=acc, potential=potential)


def rollout_staged(state: NBodyState, cfg: SimConfig, steps: int, record_every: int = 0
                   ) -> tuple[NBodyState, Optional[Trajectory], int]:
    """:func:`rollout` on the tree force that keeps the near-field overflow
    of every step, as the JAX package's staged loop does. The running
    maximum stays on the device and is read once, after the last step.
    Returns ``(final, trajectory or None, max overflow)``: 0 means every
    near pair was summed exactly for the whole run.

    Requires ``integrator='kdk'``, ``collisions='none'`` and
    ``force_impl='tree'``; ``simulate()`` routes here at ``tree_levels >= 8``
    and N >= 524,288, the JAX package's thresholds."""
    from ..ops.tree import tree_acc_potential_staged

    if cfg.integrator != "kdk" or cfg.collisions != "none":
        raise ValueError("rollout_staged supports integrator='kdk' with collisions='none'")
    if cfg.force_impl != "tree":
        raise ValueError("rollout_staged is the force_impl='tree' large-N path; use "
                         "rollout() otherwise")
    kw = _tree_kwargs(cfg, state.device)
    worst = torch.zeros((), dtype=torch.int64, device=state.device)

    def keeping(pos, mass, alive):
        nonlocal worst
        acc, U, overflow = tree_acc_potential_staged(pos, mass, alive, **kw)
        worst = torch.maximum(worst, overflow.to(torch.int64))
        return acc, U

    final, traj = rollout(state, cfg, steps, record_every, force_fn=keeping)
    return final, traj, int(worst)
