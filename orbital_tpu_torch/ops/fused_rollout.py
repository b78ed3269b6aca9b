"""Whole-rollout fused kernel: K leapfrog steps in one CUDA launch.

Replaces ``orbital_tpu/ops/fused_rollout.py::_fused_kernel``. The TPU
kernel keeps the whole state resident in VMEM; on the H100 the state lives
in device memory (it does not fit one SM's shared memory) and one
cooperative grid runs the KDK loop with two grid-wide barriers per step:
kick+drift, force sweep, kick (``csrc/fused_rollout.cu``). The step count
is a runtime argument, so no trip count triggers a rebuild.

Semantics are those of ``make_step_fn``'s KDK for f32 and ds32 states with
``collisions='none'`` and eps2 > 0: a(t) is seeded in the kernel from the
positions, dead bodies keep zero acceleration, and the caller refreshes the
acceleration/potential caches afterwards if it needs them
(``engine.rollout.rollout`` does).

For CPU tensors :func:`fused_rollout` runs the plain version (a loop of
the eager KDK step on plain forces, seeded the same way). For CUDA tensors
it launches the kernel or raises; it never falls back.
``fused_rollout.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..engine.state import NBodyState
from ..utils.config import SimConfig
from .cuda_forces import pairwise_acc_plain

__all__ = ["fused_rollout", "fused_rollout_plain", "FUSED_MAX_N"]

FUSED_MAX_N = 32768

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("fused_rollout")
        lib.fused_kdk.restype = ctypes.c_int
        lib.fused_kdk.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
               ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_int])
        _lib = lib
    return _lib


def _validate(state: NBodyState, cfg: SimConfig, steps: int) -> None:
    if cfg.collisions != "none":
        raise ValueError("fused_rollout does not support collisions")
    if cfg.eps2 <= 0.0:
        raise ValueError("fused_rollout requires eps2 > 0")
    if cfg.integrator != "kdk":
        raise ValueError("fused_rollout implements the kdk integrator only")
    if state.n_bodies > FUSED_MAX_N:
        raise ValueError(f"N={state.n_bodies} exceeds FUSED_MAX_N={FUSED_MAX_N}")
    if state.pos.ndim != 2:
        raise ValueError("fused_rollout takes one unbatched state")
    if int(steps) < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def _advance_clock(state: NBodyState, cfg: SimConfig, steps: int, **fields) -> NBodyState:
    return state.replace(time=state.time + cfg.dt * steps,
                         step=state.step + steps, **fields)


def fused_rollout_plain(state: NBodyState, cfg: SimConfig, steps: int) -> NBodyState:
    """The plain PyTorch version: seed a(t) from the positions, then
    ``steps`` eager KDK steps on plain forces. Only positions, velocities,
    their compensation terms and the clock change, as with the kernel."""
    from ..engine.integrators import make_step_fn

    _validate(state, cfg, steps)

    def force_fn(pos, mass, alive):
        return pairwise_acc_plain(pos, mass, alive, G=cfg.G, eps2=cfg.eps2,
                                  with_potential=False, chunk=cfg.chunk)

    step = make_step_fn(cfg, force_fn)
    s = state.replace(acc=force_fn(state.pos, state.mass, state.alive)[0])
    for _ in range(int(steps)):
        s = step(s)
    return _advance_clock(state, cfg, int(steps), pos=s.pos, vel=s.vel,
                          pos_lo=s.pos_lo, vel_lo=s.vel_lo)


def fused_rollout(state: NBodyState, cfg: SimConfig, steps: int) -> NBodyState:
    """Advance ``steps`` KDK steps inside one kernel launch (CUDA tensors) or
    through the plain version (CPU tensors)."""
    if state.device.type == "cpu":
        return fused_rollout_plain(state, cfg, steps)
    if state.device.type != "cuda":
        raise ValueError(f"fused_rollout: unsupported device {state.device}")
    _validate(state, cfg, steps)
    if state.dtype != torch.float32:
        raise TypeError(f"fused_rollout needs an f32 or ds32 state, got {state.dtype}")
    steps = int(steps)
    n = state.n_bodies
    ds = state.is_ds

    def rows(x):  # [N, 3] -> fresh contiguous [3, N] (the kernel updates it in place)
        return x.t().contiguous()

    pos_hi, vel_hi = rows(state.pos), rows(state.vel)
    pos_lo = rows(state.pos_lo) if ds else torch.zeros_like(pos_hi)
    vel_lo = rows(state.vel_lo) if ds else torch.zeros_like(vel_hi)
    keep = state.alive.to(torch.float32).contiguous()
    mass = (state.mass * keep).contiguous()
    acc = torch.empty_like(pos_hi)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.fused_kdk(pos_hi.data_ptr(), pos_lo.data_ptr(), vel_hi.data_ptr(),
                        vel_lo.data_ptr(), acc.data_ptr(), mass.data_ptr(),
                        keep.data_ptr(), n, steps, float(cfg.dt),
                        float(0.5 * cfg.dt), float(cfg.G), float(cfg.eps2),
                        int(ds), stream, state.device.index or 0)
    check(lib, err, "fused_kdk launch")
    fused_rollout.launches += 1

    fields = dict(pos=pos_hi.t().contiguous(), vel=vel_hi.t().contiguous())
    if ds:
        fields.update(pos_lo=pos_lo.t().contiguous(), vel_lo=vel_lo.t().contiguous())
    return _advance_clock(state, cfg, steps, **fields)


fused_rollout.launches = 0
