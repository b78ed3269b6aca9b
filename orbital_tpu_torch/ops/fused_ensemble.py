"""Batched whole-rollout kernel: K leapfrog steps of E independent systems in
one CUDA launch.

Replaces no Pallas kernel: it stands in for the XLA code of the JAX
package's ensemble rollout (``orbital_tpu/parallel/ensemble.py:53-69``,
``jax.vmap`` over the dense stepper with ``fused="never"``). One block a
member keeps the member's state on chip for all K steps
(``csrc/fused_ensemble.cu``); members are independent, so the launch needs
no grid-wide barrier. At N <= 32 a lane owns a body, its state in
registers, and sweeps a double-buffered table with one barrier a step. It
seeds a(t) from the positions, as ``fused_rollout_plain`` does, and closes
with each member's acceleration and softened potential from the last
evaluation; with K = 0 it only evaluates them.

Semantics are those of ``make_step_fn``'s KDK for a batched state
([E, N, 3], [E, N], time and step [E]) with ``collisions='none'`` and
eps2 > 0, on the dense force formula of ``ops.forces``.

For CPU tensors :func:`fused_ensemble` runs the plain version
:func:`fused_ensemble_plain` (any precision, f64 included). For CUDA
tensors it launches the kernel (f32 and ds32 state, N <= ENSEMBLE_MAX_N) or
raises; it never falls back. ``fused_ensemble.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..engine.state import NBodyState
from ..utils.config import SimConfig
from ..utils.kernels import refuse_grad
from .forces import _masked_inverse_r

__all__ = ["fused_ensemble", "fused_ensemble_plain", "ensemble_acc_potential_plain",
           "ENSEMBLE_MAX_N"]

# the largest N the kernel takes: a member's state, 68 bytes a body, in the
# 227 KB of shared memory a block can use (csrc/fused_ensemble.cu kMaxN)
ENSEMBLE_MAX_N = 3072

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("fused_ensemble")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_ensemble.restype = ctypes.c_int
        lib.fused_ensemble.argtypes = [p] * 9 + [i, i, i, f, f, f, f, i, p, i]
        lib.fused_ensemble_shape.restype = None
        lib.fused_ensemble_shape.argtypes = [i, p]
        _lib = lib
    return _lib


def _validate(states: NBodyState, cfg: SimConfig, steps: int) -> None:
    if cfg.integrator != "kdk":
        raise ValueError("fused_ensemble implements the kdk integrator only")
    if cfg.collisions != "none":
        raise ValueError("fused_ensemble does not support collisions")
    if cfg.eps2 <= 0.0:
        raise ValueError("fused_ensemble requires eps2 > 0")
    if states.pos.ndim != 3:
        raise ValueError("fused_ensemble takes a batched state ([E, N, 3] positions)")
    if states.n_bodies > ENSEMBLE_MAX_N:
        raise ValueError(f"N={states.n_bodies} exceeds ENSEMBLE_MAX_N={ENSEMBLE_MAX_N}")
    if int(steps) < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def ensemble_acc_potential_plain(pos: torch.Tensor, mass: torch.Tensor,
                                 alive: torch.Tensor, *, G: float, eps2: float
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Softened O(N^2) accelerations [E, N, 3] and potentials [E] of E
    systems: the pair formula of ``ops.forces._block_acc_potential`` with the
    batch axis written out as [E, N, N] broadcasts."""
    n = pos.shape[-2]
    mass_eff = mass * alive.to(mass.dtype)
    dx = pos[..., None, :, 0] - pos[..., :, None, 0]  # [E, i, j]: r_j - r_i
    dy = pos[..., None, :, 1] - pos[..., :, None, 1]
    dz = pos[..., None, :, 2] - pos[..., :, None, 2]
    r2 = dx * dx + dy * dy + dz * dz
    mask = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    inv_r = _masked_inverse_r(r2, mask, eps2)
    inv_r3 = inv_r * inv_r * inv_r
    w = mass_eff[..., None, :] * inv_r3
    ax = torch.sum(w * dx, dim=-1)
    ay = torch.sum(w * dy, dim=-1)
    az = torch.sum(w * dz, dim=-1)
    pe_row = torch.sum(mass_eff[..., None, :] * inv_r, dim=-1)
    acc = G * torch.stack([ax, ay, az], dim=-1) * alive[..., None].to(pos.dtype)
    U = -0.5 * G * torch.sum(mass_eff * pe_row, dim=-1)
    return acc, U


def fused_ensemble_plain(states: NBodyState, cfg: SimConfig, steps: int) -> NBodyState:
    """The plain PyTorch version: seed a(t) and U from the positions, then
    ``steps`` eager KDK steps (``make_step_fn``'s, the ds32 kicks and drifts
    through ``_accumulate``) on :func:`ensemble_acc_potential_plain`."""
    from ..engine.integrators import make_step_fn

    _validate(states, cfg, steps)

    def force_fn(pos, mass, alive):
        return ensemble_acc_potential_plain(pos, mass, alive, G=cfg.G, eps2=cfg.eps2)

    step = make_step_fn(cfg, force_fn)
    acc, potential = force_fn(states.pos, states.mass, states.alive)
    s = states.replace(acc=acc, potential=potential)
    for _ in range(int(steps)):
        s = step(s)
    return s


def fused_ensemble(states: NBodyState, cfg: SimConfig, steps: int) -> NBodyState:
    """Advance every member of a batched state ``steps`` KDK steps inside one
    kernel launch (CUDA tensors) or through the plain version (CPU tensors).
    The result carries the last evaluation's acc and potential."""
    if states.device.type == "cpu":
        return fused_ensemble_plain(states, cfg, steps)
    if states.device.type != "cuda":
        raise ValueError(f"fused_ensemble: unsupported device {states.device}")
    refuse_grad("fused_ensemble", states.pos, states.vel, states.mass, states.pos_lo,
                states.vel_lo)
    _validate(states, cfg, steps)
    if states.dtype != torch.float32:
        raise TypeError(f"fused_ensemble needs an f32 or ds32 state, got {states.dtype}")
    steps = int(steps)
    e, n = states.pos.shape[0], states.n_bodies
    if (states.mass.shape != (e, n) or states.alive.shape != (e, n)
            or states.time.shape != (e,)):
        raise ValueError("fused_ensemble: mass and alive must be [E, N] and time [E] "
                         f"for positions {tuple(states.pos.shape)}")
    ds = states.is_ds

    def fresh(x):  # a contiguous f32 copy the kernel updates in place
        return torch.clone(x.to(torch.float32), memory_format=torch.contiguous_format)

    pos, vel = fresh(states.pos), fresh(states.vel)
    pos_lo = fresh(states.pos_lo) if ds else None
    vel_lo = fresh(states.vel_lo) if ds else None
    time = fresh(states.time)
    keep = states.alive.to(torch.float32).contiguous()
    mass = (states.mass.to(torch.float32) * keep).contiguous()
    acc = torch.empty_like(pos)
    potential = torch.empty((e,), dtype=torch.float32, device=states.device)

    from ..utils.kernels import check

    lib = _load()
    dev = states.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_ensemble(pos.data_ptr(), pos_lo.data_ptr() if ds else None,
                             vel.data_ptr(), vel_lo.data_ptr() if ds else None,
                             acc.data_ptr(), potential.data_ptr(), time.data_ptr(),
                             mass.data_ptr(), keep.data_ptr(), e, n, steps, float(cfg.dt),
                             float(0.5 * cfg.dt), float(cfg.G), float(cfg.eps2), int(ds),
                             stream, dev.index or 0)
    check(lib, err, "fused_ensemble launch")
    fused_ensemble.launches += 1
    return states.replace(pos=pos, vel=vel, pos_lo=pos_lo, vel_lo=vel_lo, acc=acc,
                          potential=potential, time=time, step=states.step + steps)


fused_ensemble.launches = 0
