"""Whole-rollout fused kernel: K leapfrog steps in one CUDA launch.

Replaces ``orbital_tpu/ops/fused_rollout.py::_fused_kernel``. The TPU
kernel keeps the whole state resident in VMEM; on the H100 the state lives
in device memory (it does not fit one SM's shared memory) and one
cooperative grid runs the KDK loop with two grid-wide barriers per step:
kick+drift, force sweep, kick (``csrc/fused_rollout.cu``). The step count
is a runtime argument, so no trip count triggers a rebuild. The sweep is
cut into units of an i tile against a j split so that small N fills the
card; :func:`launch_plan` (pure Python, so the CPU can test it) chooses the
splits and the grid from the kernel's shape and its co-resident blocks.

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
from ..utils.kernels import refuse_grad
from .cuda_forces import pairwise_acc_plain

__all__ = ["fused_rollout", "fused_rollout_plain", "launch_plan", "FUSED_MAX_N"]

FUSED_MAX_N = 32768
# the plan's granule (a warp's rows) and a unit's fixed cost (its i rows'
# loads, the warps' sums through shared memory, the partials' writes),
# counted as j rows a warp sweeps
_GRANULE = 32
_UNIT_ROWS = 64

_lib = None
_shapes: dict = {}


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("fused_rollout")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_kdk.restype = ctypes.c_int
        lib.fused_kdk.argtypes = [p] * 8 + [i, i, f, f, f, f, i, i, i, i, i, p, i]
        lib.fused_kdk_shape.restype = None
        lib.fused_kdk_shape.argtypes = [i, p]
        _lib = lib
    return _lib


def _shape(device: torch.device) -> tuple[int, int, int]:
    """(i bodies a tile, warps a block, co-resident blocks) of the loaded
    kernel on ``device``, asked of the library once per library and device."""
    lib = _load()
    key = (id(lib), device.index or 0)
    if key not in _shapes:
        arr = (ctypes.c_int * 5)()
        with torch.cuda.device(key[1]):
            lib.fused_kdk_shape(0, arr)
        _shapes[key] = (32 * arr[0], arr[1], arr[4])
    return _shapes[key]


def launch_plan(n: int, rows: int, warps: int, resident: int) -> dict:
    """The sweep's cut for n bodies: ``tiles`` i tiles of ``rows`` bodies,
    ``splits`` j splits of ``split_len`` bodies (a multiple of 32), warp
    slices of ``warp_len`` (a multiple of 32, ``warps`` a split), ``units``
    = tiles x splits, and ``grid`` = min(units, resident) blocks. Of the
    split counts that tile [0, n) without an empty split, it takes the one
    with the least critical path, rounds x (warp_len + a unit's fixed cost
    of 64 rows), the fewest splits on a tie: at 4,096 bodies in tiles of 128
    on 132 co-resident blocks, 4 splits (128 units, one round) where 1
    would leave 100 blocks idle."""
    n, rows, warps, resident = int(n), int(rows), int(warps), int(resident)
    if n < 1 or rows < 1 or warps < 1 or resident < 1:
        raise ValueError(f"launch_plan: n={n}, rows={rows}, warps={warps}, "
                         f"resident={resident} must be >= 1")

    def up(x, m):
        return -(-x // m) * m

    tiles = -(-n // rows)
    best = None
    for splits in range(1, -(-n // _GRANULE) + 1):
        split_len = up(-(-n // splits), _GRANULE)
        if -(-n // split_len) != splits:
            continue  # a smaller count cuts the same way
        warp_len = up(-(-split_len // warps), _GRANULE)
        units = tiles * splits
        grid = min(units, resident)
        cost = -(-units // grid) * (warp_len + _UNIT_ROWS)
        if best is None or cost < best[0]:
            best = (cost, dict(tiles=tiles, splits=splits, split_len=split_len,
                               warp_len=warp_len, units=units, grid=grid))
    return best[1]


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
    refuse_grad("fused_rollout", state.pos, state.vel, state.mass, state.pos_lo, state.vel_lo)
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
    _launch(pos_hi, pos_lo, vel_hi, vel_lo, mass, keep, cfg, steps, ds)
    fused_rollout.launches += 1

    fields = dict(pos=pos_hi.t().contiguous(), vel=vel_hi.t().contiguous())
    if ds:
        fields.update(pos_lo=pos_lo.t().contiguous(), vel_lo=vel_lo.t().contiguous())
    return _advance_clock(state, cfg, steps, **fields)


def _launch(pos_hi, pos_lo, vel_hi, vel_lo, mass, keep, cfg: SimConfig, steps: int,
            ds: bool) -> None:
    """One launch of the kernel over the [3, n] tables, in place, on the
    plan of :func:`launch_plan`."""
    n, dev = pos_hi.shape[1], pos_hi.device
    lib = _load()
    from ..utils.kernels import check

    rows_, warps, resident = _shape(dev)
    if resident < 1:
        raise RuntimeError(f"fused_kdk: no co-resident blocks on {dev} (cooperative launch "
                           f"unsupported?)")
    plan = launch_plan(n, rows_, warps, resident)
    acc = torch.empty_like(pos_hi)
    part = torch.empty((plan["splits"], 3, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_kdk(pos_hi.data_ptr(), pos_lo.data_ptr(), vel_hi.data_ptr(),
                        vel_lo.data_ptr(), acc.data_ptr(), part.data_ptr(), mass.data_ptr(),
                        keep.data_ptr(), n, steps, float(cfg.dt), float(0.5 * cfg.dt),
                        float(cfg.G), float(cfg.eps2), int(ds), plan["splits"],
                        plan["split_len"], plan["warp_len"], plan["grid"], stream,
                        dev.index or 0)
    check(lib, err, "fused_kdk launch")


fused_rollout.launches = 0
