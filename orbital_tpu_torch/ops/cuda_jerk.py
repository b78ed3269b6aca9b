"""The hand-written CUDA acc + jerk sweep (``csrc/nbody_jerk.cu``).

Replaces ``orbital_tpu/ops/pallas_jerk.py::_jerk_kernel`` behind
``accel_jerk_pallas`` and ``accel_jerk_detect_pallas``, with the same
contracts: f32 in, (acc [N, 3], jerk [N, 3], U) out, dead bodies inert, the
potential always computed. :func:`accel_jerk_detect_cuda` also counts
directed touching pairs into an int32 that stays on the device, the gate of
the bounce sweep after a Hermite step; its acc, jerk and U are bit-equal to
:func:`accel_jerk_cuda`'s on the same inputs. :func:`accel_jerk_subset_cuda`
is the row-subset sweep of the block-timestep steppers (``ops.forces.
accel_jerk_subset``'s contract: acc and jerk on F target rows from all N
sources), with an f64 instance for f64 state. On float64 CUDA tensors the
full sweeps compute in float32 inside, as JAX's wrappers do
(``utils.kernels.in_f32``).

The kernel is bound by instruction issue (~30.6 warp instructions and one
MUFU.RSQ a pair; see the note at the top of the source): two i bodies a
thread, the j range split across the 8 warps of a block, the slices' sums
added in a fixed order. The bookkeeping stays here, as in the JAX
wrappers: the alive mask, the analytic self-PE subtraction m_i/eps (the
kernel masks nothing when eps2 > 0) and U = -1/2 G sum m pe. The subset
kernel reads pos, vel, mass and alive in place and adds its j splits on the
device, in a fixed order, in the same launch (:func:`subset_plan` cuts the j
range); its wrapper allocates only the [F, 6] output.

For CPU tensors the wrappers compute the plain versions (``*_plain``): the
chunked forms of ``ops.forces`` plus ``ops.collisions.
count_contacts_chunked`` for the count. For CUDA tensors they launch the
kernel or raise; they never fall back. Each wrapper's ``.launches`` counts
its kernel launches (the subset's f32 instance; ``.f64_launches`` its f64
one).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .collisions import count_contacts_chunked
from .forces import accel_jerk_chunked, accel_jerk_subset
from ..utils.kernels import in_f32, refuse_grad

__all__ = ["accel_jerk_cuda", "accel_jerk_plain", "accel_jerk_detect_cuda",
           "accel_jerk_detect_plain", "accel_jerk_subset_cuda", "accel_jerk_subset_plain",
           "subset_plan"]

# the subset kernel's block: target rows, sources staged a round (the j
# split is a multiple of it), and the SMs its grid should cover
SUBSET_ROWS, SUBSET_TILE, SM_COUNT = 32, 256, 132

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("nbody_jerk")
        p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
        for name, args in (("nbody_jerk", [p, p, i, f, f, p, p, i]),
                           ("nbody_jerk_detect", [p, p, i, f, f, p, p, p, i]),
                           ("nbody_jerk_subset",
                            [p, i, i, p, i, i, p, i, p, i, p, i, i, i, i, f, f, p, p, p, p,
                             i]),
                           ("nbody_jerk_subset_f64",
                            [p, i, i, p, i, i, p, i, p, i, p, i, i, i, i, d, d, p, p, p, p,
                             i])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _launch(name: str, *args) -> None:
    from ..utils.kernels import check

    lib = _load()
    check(lib, getattr(lib, name)(*args), f"{name} launch")


def _check_inputs(fn: str, pos, vel, mass, *others, dtype=torch.float32) -> None:
    if pos.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {pos.device}")
    if pos.dtype != dtype or vel.dtype != dtype:
        raise TypeError(f"{fn} computes in {dtype}, got {pos.dtype} / {vel.dtype}")
    if pos.ndim != 2 or pos.shape[1] != 3 or vel.shape != pos.shape \
            or mass.shape != pos.shape[:1]:
        raise ValueError(f"{fn}: need pos, vel [N, 3] and mass [N], got "
                         f"{tuple(pos.shape)}, {tuple(vel.shape)} and {tuple(mass.shape)}")
    if any(t is not None and t.device != pos.device for t in (vel, mass, *others)):
        raise ValueError(f"{fn}: all tensors must be on one device")


def _pack(pos, vel, mass, alive, radius=None):
    """The kernel's two float4 rows per body, (x, y, z, m_eff) and
    (vx, vy, vz, R_eff), and m_eff in f32."""
    keep = None if alive is None else alive.to(torch.float32)
    mass32 = mass.to(torch.float32) if keep is None else mass.to(torch.float32) * keep
    if radius is None:
        w = torch.zeros_like(mass32)
    else:
        w = radius.to(torch.float32) if keep is None else radius.to(torch.float32) * keep
    pm = torch.cat([pos, mass32[:, None]], dim=1).contiguous()
    vr = torch.cat([vel, w[:, None]], dim=1).contiguous()
    return pm, vr, mass32


def _finish(out, mass32, alive, G: float, eps2: float):
    """(acc, jerk, U) from the kernel's [N, 8] rows: the alive mask, the
    analytic self-term m_i/eps of the mask-free kernel removed from pe."""
    acc, jerk, pe_row = out[:, 0:3], out[:, 3:6], out[:, 6]
    if eps2 > 0.0:
        pe_row = pe_row - mass32 * (1.0 / float(eps2) ** 0.5)
    U = -0.5 * G * torch.sum(mass32 * pe_row)
    if alive is not None:
        keep = alive[:, None].to(torch.float32)
        acc, jerk = acc * keep, jerk * keep
    return acc, jerk, U


def accel_jerk_plain(pos, vel, mass, alive=None, *, G: float, eps2: float,
                     chunk: int = 1024):
    """The plain PyTorch version of the kernel, on any device."""
    return accel_jerk_chunked(pos, vel, mass, alive, G=G, eps2=eps2,
                              chunk=min(chunk, max(pos.shape[0], 1)))


def accel_jerk_cuda(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softened accelerations [N, 3], jerks [N, 3] and total potential U."""
    if pos.device.type == "cpu":
        return accel_jerk_plain(pos, vel, mass, alive, G=G, eps2=eps2)
    if pos.dtype == torch.float64:
        return in_f32(accel_jerk_cuda, pos, vel, mass, alive, G=G, eps2=eps2)
    _check_inputs("accel_jerk_cuda", pos, vel, mass, alive)
    refuse_grad("accel_jerk_cuda", pos, vel, mass)
    n = pos.shape[0]
    pm, vr, mass32 = _pack(pos, vel, mass, alive)
    out = torch.empty((n, 8), dtype=torch.float32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    _launch("nbody_jerk", pm.data_ptr(), vr.data_ptr(), n, float(G), float(eps2),
            out.data_ptr(), stream, pos.device.index or 0)
    accel_jerk_cuda.launches += 1
    return _finish(out, mass32, alive, G, eps2)


accel_jerk_cuda.launches = 0


def accel_jerk_detect_plain(pos, vel, mass, radius, alive, *, G: float, eps2: float,
                            chunk: int = 1024):
    """The plain PyTorch version of the detecting kernel, on any device: the
    chunked sweep and the chunked contact count, as
    ``resolve_accel_jerk_detect_fn`` composes them for ``force_impl="chunked"``."""
    acc, jerk, U = accel_jerk_plain(pos, vel, mass, alive, G=G, eps2=eps2, chunk=chunk)
    contacts = count_contacts_chunked(pos, radius, alive,
                                      chunk=min(chunk, max(pos.shape[0], 1)))
    return acc, jerk, U, contacts


def accel_jerk_detect_cuda(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    alive: torch.Tensor,
    *,
    G: float,
    eps2: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The acc + jerk sweep with contact detection: (acc, jerk, U, contacts),
    ``contacts`` an int32 0-dim tensor on the device counting directed
    touching pairs between live bodies (|r_ij| <= (R_i + R_j) * 1.00001,
    unsoftened). Dead bodies must sit at spread-out far positions, as
    ``make_state`` parks them. acc, jerk and U are bit-equal to
    :func:`accel_jerk_cuda`'s on the same inputs."""
    if pos.device.type == "cpu":
        return accel_jerk_detect_plain(pos, vel, mass, radius, alive, G=G, eps2=eps2)
    if pos.dtype == torch.float64:
        return in_f32(accel_jerk_detect_cuda, pos, vel, mass, radius, alive, G=G, eps2=eps2)
    _check_inputs("accel_jerk_detect_cuda", pos, vel, mass, radius, alive)
    refuse_grad("accel_jerk_detect_cuda", pos, vel, mass, radius)
    n = pos.shape[0]
    pm, vr, mass32 = _pack(pos, vel, mass, alive, radius)
    out = torch.empty((n, 8), dtype=torch.float32, device=pos.device)
    # the kernel counts the n self pairs too: start the counter at -n
    contacts = torch.full((), -n, dtype=torch.int32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    _launch("nbody_jerk_detect", pm.data_ptr(), vr.data_ptr(), n, float(G), float(eps2),
            out.data_ptr(), contacts.data_ptr(), stream, pos.device.index or 0)
    accel_jerk_detect_cuda.launches += 1
    return (*_finish(out, mass32, alive, G, eps2), contacts)


accel_jerk_detect_cuda.launches = 0


def accel_jerk_subset_plain(idx_i, pos, vel, mass, alive=None, *, G: float, eps2: float,
                            chunk: int = 1024):
    """The plain PyTorch version of the subset kernel, on any device:
    ``ops.forces.accel_jerk_subset`` over column blocks."""
    return accel_jerk_subset(idx_i, pos, vel, mass, alive, G=G, eps2=eps2,
                             chunk=min(chunk, max(pos.shape[0], 1)))


def subset_plan(n: int, f: int) -> tuple[int, int]:
    """(splits, split): the subset kernel's j range cut into splits of
    ``split`` sources (a multiple of SUBSET_TILE), as few as cover SM_COUNT
    blocks over the ceil(f / SUBSET_ROWS) row tiles."""
    tiles = -(-f // SUBSET_ROWS)
    want = min(max(1, -(-SM_COUNT // tiles)), -(-n // SUBSET_TILE))
    split = -(-(-(-n // want)) // SUBSET_TILE) * SUBSET_TILE
    return -(-n // split), split


# per device: the subset kernel's split scratch and its row tiles' counters
# (zeros, which each launch leaves zero)
_subset_scratch: dict = {}


def _subset_buffers(dev: torch.device, dtype: torch.dtype, parts: int, tiles: int):
    part, done = _subset_scratch.get((dev, dtype), (None, None))
    if part is None or part.numel() < parts:
        part = torch.empty((max(parts, 1),), dtype=dtype, device=dev)
    if done is None or done.numel() < tiles:
        done = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    _subset_scratch[(dev, dtype)] = (part, done)
    return part, done


def _subset(idx_i, pos, vel, mass, alive, G: float, eps2: float) -> torch.Tensor:
    """Launch the subset kernel's instance of ``pos``'s dtype (float32 or
    float64): [F, 6] rows of (G acc, G jerk) in that dtype."""
    n, f, dev, dt = pos.shape[0], idx_i.shape[0], pos.device, pos.dtype
    out = torch.empty((f, 6), dtype=dt, device=dev)
    splits, split = subset_plan(n, f)
    tiles = -(-f // SUBSET_ROWS)
    part, done = _subset_buffers(dev, dt, f * 6 * splits if splits > 1 else 0, tiles)
    idx = idx_i if idx_i.dtype in (torch.int64, torch.int32) else idx_i.to(torch.int64)
    idx = idx.contiguous()
    live = None if alive is None else (alive if alive.dtype == torch.bool
                                       else alive != 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = "nbody_jerk_subset_f64" if dt == torch.float64 else "nbody_jerk_subset"
    _launch(name, pos.data_ptr(), pos.stride(0), pos.stride(1),
            vel.data_ptr(), vel.stride(0), vel.stride(1), mass.data_ptr(), mass.stride(0),
            None if live is None else live.data_ptr(), 0 if live is None else live.stride(0),
            idx.data_ptr(), int(idx.dtype == torch.int64), f, n, split, float(G),
            float(eps2), part.data_ptr(), done.data_ptr(), out.data_ptr(), stream,
            dev.index or 0)
    return out


def accel_jerk_subset_cuda(
    idx_i: torch.Tensor,
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Acc + jerk [F, 3] on the ``idx_i`` rows from all N bodies (the target
    rows are not alive-masked, as in ``accel_jerk_subset``). Indices out of
    [0, N) are clamped, as a JAX gather clamps them. float64 pos take the
    kernel's f64 instance and return float64, as JAX's XLA subset runs in
    the state's dtype; float32 the f32 one."""
    if pos.device.type == "cpu":
        return accel_jerk_subset_plain(idx_i, pos, vel, mass, alive, G=G, eps2=eps2)
    dt = torch.float64 if pos.dtype == torch.float64 else torch.float32
    _check_inputs("accel_jerk_subset_cuda", pos, vel, mass, alive, idx_i, dtype=dt)
    refuse_grad("accel_jerk_subset_cuda", pos, vel, mass)
    if idx_i.ndim != 1:
        raise ValueError("accel_jerk_subset_cuda: idx_i must be [F]")
    out = _subset(idx_i, pos, vel, mass.to(dt), alive, G, eps2)
    if dt == torch.float64:
        accel_jerk_subset_cuda.f64_launches += 1
    else:
        accel_jerk_subset_cuda.launches += 1
    return out[:, 0:3], out[:, 3:6]


accel_jerk_subset_cuda.launches = 0
accel_jerk_subset_cuda.f64_launches = 0
