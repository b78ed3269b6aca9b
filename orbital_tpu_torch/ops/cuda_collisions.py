"""The hand-written CUDA bounce sweep (``csrc/collisions.cu``) and merge
root search (``csrc/collision_roots.cu``).

Replaces ``orbital_tpu/ops/pallas_collisions.py::_collision_kernel`` behind
``bounce_deltas_pallas``, with the same contract: (pos, vel, mass, radius,
alive) in, (dpos [N, 3], dvel [N, 3]) out in f32, to be added to the state,
dead rows exactly 0.

The kernel is arithmetic-bound and nearly all of its work is the r2
rejection test (see the note at the top of the source). It also takes the
contact count that the detecting force sweep (``cuda_forces.
pairwise_acc_detect_cuda``) left on the device: with a count of 0 every
block writes zeros and returns at entry, which is how the stepper skips the
O(N^2) sweep on contact-free steps without reading the count on the host.

For CPU tensors the wrapper computes the plain version,
:func:`bounce_deltas_plain` (``ops.collisions.bounce_deltas_chunked``, gated
by the same count). For CUDA tensors it launches the kernel or raises; it
never falls back. ``bounce_deltas_cuda.launches`` counts kernel launches.

The contact sweep of merge and resolve (``csrc/collision_roots.cu``, one
tiled template with two modes) stands in for the JAX module's XLA blocks:
merge's root search (:func:`collision_roots_cuda`, for
``orbital_tpu/ops/collisions.py:165-196``) writes each column's parent, the
smallest touching row below it, and the wrapper jumps the pointers in eager
torch; resolve's contact mark (:func:`contact_marks_cuda`, for ``i_block``
at :452-464) marks every body that touches another. Both are gated by the
same device-held contact count (the identity, or no marks, at a count of 0).
Their plain versions, :func:`collision_parents_plain` (and
:func:`collision_roots_plain`) and :func:`contact_marks_plain`, are the
blocked torch sweeps, gated alike; ``collision_roots_cuda.launches`` and
``contact_marks_cuda.launches`` count kernel launches. :func:`sweep_plan`
mirrors the kernel's walk over its tiles.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .collisions import (bounce_deltas_chunked, collision_parents_chunked, contact_marks_chunked,
                         pointer_jump, restitution_clip)

__all__ = ["bounce_deltas_cuda", "bounce_deltas_plain", "collision_roots_cuda",
           "collision_roots_plain", "collision_parents_cuda", "collision_parents_plain",
           "contact_marks_cuda", "contact_marks_plain", "sweep_plan", "SWEEP_TILE"]

# the contact sweep's tile, rows and columns (csrc/collision_roots.cu: kTile)
SWEEP_TILE = 128

_lib = None
_roots_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("collisions")
        lib.bounce_deltas.restype = ctypes.c_int
        lib.bounce_deltas.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int])
        _lib = lib
    return _lib


def bounce_deltas_plain(pos, vel, mass, radius, alive=None, *, restitution: float = 1.0,
                        contacts: Optional[torch.Tensor] = None, chunk: int = 1024):
    """The plain PyTorch version of the kernel, on any device: the chunked
    sweep, and exact zeros where a given ``contacts`` count is 0."""
    dpos, dvel = bounce_deltas_chunked(pos, vel, mass, radius, alive,
                                       restitution=restitution, chunk=chunk)
    if contacts is not None:
        hit = contacts > 0
        dpos = torch.where(hit, dpos, torch.zeros_like(dpos))
        dvel = torch.where(hit, dvel, torch.zeros_like(dvel))
    return dpos, dvel


def bounce_deltas_cuda(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    restitution: float = 1.0,
    contacts: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled bounce sweep: (dpos [N, 3], dvel [N, 3]). With ``contacts``
    (an int32 0-dim tensor on the same device), the kernel writes zeros and
    skips the sweep when it is 0."""
    if pos.device.type == "cpu":
        return bounce_deltas_plain(pos, vel, mass, radius, alive,
                                   restitution=restitution, contacts=contacts)
    if pos.device.type != "cuda":
        raise ValueError(f"bounce_deltas_cuda: unsupported device {pos.device}")
    n = pos.shape[0]
    if pos.ndim != 2 or pos.shape[1] != 3 or vel.shape != pos.shape \
            or mass.shape != pos.shape[:1] or radius.shape != pos.shape[:1]:
        raise ValueError("bounce_deltas_cuda: need pos, vel [N, 3] and mass, radius [N]")
    tensors = [vel, mass, radius] + [t for t in (alive, contacts) if t is not None]
    if any(t.device != pos.device for t in tensors):
        raise ValueError("bounce_deltas_cuda: all tensors must be on one device")
    if contacts is not None and (contacts.dtype != torch.int32 or contacts.numel() != 1):
        raise TypeError("bounce_deltas_cuda: contacts must be one int32")
    if alive is not None and alive.dtype != torch.bool:
        raise TypeError("bounce_deltas_cuda: alive must be bool")
    # the kernel reads the state's own f32 arrays; these are no-ops for a
    # contiguous f32 state, so a gated step queues the launch alone
    f32 = torch.float32
    pos_, vel_, mass_, radius_ = (t.to(f32).contiguous() for t in (pos, vel, mass, radius))
    alive_ = None if alive is None else alive.contiguous()
    dpos = torch.empty((n, 3), dtype=f32, device=pos.device)
    dvel = torch.empty((n, 3), dtype=f32, device=pos.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.bounce_deltas(pos_.data_ptr(), vel_.data_ptr(), mass_.data_ptr(),
                            radius_.data_ptr(),
                            None if alive_ is None else alive_.data_ptr(), n,
                            restitution_clip(restitution),
                            None if contacts is None else contacts.data_ptr(),
                            dpos.data_ptr(), dvel.data_ptr(), stream,
                            pos.device.index or 0)
    check(lib, err, "bounce_deltas launch")
    bounce_deltas_cuda.launches += 1
    return dpos, dvel


bounce_deltas_cuda.launches = 0


def _load_roots():
    global _roots_lib
    if _roots_lib is None:
        from ..utils import kernels

        lib = kernels.load("collision_roots")
        p = ctypes.c_void_p
        for fn in (lib.collision_parents, lib.contact_marks):
            fn.restype = ctypes.c_int
            fn.argtypes = [p, p, p, p, ctypes.c_int, p, p, ctypes.c_int]
        _roots_lib = lib
    return _roots_lib


def sweep_plan(n: int, warps: int) -> list[list[tuple[int, int]]]:
    """The tiles (bi, bj), bi <= bj, that each of ``warps`` warps sweeps at
    n bodies, in its order: the kernel's walk (``advance`` in
    ``csrc/collision_roots.cu``) over the row-tile-major order, warp w
    taking tiles w, w + warps, ... A tile holds the pairs i < j with i in
    rows [128 bi, 128 bi + 128) and j in columns [128 bj, 128 bj + 128)."""
    nb = -(-n // SWEEP_TILE)

    def advance(bi, bj, step):
        bj += step
        while bi < nb and bj >= nb:
            bj -= nb - bi - 1
            bi += 1
        return bi, bj

    plan = []
    for w in range(warps):
        tiles, (bi, bj) = [], advance(0, 0, w)
        while bi < nb:
            tiles.append((bi, bj))
            bi, bj = advance(bi, bj, warps)
        plan.append(tiles)
    return plan


def _sweep_launch(name: str, pos, radius, alive, contacts, out_dtype):
    """Check the inputs of a contact-sweep wrapper and launch the kernel's
    mode ``name`` (the C entry point) into a new [N] tensor."""
    n = pos.shape[0]
    if pos.ndim != 2 or pos.shape[1] != 3 or radius.shape != pos.shape[:1]:
        raise ValueError(f"{name}: need pos [N, 3] and radius [N]")
    tensors = [radius] + [t for t in (alive, contacts) if t is not None]
    if any(t.device != pos.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if contacts is not None and (contacts.dtype != torch.int32 or contacts.numel() != 1):
        raise TypeError(f"{name}: contacts must be one int32")
    if alive is not None and alive.dtype != torch.bool:
        raise TypeError(f"{name}: alive must be bool")
    # the sweep reads the f32 positions, as a float32 state holds them
    f32 = torch.float32
    pos_, radius_ = pos.to(f32).contiguous(), radius.to(f32).contiguous()
    alive_ = None if alive is None else alive.contiguous()
    out = torch.empty((n,), dtype=out_dtype, device=pos.device)
    lib = _load_roots()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = getattr(lib, name)(pos_.data_ptr(), radius_.data_ptr(),
                             None if alive_ is None else alive_.data_ptr(),
                             None if contacts is None else contacts.data_ptr(), n,
                             out.data_ptr(), stream, pos.device.index or 0)
    check(lib, err, f"{name} launch")
    return out


def collision_parents_plain(pos, radius, alive=None, *,
                            contacts: Optional[torch.Tensor] = None, chunk: int = 512):
    """The plain version of the kernel's parents mode, on any device: the
    column-blocked parents, and parent[j] = j where a given ``contacts``
    count is 0."""
    if alive is None:
        alive = torch.ones(pos.shape[:1], dtype=torch.bool, device=pos.device)
    parent = collision_parents_chunked(pos, radius, alive, chunk=chunk)
    if contacts is not None:
        parent = torch.where(contacts > 0, parent,
                             torch.arange(pos.shape[0], device=pos.device))
    return parent


def collision_parents_cuda(pos: torch.Tensor, radius: torch.Tensor,
                           alive: Optional[torch.Tensor] = None, *,
                           contacts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's parents [N] (int64): parent[j] = min(j, min{i < j :
    touching(i, j)}), or j everywhere when ``contacts`` (an int32 0-dim
    tensor on the same device) is 0. CPU tensors take the plain version.
    Each launch adds one to ``collision_roots_cuda.launches``."""
    if pos.device.type == "cpu":
        return collision_parents_plain(pos, radius, alive, contacts=contacts)
    if pos.device.type != "cuda":
        raise ValueError(f"collision_roots_cuda: unsupported device {pos.device}")
    parent = _sweep_launch("collision_parents", pos, radius, alive, contacts, torch.int64)
    collision_roots_cuda.launches += 1
    return parent


def collision_roots_plain(pos, radius, alive=None, *,
                          contacts: Optional[torch.Tensor] = None, chunk: int = 512):
    """Roots of the contact chains from :func:`collision_parents_plain`."""
    return pointer_jump(collision_parents_plain(pos, radius, alive, contacts=contacts,
                                                chunk=chunk))


def collision_roots_cuda(pos: torch.Tensor, radius: torch.Tensor,
                         alive: Optional[torch.Tensor] = None, *,
                         contacts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lowest-index root [N] (int64) of each body's contact chain: the
    kernel's parents, then ceil(log2 N) pointer jumps on the device. With
    ``contacts`` 0 the kernel does no pair work and the roots are the
    identity. CPU tensors take :func:`collision_roots_plain`."""
    if pos.device.type == "cpu":
        return collision_roots_plain(pos, radius, alive, contacts=contacts)
    return pointer_jump(collision_parents_cuda(pos, radius, alive, contacts=contacts))


collision_roots_cuda.launches = 0


def contact_marks_plain(pos, radius, alive=None, *,
                        contacts: Optional[torch.Tensor] = None, chunk: int = 1024):
    """The plain version of the kernel's mark mode, on any device: the
    row-blocked marks (``ops.collisions.contact_marks_chunked``, JAX's
    ``i_block``), and no marks where a given ``contacts`` count is 0."""
    if alive is None:
        alive = torch.ones(pos.shape[:1], dtype=torch.bool, device=pos.device)
    mark = contact_marks_chunked(pos, radius, alive, chunk=chunk)
    if contacts is not None:
        mark = mark & (contacts > 0)
    return mark


def contact_marks_cuda(pos: torch.Tensor, radius: torch.Tensor,
                       alive: Optional[torch.Tensor] = None, *,
                       contacts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's marks [N] (bool): True where a body touches another (the
    sqrt test of ``_pair_geometry``), or none when ``contacts`` (an int32
    0-dim tensor on the same device) is 0. CPU tensors take
    :func:`contact_marks_plain`. Each launch adds one to
    ``contact_marks_cuda.launches``."""
    if pos.device.type == "cpu":
        return contact_marks_plain(pos, radius, alive, contacts=contacts)
    if pos.device.type != "cuda":
        raise ValueError(f"contact_marks_cuda: unsupported device {pos.device}")
    mark = _sweep_launch("contact_marks", pos, radius, alive, contacts, torch.bool)
    contact_marks_cuda.launches += 1
    return mark


contact_marks_cuda.launches = 0
