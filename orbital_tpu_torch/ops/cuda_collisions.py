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

The root search of merge mode (:func:`collision_roots_cuda`) stands in for
the JAX module's XLA column blocks (``orbital_tpu/ops/collisions.py:165-196``):
the kernel writes each column's parent, the smallest touching row below it,
gated by the same device-held contact count (parent = j at a count of 0),
and the wrapper jumps the pointers in eager torch. Its plain version,
:func:`collision_roots_plain`, is the column-blocked search, gated alike;
``collision_roots_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .collisions import (bounce_deltas_chunked, collision_parents_chunked, pointer_jump,
                         restitution_clip)

__all__ = ["bounce_deltas_cuda", "bounce_deltas_plain", "collision_roots_cuda",
           "collision_roots_plain", "collision_parents_cuda", "collision_parents_plain"]

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
        lib.collision_parents.restype = ctypes.c_int
        lib.collision_parents.argtypes = [p, p, p, p, ctypes.c_int, p, p, ctypes.c_int]
        _roots_lib = lib
    return _roots_lib


def collision_parents_plain(pos, radius, alive=None, *,
                            contacts: Optional[torch.Tensor] = None, chunk: int = 512):
    """The plain version of the kernel, on any device: the column-blocked
    parents, and parent[j] = j where a given ``contacts`` count is 0."""
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
    n = pos.shape[0]
    if pos.ndim != 2 or pos.shape[1] != 3 or radius.shape != pos.shape[:1]:
        raise ValueError("collision_roots_cuda: need pos [N, 3] and radius [N]")
    tensors = [radius] + [t for t in (alive, contacts) if t is not None]
    if any(t.device != pos.device for t in tensors):
        raise ValueError("collision_roots_cuda: all tensors must be on one device")
    if contacts is not None and (contacts.dtype != torch.int32 or contacts.numel() != 1):
        raise TypeError("collision_roots_cuda: contacts must be one int32")
    if alive is not None and alive.dtype != torch.bool:
        raise TypeError("collision_roots_cuda: alive must be bool")
    # the search reads the f32 positions, as a float32 state holds them
    f32 = torch.float32
    pos_, radius_ = pos.to(f32).contiguous(), radius.to(f32).contiguous()
    alive_ = None if alive is None else alive.contiguous()
    parent = torch.empty((n,), dtype=torch.int64, device=pos.device)
    lib = _load_roots()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.collision_parents(pos_.data_ptr(), radius_.data_ptr(),
                                None if alive_ is None else alive_.data_ptr(),
                                None if contacts is None else contacts.data_ptr(), n,
                                parent.data_ptr(), stream, pos.device.index or 0)
    check(lib, err, "collision_parents launch")
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
