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

:func:`bounce_block_cuda` is the block bounce (no TPU kernel: it stands in
for the XLA code of ``orbital_tpu/parallel/sharded.py:72-117``,
``_block_bounce``): the impulses and de-overlap of a visiting shard j on the
local shard i, a round of the multi-device ring, gated on the ring's count.
Its kernel (``bounce_block_kernel``) runs B6's sweep on a launch of its own,
:func:`bounce_plan`'s: the j range split across blocks as well as warps, so
that the ring's 16,384^2 and 8,192^2 run one wave of 256 blocks over every
SM, the splits' partials added in split order on the device. With ``out`` it
adds the round's sum to the given (dpos, dvel) in place (the ring's rounds
after the first: out + sum, the rounding of an eager add); at a count of 0
that launch returns at entry. The wrapper passes the tables' own pointers
(f32 and contiguous, as a ds32 state's hi words are) and, with
``checked=True``, skips its checks: the ring checks each shard shape once.
Its plain version is :func:`bounce_block_plain`; ``bounce_block_cuda.
launches`` counts its launches, under a lock, as the threads of a one-card
mesh launch it (and the contact sweep's, which runs on every rank of a
mesh). Float64 sides take its f64 instance (``bounce_block_f64_kernel``):
the plain version's pair in double on the same plan, gate and split sums,
deltas and ``out`` in float64, counted in ``bounce_block_cuda.
f64_launches``; nothing is cast.

The contact sweep of merge and resolve (``csrc/collision_roots.cu``, one
tiled template with two modes) stands in for the JAX module's XLA blocks:
merge's root search (:func:`collision_roots_cuda`, for
``orbital_tpu/ops/collisions.py:165-196``) writes each column's parent, the
smallest touching row below it, and the wrapper jumps the pointers in eager
torch; resolve's contact mark (:func:`contact_marks_cuda`, for ``i_block``
at :452-464) marks every body that touches another. Both are gated by the
same device-held contact count (the identity, or no marks, at a count of 0).
Each mode has an f32 and an f64 instance, picked by the positions'
dtype, so that f64 state gets JAX's roots and marks exactly (an f32 test
parts from them on grazing pairs). Their plain versions,
:func:`collision_parents_plain` (and
:func:`collision_roots_plain`) and :func:`contact_marks_plain`, are the
blocked torch sweeps, gated alike; ``collision_roots_cuda.launches`` and
``contact_marks_cuda.launches`` count the f32 instance's launches and their
``f64_launches`` the f64 instance's. :func:`sweep_plan`
mirrors the kernel's walk over its tiles.

The same source's third mode, the count (:func:`block_contacts_cuda`; no
TPU kernel: it stands in for the XLA block count of
``orbital_tpu/ops/collisions.py:97-113``, ``_contacts_block``, ringed by
``orbital_tpu/parallel/sharded.py:199-231``), is the mesh solvers' contact
count under a mesh: the directed count of a visiting shard on the local one,
a ring round, added in place into the rank's int32, f32 or f64 by the
tables' dtype. Its plain version is ``ops.collisions.block_contacts``;
``block_contacts_cuda.launches`` and ``.f64_launches`` count its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .collisions import (_bounce_block, block_contacts, bounce_deltas_chunked,
                         collision_parents_chunked, contact_marks_chunked, pointer_jump,
                         restitution_clip)
from .cuda_forces import block_plan
from ..utils.kernels import count_launch, in_f32, refuse_grad

__all__ = ["bounce_deltas_cuda", "bounce_deltas_plain", "bounce_block_cuda",
           "bounce_block_plain", "bounce_plan", "bounce_block_shape", "collision_roots_cuda",
           "collision_roots_plain", "collision_parents_cuda", "collision_parents_plain",
           "contact_marks_cuda", "contact_marks_plain", "block_contacts_cuda",
           "contact_count_shape", "sweep_plan", "SWEEP_TILE"]

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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bounce_block_round.restype = ctypes.c_int
        lib.bounce_block_round.argtypes = ([p] * 5 + [i] + [p] * 5 + [i, ctypes.c_float, p]
                                           + [i] * 3 + [p] * 5 + [i])
        lib.bounce_block_round_f64.restype = ctypes.c_int
        lib.bounce_block_round_f64.argtypes = ([p] * 5 + [i] + [p] * 5 + [i, ctypes.c_double, p]
                                               + [i] * 3 + [p] * 5 + [i])
        lib.bounce_block_shape.restype = None
        lib.bounce_block_shape.argtypes = [i, p]
        _lib = lib
    return _lib


def _gate(dpos, dvel, contacts):
    """Exact zeros where a given ``contacts`` count is 0."""
    if contacts is None:
        return dpos, dvel
    hit = contacts > 0
    return (torch.where(hit, dpos, torch.zeros_like(dpos)),
            torch.where(hit, dvel, torch.zeros_like(dvel)))


def bounce_deltas_plain(pos, vel, mass, radius, alive=None, *, restitution: float = 1.0,
                        contacts: Optional[torch.Tensor] = None, chunk: int = 1024):
    """The plain PyTorch version of the kernel, on any device: the chunked
    sweep, and exact zeros where a given ``contacts`` count is 0."""
    return _gate(*bounce_deltas_chunked(pos, vel, mass, radius, alive,
                                        restitution=restitution, chunk=chunk), contacts)


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
    if pos.dtype == torch.float64:
        return in_f32(bounce_deltas_cuda, pos, vel, mass, radius, alive,
                      restitution=restitution, contacts=contacts)
    refuse_grad("bounce_deltas_cuda", pos, vel, mass, radius)
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


def bounce_block_plain(pos_i, vel_i, mass_i, radius_i, alive_i, pos_j, vel_j, mass_j,
                       radius_j, alive_j, *, restitution: float = 1.0,
                       contacts: Optional[torch.Tensor] = None,
                       out: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                       chunk: int = 1024):
    """The plain PyTorch version of the block kernel, on any device: row
    blocks of i against all of j in the kernel's formulation
    (``ops.collisions._bounce_block``, each side's mass times its alive),
    and exact zeros where a given ``contacts`` count is 0; with ``out`` the
    round's sum added to it in place and ``out`` returned."""
    e = restitution_clip(restitution)
    m_i = mass_i * alive_i.to(mass_i.dtype)
    m_j = mass_j * alive_j.to(mass_j.dtype)
    parts = [_bounce_block(pos_i[s:s + chunk], vel_i[s:s + chunk], m_i[s:s + chunk],
                           radius_i[s:s + chunk], pos_j, vel_j, m_j, radius_j, e)
             for s in range(0, pos_i.shape[0], chunk)]
    if not parts:
        dp, dv = torch.zeros_like(pos_i), torch.zeros_like(vel_i)
    else:
        dp, dv = _gate(torch.cat([p for p, _ in parts]), torch.cat([v for _, v in parts]),
                       contacts)
    if out is None:
        return dp, dv
    out[0].add_(dp)
    out[1].add_(dv)
    return out


@functools.lru_cache(maxsize=None)
def bounce_plan(n_i: int, n_j: int, k: int, q: int, tile: int, resident: int, sms: int,
                splits: Optional[int] = None) -> dict:
    """The block bounce's cut of an n_i x n_j block at its kernel's shape (k
    i bodies a thread, q warps, j tiles of ``tile``; ``resident`` co-resident
    blocks on ``sms`` SMs): B3's :func:`~.cuda_forces.block_plan` over i
    tiles of 32 k rows with the least critical path (``fill=False``), its
    ``grid`` = ``tiles`` x ``splits`` blocks (block u sweeps i tile u %
    tiles against the j split u // tiles of ``split_len`` bodies, warp w its
    j tiles w, w + q, ...). At 4 x 8 with two blocks an SM on 132 SMs: 2
    splits at 16,384^2 and 4 at 8,192^2, 256 blocks in one wave, which ran
    3% and 10% faster than the 4 and 8 splits (512 blocks, two waves) that
    put two blocks on every SM (chip_smoke.py --ring-variants; PERF.md); one
    split at 65,536^2, B6's order. ``splits`` pins the count (whole j tiles
    a split, the last one ragged), as a check of one split does; a block
    with no i or no j body gets one split."""
    n_i, n_j, k, tile = int(n_i), int(n_j), int(k), int(tile)
    if splits is None and min(n_i, n_j) >= 1:
        return block_plan(n_i, n_j, 32 * k, q, tile, resident, sms, False)
    tiles, j_tiles = -(-n_i // (32 * k)), max(1, -(-n_j // tile))
    split_len = -(-j_tiles // max(1, int(splits or 1))) * tile
    splits = max(1, -(-n_j // split_len))
    return dict(tiles=tiles, splits=splits, split_len=split_len, units=tiles * splits,
                grid=tiles * splits)


# per (library, device): the block kernel's shape; per (n_i, n_j, library,
# device, pinned splits, dtype): its plan's cut and scratch (the splits'
# partials and each i tile's counter, zeros that each launch leaves zero),
# so that a round's launch looks up one entry
_bounce_shapes: dict = {}
_bounce_launches: dict = {}


def bounce_block_shape(device: torch.device) -> dict:
    """The block kernel's shape on ``device``: i bodies a thread (``k``),
    warps a block (``q``), j bodies a tile, threads a block, co-resident
    blocks and SMs, asked of the library once per library and device."""
    lib = _load()
    key = (id(lib), device.index or 0)
    if key not in _bounce_shapes:
        arr = (ctypes.c_int * 6)()
        lib.bounce_block_shape(key[1], arr)
        _bounce_shapes[key] = dict(zip(("k", "q", "tile", "threads", "resident", "sms"), arr))
    return _bounce_shapes[key]


def _bounce_round(lib, dev: torch.device, n_i: int, n_j: int, splits: Optional[int],
                  dtype=torch.float32):
    """((splits, split_len), (part, done) pointers) of a round at n_i x n_j,
    made once a shape and dtype (the partials in the deltas' dtype)."""
    key = (n_i, n_j, id(lib), dev.index or 0, splits, dtype)
    hit = _bounce_launches.get(key)
    if hit is None:
        sh = bounce_block_shape(dev)
        plan = bounce_plan(n_i, n_j, sh["k"], sh["q"], sh["tile"], sh["resident"], sh["sms"],
                           splits)
        part = torch.empty((n_i * 6 * plan["splits"] if plan["splits"] > 1 else 1,),
                           dtype=dtype, device=dev)
        done = torch.zeros((max(1, plan["tiles"]),), dtype=torch.int32, device=dev)
        hit = _bounce_launches[key] = ((plan["splits"], plan["split_len"]),
                                       (part.data_ptr(), done.data_ptr()), (part, done))
    return hit


def _bounce_block_launch(side_i, side_j, e: float, contacts, dpos, dvel, accumulate: bool,
                         splits: Optional[int] = None) -> None:
    """Launch the block kernel on its plan (or ``splits`` pinned) over the
    sides' own arrays (contiguous, in the deltas' dtype; alive bool) into
    ``dpos``, ``dvel`` [n_i, 3]: written, or with ``accumulate`` added to;
    its f64 instance where they are float64."""
    from ..utils.kernels import check, stream_handle

    lib, dev = _load(), dpos.device
    n_i, n_j = side_i[0].shape[0], side_j[0].shape[0]
    cut, scratch, _ = _bounce_round(lib, dev, n_i, n_j, splits, dpos.dtype)
    name = "bounce_block_round" + ("_f64" if dpos.dtype == torch.float64 else "")
    err = getattr(lib, name)(
        *(t.data_ptr() for t in side_i), n_i, *(t.data_ptr() for t in side_j), n_j, e,
        None if contacts is None else contacts.data_ptr(), *cut, int(accumulate), *scratch,
        dpos.data_ptr(), dvel.data_ptr(), stream_handle(dev), dev.index)
    check(lib, err, f"{name} launch")


def _check_bounce_block(side_i, side_j, contacts, out) -> tuple:
    """The block bounce's contract; returns the sides as the kernel reads
    them (contiguous: the tensors themselves where they are so already).
    pos, vel, mass and radius of both sides, and ``out``, must share pos_i's
    dtype, float32 or float64; alive is bool."""
    pos_i = side_i[0]
    refuse_grad("bounce_block_cuda", *side_i[:4], *side_j[:4])
    if pos_i.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bounce_block_cuda: the f32 and f64 instances take float32 or "
                        f"float64 sides, got {pos_i.dtype}")
    for side in (side_i, side_j):
        p, v, m, r, a = side
        n = p.shape[0]
        if p.shape != (n, 3) or v.shape != (n, 3) or m.shape != (n,) or r.shape != (n,) \
                or a.shape != (n,):
            raise ValueError("bounce_block_cuda: need pos, vel [B, 3] and mass, radius, "
                             "alive [B] on each side")
        if a.dtype != torch.bool:
            raise TypeError("bounce_block_cuda: alive must be bool")
        if any(t.dtype != pos_i.dtype for t in side[:4]):
            raise TypeError(f"bounce_block_cuda: pos, vel, mass and radius of both sides "
                            f"must be {pos_i.dtype}, as pos_i is; nothing is cast")
    tensors = [*side_i, *side_j] + [t for t in (contacts,) + tuple(out or ()) if t is not None]
    if any(t.device != pos_i.device for t in tensors):
        raise ValueError("bounce_block_cuda: all tensors must be on one device")
    if contacts is not None and (contacts.dtype != torch.int32 or contacts.numel() != 1):
        raise TypeError("bounce_block_cuda: contacts must be one int32")
    if out is not None and any(o.shape != (pos_i.shape[0], 3) or o.dtype != pos_i.dtype
                               or not o.is_contiguous() for o in out):
        raise ValueError(f"bounce_block_cuda: out must be two contiguous {pos_i.dtype} "
                         f"[Bi, 3] tensors")
    return tuple(tuple(t.contiguous() for t in side) for side in (side_i, side_j))


def bounce_block_cuda(pos_i: torch.Tensor, vel_i: torch.Tensor, mass_i: torch.Tensor,
                      radius_i: torch.Tensor, alive_i: torch.Tensor, pos_j: torch.Tensor,
                      vel_j: torch.Tensor, mass_j: torch.Tensor, radius_j: torch.Tensor,
                      alive_j: torch.Tensor, *, restitution: float = 1.0,
                      contacts: Optional[torch.Tensor] = None,
                      out: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                      checked: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The bounce sweep of body block j on body block i: (dpos [Bi, 3], dvel
    [Bi, 3]) in the sides' dtype (float32, or float64 on the f64
    instance), each pair's impulse and de-overlap on i from the
    pre-collision velocities, a pair touching when 0 < r2 <= (R_i + R_j)^2,
    both alive, m_j > 0 and approaching. With ``contacts`` (an int32 0-dim
    tensor on the same device) the kernel writes zeros and skips the sweep
    when it is 0. With ``out`` (two contiguous [Bi, 3] tensors of the sides'
    dtype) the sum is added to them in place and ``out`` returned (at a
    count of 0 the launch leaves them as they are). ``checked=True`` skips
    the checks: the caller vouches that the tensors are as an earlier
    checked call of the same shapes found them, of one dtype (alive bool)
    and contiguous on one CUDA device."""
    side_i = (pos_i, vel_i, mass_i, radius_i, alive_i)
    side_j = (pos_j, vel_j, mass_j, radius_j, alive_j)
    if pos_i.device.type == "cpu":
        return bounce_block_plain(*side_i, *side_j, restitution=restitution, contacts=contacts,
                                  out=out)
    if not checked:
        if pos_i.device.type != "cuda":
            raise ValueError(f"bounce_block_cuda: unsupported device {pos_i.device}")
        side_i, side_j = _check_bounce_block(side_i, side_j, contacts, out)
    if out is None:
        n_i = pos_i.shape[0]
        dpos = torch.empty((n_i, 3), dtype=pos_i.dtype, device=pos_i.device)
        dvel = torch.empty((n_i, 3), dtype=pos_i.dtype, device=pos_i.device)
    else:
        dpos, dvel = out
    _bounce_block_launch(side_i, side_j, restitution_clip(restitution), contacts, dpos, dvel,
                         out is not None)
    count_launch(bounce_block_cuda, _counter(pos_i))
    return dpos, dvel


bounce_block_cuda.launches = 0
bounce_block_cuda.f64_launches = 0


def _load_roots():
    global _roots_lib
    if _roots_lib is None:
        from ..utils import kernels

        lib = kernels.load("collision_roots")
        p = ctypes.c_void_p
        for fn in (lib.collision_parents, lib.contact_marks, lib.collision_parents_f64,
                   lib.contact_marks_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = [p, p, p, p, ctypes.c_int, p, p, ctypes.c_int]
        i, ll = ctypes.c_int, ctypes.c_longlong
        for fn in (lib.contact_count, lib.contact_count_f64):
            fn.restype = i
            fn.argtypes = [p, p, p, ll, i, p, p, p, ll, i, p, p, i]
        lib.contact_count_shape.restype = None
        lib.contact_count_shape.argtypes = [i, i, p]
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


def _counter(pos) -> str:
    """The launch counter of the contact-sweep instance that ``pos`` takes."""
    return "f64_launches" if pos.dtype == torch.float64 else "launches"


def _sweep_launch(name: str, pos, radius, alive, contacts, out_dtype):
    """Check the inputs of a contact-sweep wrapper and launch the kernel's
    mode ``name`` (the C entry point) into a new [N] tensor: its f64
    instance (``name``_f64) on float64 positions, which reads the radii in
    float64 too, else the f32 one."""
    refuse_grad(name, pos, radius)
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
    # the sweep reads the positions in the state's own type: f64 state takes
    # the f64 instance (JAX's XLA sweeps run in the state's dtype), f32 and
    # ds32 (hi words) the f32 one
    wide = pos.dtype == torch.float64
    dt = torch.float64 if wide else torch.float32
    pos_, radius_ = pos.to(dt).contiguous(), radius.to(dt).contiguous()
    alive_ = None if alive is None else alive.contiguous()
    out = torch.empty((n,), dtype=out_dtype, device=pos.device)
    lib = _load_roots()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = getattr(lib, name + "_f64" if wide else name)(pos_.data_ptr(), radius_.data_ptr(),
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
    Each launch adds one to ``collision_roots_cuda.launches`` (the f64
    instance's to its ``f64_launches``)."""
    if pos.device.type == "cpu":
        return collision_parents_plain(pos, radius, alive, contacts=contacts)
    if pos.device.type != "cuda":
        raise ValueError(f"collision_roots_cuda: unsupported device {pos.device}")
    parent = _sweep_launch("collision_parents", pos, radius, alive, contacts, torch.int64)
    count_launch(collision_roots_cuda, _counter(pos))
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
collision_roots_cuda.f64_launches = 0


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
    count_launch(contact_marks_cuda, _counter(pos))
    return mark


contact_marks_cuda.launches = 0
contact_marks_cuda.f64_launches = 0


def block_contacts_cuda(pos_i: torch.Tensor, radius_i: torch.Tensor, alive_i: torch.Tensor,
                        i_off: int, pos_j: torch.Tensor, radius_j: torch.Tensor,
                        alive_j: torch.Tensor, j_off: int, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The directed contact count (int32 0-dim) of body block j on body
    block i with global ids ``i_off + row`` and ``j_off + column``: the
    contact sweep's count mode, integer-equal to its plain version
    :func:`~.collisions.block_contacts`, which CPU tensors take. With
    ``out`` (one int32 on the same device) the count is added to it in place
    and ``out`` returned, so that a ring's rounds add into one count, a
    launch each; without, a new count. pos and radius of both blocks share
    one dtype, float32 (the f32 instance; a ds32 state's hi words) or
    float64 (the f64 instance, counted in ``f64_launches``); alive is bool;
    nothing is cast."""
    if pos_i.device.type == "cpu":
        count = block_contacts(pos_i, radius_i, alive_i, i_off, pos_j, radius_j, alive_j, j_off)
        return count if out is None else out.add_(count)
    if pos_i.device.type != "cuda":
        raise ValueError(f"block_contacts_cuda: unsupported device {pos_i.device}")
    tables = (pos_i, radius_i, pos_j, radius_j)
    if pos_i.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != pos_i.dtype for t in tables):
        raise TypeError(f"block_contacts_cuda: pos and radius of both blocks must share one "
                        f"dtype, float32 or float64; got {[t.dtype for t in tables]}")
    n_i, n_j = pos_i.shape[0], pos_j.shape[0]
    if pos_i.shape != (n_i, 3) or pos_j.shape != (n_j, 3) or radius_i.shape != (n_i,) \
            or radius_j.shape != (n_j,) or alive_i.shape != (n_i,) or alive_j.shape != (n_j,):
        raise ValueError("block_contacts_cuda: need pos [B, 3] and radius, alive [B] on each "
                         "side")
    if alive_i.dtype != torch.bool or alive_j.dtype != torch.bool:
        raise TypeError("block_contacts_cuda: alive must be bool")
    if out is not None and (out.dtype != torch.int32 or out.numel() != 1):
        raise TypeError("block_contacts_cuda: out must be one int32")
    sides = (pos_i, radius_i, alive_i, pos_j, radius_j, alive_j)
    if any(t.device != pos_i.device for t in sides[1:] + ((out,) if out is not None else ())):
        raise ValueError("block_contacts_cuda: all tensors must be on one device")
    count = torch.zeros((), dtype=torch.int32, device=pos_i.device) if out is None else out
    if not (n_i and n_j):
        return count
    from ..utils.kernels import check, stream_handle

    lib, dev = _load_roots(), pos_i.device
    pi, ri, ai, pj, rj, aj = (t.contiguous() for t in sides)
    name = "contact_count" + ("_f64" if pos_i.dtype == torch.float64 else "")
    err = getattr(lib, name)(pi.data_ptr(), ri.data_ptr(), ai.data_ptr(), int(i_off), n_i,
                             pj.data_ptr(), rj.data_ptr(), aj.data_ptr(), int(j_off), n_j,
                             count.data_ptr(), stream_handle(dev), dev.index or 0)
    check(lib, err, f"{name} launch")
    count_launch(block_contacts_cuda, _counter(pos_i))
    return count


block_contacts_cuda.launches = 0
block_contacts_cuda.f64_launches = 0


def contact_count_shape(n_i: int, n_j: int) -> dict:
    """The count mode's launch at n_i x n_j, from the library: columns a
    lane, rows and columns a tile, rows staged a round, warps a block,
    blocks and tiles."""
    arr = (ctypes.c_longlong * 6)()
    _load_roots().contact_count_shape(int(n_i), int(n_j), arr)
    return dict(zip(("columns_a_lane", "tile", "slice", "warps", "blocks", "tiles"),
                    list(arr)))
