"""The hand-written CUDA force sweep (``csrc/nbody_forces.cu``).

Replaces ``orbital_tpu/ops/pallas_forces.py::_nbody_kernel`` behind
``pairwise_acc_pallas``, with the same contract: f32 in, (acc [N, 3],
scalar U) out, dead bodies inert, and with ``with_potential=False`` the PE
sum is skipped in the kernel and U is 0. :func:`pairwise_acc_detect_cuda`
is its ``detect=True`` variant (``pairwise_acc_detect_pallas``): the same
sweep also counts directed touching pairs into an int32 that stays on the
device, the gate of the bounce sweep. :func:`block_acc_cuda` is the same
kernel over separate i and j tables (``block_acc_pallas``, the per-round
block of the multi-device ring): acc and the pe row of block j on block i,
the i == j term kept. :func:`block_acc_detect_cuda` is B3 with detection
(no TPU kernel: it stands in for the sqrt-free count ring of
``orbital_tpu/parallel/sharded.py:199-231``): the same sweep also counts the
block's directed touching pairs between live bodies of different global ids,
so that the ring's closing force evaluation counts the step's contacts.

The kernel is bound by instruction issue (~14.5 warp instructions and one
MUFU.RSQ a pair; see the note at the top of the source): four i bodies a
thread, the j range split across the 16 warps of a block, each warp
streaming its slice through its own shared float4 tiles, the slices' sums
added in a fixed order, the ragged last tile cut in the kernel. The
bookkeeping stays here, as in the JAX wrapper: the alive mask, the
analytic self-PE subtraction m_i/eps (the kernel masks nothing when
eps2 > 0) and U = -1/2 G sum m pe. B3 and B3 detect take the same tile
sweep on a launch of their own, sized for the ring's blocks (16,384^2 at 4
ranks): :func:`block_plan` splits the j range across blocks as well as
across the warps of a block, the kernel adds the splits' partials on the
device in split order, and it reads the tables in place (no packing).

For CPU tensors the wrappers compute the plain versions,
``ops.forces.pairwise_acc_chunked`` (plus ``ops.collisions.
count_contacts_chunked`` for the count), :func:`block_acc_plain` and
:func:`block_acc_detect_plain`. For CUDA tensors they launch the kernel or
raise; they never fall back. ``pairwise_acc_cuda.launches``,
``pairwise_acc_detect_cuda.launches``, ``block_acc_cuda.launches`` and
``block_acc_detect_cuda.launches`` count kernel launches (the block sweeps,
which the threads of a one-card mesh launch, under a lock).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .collisions import block_contacts, count_contacts_chunked
from .forces import block_acc_potential, pairwise_acc_chunked
from ..utils.kernels import count_launch, refuse_grad

__all__ = ["pairwise_acc_cuda", "pairwise_acc_plain", "pairwise_acc_detect_cuda",
           "pairwise_acc_detect_plain", "block_acc_cuda", "block_acc_plain",
           "block_acc_detect_cuda", "block_acc_detect_plain", "block_plan"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("nbody_forces")
        lib.nbody_forces.restype = ctypes.c_int
        lib.nbody_forces.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.nbody_forces_detect.restype = ctypes.c_int
        lib.nbody_forces_detect.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int]
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nbody_block_forces.restype = ctypes.c_int
        lib.nbody_block_forces.argtypes = [p, i, p, p, i, f, f, i, i, p, p, p, p, i]
        lib.nbody_block_forces_detect.restype = ctypes.c_int
        lib.nbody_block_forces_detect.argtypes = [p, p, p, i, i, p, p, p, p, i, i, f, f, i, i,
                                                  p, p, p, p, p, i]
        lib.nbody_block_shape.restype = None
        lib.nbody_block_shape.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


def pairwise_acc_plain(pos, mass, alive=None, *, G: float, eps2: float,
                       with_potential: bool = True, chunk: int = 1024):
    """The plain PyTorch version of the kernel, on any device."""
    acc, U = pairwise_acc_chunked(pos, mass, alive, G=G, eps2=eps2,
                                  chunk=min(chunk, max(pos.shape[0], 1)))
    if not with_potential:
        U = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return acc, U


def _check_inputs(fn: str, pos, mass, *others) -> None:
    if pos.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {pos.device}")
    if pos.dtype != torch.float32:
        raise TypeError(f"{fn} computes in float32, got {pos.dtype}")
    if pos.ndim != 2 or pos.shape[1] != 3 or mass.shape != pos.shape[:1]:
        raise ValueError(f"{fn}: need pos [N, 3] and mass [N], got "
                         f"{tuple(pos.shape)} and {tuple(mass.shape)}")
    if any(t is not None and t.device != pos.device for t in (mass, *others)):
        raise ValueError(f"{fn}: all tensors must be on one device")


def _potential(out, mass32, G: float, eps2: float, with_potential: bool):
    """U = -1/2 G sum m pe from the kernel's pe rows, with the analytic
    self-term m_i/eps of the mask-free kernel removed."""
    if not with_potential:
        return torch.zeros((), dtype=torch.float32, device=out.device)
    pe_row = out[:, 3]
    if eps2 > 0.0:
        pe_row = pe_row - mass32 * (1.0 / float(eps2) ** 0.5)
    return -0.5 * G * torch.sum(mass32 * pe_row)


def pairwise_acc_cuda(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G: float,
    eps2: float,
    with_potential: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Softened pairwise accelerations [N, 3] and total potential U."""
    if pos.device.type == "cpu":
        return pairwise_acc_plain(pos, mass, alive, G=G, eps2=eps2,
                                  with_potential=with_potential)
    _check_inputs("pairwise_acc_cuda", pos, mass, alive)
    refuse_grad("pairwise_acc_cuda", pos, mass)
    n = pos.shape[0]
    mass_eff = mass if alive is None else mass * alive.to(mass.dtype)
    mass32 = mass_eff.to(torch.float32)
    pts = torch.cat([pos, mass32[:, None]], dim=1).contiguous()  # [N, 4]
    out = torch.empty((n, 4), dtype=torch.float32, device=pos.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.nbody_forces(pts.data_ptr(), n, float(G), float(eps2),
                           int(with_potential), out.data_ptr(), stream,
                           pos.device.index or 0)
    check(lib, err, "nbody_forces launch")
    pairwise_acc_cuda.launches += 1

    acc = out[:, 0:3]
    if alive is not None:
        acc = acc * alive[:, None].to(acc.dtype)
    return acc, _potential(out, mass32, G, eps2, with_potential)


pairwise_acc_cuda.launches = 0


def pairwise_acc_detect_plain(pos, mass, radius, alive, *, G: float, eps2: float,
                              with_potential: bool = True, chunk: int = 1024):
    """The plain PyTorch version of the detect kernel, on any device: the
    chunked force sweep and the chunked contact count, as
    ``resolve_force_detect_fn`` composes them for ``force_impl="chunked"``."""
    acc, U = pairwise_acc_plain(pos, mass, alive, G=G, eps2=eps2,
                                with_potential=with_potential, chunk=chunk)
    contacts = count_contacts_chunked(pos, radius, alive,
                                      chunk=min(chunk, max(pos.shape[0], 1)))
    return acc, U, contacts


def pairwise_acc_detect_cuda(
    pos: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    alive: torch.Tensor,
    *,
    G: float,
    eps2: float,
    with_potential: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The force sweep with contact detection: (acc [N, 3], U, contacts),
    ``contacts`` an int32 0-dim tensor on the device counting directed
    touching pairs between live bodies (|r_ij| <= (R_i + R_j) * 1.00001,
    unsoftened). Dead bodies must sit at spread-out far positions, as
    ``make_state`` parks them. The acc is bit-equal to
    :func:`pairwise_acc_cuda`'s on the same inputs."""
    if pos.device.type == "cpu":
        return pairwise_acc_detect_plain(pos, mass, radius, alive, G=G, eps2=eps2,
                                         with_potential=with_potential)
    _check_inputs("pairwise_acc_detect_cuda", pos, mass, radius, alive)
    refuse_grad("pairwise_acc_detect_cuda", pos, mass, radius)
    n = pos.shape[0]
    alive32 = alive.to(torch.float32)
    mass32 = (mass * alive.to(mass.dtype)).to(torch.float32)
    radius32 = (radius.to(torch.float32) * alive32).contiguous()
    pts = torch.cat([pos, mass32[:, None]], dim=1).contiguous()  # [N, 4]
    out = torch.empty((n, 4), dtype=torch.float32, device=pos.device)
    # the kernel counts the n self pairs too: start the counter at -n
    contacts = torch.full((), -n, dtype=torch.int32, device=pos.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.nbody_forces_detect(pts.data_ptr(), radius32.data_ptr(), n, float(G),
                                  float(eps2), int(with_potential), out.data_ptr(),
                                  contacts.data_ptr(), stream, pos.device.index or 0)
    check(lib, err, "nbody_forces_detect launch")
    pairwise_acc_detect_cuda.launches += 1

    acc = out[:, 0:3] * alive[:, None].to(torch.float32)
    return acc, _potential(out, mass32, G, eps2, with_potential), contacts


pairwise_acc_detect_cuda.launches = 0


_BLOCK_ROWS = 1024  # i rows a block of the plain version


def _check_block(n_i: int, n_j: int, eps2: float) -> None:
    """B3's contract: the mask-free sweep needs eps2 > 0, as the ring does
    (``sharded.py:250-257``), and both blocks tile by 128
    (``pallas_forces.py:281-282``)."""
    if eps2 <= 0.0:
        raise ValueError("the block sweep requires eps2 > 0 (self pairs cancel through "
                         "d = 0 only when softened)")
    if n_i % 128 != 0 or n_j % 128 != 0:
        raise ValueError(f"block sizes n_i={n_i} and n_j={n_j} must be multiples of 128")


def block_acc_plain(pos_i, pos_j, mass_j, *, G: float, eps2: float):
    """The plain PyTorch version of the block kernel, on any device: row
    blocks of pos_i against all of pos_j in float32, nothing masked."""
    _check_block(pos_i.shape[0], pos_j.shape[0], eps2)
    f32 = torch.float32
    acc, pe_row = block_acc_potential(pos_i.to(f32), pos_j.to(f32), mass_j.to(f32), G=G,
                                      eps2=eps2, rows=_BLOCK_ROWS)
    return acc.to(pos_i.dtype), pe_row.to(pos_i.dtype)


# B3's launch plan: a unit's fixed cost (its i rows, sums and partials) as
# this many j bodies a warp
_UNIT_ROWS = 64


@functools.lru_cache(maxsize=None)
def block_plan(n_i: int, n_j: int, rows: int, warps: int, tile: int, resident: int,
               sms: int) -> dict:
    """B3's cut of an n_i x n_j block: ``tiles`` i tiles of ``rows`` bodies,
    ``splits`` j splits of ``split_len`` bodies (whole j tiles of ``tile``),
    ``grid`` = ``units`` = tiles x splits blocks (unit u is i tile u % tiles
    against split u // tiles, whose j tiles warp w of ``warps`` sweeps w, w +
    warps, ...). Of the split counts that cut [0, n_j) without an empty
    split, it takes one with at least 2 x ``sms`` units where there is one
    (so that every SM gets two blocks or more), then the least critical
    path, rounds x (a warp's j tiles x tile + a unit's fixed cost of 64
    bodies) with ``resident`` blocks a round, then the fewest splits: at
    16,384^2 in i tiles of 64 on 132 SMs with 264 co-resident blocks, 2
    splits (512 blocks), where one split left 4 SMs idle on B1's shape; at
    65,536^2 one split, B1's order."""
    n_i, n_j, rows, warps, tile = int(n_i), int(n_j), int(rows), int(warps), int(tile)
    resident, sms = int(resident), int(sms)
    if min(n_i, n_j, rows, warps, tile, resident, sms) < 1:
        raise ValueError(f"block_plan: n_i={n_i}, n_j={n_j}, rows={rows}, warps={warps}, "
                         f"tile={tile}, resident={resident}, sms={sms} must be >= 1")
    tiles, j_tiles = -(-n_i // rows), -(-n_j // tile)
    best = None
    for splits in range(1, j_tiles + 1):
        split_tiles = -(-j_tiles // splits)
        if -(-j_tiles // split_tiles) != splits:
            continue  # a smaller count cuts the same way
        units = tiles * splits
        path = -(-units // resident) * (-(-split_tiles // warps) * tile + _UNIT_ROWS)
        key = (units < 2 * sms, path, splits)
        if best is None or key < best[0]:
            best = (key, dict(tiles=tiles, splits=splits, split_len=split_tiles * tile,
                              units=units, grid=units))
    return best[1]


# per device: the block kernel's shape and its scratch (the splits'
# partials; each tile's counter and the count's tally and counter: zeros,
# which each launch leaves zero)
_block_shapes: dict = {}
_block_scratch: dict = {}


def block_shape(device: torch.device) -> dict:
    """B3's block shape on ``device``: i bodies a thread (``k``), warps a
    block (``q``), j bodies a tile, threads a block, co-resident blocks and
    SMs, asked of the library once per library and device."""
    lib = _load()
    key = (id(lib), device.index or 0)
    if key not in _block_shapes:
        arr = (ctypes.c_int * 6)()
        lib.nbody_block_shape(key[1], arr)
        _block_shapes[key] = dict(zip(("k", "q", "tile", "threads", "resident", "sms"), arr))
    return _block_shapes[key]


def _block_scratch_for(dev: torch.device, parts: int, tiles: int):
    part, done = _block_scratch.get(dev, (None, None))
    if part is None or part.shape[0] < parts:
        part = torch.empty((max(parts, 1), 4), dtype=torch.float32, device=dev)
    if done is None or done.numel() < tiles:
        done = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    _block_scratch[dev] = (part, done)
    return part, done


def _block_launch(pos_i, pos_j, mass_j, detect, out, G: float, eps2: float) -> None:
    """Launch B3 (``detect`` None) or B3 detect (``detect`` = (radius_i,
    alive_i, i_off, radius_j, alive_j, j_off, contacts)) on its launch plan,
    into ``out`` [n_i, 4]."""
    from ..utils.kernels import check

    lib, dev = _load(), pos_i.device
    n_i, n_j = pos_i.shape[0], pos_j.shape[0]
    sh = block_shape(dev)
    plan = block_plan(n_i, n_j, 32 * sh["k"], sh["q"], sh["tile"], sh["resident"], sh["sms"])
    part, done = _block_scratch_for(dev, n_i * plan["splits"] if plan["splits"] > 1 else 0,
                                    plan["tiles"] + 2)
    cut = (plan["splits"], plan["split_len"], part.data_ptr(), done.data_ptr(),
           out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    pi, pj, mj = (t.to(torch.float32).contiguous() for t in (pos_i, pos_j, mass_j))
    if detect is None:
        err = lib.nbody_block_forces(pi.data_ptr(), n_i, pj.data_ptr(), mj.data_ptr(), n_j,
                                     float(G), float(eps2), *cut, stream, dev.index or 0)
        check(lib, err, "nbody_block_forces launch")
        return
    radius_i, alive_i, i_off, radius_j, alive_j, j_off, contacts = detect
    ri, rj = (t.to(torch.float32).contiguous() for t in (radius_i, radius_j))
    ai, aj = (t.to(torch.bool).contiguous() for t in (alive_i, alive_j))
    err = lib.nbody_block_forces_detect(pi.data_ptr(), ri.data_ptr(), ai.data_ptr(), n_i,
                                        int(i_off), pj.data_ptr(), mj.data_ptr(),
                                        rj.data_ptr(), aj.data_ptr(), n_j, int(j_off),
                                        float(G), float(eps2), *cut, contacts.data_ptr(),
                                        stream, dev.index or 0)
    check(lib, err, "nbody_block_forces_detect launch")


def block_acc_cuda(pos_i: torch.Tensor, pos_j: torch.Tensor, mass_j: torch.Tensor, *,
                   G: float, eps2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial forces of body block j on body block i: (acc [Bi, 3], pe_row
    [Bi]) with pe_row_i = sum_j m_j / sqrt(r^2 + eps^2), the i == j term
    included where the blocks coincide. Dead bodies carry mass 0."""
    if pos_i.device.type == "cpu":
        return block_acc_plain(pos_i, pos_j, mass_j, G=G, eps2=eps2)
    _check_inputs("block_acc_cuda", pos_j, mass_j, pos_i)
    refuse_grad("block_acc_cuda", pos_i, pos_j, mass_j)
    if pos_i.dtype != torch.float32 or pos_i.ndim != 2 or pos_i.shape[1] != 3:
        raise ValueError(f"block_acc_cuda: need float32 pos_i [Bi, 3], got "
                         f"{pos_i.dtype} {tuple(pos_i.shape)}")
    n_i, n_j = pos_i.shape[0], pos_j.shape[0]
    _check_block(n_i, n_j, eps2)
    out = torch.empty((n_i, 4), dtype=torch.float32, device=pos_i.device)
    _block_launch(pos_i, pos_j, mass_j, None, out, G, eps2)
    count_launch(block_acc_cuda)
    return out[:, 0:3], out[:, 3]


block_acc_cuda.launches = 0


def block_acc_detect_plain(pos_i, radius_i, alive_i, i_off: int, pos_j, mass_j, radius_j,
                           alive_j, j_off: int, *, G: float, eps2: float):
    """The plain PyTorch version of the detecting block kernel, on any
    device: :func:`block_acc_plain` and the block's contact count
    (``ops.collisions.block_contacts``) with global ids ``i_off + row`` and
    ``j_off + column``."""
    acc, pe_row = block_acc_plain(pos_i, pos_j, mass_j, G=G, eps2=eps2)
    return acc, pe_row, block_contacts(pos_i, radius_i, alive_i, i_off, pos_j, radius_j,
                                       alive_j, j_off)


def block_acc_detect_cuda(pos_i: torch.Tensor, radius_i: torch.Tensor, alive_i: torch.Tensor,
                          i_off: int, pos_j: torch.Tensor, mass_j: torch.Tensor,
                          radius_j: torch.Tensor, alive_j: torch.Tensor, j_off: int, *,
                          G: float, eps2: float
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`block_acc_cuda` with contact detection: (acc [Bi, 3], pe_row
    [Bi], contacts), ``contacts`` an int32 0-dim tensor on the device
    counting the directed pairs (i, j) of live bodies with |r_ij| <= (R_i +
    R_j) * 1.00001 (unsoftened) and different global ids ``i_off + i`` and
    ``j_off + j``. acc and pe_row are bit-equal to :func:`block_acc_cuda`'s
    on the same tables."""
    if pos_i.device.type == "cpu":
        return block_acc_detect_plain(pos_i, radius_i, alive_i, i_off, pos_j, mass_j,
                                      radius_j, alive_j, j_off, G=G, eps2=eps2)
    _check_inputs("block_acc_detect_cuda", pos_j, mass_j, pos_i, radius_i, alive_i,
                  radius_j, alive_j)
    refuse_grad("block_acc_detect_cuda", pos_i, pos_j, mass_j, radius_i, radius_j)
    if pos_i.dtype != torch.float32 or pos_i.ndim != 2 or pos_i.shape[1] != 3:
        raise ValueError(f"block_acc_detect_cuda: need float32 pos_i [Bi, 3], got "
                         f"{pos_i.dtype} {tuple(pos_i.shape)}")
    n_i, n_j = pos_i.shape[0], pos_j.shape[0]
    if radius_i.shape != (n_i,) or radius_j.shape != (n_j,) or alive_i.shape != (n_i,) \
            or alive_j.shape != (n_j,):
        raise ValueError("block_acc_detect_cuda: need radius and alive [Bi] and [Bj]")
    _check_block(n_i, n_j, eps2)
    out = torch.empty((n_i, 4), dtype=torch.float32, device=pos_i.device)
    contacts = torch.empty((), dtype=torch.int32, device=pos_i.device)
    _block_launch(pos_i, pos_j, mass_j, (radius_i, alive_i, i_off, radius_j, alive_j, j_off,
                                         contacts), out, G, eps2)
    count_launch(block_acc_detect_cuda)
    return out[:, 0:3], out[:, 3], contacts


block_acc_detect_cuda.launches = 0
