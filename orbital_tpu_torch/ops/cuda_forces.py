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
eps2 > 0) and U = -1/2 G sum m pe.

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
from typing import Optional

import torch

from .collisions import block_contacts, count_contacts_chunked
from .forces import block_acc_potential, pairwise_acc_chunked
from ..utils.kernels import count_launch, refuse_grad

__all__ = ["pairwise_acc_cuda", "pairwise_acc_plain", "pairwise_acc_detect_cuda",
           "pairwise_acc_detect_plain", "block_acc_cuda", "block_acc_plain",
           "block_acc_detect_cuda", "block_acc_detect_plain"]

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
        lib.nbody_block_forces.restype = ctypes.c_int
        lib.nbody_block_forces.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbody_block_forces_detect.restype = ctypes.c_int
        lib.nbody_block_forces_detect.argtypes = [
            p, p, i, i, p, p, i, i, ctypes.c_float, ctypes.c_float, p, p, p, i]
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
    pts_i = torch.nn.functional.pad(pos_i, (0, 1)).contiguous()  # [Bi, 4]
    pts_j = torch.cat([pos_j, mass_j.to(torch.float32)[:, None]], dim=1).contiguous()
    out = torch.empty((n_i, 4), dtype=torch.float32, device=pos_i.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos_i.device).cuda_stream
    err = lib.nbody_block_forces(pts_i.data_ptr(), n_i, pts_j.data_ptr(), n_j, float(G),
                                 float(eps2), out.data_ptr(), stream,
                                 pos_i.device.index or 0)
    check(lib, err, "nbody_block_forces launch")
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
    f32, nan = torch.float32, float("nan")
    # a dead body's NaN radius fails every comparison in the kernel
    rad_i = torch.where(alive_i, radius_i.to(f32), nan).contiguous()
    rad_j = torch.where(alive_j, radius_j.to(f32), nan).contiguous()
    pts_i = torch.nn.functional.pad(pos_i, (0, 1)).contiguous()  # [Bi, 4]
    pts_j = torch.cat([pos_j, mass_j.to(f32)[:, None]], dim=1).contiguous()
    out = torch.empty((n_i, 4), dtype=f32, device=pos_i.device)
    contacts = torch.zeros((), dtype=torch.int32, device=pos_i.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pos_i.device).cuda_stream
    err = lib.nbody_block_forces_detect(
        pts_i.data_ptr(), rad_i.data_ptr(), n_i, int(i_off), pts_j.data_ptr(),
        rad_j.data_ptr(), n_j, int(j_off), float(G), float(eps2), out.data_ptr(),
        contacts.data_ptr(), stream, pos_i.device.index or 0)
    check(lib, err, "nbody_block_forces_detect launch")
    count_launch(block_acc_detect_cuda)
    return out[:, 0:3], out[:, 3], contacts


block_acc_detect_cuda.launches = 0
