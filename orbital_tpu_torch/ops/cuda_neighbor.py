"""The hand-written CUDA near-field sweep of the multirate stepper
(``csrc/neighbor.cu``).

Replaces the four TPU schedules of ``orbital_tpu/ops/neighbor_pallas.py``
with one kernel, behind wrappers named after their counterparts and with
their contracts (slot-space channels in, ``(acc [k_ch * chunk, 3], pe
[k_ch * chunk])`` out in slot order, the self-PE term m_i/eps subtracted
by the kernel):

  * :func:`near_acc_slots_cuda`: ``near_acc_slots_pallas`` over the padded
    j-block table ``jbl``, both its streaming (B8) and resident (B11)
    kernels. The kernel walks each row's live prefix, which it counts
    itself as the row's non-sentinel entries, so the two schedules are one
    and there is no ``resident`` knob.
  * :func:`near_acc_slots_cuda_sb`: ``near_acc_slots_pallas_sb`` (B10). The
    kernel stages each chunk's j-blocks itself, so no per-substep gather of
    superblocks is needed: a thin adapter over the same launch.
  * :func:`near_acc_slots_cuda_wl`: ``near_acc_slots_pallas_wl`` (B9), from
    the compacted worklist ``(wl_i, wl_jb)``: chunk c walks its run of
    entries, ``count[c]`` of them from an exclusive cumsum offset, both
    computed on the device (a ``scatter_add``, not ``bincount``, whose
    output size reads back to the host). A chunk the worklist never visits
    gets count 0 and so rows of zeros, which ``wl_row_live`` masks in on the
    TPU; the run-start flags ``wl_first`` are not needed.

The kernel reads the four channels through their pointers and one element
stride, so the columns of a row table ``P [n_slots, 4]`` (as the multirate
stepper passes them) are read in place, and it visits only each chunk's
live rows against the rows inside the chunk's box (a pair outside it adds
exactly 0; see the note at the top of the source): :func:`near_params`
gives the box's half-width, which ``chip_smoke.near_work`` counts with. A
call on the table runs one allocation and the kernel.

The mesh-sharded multirate stepper gives each rank the i chunks from
``i0`` on against the whole j side (``near_acc_slots_pallas_sb(i0=)`` in the
JAX package): :func:`near_acc_slots_rows_cuda`, the kernel's entry point
``near_sweep_rows``, whose launches it counts on its own
(``near_acc_slots_rows_cuda.launches``); its plain version is
``near_acc_slots(..., i0=)``.

For CPU tensors the wrappers compute the plain versions: ``ops.neighbor.
near_acc_slots`` over ``jbl``, and for the worklist
:func:`near_acc_slots_wl_plain`, which rebuilds each chunk's list as a table
and sweeps it the same way. For CUDA tensors they launch the kernel or
raise; they never fall back. ``near_acc_slots_cuda.launches`` counts the
kernel's launches through every adapter.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types

import numpy as np
import torch

from .neighbor import near_acc_slots
from ..utils.kernels import check, refuse_grad, stream_handle

__all__ = ["near_acc_slots_cuda", "near_acc_slots_cuda_sb", "near_acc_slots_cuda_wl",
           "near_acc_slots_rows_cuda", "near_acc_slots_wl_plain", "near_params"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("neighbor")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.near_sweep.restype = ctypes.c_int
        lib.near_sweep.argtypes = [p, p, p, p, ctypes.c_longlong, p, p, i, p, i, i, i, i,
                                   f, f, f, f, f, f, f, p, p, i]
        lib.near_sweep_rows.restype = ctypes.c_int
        lib.near_sweep_rows.argtypes = [p, p, p, p, ctypes.c_longlong, p, p, i, p, i, i, i, i,
                                        i, f, f, f, f, f, f, f, p, p, i]
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=16)
def near_params(r1: float, rc: float, G: float, eps2: float) -> types.MappingProxyType:
    """The kernel's float32 constants: ``sc = (rc^2 + eps2) inv_d``,
    ``neg_inv_d``, ``c60 = 60 inv_d`` (inv_d = 1 / (rc^2 - r1^2)), ``eps2``,
    ``G``, ``inv_eps = eps2^-1/2`` and the box's half-width ``h``. The
    sweep's s is ``sat(r2e neg_inv_d + sc)`` with r2e = r^2 + eps2, so s > 0
    needs r2e < sc / inv_d; ``h`` is sqrt of that bound widened by 2^-16,
    which covers the roundings of r2e (``csrc/neighbor.cu``). Cached, as a
    read-only mapping: the multirate stepper asks it on every sweep."""
    f32 = np.float32
    inv_d = 1.0 / (rc * rc - r1 * r1)
    sc, neg_inv_d = f32(float(f32(rc * rc + eps2)) * inv_d), f32(-inv_d)
    h = f32(math.sqrt(float(sc) / -float(neg_inv_d)) * (1.0 + 2.0 ** -16))
    return types.MappingProxyType(dict(
        sc=float(sc), neg_inv_d=float(neg_inv_d), c60=float(f32(60.0 * inv_d)),
        eps2=float(f32(eps2)), G=float(f32(G)), inv_eps=float(f32(eps2 ** -0.5)),
        h=float(h)))


def _check(fn: str, xs, ys, zs, ms, chunk: int, rj: int, eps2: float, *others) -> None:
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    f32 = torch.float32
    if xs.dtype != f32 or ys.dtype != f32 or zs.dtype != f32 or ms.dtype != f32:
        raise TypeError(f"{fn} computes in float32, got {xs.dtype}")
    if any(t.device != dev for t in (ys, zs, ms, *others)):
        raise ValueError(f"{fn}: all tensors must be on one device")
    if not eps2 > 0:
        raise ValueError(f"{fn} requires eps2 > 0 (the self pair is summed unmasked)")
    blkw = int(rj) * int(chunk)
    shape = xs.shape
    if int(chunk) <= 0 or blkw <= 0 or len(shape) != 1 or shape[0] % blkw or not (
            ys.shape == zs.shape == ms.shape == shape):
        raise ValueError(f"{fn}: chunk={chunk}, rj={rj} with channels "
                         f"{[tuple(t.shape) for t in (xs, ys, zs, ms)]} is outside the "
                         f"kernel's shapes (four [n_slots] channels, n_slots a multiple of "
                         f"rj * chunk)")


@functools.lru_cache(maxsize=16)
def _consts(r1: float, rc: float, G: float, eps2: float) -> tuple:
    """:func:`near_params` in the entry points' argument order."""
    k = near_params(r1, rc, G, eps2)
    return tuple(k[n] for n in ("sc", "neg_inv_d", "c60", "eps2", "G", "inv_eps", "h"))


def _sweep(xs, ys, zs, ms, blocks, off, stride: int, count, k_ch: int, *,
           r1: float, rc: float, G: float, eps2: float, chunk: int, rj: int,
           i0: int = None):
    """Launch the kernel: chunk c walks ``blocks[off[c] + q]`` for q <
    count[c], or without ``off`` and ``count`` the non-sentinel entries of
    row c of the table ``blocks [k_ch, stride]``; with ``i0`` (the
    ``near_sweep_rows`` entry) the i rows of chunk c are chunk i0 + c's.
    Returns (acc, pe) as the JAX wrappers do: views of one [k_ch * chunk, 4]
    output. The host's work a call is this function's: no tensor operation
    but the output's allocation and its two views where the inputs are
    already float32 channels of one stride and int32 blocks."""
    refuse_grad("near_acc_slots_cuda", xs, ys, zs, ms)
    c, blkw = int(chunk), int(rj) * int(chunk)
    cs = xs.stride(0)
    if ys.stride(0) != cs or zs.stride(0) != cs or ms.stride(0) != cs:
        xs, ys, zs, ms = (t.contiguous() for t in (xs, ys, zs, ms))
        cs = 1
    if blocks.dtype != torch.int32 or not blocks.is_contiguous():
        blocks = blocks.to(torch.int32).contiguous()
    dev = xs.device
    out = torch.empty((k_ch * c, 4), dtype=torch.float32, device=dev)
    lib = _lib or _load()
    head = (xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), ms.data_ptr(), cs, blocks.data_ptr(),
            None if off is None else off.data_ptr(), int(stride),
            None if count is None else count.data_ptr(), xs.shape[0] // blkw - 1)
    tail = (int(k_ch), c, blkw, *_consts(r1, rc, G, eps2), out.data_ptr(), stream_handle(dev),
            dev.index or 0)
    if i0 is None:
        check(lib, lib.near_sweep(*head, *tail), "near_sweep launch")
        near_acc_slots_cuda.launches += 1
    else:
        check(lib, lib.near_sweep_rows(*head, int(i0), *tail), "near_sweep_rows launch")
        near_acc_slots_rows_cuda.launches += 1
    return out[:, :3], out[:, 3]


def near_acc_slots_cuda(xs, ys, zs, ms, jbl, *, r1: float, rc: float, G: float,
                        eps2: float, chunk: int = 32, rj: int = 4):
    """The near sweep over the padded j-block table ``jbl [k_ch, w_blk]``
    (B8 and B11): each chunk walks its row's entries up to the first
    sentinel."""
    if xs.device.type == "cpu":
        return near_acc_slots(xs, ys, zs, ms, jbl, r1=r1, rc=rc, G=G, eps2=eps2,
                              chunk=chunk, rj=rj)
    _check("near_acc_slots_cuda", xs, ys, zs, ms, chunk, rj, eps2, jbl)
    k_ch, w_blk = jbl.shape
    if k_ch * int(chunk) > xs.shape[0]:
        raise ValueError(f"near_acc_slots_cuda: jbl has {k_ch} chunks of {chunk} rows for "
                         f"{xs.shape[0]} slots")
    return _sweep(xs, ys, zs, ms, jbl, None, w_blk, None, k_ch, r1=r1, rc=rc, G=G, eps2=eps2,
                  chunk=chunk, rj=rj)


near_acc_slots_cuda.launches = 0


def near_acc_slots_cuda_sb(xs, ys, zs, ms, jbl, i0=None, **kw):
    """``near_acc_slots_pallas_sb``'s counterpart (B10): the same launch as
    :func:`near_acc_slots_cuda`, or with ``i0`` as
    :func:`near_acc_slots_rows_cuda`."""
    if i0 is not None:
        return near_acc_slots_rows_cuda(xs, ys, zs, ms, jbl, i0=i0, **kw)
    return near_acc_slots_cuda(xs, ys, zs, ms, jbl, **kw)


def near_acc_slots_rows_cuda(xs, ys, zs, ms, jbl, *, i0: int, r1: float, rc: float,
                             G: float, eps2: float, chunk: int = 32, rj: int = 4):
    """The near sweep of the i chunks ``[i0, i0 + k_ch)`` only, ``jbl [k_ch,
    w_blk]`` their rows of the block table, against the whole j side: one
    mesh rank's share (``ops.neighbor.near_acc_slots(i0=)`` is its plain
    version). A rank's rows of an int32 table are a contiguous view of it,
    which the kernel reads in place. Returns (acc [k_ch * chunk, 3], pe
    [k_ch * chunk]) for those chunks."""
    kw = dict(r1=r1, rc=rc, G=G, eps2=eps2, chunk=chunk, rj=rj)
    if xs.device.type == "cpu":
        return near_acc_slots(xs, ys, zs, ms, jbl, i0=int(i0), **kw)
    _check("near_acc_slots_rows_cuda", xs, ys, zs, ms, chunk, rj, eps2, jbl)
    k_ch, w_blk = jbl.shape
    if (int(i0) + k_ch) * int(chunk) > xs.shape[0] or int(i0) < 0:
        raise ValueError(f"near_acc_slots_rows_cuda: chunks [{i0}, {int(i0) + k_ch}) of "
                         f"{chunk} rows for {xs.shape[0]} slots")
    return _sweep(xs, ys, zs, ms, jbl, None, w_blk, None, k_ch, i0=int(i0), **kw)


near_acc_slots_rows_cuda.launches = 0


def _wl_lists(wl_i, k_ch: int):
    """(count, off) per chunk from the worklist's chunk column, on its
    device: entries of chunk k_ch (the inert tail) go to a spare slot."""
    count = torch.zeros((k_ch + 1,), dtype=torch.int32, device=wl_i.device)
    count.scatter_add_(0, wl_i.long(), torch.ones_like(wl_i, dtype=torch.int32))
    count = count[:k_ch]
    off = (torch.cumsum(count, 0, dtype=torch.int32) - count).contiguous()
    return count.contiguous(), off


def near_acc_slots_wl_plain(xs, ys, zs, ms, wl_i, wl_jb, *, r1: float, rc: float,
                            G: float, eps2: float, chunk: int = 32, rj: int = 4):
    """The plain version of :func:`near_acc_slots_cuda_wl`, on any device:
    each chunk's worklist run laid out as a row of a table (sentinel past
    its count) and swept by ``near_acc_slots``. Reads the longest run back
    to size the table."""
    c, rjn = int(chunk), int(rj)
    k_ch = xs.shape[0] // c - rjn
    count, off = _wl_lists(wl_i, k_ch)
    k = torch.arange(max(int(count.max()), 1), device=xs.device)
    idx = torch.clamp(off[:, None].long() + k, max=wl_jb.shape[0] - 1)
    table = torch.where(k < count[:, None], wl_jb[idx], k_ch // rjn)
    return near_acc_slots(xs, ys, zs, ms, table, r1=r1, rc=rc, G=G, eps2=eps2,
                          chunk=c, rj=rjn)


def near_acc_slots_cuda_wl(xs, ys, zs, ms, wl_i, wl_jb, *, r1: float, rc: float,
                           G: float, eps2: float, chunk: int = 32, rj: int = 4):
    """``near_acc_slots_pallas_wl``'s counterpart (B9), from the compacted
    worklist ``(wl_i, wl_jb)`` of ``neighbor_geometry(..., wl_entries=)``.
    The acc rows of chunks the worklist does not visit are 0."""
    kw = dict(r1=r1, rc=rc, G=G, eps2=eps2, chunk=chunk, rj=rj)
    if xs.device.type == "cpu":
        return near_acc_slots_wl_plain(xs, ys, zs, ms, wl_i, wl_jb, **kw)
    _check("near_acc_slots_cuda_wl", xs, ys, zs, ms, chunk, rj, eps2, wl_i, wl_jb)
    k_ch = xs.shape[0] // int(chunk) - int(rj)
    count, off = _wl_lists(wl_i, k_ch)
    return _sweep(xs, ys, zs, ms, wl_jb, off, 0, count, k_ch, **kw)
