"""The hand-written CUDA near-field sweep of the tree solver
(``csrc/tree_near.cu``, B7).

Replaces ``orbital_tpu/ops/tree_near_wl.py``'s Pallas worklist kernel
(``_wl_kernel`` with ``_entry_math``). The kernel takes each i-chunk's block
runs ``(start_blk, n_blk)`` of ``_wl_runs`` and walks them itself, one block
per 32-row slice of a chunk; the chunks that the worklist budget drops come
with count 0 (``ops.tree_near_wl._wl_table`` zeroes them), so it sums exactly
the entries of the TPU kernel's worklist. It visits only the chunk's live
rows against the staged rows inside the chunk's cell box (a pair outside it
fails the band and adds exactly 0; see the note at the top of the source).
It writes one (ax, ay, az, pe) row per slot, acc without G.

The body-sharded tree (``ops.tree.tree_sharded_force``) splits the worklist
across the ranks: :func:`tree_near_part_cuda` (B7's slice) passes the runs'
exclusive offsets in the flat worklist (``_wl_table``'s ``off``) and one
rank's span of it (``ops.tree_near_wl.wl_span``, the JAX module's ``q_part``
slice), and each block of the same kernel cuts its chunk's runs to the span
in its prologue (a chunk with no entry in it writes zeros and returns), so
that every entry is swept by exactly one rank and nothing runs on the
device between the table and the launch. :func:`tree_near_cuda` is the same
entry over the whole worklist.

For CPU tensors the wrappers compute the plain versions,
``ops.tree_near_wl.tree_near_plain`` and (the runs clipped by
``clip_runs`` from the same offsets) :func:`tree_near_part_plain`; for CUDA
tensors they launch the kernel or raise, and never fall back. The runs and
offsets are read in place where they are int32 and contiguous, as
``_wl_table`` makes them. ``tree_near_cuda.launches`` and
``tree_near_part_cuda.launches`` count each wrapper's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .tree_near_wl import clip_runs, tree_near_plain
from ..utils.kernels import refuse_grad

__all__ = ["tree_near_cuda", "tree_near_part_cuda", "tree_near_part_plain"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("tree_near")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tree_near_span.restype = ctypes.c_int
        lib.tree_near_span.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, p, p, i]
        _lib = lib
    return _lib


def tree_near_cuda(pbods: torch.Tensor, start_blk: torch.Tensor, n_blk: torch.Tensor, *,
                   wl_entries: int, chunk: int, rj: int, ws: int,
                   eps2: float) -> torch.Tensor:
    """The tree's near sweep over the slot-major body table ``pbods [kpad *
    chunk, 8]`` (x y z m idx cx cy cz) and the block runs ``start_blk,
    n_blk [k_ch, (2ws+1)^2]``, the counts of the chunks that the worklist
    budget ``wl_entries`` drops already 0 (``ops.tree_near_wl._wl_table``).
    Returns ``[k_ch * chunk, 4]`` (ax, ay, az, pe) per slot, acc without G;
    the slots of dropped and empty chunks are 0."""
    kw = dict(wl_entries=wl_entries, chunk=chunk, rj=rj, ws=ws, eps2=eps2)
    if pbods.device.type == "cpu":
        return tree_near_plain(pbods, start_blk, n_blk, **kw)
    out = _launch("tree_near_cuda", pbods, start_blk, n_blk, None, (0, 0), chunk=chunk,
                  rj=rj, ws=ws, eps2=eps2)
    tree_near_cuda.launches += 1
    return out


tree_near_cuda.launches = 0


def tree_near_part_plain(pbods, start_blk, n_blk, off, *, span: tuple[int, int],
                         wl_entries: int, chunk: int, rj: int, ws: int, eps2: float):
    """The plain version of B7's slice, on any device: the runs clipped to
    ``span`` from their offsets ``off`` (``ops.tree_near_wl.clip_runs``),
    then :func:`~.tree_near_wl.tree_near_plain` over them."""
    start_blk, n_blk = clip_runs(start_blk, n_blk, *span, off=off)
    return tree_near_plain(pbods, start_blk, n_blk, wl_entries=wl_entries, chunk=chunk,
                           rj=rj, ws=ws, eps2=eps2)


def tree_near_part_cuda(pbods: torch.Tensor, start_blk: torch.Tensor, n_blk: torch.Tensor,
                        off: torch.Tensor, *, span: tuple[int, int], wl_entries: int,
                        chunk: int, rj: int, ws: int, eps2: float) -> torch.Tensor:
    """B7's slice: :func:`tree_near_cuda` over only the worklist entries
    ``span = (lo, hi)`` of the flat worklist (``ops.tree_near_wl.wl_span``),
    each run cut to it inside the kernel from ``off`` [k_ch, (2ws+1)^2],
    the runs' exclusive offsets in the chunk-major worklist (``_wl_table``'s
    ``off``). Returns ``[k_ch * chunk, 4]`` per slot, the sums of the
    slice's entries alone."""
    if pbods.device.type == "cpu":
        return tree_near_part_plain(pbods, start_blk, n_blk, off, span=span,
                                    wl_entries=wl_entries, chunk=chunk, rj=rj, ws=ws,
                                    eps2=eps2)
    out = _launch("tree_near_part_cuda", pbods, start_blk, n_blk, off, span, chunk=chunk,
                  rj=rj, ws=ws, eps2=eps2)
    tree_near_part_cuda.launches += 1
    return out


tree_near_part_cuda.launches = 0


def _int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it is int32 and contiguous, else such a copy."""
    return t if t.dtype == torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()


def _launch(fn: str, pbods, start_blk, n_blk, off: Optional[torch.Tensor],
            span: tuple[int, int], *, chunk: int, rj: int, ws: int,
            eps2: float) -> torch.Tensor:
    if pbods.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {pbods.device}")
    refuse_grad(fn, pbods)
    if pbods.dtype != torch.float32:
        raise TypeError(f"{fn} computes in float32, got {pbods.dtype}")
    runs = (start_blk, n_blk) + (() if off is None else (off,))
    if any(t.device != pbods.device for t in runs):
        raise ValueError(f"{fn}: all tensors must be on one device")
    c, blkw = int(chunk), int(rj) * int(chunk)
    k_ch, n_nb = n_blk.shape
    if (pbods.dim() != 2 or pbods.shape[1] != 8 or c <= 0 or pbods.shape[0] % blkw
            or pbods.shape[0] < (k_ch + 1) * c or start_blk.shape != n_blk.shape
            or (off is not None and off.shape != n_blk.shape)):
        raise ValueError(f"{fn}: table {tuple(pbods.shape)} with chunk={c}, rj={rj} and runs "
                         f"{tuple(n_blk.shape)} are outside the kernel's shapes ([kpad * "
                         f"chunk, 8] rows, kpad a multiple of rj above k_ch={k_ch}; start, "
                         f"count and offsets alike)")
    start, count = _int32(start_blk), _int32(n_blk)
    offs = None if off is None else _int32(off)
    rows = pbods.contiguous()
    out = torch.empty((k_ch * c, 4), dtype=torch.float32, device=pbods.device)

    lib = _load()
    from ..utils.kernels import check, stream_handle

    err = lib.tree_near_span(rows.data_ptr(), start.data_ptr(), count.data_ptr(),
                             None if offs is None else offs.data_ptr(), int(span[0]),
                             int(span[1]), int(k_ch), int(n_nb), c, blkw, float(ws),
                             float(eps2), out.data_ptr(), stream_handle(pbods.device),
                             pbods.device.index)
    check(lib, err, "tree_near_span launch")
    return out
