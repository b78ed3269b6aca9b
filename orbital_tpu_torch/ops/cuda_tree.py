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
across the ranks: :func:`tree_near_part_cuda` (B7's slice) clips the runs to
one rank's span of the flat worklist (``ops.tree_near_wl.clip_runs``, the
JAX module's ``q_part`` slice) and launches the same kernel over them, so
that every entry is swept by exactly one rank.

For CPU tensors the wrappers compute the plain version,
``ops.tree_near_wl.tree_near_plain`` (over the clipped runs for the slice);
for CUDA tensors they launch the kernel or raise, and never fall back.
``tree_near_cuda.launches`` and ``tree_near_part_cuda.launches`` count each
wrapper's launches.
"""
from __future__ import annotations

import ctypes

import torch

from .tree_near_wl import clip_runs, tree_near_plain
from ..utils.kernels import refuse_grad

__all__ = ["tree_near_cuda", "tree_near_part_cuda"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("tree_near")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tree_near.restype = ctypes.c_int
        lib.tree_near.argtypes = [p, p, p, i, i, i, i, f, f, p, p, i]
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
    out = _launch("tree_near_cuda", pbods, start_blk, n_blk, chunk=chunk, rj=rj, ws=ws,
                  eps2=eps2)
    tree_near_cuda.launches += 1
    return out


tree_near_cuda.launches = 0


def tree_near_part_cuda(pbods: torch.Tensor, start_blk: torch.Tensor, n_blk: torch.Tensor,
                        *, span: tuple[int, int], wl_entries: int, chunk: int, rj: int,
                        ws: int, eps2: float) -> torch.Tensor:
    """B7's slice: :func:`tree_near_cuda` over only the worklist entries
    ``span = (lo, hi)`` of the flat worklist (``ops.tree_near_wl.wl_span``),
    the runs clipped to it. Returns ``[k_ch * chunk, 4]`` per slot, the sums
    of the slice's entries alone."""
    start_blk, n_blk = clip_runs(start_blk, n_blk, *span)
    if pbods.device.type == "cpu":
        return tree_near_plain(pbods, start_blk, n_blk, wl_entries=wl_entries, chunk=chunk,
                               rj=rj, ws=ws, eps2=eps2)
    out = _launch("tree_near_part_cuda", pbods, start_blk, n_blk, chunk=chunk, rj=rj, ws=ws,
                  eps2=eps2)
    tree_near_part_cuda.launches += 1
    return out


tree_near_part_cuda.launches = 0


def _launch(fn: str, pbods, start_blk, n_blk, *, chunk: int, rj: int, ws: int,
            eps2: float) -> torch.Tensor:
    if pbods.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {pbods.device}")
    refuse_grad(fn, pbods)
    if pbods.dtype != torch.float32:
        raise TypeError(f"{fn} computes in float32, got {pbods.dtype}")
    if start_blk.device != pbods.device or n_blk.device != pbods.device:
        raise ValueError(f"{fn}: all tensors must be on one device")
    c, blkw = int(chunk), int(rj) * int(chunk)
    k_ch, n_nb = n_blk.shape
    if (pbods.dim() != 2 or pbods.shape[1] != 8 or c <= 0 or pbods.shape[0] % blkw
            or pbods.shape[0] < (k_ch + 1) * c):
        raise ValueError(f"{fn}: table {tuple(pbods.shape)} with chunk={c}, rj={rj} is "
                         f"outside the kernel's shapes ([kpad * chunk, 8] rows, kpad a "
                         f"multiple of rj above k_ch={k_ch})")
    count = n_blk.to(torch.int32).contiguous()
    start = start_blk.to(torch.int32).contiguous()
    rows = pbods.contiguous()
    out = torch.empty((k_ch * c, 4), dtype=torch.float32, device=pbods.device)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(pbods.device).cuda_stream
    err = lib.tree_near(rows.data_ptr(), start.data_ptr(), count.data_ptr(), int(k_ch),
                        int(n_nb), c, blkw, float(ws), float(eps2), out.data_ptr(), stream,
                        pbods.device.index or 0)
    check(lib, err, "tree_near launch")
    return out
