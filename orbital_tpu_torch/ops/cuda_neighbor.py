"""The hand-written CUDA near-field sweep of the multirate stepper
(``csrc/neighbor.cu``).

Replaces the four TPU schedules of ``orbital_tpu/ops/neighbor_pallas.py``
with one kernel, behind wrappers named after their counterparts and with
their contracts (slot-space channels in, ``(acc [k_ch * chunk, 3], pe
[k_ch * chunk])`` out in slot order, the self-PE term m_i/eps subtracted
here):

  * :func:`near_acc_slots_cuda`: ``near_acc_slots_pallas`` over the padded
    j-block table ``jbl``, both its streaming (B8) and resident (B11)
    kernels. The kernel walks each row's live prefix, counted here as the
    row's non-sentinel entries, so the two schedules are one and there is
    no ``resident`` knob.
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

For CPU tensors the wrappers compute the plain versions: ``ops.neighbor.
near_acc_slots`` over ``jbl``, and for the worklist
:func:`near_acc_slots_wl_plain`, which rebuilds each chunk's list as a table
and sweeps it the same way. For CUDA tensors they launch the kernel or
raise; they never fall back. ``near_acc_slots_cuda.launches`` counts the
kernel's launches through every adapter.
"""
from __future__ import annotations

import ctypes

import torch

from .neighbor import near_acc_slots

__all__ = ["near_acc_slots_cuda", "near_acc_slots_cuda_sb", "near_acc_slots_cuda_wl",
           "near_acc_slots_wl_plain"]

# the kernel's block size and staged rows (csrc/neighbor.cu)
_THREADS = 256
_STAGE_ROWS = 1024

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("neighbor")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.near_sweep.restype = ctypes.c_int
        lib.near_sweep.argtypes = [p, p, p, i, p, i, i, i, f, f, f, f, f, p, p, i]
        _lib = lib
    return _lib


def _check(fn: str, xs, chunk: int, rj: int, *others) -> None:
    if xs.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {xs.device}")
    if xs.dtype != torch.float32:
        raise TypeError(f"{fn} computes in float32, got {xs.dtype}")
    if any(t.device != xs.device for t in others):
        raise ValueError(f"{fn}: all tensors must be on one device")
    blkw = rj * chunk
    groups = max(1, _THREADS // chunk)
    smem = 16 * (max(1, _STAGE_ROWS // blkw) * blkw + chunk * groups)
    if chunk > _THREADS or smem > 48 * 1024 or xs.shape[0] % blkw:
        raise ValueError(f"{fn}: chunk={chunk}, rj={rj} with {xs.shape[0]} slots is outside "
                         f"the kernel's shapes (chunk <= {_THREADS}, staged rows <= 48 KB)")


def _sweep(xs, ys, zs, ms, blocks, off, stride: int, count, k_ch: int, *,
           r1: float, rc: float, G: float, eps2: float, chunk: int, rj: int):
    """Launch the kernel: chunk c walks ``blocks[off[c] + q]`` (``c * stride
    + q`` without ``off``) for q < count[c]. Returns (acc, pe) as the JAX
    wrappers do."""
    c = int(chunk)
    pts = torch.stack([xs, ys, zs, ms], dim=1).contiguous()      # [n_slots, 4]
    out = torch.empty((k_ch * c, 4), dtype=torch.float32, device=xs.device)
    inv_d = 1.0 / (rc * rc - r1 * r1)

    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = lib.near_sweep(pts.data_ptr(), blocks.data_ptr(),
                         None if off is None else off.data_ptr(), int(stride),
                         count.data_ptr(), int(k_ch), c, int(rj) * c, float(rc * rc),
                         float(inv_d), float(30.0 * inv_d), float(eps2), float(G),
                         out.data_ptr(), stream, xs.device.index or 0)
    check(lib, err, "near_sweep launch")
    near_acc_slots_cuda.launches += 1
    pe = out[:, 3] - ms[:k_ch * c] * (float(eps2) ** -0.5)
    return out[:, :3], pe


def near_acc_slots_cuda(xs, ys, zs, ms, jbl, *, r1: float, rc: float, G: float,
                        eps2: float, chunk: int = 32, rj: int = 4):
    """The near sweep over the padded j-block table ``jbl [k_ch, w_blk]``
    (B8 and B11): each chunk walks its row's entries up to the first
    sentinel."""
    if xs.device.type == "cpu":
        return near_acc_slots(xs, ys, zs, ms, jbl, r1=r1, rc=rc, G=G, eps2=eps2,
                              chunk=chunk, rj=rj)
    _check("near_acc_slots_cuda", xs, chunk, rj, ys, zs, ms, jbl)
    k_ch, w_blk = jbl.shape
    sentinel = xs.shape[0] // (rj * chunk) - 1
    jbl = jbl.to(torch.int32).contiguous()
    count = torch.sum(jbl != sentinel, dim=1, dtype=torch.int32)
    return _sweep(xs, ys, zs, ms, jbl, None, w_blk, count, k_ch, r1=r1, rc=rc, G=G,
                  eps2=eps2, chunk=chunk, rj=rj)


near_acc_slots_cuda.launches = 0


def near_acc_slots_cuda_sb(xs, ys, zs, ms, jbl, **kw):
    """``near_acc_slots_pallas_sb``'s counterpart (B10): the same launch as
    :func:`near_acc_slots_cuda`."""
    return near_acc_slots_cuda(xs, ys, zs, ms, jbl, **kw)


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
    Rows of chunks the worklist does not visit are 0."""
    kw = dict(r1=r1, rc=rc, G=G, eps2=eps2, chunk=chunk, rj=rj)
    if xs.device.type == "cpu":
        return near_acc_slots_wl_plain(xs, ys, zs, ms, wl_i, wl_jb, **kw)
    _check("near_acc_slots_cuda_wl", xs, chunk, rj, ys, zs, ms, wl_i, wl_jb)
    k_ch = xs.shape[0] // int(chunk) - int(rj)
    count, off = _wl_lists(wl_i, k_ch)
    return _sweep(xs, ys, zs, ms, wl_jb.to(torch.int32).contiguous(), off, 0, count, k_ch,
                  **kw)
