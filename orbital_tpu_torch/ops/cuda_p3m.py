"""The hand-written CUDA short-range sum of P3M (``csrc/p3m_short.cu``).

No Pallas kernel carries P3M's short range: the JAX module runs it as a plain
XLA ``lax.map`` over cell blocks of [cell_block, M, 27 M] masked tiles
(``orbital_tpu/ops/p3m.py:181-231``). Torch has no fused op for it, and the
plain tile form spends ~95x the needed pair work in temporaries at the bench
row, so on the card it is a hand kernel. :func:`p3m_short_cuda` takes the cell
table of ``ops.p3m.p3m_cell_table`` and returns (acc [n, 3], pe [n]) as
:func:`ops.p3m.p3m_short_plain` does: G sum m_j g (r_j - r_i) and sum m_j
K_short over the pairs of each kept body with the kept bodies of its 27
neighbour cells inside rcut, bodies without a slot 0.

For CPU tensors the wrapper computes the plain version. For CUDA tensors it
launches the kernel or raises; it never falls back. ``.launches`` counts its
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .p3m import p3m_short_plain

__all__ = ["p3m_short_cuda", "p3m_short_plain"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("p3m_short")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.p3m_short.restype = ctypes.c_int
        lib.p3m_short.argtypes = [p, p, p, p, i, i, p, f, f, p, p, p, i]
        _lib = lib
    return _lib


def p3m_short_cuda(table: torch.Tensor, cell_pos: torch.Tensor, cell_m: torch.Tensor, *,
                   count: torch.Tensor, gc: int, n: int, G: float, sigma, rcut2, eps2: float,
                   cell_block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """The short-range sum over the cell table ``table`` [gc^3 + 1, M] (body
    indices, n in empty slots), ``cell_pos`` [gc^3 + 1, M, 3] and ``cell_m``
    [gc^3 + 1, M], each cell's kept bodies a prefix of its row (``count``
    [gc^3] of them, which only the kernel reads). ``sigma`` and ``rcut2`` may
    be 0-dim tensors on the device. ``cell_block`` is the plain version's
    cells a block. Returns (acc [n, 3], pe [n]) in float32."""
    if table.device.type == "cpu":
        return p3m_short_plain(table, cell_pos, cell_m, gc=gc, n=n, G=G, sigma=sigma,
                               rcut2=rcut2, eps2=eps2, cell_block=cell_block)
    if table.device.type != "cuda":
        raise ValueError(f"p3m_short_cuda: unsupported device {table.device}")
    if eps2 <= 0.0:
        raise ValueError("p3m_short_cuda requires eps2 > 0")
    gc3 = gc ** 3
    cap = table.shape[1]
    if (table.shape[0] != gc3 + 1 or cell_pos.shape != (gc3 + 1, cap, 3)
            or cell_m.shape != (gc3 + 1, cap)):
        raise ValueError(f"p3m_short_cuda: need table [{gc3 + 1}, M], cell_pos [{gc3 + 1}, M, "
                         f"3] and cell_m [{gc3 + 1}, M], got {tuple(table.shape)}, "
                         f"{tuple(cell_pos.shape)} and {tuple(cell_m.shape)}")
    if cell_pos.dtype != torch.float32 or cell_m.dtype != torch.float32:
        raise TypeError("p3m_short_cuda computes in float32")
    if any(t.device != table.device for t in (cell_pos, cell_m)):
        raise ValueError("p3m_short_cuda: all tensors must be on one device")
    dev = table.device
    if count.shape != (gc3,) or count.device != dev:
        raise ValueError(f"p3m_short_cuda: need count [{gc3}] on {dev}")
    count = count.to(torch.int32).contiguous()
    table = table.to(torch.int64).contiguous()
    # the kernel's constants [rcut^2, alpha = 1 / (2 sigma)] on the device, so
    # that a sigma computed there is not read back
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    params = torch.stack([torch.as_tensor(rcut2, dtype=torch.float32, device=dev),
                          1.0 / (2.0 * sigma)])
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pe = torch.zeros((n,), dtype=torch.float32, device=dev)
    lib = _load()
    from ..utils.kernels import check

    stream = torch.cuda.current_stream(dev).cuda_stream
    cell_pos, cell_m = cell_pos.contiguous(), cell_m.contiguous()
    err = lib.p3m_short(cell_pos.data_ptr(), cell_m.data_ptr(), table.data_ptr(),
                        count.data_ptr(), int(gc), int(cap), params.data_ptr(), float(G),
                        float(eps2), acc.data_ptr(), pe.data_ptr(), stream, dev.index or 0)
    check(lib, err, "p3m_short launch")
    p3m_short_cuda.launches += 1
    return acc, pe


p3m_short_cuda.launches = 0
