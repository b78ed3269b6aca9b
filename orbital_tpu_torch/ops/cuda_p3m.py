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

On CUDA tensors the wrapper first reorders each cell's kept prefix for the
kernel (:func:`p3m_short_order_cuda`, a second kernel of the same source,
whose plain version is :func:`p3m_short_order`: by the Morton code of an 8^3
split of the cell's bounding box, cut into its 8 top-level octant runs with
their boxes), so that a 32-row slice of a cell spans a small box and the
kernel visits only the rows within reach of it. The table itself
(``p3m_cell_table``'s output, which the overflow and the kept bodies come
from) is not changed.

The body-sharded ring (``ops.p3m.p3m_ring_force``) takes the kernel's
two-table form, :func:`p3m_short_pair_cuda`: this rank's table (reordered
once an evaluation) against a visiting rank's table (reordered once a
round), both binned on the same global grid. Its plain version is
``ops.p3m.p3m_short_pair_plain``, which skips self pairs by global id as the
JAX ring does; the kernel skips them by slot in the diagonal round (one
table for both sides), which leaves out the same pairs.

For CPU tensors the wrappers compute the plain versions. For CUDA tensors
they launch the kernel or raise; they never fall back. ``.launches`` counts
each wrapper's launches of the sum kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .p3m import p3m_short_pair_plain, p3m_short_plain
from ..utils.kernels import refuse_grad

__all__ = ["p3m_short_cuda", "p3m_short_plain", "p3m_short_order", "p3m_short_order_cuda",
           "p3m_short_pair_cuda", "p3m_short_pair_plain"]

# sub-cells a side of the Morton order (3 bits an axis); the runs are the
# 8 top-level octants
SUB = 8
_OCT = 8

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("p3m_short")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.p3m_short_sorted.restype = ctypes.c_int
        lib.p3m_short_sorted.argtypes = [p, p, p, p, i, i, p, f, f, p, p, p, i]
        lib.p3m_short_pair.restype = ctypes.c_int
        lib.p3m_short_pair.argtypes = [p, p, p, p, p, p, i, i, i, p, f, f, p, p, p, i]
        lib.p3m_short_order.restype = ctypes.c_int
        lib.p3m_short_order.argtypes = [p, p, p, p, i, i, p, p, p, p, p, i]
        lib.p3m_short_shape.restype = None
        lib.p3m_short_shape.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


def p3m_short_order(table: torch.Tensor, cell_pos: torch.Tensor, cell_m: torch.Tensor,
                    count: torch.Tensor, gc: int) -> dict:
    """The kernel's view of the cell table, on the table's device: each
    cell's kept prefix (``count`` [gc^3] rows; the pad row dropped) sorted
    stably by the Morton code of its rows in an 8^3 split of the prefix's
    bounding box, and cut into the runs of the 8 top-level octants.

    Returns ``rows`` [gc^3, M, 4] (x, y, z, m), ``table`` [gc^3, M] (body
    indices), ``perm`` [gc^3, M] (the permutation of each row: new slot k
    holds old slot perm[k]; slots past the prefix keep their place; the
    kernel returns no ``perm``),
    ``run_off`` [gc^3, 9] int32 (the first row of each octant run;
    run_off[:, 8] = count) and ``run_box`` [gc^3, 8, 6] float32 (the min x,
    y, z and max x, y, z of each run's rows, +inf and -inf for an empty
    run)."""
    gc3, cap, dev = gc ** 3, table.shape[1], table.device
    f32 = torch.float32
    # no host-to-device copy here: it would wait for the stream to drain
    valid = torch.arange(cap, device=dev)[None, :] < count[:, None]            # [gc3, M]
    pos = cell_pos[:gc3].to(f32)
    # empty slots hold SENTINEL, above every live coordinate
    lo = pos.amin(1)                                                          # [gc3, 3]
    hi = torch.where(valid[..., None], pos, float("-inf")).amax(1)
    scale = SUB / (hi - lo).clamp(min=1e-30)
    q = torch.clamp(torch.floor((pos - lo[:, None]) * scale[:, None]), 0, SUB - 1).long()
    spread = (q & 1) | ((q & 2) << 2) | ((q & 4) << 4)                       # [gc3, M, 3]
    key = (spread[..., 0] << 2) | (spread[..., 1] << 1) | spread[..., 2]
    key = torch.where(valid, key, SUB ** 3)
    key, perm = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(0, SUB ** 3 + 1, SUB ** 3 // _OCT, device=dev)
    run_off = torch.searchsorted(key, bounds.expand(gc3, -1).contiguous()).to(torch.int32)
    rows = torch.cat([pos, cell_m[:gc3, :, None].to(f32)], dim=-1)
    rows = torch.gather(rows, 1, perm[..., None].expand(-1, -1, 4))
    # each run's box: octant 8 takes the slots past the prefix
    seg = (torch.arange(0, gc3 * (_OCT + 1), _OCT + 1, device=dev)[:, None]
           + (key >> 6)).reshape(-1, 1).expand(-1, 3)
    flat = rows[..., :3].reshape(-1, 3)
    box = torch.empty((2, gc3 * (_OCT + 1), 3), dtype=f32, device=dev)
    box[0].fill_(float("inf")).scatter_reduce_(0, seg, flat, "amin")
    box[1].fill_(float("-inf")).scatter_reduce_(0, seg, flat, "amax")
    run_box = box.reshape(2, gc3, _OCT + 1, 3)[:, :, :_OCT].permute(1, 2, 0, 3)
    return dict(rows=rows, table=torch.gather(table[:gc3], 1, perm), perm=perm,
                run_off=run_off, run_box=run_box.reshape(gc3, _OCT, 6).contiguous())


def p3m_short_reach2(rcut2: float) -> float:
    """The bound of the kernel's reach test, as it rounds it: rcut^2 (float32)
    times 1 + 2^-20, rounded up. The kernel visits a row only if its squared
    distance to the slice's box (the rows' min and max on each axis),
    computed with every operation rounded down, is below it; a row at or
    beyond it has an f32 r^2 > rcut^2 with every row of the slice."""
    import numpy as np

    r = np.float32(float(np.float32(rcut2)) * (1.0 + 2.0 ** -20))
    exact = float(np.float32(rcut2)) * (1.0 + 2.0 ** -20)
    return float(np.nextafter(r, np.float32(np.inf)) if float(r) < exact else r)


def p3m_short_order_cuda(table: torch.Tensor, cell_pos: torch.Tensor, cell_m: torch.Tensor,
                         count: torch.Tensor, gc: int) -> dict:
    """:func:`p3m_short_order` as the kernel ``p3m_order_kernel`` computes it
    (one block a cell): ``rows`` and ``table`` equal to the plain version's,
    bit for bit, on each cell's kept prefix and not written past it (the sum
    reads no slot there), ``run_off`` and ``run_box`` equal throughout, and
    no ``perm``. CPU tensors take :func:`p3m_short_order`; ``.launches``
    counts the kernel's launches."""
    if table.device.type == "cpu":
        return p3m_short_order(table, cell_pos, cell_m, count, gc)
    if table.device.type != "cuda":
        raise ValueError(f"p3m_short_order_cuda: unsupported device {table.device}")
    refuse_grad("p3m_short_order_cuda", cell_pos, cell_m)
    from ..utils.kernels import check

    gc3, cap, dev = gc ** 3, table.shape[1], table.device
    f32, i64 = torch.float32, torch.int64
    rows = torch.empty((gc3, cap, 4), dtype=f32, device=dev)
    table_s = torch.empty((gc3, cap), dtype=i64, device=dev)
    run_off = torch.empty((gc3, _OCT + 1), dtype=torch.int32, device=dev)
    run_box = torch.empty((gc3, _OCT, 6), dtype=f32, device=dev)
    ins = (cell_pos[:gc3].to(f32).contiguous(), cell_m[:gc3].to(f32).contiguous(),
           table[:gc3].to(i64).contiguous(), count.to(torch.int32).contiguous())
    lib = _load()
    err = lib.p3m_short_order(*(t.data_ptr() for t in ins), int(gc), int(cap),
                              rows.data_ptr(), table_s.data_ptr(), run_off.data_ptr(),
                              run_box.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    check(lib, err, "p3m_short_order launch")
    p3m_short_order_cuda.launches += 1
    return dict(rows=rows, table=table_s, run_off=run_off, run_box=run_box)


p3m_short_order_cuda.launches = 0


def p3m_short_shape(gc: int, cap: int) -> dict:
    """The kernel's launch shape at gc cells a side and capacity ``cap``:
    rows a block slice, warps, buffered rows that start a sweep, threads a
    block, blocks."""
    shape = (ctypes.c_int * 5)()
    _load().p3m_short_shape(int(gc), int(cap), shape)
    return dict(zip(("slice_rows", "warps", "sweep_rows", "threads", "blocks"), shape))


def p3m_short_cuda(table: torch.Tensor, cell_pos: torch.Tensor, cell_m: torch.Tensor, *,
                   count: torch.Tensor, gc: int, n: int, G: float, sigma, rcut2, eps2: float,
                   cell_block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """The short-range sum over the cell table ``table`` [gc^3 + 1, M] (body
    indices, n in empty slots), ``cell_pos`` [gc^3 + 1, M, 3] and ``cell_m``
    [gc^3 + 1, M], each cell's kept bodies a prefix of its row (``count``
    [gc^3] of them, which only the kernel's reorder reads). ``sigma`` and ``rcut2`` may
    be 0-dim tensors on the device. ``cell_block`` is the plain version's
    cells a block. Returns (acc [n, 3], pe [n]) in float32."""
    if table.device.type == "cpu":
        return p3m_short_plain(table, cell_pos, cell_m, gc=gc, n=n, G=G, sigma=sigma,
                               rcut2=rcut2, eps2=eps2, cell_block=cell_block)
    _check_table("p3m_short_cuda", table, cell_pos, cell_m, count, gc, eps2)
    dev = table.device
    params = _params(sigma, rcut2, dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pe = torch.zeros((n,), dtype=torch.float32, device=dev)
    _launch(table.to(torch.int64), cell_pos, cell_m, count, gc, params, float(G), float(eps2),
            acc, pe)
    p3m_short_cuda.launches += 1
    return acc, pe


def _check_table(fn: str, table, cell_pos, cell_m, count, gc: int, eps2: float) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {table.device}")
    refuse_grad(fn, cell_pos, cell_m)
    if eps2 <= 0.0:
        raise ValueError(f"{fn} requires eps2 > 0")
    gc3 = gc ** 3
    cap = table.shape[1]
    if (table.shape[0] != gc3 + 1 or cell_pos.shape != (gc3 + 1, cap, 3)
            or cell_m.shape != (gc3 + 1, cap)):
        raise ValueError(f"{fn}: need table [{gc3 + 1}, M], cell_pos [{gc3 + 1}, M, "
                         f"3] and cell_m [{gc3 + 1}, M], got {tuple(table.shape)}, "
                         f"{tuple(cell_pos.shape)} and {tuple(cell_m.shape)}")
    if cell_pos.dtype != torch.float32 or cell_m.dtype != torch.float32:
        raise TypeError(f"{fn} computes in float32")
    if any(t.device != table.device for t in (cell_pos, cell_m)):
        raise ValueError(f"{fn}: all tensors must be on one device")
    if count.shape != (gc3,) or count.device != table.device:
        raise ValueError(f"{fn}: need count [{gc3}] on {table.device}")


def _params(sigma, rcut2, dev) -> torch.Tensor:
    """The kernel's constants [rcut^2, alpha = 1 / (2 sigma)] on the device,
    so that a sigma computed there is not read back."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    return torch.stack([torch.as_tensor(rcut2, dtype=torch.float32, device=dev),
                        1.0 / (2.0 * sigma)])


def _gid_table(table: torch.Tensor, gid: torch.Tensor, empty: int) -> torch.Tensor:
    """Global ids of a table's slots (``empty`` where the slot holds n)."""
    n = gid.shape[0]
    ext = torch.cat([gid.to(torch.int64), torch.full((1,), empty, dtype=torch.int64,
                                                     device=gid.device)])
    return ext[torch.clamp(table, max=n)]


def p3m_short_pair_cuda(tab_i: dict, tab_j: dict, gid_i: torch.Tensor, gid_j: torch.Tensor, *,
                        gc: int, n: int, G: float, sigma, rcut2, eps2: float,
                        order_i: dict = None, cell_block: int = 32
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of the P3M ring: the kept bodies of ``tab_i`` (this rank's
    ``ops.p3m.p3m_cell_table``, its ``n`` bodies' global ids ``gid_i``)
    against the kept bodies of ``tab_j`` (a visiting shard's table on the
    same grid, global ids ``gid_j``) in the 27 cells around each, pairs with
    r^2 < rcut2 and different global ids. ``tab_j is tab_i`` (with
    ``gid_j is gid_i``) is the diagonal round. ``order_i``, the kernel's
    order of ``tab_i`` (``p3m_short_order_cuda``), may be passed in so that
    the ring reorders its own table once. Returns (acc [n, 3], pe [n]) in
    float32 as :func:`p3m_short_cuda` does."""
    diag = tab_j is tab_i
    if diag != (gid_j is gid_i):
        raise ValueError("p3m_short_pair_cuda: the diagonal round passes one table and one "
                         "id vector for both sides")
    if tab_i["table"].device.type == "cpu":
        return p3m_short_pair_plain(
            tab_i["table"], tab_i["cell_pos"], _gid_table(tab_i["table"], gid_i, -2),
            tab_j["cell_pos"], tab_j["cell_m"],
            _gid_table(tab_j["table"], gid_j, -1), gc=gc, n=n, G=G, sigma=sigma,
            rcut2=rcut2, eps2=eps2, cell_block=cell_block)
    for tab in (tab_i, tab_j):
        _check_table("p3m_short_pair_cuda", tab["table"], tab["cell_pos"], tab["cell_m"],
                     tab["count"], gc, eps2)
    if tab_j["table"].shape != tab_i["table"].shape:
        raise ValueError("p3m_short_pair_cuda: the two tables need one grid and capacity")
    dev = tab_i["table"].device
    if order_i is None:
        order_i = p3m_short_order_cuda(tab_i["table"], tab_i["cell_pos"], tab_i["cell_m"],
                                       tab_i["count"], gc)
    order_j = order_i if diag else p3m_short_order_cuda(
        tab_j["table"], tab_j["cell_pos"], tab_j["cell_m"], tab_j["count"], gc)
    params = _params(sigma, rcut2, dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pe = torch.zeros((n,), dtype=torch.float32, device=dev)
    from ..utils.kernels import check

    lib = _load()
    err = lib.p3m_short_pair(order_i["rows"].data_ptr(), order_i["table"].data_ptr(),
                             order_i["run_off"].data_ptr(), order_j["rows"].data_ptr(),
                             order_j["run_off"].data_ptr(), order_j["run_box"].data_ptr(),
                             int(diag), int(gc), int(tab_i["table"].shape[1]),
                             params.data_ptr(), float(G), float(eps2), acc.data_ptr(),
                             pe.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
                             dev.index or 0)
    check(lib, err, "p3m_short_pair launch")
    p3m_short_pair_cuda.launches += 1
    return acc, pe


p3m_short_pair_cuda.launches = 0


def _launch(table, cell_pos, cell_m, count, gc: int, params, G: float, eps2: float, acc,
            pe) -> None:
    """Reorder the table for the kernel and launch it into the zeroed
    ``acc`` and ``pe``."""
    from ..utils.kernels import check

    order = p3m_short_order_cuda(table, cell_pos, cell_m, count, gc)
    lib = _load()
    dev = table.device
    err = lib.p3m_short_sorted(order["rows"].data_ptr(), order["table"].data_ptr(),
                               order["run_off"].data_ptr(), order["run_box"].data_ptr(),
                               int(gc), int(table.shape[1]), params.data_ptr(), G, eps2,
                               acc.data_ptr(), pe.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    check(lib, err, "p3m_short launch")


p3m_short_cuda.launches = 0
