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

The kernel reads a view of the table (:func:`p3m_short_view_cuda`, a second
kernel of the same source, whose plain version is :func:`p3m_short_view`):
each cell's kept prefix reordered by the Morton code of an 8^3 split of the
cell's bounding box (:func:`p3m_short_order`), cut into its 8 top-level
octant runs with their boxes, and held as one segment of a compact array of
the shard's rows, with each slot's body index and global id and the list of
the (cell, 32-row slice) pairs that hold rows, which a persistent grid of
the kernel walks. The table itself (``p3m_cell_table``'s output, which the
overflow and the kept bodies come from) is not changed.

The body-sharded ring (``ops.p3m.p3m_ring_force``) builds each shard's view
once an evaluation, on its owner, passes what a visitor's round reads
(:data:`SHIPPED`) round the ring, and sums each round with the kernel's
two-table form, :func:`p3m_short_round_cuda`, adding into its outputs.
:func:`p3m_short_pair_cuda` is the same round from two cell tables and
their global ids; its plain version is ``ops.p3m.p3m_short_pair_plain``,
which skips self pairs by global id as the JAX ring does; the kernel skips
them by slot in the diagonal round (one view for both sides), which leaves
out the same pairs.

For CPU tensors the wrappers compute the plain versions. For CUDA tensors
they launch the kernel or raise; they never fall back. ``.launches`` counts
each wrapper's launches: of the sum (:func:`p3m_short_cuda`,
:func:`p3m_short_pair_cuda`, :func:`p3m_short_round_cuda`) and of the view
kernel (:func:`p3m_short_view_cuda`).
"""
from __future__ import annotations

import ctypes
import functools
import math
import types
from collections.abc import Mapping

import torch

from .p3m import SENTINEL, p3m_short_pair_plain, p3m_short_plain, _short_tiles
from ..utils.kernels import count_launch, refuse_grad, stream_handle

__all__ = ["p3m_short_cuda", "p3m_short_plain", "p3m_short_order", "p3m_short_order_cuda",
           "p3m_short_view", "p3m_short_view_cuda", "p3m_short_round_cuda",
           "p3m_short_pair_cuda", "p3m_short_pair_plain", "short_params", "SHIPPED"]

# sub-cells a side of the Morton order (3 bits an axis); the runs are the
# 8 top-level octants
SUB = 8
_OCT = 8
# what the ring passes of a visiting shard's view: its rows (x, y, z, m),
# their global ids, and each cell's runs and run boxes
SHIPPED = ("rows", "gid", "run_off", "run_box")

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils import kernels

        lib = kernels.load("p3m_short")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.p3m_short_view.restype = ctypes.c_int
        lib.p3m_short_view.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p, p, p, p, i]
        lib.p3m_short_pair.restype = ctypes.c_int
        lib.p3m_short_pair.argtypes = [p, p, p, p, p, i, p, p, p, i, i, p, f, f, p, p, p, i]
        lib.p3m_short_sorted.restype = ctypes.c_int
        lib.p3m_short_sorted.argtypes = [p, p, p, p, p, p, i, i, p, f, f, p, p, p, i]
        lib.p3m_short_shape.restype = None
        lib.p3m_short_shape.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
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


def max_slices(gc: int, cap: int, n: int) -> int:
    """Room for a view's slice list: each cell's ceil(count / 32) slices,
    at most ceil(cap / 32) a cell and at most gc^3 + n / 32 in all."""
    gc3 = gc ** 3
    return max(1, min(gc3 * -(-cap // 32), gc3 + n // 32 + 1))


def p3m_short_view(tab: dict, gc: int, n: int, gid: torch.Tensor = None,
                   reorder: bool = True) -> dict:
    """The kernel's view of a cell table ``tab`` (``ops.p3m.p3m_cell_table``'s
    ``table``, ``cell_pos``, ``cell_m`` and ``count``) of n bodies, on its
    device: each cell's kept prefix held as one segment of compact arrays,
    the cells in order; with ``reorder`` in the order of
    :func:`p3m_short_order`, cut into its 8 octant runs, else in the table's
    order as one run (the plain route's view: its tile sum is then the
    single-table plain sum's, bit for bit).

    Returns ``rows`` [n, 4] (x, y, z, m; the kept rows first, zeros past
    them), ``body`` [n] (the body index of each slot, n past the kept rows),
    with ``gid`` [n] global ids also ``gid`` [n] (each slot's, -1 past the
    kept rows), ``run_off`` [gc^3, 9] int32 (the absolute first slot of each
    run; run_off[c, 8] - run_off[c, 0] = count[c]), ``run_box`` [gc^3, 8, 6]
    float32 (the min x, y, z and max x, y, z of each run's rows, +inf and
    -inf for an empty run), ``slices`` int32, the (cell, slice) pairs that
    hold rows, cell by cell, each entry cell << 9 | k for rows 32 k onward,
    and ``nslices`` [3] int32 (their number, and the sum's two counters,
    0)."""
    table, count = tab["table"], tab["count"].long()
    gc3, cap, dev = gc ** 3, table.shape[1], table.device
    keep = torch.arange(cap, device=dev)[None] < count[:, None]
    if reorder:
        o = p3m_short_order(table, tab["cell_pos"], tab["cell_m"], tab["count"], gc)
        rows_c, body_c, run_off, run_box = o["rows"], o["table"], o["run_off"], o["run_box"]
    else:
        pos = tab["cell_pos"][:gc3].to(torch.float32)
        rows_c = torch.cat([pos, tab["cell_m"][:gc3, :, None].to(torch.float32)], -1)
        body_c = table[:gc3]
        run_off = torch.cat([torch.zeros_like(count)[:, None], count[:, None].expand(-1, _OCT)],
                            1)
        inf = float("inf")
        run_box = torch.tensor([inf] * 3 + [-inf] * 3, device=dev).repeat(gc3, _OCT, 1)
        run_box[:, 0, :3] = torch.where(keep[..., None], pos, inf).amin(1)
        run_box[:, 0, 3:] = torch.where(keep[..., None], pos, -inf).amax(1)
    start = torch.cumsum(count, 0) - count
    dst = (start[:, None] + torch.arange(cap, device=dev))[keep]
    rows = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rows[dst] = rows_c[keep]
    body = torch.full((n,), n, dtype=torch.int64, device=dev)
    body[dst] = body_c[keep]
    per = (count + 31) // 32
    cells = torch.repeat_interleave(torch.arange(gc3, device=dev), per)
    first = torch.repeat_interleave(torch.cumsum(per, 0) - per, per)
    k = torch.arange(cells.shape[0], device=dev) - first
    view = dict(rows=rows, body=body, run_off=(run_off + start[:, None]).to(torch.int32),
                run_box=run_box, slices=((cells << 9) | k).to(torch.int32),
                nslices=torch.tensor([cells.shape[0], 0, 0], dtype=torch.int32, device=dev))
    if gid is not None:
        view["gid"] = torch.full((n,), -1, dtype=torch.int64, device=dev)
        view["gid"][dst] = gid.to(torch.int64)[body[dst]]
    return view


def p3m_short_view_cuda(tab: dict, gc: int, n: int, gid: torch.Tensor = None):
    """:func:`p3m_short_view` as the kernel ``p3m_view_kernel`` builds it (a
    warp a cell): equal to the plain version's, bit for bit, on the kept
    rows and the first ``nslices[0]`` entries of ``slices``, and not written
    past them (the sum reads neither). On the card the view is a mapping
    over one buffer whose entries are made on first use, so that the sum's
    wrappers, which read only their addresses, cost no tensor operation.
    CPU tensors take the plain route's view, :func:`p3m_short_view` in the
    table's order; ``.launches`` counts the kernel's launches."""
    table = tab["table"]
    if table.device.type == "cpu":
        return p3m_short_view(tab, gc, n, gid, reorder=False)
    if table.device.type != "cuda":
        raise ValueError(f"p3m_short_view_cuda: unsupported device {table.device}")
    refuse_grad("p3m_short_view_cuda", tab["cell_pos"], tab["cell_m"])
    view = _view(tab, gc, n, gid)
    count_launch(p3m_short_view_cuda)
    return view


class _View(Mapping):
    """The kernel's view: its entries (those of :func:`p3m_short_view`) laid
    out in one device buffer, each made as a tensor on first use; ``ptr``
    gives an entry's address without making it, ``room`` the slice list's
    length. Lazy because the sum reads addresses only: making the seven
    entries at once (a slice and two views each) took 0.065 ms of host time
    a call on an H100's host, three times the whole call's 0.030
    (``chip_smoke.py --parent``, in turns)."""

    __slots__ = ("_buf", "_base", "_fields", "_made", "room")

    def __init__(self, n: int, gc3: int, room: int, with_gid: bool, dev):
        self._fields, nbytes = _layout(n, gc3, room, with_gid)
        self._buf = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
        self._base = self._buf.data_ptr()
        self._made = {}
        self.room = room

    @property
    def device(self) -> torch.device:
        return self._buf.device

    def ptr(self, key: str):
        return None if key not in self._fields else self._base + self._fields[key][0]

    def __getitem__(self, key: str) -> torch.Tensor:
        t = self._made.get(key)
        if t is None:
            off, nbytes, dtype, shape = self._fields[key]
            t = self._made[key] = self._buf[off:off + nbytes].view(dtype).view(shape)
        return t

    def __iter__(self):
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)


@functools.lru_cache(maxsize=32)
def _layout(n: int, gc3: int, room: int, with_gid: bool) -> tuple:
    """Where each entry of a view lies in its buffer: ({entry: (byte offset,
    bytes, dtype, shape)}, the buffer's bytes), each entry 16-byte aligned."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    spec = [("rows", f32, (n, 4)), ("body", i64, (n,))]
    if with_gid:
        spec.append(("gid", i64, (n,)))
    spec += [("run_off", i32, (gc3, _OCT + 1)), ("run_box", f32, (gc3, _OCT, 6)),
             ("slices", i32, (room,)), ("nslices", i32, (3,))]
    fields, off = {}, 0
    for name, dtype, shape in spec:
        nbytes = math.prod(shape) * dtype.itemsize
        fields[name] = (off, nbytes, dtype, shape)
        off += -(-nbytes // 16) * 16
    return types.MappingProxyType(fields), off


def _ptr(view, key: str) -> int:
    """The address of a view's entry, made or not."""
    return view.ptr(key) if isinstance(view, _View) else view[key].data_ptr()


def _room(view) -> int:
    """The length of a view's slice list."""
    return view.room if isinstance(view, _View) else int(view["slices"].shape[0])


def _in(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor, itself when it is one."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _view(tab: dict, gc: int, n: int, gid) -> _View:
    """Launch the view kernel on a cell table. The table's first gc^3 cells
    are read in place: their rows open each input."""
    from ..utils.kernels import check

    table = tab["table"]
    gc3, cap, dev = gc ** 3, table.shape[1], table.device
    ins = (_in(tab["cell_pos"], torch.float32), _in(tab["cell_m"], torch.float32),
           _in(table, torch.int64), _in(tab["count"], torch.int32))
    if gid is not None:
        gid = _in(gid, torch.int64)
    view = _View(n, gc3, max_slices(gc, cap, n), gid is not None, dev)
    lib = _load()
    err = lib.p3m_short_view(*(t.data_ptr() for t in ins),
                             None if gid is None else gid.data_ptr(), int(gc), int(cap),
                             view.ptr("rows"), view.ptr("body"), view.ptr("gid"),
                             view.ptr("run_off"), view.ptr("run_box"), view.ptr("slices"),
                             view.ptr("nslices"), stream_handle(dev), dev.index or 0)
    check(lib, err, "p3m_short_view launch")
    return view


p3m_short_view_cuda.launches = 0


def p3m_short_order_cuda(table: torch.Tensor, cell_pos: torch.Tensor, cell_m: torch.Tensor,
                         count: torch.Tensor, gc: int) -> dict:
    """:func:`p3m_short_order` as the view kernel computes it, in the plain
    version's layout: ``rows`` and ``table`` equal to the plain version's,
    bit for bit, on each cell's kept prefix (past it they are not written),
    ``run_off`` and ``run_box`` equal throughout, and no ``perm``. CPU
    tensors take :func:`p3m_short_order`; ``.launches`` counts its calls on
    the card (the view kernel's launches count on
    :func:`p3m_short_view_cuda`)."""
    if table.device.type == "cpu":
        return p3m_short_order(table, cell_pos, cell_m, count, gc)
    if table.device.type != "cuda":
        raise ValueError(f"p3m_short_order_cuda: unsupported device {table.device}")
    gc3, cap, dev = gc ** 3, table.shape[1], table.device
    view = p3m_short_view_cuda(dict(table=table, cell_pos=cell_pos, cell_m=cell_m,
                                    count=count), gc, gc3 * cap)
    start = view["run_off"][:, :1].long()
    k = torch.arange(cap, device=dev)[None]
    keep = k < count.long()[:, None]
    src = torch.where(keep, start + k, 0)
    rows = torch.empty((gc3, cap, 4), dtype=torch.float32, device=dev)
    table_s = torch.empty((gc3, cap), dtype=torch.int64, device=dev)
    rows[keep] = view["rows"][src[keep]]
    table_s[keep] = view["body"][src[keep]]
    p3m_short_order_cuda.launches += 1
    return dict(rows=rows, table=table_s, run_off=(view["run_off"] - start).to(torch.int32),
                run_box=view["run_box"])


p3m_short_order_cuda.launches = 0


def p3m_short_shape(device: torch.device) -> dict:
    """The sum's launch shape on ``device``: rows a slice, warps a block,
    buffered rows that start a sweep, threads a block and the co-resident
    blocks, which bound its persistent grid."""
    shape = (ctypes.c_int * 5)()
    _load().p3m_short_shape(int(device.index or 0), shape)
    return dict(zip(("slice_rows", "warps", "sweep_rows", "threads", "blocks"), shape))


def p3m_short_cuda(table: torch.Tensor, cell_pos: torch.Tensor, cell_m: torch.Tensor, *,
                   count: torch.Tensor, gc: int, n: int, G: float, sigma, rcut2, eps2: float,
                   cell_block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """The short-range sum over the cell table ``table`` [gc^3 + 1, M] (body
    indices, n in empty slots), ``cell_pos`` [gc^3 + 1, M, 3] and ``cell_m``
    [gc^3 + 1, M], each cell's kept bodies a prefix of its row (``count``
    [gc^3] of them, which only the kernel's view reads). ``sigma`` and ``rcut2`` may
    be 0-dim tensors on the device. ``cell_block`` is the plain version's
    cells a block. Returns (acc [n, 3], pe [n]) in float32."""
    if table.device.type == "cpu":
        return p3m_short_plain(table, cell_pos, cell_m, gc=gc, n=n, G=G, sigma=sigma,
                               rcut2=rcut2, eps2=eps2, cell_block=cell_block)
    _check_table("p3m_short_cuda", table, cell_pos, cell_m, count, gc, eps2)
    dev = table.device
    params = short_params(sigma, rcut2, dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pe = torch.zeros((n,), dtype=torch.float32, device=dev)
    _launch(table.to(torch.int64), cell_pos, cell_m, count, gc, params, float(G), float(eps2),
            acc, pe)
    count_launch(p3m_short_cuda)
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


def short_params(sigma, rcut2, dev) -> torch.Tensor:
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


def _view_table(view: dict, gc: int, key: str, fill):
    """A view's ``key`` ("rows", "body" or "gid") as a padded [gc^3 + 1, W,
    ...] table, W its fullest cell's kept rows, ``fill`` in empty slots and
    the pad row."""
    off = view["run_off"].long()
    start, count = off[:, 0], off[:, -1] - off[:, 0]
    width = max(1, int(count.max()))
    k = torch.arange(width, device=off.device)[None]
    keep = k < count[:, None]
    src = view[key]
    out = torch.full((gc ** 3 + 1, width, *src.shape[1:]), fill, dtype=src.dtype,
                     device=src.device)
    out[:-1][keep] = src[(start[:, None] + k)[keep]]
    return out


def _round_plain(view_i: dict, view_j: dict, *, gc: int, n: int, G: float, sigma, rcut2,
                 eps2: float, cell_block: int):
    """The plain version of a round over two views with global ids: their
    rows as padded tables (the cells' kept rows in the views' order,
    SENTINEL and mass 0 in empty slots) through the tile form of
    :func:`ops.p3m.p3m_short_pair_plain`, self pairs skipped by global id."""
    rows_j = _view_table(view_j, gc, "rows", SENTINEL)
    key_j = _view_table(view_j, gc, "gid", -1)
    used_j = key_j >= 0
    return _short_tiles(_view_table(view_i, gc, "body", n),
                        _view_table(view_i, gc, "rows", SENTINEL)[..., :3],
                        _view_table(view_i, gc, "gid", -2), rows_j[..., :3],
                        torch.where(used_j, rows_j[..., 3], 0.0), key_j, used_j, gc=gc, n=n,
                        G=G, sigma=sigma, rcut2=rcut2, eps2=eps2, cell_block=cell_block)


def p3m_short_round_cuda(view_i: dict, view_j: dict, *, gc: int, n: int, G: float, sigma,
                         rcut2, eps2: float, out=None, params=None, cell_block: int = 32
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of the P3M ring over two views (:func:`p3m_short_view_cuda`):
    the kept bodies of ``view_i`` (this rank's n bodies) against the rows of
    ``view_j`` (a visiting shard's view on the same grid, at least its
    :data:`SHIPPED` entries) in the 27 cells around each, pairs with r^2 <
    rcut2 and different bodies (the plain route tells them by the views'
    global ids). ``view_j is view_i`` is the diagonal round.
    Adds (acc [n, 3], pe [n]) of the round into ``out`` when given (in place)
    and returns it; else returns them. ``params`` may carry
    :func:`short_params` of (sigma, rcut2), made once for every round."""
    diag = view_j is view_i
    dev = view_i.device if isinstance(view_i, _View) else view_i["rows"].device
    if dev.type == "cpu":
        a, p = _round_plain(view_i, view_j, gc=gc, n=n, G=G, sigma=sigma, rcut2=rcut2,
                            eps2=eps2, cell_block=cell_block)
        if out is None:
            return a, p
        out[0].add_(a)
        out[1].add_(p)
        return out
    if dev.type != "cuda":
        raise ValueError(f"p3m_short_round_cuda: unsupported device {dev}")
    if eps2 <= 0.0:
        raise ValueError("p3m_short_round_cuda requires eps2 > 0")
    if params is None:
        params = short_params(sigma, rcut2, dev)
    if out is None:
        out = (torch.zeros((n, 3), dtype=torch.float32, device=dev),
               torch.zeros((n,), dtype=torch.float32, device=dev))
    _round(view_i, view_j, diag, gc, params, float(G), float(eps2), *out)
    count_launch(p3m_short_round_cuda)
    return out


p3m_short_round_cuda.launches = 0


def _round(view_i, view_j, diag: bool, gc: int, params, G: float, eps2: float, acc,
           pe) -> None:
    """Launch the two-table form over two views, adding into ``acc`` and
    ``pe``."""
    from ..utils.kernels import check

    lib = _load()
    dev = acc.device
    err = lib.p3m_short_pair(*(_ptr(view_i, k) for k in ("rows", "body", "run_off", "slices",
                                                         "nslices")),
                             _room(view_i),
                             *(_ptr(view_j, k) for k in ("rows", "run_off", "run_box")),
                             int(diag), int(gc), params.data_ptr(), G, eps2, acc.data_ptr(),
                             pe.data_ptr(), stream_handle(dev),
                             dev.index or 0)
    check(lib, err, "p3m_short_pair launch")


def p3m_short_pair_cuda(tab_i: dict, tab_j: dict, gid_i: torch.Tensor, gid_j: torch.Tensor, *,
                        gc: int, n: int, G: float, sigma, rcut2, eps2: float,
                        cell_block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of the P3M ring from two cell tables: the kept bodies of
    ``tab_i`` (this rank's ``ops.p3m.p3m_cell_table``, its ``n`` bodies'
    global ids ``gid_i``) against the kept bodies of ``tab_j`` (a visiting
    shard's table on the same grid, global ids ``gid_j``) in the 27 cells
    around each, pairs with r^2 < rcut2 and different global ids. ``tab_j is
    tab_i`` (with ``gid_j is gid_i``) is the diagonal round. On the card it
    builds the tables' views and launches :func:`p3m_short_round_cuda`'s
    kernel. Returns (acc [n, 3], pe [n]) in float32 as :func:`p3m_short_cuda`
    does."""
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
    params = short_params(sigma, rcut2, dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pe = torch.zeros((n,), dtype=torch.float32, device=dev)
    _launch_pair(tab_i, tab_j, gid_i, gid_j, gc, n, params, float(G), float(eps2), acc, pe)
    count_launch(p3m_short_pair_cuda)
    return acc, pe


p3m_short_pair_cuda.launches = 0


def _launch_pair(tab_i, tab_j, gid_i, gid_j, gc: int, n: int, params, G: float, eps2: float,
                 acc, pe) -> None:
    """Build the tables' views (one in the diagonal round) and launch the
    two-table form into the zeroed ``acc`` and ``pe``."""
    view_i = p3m_short_view_cuda(tab_i, gc, n, gid_i)
    view_j = view_i if tab_j is tab_i else p3m_short_view_cuda(tab_j, gc, gid_j.shape[0],
                                                               gid_j)
    _round(view_i, view_j, tab_j is tab_i, gc, params, G, eps2, acc, pe)


def _launch(table, cell_pos, cell_m, count, gc: int, params, G: float, eps2: float, acc,
            pe) -> None:
    """Build the table's view and launch the single-table sum into the
    zeroed ``acc`` and ``pe``."""
    from ..utils.kernels import check

    view = p3m_short_view_cuda(dict(table=table, cell_pos=cell_pos, cell_m=cell_m,
                                    count=count), gc, acc.shape[0])
    lib = _load()
    dev = table.device
    err = lib.p3m_short_sorted(*(_ptr(view, k) for k in ("rows", "body", "run_off", "run_box",
                                                         "slices", "nslices")),
                               _room(view), int(gc), params.data_ptr(), G,
                               eps2, acc.data_ptr(), pe.data_ptr(),
                               stream_handle(dev), dev.index or 0)
    check(lib, err, "p3m_short_sorted launch")


p3m_short_cuda.launches = 0
