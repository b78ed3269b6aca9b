"""Device meshes and the collectives of the body-sharded solvers.

A port of ``orbital_tpu/parallel/mesh.py``. The JAX package lays a mesh over
whatever devices exist (TPU chips, or the virtual CPU devices of its tests)
and runs each sharded function once per device inside ``shard_map``, with
XLA's collectives between them. Here a sharded function is written once, as
the code of one rank, against a communicator (:class:`Comm`) that offers the
collectives the JAX code uses, under plainly mapped names:

  * ``ppermute(tensors)``: the forward ring ``lax.ppermute(x, axis,
    [(i, (i + 1) % n)])``: each rank sends to rank + 1 and receives from
    rank - 1;
  * ``psum``, ``pmin``, ``pmax``: elementwise reductions over the ranks;
  * ``all_gather(x)``: ``lax.all_gather(x, axis, tiled=True)``, the ranks'
    blocks concatenated along dim 0 in rank order;
  * ``rank`` (``lax.axis_index``) and ``size``.

A :class:`Mesh` runs such per-rank code on one of two backends:

  * one-card ranks (``make_mesh(devices=...)``): P ranks in this process on
    one device, each in its own Python thread, the counterpart of the JAX
    package's virtual devices. This is how the multi-device paths run on one
    card (NCCL refuses two ranks on one device) and on the CPU in tests. The
    ranks exchange tensors through shared slots between barriers, and run
    one at a time from one barrier to the next; every rank queues its work
    on the caller's current stream, so a tensor one rank writes before a
    barrier is written before another rank's read queued after it, by
    stream order.
  * a process group (``make_mesh()`` under an initialised
    ``torch.distributed``, or ``make_mesh(group=...)``): this process is one
    rank, NCCL for one card a rank, gloo for CPU tensors. The ring shift is
    one ``batch_isend_irecv``, the reductions ``all_reduce`` and the gather
    the single-tensor all-gather.

The same per-rank code runs on both, so a ring on the card's one-card mesh
and the same ring over gloo processes do the same arithmetic in the same
order.

A mesh of several axes (``make_mesh(shape=(E, B), axis_names=("ensemble",
"body"))``, the JAX package's (ensemble x body) mesh) lays its ranks out
row-major, as the JAX package reshapes its devices, and gives each rank a
communicator a line of each axis: rank (e, b)'s ``body`` communicator spans
the ranks (e, 0 .. B-1). On one-card ranks each line has its own slots and
barrier and every rank of the mesh shares one baton, so a rank waiting at
its line's barrier has always handed the baton on; under a process group
each line is a ``dist.new_group``, which every process creates for every
line in the same order.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
from typing import Callable, Optional, Sequence

import torch

__all__ = ["make_mesh", "Mesh", "Comm", "BODY_AXIS", "ENSEMBLE_AXIS"]

BODY_AXIS = "body"
ENSEMBLE_AXIS = "ensemble"

# a rank waiting longer than this at a barrier breaks it (another rank is
# stuck or gone) instead of hanging the process
_BARRIER_SECONDS = 600.0


class Comm:
    """The collectives of one rank of a mesh axis (see the module note).
    ``seconds`` accumulates the host time spent inside them."""

    rank: int
    size: int

    def __init__(self):
        self.seconds = 0.0

    @property
    def axis_index(self) -> int:
        return self.rank

    def ppermute(self, tensors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class _Slots:
    """The shared state of the one-card ranks of a mesh line: a barrier, two
    sets of slots, used in turns, so that one barrier an exchange suffices (a
    rank writes set t only after every rank has passed the barrier of the
    exchange that read set t last), and the baton (one for the whole mesh):
    one rank runs at a time, holding it, and hands it on only at a barrier. Without the baton every
    kernel launch (a ctypes call, which releases the interpreter lock)
    passed the lock to another rank's thread and back: a ring step of the
    65,536-body cluster over 4 ranks took 24.1 ms on the card against 2.5 on
    one card (``chip_smoke.py`` phase 60, an H100 at 700 W), whatever the
    interpreter's switch interval."""

    def __init__(self, size: int, baton: Optional[threading.Lock] = None):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=_BARRIER_SECONDS)
        self.baton = baton or threading.Lock()
        self.sets = ([None] * size, [None] * size)


class _LocalComm(Comm):
    def __init__(self, slots: _Slots, rank: int):
        super().__init__()
        self._slots, self.rank, self.size = slots, rank, slots.size
        self._turn = 0

    def _exchange(self, value) -> list:
        """Every rank's ``value``, in rank order."""
        t0 = time.perf_counter()
        slots = self._slots.sets[self._turn]
        self._turn ^= 1
        slots[self.rank] = value
        self._slots.baton.release()
        try:
            self._slots.barrier.wait()
        finally:
            self._slots.baton.acquire()
        self.seconds += time.perf_counter() - t0
        return slots

    def ppermute(self, tensors):
        if self.size == 1:
            return tuple(tensors)
        return tuple(self._exchange(tuple(tensors))[(self.rank - 1) % self.size])

    def _reduce(self, x, op):
        if self.size == 1:
            return x
        vals = self._exchange(x)
        out = vals[0]
        for v in vals[1:]:
            out = op(out, v)
        return out

    def psum(self, x):
        return self._reduce(x, torch.add)

    def pmin(self, x):
        return self._reduce(x, torch.minimum)

    def pmax(self, x):
        return self._reduce(x, torch.maximum)

    def all_gather(self, x):
        if self.size == 1:
            return x
        return torch.cat(self._exchange(x), dim=0)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor the backends carry (bool as uint8 bytes)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _all_gather_single():
    """The installed torch's single-tensor all-gather (torch 2.13 names it
    ``all_gather_single`` and deprecates ``all_gather_into_tensor``)."""
    import torch.distributed as dist

    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class _GroupComm(Comm):
    def __init__(self, group=None):
        import torch.distributed as dist

        super().__init__()
        self._dist, self.group = dist, group
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)

        def peer(r):
            return r if group is None else dist.get_global_rank(group, r)
        self._next, self._prev = peer((self.rank + 1) % self.size), peer(
            (self.rank - 1) % self.size)

    @contextlib.contextmanager
    def _timed(self):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0

    def ppermute(self, tensors):
        if self.size == 1:
            return tuple(tensors)
        dist = self._dist
        sends = [_wire(t) for t in tensors]
        recvs = [torch.empty_like(s) for s in sends]
        ops = []
        for s, r in zip(sends, recvs):
            ops.append(dist.P2POp(dist.isend, s, self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, r, self._prev, self.group))
        with self._timed():
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(r.view(torch.bool) if t.dtype == torch.bool else r
                     for t, r in zip(tensors, recvs))

    def _reduce(self, x, op):
        out = x.reshape(1).clone() if x.ndim == 0 else x.contiguous().clone()
        with self._timed():
            self._dist.all_reduce(out, op=op, group=self.group)
        return out.reshape(x.shape)

    def psum(self, x):
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmin(self, x):
        return self._reduce(x, self._dist.ReduceOp.MIN)

    def pmax(self, x):
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def all_gather(self, x):
        src = _wire(x)
        out = torch.empty((self.size * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        with self._timed():
            _all_gather_single()(out, src, group=self.group)
        return out.view(torch.bool) if x.dtype == torch.bool else out


class Mesh:
    """A mesh of ranks: ``axis_names``, ``shape`` ({axis: ranks}), ``device``
    (this process's ranks' device), ``ranks`` (the ranks this process runs,
    in rank order: all of them on one-card ranks, one under a process group;
    an int on a 1-D mesh, the coordinates' tuple otherwise) and each rank's
    communicator along each axis (:meth:`axis_comms`; ``comms`` on a 1-D
    mesh). :meth:`run` runs per-rank code on them."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], device: torch.device,
                 comms: list[dict], coords: list[tuple],
                 slots: Optional[list[_Slots]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.device = device
        self._comms = comms
        self.ranks = [c[0] for c in coords] if len(self.axis_names) == 1 else list(coords)
        self._slots = slots

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def comms(self) -> list:
        """The communicators of this process's ranks on a 1-D mesh."""
        if len(self.axis_names) != 1:
            raise ValueError(f"a mesh of axes {self.axis_names}: name one, axis_comms(axis)")
        return self.axis_comms(self.axis_names[0])

    def axis_comms(self, axis: str) -> list:
        """Each of this process's ranks' communicator along ``axis``."""
        return [c[axis] for c in self._comms]

    @property
    def local(self) -> bool:
        """True for one-card ranks (every rank in this process)."""
        return self._slots is not None

    def exchange_seconds(self) -> float:
        """Host seconds this process's ranks spent in collectives, summed."""
        return sum(c.seconds for cs in self._comms for c in cs.values())

    def run(self, fn: Callable, *per_rank, axis: Optional[str] = None) -> list:
        """``fn(comm, *args)`` for each rank this process runs, ``comm`` its
        communicator along ``axis`` (the only axis of a 1-D mesh), ``args``
        the rank's entries of the ``per_rank`` sequences (each in ``ranks``
        order); the results in the same order. One-card ranks run a thread
        each, on the caller's current stream and grad mode, one at a time
        between barriers (the baton, ``_Slots``); if one raises, the others
        are released from their barriers and the first error is raised."""
        comms = self.comms if axis is None else self.axis_comms(axis)
        args = list(zip(*per_rank)) if per_rank else [()] * len(comms)
        if len(comms) == 1:
            return [fn(comms[0], *args[0])]
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)
        grad = torch.is_grad_enabled()
        results, errors = [None] * len(comms), [None] * len(comms)
        baton = self._slots[0].baton

        def work(r):
            try:
                ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
                with baton, ctx, torch.set_grad_enabled(grad):
                    results[r] = fn(comms[r], *args[r])
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors[r] = exc
                for sl in self._slots:
                    sl.barrier.abort()

        threads = [threading.Thread(target=work, args=(r,), name=f"mesh-rank-{r}")
                   for r in range(len(comms))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if any(e is not None for e in errors):
            for sl in self._slots:
                sl.barrier.reset()
            for cs in self._comms:
                for c in cs.values():
                    c._turn = 0
            first = [e for e in errors if e is not None]
            raise next((e for e in first if not isinstance(e, threading.BrokenBarrierError)),
                       first[0])
        return results


def _lines(sizes: Sequence[int], k: int) -> list[list[int]]:
    """The lines of axis ``k`` of a row-major grid of ``sizes``: the flat
    ranks that differ only in coordinate k, in order, for every setting of
    the other coordinates (row-major)."""
    coords = [tuple(int(c) for c in cs) for cs in itertools.product(*map(range, sizes))]
    lines: dict = {}
    for r, c in enumerate(coords):
        lines.setdefault(c[:k] + c[k + 1:], []).append(r)
    return list(lines.values())


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (BODY_AXIS,),
              devices=None, group=None) -> Mesh:
    """Build a mesh. With ``group``, or with no ``devices`` while
    ``torch.distributed`` is initialised, a process-group mesh of that group
    (the default group), this process one rank, on ``devices`` (one device)
    or else the current CUDA device under NCCL and the CPU otherwise.
    Otherwise one-card ranks: ``devices`` is one device, or a sequence of
    one device repeated, default ``cuda:0``; ``shape`` defaults to
    ``(len(devices),)``, as the JAX package's all devices on one ``body``
    axis. A mesh of several axes needs ``shape`` (one size an axis); its
    ranks are laid out row-major."""
    axis_names = tuple(axis_names)
    if len(axis_names) != 1 and shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if shape is not None and len(tuple(shape)) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} for axes {axis_names}")
    import torch.distributed as dist

    distributed = dist.is_available() and dist.is_initialized()
    if group is not None or (devices is None and distributed):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        sizes = (world,) if shape is None else tuple(int(x) for x in shape)
        if math.prod(sizes) != world:
            raise ValueError(f"shape {sizes} does not match the process group's "
                             f"{world} ranks")
        comms = {}
        for k, axis in enumerate(axis_names):
            if len(axis_names) == 1:
                comms[axis] = _GroupComm(group)
                continue
            # every process creates every line's group, in the same order
            for line in _lines(sizes, k):
                members = (line if group is None
                           else [dist.get_global_rank(group, r) for r in line])
                g = dist.new_group(members)
                if rank in line:
                    comms[axis] = _GroupComm(g)
        if devices is not None:
            device = torch.device(devices if isinstance(devices, (str, torch.device))
                                  else devices[0])
        elif dist.get_backend(group) == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
        coords = tuple(int(c) for c in _unravel(rank, sizes))
        return Mesh(axis_names, sizes, device, [comms], [coords])
    if devices is None:
        devices = ["cuda:0"]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    sizes = (len(devices),) if shape is None else tuple(int(x) for x in shape)
    size = math.prod(sizes)
    if len(devices) == 1:
        devices = devices * size
    if len(devices) < size:
        raise ValueError(f"mesh of {size} ranks over {len(devices)} devices")
    if len(set(devices[:size])) != 1:
        raise ValueError(
            "one-card ranks share one device; for one rank a card run one process a card "
            "under torch.distributed (NCCL) and build the mesh there")
    baton = threading.Lock()
    comms = [{} for _ in range(size)]
    slots = []
    for k, axis in enumerate(axis_names):
        for line in _lines(sizes, k):
            sl = _Slots(len(line), baton)
            slots.append(sl)
            for pos, r in enumerate(line):
                comms[r][axis] = _LocalComm(sl, pos)
    coords = [tuple(int(c) for c in _unravel(r, sizes)) for r in range(size)]
    return Mesh(axis_names, sizes, devices[0], comms, coords, slots)


def _unravel(r: int, sizes: Sequence[int]) -> tuple:
    """Row-major coordinates of flat rank ``r``."""
    out = []
    for s in reversed(sizes):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))
