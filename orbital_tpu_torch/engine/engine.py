"""``SimulationEngine``: the reference-parity OO facade over device state.

The same constructor surface and step semantics as the JAX package's facade
(``orbital_tpu/engine/engine.py``): an ObjectCollection in, leapfrog KDK with
per-step collision handling, uuid-keyed position history, a throttled JSONL
frame cache, energy and angular-momentum diagnostics and a checkpoint round
trip. All stepping happens on the engine's device: ``run(n)`` advances in
``rollout`` calls (one for an unrecorded run, windows of records streamed
to the host for a recorded one) instead of n Python steps.

Differences from the JAX facade:
  * ``device`` (default ``"cuda"``): the engine runs on the card unless the
    caller asks for the CPU, and raises where CUDA is absent; it never falls
    back. ``precision`` defaults to ``"ds32"`` on the card and ``"f64"`` on
    the CPU, as ``simulate()`` does.
  * no per-program step cap: the JAX facade splits runs so that no compiled
    TPU program outlasts the worker's watchdog; an unrecorded run here is one
    ``rollout`` call. Recorded runs keep the host window budget.
  * checkpoints are ``.npz`` only (``engine.checkpoint``); the JAX package's
    orbax directory form raises ``ValueError``.

Shared with the JAX facade (and its differences from the reference engine,
``core/engine.py``): any ``max_hist <= 0`` or ``None`` means unlimited
history, positive values a ring buffer; velocities stay float64 host-side;
checkpoints are a real round trip; SI-magnitude scenes in f32 or ds32 are
rescaled to natural units internally (an exact change of units).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..models.constants import STANDARD, UnitProfile
from ..models.objects import Coordinates, ObjectCollection
from ..models.scene import compile_objects
from ..ops import diagnostics as diag
from ..utils.config import SimConfig
from ..utils.io import append_jsonl, last_jsonl
from . import checkpoint as ckpt
from .integrators import make_step_fn
from .rollout import resolve_force_detect_fn, resolve_force_fn, rollout
from .state import NBodyState, Rescale, make_state

__all__ = ["SimulationEngine", "run_simulation"]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def engine_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch device; raises where it names CUDA and the
    process has none (the port's entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


class SimulationEngine:
    """Advance an orbital simulation on one device with a host-side object
    view."""

    def __init__(
        self,
        objects: ObjectCollection,
        dt: float = 1.0,
        softening: float = 0.0,
        restitution: float = 1.0,
        max_hist: Optional[int] = -1,
        cache: bool = True,
        cache_fp: str = "history.jsonl",
        cache_every_n: int = 300,
        *,
        merge_on_capture: bool = False,
        collisions: Optional[str] = None,
        precision: Optional[str] = None,
        force_impl: str = "auto",
        unit_profile: UnitProfile = STANDARD,
        rescale: Optional[Rescale] = None,
        record_history: bool = True,
        history_every: Union[int, str] = "auto",
        device: torch.device | str = "cuda",
    ):
        if isinstance(objects, (list, tuple)):
            objects = ObjectCollection(list(objects))
        self.device = engine_device(device)
        self.objects = objects
        self.dt = float(dt)
        self.softening = float(softening)
        self.restitution = float(restitution)
        self.max_hist = max_hist
        self.cache = cache
        if cache_fp and not cache_fp.endswith(".jsonl"):
            raise ValueError("cache_fp must end with .jsonl")
        self.cache_fp = cache_fp
        self.cache_every_n = cache_every_n if cache else 0
        self.unit_profile = unit_profile
        self.record_history = record_history
        # History stride for run(): 1 = reference parity (every step);
        # "auto" keeps per-run retained history under a float budget so
        # run(10k) at N=65k stays in memory (stride 1 at small N).
        self.history_every = history_every

        if precision is None:
            precision = "f64" if self.device.type == "cpu" else "ds32"
        self.precision = precision

        scene = compile_objects(objects)
        if rescale is None:
            rescale = (
                Rescale.identity()
                if precision == "f64"
                else Rescale.natural(scene.pos, scene.mass, unit_profile.G)
            )
        self.rescale = rescale

        mode = collisions if collisions is not None else (
            "merge" if merge_on_capture else "bounce"
        )
        self.config = SimConfig(
            dt=self.dt / rescale.time,
            G=rescale.g_internal(unit_profile.G),
            eps2=(self.softening / rescale.length) ** 2,
            restitution=self.restitution,
            collisions=mode,
            force_impl=force_impl,
        )

        self.state = make_state(
            scene.pos, scene.vel, scene.mass, scene.radius,
            precision=precision, rescale=rescale, device=self.device,
        )
        self._uuids = list(scene.uuids)
        self._rebuild_compiled(self.state.n_bodies)

        # initial force evaluation (reference: core/engine.py:41)
        acc0, U0 = self._force_fn(self.state.pos, self.state.mass, self.state.alive)
        self.state = self.state.replace(acc=acc0, potential=U0)

        self.history: dict[str, list[list[float]]] = {
            obj.uuid: [obj.position().copy().tolist()] for obj in self.objects
        }
        self.time_elapsed = 0.0
        self.step_idx = 0
        self._hist_phase = 0  # steps since the last history record (run())

    def _rebuild_compiled(self, n: int) -> None:
        """(Re)resolve the force and step functions for a body count. With a
        collision mode on, the stepper takes the contact-detecting force
        sweep and gates the resolution sweep on its count on the device."""
        dtype = self.state.dtype
        self._force_fn = resolve_force_fn(self.config, n, self.device, dtype)
        self._force_detect_fn = (resolve_force_detect_fn(self.config, n, self.device, dtype)
                                 if self.config.collisions != "none" else None)
        self._step_fn = make_step_fn(self.config, self._force_fn,
                                     force_detect_fn=self._force_detect_fn)

    # -- unit conversion helpers ---------------------------------------------

    def _pos_phys(self, state: Optional[NBodyState] = None) -> np.ndarray:
        s = state or self.state
        return _host(s.pos_full()).astype(np.float64) * self.rescale.length

    def _vel_phys(self, state: Optional[NBodyState] = None) -> np.ndarray:
        s = state or self.state
        return _host(s.vel_full()).astype(np.float64) * self.rescale.velocity

    @property
    def acc(self) -> dict[str, np.ndarray]:
        """uuid -> acceleration (physical units), as the reference exposes."""
        a = _host(self.state.acc).astype(np.float64) * (
            self.rescale.length / self.rescale.time**2
        )
        return {u: a[i] for i, u in enumerate(self._uuids) if u is not None}

    @property
    def last_potential(self) -> float:
        return float(self.state.potential) * self.rescale.energy

    # -- host synchronization --------------------------------------------------

    def _sync_objects(self) -> None:
        """Refresh host Objects from device state; prune merged-away bodies.

        O(N): one uuid -> Object map instead of a per-body linear scan."""
        pos = self._pos_phys()
        vel = self._vel_phys()
        mass = _host(self.state.mass).astype(np.float64) * self.rescale.mass
        radius = _host(self.state.radius).astype(np.float64) * self.rescale.length
        alive = _host(self.state.alive)
        by_uuid = {o.uuid: o for o in self.objects}
        dead = []
        for i, uuid in enumerate(self._uuids):
            if uuid is None:
                continue
            obj = by_uuid.get(uuid)
            if obj is None:
                continue
            if not alive[i]:
                dead.append((i, obj))
                continue
            obj.coordinates = Coordinates.from_iterable(pos[i])
            obj.velocity = vel[i]
            obj.mass = float(mass[i])
            obj.radius = float(radius[i])
        for i, obj in dead:
            self.objects.remove(obj)
            self._uuids[i] = None

    def _append_history(self, pos_phys: np.ndarray, alive: np.ndarray) -> None:
        unlimited = self.max_hist is None or self.max_hist <= 0
        for i, uuid in enumerate(self._uuids):
            if uuid is None or not alive[i]:
                continue
            h = self.history[uuid]
            h.append(pos_phys[i].tolist())
            if not unlimited and len(h) > self.max_hist:
                del h[: len(h) - self.max_hist]

    # -- public stepping API -----------------------------------------------------

    def step(self) -> None:
        """Advance one KDK step (reference semantics, core/engine.py:65-97).

        Frame timestamps match the reference ordering exactly: the throttled
        ``save_frame`` fires *before* ``time_elapsed += dt``
        (core/engine.py:94-97), so a frame written after step k carries
        t = k*dt, not (k+1)*dt."""
        self.state = self._step_fn(self.state)
        pos = self._pos_phys()
        alive = _host(self.state.alive)
        if self.record_history:
            self._append_history(pos, alive)
            self._hist_phase = 0  # a record just landed; run() strides from here
        if self.cache and self.cache_every_n and (self.step_idx % self.cache_every_n == 0):
            self._sync_objects()
            self.save_frame()
        self.time_elapsed += self.dt
        self.step_idx += 1
        self._sync_objects()

    # history floats retained per run() call under history_every="auto"
    _HISTORY_FLOAT_BUDGET = 30_000_000
    # recorded floats per rollout window (device records + one host copy)
    _WINDOW_FLOAT_BUDGET = 2**25

    def _history_stride(self, steps: int) -> int:
        if not self.record_history:
            return 0
        if self.history_every == "auto":
            total = steps * self.state.n_bodies * 3
            stride = max(1, math.ceil(total / self._HISTORY_FLOAT_BUDGET))
            if stride > 1 and not getattr(self, "_warned_auto_stride", False):
                # parity-surface behavior change (reference records every
                # step, core/engine.py:88) gated on N*steps — make it
                # visible at runtime, once, not only in the docstring
                self._warned_auto_stride = True
                warnings.warn(
                    f"history_every='auto': run({steps}) at N="
                    f"{self.state.n_bodies} records every {stride}-th step "
                    "to bound history memory (the reference records every "
                    "step). Pass history_every=1 to force reference parity, "
                    "or an explicit stride to silence this.",
                    RuntimeWarning, stacklevel=3)
            return stride
        return max(1, int(self.history_every))

    def _roll_unrecorded(self, steps: int) -> None:
        self.state, _ = rollout(self.state, self.config, steps, record_every=0,
                                force_fn=self._force_fn,
                                force_detect_fn=self._force_detect_fn)

    def _roll_recorded(self, steps: int, record_every: int) -> None:
        """``steps`` must be a multiple of ``record_every``; snapshots are
        streamed to the host window by window (device and host buffers stay
        O(window))."""
        per_window = max(1, self._WINDOW_FLOAT_BUDGET // (6 * self.state.n_bodies))
        rec_total = steps // record_every
        done_rec = 0
        while done_rec < rec_total:
            w_rec = min(per_window, rec_total - done_rec)
            final, traj = rollout(self.state, self.config, w_rec * record_every,
                                  record_every=record_every, force_fn=self._force_fn,
                                  force_detect_fn=self._force_detect_fn)
            self.state = final
            pos_all = _host(traj.pos).astype(np.float64) * self.rescale.length
            alive_all = _host(traj.alive)
            for r in range(w_rec):
                self._append_history(pos_all[r], alive_all[r])
            done_rec += w_rec

    def _advance(self, steps: int, stride: int) -> None:
        """Advance ``steps`` steps, appending history every ``stride``-th
        step globally (0 = no recording). The stride phase
        (``self._hist_phase``: steps accumulated since the last history
        record) persists across segments and run() calls, so frame-boundary
        segmentation never shifts or drops records."""
        done = 0
        if stride:
            phase = self._hist_phase % stride
            pre = (stride - phase) % stride  # steps to the pending record
            if pre and steps >= pre:
                self._roll_recorded(pre, pre)  # exactly one record
                done = pre
            n_full = (steps - done) // stride
            if n_full > 0:
                self._roll_recorded(n_full * stride, stride)
                done += n_full * stride
            self._hist_phase = (self._hist_phase + steps) % stride
        tail = steps - done
        if tail:
            self._roll_unrecorded(tail)
        self.time_elapsed += self.dt * steps
        self.step_idx += steps

    def run(self, steps: int) -> None:
        """Advance ``steps`` steps in rollouts (windowed device -> host
        streaming), preserving history and throttled frame-cache semantics:
        history is appended every ``history_every``-th step (every step when
        1; "auto" bounds retained memory), and JSONL frames are written from
        the *exact* synced state at each frame step — runs are split at
        frame boundaries, so frames are bit-identical to stepwise execution
        even across mid-run merges.
        """
        steps = int(steps)
        if steps <= 0:
            return
        want_frames = bool(self.cache and self.cache_every_n)
        stride = self._history_stride(steps)
        end = self.step_idx + steps
        while self.step_idx < end:
            if want_frames:
                c = self.cache_every_n
                k_frame = ((self.step_idx + c - 1) // c) * c  # next frame step
                seg_end = min(end, k_frame + 1)
            else:
                k_frame = None
                seg_end = end
            seg = seg_end - self.step_idx
            self._advance(seg, stride)
            if k_frame is not None and self.step_idx == k_frame + 1:
                self._sync_objects()
                # reference frame-timestamp quirk: a frame written after
                # step k carries t = k*dt (core/engine.py:94-97)
                self.time_elapsed -= self.dt
                self.save_frame()
                self.time_elapsed += self.dt
        self._sync_objects()

    # -- history / frames -----------------------------------------------------

    def named_history(self, limit: int = 0) -> dict[str, list[list[float]]]:
        """History keyed by body name (reference: core/engine.py:59-63)."""
        if limit > 0:
            return {o.name: self.history[o.uuid][-limit:] for o in self.objects}
        return {o.name: self.history[o.uuid] for o in self.objects}

    def save_frame(self) -> None:
        """Append the current state to the JSONL cache (same schema as the
        reference, core/engine.py:48-57)."""
        append_jsonl(self.cache_fp, {
            "time_elapsed": self.time_elapsed,
            "objects": self.objects.to_dict(),
            "history": self.named_history(limit=1),
        })

    # -- checkpoint / resume -----------------------------------------------------

    def checkpoint(self, path: str | Path) -> None:
        """Full-fidelity device-state checkpoint (``.npz``)."""
        ckpt.save_state(self.state, path, meta={
            "time_elapsed": self.time_elapsed,
            "step_idx": self.step_idx,
            "dt": self.dt,
            "softening": self.softening,
            "rescale": dataclasses.asdict(self.rescale),
            "uuids": self._uuids,
            "names": [o.name for o in self.objects],
        })

    def resume(self, path: str | Path) -> None:
        """Restore device state from :meth:`checkpoint` output (or the JAX
        facade's ``.npz``) onto this engine's device.

        Validates that the checkpoint's rescale and dt match this engine's
        (internal-unit state is meaningless under a different rescale),
        re-resolves the force and step functions if the body count changed,
        and restores the uuid <-> row mapping when the checkpoint's uuids
        match this engine's objects (cross-process resume of the same scene
        construction keeps working by row order otherwise)."""
        state, meta = ckpt.load_state(path, device=self.device)
        rs = meta.get("rescale")
        if rs is not None:
            for k in ("length", "mass", "time"):
                mine = getattr(self.rescale, k)
                if abs(rs[k] - mine) > 1e-12 * max(abs(mine), 1e-300):
                    raise ValueError(
                        f"checkpoint rescale.{k}={rs[k]!r} != engine's {mine!r}; "
                        "construct the engine with rescale matching the "
                        "checkpoint (internal units would be reinterpreted)"
                    )
        meta_dt = meta.get("dt")
        if meta_dt is not None and abs(meta_dt - self.dt) > 1e-12 * abs(self.dt):
            raise ValueError(
                f"checkpoint dt={meta_dt} != engine dt={self.dt}; "
                "construct the engine with the checkpoint's dt"
            )
        rebuild = state.n_bodies != self.state.n_bodies
        self.state = state
        if rebuild:
            self._rebuild_compiled(state.n_bodies)
        uuids = meta.get("uuids")
        if uuids is not None and len(uuids) == state.n_bodies:
            known = {o.uuid for o in self.objects}
            if any(u in known for u in uuids if u is not None):
                self._uuids = list(uuids)
        self.time_elapsed = meta.get("time_elapsed", 0.0)
        self.step_idx = meta.get("step_idx", 0)
        self._sync_objects()

    def resume_from_cache(self, cache_fp: Optional[str] = None) -> bool:
        """Resume host objects + clock from the last JSONL frame — the load
        path the reference never implemented. Returns True if a frame was
        found."""
        frame = last_jsonl(cache_fp or self.cache_fp)
        if frame is None:
            return False
        self.objects = ObjectCollection.from_dict(frame["objects"])
        self.time_elapsed = frame["time_elapsed"]
        scene = compile_objects(self.objects)
        self.state = make_state(
            scene.pos, scene.vel, scene.mass, scene.radius,
            precision=self.precision, rescale=self.rescale, device=self.device,
        )
        # the cached frame may hold fewer bodies than the engine was built
        # with (post-merge caches): re-resolve the force and step functions
        # for the restored body count before seeding forces
        self._rebuild_compiled(self.state.n_bodies)
        acc0, U0 = self._force_fn(self.state.pos, self.state.mass, self.state.alive)
        self.state = self.state.replace(acc=acc0, potential=U0)
        self._uuids = list(scene.uuids)
        for o in self.objects:
            self.history.setdefault(o.uuid, [o.position().tolist()])
        return True

    # -- diagnostics ---------------------------------------------------------------

    def total_energy(self) -> float:
        """K + U with U from the last force evaluation
        (reference: core/engine.py:104-112)."""
        E = diag.total_energy(self.state.vel_full(), self.state.mass, self.state.potential)
        return float(E) * self.rescale.energy

    def angular_momentum(self) -> np.ndarray:
        """L = sum r x mv (reference: core/engine.py:114-121)."""
        L = diag.angular_momentum(self.state.pos_full(), self.state.vel_full(),
                                  self.state.mass)
        return _host(L).astype(np.float64) * self.rescale.angular_momentum


def run_simulation(engine: SimulationEngine, steps: int, print_every: int = 100):
    """Drive an engine while printing relative energy / angular-momentum
    drift (reference: core/engine.py:124-134). Steps are executed in
    ``run`` chunks of ``print_every``."""
    E0 = engine.total_energy()
    L0 = engine.angular_momentum()
    done = 0
    while done < steps:
        chunk = min(print_every, steps - done)
        engine.run(chunk)
        done += chunk
        E = engine.total_energy()
        L = engine.angular_momentum()
        dE = (E - E0) / abs(E0)
        dL = np.linalg.norm(L - L0) / (np.linalg.norm(L0) + 1e-30)
        print(f"step {done}: dE={dE:.3e}, dL={dL:.3e}")
