"""Structured run metrics.

The reference's only instrumentation is a drift print line
(core/engine.py:124-134). Here each rollout window produces a structured
record — steps/s, relative energy and angular-momentum drift, collision
activity, wall time — computed from on-device reductions and emitted
host-side as dicts (JSON-linable), so production serving can ship them to
whatever log pipeline without parsing stdout. A window's wall time ends
after the engine's device work: the recorder synchronizes the engine's
device before it reads the clock (the energy read would wait for it too,
but only after the clock).
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["WindowMetrics", "MetricsRecorder"]


def _synchronize(engine) -> None:
    """Wait for the engine's queued device work (a no-op on the CPU)."""
    device = getattr(engine, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class WindowMetrics:
    """One rollout window's worth of diagnostics."""

    step: int
    time_elapsed: float
    wall_s: float
    steps_per_s: float
    body_steps_per_s: float
    energy: float
    dE_rel: float
    dL_rel: float
    n_alive: int
    n_merged: int

    def to_json(self) -> str:
        return json.dumps(asdict(self))


@dataclass
class MetricsRecorder:
    """Accumulates per-window metrics for an engine run.

    Usage:
        rec = MetricsRecorder.start(engine)
        engine.run(500); rec.record(engine)
        ...
        for w in rec.windows: print(w.to_json())
    """

    E0: float
    L0: np.ndarray
    n0: int
    last_step: int
    last_time: float
    last_wall: float
    windows: list[WindowMetrics] = field(default_factory=list)
    emit: Optional[Callable[[WindowMetrics], None]] = None

    @classmethod
    def start(cls, engine, emit: Optional[Callable] = None) -> "MetricsRecorder":
        _synchronize(engine)
        return cls(
            E0=engine.total_energy(),
            L0=np.asarray(engine.angular_momentum()),
            n0=len(engine.objects),
            last_step=engine.step_idx,
            last_time=engine.time_elapsed,
            last_wall=time.perf_counter(),
            emit=emit,
        )

    def record(self, engine) -> WindowMetrics:
        _synchronize(engine)
        now = time.perf_counter()
        wall = now - self.last_wall
        steps = engine.step_idx - self.last_step
        E = engine.total_energy()
        L = np.asarray(engine.angular_momentum())
        n_alive = len(engine.objects)
        w = WindowMetrics(
            step=engine.step_idx,
            time_elapsed=engine.time_elapsed,
            wall_s=wall,
            steps_per_s=steps / wall if wall > 0 else 0.0,
            body_steps_per_s=steps * n_alive / wall if wall > 0 else 0.0,
            energy=E,
            dE_rel=(E - self.E0) / abs(self.E0) if self.E0 else 0.0,
            dL_rel=float(np.linalg.norm(L - self.L0)
                         / (np.linalg.norm(self.L0) + 1e-30)),
            n_alive=n_alive,
            n_merged=self.n0 - n_alive,
        )
        self.windows.append(w)
        self.last_step = engine.step_idx
        self.last_time = engine.time_elapsed
        self.last_wall = now
        if self.emit is not None:
            self.emit(w)
        return w
