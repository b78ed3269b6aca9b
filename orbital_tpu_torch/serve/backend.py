"""The live viewer's simulation backend: the scene, its stepping and the JSON
snapshots, with no web layer (``serve.app`` adds the routes and the thread).

The same scenes, configuration and payloads as the JAX package's viewer
(``app/app.py``):

  * solar mode (``SIM_SCENE=sol``, the default): the bundled solar system
    (with its moons unless ``SIM_MOONS=false``) in a ``SimulationEngine``,
    one engine step a tick of ``SIM_INTERVAL`` seconds;
  * cluster mode (``SIM_SCENE=cluster``): a ``SIM_N``-body virialised
    cluster (default 65,536; seed 0, G = 1, eps2 = 1e-4, dt = 1e-3, ds32),
    ``SIM_STEPS_PER_TICK`` steps of ``rollout`` a tick, and a decimated view
    of ``SIM_VIEW_MAX`` bodies whose trails live in one preallocated float32
    ring. ``SIM_FORCE=tree`` runs the port's tree with ``tree_near="kernel"``
    (the JAX viewer's is ``"pairs"``: the same chunk-pair near field, which
    the port runs fastest through its B7 kernel), its budgets probed at the
    start; past 512k bodies at 8 levels the staged loop.

Configured from the environment with the JAX viewer's names and defaults
(:class:`ViewerConfig`); built by :func:`create_backend`, never at import,
so a test or a script can build it at any size and on any device (the card
unless the caller asks for the CPU). The backend owns a lock: ``tick``,
``checkpoint`` and the page's history copy take it, and each tick publishes
an immutable snapshot by reference swap, so readers never see partial
state.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from ..engine.checkpoint import save_state
from ..engine.engine import SimulationEngine, engine_device, run_simulation
from ..engine.rollout import init_forces, init_forces_staged, rollout, rollout_staged
from ..engine.state import make_state
from ..models.constants import J2000_JD, JULIAN_DAY
from ..models.datasets import solar_system_v2
from ..models.objects import Coordinates, Object, ObjectCollection
from ..models.scene import compile_system
from ..utils.config import SimConfig

__all__ = ["ViewerConfig", "Backend", "create_backend", "generate_solar_system"]

WORLD_SCALE = 1.0  # world units are meters; the viewer rescales client-side
# trail records kept a viewed body in cluster mode
HIST_CAP = 300
# the staged tree loop's thresholds (simulate._STAGED_MIN_*)
_STAGED_MIN_N, _STAGED_MIN_LEVELS = 524288, 8


def generate_solar_system(
    dt: float,
    max_hist: int | None = None,
    use_cache: bool = False,
    cache_fp: str | None = "solar_system_cache.jsonl",
    cache_every_n: int = 600,
    moons: bool = True,
    device: torch.device | str = "cuda",
) -> SimulationEngine:
    """Dataset -> Keplerian states (parent-composed) -> engine
    (reference: app/app.py:19-63)."""
    system = solar_system_v2(moons=moons)
    scene = compile_system(system, compose_parents=True)
    bodies = [
        Object(mass=float(scene.mass[i]), radius=float(scene.radius[i]),
               velocity=scene.vel[i], coordinates=Coordinates(*scene.pos[i]),
               name=scene.names[i])
        for i in range(scene.n)
    ]
    engine = SimulationEngine(
        ObjectCollection(bodies),
        dt=dt,
        softening=1e6,
        restitution=1.0,
        max_hist=max_hist,
        cache=use_cache,
        cache_fp=cache_fp or "solar_system_cache.jsonl",
        cache_every_n=cache_every_n,
        device=device,
    )
    engine.body_map = {b.name: b for b in system.bodies}
    engine.system = system
    return engine


def _flag(env: Mapping[str, str], name: str, default: str) -> bool:
    return env.get(name, default).lower() == "true"


@dataclasses.dataclass(frozen=True)
class ViewerConfig:
    """The viewer's settings, read from the environment under the JAX
    viewer's names (reference: app/app.py:69-76, plus SIM_FPS, SIM_MOONS,
    RESUME_FROM_CACHE, the cluster mode's SIM_* and CHECKPOINT_FP)."""

    interval: float = 1800.0          # SIM_INTERVAL, seconds a solar step
    initial_steps: int = 5000         # SIM_INITIAL_STEPS, warm-up steps
    max_history: int = 7000           # SIM_MAX_HISTORY
    use_cache: bool = False           # USE_CACHE
    cache_fp: Optional[str] = None    # CACHE_FP
    cache_every_n: int = 600          # CACHE_EVERY_N
    fps: float = 10.0                 # SIM_FPS, ticks a second
    moons: bool = True                # SIM_MOONS
    resume_from_cache: bool = False   # RESUME_FROM_CACHE
    scene: str = "sol"                # SIM_SCENE: "sol" or "cluster"
    n: int = 65536                    # SIM_N
    view_max: int = 1500              # SIM_VIEW_MAX
    steps_per_tick: int = 10          # SIM_STEPS_PER_TICK
    force: str = "exact"              # SIM_FORCE: "exact" or "tree"
    tree_levels: int = 0              # SIM_TREE_LEVELS, 0 = auto
    disable_thread: bool = False      # SIM_DISABLE_THREAD
    checkpoint_fp: str = "engine_checkpoint.npz"  # CHECKPOINT_FP

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "ViewerConfig":
        env = os.environ if env is None else env
        return cls(
            interval=float(env.get("SIM_INTERVAL", 1800.0)),
            initial_steps=int(env.get("SIM_INITIAL_STEPS", 5000)),
            max_history=int(env.get("SIM_MAX_HISTORY", 7000)),
            use_cache=_flag(env, "USE_CACHE", "false"),
            cache_fp=env.get("CACHE_FP"),
            cache_every_n=int(env.get("CACHE_EVERY_N", "600")),
            fps=float(env.get("SIM_FPS", "10.0")),
            moons=_flag(env, "SIM_MOONS", "true"),
            resume_from_cache=_flag(env, "RESUME_FROM_CACHE", "false"),
            scene=env.get("SIM_SCENE", "sol"),
            n=int(env.get("SIM_N", "65536")),
            view_max=int(env.get("SIM_VIEW_MAX", "1500")),
            steps_per_tick=int(env.get("SIM_STEPS_PER_TICK", "10")),
            force=env.get("SIM_FORCE", "exact"),
            tree_levels=int(env.get("SIM_TREE_LEVELS", "0")),
            disable_thread=_flag(env, "SIM_DISABLE_THREAD", "false"),
            checkpoint_fp=env.get("CHECKPOINT_FP", "engine_checkpoint.npz"),
        )


def _unwrap_unit(val):
    try:
        return float(val.value) if hasattr(val, "value") else float(val)
    except (TypeError, ValueError):
        return None


class _Cluster:
    """Cluster mode's state, config, view and trail ring."""

    def __init__(self, cfg: ViewerConfig, device: torch.device):
        n = cfg.n
        rng = np.random.default_rng(0)
        pos = rng.normal(size=(n, 3))
        vel = rng.normal(size=(n, 3)) * 0.6
        mass = np.full(n, 1.0 / n)
        state0 = make_state(pos, vel, mass, np.full(n, 1e-4), precision="ds32",
                            device=device)
        sim = SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
        if cfg.force == "tree":
            from ..ops.tree_near_wl import tree_wl_budgets

            levels = cfg.tree_levels or (8 if n > 262144 else 7)
            sim = sim.replace(force_impl="tree", tree_levels=levels, tree_near="kernel")
            k_ch, wl_q = tree_wl_budgets(state0.pos, state0.alive, levels=levels,
                                         ws=sim.tree_ws, chunk=sim.tree_chunk,
                                         rj=sim.tree_wl_rj)
            sim = sim.replace(tree_max_chunks=k_ch, tree_wl_entries=wl_q)
        elif cfg.force != "exact":
            raise ValueError(f"SIM_FORCE must be 'exact' or 'tree', got {cfg.force!r}")
        self.cfg = sim
        self.staged = (cfg.force == "tree" and n >= _STAGED_MIN_N
                       and sim.tree_levels >= _STAGED_MIN_LEVELS)
        self.state = init_forces_staged(state0, sim) if self.staged else init_forces(state0,
                                                                                     sim)
        self.n = n
        self.view = np.linspace(0, n - 1, min(cfg.view_max, n), dtype=np.int64)
        self.view_t = torch.from_numpy(self.view).to(device)
        self.names = [f"b{int(i):06d}" for i in self.view]
        # trail history: ONE preallocated float32 ring [n_view, cap, 3]; the
        # per-tick append is one vectorized row write
        self.hist_buf = np.zeros((len(self.view), HIST_CAP, 3), np.float32)
        self.hist_len = 0
        self.hist_head = 0

    def advance(self, k: int) -> None:
        if self.staged:
            self.state, _, ovf = rollout_staged(self.state, self.cfg, k)
            if ovf:
                print(f"WARNING: tree near-field overflow {ovf} "
                      "(budgets outgrown; restart to re-probe)")
        else:
            self.state, _ = rollout(self.state, self.cfg, k)


class Backend:
    """The viewer's engine (solar mode) or cluster runtime, its lock and its
    published snapshot."""

    def __init__(self, cfg: ViewerConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = engine_device(device)
        self.lock = threading.Lock()
        self.engine: Optional[SimulationEngine] = None
        self.cluster: Optional[_Cluster] = None
        self.resumed = False
        if cfg.scene == "cluster":
            self.cluster = _Cluster(cfg, self.device)
            if cfg.initial_steps > 0:
                print(f"Warming up {cfg.n}-body cluster...")
                self.cluster.advance(cfg.initial_steps)
                float(self.cluster.state.time)
                print("Done.")
        elif cfg.scene == "sol":
            self._start_solar()
        else:
            raise ValueError(f"SIM_SCENE must be 'sol' or 'cluster', got {cfg.scene!r}")
        self.snapshot: dict = self.build_snapshot()

    def _start_solar(self) -> None:
        cfg = self.cfg
        engine = generate_solar_system(
            dt=cfg.interval, max_hist=cfg.max_history, use_cache=cfg.use_cache,
            cache_fp=cfg.cache_fp, cache_every_n=cfg.cache_every_n, moons=cfg.moons,
            device=self.device)
        epoch_ts = (J2000_JD - 2440587.5) * JULIAN_DAY  # seconds since Unix epoch
        engine.sim_epoch = datetime.fromtimestamp(epoch_ts, tz=timezone.utc)
        engine.sim_epoch_jd = float(J2000_JD)
        self.engine = engine
        if cfg.resume_from_cache and cfg.cache_fp and Path(cfg.cache_fp).exists():
            self.resumed = engine.resume_from_cache(cfg.cache_fp)
            print(f"Resumed from cache: {self.resumed} (t={engine.time_elapsed:.0f}s)")
        if not self.resumed and cfg.initial_steps > 0:
            print("Warming up simulation...")
            run_simulation(engine, steps=cfg.initial_steps,
                           print_every=max(1, cfg.initial_steps // 10))
            print("Done.")

    # -- stepping ----------------------------------------------------------------

    def tick(self) -> dict:
        """One tick (an engine step, or SIM_STEPS_PER_TICK cluster steps),
        then a new snapshot, published by reference swap and returned."""
        with self.lock:
            if self.cluster is not None:
                self.cluster.advance(self.cfg.steps_per_tick)
            else:
                self.engine.step()
            self.snapshot = self.build_snapshot()
        return self.snapshot

    # -- snapshots -------------------------------------------------------------------

    def build_cluster_snapshot(self) -> dict:
        """Decimated snapshot: one device -> host copy of the viewed rows,
        the solar payload's field names, and one trail-ring row write."""
        cl = self.cluster
        state = cl.state
        pos = state.pos[cl.view_t].double()
        if state.pos_lo is not None:
            pos = pos + state.pos_lo[cl.view_t].double()
        pos = pos.cpu().numpy()
        t = float(state.time)
        mass = float(1.0 / cl.n)
        head = cl.hist_head
        cl.hist_buf[:, head] = pos.astype(np.float32)
        cl.hist_head = (head + 1) % cl.hist_buf.shape[1]
        cl.hist_len = min(cl.hist_len + 1, cl.hist_buf.shape[1])
        bodies = []
        for k, name in enumerate(cl.names):
            bodies.append({
                "id": name,
                "name": name,
                "mass_kg": mass,
                "radius_km": 1.0,
                "T_seconds": None,
                "fg_ms2": None,
                "position": {"x": float(pos[k, 0]), "y": float(pos[k, 1]),
                             "z": float(pos[k, 2])},
            })
        return {
            "bodies": bodies,
            "mass_min": mass,
            "mass_max": mass,
            "radius_min": 1.0,
            "radius_max": 1.0,
            "time_elapsed": t,
            "sim_time_jd": float(J2000_JD) + t / JULIAN_DAY,
            "sim_time_iso": datetime.fromtimestamp(
                (J2000_JD - 2440587.5) * JULIAN_DAY, tz=timezone.utc).isoformat(),
            "scene": {"kind": "cluster", "n_total": cl.n, "n_view": int(len(cl.view)),
                      "steps_per_tick": self.cfg.steps_per_tick},
        }

    def build_snapshot(self) -> dict:
        """The JSON state payload (the reference's field names,
        app/app.py:117-168). Called by the owner of the lock."""
        if self.cluster is not None:
            return self.build_cluster_snapshot()
        engine = self.engine
        bodies, masses, radii_km = [], [], []
        body_map = getattr(engine, "body_map", {})
        for obj in engine.objects:
            pos_world = obj.position() * WORLD_SCALE
            r_km = float(obj.radius) / 1000.0
            kep = body_map.get(obj.name)
            bodies.append({
                "id": obj.uuid,
                "name": obj.name,
                "mass_kg": float(obj.mass),
                "radius_km": r_km,
                "T_seconds": _unwrap_unit(kep.T) if kep is not None else None,
                "fg_ms2": kep.fg if kep is not None else None,
                "position": {"x": float(pos_world[0]), "y": float(pos_world[1]),
                             "z": float(pos_world[2])},
            })
            masses.append(float(obj.mass))
            radii_km.append(r_km)
        masses = masses or [1.0]
        radii_km = radii_km or [1.0]
        sim_jd = engine.sim_epoch_jd + engine.time_elapsed / JULIAN_DAY
        sim_iso = (engine.sim_epoch + timedelta(seconds=engine.time_elapsed)).isoformat()
        return {
            "bodies": bodies,
            "mass_min": min(masses),
            "mass_max": max(masses),
            "radius_min": min(radii_km),
            "radius_max": max(radii_km),
            "time_elapsed": engine.time_elapsed,
            "sim_time_jd": sim_jd,
            "sim_time_iso": sim_iso,
        }

    def history(self) -> dict:
        """Trails for the bootstrap page: name -> [[x, y, z], ...] (the
        cluster's ring in order, or the engine's last 5,000 records)."""
        with self.lock:
            if self.cluster is not None:
                cl = self.cluster
                buf, length = cl.hist_buf, cl.hist_len
                order = (np.arange(length) + cl.hist_head - length) % buf.shape[1]
                return {n: buf[k, order].tolist() for k, n in enumerate(cl.names)}
            raw = self.engine.named_history(limit=5000)
            return {name: [[p[0] * WORLD_SCALE, p[1] * WORLD_SCALE, p[2] * WORLD_SCALE]
                           for p in pts] for name, pts in raw.items()}

    # -- checkpoint / health -------------------------------------------------------

    def checkpoint(self, path: Optional[str] = None) -> str:
        """Write a full-fidelity device-state checkpoint (``.npz``) to
        ``path`` (default ``CHECKPOINT_FP``); returns the path."""
        path = path or self.cfg.checkpoint_fp
        with self.lock:
            if self.cluster is not None:
                save_state(self.cluster.state, path,
                           meta={"scene": "cluster", "n": self.cluster.n})
            else:
                self.engine.checkpoint(path)
        return str(path)

    def health(self) -> dict:
        """The liveness / readiness probe's payload."""
        return {"status": "ok"}


def create_backend(env: Optional[Mapping[str, str]] = None,
                   device: torch.device | str = "cuda") -> Backend:
    """Build the viewer backend from ``env`` (default ``os.environ``): the
    scene, its warm-up and the first snapshot."""
    return Backend(ViewerConfig.from_env(env), device)
