"""One-call convenience API: scene in, trajectory out.

A scene is a Keplerian ``System``, an ``ObjectCollection`` or a list of
``Object`` (compiled by ``models.scene``), or ``SceneArrays``. Wraps
natural-unit rescaling, the precision policy, force-path selection,
the rollout and the unit conversion back to physical units behind a single
function. Ported so far: the exact-force kdk, euler, rk4, yoshida4 and
Hermite steppers (Hermite with fixed or adaptive dt and block timesteps)
and the multirate (RESPA) stepper on one device, with or without bounce,
merge or resolve collisions (with debris into ``spare`` dead slots), the
exact-force variants (``force_impl="pallas_sym"``, ``"mxu"``,
``"pallas_mxu"``), the tree force solver (``force_impl="tree"``) in its
four near modes with probe-sized budgets and ``tree_accuracy=``, and the
mesh solvers (``force_impl="pm"`` and ``"p3m"``) on an auto-pinned cube,
and the body-sharded rollout over a mesh (``mesh=``, ``shard_axis=``: the
exact-force ring with every collision mode, PM, P3M's ring, the sharded
tree with its staged route, and the sharded RESPA).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import numpy as np
import torch

from .engine.multirate import respa_rollout
from .engine.rollout import (_box_tensors, init_forces, init_forces_staged, rollout,
                             rollout_staged)
from .engine.state import NBodyState, Rescale, make_state
from .models.body import System
from .models.constants import STANDARD, UnitProfile
from .models.objects import Object, ObjectCollection
from .models.scene import SceneArrays, compile_objects, compile_system
from .ops.neighbor import neighbor_budgets
from .ops.p3m import p3m_max_occupancy
from .ops.tree import (tree_class_probe, tree_column_probe, tree_occupancy_probe,
                       tree_pairs_budgets, tree_pairs_probe)
from .ops.tree_near_wl import tree_wl_budgets, tree_wl_probe
from .utils.config import SimConfig

__all__ = ["simulate", "SimResult"]

# tree rollouts at and past this shape take the staged loop, which reads the
# near-field overflow after every step (the JAX package's thresholds)
_STAGED_MIN_LEVELS = 8
_STAGED_MIN_N = 524288


def _respa_fields(scene: SceneArrays, steps: int, dt: float, softening: float,
                  rescale: Rescale, *, respa_k: int, respa_rc: float, respa_r1: float,
                  respa_cell: float, respa_impl: str, respa_refresh: int,
                  shards: int = 0) -> dict:
    """The ``respa_*`` fields of the config in internal units: rc defaults
    to 5 softening lengths, the cell to the larger of 2 rc and rc plus twice
    the distance the 99th-percentile speed covers in one frozen-geometry
    window (each body may move half the skin), and the budgets come from the
    probe with a chunk of 32 and blocks of 4 chunks. Over ``shards`` mesh
    ranks the chunk budget is rounded up to a multiple of lcm(8, shards), so
    that each rank sweeps as many chunks, and the worklist is off (it
    compacts its entries globally and does not split)."""
    if steps % respa_k:
        raise ValueError(f"steps={steps} must divide by respa_k={respa_k}")
    eps2_i = (softening / rescale.length) ** 2
    if eps2_i <= 0:
        raise ValueError("integrator='respa' requires softening > 0")
    rc_i = respa_rc / rescale.length if respa_rc else 5.0 * eps2_i ** 0.5
    pos_i = np.asarray(scene.pos, np.float64) / rescale.length
    if respa_cell:
        cell_i = respa_cell / rescale.length
    else:
        vel_i = np.asarray(scene.vel, np.float64) / rescale.velocity
        vmag = np.linalg.norm(vel_i, axis=1)
        v99 = float(np.quantile(vmag, 0.99)) if vmag.size else 0.0
        cell_i = max(2.0 * rc_i,
                     rc_i + 4.0 * respa_refresh * respa_k * (dt / rescale.time) * v99)
    m_grid, k_ch, w_blk, wl_q = neighbor_budgets(pos_i, cell=cell_i, chunk=32, rj=4,
                                                  with_wl=True)
    if shards:
        mult = int(np.lcm(8, shards))
        k_ch, wl_q = -(-k_ch // mult) * mult, 0
    return dict(respa_k=respa_k, respa_rc=rc_i,
                respa_r1=respa_r1 / rescale.length if respa_r1 else 0.0,
                respa_cell=cell_i, respa_m=m_grid, respa_max_chunks=k_ch,
                respa_w_blk=w_blk, respa_chunk=32, respa_rj=4, respa_impl=respa_impl,
                respa_wl_entries=wl_q, respa_refresh=respa_refresh)


def _tree_budget_cfg(cfg: SimConfig, state: NBodyState, *, tree_near: str, tree_levels,
                     tree_capacity) -> SimConfig:
    """Probe-size every static tree budget from the initial distribution in
    one pass (1.5x headroom; the hot loop drops the overflow counter, so the
    budgets are sized here). ``tree_levels="auto"`` takes the smallest of 5-8
    levels whose densest finest cell holds at most 64 bodies. The budgets
    are per cell under ``"cells"`` (``tree_class_probe``), per column under
    ``"columns"`` (``tree_column_probe``), per chunk octave under ``"pairs"``
    (``tree_pairs_budgets``) and per worklist under ``"kernel"``
    (``tree_wl_budgets``); ``tree_capacity="auto"`` sizes the cell or column
    capacity (above 4,096 bodies a cell or 16,384 a column it raises).

    ``tree_near="auto"`` resolves to ``"kernel"``, where the JAX package
    picks ``"pairs"`` at N >= 65,536 with levels >= 7 and ``"columns"``
    below, a rule its TPU measured (its XLA-gather sweeps against each
    other). On the card the B7 kernel computes the same chunk-pair near field
    and the eager sweeps stand behind it: at ``bench_tree``'s 65,536-body
    Plummer sphere, levels 7, each mode on its probed budgets, one
    evaluation takes 33.7 ms with ``"kernel"`` against 66.4 ms
    (``"pairs"``, chunk 64), 153.2 ms (``"columns"``) and 322.9 ms
    (``"cells"``), and at 1,048,576 bodies, levels 8, 54.8 ms against
    604.7 ms for ``"pairs"`` (CUDA events, medians of 3, in one call on an
    H100 80GB HBM3 at 700 W: ``chip_smoke.py`` phase 48; the eager modes
    are host-bound, and another call read 49.2 ms against 83.4-600.3)."""
    box = cfg.pm_box_arrays()
    if tree_levels == "auto":
        for tree_levels in (5, 6, 7, 8):
            occ, _ = tree_occupancy_probe(state.pos, state.alive, levels=tree_levels, box=box)
            if occ <= 64 or tree_levels == 8:
                break
    if tree_near == "auto":
        tree_near = "kernel"
    levels, ws = int(tree_levels), cfg.tree_ws
    cfg = cfg.replace(tree_levels=levels, tree_near=tree_near)
    if tree_near == "pairs":
        k_ch, entries = tree_pairs_budgets(state.pos, state.alive, levels=levels, ws=ws,
                                           chunk=cfg.tree_chunk, box=box)
        return cfg.replace(tree_max_chunks=k_ch, tree_pair_entries=entries)
    if tree_near == "kernel":
        k_ch, wl_q = tree_wl_budgets(state.pos, state.alive, levels=levels, ws=ws,
                                     chunk=cfg.tree_chunk, rj=cfg.tree_wl_rj, box=box)
        return cfg.replace(tree_max_chunks=k_ch, tree_wl_entries=wl_q)
    if tree_near == "columns":
        occ, ncells, nbig, nfront, nchunks = tree_column_probe(
            state.pos, state.alive, levels=levels, ws=ws, box=box, with_chunks=True)
        unit_cap = 4 ** levels
    else:
        occ, ncells, nbig, nfront = tree_class_probe(state.pos, state.alive, levels=levels,
                                                     ws=ws, box=box)
        unit_cap = 8 ** levels
    # class-list budgets at 1.5x, /256-aligned: the K // 8 and K // 4
    # defaults are mostly sentinel padding on concentrated systems
    kcells = min(state.n_bodies, unit_cap, -(-int(ncells * 1.5) // 1024) * 1024)
    kbig = min(kcells, max(256, -(-int(nbig * 1.5) // 256) * 256))
    kfront = min(kcells, max(256, -(-int(nfront * 1.5) // 256) * 256))
    cfg = cfg.replace(tree_max_cells=kcells, tree_max_big=kbig, tree_max_frontier=kfront)
    if tree_near == "columns":
        # the big sweep's i-side chunk list, at the same headroom
        cfg = cfg.replace(tree_max_chunks=max(256, -(-int(nchunks * 1.5) // 256) * 256))
    if tree_capacity == "auto":
        cap = max(16, -(-int(occ * 1.5) // 8) * 8)
        cap_bound = 16384 if tree_near == "columns" else 4096
        if cap > cap_bound:
            unit = "column" if tree_near == "columns" else "cell"
            raise ValueError(
                f"tree_capacity='auto': densest {unit} holds {occ} bodies; raise "
                "tree_levels (finer cells) for this concentration")
        cfg = cfg.replace(tree_capacity=cap)
    return cfg


# the (order, ws) escalation ladder of tree_accuracy=, cheapest first (the
# JAX package's cost order at 65,536 bodies: o1 ws1 < o2 ws1 < o1 ws2 <~ o2
# ws2; each rung buys ~5x force error)
_TREE_ACCURACY_LADDER = ((1, 1), (2, 1), (1, 2), (2, 2))


def _tree_accuracy_probe(cfg: SimConfig, state: NBodyState, *, target: float,
                         tree_near: str, tree_levels, tree_capacity) -> SimConfig:
    """Map one accuracy target to the tree's coupled budgets: walk the
    (order, ws) ladder cheapest first, measure each rung's force error on
    the initial state (the relative RMS ``rms(|a_tree - a_exact|) /
    rms(|a_exact|)`` over live bodies, against one exact evaluation through
    ``force_impl="auto"``: the B1 kernel on the card above 4,096 bodies),
    and return the first budgeted config at or under ``target``; levels,
    capacity and the near budgets come from :func:`_tree_budget_cfg` at each
    rung. Raises ``ValueError`` with every measured error when no rung meets
    the target."""
    from .engine.rollout import resolve_force_fn

    n, dev, dtype = state.n_bodies, state.device, state.dtype

    def host_acc(fn):
        acc = fn(state.pos, state.mass, state.alive)[0]
        return acc.detach().to("cpu", torch.float64).numpy()

    alive = state.alive.cpu().numpy()
    ax = host_acc(resolve_force_fn(cfg.replace(force_impl="auto"), n, dev, dtype))[alive]
    rms_x = float(np.sqrt(np.mean(np.sum(ax * ax, axis=1))))
    if rms_x == 0.0:
        return _tree_budget_cfg(cfg, state, tree_near=tree_near, tree_levels=tree_levels,
                                tree_capacity=tree_capacity)
    errs = []
    for order, ws in _TREE_ACCURACY_LADDER:
        cand = _tree_budget_cfg(cfg.replace(tree_order=order, tree_ws=ws), state,
                                tree_near=tree_near, tree_levels=tree_levels,
                                tree_capacity=tree_capacity)
        d = host_acc(resolve_force_fn(cand, n, dev, dtype))[alive] - ax
        err = float(np.sqrt(np.mean(np.sum(d * d, axis=1)))) / rms_x
        errs.append((order, ws, err))
        if err <= target:
            return cand
    detail = ", ".join(f"order={o} ws={w}: {e:.2e}" for o, w, e in errs)
    raise ValueError(
        f"tree_accuracy={target:g}: no tree configuration meets the target on this scene "
        f"(measured relative RMS force errors: {detail}). Use the exact kernels "
        "(force_impl='auto'): at collisional N they are the 1e-6-grade path.")


def _tree_outgrown(cfg: SimConfig, final: NBodyState) -> bool:
    """The end-of-run probe, by the near mode in use: did the final
    distribution outgrow the near-field budgets sized from the initial
    one?"""
    kw = dict(levels=cfg.tree_levels, ws=cfg.tree_ws, box=cfg.pm_box_arrays())
    if cfg.tree_near == "pairs":
        total, per = tree_pairs_probe(final.pos, final.alive, chunk=cfg.tree_chunk, **kw)
        ent = cfg.tree_pair_entries
        return total > cfg.tree_max_chunks or any(
            v and (o >= len(ent) or v > ent[o]) for o, v in enumerate(per))
    if cfg.tree_near == "kernel":
        total, entries = tree_wl_probe(final.pos, final.alive, chunk=cfg.tree_chunk,
                                       rj=cfg.tree_wl_rj, **kw)
        return total > cfg.tree_max_chunks or entries > cfg.tree_wl_entries
    if cfg.tree_near == "columns":
        occ, ncells = tree_column_probe(final.pos, final.alive, **kw)[:2]
    else:
        occ, ncells = tree_occupancy_probe(final.pos, final.alive, levels=cfg.tree_levels,
                                           box=kw["box"])
    return occ > cfg.tree_capacity or ncells > cfg.tree_max_cells


def _auto_pm_box(scene: SceneArrays, rescale: Rescale) -> tuple:
    """The mesh cube pinned from the initial extent in internal units: the
    center of the extent and twice its largest half-width (1 for a point)."""
    p0 = np.asarray(scene.pos, np.float64) / rescale.length
    c0 = (p0.max(0) + p0.min(0)) / 2.0
    half0 = float(np.max(np.abs(p0 - c0))) * 2.0 or 1.0
    return (float(c0[0]), float(c0[1]), float(c0[2]), half0)


def _p3m_capacity(state: NBodyState, cfg: SimConfig, grid: int) -> int:
    """``p3m_capacity="auto"``: the densest short-range cell of the initial
    state with 1.5x headroom, rounded up to a multiple of 8 (at least 32);
    more than 4,096 raises."""
    occ = p3m_max_occupancy(state.pos, state.alive, grid=grid,
                            box=_box_tensors(cfg, state.device))
    cap = max(32, -(-int(occ * 1.5) // 8) * 8)
    if cap > 4096:
        raise ValueError(
            f"p3m_capacity='auto': densest cell holds {occ} bodies (needs > 4096 with "
            "headroom): the scene is too concentrated for P3M; use the exact kernels or PM")
    return cap


def _pm_softening_warning(cfg: SimConfig, grid: int) -> None:
    """PM's collisionless contract: the mesh smooths pair forces below ~one
    cell spacing h, so a softening under h / 2 is outside it (the headline
    65,536-body cluster there drifts ~1e-2 over 10k steps, DESIGN.md §10)."""
    h_cell = 2.0 * float(cfg.pm_box[3]) / float(grid)
    eps_i = float(cfg.eps2) ** 0.5
    if eps_i < 0.5 * h_cell:
        warnings.warn(
            f"force_impl='pm': softening ({eps_i:.3g} internal) is below half the mesh cell "
            f"spacing (h = {h_cell:.3g}): the mesh smooths forces at ~h, so dynamics below "
            "the grid scale are not resolved and energy drift is fluctuation-dominated "
            "(measured ~1e-2 over 10k steps in this regime, DESIGN.md §10). Use a finer "
            "pm_grid, the P3M solver (force_impl='p3m'), or the exact kernels.", stacklevel=3)


def _escaped(cfg: SimConfig, final: NBodyState) -> int:
    """Live bodies of the final state outside the pinned mesh cube."""
    center, half = cfg.pm_box_arrays()
    fp = final.pos.detach().double().cpu().numpy()
    out = np.any(np.abs(fp - np.asarray(center, np.float64)) > float(half), axis=-1)
    return int(np.sum(out & final.alive.cpu().numpy()))


@dataclasses.dataclass
class SimResult:
    """Physical-unit outputs of :func:`simulate`."""

    pos: np.ndarray        # [R, N, 3] recorded positions (physical units)
    vel: np.ndarray        # [R, N, 3]
    time: np.ndarray       # [R]
    energy: np.ndarray     # [R]
    ang_mom: np.ndarray    # [R, 3]
    names: list[str]
    final_state: NBodyState
    rescale: Rescale
    config: SimConfig

    @property
    def energy_drift(self) -> float:
        """max |E_t - E_0| / |E_0| over the recording."""
        return float(np.max(np.abs(self.energy - self.energy[0])
                            / abs(self.energy[0])))


def simulate(
    scene: Union[System, ObjectCollection, list[Object], SceneArrays],
    *,
    steps: int,
    dt: float,
    device: torch.device | str,
    softening: float = 0.0,
    record_every: Optional[int] = None,
    precision: Optional[str] = None,
    integrator: str = "kdk",
    collisions: str = "none",
    restitution: float = 1.0,
    frag_seed: int = 0,
    debris_k: int = 0,
    debris_max_pairs: int = 4,
    debris_energy_frac: float = 0.3,
    debris_sep: float = 1.0,
    spare: int = 0,
    force_impl: str = "auto",
    adaptive_eta: Optional[float] = None,
    dt_min: float = 0.0,
    hermite_fast_cap: int = 0,
    hermite_max_substeps: int = 64,
    hermite_rungs: int = 1,
    respa_k: int = 8,
    respa_rc: float = 0.0,
    respa_r1: float = 0.0,
    respa_cell: float = 0.0,
    respa_impl: str = "auto",
    respa_refresh: int = 1,
    pm_grid: int = 64,
    p3m_capacity: Union[int, str] = "auto",
    pm_box: Optional[tuple] = None,
    tree_levels: Union[int, str] = 6,
    tree_capacity: Union[int, str] = "auto",
    tree_ws: int = 1,
    tree_order: int = 1,
    tree_accuracy: Optional[float] = None,
    tree_near: str = "auto",
    tree_chunk: int = 32,
    tree_wl_rj: int = 8,
    unit_profile: UnitProfile = STANDARD,
    rescale: Optional[Rescale] = None,
    mesh=None,
    shard_axis: str = "body",
) -> SimResult:
    """Simulate a scene on ``device`` and return its recorded trajectory in
    physical units.

    ``scene`` is a Keplerian ``System`` (compiled to SI state vectors by
    ``models.scene.compile_system``, which standardizes the system's units in
    place and adds each moon's parent state), an ``ObjectCollection`` or a
    list of ``Object`` (``compile_objects``, in the objects' own units), or
    ``SceneArrays`` as they are.

    ``precision`` defaults to ``"f64"`` on the CPU (the golden path) and
    ``"ds32"`` on CUDA. ``record_every`` defaults to ~100 evenly spaced
    records. ``softening`` and ``dt`` are in scene units.
    ``collisions="bounce"`` bounces touching spheres (``scene.radius``)
    with coefficient of restitution ``restitution``; ``collisions="merge"``
    merges every chain of touching spheres into its lowest-index member
    (mass and momentum conserved, volumes added), the others recorded dead;
    ``collisions="resolve"`` runs the outcome model (absorption above a mass
    ratio of 10, fragmentation rolled from ``frag_seed`` and the step,
    bounce), and with ``debris_k`` > 0 a fragmenting pair spawns
    ``debris_k`` conserving fragments (``debris_max_pairs``,
    ``debris_energy_frac``, ``debris_sep``: see
    ``ops.collisions.resolve_outcomes``) into dead slots, of which
    ``spare`` are added to the scene.
    ``integrator="hermite"`` takes ``adaptive_eta`` (Aarseth steps clipped
    to [dt_min, dt]; ``dt_min`` in scene units) and the block-timestep knobs
    ``hermite_fast_cap``, ``hermite_max_substeps`` and ``hermite_rungs``
    (see :class:`SimConfig`).

    ``integrator="respa"`` runs the multirate stepper: one exact force
    evaluation per ``respa_k`` leapfrog substeps and the switched near force
    every substep (``engine.multirate``). ``steps`` counts substeps and must
    divide by ``respa_k``; ``record_every`` is rounded to a multiple of it.
    ``respa_rc`` (switch radius, default 5 softening lengths) and
    ``respa_cell`` (neighbor-grid cell, default from rc and the 99th
    percentile speed) are in scene units; the search budgets are sized from
    the initial distribution (``ops.neighbor.neighbor_budgets``). A nonzero
    overflow or skin counter, read once after the run, raises a
    ``RuntimeWarning``: near pairs may have been missed.

    ``force_impl`` takes the exact-force variants as the JAX package does:
    ``"pallas_sym"`` (the half-pair kernel; U is 0, so the recorded
    energies are kinetic only), ``"mxu"`` and ``"pallas_mxu"`` (the Gram
    forms); none has a contact-detecting variant, so with bounce the sweep
    runs every step ungated. N must meet each kernel's tile rule.

    ``force_impl="tree"`` runs the tree solver (``ops.tree``) with
    ``tree_levels`` (an int or ``"auto"``), ``tree_capacity`` (an int or
    ``"auto"``: the densest cell or column at 1.5x), ``tree_ws``,
    ``tree_order``, ``tree_near`` (``"cells"``, ``"columns"``, ``"pairs"``,
    ``"kernel"`` or ``"auto"``, which resolves to ``"kernel"`` on the port:
    see ``_tree_budget_cfg`` for the card's times behind that, where the JAX
    package picks ``"pairs"`` or ``"columns"``), ``tree_chunk``,
    ``tree_wl_rj`` and ``pm_box`` (cx, cy, cz, half in scene units; it pins
    the tree's grid). ``tree_accuracy=`` replaces hand-tuning with one
    relative RMS force-error target: each (order, ws) rung of the ladder is
    measured on the initial state against one exact evaluation, and the
    cheapest rung that meets the target is taken (``ValueError`` with the
    measured errors if none does; ``tree_order`` and ``tree_ws`` are then
    ignored). The budgets are sized from the initial distribution; the hot
    loop drops the overflow counter, so the final state is re-probed (by
    the near mode in use) and a ``RuntimeWarning`` says if the budgets were
    outgrown. At
    ``tree_levels >= 8`` and N >= 524,288 the run takes the staged loop
    (``engine.rollout.rollout_staged``), which checks the overflow after
    every step and warns if it was ever nonzero.

    ``force_impl="pm"`` and ``"p3m"`` run the mesh solvers (``ops.pm``,
    ``ops.p3m``) on a ``pm_grid`` mesh a side over the cube ``pm_box``; when
    it is None the cube is pinned from the initial extent (its center, twice
    its half-width), since a refit every step is not a Hamiltonian leapfrog
    conserves. ``p3m_capacity`` is an int or ``"auto"`` (the densest
    short-range cell of the initial state with 1.5x headroom, a multiple of
    8; above 4,096 raises). PM warns when the softening is below half a
    mesh cell (outside its contract), and both warn at the end if live
    bodies left the pinned cube (their deposits clip to the edge cells).
    Neither has a contact-detecting variant; Hermite raises.

    ``mesh`` (a ``parallel.mesh.Mesh``) runs the rollout body-sharded over
    its ``shard_axis`` ranks (N must divide across them): exact forces
    become the ring (``parallel.sharded.make_sharded_rollout``) with bounce,
    merge or resolve across shards, and PM keeps its solver with one psum
    of the density grid. The state is built and its first force evaluation
    made on ``device``, then cut into the mesh's shards; ``final_state`` is
    the gathered full state. P3M rings its short range, the tree splits its
    near sweep (and takes its staged route past the thresholds above), and
    RESPA runs ``parallel.sharded.make_sharded_respa_rollout`` with its
    chunk budget rounded to divide across the ranks and no worklist.
    Hermite under a mesh raises: the JAX package has no sharded Hermite to
    hold it against (``parallel.sharded.HERMITE_REFUSAL``).
    """
    if isinstance(scene, System):
        scene = compile_system(scene)
    elif isinstance(scene, ObjectCollection) or (
            isinstance(scene, list) and scene and all(isinstance(o, Object) for o in scene)):
        scene = compile_objects(scene)
    elif not isinstance(scene, SceneArrays):
        raise TypeError("simulate() takes a System, an ObjectCollection, a list of Object "
                        f"or SceneArrays, got {type(scene).__name__}")
    device = torch.device(device)
    if mesh is not None and integrator == "hermite":
        from .parallel.sharded import HERMITE_REFUSAL

        raise NotImplementedError(HERMITE_REFUSAL)
    if precision is None:
        precision = "f64" if device.type == "cpu" else "ds32"
    if rescale is None:
        rescale = (Rescale.identity() if precision == "f64"
                   else Rescale.natural(scene.pos, scene.mass, unit_profile.G))

    if record_every is None:
        record_every = max(1, steps // 100)
        while steps % record_every:
            record_every -= 1
        if integrator == "respa":
            # snapshots exist at macro boundaries only
            record_every = (record_every // respa_k) * respa_k
            while record_every and steps % record_every:
                record_every -= respa_k
            record_every = record_every or respa_k

    if isinstance(tree_levels, str) and tree_levels != "auto":
        raise ValueError(f"tree_levels must be an int or 'auto', got {tree_levels!r}")
    if isinstance(tree_capacity, str) and tree_capacity != "auto":
        raise ValueError(f"tree_capacity must be an int or 'auto', got {tree_capacity!r}")
    if isinstance(p3m_capacity, str) and p3m_capacity != "auto":
        raise ValueError(f"p3m_capacity must be an int or 'auto', got {p3m_capacity!r}")
    if pm_box is not None:
        # pm_box arrives in scene units like softening and dt
        pm_box = tuple(float(v) / rescale.length for v in pm_box)
    elif force_impl in ("pm", "p3m"):
        # a pinned cube keeps the mesh force a fixed Hamiltonian; escapers
        # clip into edge cells, which the end of the run reports
        pm_box = _auto_pm_box(scene, rescale)

    respa_fields = {}
    if integrator == "respa":
        respa_fields = _respa_fields(scene, steps, dt, softening, rescale, respa_k=respa_k,
                                     respa_rc=respa_rc, respa_r1=respa_r1,
                                     respa_cell=respa_cell, respa_impl=respa_impl,
                                     respa_refresh=respa_refresh,
                                     shards=0 if mesh is None else mesh.shape[shard_axis])
    cfg = SimConfig(
        **respa_fields,
        dt=dt / rescale.time,
        G=rescale.g_internal(unit_profile.G),
        eps2=(softening / rescale.length) ** 2,
        integrator=integrator,
        collisions=collisions,
        restitution=restitution,
        frag_seed=frag_seed,
        debris_k=debris_k,
        debris_max_pairs=debris_max_pairs,
        debris_energy_frac=debris_energy_frac,
        debris_sep=debris_sep,
        force_impl=force_impl,
        adaptive_eta=adaptive_eta,
        dt_min=dt_min / rescale.time if dt_min else 0.0,
        hermite_fast_cap=hermite_fast_cap,
        hermite_max_substeps=hermite_max_substeps,
        hermite_rungs=hermite_rungs,
        pm_grid=pm_grid,
        p3m_capacity=64 if p3m_capacity == "auto" else int(p3m_capacity),
        pm_box=pm_box,
        tree_levels=6 if tree_levels == "auto" else int(tree_levels),
        tree_capacity=48 if tree_capacity == "auto" else int(tree_capacity),
        tree_ws=tree_ws,
        tree_order=tree_order,
        tree_near=tree_near,
        tree_chunk=tree_chunk,
        tree_wl_rj=tree_wl_rj,
    )
    state = make_state(scene.pos, scene.vel, scene.mass, scene.radius,
                       precision=precision, rescale=rescale, spare=spare, device=device)
    if force_impl == "tree" and tree_accuracy is not None:
        cfg = _tree_accuracy_probe(cfg, state, target=float(tree_accuracy), tree_near=tree_near,
                                   tree_levels=tree_levels, tree_capacity=tree_capacity)
    elif force_impl == "tree":
        cfg = _tree_budget_cfg(cfg, state, tree_near=tree_near, tree_levels=tree_levels,
                               tree_capacity=tree_capacity)
    if force_impl == "p3m" and p3m_capacity == "auto":
        cfg = cfg.replace(p3m_capacity=_p3m_capacity(state, cfg, pm_grid))
    if force_impl == "pm" and cfg.eps2 > 0:
        _pm_softening_warning(cfg, pm_grid)
    staged = (force_impl == "tree" and integrator == "kdk" and collisions == "none"
              and cfg.tree_levels >= _STAGED_MIN_LEVELS and state.n_bodies >= _STAGED_MIN_N)
    if mesh is not None and state.n_bodies % mesh.shape[shard_axis]:
        raise ValueError(
            f"N={state.n_bodies} must divide across the mesh's "
            f"{mesh.shape[shard_axis]} '{shard_axis}' shards")
    sharded = dict(mesh=mesh, shard_axis=shard_axis)
    if staged:
        final, traj, overflow = rollout_staged(init_forces_staged(state, cfg, **sharded), cfg,
                                               steps, record_every, **sharded)
        if overflow:
            warnings.warn(
                f"tree near-field overflow {overflow} during the staged rollout: budgets "
                "sized from the initial distribution were outgrown mid-run; re-run in "
                "shorter segments.", RuntimeWarning, stacklevel=2)
    elif integrator == "respa":
        if mesh is not None:
            from .parallel.sharded import (gather_state, make_sharded_respa_rollout,
                                           shard_state)

            state = init_forces(state, cfg)
            roll = make_sharded_respa_rollout(cfg, mesh, state, steps, record_every,
                                              axis=shard_axis)
            shards, traj, rdiag = roll(shard_state(mesh, state, shard_axis))
            final = gather_state(mesh, shards)
        else:
            final, traj, rdiag = respa_rollout(init_forces(state, cfg), cfg, steps,
                                               record_every)
        overflow, skin = int(rdiag["overflow"]), int(rdiag["skin_violation"])
        if overflow or skin:
            warnings.warn(
                f"respa window diagnostics nonzero (overflow={overflow}, "
                f"skin_violation={skin}): near pairs may have been missed; enlarge "
                "respa_cell (skin) or re-run in segments so budgets re-size.",
                RuntimeWarning, stacklevel=2)
    elif mesh is not None:
        from .parallel.sharded import gather_state, make_sharded_rollout, shard_state

        state = init_forces(state, cfg)
        roll = make_sharded_rollout(cfg, mesh, state, steps, record_every, axis=shard_axis)
        shards, traj = roll(shard_state(mesh, state, shard_axis))
        final = gather_state(mesh, shards)
    else:
        final, traj = rollout(init_forces(state, cfg), cfg, steps, record_every)
    if force_impl == "tree" and _tree_outgrown(cfg, final):
        warnings.warn(
            "tree budgets outgrown during the run: the final distribution exceeds the "
            "near-field budgets sized from the initial one; near-field pairs were dropped "
            "near the end of the rollout. Re-run in shorter segments so the budgets "
            "re-size, or pass explicit budgets or levels.", RuntimeWarning, stacklevel=2)
    if force_impl in ("pm", "p3m"):
        esc = _escaped(cfg, final)
        if esc:
            warnings.warn(
                f"{esc} bodies left the pinned pm/p3m mesh cube during the run (deposits "
                "clipped to edge cells). Pass a larger pm_box, or re-run in segments so the "
                "auto-pinned cube re-fits.", RuntimeWarning, stacklevel=2)

    def host(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy().astype(np.float64)

    return SimResult(
        pos=host(traj.pos) * rescale.length,
        vel=host(traj.vel) * rescale.velocity,
        time=host(traj.time) * rescale.time,
        energy=host(traj.energy) * rescale.energy,
        ang_mom=host(traj.ang_mom) * rescale.angular_momentum,
        names=list(scene.names),
        final_state=final,
        rescale=rescale,
        config=cfg,
    )
