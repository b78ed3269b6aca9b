"""Simulation configuration.

A copy of ``orbital_tpu.utils.config`` (same fields, defaults and
validation) so that the PyTorch package never imports the JAX one:
``SimConfig(**dataclasses.asdict(jax_cfg))`` converts between the two.
Every solver a field selects is ported. One combination still raises
``NotImplementedError``: ``integrator="hermite"`` under a mesh (the JAX
package has no sharded Hermite to hold one against).

All physical quantities here are in *internal* (device) units; the engine
facade converts from scene units via ``engine.state.Rescale``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SimConfig"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static parameters of the compiled stepper.

    Attributes:
        dt: time step (internal units).
        G: gravitational constant (internal units; 1.0 under natural rescale).
        eps2: squared softening length (internal units).
        restitution: coefficient of restitution for bounce collisions.
        collisions: "none" | "bounce" | "merge" | "resolve" (the
            reference's absorb/fragment/bounce outcome model,
            ``ops.collisions.resolve_outcomes``; small-scene dense sweep,
            fragmentation rolls drawn per step from ``frag_seed``).
        integrator: "kdk" (leapfrog, reference: core/engine.py:65-97) |
            "euler" (semi-implicit, reference: core/physics.py:315-332) |
            "rk4" (classical 4th order; 4 force evals/step) |
            "hermite" (4th-order predictor-corrector with jerk; 1 combined
            acc+jerk eval/step, dense force path) |
            "yoshida4" (4th-order symplectic; 3 weighted KDK sub-steps,
            3 force evals/step — KDK's long-horizon stability at two
            orders higher per-step accuracy).
        force_impl: "auto" | "dense" | "chunked" | "pallas" (the CUDA
            force sweep, ``csrc/nbody_forces.cu``) |
            "pallas_sym" (the CUDA half-pair sweep over upper-triangle
            tile pairs, ``csrc/nbody_forces_sym.cu``; no PE: U is 0) |
            "mxu" (the Gram-identity form in plain torch, full-f32
            matrix products) | "pallas_mxu" (the CUDA Gram-identity
            sweep, ``csrc/nbody_forces_mxu.cu``; the identity cancels on
            close pairs: up to ~2e-3 of max |a| there, ~6e-5 RMS) |
            "pm" (particle-mesh FFT Poisson solver, O(N + G^3 log G) for
            N >> 1e5; collisionless accuracy contract, see ops/pm.py) |
            "p3m" (PM far field + exact short-range cell-list correction,
            ~2e-3 force accuracy at large N for bounded density contrast;
            see ops/p3m.py) |
            "tree" (multilevel monopole far field + exact occupied-cell
            near field — the solver for strongly *concentrated* large-N
            systems where P3M's per-cell capacity overflows; ~1e-2 RMS
            forces at tree_ws=1, ~3e-3 at tree_ws=2; see ops/tree.py) |
            "ring".
        chunk: row-block size for the chunked/pallas force paths.
        shard_axis: mesh axis name for the ring force path (None = unsharded;
            set by ``parallel.sharded``).
        track_potential: compute the softened potential every force eval
            (reference parity, core/physics.py:158). False skips the PE sum
            in the Pallas stepper path (~13% faster); energy diagnostics
            then need an explicit potential evaluation.
        adaptive_eta: hermite only — enables adaptive time steps
            dt = clip(eta * min_i sqrt(|a_i| / |jerk_i|), dt_min, dt)
            (the Aarseth criterion); ``dt`` becomes the ceiling.
        dt_min: floor for the adaptive step.
        ring_block_impl: per-round block-force implementation of the
            multi-device ring (``parallel.sharded``) — "auto" (the CUDA
            block sweep B3 for float32 shards on CUDA that tile by 128 with
            eps2 > 0, the dense torch block otherwise), "pallas" (B3 on
            CUDA, its plain version on the CPU; needs a tileable shard and
            eps2 > 0), or "dense".
        pm_grid: mesh resolution per axis for force_impl="pm"/"p3m".
        p3m_capacity: max bodies per short-range cell (force_impl="p3m");
            overflowing bodies silently lose short-range pairs — size it
            from the density (call ops.p3m.p3m_acc_potential directly once
            to read the overflow counter).
        pm_box: optional (cx, cy, cz, half) pinning the pm/p3m mesh — and
            the tree grid — to a fixed cube. A static mesh makes the
            approximate force a fixed Hamiltonian that leapfrog conserves
            (recommended for long rollouts); default refits the live
            bounding cube every step.
        tree_levels: force_impl="tree" pyramid depth (near field on
            2^levels cells per side). Deeper tolerates higher density
            contrast at 8x far-field cost per level.
        tree_capacity: max bodies per finest tree cell; size it with
            ops.tree.tree_occupancy_probe (simulate(force_impl="tree")
            auto-sizes). Overflowing bodies lose near-field pairs and are
            counted by the solver's overflow output.
        hermite_fast_cap: block-timestep Hermite — when > 0, each macro
            step classifies bodies by the Aarseth criterion
            dt_i = adaptive_eta sqrt(|a|/|jerk|); up to this many bodies
            with dt_i < dt substep at dt/m (m <= hermite_max_substeps,
            chosen per macro step) against predicted sources, so ONE
            close encounter no longer stalls the whole system's step.
            0 disables (global adaptive dt as before). Bodies past the
            cap are stepped at the macro dt (accuracy, never
            correctness, degrades — size the cap generously).
        hermite_max_substeps: ceiling on substeps per macro step.
        tree_order: multipole expansion order — 1 (monopole+dipole,
            fast) | 2 (+quadrupole sources and second-order target
            Taylor; ~3x lower force error per well-separation ratio at
            ~2.5x far-field conv cost, near field unchanged).
        tree_ws: tree well-separation in cells — 1 (fast, ~1e-2 RMS
            forces) or 2 (~3e-3, ~4x the far-field + near-field cost).
        tree_max_cells: static occupied-cell budget for the tree's
            near-field sweep (0 = min(N, 8^levels), always safe; smaller
            compiles a smaller sweep).
        tree_max_big: static budget for BIG cells (> 16 bodies) in the
            near-field occupancy split (0 = max_cells//8 heuristic; size
            from ops.tree.tree_class_probe to cut sentinel padding).
        tree_near: near-field sweep granularity — "cells" (per-cell
            (2ws+1)^3 neighbor-row gathers) | "columns" (per-(x,y)-column
            (2ws+1)^2 gathers with an in-kernel |dz| <= ws band mask;
            ~25x fewer of the row gathers that dominate near-field cost
            on concentrated systems). Under "columns" the capacity /
            max_cells / max_big / max_frontier budgets are PER-COLUMN —
            size them with ops.tree.tree_column_probe.
        tree_max_frontier: static budget for FRONTIER cells (small cells
            adjacent to a big one) in the split (0 = max_cells//4
            heuristic; size from ops.tree.tree_class_probe).
        tree_max_chunks: static budget for the column big sweep's i-side
            32-row chunk list (near="columns" only; 0 = heuristic; size
            from ops.tree.tree_column_probe(with_chunks=True)). Chunking
            makes the big sweep cost scale with big-column BODIES
            instead of big-columns x capacity. Under tree_near="pairs"
            this is the TOTAL chunk-table row budget instead.
        tree_chunk: tree_near="pairs" chunk row size (bodies per packed
            row on both sweep sides).
        tree_pair_entries: tree_near="pairs" static per-octave i-chunk
            budgets; size with ops.tree.tree_pairs_probe
            (simulate(force_impl="tree", tree_near="pairs") probes
            automatically).
        tree_wl_entries: tree_near="kernel" static worklist budget
            (total RJ-row j-blocks); size with
            ops.tree_near_wl.tree_wl_budgets (simulate() probes
            automatically).
        tree_wl_rj: tree_near="kernel" j-block height in chunk rows
            (tree_wl_rj * tree_chunk must be a multiple of 128).
        hermite_rungs: block-timestep Hermite substep LEVELS. 1 (the
            default) substeps every fast body at the single rate the
            fastest needs. R > 1 grants power-of-two rungs by
            sorted-dt position quota (the fastest fast_cap/2^(R-1)
            bodies substep every fine step, the next quota every 2nd,
            ...), so substep force cost scales with the sum of rung
            sizes instead of m x fast_cap. Requires hermite_fast_cap,
            adaptive_eta, and a power-of-two hermite_max_substeps
            >= 2^(R-1).
        hermite_reselect: multi-rung Hermite only — re-sort the riding
            bodies by their CURRENT Aarseth dt at every coarsest-rung
            boundary inside the macro window (all riding rows are
            freshly corrected and time-aligned there, so the carry
            permutation is exact), re-granting position-keyed rungs
            mid-macro: an encounter that hardens inside the window is
            promoted to a finer rung at the next boundary instead of
            waiting for the macro step. Costs one argsort + gather of
            the fast rows per boundary (cheap next to a force
            evaluation). Default True; set False for the frozen
            per-macro grants.
        frag_seed: PRNG seed for collisions="resolve" fragmentation rolls
            (folded with the step counter — outcomes are reproducible).
        resolve_subset: contact-subset budget for collisions="resolve"
            above the dense [N, N] ceiling: up to this many touching
            bodies gather into a small dense scene per step
            (ops.collisions.resolve_outcomes_subset); excess contacts
            defer to the next step's re-detection.
        debris_k: collisions="resolve" debris model — fragments spawned
            per fragmenting pair into entry-dead slots (allocate with
            make_state(spare=...)). 0 (default) reproduces the reference:
            fragmenting bodies are removed without debris
            (core/physics.py:378-383). See ops.collisions.resolve_outcomes
            for the conservation guarantees.
        debris_max_pairs: static per-step budget of fragmenting pairs
            that may spawn debris (pairs beyond it fall back to plain
            removal).
        debris_energy_frac: fraction of each pair's collision kinetic
            energy retained as fragment spread KE (the rest dissipates).
        debris_sep: fragment placement distance in units of (r1 + r2)
            from the pair's center of mass.
        respa_k: integrator="respa" substeps per macro window — ONE exact
            O(N^2) force evaluation per K leapfrog substeps; the smooth
            switched near force (ops/neighbor.py) is evaluated every
            substep and the far remainder is applied as symplectic
            boundary impulses (engine/multirate.py).
        respa_rc: switch radius — pair forces are integrated on the fast
            clock below it (S(r) reaches 0 at rc). Internal units.
        respa_r1: inner switch radius (full near weight below it);
            0 = rc / 2.
        respa_cell: neighbor-grid cell size; cell - rc is the SKIN margin
            that keeps the per-window frozen geometry covering (each body
            may move skin/2 per window — violations are counted).
        respa_m: neighbor grid cells per axis (size with
            ops.neighbor.neighbor_budgets; simulate() probes).
        respa_max_chunks: static chunk-table budget (probe-sized;
            overflowing bodies integrate ballistically for the window and
            are counted).
        respa_w_blk: static per-chunk j-block budget (probe-sized).
        respa_chunk / respa_rj: chunk rows and j-block height
            (rj * chunk must be a multiple of 128).
        respa_impl: near-sweep backend — "auto" (Pallas on TPU, XLA
            elsewhere) | "pallas" (streaming padded grid; worklist when
            respa_wl_entries > 0) | "pallas_sb" (superblock: per-substep
            contiguous j-gather, one grid step per chunk) |
            "pallas_interpret" | "xla".
        respa_wl_entries: worklist-entry budget for the compacted Pallas
            near sweep (``neighbor_budgets(..., with_wl=True)``); 0 keeps
            the padded-table streaming kernel. Only the Pallas backends
            consume it — w_blk stays the probed per-chunk bound either
            way (the jbl table is the worklist's source).
    """

    dt: float
    G: float = 1.0
    eps2: float = 0.0
    restitution: float = 1.0
    collisions: str = "none"
    integrator: str = "kdk"
    force_impl: str = "auto"
    chunk: int = 1024
    shard_axis: Optional[str] = None
    track_potential: bool = True
    adaptive_eta: Optional[float] = None
    dt_min: float = 0.0
    ring_block_impl: str = "auto"
    pm_grid: int = 64
    p3m_capacity: int = 64
    pm_box: Optional[tuple] = None
    tree_levels: int = 6
    tree_capacity: int = 48
    tree_ws: int = 1
    tree_max_cells: int = 0
    tree_order: int = 1
    tree_max_big: int = 0
    tree_max_frontier: int = 0
    tree_max_chunks: int = 0
    tree_near: str = "cells"
    tree_chunk: int = 32
    tree_pair_entries: tuple = ()
    tree_wl_entries: int = 0
    tree_wl_rj: int = 8
    hermite_fast_cap: int = 0
    hermite_max_substeps: int = 64
    hermite_rungs: int = 1
    hermite_reselect: bool = True
    frag_seed: int = 0
    resolve_subset: int = 512
    debris_k: int = 0
    debris_max_pairs: int = 4
    debris_energy_frac: float = 0.3
    debris_sep: float = 1.0
    respa_k: int = 8
    respa_rc: float = 0.0
    respa_r1: float = 0.0
    respa_cell: float = 0.0
    respa_m: int = 0
    respa_max_chunks: int = 0
    respa_w_blk: int = 0
    respa_chunk: int = 32
    respa_rj: int = 4
    respa_impl: str = "auto"
    respa_wl_entries: int = 0
    respa_refresh: int = 1

    def __post_init__(self):
        if self.debris_k < 0:
            raise ValueError(f"debris_k must be >= 0, got {self.debris_k}")
        if not 0.0 <= self.debris_energy_frac <= 1.0:
            raise ValueError("debris_energy_frac must be in [0, 1], got "
                             f"{self.debris_energy_frac}")
        if self.collisions not in ("none", "bounce", "merge", "resolve"):
            raise ValueError(f"bad collisions mode: {self.collisions!r}")
        if self.integrator not in ("kdk", "euler", "rk4", "hermite",
                                   "yoshida4", "respa"):
            raise ValueError(f"bad integrator: {self.integrator!r}")
        if self.integrator == "respa":
            if self.respa_k < 1:
                raise ValueError(f"respa_k must be >= 1, got {self.respa_k}")
            if not self.respa_rc > 0:
                raise ValueError("integrator='respa' needs respa_rc > 0 "
                                 "(the near/far switch radius)")
            if not self.respa_cell > self.respa_rc:
                raise ValueError(
                    "respa_cell must exceed respa_rc (the difference is the "
                    f"skin margin); got cell={self.respa_cell}, "
                    f"rc={self.respa_rc}")
            if self.respa_r1 and not (0 < self.respa_r1 < self.respa_rc):
                raise ValueError("respa_r1 must sit in (0, respa_rc)")
            if not self.eps2 > 0:
                raise ValueError("integrator='respa' requires softening > 0")
            if (self.respa_rj * self.respa_chunk) % 128 or \
                    self.respa_chunk % 8:
                raise ValueError(
                    "respa needs chunk % 8 == 0 and rj*chunk % 128 == 0 "
                    f"(got rj={self.respa_rj}, chunk={self.respa_chunk})")
            if self.respa_refresh < 1:
                raise ValueError("respa_refresh must be >= 1")
            if self.respa_refresh > 1 and self.collisions != "none":
                raise ValueError(
                    "respa_refresh > 1 requires collisions='none' (alive-"
                    "set changes mid-freeze would leave bodies slotless)")
            if self.respa_impl not in ("auto", "pallas", "pallas_sb",
                                       "pallas_interpret",
                                       "xla"):
                raise ValueError(f"bad respa_impl: {self.respa_impl!r}")
        if self.force_impl not in ("auto", "dense", "chunked", "pallas", "pallas_sym", "mxu", "pallas_mxu", "pm", "p3m", "tree", "ring"):
            raise ValueError(f"bad force_impl: {self.force_impl!r}")
        if self.tree_ws not in (1, 2):
            raise ValueError(f"tree_ws must be 1 or 2, got {self.tree_ws}")
        # "auto" is a simulate()-level value: _tree_budget_cfg resolves it
        # (pairs/c64 at N >= 65536 with levels >= 7, else columns) before
        # any force layer sees the config; tree_acc_potential itself
        # rejects it
        if self.tree_near not in ("auto", "cells", "columns", "pairs",
                                  "kernel"):
            raise ValueError(f"tree_near must be 'auto', 'cells', "
                             f"'columns', 'pairs', or 'kernel', "
                             f"got {self.tree_near}")
        if self.tree_near == "kernel" and \
                (self.tree_wl_rj * self.tree_chunk) % 128 != 0:
            raise ValueError(
                "tree_near='kernel' needs tree_wl_rj * tree_chunk to be a "
                f"multiple of 128 (got {self.tree_wl_rj}*{self.tree_chunk})")
        if self.tree_order not in (1, 2):
            raise ValueError(
                f"tree_order must be 1 or 2, got {self.tree_order}")
        if self.hermite_fast_cap > 0:
            if self.integrator != "hermite":
                raise ValueError("hermite_fast_cap requires "
                                 "integrator='hermite'")
            if self.adaptive_eta is None:
                raise ValueError(
                    "hermite_fast_cap needs adaptive_eta (the Aarseth "
                    "criterion classifies fast bodies)")
        if self.hermite_max_substeps < 1:
            raise ValueError("hermite_max_substeps must be >= 1")
        if self.hermite_rungs < 1:
            raise ValueError("hermite_rungs must be >= 1")
        if self.hermite_rungs > 1:
            if self.hermite_fast_cap <= 0:
                raise ValueError("hermite_rungs > 1 requires "
                                 "hermite_fast_cap (block timesteps)")
            ms = self.hermite_max_substeps
            if ms & (ms - 1):
                raise ValueError(
                    "hermite_rungs > 1 requires a power-of-two "
                    f"hermite_max_substeps, got {ms}")
            if (1 << (self.hermite_rungs - 1)) > ms:
                raise ValueError(
                    f"hermite_rungs={self.hermite_rungs} needs "
                    f"hermite_max_substeps >= 2^(rungs-1) = "
                    f"{1 << (self.hermite_rungs - 1)}, got {ms}")
        if not (2 <= self.tree_levels <= 8):
            raise ValueError(f"tree_levels must be in [2, 8], got {self.tree_levels}")
        if self.ring_block_impl not in ("auto", "pallas", "dense"):
            raise ValueError(f"bad ring_block_impl: {self.ring_block_impl!r}")
        if self.pm_box is not None and len(self.pm_box) != 4:
            raise ValueError("pm_box must be (cx, cy, cz, half)")
        if self.adaptive_eta is not None and not (self.dt_min > 0.0):
            # dt_min = 0 would let a collapsed Aarseth ratio freeze
            # simulation time inside the compiled rollout (steps would
            # still count) — require an explicit positive floor
            raise ValueError(
                "adaptive_eta requires dt_min > 0 (the adaptive step is "
                "clipped to [dt_min, dt])")

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def pm_box_arrays(self):
        """``pm_box`` as (center ndarray [3], half float32) or None — the
        form ``ops.pm`` / ``ops.p3m`` take (one conversion point so every
        consumer pins the same cube)."""
        if self.pm_box is None:
            return None
        import numpy as np

        return (np.asarray(self.pm_box[:3], np.float32),
                np.float32(self.pm_box[3]))
