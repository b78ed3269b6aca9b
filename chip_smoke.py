#!/usr/bin/env python3
"""Drive the PyTorch port (``orbital_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--drift-steps 1000] [--seed 0]
    python3 chip_smoke.py [--sweep] [--parent DIR]

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked by
``git archive``) it runs phases 1-2 and then only holds B1, B2, B3 (on
coinciding tables), B5, B5 detect, the B5 row subset, B13, B6, B12, B7, the
near sweep, B4, the P3M short range and the merge root search of this tree
against those built from DIR's ``csrc/nbody_forces.cu``,
``nbody_jerk.cu``, ``nbody_forces_mxu.cu``, ``collisions.cu``,
``nbody_forces_sym.cu``, ``tree_near.cu``, ``neighbor.cu``,
``fused_rollout.cu``, ``p3m_short.cu`` and ``collision_roots.cu`` (the root
search's parents integer-equal, gated and ungated, at the contact-rich
radius; the P3M bench row's table within
SHORT_RTOL; N = 65,536, 7 dead, eps2 1e-4 and 0, PE on and off; B7
on the tree tables of ``Smoke.tree_calls``, the near sweep on the RESPA
geometries of ``Smoke.near_calls``, B4 on FUSED_CASES) within FORCE_RTOL,
JERK_RTOL and ENERGY_RTOL with equal contact counts, B13 by the Gram gates,
B6 within BOUNCE_RTOL with the gated B6 bit-equal to the ungated, B7 and
the near sweep within NEAR_RTOL (B7 with equal overflow), B4 within
STATE_ATOL, says whether each is bit-equal, and times both trees' kernels
in turns (B7 at 65,536 and 1,048,576 bodies, B4 at 4,096 and 32,768 in
ds32 and f32, the root search at a count > 0 and at 0), and the block macro
step on each tree's row subset (its time and the host's time to queue it).
A source whose C signature predates its redesign (the near sweep's, B4's,
the row subset's and the P3M short range's first versions) runs through
``FIRST_SIGNATURES``. With
``--sweep`` it runs phases 1-2 and then builds the launch shapes of
``SWEEP`` (``-D`` overrides of the eight sources' shape macros), holds each
against the plain versions and times them in turns, with the registers,
spills and SASS instructions a pair of each.

Phases, one line of output each; any failure exits nonzero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``orbital_tpu_torch/csrc``, one nvcc per
     source, all at once; the launch shape, registers, spills and SASS
     instructions a pair (``cuobjdump -sass``) of B1, B2, B3, B4, B5, B5
     detect, B13 (with the TF32 HMMA of its inner loop, which must be
     there), B6, B12, B7 and the near sweep, the shape, registers and spills
     of the B5 row subset, the P3M short range (with the SASS instructions a
     visited pair of its polynomial sweep) and the contact sweep's two modes,
     the merge root search and resolve's contact mark (with the SASS
     instructions a pair of their prefilter loop, one FSETP a pair, whose
     instructions go to standard error; no spill anywhere), and the issue
     floor they imply
     at 528 warp instructions a clock and 1.98 GHz (B7's and the near
     sweep's from their visited pairs, in phases 24 and 20);
  3. the force kernel (B1) against its plain PyTorch version at N = 65536
     and a ragged N = 5000, PE on/off, eps2 > 0 and = 0, and the ds32 step
     at N = 8192 against the same step on plain forces;
  4. the fused-rollout kernel (B4) against the plain KDK loop at N = 4096
     (ds32 and f32, with dead padding bodies), at a ragged unpadded
     N = 5000 and at N = 32768 (ds32 and f32), with its launch plan;
  5. the main path: the 65,536-body virialised ds32 cluster through
     ``init_forces`` -> a recorded ``rollout`` -> an unrecorded ``rollout``,
     with the energy drift measured in f64 (kinetic on the host, potential
     from the C++ oracle in ``native/``) against |dE/E| <= 1e-6;
  6. an unrecorded N = 4096 rollout, which routes to the fused kernel;
  7. the detecting force kernel (B2) against its plain version (chunked
     forces plus the chunked contact count) at N = 65536 and 5000 with dead
     bodies parked far, and against B1 bit for bit;
  8. the bounce kernel (B6) against its plain version at N = 65536 on the
     contact-rich cluster and at a ragged N = 5000 (a third dead), and its
     skip on a zero count;
  9. the collision main path, bench row: the same cluster with radius 1e-4
     and ``collisions="bounce"`` through ``init_forces`` -> a recorded and an
     unrecorded ``rollout``: no contacts, the drift budget, and a final state
     bit-equal to the collision-free run;
 10. the collision main path, contact-rich: radius 3e-3, restitution 0.8,
     200 steps, and the first 10 steps against the plain forces, counts and
     bounce sweep;
 11. kernel and plain times (CUDA events, median and spread of 3 repeats),
     B4 in turns with the step loop it stands in for
     (``rollout(fused="never")``) at N = 4096, 8192, 16384 and 32768;
 12. the acc + jerk kernel (B5), its detecting variant and its row-subset
     variant against their plain versions at N = 65536 and 5000, eps2 > 0
     and = 0, dead bodies parked far, F = 64 and 37 target rows; the
     detecting variant's count exact and its acc, jerk and U bit-equal to
     B5's; kernel and plain version each against the f64 sum;
 13. the Hermite main path: the same cluster with ``integrator="hermite"``
     through ``init_forces`` -> a recorded and an unrecorded ``rollout``,
     |dE/E| <= 1e-6 in f64;
 14. adaptive Hermite (``adaptive_eta``, dt_min = dt/4096), 300 steps;
 15. block timesteps: the cluster with a hard binary planted, eps2 = 1e-10,
     ``hermite_fast_cap`` = 64, ``hermite_max_substeps`` = 64, rungs 1 and
     3, macro step by macro step against the same stepper on the plain
     versions;
 16. Hermite with bounce collisions: the bench row's radius against the
     collision-free Hermite run up to the first contact, and the
     contact-rich radius on the kernels and on the plain versions;
 17. Hermite kernel, step and macro-step times;
 18. the near-field kernel of the multirate stepper (B8-B11 as one kernel)
     against its plain version, over the padded block table and over the
     worklist, at the 65,536-body headline geometry and at a ragged N = 5000
     with dead bodies and starved budgets (every overflow counter > 0); each
     against the f64 sum too, and the columns of a row table bit-equal to
     four channels;
 19. the multirate (RESPA) main path: the same cluster with the bench's
     configuration (rc = 5 eps, cell = 2 rc, K = 4, refresh every 4 macro
     windows) through ``init_forces`` -> a recorded and an unrecorded
     ``respa_rollout``: zero overflow and skin counters, |dE/E| <= 1e-6 in
     f64, three macro steps on the kernel against the plain sweep, and
     with bounce collisions (refresh 1) bit-equal to a collision-free run
     up to the first contact;
 20. near kernel, geometry, pack/unpack, macro-step and per-substep times at
     K = 4 and K = 5 against the KDK step; the near sweep's pairs (walked by
     every row of every live entry, live, visited by its box rule, issued as
     lane slots, needed: ``near_work``), visited < 10% of walked, and its
     bound over the needed pairs and the bytes it must move;
 21. the tree's near-field kernel (B7) against its plain version at the
     65,536-body Plummer geometry (levels 7, ws 1) and a ragged N = 5000 with
     a third of its bodies dead, at ws 1 and 2 and with starved budgets
     (overflow counts equal to the CPU's and > 0); each against the f64 sum;
 22. the tree force: ``tree_acc_potential`` on B7 against the same on the
     plain sweep, its far field against float64 (on the CPU at order 1, on
     the card at order 2: no TF32), and its RMS error against the exact
     forces (B1) at orders 1 and 2;
 23. the tree main path: ``bench_tree``'s configuration (Plummer 65,536,
     levels 7, dt 1e-4, eps2 1e-6, f32, budgets probed at 1.5x) through
     ``init_forces`` -> 20 recorded -> 1,000 unrecorded ``rollout`` steps with
     B7 once an evaluation and overflow 0; the tree drift run of the headline
     cluster (pm_box (0, 0, 0, 8), dt 1e-3) with |dE/E| <= 1e-3 in f64; and
     ``simulate(force_impl="tree")`` on the card;
 24. tree timings: B7, its plain version, the far field, the evaluation and
     the KDK step at 65,536, with the device's busy share; one evaluation at
     N = 1,048,576 (levels 8) with its error against the exact f64 sum on
     1,024 sampled bodies, beside one B1 evaluation; B7's pairs (walked by
     every row of every entry, live, visited by its box rule, issued as
     lane slots, needed) and its issue floor at both sizes;
 25. the half-pair kernel (B12) against its plain version (the chunked full
     sweep) and the f64 sum at N = 65,536 and a ragged 4,992 (39 tiles of
     128, a third of the bodies dead and parked far): U = 0, dead rows 0;
     eps2 = 0 and N = 5,000 raise ValueError;
 26. the Gram kernel (B13) against its plain version at the same sizes with
     PE on and off, on its own outputs (pe by the Gram gates, S against
     the exact S within GRAM_S_RTOL and GRAM_MAX_RTOL: the kernel forms r2
     on the tensor cores), its PE-off sums and
     acc bit-equal to the PE-on
     ones; its accelerations against the plain version's in RMS, and they
     and the "mxu" route's against the exact f64 sum in RMS and in max (the
     Gram identity's error sits on close pairs), "mxu" also against its
     formula in f64;
 27. the block kernel (B3, B1's sweep over separate i and j tables) against
     its plain version at 16,384 x 65,536 and 65,536 x 16,384; on coinciding
     tables at 65,536 its acc bit-equal to B1's and its pe row B1's plus
     the self term m/eps;
 28. the exact-force variants' main paths: the headline cluster through
     ``init_forces`` -> 20 recorded -> ``--drift-steps`` unrecorded steps with
     ``force_impl="pallas_sym"`` (B12 every evaluation, B1 never) and
     ``"pallas_mxu"`` (B13 every evaluation), and 200 unrecorded steps of
     ``"mxu"``, each with |dE/E| <= 1e-6 in f64; ``"pallas_sym"`` with bounce
     at the bench row's radius for 100 steps (B6 ungated every step) against
     the collision-free run; ``simulate(force_impl="pallas_sym",
     integrator="hermite")`` (B5, not B12);
 29. variant timings: B12, B13 with PE on and off, B3 at 65,536 x 65,536 and
     one "mxu" evaluation beside B1 without and with PE; the KDK step of each
     path beside B1's;
 30. the particle-mesh solver (``ops.pm``) on the card against the same
     function in float64 on the CPU (RMS acc and U within PM_RTOL): the JAX
     package's smooth cluster at N = 65,536 and grid 64 (and its RMS
     against the exact forces, B1, within 1e-2; a third dead and inert) and
     the PM drift row (the headline cluster, grid 128, box (0, 0, 0, 8));
 31. P3M's short-range kernels (``csrc/p3m_short.cu``): the reorder of each
     cell's kept prefix equal to its plain version (``p3m_short_order``), and
     the sum against its plain version and the same sum in float64 (within
     SHORT_RTOL) at the P3M bench row (65,536 uniform bodies, grid 64, the
     capacity probed), a ragged N = 5,000 with a third dead, its starved
     table (overflow equal to the CPU's and > 0) and its table at a cut of
     P3M_WIDE_CUT sigmas (the kernel's erff / expf arithmetic, taken beyond
     its polynomials' range); rows without a slot 0; the
     bench row bit-equal from call to call; ``p3m_short_work`` printed
     (walked, staged, visited, lane slots, needed);
 32. the mesh main paths through ``init_forces`` -> 20 recorded -> unrecorded
     ``rollout`` steps: ``force_impl="pm"`` at the drift row for 10,000
     steps and ``"p3m"`` at the uniform row for 4,000 (the short-range
     kernels once an evaluation, overflow 0), each drift within its gate and
     printed beside JAX's recorded one, the bodies escaped from the box
     printed; ``simulate(force_impl="p3m"/"pm")`` on the card;
 33. mesh timings: a PM evaluation at 65,536 and 1,048,576 (grid 128), a PM
     KDK step at 1,048,576, a P3M evaluation and KDK step at 65,536, the
     short-range kernels beside their plain versions and their bounds, the
     sum's issue floor and the wrapper's device time (the B5 subset and the
     block macro step are phase 17's, and ``--parent``'s in turns with their
     host time);
 34. the contact sweep (``csrc/collision_roots.cu``): the merge root
     search's parents, gated on the detecting sweep's count and ungated, and
     its roots integer-equal to the plain column-blocked search, and
     resolve's contact mark integer-equal to the plain row blocks, gated and
     ungated, on the 65,536-body cluster at the contact-rich radius (count >
     0) and the bench row's (count 0: the identity, no marks) and at a
     ragged 5,000 with a third dead; both timed at both counts beside their
     bounds and issue floors;
 35. the merge main path, bench row: the cluster with radius 1e-4 and
     ``collisions="merge"`` through ``init_forces`` -> a recorded and an
     unrecorded ``rollout``, bit-equal to the collision-free run up to the
     first contact, ms/step armed against unarmed;
 36. ``simulate(collisions="merge")`` on the cluster at the contact-rich
     radius for MERGE_STEPS steps, twice: the merge count, mass and momentum
     conserved in host f64 (MERGE_MASS_RTOL, MERGE_P_RTOL), every merged body
     dead, massless, without radius and parked beyond every live body's
     reach, the two runs bit-equal, one root search a detecting sweep;
 37. Hermite + merge (B5 detect) and RESPA K = 4 + merge (the geometry
     rebuilt every window) through ``simulate`` at the contact-rich radius,
     twice each, with phase 36's checks, and RESPA's counters from
     ``respa_rollout`` (its ``overflow`` counts the bodies dead at a
     window's start, as the JAX stepper's does, so ``simulate`` warns);
 38. the resolve main path, bench row (``bench.py:200-206``): the cluster
     with radius 1e-4, ``collisions="resolve"``, frag_seed 11, debris_k 2,
     through ``init_forces`` -> a recorded and an unrecorded ``rollout``,
     bit-equal to the collision-free run up to the first contact, the mark
     kernel once a step, ms/step armed against unarmed;
 39. resolve, contact-rich: the cluster at radius 3e-3 with every
     RESOLVE_HEAVY_EVERY-th body RESOLVE_HEAVY_MASS times heavier
     (absorbers) and RESOLVE_PAIRS planted pairs that meet at E_coll =
     E_thresh (p = 1/2), with spare dead slots for debris, through
     ``simulate()`` (KDK), Hermite and RESPA K = 4, twice each: the two runs
     bit-equal; absorptions, fragmentations and debris counted per round
     (``ResolveLog``), at least one of each; the dead massless, without
     radius and parked beyond every live body's reach; mass conserved where
     every fragmentation spawned debris, and otherwise lost by exactly the
     fragments without debris;
 40. the fragmentation frequency on the card: FRAG_PAIRS pairs at E_coll =
     E_thresh through ``_apply_collisions`` over FRAG_ROUNDS steps (fresh
     draws each), within 4 binomial sigmas of 1/2.

The launch counters are set to 0 just before each main path (phases 5+6, 9,
10, 13, 14, 15, 16, 19, 23, 28, 32, 35, 36, 37, 38 and 39) and read just after it:
each kernel must have run on its path. B3 has no single-card path (the multi-device ring
launches it): phase 27 checks it, and its record's launches are its count
over phase 28's three main paths, which must be 0. The
line before the last is a JSON summary of the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

EPS2 = 1e-4
DT = 1e-3
DRIFT_BUDGET = 1e-6
# f32 force sums in two summation orders (the kernel's per-thread sequence
# with rsqrtf, the plain version's blocked torch.sum): max |d acc| over
# max |acc|, and |dU / U|. At N = 65536 the kernel's two-level f32 sum sits
# ~1e-6 from the f64 sum and the plain version's ~2e-7 (the script prints
# both); 1e-5 leaves a tenfold margin.
FORCE_RTOL = 1e-5
# the acc + jerk sweep (B5) against its plain version, max |d jerk| over
# max |jerk|: the jerk sums cancel more than the acc sums (set from the
# f64 comparison that phase 12 prints, as FORCE_RTOL is)
JERK_RTOL = 1e-5
ENERGY_RTOL = 1e-5
# positions / velocities after 10 KDK steps whose forces differ only in f32
# summation order (the tolerance of the JAX package's own fused-rollout test)
STATE_ATOL = 1e-6
# bounce deltas of B6 against the chunked plain sweep, max |d dv| / max |dv|
# and max |d dp| / max |dp|: the same formula in f32 with rsqrtf and fused
# multiply-adds against torch's rounding
BOUNCE_RTOL = 1e-5
# the two radii of the collision runs: the bench row of bench.py:182-184
# (~2e-3 touching pairs expected at t = 0) and a contact-rich one (~44)
R_BENCH = 1e-4
R_RICH = 3e-3
# the headline body count, and the ragged count (and its radius) of the
# kernel checks
N_MAIN = 65536
N_RAGGED = 5000
R_RAGGED = 0.015
# the fused rollout (B4): its main path's N (the unrecorded drift rung), the
# largest N it serves, and the N at which phase 11 times it in turns with
# the step loop it stands in for
N_FUSED, N_FUSED_BIG = 4096, 32768
FUSED_TURNS = (4096, 8192, 16384, 32768)
# B4's checked scenes by key: (N, live bodies, precision); the dead padding
# of the 4,096 ones, and the ragged 5,000 (40 tiles of 128, the last cut)
FUSED_CASES = {"B4": (N_FUSED, 4000, "ds32"), "B4F": (N_FUSED, 4000, "f32"),
               "B4R": (N_RAGGED, N_RAGGED, "ds32"), "B4L": (N_FUSED_BIG, N_FUSED_BIG, "ds32"),
               "B4LF": (N_FUSED_BIG, N_FUSED_BIG, "f32")}
# Hermite runs (phases 13-17): the adaptive run's eta and length; the block
# runs' softening, planted binary, eta and macro steps; the contact-rich
# Hermite run's length and its steps checked against the plain versions.
# The block criterion dt_i = eta sqrt(|a|/|j|) cannot single the binary out
# at eps2 = 1e-4: softening caps a pair's omega at sqrt(G M_pair / eps^3),
# and the cluster's own close pairs reach sqrt(|a|/|j|) ~ 0.07. At
# eps2 = 1e-10 a binary of 2 x 1e-3 at separation 1.26e-3 (omega ~ 1000,
# sqrt(|a|/|j|) = 0.032) needs m = 6 substeps at eta = 0.0075, and turns
# ~0.2 rad a substep, so the kernels and the plain versions stay within
# STATE_ATOL of each other; ~500 cluster bodies (0.8%) are under dt too,
# so the fast cap of 64 is full.
ETA_ADAPTIVE = 0.005
ADAPTIVE_STEPS = 300
EPS2_BLOCK = 1e-10
BINARY_MASS = 1e-3
BINARY_SEP = 1.26e-3
ETA_BLOCK = 0.0075
BLOCK_MACRO_STEPS = 3
RICH_STEPS = 100
RICH_CHECK_STEPS = 3

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): f32 outside
# the tensor cores, device memory, and rsqrt on the special-function units
# (16 a clock per SM, 132 SMs, 1.98 GHz boost).
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_RSQRT = 16 * 132 * 1.98e9
# dense TF32 on the tensor cores (NVIDIA's data sheet, H100 SXM)
PEAK_TF32 = 495e12
# f32 operations per pair, counted from the sources: B1 no-PE 3 differences,
# r2 (5), + eps2, inv_r^3 (2), m_j * (1), three multiply-adds (6); B2 adds
# (R_i + R_j) * 1.00001 and its square (3); B6 rejects a pair after the 3
# differences, r2 (5), R_i + R_j and its square (10), and a touching pair
# adds ~30 more (s, 1/m_j, base, the impulse and the de-overlap terms)
OPS_B1, OPS_B2, OPS_B6, OPS_B6_TOUCH = 18, 21, 10, 30
# B5 (csrc/nbody_jerk.cu, sweep_tile): 3 position and 3 velocity
# differences, r2 (5), + eps2, inv^2 and inv^3 (2), w (1), r.v (5),
# c = 3 rv inv^2 (2), three acc multiply-adds (6), three jerk terms
# (dv - c dx) and their multiply-adds (12), pe (2): 42; detect adds
# (R_i + R_j) * 1.00001 and its square (3); the subset variant has no pe
OPS_B5, OPS_B5_DETECT, OPS_B5_SUBSET = 42, 45, 40
# the near sweep (csrc/neighbor.cu, per pair): 3 differences, r2 (5),
# rc^2 - r2 and * inv_d (2), the clip (2), s^2 (1), S (6), spd (4), + eps2,
# inv_r^3 (2), the weight (5), three multiply-adds (6), pe (3): 40, the
# count of the JAX kernel's own cost estimate (neighbor_pallas.py:156-159)
OPS_NEAR = 40
# the multirate runs (phases 18-20), the bench's configuration
# (bench.py:265-316, 966-972): switch radius 5 softening lengths, cell 2 rc,
# chunks of 32 bodies, j-blocks of 4 chunks, budget headroom 2.2 (1.5 on the
# blocks of a chunk); K = 4 substeps a macro window with the geometry
# refreshed every 4 windows (K = 5 every 3, timed only)
RC_RESPA = 5.0 * EPS2 ** 0.5
CELL_RESPA = 2.0 * RC_RESPA
RESPA_K, RESPA_REFRESH = 4, 4
RESPA_K5, RESPA_REFRESH5 = 5, 3
# the near kernel against its plain version: max |d acc| / max |acc| and
# max |d pe| / max |pe|, f32 sums in two orders (as FORCE_RTOL)
NEAR_RTOL = 1e-5
# the ragged near-kernel case: N, its concentration (a unit Gaussian scaled
# so that a body has a few neighbours within rc) and its starved budgets
N_NEAR_RAGGED = 5000
NEAR_RAGGED_SCALE = 0.3

# the tree runs (phases 21-24): bench_tree's configuration (bench.py:441-464,
# Plummer positions of bench.py:343-353, levels 7, dt 1e-4, eps2 1e-6,
# chunks of 32 bodies, j-blocks of 8 chunks, budgets at headroom 1.5) and
# the tree drift rung's (bench.py:947-955: the headline cluster, pm_box
# (0, 0, 0, 8), dt 1e-3); the ragged near-kernel case's size and levels; the
# large evaluation's size and levels and its sampled targets
TREE_LEVELS, TREE_DT, TREE_EPS2 = 7, 1e-4, 1e-6
TREE_CHUNK, TREE_RJ = 32, 8
TREE_DRIFT_BOX = (0.0, 0.0, 0.0, 8.0)
N_TREE_RAGGED, TREE_RAGGED_LEVELS = 5000, 5
N_TREE_BIG, TREE_BIG_LEVELS, TREE_SAMPLE = 1048576, 8, 1024
# the tree's bounds: the RMS force error against the exact sum (the JAX
# package's deep-level bound, tests/test_tree.py:105-120), the energy drift
# of an approximate force (the 1e-6 budget is the exact kernels'), and the
# far field against float64 (max |d a| / max |a|: f32 conv and Taylor sums
# keep ~1e-6; TF32 would show at ~1e-3)
TREE_RMS_BOUND = 6e-2
TREE_DRIFT_BOUND = 1e-3
FAR_RTOL = 1e-5
# B7 per pair the function needs (a body and another in its cell band): 3
# differences, r2 (5), + eps2, inv^3 (2), m inv^3 (1), three multiply-adds
# (6), pe (2): 20 and one rsqrt. The JAX kernel's cost estimate
# (tree_near_wl.py:236) counts 26 per walked pair, the band (6) and idx test
# included: a sweep that visited only needed pairs would not test them.
OPS_TREE = 20
# the exact-force variants (phases 25-29). B12 per unordered pair
# (csrc/nbody_forces_sym.cu): 3 differences, r2 (5), + eps2, inv^3 (2), the
# two weights (2), three i-side and three j-side multiply-adds (12): 25 and
# one rsqrt. B13 per ordered pair (csrc/nbody_forces_mxu.cu): its dot
# (8 deep) and its sums (4 columns) are the function's matrix products, 24
# flops on the tensor cores at the TF32 rate (as the TPU kernel puts them on
# its matrix unit); what must stay on the CUDA cores is the weight: the
# clamp, + eps2, inv^2, m inv and w (5) and one rsqrt, which sets the bound
# (1.027 ms at 65,536); PE adds the sum of m inv (1). Counted as B1 is,
# every flop on the CUDA cores (the dot's five nonzero terms (7), the
# weight (5), three multiply-adds and the row sum (7)), it was 20 and 22,
# a 1.282 ms bound; phase 29 prints both.
OPS_B12, OPS_B13, OPS_B13_PE, OPS_B1_PE = 25, 5, 6, 20
TENSOR_B13, OPS_B13_ALL_CUDA = 24, 20
# The Gram forms' accelerations, RMS |d acc| / RMS |acc|: B13's against its
# plain version and the exact f64 sum, the "mxu" route's against its formula
# in f64. The Gram identity cancels |r_i|^2 + |r_j|^2 - 2 r_i.r_j in f32, so
# its error sits on close pairs, ~|r|^2 2^-24 / eps2 of their weight, and
# acc = S[:, 0:3] - pos * S[:, 3] cancels the f32 rounding of two 65,536-term
# sums: on the 65,536-body cluster a few bodies are 1.6-2.7e-3 of max |acc|
# from the exact sum whatever computes the formula, and two summation orders
# of S part by ~1e-3 in max, while the RMS is 5.5e-5 (B13) and 6.7e-5
# ("mxu"; phase 26 prints both, on an H100 80GB HBM3 at 700 W). 5e-4 is
# ~10x that RMS, as FORCE_RTOL is ~10x B1's distance from f64, and the JAX
# package's bound for the formula (tests/test_pallas_forces.py:413).
# The kernel's own outputs, S and pe (gram_held): they were held to the
# plain version within FORCE_RTOL in max while both formed r2 in one fixed
# rounding order. The kernel now forms r2 on the tensor cores from a
# 3-piece TF32 split, an order of its own as the TPU kernel's is, and on
# close pairs one ulp of r2 moves a weight by ~|r|^2 2^-24 / eps2. So pe is
# held to the plain version within GRAM_RTOL in RMS and GRAM_MAX_RTOL in
# max. S is dominated by those close-pair rows (a weight of ~m / eps^3
# against ~m a far pair): on the 65,536-body scene the plain version's own
# S is 8.2e-4 from the exact S in RMS and 4.5e-3 in max (the kernel's
# 2.5e-4 and 9.4e-4), and the two part by 8.3e-4 in RMS (H100 80GB HBM3 at
# 700 W), so no other rounding of r2 can meet the Gram gates against it.
# S is held to the exact S of the same packed rows (f64) instead, within
# GRAM_S_RTOL in RMS and GRAM_MAX_RTOL in max (gram_held). Phase 26 prints
# the kernel S against the plain S, and whether S and pe still sit within
# FORCE_RTOL.
GRAM_RTOL = 5e-4
# and in max against the exact f64 sum, both Gram forms: the few close-pair
# bodies above read 1.64e-3 (B13) and 2.72e-3 ("mxu") of max |acc| at
# N = 65,536 (phase 26, H100 80GB HBM3 at 700 W); 5e-3 is ~2x the larger.
GRAM_MAX_RTOL = 5e-3
# B13's S against the exact S of its packed rows, in RMS (and GRAM_MAX_RTOL
# in max). On the 65,536-body scene (phase 26, H100 80GB HBM3 at 700 W) the
# kernel's 3-piece TF32 r2 reads 2.51e-4 RMS and 9.39e-4 max; a 2-piece
# r2 (hh, hm, mh), which keeps fewer bits, read 1.87e-3 and 2.16e-2. 1e-3
# is 4x the first and below the second.
GRAM_S_RTOL = 1e-3
# the ragged size of phases 25-26: 39 tiles of 128, a third dead; the block
# sizes of phase 27; the "mxu" route's timed steps
N_VAR_RAGGED = 4992
N_BLOCK = 16384
MXU_STEPS = 200

# the mesh runs (phases 30-33). PM: the JAX package's smooth cluster
# (tests/test_pm.py:11-16: normal positions, masses uniform in [0.5, 1.5] / N,
# eps2 0.09) at N_MAIN and grid 64; the PM drift row (bench.py:928-941: the
# headline cluster, grid 128, pm_box (0, 0, 0, 8), f32, 10,000 steps); and
# bench_pm's scene (bench.py:319-340: 1,048,576 normal positions, velocities
# 0.3 N(0, 1), masses 1/N, eps2 0.01, grid 128, no potential). P3M: the
# uniform row (bench.py:981-1000: 65,536 bodies uniform in [-4, 4]^3 from
# seed 11, velocities 0.1 N(0, 1), masses 1/N, eps2 1e-4, grid 64, pm_box
# (0, 0, 0, 6), capacity from the probe at 1.5x, f32, 4,000 steps), and a
# ragged 5,000 (uniform in [-1, 1]^3, a third dead, grid 32, the cube fitted)
# whose starved table (half the probed capacity) overflows
PM_SMOOTH_EPS2, PM_SMOOTH_GRID, PM_GRID = 0.09, 64, 128
PM_BOX = (0.0, 0.0, 0.0, 8.0)
PM_STEPS = 10000
N_PM_BIG, PM_BIG_EPS2 = 1048576, 0.01
P3M_SEED, P3M_HALF, P3M_GRID, P3M_BOX, P3M_STEPS = 11, 4.0, 64, (0.0, 0.0, 0.0, 6.0), 4000
N_P3M_RAGGED, P3M_RAGGED_GRID = 5000, 32
# a cut (in sigmas) past the short-range kernel's polynomials (a^2 rcut^2 =
# cut^2 / 4 > 5.25), so that phase 31 holds its erff / expf arithmetic too
P3M_WIDE_CUT = 5.0
# the JAX package's recorded drifts of the two rows (BENCH_LAST_GOOD.json),
# printed beside the port's as a physics cross-check, not a target
JAX_PM_DRIFT, JAX_P3M_DRIFT = 9.149312456696479e-3, 3.9267120160259206e-05
# PM on the card against the same function in float64 on the CPU, RMS |d a| /
# RMS |a| and |dU / U|: the card's f32 deposit (atomics in no fixed order),
# cuFFT in f32 and the gather's rounding
PM_RTOL = 1e-5
# PM against the exact forces (B1) on the smooth cluster, RMS: the JAX
# package's own contract for the deconvolved solve (tests/test_pm.py:29)
PM_EXACT_RMS = 1e-2
# the short-range kernel against its plain version and against the same sum
# in f64, max |d| / max |ref| of acc and of pe: the card's erff, expf and
# rsqrtf (~2 ulp each) against torch.special.erf, torch.exp and torch.rsqrt,
# amplified near rcut where g is the small difference of 1/s^3 and the
# long-range part (g(rcut) ~ 1.75% of 1/rcut^3), and f32 sums of a few
# hundred terms in other orders
SHORT_RTOL = 1e-5
# the short-range sum per needed pair (csrc/p3m_short.cu): 3 differences,
# r2 (5), the tests (2), rsqrt's product r (1), a r (1), erf (~20 as a
# polynomial), (a r)^2 and the Gaussian's scale (3), + eps2 (1), inv_s^3 (2),
# inv_r^3 (2), g (4), K (2), m g and three multiply-adds (7), pe (2): ~50
# f32 operations, and 3 MUFU operations (two rsqrt, one ex2)
OPS_SHORT, MUFU_SHORT = 50, 3
# the merge runs (phases 34-37): the root search per pair it needs (3
# differences, r2 (5), R_i + R_j (1), the comparison: 10, as B6's rejection);
# the contact-rich runs' lengths (KDK steps, Hermite steps, RESPA windows of
# K = 4); and their conservation gates in host f64, set from the port's own
# runs on an H100 80GB HBM3 at 700 W: the total mass moved by 0 in all three
# runs and the momentum by 1.55e-11 (KDK), 9.27e-12 (Hermite) and 7.81e-12
# (RESPA) of sum m |v| (the f32 force sums' asymmetry over the run); each
# gate leaves ~65x room above the largest reading, so that a merge that
# mis-weights even a few of the ~800 groups fails
OPS_ROOTS = 10
MERGE_STEPS, MERGE_HERMITE_STEPS, MERGE_RESPA_WINDOWS = 200, 40, 5
MERGE_MASS_RTOL, MERGE_P_RTOL = 1e-9, 1e-9
# the resolve runs (phases 38-40): the bench row's frag_seed and debris_k
# (bench.py:200-206); the contact-rich scene's absorbers (every 64th body 20x
# heavier: a ratio > 10 absorbs) and the pairs planted to meet at E_coll =
# E_thresh (v_rel^2 = 4e3 for equal masses, p = 1/2), its dead slots for
# debris and a debris budget that lets every mutually-first pair spawn; the
# runs' lengths (KDK steps, Hermite steps, RESPA windows of K = 4); the
# fragmentation-frequency check's pairs and rounds (fresh draws a round)
RESOLVE_SEED, RESOLVE_DEBRIS_K = 11, 2
RESOLVE_HEAVY_EVERY, RESOLVE_HEAVY_MASS, RESOLVE_PAIRS = 64, 20.0, 64
RESOLVE_SPARE, RESOLVE_MAX_PAIRS = 512, 64
RESOLVE_STEPS, RESOLVE_HERMITE_STEPS, RESOLVE_RESPA_WINDOWS = 100, 40, 5
FRAG_PAIRS, FRAG_ROUNDS = 256, 8
# the resolve runs' mass gate (of the total mass, against the mass of the
# fragments that spawned no debris): an absorption or a spawn rounds each
# f32 mass once (2^-24 of it); the cluster's masses (2^-16, 20 x 2^-16) and
# their sums are exact in f32, so the card should read 0
RESOLVE_MASS_RTOL = 1e-7
# the mesh rows' drift gates, set from the port's own run on an H100 80GB
# HBM3 at 700 W: PM 9.148e-3 over 10,000 steps (fluctuation-dominated: the
# softening is below the mesh scale, outside PM's contract, DESIGN.md
# section 10) and P3M 3.931e-5 over 4,000; each gate ~2-2.5x its run, so a
# solver that breaks (a refitted or wrong cube, a lost short range) fails
PM_DRIFT_BOUND, P3M_DRIFT_BOUND = 2e-2, 1e-4

# warp instructions the card issues a second: 4 schedulers on each of 132
# SMs at the 1.98 GHz boost clock (NVIDIA's data sheet, H100 SXM)
INSTR_RATE = 528 * 1.98e9
# the instantiations of the eight redesigned kernels that each record
# reads (mangled-name stems: nbody_forces_kernel<kPE, kSoft, kDetect>,
# jerk_kernel<kSoft, kDetect>, gram_kernel<kPE>, bounce_kernel,
# sym_tile_kernel<512>, tree_near_kernel, near_sweep_kernel,
# fused_kdk_kernel), the C function that reports the launch shape, the SASS
# instruction that marks one pair in the inner loop (MUFU.RSQ on the
# softened sweeps, an unordered pair in B12's, a visited pair in B7's and
# the near sweep's; B6 rejects a pair with one FMNMX, its parent's build
# with one FSETP) and the functions a library of each source exports
SHAPED = {
    "nbody_forces": ("nbody_forces_shape", {
        "B1": "nbody_forces_kernelILb0ELb1ELb0E", "B2": "nbody_forces_kernelILb0ELb1ELb1E",
        "B3": "nbody_forces_kernelILb1ELb1ELb0E"}, r"MUFU\.RSQ"),
    "nbody_jerk": ("nbody_jerk_shape", {
        "B5": "jerk_kernelILb1ELb0E", "B5D": "jerk_kernelILb1ELb1E"}, r"MUFU\.RSQ"),
    "nbody_forces_mxu": ("nbody_forces_mxu_shape", {"B13": "gram_kernelILb0E"},
                         r"MUFU\.RSQ"),
    "collisions": ("bounce_deltas_shape", {"B6": "bounce_kernel"}, r"\bFMNMX\b|\bFSETP\b"),
    "nbody_forces_sym": ("nbody_forces_sym_shape", {"B12": "sym_tile_kernelILi512E"},
                         r"MUFU\.RSQ"),
    "tree_near": ("tree_near_shape", {"B7": "tree_near_kernel"}, r"MUFU\.RSQ"),
    "neighbor": ("near_sweep_shape", {"NEAR": "near_sweep_kernel"}, r"MUFU\.RSQ"),
    "fused_rollout": ("fused_kdk_shape", {"B4": "fused_kdk_kernel"}, r"MUFU\.RSQ"),
}
LIB_FUNCS = {"nbody_forces": ("nbody_forces", "nbody_forces_detect", "nbody_block_forces",
                              "ot_error_string"),
             "nbody_jerk": ("nbody_jerk", "nbody_jerk_detect", "nbody_jerk_subset",
                            "nbody_jerk_subset_shape", "ot_error_string"),
             "nbody_forces_mxu": ("nbody_forces_mxu", "ot_error_string"),
             "collisions": ("bounce_deltas", "ot_error_string"),
             "nbody_forces_sym": ("nbody_forces_sym", "ot_error_string"),
             "tree_near": ("tree_near", "ot_error_string"),
             "neighbor": ("near_sweep", "ot_error_string"),
             "fused_rollout": ("fused_kdk", "fused_kdk_shape", "ot_error_string"),
             "p3m_short": ("p3m_short_sorted", "p3m_short_order", "p3m_short_shape",
                           "ot_error_string")}
# the sources whose inner loop must hold tensor-core products (TF32 HMMA)
TENSOR_CORE = {"nbody_forces_mxu": r"\bHMMA\.\S*TF32"}
# --sweep: the launch shapes built with -D (i bodies or m16 tiles a thread
# or warp, or for B7 and the near sweep j rows a lane stages a round; warps
# a block); the first of B1's and B5's is the first version's summation
# order with the one-MUFU rsqrt, the first of B6's the first version's shape
SWEEP = {
    "nbody_forces": ((1, 1), (2, 8), (4, 4), (4, 8), (4, 16), (8, 4), (8, 8)),
    "nbody_jerk": ((1, 1), (2, 4), (2, 8), (3, 8), (4, 4), (4, 8)),
    "nbody_forces_mxu": ((1, 4), (2, 4), (2, 8), (4, 2), (4, 4), (4, 8)),
    "collisions": ((1, 4), (2, 4), (2, 8), (4, 4), (4, 8)),
    "nbody_forces_sym": ((2, 4), (4, 4), (8, 4), (8, 8), (16, 2), (16, 4)),
    "tree_near": ((2, 4), (4, 4), (8, 2), (8, 4), (16, 2)),
    "neighbor": ((2, 4), (4, 2), (4, 4), (4, 8), (8, 4)),
    "fused_rollout": ((2, 8), (4, 4), (4, 8), (4, 16), (8, 8)),
}
SWEEP_MACRO = {"nbody_forces": "OT_FORCES", "nbody_jerk": "OT_JERK",
               "nbody_forces_mxu": "OT_MXU", "collisions": "OT_BOUNCE",
               "nbody_forces_sym": "OT_SYM", "tree_near": "OT_TREE",
               "neighbor": "OT_NEAR", "fused_rollout": "OT_FUSED"}

B1 = dict(name="nbody_forces", route="cuda",
          source="orbital_tpu_torch/csrc/nbody_forces.cu",
          replaces="orbital_tpu/ops/pallas_forces.py:55")
B2 = dict(name="nbody_forces_detect", route="cuda",
          source="orbital_tpu_torch/csrc/nbody_forces.cu",
          replaces="orbital_tpu/ops/pallas_forces.py:302")
B4 = dict(name="fused_kdk", route="cuda",
          source="orbital_tpu_torch/csrc/fused_rollout.cu",
          replaces="orbital_tpu/ops/fused_rollout.py:54")
B6 = dict(name="bounce_deltas", route="cuda",
          source="orbital_tpu_torch/csrc/collisions.cu",
          replaces="orbital_tpu/ops/pallas_collisions.py:37")
B5 = dict(name="nbody_jerk", route="cuda",
          source="orbital_tpu_torch/csrc/nbody_jerk.cu",
          replaces="orbital_tpu/ops/pallas_jerk.py:52")
B5D = dict(name="nbody_jerk_detect", route="cuda",
           source="orbital_tpu_torch/csrc/nbody_jerk.cu",
           replaces="orbital_tpu/ops/pallas_jerk.py:177")
B5S = dict(name="nbody_jerk_subset", route="cuda",
           source="orbital_tpu_torch/csrc/nbody_jerk.cu",
           replaces="orbital_tpu/ops/pallas_jerk.py:52")
# one kernel for the four TPU schedules B8 (:165), B9 (:286), B10 (:394) and
# B11 (:80); the record names B8's
NEAR = dict(name="near_sweep", route="cuda", source="orbital_tpu_torch/csrc/neighbor.cu",
            replaces="orbital_tpu/ops/neighbor_pallas.py:165")
B7 = dict(name="tree_near", route="cuda", source="orbital_tpu_torch/csrc/tree_near.cu",
          replaces="orbital_tpu/ops/tree_near_wl.py:171")
B12 = dict(name="nbody_forces_sym", route="cuda",
           source="orbital_tpu_torch/csrc/nbody_forces_sym.cu",
           replaces="orbital_tpu/ops/pallas_forces_sym.py:40")
B13 = dict(name="nbody_forces_mxu", route="cuda",
           source="orbital_tpu_torch/csrc/nbody_forces_mxu.cu",
           replaces="orbital_tpu/ops/pallas_forces_mxu.py:50")
# no single-card path (the ring of ROADMAP A.15): phase 28 reads its count
# over the variants' main paths and requires 0
B3 = dict(name="nbody_block_forces", route="cuda",
          source="orbital_tpu_torch/csrc/nbody_forces.cu",
          replaces="orbital_tpu/ops/pallas_forces.py:221")
# no TPU kernel: stands in for the plain XLA lax.map over cell blocks of
# p3m_acc_potential (orbital_tpu/ops/p3m.py:181-231)
P3M = dict(name="p3m_short", route="cuda", source="orbital_tpu_torch/csrc/p3m_short.cu",
           replaces="orbital_tpu/ops/p3m.py:181")
# the short range's reorder of each cell's kept prefix (a second kernel of
# the same source, the redesign's own; the JAX tile form needs none)
P3MO = dict(name="p3m_short_order", route="cuda", source="orbital_tpu_torch/csrc/p3m_short.cu",
            replaces="orbital_tpu/ops/p3m.py:181")
# no TPU kernel: stands in for the XLA column blocks of collision_roots_chunked
# (orbital_tpu/ops/collisions.py:165-196), merge mode's root search
ROOTS = dict(name="collision_roots", route="cuda",
             source="orbital_tpu_torch/csrc/collision_roots.cu",
             replaces="orbital_tpu/ops/collisions.py:165")
# no TPU kernel: the same source's mark mode stands in for the XLA row blocks
# (i_block) of resolve_outcomes_subset (orbital_tpu/ops/collisions.py:452-464)
MARK = dict(name="contact_marks", route="cuda",
            source="orbital_tpu_torch/csrc/collision_roots.cu",
            replaces="orbital_tpu/ops/collisions.py:452")
# the contact sweep's two instantiations (mangled-name stems) by record key
SWEEP_MODES = {"ROOTS": "sweep_kernelILi0E", "MARK": "sweep_kernelILi1E"}


def bound(flops: float, nbytes: float, rsqrt: float = 0.0,
          tensor: float = 0.0) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of the operations
    over their peak rate (f32 on the CUDA cores, rsqrt, TF32 flops on the
    tensor cores) and the bytes over the memory rate."""
    t_ops = max(flops / PEAK_F32, rsqrt / PEAK_RSQRT, tensor / PEAK_TF32)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def make_cluster(n: int, seed: int):
    """Virialised Gaussian cluster in natural units (G = 1, M = 1), velocities
    scaled so that 2K = |U| with U the f64 softened potential."""
    from orbital_tpu_torch.utils import native

    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    U = native.potential_f64(pos, mass, EPS2)
    K = 0.5 * float(np.sum(mass * np.sum(vel * vel, -1)))
    vel *= np.sqrt(0.5 * abs(U) / K)
    return pos, vel, mass


def make_plummer(n: int, seed: int = 0):
    """Concentrated Plummer sphere (the tree's regime), as bench.py:343-353
    makes it: positions, velocities 0.05 N(0, 1), masses 1/n."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = r[:, None] * v
    vel = 0.05 * rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    return pos, vel, mass


def rms_rel(a, ref) -> float:
    """RMS of |a - ref| over RMS of |ref| (tests/test_tree.py:_rms)."""
    a, ref = a.double(), ref.double()
    return float(((a - ref) ** 2).sum(-1).mean().sqrt() / (ref ** 2).sum(-1).mean().sqrt())


def exact_acc_f64(pos, mass, idx, eps2: float, chunk: int = 16384):
    """The softened acceleration of the bodies ``idx`` in float64 on the
    card, summed over every body in chunks (G = 1; the self pair adds 0)."""
    import torch

    p64, m64 = pos.double(), mass.double()
    tgt = p64[idx]
    acc = torch.zeros_like(tgt)
    for j0 in range(0, p64.shape[0], chunk):
        d = p64[None, j0:j0 + chunk] - tgt[:, None]
        r2 = (d * d).sum(-1) + eps2
        acc += (m64[None, j0:j0 + chunk, None] * d * r2.rsqrt()[..., None] ** 3).sum(1)
    return acc


def tree_near_work(tab: dict, n: int, levels: int, ws: int, chunk: int, rj: int) -> dict:
    """B7's work on a table of ``ops.tree_near_wl._wl_table``: the pairs a
    sweep of every row of every (i-chunk, j-block) entry walks (sentinel
    rows included: the first version's), the pairs of live rows among them,
    the pairs the kernel visits (each chunk's live rows against the rows of
    its entries inside the chunk's box, [min c - ws, max c + ws] on each
    axis over its live rows), the lane slots its sweeps issue for them (32
    lanes times ceil(J / G) warp iterations for a chunk's J visited j rows,
    G = 32 / S groups, S the power of two >= its live rows; each of a
    block's warps may add one part-filled iteration), and the pairs the
    function needs: each live body of a kept chunk against every other live
    body in its cell band (|c_i - c_j|_inf <= ws). Also the bytes the
    function must move: each live row read once (32 B), each kept body's
    (ax, ay, az, pe) written once (16 B) and the runs (8 B each). Takes
    chunks of at most 32 rows (one block slice each)."""
    import torch

    if chunk > 32:
        raise ValueError(f"tree_near_work counts chunks of <= 32 rows, got {chunk}")
    pb, start, count = tab["pbods"], tab["start_blk"].long(), tab["n_blk"].long()
    k_ch, n_nb = count.shape
    blkw, M, dev = rj * chunk, 2 ** levels, pb.device
    live = pb[:, 5] < 1e9
    walked = int(count.sum()) * chunk * blkw
    # live rows per i-chunk and, by prefix sums, per run of j-blocks
    live_i = live[:k_ch * chunk].reshape(-1, chunk).sum(1).long()
    cum_j = torch.cat([live.new_zeros(1, dtype=torch.long),
                       torch.cumsum(live.reshape(-1, blkw).sum(1).long(), 0)])
    run_j = torch.where(count > 0, cum_j[start + count] - cum_j[start], 0)
    live_pairs = int((live_i * run_j.sum(1)).sum())
    # each chunk's box, and the rows of each of its entries inside it
    cells_i = pb[:k_ch * chunk, 5:8].reshape(k_ch, chunk, 3)
    live_c = live[:k_ch * chunk].reshape(k_ch, chunk, 1)
    big = torch.tensor(1e9, dtype=pb.dtype, device=dev)
    lo = torch.where(live_c, cells_i, big).amin(1) - ws
    hi = torch.where(live_c, cells_i, -big).amax(1) + ws
    cnt_f, start_f = count.reshape(-1), start.reshape(-1)
    run = torch.repeat_interleave(torch.arange(cnt_f.numel(), device=dev), cnt_f)
    first = torch.cumsum(cnt_f, 0) - cnt_f
    block = start_f[run] + torch.arange(run.numel(), device=dev) - first[run]
    ent_c = run // n_nb
    in_box = torch.zeros(k_ch, dtype=torch.long, device=dev)
    ar = torch.arange(blkw, device=dev)
    for e0 in range(0, run.numel(), 8192):
        c_e = ent_c[e0:e0 + 8192]
        cj = pb[(block[e0:e0 + 8192, None] * blkw + ar), 5:8]        # [E, blkw, 3]
        inside = ((cj >= lo[c_e, None]) & (cj <= hi[c_e, None])).all(-1).sum(1)
        in_box.index_add_(0, c_e, inside.long())
    visited = int((live_i * in_box).sum())
    width = 2 ** torch.ceil(torch.log2(live_i.clamp(min=1).double())).long()
    groups = 32 // width
    issued = int(torch.where(live_i > 0, 32 * -(-in_box // groups), 0).sum())
    # occupancy of the finest cells, box-summed over the band
    cell = pb[live, 5:8].long()
    occ = torch.zeros(M ** 3, dtype=torch.long, device=dev)
    occ.index_add_(0, (cell[:, 0] * M + cell[:, 1]) * M + cell[:, 2],
                   torch.ones_like(cell[:, 0]))
    box = torch.nn.functional.pad(occ.reshape(M, M, M), (ws,) * 6)
    for d in range(3):
        box = sum(box.narrow(d, k, box.shape[d] - 2 * ws) for k in range(2 * ws + 1))
    kept = torch.zeros(pb.shape[0], dtype=torch.bool, device=dev)
    kept[:k_ch * chunk] = (count.sum(1) > 0).repeat_interleave(chunk)
    tgt = live & kept
    c_t = pb[tgt, 5:8].long()
    needed = int((box[c_t[:, 0], c_t[:, 1], c_t[:, 2]] - 1).sum())
    nbytes = 32 * int(live.sum()) + 16 * int(tgt.sum()) + 8 * k_ch * n_nb
    return dict(walked=walked, live=live_pairs, visited=visited, issued=issued,
                needed=needed, nbytes=nbytes)


def _directed_f32(v, up: bool):
    """float64 values rounded to float32 toward +inf (``up``) or -inf, as
    the kernel's __fadd_ru / __fsub_rd round (returned as float64)."""
    import torch

    r = v.float()
    away = r.double() < v if up else r.double() > v
    inf = torch.full_like(r, float("inf") if up else float("-inf"))
    return torch.where(away, torch.nextafter(r, inf), r).double()


def near_work(geom: dict, channels, rc: float, chunk: int, rj: int, eps2: float = EPS2,
              r1: float = None) -> dict:
    """The near sweep's work on a geometry of ``ops.neighbor.neighbor_geometry``
    and its slot channels (xs, ys, zs, ms): the pairs a sweep of every row of
    every live jbl entry walks (sentinel rows included: the first version's),
    the pairs of live rows among them, the pairs the kernel visits (each
    chunk's live rows against the rows of its entries inside the chunk's
    box, [min - h, max + h] on each axis over its live rows, lo rounded down
    and hi up in f32, h of ``cuda_neighbor.near_params``), the lane slots its
    sweeps issue for them (32 lanes times ceil(J / G) warp iterations for a
    chunk's J visited j rows, G = 32 / S groups, S the power of two >= its
    live rows; each of a block's warps may add one part-filled iteration),
    and the pairs the function needs: live rows closer than rc (r^2 of the
    f32 positions in f64), self pairs excluded. A row is live unless x, y
    and z are all >= half of SENTINEL_POS, as the kernel tells them. Also
    the bytes the function must move: the slot channels read once (16 B a
    slot), the table and the counts (4 B an entry, 4 B a chunk) and one
    (ax, ay, az, pe) row a chunk slot written once (16 B). Takes chunks of
    at most 32 rows (one block slice each)."""
    import torch

    from orbital_tpu_torch.ops.cuda_neighbor import near_params

    if chunk > 32:
        raise ValueError(f"near_work counts chunks of <= 32 rows, got {chunk}")
    jbl = geom["jbl"].long()
    k_ch, w_blk = jbl.shape
    pos = torch.stack([c.float() for c in channels[:3]], dim=1)      # [n_slots, 3]
    n_slots, blkw, dev = pos.shape[0], rj * chunk, pos.device
    used = jbl != n_slots // blkw - 1
    count = used.sum(1)
    walked = int(count.sum()) * chunk * blkw
    live = ~(pos >= 5e14).all(1)
    live_i = live[:k_ch * chunk].reshape(k_ch, chunk)
    n_i = live_i.sum(1)
    live_b = live.reshape(-1, blkw).sum(1)
    live_pairs = int((n_i * torch.where(used, live_b[jbl], 0).sum(1)).sum())
    # each chunk's box, rounded outward as the kernel rounds it
    h = near_params(0.5 * rc if r1 is None else r1, rc, 1.0, eps2)["h"]
    p_i = pos[:k_ch * chunk].reshape(k_ch, chunk, 3).double()
    big = torch.tensor(1e30, dtype=torch.float64, device=dev)
    lo = _directed_f32(torch.where(live_i[..., None], p_i, big).amin(1) - h, up=False)
    hi = _directed_f32(torch.where(live_i[..., None], p_i, -big).amax(1) + h, up=True)
    ent_c, ent_q = torch.nonzero(used & (n_i > 0)[:, None], as_tuple=True)
    ent_b = jbl[ent_c, ent_q]
    in_box = torch.zeros(k_ch, dtype=torch.long, device=dev)
    needed = 0
    ar, ai = torch.arange(blkw, device=dev), torch.arange(chunk, device=dev)
    for e0 in range(0, ent_c.numel(), 2048):
        c_e, b_e = ent_c[e0:e0 + 2048], ent_b[e0:e0 + 2048]
        rows = b_e[:, None] * blkw + ar                                # [E, blkw]
        pj = pos[rows].double()                                       # [E, blkw, 3]
        inside = ((pj >= lo[c_e, None]) & (pj <= hi[c_e, None])).all(-1)
        in_box.index_add_(0, c_e, inside.sum(1))
        slots = c_e[:, None] * chunk + ai                              # [E, chunk]
        d2 = ((pj[:, None] - pos[slots].double()[:, :, None]) ** 2).sum(-1)
        near = (d2 < rc * rc) & live[slots][:, :, None] & live[rows][:, None, :]
        needed += int((near & (slots[:, :, None] != rows[:, None, :])).sum())
    visited = int((n_i * in_box).sum())
    width = 2 ** torch.ceil(torch.log2(n_i.clamp(min=1).double())).long()
    issued = int(torch.where(n_i > 0, 32 * -(-in_box // (32 // width)), 0).sum())
    nbytes = 16 * n_slots + 4 * k_ch * w_blk + 4 * k_ch + 16 * k_ch * chunk
    return dict(walked=walked, live=live_pairs, visited=visited, issued=issued,
                needed=needed, nbytes=nbytes)


def pm_f64(pos, mass, alive, eps2: float, grid: int, box=None):
    """``ops.pm.pm_acc_potential`` in float64 on the CPU (its ``_pm_core`` in
    the inputs' float type): (acc [N, 3], U) of numpy inputs, G = 1."""
    import torch

    from orbital_tpu_torch.ops.pm import _pm_core

    p = torch.as_tensor(np.asarray(pos, np.float64))
    alive_f = (torch.ones(p.shape[0], dtype=torch.float64) if alive is None
               else torch.as_tensor(np.asarray(alive)).double())
    m = torch.as_tensor(np.asarray(mass, np.float64)) * alive_f
    if box is not None:
        box = tuple(torch.tensor(b, dtype=torch.float64) for b in (box[:3], box[3]))
    acc, phi, _, _, _ = _pm_core(p, m, alive_f, g=grid, G_grav=1.0,
                                 kern_builder=lambda r2, h: torch.rsqrt(r2 + eps2),
                                 with_potential=True, deconvolve=True, box=box)
    U = 0.5 * torch.sum(m * (phi + m * eps2 ** -0.5))
    return acc, float(U)


def p3m_slices(order: dict, gc: int, rcut2: float) -> dict:
    """The redesigned short-range kernel's slices over a table reordered by
    ``ops.cuda_p3m.p3m_short_order``: each non-empty 32-row slice of a cell's
    kept prefix (``cell``, ``s0``, ``rows``), its box (``lo``, ``hi``: the
    rows' min and max on each axis, float64 holding float32) and the bound
    of the reach test (``reach2``, ``cuda_p3m.p3m_short_reach2``)."""
    import torch

    from orbital_tpu_torch.ops.cuda_p3m import p3m_short_reach2

    count = order["run_off"][:, -1].long()
    dev = count.device
    n_sl = int(-(-int(count.max()) // 32)) if count.numel() else 0
    s0 = torch.arange(n_sl, device=dev) * 32
    cell, sl = torch.nonzero(count[:, None] > s0[None, :], as_tuple=True)
    start = s0[sl]
    rows = (count[cell] - start).clamp(max=32)
    k = start[:, None] + torch.arange(32, device=dev)                  # [S, 32]
    own = k < count[cell, None]
    p = order["rows"][cell[:, None], k.clamp(max=order["rows"].shape[1] - 1), :3].double()
    big = torch.tensor(1e30, dtype=torch.float64, device=dev)
    lo = torch.where(own[..., None], p, big).amin(1)
    hi = torch.where(own[..., None], p, -big).amax(1)
    return dict(cell=cell, s0=start, rows=rows, lo=lo, hi=hi, reach2=p3m_short_reach2(rcut2))


def p3m_within_reach(lo, hi, reach2: float, lo_b=None, hi_b=None):
    """The kernel's reach test: the squared distance between the box [lo, hi]
    and the points (``lo_b`` = ``hi_b``) or boxes [lo_b, hi_b], each operation
    rounded down in float32 (``__fsub_rd``, ``__fmul_rd``, ``__fadd_rd``), is
    below ``reach2``. Arguments are float64 holding float32 and broadcast."""
    import torch

    def down(v):
        return _directed_f32(v, up=False)

    gap = torch.clamp(torch.maximum(down(lo_b - hi), down(lo - hi_b)), min=0.0)
    sq = down(gap * gap)
    return down(down(sq[..., 0] + sq[..., 1]) + sq[..., 2]) < reach2


def p3m_short_work(tab: dict, gc: int, n: int, rcut2: float, warps: int = 8) -> dict:
    """The short-range kernel's work on a table of ``ops.p3m.p3m_cell_table``:
    the slots of the JAX module's tile form (``cell_block`` 32 cells of M
    rows against 27 M), the pairs the first version walked (each kept row of
    a cell against every kept row of its 27 neighbours), and, over the table
    as ``ops.cuda_p3m.p3m_short_order`` reorders it (``p3m_slices``): the
    pairs the kernel stages (each slice's rows against the rows of the
    neighbour octant runs whose box is within reach of the slice's box,
    ``p3m_within_reach``), the pairs it visits (against the rows within reach
    of the slice's box), the lane slots it issues (warp w of ``warps``
    sweeps the rows within reach of runs w, w + warps, ... in 32 x ceil(V_w /
    G) lane slots, G = 32 / S groups, S the power of two >= the slice's
    rows: every sweep but a warp's last takes a multiple of G
    rows), and the pairs the function needs: ordered pairs of kept bodies
    closer than rcut (r^2 of the f32 positions in f64), self pairs excluded.
    Also the bytes it must move: each kept slot's (x, y, z, m) and index read
    once (24 B), the counts (4 B a cell), each body's (ax, ay, az, pe)
    written once (16 B)."""
    import torch

    from orbital_tpu_torch.ops.cuda_p3m import p3m_short_order
    from orbital_tpu_torch.ops.p3m import _neighbour_cells

    table, pos = tab["table"], tab["cell_pos"]
    count = tab["count"].long()
    gc3, cap, dev = gc ** 3, table.shape[1], table.device
    nb = _neighbour_cells(torch.arange(gc3, device=dev), gc)
    cnt = torch.cat([count, count.new_zeros(1)])
    J = cnt[nb].sum(1)
    walked = int((count * J).sum())
    needed = 0
    block = max(1, (1 << 25) // (27 * cap * cap))
    rank = torch.arange(cap, device=dev)
    for c0 in range(0, gc3, block):
        cells = torch.arange(c0, min(c0 + block, gc3), device=dev)
        n_c = nb[c0:c0 + cells.shape[0]]
        pi, pj = pos[cells].double(), pos[n_c].reshape(cells.shape[0], -1, 3).double()
        live_i = rank[None] < count[cells, None]
        live_j = (rank[None, None] < cnt[n_c][..., None]).reshape(cells.shape[0], -1)
        d2 = ((pj[:, None] - pi[:, :, None]) ** 2).sum(-1)
        other = table[cells][:, :, None] != table[n_c].reshape(cells.shape[0], -1)[:, None]
        needed += int((live_i[:, :, None] & live_j[:, None] & other & (d2 < rcut2)).sum())

    order = p3m_short_order(table, pos, tab["cell_m"], tab["count"], gc)
    sl = p3m_slices(order, gc, rcut2)
    reach2 = sl["reach2"]
    run_off, run_box = order["run_off"].long(), order["run_box"].double()
    octant = torch.searchsorted(run_off[:, 1:].contiguous(), rank.expand(gc3, -1).contiguous(),
                                right=True)                          # [gc3, M]
    width = 2 ** torch.ceil(torch.log2(sl["rows"].clamp(min=1).double())).long()
    groups = 32 // width
    staged = visited = issued = 0
    for a in range(0, sl["cell"].numel(), 64):
        c, lo, hi = sl["cell"][a:a + 64], sl["lo"][a:a + 64], sl["hi"][a:a + 64]
        ids = nb[c]                                                   # [S, 27]
        ok = ids < gc3
        ids_c = torch.where(ok, ids, 0)
        pj = order["rows"][ids_c][..., :3].double()                   # [S, 27, M, 3]
        live = (rank < cnt[ids][..., None]) & ok[..., None]
        inside = live & p3m_within_reach(lo[:, None, None], hi[:, None, None], reach2, pj, pj)
        b = run_box[ids_c]                                            # [S, 27, 8, 6]
        reach = p3m_within_reach(lo[:, None, None], hi[:, None, None], reach2, b[..., :3],
                                 b[..., 3:])
        run = torch.arange(27, device=dev)[None, :, None] * 8 + octant[ids_c]   # [S, 27, M]
        staged_rows = (live & torch.gather(reach, 2, octant[ids_c].clamp(max=7))).sum((1, 2))
        warp_of = run % warps
        v_w = torch.stack([(inside & (warp_of == w)).sum((1, 2)) for w in range(warps)], 1)
        r = sl["rows"][a:a + 64]
        staged += int((r * staged_rows).sum())
        visited += int((r * inside.sum((1, 2))).sum())
        issued += int((32 * -(-v_w // groups[a:a + 64, None])).sum())
    kept = int(count.sum())
    return dict(jax_slots=-(-gc3 // 32) * 32 * cap * 27 * cap, walked=walked, staged=staged,
                visited=visited, issued=issued, needed=needed,
                nbytes=24 * kept + 4 * gc3 + 16 * n)


def energy_f64(state) -> float:
    """Total energy in f64 from the (ds32) state: kinetic on the host,
    softened potential from the f64 oracle."""
    from orbital_tpu_torch.utils import native

    def full(hi, lo):
        x = hi.double()
        return (x if lo is None else x + lo.double()).cpu().numpy()

    pos, vel = full(state.pos, state.pos_lo), full(state.vel, state.vel_lo)
    mass = state.mass.double().cpu().numpy()
    K = 0.5 * float(np.sum(mass * np.sum(vel * vel, -1)))
    return K + native.potential_f64(pos, mass, EPS2)


def time_ms(fn, iters: int, repeats: int = 3):
    """Per-call milliseconds of ``fn`` by CUDA events, one figure per
    repeat of ``iters`` calls after one warm-up call."""
    import torch

    fn()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def host_ms(fn, iters: int, repeats: int = 3):
    """Per-call milliseconds the host takes to queue ``fn`` (no synchronise
    inside the timed span; the card is drained before and after), one figure
    per repeat of ``iters`` calls after one warm-up call."""
    import torch

    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out.append(1e3 * (time.perf_counter() - t0) / iters)
        torch.cuda.synchronize()
    return out


def alternate_ms(fns: dict, iters: int, repeats: int = 3, timer=None) -> dict:
    """``time_ms`` (or ``timer``) of several functions in turns (a, b, b, a,
    ...), so that drift of the card's clock hits them alike."""
    timer = timer or time_ms
    out = {k: [] for k in fns}
    names = list(fns)
    for r in range(repeats):
        for k in (names if r % 2 == 0 else names[::-1]):
            out[k] += timer(fns[k], iters, repeats=1)
    return out


def device_times(fn) -> dict:
    """{kernel name: (launches, device ms)} over one call of ``fn`` (after a
    warm-up call), from torch.profiler's CUDA activity; empty when the
    profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and t > 0:
            out[e.key] = (e.count, t / 1e3)
    return out


def reset_launches() -> None:
    from orbital_tpu_torch.ops import (cuda_collisions, cuda_forces, cuda_forces_mxu,
                                       cuda_forces_sym, cuda_jerk, cuda_neighbor, cuda_p3m,
                                       cuda_tree, fused_rollout)

    for fn in (cuda_forces.pairwise_acc_cuda, cuda_forces.pairwise_acc_detect_cuda,
               fused_rollout.fused_rollout, cuda_collisions.bounce_deltas_cuda,
               cuda_jerk.accel_jerk_cuda, cuda_jerk.accel_jerk_detect_cuda,
               cuda_jerk.accel_jerk_subset_cuda, cuda_neighbor.near_acc_slots_cuda,
               cuda_tree.tree_near_cuda, cuda_forces_sym.pairwise_acc_sym_cuda,
               cuda_forces_mxu.gram_sums_cuda, cuda_forces.block_acc_cuda,
               cuda_p3m.p3m_short_cuda, cuda_p3m.p3m_short_order_cuda,
               cuda_collisions.collision_roots_cuda, cuda_collisions.contact_marks_cuda):
        fn.launches = 0


@contextlib.contextmanager
def plain_tree_near():
    """Route the tree's near sweep on CUDA tensors to the plain version
    instead of B7, for a run that is held against the kernel's."""
    from orbital_tpu_torch.ops import cuda_tree

    kernel = cuda_tree.tree_near_cuda
    cuda_tree.tree_near_cuda = cuda_tree.tree_near_plain
    try:
        yield
    finally:
        cuda_tree.tree_near_cuda = kernel


@contextlib.contextmanager
def overflow_log():
    """Wrap ``ops.tree.tree_acc_potential`` so that every evaluation adds
    its overflow to a device counter (no host read until the caller reads
    it); yields the one-element list that holds the counter."""
    from orbital_tpu_torch.ops import tree

    inner = tree.tree_acc_potential
    total = []

    def logged(*args, **kw):
        acc, U, ovf = inner(*args, **kw)
        if total:
            total[0] = total[0] + ovf
        else:
            total.append(ovf.long())
        return acc, U, ovf

    tree.tree_acc_potential = logged
    try:
        yield total
    finally:
        tree.tree_acc_potential = inner


@contextlib.contextmanager
def plain_bounce():
    """Route the stepper's bounce sweep on CUDA tensors to the plain version
    instead of the kernel, for a run that is held against the kernel's."""
    from orbital_tpu_torch.ops import cuda_collisions

    kernel = cuda_collisions.bounce_deltas_cuda
    cuda_collisions.bounce_deltas_cuda = cuda_collisions.bounce_deltas_plain
    try:
        yield
    finally:
        cuda_collisions.bounce_deltas_cuda = kernel


class StepLog:
    """Wraps the closing force function of a run (with or without contact
    detection; kdk's or Hermite's) and logs what it sees on the device: the
    positions of every step if asked, and for a detecting function (whose
    last output is an int32 count) the sum of its contact counts, the number
    of steps with a count > 0 and, if asked, each step's count. Nothing is
    read back until the run is over."""

    def __init__(self, fn, keep_pos: bool = False, keep_counts: bool = False):
        self.fn = fn
        self.total = self.steps = None
        self.positions = [] if keep_pos else None
        self.counts = [] if keep_counts else None

    def __call__(self, pos, *rest):
        import torch

        out = self.fn(pos, *rest)
        if self.positions is not None:
            self.positions.append(pos)
        if out[-1].dtype == torch.int32:
            c = out[-1]
            if self.total is None:
                self.total = torch.zeros((), dtype=torch.int64, device=c.device)
                self.steps = torch.zeros_like(self.total)
            self.total += c
            self.steps += (c > 0).to(self.steps.dtype)
            if self.counts is not None:
                self.counts.append(c)
        return out


class ResolveLog:
    """Counts what each resolve round (``ops.collisions.resolve_outcomes``,
    on the gathered subset scene) did, on the device, while it is patched
    in: per round the deaths, of them the absorbed (died touching a live
    body more than 10x heavier), the absorbers that gained mass and the
    debris revived in dead slots, and the masses that died, that absorbers
    gained and that debris carries. An absorbed body's mass goes whole to
    its absorber, so the fragmented mass is the dead mass less the gained;
    a round whose fragments all spawned debris carries it all into debris.
    A gated round at a count of 0 touches nothing and counts 0. ``totals()``
    reads them back once."""

    KEYS = ("died", "absorbed", "absorbers", "debris", "m_died", "m_gained", "m_debris")

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from orbital_tpu_torch.ops import collisions

        self.mod, self.fn = collisions, collisions.resolve_outcomes

        def logged(pos, vel, mass, radius, alive, *rest, **kw):
            import torch

            out = self.fn(pos, vel, mass, radius, alive, *rest, **kw)
            _, _, touching = collisions._pair_geometry(pos, radius, alive)
            heavier = touching & (mass[None, :] > 10.0 * mass[:, None]) & out[4][None, :]
            died = alive & ~out[4]
            gained = alive & out[4] & (out[2] > mass)
            debris = ~alive & out[4]
            m, m_out = mass.double(), out[2].double()
            self.rows.append(torch.stack([
                died.sum().double(), (died & heavier.any(1)).sum().double(),
                gained.sum().double(), debris.sum().double(), (m * died).sum(),
                ((m_out - m) * gained).sum(), (m_out * debris).sum()]))
            return out

        collisions.resolve_outcomes = logged
        return self

    def __exit__(self, *exc):
        self.mod.resolve_outcomes = self.fn

    def totals(self) -> dict:
        import torch

        rows = torch.stack(self.rows).cpu().numpy() if self.rows else np.zeros((0, 7))
        out = dict(zip(self.KEYS, rows.sum(0).tolist()))
        m_frag = rows[:, 4] - rows[:, 5]
        short = m_frag - rows[:, 6]   # fragments that spawned no debris
        out.update(rounds=len(rows), fragmented=out["died"] - out["absorbed"],
                   m_fragmented=float(m_frag.sum()), m_unspawned=float(short.sum()),
                   rounds_short=int((short > 1e-3 * np.maximum(m_frag, 1e-300)).sum()))
        return out


def summary(times):
    return {"median": statistics.median(times), "spread": max(times) - min(times),
            "runs": times}


def bind_like(path, like, names):
    """Load another build of a source and give its entry points the
    argument types of ``like``, the library this tree built."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    for fn in names:
        getattr(lib, fn).restype = getattr(like, fn).restype
        getattr(lib, fn).argtypes = getattr(like, fn).argtypes
    return lib


class OldBuild:
    """Another build of a source whose C entry point predates this tree's
    wrapper: ``on`` runs the wrapper with its launch function (``patches``,
    by name) swapped for one written against the old signature."""

    def __init__(self, lib, patches: dict):
        self.lib, self.patches = lib, patches


def _near_sweep_first(lib):
    """``cuda_neighbor._sweep`` against the near sweep's first C signature
    (one float4 table; the wrapper counted each row's live prefix and took
    the self pair off pe)."""
    import ctypes

    import torch

    from orbital_tpu_torch.utils.kernels import check

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.near_sweep.restype = ctypes.c_int
    lib.near_sweep.argtypes = [p, p, p, i, p, i, i, i, f, f, f, f, f, p, p, i]

    def sweep(xs, ys, zs, ms, blocks, off, stride, count, k_ch, *, r1, rc, G, eps2, chunk,
              rj):
        c, blkw = int(chunk), int(rj) * int(chunk)
        pts = torch.stack([xs, ys, zs, ms], dim=1).contiguous()
        if count is None:
            count = torch.sum(blocks != xs.shape[0] // blkw - 1, dim=1, dtype=torch.int32)
        out = torch.empty((k_ch * c, 4), dtype=torch.float32, device=xs.device)
        inv_d = 1.0 / (rc * rc - r1 * r1)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.near_sweep(pts.data_ptr(), blocks.data_ptr(),
                             None if off is None else off.data_ptr(), int(stride),
                             count.data_ptr(), int(k_ch), c, blkw, float(rc * rc),
                             float(inv_d), float(30.0 * inv_d), float(eps2), float(G),
                             out.data_ptr(), stream, xs.device.index or 0)
        check(lib, err, "near_sweep launch (first signature)")
        return out[:, :3], out[:, 3] - ms[:k_ch * c] * (float(eps2) ** -0.5)

    return {"_sweep": sweep}


def _fused_launch_first(lib):
    """``fused_rollout._launch`` against B4's first C signature (no launch
    plan: the kernel sized its own grid)."""
    import ctypes

    import torch

    from orbital_tpu_torch.utils.kernels import check

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_kdk.restype = ctypes.c_int
    lib.fused_kdk.argtypes = [p] * 7 + [i, i, f, f, f, f, i, p, i]

    def launch(pos_hi, pos_lo, vel_hi, vel_lo, mass, keep, cfg, steps, ds):
        acc = torch.empty_like(pos_hi)
        dev = pos_hi.device
        err = lib.fused_kdk(pos_hi.data_ptr(), pos_lo.data_ptr(), vel_hi.data_ptr(),
                            vel_lo.data_ptr(), acc.data_ptr(), mass.data_ptr(),
                            keep.data_ptr(), pos_hi.shape[1], int(steps), float(cfg.dt),
                            float(0.5 * cfg.dt), float(cfg.G), float(cfg.eps2), int(ds),
                            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
        check(lib, err, "fused_kdk launch (first signature)")

    return {"_launch": launch}


def _jerk_subset_first(lib):
    """``cuda_jerk._subset`` against the row subset's first C signature (two
    packed float4 tables of all N bodies and int64 indices in; per-split
    partials of 128 sources out, which the wrapper summed with one
    ``torch.sum``)."""
    import ctypes

    import torch

    from orbital_tpu_torch.ops.cuda_jerk import _pack
    from orbital_tpu_torch.utils.kernels import check

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nbody_jerk_subset.restype = ctypes.c_int
    lib.nbody_jerk_subset.argtypes = [p, p, p, i, i, i, f, f, p, p, i]

    def subset(idx_i, pos, vel, mass, alive, G, eps2):
        n, f_, dev = pos.shape[0], idx_i.shape[0], pos.device
        pm, vr, _ = _pack(pos, vel, mass, alive)
        idx64 = idx_i.to(torch.int64).contiguous()
        part = torch.empty((-(-n // 128), f_, 6), dtype=torch.float32, device=dev)
        err = lib.nbody_jerk_subset(pm.data_ptr(), vr.data_ptr(), idx64.data_ptr(), f_, n,
                                    128, float(G), float(eps2), part.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
        check(lib, err, "nbody_jerk_subset launch (first signature)")
        return part.sum(0)

    return {"_subset": subset}


def _p3m_short_first(lib):
    """``cuda_p3m._launch`` against the short-range kernel's first C
    signature (the cell table as ``p3m_cell_table`` builds it, with the
    counts: no reorder)."""
    import ctypes

    import torch

    from orbital_tpu_torch.utils.kernels import check

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.p3m_short.restype = ctypes.c_int
    lib.p3m_short.argtypes = [p, p, p, p, i, i, p, f, f, p, p, p, i]

    def launch(table, cell_pos, cell_m, count, gc, params, G, eps2, acc, pe):
        dev = table.device
        tab, cp, cm = table.contiguous(), cell_pos.contiguous(), cell_m.contiguous()
        cnt = count.to(torch.int32).contiguous()
        err = lib.p3m_short(cp.data_ptr(), cm.data_ptr(), tab.data_ptr(), cnt.data_ptr(),
                            int(gc), int(tab.shape[1]), params.data_ptr(), G, eps2,
                            acc.data_ptr(), pe.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
        check(lib, err, "p3m_short launch (first signature)")

    return {"_launch": launch}


# the sources whose C signature changed with a redesign: the function their
# earlier versions lack, the adapter to the earlier signature and the entry
# points it binds (the rest keep this tree's argument types)
FIRST_SIGNATURES = {"neighbor": ("near_sweep_shape", _near_sweep_first, ("near_sweep",)),
                    "p3m_short": ("p3m_short_sorted", _p3m_short_first, ("p3m_short",)),
                    "fused_rollout": ("fused_kdk_shape", _fused_launch_first, ("fused_kdk",)),
                    "nbody_jerk": ("nbody_jerk_subset_shape", _jerk_subset_first,
                                   ("nbody_jerk_subset",))}


def other_build(name: str, path, like):
    """Another commit's build of source ``name`` at ``path``, bound as this
    tree's library ``like`` is, or as an OldBuild where an entry point has
    an earlier signature."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    first = FIRST_SIGNATURES.get(name)
    if first is not None and not hasattr(lib, first[0]):
        same = [fn for fn in LIB_FUNCS[name] if fn not in first[2] and hasattr(lib, fn)]
        for fn in same:
            getattr(lib, fn).restype = getattr(like, fn).restype
            getattr(lib, fn).argtypes = getattr(like, fn).argtypes
        return OldBuild(lib, first[1](lib))
    return bind_like(path, like, LIB_FUNCS[name])


class RootsLib:
    """The root search's library slot (``cuda_collisions._roots_lib``) as a
    module's ``_lib``, so that ``on`` swaps it for another build."""

    @property
    def _lib(self):
        from orbital_tpu_torch.ops import cuda_collisions

        return cuda_collisions._roots_lib

    @_lib.setter
    def _lib(self, lib):
        from orbital_tpu_torch.ops import cuda_collisions

        cuda_collisions._roots_lib = lib

    @staticmethod
    def load():
        from orbital_tpu_torch.ops import cuda_collisions

        return cuda_collisions._load_roots()


def on(mod, lib, fn):
    """``fn()`` with wrapper module ``mod`` launching from library ``lib``
    (an OldBuild swaps the module's launch function too)."""
    patches = getattr(lib, "patches", {})
    saved = (mod._lib, {k: getattr(mod, k) for k in patches})
    mod._lib = getattr(lib, "lib", lib)
    for k, v in patches.items():
        setattr(mod, k, v)
    try:
        return fn()
    finally:
        mod._lib = saved[0]
        for k, v in saved[1].items():
            setattr(mod, k, v)


def compile_libraries(jobs) -> dict:
    """Run one ``nvcc`` per ``(source, library, extra flags)`` job with the
    build's flags, all at once, each into a temporary file renamed into
    place when it succeeds. Returns ``{library: (nvcc's output, wall
    seconds)}``; raises with the compiler's output if any build fails."""
    from pathlib import Path

    from orbital_tpu_torch.utils import kernels

    started = []
    for src, out, extra in jobs:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started.append((Path(src), out, tmp, proc, time.perf_counter()))
    done, failed = {}, []
    for src, out, tmp, proc, t0 in started:
        log = proc.communicate()[0]
        done[out] = (log, time.perf_counter() - t0)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {src.name} (rc={proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def ptxas_usage(log: str) -> dict:
    """``{entry function: (registers, spill store bytes, spill load bytes)}``
    from nvcc's ``-Xptxas -v`` output."""
    out, fn, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), *spill)
    return out


def sass(library) -> str:
    """``cuobjdump -sass`` of a built library; empty if the toolkit has no
    ``cuobjdump``."""
    from pathlib import Path

    from orbital_tpu_torch.utils import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return ""
    return subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout


def loop_bodies(text: str, marker: str = r"MUFU\.RSQ", exclude: str = None) -> dict:
    """``{function: [instruction, ...]}``: the innermost loop of each
    function in SASS ``text`` that holds the most instructions matching
    ``marker`` (and of those, the fewest instructions a marker), skipping
    loops with an instruction matching ``exclude``. A loop is the span from a
    backward branch's target to the branch; branch targets are addresses
    (``cuobjdump``) or ``.L_x_`` labels (``nvdisasm``)."""
    out = {}
    for chunk in re.split(r"\n\s*Function\s*:\s*", text)[1:]:
        name = chunk.split(None, 1)[0]
        insts, labels, pending = [], {}, []
        for line in chunk.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                addr = int(m.group(1), 16)
                for label in pending:
                    labels[label] = addr
                pending = []
                insts.append((addr, m.group(2)))
        loops = []
        for addr, op in insts:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", op)
            if not m:
                continue
            target = m.group(1)
            start = labels.get(target) if target.startswith(".") else int(target, 16)
            if start is not None and start <= addr:
                loops.append((start, addr))
        inner = [lp for lp in loops
                 if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        best = None
        for start, end in inner:
            body = [op for a, op in insts if start <= a <= end]
            if exclude and any(re.search(exclude, op) for op in body):
                continue
            count = sum(bool(re.search(marker, op)) for op in body)
            if count and (best is None or (-count, len(body) / count)
                          < (-best[1], len(best[0]) / best[1])):
                best = (body, count)
        if best is not None:
            out[name] = best[0]
    return out


def inner_loop(text: str, marker: str = r"MUFU\.RSQ") -> dict:
    """``{function: (instructions, marker count)}`` of :func:`loop_bodies`:
    with one marker a pair (MUFU.RSQ on the softened sweeps), instructions
    / count is the warp instructions a pair."""
    return {f: (len(body), sum(bool(re.search(marker, op)) for op in body))
            for f, body in loop_bodies(text, marker).items()}


def inner_loop_excluding(text: str, exclude: str, marker: str = r"MUFU\.RSQ") -> dict:
    """:func:`inner_loop` over the loops without an instruction matching
    ``exclude``."""
    return {f: (len(body), sum(bool(re.search(marker, op)) for op in body))
            for f, body in loop_bodies(text, marker, exclude).items()}


def sass_slots(name: str, sass_text: str) -> dict:
    """{record key: warp instructions a pair} of the instantiations of
    ``name`` that SHAPED lists: the inner loop's instructions over its count
    of the pair marker SHAPED gives (one a pair)."""
    _, stems, marker = SHAPED[name]
    loops = inner_loop(sass_text, marker)
    out = {}
    for key, stem in stems.items():
        loop = next((v for f, v in loops.items() if stem in f), None)
        if loop:
            out[key] = loop[0] / loop[1]
    return out


def tensor_ops(name: str, sass_text: str) -> dict:
    """{record key: TF32 HMMA instructions in the inner loop} of the
    instantiations of ``name`` (a TENSOR_CORE source) that SHAPED lists."""
    _, stems, marker = SHAPED[name]
    bodies = loop_bodies(sass_text, marker)
    out = {}
    for key, stem in stems.items():
        body = next((v for f, v in bodies.items() if stem in f), None)
        if body is not None:
            out[key] = sum(bool(re.search(TENSOR_CORE[name], op)) for op in body)
    return out


def clock_during(fn, seconds: float = 2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi samples
    every 50 ms while ``fn`` runs back to back for ``seconds`` (the first
    third of the samples, taken while the load ramps up, dropped)."""
    import torch

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    rows = []
    for line in text.splitlines():
        try:
            rows.append(tuple(float(x) for x in line.split(",")))
        except ValueError:
            continue
    rows = rows[len(rows) // 3:]
    if not rows:
        return {"sm_mhz": "not measured", "watts": "not measured"}
    return {"sm_mhz": statistics.median(r[0] for r in rows),
            "watts": statistics.median(r[1] for r in rows), "samples": len(rows)}


def launch_record(lib, name: str, log: str, sass_text: str, n: int = N_MAIN) -> dict:
    """{record key: launch shape at n bodies, registers and spill bytes (from
    nvcc's -Xptxas -v output ``log``) and warp instructions a pair (the
    innermost loop of ``sass_text`` over its pair markers; for a TENSOR_CORE
    source also the TF32 HMMA instructions of that loop)}. Raises if an
    instantiation SHAPED lists is missing from ``log``, or from
    ``sass_text`` unless that is empty (no ``cuobjdump``), or if a
    TENSOR_CORE source's inner loop holds no TF32 HMMA."""
    import ctypes

    shape_fn, stems, _ = SHAPED[name]
    fn = getattr(lib, shape_fn)
    fn.restype, fn.argtypes = None, [ctypes.c_int, ctypes.c_void_p]
    arr = (ctypes.c_int * 5)()
    fn(n, arr)
    shape = dict(zip(("k", "q", "tile", "threads", "blocks"), list(arr)))
    usage, per_pair = ptxas_usage(log), sass_slots(name, sass_text)
    hmma = tensor_ops(name, sass_text) if name in TENSOR_CORE else {}
    out = {}
    for key, stem in stems.items():
        regs = next((v for f, v in usage.items() if stem in f), None)
        if regs is None:
            raise AssertionError(f"{key}: no entry function *{stem}* in the ptxas output")
        if sass_text and key not in per_pair:
            marker = SHAPED[name][2].replace("\\b", "").replace("\\", "")
            raise AssertionError(f"{key}: no loop with {marker} in *{stem}* in the SASS")
        out[key] = {"shape": shape, "registers": regs[0], "spill_bytes": regs[1] + regs[2],
                    "sass_slots_per_pair": per_pair.get(key, "not measured")}
        if name in TENSOR_CORE:
            if sass_text and not hmma.get(key):
                raise AssertionError(f"{key}: no TF32 HMMA in the inner loop of *{stem}*: "
                                     f"the tensor cores are not in use")
            out[key]["tf32_hmma_in_loop"] = hmma.get(key, "not measured")
    return out


def spill_free(name: str, log: str) -> int:
    """The number of entry functions in nvcc's -Xptxas -v output ``log``;
    raises if it names none or any of them spills."""
    usage = ptxas_usage(log)
    spilled = {f: u[1] + u[2] for f, u in usage.items() if u[1] + u[2]}
    if not usage or spilled:
        raise AssertionError(f"{name}: spill bytes {spilled or 'not in the ptxas output'}")
    return len(usage)


def fmt(x, digits: int = 2, unit: str = "") -> str:
    return "not measured" if x is None or isinstance(x, str) else f"{x:.{digits}f}{unit}"


def loop_pairs(key: str, rec: dict, n: int = N_MAIN):
    """The pairs the inner loop of ``key``'s kernel walks at n bodies, one
    pair marker each: the n^2 ordered pairs (B4's a step at its main path's
    N_FUSED); for B12 the unordered pairs of its tile pairs (a diagonal
    tile's twice); for B7 and the near sweep None, since they follow the
    data (``tree_near_work`` and ``near_work`` count them)."""
    if key in ("B7", "NEAR"):
        return None
    if key == "B4":
        return N_FUSED * N_FUSED
    if key == "B12":
        return rec["shape"]["blocks"] * rec["shape"]["tile"] ** 2
    return n * n


def issue_floor_ms(per_pair, pairs, mhz: float = 1980.0):
    """Milliseconds to issue ``per_pair`` warp instructions for each of
    ``pairs`` pairs (32 to a warp) on 528 schedulers at ``mhz``; None when
    either is unknown."""
    if per_pair is None or isinstance(per_pair, str) or pairs is None:
        return None
    return 1e3 * per_pair * pairs / 32 / (528 * mhz * 1e6)


def describe_launch(key: str, rec: dict, n: int = N_MAIN) -> str:
    """One launch record as text, with the issue floor its SASS count
    implies at n bodies, 528 schedulers and the 1.98 GHz boost clock."""
    sh, slots = rec["shape"], rec["sass_slots_per_pair"]
    floor = issue_floor_ms(slots, loop_pairs(key, rec, n))
    floor = {"B7": "from the visited pairs, phase 24",
             "NEAR": "from the visited pairs, phase 20"}.get(key, fmt(floor, 3, " ms"))
    if key == "B4":
        floor += f" a step at N={N_FUSED}; {sh['blocks']} co-resident blocks"
    hmma = (f", {rec['tf32_hmma_in_loop']} TF32 HMMA in the inner loop"
            if "tf32_hmma_in_loop" in rec else "")
    return (f"{key} k={sh['k']} q={sh['q']} tile={sh['tile']} ({sh['threads']} threads x "
            f"{sh['blocks']} blocks), {rec['registers']} registers, {rec['spill_bytes']} "
            f"spill bytes, {fmt(slots)} SASS instructions a pair (issue floor "
            f"{floor}){hmma}")


def held(out, ref, tols) -> tuple[float, bool]:
    """The outputs of one wrapper call against a reference call's: the
    worst relative difference (max |d| / max |ref| of an array, |d| / |ref|
    of a scalar), raising where one exceeds its tolerance (0: equal), and
    whether every output is bit-equal."""
    worst, equal = 0.0, True
    for i, (x, y, tol) in enumerate(zip(out, ref, tols)):
        equal = equal and bool((x == y).all())
        if not x.is_floating_point():
            if not bool((x == y).all()):
                raise AssertionError(f"output {i}: {x.tolist()} != {y.tolist()}")
            continue
        scale = float(y.abs().max())
        err = float((x.double() - y.double()).abs().max())
        rel = err / scale if scale > 0 else err
        if rel > tol:
            raise AssertionError(f"output {i}: relative difference {rel:.3e} > {tol:g}")
        worst = max(worst, rel)
    return worst, equal


def gram_held(out, ref, s64) -> float:
    """B13's outputs (S, and pe with PE) against a reference build's or its
    plain version's ``ref``: S within GRAM_S_RTOL in RMS and GRAM_MAX_RTOL
    in max of ``s64``, the exact S of the same packed rows (f64); pe within
    GRAM_RTOL in RMS and GRAM_MAX_RTOL in max of ``ref``'s. Raises where
    one fails; returns the worst max difference from ``ref``."""
    import torch

    worst = 0.0
    for i, (x, y) in enumerate(zip(out, ref)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"B13 output {i} is not finite")
        worst = max(worst, float((x.double() - y.double()).abs().max()) / float(y.abs().max()))
    S = out[0]
    r_rms = rms_rel(S, s64)
    r_max = float((S.double() - s64).abs().max()) / float(s64.abs().max())
    if r_rms > GRAM_S_RTOL or r_max > GRAM_MAX_RTOL:
        raise AssertionError(f"B13 S vs the exact S: RMS {r_rms:.3e}, max {r_max:.3e} > "
                             f"{GRAM_S_RTOL:g}, {GRAM_MAX_RTOL:g}")
    if len(out) > 1:
        pe, pe0 = out[1], ref[1]
        p_rms = rms_rel(pe, pe0)
        p_max = float((pe.double() - pe0.double()).abs().max()) / float(pe0.abs().max())
        if p_rms > GRAM_RTOL or p_max > GRAM_MAX_RTOL:
            raise AssertionError(f"B13 pe: RMS difference {p_rms:.3e}, max {p_max:.3e} > "
                                 f"{GRAM_RTOL:g}, {GRAM_MAX_RTOL:g}")
    return worst


def max_state_err(a, b) -> float:
    """Largest |difference| of full-precision positions and velocities."""
    err = 0.0
    for f in ("pos_full", "vel_full"):
        x = getattr(a, f)().double()
        y = getattr(b, f)().double()
        err = max(err, float((x - y).abs().max()))
    return err


class Smoke:
    def __init__(self, seed: int, drift_steps: int):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.seed = seed
        self.drift_steps = drift_steps
        self.kernels = {"B1": dict(B1), "B2": dict(B2), "B4": dict(B4), "B6": dict(B6),
                        "B5": dict(B5), "B5D": dict(B5D), "B5S": dict(B5S),
                        "NEAR": dict(NEAR), "B7": dict(B7), "B12": dict(B12),
                        "B13": dict(B13), "B3": dict(B3), "P3M": dict(P3M),
                        "P3MO": dict(P3MO), "ROOTS": dict(ROOTS), "MARK": dict(MARK)}
        self._cluster = None
        self._respa_budgets = None
        self._plummer = None
        self.main_ms_per_step = None
        self.hermite_log = None

    def cluster(self):
        """The 65,536-body virialised cluster and its f64 energy after
        ``init_forces`` (made once; every N = 65,536 path starts from it)."""
        if self._cluster is None:
            import orbital_tpu_torch as ot

            pos, vel, mass = make_cluster(N_MAIN, self.seed)
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2)
            st = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32",
                                              device=self.dev), cfg)
            self._cluster = (pos, vel, mass, energy_f64(st))
        return self._cluster

    # phase 1
    def device_info(self) -> str:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        line = out.stdout.strip().splitlines()[0]
        print(line, flush=True)  # the card's name and power limit, as nvidia-smi gives them
        return line

    # phase 2
    def build(self) -> str:
        from orbital_tpu_torch.ops import (cuda_collisions, cuda_forces, cuda_forces_mxu,
                                           cuda_forces_sym, cuda_jerk, cuda_neighbor,
                                           cuda_p3m, cuda_tree, fused_rollout)
        from orbital_tpu_torch.utils import kernels

        names = kernels.SOURCES
        t0 = time.perf_counter()
        kernels.build(names)
        for mod in (cuda_forces, fused_rollout, cuda_collisions, cuda_jerk, cuda_neighbor,
                    cuda_tree, cuda_forces_sym, cuda_forces_mxu, cuda_p3m):
            mod._load()
        cuda_collisions._load_roots()
        total = time.perf_counter() - t0
        for name in names:
            for line in kernels.build_log(name).splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)
        each = ", ".join(f"{n} {kernels.build_seconds(n):.2f} s" for n in names)
        # the launch shapes of the eight redesigned kernels, their
        # registers and spills (a cached library is compiled again for its
        # -Xptxas -v output), SASS instructions a pair and B13's TF32 HMMA;
        # B7's and the near sweep's blocks at their main paths' chunk budgets
        tiled = self.redesigned()
        at = {"tree_near": self.plummer()[3][0], "neighbor": self.respa_budgets()[1]}
        logs = {name: kernels.build_log(name)
                for name in (*tiled, "p3m_short", "collision_roots")}
        again = {kernels.BUILD_DIR / "usage" / kernels._library_path(name)[1].name: name
                 for name, log in logs.items() if not log}
        for out, (log, _) in compile_libraries(
                [(kernels._library_path(name)[0], out, ()) for out, name in again.items()]
        ).items():
            logs[again[out]] = log
        shapes, spills = [], []
        for name, mod in tiled.items():
            spills.append(f"{name} 0 in {spill_free(name, logs[name])} entry functions")
            recs = launch_record(mod._load(), name, logs[name],
                                 sass(kernels._library_path(name)[1]), n=at.get(name, N_MAIN))
            for key, rec in recs.items():
                self.kernels[key].update(rec)
                shapes.append(describe_launch(key, rec))
        # the kernels outside SHAPED: the row subset (in nbody_jerk, whose
        # spills are checked above), the short range and the contact sweep
        for name in ("p3m_short", "collision_roots"):
            spills.append(f"{name} 0 in {spill_free(name, logs[name])} entry functions")
        shapes += [self.subset_record(cuda_jerk._load(), logs["nbody_jerk"]),
                   self.p3m_record(logs["p3m_short"], sass(
                       kernels._library_path("p3m_short")[1])),
                   self.roots_record(logs["collision_roots"], sass(
                       kernels._library_path("collision_roots")[1]))]
        return (f"built {each} in parallel (load total {total:.2f} s) for sm_90a; at "
                f"N={N_MAIN}: " + "; ".join(shapes) + "; spill bytes: " + ", ".join(spills))

    def entry_record(self, key: str, stem: str, log: str) -> str:
        """Registers and spill bytes of the entry functions *stem* in nvcc's
        -Xptxas -v output, into ``key``'s record; raises if there is none."""
        usage = [u for f, u in ptxas_usage(log).items() if stem in f]
        if not usage:
            raise AssertionError(f"{key}: no entry function *{stem}* in the ptxas output")
        regs, spill = max(u[0] for u in usage), sum(u[1] + u[2] for u in usage)
        self.kernels[key].update(registers=regs, spill_bytes=spill)
        return (f"{key} ({len(usage)} instantiations) {regs} registers at most, {spill} spill "
                f"bytes")

    def p3m_record(self, log: str, sass_text: str) -> str:
        """The short-range kernel's launch shape at the P3M bench row's grid
        and probed capacity, its registers and spills, and the SASS
        instructions of its polynomial sweep loop (the innermost loop with
        MUFU.RSQ and no MUFU.EX2, the erff path's) a visited pair: one
        MUFU.RSQ a pair."""
        from orbital_tpu_torch.ops.cuda_p3m import p3m_short_shape
        from orbital_tpu_torch.ops.p3m import _cell_grid, p3m_max_occupancy

        line = (self.entry_record("P3M", "p3m_short_kernel", log) + "; "
                + self.entry_record("P3MO", "p3m_order_kernel", log))
        pos, _, _ = self.p3m_uniform()
        cap = self.p3m_capacity(p3m_max_occupancy(self.t(pos), None, grid=P3M_GRID,
                                                  box=self.box_t(P3M_BOX)))
        shape = p3m_short_shape(_cell_grid(P3M_GRID, 1.5, 4.5), cap)
        loop = next((v for f, v in inner_loop_excluding(sass_text, r"MUFU\.EX2").items()
                     if "p3m_short_kernel" in f), None)
        if sass_text and loop is None:
            raise AssertionError("P3M: no polynomial sweep loop (MUFU.RSQ without MUFU.EX2)")
        per_pair = loop[0] / loop[1] if loop else "not measured"
        self.kernels["P3M"].update(shape=shape, sass_slots_per_pair=per_pair)
        return f"{line}, shape {shape}, {fmt(per_pair)} SASS instructions a visited pair"

    def roots_record(self, log: str, sass_text: str) -> str:
        """The contact sweep's launch shape at N_MAIN (tiles and the
        cooperative grid), the registers and spills of its two modes, and
        the SASS instructions a pair of each mode's prefilter loop (its
        innermost loop with the most FSETP, one a pair), whose
        instructions go to standard error."""
        import ctypes

        from orbital_tpu_torch.ops import cuda_collisions

        line = "; ".join(self.entry_record(k, stem, log) for k, stem in SWEEP_MODES.items())
        fn = cuda_collisions._load_roots().collision_parents_shape
        fn.restype, fn.argtypes = None, [ctypes.c_int, ctypes.c_void_p]
        arr = (ctypes.c_int * 6)()
        fn(N_MAIN, arr)
        shape = dict(zip(("columns_a_lane", "tile", "slice", "warps", "blocks", "tiles"),
                         list(arr)))
        bodies = loop_bodies(sass_text, r"\bFSETP\b")
        dump, per = [], {}
        for key, stem in SWEEP_MODES.items():
            body = next((v for f, v in bodies.items() if stem in f), None)
            marks = sum(bool(re.search(r"\bFSETP\b", op)) for op in body or ())
            per[key] = len(body) / marks if marks else "not measured"
            self.kernels[key].update(shape=shape, sass_slots_per_pair=per[key])
            dump.append(f"{key} ({stem}): {len(body or ())} instructions, {marks} FSETP\n"
                        + "\n".join(body or ()))
        if sass_text and not all(isinstance(v, float) for v in per.values()):
            raise AssertionError(f"contact sweep: no prefilter loop with FSETP in {per}")
        print("collision_roots loops: " + "\n\n".join(dump), file=sys.stderr)
        floor = issue_floor_ms(per["ROOTS"], shape["tiles"] * shape["tile"] ** 2)
        return (f"{line}, shape {shape}, SASS instructions a pair: parents "
                f"{fmt(per['ROOTS'])}, mark {fmt(per['MARK'])} (issue floor over the "
                f"{shape['tiles'] * shape['tile'] ** 2:,} pairs of the tiles: "
                f"{fmt(floor, 3, ' ms')})")

    def subset_record(self, lib, log: str) -> str:
        """The row subset's block shape and its j split at the main path's
        64 rows, with its registers and spills."""
        import ctypes

        from orbital_tpu_torch.ops.cuda_jerk import subset_plan

        fn = lib.nbody_jerk_subset_shape
        fn.restype, fn.argtypes = None, [ctypes.c_void_p]
        arr = (ctypes.c_int * 4)()
        fn(arr)
        rows, groups, tile, threads = list(arr)
        splits, split = subset_plan(N_MAIN, 64)
        self.kernels["B5S"]["shape"] = {"rows": rows, "groups": groups, "tile": tile,
                                        "threads": threads, "splits": splits, "split": split}
        return (f"B5S {rows} rows x {groups} groups over j ({threads} threads), {tile} "
                f"sources staged a round, at F=64: {splits} splits of {split} x "
                f"{-(-64 // rows)} row tiles = {splits * -(-64 // rows)} blocks, "
                + self.entry_record("B5S", "jerk_subset_kernel", log))

    # phase 3
    def check_forces(self) -> str:
        torch = self.torch
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda, pairwise_acc_plain

        rng = np.random.default_rng(self.seed + 1)
        worst = {}
        for n in (N_MAIN, N_RAGGED):
            pos = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=self.dev)
            mass = torch.tensor(rng.uniform(0.5, 1.5, n) / n, dtype=torch.float32,
                                device=self.dev)
            alive = torch.ones(n, dtype=torch.bool, device=self.dev)
            alive[-7:] = False
            for eps2 in (EPS2, 0.0):
                for pe in (True, False):
                    a, U = pairwise_acc_cuda(pos, mass, alive, G=1.0, eps2=eps2,
                                             with_potential=pe)
                    a0, U0 = pairwise_acc_plain(pos, mass, alive, G=1.0, eps2=eps2,
                                                with_potential=pe)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"B1 non-finite acc at N={n} eps2={eps2}")
                    abs_err = float((a - a0).abs().max())
                    rel = abs_err / float(a0.abs().max())
                    u_rel = abs(float(U) - float(U0)) / max(abs(float(U0)), 1e-30)
                    key = f"N={n},eps2={eps2:g},pe={int(pe)}"
                    worst[key] = (rel, u_rel)
                    if rel > FORCE_RTOL or (pe and u_rel > ENERGY_RTOL):
                        raise AssertionError(f"B1 vs plain {key}: max|da|/max|a| = "
                                             f"{rel:.3e}, |dU/U| = {u_rel:.3e}")
                    if not pe and float(U) != 0.0:
                        raise AssertionError("B1 with_potential=False must give U = 0")
                    if n == N_MAIN and eps2 > 0 and not pe:
                        self.kernels["B1"]["max_abs_err"] = abs_err
                        # both f32 sums against the same sum in f64
                        a64, _ = pairwise_acc_plain(pos.double(), mass.double(), alive,
                                                    G=1.0, eps2=eps2, with_potential=False)
                        scale = float(a64.abs().max())
                        vs64 = (float((a.double() - a64).abs().max()) / scale,
                                float((a0.double() - a64).abs().max()) / scale)
                        if vs64[0] > FORCE_RTOL:
                            raise AssertionError(f"B1 vs f64: {vs64[0]:.3e}")
        # the ds32 step on the kernel against the same step on plain forces
        step_err = self.step_vs_plain(8192, steps=10)
        if step_err > STATE_ATOL:
            raise AssertionError(f"ds32 step at N=8192: max state diff {step_err:.3e}")
        rels = ", ".join(f"{k}: {v[0]:.2e}/{v[1]:.2e}" for k, v in worst.items())
        return (f"B1 == plain within max|da|/max|a| <= {FORCE_RTOL:g} and |dU/U| <= "
                f"{ENERGY_RTOL:g} [{rels}]; N=65536 vs f64 sums: kernel {vs64[0]:.2e}, "
                f"plain {vs64[1]:.2e}; ds32 10-step N=8192 kernel vs plain "
                f"forces max diff {step_err:.2e} <= {STATE_ATOL:g}")

    def step_vs_plain(self, n: int, steps: int) -> float:
        import orbital_tpu_torch as ot

        rng = np.random.default_rng(self.seed + 2)
        pos = rng.normal(size=(n, 3))
        vel = rng.normal(size=(n, 3)) * 0.3
        mass = np.full(n, 1.0 / n)
        out = {}
        for impl in ("auto", "chunked"):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl=impl)
            st = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
            st = ot.init_forces(st, cfg)
            out[impl], _ = ot.rollout(st, cfg, steps, record_every=steps)
        return max_state_err(out["auto"], out["chunked"])

    # phase 4
    def check_fused(self) -> str:
        from orbital_tpu_torch.ops.fused_rollout import (_shape, fused_rollout,
                                                         fused_rollout_plain, launch_plan)

        lines = []
        for n, live, precision in FUSED_CASES.values():
            st, cfg = self.fused_state(n, live, precision)
            out = fused_rollout(st, cfg, 10)
            ref = fused_rollout_plain(st, cfg, 10)
            self.torch.cuda.synchronize()
            err = max_state_err(out, ref)
            if not bool(self.torch.isfinite(out.pos).all()) or err > STATE_ATOL:
                raise AssertionError(f"B4 vs plain N={n} {precision}: max diff {err:.3e}")
            if int(out.step) != 10 or abs(float(out.time) - 10 * DT) > 1e-9:
                raise AssertionError("B4 clock not advanced by 10 steps")
            if precision == "ds32" and n == N_FUSED_BIG:
                self.kernels["B4"]["max_abs_err"] = err
            plan = launch_plan(n, *_shape(self.dev))
            lines.append(f"N={n} ({live} live) {precision}: {err:.2e} (plan {plan})")
        return (f"B4 == plain KDK loop over 10 steps within {STATE_ATOL:g} "
                f"[{'; '.join(lines)}]")

    def fused_state(self, n: int, live: int, precision: str):
        """B4's scenes: ``live`` Gaussian bodies padded with dead ones to a
        multiple of n (unpadded when live == n), and the KDK config."""
        import orbital_tpu_torch as ot

        rng = np.random.default_rng(self.seed + 3)
        pos = rng.normal(size=(live, 3))
        vel = rng.normal(size=(live, 3)) * 0.3
        mass = rng.uniform(0.5, 1.5, live) / live
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2)
        return ot.make_state(pos, vel, mass, precision=precision, pad_to=n,
                             device=self.dev), cfg

    # phases 5 and 6
    def main_path(self) -> tuple[str, str]:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda
        from orbital_tpu_torch.ops.fused_rollout import fused_rollout
        from orbital_tpu_torch.utils import native

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, E0 = self.cluster()
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2)
        state = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
        small = make_cluster(4096, self.seed)
        state_small = ot.make_state(*small, precision="ds32", device=self.dev)

        reset_launches()

        state = ot.init_forces(state, cfg)
        rec, traj = ot.rollout(state, cfg, 20, record_every=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, none = ot.rollout(rec, cfg.replace(track_potential=False), self.drift_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        E1 = energy_f64(fin)
        drift = abs((E1 - E0) / E0)
        b1_main = pairwise_acc_cuda.launches

        small0 = ot.init_forces(state_small, cfg)
        e0_small = energy_f64(small0)
        fin_small, _ = ot.rollout(small0, cfg, 1000)
        torch.cuda.synchronize()
        drift_small = abs((energy_f64(fin_small) - e0_small) / e0_small)

        self.kernels["B1"]["launches"] = pairwise_acc_cuda.launches
        self.kernels["B4"]["launches"] = fused_rollout.launches

        if traj is None or tuple(traj.pos.shape) != (2, n, 3) or none is not None:
            raise AssertionError("recorded rollout returned the wrong records")
        e_rec = traj.energy.double().cpu().numpy()
        if not (np.isfinite(e_rec).all() and bool(torch.isfinite(fin.pos).all())):
            raise AssertionError("non-finite state or energy records")
        if np.max(np.abs(e_rec / E0 - 1.0)) > ENERGY_RTOL:
            raise AssertionError(f"recorded f32 energies {e_rec} stray from E0 = {E0}")
        if int(fin.step) != 20 + self.drift_steps:
            raise AssertionError("step counter wrong")
        if b1_main < 1 + 20 + self.drift_steps:
            raise AssertionError(f"B1 launched {b1_main} times on the 65536 path")
        if fused_rollout.launches < 1:
            raise AssertionError("the N=4096 unrecorded rollout did not launch B4")
        if drift > DRIFT_BUDGET or drift_small > DRIFT_BUDGET:
            raise AssertionError(f"energy drift {drift:.3e} (N=65536) / "
                                 f"{drift_small:.3e} (N=4096) over budget {DRIFT_BUDGET:g}")
        ms_per_step = 1e3 * wall / self.drift_steps
        self.main_ms_per_step = ms_per_step
        line5 = (f"N=65536 ds32: init_forces + 20 recorded + {self.drift_steps} unrecorded "
                 f"steps, |dE/E| = {drift:.3e} <= {DRIFT_BUDGET:g} (f64, {native.backend()}); "
                 f"{ms_per_step:.3f} ms/step wall; B1 launches {b1_main}")
        line6 = (f"N=4096 ds32 unrecorded 1000 steps: |dE/E| = {drift_small:.3e}; "
                 f"B4 launches {fused_rollout.launches}")
        return line5, line6

    def scene(self, n: int, radius: float, dead: int, seed_offset: int,
              cluster: bool = True):
        """Cluster positions and velocities (Gaussian ones below N_MAIN or
        without ``cluster``) with radii in [R/2, 3R/2] and ``dead`` bodies at
        the end, parked far as make_state parks padding: f32 tensors (pos,
        vel, mass, radius, alive) on the card."""
        from orbital_tpu_torch.engine.state import far_positions

        torch = self.torch
        rng = np.random.default_rng(self.seed + seed_offset)
        if n == N_MAIN and cluster:
            pos, vel, mass, _ = self.cluster()
            pos, vel = pos.copy(), vel.copy()
        else:
            pos, vel, mass = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.3, \
                np.full(n, 1.0 / n)
        rad = radius * rng.uniform(0.5, 1.5, n)
        alive = np.ones(n, bool)
        if dead:
            alive[-dead:] = False
            pos[-dead:] = far_positions(dead, float(np.abs(pos).max()), np.float32,
                                        start=n - dead)

        def t(a, dtype=torch.float32):
            return torch.tensor(a, dtype=dtype, device=self.dev)

        return t(pos), t(vel), t(mass), t(rad), t(alive, torch.bool)

    # phase 7
    def check_detect(self) -> str:
        torch = self.torch
        from orbital_tpu_torch.ops.cuda_forces import (pairwise_acc_cuda,
                                                       pairwise_acc_detect_cuda,
                                                       pairwise_acc_detect_plain)

        lines = []
        for n, radius, dead in ((N_MAIN, R_RICH, 7), (N_RAGGED, R_RAGGED, 7), (N_MAIN, R_BENCH, 0)):
            pos, _, mass, rad, alive = self.scene(n, radius, dead, seed_offset=5)
            for eps2 in (EPS2, 0.0):
                a0, U0, c0 = pairwise_acc_detect_plain(pos, mass, rad, alive, G=1.0,
                                                       eps2=eps2, with_potential=True)
                for pe in (True, False):
                    a, U, c = pairwise_acc_detect_cuda(pos, mass, rad, alive, G=1.0,
                                                       eps2=eps2, with_potential=pe)
                    a1, U1 = pairwise_acc_cuda(pos, mass, alive, G=1.0, eps2=eps2,
                                               with_potential=pe)
                    torch.cuda.synchronize()
                    key = f"N={n},R={radius:g},eps2={eps2:g},pe={int(pe)}"
                    if c.dtype != torch.int32 or c.device != pos.device or c.ndim != 0:
                        raise AssertionError(f"B2 count is not an int32 on the card: {c}")
                    count, count0 = int(c), int(c0)
                    if count != count0:
                        raise AssertionError(f"B2 {key}: {count} contacts, plain {count0}")
                    if (radius == R_BENCH) != (count == 0):
                        raise AssertionError(f"B2 {key}: {count} contacts")
                    if not (torch.equal(a, a1) and torch.equal(U, U1)):
                        raise AssertionError(f"B2 {key}: acc or U differs from B1's")
                    abs_err = float((a - a0).abs().max())
                    rel = abs_err / float(a0.abs().max())
                    u_rel = abs(float(U) - float(U0)) / abs(float(U0))
                    if rel > FORCE_RTOL or (pe and u_rel > ENERGY_RTOL):
                        raise AssertionError(f"B2 vs plain {key}: max|da|/max|a| = "
                                             f"{rel:.3e}, |dU/U| = {u_rel:.3e}")
                    if not pe and float(U) != 0.0:
                        raise AssertionError("B2 with_potential=False must give U = 0")
                    if n == N_MAIN and radius == R_RICH and eps2 > 0 and not pe:
                        self.kernels["B2"]["max_abs_err"] = abs_err
                        self.rich_contacts = count
                    if not pe:
                        lines.append(f"{key}: {count} contacts, {rel:.2e}")
        return (f"B2 == plain: contacts exactly, max|da|/max|a| <= {FORCE_RTOL:g}, "
                f"|dU/U| <= {ENERGY_RTOL:g}; acc and U bit-equal to B1's "
                f"[{'; '.join(lines)}]; contact-rich N={N_MAIN} at t=0: "
                f"{self.rich_contacts} directed = {self.rich_contacts // 2} pairs")

    # phase 8
    def check_bounce(self) -> str:
        torch = self.torch
        from orbital_tpu_torch.ops.collisions import bounce_deltas_chunked
        from orbital_tpu_torch.ops.cuda_collisions import bounce_deltas_cuda
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_detect_cuda

        # the contact-rich cluster, and a ragged N = 5000 (40 tiles of 128,
        # the last partial, a third dead, radii in [R/2, 3R/2]): the
        # prefilter's tile maximum and the tail tile
        lines = []
        for n, radius, dead in ((N_MAIN, R_RICH, 7), (N_RAGGED, R_RAGGED, N_RAGGED // 3)):
            pos, vel, mass, rad, alive = self.scene(n, radius, dead, seed_offset=5)
            _, _, count = pairwise_acc_detect_cuda(pos, mass, rad, alive, G=1.0, eps2=EPS2,
                                                   with_potential=False)
            dp, dv = bounce_deltas_cuda(pos, vel, mass, rad, alive, restitution=0.8)
            dp_c, dv_c = bounce_deltas_cuda(pos, vel, mass, rad, alive, restitution=0.8,
                                            contacts=count)
            zero = torch.zeros((), dtype=torch.int32, device=self.dev)
            dp_z, dv_z = bounce_deltas_cuda(pos, vel, mass, rad, alive, restitution=0.8,
                                            contacts=zero)
            dp0, dv0 = bounce_deltas_chunked(pos, vel, mass, rad, alive, restitution=0.8)
            torch.cuda.synchronize()
            key = f"N={n} R={radius:g} ({dead} dead)"
            touched = int((dv0.abs().amax(1) > 0).sum())
            if int(count) <= 0 or touched == 0:
                raise AssertionError(f"B6 {key}: no contacts in the scene ({int(count)})")
            err_v = float((dv - dv0).abs().max())
            err_p = float((dp - dp0).abs().max())
            rel_v, rel_p = err_v / float(dv0.abs().max()), err_p / float(dp0.abs().max())
            if rel_v > BOUNCE_RTOL or rel_p > BOUNCE_RTOL:
                raise AssertionError(f"B6 vs plain {key}: max|d dv|/max|dv| = {rel_v:.3e}, "
                                     f"max|d dp|/max|dp| = {rel_p:.3e}")
            dead_rows = ~alive
            if bool(dv[dead_rows].any()) or bool(dp[dead_rows].any()):
                raise AssertionError(f"B6 {key}: dead rows not exactly 0")
            m = mass.double()[:, None]
            p_sum = float((m * dv.double()).sum(0).abs().max())
            p_abs = float((m * dv.double().abs()).sum())
            if p_sum > 1e-5 * p_abs:
                raise AssertionError(f"B6 {key} momentum: |sum m dv| = {p_sum:.3e} against "
                                     f"sum m |dv| = {p_abs:.3e}")
            if not (torch.equal(dv_c, dv) and torch.equal(dp_c, dp)):
                raise AssertionError(f"B6 {key}: gated on a count > 0 differs from the "
                                     f"ungated sweep")
            if bool(dv_z.any()) or bool(dp_z.any()):
                raise AssertionError(f"B6 {key}: with a zero count it is not exactly 0")
            if n == N_MAIN:
                self.kernels["B6"]["max_abs_err"] = err_v
            lines.append(f"{key}, e=0.8: {int(count)} contacts, {touched} bodies bounced, "
                         f"max|d dv|/max|dv| = {rel_v:.2e}, max|d dp|/max|dp| = {rel_p:.2e}, "
                         f"|sum m dv| / sum m|dv| = {p_sum / p_abs:.2e}")
        return (f"B6 == plain within {BOUNCE_RTOL:g}, dead rows 0, momentum kept, gated on "
                f"the count == ungated, zero count -> exact zeros [{'; '.join(lines)}]")

    # phase 9
    def bounce_bench_row(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_force_detect_fn, resolve_force_fn
        from orbital_tpu_torch.ops.cuda_collisions import bounce_deltas_cuda
        from orbital_tpu_torch.ops.cuda_forces import (pairwise_acc_cuda,
                                                       pairwise_acc_detect_cuda)

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, E0 = self.cluster()
        radius = np.full(n, R_BENCH)
        runs = {}
        for mode in ("bounce", "none"):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, collisions=mode, restitution=1.0)
            state = ot.make_state(pos, vel, mass, radius, precision="ds32", device=self.dev)
            resolve = resolve_force_detect_fn if mode == "bounce" else resolve_force_fn
            log = StepLog(resolve(cfg, n, self.dev), keep_pos=True, keep_counts=True)
            hook = dict(force_detect_fn=log) if mode == "bounce" else dict(force_fn=log)
            if mode == "bounce":
                _, _, c0 = pairwise_acc_detect_cuda(state.pos, state.mass, state.radius,
                                                    state.alive, G=1.0, eps2=EPS2)
                contacts0 = int(c0)
                reset_launches()
            state = ot.init_forces(state, cfg)
            rec, _ = ot.rollout(state, cfg, 20, record_every=10, fused="never", **hook)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg = cfg.replace(track_potential=False)
            log.fn = resolve(cfg, n, self.dev)
            fin, _ = ot.rollout(rec, cfg, self.drift_steps, fused="never", **hook)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if mode == "bounce":
                launches = (pairwise_acc_cuda.launches, pairwise_acc_detect_cuda.launches,
                            bounce_deltas_cuda.launches)
            runs[mode] = (fin, 1e3 * wall / self.drift_steps, log)
        (fin, ms_bounce, log), (other, ms_none, log_none) = runs["bounce"], runs["none"]
        drift = abs((energy_f64(fin) - E0) / E0)
        b1, b2, b6 = launches
        self.kernels["B2"]["launches"] = b2
        self.kernels["B6"]["launches"] = b6
        steps = 20 + self.drift_steps
        counts = torch.stack(log.counts).cpu().numpy()
        hit = [int(k) + 1 for k in np.flatnonzero(counts)]  # steps with contacts, from 1
        if contacts0 != 0:
            raise AssertionError(f"bench row: {contacts0} contacts at t=0")
        if b2 != steps or b6 != steps or b1 != 1:
            raise AssertionError(f"bench row launches: B1 {b1}, B2 {b2}, B6 {b6}")
        if drift > DRIFT_BUDGET or not bool(torch.isfinite(fin.pos).all()):
            raise AssertionError(f"bench row drift {drift:.3e} over budget {DRIFT_BUDGET:g}")
        # every step before the first contact is bit-equal to the
        # collision-free run (a bounce at the end of step k first shows in
        # the positions of step k + 1); without contacts, the whole run is
        differ = next((k + 1 for k, (a, b) in enumerate(zip(log.positions,
                                                             log_none.positions))
                       if not torch.equal(a, b)), None)
        if hit:
            if differ is not None and differ <= hit[0]:
                raise AssertionError(f"bench row: positions differ from the collision-free "
                                     f"run at step {differ}, before the first contact "
                                     f"(step {hit[0]})")
            same = f"bit-equal to collisions='none' through step {hit[0]}"
        else:
            if differ is not None:
                raise AssertionError(f"bench row: positions differ at step {differ}")
            for f in ("pos", "pos_lo", "vel", "vel_lo", "acc", "potential", "step"):
                if not torch.equal(getattr(fin, f), getattr(other, f)):
                    raise AssertionError(f"bench row: final {f} differs from the "
                                         "collision-free run")
            same = "final state bit-equal to collisions='none'"
        self.bench_row = dict(contacts=int(counts.sum()), steps_hit=hit, first_diff=differ)
        return (f"N={n} ds32 bounce R={R_BENCH:g} e=1: init_forces + 20 recorded + "
                f"{self.drift_steps} unrecorded steps; contacts 0 at t=0, "
                f"{int(counts.sum())} over the run on steps {hit}; {same} (positions first "
                f"differ at step {differ}); |dE/E| = {drift:.3e} <= {DRIFT_BUDGET:g}; "
                f"{ms_bounce:.3f} ms/step wall armed vs {ms_none:.3f} without; launches "
                f"B1 {b1}, B2 {b2}, B6 {b6}")

    # phase 10
    def bounce_contact_rich(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_force_detect_fn
        from orbital_tpu_torch.ops.cuda_collisions import bounce_deltas_cuda
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_detect_cuda

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, _ = self.cluster()
        radius = np.full(n, R_RICH)
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, collisions="bounce", restitution=0.8,
                           track_potential=False)
        state = ot.make_state(pos, vel, mass, radius, precision="ds32", device=self.dev)
        _, _, c0 = pairwise_acc_detect_cuda(state.pos, state.mass, state.radius,
                                            state.alive, G=1.0, eps2=EPS2,
                                            with_potential=False)
        contacts0 = int(c0)
        if contacts0 < 20:
            raise AssertionError(f"contact-rich: only {contacts0} directed contacts at t=0")

        reset_launches()
        tally = StepLog(resolve_force_detect_fn(cfg, n, self.dev))
        start = ot.init_forces(state, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, _ = ot.rollout(start, cfg, 200, force_detect_fn=tally)
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.perf_counter() - t0) / 200
        b2, b6 = pairwise_acc_detect_cuda.launches, bounce_deltas_cuda.launches
        steps_hit, total = int(tally.steps), int(tally.total)
        if b2 != 200 or b6 != 200 or steps_hit == 0:
            raise AssertionError(f"contact-rich: B2 {b2}, B6 {b6} launches, contacts on "
                                 f"{steps_hit} steps")
        if not (bool(torch.isfinite(fin.pos).all()) and bool(torch.isfinite(fin.vel).all())):
            raise AssertionError("contact-rich: non-finite state")
        moved = float((fin.vel_full() - ot.rollout(
            ot.init_forces(state, cfg.replace(collisions="none")),
            cfg.replace(collisions="none"), 200, fused="never")[0].vel_full()).abs().max())
        if moved == 0.0:
            raise AssertionError("contact-rich: the bounces changed nothing")

        # the first 10 steps, one at a time, on the kernels and on the plain
        # forces, counts and bounce sweep
        runs = {}
        for impl in ("auto", "chunked"):
            c = cfg.replace(force_impl=impl)
            tally = StepLog(resolve_force_detect_fn(c, n, self.dev), keep_counts=True)
            with plain_bounce() if impl == "chunked" else contextlib.nullcontext():
                s = ot.init_forces(state, c)
                states = []
                for _ in range(10):
                    s, _ = ot.rollout(s, c, 1, force_detect_fn=tally)
                    states.append(s)
                torch.cuda.synchronize()
            runs[impl] = (states, [int(x) for x in tally.counts])
        (k_states, k_counts), (p_states, p_counts) = runs["auto"], runs["chunked"]
        gates = [(a > 0) == (b > 0) for a, b in zip(k_counts, p_counts)]
        upto = gates.index(False) if False in gates else 10
        note = "gate decisions agree on all 10 steps"
        if upto < 10:
            note = (f"a grazing pair flips the gate at step {upto + 1} (counts "
                    f"{k_counts[upto]} vs {p_counts[upto]}): compared at step {upto}")
        if upto == 0:
            raise AssertionError(f"contact-rich: gates differ at step 1 ({note})")
        err = max_state_err(k_states[upto - 1], p_states[upto - 1])
        if err > STATE_ATOL:
            raise AssertionError(f"contact-rich: kernels vs plain after {upto} steps: "
                                 f"{err:.3e} > {STATE_ATOL:g}")
        return (f"N={N_MAIN} ds32 bounce R={R_RICH:g} e=0.8: {contacts0} directed contacts "
                f"at t=0 ({contacts0 // 2} pairs); 200 steps at {ms_step:.3f} ms/step wall, "
                f"contacts > 0 on {steps_hit} of them ({total} summed), launches B2 {b2}, "
                f"B6 {b6}, finite, bounces moved "
                f"max|dv| {moved:.2e} against the collision-free run; kernels vs plain "
                f"over {upto} steps max diff {err:.2e} <= {STATE_ATOL:g} ({note}; counts "
                f"kernel {k_counts} plain {p_counts})")

    # phase 11
    def timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_collisions import bounce_deltas_cuda, bounce_deltas_plain
        from orbital_tpu_torch.ops.cuda_forces import (pairwise_acc_cuda,
                                                       pairwise_acc_detect_cuda,
                                                       pairwise_acc_detect_plain,
                                                       pairwise_acc_plain)
        from orbital_tpu_torch.ops.fused_rollout import fused_rollout, fused_rollout_plain

        torch = self.torch
        rng = np.random.default_rng(self.seed + 4)
        n = N_MAIN
        pos = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=self.dev)
        mass = torch.full((n,), 1.0 / n, dtype=torch.float32, device=self.dev)
        alive = torch.ones(n, dtype=torch.bool, device=self.dev)
        b1 = summary(time_ms(lambda: pairwise_acc_cuda(
            pos, mass, alive, G=1.0, eps2=EPS2, with_potential=False), 20))
        b1p = summary(time_ms(lambda: pairwise_acc_plain(
            pos, mass, alive, G=1.0, eps2=EPS2, with_potential=False), 2))
        b1pe = summary(time_ms(lambda: pairwise_acc_cuda(
            pos, mass, alive, G=1.0, eps2=EPS2, with_potential=True), 20))

        def stepper(impl, n_):
            pos_, vel_, mass_ = (rng.normal(size=(n_, 3)), rng.normal(size=(n_, 3)) * 0.3,
                                 np.full(n_, 1.0 / n_))
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl=impl,
                               track_potential=False)
            st = ot.init_forces(ot.make_state(pos_, vel_, mass_, precision="ds32",
                                              device=self.dev), cfg)
            return st, cfg

        st, cfg = stepper("auto", n)
        step_k = summary([t / 10 for t in time_ms(lambda: ot.rollout(st, cfg, 10), 1)])
        st_p, cfg_p = stepper("chunked", n)
        step_p = summary([t / 2 for t in time_ms(lambda: ot.rollout(st_p, cfg_p, 2), 1)])

        # per step, each run including its one seeding force sweep; B4 in
        # turns with the step loop it stands in for (rollout(fused="never"):
        # the dense plain step at N <= 4096, B1's above)
        fused, loop = {}, {}
        for n_f in FUSED_TURNS:
            k_steps = 200 if n_f <= 8192 else 20
            st_f, cfg_f = stepper("auto", n_f)
            turns = alternate_ms({
                "B4": lambda: fused_rollout(st_f, cfg_f, k_steps),
                "loop": lambda: ot.rollout(st_f, cfg_f, k_steps, fused="never")}, 1,
                repeats=4)
            kern = summary([t / k_steps for t in turns["B4"]])
            loop[n_f] = summary([t / k_steps for t in turns["loop"]])
            if n_f in (N_FUSED, N_FUSED_BIG):
                p_steps = 50 if n_f == N_FUSED else 10
                plain = summary([t / p_steps for t in time_ms(
                    lambda: fused_rollout_plain(st_f, cfg_f, p_steps), 1)])
                fused[n_f] = (kern, plain)
            else:
                fused[n_f] = (kern, None)

        # B2 on B1's inputs with the bench row's radius (no contacts)
        rad = torch.full((n,), R_BENCH, dtype=torch.float32, device=self.dev)
        b2 = summary(time_ms(lambda: pairwise_acc_detect_cuda(
            pos, mass, rad, alive, G=1.0, eps2=EPS2, with_potential=False), 20))
        b2p = summary(time_ms(lambda: pairwise_acc_detect_plain(
            pos, mass, rad, alive, G=1.0, eps2=EPS2, with_potential=False), 1))

        # B6 on the contact-rich cluster, with the count B2 gives it and with 0
        pos6, vel6, mass6, rad6, alive6 = self.scene(n, R_RICH, 0, seed_offset=5)
        _, _, count6 = pairwise_acc_detect_cuda(pos6, mass6, rad6, alive6, G=1.0,
                                                eps2=EPS2, with_potential=False)
        touching = int(count6)
        zero = torch.zeros((), dtype=torch.int32, device=self.dev)

        def b6_call(contacts, fn=bounce_deltas_cuda):
            return lambda: fn(pos6, vel6, mass6, rad6, alive6, restitution=0.8,
                              contacts=contacts)

        b6 = summary(time_ms(b6_call(count6), 20))
        b6z = summary(time_ms(b6_call(zero), 200))
        b6p = summary(time_ms(b6_call(count6, bounce_deltas_plain), 1))

        # the ds32 step at N = 65,536 with bounce armed (the bench row: no
        # contacts) against the same step without collisions, in turns
        pos_c, vel_c, mass_c, _ = self.cluster()
        armed = {}
        for mode in ("none", "bounce"):
            cfg_c = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, collisions=mode,
                                 track_potential=False)
            st_c = ot.init_forces(ot.make_state(pos_c, vel_c, mass_c, np.full(n, R_BENCH),
                                                precision="ds32", device=self.dev), cfg_c)
            armed[mode] = (lambda s_, c_: lambda: ot.rollout(s_, c_, 10, fused="never"))(
                st_c, cfg_c)
        armed = {k: summary([t / 10 for t in v])
                 for k, v in alternate_ms(armed, 1, repeats=3).items()}

        def b4_bound(n_f, steps):  # a step: the state read once, written once a launch
            state_bytes = (12 + 2) * 4 * n_f + 12 * 4 * n_f
            return bound(OPS_B1 * n_f * n_f, state_bytes / steps, rsqrt=n_f * n_f)

        bounds = {
            "B1": bound(OPS_B1 * n * n, 32 * n, rsqrt=n * n),
            "B2": bound(OPS_B2 * n * n, 36 * n + 4, rsqrt=n * n),
            "B4": b4_bound(N_FUSED, 200),
            "B6": bound(OPS_B6 * n * n + OPS_B6_TOUCH * touching, 57 * n + 4),
        }
        bound_b4_big = b4_bound(N_FUSED_BIG, 20)
        bound_b6_zero = bound(0.0, 24 * n + 4)
        timed = {"B1": (b1, b1p), "B2": (b2, b2p), "B4": fused[N_FUSED], "B6": (b6, b6p)}
        for k, (kern, plain) in timed.items():
            self.kernels[k].update(ms=kern["median"], plain_ms=plain["median"],
                                   bound_ms=bounds[k][0], bound_by=bounds[k][1],
                                   library_ms=None)
        self.perf = {"B1_nope_N65536": (b1, b1p), "B1_pe_N65536": b1pe,
                     "ds32_step_N65536": (step_k, step_p),
                     **{f"B4_N{k}": v for k, v in fused.items()},
                     **{f"step_loop_N{k}": v for k, v in loop.items()},
                     "B4_bound_N32768_ms": bound_b4_big, "B2_nope_N65536": (b2, b2p),
                     "B6_N65536_contacts": (b6, b6p), "B6_N65536_count0": b6z,
                     "B6_bound_count0_ms": bound_b6_zero[0], "B6_touching": touching,
                     "ds32_step_N65536_none_vs_bounce": (armed["none"], armed["bounce"]),
                     "bounds_ms": bounds}
        print("perf " + json.dumps(self.perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        b4 = "; ".join(
            f"B4 N={k} {ms(v[0])}/step vs the step loop {ms(loop[k])}/step "
            f"({loop[k]['median'] / v[0]['median']:.2f}x)"
            + ("" if v[1] is None else f", plain {ms(v[1])}/step") for k, v in fused.items())
        return (f"B1 N=65536 no-PE {ms(b1)} vs plain {ms(b1p)}; PE {ms(b1pe)}; "
                f"ds32 step N=65536 {step_k['median']:.3f} vs plain "
                f"{step_p['median']:.3f} ms/step; {b4} (in turns, 4 runs each); B4 bound "
                f"N={N_FUSED_BIG} {bound_b4_big[0]:.4f} ms/step; B2 N=65536 no-PE {ms(b2)} vs "
                f"plain {ms(b2p)}; B6 N=65536 {touching} contacts {ms(b6)}, count 0 {ms(b6z)}, "
                f"plain {ms(b6p)}; ds32 step N=65536 without collisions "
                f"{ms(armed['none'])}, bounce armed {ms(armed['bounce'])}; bounds "
                + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bounds.items()))

    # phase 12
    def check_jerk(self) -> str:
        torch = self.torch
        from orbital_tpu_torch.ops.collisions import count_contacts_chunked
        from orbital_tpu_torch.ops.cuda_jerk import (accel_jerk_cuda, accel_jerk_detect_cuda,
                                                     accel_jerk_plain, accel_jerk_subset_cuda,
                                                     accel_jerk_subset_plain)

        def rel(x, ref):
            return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())

        lines = []
        for n, radius in ((N_MAIN, R_RICH), (N_RAGGED, R_RAGGED)):
            pos, vel, mass, rad, alive = self.scene(n, radius, 7, seed_offset=6)
            for eps2 in (EPS2, 0.0):
                kw = dict(G=1.0, eps2=eps2)
                a, j, U = accel_jerk_cuda(pos, vel, mass, alive, **kw)
                ad, jd, Ud, c = accel_jerk_detect_cuda(pos, vel, mass, rad, alive, **kw)
                a0, j0, U0 = accel_jerk_plain(pos, vel, mass, alive, **kw)
                c0 = count_contacts_chunked(pos, rad, alive)
                torch.cuda.synchronize()
                key = f"N={n},eps2={eps2:g}"
                if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(j).all())):
                    raise AssertionError(f"B5 non-finite acc or jerk at {key}")
                ra, rj = rel(a, a0), rel(j, j0)
                ru = abs(float(U) - float(U0)) / abs(float(U0))
                if ra > FORCE_RTOL or rj > JERK_RTOL or ru > ENERGY_RTOL:
                    raise AssertionError(f"B5 vs plain {key}: acc {ra:.3e}, jerk {rj:.3e}, "
                                         f"U {ru:.3e}")
                if c.dtype != torch.int32 or c.ndim != 0 or c.device != pos.device:
                    raise AssertionError(f"B5 detect count is not an int32 on the card: {c}")
                if int(c) != int(c0):
                    raise AssertionError(f"B5 detect {key}: {int(c)} contacts, plain {int(c0)}")
                if not (torch.equal(a, ad) and torch.equal(j, jd) and torch.equal(U, Ud)):
                    raise AssertionError(f"B5 detect {key}: acc, jerk or U differ from B5's")
                lines.append(f"{key}: acc {ra:.2e}, jerk {rj:.2e}, U {ru:.2e}, "
                             f"{int(c)} contacts")
                if n == N_MAIN and eps2 > 0:
                    err = max(float((a - a0).abs().max()), float((j - j0).abs().max()))
                    self.kernels["B5"]["max_abs_err"] = err
                    self.kernels["B5D"]["max_abs_err"] = err
                    # both f32 sums against the same sum in f64
                    a64, j64, _ = accel_jerk_plain(pos.double(), vel.double(), mass.double(),
                                                   alive, chunk=512, **kw)
                    vs64 = {"acc": (rel(a, a64), rel(a0, a64)),
                            "jerk": (rel(j, j64), rel(j0, j64))}
                    if vs64["acc"][0] > FORCE_RTOL or vs64["jerk"][0] > JERK_RTOL:
                        raise AssertionError(f"B5 vs f64: {vs64}")
                    del a64, j64
        # the row-subset variant against the plain subset, one dead row among
        # the targets
        pos, vel, mass, _, alive = self.scene(N_MAIN, R_RICH, 7, seed_offset=6)
        rng = np.random.default_rng(self.seed + 7)
        sub = []
        for f in (64, 37):
            idx = torch.tensor(rng.choice(N_MAIN - 7, f, replace=False), device=self.dev)
            idx[-1] = N_MAIN - 1
            for eps2 in (EPS2, 0.0):
                a, j = accel_jerk_subset_cuda(idx, pos, vel, mass, alive, G=1.0, eps2=eps2)
                a0, j0 = accel_jerk_subset_plain(idx, pos, vel, mass, alive, G=1.0, eps2=eps2)
                torch.cuda.synchronize()
                ra, rj = rel(a, a0), rel(j, j0)
                if tuple(a.shape) != (f, 3) or ra > FORCE_RTOL or rj > JERK_RTOL:
                    raise AssertionError(f"B5 subset F={f} eps2={eps2:g}: acc {ra:.3e}, "
                                         f"jerk {rj:.3e}")
                if f == 64 and eps2 > 0:
                    self.kernels["B5S"]["max_abs_err"] = max(
                        float((a - a0).abs().max()), float((j - j0).abs().max()))
                sub.append(f"F={f},eps2={eps2:g}: {ra:.2e}/{rj:.2e}")
        f64 = ", ".join(f"{k} kernel {v[0]:.2e} plain {v[1]:.2e}" for k, v in vs64.items())
        return (f"B5 == plain within max|da|/max|a| <= {FORCE_RTOL:g}, max|dj|/max|j| <= "
                f"{JERK_RTOL:g}, |dU/U| <= {ENERGY_RTOL:g} [{'; '.join(lines)}]; B5 detect: "
                f"counts exact, acc/jerk/U bit-equal to B5's; N=65536 vs f64 sums: {f64}; "
                f"B5 subset == plain [{'; '.join(sub)}]")

    # phase 13
    def hermite_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_accel_jerk_fn
        from orbital_tpu_torch.ops.cuda_jerk import accel_jerk_cuda
        from orbital_tpu_torch.utils import native

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, E0 = self.cluster()
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, integrator="hermite")
        state = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
        # the evaluated positions of every step, for phase 16's comparison
        log = StepLog(resolve_accel_jerk_fn(cfg, n, self.dev), keep_pos=True)

        reset_launches()
        state = ot.init_forces(state, cfg)
        rec, traj = ot.rollout(state, cfg, 20, record_every=10, accel_jerk_fn=log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, _ = ot.rollout(rec, cfg, self.drift_steps, accel_jerk_fn=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b5 = accel_jerk_cuda.launches

        drift = abs((energy_f64(fin) - E0) / E0)
        e_rec = traj.energy.double().cpu().numpy()
        if tuple(traj.pos.shape) != (2, n, 3) or fin.jerk is None:
            raise AssertionError("Hermite: wrong records or no jerk cache")
        if not (np.isfinite(e_rec).all() and bool(torch.isfinite(fin.pos).all())):
            raise AssertionError("Hermite: non-finite state or energy records")
        if np.max(np.abs(e_rec / E0 - 1.0)) > ENERGY_RTOL:
            raise AssertionError(f"Hermite recorded f32 energies {e_rec} stray from E0 = {E0}")
        steps = 20 + self.drift_steps
        # the f32 clock rounds each addition by at most half an ulp of its value
        clock_tol = steps * float(np.spacing(np.float32(steps * DT)))
        if int(fin.step) != steps or abs(float(fin.time) - steps * DT) > clock_tol:
            raise AssertionError(f"Hermite step counter {int(fin.step)} or clock "
                                 f"{float(fin.time)} wrong after {steps} steps")
        if b5 != 1 + steps:
            raise AssertionError(f"B5 launched {b5} times in {steps} Hermite steps + init")
        if drift > DRIFT_BUDGET:
            raise AssertionError(f"Hermite energy drift {drift:.3e} over {DRIFT_BUDGET:g}")
        self.kernels["B5"]["launches"] = b5
        self.hermite_log = log
        return (f"N=65536 ds32 Hermite dt={DT:g}: init_forces + 20 recorded + "
                f"{self.drift_steps} unrecorded steps, |dE/E| = {drift:.3e} <= "
                f"{DRIFT_BUDGET:g} (f64, {native.backend()}); "
                f"{1e3 * wall / self.drift_steps:.3f} ms/step wall; B5 launches {b5}")

    # phase 14
    def hermite_adaptive(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_jerk import accel_jerk_cuda

        torch = self.torch
        pos, vel, mass, E0 = self.cluster()
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, integrator="hermite",
                           adaptive_eta=ETA_ADAPTIVE, dt_min=DT / 4096)
        state = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
        reset_launches()
        state = ot.init_forces(state, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, traj = ot.rollout(state, cfg, ADAPTIVE_STEPS, record_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b5 = accel_jerk_cuda.launches
        # the steps taken, from the recorded f32 clock (its rounding is
        # ~3e-8 here, against steps of ~1e-4)
        clock = traj.time.double().cpu().numpy()
        steps_dt = np.diff(np.concatenate([[0.0], clock]))
        drift = abs((energy_f64(fin) - E0) / E0)
        lo, med, hi = steps_dt.min(), float(np.median(steps_dt)), steps_dt.max()
        if b5 != 1 + ADAPTIVE_STEPS:
            raise AssertionError(f"adaptive Hermite: B5 launched {b5} times")
        if not (bool(torch.isfinite(fin.pos).all()) and fin.time.ndim == 0):
            raise AssertionError("adaptive Hermite: non-finite state")
        if not (DT / 4096 * (1 - 1e-3) <= lo and hi <= DT * (1 + 1e-3) and lo < DT):
            raise AssertionError(f"adaptive Hermite: steps [{lo:.3e}, {hi:.3e}] outside "
                                 f"[dt_min, dt] or never below dt")
        if drift > DRIFT_BUDGET:
            raise AssertionError(f"adaptive Hermite drift {drift:.3e} over {DRIFT_BUDGET:g}")
        return (f"N=65536 ds32 Hermite adaptive_eta={ETA_ADAPTIVE:g}, dt_min=dt/4096: "
                f"{ADAPTIVE_STEPS} steps to t = {clock[-1]:.6f}, dt min {lo:.4e} median "
                f"{med:.4e} max {hi:.4e}; |dE/E| = {drift:.3e}; "
                f"{1e3 * wall / ADAPTIVE_STEPS:.3f} ms/step wall (records every step); "
                f"B5 launches {b5}")

    def block_scene(self):
        """The cluster with its last two bodies replaced by a hard circular
        binary (each BINARY_MASS, separation BINARY_SEP) moving with the
        first one's velocity."""
        pos, vel, mass, _ = self.cluster()
        pos, vel, mass = pos.copy(), vel.copy(), mass.copy()
        center, drift = pos[-2].copy(), vel[-2].copy()
        v = 0.5 * np.sqrt(2.0 * BINARY_MASS / BINARY_SEP)
        pos[-2:] = center + np.array([[-0.5, 0, 0], [0.5, 0, 0]]) * BINARY_SEP
        vel[-2:] = drift + np.array([[0, -v, 0], [0, v, 0]])
        mass[-2:] = BINARY_MASS
        return pos, vel, mass

    def block_config(self, rungs: int):
        import orbital_tpu_torch as ot

        return ot.SimConfig(dt=DT, G=1.0, eps2=EPS2_BLOCK, integrator="hermite",
                            adaptive_eta=ETA_BLOCK, dt_min=DT / 4096, hermite_fast_cap=64,
                            hermite_max_substeps=64, hermite_rungs=rungs)

    # phase 15
    def block_timesteps(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.integrators import block_plan
        from orbital_tpu_torch.ops.cuda_jerk import accel_jerk_cuda, accel_jerk_subset_cuda

        torch = self.torch
        pos, vel, mass = self.block_scene()
        lines, subset_total = [], 0
        for rungs in (1, 3):
            cfg = self.block_config(rungs)
            runs = {}
            for impl in ("auto", "chunked"):  # the kernels, then the plain versions
                c = cfg.replace(force_impl=impl)
                st = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
                if impl == "auto":
                    reset_launches()
                st = ot.init_forces(st, c)
                plans, states, walls = [], [], []
                for _ in range(BLOCK_MACRO_STEPS):
                    idx, fast, m = block_plan(st, c)
                    q = torch.sqrt(torch.linalg.vector_norm(st.acc, dim=-1)
                                   / torch.linalg.vector_norm(st.jerk, dim=-1))
                    under = int((ETA_BLOCK * q < DT).sum())  # all bodies under dt
                    plans.append((int(fast.sum()), m, idx.cpu(), under))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st, _ = ot.rollout(st, c, 1)
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
                    states.append(st)
                if impl == "auto":
                    launches = (accel_jerk_cuda.launches, accel_jerk_subset_cuda.launches)
                runs[impl] = (plans, states, walls)
            (plans, states, walls), (p_plans, p_states, _) = runs["auto"], runs["chunked"]
            b5, b5s = launches
            substeps = sum(p[1] for p in plans)
            subset_total += b5s
            if b5 != 1 + BLOCK_MACRO_STEPS or b5s != substeps:
                raise AssertionError(f"block rungs={rungs}: B5 {b5}, B5 subset {b5s} "
                                     f"launches for {substeps} substeps")
            if not any(1 < p[0] <= 64 and p[1] >= 4 for p in plans):
                raise AssertionError(f"block rungs={rungs}: no macro step with 1 < fast <= 64 "
                                     f"and m >= 4: {[p[:2] for p in plans]}")
            if not all(bool(torch.isfinite(s.pos).all()) for s in states):
                raise AssertionError(f"block rungs={rungs}: non-finite state")
            same = [a[:2] == b[:2] and torch.equal(a[2], b[2])
                    for a, b in zip(plans, p_plans)]
            upto = same.index(False) if False in same else len(same)
            if upto == 0:
                raise AssertionError(f"block rungs={rungs}: the kernels and the plain versions "
                                     f"chose different fast rows or m at macro step 1")
            err = max_state_err(states[upto - 1], p_states[upto - 1])
            if err > STATE_ATOL:
                raise AssertionError(f"block rungs={rungs}: kernels vs plain after {upto} "
                                     f"macro steps: {err:.3e} > {STATE_ATOL:g}")
            steps = "; ".join(f"step {k + 1}: fast {p[0]} ({p[3]} under dt), m {p[1]}, "
                              f"{w:.1f} ms" for k, (p, w) in enumerate(zip(plans, walls)))
            lines.append(f"rungs={rungs}: [{steps}]; launches B5 {b5}, B5 subset {b5s} "
                         f"= substeps; kernels vs plain after {upto} macro steps (same m and "
                         f"fast rows) max diff {err:.2e} <= {STATE_ATOL:g}")
        self.kernels["B5S"]["launches"] = subset_total
        return (f"N=65536 ds32 block Hermite, binary {BINARY_MASS:g} x 2 at separation "
                f"{BINARY_SEP:g}, eps2={EPS2_BLOCK:g}, eta={ETA_BLOCK:g}, fast_cap=64, "
                f"max_substeps=64: " + " | ".join(lines))

    # phase 16
    def hermite_bounce(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_accel_jerk_detect_fn
        from orbital_tpu_torch.ops.cuda_collisions import bounce_deltas_cuda
        from orbital_tpu_torch.ops.cuda_jerk import accel_jerk_cuda, accel_jerk_detect_cuda

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, E0 = self.cluster()
        if self.hermite_log is None:
            raise AssertionError("phase 16 needs the Hermite main path's log (phase 13)")

        # the bench row's radius: contact-free at t = 0, bit-equal to the
        # collision-free Hermite run up to the first contact
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, integrator="hermite", collisions="bounce",
                           restitution=1.0)
        state = ot.make_state(pos, vel, mass, np.full(n, R_BENCH), precision="ds32",
                              device=self.dev)
        _, _, _, c0 = accel_jerk_detect_cuda(state.pos, state.vel, state.mass, state.radius,
                                             state.alive, G=1.0, eps2=EPS2)
        contacts0 = int(c0)
        log = StepLog(resolve_accel_jerk_detect_fn(cfg, n, self.dev), keep_pos=True,
                      keep_counts=True)
        reset_launches()
        state = ot.init_forces(state, cfg)
        rec, _ = ot.rollout(state, cfg, 20, record_every=10, accel_jerk_detect_fn=log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, _ = ot.rollout(rec, cfg, self.drift_steps, accel_jerk_detect_fn=log)
        torch.cuda.synchronize()
        ms_bench = 1e3 * (time.perf_counter() - t0) / self.drift_steps
        b5, b5d, b6 = (accel_jerk_cuda.launches, accel_jerk_detect_cuda.launches,
                       bounce_deltas_cuda.launches)
        steps = 20 + self.drift_steps
        drift = abs((energy_f64(fin) - E0) / E0)
        counts = torch.stack(log.counts).cpu().numpy()
        hit = [int(k) + 1 for k in np.flatnonzero(counts)]
        differ = next((k + 1 for k, (a, b) in enumerate(zip(log.positions,
                                                             self.hermite_log.positions))
                       if not torch.equal(a, b)), None)
        if contacts0 != 0:
            raise AssertionError(f"Hermite bench row: {contacts0} contacts at t=0")
        if b5 != 1 or b5d != steps or b6 != steps:
            raise AssertionError(f"Hermite bench row launches: B5 {b5}, B5 detect {b5d}, "
                                 f"B6 {b6}")
        if drift > DRIFT_BUDGET or not bool(torch.isfinite(fin.pos).all()):
            raise AssertionError(f"Hermite bench row drift {drift:.3e} over {DRIFT_BUDGET:g}")
        if len(log.positions) != len(self.hermite_log.positions):
            raise AssertionError("Hermite bench row: step counts differ from phase 13")
        if differ is not None and (not hit or differ <= hit[0]):
            raise AssertionError(f"Hermite bench row: positions differ from the collision-free "
                                 f"run at step {differ}, first contact {hit[:1]}")
        same = (f"bit-equal to collisions='none' through step {hit[0]}" if hit
                else "bit-equal to collisions='none' on every step")
        self.hermite_log = None

        # the contact-rich radius: bounces on most steps
        cfg = cfg.replace(restitution=0.8)
        state = ot.make_state(pos, vel, mass, np.full(n, R_RICH), precision="ds32",
                              device=self.dev)
        reset_launches()
        tally = StepLog(resolve_accel_jerk_detect_fn(cfg, n, self.dev))
        start = ot.init_forces(state, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, _ = ot.rollout(start, cfg, RICH_STEPS, accel_jerk_detect_fn=tally)
        torch.cuda.synchronize()
        ms_rich = 1e3 * (time.perf_counter() - t0) / RICH_STEPS
        b5d_rich, b6_rich = accel_jerk_detect_cuda.launches, bounce_deltas_cuda.launches
        steps_hit, total = int(tally.steps), int(tally.total)
        if b5d_rich != RICH_STEPS or b6_rich != RICH_STEPS or steps_hit == 0:
            raise AssertionError(f"Hermite contact-rich: B5 detect {b5d_rich}, B6 {b6_rich} "
                                 f"launches, contacts on {steps_hit} steps")
        if not (bool(torch.isfinite(fin.pos).all()) and bool(torch.isfinite(fin.vel).all())):
            raise AssertionError("Hermite contact-rich: non-finite state")
        free = cfg.replace(collisions="none")
        moved = float((fin.vel_full() - ot.rollout(ot.init_forces(state, free), free,
                                                   RICH_STEPS)[0].vel_full()).abs().max())
        if moved == 0.0:
            raise AssertionError("Hermite contact-rich: the bounces changed nothing")
        self.kernels["B5D"]["launches"] = b5d + b5d_rich

        # the first steps one at a time, on the kernels and on the plain
        # sweeps, counts and bounce sweep
        runs = {}
        for impl in ("auto", "chunked"):
            c = cfg.replace(force_impl=impl)
            t = StepLog(resolve_accel_jerk_detect_fn(c, n, self.dev), keep_counts=True)
            with plain_bounce() if impl == "chunked" else contextlib.nullcontext():
                s = ot.init_forces(state, c)
                states = []
                for _ in range(RICH_CHECK_STEPS):
                    s, _ = ot.rollout(s, c, 1, accel_jerk_detect_fn=t)
                    states.append(s)
                torch.cuda.synchronize()
            runs[impl] = (states, [int(x) for x in t.counts])
        (k_states, k_counts), (p_states, p_counts) = runs["auto"], runs["chunked"]
        gates = [(a > 0) == (b > 0) for a, b in zip(k_counts, p_counts)]
        upto = gates.index(False) if False in gates else RICH_CHECK_STEPS
        if upto == 0:
            raise AssertionError("Hermite contact-rich: gates differ at step 1")
        err = max_state_err(k_states[upto - 1], p_states[upto - 1])
        if err > STATE_ATOL:
            raise AssertionError(f"Hermite contact-rich: kernels vs plain after {upto} steps: "
                                 f"{err:.3e} > {STATE_ATOL:g}")
        return (f"N=65536 ds32 Hermite bounce, bench row R={R_BENCH:g} e=1: 20 recorded + "
                f"{self.drift_steps} unrecorded steps, contacts 0 at t=0, "
                f"{int(counts.sum())} on steps {hit}, {same} (positions first differ at step "
                f"{differ}); |dE/E| = {drift:.3e}; {ms_bench:.3f} ms/step wall; launches B5 "
                f"{b5}, B5 detect {b5d}, B6 {b6} | contact-rich R={R_RICH:g} e=0.8: "
                f"{RICH_STEPS} steps at {ms_rich:.3f} ms/step, contacts on {steps_hit} "
                f"({total} summed), launches B5 detect {b5d_rich}, B6 {b6_rich}, bounces moved "
                f"max|dv| {moved:.2e}; kernels vs plain over {upto} steps max diff {err:.2e} "
                f"<= {STATE_ATOL:g} (counts kernel {k_counts} plain {p_counts})")

    # phase 17
    def hermite_timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_jerk import (accel_jerk_cuda, accel_jerk_detect_cuda,
                                                     accel_jerk_detect_plain, accel_jerk_plain,
                                                     accel_jerk_subset_cuda,
                                                     accel_jerk_subset_plain)

        torch = self.torch
        n, f = N_MAIN, 64
        pos, vel, mass, rad, alive = self.scene(n, R_BENCH, 0, seed_offset=8)
        kw = dict(G=1.0, eps2=EPS2)
        idx = torch.arange(0, n, n // f, device=self.dev)
        b5 = summary(time_ms(lambda: accel_jerk_cuda(pos, vel, mass, alive, **kw), 20))
        b5p = summary(time_ms(lambda: accel_jerk_plain(pos, vel, mass, alive, **kw), 1))
        b5d = summary(time_ms(lambda: accel_jerk_detect_cuda(pos, vel, mass, rad, alive,
                                                             **kw), 20))
        b5dp = summary(time_ms(lambda: accel_jerk_detect_plain(pos, vel, mass, rad, alive,
                                                               **kw), 1))
        b5s = summary(time_ms(lambda: accel_jerk_subset_cuda(idx, pos, vel, mass, alive,
                                                             **kw), 200))
        b5sp = summary(time_ms(lambda: accel_jerk_subset_plain(idx, pos, vel, mass, alive,
                                                               **kw), 5))
        # the subset's device time a call (torch.profiler over 20 calls): its
        # events time above is the wrapper's host time where that is longer
        dev_s = device_times(lambda: [accel_jerk_subset_cuda(idx, pos, vel, mass, alive, **kw)
                                      for _ in range(20)])
        b5s_dev = next((t / 20 for k, (c, t) in dev_s.items() if "jerk_subset" in k), None)

        pos_c, vel_c, mass_c, _ = self.cluster()
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, integrator="hermite")
        st = ot.init_forces(ot.make_state(pos_c, vel_c, mass_c, precision="ds32",
                                          device=self.dev), cfg)
        step = summary([t / 10 for t in time_ms(lambda: ot.rollout(st, cfg, 10), 1)])
        cfg_b = self.block_config(1)
        st_b = ot.init_forces(ot.make_state(*self.block_scene(), precision="ds32",
                                            device=self.dev), cfg_b)
        from orbital_tpu_torch.engine.integrators import block_plan

        m_b = block_plan(st_b, cfg_b)[2]
        macro = summary(time_ms(lambda: ot.rollout(st_b, cfg_b, 1), 1))

        bounds = {
            "B5": bound(OPS_B5 * n * n, 64 * n, rsqrt=n * n),
            "B5D": bound(OPS_B5_DETECT * n * n, 64 * n + 4, rsqrt=n * n),
            "B5S": bound(OPS_B5_SUBSET * f * n, 32 * n + 32 * f, rsqrt=f * n),
        }
        for k, (kern, plain) in {"B5": (b5, b5p), "B5D": (b5d, b5dp),
                                 "B5S": (b5s, b5sp)}.items():
            self.kernels[k].update(ms=kern["median"], plain_ms=plain["median"],
                                   bound_ms=bounds[k][0], bound_by=bounds[k][1],
                                   library_ms=None)
        perf = {"B5_N65536": (b5, b5p), "B5D_N65536": (b5d, b5dp), "B5S_F64_N65536": (b5s, b5sp),
                "B5S_device_ms": b5s_dev,
                "hermite_step_N65536": step, "block_macro_step_N65536": macro,
                "block_macro_m": m_b, "bounds_ms": bounds}
        print("perf_hermite " + json.dumps(perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        return (f"B5 N=65536 {ms(b5)} vs plain {ms(b5p)}; B5 detect {ms(b5d)} vs plain "
                f"{ms(b5dp)}; B5 subset F=64 {b5s['median'] * 1e3:.1f} us (spread "
                f"{b5s['spread'] * 1e3:.1f}; device "
                f"{fmt(b5s_dev and b5s_dev * 1e3, 1, ' us')}) vs plain {ms(b5sp)}; Hermite ds32 "
                f"step N=65536 "
                f"{ms(step)}; block macro step (rungs=1, m={m_b}) {ms(macro)}; bounds "
                + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bounds.items()))

    # phases 18-20: the multirate stepper
    def respa_budgets(self):
        """(m_grid, max_chunks, w_blk, wl_entries) of the cluster, probed once
        as the bench probes them (bench.py:282-285), from its positions (the
        first draw of make_cluster's generator)."""
        if self._respa_budgets is None:
            from orbital_tpu_torch.ops.neighbor import neighbor_budgets

            pos = np.random.default_rng(self.seed).normal(size=(N_MAIN, 3))
            self._respa_budgets = neighbor_budgets(pos, cell=CELL_RESPA, chunk=32, rj=4,
                                                   with_wl=True, headroom=2.2,
                                                   w_headroom=1.5)
        return self._respa_budgets

    def respa_config(self, k: int = RESPA_K, refresh: int = RESPA_REFRESH, **kw):
        """The bench's multirate configuration on the cluster: the superblock
        schedule, so no worklist budget."""
        import orbital_tpu_torch as ot

        m, k_ch, w_blk, _ = self.respa_budgets()
        return ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, integrator="respa", respa_k=k,
                            respa_rc=RC_RESPA, respa_cell=CELL_RESPA, respa_m=m,
                            respa_max_chunks=k_ch, respa_w_blk=w_blk, respa_wl_entries=0,
                            respa_impl="pallas_sb", respa_refresh=refresh, **kw)

    def ragged_near_scene(self, n: int = N_NEAR_RAGGED):
        """The ragged near-kernel case: n Gaussian bodies scaled by
        NEAR_RAGGED_SCALE, 7 dead and parked far, and starved budgets (pos,
        mass, alive, budgets), every overflow counter > 0."""
        from orbital_tpu_torch.engine.state import far_positions
        from orbital_tpu_torch.ops import neighbor as nb

        rng = np.random.default_rng(self.seed + 9)
        pos_r = rng.normal(size=(n, 3)) * NEAR_RAGGED_SCALE
        alive_r = np.ones(n, bool)
        alive_r[-7:] = False
        pos_r[-7:] = far_positions(7, float(np.abs(pos_r).max()), np.float32, start=n - 7)
        mass_r = np.full(n, 1.0 / n)
        m_r, k_r, w_r, q_r = nb.neighbor_budgets(pos_r, alive_r, cell=CELL_RESPA, chunk=32,
                                                 rj=4, with_wl=True)
        starved = (m_r, max(4, (k_r // 2) // 4 * 4), max(1, w_r // 3), max(8, q_r // 3))
        return pos_r, mass_r, alive_r, starved

    def near_case(self, pos, mass, alive, budgets):
        """Geometry with a worklist and packed slot channels on the card."""
        from orbital_tpu_torch.ops import neighbor as nb

        torch = self.torch
        m, k_ch, w_blk, q = budgets
        pos_t = torch.tensor(pos, dtype=torch.float32, device=self.dev)
        alive_t = torch.tensor(alive, device=self.dev)
        geom = nb.neighbor_geometry(pos_t, alive_t, cell=CELL_RESPA, m_grid=m, chunk=32,
                                    max_chunks=k_ch, w_blk=w_blk, rj=4, wl_entries=q)
        n_slots = (k_ch + 4) * 32
        mass_t = torch.tensor(np.where(alive, mass, 0.0), dtype=torch.float32,
                              device=self.dev)
        ch = [nb.pack_slots(geom["slot"], pos_t[:, k].contiguous(), n_slots, nb.SENTINEL_POS)
              for k in range(3)] + [nb.pack_slots(geom["slot"], mass_t, n_slots, 0.0)]
        return geom, ch

    # phase 18
    def check_near(self) -> str:
        from orbital_tpu_torch.ops import cuda_neighbor as cn
        from orbital_tpu_torch.ops import neighbor as nb
        from orbital_tpu_torch.utils import kernels

        torch = self.torch
        kw = dict(r1=0.5 * RC_RESPA, rc=RC_RESPA, G=1.0, eps2=EPS2, chunk=32, rj=4)

        def rel(x, ref):
            return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())

        pos, _, mass, _ = self.cluster()
        budgets = self.respa_budgets()
        lines, vs64 = [], {}
        for name, (p_, m_, a_, b_) in (
                (f"N={N_MAIN}", (pos, mass, np.ones(N_MAIN, bool), budgets)),
                (f"N={N_NEAR_RAGGED} starved", self.ragged_near_scene())):
            geom, ch = self.near_case(p_, m_, a_, b_)
            ovf = {k: int(geom[k]) for k in ("cap_overflow", "w_overflow", "q_overflow")}
            if name.endswith("starved") != all(v > 0 for v in ovf.values()):
                raise AssertionError(f"near {name}: overflow counters {ovf}")
            a_k, pe_k = cn.near_acc_slots_cuda(*ch, geom["jbl"], **kw)
            a_w, pe_w = cn.near_acc_slots_cuda_wl(*ch, geom["wl_i"], geom["wl_jb"], **kw)
            a_p, pe_p = nb.near_acc_slots(*ch, geom["jbl"], **kw)
            a_pw, pe_pw = cn.near_acc_slots_wl_plain(*ch, geom["wl_i"], geom["wl_jb"], **kw)
            a64, pe64 = nb.near_acc_slots(*(c.double() for c in ch), geom["jbl"], **kw)
            torch.cuda.synchronize()
            errs = {"jbl": (rel(a_k, a_p), rel(pe_k, pe_p)),
                    "worklist": (rel(a_w, a_pw), rel(pe_w, pe_pw))}
            for mode, (ea, ep) in errs.items():
                if ea > NEAR_RTOL or ep > NEAR_RTOL or not bool(torch.isfinite(a_k).all()):
                    raise AssertionError(f"near {name} {mode}: max|da|/max|a| = {ea:.3e}, "
                                         f"max|dpe|/max|pe| = {ep:.3e}")
            same = torch.equal(a_k, a_w) and torch.equal(pe_k, pe_w)
            if ovf["q_overflow"] == 0 and not same:
                raise AssertionError(f"near {name}: worklist and table sweeps differ")
            # the columns of a row table, read in place as the RESPA stepper
            # passes them, give the same bits as four channels
            P = torch.stack(ch, dim=1)
            a_t, pe_t = cn.near_acc_slots_cuda(P[:, 0], P[:, 1], P[:, 2], P[:, 3],
                                               geom["jbl"], **kw)
            if not (torch.equal(a_t, a_k) and torch.equal(pe_t, pe_k)):
                raise AssertionError(f"near {name}: the row table's columns and the four "
                                     f"channels differ")
            vs64[name] = (rel(a_k, a64), rel(a_p, a64), rel(pe_k, pe64), rel(pe_p, pe64))
            if vs64[name][0] > NEAR_RTOL:
                raise AssertionError(f"near {name} vs f64: {vs64[name]}")
            if name == f"N={N_MAIN}":
                self.kernels["NEAR"]["max_abs_err"] = float((a_k - a_p).abs().max())
                entries = int((geom["jbl"] != geom["jbl"].shape[0] // 4).sum())
            lines.append(
                f"{name} ({ovf}): table {errs['jbl'][0]:.2e}/{errs['jbl'][1]:.2e}, worklist "
                f"{errs['worklist'][0]:.2e}/{errs['worklist'][1]:.2e}"
                f"{', bit-equal to the table' if same else ''}; vs f64 acc kernel "
                f"{vs64[name][0]:.2e} plain {vs64[name][1]:.2e}, pe kernel "
                f"{vs64[name][2]:.2e} plain {vs64[name][3]:.2e}")
            del a64, pe64
        ptxas = "; ".join(line.strip() for line in kernels.build_log("neighbor").splitlines()
                          if "registers" in line or "spill" in line) or "cached build"
        m, k_ch, w_blk, q = budgets
        return (f"near kernel == plain within max|da|/max|a|, max|dpe|/max|pe| <= "
                f"{NEAR_RTOL:g} [{'; '.join(lines)}]; headline budgets m={m} k_ch={k_ch} "
                f"w_blk={w_blk} wl={q}, {entries} live j-blocks; ptxas: {ptxas}")

    # phase 19
    def respa_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.multirate import respa_rollout
        from orbital_tpu_torch.engine.rollout import resolve_force_detect_fn, resolve_force_fn
        from orbital_tpu_torch.ops.cuda_collisions import bounce_deltas_cuda
        from orbital_tpu_torch.ops.cuda_forces import (pairwise_acc_cuda,
                                                       pairwise_acc_detect_cuda)
        from orbital_tpu_torch.ops.cuda_neighbor import near_acc_slots_cuda
        from orbital_tpu_torch.utils import native

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, E0 = self.cluster()
        cfg = self.respa_config()
        state = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
        rec_steps = 2 * RESPA_K * 2  # two records of two macro windows
        if self.drift_steps % RESPA_K:
            raise AssertionError(f"--drift-steps must divide by K = {RESPA_K}")

        reset_launches()
        state = ot.init_forces(state, cfg)
        rec, traj, d_rec = respa_rollout(state, cfg, rec_steps, record_every=rec_steps // 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, none, d_run = respa_rollout(rec, cfg.replace(track_potential=False),
                                         self.drift_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1, near = pairwise_acc_cuda.launches, near_acc_slots_cuda.launches

        steps = rec_steps + self.drift_steps
        macros = steps // RESPA_K
        drift = abs((energy_f64(fin) - E0) / E0)
        counters = {k: max(int(d_rec[k]), int(d_run[k])) for k in d_run}
        e_rec = traj.energy.double().cpu().numpy()
        if tuple(traj.pos.shape) != (2, n, 3) or none is not None:
            raise AssertionError("RESPA: the recorded rollout returned the wrong records")
        if not (np.isfinite(e_rec).all() and bool(torch.isfinite(fin.pos).all())):
            raise AssertionError("RESPA: non-finite state or energy records")
        if np.max(np.abs(e_rec / E0 - 1.0)) > ENERGY_RTOL:
            raise AssertionError(f"RESPA recorded f32 energies {e_rec} stray from E0 = {E0}")
        if any(counters.values()):
            raise AssertionError(f"RESPA overflow or skin counters nonzero: {counters}")
        if int(fin.step) != steps:
            raise AssertionError(f"RESPA step counter {int(fin.step)} after {steps} substeps")
        if b1 != 1 + macros or near != (RESPA_K + 1) * macros:
            raise AssertionError(f"RESPA launches: B1 {b1}, near {near} in {macros} macro "
                                 f"windows + init")
        if drift > DRIFT_BUDGET:
            raise AssertionError(f"RESPA energy drift {drift:.3e} over {DRIFT_BUDGET:g}")
        self.kernels["NEAR"]["launches"] = near
        self.respa_ms_per_substep = 1e3 * wall / self.drift_steps

        # three macro windows on the kernel against the plain sweep
        start = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32",
                                             device=self.dev), cfg)
        k3, _, _ = respa_rollout(start, cfg, 3 * RESPA_K)
        p3, _, _ = respa_rollout(start, cfg.replace(respa_impl="xla"), 3 * RESPA_K)
        torch.cuda.synchronize()
        err = max_state_err(k3, p3)
        if err > STATE_ATOL:
            raise AssertionError(f"RESPA 3 macro steps, kernel vs plain sweep: {err:.3e}")

        # bounce at the bench row's radius against the collision-free run, both
        # with the geometry rebuilt every window (refresh > 1 needs collisions off)
        radius = np.full(n, R_BENCH)
        runs = {}
        for mode in ("none", "bounce"):
            c = self.respa_config(refresh=1, collisions=mode, restitution=1.0,
                                  track_potential=False)
            resolve = resolve_force_detect_fn if mode == "bounce" else resolve_force_fn
            log = StepLog(resolve(c, n, self.dev), keep_pos=True, keep_counts=True)
            hook = dict(force_detect_fn=log) if mode == "bounce" else dict(force_fn=log)
            s = ot.init_forces(ot.make_state(pos, vel, mass, radius, precision="ds32",
                                             device=self.dev), c)
            if mode == "bounce":
                reset_launches()
            fin_b, _, d_b = respa_rollout(s, c, self.drift_steps, **hook)
            torch.cuda.synchronize()
            runs[mode] = (fin_b, log, {k: int(v) for k, v in d_b.items()})
        b2, b6 = pairwise_acc_detect_cuda.launches, bounce_deltas_cuda.launches
        (_, log_none, _), (fin_b, log_b, d_b) = runs["none"], runs["bounce"]
        counts = torch.stack(log_b.counts).cpu().numpy()
        hit = [int(k) + 1 for k in np.flatnonzero(counts)]  # macro windows with contacts
        differ = next((k + 1 for k, (a, b) in enumerate(zip(log_b.positions,
                                                             log_none.positions))
                       if not torch.equal(a, b)), None)
        n_b = self.drift_steps // RESPA_K
        if any(d_b.values()) or b2 != n_b or b6 != n_b:
            raise AssertionError(f"RESPA bounce: counters {d_b}, launches B2 {b2}, B6 {b6}")
        if differ is not None and (not hit or differ <= hit[0]):
            raise AssertionError(f"RESPA bounce: positions differ from the collision-free run "
                                 f"at window {differ}, first contact {hit[:1]}")
        if not bool(torch.isfinite(fin_b.pos).all()):
            raise AssertionError("RESPA bounce: non-finite state")
        same = (f"bit-equal to collisions='none' through window {hit[0]}" if hit
                else "bit-equal to collisions='none' on every window")
        return (f"N={n} ds32 RESPA K={RESPA_K} refresh={RESPA_REFRESH} rc={RC_RESPA:g} "
                f"cell={CELL_RESPA:g}: init_forces + {rec_steps} recorded + "
                f"{self.drift_steps} unrecorded substeps, |dE/E| = {drift:.3e} <= "
                f"{DRIFT_BUDGET:g} (f64, {native.backend()}); counters {counters}; "
                f"{self.respa_ms_per_substep:.3f} ms/substep wall; launches B1 {b1}, near "
                f"{near} in {macros} windows; 3 windows kernel vs plain sweep max diff "
                f"{err:.2e} <= {STATE_ATOL:g} | bounce R={R_BENCH:g} e=1, refresh 1, "
                f"{self.drift_steps} substeps: contacts on windows {hit}, {same} (positions "
                f"first differ at window {differ}); launches B2 {b2}, B6 {b6}")

    # phase 20
    def respa_timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.multirate import make_respa_macro, respa_rollout
        from orbital_tpu_torch.engine.rollout import resolve_force_fn
        from orbital_tpu_torch.ops import cuda_neighbor as cn
        from orbital_tpu_torch.ops import neighbor as nb

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, _ = self.cluster()
        cfg = self.respa_config(track_potential=False)
        st = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32", device=self.dev),
                            cfg)
        macro = make_respa_macro(cfg, resolve_force_fn(cfg, n, self.dev))
        geom = macro.build_geom(st)
        geom_wl, ch = self.near_case(pos, mass, np.ones(n, bool), self.respa_budgets())
        kw = dict(r1=0.5 * RC_RESPA, rc=RC_RESPA, G=1.0, eps2=EPS2, chunk=32, rj=4)

        near = summary(time_ms(lambda: cn.near_acc_slots_cuda(*ch, geom_wl["jbl"], **kw), 50))
        # the wrapper's host time a call (enqueue only): CUDA events count it
        # too where it is longer than the kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            cn.near_acc_slots_cuda(*ch, geom_wl["jbl"], **kw)
        near_host = 1e3 * (time.perf_counter() - t0) / 50
        torch.cuda.synchronize()
        near_wl = summary(time_ms(lambda: cn.near_acc_slots_cuda_wl(
            *ch, geom_wl["wl_i"], geom_wl["wl_jb"], **kw), 50))
        near_p = summary(time_ms(lambda: nb.near_acc_slots(*ch, geom_wl["jbl"], **kw), 1))
        build = summary(time_ms(lambda: macro.build_geom(st), 10))

        n_slots = (cfg.respa_max_chunks + 4) * 32
        slot = geom["slot"]
        rows = torch.cat([st.pos, st.mass[:, None]], dim=1)

        def pack_unpack():
            tabs = [nb.pack_rows(slot, rows, n_slots, 0.0) for _ in range(5)]
            return [nb.unpack_rows(slot, t, rows, cfg.respa_max_chunks * 32) for t in tabs]

        packs = summary(time_ms(pack_unpack, 20))
        one_macro = summary(time_ms(lambda: macro(st, geom), 5))

        # ms per substep over 12 macro windows (geometry builds included), at
        # K = 4 and K = 5, against the KDK step of phase 11, in turns
        cfg5 = self.respa_config(RESPA_K5, RESPA_REFRESH5, track_potential=False)
        st5 = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32", device=self.dev),
                             cfg5)
        kcfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, track_potential=False)
        stk = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32", device=self.dev),
                             kcfg)
        turns = alternate_ms({
            "K4": lambda: respa_rollout(st, cfg, 12 * RESPA_K),
            "K5": lambda: respa_rollout(st5, cfg5, 12 * RESPA_K5),
            "kdk": lambda: ot.rollout(stk, kcfg, 10)}, 1, repeats=3)
        per = {"K4": 12 * RESPA_K, "K5": 12 * RESPA_K5, "kdk": 10}
        sub = {k: summary([t / per[k] for t in v]) for k, v in turns.items()}

        # device time by kernel: the near kernel alone (its wrapper's host work
        # is not in it), and one geometry period at K = 4 (4 windows) for the
        # busy share of a substep and where the device time goes
        prof = device_times(lambda: [cn.near_acc_slots_cuda(*ch, geom_wl["jbl"], **kw)
                                     for _ in range(20)])
        near_dev = sum(t for k, (_, t) in prof.items() if "near_sweep" in k) / 20 or None
        prof = device_times(lambda: respa_rollout(st, cfg, RESPA_REFRESH * RESPA_K))
        busy = sum(t for _, t in prof.values()) / (RESPA_REFRESH * RESPA_K) or None
        launched = sum(c for c, _ in prof.values()) / (RESPA_REFRESH * RESPA_K)
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
        prof = device_times(lambda: macro.build_geom(st))
        build_dev = (sum(c for c, _ in prof.values()), sum(t for _, t in prof.values()))

        # the pairs walked, live, visited and needed, and the bound over the
        # needed pairs' operations and the bytes the function must move,
        # beside the bound over every walked pair (the first version's)
        work = near_work(geom_wl, ch, RC_RESPA, 32, 4)
        if not work["visited"] < 0.1 * work["walked"]:
            raise AssertionError(f"near sweep: {work['visited']} visited pairs of "
                                 f"{work['walked']} walked, not < 10%")
        bnd = bound(OPS_NEAR * work["needed"], work["nbytes"], rsqrt=work["needed"])
        bnd_walked = bound(OPS_NEAR * work["walked"], work["nbytes"], rsqrt=work["walked"])
        floor = issue_floor_ms(self.kernels["NEAR"].get("sass_slots_per_pair"),
                               work["issued"])
        self.kernels["NEAR"].update(ms=near["median"], plain_ms=near_p["median"],
                                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        ratio = {k: sub["kdk"]["median"] / sub[k]["median"] for k in ("K4", "K5")}
        perf = {"near_N65536": (near, near_p), "near_wl_N65536": near_wl,
                "near_host_ms": near_host, "near_pairs": work, "near_bound_ms": bnd,
                "near_bound_walked_ms": bnd_walked, "near_issue_floor_ms": floor,
                "geometry_build": build,
                "pack_unpack_5_tables": packs, "macro_step_K4": one_macro,
                "substep_K4_refresh4": sub["K4"], "substep_K5_refresh3": sub["K5"],
                "kdk_step": sub["kdk"], "kdk_over_substep": ratio,
                "near_device_ms": near_dev, "substep_K4_device_busy_ms": busy,
                "substep_K4_kernels": launched, "period_K4_top_kernels": top,
                "geometry_build_kernels_device_ms": build_dev}
        print("perf_respa " + json.dumps(perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        profiled = ("device time not measured (the profiler recorded none)" if busy is None
                    else f"near kernel device time {near_dev:.3f} ms a call; a K=4 substep "
                    f"keeps the device busy {busy:.3f} ms of {sub['K4']['median']:.3f} "
                    f"(idle {100 * (1 - busy / sub['K4']['median']):.0f}%) with "
                    f"{launched:.1f} kernels; a geometry build {build_dev[0]} kernels, "
                    f"{build_dev[1]:.3f} ms of device time; top: "
                    + ", ".join(f"{k[:40]} {c}x {t:.2f} ms" for k, (c, t) in top[:4]))
        dev_share = ("" if near_dev is None else
                     f", {100 * bnd[0] / near_dev:.1f}% of its device time")
        return (f"near kernel N={n} {ms(near)} (the wrapper's host time {near_host:.3f} ms "
                f"a call; worklist {ms(near_wl)}) vs plain {ms(near_p)}; pairs walked "
                f"{work['walked']}, live {work['live']}, visited {work['visited']} (issued as "
                f"{work['issued']} lane slots, {100 * work['visited'] / work['walked']:.1f}% of "
                f"walked), needed {work['needed']}; bound {bnd[0]:.4f} ms ({bnd[1]}: "
                f"{work['nbytes']} bytes, {OPS_NEAR} flops a needed pair; "
                f"{100 * bnd[0] / near['median']:.1f}% of the events time{dev_share}), "
                f"{bnd_walked[0]:.4f} ms over every walked pair; issue floor "
                f"{fmt(floor, 4, ' ms')} at 1.98 GHz; geometry build {ms(build)}; "
                f"pack+unpack of 5 tables {ms(packs)}; one macro step K=4 {ms(one_macro)}; "
                f"per substep K=4 refresh 4 {ms(sub['K4'])}, K=5 refresh 3 {ms(sub['K5'])}; "
                f"KDK step {ms(sub['kdk'])}: KDK/substep {ratio['K4']:.2f}x (K=4), "
                f"{ratio['K5']:.2f}x (K=5); {profiled}")

    # phases 21-24: the tree force solver
    def plummer(self):
        """The 65,536-body Plummer sphere of the tree phases and its probed
        budgets at levels 7 (made once)."""
        if self._plummer is None:
            from orbital_tpu_torch.ops.tree_near_wl import tree_wl_budgets

            pos, vel, mass = make_plummer(N_MAIN, self.seed)
            budgets = tree_wl_budgets(pos, levels=TREE_LEVELS, ws=1, chunk=TREE_CHUNK,
                                      rj=TREE_RJ)
            self._plummer = (pos, vel, mass, budgets)
        return self._plummer

    def tree_config(self, budgets, **kw):
        import orbital_tpu_torch as ot

        return ot.SimConfig(dt=TREE_DT, G=1.0, eps2=TREE_EPS2, force_impl="tree",
                            tree_levels=TREE_LEVELS, tree_near="kernel", tree_chunk=TREE_CHUNK,
                            tree_wl_rj=TREE_RJ, tree_max_chunks=budgets[0],
                            tree_wl_entries=budgets[1], **kw)

    def tree_table(self, pos, mass, alive, levels: int, ws: int, budgets):
        """The B7 inputs on the card (``ops.tree_near_wl._wl_table``), as
        ``tree_acc_potential`` builds them."""
        from orbital_tpu_torch.ops import tree as T
        from orbital_tpu_torch.ops import tree_near_wl as W

        torch = self.torch
        M = 2 ** levels
        pos_t = torch.tensor(pos, dtype=torch.float32, device=self.dev)
        mass_t = torch.tensor(mass, dtype=torch.float32, device=self.dev)
        alive_t = torch.tensor(alive, device=self.dev)
        pos32, alive_b, _, m_eff, _, _, _, cc = T._bin(pos_t, mass_t, alive_t, M, None,
                                                       torch.float32)
        sc, sort_idx = T._sort_cells(cc, alive_b, M)
        return W._wl_table(sc, pos32[sort_idx], m_eff[sort_idx], sort_idx, pos.shape[0], M,
                           ws, budgets[0], TREE_CHUNK, budgets[1], TREE_RJ)

    def ragged_tree_scene(self, n: int = N_TREE_RAGGED):
        """n Plummer bodies with a third dead and parked far."""
        from orbital_tpu_torch.engine.state import far_positions

        pos, _, mass = make_plummer(n, self.seed + 11)
        alive = np.ones(n, bool)
        dead = np.arange(0, n, 3)
        alive[dead] = False
        pos[dead] = far_positions(len(dead), float(np.abs(pos).max()), np.float32)
        return pos, mass, alive

    # phase 21
    def check_tree_near(self) -> str:
        from orbital_tpu_torch.ops import cuda_tree
        from orbital_tpu_torch.ops.tree import tree_acc_potential
        from orbital_tpu_torch.ops.tree_near_wl import tree_wl_budgets, tree_wl_probe
        from orbital_tpu_torch.utils import kernels

        torch = self.torch

        def rel(x, ref):
            return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())

        pos, _, mass, budgets = self.plummer()
        pos_r, mass_r, alive_r = self.ragged_tree_scene()
        cases = [(f"N={N_MAIN} l{TREE_LEVELS} ws1", pos, mass, np.ones(N_MAIN, bool),
                  TREE_LEVELS, 1, budgets)]
        for ws in (1, 2):
            b = tree_wl_budgets(pos_r, alive_r, levels=TREE_RAGGED_LEVELS, ws=ws,
                                chunk=TREE_CHUNK, rj=TREE_RJ)
            cases.append((f"N={N_TREE_RAGGED} dead l{TREE_RAGGED_LEVELS} ws{ws}", pos_r, mass_r,
                          alive_r, TREE_RAGGED_LEVELS, ws, b))
        total, entries = tree_wl_probe(pos_r, alive_r, levels=TREE_RAGGED_LEVELS, ws=1,
                                       chunk=TREE_CHUNK, rj=TREE_RJ)
        starved = (max(1, total - total // 4), max(1, entries // 4))
        cases.append((f"N={N_TREE_RAGGED} dead ws1 starved", pos_r, mass_r, alive_r,
                       TREE_RAGGED_LEVELS, 1, starved))
        lines = []
        for name, p_, m_, a_, levels, ws, b_ in cases:
            t = self.tree_table(p_, m_, a_, levels, ws, b_)
            kw = dict(wl_entries=b_[1], chunk=TREE_CHUNK, rj=TREE_RJ, ws=ws, eps2=TREE_EPS2)
            out_k = cuda_tree.tree_near_cuda(t["pbods"], t["start_blk"], t["n_blk"], **kw)
            out_p = cuda_tree.tree_near_plain(t["pbods"], t["start_blk"], t["n_blk"], **kw)
            out_64 = cuda_tree.tree_near_plain(t["pbods"].double(), t["start_blk"],
                                               t["n_blk"], **kw)
            torch.cuda.synchronize()
            # per kept body: each owns one slot
            slots = t["slot"][t["keep"]]
            k, p, r64 = out_k[slots], out_p[slots], out_64[slots]
            if not bool(torch.isfinite(out_k).all()):
                raise AssertionError(f"B7 {name}: non-finite rows")
            ea, ep = rel(k[:, :3], p[:, :3]), rel(k[:, 3], p[:, 3])
            va = (rel(k[:, :3], r64[:, :3]), rel(p[:, :3], r64[:, :3]))
            vp = (rel(k[:, 3], r64[:, 3]), rel(p[:, 3], r64[:, 3]))
            if max(ea, ep, va[0], vp[0]) > NEAR_RTOL:
                raise AssertionError(f"B7 {name}: vs plain acc {ea:.3e} pe {ep:.3e}; vs f64 "
                                     f"acc {va[0]:.3e} pe {vp[0]:.3e}")
            ovf = (int(t["cap_overflow"]), int(t["cell_overflow"]))
            if name.endswith("starved"):
                # the whole near phase on the card (B7) and on the CPU (plain)
                kw_t = dict(G_grav=1.0, eps2=TREE_EPS2, levels=levels, ws=ws, near="kernel",
                            max_chunks=b_[0], wl_entries=b_[1], chunk=TREE_CHUNK,
                            wl_rj=TREE_RJ, _phase="near")
                args = [torch.tensor(x) for x in (p_.astype(np.float32),
                                                  m_.astype(np.float32), a_)]
                a_c, U_c, o_c = tree_acc_potential(*(x.to(self.dev) for x in args), **kw_t)
                a_h, U_h, o_h = tree_acc_potential(*args, **kw_t)
                if int(o_c) != int(o_h) or int(o_c) != sum(ovf) or min(ovf) <= 0:
                    raise AssertionError(f"B7 {name}: overflow card {int(o_c)}, CPU "
                                         f"{int(o_h)}, table {ovf}")
                e_cpu = rel(a_c.cpu(), a_h)
                if e_cpu > NEAR_RTOL:
                    raise AssertionError(f"B7 {name}: near phase card vs CPU {e_cpu:.3e}")
                ovf = f"overflow {ovf} == CPU's, near phase card vs CPU {e_cpu:.2e}"
            elif sum(ovf):
                raise AssertionError(f"B7 {name}: overflow {ovf} with probed budgets")
            else:
                ovf = "overflow 0"
            if name.startswith(f"N={N_MAIN}"):
                self.kernels["B7"]["max_abs_err"] = float((k[:, :3] - p[:, :3]).abs().max())
            lines.append(f"{name} budgets {b_}: vs plain acc {ea:.2e} pe {ep:.2e}; vs f64 acc "
                         f"kernel {va[0]:.2e} plain {va[1]:.2e}, pe kernel {vp[0]:.2e} plain "
                         f"{vp[1]:.2e}; {ovf}")
        ptxas = "; ".join(line.strip() for line in kernels.build_log("tree_near").splitlines()
                          if "registers" in line or "spill" in line) or "cached build"
        return (f"B7 == plain within max|da|/max|a|, max|dpe|/max|pe| <= {NEAR_RTOL:g} "
                f"[{' | '.join(lines)}]; ptxas: {ptxas}")

    # phase 22
    def check_tree_force(self) -> str:
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda
        from orbital_tpu_torch.ops.tree import tree_acc_potential

        torch = self.torch
        pos, _, mass, budgets = self.plummer()
        pos_t = torch.tensor(pos, dtype=torch.float32, device=self.dev)
        mass_t = torch.tensor(mass, dtype=torch.float32, device=self.dev)
        alive_t = torch.ones(N_MAIN, dtype=torch.bool, device=self.dev)
        kw = dict(G_grav=1.0, eps2=TREE_EPS2, levels=TREE_LEVELS, ws=1, near="kernel",
                  max_chunks=budgets[0], wl_entries=budgets[1], chunk=TREE_CHUNK,
                  wl_rj=TREE_RJ)

        def rel(x, ref):
            return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())

        a_k, U_k, o_k = tree_acc_potential(pos_t, mass_t, alive_t, **kw)
        with plain_tree_near():
            a_p, U_p, o_p = tree_acc_potential(pos_t, mass_t, alive_t, **kw)
        torch.cuda.synchronize()
        e_kp, u_kp = rel(a_k, a_p), abs(float(U_k) / float(U_p) - 1.0)
        if int(o_k) or int(o_p) or e_kp > NEAR_RTOL or u_kp > ENERGY_RTOL:
            raise AssertionError(f"tree on B7 vs plain sweep: {e_kp:.3e}, dU/U {u_kp:.3e}, "
                                 f"overflow {int(o_k)}/{int(o_p)}")
        # the far field on the card (cuDNN conv, TF32 off) against float64: on
        # the CPU at order 1, on the card at order 2 (its f64 conv on the CPU
        # takes minutes)
        far = {}
        for order, ref_dev in ((1, "cpu"), (2, self.dev)):
            a_f, U_f, _ = tree_acc_potential(pos_t, mass_t, alive_t, order=order,
                                             _phase="far", **kw)
            a_64, U_64, _ = tree_acc_potential(pos_t.to(ref_dev), mass_t.to(ref_dev),
                                               alive_t.to(ref_dev), order=order, _phase="far",
                                               _dtype=torch.float64, **kw)
            far[order] = (rel(a_f.to(ref_dev), a_64), abs(float(U_f) / float(U_64) - 1.0))
            if far[order][0] > FAR_RTOL or far[order][1] > FAR_RTOL:
                raise AssertionError(f"tree far field order {order} vs f64: {far[order]}")
        # against the exact forces (B1)
        a_x, _ = pairwise_acc_cuda(pos_t, mass_t, alive_t, G=1.0, eps2=TREE_EPS2,
                                   with_potential=False)
        errs = {}
        for order in (1, 2):
            a_o, _, ov = tree_acc_potential(pos_t, mass_t, alive_t, order=order, **kw)
            errs[order] = rms_rel(a_o, a_x)
            if int(ov):
                raise AssertionError(f"tree order {order}: overflow {int(ov)}")
        if errs[1] > TREE_RMS_BOUND or not errs[2] < errs[1]:
            raise AssertionError(f"tree RMS error vs B1: order 1 {errs[1]:.3e}, order 2 "
                                 f"{errs[2]:.3e} (bound {TREE_RMS_BOUND:g}, order 2 lower)")
        ma = mass_t.double()[:, None] * a_k.double()
        mom = float(ma.sum(0).norm()) / float((ma.norm(dim=1) ** 2).mean().sqrt())
        return (f"N={N_MAIN} Plummer l{TREE_LEVELS} ws1 budgets {budgets}: tree on B7 vs the "
                f"plain sweep max|da|/max|a| {e_kp:.2e} <= {NEAR_RTOL:g}, |dU/U| {u_kp:.2e}; "
                f"far field vs f64 order 1 (CPU) {far[1][0]:.2e} (U {far[1][1]:.2e}), order 2 "
                f"(card) {far[2][0]:.2e} (U {far[2][1]:.2e}) <= {FAR_RTOL:g}; RMS error vs B1 "
                f"order 1 {errs[1]:.3e} <= {TREE_RMS_BOUND:g}, order 2 {errs[2]:.3e}; "
                f"|sum m a| / RMS(m|a|) {mom:.2e}")

    # phase 23
    def tree_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops.cuda_tree import tree_near_cuda
        from orbital_tpu_torch.ops.tree_near_wl import tree_wl_budgets, tree_wl_probe
        from orbital_tpu_torch.utils import native

        torch = self.torch
        pos, vel, mass, budgets = self.plummer()
        cfg = self.tree_config(budgets, track_potential=False)
        state = ot.make_state(pos, vel, mass, precision="f32", device=self.dev)
        rec_steps = 20
        with overflow_log() as ovf:
            reset_launches()
            state = ot.init_forces(state, cfg)
            rec, traj = ot.rollout(state, cfg, rec_steps, record_every=rec_steps // 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fin, none = ot.rollout(rec, cfg, self.drift_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b7 = tree_near_cuda.launches
            overflow = int(ovf[0])
        evals = 1 + rec_steps + self.drift_steps
        if b7 != evals:
            raise AssertionError(f"tree main path: B7 launched {b7} times in {evals} evals")
        if overflow:
            raise AssertionError(f"tree main path: near-field overflow {overflow}")
        if tuple(traj.pos.shape) != (2, N_MAIN, 3) or none is not None:
            raise AssertionError("tree main path: the recorded rollout returned wrong records")
        if not bool(torch.isfinite(fin.pos).all()) or int(fin.step) != rec_steps + \
                self.drift_steps:
            raise AssertionError("tree main path: non-finite state or wrong step count")
        total, entries = tree_wl_probe(fin.pos, fin.alive, levels=TREE_LEVELS, ws=1,
                                       chunk=TREE_CHUNK, rj=TREE_RJ)
        if total > budgets[0] or entries > budgets[1]:
            raise AssertionError(f"tree main path: final probe ({total}, {entries}) outgrew "
                                 f"the budgets {budgets}")
        self.kernels["B7"]["launches"] = b7
        self.tree_ms_per_step = 1e3 * wall / self.drift_steps

        # the tree drift rung: the headline cluster in a pinned box
        cpos, cvel, cmass, _ = self.cluster()
        box = np.asarray(TREE_DRIFT_BOX[:3], np.float32), np.float32(TREE_DRIFT_BOX[3])
        b_d = tree_wl_budgets(cpos, levels=TREE_LEVELS, ws=1, chunk=TREE_CHUNK, rj=TREE_RJ,
                              box=box)
        cfg_d = self.tree_config(b_d, pm_box=TREE_DRIFT_BOX,
                                 track_potential=False).replace(dt=DT, eps2=EPS2)
        st = ot.init_forces(ot.make_state(cpos, cvel, cmass, precision="f32",
                                          device=self.dev), cfg_d)
        E0 = energy_f64(st)
        with overflow_log() as ovf_d:
            fin_d, _ = ot.rollout(st, cfg_d, self.drift_steps)
            torch.cuda.synchronize()
            overflow_d = int(ovf_d[0])
        drift = abs((energy_f64(fin_d) - E0) / E0)
        if overflow_d or not drift <= TREE_DRIFT_BOUND:
            raise AssertionError(f"tree drift {drift:.3e} (bound {TREE_DRIFT_BOUND:g}), "
                                 f"overflow {overflow_d}")

        # simulate(force_impl="tree") on the card, from scene arrays
        scene = SceneArrays(pos=pos, vel=vel, mass=mass, radius=np.full(N_MAIN, 1e-3),
                            names=[f"b{i}" for i in range(N_MAIN)])
        reset_launches()
        res = ot.simulate(scene, steps=10, dt=TREE_DT, softening=TREE_EPS2 ** 0.5,
                          device=self.dev, force_impl="tree", tree_levels=TREE_LEVELS,
                          record_every=5)
        c = res.config
        sim_b7 = tree_near_cuda.launches
        if c.tree_near != "kernel" or sim_b7 < 11 or not np.isfinite(res.pos).all():
            raise AssertionError(f"simulate(force_impl='tree'): tree_near={c.tree_near!r}, "
                                 f"B7 {sim_b7}")
        return (f"bench_tree config (N={N_MAIN} Plummer, l{TREE_LEVELS}, dt {TREE_DT:g}, eps2 "
                f"{TREE_EPS2:g}, f32, budgets {budgets}): init_forces + {rec_steps} recorded + "
                f"{self.drift_steps} unrecorded steps, B7 launched {b7} times in {evals} evals, "
                f"overflow 0, final probe ({total}, {entries}) within the budgets; "
                f"{self.tree_ms_per_step:.3f} ms/step wall | drift run (headline cluster, "
                f"pm_box {TREE_DRIFT_BOX}, dt {DT:g}, eps2 {EPS2:g}, budgets {b_d}): |dE/E| = "
                f"{drift:.3e} over {self.drift_steps} steps (f64, {native.backend()}) <= "
                f"{TREE_DRIFT_BOUND:g}, overflow 0 | simulate: tree_near={c.tree_near!r}, "
                f"levels {c.tree_levels}, max_chunks {c.tree_max_chunks}, wl_entries "
                f"{c.tree_wl_entries}, ds32 state {res.final_state.pos_lo is not None}, B7 "
                f"{sim_b7} launches")

    # phase 24
    def tree_timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops import cuda_tree
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda
        from orbital_tpu_torch.ops.tree import tree_acc_potential
        from orbital_tpu_torch.ops.tree_near_wl import tree_wl_budgets

        torch = self.torch
        pos, vel, mass, budgets = self.plummer()
        t = self.tree_table(pos, mass, np.ones(N_MAIN, bool), TREE_LEVELS, 1, budgets)
        kw_b7 = dict(wl_entries=budgets[1], chunk=TREE_CHUNK, rj=TREE_RJ, ws=1, eps2=TREE_EPS2)

        def b7_bound(tab, n, levels):
            w = tree_near_work(tab, n, levels, 1, TREE_CHUNK, TREE_RJ)
            return w, bound(OPS_TREE * w["needed"], w["nbytes"], rsqrt=w["needed"])

        def b7_call(tab, q):
            return lambda: cuda_tree.tree_near_cuda(tab["pbods"], tab["start_blk"],
                                                    tab["n_blk"], **dict(kw_b7, wl_entries=q))

        b7 = summary(time_ms(b7_call(t, budgets[1]), 20))
        # the wrapper's host time a call (enqueue only): CUDA events count it
        # too where it is longer than the kernel
        call = b7_call(t, budgets[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        b7_host = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        b7_p = summary(time_ms(lambda: cuda_tree.tree_near_plain(
            t["pbods"], t["start_blk"], t["n_blk"], **kw_b7), 1))
        work, bnd = b7_bound(t, N_MAIN, TREE_LEVELS)

        pos_t = torch.tensor(pos, dtype=torch.float32, device=self.dev)
        mass_t = torch.tensor(mass, dtype=torch.float32, device=self.dev)
        alive_t = torch.ones(N_MAIN, dtype=torch.bool, device=self.dev)
        kw = dict(G_grav=1.0, eps2=TREE_EPS2, levels=TREE_LEVELS, ws=1, near="kernel",
                  max_chunks=budgets[0], wl_entries=budgets[1], chunk=TREE_CHUNK,
                  wl_rj=TREE_RJ, with_potential=False)
        far = summary(time_ms(lambda: tree_acc_potential(pos_t, mass_t, alive_t,
                                                         _phase="far", **kw), 5))
        ev = summary(time_ms(lambda: tree_acc_potential(pos_t, mass_t, alive_t, **kw), 5))
        cfg = self.tree_config(budgets, track_potential=False)
        st = ot.init_forces(ot.make_state(pos, vel, mass, precision="f32", device=self.dev),
                            cfg)
        step = summary([x / 10 for x in time_ms(lambda: ot.rollout(st, cfg, 10), 1)])
        prof = device_times(lambda: ot.rollout(st, cfg, 5))
        busy = sum(tm for _, tm in prof.values()) / 5 or None
        launched = sum(cn for cn, _ in prof.values()) / 5
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
        b7_dev = sum(tm for k, (_, tm) in prof.items() if "tree_near" in k) / 5 or None
        self.kernels["B7"].update(ms=b7["median"], plain_ms=b7_p["median"], bound_ms=bnd[0],
                                  bound_by=bnd[1], library_ms=None)

        # N = 1,048,576 Plummer, levels 8
        pos_b, _, mass_b = make_plummer(N_TREE_BIG, self.seed)
        t0 = time.perf_counter()
        b_big = tree_wl_budgets(pos_b, levels=TREE_BIG_LEVELS, ws=1, chunk=TREE_CHUNK,
                                rj=TREE_RJ)
        probe_s = time.perf_counter() - t0
        pb = torch.tensor(pos_b, dtype=torch.float32, device=self.dev)
        mb = torch.tensor(mass_b, dtype=torch.float32, device=self.dev)
        ab = torch.ones(N_TREE_BIG, dtype=torch.bool, device=self.dev)
        kw_big = dict(kw, levels=TREE_BIG_LEVELS, max_chunks=b_big[0], wl_entries=b_big[1])
        a_big, _, ov_big = tree_acc_potential(pb, mb, ab, **kw_big)
        if int(ov_big):
            raise AssertionError(f"tree N={N_TREE_BIG}: overflow {int(ov_big)}")
        sample = torch.tensor(np.random.default_rng(self.seed + 12).choice(
            N_TREE_BIG, TREE_SAMPLE, replace=False), device=self.dev)
        err_big = rms_rel(a_big[sample], exact_acc_f64(pb, mb, sample, TREE_EPS2))
        if err_big > TREE_RMS_BOUND:
            raise AssertionError(f"tree N={N_TREE_BIG}: RMS error {err_big:.3e}")
        ev_big = summary(time_ms(lambda: tree_acc_potential(pb, mb, ab, **kw_big), 1))
        t_big = self.tree_table(pos_b, mass_b, np.ones(N_TREE_BIG, bool), TREE_BIG_LEVELS, 1,
                                b_big)
        b7_big = summary(time_ms(b7_call(t_big, b_big[1]), 5))
        work_big, bnd_big = b7_bound(t_big, N_TREE_BIG, TREE_BIG_LEVELS)
        b1_big = summary(time_ms(lambda: pairwise_acc_cuda(pb, mb, ab, G=1.0, eps2=TREE_EPS2,
                                                           with_potential=False), 1))
        perf = {"b7_N65536": b7, "b7_host_ms": b7_host, "b7_plain": b7_p, "b7_pairs": work,
                "b7_bound": bnd,
                "far_N65536": far, "eval_N65536": ev, "kdk_step_N65536": step,
                "step_device_busy_ms": busy, "step_kernels": launched, "b7_device_ms": b7_dev,
                "step_top_kernels": top, "budgets_N1048576": b_big, "probe_s": probe_s,
                "eval_N1048576": ev_big, "b7_N1048576": b7_big, "b7_pairs_N1048576": work_big,
                "b7_bound_N1048576": bnd_big, "b1_N1048576": b1_big, "rms_N1048576": err_big}
        print("perf_tree " + json.dumps(perf), file=sys.stderr)

        def ms(x):
            return f"{x['median']:.3f} ms (spread {x['spread']:.3f})"

        profiled = ("device time not measured (the profiler recorded none)" if busy is None
                    else f"a step keeps the device busy {busy:.3f} ms of {step['median']:.3f} "
                    f"(idle {100 * (1 - busy / step['median']):.0f}%) with {launched:.0f} "
                    f"kernels, B7 {b7_dev or 0:.3f} ms of device time; top: "
                    + ", ".join(f"{k[:40]} {c}x {tm:.2f} ms" for k, (c, tm) in top[:4]))
        def pairs(w):
            floor = issue_floor_ms(self.kernels["B7"].get("sass_slots_per_pair"), w["issued"])
            return (f"pairs walked {w['walked']}, live {w['live']}, visited {w['visited']} "
                    f"(issued as {w['issued']} lane slots), needed {w['needed']} "
                    f"({100 * w['needed'] / w['walked']:.1f}% of walked, "
                    f"{100 * w['needed'] / w['visited']:.1f}% of visited), issue floor "
                    f"{fmt(floor, 4, ' ms')} at 1.98 GHz")

        return (f"N={N_MAIN} l{TREE_LEVELS}: B7 {ms(b7)} (the wrapper's host time {b7_host:.3f} "
                f"ms a call) vs plain {ms(b7_p)}, {pairs(work)}, "
                f"bound {bnd[0]:.4f} ms ({bnd[1]}, {100 * bnd[0] / b7['median']:.1f}%); far "
                f"field {ms(far)}; evaluation {ms(ev)}; KDK step {ms(step)}; {profiled} | "
                f"N={N_TREE_BIG} l{TREE_BIG_LEVELS} budgets {b_big} (probe {probe_s:.1f} s): "
                f"evaluation {ms(ev_big)}, overflow 0, RMS error vs f64 on {TREE_SAMPLE} "
                f"bodies {err_big:.3e} <= {TREE_RMS_BOUND:g}; B7 {ms(b7_big)}, {pairs(work_big)}, "
                f"bound {bnd_big[0]:.4f} ms ({bnd_big[1]}, "
                f"{100 * bnd_big[0] / b7_big['median']:.1f}%); B1 {ms(b1_big)}")


    # phases 25-29: the exact-force variants
    def variant_scene(self, n: int, dead: int, seed_offset: int):
        """Gaussian positions, masses in [0.5, 1.5] / n and ``dead`` bodies at
        the end parked far, as make_state parks padding: (pos, mass, alive)
        f32 tensors on the card."""
        from orbital_tpu_torch.engine.state import far_positions

        rng = np.random.default_rng(self.seed + seed_offset)
        pos = rng.normal(size=(n, 3))
        mass = rng.uniform(0.5, 1.5, n) / n
        alive = np.ones(n, bool)
        if dead:
            alive[-dead:] = False
            pos[-dead:] = far_positions(dead, float(np.abs(pos).max()), np.float32,
                                        start=n - dead)
        t = self.torch
        return (t.tensor(pos, dtype=t.float32, device=self.dev),
                t.tensor(mass, dtype=t.float32, device=self.dev),
                t.tensor(alive, dtype=t.bool, device=self.dev))

    def exact_f64(self, pos, mass, alive):
        """The softened acc and U in f64 on the card (the chunked sweep)."""
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_plain

        return pairwise_acc_plain(pos.double(), mass.double(), alive, G=1.0, eps2=EPS2)

    @staticmethod
    def rel(x, ref) -> float:
        return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())

    # phase 25
    def check_sym(self) -> str:
        from orbital_tpu_torch.ops.cuda_forces_sym import (pairwise_acc_sym_cuda,
                                                           pairwise_acc_sym_plain)

        torch, rel = self.torch, self.rel
        lines = []
        for n, dead in ((N_MAIN, 7), (N_VAR_RAGGED, N_VAR_RAGGED // 3)):
            pos, mass, alive = self.variant_scene(n, dead, seed_offset=13)
            a, U = pairwise_acc_sym_cuda(pos, mass, alive, G=1.0, eps2=EPS2)
            a0, U0 = pairwise_acc_sym_plain(pos, mass, alive, G=1.0, eps2=EPS2)
            a64, _ = self.exact_f64(pos, mass, alive)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(a).all()) or float(U) != 0.0 or float(U0) != 0.0:
                raise AssertionError(f"B12 N={n}: non-finite acc or U != 0 ({float(U)})")
            if bool(a[~alive].any()):
                raise AssertionError(f"B12 N={n}: dead rows not exactly 0")
            r, r64, r64p = rel(a, a0), rel(a, a64), rel(a0, a64)
            if r > FORCE_RTOL or r64 > FORCE_RTOL:
                raise AssertionError(f"B12 N={n}: vs plain {r:.3e}, vs f64 {r64:.3e}")
            if n == N_MAIN:
                self.kernels["B12"]["max_abs_err"] = float((a - a0).abs().max())
            lines.append(f"N={n} ({dead} dead): vs plain {r:.2e}, vs f64 kernel {r64:.2e} "
                         f"plain {r64p:.2e}")
        refused = []
        for n, eps2 in ((512, 0.0), (5000, EPS2)):
            pos, mass, alive = self.variant_scene(n, 0, seed_offset=13)
            try:
                pairwise_acc_sym_cuda(pos, mass, alive, G=1.0, eps2=eps2)
            except ValueError as exc:
                refused.append(f"N={n} eps2={eps2:g}: {exc}")
            else:
                raise AssertionError(f"B12 accepted N={n}, eps2={eps2:g}")
        return (f"B12 == plain and the f64 sum within max|da|/max|a| <= {FORCE_RTOL:g}, U = 0, "
                f"dead rows 0 [{'; '.join(lines)}]; ValueError for {'; '.join(refused)}")

    # phase 26
    def check_gram(self) -> str:
        from orbital_tpu_torch.ops.cuda_forces_mxu import (gram_sums_cuda, gram_sums_plain,
                                                           pack_gram, pairwise_acc_mxu_cuda,
                                                           pairwise_acc_mxu_plain)
        from orbital_tpu_torch.ops.mxu_forces import pairwise_acc_mxu

        torch, rel = self.torch, self.rel
        lines = []
        for n, dead in ((N_MAIN, 7), (N_VAR_RAGGED, N_VAR_RAGGED // 3)):
            pos, mass, alive = self.variant_scene(n, dead, seed_offset=14)
            a64, U64 = self.exact_f64(pos, mass, alive)
            # the kernel's function, the sums S and pe, against its plain version
            iA, jB = pack_gram(pos, mass * alive)
            s64 = self.gram_exact(pos, iA, jB, EPS2)
            sums = {}
            for pe in (True, False):
                S, P = gram_sums_cuda(iA, jB, eps2=EPS2, with_potential=pe)
                S0, P0 = gram_sums_plain(iA, jB, eps2=EPS2, with_potential=pe)
                torch.cuda.synchronize()
                out, ref = ((S, P), (S0, P0)) if pe else ((S,), (S0,))
                gram_held(out, ref, s64)
                rs, rs_rms = rel(S, S0), rms_rel(S, S0)
                rp, rp_rms = (rel(P, P0), rms_rel(P, P0)) if pe else (0.0, 0.0)
                sums[pe] = (S, rs, rp, rs_rms, rp_rms, S0)
            if not torch.equal(sums[True][0], sums[False][0]):
                raise AssertionError(f"B13 N={n}: the PE-off sums differ from the PE-on sums")
            # the accelerations and U through the wrapper
            out = {}
            for pe in (True, False):
                a, U = pairwise_acc_mxu_cuda(pos, mass, alive, G=1.0, eps2=EPS2,
                                             with_potential=pe)
                out[pe] = (a, U)
            a0, U0 = pairwise_acc_mxu_plain(pos, mass, alive, G=1.0, eps2=EPS2)
            torch.cuda.synchronize()
            (a, U), (a_off, U_off) = out[True], out[False]
            if not torch.equal(a, a_off) or float(U_off) != 0.0 or bool(a[~alive].any()):
                raise AssertionError(f"B13 N={n}: PE-off acc not bit-equal, U != 0 or dead rows")
            ra, ra_max, u = rms_rel(a, a0), rel(a, a0), abs(float(U) / float(U0) - 1.0)
            r64, u64 = rms_rel(a, a64), abs(float(U) / float(U64) - 1.0)
            r64_max = rel(a, a64)
            if ra > GRAM_RTOL or r64 > GRAM_RTOL or r64_max > GRAM_MAX_RTOL or u > ENERGY_RTOL:
                raise AssertionError(f"B13 N={n}: acc vs plain RMS {ra:.3e}, vs the f64 sum "
                                     f"RMS {r64:.3e} max {r64_max:.3e}, U {u:.3e}")
            if n == N_MAIN:
                self.kernels["B13"]["max_abs_err"] = float((sums[False][0] - gram_sums_plain(
                    iA, jB, eps2=EPS2, with_potential=False)[0]).abs().max())
            # the "mxu" route (plain torch) against its own formula in f64
            chunk = 1024 if n % 1024 == 0 else 128
            m, Um = pairwise_acc_mxu(pos, mass, alive, G=1.0, eps2=EPS2, chunk=chunk)
            m64, Um64 = pairwise_acc_mxu(pos.double(), mass.double(), alive, G=1.0, eps2=EPS2,
                                         chunk=chunk, _dtype=torch.float64)
            torch.cuda.synchronize()
            rm, rm_max = rms_rel(m, m64), rel(m, m64)
            rm64, rm64_max = rms_rel(m, a64), rel(m, a64)
            um64 = abs(float(Um) / float(U64) - 1.0)
            if rm > GRAM_RTOL or abs(float(Um) / float(Um64) - 1.0) > ENERGY_RTOL:
                raise AssertionError(f"mxu N={n} vs its f64 form: RMS {rm:.3e}")
            if rm64 > GRAM_RTOL or rm64_max > GRAM_MAX_RTOL or um64 > ENERGY_RTOL:
                raise AssertionError(f"mxu N={n} vs the f64 sum: RMS {rm64:.3e}, max "
                                     f"{rm64_max:.3e}, U {um64:.3e}")
            within = max(sums[True][1], sums[True][2], sums[False][1]) <= FORCE_RTOL
            lines.append(f"N={n} ({dead} dead): B13 sums vs plain max S {sums[True][1]:.2e} pe "
                         f"{sums[True][2]:.2e} (PE off S {sums[False][1]:.2e}), RMS S "
                         f"{sums[True][3]:.2e} pe {sums[True][4]:.2e}, within FORCE_RTOL: "
                         f"{'yes' if within else 'no'}; S vs the exact S RMS "
                         f"{rms_rel(sums[True][0], s64):.2e} max {rel(sums[True][0], s64):.2e}, "
                         f"the plain S's {rms_rel(sums[True][5], s64):.2e} and "
                         f"{rel(sums[True][5], s64):.2e}; acc vs plain RMS "
                         f"{ra:.2e} (max {ra_max:.2e}), U {u:.1e}; vs the f64 sum RMS {r64:.2e} "
                         f"(max {r64_max:.2e}, plain max {rel(a0, a64):.2e}; the CUDA-core form's "
                         f"5.5e-5 and 1.64e-3 at N={N_MAIN}), U {u64:.1e}; "
                         f"mxu vs its f64 form RMS {rm:.2e} (max {rm_max:.2e}), vs the f64 sum "
                         f"RMS {rm64:.2e} (max {rm64_max:.2e}), U {um64:.1e}")
        return (f"B13 pe == plain within RMS <= {GRAM_RTOL:g} and max|d|/max|.| <= "
                f"{GRAM_MAX_RTOL:g}, S vs the exact S within RMS <= {GRAM_S_RTOL:g} "
                f"(GRAM_S_RTOL) and max <= {GRAM_MAX_RTOL:g} (its r2 is the tensor cores' "
                f"3-piece TF32 product), PE-off sums "
                f"and acc bit-equal to PE-on; B13 acc vs plain, and B13 and mxu vs the f64 sum "
                f"and mxu vs its f64 form, within RMS|da|/RMS|a| <= {GRAM_RTOL:g} (GRAM_RTOL); "
                f"B13 and mxu vs the f64 sum within max|da|/max|a| <= {GRAM_MAX_RTOL:g} "
                f"(GRAM_MAX_RTOL); |dU/U| <= {ENERGY_RTOL:g} [{'; '.join(lines)}]")

    # phase 27
    def check_block(self) -> str:
        from orbital_tpu_torch.ops.cuda_forces import (_potential, block_acc_cuda,
                                                       block_acc_plain, pairwise_acc_cuda)

        torch, rel = self.torch, self.rel
        pos, mass, _ = self.variant_scene(N_MAIN, 0, seed_offset=15)
        lines = []
        for n_i, n_j in ((N_BLOCK, N_MAIN), (N_MAIN, N_BLOCK)):
            p_i, p_j, m_j = pos[:n_i], pos[N_MAIN - n_j:], mass[N_MAIN - n_j:]
            a, pe = block_acc_cuda(p_i, p_j, m_j, G=1.0, eps2=EPS2)
            a0, pe0 = block_acc_plain(p_i, p_j, m_j, G=1.0, eps2=EPS2)
            torch.cuda.synchronize()
            ra, rp = rel(a, a0), rel(pe, pe0)
            if ra > FORCE_RTOL or rp > FORCE_RTOL or tuple(a.shape) != (n_i, 3):
                raise AssertionError(f"B3 {n_i}x{n_j}: acc {ra:.3e}, pe {rp:.3e}")
            if n_i == N_BLOCK:
                self.kernels["B3"]["max_abs_err"] = float((a - a0).abs().max())
            lines.append(f"{n_i}x{n_j}: acc {ra:.2e}, pe {rp:.2e}")
        # coinciding tables: B1's sweep, its self PE term kept
        a, pe = block_acc_cuda(pos, pos, mass, G=1.0, eps2=EPS2)
        a1, U1 = pairwise_acc_cuda(pos, mass, None, G=1.0, eps2=EPS2, with_potential=True)
        U3 = _potential(torch.cat([a, pe[:, None]], 1), mass, 1.0, EPS2, True)
        torch.cuda.synchronize()
        if not torch.equal(a, a1):
            raise AssertionError("B3 on coinciding tables: acc differs from B1's")
        if not torch.equal(U3, U1):
            raise AssertionError(f"B3 on coinciding tables: U from its pe row minus m/eps "
                                 f"{float(U3)} != B1's {float(U1)}")
        self_term = float((pe - mass / EPS2 ** 0.5).min()) > 0.0
        return (f"B3 == plain within {FORCE_RTOL:g} [{'; '.join(lines)}]; coinciding "
                f"{N_MAIN}x{N_MAIN}: acc bit-equal to B1's, pe row = B1's + m/eps (U bit-equal "
                f"through B1's self-term subtraction; rows above m/eps: {self_term}); its "
                f"path (the multi-device ring) is ROADMAP A.15")

    # phase 28
    def variants_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops.cuda_collisions import bounce_deltas_cuda
        from orbital_tpu_torch.ops.cuda_forces import block_acc_cuda, pairwise_acc_cuda
        from orbital_tpu_torch.ops.cuda_forces_mxu import gram_sums_cuda
        from orbital_tpu_torch.ops.cuda_forces_sym import pairwise_acc_sym_cuda
        from orbital_tpu_torch.ops.cuda_jerk import accel_jerk_cuda

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, E0 = self.cluster()
        lines, self.variant_ms, b3 = [], {}, 0
        for impl, kernel, steps in (("pallas_sym", pairwise_acc_sym_cuda, self.drift_steps),
                                    ("pallas_mxu", gram_sums_cuda, self.drift_steps),
                                    ("mxu", None, MXU_STEPS)):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl=impl)
            state = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
            reset_launches()
            rec_steps = 20 if kernel is not None else 0
            state = ot.init_forces(state, cfg)
            traj = None
            if rec_steps:
                state, traj = ot.rollout(state, cfg, rec_steps, record_every=rec_steps // 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fin, none = ot.rollout(state, cfg.replace(track_potential=False), steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = kernel.launches if kernel is not None else 0
            b1 = pairwise_acc_cuda.launches
            b3 += block_acc_cuda.launches
            evals = 1 + rec_steps + steps
            if kernel is not None and launched != evals:
                raise AssertionError(f"{impl}: its kernel launched {launched} times in "
                                     f"{evals} evaluations")
            if b1 or b3 or none is not None or int(fin.step) != rec_steps + steps:
                raise AssertionError(f"{impl}: B1 launched {b1} times, B3 {b3}, or wrong "
                                     f"records/steps")
            if not bool(torch.isfinite(fin.pos).all()):
                raise AssertionError(f"{impl}: non-finite state")
            if traj is not None:
                e_rec = traj.energy.double().cpu().numpy()
                if impl == "pallas_sym":  # U = 0: the records hold the kinetic energy
                    ok = bool((traj.energy > 0).all())
                else:
                    ok = bool(np.max(np.abs(e_rec / E0 - 1.0)) <= ENERGY_RTOL)
                if tuple(traj.pos.shape) != (2, n, 3) or not ok:
                    raise AssertionError(f"{impl}: wrong records or energies {e_rec}")
            drift = abs((energy_f64(fin) - E0) / E0)
            if drift > DRIFT_BUDGET:
                raise AssertionError(f"{impl}: |dE/E| = {drift:.3e} over {DRIFT_BUDGET:g}")
            if impl == "pallas_sym":
                self.kernels["B12"]["launches"] = launched
            elif impl == "pallas_mxu":
                self.kernels["B13"]["launches"] = launched
            self.variant_ms[impl] = 1e3 * wall / steps
            lines.append(f"{impl}: init_forces + {rec_steps} recorded + {steps} unrecorded "
                         f"steps, |dE/E| = {drift:.3e}, {self.variant_ms[impl]:.3f} ms/step wall, "
                         f"its kernel {launched} launches, B1 {b1}")
        # B3 has no single-card path: measured 0 over the three main paths
        self.kernels["B3"]["launches"] = b3

        # "pallas_sym" with bounce at the bench row's radius: B6 ungated
        radius = np.full(n, R_BENCH)
        fins = {}
        for mode in ("bounce", "none"):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl="pallas_sym",
                               collisions=mode, restitution=1.0, track_potential=False)
            st = ot.make_state(pos, vel, mass, radius, precision="ds32", device=self.dev)
            reset_launches()
            fins[mode], _ = ot.rollout(ot.init_forces(st, cfg), cfg, 100)
            torch.cuda.synchronize()
            if mode == "bounce":
                b6, b12 = bounce_deltas_cuda.launches, pairwise_acc_sym_cuda.launches
        diff = max_state_err(fins["bounce"], fins["none"])
        if b6 != 100 or b12 != 101 or diff > STATE_ATOL:
            raise AssertionError(f"pallas_sym + bounce: B6 {b6}, B12 {b12} launches, max "
                                 f"state diff {diff:.3e}")

        # simulate(): Hermite with this policy runs the acc + jerk kernel
        scene = SceneArrays(pos=pos, vel=vel, mass=mass, radius=np.full(n, R_BENCH),
                            names=[f"b{i}" for i in range(n)])
        reset_launches()
        res = ot.simulate(scene, steps=10, dt=DT, softening=EPS2 ** 0.5, device=self.dev,
                          force_impl="pallas_sym", integrator="hermite", record_every=5,
                          precision="ds32")
        b5, b12_sim = accel_jerk_cuda.launches, pairwise_acc_sym_cuda.launches
        if b5 != 11 or b12_sim or not np.isfinite(res.pos).all():
            raise AssertionError(f"simulate(pallas_sym, hermite): B5 {b5}, B12 {b12_sim}")
        return ("; ".join(lines) + f"; B3 {b3} launches over the three | pallas_sym + "
                f"bounce R={R_BENCH:g}, 100 steps: B6 {b6} "
                f"launches (ungated), B12 {b12}, max state diff from the collision-free run "
                f"{diff:.2e} <= {STATE_ATOL:g} | simulate(pallas_sym, hermite) 10 steps: B5 "
                f"{b5} launches, B12 {b12_sim}")

    # the eleven kernels of the eight redesigned sources, for --sweep and
    # --parent: max |d| / max |ref| of each output (0: equal); B13 by
    # gram_held; B4 (FUSED_CASES' keys) by max |d| on the full positions and
    # velocities (absolute: STATE_ATOL); B6G is B6 gated on the scene's contact
    # count, B6Z on a zero count (the gate's cost); B7, B7R, B7L and B7S are
    # tree_calls' tables, NEAR, NEARW and NEARR near_calls' geometries
    TOLS = {"B1": (FORCE_RTOL, ENERGY_RTOL), "B2": (FORCE_RTOL, ENERGY_RTOL, 0),
            "B3": (FORCE_RTOL, FORCE_RTOL), "B5": (FORCE_RTOL, JERK_RTOL, ENERGY_RTOL),
            "B5S": (FORCE_RTOL, JERK_RTOL),
            "B5D": (FORCE_RTOL, JERK_RTOL, ENERGY_RTOL, 0),
            "B13": (GRAM_MAX_RTOL, GRAM_MAX_RTOL), "B6": (BOUNCE_RTOL, BOUNCE_RTOL),
            "B6G": (BOUNCE_RTOL, BOUNCE_RTOL), "B6Z": (0, 0),
            "B12": (FORCE_RTOL, FORCE_RTOL), "B7": (NEAR_RTOL, NEAR_RTOL),
            "B7R": (NEAR_RTOL, NEAR_RTOL), "B7L": (NEAR_RTOL, NEAR_RTOL),
            "B7S": (NEAR_RTOL, NEAR_RTOL, 0), "NEAR": (NEAR_RTOL, NEAR_RTOL),
            "NEARW": (NEAR_RTOL, NEAR_RTOL), "NEARR": (NEAR_RTOL, NEAR_RTOL),
            "P3M": (SHORT_RTOL, SHORT_RTOL),
            **{k: (STATE_ATOL, STATE_ATOL) for k in FUSED_CASES}}
    # the source of each, the calls timed in turns and the pairs that must
    # be bit-equal
    SOURCE = {"B1": "nbody_forces", "B2": "nbody_forces", "B3": "nbody_forces",
              "B5": "nbody_jerk", "B5D": "nbody_jerk", "B5S": "nbody_jerk",
              "B13": "nbody_forces_mxu",
              "B6": "collisions", "B6G": "collisions", "B6Z": "collisions",
              "B12": "nbody_forces_sym", "B7": "tree_near", "B7R": "tree_near",
              "B7L": "tree_near", "B7S": "tree_near", "NEAR": "neighbor",
              "NEARW": "neighbor", "NEARR": "neighbor",
              **{k: "fused_rollout" for k in FUSED_CASES}}
    TIMED = {"nbody_forces": ("B1", "B2"), "nbody_jerk": ("B5", "B5D", "B5S"),
             "nbody_forces_mxu": ("B13",), "collisions": ("B6", "B6Z"),
             "nbody_forces_sym": ("B12",), "tree_near": ("B7", "B7L"),
             "neighbor": ("NEAR",), "fused_rollout": ("B4", "B4L")}
    SAME = {"nbody_forces": ("B1", "B2"), "nbody_jerk": ("B5", "B5D"),
            "collisions": ("B6", "B6G")}

    def hold(self, key: str, out, ref, call=None) -> tuple[float, bool]:
        """``held`` with ``key``'s tolerances, for B13 ``gram_held``
        against the exact sums that ``exact_calls`` attached to its
        ``call``, for B4 the largest |difference| of the full positions and
        velocities within STATE_ATOL; and whether every output is
        bit-equal."""
        if key in FUSED_CASES:
            errs = [float((x - y).abs().max()) for x, y in zip(out, ref)]
            for i, (err, tol) in enumerate(zip(errs, self.TOLS[key])):
                if not err <= tol:
                    raise AssertionError(f"{key} output {i}: max difference {err:.3e} > "
                                         f"{tol:g}")
            return max(errs), all(bool((x == y).all()) for x, y in zip(out, ref))
        if key != "B13":
            return held(out, ref, self.TOLS[key])
        equal = all(bool((x == y).all()) for x, y in zip(out, ref))
        return gram_held(out, ref, call.exact()), equal

    def gram_exact(self, pos, iA, jB, eps2: float):
        """S of the packed rows in f64, once for each scene and eps2."""
        from orbital_tpu_torch.ops.cuda_forces_mxu import gram_sums_plain

        cache = self.__dict__.setdefault("_gram_exact", {})
        key = (id(pos), eps2)
        if key not in cache:
            s64, _ = gram_sums_plain(iA.double(), jB.double(), eps2=eps2,
                                     with_potential=False)
            cache[key] = (pos, s64)
        return cache[key][1]

    def exact_calls(self, scene, eps2: float, pe: bool, plain: bool = False) -> dict:
        """{key: (wrapper module, call)} of B1 and B2 (PE as ``pe``), B3 (on
        coinciding tables; with PE, eps2 > 0 and N % 128 == 0 only), B5, B5
        detect and the B5 row subset (64 rows, the last dead) on ``scene``,
        B13 (its sums S and pe) and B12 (eps2 > 0 and N % 128 == 0 only), and
        B6 ungated and gated on B2's count (restitution 0.8) and on a zero
        count; with ``plain``, their plain versions."""
        from orbital_tpu_torch.ops import cuda_collisions as cc
        from orbital_tpu_torch.ops import cuda_forces as cf
        from orbital_tpu_torch.ops import cuda_forces_mxu as cm
        from orbital_tpu_torch.ops import cuda_forces_sym as cs
        from orbital_tpu_torch.ops import cuda_jerk as cj

        pos, vel, mass, rad, alive = scene
        kw = dict(G=1.0, eps2=eps2)
        sfx = "_plain" if plain else "_cuda"
        # the block steppers' 64 fast rows, the last a dead one
        idx = self.torch.arange(0, pos.shape[0], max(1, pos.shape[0] // 64),
                                device=pos.device)[:64]
        idx[-1] = pos.shape[0] - 1
        count = cf.pairwise_acc_detect_cuda(pos, mass, rad, alive, with_potential=False,
                                            **kw)[2]

        def fn(mod, name):
            return getattr(mod, name + sfx)

        def b6(contacts):
            return lambda: fn(cc, "bounce_deltas")(pos, vel, mass, rad, alive,
                                                   restitution=0.8, contacts=contacts)

        calls = {
            "B1": (cf, lambda: fn(cf, "pairwise_acc")(pos, mass, alive, with_potential=pe,
                                                       **kw)),
            "B2": (cf, lambda: fn(cf, "pairwise_acc_detect")(pos, mass, rad, alive,
                                                              with_potential=pe, **kw)),
            "B5": (cj, lambda: fn(cj, "accel_jerk")(pos, vel, mass, alive, **kw)),
            "B5D": (cj, lambda: fn(cj, "accel_jerk_detect")(pos, vel, mass, rad, alive, **kw)),
            "B5S": (cj, lambda: fn(cj, "accel_jerk_subset")(idx, pos, vel, mass, alive, **kw)),
            "B6": (cc, b6(None)),
            "B6G": (cc, b6(count)),
            "B6Z": (cc, b6(self.torch.zeros_like(count))),
        }
        if eps2 > 0 and pos.shape[0] % 128 == 0:
            m_eff = mass * alive
            if pe:
                calls["B3"] = (cf, lambda: fn(cf, "block_acc")(pos, pos, m_eff, **kw))
            iA, jB = cm.pack_gram(pos, m_eff)

            def b13():
                return tuple(x for x in fn(cm, "gram_sums")(iA, jB, eps2=eps2,
                                                            with_potential=pe)
                             if x is not None)

            b13.exact = lambda: self.gram_exact(pos, iA, jB, eps2)
            calls["B13"] = (cm, b13)
            calls["B12"] = (cs, lambda: fn(cs, "pairwise_acc_sym")(pos, mass, alive, **kw))
        return calls

    def tree_calls(self, plain: bool = False, sizes=None) -> dict:
        """{key: (wrapper module, call)} of B7 on tree tables made once on
        the card: B7 on the main path's (``plummer()``: levels 7, ws 1), B7R
        on the ragged bodies with a third dead at ws 2 and B7L on 1,048,576
        bodies at levels 8, each returning (acc, pe) of the kept slots with
        ``pairs``, the lane slots of ``tree_near_work``; B7S the ragged
        bodies' whole near phase (``tree_acc_potential``) at starved
        budgets, returning (acc, U, overflow), whose overflow is > 0.
        ``sizes`` overrides ((N_MAIN, TREE_LEVELS), (N_TREE_RAGGED,
        TREE_RAGGED_LEVELS), (N_TREE_BIG, TREE_BIG_LEVELS)); a last entry of
        None drops B7L. With ``plain``, their plain versions."""
        from orbital_tpu_torch.ops import cuda_tree
        from orbital_tpu_torch.ops.tree import tree_acc_potential
        from orbital_tpu_torch.ops.tree_near_wl import tree_wl_budgets, tree_wl_probe

        torch = self.torch
        sizes = sizes or ((N_MAIN, TREE_LEVELS), (N_TREE_RAGGED, TREE_RAGGED_LEVELS),
                          (N_TREE_BIG, TREE_BIG_LEVELS))
        cache = self.__dict__.setdefault("_tree_calls", {})
        if sizes not in cache:
            (n0, l0), (n1, l1), big = sizes
            tabs = {}
            for key, (n, levels) in (("B7", (n0, l0)), ("B7L", big)):
                if key == "B7L" and big is None:
                    continue
                pos, _, mass = make_plummer(n, self.seed)
                b = tree_wl_budgets(pos, levels=levels, ws=1, chunk=TREE_CHUNK, rj=TREE_RJ)
                tabs[key] = (self.tree_table(pos, mass, np.ones(n, bool), levels, 1, b), b,
                             1, n, levels)
            pos, mass, alive = self.ragged_tree_scene(n1)
            b = tree_wl_budgets(pos, alive, levels=l1, ws=2, chunk=TREE_CHUNK, rj=TREE_RJ)
            tabs["B7R"] = (self.tree_table(pos, mass, alive, l1, 2, b), b, 2, n1, l1)
            total, entries = tree_wl_probe(pos, alive, levels=l1, ws=1, chunk=TREE_CHUNK,
                                           rj=TREE_RJ)
            starved = (max(1, total - total // 4), max(1, entries // 4))
            near = [torch.tensor(x, device=self.dev) for x in
                    (pos.astype(np.float32), mass.astype(np.float32), alive)]
            near_kw = dict(G_grav=1.0, eps2=TREE_EPS2, levels=l1, ws=1, near="kernel",
                           max_chunks=starved[0], wl_entries=starved[1], chunk=TREE_CHUNK,
                           wl_rj=TREE_RJ, _phase="near")
            work = {k: tree_near_work(t, n, lv, ws, TREE_CHUNK, TREE_RJ)["issued"]
                    for k, (t, _, ws, n, lv) in tabs.items() if k != "B7R"}
            cache[sizes] = (tabs, near, near_kw, work)
        tabs, near, near_kw, work = cache[sizes]

        def table_call(key):
            t, b, ws, _, _ = tabs[key]
            slots = t["slot"][t["keep"]]

            def call():
                sweep = cuda_tree.tree_near_plain if plain else cuda_tree.tree_near_cuda
                out = sweep(t["pbods"], t["start_blk"], t["n_blk"], wl_entries=b[1],
                            chunk=TREE_CHUNK, rj=TREE_RJ, ws=ws, eps2=TREE_EPS2)
                return out[slots, :3], out[slots, 3]

            call.pairs = work.get(key)
            return cuda_tree, call

        def near_phase():
            with plain_tree_near() if plain else contextlib.nullcontext():
                return tree_acc_potential(*near, **near_kw)

        calls = {k: table_call(k) for k in tabs}
        calls["B7S"] = (cuda_tree, near_phase)
        return calls

    def near_calls(self, plain: bool = False, sizes=None) -> dict:
        """{key: (wrapper module, call)} of the near sweep, each returning
        (acc, pe): NEAR on the main path's geometry (the 65,536-body
        cluster) with the channels as the columns of a row table, as the
        RESPA stepper passes them, and ``pairs``, the lane slots of
        ``near_work``; NEARW the same through the worklist; NEARR the ragged
        starved scene's table. ``sizes`` overrides (N_MAIN, N_NEAR_RAGGED).
        With ``plain``, their plain versions."""
        from orbital_tpu_torch.ops import cuda_neighbor as cn
        from orbital_tpu_torch.ops import neighbor as nb

        sizes = sizes or (N_MAIN, N_NEAR_RAGGED)
        cache = self.__dict__.setdefault("_near_calls", {}).setdefault(sizes, {})
        if not cache:
            n = sizes[0]
            pos = np.random.default_rng(self.seed).normal(size=(n, 3))
            budgets = (self.respa_budgets() if n == N_MAIN else nb.neighbor_budgets(
                pos, cell=CELL_RESPA, chunk=32, rj=4, with_wl=True, headroom=2.2,
                w_headroom=1.5))
            for key, case in (("main", (pos, np.full(n, 1.0 / n), np.ones(n, bool), budgets)),
                              ("ragged", self.ragged_near_scene(sizes[1]))):
                geom, ch = self.near_case(*case)
                P = self.torch.stack(ch, dim=1)
                cache[key] = (geom, (P[:, 0], P[:, 1], P[:, 2], P[:, 3]))
            cache["pairs"] = near_work(*cache["main"], RC_RESPA, 32, 4)["issued"]
        kw = dict(r1=0.5 * RC_RESPA, rc=RC_RESPA, G=1.0, eps2=EPS2, chunk=32, rj=4)
        table = nb.near_acc_slots if plain else cn.near_acc_slots_cuda
        wl = cn.near_acc_slots_wl_plain if plain else cn.near_acc_slots_cuda_wl

        def call(case, worklist=False):
            geom, ch = cache[case]
            if worklist:
                return lambda: wl(*ch, geom["wl_i"], geom["wl_jb"], **kw)
            return lambda: table(*ch, geom["jbl"], **kw)

        calls = {"NEAR": call("main"), "NEARW": call("main", True), "NEARR": call("ragged")}
        calls["NEAR"].pairs = cache["pairs"]
        return {k: (cn, c) for k, c in calls.items()}

    def fused_calls(self, plain: bool = False, timing: bool = False, cases=None) -> dict:
        """{key: (wrapper module, call)} of B4 on the scenes of ``cases``
        (default FUSED_CASES), each returning the full positions and
        velocities (f64) after 10 steps, or with ``timing`` 200 steps (20 at
        N_FUSED_BIG), and ``pairs``, the pairs its sweeps walk (the seeding
        one included). With ``plain``, the plain KDK loop."""
        from orbital_tpu_torch.ops import fused_rollout as fr

        fn = fr.fused_rollout_plain if plain else fr.fused_rollout

        def call(n, live, precision):
            st, cfg = self.fused_state(n, live, precision)
            steps = (20 if n == N_FUSED_BIG else 200) if timing else 10

            def run():
                out = fn(st, cfg, steps)
                return out.pos_full().double(), out.vel_full().double()

            run.pairs = n * n * (steps + 1)
            return fr, run

        return {k: call(*case) for k, case in (cases or FUSED_CASES).items()}

    def redesigned(self):
        """The wrapper module of each source in SHAPED."""
        from orbital_tpu_torch.ops import (cuda_collisions, cuda_forces, cuda_forces_mxu,
                                           cuda_forces_sym, cuda_jerk, cuda_neighbor,
                                           cuda_tree, fused_rollout)

        return {"nbody_forces": cuda_forces, "nbody_jerk": cuda_jerk,
                "nbody_forces_mxu": cuda_forces_mxu, "collisions": cuda_collisions,
                "nbody_forces_sym": cuda_forces_sym, "tree_near": cuda_tree,
                "neighbor": cuda_neighbor, "fused_rollout": fused_rollout}

    # --sweep
    def sweep(self) -> str:
        from orbital_tpu_torch.utils import kernels

        torch = self.torch
        mods = self.redesigned()
        jobs, variants = [], []
        for name, shapes in SWEEP.items():
            m = SWEEP_MACRO[name]
            for shape in shapes:
                tag = "k{}q{}".format(*shape)
                flags = (f"-D{m}_K={shape[0]}", f"-D{m}_Q={shape[1]}")
                out = kernels.BUILD_DIR / "sweep" / f"lib{name}-{tag}.so"
                jobs.append((kernels.CSRC_DIR / f"{name}.cu", out, flags))
                variants.append((name, tag, out))
        t0 = time.perf_counter()
        built = compile_libraries(jobs)
        build_s = time.perf_counter() - t0
        # {group: calls(plain=False)}: exact_calls on the rich scene at N_MAIN
        # and N_RAGGED (eps2 1e-4, PE on) and tree_calls
        scenes = {n: self.scene(n, R_RICH, 7, seed_offset=17, cluster=False)
                  for n in (N_MAIN, N_RAGGED)}
        groups = {n: (lambda sc: lambda plain=False: self.exact_calls(sc, EPS2, True,
                                                                      plain=plain))(sc)
                  for n, sc in scenes.items()}
        groups.update(tree=self.tree_calls, near=self.near_calls, fused=self.fused_calls)
        refs = {g: {k: c() for k, (_, c) in mk(plain=True).items()} for g, mk in groups.items()}
        torch.cuda.synchronize()
        rows, timed = {}, {}
        timed_calls = {**self.exact_calls(scenes[N_MAIN], EPS2, pe=False),
                       **self.tree_calls(), **self.near_calls(),
                       **self.fused_calls(timing=True)}
        at = {"tree_near": self.plummer()[3][0], "neighbor": self.respa_budgets()[1]}
        for name, tag, out in variants:
            mod = mods[name]
            lib = bind_like(out, mod._load(), LIB_FUNCS[name])
            rec = launch_record(lib, name, built[out][0], sass(out), n=at.get(name, N_MAIN))
            worst = 0.0
            for group, mk in groups.items():
                calls = mk()
                outs = {k: on(mod, lib, c) for k, (m_, c) in calls.items() if m_ is mod}
                for k, o in outs.items():
                    worst = max(worst, self.hold(k, o, refs[group][k], calls[k][1])[0])
                if name in self.SAME and outs:
                    base, det = self.SAME[name]
                    if not all(torch.equal(x, y) for x, y in zip(outs[base], outs[det])):
                        raise AssertionError(f"{name} {tag} at N={group}: {det} differs from "
                                             f"{base}")
            for k in self.TIMED[name]:
                timed[f"{tag} {k}"] = (lambda m_, l_, c_: lambda: on(m_, l_, c_))(
                    mod, lib, timed_calls[k][1])
            rows[f"{name} {tag}"] = {"launch": rec, "worst_vs_plain": worst}
        times = {k: summary(v) for k, v in alternate_ms(timed, 10, repeats=4).items()}
        for key, row in rows.items():
            name, tag = key.split()
            row["ms"] = {k: times[f"{tag} {k}"] for k in self.TIMED[name]}
        print("perf_sweep " + json.dumps(rows), file=sys.stderr)
        lines = []
        for key, row in rows.items():
            rec = next(iter(row["launch"].values()))
            hmma = (f", {rec['tf32_hmma_in_loop']} TF32 HMMA in the loop"
                    if "tf32_hmma_in_loop" in rec else "")
            lines.append(f"{key}: " + ", ".join(
                f"{k} {v['median']:.3f} ms (spread {v['spread']:.3f})"
                for k, v in row["ms"].items())
                + f", {rec['registers']} registers, {rec['spill_bytes']} spill bytes, "
                f"{fmt(rec['sass_slots_per_pair'])} instructions a pair{hmma}, vs plain "
                f"{row['worst_vs_plain']:.2e}")
        return (f"{len(variants)} launch shapes built in {build_s:.1f} s, each within the "
                f"tolerances of the plain versions at N={N_MAIN} and {N_RAGGED} (7 dead, "
                f"eps2 {EPS2:g}, PE on, R {R_RICH:g}) with detect bit-equal, counts exact and "
                f"gated B6 bit-equal to ungated, on the tree tables (B7 at N={N_MAIN} and "
                f"{N_TREE_BIG}, ragged ws 2, starved near phase with its overflow equal), on "
                f"the RESPA geometries (the near sweep at N={N_MAIN}, table and worklist, and "
                f"the ragged starved {N_NEAR_RAGGED}) and B4's scenes (10 steps: {FUSED_CASES} "
                f"within {STATE_ATOL:g}); N={N_MAIN} no PE (B4: 200 steps at {N_FUSED} ds32, "
                f"20 at {N_FUSED_BIG}), in turns: " + "; ".join(lines))

    # --parent
    def roots_calls(self) -> dict:
        """The root search's main-path calls for ``--parent``: ``{key:
        call(gated) -> parents}`` on the cluster at R_RICH (ROOTS, a count >
        0) and R_BENCH (ROOTS0, a count of 0), with the detecting sweep's
        count."""
        from orbital_tpu_torch.ops.cuda_collisions import collision_parents_cuda
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_detect_cuda

        pos0, vel0, mass0, _ = self.cluster()
        out = {}
        for key, radius in (("ROOTS", R_RICH), ("ROOTS0", R_BENCH)):
            st = self.torch_state(pos0, vel0, mass0, radius)
            _, _, count = pairwise_acc_detect_cuda(st.pos, st.mass, st.radius, st.alive,
                                                   G=1.0, eps2=EPS2, with_potential=False)
            out[key] = (lambda st_, c_: lambda gated: collision_parents_cuda(
                st_.pos, st_.radius, st_.alive, contacts=c_ if gated else None))(st, count)
        return out

    def check_parent(self, parent: str) -> str:
        from pathlib import Path

        from orbital_tpu_torch.utils import kernels

        from orbital_tpu_torch.ops import cuda_p3m
        from orbital_tpu_torch.ops.cuda_p3m import p3m_short_cuda

        mods = self.redesigned()
        jobs = {name: (Path(parent) / "orbital_tpu_torch" / "csrc" / f"{name}.cu",
                       kernels.BUILD_DIR / "parent" / f"lib{name}.so")
                for name in (*mods, "p3m_short", "collision_roots")}
        compile_libraries([(src, out, ()) for src, out in jobs.values()])
        old = {mod: other_build(name, jobs[name][1], mod._load())
               for name, mod in (*mods.items(), ("p3m_short", cuda_p3m))}
        roots = RootsLib()
        old[roots] = bind_like(jobs["collision_roots"][1], roots.load(),
                               ("collision_parents", "ot_error_string"))
        scene = self.scene(N_MAIN, R_RICH, 7, seed_offset=17, cluster=False)
        worst, equal, counts, cases = {}, {}, set(), 0

        def hold(k, mod, call):
            nonlocal cases
            ref, out = on(mod, old[mod], call), call()
            rel, eq = self.hold(k, out, ref, call)
            worst[k] = max(worst.get(k, 0.0), rel)
            equal[k] = equal.get(k, True) and eq
            cases += 1
            return ref, out

        for eps2 in (EPS2, 0.0):
            for pe in (True, False):
                calls = self.exact_calls(scene, eps2, pe)
                outs = {}
                for k, (mod, call) in calls.items():
                    if k in ("B5", "B5D", "B5S") and not pe:
                        continue  # no PE switch: once for each eps2
                    if k in ("B6", "B6G", "B6Z", "B12") and not (pe and eps2 > 0):
                        continue  # neither: once
                    ref, outs[k] = hold(k, mod, call)
                    if k == "B6":  # bounced rows whose deltas equal the parent's
                        moved = ref[1].abs().amax(1) > 0
                        same = (outs[k][0] == ref[0]).all(1) & (outs[k][1] == ref[1]).all(1)
                        b6_rows = (int((same & moved).sum()), int(moved.sum()))
                    if k in ("B2", "B5D"):
                        counts.add(int(outs[k][-1]))
                if "B6G" in outs and not all(
                        self.torch.equal(x, y) for x, y in zip(outs["B6"], outs["B6G"])):
                    raise AssertionError("B6 gated on the count differs from B6 ungated")
        tree = self.tree_calls()
        overflow = int(hold("B7S", *tree["B7S"])[1][2])
        for k in ("B7", "B7R", "B7L"):
            hold(k, *tree[k])
        near, fused = self.near_calls(), self.fused_calls()
        for k, v in {**near, **fused}.items():
            hold(k, *v)
        # the P3M short range on the bench row's table
        tab, kw_p = self.p3m_bench_case()
        kw_t = dict(kw_p, sigma=self.t(kw_p["sigma"]), rcut2=self.t(kw_p["rcut2"]))
        p3m_call = (lambda: p3m_short_cuda(tab["table"], tab["cell_pos"], tab["cell_m"],
                                           count=tab["count"], **kw_t))
        p3m_call.pairs = p3m_short_work(tab, kw_p["gc"], kw_p["n"], kw_p["rcut2"])["issued"]
        hold("P3M", cuda_p3m, p3m_call)
        # the merge root search: parents integer-equal, gated and ungated, at
        # the contact-rich radius; timed at a count > 0 (ROOTS) and 0 (ROOTS0)
        roots_calls = self.roots_calls()
        for k, call in roots_calls.items():
            for gate in (True, False):
                ref, out = on(roots, old[roots], lambda: call(gate)), call(gate)
                if not self.torch.equal(ref, out):
                    raise AssertionError(f"{k}: parents differ from the parent build's "
                                         f"(gated {gate}): {int((ref != out).sum())} rows")
                cases += 1
            worst[k], equal[k] = 0.0, True
        fused_t = self.fused_calls(timing=True)
        calls = {k: v for k, v in self.exact_calls(scene, EPS2, pe=False).items()
                 if k != "B6G"}
        calls["B3"] = self.exact_calls(scene, EPS2, pe=True)["B3"]
        calls.update(B7=tree["B7"], B7L=tree["B7L"], NEAR=near["NEAR"],
                     P3M=(cuda_p3m, p3m_call))
        calls.update({k: fused_t[k] for k in ("B4", "B4F", "B4L", "B4LF")})
        calls.update({k: (roots, (lambda c: lambda: c(True))(call))
                      for k, call in roots_calls.items()})
        fns = {}
        for k, (mod, call) in calls.items():
            fns[f"{k} parent"] = (lambda m_, l_, c_: lambda: on(m_, l_, c_))(mod, old[mod], call)
            fns[k] = call
        times = {k: summary(v) for k, v in alternate_ms(fns, 10, repeats=6).items()}
        # the block macro step (rungs 1) on each build's row subset, in turns:
        # its time by CUDA events and the host's time to queue it
        cj = mods["nbody_jerk"]
        macro = self.block_macro_call()
        steps = {"macro parent": lambda: on(cj, old[cj], macro), "macro": macro}
        macro_t = {k: summary(v) for k, v in alternate_ms(steps, 1, repeats=10).items()}
        macro_h = {k: summary(v) for k, v in alternate_ms(steps, 1, repeats=10,
                                                          timer=host_ms).items()}
        # instructions a pair of both builds, and the SM clock under each of
        # this tree's kernels: the issue floor at the clock the card ran
        slots = {"parent": {}, "this": {}}
        for name in mods:
            slots["parent"].update(sass_slots(name, sass(jobs[name][1])))
            slots["this"].update(sass_slots(name, sass(kernels._library_path(name)[1])))
        slots["this"]["P3M"] = self.kernels["P3M"].get("sass_slots_per_pair")
        clocks = {k: clock_during(call) for k, (_, call) in calls.items()}
        print("perf_parent " + json.dumps({"times": times, "slots": slots, "clocks": clocks,
                                           "block_macro_ms": macro_t,
                                           "block_macro_host_ms": macro_h}), file=sys.stderr)
        lines = []
        for k, (_, call) in calls.items():
            this, par = times[k], times[f"{k} parent"]
            faster = max(this["runs"]) < min(par["runs"])
            base = {"B7L": "B7", "B4F": "B4", "B4L": "B4", "B4LF": "B4"}.get(k, k)
            line = (f"{k} {'bit-equal' if equal[k] else 'not bit-equal'} (max rel diff "
                    f"{worst[k]:.2e}), {this['median']:.3f} ms (spread {this['spread']:.3f}) "
                    f"vs parent {par['median']:.3f} ({par['spread']:.3f}), "
                    f"{par['median'] / this['median']:.2f}x, faster outside both spreads: "
                    f"{'yes' if faster else 'no'}; instructions a pair "
                    f"{fmt(slots['this'].get(base))} (parent {fmt(slots['parent'].get(base))})")
            if k == "B6":
                line += f"; bounced rows bit-equal to the parent's: {b6_rows[0]} of {b6_rows[1]}"
            mhz = clocks[k]["sm_mhz"]
            pairs = getattr(call, "pairs", None) or loop_pairs(k, self.kernels.get(k, {}))
            floor = (None if isinstance(mhz, str)
                     else issue_floor_ms(slots["this"].get(base), pairs, mhz))
            if floor is not None:
                line += (f", SM clock {mhz:.0f} MHz at {clocks[k]['watts']:.0f} W: issue "
                         f"floor {floor:.3f} ms ({100 * floor / this['median']:.0f}%)")
            lines.append(line)
        lines.append("block macro step (rungs 1, m = {}) {}".format(macro.m, ", ".join(
            f"{k} {macro_t[k]['median']:.3f} ms (spread {macro_t[k]['spread']:.3f}), host "
            f"{macro_h[k]['median']:.3f} ms (spread {macro_h[k]['spread']:.3f})"
            for k in steps)))
        return (f"B1, B2, B3, B5, B5 detect, the B5 subset, B13, B6, B12, B7, the near sweep, "
                f"B4, the P3M short range and the root search held "
                f"against the build of "
                f"{parent}'s sources in {cases} calls (N={N_MAIN}, 7 dead, R {R_RICH:g}, eps2 "
                f"{EPS2:g} and 0, PE on and off; within {FORCE_RTOL:g} / {JERK_RTOL:g} / "
                f"{ENERGY_RTOL:g}, B13's pe within {GRAM_RTOL:g} RMS and {GRAM_MAX_RTOL:g} max "
                f"and its S within {GRAM_S_RTOL:g} RMS and {GRAM_MAX_RTOL:g} max of the exact S, "
                f"B6 within {BOUNCE_RTOL:g} and gated == ungated, contact counts equal: "
                f"{sorted(counts)}; B7 within {NEAR_RTOL:g} on the tree tables at N={N_MAIN}, "
                f"{N_TREE_BIG} and the ragged ws 2, and its starved near phase with overflow "
                f"{overflow} equal; the near sweep within {NEAR_RTOL:g} at N={N_MAIN} (table, "
                f"worklist) and the ragged starved {N_NEAR_RAGGED}; B4 after 10 steps within "
                f"{STATE_ATOL:g} on {FUSED_CASES}; the P3M short range within {SHORT_RTOL:g} "
                f"on the bench row's table; the root search's parents equal, gated and "
                f"ungated, at R {R_RICH:g} and {R_BENCH:g}); in turns, 6 runs each (B1, B2, "
                f"B13 no PE; ROOTS at a count > 0, ROOTS0 at 0; "
                f"B3 PE; B6 ungated, B6Z at a zero count; B12; B7 at N={N_MAIN} and B7L at "
                f"{N_TREE_BIG}; NEAR the table sweep at N={N_MAIN}; B4 200 steps at {N_FUSED}, "
                f"ds32 and B4F f32, B4L and B4LF 20 steps at {N_FUSED_BIG}): "
                + "; ".join(lines))

    # phase 29
    def variant_timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_forces import (block_acc_cuda, block_acc_plain,
                                                       pairwise_acc_cuda)
        from orbital_tpu_torch.ops.cuda_forces_mxu import (pairwise_acc_mxu_cuda,
                                                           pairwise_acc_mxu_plain)
        from orbital_tpu_torch.ops.cuda_forces_sym import (pairwise_acc_sym_cuda,
                                                           pairwise_acc_sym_plain)
        from orbital_tpu_torch.ops.mxu_forces import pairwise_acc_mxu

        n = N_MAIN
        pos, mass, alive = self.variant_scene(n, 0, seed_offset=16)
        kw = dict(G=1.0, eps2=EPS2)
        kern = {k: summary(v) for k, v in alternate_ms({
            "B1": lambda: pairwise_acc_cuda(pos, mass, alive, with_potential=False, **kw),
            "B1_pe": lambda: pairwise_acc_cuda(pos, mass, alive, **kw),
            "B12": lambda: pairwise_acc_sym_cuda(pos, mass, alive, **kw),
            "B13": lambda: pairwise_acc_mxu_cuda(pos, mass, alive, with_potential=False, **kw),
            "B13_pe": lambda: pairwise_acc_mxu_cuda(pos, mass, alive, **kw),
            "B3_pe": lambda: block_acc_cuda(pos, pos, mass, **kw),
        }, 10).items()}
        mxu = summary(time_ms(lambda: pairwise_acc_mxu(pos, mass, alive, chunk=1024, **kw), 1))
        plain = {
            "B12": summary(time_ms(lambda: pairwise_acc_sym_plain(pos, mass, alive, **kw), 1)),
            "B13": summary(time_ms(lambda: pairwise_acc_mxu_plain(
                pos, mass, alive, with_potential=False, **kw), 1)),
            "B3": summary(time_ms(lambda: block_acc_plain(pos, pos, mass, **kw), 1)),
        }

        pos_c, vel_c, mass_c, _ = self.cluster()
        steps = {}
        for impl, k in (("auto", 10), ("pallas_sym", 10), ("pallas_mxu", 10), ("mxu", 2)):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl=impl, track_potential=False)
            st = ot.init_forces(ot.make_state(pos_c, vel_c, mass_c, precision="ds32",
                                              device=self.dev), cfg)
            steps[impl] = summary([t / k for t in time_ms(
                lambda: ot.rollout(st, cfg, k, fused="never"), 1)])

        pairs = n * (n - 1) / 2
        bounds = {
            "B12": bound(OPS_B12 * pairs, 28 * n, rsqrt=pairs),
            "B13": bound(OPS_B13 * n * n, 80 * n, rsqrt=n * n, tensor=TENSOR_B13 * n * n),
            "B13_pe": bound(OPS_B13_PE * n * n, 84 * n, rsqrt=n * n,
                            tensor=TENSOR_B13 * n * n),
            "B3": bound(OPS_B1_PE * n * n, 48 * n, rsqrt=n * n),
        }
        # the count of PRs 1-7, every flop of B13 on the CUDA cores
        bound_b13_cuda = bound(OPS_B13_ALL_CUDA * n * n, 80 * n, rsqrt=n * n)
        for k, t in (("B12", kern["B12"]), ("B13", kern["B13"]), ("B3", kern["B3_pe"])):
            self.kernels[k].update(ms=t["median"], plain_ms=plain[k]["median"],
                                   bound_ms=bounds[k][0], bound_by=bounds[k][1],
                                   library_ms=None)
        perf = {"kernels_N65536": kern, "mxu_eval_N65536": mxu, "plain_N65536": plain,
                "kdk_step_N65536": steps, "bounds_ms": bounds,
                "B13_bound_all_cuda_cores_ms": bound_b13_cuda,
                "main_path_ms_per_step_wall": getattr(self, "variant_ms", None)}
        print("perf_variants " + json.dumps(perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        timed = {"B12": kern["B12"], "B13": kern["B13"], "B13_pe": kern["B13_pe"],
                 "B3": kern["B3_pe"]}
        return ("N=65536: " + ", ".join(f"{k} {ms(v)}" for k, v in kern.items())
                + f"; mxu evaluation {ms(mxu)}; plain " + ", ".join(
                    f"{k} {ms(v)}" for k, v in plain.items())
                + "; ds32 KDK step " + ", ".join(f"{k} {ms(v)}" for k, v in steps.items())
                + "; bounds " + ", ".join(
                    f"{k} {v[0]:.4f} ms ({v[1]}, {100 * v[0] / timed[k]['median']:.0f}%)"
                    for k, v in bounds.items())
                + f"; B13 counted all on the CUDA cores {bound_b13_cuda[0]:.4f} ms "
                f"({100 * bound_b13_cuda[0] / timed['B13']['median']:.0f}%)")

    def block_macro_call(self):
        """One block macro step (rungs 1) of phase 15's scene from a state
        made once, as a call; ``.m`` is its substep count."""
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.integrators import block_plan

        cfg = self.block_config(1)
        st = ot.init_forces(ot.make_state(*self.block_scene(), precision="ds32",
                                          device=self.dev), cfg)

        def call():
            return ot.rollout(st, cfg, 1)
        call.m = block_plan(st, cfg)[2]
        return call

    # phases 30-33: the mesh solvers
    def t(self, a, dtype=None):
        return self.torch.tensor(np.asarray(a), dtype=dtype or self.torch.float32,
                                 device=self.dev)

    def box_t(self, box):
        return None if box is None else (self.t(box[:3]), self.t(box[3]))

    def p3m_uniform(self):
        """The P3M bench row's bodies (bench.py:981-1000): positions uniform in
        [-4, 4]^3 and velocities 0.1 N(0, 1) from seed 11, masses 1/N."""
        rng = np.random.default_rng(P3M_SEED)
        pos = rng.uniform(-P3M_HALF, P3M_HALF, size=(N_MAIN, 3))
        vel = 0.1 * rng.normal(size=(N_MAIN, 3))
        return pos, vel, np.full(N_MAIN, 1.0 / N_MAIN)

    def p3m_ragged(self):
        """N_P3M_RAGGED bodies uniform in [-1, 1]^3, a third dead and parked
        far as make_state parks them."""
        from orbital_tpu_torch.engine.state import far_positions

        rng = np.random.default_rng(self.seed + 31)
        n = N_P3M_RAGGED
        pos = rng.uniform(-1.0, 1.0, size=(n, 3))
        mass = rng.uniform(0.5, 1.5, n) / n
        alive = np.ones(n, bool)
        alive[::3] = False
        pos[~alive] = far_positions(int((~alive).sum()), 1.0, np.float64)
        return pos, mass, alive

    @staticmethod
    def p3m_capacity(occ: int) -> int:
        """simulate()'s p3m_capacity="auto" rule: 1.5x headroom, a multiple
        of 8, at least 32."""
        return max(32, -(-int(occ * 1.5) // 8) * 8)

    def p3m_table(self, pos, mass, alive, grid: int, box, capacity: int, device=None,
                  cut_sigma: float = 4.5):
        """The short-range table of ``p3m_acc_potential`` for numpy inputs on
        ``device`` (the card by default) at its default sigma of 1.5 mesh
        cells and a cut of ``cut_sigma`` sigmas: (table dict, gc, sigma,
        rcut2) with sigma and rcut2 rounded in f32 as the solver rounds
        them."""
        import torch

        from orbital_tpu_torch.ops.p3m import _cell_grid, p3m_cell_table
        from orbital_tpu_torch.ops.pm import _bounding_cube

        dev = device or self.dev
        f32 = torch.float32
        p = torch.tensor(np.asarray(pos), dtype=f32, device=dev)
        a = (torch.ones(p.shape[0], dtype=torch.bool, device=dev) if alive is None
             else torch.tensor(np.asarray(alive), device=dev))
        m = torch.tensor(np.asarray(mass), dtype=f32, device=dev) * a.to(f32)
        if box is None:
            center, half = _bounding_cube(p, a.to(f32), grid)
        else:
            center = torch.tensor(box[:3], dtype=f32, device=dev)
            half = torch.tensor(box[3], dtype=f32, device=dev)
        gc = _cell_grid(grid, 1.5, cut_sigma)
        tab = p3m_cell_table(p, m, a, center, half, gc=gc, capacity=capacity)
        sigma = 1.5 * (2.0 * half.cpu() / grid)
        return tab, gc, float(sigma), float((cut_sigma * sigma) ** 2)

    def p3m_sum_launch(self, tab, kw):
        """A call that launches the short-range sum alone, on the table as
        the reorder kernel leaves it (reordered once), into fixed outputs."""
        from orbital_tpu_torch.ops import cuda_p3m

        torch = self.torch
        order = cuda_p3m.p3m_short_order_cuda(tab["table"], tab["cell_pos"], tab["cell_m"],
                                              tab["count"], kw["gc"])
        params = self.t([kw["rcut2"], 1.0 / (2.0 * kw["sigma"])])
        acc = torch.zeros((kw["n"], 3), dtype=torch.float32, device=self.dev)
        pe = torch.zeros((kw["n"],), dtype=torch.float32, device=self.dev)
        lib, cap = cuda_p3m._load(), tab["table"].shape[1]

        def launch():
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            err = lib.p3m_short_sorted(order["rows"].data_ptr(), order["table"].data_ptr(),
                                       order["run_off"].data_ptr(),
                                       order["run_box"].data_ptr(), kw["gc"], cap,
                                       params.data_ptr(), float(kw["G"]), float(kw["eps2"]),
                                       acc.data_ptr(), pe.data_ptr(), stream,
                                       self.dev.index or 0)
            if err:
                raise RuntimeError(f"p3m_short_sorted: CUDA error {err}")
        return launch

    def p3m_bench_case(self):
        """The P3M bench row's short-range table and the wrapper's keyword
        arguments (capacity probed as simulate() probes it)."""
        from orbital_tpu_torch.ops.p3m import p3m_max_occupancy

        pos, _, mass = self.p3m_uniform()
        occ = p3m_max_occupancy(self.t(pos), None, grid=P3M_GRID, box=self.box_t(P3M_BOX))
        tab, gc, sigma, rcut2 = self.p3m_table(pos, mass, None, P3M_GRID, P3M_BOX,
                                               self.p3m_capacity(occ))
        return tab, dict(gc=gc, n=len(mass), G=1.0, sigma=sigma, rcut2=rcut2, eps2=EPS2)

    # phase 30
    def check_pm(self) -> str:
        import orbital_tpu_torch.ops.pm as pm
        from orbital_tpu_torch.engine.state import far_positions
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda

        torch = self.torch
        rng = np.random.default_rng(self.seed + 30)
        n = N_MAIN
        smooth = (rng.normal(size=(n, 3)), rng.uniform(0.5, 1.5, n) / n)
        cpos, _, cmass, _ = self.cluster()
        cases = {"smooth": (*smooth, PM_SMOOTH_EPS2, PM_SMOOTH_GRID, None),
                 "bench": (cpos, cmass, EPS2, PM_GRID, PM_BOX)}
        lines = []
        for key, (p, m, eps2, grid, box) in cases.items():
            pt, mt = self.t(p), self.t(m)
            a, U = pm.pm_acc_potential(pt, mt, None, G_grav=1.0, eps2=eps2, grid=grid,
                                       box=self.box_t(box))
            a64, U64 = pm_f64(p, m, None, eps2, grid, box)
            if not bool(torch.isfinite(a).all()) or tuple(a.shape) != (n, 3):
                raise AssertionError(f"PM {key}: non-finite or misshapen acc")
            r_a, r_u = rms_rel(a.cpu(), a64), abs(float(U) - U64) / abs(U64)
            if r_a > PM_RTOL or r_u > PM_RTOL:
                raise AssertionError(f"PM {key} vs f64: RMS acc {r_a:.3e}, U {r_u:.3e} > "
                                     f"{PM_RTOL:g}")
            line = (f"{key} (N={n}, grid {grid}, eps2 {eps2:g}, "
                    f"{'box ' + str(box) if box else 'cube fitted'}): vs f64 on the CPU RMS "
                    f"acc {r_a:.2e}, U {r_u:.2e}")
            if key == "smooth":
                exact, _ = pairwise_acc_cuda(pt, mt, None, G=1.0, eps2=eps2,
                                             with_potential=False)
                r_x = rms_rel(a, exact)
                if r_x > PM_EXACT_RMS:
                    raise AssertionError(f"PM smooth vs B1: RMS {r_x:.3e} > {PM_EXACT_RMS:g}")
                line += f"; vs the exact forces (B1) RMS {r_x:.2e} <= {PM_EXACT_RMS:g}"
                # dead bodies inert: a third dead and parked far
                alive = np.ones(n, bool)
                alive[::3] = False
                pd = smooth[0].copy()
                pd[~alive] = far_positions(int((~alive).sum()), float(np.abs(pd).max()),
                                           np.float64)
                ad, Ud = pm.pm_acc_potential(self.t(pd), mt, self.t(alive, torch.bool),
                                             G_grav=1.0, eps2=eps2, grid=grid)
                al, Ul = pm.pm_acc_potential(self.t(smooth[0][alive]), self.t(m[alive]), None,
                                             G_grav=1.0, eps2=eps2, grid=grid)
                live = self.t(alive, torch.bool)
                r_d = rms_rel(ad[live], al)
                r_du = abs(float(Ud) - float(Ul)) / abs(float(Ul))
                if bool(ad[~live].any()) or r_d > PM_RTOL or r_du > PM_RTOL:
                    raise AssertionError(f"PM dead bodies: dead rows nonzero or live rows "
                                         f"{r_d:.3e}, U {r_du:.3e} from the live-only run")
                line += (f"; a third dead: dead rows 0, live rows {r_d:.2e} (U {r_du:.2e}) "
                         f"from the live bodies alone")
            lines.append(line)
        return f"PM on the card within RMS {PM_RTOL:g} of f64: " + "; ".join(lines)

    # phase 31
    def check_p3m_short(self) -> str:
        from orbital_tpu_torch.ops.cuda_p3m import (p3m_short_cuda, p3m_short_order,
                                                    p3m_short_order_cuda)
        from orbital_tpu_torch.ops.p3m import p3m_max_occupancy, p3m_short_plain

        torch = self.torch
        pos, _, mass = self.p3m_uniform()
        rp, rm, ralive = self.p3m_ragged()
        occ_b = p3m_max_occupancy(self.t(pos), None, grid=P3M_GRID, box=self.box_t(P3M_BOX))
        occ_r = p3m_max_occupancy(self.t(rp), self.t(ralive, torch.bool), grid=P3M_RAGGED_GRID)
        occ_w = p3m_max_occupancy(self.t(rp), self.t(ralive, torch.bool), grid=P3M_RAGGED_GRID,
                                  cut_sigma=P3M_WIDE_CUT)
        cases = {"bench": (pos, mass, None, P3M_GRID, P3M_BOX, self.p3m_capacity(occ_b), 4.5),
                 "ragged": (rp, rm, ralive, P3M_RAGGED_GRID, None, self.p3m_capacity(occ_r),
                            4.5),
                 "starved": (rp, rm, ralive, P3M_RAGGED_GRID, None, max(1, occ_r // 2), 4.5),
                 # beyond the polynomials' range: the erff / expf arithmetic
                 "ragged wide cut": (rp, rm, ralive, P3M_RAGGED_GRID, None,
                                     self.p3m_capacity(occ_w), P3M_WIDE_CUT)}
        lines = []
        for key, (p, m, alive, grid, box, cap, cut) in cases.items():
            tab, gc, sigma, rcut2 = self.p3m_table(p, m, alive, grid, box, cap, cut_sigma=cut)
            n = len(m)
            kw = dict(gc=gc, n=n, G=1.0, sigma=sigma, rcut2=rcut2, eps2=EPS2)
            # the reorder kernel against its plain version: equal, bit for bit,
            # on each cell's kept prefix (the kernel writes nothing past it)
            args = (tab["table"], tab["cell_pos"], tab["cell_m"], tab["count"], gc)
            got, want = p3m_short_order_cuda(*args), p3m_short_order(*args)
            kept_slot = (torch.arange(tab["table"].shape[1], device=self.dev)[None, :]
                         < tab["count"][:, None])
            for k in got:
                g_, w_ = (got[k][kept_slot], want[k][kept_slot]) if k in ("rows", "table") \
                    else (got[k], want[k])
                if not torch.equal(g_, w_):
                    raise AssertionError(f"P3M order {key}: {k} differs from the plain version")
            a, pe = p3m_short_cuda(tab["table"], tab["cell_pos"], tab["cell_m"],
                                   count=tab["count"], **kw)
            a0, pe0 = p3m_short_plain(tab["table"], tab["cell_pos"], tab["cell_m"], **kw)
            a64, pe64 = p3m_short_plain(tab["table"], tab["cell_pos"].double(),
                                        tab["cell_m"].double(), **kw)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(pe).all())):
                raise AssertionError(f"P3M short {key}: non-finite output")

            def rel(x, ref):
                return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())
            errs = {"plain": (rel(a, a0), rel(pe, pe0)), "f64": (rel(a, a64), rel(pe, pe64)),
                    "plain vs f64": (rel(a0, a64), rel(pe0, pe64))}
            if max(errs["plain"] + errs["f64"]) > SHORT_RTOL:
                raise AssertionError(f"P3M short {key}: {errs} > {SHORT_RTOL:g}")
            kept = torch.zeros(n, dtype=torch.bool, device=self.dev)
            kept[tab["order"][tab["keep"]]] = True
            if bool(a[~kept].any()) or bool(pe[~kept].any()):
                raise AssertionError(f"P3M short {key}: rows without a slot are not 0")
            overflow = int(tab["overflow"])
            line = (f"{key} (N={n}, grid {grid}, cut {cut:g} sigma, gc {gc}, capacity {cap}, "
                    f"overflow {overflow}): the reorder bit-equal to its plain version; "
                    f"acc/pe vs plain {errs['plain'][0]:.2e}/{errs['plain'][1]:.2e}, vs f64 "
                    f"{errs['f64'][0]:.2e}/{errs['f64'][1]:.2e} (plain vs f64 "
                    f"{errs['plain vs f64'][0]:.2e}/{errs['plain vs f64'][1]:.2e})")
            if key == "starved":
                cpu = self.p3m_table(p, m, alive, grid, box, cap, device="cpu")[0]
                if overflow <= 0 or overflow != int(cpu["overflow"]):
                    raise AssertionError(f"P3M starved overflow {overflow}, CPU "
                                         f"{int(cpu['overflow'])}")
                line += f" == the CPU's {int(cpu['overflow'])}"
            if key == "bench":
                self.kernels["P3M"]["max_abs_err"] = max(float((a - a0).abs().max()),
                                                         float((pe - pe0).abs().max()))
                self.kernels["P3MO"]["max_abs_err"] = 0.0
                self.p3m_short_case = (tab, kw)
                from orbital_tpu_torch.ops.cuda_p3m import p3m_short_shape

                work = p3m_short_work(tab, gc, n, rcut2,
                                      warps=p3m_short_shape(gc, tab["table"].shape[1])["warps"])
                self.p3m_short_w = work
                print("p3m_short_work " + json.dumps(work), file=sys.stderr)
                line += (f"; p3m_short_work: {work['walked']:,} pairs walked by the first "
                         f"version, {work['staged']:,} staged, {work['visited']:,} visited in "
                         f"{work['issued']:,} lane slots, {work['needed']:,} needed "
                         f"(visited/needed {work['visited'] / work['needed']:.2f}); the JAX tile "
                         f"form {work['jax_slots']:,} slots")
            lines.append(line)
        # bit-equal from call to call (sums in a fixed order, no atomics)
        tab, kw = self.p3m_short_case
        args = (tab["table"], tab["cell_pos"], tab["cell_m"])
        one = p3m_short_cuda(*args, count=tab["count"], **kw)
        two = p3m_short_cuda(*args, count=tab["count"], **kw)
        if not all(torch.equal(x, y) for x, y in zip(one, two)):
            raise AssertionError("P3M short: two calls on the same table differ")
        return (f"P3M short range (csrc/p3m_short.cu: the reorder kernel equal to its plain "
                f"version on the kept prefixes; the sum within {SHORT_RTOL:g} of its plain "
                f"version and the f64 sum, bench row bit-equal from call to call): "
                + "; ".join(lines))

    # phase 32
    def mesh_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops import p3m as p3m_mod
        from orbital_tpu_torch.ops.cuda_p3m import p3m_short_cuda, p3m_short_order_cuda
        from orbital_tpu_torch.ops.p3m import p3m_max_occupancy

        torch = self.torch
        lines = []

        def escaped(state, box):
            p = state.pos.double()
            c = torch.tensor(box[:3], dtype=torch.float64, device=p.device)
            return int(((p - c).abs() > box[3]).any(1).logical_and(state.alive).sum())

        def drive(cfg, state, steps):
            """init_forces -> 20 recorded -> steps - 20 unrecorded steps."""
            e0 = energy_f64(state)
            state = ot.init_forces(state, cfg)
            rec, traj = ot.rollout(state, cfg, 20, record_every=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fin, _ = ot.rollout(rec, cfg, steps - 20)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / (steps - 20)
            if tuple(traj.pos.shape) != (2, state.n_bodies, 3) or int(fin.step) != steps:
                raise AssertionError("mesh main path: wrong records or step count")
            if not (bool(torch.isfinite(fin.pos).all())
                    and bool(torch.isfinite(traj.energy).all())):
                raise AssertionError("mesh main path: non-finite state or energies")
            return fin, abs((energy_f64(fin) - e0) / e0), wall

        # PM: the drift row
        pos, vel, mass, _ = self.cluster()
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl="pm", pm_grid=PM_GRID,
                           pm_box=PM_BOX)
        reset_launches()
        fin, drift, wall = drive(cfg, ot.make_state(pos, vel, mass, precision="f32",
                                                    device=self.dev), PM_STEPS)
        esc = escaped(fin, PM_BOX)
        if drift > PM_DRIFT_BOUND:
            raise AssertionError(f"PM drift {drift:.3e} > {PM_DRIFT_BOUND:g}")
        self.pm_ms_per_step = wall
        lines.append(f"PM N={N_MAIN} f32 grid {PM_GRID} box {PM_BOX}: init_forces + 20 recorded "
                     f"+ {PM_STEPS - 20} steps, |dE/E| = {drift:.3e} <= {PM_DRIFT_BOUND:g} "
                     f"(JAX's recorded {JAX_PM_DRIFT:.3e}); {wall:.3f} ms/step wall; "
                     f"{esc} escaped the box")

        # P3M: the uniform row, the overflow of every evaluation summed on the card
        upos, uvel, umass = self.p3m_uniform()
        occ = p3m_max_occupancy(self.t(upos), None, grid=P3M_GRID, box=self.box_t(P3M_BOX))
        cap = self.p3m_capacity(occ)
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl="p3m", pm_grid=P3M_GRID,
                           p3m_capacity=cap, pm_box=P3M_BOX)
        inner, total = p3m_mod.p3m_acc_potential, []

        def logged(*args, **kw):
            acc, U, ovf = inner(*args, **kw)
            total.append(ovf)
            return acc, U, ovf
        reset_launches()
        p3m_mod.p3m_acc_potential = logged
        try:
            fin, drift, wall = drive(cfg, ot.make_state(upos, uvel, umass, precision="f32",
                                                        device=self.dev), P3M_STEPS)
        finally:
            p3m_mod.p3m_acc_potential = inner
        launches, overflow = p3m_short_cuda.launches, int(torch.stack(total).sum())
        order_launches = p3m_short_order_cuda.launches
        esc = escaped(fin, P3M_BOX)
        if (launches != len(total) or launches != 1 + P3M_STEPS or overflow
                or order_launches != launches):
            raise AssertionError(f"P3M: {launches} short-range and {order_launches} reorder "
                                 f"launches for {len(total)} evaluations ({1 + P3M_STEPS} "
                                 f"expected), overflow {overflow}")
        self.kernels["P3MO"]["launches"] = order_launches
        if drift > P3M_DRIFT_BOUND:
            raise AssertionError(f"P3M drift {drift:.3e} > {P3M_DRIFT_BOUND:g}")
        self.kernels["P3M"]["launches"] = launches
        self.p3m_ms_per_step = wall
        lines.append(f"P3M N={N_MAIN} f32 uniform grid {P3M_GRID} box {P3M_BOX} capacity {cap} "
                     f"(densest cell {occ}): init_forces + 20 recorded + {P3M_STEPS - 20} steps, "
                     f"|dE/E| = {drift:.3e} <= {P3M_DRIFT_BOUND:g} (JAX's recorded "
                     f"{JAX_P3M_DRIFT:.3e}); {wall:.3f} ms/step wall; short-range and reorder "
                     f"launches {launches} and {order_launches} = evaluations, overflow "
                     f"{overflow}; {esc} escaped the box")

        # simulate() on the card, the cube pinned and the capacity probed
        names = [f"b{i}" for i in range(N_MAIN)]
        for impl, (p, v, m) in (("p3m", (upos, uvel, umass)), ("pm", (pos, vel, mass))):
            scene = SceneArrays(pos=p, vel=v, mass=m, radius=np.zeros(N_MAIN), names=names)
            reset_launches()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = ot.simulate(scene, steps=20, dt=DT, softening=EPS2 ** 0.5,
                                  device=self.dev, precision="f32", force_impl=impl,
                                  pm_grid=P3M_GRID if impl == "p3m" else PM_GRID,
                                  p3m_capacity="auto", rescale=ot.Rescale.identity(),
                                  record_every=10)
            if not np.isfinite(res.pos).all() or res.pos.shape != (2, N_MAIN, 3):
                raise AssertionError(f"simulate(force_impl={impl!r}): bad records")
            if impl == "p3m" and p3m_short_cuda.launches != 21:
                raise AssertionError(f"simulate(p3m): {p3m_short_cuda.launches} launches")
            said = "; ".join(str(w.message)[:60] for w in caught) or "no warning"
            lines.append(f"simulate(force_impl={impl!r}) 20 steps on the card: box "
                         f"{tuple(round(x, 4) for x in res.config.pm_box)}, capacity "
                         f"{res.config.p3m_capacity}, short-range launches "
                         f"{p3m_short_cuda.launches}; warnings: {said}")
        return " | ".join(lines)

    # phase 33
    def mesh_timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_p3m import (p3m_short_cuda, p3m_short_order,
                                                    p3m_short_order_cuda)
        from orbital_tpu_torch.ops.p3m import p3m_acc_potential, p3m_short_plain
        from orbital_tpu_torch.ops.pm import pm_acc_potential

        torch = self.torch
        pos, vel, mass, _ = self.cluster()
        pt, mt, box = self.t(pos), self.t(mass), self.box_t(PM_BOX)
        kw = dict(G_grav=1.0, with_potential=False)
        ev = {"pm_eval_65536": summary(time_ms(lambda: pm_acc_potential(
            pt, mt, None, eps2=EPS2, grid=PM_GRID, box=box, **kw), 10))}
        rng = np.random.default_rng(0)  # bench_pm's scene (bench.py:330-333)
        big = (rng.normal(size=(N_PM_BIG, 3)), 0.3 * rng.normal(size=(N_PM_BIG, 3)),
               np.full(N_PM_BIG, 1.0 / N_PM_BIG))
        bt, bm = self.t(big[0]), self.t(big[2])
        ev["pm_eval_1048576"] = summary(time_ms(lambda: pm_acc_potential(
            bt, bm, None, eps2=PM_BIG_EPS2, grid=PM_GRID, **kw), 5))
        cfg_b = ot.SimConfig(dt=DT, G=1.0, eps2=PM_BIG_EPS2, force_impl="pm", pm_grid=PM_GRID,
                             track_potential=False)
        st_b = ot.init_forces(ot.make_state(*big, precision="f32", device=self.dev), cfg_b)
        ev["pm_step_1048576"] = summary([t / 5 for t in time_ms(
            lambda: ot.rollout(st_b, cfg_b, 5), 1)])
        del st_b, bt, bm
        upos, uvel, umass = self.p3m_uniform()
        tab, kw_s = self.p3m_short_case
        cap = tab["table"].shape[1]
        ut, um, ubox = self.t(upos), self.t(umass), self.box_t(P3M_BOX)
        ev["p3m_eval_65536"] = summary(time_ms(lambda: p3m_acc_potential(
            ut, um, None, eps2=EPS2, grid=P3M_GRID, capacity=cap, box=ubox, **kw), 10))
        cfg_p = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl="p3m", pm_grid=P3M_GRID,
                             p3m_capacity=cap, pm_box=P3M_BOX, track_potential=False)
        st_p = ot.init_forces(ot.make_state(upos, uvel, umass, precision="f32",
                                            device=self.dev), cfg_p)
        ev["p3m_step_65536"] = summary([t / 10 for t in time_ms(
            lambda: ot.rollout(st_p, cfg_p, 10), 1)])
        args = (tab["table"], tab["cell_pos"], tab["cell_m"])
        # sigma and rcut^2 on the card, as the solver hands them over: a
        # number would be copied in each call and wait for the stream
        kw_t = dict(kw_s, sigma=self.t(kw_s["sigma"]), rcut2=self.t(kw_s["rcut2"]))
        short = summary(time_ms(lambda: p3m_short_cuda(*args, count=tab["count"], **kw_t), 20))
        plain = summary(time_ms(lambda: p3m_short_plain(*args, **kw_t), 1))
        o_args = (*args, tab["count"], kw_s["gc"])
        order = summary(time_ms(lambda: p3m_short_order_cuda(*o_args), 20))
        order_plain = summary(time_ms(lambda: p3m_short_order(*o_args), 5))
        # the reorder reads each kept slot's (x, y, z), m and index once (24 B)
        # and each cell's count, and writes each kept slot's (x, y, z, m) and
        # index (24 B) and each cell's run offsets and boxes once
        kept = int(tab["count"].sum())
        b_o = bound(0, 48 * kept + (4 + 36 + 192) * kw_s["gc"] ** 3)
        self.kernels["P3MO"].update(ms=order["median"], plain_ms=order_plain["median"],
                                    bound_ms=b_o[0], bound_by=b_o[1], library_ms=None)
        # the sum alone by CUDA events (its launch on a table reordered
        # once), and the wrapper's device time by the profiler: the reorder,
        # the sum and their set-up
        sum_alone = summary(time_ms(self.p3m_sum_launch(tab, kw_s), 20))
        dev_t = device_times(lambda: p3m_short_cuda(*args, count=tab["count"], **kw_t))
        dev = {k: sum(v[1] for n_, v in dev_t.items() if k in n_) if dev_t else "not measured"
               for k in ("p3m_short_kernel", "p3m_order_kernel", "")}
        w = self.p3m_short_w
        b = bound(OPS_SHORT * w["needed"], w["nbytes"], rsqrt=MUFU_SHORT * w["needed"])
        slots = self.kernels["P3M"].get("sass_slots_per_pair", "not measured")
        floor = (None if isinstance(slots, str)
                 else 1e3 * slots * w["issued"] / 32 / INSTR_RATE)
        self.kernels["P3M"].update(ms=short["median"], plain_ms=plain["median"], bound_ms=b[0],
                                   bound_by=b[1], library_ms=None,
                                   sum_alone_ms=sum_alone["median"])
        perf = {**ev, "p3m_short": short, "p3m_short_plain": plain, "p3m_short_bound": b,
                "p3m_short_work": w, "p3m_order": order, "p3m_order_plain": order_plain,
                "p3m_order_bound": b_o, "p3m_sum_alone": sum_alone, "p3m_short_device": dev}
        print("perf_mesh " + json.dumps(perf), file=sys.stderr)

        def ms(x):
            return f"{x['median']:.3f} ms (spread {x['spread']:.3f})"

        return (", ".join(f"{k} {ms(v)}" for k, v in ev.items())
                + f"; short-range kernel {ms(short)} vs plain {ms(plain)}, bound {b[0]:.4f} ms "
                f"({b[1]}, {100 * b[0] / short['median']:.1f}%) over {w['needed']:,} needed "
                f"pairs ({w['visited']:,} visited, {w['walked']:,} walked by the first "
                f"version); its issue floor {fmt(floor, 4)} ms ({fmt(slots)} SASS instructions "
                f"a visited pair over {w['issued']:,} lane slots); the sum alone "
                f"{ms(sum_alone)} by events; the wrapper's device time {fmt(dev[''], 4)} ms "
                f"(the sum {fmt(dev['p3m_short_kernel'], 4)}, the reorder "
                f"{fmt(dev['p3m_order_kernel'], 4)}); "
                f"the reorder kernel {ms(order)} vs its plain version {ms(order_plain)}, bound "
                f"{b_o[0]:.4f} ms ({b_o[1]}); the B5 subset and the block macro step: phase 17, "
                f"and in turns with another build's by --parent")

    # phase 34
    def check_roots(self) -> str:
        from orbital_tpu_torch.ops.collisions import pointer_jump
        from orbital_tpu_torch.ops.cuda_collisions import (collision_parents_cuda,
                                                           collision_parents_plain,
                                                           collision_roots_cuda,
                                                           contact_marks_cuda,
                                                           contact_marks_plain)
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_detect_cuda

        torch = self.torch
        pos0, vel0, mass0, _ = self.cluster()
        cases = {"rich": R_RICH, "bench": R_BENCH, "ragged": None}
        lines, perf = [], {}
        for key, radius in cases.items():
            if radius is None:
                pos, _, mass, rad, alive = self.scene(N_RAGGED, R_RAGGED, N_RAGGED // 3,
                                                      seed_offset=34)
            else:
                st = self.torch_state(pos0, vel0, mass0, radius)
                pos, mass, rad, alive = st.pos, st.mass, st.radius, st.alive
            n = pos.shape[0]
            ident = torch.arange(n, device=self.dev)
            _, _, count = pairwise_acc_detect_cuda(pos, mass, rad, alive, G=1.0, eps2=EPS2,
                                                   with_potential=False)
            kern = {"parents": collision_parents_cuda, "mark": contact_marks_cuda}
            plain = {"parents": collision_parents_plain, "mark": contact_marks_plain}
            got = {(m, g): kern[m](pos, rad, alive, contacts=count if g == "gated" else None)
                   for m in kern for g in ("gated", "ungated")}
            want = {(m, g): plain[m](pos, rad, alive, contacts=count if g == "gated" else None)
                    for m in plain for g in ("gated", "ungated")}
            root = collision_roots_cuda(pos, rad, alive, contacts=count)
            torch.cuda.synchronize()
            for k in got:
                if not torch.equal(got[k], want[k]):
                    bad = int((got[k] != want[k]).sum())
                    raise AssertionError(f"contact sweep {key} {k}: {bad} rows differ from "
                                         f"plain")
            if not torch.equal(root, pointer_jump(want["parents", "gated"])):
                raise AssertionError(f"roots {key}: roots differ from the plain version's")
            c = int(count)
            linked = int((want["parents", "ungated"] != ident).sum())
            marked = int(want["mark", "ungated"].sum())
            if key == "rich" and not (c > 0 and linked > 0 and marked > 0):
                raise AssertionError(f"contact sweep rich: count {c}, {linked} linked columns, "
                                     f"{marked} marks")
            if key == "bench" and (c != 0 or not torch.equal(got["parents", "gated"], ident)
                                   or bool(got["mark", "gated"].any())):
                raise AssertionError(f"contact sweep bench: count {c} at t=0, or parents not "
                                     f"the identity, or marks at a count of 0")
            line = (f"{key} (N={n}, R {radius if radius else R_RAGGED:g}, count {c}): parents "
                    f"and marks, gated and ungated, and the roots integer-equal to the plain "
                    f"versions, {linked} columns with a lower touching row, {marked} bodies "
                    f"marked")
            if key in ("rich", "bench"):
                for m, fn in kern.items():
                    t = summary(time_ms(lambda: fn(pos, rad, alive, contacts=count), 10))
                    perf[f"{m}_{key}"] = t
                    line += f"; {m} {t['median']:.4f} ms (spread {t['spread']:.4f})"
            if key == "rich":
                # the pairs each mode needs: the parents each live column's rows
                # up to its first touching one, the mark every live pair i < j
                p, j = want["parents", "ungated"], ident
                pairs = int(torch.where(alive, torch.where(p < j, p + 1, j), 0).sum())
                live = int(alive.sum())
                perf["pairs"], perf["mark_pairs"] = pairs, live * (live - 1) // 2
                perf["bound"] = bound(OPS_ROOTS * pairs, 25 * n)
                perf["mark_bound"] = bound(OPS_ROOTS * perf["mark_pairs"], 18 * n)
                for m in plain:
                    perf[f"{m}_plain"] = summary(time_ms(
                        lambda: plain[m](pos, rad, alive, contacts=count), 1))
                line += (f", plain {perf['parents_plain']['median']:.3f} and "
                         f"{perf['mark_plain']['median']:.3f} ms; bounds "
                         f"{perf['bound'][0]:.4f} ms ({perf['bound'][1]}, {pairs:,} pairs) "
                         f"and {perf['mark_bound'][0]:.4f} ms ({perf['mark_pairs']:,} pairs)")
                for k, m in (("ROOTS", "parents"), ("MARK", "mark")):
                    slots = self.kernels[k].get("sass_slots_per_pair")
                    floor = issue_floor_ms(slots, perf["pairs" if m == "parents" else
                                                        "mark_pairs"])
                    if floor is not None:
                        t = perf[f"{m}_rich"]["median"]
                        b = perf["bound" if m == "parents" else "mark_bound"][0]
                        line += (f"; {m} issue floor {floor:.3f} ms ({100 * floor / t:.0f}% of "
                                 f"its time), {100 * b / t:.1f}% of its bound")
            if key == "bench":
                perf["bound_count0"] = bound(0, 8 * n + 4)
                perf["mark_bound_count0"] = bound(0, n + 4)
                line += (f"; at count 0 bounds {perf['bound_count0'][0]:.5f} and "
                         f"{perf['mark_bound_count0'][0]:.5f} ms (bytes)")
            lines.append(line)
        for k, m, b in (("ROOTS", "parents", "bound"), ("MARK", "mark", "mark_bound")):
            self.kernels[k].update(
                max_abs_err=0, ms=perf[f"{m}_rich"]["median"],
                plain_ms=perf[f"{m}_plain"]["median"], bound_ms=perf[b][0],
                bound_by=perf[b][1], library_ms=None, ms_count0=perf[f"{m}_bench"]["median"],
                bound_count0_ms=perf[f"{b}_count0"][0])
        print("perf_roots " + json.dumps(perf), file=sys.stderr)
        return ("the contact sweep (csrc/collision_roots.cu; the merge root search and "
                "resolve's contact mark): " + "; ".join(lines))

    def torch_state(self, pos, vel, mass, radius: float, precision: str = "ds32"):
        import orbital_tpu_torch as ot

        return ot.make_state(pos, vel, mass, np.full(len(mass), radius), precision=precision,
                             device=self.dev)

    def merged_checks(self, key: str, start, fin) -> str:
        """A merge run's invariants in host f64: total mass and momentum of
        ``fin`` against ``start`` within MERGE_MASS_RTOL and MERGE_P_RTOL (of
        sum m |v|), and every merged body dead, massless, without radius and
        parked beyond every live body's reach. Returns its merge count."""
        torch = self.torch
        m0, m1 = start.mass.double(), fin.mass.double()
        v0, v1 = start.vel_full().double(), fin.vel_full().double()
        dm = abs(float(m1.sum() - m0.sum())) / float(m0.sum())
        scale = float((m0 * v0.norm(dim=1)).sum())
        dp = float(((m1[:, None] * v1).sum(0) - (m0[:, None] * v0).sum(0)).norm()) / scale
        gone = start.alive & ~fin.alive
        merged = int(gone.sum())
        if not (bool(torch.isfinite(fin.pos).all()) and bool(torch.isfinite(fin.vel).all())):
            raise AssertionError(f"{key}: non-finite state")
        if merged == 0:
            raise AssertionError(f"{key}: no body merged")
        if dm > MERGE_MASS_RTOL or dp > MERGE_P_RTOL:
            raise AssertionError(f"{key}: mass {dm:.3e} (> {MERGE_MASS_RTOL:g}?) or momentum "
                                 f"{dp:.3e} (> {MERGE_P_RTOL:g}?) not conserved")
        live = fin.alive
        reach = float(fin.pos.double()[live].abs().max()) + 2.0 * float(fin.radius[live].max())
        parked = float(fin.pos.double()[gone].abs().amax(1).min())
        if bool(fin.mass[gone].any()) or bool(fin.radius[gone].any()) or parked < 1e3 * reach:
            raise AssertionError(f"{key}: merged bodies not massless, without radius and "
                                 f"parked far (nearest at {parked:.3e}, live reach {reach:.3e})")
        return (f"{merged} merged; |dM/M| {dm:.2e} <= {MERGE_MASS_RTOL:g}, |dP| / sum m|v| "
                f"{dp:.2e} <= {MERGE_P_RTOL:g}; merged bodies dead, massless, radius 0, parked "
                f"at >= {parked:.2e} (live reach {reach:.2e})")

    # phase 35
    def merge_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_force_detect_fn, resolve_force_fn
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops.cuda_collisions import collision_roots_cuda
        from orbital_tpu_torch.ops.cuda_forces import (pairwise_acc_cuda,
                                                       pairwise_acc_detect_cuda)

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, _ = self.cluster()
        # the bench row: armed against collision-free, step by step
        runs = {}
        for mode in ("merge", "none"):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, collisions=mode)
            state = self.torch_state(pos, vel, mass, R_BENCH)
            resolve = resolve_force_detect_fn if mode == "merge" else resolve_force_fn
            log = StepLog(resolve(cfg, n, self.dev), keep_pos=True, keep_counts=True)
            hook = dict(force_detect_fn=log) if mode == "merge" else dict(force_fn=log)
            if mode == "merge":
                _, _, c0 = pairwise_acc_detect_cuda(state.pos, state.mass, state.radius,
                                                    state.alive, G=1.0, eps2=EPS2)
                contacts0 = int(c0)
                reset_launches()
            state = ot.init_forces(state, cfg)
            rec, _ = ot.rollout(state, cfg, 20, record_every=10, fused="never", **hook)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg = cfg.replace(track_potential=False)
            log.fn = resolve(cfg, n, self.dev)
            fin, _ = ot.rollout(rec, cfg, self.drift_steps, fused="never", **hook)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if mode == "merge":
                launches = (pairwise_acc_cuda.launches, pairwise_acc_detect_cuda.launches,
                            collision_roots_cuda.launches)
            runs[mode] = (state, fin, 1e3 * wall / self.drift_steps, log)
        (start, fin, ms_merge, log), (_, other, ms_none, log_none) = runs["merge"], runs["none"]
        b1, b2, roots = launches
        steps = 20 + self.drift_steps
        counts = torch.stack(log.counts).cpu().numpy()
        hit = [int(k) + 1 for k in np.flatnonzero(counts)]
        if contacts0 != 0 or b1 != 1 or b2 != steps or roots != steps:
            raise AssertionError(f"merge bench row: {contacts0} contacts at t=0, launches B1 "
                                 f"{b1}, B2 {b2}, roots {roots}")
        differ = next((k + 1 for k, (a, b) in enumerate(zip(log.positions, log_none.positions))
                       if not torch.equal(a, b)), None)
        if hit:
            if differ is not None and differ <= hit[0]:
                raise AssertionError(f"merge bench row: positions differ from the "
                                     f"collision-free run at step {differ}, before the first "
                                     f"contact (step {hit[0]})")
            same = f"bit-equal to collisions='none' through step {hit[0]}"
            merged = f"{int((start.alive & ~fin.alive).sum())} merged"
        else:
            if differ is not None:
                raise AssertionError(f"merge bench row: positions differ at step {differ}")
            for f in ("pos", "pos_lo", "vel", "vel_lo", "mass", "alive", "step"):
                if not torch.equal(getattr(fin, f), getattr(other, f)):
                    raise AssertionError(f"merge bench row: final {f} differs")
            same, merged = "final state bit-equal to collisions='none'", "none merged"
        del log, log_none, runs
        self.merge_ms = (ms_merge, ms_none)
        line1 = (f"N={n} ds32 merge R={R_BENCH:g}: init_forces + 20 recorded + "
                 f"{self.drift_steps} unrecorded steps; contacts 0 at t=0, "
                 f"{int(counts.sum())} over the run on steps {hit}; {merged}; {same} "
                 f"(positions first differ at step {differ}); {ms_merge:.3f} ms/step wall armed "
                 f"vs {ms_none:.3f} without; launches B1 {b1}, B2 {b2}, roots {roots}")

        # contact-rich, through simulate() twice: bit-equal, conserved
        scene = SceneArrays(pos=pos, vel=vel, mass=mass, radius=np.full(n, R_RICH),
                            names=[f"b{i}" for i in range(n)])
        kw = dict(steps=MERGE_STEPS, dt=DT, softening=EPS2 ** 0.5, device=self.dev,
                  precision="ds32", collisions="merge", rescale=ot.Rescale.identity(),
                  record_every=MERGE_STEPS // 2)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ot.simulate(scene, **kw)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / MERGE_STEPS
        b2, roots = pairwise_acc_detect_cuda.launches, collision_roots_cuda.launches
        self.kernels["ROOTS"]["launches"] = roots
        again = ot.simulate(scene, **kw)
        a, b = res.final_state, again.final_state
        if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in
                   ("pos", "pos_lo", "vel", "vel_lo", "mass", "radius", "alive")):
            raise AssertionError("merge contact-rich: two simulate() runs differ")
        if b2 != MERGE_STEPS or roots != MERGE_STEPS:
            raise AssertionError(f"merge contact-rich: launches B2 {b2}, roots {roots}")
        if res.pos.shape != (2, n, 3) or not np.isfinite(res.pos).all():
            raise AssertionError("merge contact-rich: bad records")
        start = self.torch_state(pos, vel, mass, R_RICH)
        line2 = (f"simulate(collisions='merge') N={n} ds32 R={R_RICH:g}, {MERGE_STEPS} steps "
                 f"at {wall:.3f} ms/step wall (set-up included): "
                 f"{self.merged_checks('merge contact-rich', start, a)}; two runs bit-equal; "
                 f"launches B2 {b2}, roots {roots}")
        return line1, line2

    # phase 37
    def merge_steppers(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.multirate import respa_rollout
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops.cuda_collisions import collision_roots_cuda
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_detect_cuda
        from orbital_tpu_torch.ops.cuda_jerk import accel_jerk_detect_cuda

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, _ = self.cluster()
        start = self.torch_state(pos, vel, mass, R_RICH)
        lines = []
        # Hermite through simulate(), twice
        scene = SceneArrays(pos=pos, vel=vel, mass=mass, radius=np.full(n, R_RICH),
                            names=[f"b{i}" for i in range(n)])
        kw = dict(steps=MERGE_HERMITE_STEPS, dt=DT, softening=EPS2 ** 0.5, device=self.dev,
                  precision="ds32", collisions="merge", rescale=ot.Rescale.identity(),
                  record_every=MERGE_HERMITE_STEPS, integrator="hermite")
        reset_launches()
        finals = [ot.simulate(scene, **kw).final_state for _ in range(2)]
        detect, roots = accel_jerk_detect_cuda.launches, collision_roots_cuda.launches
        lines.append(self.merge_twice("hermite", start, finals, detect, roots,
                                      2 * MERGE_HERMITE_STEPS))
        # RESPA K = 4 (the geometry rebuilt every window, as collisions
        # require) through simulate(), twice; a dead body has no slot, so
        # RESPA counts it with the dropped bodies in `overflow`, as the JAX
        # stepper does, and simulate() warns once bodies have merged
        steps = RESPA_K * MERGE_RESPA_WINDOWS
        kw.update(steps=steps, record_every=steps, integrator="respa", respa_k=RESPA_K,
                  respa_rc=RC_RESPA, respa_cell=CELL_RESPA)
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            finals = [ot.simulate(scene, **kw).final_state for _ in range(2)]
        detect, roots = pairwise_acc_detect_cuda.launches, collision_roots_cuda.launches
        line = self.merge_twice("respa", start, finals, detect, roots, 2 * MERGE_RESPA_WINDOWS)
        said = [str(w.message) for w in caught]
        if not all(m.startswith("respa window diagnostics nonzero (overflow=") for m in said):
            raise AssertionError(f"merge respa: warnings {said}")
        # its counters, read from respa_rollout on the bench's budgets: the
        # split budgets and the skin 0, the overflow the dead bodies
        cfg = self.respa_config(refresh=1, collisions="merge")
        fin, _, diag = respa_rollout(ot.init_forces(start, cfg), cfg, steps)
        diag = {k: int(v) for k, v in diag.items()}
        dead = int((~fin.alive).sum())
        if (diag["cap_overflow"] or diag["w_overflow"] or diag["q_overflow"]
                or diag["skin_violation"] or not 0 < diag["overflow"] <= dead):
            raise AssertionError(f"merge respa: counters {diag} with {dead} dead")
        lines.append(f"{line}; simulate() warned only of the overflow counter; "
                     f"respa_rollout's counters {diag} with {dead} dead (overflow: bodies "
                     f"dead at a window's start)")
        return " | ".join(lines)

    def merge_twice(self, key: str, start, finals, detect: int, roots: int,
                    evals: int) -> str:
        """Two runs' final states bit-equal, each detecting sweep followed by
        one root search, and the merge invariants (``merged_checks``)."""
        torch = self.torch
        a, b = finals
        if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in
                   ("pos", "pos_lo", "vel", "vel_lo", "mass", "radius", "alive")):
            raise AssertionError(f"merge {key}: two runs differ")
        if detect != evals or roots != evals:
            raise AssertionError(f"merge {key}: {detect} detecting sweeps, {roots} root "
                                 f"searches for {evals} evaluations")
        return (f"{key} + merge N={start.n_bodies} ds32 R={R_RICH:g}, twice: "
                f"{self.merged_checks('merge ' + key, start, a)}; two runs bit-equal; "
                f"detecting sweeps {detect}, roots {roots}")

    # phase 38
    def resolve_bench_row(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_force_detect_fn, resolve_force_fn
        from orbital_tpu_torch.ops.cuda_collisions import (collision_roots_cuda,
                                                           contact_marks_cuda)
        from orbital_tpu_torch.ops.cuda_forces import (pairwise_acc_cuda,
                                                       pairwise_acc_detect_cuda)

        torch = self.torch
        n = N_MAIN
        pos, vel, mass, _ = self.cluster()
        runs = {}
        for mode in ("resolve", "none"):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, collisions=mode,
                               frag_seed=RESOLVE_SEED, debris_k=RESOLVE_DEBRIS_K)
            state = self.torch_state(pos, vel, mass, R_BENCH)
            resolve = resolve_force_detect_fn if mode == "resolve" else resolve_force_fn
            log = StepLog(resolve(cfg, n, self.dev), keep_pos=True, keep_counts=True)
            hook = dict(force_detect_fn=log) if mode == "resolve" else dict(force_fn=log)
            if mode == "resolve":
                reset_launches()
            state = ot.init_forces(state, cfg)
            rec, _ = ot.rollout(state, cfg, 20, record_every=10, fused="never", **hook)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg = cfg.replace(track_potential=False)
            log.fn = resolve(cfg, n, self.dev)
            fin, _ = ot.rollout(rec, cfg, self.drift_steps, fused="never", **hook)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if mode == "resolve":
                launches = (pairwise_acc_cuda.launches, pairwise_acc_detect_cuda.launches,
                            contact_marks_cuda.launches, collision_roots_cuda.launches)
            runs[mode] = (state, fin, 1e3 * wall / self.drift_steps, log)
        (start, fin, ms_on, log), (_, other, ms_off, log_off) = runs["resolve"], runs["none"]
        b1, b2, marks, roots = launches
        steps = 20 + self.drift_steps
        counts = torch.stack(log.counts).cpu().numpy()
        hit = [int(k) + 1 for k in np.flatnonzero(counts)]
        if counts[0] != 0 or b1 != 1 or b2 != steps or marks != steps or roots != 0:
            raise AssertionError(f"resolve bench row: {counts[0]} contacts at step 1, "
                                 f"launches B1 {b1}, B2 {b2}, marks {marks}, roots {roots}")
        differ = next((k + 1 for k, (a, b) in enumerate(zip(log.positions, log_off.positions))
                       if not torch.equal(a, b)), None)
        if hit:
            if differ is not None and differ <= hit[0]:
                raise AssertionError(f"resolve bench row: positions differ from the "
                                     f"collision-free run at step {differ}, before the first "
                                     f"contact (step {hit[0]})")
            same = f"bit-equal to collisions='none' through step {hit[0]}"
        else:
            if differ is not None:
                raise AssertionError(f"resolve bench row: positions differ at step {differ}")
            for f in ("pos", "pos_lo", "vel", "vel_lo", "mass", "alive", "step"):
                if not torch.equal(getattr(fin, f), getattr(other, f)):
                    raise AssertionError(f"resolve bench row: final {f} differs")
            same = "final state bit-equal to collisions='none'"
        if not (bool(torch.isfinite(fin.pos).all()) and bool(torch.isfinite(fin.vel).all())):
            raise AssertionError("resolve bench row: non-finite state")
        self.kernels["MARK"]["launches"] = marks
        gone = int((start.alive & ~fin.alive).sum())
        del log, log_off, runs
        # ms/step armed and unarmed in turns, without the step logs: 100
        # unrecorded steps from the recorded state, three times each
        steps = {}
        for mode in ("resolve", "none"):
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, collisions=mode,
                               frag_seed=RESOLVE_SEED, debris_k=RESOLVE_DEBRIS_K,
                               track_potential=False)
            steps[mode] = (lambda c: lambda: ot.rollout(start, c, 100, fused="never"))(cfg)
        turns = {k: summary([t / 100 for t in v]) for k, v in
                 alternate_ms(steps, 1, repeats=6).items()}
        self.resolve_ms = (turns["resolve"]["median"], turns["none"]["median"])
        # kernels and device time a step (torch.profiler over 10 steps): the
        # eager subset model runs at a count of 0 too, as no host read skips it
        prof = {}
        for mode, fn in steps.items():
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, collisions=mode,
                               frag_seed=RESOLVE_SEED, debris_k=RESOLVE_DEBRIS_K,
                               track_potential=False)
            k = device_times(lambda: ot.rollout(start, cfg, 10, fused="never"))
            prof[mode] = (sum(v[0] for v in k.values()) / 10, sum(v[1] for v in k.values()) / 10)
        print("perf_resolve_step " + json.dumps({"turns": turns, "profile": prof}),
              file=sys.stderr)
        return (f"N={n} ds32 resolve R={R_BENCH:g} frag_seed {RESOLVE_SEED} debris_k "
                f"{RESOLVE_DEBRIS_K}: init_forces + 20 recorded + {self.drift_steps} unrecorded "
                f"steps; {int(counts.sum())} contacts over the run on steps {hit}; {gone} "
                f"bodies gone; {same} (positions first differ at step {differ}); "
                f"{ms_on:.3f} ms/step wall armed vs {ms_off:.3f} without (logged runs); in "
                f"turns, 100 unlogged steps x 6: {turns['resolve']['median']:.3f} ms/step "
                f"(spread {turns['resolve']['spread']:.3f}) armed vs "
                f"{turns['none']['median']:.3f} ({turns['none']['spread']:.3f}) without; a step "
                f"by torch.profiler: {prof['resolve'][0]:.1f} kernels and {prof['resolve'][1]:.3f} "
                f"ms of device time armed, {prof['none'][0]:.1f} and {prof['none'][1]:.3f} "
                f"without; "
                f"launches B1 {b1}, B2 {b2}, marks {marks}, roots {roots}")

    def resolve_scene(self, t_touch: float):
        """The contact-rich resolve scene: the cluster at R_RICH, every
        RESOLVE_HEAVY_EVERY-th body RESOLVE_HEAVY_MASS times heavier, and
        RESOLVE_PAIRS pairs of light bodies placed to meet head-on at
        ``t_touch`` (the first detection: dt for KDK and Hermite, K dt for
        RESPA) at v_rel^2 = 4e3, E_coll = E_thresh, 0.5 R_RICH apart then."""
        from orbital_tpu_torch.models.scene import SceneArrays

        pos, vel, mass, _ = self.cluster()
        pos, vel, mass = pos.copy(), vel.copy(), mass.copy()
        n = len(mass)
        heavy = np.arange(0, n, RESOLVE_HEAVY_EVERY)
        mass[heavy] *= RESOLVE_HEAVY_MASS
        rng = np.random.default_rng(self.seed + 39)
        light = np.setdiff1d(np.arange(n), heavy)
        a, b = rng.choice(light, (2, RESOLVE_PAIRS), replace=False)
        v = 0.5 * np.sqrt(4e3)
        pos[b] = pos[a] + [2.0 * v * t_touch + 0.5 * R_RICH, 0.0, 0.0]
        vel[b] = vel[a] - [v, 0.0, 0.0]
        vel[a] = vel[a] + [v, 0.0, 0.0]
        return SceneArrays(pos=pos, vel=vel, mass=mass, radius=np.full(n, R_RICH),
                           names=[f"b{i}" for i in range(n)])

    def resolved_checks(self, key: str, scene, fin, stats: dict) -> str:
        """A resolve run's invariants in host f64: at least one absorption,
        fragmentation and debris body (from ``ResolveLog``); every dead body
        massless, without radius and parked beyond every live body's reach;
        the total mass conserved within RESOLVE_MASS_RTOL where every
        fragmentation spawned debris, and otherwise short by exactly the
        fragments that spawned none."""
        m0 = float(np.sum(scene.mass))
        m1 = float(fin.mass.double().sum())
        if not (bool(self.torch.isfinite(fin.pos).all())
                and bool(self.torch.isfinite(fin.vel).all())):
            raise AssertionError(f"{key}: non-finite state")
        if not (stats["absorbed"] >= 1 and stats["m_fragmented"] > 0 and stats["debris"] >= 1):
            raise AssertionError(f"{key}: not every outcome happened: {stats}")
        loss = (m0 - m1) / m0
        want = stats["m_unspawned"] / m0
        if abs(loss - want) > RESOLVE_MASS_RTOL:
            raise AssertionError(f"{key}: mass lost {loss:.3e} of M, fragments without debris "
                                 f"{want:.3e} (gate {RESOLVE_MASS_RTOL:g})")
        dead, live = ~fin.alive, fin.alive
        reach = float(fin.pos.double()[live].abs().max()) + 2.0 * float(fin.radius[live].max())
        parked = float(fin.pos.double()[dead].abs().amax(1).min())
        if bool(fin.mass[dead].any()) or bool(fin.radius[dead].any()) or parked < 1e3 * reach:
            raise AssertionError(f"{key}: dead bodies not massless, without radius and parked "
                                 f"far (nearest at {parked:.3e}, live reach {reach:.3e})")
        conserved = ("conserved" if stats["rounds_short"] == 0 else
                     f"short by the {stats['rounds_short']} rounds' fragments without debris")
        return (f"{int(stats['absorbed'])} absorbed into {int(stats['absorbers'])} absorber "
                f"rounds, {int(stats['fragmented'])} fragmented ({stats['m_fragmented'] / m0:.2e} "
                f"of M), {int(stats['debris'])} debris "
                f"in {stats['rounds']} rounds; |dM/M| {abs(loss):.2e} against {want:.2e} "
                f"unspawned (mass {conserved}, within {RESOLVE_MASS_RTOL:g}); dead massless, "
                f"radius 0, parked at >= {parked:.2e} (live reach {reach:.2e})")

    # phase 39
    def resolve_contact_rich(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_collisions import contact_marks_cuda
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_detect_cuda
        from orbital_tpu_torch.ops.cuda_jerk import accel_jerk_detect_cuda

        torch = self.torch
        base = dict(dt=DT, softening=EPS2 ** 0.5, device=self.dev, precision="ds32",
                    collisions="resolve", rescale=ot.Rescale.identity(),
                    frag_seed=RESOLVE_SEED, debris_k=RESOLVE_DEBRIS_K,
                    debris_max_pairs=RESOLVE_MAX_PAIRS, spare=RESOLVE_SPARE)
        runs = {
            "kdk": (DT, dict(steps=RESOLVE_STEPS, record_every=RESOLVE_STEPS // 2),
                    pairwise_acc_detect_cuda, RESOLVE_STEPS),
            "hermite": (DT, dict(steps=RESOLVE_HERMITE_STEPS, integrator="hermite",
                                 record_every=RESOLVE_HERMITE_STEPS),
                        accel_jerk_detect_cuda, RESOLVE_HERMITE_STEPS),
            "respa": (RESPA_K * DT, dict(steps=RESPA_K * RESOLVE_RESPA_WINDOWS,
                                         record_every=RESPA_K * RESOLVE_RESPA_WINDOWS,
                                         integrator="respa", respa_k=RESPA_K,
                                         respa_rc=RC_RESPA, respa_cell=CELL_RESPA),
                      pairwise_acc_detect_cuda, RESOLVE_RESPA_WINDOWS)}
        lines = []
        for key, (t_touch, kw, detect_fn, evals) in runs.items():
            scene = self.resolve_scene(t_touch)
            finals, said = [], []
            for k in range(2):
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ResolveLog() as rlog, warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    res = ot.simulate(scene, **base, **kw)
                    torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / kw["steps"]
                said += [str(w.message)[:60] for w in caught]
                finals.append(res.final_state)
                if k == 0:
                    stats = rlog.totals()
                    detect, marks = detect_fn.launches, contact_marks_cuda.launches
            a, b = finals
            if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in
                       ("pos", "pos_lo", "vel", "vel_lo", "mass", "radius", "alive")):
                raise AssertionError(f"resolve {key}: two runs differ")
            if detect != evals or marks != evals:
                raise AssertionError(f"resolve {key}: {detect} detecting sweeps, {marks} marks "
                                     f"for {evals} evaluations")
            if key == "kdk":
                self.kernels["MARK"]["launches_contact_rich"] = marks
            lines.append(f"{key} + resolve N={N_MAIN} + {RESOLVE_SPARE} spare ds32 "
                         f"R={R_RICH:g}, {kw['steps']} steps at {wall:.3f} ms/step wall "
                         f"(set-up included), twice: "
                         f"{self.resolved_checks('resolve ' + key, scene, a, stats)}; two runs "
                         f"bit-equal; detecting sweeps {detect}, marks {marks}; warnings "
                         f"{sorted(set(said))}")
        return " | ".join(lines)

    # phase 40
    def fragmentation_frequency(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.integrators import _apply_collisions
        from orbital_tpu_torch.ops.cuda_collisions import contact_marks_cuda

        torch = self.torch
        g = np.arange(FRAG_PAIRS)
        a = np.stack([g % 16, (g // 16) % 16, np.zeros_like(g)], 1).astype(float)
        v = 0.5 * np.sqrt(4e3)
        pos = np.concatenate([a, a + [0.015, 0.0, 0.0]])
        vel = np.concatenate([np.tile([v, 0.0, 0.0], (FRAG_PAIRS, 1)),
                              np.tile([-v, 0.0, 0.0], (FRAG_PAIRS, 1))])
        state = ot.make_state(pos, vel, np.ones(2 * FRAG_PAIRS), np.full(2 * FRAG_PAIRS, 0.01),
                              precision="f32", device=self.dev)
        cfg = ot.SimConfig(dt=DT, collisions="resolve", frag_seed=RESOLVE_SEED)
        reset_launches()
        frag = []
        for r in range(FRAG_ROUNDS):
            st = state.replace(step=torch.tensor(r + 1, dtype=torch.int32, device=self.dev))
            out = _apply_collisions(cfg, st)
            dead = ~out.alive
            if not torch.equal(dead[:FRAG_PAIRS], dead[FRAG_PAIRS:]):
                raise AssertionError("fragmentation: a pair half fragmented")
            frag.append(int(dead[:FRAG_PAIRS].sum()))
        trials = FRAG_PAIRS * FRAG_ROUNDS
        f = sum(frag) / trials
        tol = 4.0 * np.sqrt(0.25 / trials)
        if abs(f - 0.5) > tol or contact_marks_cuda.launches != FRAG_ROUNDS:
            raise AssertionError(f"fragmentation frequency {f:.4f} (tolerance {tol:.4f}), "
                                 f"{contact_marks_cuda.launches} mark launches")
        return (f"{FRAG_PAIRS} pairs at E_coll = E_thresh (p = 1/2) over {FRAG_ROUNDS} "
                f"rounds on the card's draws: {sum(frag)} of {trials} fragmented "
                f"({f:.4f}; per round {frag}), within 4 binomial sigmas ({tol:.4f}) of 0.5; "
                f"each pair wholly fragmented or bounced; marks {contact_marks_cuda.launches}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--drift-steps", type=int, default=1000,
                        help="unrecorded steps of the 65,536-body drift run")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", metavar="DIR",
                        help="only hold B1, B2, B3, B5, B5 detect, the B5 subset, B13, B6, "
                             "B12, B7, the near sweep, B4, the P3M short range and the root "
                             "search against DIR's kernel sources (phases 1, 2 and this "
                             "check)")
    parser.add_argument("--sweep", action="store_true",
                        help="only build and time the launch shapes of SWEEP (phases 1, 2 "
                             "and the sweep; with --parent, the parent check after it)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need a GPU",
              file=sys.stderr)
        return 2
    try:
        import orbital_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import orbital_tpu_torch ({exc}); run it from "
              "the repository root", file=sys.stderr)
        return 2

    smoke = Smoke(args.seed, args.drift_steps)
    phases = [
        ("1 device", smoke.device_info),
        ("2 build", smoke.build),
        ("3 forces", smoke.check_forces),
        ("4 fused", smoke.check_fused),
        ("5+6 main path", smoke.main_path),
        ("7 detect", smoke.check_detect),
        ("8 bounce", smoke.check_bounce),
        ("9 bounce bench row", smoke.bounce_bench_row),
        ("10 bounce contact-rich", smoke.bounce_contact_rich),
        ("11 timings", smoke.timings),
        ("12 jerk", smoke.check_jerk),
        ("13 hermite main path", smoke.hermite_main_path),
        ("14 hermite adaptive", smoke.hermite_adaptive),
        ("15 hermite block", smoke.block_timesteps),
        ("16 hermite bounce", smoke.hermite_bounce),
        ("17 hermite timings", smoke.hermite_timings),
        ("18 near", smoke.check_near),
        ("19 respa main path", smoke.respa_main_path),
        ("20 respa timings", smoke.respa_timings),
        ("21 tree near", smoke.check_tree_near),
        ("22 tree force", smoke.check_tree_force),
        ("23 tree main path", smoke.tree_main_path),
        ("24 tree timings", smoke.tree_timings),
        ("25 sym", smoke.check_sym),
        ("26 gram", smoke.check_gram),
        ("27 block", smoke.check_block),
        ("28 variants main path", smoke.variants_main_path),
        ("29 variant timings", smoke.variant_timings),
        ("30 pm", smoke.check_pm),
        ("31 p3m short", smoke.check_p3m_short),
        ("32 mesh main paths", smoke.mesh_main_path),
        ("33 mesh timings", smoke.mesh_timings),
        ("34 roots", smoke.check_roots),
        ("35+36 merge main path", smoke.merge_main_path),
        ("37 merge steppers", smoke.merge_steppers),
        ("38 resolve bench row", smoke.resolve_bench_row),
        ("39 resolve contact-rich", smoke.resolve_contact_rich),
        ("40 fragmentation frequency", smoke.fragmentation_frequency),
    ]
    if args.sweep or args.parent:
        phases = phases[:2] + ([("sweep", smoke.sweep)] if args.sweep else []) + (
            [("parent", lambda: smoke.check_parent(args.parent))] if args.parent else [])
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception:
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
            return 1
        results = result if isinstance(result, tuple) else (result,)
        for i, line in enumerate(results):
            label = name if len(results) == 1 else name.split()[0].split("+")[i]
            print(f"phase {label}: {line} [{time.perf_counter() - t0:.1f} s]", flush=True)

    if not (args.sweep or args.parent):
        print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
