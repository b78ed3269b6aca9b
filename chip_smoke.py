#!/usr/bin/env python3
"""Drive the PyTorch port (``orbital_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--drift-steps 1000] [--seed 0]
    python3 chip_smoke.py [--sweep] [--parent DIR]

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked by
``git archive``) it runs phases 1-2 and then only holds B1, B2, B3 (on
coinciding tables), B5, B5 detect, B13, B6, B12, B7, the near sweep and B4
of this tree against those built from DIR's ``csrc/nbody_forces.cu``,
``nbody_jerk.cu``, ``nbody_forces_mxu.cu``, ``collisions.cu``,
``nbody_forces_sym.cu``, ``tree_near.cu``, ``neighbor.cu`` and
``fused_rollout.cu`` (N = 65,536, 7 dead, eps2 1e-4 and 0, PE on and off; B7
on the tree tables of ``Smoke.tree_calls``, the near sweep on the RESPA
geometries of ``Smoke.near_calls``, B4 on FUSED_CASES) within FORCE_RTOL,
JERK_RTOL and ENERGY_RTOL with equal contact counts, B13 by the Gram gates,
B6 within BOUNCE_RTOL with the gated B6 bit-equal to the ungated, B7 and
the near sweep within NEAR_RTOL (B7 with equal overflow), B4 within
STATE_ATOL, says whether each is bit-equal, and times both trees' kernels
in turns (B7 at 65,536 and 1,048,576 bodies, B4 at 4,096 and 32,768 in
ds32 and f32). A source whose C signature predates its redesign (the near
sweep's and B4's first versions) runs through ``FIRST_SIGNATURES``. With
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
     there), B6, B12, B7 and the near sweep, and the issue floor they imply
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
     path beside B1's.

The launch counters are set to 0 just before each main path (phases 5+6, 9,
10, 13, 14, 15, 16, 19, 23 and 28) and read just after it: each kernel must
have run on its path. B3 has no single-card path (the multi-device ring
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
                            "ot_error_string"),
             "nbody_forces_mxu": ("nbody_forces_mxu", "ot_error_string"),
             "collisions": ("bounce_deltas", "ot_error_string"),
             "nbody_forces_sym": ("nbody_forces_sym", "ot_error_string"),
             "tree_near": ("tree_near", "ot_error_string"),
             "neighbor": ("near_sweep", "ot_error_string"),
             "fused_rollout": ("fused_kdk", "fused_kdk_shape", "ot_error_string")}
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


def alternate_ms(fns: dict, iters: int, repeats: int = 3) -> dict:
    """``time_ms`` of several functions in turns (a, b, b, a, ...), so that
    drift of the card's clock hits them alike."""
    out = {k: [] for k in fns}
    names = list(fns)
    for r in range(repeats):
        for k in (names if r % 2 == 0 else names[::-1]):
            out[k] += time_ms(fns[k], iters, repeats=1)
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
                                       cuda_forces_sym, cuda_jerk, cuda_neighbor, cuda_tree,
                                       fused_rollout)

    for fn in (cuda_forces.pairwise_acc_cuda, cuda_forces.pairwise_acc_detect_cuda,
               fused_rollout.fused_rollout, cuda_collisions.bounce_deltas_cuda,
               cuda_jerk.accel_jerk_cuda, cuda_jerk.accel_jerk_detect_cuda,
               cuda_jerk.accel_jerk_subset_cuda, cuda_neighbor.near_acc_slots_cuda,
               cuda_tree.tree_near_cuda, cuda_forces_sym.pairwise_acc_sym_cuda,
               cuda_forces_mxu.gram_sums_cuda, cuda_forces.block_acc_cuda):
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


# the sources whose C signature changed with their redesign, told by the
# launch-shape function that their first versions lack
FIRST_SIGNATURES = {"neighbor": _near_sweep_first, "fused_rollout": _fused_launch_first}


def other_build(name: str, path, like):
    """Another commit's build of source ``name`` at ``path``, bound as this
    tree's library ``like`` is, or as an OldBuild where its entry point is
    the first version's."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    if name in FIRST_SIGNATURES and not hasattr(lib, SHAPED[name][0]):
        return OldBuild(lib, FIRST_SIGNATURES[name](lib))
    return bind_like(path, like, LIB_FUNCS[name])


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


def loop_bodies(text: str, marker: str = r"MUFU\.RSQ") -> dict:
    """``{function: [instruction, ...]}``: the innermost loop of each
    function in SASS ``text`` that holds the most instructions matching
    ``marker`` (and of those, the fewest instructions a marker). A loop is
    the span from a backward branch's target to the branch; branch targets
    are addresses (``cuobjdump``) or ``.L_x_`` labels (``nvdisasm``)."""
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
                        "B13": dict(B13), "B3": dict(B3)}
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
                                           cuda_tree, fused_rollout)
        from orbital_tpu_torch.utils import kernels

        names = kernels.SOURCES
        t0 = time.perf_counter()
        kernels.build(names)
        for mod in (cuda_forces, fused_rollout, cuda_collisions, cuda_jerk, cuda_neighbor,
                    cuda_tree, cuda_forces_sym, cuda_forces_mxu):
            mod._load()
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
        logs = {name: kernels.build_log(name) for name in tiled}
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
        return (f"built {each} in parallel (load total {total:.2f} s) for sm_90a; at "
                f"N={N_MAIN}: " + "; ".join(shapes) + "; spill bytes: " + ", ".join(spills))

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
                "hermite_step_N65536": step, "block_macro_step_N65536": macro,
                "block_macro_m": m_b, "bounds_ms": bounds}
        print("perf_hermite " + json.dumps(perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        return (f"B5 N=65536 {ms(b5)} vs plain {ms(b5p)}; B5 detect {ms(b5d)} vs plain "
                f"{ms(b5dp)}; B5 subset F=64 {b5s['median'] * 1e3:.1f} us (spread "
                f"{b5s['spread'] * 1e3:.1f}) vs plain {ms(b5sp)}; Hermite ds32 step N=65536 "
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
            "B5D": (FORCE_RTOL, JERK_RTOL, ENERGY_RTOL, 0),
            "B13": (GRAM_MAX_RTOL, GRAM_MAX_RTOL), "B6": (BOUNCE_RTOL, BOUNCE_RTOL),
            "B6G": (BOUNCE_RTOL, BOUNCE_RTOL), "B6Z": (0, 0),
            "B12": (FORCE_RTOL, FORCE_RTOL), "B7": (NEAR_RTOL, NEAR_RTOL),
            "B7R": (NEAR_RTOL, NEAR_RTOL), "B7L": (NEAR_RTOL, NEAR_RTOL),
            "B7S": (NEAR_RTOL, NEAR_RTOL, 0), "NEAR": (NEAR_RTOL, NEAR_RTOL),
            "NEARW": (NEAR_RTOL, NEAR_RTOL), "NEARR": (NEAR_RTOL, NEAR_RTOL),
            **{k: (STATE_ATOL, STATE_ATOL) for k in FUSED_CASES}}
    # the source of each, the calls timed in turns and the pairs that must
    # be bit-equal
    SOURCE = {"B1": "nbody_forces", "B2": "nbody_forces", "B3": "nbody_forces",
              "B5": "nbody_jerk", "B5D": "nbody_jerk", "B13": "nbody_forces_mxu",
              "B6": "collisions", "B6G": "collisions", "B6Z": "collisions",
              "B12": "nbody_forces_sym", "B7": "tree_near", "B7R": "tree_near",
              "B7L": "tree_near", "B7S": "tree_near", "NEAR": "neighbor",
              "NEARW": "neighbor", "NEARR": "neighbor",
              **{k: "fused_rollout" for k in FUSED_CASES}}
    TIMED = {"nbody_forces": ("B1", "B2"), "nbody_jerk": ("B5", "B5D"),
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
        coinciding tables; with PE, eps2 > 0 and N % 128 == 0 only), B5 and
        B5 detect on ``scene``, B13 (its sums S and pe) and B12 (eps2 > 0
        and N % 128 == 0 only), and B6 ungated and gated on B2's count
        (restitution 0.8) and on a zero count; with ``plain``, their plain
        versions."""
        from orbital_tpu_torch.ops import cuda_collisions as cc
        from orbital_tpu_torch.ops import cuda_forces as cf
        from orbital_tpu_torch.ops import cuda_forces_mxu as cm
        from orbital_tpu_torch.ops import cuda_forces_sym as cs
        from orbital_tpu_torch.ops import cuda_jerk as cj

        pos, vel, mass, rad, alive = scene
        kw = dict(G=1.0, eps2=eps2)
        sfx = "_plain" if plain else "_cuda"
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
    def check_parent(self, parent: str) -> str:
        from pathlib import Path

        from orbital_tpu_torch.utils import kernels

        mods = self.redesigned()
        jobs = {name: (Path(parent) / "orbital_tpu_torch" / "csrc" / f"{name}.cu",
                       kernels.BUILD_DIR / "parent" / f"lib{name}.so") for name in mods}
        compile_libraries([(src, out, ()) for src, out in jobs.values()])
        old = {mod: other_build(name, jobs[name][1], mod._load())
               for name, mod in mods.items()}
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
                    if k in ("B5", "B5D") and not pe:
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
        fused_t = self.fused_calls(timing=True)
        calls = {k: v for k, v in self.exact_calls(scene, EPS2, pe=False).items()
                 if k != "B6G"}
        calls["B3"] = self.exact_calls(scene, EPS2, pe=True)["B3"]
        calls.update(B7=tree["B7"], B7L=tree["B7L"], NEAR=near["NEAR"])
        calls.update({k: fused_t[k] for k in ("B4", "B4F", "B4L", "B4LF")})
        fns = {}
        for k, (mod, call) in calls.items():
            fns[f"{k} parent"] = (lambda m_, l_, c_: lambda: on(m_, l_, c_))(mod, old[mod], call)
            fns[k] = call
        times = {k: summary(v) for k, v in alternate_ms(fns, 10, repeats=6).items()}
        # instructions a pair of both builds, and the SM clock under each of
        # this tree's kernels: the issue floor at the clock the card ran
        slots = {"parent": {}, "this": {}}
        for name in mods:
            slots["parent"].update(sass_slots(name, sass(jobs[name][1])))
            slots["this"].update(sass_slots(name, sass(kernels._library_path(name)[1])))
        clocks = {k: clock_during(call) for k, (_, call) in calls.items()}
        print("perf_parent " + json.dumps({"times": times, "slots": slots, "clocks": clocks}),
              file=sys.stderr)
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
        return (f"B1, B2, B3, B5, B5 detect, B13, B6, B12, B7, the near sweep and B4 held "
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
                f"{STATE_ATOL:g} on {FUSED_CASES}); in turns, 6 runs each (B1, B2, B13 no PE; "
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

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--drift-steps", type=int, default=1000,
                        help="unrecorded steps of the 65,536-body drift run")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", metavar="DIR",
                        help="only hold B1, B2, B3, B5, B5 detect, B13, B6, B12, B7, the "
                             "near sweep and B4 against DIR's kernel sources (phases 1, 2 "
                             "and this check)")
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
