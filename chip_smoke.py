#!/usr/bin/env python3
"""Drive the PyTorch port (``orbital_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--drift-steps 1000] [--seed 0]
    python3 chip_smoke.py [--sweep] [--parent DIR]
    python3 chip_smoke.py --ring-variants

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked by
``git archive``) it runs phases 1-2 and then only holds B1, B2, B3 (on
coinciding tables), B5, B5 detect, the B5 row subset, B13, B6, B12, B7, the
near sweep, B4, the P3M short range, the merge root search and the
ensemble kernel of this tree against those built from DIR's
``csrc/nbody_forces.cu``, ``nbody_jerk.cu``, ``nbody_forces_mxu.cu``,
``collisions.cu``, ``nbody_forces_sym.cu``, ``tree_near.cu``,
``neighbor.cu``, ``fused_rollout.cu``, ``p3m_short.cu``,
``collision_roots.cu`` and ``fused_ensemble.cu`` (the root
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
ds32 and f32, the root search at a count > 0 and at 0, the ensemble kernel
at 128, 1,024 and 8,192 config-5 members, held to its plain version), and
the block macro step on each tree's row subset (its time and the host's
time to queue it); and the ring's kernels at its shard shapes (B3 and B3
detect at RING_B^2 and RING_B8^2, P3M's two-table round at RING_P ranks
from its tables, and that round alone with its views, or the table form's
orders, built before). A source whose C signature predates its redesign
(the near sweep's, B4's, the row subset's, the P3M short range's first and
table forms, B3's first block form and the ensemble kernel's first
version) runs through ``FIRST_SIGNATURES``. With
``--ring-variants`` it runs phases 1-2 and then builds B3's block kernel and
P3M's sum at the launch shapes of RING_VARIANTS (``-D`` overrides), holds
each against this build and times them in turns at the ring's shard shapes.
With ``--sweep`` it runs phases 1-2 and then builds the launch shapes of
``SWEEP`` (``-D`` overrides of the eight sources' shape macros), holds each
against the plain versions and times them in turns, with the registers,
spills and SASS instructions a pair of each.

Phases, one line of output each; any failure exits nonzero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``orbital_tpu_torch/csrc``, one nvcc per
     source, all at once; the launch shape, registers, spills and SASS
     instructions a pair (``cuobjdump -sass``) of B1, B2, B3 and B3 detect
     (their block kernel's shape and plans at the ring's shard shapes), B4,
     B5, B5 detect, B13 (with the TF32 HMMA of its inner loop, which must be
     there), B6, B12, B7 and the near sweep, the shape, registers and spills
     of the B5 row subset, the P3M short range (with the SASS instructions a
     visited pair of its polynomial sweep) and the contact sweep's two modes,
     the merge root search and resolve's contact mark (with the SASS
     instructions a pair of their prefilter loop, one FSETP a pair, whose
     instructions go to standard error), the ensemble kernel's team and
     block kernels (the library's launch shapes against the layout the
     source states, the SASS instructions a pair of each; no spill anywhere),
     and the issue floor they imply
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
     draws each), within 4 binomial sigmas of 1/2;
 41. the ensemble kernel (``csrc/fused_ensemble.cu``) against its plain
     version (``fused_ensemble_plain``) at every (members, N) of ENS_CASES
     in f32 and ds32, with K = 0 (forces only) and ENS_CHECK_STEPS steps:
     positions and velocities within DRIFT_BUDGET of max, acc within
     FORCE_RTOL, potential within ENERGY_RTOL, clocks equal, two launches
     bit-equal; config 5 at 0 and 1 steps, and at ENS_CHECK_STEPS against
     the same steps in f64 (ENS_F64_FACTOR), and its first ENS_SLICE
     members launched alone bit-equal to the same members in the ensemble;
 42. the ensemble main path, BASELINE config 5: ``compile_system`` ->
     ``Rescale.natural`` -> ``make_state`` -> ``make_ensemble`` ->
     ``ensemble_rollout`` for ENS_STEPS steps in chunks of ENS_CHUNK, each
     member's |dE/E| from host-f64 energies (``ensemble_energies_f64``)
     within ENS_DRIFT_BOUND for the maximum and for member 0 (JAX's
     recorded drifts beside), one kernel launch a chunk and no member loop;
     a recorded rollout (one launch a block, records [E, R, ...]); and the
     member loop on a 4-member bounce ensemble;
 43. ensemble timings: the kernel route's ms a step and body-steps a second
     over ENS_TIMED_STEPS steps at each member count of ENS_SCALE, its
     bound and share of it, and the plain version's step at config 5;
 44. the facade: ``SimulationEngine`` on the card over the 65,536-body
     cluster as Objects (radius R_BENCH, the default bounce mode, ds32, the
     cluster's own units), FACADE_STEP_CALLS ``step()``s and
     ``run(FACADE_RUN)`` recording every FACADE_HISTORY_EVERY-th step: B1
     (the initial evaluation), B2 and the gated B6 launched through it, the
     history's length and stride, |dE/E| in f64 within DRIFT_BUDGET; a
     ``.npz`` checkpoint resumed in a fresh engine, FACADE_AFTER more steps
     in both bit-equal; ``run()`` against ``rollout`` alone on the same
     state, in turns (the facade's overhead);
 45. the viewer backend (``serve.backend``, no web layer on the card's
     machine): cluster mode at SIM_N = 65,536 with VIEWER_WARMUP warm-up
     steps, VIEWER_TICKS ticks of SIM_STEPS_PER_TICK steps (B1 each step)
     and as many snapshots (JSON, the schema's keys, 1,500 view bodies,
     finite), ms a tick and a snapshot, the checkpoint function; solar mode,
     SOLAR_TICKS ticks and its checkpoint;
 46. the CLI in process: ``simulate --steps 365 --device cuda``, its JSON
     line parsed and checked;
 47. fitting (``orbital_tpu_torch.fitting``) on the card in f64: the
     first FIT_CHECK_ITERS iterations of the velocity fit (its loss and
     backward as CUDA graphs) against the same fit run eagerly on the CPU;
     the two scenes of tests/test_fitting.py (the Earth-Moon pair in SI,
     velocity and central mass; two planets' elements) at those tests'
     iteration counts, with their recovery gates and ms an iteration, no
     kernel launched (the dense route); ``pairwise_acc_cuda`` and
     ``fused_rollout`` raising on a grad-requiring ``pos``;
 48. the tree's near modes at ``bench_tree``'s Plummer 65,536, levels 7,
     f32, with simulate()'s probed budgets for each (``"pairs"`` at chunk
     64): ``"cells"``, ``"columns"`` and ``"pairs"`` against ``"kernel"``
     (TREE_MODE_RTOL, overflow 0), each mode's evaluation timed by CUDA
     events with its peak memory, TREE_MODE_STEPS KDK steps of each within
     TREE_DRIFT_BOUND (B7 once a step on ``"kernel"`` only); one evaluation
     of ``"pairs"`` against ``"kernel"`` at 1,048,576, levels 8, timed;
 49. ``simulate(force_impl="tree", tree_accuracy=TREE_ACCURACY)`` at 65,536
     (its probe's exact evaluation through B1): the rung and its RMS force
     error against B1; ``SimulationEngine(force_impl="tree")`` with
     SimConfig's defaults (near "cells") on a TREE_ENGINE_N-body cluster
     for TREE_ENGINE_STEPS steps, overflow 0;
 50. the reference user code of tests/test_compat_core.py through
     ``orbital_tpu_torch/compat/core`` on the card, in a fresh process with
     no JAX imported;
 51. the multi-device ring's kernels at the bench row's shard shape
     (RING_B x RING_B, and RING_B8 x RING_B8 for B3D): B3 with detection
     (B3D) integer-equal in its count to its plain version and bit-equal to
     B3 in acc and pe, its acc within FORCE_RTOL of the plain one, and the block
     bounce (BB) within BOUNCE_RTOL of its plain version, zeros at count 0,
     at the contact-rich radius and the bench row's, on shards with a third
     dead, and the bounce on a ragged pair of blocks with a third dead;
 52. B3 in the ring (``parallel.sharded.ring_force_fn``) over RING_P and
     RING_P2 one-card ranks against B1 over the whole table (acc within
     FORCE_RTOL, U within RING_U_RTOL), its detecting form bit-equal with
     B2's count; P^2 launches each, B1 none;
 53. the ring's main path: the 65,536-body ds32 cluster through
     ``init_forces`` -> ``make_sharded_rollout`` over RING_P ranks,
     RING_STEPS recorded steps within STATE_ATOL of the single-card B1 path,
     then ``--drift-steps`` unrecorded, |dE/E| <= 1e-6 in f64, B3 launched
     RING_P^2 times an evaluation and B1 never;
 54. the ring's bounce at the bench row's radius, bit-equal step by step to
     the collision-free ring up to its first contact (B3D and BB RING_P^2 a
     step);
 55. the ring's bounce at the contact-rich radius against the single-card
     B2 + B6 path: counts equal each step, the state within STATE_ATOL;
 56. merge and resolve across the shards at the bench row, over RING_WINDOW
     steps from step RING_WINDOW_START: the ring's count equal to the single
     card's on each step, alive equal, merge's mass and momentum conserved;
 57. the sharded PM at 65,536 (grid 128; pinned box and the cube by
     pmin/pmax) against the single-card PM within PM_RTOL, and RING_STEPS
     sharded PM steps against the single card's;
 58. ``simulate(mesh=..., collisions="bounce")`` on the card against
     ``simulate()`` on one card;
 59. the process-group backend: a ``torch.distributed`` group of one rank
     over NCCL (a ``file://`` store), RING_NCCL_STEPS recorded merge steps at
     the contact-rich radius bit-equal to the one-card mesh of one rank;
 60. ring timings: B3, B3D and BB at RING_B x RING_B beside their plain
     versions and bounds (BB also at count 0; B3 and B3D also at RING_B8 x
     RING_B8), the bounce step at the bench row on one card and on the
     ring at RING_P ranks in turns (host and busy time), the KDK step on one card and
     on the ring at each of RING_TIMED's rank counts in turns, and for each
     a step's host time, a rank's wait in the exchange and the device's
     busy time (torch.profiler);
 61. P3M's ring round at RING_P and RING_P8 ranks: each shard's view
     (``cuda_p3m.p3m_short_view_cuda``) equal to its plain version, the
     two-table form (``cuda_p3m.p3m_short_round_cuda``) on the P3M row's
     shards, a diagonal and three other rounds with the visitor's view as
     the ring ships it, against the plain version within SHORT_RTOL and
     bit-equal to the same round with the visitor's view built again
     (``p3m_short_pair_cuda``), shard 0's rounds summed in place against the
     single-table sum, a round timed (events, device time, host time)
     beside the diagonal one, the round building both views, its plain
     version and its bound (the pairs the round needs), and the bytes a
     shift of the ring carries;
 62. P3M's ring over RING_P one-card ranks: the evaluation against the
     single-card ``p3m_acc_potential`` (P3M_RING_RTOL, RING_U_RTOL),
     RING_P^2 two-table and RING_P view launches an evaluation (each rank
     builds its own view once), the pairs rank
     0's rounds need against the single card's; the main path, RING_STEPS
     recorded steps within STATE_ATOL of one card's and P3M_RING_STEPS in
     all within P3M_DRIFT_BOUND; a step in turns with one card, its host
     time and the device's busy time;
 63. the sharded tree on bench_tree's sphere: B7's RING_P slices of the
     worklist summed against the whole sweep and each against its plain
     version (NEAR_RTOL), a slice timed beside its bound; the sharded
     evaluation against one card's (TREE_MODE_RTOL); TREE_RING_STEPS steps
     over RING_P ranks within STATE_ATOL of one card's, B7's slice RING_P
     times a step and B7 never; the staged route at TREE_STAGED_N bodies,
     levels 8, TREE_STAGED_STEPS steps, overflow 0, against one card's;
 64. the sharded RESPA on the RESPA row: the near sweep of each rank's
     chunks (``near_acc_slots_rows_cuda``) against its plain version, the
     ranks' rows bit-equal to the whole sweep, rank 0's timed beside its
     bound; ``make_sharded_respa_rollout`` over RING_P ranks,
     RESPA_RING_WINDOWS windows within STATE_ATOL of one card's with the
     counters 0, then RESPA_RING_DRIFT_WINDOWS more within DRIFT_BUDGET; a
     substep in turns with one card;
 65. the (ensemble x body) mesh of ENS_MESH_SHAPE one-card ranks,
     ``make_sharded_ensemble_step`` on ENS_MESH_E perturbed members, bounce
     and merge, each member's live bodies after ENS_MESH_STEPS steps within
     STATE_ATOL of its own single-card run, alive equal, B3 (and the block
     bounce) E x P_body^2 times a step.

The launch counters are set to 0 just before each main path (phases 5+6, 9,
10, 13, 14, 15, 16, 19, 23, 28, 32, 35, 36, 37, 38, 39, 42, 44, 45, 47, 48,
49, 53, 54, 58, 62, 63, 64 and 65) and read just after it:
each kernel must have run on its path. B3 runs on the multi-device ring only:
phase 27 checks it alone, phase 28 requires 0 launches over its three
single-card main paths, and its record's launches are phase 53's. The
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
# the multi-device ring (phases 51-57, ROADMAP A.15a): the bench row sharded
# over RING_P one-card ranks (and RING_P2), shards of RING_B bodies, each ring
# round a B3 launch at RING_B x RING_B; RING_STEPS recorded steps held
# against the single-card path; the bench row's bounce ring against the
# collision-free ring for up to RING_BOUNCE_STEPS steps (its first contact on
# one card is at step 587, seed 0); the merge and resolve window of
# RING_WINDOW steps from step RING_WINDOW_START (contacts at 587 and 609);
# RING_NCCL_STEPS merge steps over the NCCL group of one rank; the ring's U
# against B1's, relative (f32 sums of 65,536 rows in two orders)
RING_P, RING_P2 = 4, 2
RING_TIMED = (RING_P, RING_P2, 8)
RING_B = N_MAIN // RING_P
# the ring's kernels are also held and timed at 8 ranks' shards (B3, B3
# detect and P3M's two-table round)
RING_P8 = 8
RING_B8 = N_MAIN // RING_P8
RING_STEPS, RING_BOUNCE_STEPS = 20, 600
RING_WINDOW_START, RING_WINDOW, RING_NCCL_STEPS = 560, 100, 5
RING_U_RTOL = 1e-6
# the multi-device paths of part two (phases 61-65, ROADMAP A.15b), each over
# RING_P one-card ranks: P3M's ring on its uniform row (P3M_RING_STEPS
# steps, the first RING_STEPS recorded and held against one card); its acc
# against the single-card solve, max |d a| / max |a|: the rounds' partial
# sums, the psum'd grid and the deposit's float atomics in other orders
# (P3M_RING_RTOL); the sharded tree on bench_tree's sphere (TREE_RING_STEPS
# steps against one card's) and the staged route at TREE_STAGED_N bodies,
# levels 8 (TREE_STAGED_STEPS steps); the sharded RESPA on the RESPA row
# (RESPA_RING_WINDOWS windows against one card's, RESPA_RING_DRIFT_WINDOWS
# for the drift); the (ensemble x body) mesh, ENS_MESH_SHAPE ranks over
# ENS_MESH_E members of an ENS_MESH_N-body cluster (positions perturbed by
# ENS_MESH_SIGMA) at radius ENS_MESH_R, ENS_MESH_STEPS steps of bounce and
# of merge held member by member against one card's
P3M_RING_STEPS, P3M_RING_RTOL = 400, 1e-5
TREE_RING_STEPS, TREE_STAGED_N, TREE_STAGED_STEPS = 20, 1048576, 3
RESPA_RING_WINDOWS, RESPA_RING_DRIFT_WINDOWS = 3, 100
ENS_MESH_SHAPE, ENS_MESH_E, ENS_MESH_N = (2, 2), 4, 4096
ENS_MESH_SIGMA, ENS_MESH_R, ENS_MESH_STEPS = 1e-6, 0.03, 10
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
# the ensemble runs (phases 41-43): BASELINE config 5 (bench.py:517-593),
# 1,024 perturbed copies of compile_system(solar_system_v2(moons=True),
# compose_parents=True) (26 bodies), ds32 in natural units, dt 1,800 s,
# softening 1e6 m, pos_sigma 1e-8 (internal units) from generator seed 7,
# 10,000 steps in chunks of 2,000, per-member |dE/E| from host-f64 energies
# gated at the exact kernels' 1e-6 for the maximum and for member 0; JAX's
# recorded drifts (BENCH_LAST_GOOD.json) printed beside, not a target
ENS_MEMBERS, ENS_SEED, ENS_SIGMA, ENS_DT_S, ENS_SOFT_M = 1024, 7, 1e-8, 1800.0, 1e6
ENS_STEPS, ENS_CHUNK, ENS_DRIFT_BOUND = 10000, 2000, 1e-6
JAX_ENS_DRIFT, JAX_ENS_DRIFT_MEMBER0 = 7.709708863116476e-07, 1.392445959962589e-07
# phase 41's (members, bodies): config 5, and Gaussian clusters (every other
# member with a fifth of its bodies dead) across the kernel's two launch
# modes (a warp a member at N <= 32, a block a member above) and its largest
# timed N; their softening, and the steps held against the plain version
ENS_CASES = ((ENS_MEMBERS, 26), (3, 1), (5, 32), (7, 33), (4, 100), (2, 1024))
ENS_RAND_EPS2, ENS_CHECK_STEPS = 1e-2, 100
# Config 5's moons sit ~1.4e-4 (internal) from planets at ~0.26, so one ulp
# of a hi position moves a moon's acceleration by ~6e-4 of it, and any two
# f32 sweeps (kernel and plain, or plain f32 and ds32) part there: in a CPU
# emulation of the kernel (exact sqrt) they read 1.9e-4 of max |v| apart
# after 100 steps while each sat 1.7e-2 from the f64 run. So config 5 is held
# to the plain version after 0 and 1 steps, and after ENS_CHECK_STEPS each is
# held to the same steps in f64 from the same state: the kernel's distance
# within ENS_F64_FACTOR of the plain version's
ENS_F64_FACTOR = 2.0
# phase 43: the timed steps of the kernel route, and the member counts timed
ENS_TIMED_STEPS, ENS_SCALE = 1000, (128, 1024, 8192)
# phase 41: a launch of config 5's first ENS_SLICE members alone, bit-equal to
# the same members in the 1,024-member launch
ENS_SLICE = 128

# the facade and viewer runs (phases 44-46): the engine on the 65,536-body
# cluster in its own units (G = 1 through the unit profile, the identity
# rescale, so its config is the bench cluster's: dt 1e-3, eps2 1e-4) with the
# bench row's radius and the default bounce mode: FACADE_STEP_CALLS step()s,
# run(FACADE_RUN) recording every FACADE_HISTORY_EVERY-th step, a checkpoint
# resumed in a fresh engine and FACADE_AFTER more steps in both (bit-equal);
# run() against rollout alone with the same recording and host copy over
# FACADE_TIMED steps, FACADE_TIMED_REPEATS times each in turns. The viewer backend at SIM_N = 65,536 with VIEWER_WARMUP
# warm-up steps (the default is 5,000) and VIEWER_TICKS ticks and snapshots;
# solar mode with SOLAR_TICKS ticks
FACADE_STEP_CALLS, FACADE_RUN, FACADE_HISTORY_EVERY, FACADE_AFTER = 10, 500, 50, 100
FACADE_TIMED, FACADE_TIMED_REPEATS = 200, 8
VIEWER_WARMUP, VIEWER_TICKS, VIEWER_VIEW, SOLAR_TICKS = 100, 5, 1500, 3

# the fitting runs (phase 47): the two scenes of tests/test_fitting.py on the
# card in f64 at those tests' iteration counts and learning rates (the
# Earth-Moon pair in SI, observed every 24 one-hour steps over 240; two
# planets about a unit mass observed every 40 steps of 2e-3 over 400), their
# recovery gates as the tests state them
G_SI = 6.6743e-11
FIT_VEL_ITERS, FIT_MASS_ITERS, FIT_ELEMENTS_ITERS = 250, 300, 200
# the first FIT_CHECK_ITERS iterations of the velocity fit on the card against
# the same fit on the CPU: f64 sums of the same few terms, ~1e-15 apart a step
# (rsqrt on two devices), grown by the optimizer's ten steps; 1e-9 leaves room
# and still fails a wrong or stale graph replay
FIT_CHECK_ITERS, FIT_CPU_RTOL = 10, 1e-9
# the tree's near modes (phases 48-49): bench_tree's Plummer sphere with each
# mode's probe-sized budgets ("pairs" at chunk 64, as the JAX package's
# "auto" takes it); each mode against "kernel" within TREE_MODE_RTOL (max
# |d a| / max |a| and |d U / U|: f32 sums of the same near pairs in other
# orders, as FORCE_RTOL), TREE_MODE_STEPS steps each within TREE_DRIFT_BOUND,
# the modes timed TREE_MODE_ITERS calls a repeat; the 1,048,576-body
# evaluation of "pairs" against "kernel"; tree_accuracy='s target and the
# facade's tree run (SimConfig's defaults: near "cells", capacity 48, levels
# 6) on the cluster of TREE_ENGINE_N bodies for TREE_ENGINE_STEPS steps
TREE_MODES = ("cells", "columns", "pairs")
TREE_MODE_RTOL, TREE_MODE_STEPS, TREE_MODE_ITERS, TREE_PAIRS_CHUNK = 1e-5, 100, 3, 64
TREE_ACCURACY = 1e-2
TREE_ENGINE_N, TREE_ENGINE_STEPS = 16384, 20

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
        "B3": "block_forces_kernelILb0E"}, r"MUFU\.RSQ"),
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
                              "nbody_block_forces_detect", "nbody_block_shape",
                              "ot_error_string"),
             "nbody_jerk": ("nbody_jerk", "nbody_jerk_detect", "nbody_jerk_subset",
                            "nbody_jerk_subset_shape", "ot_error_string"),
             "nbody_forces_mxu": ("nbody_forces_mxu", "ot_error_string"),
             "collisions": ("bounce_deltas", "bounce_block_deltas", "ot_error_string"),
             "nbody_forces_sym": ("nbody_forces_sym", "ot_error_string"),
             "tree_near": ("tree_near", "ot_error_string"),
             "neighbor": ("near_sweep", "near_sweep_rows", "ot_error_string"),
             "fused_rollout": ("fused_kdk", "fused_kdk_shape", "ot_error_string"),
             "p3m_short": ("p3m_short_view", "p3m_short_sorted", "p3m_short_pair",
                           "p3m_short_shape", "ot_error_string"),
             "fused_ensemble": ("fused_ensemble", "fused_ensemble_shape", "ot_error_string")}
# --ring-variants: B3's block kernel (i bodies a thread, warps, blocks an SM
# its registers are capped for; the first is the source's) and P3M's sum
# (warps a block; the first is the source's), built with -D
RING_VARIANTS = {"nbody_forces": (("k2q16m2", ()),
                                  ("k4q8m2", ("-DOT_BLOCK_K=4", "-DOT_BLOCK_Q=8")),
                                  ("k4q16m1", ("-DOT_BLOCK_K=4", "-DOT_BLOCK_Q=16",
                                               "-DOT_BLOCK_MIN=1")),
                                  ("k2q8m4", ("-DOT_BLOCK_K=2", "-DOT_BLOCK_Q=8",
                                              "-DOT_BLOCK_MIN=4"))),
                 "p3m_short": (("q8", ()), ("q4", ("-DOT_P3M_Q=4",)),
                               ("q16", ("-DOT_P3M_Q=16",)))}
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
# the multi-device ring's round (phase 53 counts it; phase 28 requires 0
# over the single-card variants' main paths)
B3 = dict(name="nbody_block_forces", route="cuda",
          source="orbital_tpu_torch/csrc/nbody_forces.cu",
          replaces="orbital_tpu/ops/pallas_forces.py:221")
# no TPU kernel: B3 with detection stands in for the XLA count ring of the
# sharded step (orbital_tpu/ops/collisions.py:97-113 _contacts_block, ringed
# by orbital_tpu/parallel/sharded.py:199-231)
B3D = dict(name="nbody_block_forces_detect", route="cuda",
           source="orbital_tpu_torch/csrc/nbody_forces.cu",
           replaces="orbital_tpu/ops/collisions.py:97")
# no TPU kernel: the block bounce (B6's kernel over separate i and j
# tables) stands in for the XLA block of the ring's bounce
# (orbital_tpu/parallel/sharded.py:72-117 _block_bounce)
BB = dict(name="bounce_block_deltas", route="cuda",
          source="orbital_tpu_torch/csrc/collisions.cu",
          replaces="orbital_tpu/parallel/sharded.py:72")
# no TPU kernel: stands in for the plain XLA lax.map over cell blocks of
# p3m_acc_potential (orbital_tpu/ops/p3m.py:181-231)
P3M = dict(name="p3m_short", route="cuda", source="orbital_tpu_torch/csrc/p3m_short.cu",
           replaces="orbital_tpu/ops/p3m.py:181")
# the short range's view of a cell table: each cell's kept prefix reordered
# into a compact array, with its runs and the slice list (a second kernel of
# the same source, the redesign's own; the JAX tile form needs none)
P3MO = dict(name="p3m_short_view", route="cuda", source="orbital_tpu_torch/csrc/p3m_short.cu",
            replaces="orbital_tpu/ops/p3m.py:181")
# the multi-device paths of phases 61-65 (ROADMAP A.15b): the short range's
# two-table form, a round of P3M's ring (this rank's table against a
# visitor's; no TPU kernel: the ring's XLA sweep, orbital_tpu/ops/p3m.py:
# 347-404); B7 over one rank's slice of the worklist (the sharded tree,
# orbital_tpu/ops/tree_near_wl.py:307-313 slicing the Pallas kernel's
# worklist); the near sweep of one rank's i chunks (the sharded RESPA,
# the Pallas B10 kernel's i0 form, orbital_tpu/ops/neighbor_pallas.py:453)
P3MR = dict(name="p3m_short_pair", route="cuda", source="orbital_tpu_torch/csrc/p3m_short.cu",
            replaces="orbital_tpu/ops/p3m.py:347")
B7S = dict(name="tree_near_part", route="cuda", source="orbital_tpu_torch/csrc/tree_near.cu",
           replaces="orbital_tpu/ops/tree_near_wl.py:171")
NEARI = dict(name="near_sweep_rows", route="cuda", source="orbital_tpu_torch/csrc/neighbor.cu",
             replaces="orbital_tpu/ops/neighbor_pallas.py:394")
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
# no TPU kernel: stands in for the XLA code of the JAX package's vmapped
# ensemble rollout (orbital_tpu/parallel/ensemble.py:53-69, dense, fused="never")
ENS = dict(name="fused_ensemble", route="cuda",
           source="orbital_tpu_torch/csrc/fused_ensemble.cu",
           replaces="orbital_tpu/parallel/ensemble.py:53")
# its two kernels (mangled-name stems): the team kernel (N <= 32, a warp a
# member, a lane a body) and the block kernel (N > 32)
ENS_MODES = {"team": "ensemble_team_kernel", "block": "ensemble_block_kernel"}


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


def earth_moon():
    """The Earth-Moon circular pair in SI (tests/test_fitting.py:11-22):
    positions, velocities, masses."""
    R = 3.844e8
    m1, m2 = 5.972e24, 7.348e22
    mu = G_SI * (m1 + m2)
    v2 = np.sqrt(mu / R) * (m1 / (m1 + m2))
    v1 = -np.sqrt(mu / R) * (m2 / (m1 + m2))
    return (np.array([[0.0, 0.0, 0.0], [R, 0.0, 0.0]]),
            np.array([[0.0, v1, 0.0], [0.0, v2, 0.0]]), np.array([m1, m2]))


def raises(exc, match: str, fn) -> str:
    """Call ``fn``, require it to raise ``exc`` whose message holds
    ``match``, and return the message's start."""
    try:
        fn()
    except exc as err:
        if match not in str(err):
            raise AssertionError(f"expected {match!r} in: {err}") from err
        return f"{exc.__name__}: {str(err)[:60]}..."
    raise AssertionError(f"expected {exc.__name__} ({match!r}), nothing raised")


REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def reference_user_code() -> str:
    """The reference-style user code of tests/test_compat_core.py: its
    ``SCRIPT`` after the JAX platform preamble, read from the checkout with
    ``ast`` (the test module is not imported)."""
    import ast

    path = os.path.join(REPO_ROOT, "tests", "test_compat_core.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    script = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and any(getattr(t, "id", None) == "SCRIPT" for t in node.targets))
    return "import numpy as np\n" + script.split("import numpy as np\n", 1)[1]


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
              r1: float = None, i0: int = 0) -> dict:
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
    at most 32 rows (one block slice each). With ``i0`` the jbl rows are the
    i chunks from ``i0`` on (the mesh-sharded sweep's share)."""
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
    rows_i = slice(i0 * chunk, (i0 + k_ch) * chunk)
    live_i = live[rows_i].reshape(k_ch, chunk)
    n_i = live_i.sum(1)
    live_b = live.reshape(-1, blkw).sum(1)
    live_pairs = int((n_i * torch.where(used, live_b[jbl], 0).sum(1)).sum())
    # each chunk's box, rounded outward as the kernel rounds it
    h = near_params(0.5 * rc if r1 is None else r1, rc, 1.0, eps2)["h"]
    p_i = pos[rows_i].reshape(k_ch, chunk, 3).double()
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
        slots = (i0 + c_e[:, None]) * chunk + ai                       # [E, chunk]
        d2 = ((pj[:, None] - pos[slots].double()[:, :, None]) ** 2).sum(-1)
        near = (d2 < rc * rc) & live[slots][:, :, None] & live[rows][:, None, :]
        needed += int((near & (slots[:, :, None] != rows[:, None, :])).sum())
    visited = int((n_i * in_box).sum())
    width = 2 ** torch.ceil(torch.log2(n_i.clamp(min=1).double())).long()
    issued = int(torch.where(n_i > 0, 32 * -(-in_box // (32 // width)), 0).sum())
    nbytes = 16 * n_slots + 4 * k_ch * w_blk + 4 * k_ch + 16 * k_ch * chunk
    return dict(walked=walked, live=live_pairs, visited=visited, issued=issued,
                needed=needed, nbytes=nbytes)


def pairs_within(pos_i, pos_j, r2: float, same: bool = False, rows: int = 1024) -> int:
    """Pairs (i, j) of two position sets with an f32 squared distance below
    ``r2`` (the short range's test), i != j when the sets are one."""
    import torch

    n = 0
    for a in range(0, pos_i.shape[0], rows):
        d = pos_j[None, :, :] - pos_i[a:a + rows, None, :]
        near = (d * d).sum(-1) < r2
        if same:
            k = torch.arange(a, a + near.shape[0], device=near.device)
            near[torch.arange(near.shape[0], device=near.device), k] = False
        n += int(near.sum())
    return n


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
    of the slice's box), the lane slots it issues (the staged rows in run
    order as one flat sequence, warp w of ``warps`` taking its 32-row rounds
    w, w + warps, ..., and sweeping the rows within reach among them in 32 x
    ceil(V_w / G) lane slots, G = 32 / S groups, S the power of two >= the
    slice's rows: every sweep but a warp's last takes a multiple of G
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
        on = live & torch.gather(reach, 2, octant[ids_c].clamp(max=7))   # [S, 27, M]
        staged_rows = on.sum((1, 2))
        # each staged row's place in the flat sequence (cells, then rows in
        # run order) and the warp whose round holds it
        flat = torch.cumsum(on.flatten(1).long(), 1).reshape(on.shape) - 1
        warp_of = (flat // 32) % warps
        v_w = torch.stack([(inside & (warp_of == w)).sum((1, 2)) for w in range(warps)], 1)
        r = sl["rows"][a:a + 64]
        staged += int((r * staged_rows).sum())
        visited += int((r * inside.sum((1, 2))).sum())
        issued += int((32 * -(-v_w // groups[a:a + 64, None])).sum())
    kept = int(count.sum())
    return dict(jax_slots=-(-gc3 // 32) * 32 * cap * 27 * cap, walked=walked, staged=staged,
                visited=visited, issued=issued, needed=needed,
                nbytes=24 * kept + 4 * gc3 + 16 * n)


def energy_f64(state, eps2: float = EPS2) -> float:
    """Total energy in f64 from the (ds32) state: kinetic on the host,
    softened potential (softening ``eps2``) from the f64 oracle."""
    from orbital_tpu_torch.utils import native

    def full(hi, lo):
        x = hi.double()
        return (x if lo is None else x + lo.double()).cpu().numpy()

    pos, vel = full(state.pos, state.pos_lo), full(state.vel, state.vel_lo)
    mass = state.mass.double().cpu().numpy()
    K = 0.5 * float(np.sum(mass * np.sum(vel * vel, -1)))
    return K + native.potential_f64(pos, mass, eps2)


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
                                       cuda_tree, fused_ensemble, fused_rollout)
    from orbital_tpu_torch.parallel import ensemble

    for fn in (cuda_forces.pairwise_acc_cuda, cuda_forces.pairwise_acc_detect_cuda,
               fused_rollout.fused_rollout, cuda_collisions.bounce_deltas_cuda,
               cuda_jerk.accel_jerk_cuda, cuda_jerk.accel_jerk_detect_cuda,
               cuda_jerk.accel_jerk_subset_cuda, cuda_neighbor.near_acc_slots_cuda,
               cuda_tree.tree_near_cuda, cuda_forces_sym.pairwise_acc_sym_cuda,
               cuda_forces_mxu.gram_sums_cuda, cuda_forces.block_acc_cuda,
               cuda_p3m.p3m_short_cuda, cuda_p3m.p3m_short_order_cuda,
               cuda_collisions.collision_roots_cuda, cuda_collisions.contact_marks_cuda,
               fused_ensemble.fused_ensemble, cuda_forces.block_acc_detect_cuda,
               cuda_collisions.bounce_block_cuda, cuda_p3m.p3m_short_pair_cuda,
               cuda_p3m.p3m_short_view_cuda, cuda_p3m.p3m_short_round_cuda,
               cuda_tree.tree_near_part_cuda, cuda_neighbor.near_acc_slots_rows_cuda):
        fn.launches = 0
    ensemble.member_loop.runs = 0


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


@contextlib.contextmanager
def ring_counts(log: list):
    """While active, the sharded steps built (``make_sharded_step``,
    ``make_sharded_rollout``) append the psum'd contact count of each
    closing ring evaluation (rank 0's; every rank holds the same) to
    ``log``, on the device."""
    from orbital_tpu_torch.parallel import sharded

    make = sharded.ring_force_fn

    def logged(cfg, comm, detect=False):
        fn = make(cfg, comm, detect)
        if not detect or comm.rank != 0:
            return fn

        def counted(*args):
            out = fn(*args)
            log.append(out[2])
            return out
        return counted

    sharded.ring_force_fn = logged
    try:
        yield
    finally:
        sharded.ring_force_fn = make


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
    argument types of ``like``, the library this tree built (an entry point
    the other build lacks, added since, stays unbound)."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    for fn in names:
        if not hasattr(lib, fn):
            continue
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


def _p3m_tables_lib(lib):
    """The C signatures of the short range's table form (PRs 12-18: the
    reorder into the padded table, ``p3m_short_order``, the single-table sum
    ``p3m_short_sorted`` and the two-table form ``p3m_short_pair``, over
    grids of cells x slices), bound on ``lib``."""
    import ctypes

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.p3m_short_order.restype = ctypes.c_int
    lib.p3m_short_order.argtypes = [p, p, p, p, i, i, p, p, p, p, p, i]
    lib.p3m_short_sorted.restype = ctypes.c_int
    lib.p3m_short_sorted.argtypes = [p, p, p, p, i, i, p, f, f, p, p, p, i]
    lib.p3m_short_pair.restype = ctypes.c_int
    lib.p3m_short_pair.argtypes = [p, p, p, p, p, p, i, i, i, p, f, f, p, p, p, i]
    return lib


def _p3m_tables_order(lib, tab, gc: int) -> dict:
    """The table form's reorder of ``tab`` (the padded layout)."""
    import torch

    from orbital_tpu_torch.utils.kernels import check

    gc3, cap, dev = gc ** 3, tab["table"].shape[1], tab["table"].device
    out = dict(rows=torch.empty((gc3, cap, 4), dtype=torch.float32, device=dev),
               table=torch.empty((gc3, cap), dtype=torch.int64, device=dev),
               run_off=torch.empty((gc3, 9), dtype=torch.int32, device=dev),
               run_box=torch.empty((gc3, 8, 6), dtype=torch.float32, device=dev))
    ins = (tab["cell_pos"][:gc3].contiguous(), tab["cell_m"][:gc3].contiguous(),
           tab["table"][:gc3].to(torch.int64).contiguous(),
           tab["count"].to(torch.int32).contiguous())
    err = lib.p3m_short_order(*(t.data_ptr() for t in ins), int(gc), int(cap),
                              *(out[k].data_ptr() for k in ("rows", "table", "run_off",
                                                            "run_box")),
                              torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    check(lib, err, "p3m_short_order launch (table form)")
    return out


def _p3m_tables_pair(lib, order_i, order_j, diag: bool, gc: int, params, G: float,
                     eps2: float, acc, pe) -> None:
    """The table form's two-table sum over two reordered tables, into the
    zeroed ``acc`` and ``pe``."""
    import torch

    from orbital_tpu_torch.utils.kernels import check

    dev = acc.device
    err = lib.p3m_short_pair(order_i["rows"].data_ptr(), order_i["table"].data_ptr(),
                             order_i["run_off"].data_ptr(), order_j["rows"].data_ptr(),
                             order_j["run_off"].data_ptr(), order_j["run_box"].data_ptr(),
                             int(diag), int(gc), int(order_i["table"].shape[1]),
                             params.data_ptr(), float(G), float(eps2), acc.data_ptr(),
                             pe.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
                             dev.index or 0)
    check(lib, err, "p3m_short_pair launch (table form)")


def _p3m_short_tables(lib):
    """``cuda_p3m._launch`` and ``cuda_p3m._launch_pair`` against the table
    form (PRs 12-18: each side reordered into the padded table, the sums
    launched over cells x ceil(capacity / 32) slices)."""
    _p3m_tables_lib(lib)

    def launch(table, cell_pos, cell_m, count, gc, params, G, eps2, acc, pe):
        from orbital_tpu_torch.utils.kernels import check

        import torch

        o = _p3m_tables_order(lib, dict(table=table, cell_pos=cell_pos, cell_m=cell_m,
                                        count=count), gc)
        dev = table.device
        err = lib.p3m_short_sorted(o["rows"].data_ptr(), o["table"].data_ptr(),
                                   o["run_off"].data_ptr(), o["run_box"].data_ptr(), int(gc),
                                   int(table.shape[1]), params.data_ptr(), G, eps2,
                                   acc.data_ptr(), pe.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
        check(lib, err, "p3m_short_sorted launch (table form)")

    def launch_pair(tab_i, tab_j, gid_i, gid_j, gc, n, params, G, eps2, acc, pe):
        o_i = _p3m_tables_order(lib, tab_i, gc)
        o_j = o_i if tab_j is tab_i else _p3m_tables_order(lib, tab_j, gc)
        _p3m_tables_pair(lib, o_i, o_j, tab_j is tab_i, gc, params, G, eps2, acc, pe)

    return {"_launch": launch, "_launch_pair": launch_pair}


def _block_forces_first(lib):
    """``cuda_forces._block_launch`` against B3's first C signatures (PRs
    6-18: B1's launch over float4 tables the wrapper packed, the NaN radius
    tables built by the wrapper, the counter zeroed by the wrapper)."""
    import ctypes

    import torch

    from orbital_tpu_torch.utils.kernels import check

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nbody_block_forces.restype = ctypes.c_int
    lib.nbody_block_forces.argtypes = [p, i, p, i, f, f, p, p, i]
    lib.nbody_block_forces_detect.restype = ctypes.c_int
    lib.nbody_block_forces_detect.argtypes = [p, p, i, i, p, p, i, i, f, f, p, p, p, i]

    def launch(pos_i, pos_j, mass_j, detect, out, G, eps2):
        f32, dev = torch.float32, pos_i.device
        n_i, n_j = pos_i.shape[0], pos_j.shape[0]
        pts_i = torch.nn.functional.pad(pos_i, (0, 1)).contiguous()
        pts_j = torch.cat([pos_j, mass_j.to(f32)[:, None]], dim=1).contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if detect is None:
            err = lib.nbody_block_forces(pts_i.data_ptr(), n_i, pts_j.data_ptr(), n_j,
                                         float(G), float(eps2), out.data_ptr(), stream,
                                         dev.index or 0)
            check(lib, err, "nbody_block_forces launch (first signature)")
            return
        radius_i, alive_i, i_off, radius_j, alive_j, j_off, contacts = detect
        rad_i = torch.where(alive_i, radius_i.to(f32), float("nan")).contiguous()
        rad_j = torch.where(alive_j, radius_j.to(f32), float("nan")).contiguous()
        contacts.zero_()
        err = lib.nbody_block_forces_detect(
            pts_i.data_ptr(), rad_i.data_ptr(), n_i, int(i_off), pts_j.data_ptr(),
            rad_j.data_ptr(), n_j, int(j_off), float(G), float(eps2), out.data_ptr(),
            contacts.data_ptr(), stream, dev.index or 0)
        check(lib, err, "nbody_block_forces_detect launch (first signature)")

    return {"_block_launch": launch}


# the sources whose C signature changed with a redesign: for each earlier
# signature, in the order they came, the function its versions lack, the
# adapter to it and the entry points it binds (the rest keep this tree's
# argument types)
FIRST_SIGNATURES = {"neighbor": [("near_sweep_shape", _near_sweep_first, ("near_sweep",))],
                    "p3m_short": [("p3m_short_sorted", _p3m_short_first, ("p3m_short",)),
                                  ("p3m_short_view", _p3m_short_tables,
                                   ("p3m_short_order", "p3m_short_sorted", "p3m_short_pair",
                                    "p3m_short_shape"))],
                    "fused_rollout": [("fused_kdk_shape", _fused_launch_first,
                                       ("fused_kdk",))],
                    "nbody_jerk": [("nbody_jerk_subset_shape", _jerk_subset_first,
                                    ("nbody_jerk_subset",))],
                    "nbody_forces": [("nbody_block_shape", _block_forces_first,
                                      ("nbody_block_forces", "nbody_block_forces_detect"))]}


def other_build(name: str, path, like):
    """Another commit's build of source ``name`` at ``path``, bound as this
    tree's library ``like`` is, or as an OldBuild where an entry point has
    an earlier signature."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    first = next((f for f in FIRST_SIGNATURES.get(name, ()) if not hasattr(lib, f[0])), None)
    if first is not None:
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


def ensemble_energies_f64(states, G: float, eps2: float) -> np.ndarray:
    """Each member's total energy in host f64 from a (ds32) ensemble state
    [E, N, ...]: ``bench.py::_member_energies_f64``'s formula (all pairs with
    the softened self terms subtracted), the f64 oracle of the ensemble drift
    rung."""
    def full(hi, lo):
        x = hi.double()
        return (x if lo is None else x + lo.double()).cpu().numpy()

    pos, vel = full(states.pos, states.pos_lo), full(states.vel, states.vel_lo)
    mass = states.mass.double().cpu().numpy() * states.alive.double().cpu().numpy()
    K = 0.5 * np.sum(mass * np.sum(vel * vel, -1), axis=-1)
    d = pos[:, :, None, :] - pos[:, None, :, :]
    r = np.sqrt(np.sum(d * d, -1) + eps2)
    mm = mass[:, :, None] * mass[:, None, :]
    self_e = np.sum(mass * mass, axis=-1) / np.sqrt(eps2)
    U = -0.5 * G * (np.sum(mm / r, axis=(1, 2)) - self_e)
    return K + U


def ensemble_errors(out, ref, clocks: bool = True) -> dict:
    """Relative differences (max |d| / max |ref| over every member) of two
    ensemble states: full-precision positions and velocities, acc and
    potential; with ``clocks``, raises unless their clocks and step counters
    are equal."""
    import torch

    if clocks and not (torch.equal(out.time, ref.time) and torch.equal(out.step, ref.step)):
        raise AssertionError("ensemble clocks or step counters differ")
    out_f = {"pos": out.pos_full(), "vel": out.vel_full(), "acc": out.acc,
             "potential": out.potential}
    ref_f = {"pos": ref.pos_full(), "vel": ref.vel_full(), "acc": ref.acc,
             "potential": ref.potential}
    errs = {}
    for k, x in out_f.items():
        y = ref_f[k].double()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"ensemble {k} is not finite")
        scale = float(y.abs().max())
        errs[k] = float((x.double() - y).abs().max()) / (scale if scale > 0 else 1.0)
    return errs


ENSEMBLE_FIELDS = ("pos", "vel", "pos_lo", "vel_lo", "acc", "potential", "time", "step")


def ensemble_slice(states, k: int):
    """The first k members of an ensemble state."""
    return states.replace(**{f: getattr(states, f)[:k]
                             for f in ENSEMBLE_FIELDS + ("mass", "radius", "alive")
                             if getattr(states, f) is not None})


def ensemble_equal(a, b, what: str) -> None:
    """Raise unless two ensemble states are bit-equal in every field the
    kernel writes."""
    import torch

    for f in ENSEMBLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what} differ in {f}")


def ensemble_lane_pairs(members: int, shape: dict) -> int:
    """The lane pairs the ensemble kernel's pair loop issues a step for
    ``members`` systems at the launch shape ``shape`` (from
    ``fused_ensemble_shape``: every thread of a member's block walks its
    ``j_a_lane`` j, live lane or not): the count its issue floor takes."""
    return members * shape["threads"] * shape["j_a_lane"]


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
                        "P3MO": dict(P3MO), "ROOTS": dict(ROOTS), "MARK": dict(MARK),
                        "ENS": dict(ENS), "B3D": dict(B3D), "BB": dict(BB),
                        "P3MR": dict(P3MR), "B7S": dict(B7S), "NEARI": dict(NEARI)}
        self._cluster = None
        self._respa_budgets = None
        self._plummer = None
        self.main_ms_per_step = None
        self.hermite_log = None
        self.ring_perf = {}
        self.p3m_ring_perf = {}

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
                                           cuda_p3m, cuda_tree, fused_ensemble, fused_rollout)
        from orbital_tpu_torch.utils import kernels

        names = kernels.SOURCES
        t0 = time.perf_counter()
        kernels.build(names)
        for mod in (cuda_forces, fused_rollout, cuda_collisions, cuda_jerk, cuda_neighbor,
                    cuda_tree, cuda_forces_sym, cuda_forces_mxu, cuda_p3m, fused_ensemble):
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
                for name in (*tiled, "p3m_short", "collision_roots", "fused_ensemble")}
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
                if key != "B3":  # the block's own launch: block_record
                    shapes.append(describe_launch(key, rec))
        # the kernels outside SHAPED: the row subset (in nbody_jerk, whose
        # spills are checked above), the short range and the contact sweep
        for name in ("p3m_short", "collision_roots", "fused_ensemble"):
            spills.append(f"{name} 0 in {spill_free(name, logs[name])} entry functions")
        # the ring's block instances: B3 and B3 detect on their own launch,
        # and the block bounce, B6's kernel over separate tables (B6's record)
        shapes.append(self.block_record(logs["nbody_forces"], sass(
            kernels._library_path("nbody_forces")[1])))
        self.kernels["BB"].update({k: v for k, v in self.kernels["B6"].items()
                                   if k in ("shape", "registers", "spill_bytes",
                                            "sass_slots_per_pair")})
        shapes += [self.subset_record(cuda_jerk._load(), logs["nbody_jerk"]),
                   self.p3m_record(logs["p3m_short"], sass(
                       kernels._library_path("p3m_short")[1])),
                   self.roots_record(logs["collision_roots"], sass(
                       kernels._library_path("collision_roots")[1])),
                   self.ensemble_record(logs["fused_ensemble"], sass(
                       kernels._library_path("fused_ensemble")[1]))]
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

    def block_record(self, log: str, sass_text: str) -> str:
        """B3's and B3 detect's launch shape (the block kernel's i bodies a
        thread, warps, co-resident blocks and the plan's grid at the ring's
        shard shapes, RING_B^2 and RING_B8^2) into their records, with the
        registers, spills and SASS instructions a pair (launch_record's for
        B3; B3 detect's read here, its inner loop over MUFU.RSQ), and the
        issue floor at RING_B^2."""
        from orbital_tpu_torch.ops.cuda_forces import block_plan, block_shape

        stem = "block_forces_kernelILb1E"
        self.entry_record("B3D", stem, log)
        loop = next((v for f, v in inner_loop(sass_text).items() if stem in f), None)
        if sass_text and loop is None:
            raise AssertionError(f"B3D: no loop with MUFU.RSQ in *{stem}* in the SASS")
        self.kernels["B3D"]["sass_slots_per_pair"] = (loop[0] / loop[1] if loop
                                                      else "not measured")
        sh = block_shape(self.dev)
        plans = {b: block_plan(b, b, 32 * sh["k"], sh["q"], sh["tile"], sh["resident"],
                               sh["sms"]) for b in (RING_B, RING_B8)}
        out = []
        for key in ("B3", "B3D"):
            rec = self.kernels[key]
            rec["shape"] = dict(k=sh["k"], q=sh["q"], tile=sh["tile"], threads=sh["threads"],
                                blocks=plans[RING_B]["grid"], splits=plans[RING_B]["splits"],
                                resident=sh["resident"])
            floor = issue_floor_ms(rec["sass_slots_per_pair"], RING_B * RING_B)
            out.append(f"{key} k={sh['k']} q={sh['q']} tile={sh['tile']} ({sh['threads']} "
                       f"threads, {sh['resident']} co-resident blocks on {sh['sms']} SMs), "
                       + ", ".join(f"{b}^2 {p['grid']} blocks ({p['tiles']} i tiles x "
                                   f"{p['splits']} splits of {p['split_len']})"
                                   for b, p in plans.items())
                       + f", {rec['registers']} registers, {rec['spill_bytes']} spill bytes, "
                       f"{fmt(rec['sass_slots_per_pair'])} SASS instructions a pair (issue "
                       f"floor {fmt(floor, 3, ' ms')} at {RING_B}^2)")
        self.block_plans = plans
        return "; ".join(out)

    def p3m_record(self, log: str, sass_text: str) -> str:
        """The short range's launch shape (the persistent grid of the sum,
        which the single-table sum and the ring's two-table form share), the
        registers and spills of the sum and of the view kernel, and the SASS
        instructions of the sum's polynomial sweep loop (the innermost loop
        with MUFU.RSQ and no MUFU.EX2, the erff path's) a visited pair: one
        MUFU.RSQ a pair."""
        from orbital_tpu_torch.ops.cuda_p3m import p3m_short_shape

        line = (self.entry_record("P3M", "p3m_short_kernel", log) + "; "
                + self.entry_record("P3MO", "p3m_view_kernel", log))
        shape = p3m_short_shape(self.dev)
        loop = next((v for f, v in inner_loop_excluding(sass_text, r"MUFU\.EX2").items()
                     if "p3m_short_kernel" in f), None)
        if sass_text and loop is None:
            raise AssertionError("P3M: no polynomial sweep loop (MUFU.RSQ without MUFU.EX2)")
        per_pair = loop[0] / loop[1] if loop else "not measured"
        for key in ("P3M", "P3MR"):
            self.kernels[key].update(shape=shape, sass_slots_per_pair=per_pair)
        self.kernels["P3MR"].update({k: self.kernels["P3M"][k]
                                     for k in ("registers", "spill_bytes")})
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

    def ensemble_record(self, log: str, sass_text: str) -> str:
        """The ensemble kernel's launch shapes (``fused_ensemble_shape``) at
        config 5's N = 26 (the team kernel: a warp a member, a lane a body,
        its chains) and at N = 1,024 (the block kernel), checked against
        the layout the source states and the wrapper's ENSEMBLE_MAX_N, the
        registers and spills of its kernels, the SASS instructions of each
        one's pair loop a pair (its innermost loop with the most MUFU.RSQ,
        one a pair, the loop without the potential) and the issue floor of
        config 5's pair loop: 32 lanes a member, 26 j a lane, one step."""
        import ctypes

        from orbital_tpu_torch.ops import fused_ensemble as fe

        line = self.entry_record("ENS", "ensemble_", log)
        lib = fe._load()
        shapes = {}
        for n, threads, chains in ((26, 32, 2), (1024, 256, 1)):
            arr = (ctypes.c_int * 6)()
            lib.fused_ensemble_shape(n, arr)
            shape = dict(zip(("members_a_block", "threads", "shared_bytes", "max_n",
                              "chains", "j_a_lane"), list(arr)))
            if (shape["members_a_block"], shape["threads"], shape["max_n"], shape["chains"],
                    shape["j_a_lane"]) != (1, threads, fe.ENSEMBLE_MAX_N, chains, n):
                raise AssertionError(f"ENS at N={n}: the library's shape {shape}")
            shapes[n] = shape
        loops = inner_loop(sass_text)
        per = {}
        for mode, stem in ENS_MODES.items():
            loop = next((v for f, v in loops.items() if stem in f), None)
            per[mode] = loop[0] / loop[1] if loop else "not measured"
        if sass_text and not all(isinstance(v, float) for v in per.values()):
            raise AssertionError(f"ENS: no pair loop with MUFU.RSQ in {per}")
        lane_pairs = ensemble_lane_pairs(ENS_MEMBERS, shapes[26])
        floor = issue_floor_ms(per["team"], lane_pairs)
        self.kernels["ENS"].update(shape=shapes[26], sass_slots_per_pair=per["team"],
                                   sass_slots_per_pair_block_kernel=per["block"])
        return (f"{line}, shape at N=26 {shapes[26]}, at N=1024 {shapes[1024]}, SASS "
                f"instructions a pair: team kernel {fmt(per['team'])}, block kernel "
                f"{fmt(per['block'])} (issue floor of config 5's pair loop, "
                f"{lane_pairs:,} lane pairs a step: {fmt(floor, 5, ' ms')})")

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
                    else f"near kernel device time {fmt(near_dev, 3)} ms a call; a K=4 substep "
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
                f"path is the multi-device ring (phases 51-60)")

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
        # B3 runs on the ring only (phase 53 counts it there): 0 on these paths

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
            "P3M": (SHORT_RTOL, SHORT_RTOL), "P3MR": (SHORT_RTOL, SHORT_RTOL),
            "B3R": (FORCE_RTOL, FORCE_RTOL), "B3R8": (FORCE_RTOL, FORCE_RTOL),
            "B3D": (FORCE_RTOL, FORCE_RTOL, 0), "B3D8": (FORCE_RTOL, FORCE_RTOL, 0),
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

    # --ring-variants
    def ring_variants(self) -> str:
        from orbital_tpu_torch.ops import cuda_forces as cf
        from orbital_tpu_torch.ops import cuda_p3m
        from orbital_tpu_torch.utils import kernels

        torch = self.torch
        mods = {"nbody_forces": cf, "p3m_short": cuda_p3m}
        jobs = {(name, tag): (kernels.CSRC_DIR / f"{name}.cu",
                              kernels.BUILD_DIR / "variants" / f"lib{name}-{tag}.so", flags)
                for name, shapes in RING_VARIANTS.items() for tag, flags in shapes}
        built = compile_libraries(jobs.values())
        libs, usage = {}, {}
        for (name, tag), (_, out, _) in jobs.items():
            libs[name, tag] = bind_like(out, mods[name]._load(), LIB_FUNCS[name])
            stem = "block_forces_kernel" if name == "nbody_forces" else "p3m_short_kernel"
            regs = [u for f, u in ptxas_usage(built[out][0]).items() if stem in f]
            usage[f"{name} {tag}"] = (f"{max(u[0] for u in regs)} registers, "
                                      f"{sum(u[1] + u[2] for u in regs)} spill bytes")
        kw = dict(G=1.0, eps2=EPS2)
        fns = {}
        for ranks in (RING_P, RING_P8):
            b = N_MAIN // ranks
            (pi, _, _, ri, ai), (pj, _, mj, rj, aj) = self.ring_shards(R_BENCH, ranks=ranks)[:2]
            ref = cf.block_acc_detect_cuda(pi, ri, ai, 0, pj, mj, rj, aj, b, **kw)
            for tag, _ in RING_VARIANTS["nbody_forces"]:
                lib = libs["nbody_forces", tag]

                def b3d(lib=lib, pi=pi, ri=ri, ai=ai, pj=pj, mj=mj, rj=rj, aj=aj, b=b):
                    return on(cf, lib, lambda: cf.block_acc_detect_cuda(
                        pi, ri, ai, 0, pj, mj, rj, aj, b, **kw))

                def b3(lib=lib, pi=pi, pj=pj, mj=mj):
                    return on(cf, lib, lambda: cf.block_acc_cuda(pi, pj, mj, **kw))

                out = b3d()
                torch.cuda.synchronize()
                if int(out[2]) != int(ref[2]) or self.rel(out[0], ref[0]) > FORCE_RTOL \
                        or not torch.equal(out[0], b3()[0]):
                    raise AssertionError(f"B3 detect {tag} at {b}: not held to this build")
                fns[f"B3D {b} {tag}"], fns[f"B3 {b} {tag}"] = b3d, b3
            c = self.p3m_ring_case(ranks)
            tabs, gids, kwp = c["tabs"], c["gids"], c["kw"]
            views = [cuda_p3m.p3m_short_view_cuda(tabs[r], kwp["gc"], b, gids[r])
                     for r in (0, 1)]
            visitor = {k: views[1][k] for k in cuda_p3m.SHIPPED}
            params = cuda_p3m.short_params(kwp["sigma"], kwp["rcut2"], self.dev)
            ref = cuda_p3m.p3m_short_round_cuda(views[0], visitor, params=params, **kwp)
            for tag, _ in RING_VARIANTS["p3m_short"]:
                lib = libs["p3m_short", tag]
                outs = (torch.zeros((b, 3), device=self.dev), torch.zeros((b,), device=self.dev))

                def round_(lib=lib, views=views, visitor=visitor, params=params, kwp=kwp,
                           out=None):
                    return on(cuda_p3m, lib, lambda: cuda_p3m.p3m_short_round_cuda(
                        views[0], visitor, out=out, params=params, **kwp))

                got = round_()
                torch.cuda.synchronize()
                if max(self.rel(x, y) for x, y in zip(got, ref)) > SHORT_RTOL:
                    raise AssertionError(f"P3M round {tag} at {b}: not held to this build")
                fns[f"P3MR {b} {tag}"] = (lambda f=round_, o=outs: f(out=o))
        tab, kw_b = self.p3m_bench_case()
        for tag, _ in RING_VARIANTS["p3m_short"]:
            fns[f"P3M {tag}"] = on(cuda_p3m, libs["p3m_short", tag],
                                   lambda: self.p3m_sum_launch(tab, kw_b))
        times = {k: summary(v) for k, v in alternate_ms(fns, 20, repeats=5).items()}
        print("perf_ring_variants " + json.dumps({"times": times, "registers": usage}),
              file=sys.stderr)
        return (f"B3 and B3 detect (R {R_BENCH:g}, within {FORCE_RTOL:g} of this build, "
                f"counts equal, B3 bit-equal to B3 detect) and P3M's two-table round (within "
                f"{SHORT_RTOL:g}) at {RING_B} and {RING_B8} bodies a shard, the single-table "
                f"sum alone at the bench row, each shape in turns: " + "; ".join(
                    f"{k} {v['median']:.4f} ms (spread {v['spread']:.4f})"
                    for k, v in times.items())
                + "; registers: " + ", ".join(f"{k} {v}" for k, v in usage.items()))

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

    def ring_calls(self) -> dict:
        """{key: (wrapper module, call)} of the ring's kernels at its shard
        shapes, for --parent: B3 (B3R) and B3 detect (B3D) on shards 0 and 1
        of the bench row at RING_P ranks, B3R8 and B3D8 at RING_P8, each with
        ``pairs``; P3MR, P3M's two-table round of shard 0 against shard 1 at
        RING_P ranks from their tables (each build makes their views or
        orders)."""
        from orbital_tpu_torch.ops import cuda_forces as cf
        from orbital_tpu_torch.ops import cuda_p3m

        kw = dict(G=1.0, eps2=EPS2)
        out = {}
        for ranks, sfx in ((RING_P, ""), (RING_P8, "8")):
            b = N_MAIN // ranks
            (pi, _, _, ri, ai), (pj, _, mj, rj, aj) = self.ring_shards(R_BENCH, ranks=ranks)[:2]

            def b3(pi=pi, pj=pj, mj=mj):
                return cf.block_acc_cuda(pi, pj, mj, **kw)

            def b3d(pi=pi, ri=ri, ai=ai, pj=pj, mj=mj, rj=rj, aj=aj, b=b):
                return cf.block_acc_detect_cuda(pi, ri, ai, 0, pj, mj, rj, aj, b, **kw)

            b3.pairs = b3d.pairs = b * b
            out[f"B3R{sfx}"], out[f"B3D{sfx}"] = (cf, b3), (cf, b3d)
        c = self.p3m_ring_case()
        self.p3m_ring_parent_case = c
        kw_p = dict(c["kw"], sigma=self.t(float(c["kw"]["sigma"])),
                    rcut2=self.t(float(c["kw"]["rcut2"])))
        tabs, gids = c["tabs"], c["gids"]
        out["P3MR"] = (cuda_p3m, lambda: cuda_p3m.p3m_short_pair_cuda(
            tabs[0], tabs[1], gids[0], gids[1], **kw_p))
        return out

    def p3m_round_alone(self, old) -> dict:
        """P3M's two-table round of ``ring_calls``' case alone, timed in
        turns: this tree's over shard 0's view and shard 1's shipped view,
        built before, and the other build's (``old``, an OldBuild of the
        table form) over the two tables' orders, made before, each into
        fixed outputs."""
        from orbital_tpu_torch.ops import cuda_p3m

        torch = self.torch
        c = self.p3m_ring_parent_case
        tabs, gids, kw = c["tabs"], c["gids"], c["kw"]
        gc, b = kw["gc"], kw["n"]
        params = cuda_p3m.short_params(kw["sigma"], kw["rcut2"], self.dev)
        views = [cuda_p3m.p3m_short_view_cuda(tabs[r], gc, b, gids[r]) for r in (0, 1)]
        visitor = {k: views[1][k] for k in cuda_p3m.SHIPPED}
        outs = [(torch.zeros((b, 3), dtype=torch.float32, device=self.dev),
                 torch.zeros((b,), dtype=torch.float32, device=self.dev)) for _ in range(2)]
        lib = getattr(old, "lib", old)

        def this():
            cuda_p3m.p3m_short_round_cuda(views[0], visitor, out=outs[0], params=params, **kw)

        if hasattr(lib, "p3m_short_view"):  # a build of the view form
            old_views = [on(cuda_p3m, old, lambda r=r: cuda_p3m.p3m_short_view_cuda(
                tabs[r], gc, b, gids[r])) for r in (0, 1)]
            old_visitor = {k: old_views[1][k] for k in cuda_p3m.SHIPPED}

            def parent():
                on(cuda_p3m, old, lambda: cuda_p3m.p3m_short_round_cuda(
                    old_views[0], old_visitor, out=outs[1], params=params, **kw))
        else:
            orders = [_p3m_tables_order(lib, tabs[r], gc) for r in (0, 1)]

            def parent():
                _p3m_tables_pair(lib, orders[0], orders[1], False, gc, params, 1.0, EPS2,
                                 *outs[1])

        return {"P3MR round": this, "P3MR round parent": parent}

    def check_parent(self, parent: str) -> str:
        from pathlib import Path

        from orbital_tpu_torch.utils import kernels

        from orbital_tpu_torch.ops import cuda_p3m, fused_ensemble
        from orbital_tpu_torch.ops.cuda_p3m import p3m_short_cuda

        mods = self.redesigned()
        jobs = {name: (Path(parent) / "orbital_tpu_torch" / "csrc" / f"{name}.cu",
                       kernels.BUILD_DIR / "parent" / f"lib{name}.so")
                for name in (*mods, "p3m_short", "collision_roots", "fused_ensemble")}
        compile_libraries([(src, out, ()) for src, out in jobs.values()])
        old = {mod: other_build(name, jobs[name][1], mod._load())
               for name, mod in (*mods.items(), ("p3m_short", cuda_p3m),
                                 ("fused_ensemble", fused_ensemble))}
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
        # the ring's kernels at its shard shapes: B3 and B3 detect at RING_B^2
        # and RING_B8^2 (the bench row's radius), P3M's two-table round at 4
        # ranks' shards (building its tables' views or orders)
        ring = self.ring_calls()
        for k, (mod, call) in ring.items():
            hold(k, mod, call)
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
                     P3M=(cuda_p3m, p3m_call), **ring)
        calls.update({k: fused_t[k] for k in ("B4", "B4F", "B4L", "B4LF")})
        calls.update({k: (roots, (lambda c: lambda: c(True))(call))
                      for k, call in roots_calls.items()})
        fns = {}
        for k, (mod, call) in calls.items():
            fns[f"{k} parent"] = (lambda m_, l_, c_: lambda: on(m_, l_, c_))(mod, old[mod], call)
            fns[k] = call
        # P3M's round alone, its visitor's view (this tree) or order (the
        # table form) built before
        fns.update(self.p3m_round_alone(old[cuda_p3m]))
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
        slots["this"]["B3D"] = self.kernels["B3D"].get("sass_slots_per_pair")
        clocks = {k: clock_during(call) for k, (_, call) in calls.items()}
        print("perf_parent " + json.dumps({"times": times, "slots": slots, "clocks": clocks,
                                           "block_macro_ms": macro_t,
                                           "block_macro_host_ms": macro_h}), file=sys.stderr)
        lines = []
        for k, (_, call) in calls.items():
            this, par = times[k], times[f"{k} parent"]
            faster = max(this["runs"]) < min(par["runs"])
            base = {"B7L": "B7", "B4F": "B4", "B4L": "B4", "B4LF": "B4", "B3R": "B3",
                    "B3R8": "B3", "B3D8": "B3D"}.get(k, k)
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
        this, par = times["P3MR round"], times["P3MR round parent"]
        lines.append(f"P3MR round alone {this['median']:.4f} ms (spread {this['spread']:.4f}) vs "
                     f"parent {par['median']:.4f} ({par['spread']:.4f}), "
                     f"{par['median'] / this['median']:.2f}x, faster outside both spreads: "
                     f"{'yes' if max(this['runs']) < min(par['runs']) else 'no'}")
        lines.append(self.ensemble_parent(old[fused_ensemble], sass(jobs["fused_ensemble"][1])))
        lines.append("block macro step (rungs 1, m = {}) {}".format(macro.m, ", ".join(
            f"{k} {macro_t[k]['median']:.3f} ms (spread {macro_t[k]['spread']:.3f}), host "
            f"{macro_h[k]['median']:.3f} ms (spread {macro_h[k]['spread']:.3f})"
            for k in steps)))
        return (f"B1, B2, B3, B5, B5 detect, the B5 subset, B13, B6, B12, B7, the near sweep, "
                f"B4, the P3M short range, the root search and ENS held "
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
                f"on the bench row's table; the ensemble kernel within DRIFT_BUDGET, "
                f"FORCE_RTOL and ENERGY_RTOL of the plain version at ENS_CASES' config 5 "
                f"(1 step) and 2 x 1,024 (ENS_CHECK_STEPS), timed at {ENS_SCALE} members; "
                f"the root search's parents equal, gated and "
                f"ungated, at R {R_RICH:g} and {R_BENCH:g}); in turns, 6 runs each (B1, B2, "
                f"B13 no PE; ROOTS at a count > 0, ROOTS0 at 0; "
                f"B3 PE; B6 ungated, B6Z at a zero count; B12; B7 at N={N_MAIN} and B7L at "
                f"{N_TREE_BIG}; NEAR the table sweep at N={N_MAIN}; B4 200 steps at {N_FUSED}, "
                f"ds32 and B4F f32, B4L and B4LF 20 steps at {N_FUSED_BIG}): "
                + "; ".join(lines))

    def ensemble_parent(self, old_lib, parent_sass: str) -> str:
        """``--parent``'s ensemble kernel: this tree's and the other build's
        launches against the plain version (config 5 after 1 step in ds32
        and f32, the block kernel's 2 x 1,024 after ENS_CHECK_STEPS), whether
        the two builds agree bit for bit, and both timed in turns over
        ENS_TIMED_STEPS steps at each member count of ENS_SCALE, with their
        SASS instructions a pair."""
        from orbital_tpu_torch.ops import fused_ensemble as fe

        held = []
        for members, n, steps in ((ENS_MEMBERS, 26, 1), (2, 1024, ENS_CHECK_STEPS)):
            for precision in ("ds32", "f32"):
                st, cfg = (self.solar_ensemble(members, precision) if n == 26
                           else self.random_ensemble(members, n, precision))
                ref = fe.fused_ensemble_plain(st, cfg, steps)
                outs = {"this": fe.fused_ensemble(st, cfg, steps),
                        "parent": on(fe, old_lib, lambda: fe.fused_ensemble(st, cfg, steps))}
                tols = {"pos": DRIFT_BUDGET, "vel": DRIFT_BUDGET, "acc": FORCE_RTOL,
                        "potential": ENERGY_RTOL}
                for k, out in outs.items():
                    errs = ensemble_errors(out, ref)
                    bad = {f: v for f, v in errs.items() if v > tols[f]}
                    if bad:
                        raise AssertionError(f"ENS {k} {members}x{n} {precision}: {bad}")
                try:
                    ensemble_equal(outs["this"], outs["parent"], "")
                    same = "bit-equal"
                except AssertionError:
                    same = "not bit-equal"
                held.append(f"{members} x {n} {precision} K={steps} {same}")
        fns = {}
        for members in ENS_SCALE:
            st, cfg = self.solar_ensemble(members)
            call = (lambda st_, cfg_: lambda: fe.fused_ensemble(st_, cfg_, ENS_TIMED_STEPS))(
                st, cfg)
            fns[f"ENS{members} parent"] = (lambda c_: lambda: on(fe, old_lib, c_))(call)
            fns[f"ENS{members}"] = call
        times = {k: summary([1e3 * v / ENS_TIMED_STEPS for v in runs])
                 for k, runs in alternate_ms(fns, 3, repeats=6).items()}
        per = {"this": self.kernels["ENS"].get("sass_slots_per_pair"),
               "parent": next((v[0] / v[1] for f, v in inner_loop(parent_sass).items()
                               if "ensemble_kernelILb1E" in f), "not measured")}
        print("perf_parent_ens " + json.dumps({"times_us_per_step": times, "slots": per}),
              file=sys.stderr)
        parts = []
        for members in ENS_SCALE:
            this, par = times[f"ENS{members}"], times[f"ENS{members} parent"]
            faster = max(this["runs"]) < min(par["runs"])
            parts.append(f"{members} x 26 {this['median']:.4f} us/step (spread "
                         f"{this['spread']:.4f}) vs parent {par['median']:.4f} "
                         f"({par['spread']:.4f}), {par['median'] / this['median']:.2f}x, faster "
                         f"outside both spreads: {'yes' if faster else 'no'}")
        return (f"ENS against the parent's build ({'; '.join(held)}), in turns, 6 runs each: "
                + "; ".join(parts) + f"; SASS instructions a pair {fmt(per['this'])} (parent's "
                f"warp-a-member loop {fmt(per['parent'])})")

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
        """A call that launches the short-range sum alone, on the table's view
        as the view kernel leaves it (built once), into fixed outputs."""
        from orbital_tpu_torch.ops import cuda_p3m

        torch = self.torch
        view = cuda_p3m.p3m_short_view_cuda(tab, kw["gc"], kw["n"])
        params = self.t([kw["rcut2"], 1.0 / (2.0 * kw["sigma"])])
        acc = torch.zeros((kw["n"], 3), dtype=torch.float32, device=self.dev)
        pe = torch.zeros((kw["n"],), dtype=torch.float32, device=self.dev)
        lib = cuda_p3m._load()

        def launch():
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            err = lib.p3m_short_sorted(*(view[k].data_ptr() for k in (
                "rows", "body", "run_off", "run_box", "slices", "nslices")),
                int(view["slices"].shape[0]), kw["gc"], params.data_ptr(), float(kw["G"]),
                float(kw["eps2"]), acc.data_ptr(), pe.data_ptr(), stream, self.dev.index or 0)
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
    def view_equal(self, what: str, tab, gc: int, n: int, gid=None) -> dict:
        """The view kernel's view of ``tab`` (``cuda_p3m.p3m_short_view_cuda``)
        against its plain version in the kernel's order: the kept rows, body
        indices and global ids, the runs, their boxes and the slice list
        equal, bit for bit. Returns the kernel's view."""
        from orbital_tpu_torch.ops.cuda_p3m import p3m_short_view, p3m_short_view_cuda

        torch = self.torch
        got, want = p3m_short_view_cuda(tab, gc, n, gid), p3m_short_view(tab, gc, n, gid)
        kept, length = int(tab["count"].sum()), int(want["nslices"][0])
        for k in want:
            g_, w_ = got[k], want[k]
            if k in ("rows", "body", "gid"):
                g_, w_ = g_[:kept], w_[:kept]
            elif k == "slices":
                g_, w_ = g_[:length], w_[:length]
            if not torch.equal(g_, w_):
                raise AssertionError(f"{what}: {k} differs from the plain version")
        return got

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
            self.view_equal(f"P3M view {key}", tab, gc, n)
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
                    f"overflow {overflow}): the reorder and the view bit-equal to their plain "
                    f"versions; "
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

                work = p3m_short_work(tab, gc, n, rcut2, warps=p3m_short_shape(self.dev)["warps"])
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
        return (f"P3M short range (csrc/p3m_short.cu: the view kernel equal to its plain "
                f"version on the kept rows, its reorder on the kept prefixes; the sum within {SHORT_RTOL:g} of its plain "
                f"version and the f64 sum, bench row bit-equal from call to call): "
                + "; ".join(lines))

    # phase 32
    def mesh_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops import p3m as p3m_mod
        from orbital_tpu_torch.ops.cuda_p3m import p3m_short_cuda, p3m_short_view_cuda
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
        order_launches = p3m_short_view_cuda.launches
        esc = escaped(fin, P3M_BOX)
        if (launches != len(total) or launches != 1 + P3M_STEPS or overflow
                or order_launches != launches):
            raise AssertionError(f"P3M: {launches} short-range and {order_launches} view "
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
                     f"{JAX_P3M_DRIFT:.3e}); {wall:.3f} ms/step wall; short-range and view "
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
        from orbital_tpu_torch.ops.cuda_p3m import (p3m_short_cuda, p3m_short_view,
                                                    p3m_short_view_cuda)
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
        n_s, gc_s = kw_s["n"], kw_s["gc"]
        order = summary(time_ms(lambda: p3m_short_view_cuda(tab, gc_s, n_s), 20))
        order_plain = summary(time_ms(lambda: p3m_short_view(tab, gc_s, n_s), 5))
        # the view reads each kept slot's (x, y, z), m and index once (24 B)
        # and each cell's count, and writes each kept slot's (x, y, z, m) and
        # index (24 B), each cell's run offsets and boxes and its slices once
        kept = int(tab["count"].sum())
        n_sl = int(p3m_short_view(tab, gc_s, n_s)["nslices"][0])
        b_o = bound(0, 48 * kept + (4 + 36 + 192) * gc_s ** 3 + 4 * n_sl)
        self.kernels["P3MO"].update(ms=order["median"], plain_ms=order_plain["median"],
                                    bound_ms=b_o[0], bound_by=b_o[1], library_ms=None)
        # the sum alone by CUDA events (its launch on a view built once), and
        # the wrapper's device time by the profiler: the view, the sum and
        # their set-up
        sum_alone = summary(time_ms(self.p3m_sum_launch(tab, kw_s), 20))
        dev_t = device_times(lambda: p3m_short_cuda(*args, count=tab["count"], **kw_t))
        dev = {k: sum(v[1] for n_, v in dev_t.items() if k in n_) or "not measured"
               for k in ("p3m_short_kernel", "p3m_view_kernel", "")}
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
                f"(the sum {fmt(dev['p3m_short_kernel'], 4)}, the view "
                f"{fmt(dev['p3m_view_kernel'], 4)}); "
                f"the view kernel {ms(order)} vs its plain version {ms(order_plain)}, bound "
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


    # phases 41-43
    def solar_ensemble(self, members: int, precision: str = "ds32"):
        """BASELINE config 5 through the port's entry points
        (bench.py:517-540): the compiled solar system with moons, natural
        units, ``make_state`` on the card, ``make_ensemble`` with a card
        generator seeded ENS_SEED; and its config."""
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.models.scene import compile_system
        from orbital_tpu_torch.parallel.ensemble import make_ensemble

        scene = compile_system(ot.solar_system_v2(moons=True), compose_parents=True)
        rs = ot.Rescale.natural(scene.pos, scene.mass, ot.STANDARD.G)
        base = ot.make_state(scene.pos, scene.vel, scene.mass, scene.radius,
                             precision=precision, rescale=rs, device=self.dev)
        cfg = ot.SimConfig(dt=ENS_DT_S / rs.time, G=rs.g_internal(ot.STANDARD.G),
                           eps2=(ENS_SOFT_M / rs.length) ** 2)
        gen = self.torch.Generator(device=self.dev).manual_seed(ENS_SEED)
        return make_ensemble(base, members, gen, pos_sigma=ENS_SIGMA), cfg

    def random_ensemble(self, members: int, n: int, precision: str):
        """Gaussian clusters, one a member, every other member with a fifth
        of its bodies dead, at softening ENS_RAND_EPS2."""
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.parallel.ensemble import _stack

        rng = np.random.default_rng(self.seed + 41 + n)
        states = []
        for m in range(members):
            st = ot.make_state(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.3,
                               rng.uniform(0.5, 1.5, n) / n, precision=precision,
                               device=self.dev)
            if m % 2:
                alive = np.ones(n, bool)
                alive[rng.choice(n, max(1, n // 5), replace=False)] = False
                st = st.replace(alive=self.torch.from_numpy(alive).to(self.dev))
            states.append(st)
        return _stack(states), ot.SimConfig(dt=DT, G=1.0, eps2=ENS_RAND_EPS2)

    @staticmethod
    def ensemble_f64(states):
        """An ensemble state carried to f64 (hi + lo collapsed), for the
        plain version's f64 run from the same state."""
        return states.replace(pos=states.pos_full().double(), vel=states.vel_full().double(),
                              pos_lo=None, vel_lo=None, mass=states.mass.double(),
                              radius=states.radius.double(), acc=states.acc.double(),
                              potential=states.potential.double(),
                              time=states.time.double())

    # phase 41
    def check_ensemble(self) -> str:
        from orbital_tpu_torch.ops.fused_ensemble import fused_ensemble, fused_ensemble_plain

        torch = self.torch
        lines, worst, plan_free = [], {}, 0
        for members, n in ENS_CASES:
            solar = (members, n) == (ENS_MEMBERS, 26)
            for precision in ("f32", "ds32"):
                st, cfg = (self.solar_ensemble(members, precision) if solar
                           else self.random_ensemble(members, n, precision))
                for steps in ((0, 1, ENS_CHECK_STEPS) if solar else (0, ENS_CHECK_STEPS)):
                    out = fused_ensemble(st, cfg, steps)
                    again = fused_ensemble(st, cfg, steps)
                    ref = fused_ensemble_plain(st, cfg, steps)
                    torch.cuda.synchronize()
                    ensemble_equal(out, again, f"ENS {members}x{n} {precision} K={steps}: two "
                                               "launches")
                    if solar:
                        # the team kernel's layout follows N alone: the
                        # ensemble's size may not change a bit of a member
                        part = fused_ensemble(ensemble_slice(st, ENS_SLICE), cfg, steps)
                        ensemble_equal(ensemble_slice(out, ENS_SLICE), part,
                                       f"ENS {members}x{n} {precision} K={steps}: the first "
                                       f"{ENS_SLICE} members alone and in the ensemble")
                        plan_free += 1
                    errs = ensemble_errors(out, ref)
                    key = f"{members}x{n} {precision} K={steps}"
                    if solar and steps == ENS_CHECK_STEPS:
                        exact = fused_ensemble_plain(self.ensemble_f64(st), cfg, steps)
                        k_f64 = ensemble_errors(out, exact, clocks=False)
                        p_f64 = ensemble_errors(ref, exact, clocks=False)
                        dist = {f: (k_f64[f], p_f64[f]) for f in ("pos", "vel")}
                        for f, (k_err, p_err) in dist.items():
                            if k_err > ENS_F64_FACTOR * p_err + 1e-12:
                                raise AssertionError(f"ENS {key}: {f} {k_err:.3e} from f64, the "
                                                     f"plain version {p_err:.3e}")
                        lines.append(f"{key}: kernel vs plain " + ", ".join(
                            f"{k} {v:.1e}" for k, v in errs.items()) + "; from f64 kernel/plain "
                            + ", ".join(f"{f} {a:.2e}/{b:.2e}" for f, (a, b) in dist.items()))
                        continue
                    tols = {"pos": DRIFT_BUDGET, "vel": DRIFT_BUDGET, "acc": FORCE_RTOL,
                            "potential": ENERGY_RTOL}
                    bad = {k: v for k, v in errs.items() if v > tols[k]}
                    if bad:
                        raise AssertionError(f"ENS {key} vs plain: {bad} over {tols}")
                    for k, v in errs.items():
                        worst[k] = max(worst.get(k, 0.0), v)
                    if solar and precision == "ds32" and steps == 1:
                        self.kernels["ENS"]["max_abs_err"] = max(
                            float((getattr(out, f)() - getattr(ref, f)()).abs().max())
                            for f in ("pos_full", "vel_full"))
                    lines.append(f"{key} " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
        return (f"ENS == plain (state within {DRIFT_BUDGET:g}, acc {FORCE_RTOL:g}, potential "
                f"{ENERGY_RTOL:g}; worst " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                + f"), two launches bit-equal; config 5's first {ENS_SLICE} members alone "
                f"bit-equal to the same members in the ensemble ({plan_free} cases) ["
                + "; ".join(lines) + "]")

    # phase 42
    def ensemble_main_path(self) -> str:
        from orbital_tpu_torch.ops.fused_ensemble import fused_ensemble
        from orbital_tpu_torch.parallel import ensemble

        torch = self.torch
        states, cfg = self.solar_ensemble(ENS_MEMBERS)
        e, n = states.pos.shape[0], states.n_bodies
        if (e, n) != (ENS_MEMBERS, 26):
            raise AssertionError(f"config 5 is {e} x {n}, not {ENS_MEMBERS} x 26")
        E0 = ensemble_energies_f64(states, cfg.G, cfg.eps2)
        reset_launches()
        torch.cuda.synchronize()
        t0, done = time.perf_counter(), 0
        while done < ENS_STEPS:
            k = min(ENS_CHUNK, ENS_STEPS - done)
            states, traj = ensemble.ensemble_rollout(states, cfg, k)
            torch.cuda.synchronize()  # one chunk at a time, as bench_ensemble_drift
            done += k
        wall = time.perf_counter() - t0
        launches, loops = fused_ensemble.launches, ensemble.member_loop.runs
        self.kernels["ENS"]["launches"] = launches
        E1 = ensemble_energies_f64(states, cfg.G, cfg.eps2)
        drift = np.abs((E1 - E0) / E0)
        if traj is not None or not bool(torch.isfinite(states.pos).all()):
            raise AssertionError("config 5: non-finite state or a trajectory without records")
        if not bool((states.step == ENS_STEPS).all()):
            raise AssertionError("config 5: step counters wrong")
        if launches != -(-ENS_STEPS // ENS_CHUNK) or loops:
            raise AssertionError(f"config 5: {launches} kernel launches, {loops} member loops")
        if drift.max() > ENS_DRIFT_BOUND or drift[0] > ENS_DRIFT_BOUND:
            raise AssertionError(f"config 5 |dE/E| max {drift.max():.3e}, member 0 "
                                 f"{drift[0]:.3e} over {ENS_DRIFT_BOUND:g}")

        # a recorded rollout: one launch a block, records [E, R, ...]
        reset_launches()
        rec, tr = ensemble.ensemble_rollout(states, cfg, 20, record_every=10)
        torch.cuda.synchronize()
        rec_launches = fused_ensemble.launches
        if tr is None or tuple(tr.pos.shape) != (e, 2, n, 3) or rec_launches != 2:
            raise AssertionError(f"config 5 recorded: {rec_launches} launches, records "
                                 f"{None if tr is None else tuple(tr.pos.shape)}")
        rec_drift = float(ensemble.energy_drift(tr).max())

        # the member loop on the card: a 4-member bounce ensemble of 20 steps
        small, _ = self.solar_ensemble(4)
        reset_launches()
        fin_b, _ = ensemble.ensemble_rollout(small, cfg.replace(collisions="bounce"), 20)
        torch.cuda.synchronize()
        member_loops = ensemble.member_loop.runs
        if member_loops != 1 or fused_ensemble.launches or not bool(
                torch.isfinite(fin_b.pos).all()):
            raise AssertionError(f"member loop: {member_loops} runs, "
                                 f"{fused_ensemble.launches} kernel launches")
        self.ens_ms_per_step = 1e3 * wall / ENS_STEPS
        return (f"config 5 ({e} x {n} solar with moons, ds32): {ENS_STEPS} steps in chunks of "
                f"{ENS_CHUNK} through ensemble_rollout, per-member |dE/E| (host f64) max "
                f"{drift.max():.3e}, member 0 {drift[0]:.3e} <= {ENS_DRIFT_BOUND:g} (JAX's "
                f"recorded: {JAX_ENS_DRIFT:.3e}, {JAX_ENS_DRIFT_MEMBER0:.3e}); "
                f"{1e3 * wall / ENS_STEPS:.5f} ms/step wall, "
                f"{e * n * ENS_STEPS / wall:.4g} body-steps/s; kernel launches {launches}, "
                f"member loops {loops}; recorded 20 steps every 10: {rec_launches} launches, "
                f"records {tuple(tr.pos.shape)}, max f32 energy drift {rec_drift:.2e}; "
                f"a 4-member bounce ensemble of 20 steps: member loops {member_loops}, kernel "
                f"launches {fused_ensemble.launches}")

    # phase 43
    def ensemble_timings(self) -> str:
        from orbital_tpu_torch.ops.fused_ensemble import fused_ensemble_plain
        from orbital_tpu_torch.parallel import ensemble

        out, parts = {}, []
        for members in ENS_SCALE:
            st, cfg = self.solar_ensemble(members)
            ms = summary([t / ENS_TIMED_STEPS for t in time_ms(
                lambda: ensemble.ensemble_rollout(st, cfg, ENS_TIMED_STEPS), 1)])
            n = st.n_bodies
            pairs = members * n * n
            # a launch reads pos, vel (hi and lo), mass and alive once and
            # writes pos, vel (hi and lo), acc, potential and the clock once
            nbytes = members * n * (48 + 8 + 48 + 12) + members * 12
            bnd = bound(OPS_B1 * pairs, nbytes / ENS_TIMED_STEPS, rsqrt=pairs)
            out[members] = (ms, bnd, members * n / (ms["median"] * 1e-3))
            parts.append(f"{members} x {n}: {ms['median']:.6f} ms/step (spread "
                         f"{ms['spread']:.6f}), {out[members][2]:.4g} body-steps/s, bound "
                         f"{bnd[0]:.6f} ms ({bnd[1]}), {bnd[0] / ms['median']:.2%} of it")
        st, cfg = self.solar_ensemble(ENS_MEMBERS)
        plain = summary([t / 20 for t in time_ms(lambda: fused_ensemble_plain(st, cfg, 20), 1)])
        ms, bnd, _ = out[ENS_MEMBERS]
        shape = self.kernels["ENS"].get("shape")
        floor = issue_floor_ms(self.kernels["ENS"].get("sass_slots_per_pair"),
                               shape and ensemble_lane_pairs(ENS_MEMBERS, shape))
        self.kernels["ENS"].update(ms=ms["median"], plain_ms=plain["median"], bound_ms=bnd[0],
                                   bound_by=bnd[1], library_ms=None)
        self.perf_ensemble = {f"ENS_{k}x26": {"ms_per_step": v[0], "bound_ms": v[1][0],
                                              "body_steps_per_s": v[2]}
                              for k, v in out.items()}
        self.perf_ensemble["plain_1024x26_ms_per_step"] = plain
        print("perf " + json.dumps(self.perf_ensemble), file=sys.stderr)
        return ("kernel route, ds32, " + f"{ENS_TIMED_STEPS} unrecorded steps a launch: "
                + "; ".join(parts) + f"; the batched plain route's step at {ENS_MEMBERS} x 26 "
                f"(orientation only) {plain['median']:.4f} ms (spread {plain['spread']:.4f}); "
                f"config 5's issue floor {fmt(floor, 5, ' ms')} a step")

    # phases 44-46
    def facade_engine(self):
        """A ``SimulationEngine`` on the card over the 65,536-body cluster
        as Objects (radius R_BENCH, default bounce collisions, ds32, G = 1,
        the identity rescale, history every FACADE_HISTORY_EVERY-th step of
        a run)."""
        import dataclasses as dc

        import orbital_tpu_torch as ot
        from orbital_tpu_torch.models.objects import Coordinates, Object, ObjectCollection

        pos, vel, mass, _ = self.cluster()
        objs = ObjectCollection([
            Object(float(mass[i]), R_BENCH, velocity=vel[i], coordinates=Coordinates(*pos[i]),
                   name=f"b{i:06d}") for i in range(len(mass))])
        return ot.SimulationEngine(objs, dt=DT, softening=EPS2 ** 0.5, cache=False,
                                   max_hist=None, precision="ds32",
                                   unit_profile=dc.replace(ot.STANDARD, G=1.0),
                                   rescale=ot.Rescale.identity(),
                                   history_every=FACADE_HISTORY_EVERY, device=self.dev)

    # phase 44
    def facade_main_path(self) -> str:
        import tempfile

        from orbital_tpu_torch.ops import cuda_collisions, cuda_forces
        from orbital_tpu_torch.engine.rollout import rollout

        torch = self.torch
        reset_launches()
        t0 = time.perf_counter()
        eng = self.facade_engine()
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if eng.config.collisions != "bounce" or eng.state.n_bodies != N_MAIN or not eng.state.is_ds:
            raise AssertionError(f"facade: {eng.config.collisions} collisions, N "
                                 f"{eng.state.n_bodies}, ds {eng.state.is_ds}")
        E0 = energy_f64(eng.state)
        t0 = time.perf_counter()
        for _ in range(FACADE_STEP_CALLS):
            eng.step()
        eng.run(FACADE_RUN)
        torch.cuda.synchronize()
        t_drive = time.perf_counter() - t0
        launches = {"B1": cuda_forces.pairwise_acc_cuda.launches,
                    "B2": cuda_forces.pairwise_acc_detect_cuda.launches,
                    "B6": cuda_collisions.bounce_deltas_cuda.launches}
        steps = FACADE_STEP_CALLS + FACADE_RUN
        if launches["B1"] < 1 or launches["B2"] != steps or launches["B6"] < 1:
            raise AssertionError(f"facade: launches {launches} over {steps} steps (B1 the "
                                 "initial evaluation, B2 every step, the gated B6)")
        hist = eng.history[eng.objects[0].uuid]
        want = 1 + FACADE_STEP_CALLS + FACADE_RUN // FACADE_HISTORY_EVERY
        if len(hist) != want or eng._history_stride(FACADE_RUN) != FACADE_HISTORY_EVERY:
            raise AssertionError(f"facade history: {len(hist)} records, want {want}")
        if eng.step_idx != steps or abs(eng.time_elapsed - steps * DT) > 1e-9:
            raise AssertionError(f"facade clock: step {eng.step_idx}, t {eng.time_elapsed}")
        E1 = energy_f64(eng.state)
        drift = abs((E1 - E0) / E0)
        e_f32 = eng.total_energy()
        if not drift <= DRIFT_BUDGET or abs(e_f32 - E1) > 1e-5 * abs(E1):
            raise AssertionError(f"facade |dE/E| {drift:.3e} (budget {DRIFT_BUDGET:g}), "
                                 f"engine energy {e_f32!r} against f64 {E1!r}")
        pos_obj = np.array([eng.objects[k].position() for k in (0, N_MAIN - 1)])
        if not np.isfinite(pos_obj).all():
            raise AssertionError("facade: objects not finite")

        # checkpoint, resume in a fresh engine, FACADE_AFTER more steps in both
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "facade.npz")
            eng.checkpoint(ck)
            fresh = self.facade_engine()
            fresh.resume(ck)
        eng.run(FACADE_AFTER)
        fresh.run(FACADE_AFTER)
        torch.cuda.synchronize()
        for f in ("pos", "pos_lo", "vel", "vel_lo", "acc", "potential", "time", "step",
                  "alive", "mass"):
            if not torch.equal(getattr(eng.state, f), getattr(fresh.state, f)):
                raise AssertionError(f"facade: the resumed engine differs in {f}")
        if fresh.step_idx != eng.step_idx or fresh.time_elapsed != eng.time_elapsed:
            raise AssertionError("facade: the resumed engine's clock differs")

        # run() against rollout alone with the same recording and the same
        # host copy of the records, in turns: the gap is the facade's own
        # host work (the history appends over the bodies, the Objects' sync)
        def bare():
            _, traj = rollout(fresh.state, fresh.config, FACADE_TIMED,
                              record_every=FACADE_HISTORY_EVERY, force_fn=fresh._force_fn,
                              force_detect_fn=fresh._force_detect_fn)
            traj.pos.cpu().numpy().astype(np.float64) * fresh.rescale.length
            traj.alive.cpu().numpy()

        def wall_ms(fn, iters, repeats=1):
            out = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                out.append(1e3 * (time.perf_counter() - t0) / iters / FACADE_TIMED)
            return out

        if eng._hist_phase % FACADE_HISTORY_EVERY:
            raise AssertionError(f"facade: history phase {eng._hist_phase} before the timing")
        walls = alternate_ms({"run": lambda: eng.run(FACADE_TIMED), "rollout": bare}, 1,
                             repeats=FACADE_TIMED_REPEATS, timer=wall_ms)
        t = {k: summary(v) for k, v in walls.items()}
        ratios = summary([a / b for a, b in zip(walls["run"], walls["rollout"])])
        resolved = min(walls["run"]) > max(walls["rollout"])
        self.perf_facade = {"run_ms_per_step": t["run"], "rollout_ms_per_step": t["rollout"],
                            "ratio": ratios, "resolved": resolved,
                            "build_s": t_build, "drive_s": t_drive, "drift": drift}
        print("perf_facade " + json.dumps(self.perf_facade), file=sys.stderr)
        return (f"SimulationEngine on the card at N={N_MAIN} (ds32, bounce at R {R_BENCH:g}; "
                f"built in {t_build:.1f} s): {FACADE_STEP_CALLS} step() + run({FACADE_RUN}) "
                f"every {FACADE_HISTORY_EVERY}-th step recorded in {t_drive:.1f} s, launches "
                f"{launches}; {len(hist)} history records a body; |dE/E| (f64) {drift:.3e} "
                f"<= {DRIFT_BUDGET:g}; the engine's f32 energy {e_f32:.9g} against f64 "
                f"{E1:.9g}; checkpoint resumed in a fresh engine and {FACADE_AFTER} more steps "
                f"in both: bit-equal; run({FACADE_TIMED}) {t['run']['median']:.4f} ms/step "
                f"(spread {t['run']['spread']:.4f}) against rollout alone with the same "
                f"recording and host copy {t['rollout']['median']:.4f} (spread "
                f"{t['rollout']['spread']:.4f}), {FACADE_TIMED_REPEATS} each in turns: ratio "
                f"{ratios['median']:.3f} (spread {ratios['spread']:.3f}), "
                f"{'every run() slower than every rollout' if resolved else 'unresolved'}")

    # phase 45
    def viewer_backend(self) -> str:
        import tempfile

        from orbital_tpu_torch.engine.checkpoint import load_state
        from orbital_tpu_torch.ops import cuda_forces
        from orbital_tpu_torch.serve.backend import create_backend

        torch = self.torch
        keys = {"bodies", "mass_min", "mass_max", "radius_min", "radius_max", "time_elapsed",
                "sim_time_jd", "sim_time_iso"}
        body_keys = {"id", "name", "mass_kg", "radius_km", "T_seconds", "fg_ms2", "position"}

        def check(snap, n_bodies, what):
            text = json.dumps(snap)
            pos = np.array([[b["position"][c] for c in "xyz"] for b in snap["bodies"]])
            if (not keys <= set(snap) or len(snap["bodies"]) != n_bodies
                    or any(set(b) != body_keys for b in snap["bodies"])
                    or not np.isfinite(pos).all()):
                raise AssertionError(f"{what}: snapshot keys {sorted(snap)}, "
                                     f"{len(snap['bodies'])} bodies, finite "
                                     f"{np.isfinite(pos).all()}")
            return len(text)

        env = {"SIM_SCENE": "cluster", "SIM_N": str(N_MAIN), "SIM_INITIAL_STEPS":
               str(VIEWER_WARMUP), "SIM_DISABLE_THREAD": "true"}
        t0 = time.perf_counter()
        backend = create_backend(env, device=self.dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if backend.cfg.steps_per_tick != 10 or backend.cfg.view_max != VIEWER_VIEW:
            raise AssertionError(f"viewer defaults: {backend.cfg}")
        reset_launches()
        ticks, snaps, sizes = [], [], []
        n_view = min(VIEWER_VIEW, N_MAIN)
        t_prev = backend.snapshot["time_elapsed"]
        for _ in range(VIEWER_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = backend.tick()
            ticks.append(1e3 * (time.perf_counter() - t0))
            sizes.append(check(snap, n_view, "cluster tick"))
            if not snap["time_elapsed"] > t_prev:
                raise AssertionError("cluster: the clock did not advance")
            t_prev = snap["time_elapsed"]
        b1 = cuda_forces.pairwise_acc_cuda.launches
        if b1 != VIEWER_TICKS * backend.cfg.steps_per_tick:
            raise AssertionError(f"cluster ticks: {b1} B1 launches")
        for _ in range(VIEWER_TICKS):
            t0 = time.perf_counter()
            snap = backend.build_snapshot()
            snaps.append(1e3 * (time.perf_counter() - t0))
            check(snap, n_view, "cluster snapshot")
        with tempfile.TemporaryDirectory() as tmp:
            path = backend.checkpoint(os.path.join(tmp, "cluster.npz"))
            state, meta = load_state(path, device=self.dev)
        if meta != {"scene": "cluster", "n": N_MAIN} or not torch.equal(
                state.pos, backend.cluster.state.pos):
            raise AssertionError(f"cluster checkpoint: {meta}")
        if backend.health() != {"status": "ok"}:
            raise AssertionError("cluster health")
        tick_t, snap_t = summary(ticks), summary(snaps)

        # solar mode: the bundled solar system with moons, one engine step a tick
        solar = create_backend({"SIM_INITIAL_STEPS": "20", "SIM_DISABLE_THREAD": "true"},
                               device=self.dev)
        n_solar = len(solar.engine.objects)
        for _ in range(SOLAR_TICKS):
            check(solar.tick(), n_solar, "solar tick")
        if solar.engine.step_idx != 20 + SOLAR_TICKS:
            raise AssertionError(f"solar: {solar.engine.step_idx} steps")
        with tempfile.TemporaryDirectory() as tmp:
            path = solar.checkpoint(os.path.join(tmp, "solar.npz"))
            state, meta = load_state(path, device=self.dev)
        if meta.get("step_idx") != solar.engine.step_idx or not torch.equal(
                state.pos, solar.engine.state.pos):
            raise AssertionError(f"solar checkpoint: {meta.get('step_idx')}")
        self.perf_viewer = {"tick_ms": tick_t, "snapshot_ms": snap_t, "build_s": t_build,
                            "snapshot_bytes": sizes[-1]}
        print("perf_viewer " + json.dumps(self.perf_viewer), file=sys.stderr)
        return (f"viewer backend, cluster mode at SIM_N={N_MAIN} (built with "
                f"{VIEWER_WARMUP} warm-up steps in {t_build:.1f} s): {VIEWER_TICKS} ticks of "
                f"{backend.cfg.steps_per_tick} steps, {tick_t['median']:.2f} ms a tick (spread "
                f"{tick_t['spread']:.2f}) with its snapshot, B1 launches {b1}; "
                f"{VIEWER_TICKS} snapshots of {n_view} bodies, {snap_t['median']:.2f} ms "
                f"(spread {snap_t['spread']:.2f}), {sizes[-1]:,} bytes of JSON, finite; "
                f"checkpoint reloads equal; solar mode ({n_solar} bodies): {SOLAR_TICKS} "
                f"ticks and snapshots, checkpoint at step {solar.engine.step_idx} reloads equal")

    # phase 46
    def cli_simulate(self) -> str:
        import io

        from orbital_tpu_torch.__main__ import main as cli

        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli(["simulate", "--steps", "365", "--device", "cuda"])
        wall = time.perf_counter() - t0
        got = json.loads(out.getvalue().splitlines()[0])
        # the ds32 clock is an f32 sum of 365 steps in internal units: it read
        # 364.9997 days (8e-7 of the span) on an H100; 1e-5 of it is the gate
        if (rc != 0 or set(got) != {"bodies", "steps", "sim_days", "energy_drift", "records"}
                or (got["bodies"], got["steps"], got["records"]) != (15, 365, 365)
                or abs(got["sim_days"] - 365.0) > 1e-5 * 365.0
                or not abs(got["energy_drift"]) < 1e-4):
            raise AssertionError(f"CLI simulate: rc {rc}, {got}")
        return f"python -m orbital_tpu_torch simulate --steps 365 --device cuda: {got} in {wall:.1f} s"

    # phase 47
    def fitting(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda
        from orbital_tpu_torch.ops.fused_rollout import fused_rollout
        from orbital_tpu_torch.ops.kepler import elements_to_state

        torch = self.torch
        out = []
        # the Earth-Moon pair in SI, observed by the port's own f64 rollout
        pos, vel, mass = earth_moon()
        cfg = ot.SimConfig(dt=3600.0, G=G_SI, eps2=1e6)
        st = ot.init_forces(ot.make_state(pos, vel, mass, precision="f64", device=self.dev),
                            cfg)
        obs = ot.rollout(st, cfg, 240, record_every=24)[1].pos.cpu().numpy()
        vel_guess = vel * (1.0 + 0.03 * np.random.default_rng(0).standard_normal(vel.shape))
        mass_guess = mass * np.array([1.10, 1.0])
        fits = {
            "velocity": (FIT_VEL_ITERS, lambda n: ot.fit_initial_conditions(
                obs, 24, cfg, pos0=pos, vel0=vel_guess, mass=mass, free=("vel",),
                iterations=n, learning_rate=3e-2, device=self.dev)),
            "central mass": (FIT_MASS_ITERS, lambda n: ot.fit_initial_conditions(
                obs, 24, cfg, pos0=pos, vel0=vel, mass=mass_guess, free=("mass",),
                iterations=n, learning_rate=5e-2, device=self.dev)),
        }
        # two planets about a unit mass, observed central-relative
        m_c, m_sat = 1.0, np.array([1e-4, 5e-5])
        el_true = dict(a=np.array([1.0, 1.8]), e=np.array([0.05, 0.12]),
                       inc=np.array([0.02, 0.1]), long_node=np.array([0.3, 1.1]),
                       arg_peri=np.array([0.7, 2.0]), mean_anom=np.array([0.1, 2.5]))
        cfg_p = ot.SimConfig(dt=2e-3, G=1.0, eps2=1e-12)
        mu = torch.tensor(m_c + m_sat, dtype=torch.float64, device=self.dev)
        ps, vs = elements_to_state(*(torch.tensor(el_true[k], device=self.dev) for k in
                                     ("a", "e", "inc", "long_node", "arg_peri",
                                      "mean_anom")), mu)
        ps, vs = ps.cpu().numpy(), vs.cpu().numpy()
        v_c = -(m_sat[:, None] * vs).sum(0) / m_c
        st = ot.init_forces(ot.make_state(np.concatenate([np.zeros((1, 3)), ps]),
                                          np.concatenate([v_c[None], vs]),
                                          np.concatenate([[m_c], m_sat]), precision="f64",
                                          device=self.dev), cfg_p)
        tp = ot.rollout(st, cfg_p, 400, record_every=40)[1].pos
        obs_p = (tp[:, 1:] - tp[:, :1]).cpu().numpy()
        guess = {k: v.copy() for k, v in el_true.items()}
        guess["a"] = el_true["a"] * np.array([1.02, 0.985])
        guess["mean_anom"] = el_true["mean_anom"] + np.array([0.03, -0.02])
        fits["elements"] = (FIT_ELEMENTS_ITERS, lambda n: ot.fit_orbital_elements(
            obs_p, 40, cfg_p, central_mass=m_c, sat_masses=m_sat, elements0=guess,
            free=("a", "mean_anom"), iterations=n, learning_rate=2e-2, device=self.dev))

        # the card's fit (its loss and backward as CUDA graphs) against the same
        # fit run eagerly on the CPU, FIT_CHECK_ITERS iterations: the same f64
        # arithmetic, so the histories agree to roundoff
        kw = dict(pos0=pos, vel0=vel_guess, mass=mass, free=("vel",),
                  iterations=FIT_CHECK_ITERS, learning_rate=3e-2)
        on_card = ot.fit_initial_conditions(obs, 24, cfg, device=self.dev, **kw)
        on_cpu = ot.fit_initial_conditions(obs, 24, cfg, device="cpu", **kw)
        hist_err = float(np.max(np.abs(on_card.loss_history / on_cpu.loss_history - 1.0)))
        vel_err = float(np.abs(on_card.vel - on_cpu.vel).max() / np.abs(on_cpu.vel).max())
        if not (hist_err <= FIT_CPU_RTOL and vel_err <= FIT_CPU_RTOL):
            raise AssertionError(f"fit on the card vs the CPU: history {hist_err:.3e}, "
                                 f"velocities {vel_err:.3e}")
        out.append(f"{FIT_CHECK_ITERS} iterations on the card (graphed) vs the CPU (eager): "
                   f"history {hist_err:.2e}, velocities {vel_err:.2e} (<= {FIT_CPU_RTOL:g})")

        reset_launches()
        done = {}
        for name, (iters, fit) in fits.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done[name] = fit(iters)
            torch.cuda.synchronize()
            done[name] = (done[name], 1e3 * (time.perf_counter() - t0) / iters)
        if pairwise_acc_cuda.launches or fused_rollout.launches:
            raise AssertionError("fitting launched a kernel: it must take the dense route")
        res, ms = done["velocity"]
        verr0 = np.abs(vel_guess - vel).max() / np.abs(vel).max()
        verr1 = np.abs(res.vel - vel).max() / np.abs(vel).max()
        drop = res.loss_history[-1] / res.loss_history[0]
        if not (verr1 < 1e-3 < verr0 and drop < 1e-4):
            raise AssertionError(f"velocity fit: error {verr0:.3e} -> {verr1:.3e}, loss x{drop:.2e}")
        out.append(f"Earth-Moon velocity (SI, f64): {FIT_VEL_ITERS} iterations, relative "
                   f"error {verr0:.3e} -> {verr1:.3e} (< 1e-3), loss x{drop:.3e} (< 1e-4), "
                   f"{ms:.1f} ms/iteration")
        res, ms = done["central mass"]
        merr = abs(res.mass[0] - mass[0]) / mass[0]
        drop = res.loss_history[-1] / res.loss_history[0]
        if not (merr < 1e-3 and drop < 1e-3):
            raise AssertionError(f"mass fit: error {merr:.3e}, loss x{drop:.2e}")
        out.append(f"central mass: {FIT_MASS_ITERS} iterations, relative error {merr:.3e} "
                   f"(< 1e-3), loss x{drop:.3e} (< 1e-3), {ms:.1f} ms/iteration")
        (el_fit, res), ms = done["elements"]
        a_err = np.abs(el_fit["a"] - el_true["a"]).max()
        m_err = np.abs(el_fit["mean_anom"] - el_true["mean_anom"]).max()
        drop = res.loss_history[-1] / res.loss_history[0]
        if not (a_err < 2e-3 and m_err < 5e-3 and drop < 1e-3):
            raise AssertionError(f"elements fit: a {a_err:.3e}, M {m_err:.3e}, loss x{drop:.2e}")
        out.append(f"two planets' elements: {FIT_ELEMENTS_ITERS} iterations, |da| {a_err:.3e} "
                   f"(< 2e-3), |dM| {m_err:.3e} (< 5e-3), loss x{drop:.3e} (< 1e-3), "
                   f"{ms:.1f} ms/iteration")
        self.fit_ms = {k: v[1] for k, v in done.items()}

        # the kernels have no backward pass: a grad-requiring input raises
        p = torch.randn(N_RAGGED, 3, device=self.dev, requires_grad=True)
        m = torch.full((N_RAGGED,), 1.0 / N_RAGGED, device=self.dev)
        refused = [raises(RuntimeError, "no backward pass",
                          lambda: pairwise_acc_cuda(p, m, G=1.0, eps2=EPS2))]
        s32 = ot.make_state(*make_cluster(N_FUSED, self.seed), precision="f32",
                            device=self.dev)
        s32 = s32.replace(pos=s32.pos.clone().requires_grad_())
        refused.append(raises(RuntimeError, "no backward pass",
                              lambda: fused_rollout(s32, ot.SimConfig(dt=DT, eps2=EPS2), 1)))
        with torch.no_grad():
            pairwise_acc_cuda(p, m, G=1.0, eps2=EPS2)
        out.append("pairwise_acc_cuda and fused_rollout on a grad-requiring pos: "
                   + "; ".join(refused) + " (and run under no_grad)")
        return " | ".join(out)

    def tree_mode_cfgs(self, pos, vel, mass, levels: int):
        """{mode: config} with simulate()'s probe-sized budgets for each near
        mode at ``levels`` ("pairs" at TREE_PAIRS_CHUNK), and the f32 state
        they were sized on."""
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.simulate import _tree_budget_cfg

        state = ot.make_state(pos, vel, mass, precision="f32", device=self.dev)
        base = ot.SimConfig(dt=TREE_DT, G=1.0, eps2=TREE_EPS2, force_impl="tree",
                            tree_levels=levels, tree_chunk=TREE_CHUNK, tree_wl_rj=TREE_RJ)
        cfgs = {}
        for mode in TREE_MODES + ("kernel",):
            cfg = base.replace(tree_near=mode,
                               tree_chunk=TREE_PAIRS_CHUNK if mode == "pairs" else TREE_CHUNK)
            cfgs[mode] = _tree_budget_cfg(cfg, state, tree_near=mode, tree_levels=levels,
                                          tree_capacity="auto")
        return cfgs, state

    # phase 48
    def tree_modes(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import _tree_kwargs
        from orbital_tpu_torch.ops.cuda_tree import tree_near_cuda
        from orbital_tpu_torch.ops.tree import tree_acc_potential

        torch = self.torch
        pos, vel, mass, _ = self.plummer()
        cfgs, state = self.tree_mode_cfgs(pos, vel, mass, TREE_LEVELS)
        args = (state.pos, state.mass, state.alive)

        def evaluate(mode):
            return tree_acc_potential(*args, **_tree_kwargs(cfgs[mode], self.dev))

        a_k, U_k, ov_k = evaluate("kernel")
        base = torch.cuda.memory_allocated()
        rows, perf = [], {}
        for mode in TREE_MODES + ("kernel",):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a, U, ov = evaluate(mode)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            err = float((a - a_k).abs().max() / a_k.abs().max())
            u_err = abs(float(U) / float(U_k) - 1.0)
            if int(ov) or int(ov_k) or not (err <= TREE_MODE_RTOL and u_err <= TREE_MODE_RTOL):
                raise AssertionError(f"tree near={mode!r}: max |da|/max|a| {err:.3e}, dU/U "
                                     f"{u_err:.3e}, overflow {int(ov)} (kernel {int(ov_k)})")
            t = summary(time_ms(lambda m=mode: evaluate(m), TREE_MODE_ITERS))
            perf[mode] = dict(eval=t, peak_bytes=peak, err=err, u_err=u_err)
        # TREE_MODE_STEPS KDK steps of each mode, overflow 0, drift in f64
        e0 = energy_f64(ot.init_forces(state, cfgs["kernel"]), TREE_EPS2)
        for mode in TREE_MODES + ("kernel",):
            cfg = cfgs[mode].replace(track_potential=False)
            st = ot.init_forces(state, cfg)
            reset_launches()
            with overflow_log() as ovf:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fin, _ = ot.rollout(st, cfg, TREE_MODE_STEPS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                overflow = int(ovf[0])
            b7 = tree_near_cuda.launches
            drift = abs((energy_f64(fin, TREE_EPS2) - e0) / e0)
            want_b7 = TREE_MODE_STEPS if mode == "kernel" else 0
            if overflow or b7 != want_b7 or not drift <= TREE_DRIFT_BOUND:
                raise AssertionError(f"tree near={mode!r}: {TREE_MODE_STEPS} steps, drift "
                                     f"{drift:.3e}, overflow {overflow}, B7 {b7}")
            perf[mode].update(step_ms=1e3 * wall / TREE_MODE_STEPS, drift=drift, b7=b7)
        for mode in TREE_MODES + ("kernel",):
            q = perf[mode]
            rows.append(f"{mode}: evaluation {q['eval']['median']:.3f} ms (spread "
                        f"{q['eval']['spread']:.3f}), peak {q['peak_bytes'] / 2 ** 20:.0f} MiB "
                        f"above the inputs, vs kernel {q['err']:.2e} / dU {q['u_err']:.2e}; "
                        f"{TREE_MODE_STEPS} steps {q['step_ms']:.3f} ms/step, |dE/E| "
                        f"{q['drift']:.3e}, B7 {q['b7']}")

        # one evaluation at 1,048,576 bodies, levels 8: "pairs" against "kernel"
        pos_b, vel_b, mass_b = make_plummer(N_TREE_BIG, self.seed)
        t0 = time.perf_counter()
        cfg_b, st_b = self.tree_mode_cfgs(pos_b, vel_b, mass_b, TREE_BIG_LEVELS)
        probe_s = time.perf_counter() - t0
        big = {}
        for mode in ("pairs", "kernel"):
            kw = _tree_kwargs(cfg_b[mode], self.dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_b = torch.cuda.memory_allocated()
            a, U, ov = tree_acc_potential(st_b.pos, st_b.mass, st_b.alive, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base_b
            t = summary(time_ms(lambda kw=kw: tree_acc_potential(st_b.pos, st_b.mass,
                                                                  st_b.alive, **kw), 1))
            big[mode] = (a, U, int(ov), t, peak)
        (a_p, U_p, ov_p, t_p, pk_p), (a_kb, U_kb, ov_kb, t_k, pk_k) = big["pairs"], big["kernel"]
        err_b = float((a_p - a_kb).abs().max() / a_kb.abs().max())
        u_b = abs(float(U_p) / float(U_kb) - 1.0)
        if ov_p or ov_kb or not (err_b <= TREE_MODE_RTOL and u_b <= TREE_MODE_RTOL):
            raise AssertionError(f"tree N={N_TREE_BIG} pairs vs kernel: {err_b:.3e}, dU "
                                 f"{u_b:.3e}, overflow {ov_p}/{ov_kb}")
        perf["N1048576"] = dict(pairs=t_p, kernel=t_k, pairs_peak=pk_p, kernel_peak=pk_k,
                                err=err_b, u_err=u_b, probe_s=probe_s)
        self.tree_mode_perf = perf
        print("perf_tree_modes " + json.dumps(perf), file=sys.stderr)
        return (f"N={N_MAIN} Plummer l{TREE_LEVELS}, each mode's probed budgets, all overflow "
                f"0, within {TREE_MODE_RTOL:g} of kernel: " + "; ".join(rows)
                + f" | N={N_TREE_BIG} l{TREE_BIG_LEVELS} (budgets probed in {probe_s:.1f} s): "
                f"pairs {t_p['median']:.3f} ms (spread {t_p['spread']:.3f}, peak "
                f"{pk_p / 2 ** 20:.0f} MiB) vs kernel {t_k['median']:.3f} ms (spread "
                f"{t_k['spread']:.3f}, peak {pk_k / 2 ** 20:.0f} MiB), max |da|/max|a| "
                f"{err_b:.2e}, dU/U {u_b:.2e}, overflow 0")

    # phase 49
    def tree_options(self) -> str:
        import dataclasses as dc

        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_force_fn
        from orbital_tpu_torch.models.objects import Coordinates, Object, ObjectCollection
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda
        from orbital_tpu_torch.ops.cuda_tree import tree_near_cuda

        torch = self.torch
        pos, vel, mass, _ = self.plummer()
        scene = SceneArrays(pos=pos, vel=vel, mass=mass, radius=np.full(N_MAIN, 1e-3),
                            names=[f"b{i}" for i in range(N_MAIN)])
        reset_launches()
        t0 = time.perf_counter()
        res = ot.simulate(scene, steps=10, dt=TREE_DT, softening=TREE_EPS2 ** 0.5,
                          device=self.dev, force_impl="tree", tree_levels=TREE_LEVELS,
                          tree_accuracy=TREE_ACCURACY, record_every=5)
        wall = time.perf_counter() - t0
        b1, b7 = pairwise_acc_cuda.launches, tree_near_cuda.launches
        c = res.config
        # the chosen rung's error on the initial state, as the probe measured it
        st = ot.make_state(scene.pos, scene.vel, scene.mass, precision="ds32",
                           rescale=res.rescale, device=self.dev)
        args = (st.pos, st.mass, st.alive)
        a_x = resolve_force_fn(c.replace(force_impl="auto"), N_MAIN, self.dev)(*args)[0]
        a_t = resolve_force_fn(c, N_MAIN, self.dev)(*args)[0]
        err = rms_rel(a_t, a_x)
        if (b1 < 1 or b7 < 11 or c.tree_near != "kernel" or not err <= TREE_ACCURACY
                or not np.isfinite(res.pos).all()):
            raise AssertionError(f"simulate(tree_accuracy={TREE_ACCURACY:g}): rung ("
                                 f"{c.tree_order}, {c.tree_ws}), error {err:.3e}, B1 {b1}, "
                                 f"B7 {b7}, near {c.tree_near!r}")
        out = [f"simulate(force_impl='tree', tree_accuracy={TREE_ACCURACY:g}) at N={N_MAIN}: "
               f"rung order {c.tree_order} ws {c.tree_ws}, RMS force error {err:.3e} against "
               f"B1, levels {c.tree_levels}, near {c.tree_near!r}, budgets "
               f"({c.tree_max_chunks}, {c.tree_wl_entries}); B1 {b1} and B7 {b7} launches; "
               f"{wall:.1f} s"]

        # the facade on the tree with SimConfig's defaults
        cpos, cvel, cmass = make_cluster(TREE_ENGINE_N, self.seed + 21)
        objs = ObjectCollection([
            Object(float(cmass[i]), R_BENCH, velocity=cvel[i],
                   coordinates=Coordinates(*cpos[i]), name=f"b{i:06d}")
            for i in range(TREE_ENGINE_N)])
        reset_launches()
        # built inside the log, which wraps the tree force the engine resolves
        with overflow_log() as ovf:
            eng = ot.SimulationEngine(objs, dt=DT, softening=EPS2 ** 0.5, cache=False,
                                      max_hist=None, precision="ds32", force_impl="tree",
                                      unit_profile=dc.replace(ot.STANDARD, G=1.0),
                                      rescale=ot.Rescale.identity(), device=self.dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(TREE_ENGINE_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            overflow = int(ovf[0])
        cfg = eng.config
        defaults = ot.SimConfig(dt=cfg.dt)
        same = all(getattr(cfg, f) == getattr(defaults, f) for f in (
            "tree_near", "tree_levels", "tree_capacity", "tree_max_cells", "tree_max_big",
            "tree_max_frontier", "tree_ws", "tree_order"))
        if (not same or cfg.tree_near != "cells" or overflow or eng.step_idx != TREE_ENGINE_STEPS
                or tree_near_cuda.launches or not bool(torch.isfinite(eng.state.pos).all())):
            raise AssertionError(f"SimulationEngine(force_impl='tree'): defaults {same}, near "
                                 f"{cfg.tree_near!r}, overflow {overflow}, steps "
                                 f"{eng.step_idx}, B7 {tree_near_cuda.launches}")
        out.append(f"SimulationEngine(force_impl='tree') with SimConfig's defaults (near "
                   f"{cfg.tree_near!r}, levels {cfg.tree_levels}, capacity "
                   f"{cfg.tree_capacity}) on the {TREE_ENGINE_N}-body cluster: run("
                   f"{TREE_ENGINE_STEPS}) {1e3 * wall / TREE_ENGINE_STEPS:.2f} ms/step, overflow "
                   f"0, finite")
        return " | ".join(out)

    # phase 50
    def compat_core(self) -> str:
        import tempfile

        code = reference_user_code()
        script = code + ('\nimport sys\nprint("JAX_LOADED", "jax" in sys.modules)\n'
                         'print("DEVICE", engine.device)\n')
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([
            os.path.join(REPO_ROOT, "orbital_tpu_torch", "compat"), REPO_ROOT]))
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", script], cwd=tmp, env=env,
                                  capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
        said = proc.stdout.splitlines()
        if (proc.returncode != 0 or "COMPAT_OK" not in said or "JAX_LOADED False" not in said
                or not any(ln.startswith("DEVICE cuda") for ln in said)):
            raise AssertionError(f"compat core: rc {proc.returncode}\n{proc.stdout}\n"
                                 f"{proc.stderr[-4000:]}")
        return (f"the reference user code of tests/test_compat_core.py through "
                f"orbital_tpu_torch/compat/core on {said[-1].split()[1]} in a fresh process: "
                f"COMPAT_OK, no jax imported, {wall:.1f} s")

    # --- the multi-device ring (ROADMAP A.15a) on one-card ranks ---------

    def ring_mesh(self, p: int):
        import orbital_tpu_torch as ot

        return ot.make_mesh(shape=(p,), devices=self.dev)

    def ring_shards(self, radius: float, dead: int = 0, ranks: int = RING_P):
        """The cluster (its first N_MAIN - dead bodies live, the rest parked
        far) as f32 tensors on the card, cut in ``ranks`` shards (RING_B
        bodies at RING_P): [(pos, vel, mass, radius, alive), ...]."""
        pos, vel, mass, rad, alive = self.scene(N_MAIN, radius, dead, seed_offset=51)
        b = N_MAIN // ranks
        return [tuple(t[r * b:(r + 1) * b] for t in (pos, vel, mass, rad, alive))
                for r in range(ranks)]

    # phase 51
    def check_ring_kernels(self) -> str:
        from orbital_tpu_torch.ops.cuda_collisions import bounce_block_cuda, bounce_block_plain
        from orbital_tpu_torch.ops.cuda_forces import (block_acc_cuda, block_acc_detect_cuda,
                                                       block_acc_detect_plain)

        torch, rel = self.torch, self.rel
        kw = dict(G=1.0, eps2=EPS2)
        lines, err_bb, err_b3d, abs_bb, abs_b3d = [], 0.0, 0.0, 0.0, 0.0
        zero = torch.zeros((), dtype=torch.int32, device=self.dev)

        def bounce_pair(si, sj, contacts):
            out = bounce_block_cuda(*si, *sj, restitution=0.8, contacts=contacts)
            ref = bounce_block_plain(*si, *sj, restitution=0.8, contacts=contacts)
            torch.cuda.synchronize()
            errs, absd = [], 0.0
            for o, r in zip(out, ref):
                absd = max(absd, float((o - r).abs().max()))
                if float(r.abs().max()) == 0.0:
                    if bool(o.any()):
                        raise AssertionError("block bounce: nonzero where the plain is 0")
                    errs.append(0.0)
                else:
                    errs.append(rel(o, r))
            if max(errs) > BOUNCE_RTOL:
                raise AssertionError(f"block bounce vs plain: {errs} > {BOUNCE_RTOL:g}")
            return max(errs), absd, int((out[1].abs().sum(1) > 0).sum())

        cases = (("rich", R_RICH, 0), ("bench", R_BENCH, 0), ("dead", R_RICH, N_MAIN // 3))
        for key, radius, dead in cases:
            shards = self.ring_shards(radius, dead)
            pairs = ((2, 2), (2, 3)) if dead else ((0, 0), (0, 1))
            counts = []
            for i, j in pairs:
                (pi, vi, mi, ri, ai), (pj, vj, mj, rj, aj) = shards[i], shards[j]
                m_eff = mj * aj.to(mj.dtype)
                a, pe, c = block_acc_detect_cuda(pi, ri, ai, i * RING_B, pj, m_eff, rj, aj,
                                                 j * RING_B, **kw)
                again = block_acc_detect_cuda(pi, ri, ai, i * RING_B, pj, m_eff, rj, aj,
                                              j * RING_B, **kw)
                a3, pe3 = block_acc_cuda(pi, pj, m_eff, **kw)
                _, _, c0 = block_acc_detect_plain(pi, ri, ai, i * RING_B, pj, m_eff, rj, aj,
                                                  j * RING_B, **kw)
                torch.cuda.synchronize()
                if int(c) != int(c0) or not (torch.equal(a, a3) and torch.equal(pe, pe3)):
                    raise AssertionError(f"B3 detect {key} ({i}, {j}): count {int(c)} vs plain "
                                         f"{int(c0)}, or acc/pe not bit-equal to B3's")
                if not all(torch.equal(x, y) for x, y in zip((a, pe, c), again)):
                    raise AssertionError(f"B3 detect {key} ({i}, {j}): a rerun differs")
                counts.append(int(c))
                e, d, _ = bounce_pair(shards[i], shards[j], c)
                err_bb, abs_bb = max(err_bb, e), max(abs_bb, d)
                if bounce_pair(shards[i], shards[j], zero)[1]:
                    raise AssertionError("block bounce at count 0 is not 0")
                if key == "rich":
                    a0 = block_acc_detect_plain(pi, ri, ai, i * RING_B, pj, m_eff, rj, aj,
                                                j * RING_B, **kw)[0]
                    e_acc = rel(a, a0)
                    err_b3d, abs_b3d = max(err_b3d, e_acc), max(abs_b3d,
                                                                float((a - a0).abs().max()))
                    if e_acc > FORCE_RTOL:
                        raise AssertionError(f"B3 detect acc vs plain {e_acc:.3e}")
            if key == "rich" and not all(counts):
                raise AssertionError(f"contact-rich: counts {counts}")
            lines.append(f"{key} R={radius:g}{' a third dead' if dead else ''} shards "
                         f"{pairs}: counts {counts} == plain")
        # B3 detect at 8 ranks' shards (RING_B8^2; in the dead case shard 5
        # partly and shard 6 wholly dead): the same gates
        for key, radius, dead in cases:
            shards = self.ring_shards(radius, dead, RING_P8)
            pairs = ((5, 5), (5, 6)) if dead else ((0, 0), (0, 1))
            counts = []
            for i, j in pairs:
                (pi, _, _, ri, ai), (pj, _, mj, rj, aj) = shards[i], shards[j]
                m_eff = mj * aj.to(mj.dtype)
                args = (pi, ri, ai, i * RING_B8, pj, m_eff, rj, aj, j * RING_B8)
                a, pe, c = block_acc_detect_cuda(*args, **kw)
                again = block_acc_detect_cuda(*args, **kw)
                a3, pe3 = block_acc_cuda(pi, pj, m_eff, **kw)
                a0, _, c0 = block_acc_detect_plain(*args, **kw)
                torch.cuda.synchronize()
                e_acc = rel(a, a0) if key == "rich" else 0.0
                if not all(torch.equal(x, y) for x, y in zip((a, pe, c), again)):
                    raise AssertionError(f"B3 detect {key} ({i}, {j}) at {RING_B8}: a rerun "
                                         f"differs")
                if int(c) != int(c0) or not (torch.equal(a, a3) and torch.equal(pe, pe3)) \
                        or e_acc > FORCE_RTOL:
                    raise AssertionError(f"B3 detect {key} ({i}, {j}) at {RING_B8}: count "
                                         f"{int(c)} vs plain {int(c0)}, acc vs plain "
                                         f"{e_acc:.3e}, or acc/pe not bit-equal to B3's")
                err_b3d = max(err_b3d, e_acc)
                counts.append(int(c))
            if key == "rich" and not all(counts):
                raise AssertionError(f"contact-rich at {RING_B8}: counts {counts}")
            lines.append(f"{RING_B8}x{RING_B8} {key} shards {pairs}: counts {counts} == plain")
        # a ragged pair of blocks, a third of each dead, for the bounce
        pos, vel, mass, rad, alive = self.scene(N_RAGGED, R_RAGGED, N_RAGGED // 3,
                                                seed_offset=52, cluster=False)
        cut = 2 * N_RAGGED // 5
        si = tuple(t[:cut] for t in (pos, vel, mass, rad, alive))
        sj = tuple(t[cut:] for t in (pos, vel, mass, rad, alive))
        one = torch.ones((), dtype=torch.int32, device=self.dev)
        e_r, d_r, rows_r = bounce_pair(si, sj, one)
        if not rows_r:
            raise AssertionError("ragged block bounce: nothing bounced")
        self.kernels["BB"]["max_abs_err"] = max(abs_bb, d_r)
        self.kernels["B3D"]["max_abs_err"] = abs_b3d
        return (f"B3 detect at {RING_B}x{RING_B} and {RING_B8}x{RING_B8} (acc and pe "
                f"bit-equal to B3's and reruns bit-equal, count integer-equal to the plain "
                f"one; acc vs plain "
                f"{err_b3d:.2e} <= "
                f"{FORCE_RTOL:g}) and the block bounce (vs plain {err_bb:.2e} <= "
                f"{BOUNCE_RTOL:g}, zeros at count 0): " + "; ".join(lines)
                + f"; ragged {cut}x{N_RAGGED - cut} with a third dead: bounce vs plain "
                f"{e_r:.2e}, {rows_r} rows bounced")

    def ring_eval(self, mesh, pos, mass, alive, radius=None):
        """The ring force over ``mesh`` on full tensors cut in its shards:
        (acc, U[, contacts])."""
        from orbital_tpu_torch.parallel import sharded as tsh

        detect = radius is not None
        fns = [tsh.ring_force_fn(self.ring_cfg(), c, detect=detect) for c in mesh.comms]
        p = mesh.size
        args = [list(t.chunk(p)) for t in ((pos, mass, radius, alive) if detect
                                           else (pos, mass, alive))]
        out = mesh.run(lambda comm, fn, *a: fn(*a), fns, *args)
        return (self.torch.cat([o[0] for o in out]),) + tuple(out[0][1:])

    def ring_cfg(self, **kw):
        import orbital_tpu_torch as ot

        return ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, **kw)

    # phase 52
    def check_ring_force(self) -> str:
        from orbital_tpu_torch.ops.cuda_forces import (block_acc_cuda, block_acc_detect_cuda,
                                                       pairwise_acc_cuda,
                                                       pairwise_acc_detect_cuda)

        torch, rel = self.torch, self.rel
        pos, _, mass, rad, alive = self.scene(N_MAIN, R_RICH, 0, seed_offset=53)
        a1, U1 = pairwise_acc_cuda(pos, mass, alive, G=1.0, eps2=EPS2)
        _, _, c2 = pairwise_acc_detect_cuda(pos, mass, rad, alive, G=1.0, eps2=EPS2)
        lines = []
        for p in (RING_P, RING_P2):
            mesh = self.ring_mesh(p)
            reset_launches()
            a, U = self.ring_eval(mesh, pos, mass, alive)
            ad, Ud, cd = self.ring_eval(mesh, pos, mass, alive, radius=rad)
            torch.cuda.synchronize()
            ra, ru = rel(a, a1), abs(float(U) - float(U1)) / abs(float(U1))
            if ra > FORCE_RTOL or ru > RING_U_RTOL:
                raise AssertionError(f"ring P={p} vs B1: acc {ra:.3e}, U {ru:.3e}")
            if not (torch.equal(ad, a) and torch.equal(Ud, U)) or int(cd) != int(c2):
                raise AssertionError(f"ring P={p} with detection: acc/U not bit-equal to the "
                                     f"ring's, or count {int(cd)} != B2's {int(c2)}")
            if block_acc_cuda.launches != p * p or block_acc_detect_cuda.launches != p * p \
                    or pairwise_acc_cuda.launches:
                raise AssertionError(f"ring P={p}: B3 {block_acc_cuda.launches}, B3 detect "
                                     f"{block_acc_detect_cuda.launches}, B1 "
                                     f"{pairwise_acc_cuda.launches} launches")
            lines.append(f"P={p} (shards of {N_MAIN // p}): acc {ra:.2e} <= {FORCE_RTOL:g}, "
                         f"U {ru:.2e} <= {RING_U_RTOL:g} of B1's; with detection bit-equal, "
                         f"count {int(cd)} == B2's; B3 {p * p} and B3 detect {p * p} launches, "
                         f"B1 0")
        return "B3 in the ring vs B1 over the whole table: " + "; ".join(lines)

    # phase 53
    def ring_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_forces import block_acc_cuda, pairwise_acc_cuda
        from orbital_tpu_torch.utils import native

        torch = self.torch
        pos, vel, mass, E0 = self.cluster()
        cfg = self.ring_cfg()
        state = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32",
                                             device=self.dev), cfg)
        ref, _ = ot.rollout(state, cfg, RING_STEPS, fused="never")
        mesh = self.ring_mesh(RING_P)
        reset_launches()
        roll = ot.make_sharded_rollout(cfg, mesh, state, RING_STEPS,
                                       record_every=RING_STEPS // 2)
        shards, traj = roll(ot.shard_state(mesh, state))
        rec = ot.gather_state(mesh, shards)
        err = max_state_err(rec, ref)
        x0 = mesh.exchange_seconds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards, none = ot.make_sharded_rollout(cfg, mesh, rec, self.drift_steps)(shards)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        exch = (mesh.exchange_seconds() - x0) / RING_P / self.drift_steps
        fin = ot.gather_state(mesh, shards)
        steps = RING_STEPS + self.drift_steps
        b3, b1 = block_acc_cuda.launches, pairwise_acc_cuda.launches
        drift = abs((energy_f64(fin) - E0) / E0)
        e_rec = traj.energy.double().cpu().numpy()
        if err > STATE_ATOL:
            raise AssertionError(f"ring {RING_STEPS} steps vs the single-card path: {err:.3e}")
        if b3 != RING_P * RING_P * steps or b1 or none is not None:
            raise AssertionError(f"ring main path: B3 {b3} launches for {steps} evaluations, "
                                 f"B1 {b1}")
        if tuple(traj.pos.shape) != (2, N_MAIN, 3) or \
                np.max(np.abs(e_rec / E0 - 1.0)) > ENERGY_RTOL:
            raise AssertionError(f"ring records: {tuple(traj.pos.shape)}, energies {e_rec}")
        if drift > DRIFT_BUDGET or int(fin.step) != steps:
            raise AssertionError(f"ring |dE/E| = {drift:.3e} over {DRIFT_BUDGET:g}")
        self.kernels["B3"]["launches"] = b3
        self.ring_perf = dict(wall_ms_per_step=1e3 * wall / self.drift_steps,
                              exchange_host_ms_per_step_per_rank=1e3 * exch)
        return (f"N={N_MAIN} ds32 over {RING_P} one-card ranks: init_forces + {RING_STEPS} "
                f"recorded steps within {err:.2e} <= {STATE_ATOL:g} of the single-card B1 path, "
                f"+ {self.drift_steps} unrecorded, |dE/E| = {drift:.3e} <= {DRIFT_BUDGET:g} "
                f"(f64, {native.backend()}); B3 {b3} launches = {RING_P}^2 x {steps} "
                f"evaluations, B1 {b1}; {1e3 * wall / self.drift_steps:.3f} ms/step wall, "
                f"{1e3 * exch:.3f} ms a step a rank in the exchange (host)")

    # phases 54-56
    def ring_collisions(self) -> tuple[str, str, str]:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import resolve_force_detect_fn
        from orbital_tpu_torch.ops.cuda_collisions import bounce_block_cuda
        from orbital_tpu_torch.ops.cuda_forces import block_acc_cuda, block_acc_detect_cuda

        torch = self.torch
        pos, vel, mass, _ = self.cluster()
        mesh = self.ring_mesh(RING_P)
        # bench row: the bounce ring against the collision-free ring, step by
        # step, until the first contact
        st = ot.init_forces(self.torch_state(pos, vel, mass, R_BENCH), self.ring_cfg())
        log = []
        with ring_counts(log):
            step_b = ot.make_sharded_step(self.ring_cfg(collisions="bounce"), mesh, st)
        step_n = ot.make_sharded_step(self.ring_cfg(), mesh, st)
        b = f = ot.shard_state(mesh, st)
        reset_launches()
        first = None
        for k in range(1, RING_BOUNCE_STEPS + 1):
            b, f = step_b(b), step_n(f)
            if int(log[-1]) > 0:
                first = k
                break
            for sb, sf in zip(b, f):
                for name in ("pos", "pos_lo", "vel", "vel_lo", "acc", "potential"):
                    if not torch.equal(getattr(sb, name), getattr(sf, name)):
                        raise AssertionError(f"ring bounce bench row: {name} differs from the "
                                             f"collision-free ring at step {k}, no contact")
        checked = (first or RING_BOUNCE_STEPS + 1) - 1
        evals = first or RING_BOUNCE_STEPS
        b3d, bb, b3 = (block_acc_detect_cuda.launches, bounce_block_cuda.launches,
                       block_acc_cuda.launches)
        if b3d != RING_P * RING_P * evals or bb != RING_P * RING_P * evals \
                or b3 != RING_P * RING_P * evals:
            raise AssertionError(f"ring bounce: B3 detect {b3d}, block bounce {bb}, B3 {b3} "
                                 f"launches in {evals} steps")
        self.kernels["B3D"]["launches"] = b3d
        self.kernels["BB"]["launches"] = bb
        line1 = (f"bounce R={R_BENCH:g} over {RING_P} ranks: bit-equal to the collision-free "
                 f"ring through step {checked}, first contact "
                 f"{'at step ' + str(first) if first else 'not within ' + str(checked)} "
                 f"(one card: step 587); B3 detect {b3d}, block bounce {bb} (gated) "
                 f"launches = {RING_P}^2 x {evals} steps")

        # contact-rich: ring against the single-card bounce, counts equal
        cfg = self.ring_cfg(collisions="bounce", restitution=0.8)
        st = ot.init_forces(self.torch_state(pos, vel, mass, R_RICH), cfg)
        log, single_log = [], StepLog(resolve_force_detect_fn(cfg, N_MAIN, self.dev),
                                      keep_counts=True)
        with ring_counts(log):
            roll = ot.make_sharded_rollout(cfg, mesh, st, RICH_CHECK_STEPS)
        ring_fin = ot.gather_state(mesh, roll(ot.shard_state(mesh, st))[0])
        one, _ = ot.rollout(st, cfg, RICH_CHECK_STEPS, fused="never",
                            force_detect_fn=single_log)
        ring_c = [int(c) for c in log]
        one_c = [int(c) for c in single_log.counts]
        err = max_state_err(ring_fin, one)
        if ring_c != one_c or not all(ring_c) or err > STATE_ATOL:
            raise AssertionError(f"ring bounce contact-rich: counts {ring_c} vs one card "
                                 f"{one_c}, state {err:.3e}")
        line2 = (f"bounce R={R_RICH:g}: {RICH_CHECK_STEPS} steps, ring counts {ring_c} == the "
                 f"single card's, state within {err:.2e} <= {STATE_ATOL:g} of the single-card "
                 f"B2 + B6 path")

        # merge and resolve across shards, bench row, in a window around the
        # first contacts: counts equal to the single card's step by step
        cfg0 = self.ring_cfg()
        st0 = ot.init_forces(self.torch_state(pos, vel, mass, R_BENCH), cfg0)
        w, _ = ot.rollout(st0, cfg0, RING_WINDOW_START, fused="never")
        parts = []
        for mode, extra in (("merge", {}), ("resolve", dict(frag_seed=11))):
            cfg = self.ring_cfg(collisions=mode, **extra)
            log, single_log = [], StepLog(resolve_force_detect_fn(cfg, N_MAIN, self.dev),
                                          keep_counts=True)
            with ring_counts(log):
                roll = ot.make_sharded_rollout(cfg, mesh, w, RING_WINDOW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring_fin = ot.gather_state(mesh, roll(ot.shard_state(mesh, w))[0])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / RING_WINDOW
            one, _ = ot.rollout(w, cfg, RING_WINDOW, fused="never", force_detect_fn=single_log)
            ring_c = [int(c) for c in log]
            one_c = [int(c) for c in single_log.counts]
            hits = [RING_WINDOW_START + k + 1 for k, c in enumerate(ring_c) if c]
            if ring_c != one_c or not hits:
                raise AssertionError(f"ring {mode}: counts {ring_c} vs one card {one_c}")
            if not torch.equal(ring_fin.alive, one.alive):
                raise AssertionError(f"ring {mode}: alive differs from the single card's")
            done = (self.merged_checks(f"ring {mode}", w, ring_fin) if mode == "merge" else
                    f"{int((w.alive & ~ring_fin.alive).sum())} dead after, as on one card")
            parts.append(f"{mode}: counts equal on each of {RING_WINDOW} steps from step "
                         f"{RING_WINDOW_START} (contacts on steps {hits}); {done}; "
                         f"{ms:.3f} ms/step wall")
        line3 = f"bench row R={R_BENCH:g} over {RING_P} ranks, " + " | ".join(parts)
        return line1, line2, line3

    # phases 57-58
    def ring_pm_simulate(self) -> tuple[str, str]:
        import orbital_tpu_torch as ot
        import orbital_tpu_torch.ops.pm as pm
        from orbital_tpu_torch.models.scene import SceneArrays
        from orbital_tpu_torch.ops.cuda_forces import block_acc_detect_cuda, pairwise_acc_cuda

        torch = self.torch
        pos, vel, mass, _ = self.cluster()
        pt, mt = self.t(pos), self.t(mass)
        alive = torch.ones(N_MAIN, dtype=torch.bool, device=self.dev)
        mesh = self.ring_mesh(RING_P)
        parts = []
        for box in (PM_BOX, None):
            kw = dict(G_grav=1.0, eps2=EPS2, grid=PM_GRID, box=self.box_t(box))
            a1, U1 = pm.pm_acc_potential(pt, mt, alive, **kw)
            out = mesh.run(lambda comm, p, m, al: pm.pm_acc_potential(p, m, al, comm=comm,
                                                                      **kw),
                           list(pt.chunk(RING_P)), list(mt.chunk(RING_P)),
                           list(alive.chunk(RING_P)))
            a = torch.cat([o[0] for o in out])
            r_a = rms_rel(a, a1)
            r_u = abs(float(out[0][1]) - float(U1)) / abs(float(U1))
            if r_a > PM_RTOL or r_u > PM_RTOL:
                raise AssertionError(f"sharded PM ({box}): RMS acc {r_a:.3e}, U {r_u:.3e}")
            parts.append(f"{'box ' + str(box) if box else 'cube by pmin/pmax'}: RMS acc "
                         f"{r_a:.2e}, U {r_u:.2e}")
        cfg = self.ring_cfg(force_impl="pm", pm_grid=PM_GRID, pm_box=PM_BOX)
        st = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32", device=self.dev),
                            cfg)
        fin = ot.gather_state(mesh, ot.make_sharded_rollout(cfg, mesh, st, RING_STEPS)(
            ot.shard_state(mesh, st))[0])
        one, _ = ot.rollout(st, cfg, RING_STEPS)
        err = max_state_err(fin, one)
        if err > STATE_ATOL:
            raise AssertionError(f"sharded PM {RING_STEPS} steps vs one card: {err:.3e}")
        line1 = (f"sharded PM over {RING_P} ranks at N={N_MAIN}, grid {PM_GRID}, within "
                 f"{PM_RTOL:g} of the single-card PM: " + "; ".join(parts)
                 + f"; {RING_STEPS} KDK steps within {err:.2e} of the single card's")

        scene = SceneArrays(pos=pos, vel=vel, mass=mass, radius=np.full(N_MAIN, R_BENCH),
                            names=[f"b{i}" for i in range(N_MAIN)])
        kw = dict(steps=RING_STEPS, dt=DT, softening=EPS2 ** 0.5, device=self.dev,
                  precision="ds32", rescale=ot.Rescale.identity(), record_every=10)
        reset_launches()
        res = ot.simulate(scene, mesh=mesh, collisions="bounce", **kw)
        b3d, b1 = block_acc_detect_cuda.launches, pairwise_acc_cuda.launches
        ref = ot.simulate(scene, collisions="bounce", **kw)
        d = float(np.abs(res.pos - ref.pos).max())
        if d > STATE_ATOL or b3d != RING_P * RING_P * RING_STEPS or b1 != 1 \
                or res.final_state.n_bodies != N_MAIN:
            raise AssertionError(f"simulate(mesh=): {d:.3e} from one card, B3 detect {b3d}, "
                                 f"B1 {b1} launches")
        line2 = (f"simulate(mesh=make_mesh(({RING_P},), cuda:0), collisions='bounce') N="
                 f"{N_MAIN} ds32, {RING_STEPS} steps: records within {d:.2e} of simulate() on "
                 f"one card, B3 detect {b3d} launches, B1 {b1} (init_forces)")
        return line1, line2

    # phase 59
    def ring_nccl(self) -> str:
        import torch.distributed as dist

        import orbital_tpu_torch as ot

        torch = self.torch
        store = os.path.join(REPO_ROOT, "build", "ring_store")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        if os.path.exists(store):
            os.remove(store)
        pos, vel, mass, _ = self.cluster()
        cfg = self.ring_cfg(collisions="merge")
        st = ot.init_forces(self.torch_state(pos, vel, mass, R_RICH), cfg)
        local = self.ring_mesh(1)
        torch.cuda.set_device(self.dev)
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
        try:
            mesh = ot.make_mesh()
            if mesh.local or mesh.shape != {"body": 1} or mesh.device != self.dev:
                raise AssertionError(f"make_mesh() under NCCL: {mesh.shape}, {mesh.device}")
            runs = {}
            for key, m in (("nccl", mesh), ("one-card", local)):
                shards, traj = ot.make_sharded_rollout(cfg, m, st, RING_NCCL_STEPS,
                                                       record_every=RING_NCCL_STEPS)(
                    ot.shard_state(m, st))
                runs[key] = (ot.gather_state(m, shards), traj)
            torch.cuda.synchronize()
            secs = mesh.exchange_seconds()
        finally:
            dist.destroy_process_group()
            if os.path.exists(store):
                os.remove(store)
        (a, ta), (b, tb) = runs["nccl"], runs["one-card"]
        for f in ("pos", "pos_lo", "vel", "vel_lo", "mass", "radius", "alive", "acc",
                  "potential"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"NCCL world size 1: {f} differs from the one-card mesh")
        for f in ("pos", "vel", "energy", "alive"):
            if not torch.equal(getattr(ta, f), getattr(tb, f)):
                raise AssertionError(f"NCCL world size 1: records {f} differ")
        merged = int((st.alive & ~a.alive).sum())
        return (f"process-group mesh over NCCL, world size 1 (file:// store): merge "
                f"R={R_RICH:g} N={N_MAIN} ds32 {RING_NCCL_STEPS} steps ({merged} merged: the "
                f"gather, the psums and the records' gather through NCCL, "
                f"{1e3 * secs:.1f} ms in them) bit-equal to the one-card mesh; "
                f"{time.perf_counter() - t0:.1f} s with the group's set-up")

    # phase 60
    def ring_timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_collisions import bounce_block_cuda, bounce_block_plain
        from orbital_tpu_torch.ops.cuda_forces import (block_acc_cuda, block_acc_detect_cuda,
                                                       block_acc_detect_plain, block_acc_plain)

        torch = self.torch
        B = RING_B
        kw = dict(G=1.0, eps2=EPS2)
        rich = self.ring_shards(R_RICH)
        bench = self.ring_shards(R_BENCH)
        (pi, vi, mi, ri, ai), (pj, vj, mj, rj, aj) = bench[0], bench[1]
        _, _, c_rich = block_acc_detect_cuda(rich[0][0], rich[0][3], rich[0][4], 0, rich[1][0],
                                             rich[1][2], rich[1][3], rich[1][4], B, **kw)
        touching = int(c_rich)
        zero = torch.zeros((), dtype=torch.int32, device=self.dev)
        B8 = RING_B8
        (qi, _, _, si, bi), (qj, _, nj, sj, bj) = self.ring_shards(R_BENCH, ranks=RING_P8)[:2]
        kern = {k: summary(v) for k, v in alternate_ms({
            "B3": lambda: block_acc_cuda(pi, pj, mj, **kw),
            "B3D": lambda: block_acc_detect_cuda(pi, ri, ai, 0, pj, mj, rj, aj, B, **kw),
            "B3 8": lambda: block_acc_cuda(qi, qj, nj, **kw),
            "B3D 8": lambda: block_acc_detect_cuda(qi, si, bi, 0, qj, nj, sj, bj, B8, **kw),
            "BB": lambda: bounce_block_cuda(*rich[0], *rich[1], restitution=0.8,
                                            contacts=c_rich),
            "BB0": lambda: bounce_block_cuda(*rich[0], *rich[1], restitution=0.8,
                                             contacts=zero),
        }, 20).items()}
        plain = {
            "B3": summary(time_ms(lambda: block_acc_plain(pi, pj, mj, **kw), 1)),
            "B3D": summary(time_ms(lambda: block_acc_detect_plain(
                pi, ri, ai, 0, pj, mj, rj, aj, B, **kw), 1)),
            "BB": summary(time_ms(lambda: bounce_block_plain(
                *rich[0], *rich[1], restitution=0.8, contacts=c_rich), 1)),
        }
        pairs = B * B
        bounds = {
            "B3": bound(OPS_B1_PE * pairs, 16 * 2 * B + 16 * B, rsqrt=pairs),
            "B3D": bound((OPS_B1_PE + OPS_B2 - OPS_B1) * pairs, 20 * 2 * B + 16 * B + 4,
                         rsqrt=pairs),
            "B3 8": bound(OPS_B1_PE * B8 * B8, 16 * 2 * B8 + 16 * B8, rsqrt=B8 * B8),
            "B3D 8": bound((OPS_B1_PE + OPS_B2 - OPS_B1) * B8 * B8, 20 * 2 * B8 + 16 * B8 + 4,
                           rsqrt=B8 * B8),
            "BB": bound(OPS_B6 * pairs + OPS_B6_TOUCH * touching, 33 * 2 * B + 24 * B + 4),
        }
        bound_bb0 = bound(0.0, 24 * B + 4)
        for k in ("B3", "B3D", "BB"):
            self.kernels[k].update(ms=kern[k]["median"], plain_ms=plain[k]["median"],
                                   bound_ms=bounds[k][0], bound_by=bounds[k][1],
                                   library_ms=None)

        # the ring's step against the single card's, in turns
        pos, vel, mass, _ = self.cluster()
        cfg = self.ring_cfg(track_potential=False)
        st = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32", device=self.dev),
                            cfg)
        meshes = {p: self.ring_mesh(p) for p in RING_TIMED}
        shards = {p: ot.shard_state(m, st) for p, m in meshes.items()}
        rolls = {p: ot.make_sharded_rollout(cfg, m, st, 10) for p, m in meshes.items()}
        steps = {k: summary([t / 10 for t in v]) for k, v in alternate_ms({
            "one card": lambda: ot.rollout(st, cfg, 10, fused="never"),
            **{f"ring P={p}": (lambda p_: lambda: rolls[p_](shards[p_]))(p)
               for p in RING_TIMED}}, 1, repeats=3).items()}
        # one more run of 10 steps each: the host time to queue it, the time
        # a rank waited in the exchange, and the device's busy time
        exch, host, busy = {}, {}, {}
        for p, m in meshes.items():
            x0 = m.exchange_seconds()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rolls[p](shards[p])
            host[p] = 1e3 * (time.perf_counter() - t0) / 10
            torch.cuda.synchronize()
            exch[p] = 1e3 * (m.exchange_seconds() - x0) / p / 10
            dev = device_times(lambda: rolls[p](shards[p]))
            busy[p] = sum(v[1] for v in dev.values()) / 10 if dev else None
        # the bounce ring's step at the bench row (B3 detect and the gated
        # block bounce a round) in turns with one card's (B2 and the gated
        # B6), each one's host time and busy time
        cfg_b = self.ring_cfg(track_potential=False, collisions="bounce")
        st_b = ot.init_forces(self.torch_state(pos, vel, mass, R_BENCH), cfg_b)
        roll_b = ot.make_sharded_rollout(cfg_b, meshes[RING_P], st_b, 10)
        shard_b = ot.shard_state(meshes[RING_P], st_b)
        bounce_calls = {"one card": lambda: ot.rollout(st_b, cfg_b, 10, fused="never"),
                        f"ring P={RING_P}": lambda: roll_b(shard_b)}
        bounce = {k: summary([t / 10 for t in v])
                  for k, v in alternate_ms(bounce_calls, 1, repeats=3).items()}
        bounce_host = {k: summary([t / 10 for t in host_ms(f, 1, repeats=1)])
                       for k, f in bounce_calls.items()}
        bounce_busy = {}
        for k, f in bounce_calls.items():
            dev = device_times(f)
            bounce_busy[k] = sum(v[1] for v in dev.values()) / 10 if dev else None
        self.ring_perf.update(kernels_16384=kern, plain=plain, bounds_ms=bounds,
                              block_bounce_count0_bound_ms=bound_bb0, touching=touching,
                              step_ms=steps, exchange_host_ms_per_step_per_rank=exch,
                              host_ms_per_step=host, device_busy_ms_per_step=busy,
                              bounce_step_ms=bounce, bounce_host_ms=bounce_host,
                              bounce_busy_ms=bounce_busy)
        print("perf_ring " + json.dumps(self.ring_perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        return (f"at {B}x{B} (one ring round of N={N_MAIN} over {RING_P}): B3 {ms(kern['B3'])} "
                f"(bound {bounds['B3'][0]:.4f} ms, {bounds['B3'][1]}; plain "
                f"{ms(plain['B3'])}), B3 detect R={R_BENCH:g} {ms(kern['B3D'])} (bound "
                f"{bounds['B3D'][0]:.4f}; plain {ms(plain['B3D'])}); at {B8}x{B8} (8 ranks) B3 "
                f"{ms(kern['B3 8'])} (bound {bounds['B3 8'][0]:.4f}), B3 detect "
                f"{ms(kern['B3D 8'])} (bound {bounds['B3D 8'][0]:.4f}); block bounce "
                f"{touching} contacts {ms(kern['BB'])} (bound {bounds['BB'][0]:.4f}; plain "
                f"{ms(plain['BB'])}), at count 0 {ms(kern['BB0'])} (bound "
                f"{bound_bb0[0]:.5f}); KDK step ds32 N={N_MAIN} in turns: "
                + ", ".join(f"{k} {ms(v)}" for k, v in steps.items())
                + "; a step's host time to queue, a rank's wait in the exchange and the "
                "device's busy time (profiler): " + ", ".join(
                    f"P={p} {host[p]:.3f}, {exch[p]:.3f} and {fmt(busy[p], 3)} ms"
                    for p in RING_TIMED)
                + f"; the bounce step at R={R_BENCH:g} in turns (host, busy): " + ", ".join(
                    f"{k} {ms(v)} ({bounce_host[k]['median']:.3f}, {fmt(bounce_busy[k], 3)})"
                    for k, v in bounce.items()))

    # --- the multi-device paths, part two (ROADMAP A.15b) -----------------

    def p3m_ring_case(self, ranks: int = RING_P):
        """The P3M uniform row cut in ``ranks`` shards: each shard's
        short-range table on the pinned grid, its global ids, the wrapper's
        keywords (sigma and rcut^2 on the card, as the solver makes them),
        the capacity probed on the whole set, and the whole table."""
        import torch

        from orbital_tpu_torch.ops.p3m import _cell_grid, p3m_cell_table, p3m_max_occupancy

        pos, _, mass = self.p3m_uniform()
        p, m = self.t(pos), self.t(mass)
        alive = torch.ones(N_MAIN, dtype=torch.bool, device=self.dev)
        center, half = self.box_t(P3M_BOX)
        cap = self.p3m_capacity(p3m_max_occupancy(p, None, grid=P3M_GRID, box=(center, half)))
        gc = _cell_grid(P3M_GRID, 1.5, 4.5)
        sigma = 1.5 * (2.0 * half / P3M_GRID)
        b = N_MAIN // ranks
        kw = dict(gc=gc, n=b, G=1.0, sigma=sigma, rcut2=(4.5 * sigma) ** 2, eps2=EPS2)
        shards = [slice(r * b, (r + 1) * b) for r in range(ranks)]
        tabs = [p3m_cell_table(p[sl], m[sl], alive[sl], center, half, gc=gc, capacity=cap)
                for sl in shards]
        gids = [torch.arange(sl.start, sl.stop, device=self.dev) for sl in shards]
        whole = p3m_cell_table(p, m, alive, center, half, gc=gc, capacity=cap)
        return dict(pos=p, tabs=tabs, gids=gids, kw=kw, cap=cap, whole=whole, shards=shards)

    # phase 61
    def check_p3m_ring_kernel(self) -> str:
        from orbital_tpu_torch.ops import cuda_p3m
        from orbital_tpu_torch.ops.p3m import p3m_short_pair_plain

        torch, rel = self.torch, self.rel
        self.p3m_ring_perf = {}
        lines, absd = [], 0.0
        for ranks in (RING_P, RING_P8):
            c = self.p3m_ring_case(ranks)
            tabs, gids, kw = c["tabs"], c["gids"], c["kw"]
            b = kw["n"]

            def plain(i, j):
                return p3m_short_pair_plain(
                    tabs[i]["table"], tabs[i]["cell_pos"],
                    cuda_p3m._gid_table(tabs[i]["table"], gids[i], -2), tabs[j]["cell_pos"],
                    tabs[j]["cell_m"], cuda_p3m._gid_table(tabs[j]["table"], gids[j], -1), **kw)

            def pair(i, j):
                return cuda_p3m.p3m_short_pair_cuda(tabs[i], tabs[j], gids[i], gids[j], **kw)

            # each shard's view, built by its owner and held to the plain view;
            # a visitor's round reads what the ring ships of it
            views = [self.view_equal(f"P3M ring view {ranks} ranks, shard {r}", tabs[r],
                                     kw["gc"], b, gids[r]) for r in range(ranks)]
            shipped = [{k: v[k] for k in cuda_p3m.SHIPPED} for v in views]
            params = cuda_p3m.short_params(kw["sigma"], kw["rcut2"], self.dev)

            def round_(i, j, out=None):
                return cuda_p3m.p3m_short_round_cuda(
                    views[i], views[i] if i == j else shipped[j], out=out, params=params, **kw)

            errs = []
            for i, j in ((0, 0), (0, 1), (2, 3), (3, 0)):
                out, ref, rebuilt = round_(i, j), plain(i, j), pair(i, j)
                torch.cuda.synchronize()
                e = max(rel(o, r) for o, r in zip(out, ref))
                if e > SHORT_RTOL:
                    raise AssertionError(f"P3M two-table ({i}, {j}) at {b} a shard vs plain: "
                                         f"{e:.3e}")
                # the visitor's view shipped or built again by this rank: the
                # same bits (its order does not depend on who builds it)
                if not all(torch.equal(x, y) for x, y in zip(out, rebuilt)):
                    raise AssertionError(f"P3M round ({i}, {j}) at {b}: the shipped view's "
                                         f"sum differs from the rebuilt one's")
                errs.append(f"({i}, {j}) {e:.2e}")
                absd = max(absd, max(float((o - r).abs().max()) for o, r in zip(out, ref)))
            # shard 0's rounds against every shard add up to the single table's
            # sum; the rounds accumulate in place in round order
            w = c["whole"]
            one = cuda_p3m.p3m_short_cuda(w["table"], w["cell_pos"], w["cell_m"],
                                          count=w["count"], **dict(kw, n=N_MAIN))
            acc = None
            for j in range(ranks):
                acc = round_(0, j, acc)
            e_sum = max(rel(acc[k], one[k][:b]) for k in range(2))
            if e_sum > SHORT_RTOL:
                raise AssertionError(f"P3M rounds summed at {b} vs the single table: "
                                     f"{e_sum:.3e}")
            # a round's time with its views passed in (the ring's), the
            # diagonal one, the round building both views (the table form's
            # call), the plain version's, and the bound from the pairs the
            # round needs
            outs = (torch.zeros((b, 3), dtype=torch.float32, device=self.dev),
                    torch.zeros((b,), dtype=torch.float32, device=self.dev))
            t = {k: summary(v) for k, v in alternate_ms({
                "round": lambda: round_(0, 1, outs), "diagonal": lambda: round_(0, 0, outs),
                "views built": lambda: pair(0, 1)}, 20).items()}
            t_plain = summary(time_ms(lambda: plain(0, 1), 1))
            # the round's device time (profiler) and its host time a call
            dev_t = [v[1] for k_, v in device_times(lambda: round_(0, 1, outs)).items()
                     if "p3m_short_kernel" in k_]
            dev_round = sum(dev_t) if dev_t else "not measured"
            host_round = summary(host_ms(lambda: round_(0, 1, outs), 20))
            r2 = float(kw["rcut2"])
            needed = pairs_within(c["pos"][:b], c["pos"][b:2 * b], r2)
            kept = int(tabs[0]["count"].sum() + tabs[1]["count"].sum())
            nbytes = 24 * kept + 16 * b + 2 * 232 * kw["gc"] ** 3
            bnd = bound(OPS_SHORT * needed, nbytes, rsqrt=MUFU_SHORT * needed)
            shift = {"before": 25 * b, "after": sum(
                v.numel() * v.element_size() for v in shipped[1].values())}
            if ranks == RING_P:
                self.kernels["P3MR"].update(max_abs_err=absd, ms=t["round"]["median"],
                                            plain_ms=t_plain["median"], bound_ms=bnd[0],
                                            bound_by=bnd[1], library_ms=None)
            self.p3m_ring_perf[f"{ranks} ranks"] = dict(
                times=t, plain_ms=t_plain, device_ms=dev_round, host_ms=host_round,
                round_needed_pairs=needed, bound=bnd,
                shift_bytes=shift, slices=int(views[0]["nslices"][0]))
            lines.append(
                f"{ranks} ranks ({b} bodies a shard, capacity {c['cap']}, "
                f"{int(views[0]['nslices'][0])} slices in shard 0's view): vs plain "
                + ", ".join(errs) + f" <= {SHORT_RTOL:g}, shipped views' sums bit-equal to "
                f"rebuilt ones'; shard 0's {ranks} rounds summed vs the single-table sum "
                f"{e_sum:.2e}; a round {t['round']['median']:.4f} ms (spread "
                f"{t['round']['spread']:.4f}; device time {fmt(dev_round, 4)}, the wrapper's "
                f"host time {host_round['median']:.4f} a call), the diagonal one "
                f"{t['diagonal']['median']:.4f}, "
                f"building both views {t['views built']['median']:.4f}, plain "
                f"{t_plain['median']:.3f}; bound {bnd[0]:.4f} ms ({bnd[1]}; {needed:,} needed "
                f"pairs); a shift {shift['after']:,} bytes (the bodies it replaces "
                f"{shift['before']:,})")
        return ("the short range's two-table form at a round of the P3M row: "
                + "; ".join(lines))

    # phase 62
    def p3m_ring_main_path(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops import cuda_p3m
        from orbital_tpu_torch.ops.p3m import p3m_acc_potential, p3m_ring_force

        torch, rel = self.torch, self.rel
        c = self.p3m_ring_case()
        upos, uvel, umass = self.p3m_uniform()
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2, force_impl="p3m", pm_grid=P3M_GRID,
                           p3m_capacity=c["cap"], pm_box=P3M_BOX)
        mesh = self.ring_mesh(RING_P)
        p, m = c["pos"], self.t(umass)
        alive = torch.ones(N_MAIN, dtype=torch.bool, device=self.dev)
        box = self.box_t(P3M_BOX)
        kw = dict(G_grav=1.0, eps2=EPS2, grid=P3M_GRID, capacity=c["cap"], box=box)
        reset_launches()
        out = mesh.run(lambda comm, x, y, z: p3m_ring_force(x, y, z, comm=comm, **kw),
                       list(p.chunk(RING_P)), list(m.chunk(RING_P)),
                       list(alive.chunk(RING_P)))
        a = torch.cat([o[0] for o in out])
        pairs, orders = (cuda_p3m.p3m_short_round_cuda.launches,
                         cuda_p3m.p3m_short_view_cuda.launches)
        a1, U1, ov = p3m_acc_potential(p, m, alive, **kw)
        r_a, r_u = rel(a, a1), abs(float(out[0][1]) - float(U1)) / abs(float(U1))
        if r_a > P3M_RING_RTOL or r_u > RING_U_RTOL or int(ov):
            raise AssertionError(f"P3M ring vs one card: acc {r_a:.3e}, U {r_u:.3e}, "
                                 f"overflow {int(ov)}")
        # each rank builds its own view once: P view launches an evaluation
        if pairs != RING_P * RING_P or orders != RING_P:
            raise AssertionError(f"P3M ring: {pairs} two-table and {orders} view launches "
                                 f"an evaluation")
        # the pairs each rank's rounds need, against the single card's
        r2 = float(c["kw"]["rcut2"])
        mine = sum(pairs_within(p[:RING_B], p[sl], r2, same=r == 0)
                   for r, sl in enumerate(c["shards"]))
        total = pairs_within(p, p, r2, same=True)

        # the main path: 20 recorded steps against one card's, then the rest
        state = ot.init_forces(ot.make_state(upos, uvel, umass, precision="f32",
                                             device=self.dev), cfg)
        e0 = energy_f64(state)
        ref, _ = ot.rollout(state, cfg, RING_STEPS)
        reset_launches()
        roll = ot.make_sharded_rollout(cfg, mesh, state, RING_STEPS, record_every=10)
        shards, traj = roll(ot.shard_state(mesh, state))
        rec = ot.gather_state(mesh, shards)
        err = max_state_err(rec, ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards, _ = ot.make_sharded_rollout(cfg, mesh, rec, P3M_RING_STEPS - RING_STEPS)(shards)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / (P3M_RING_STEPS - RING_STEPS)
        fin = ot.gather_state(mesh, shards)
        launches = cuda_p3m.p3m_short_round_cuda.launches
        single = cuda_p3m.p3m_short_cuda.launches
        drift = abs((energy_f64(fin) - e0) / e0)
        if err > STATE_ATOL or tuple(traj.pos.shape) != (2, N_MAIN, 3):
            raise AssertionError(f"P3M ring {RING_STEPS} steps vs one card: {err:.3e}")
        if launches != RING_P * RING_P * P3M_RING_STEPS or single:
            raise AssertionError(f"P3M ring main path: {launches} two-table launches in "
                                 f"{P3M_RING_STEPS} steps, {single} single-table")
        if drift > P3M_DRIFT_BOUND or int(fin.step) != P3M_RING_STEPS:
            raise AssertionError(f"P3M ring |dE/E| = {drift:.3e} > {P3M_DRIFT_BOUND:g}")
        self.kernels["P3MR"]["launches"] = launches

        # a step in turns with one card, its host time and the busy time
        rolls = {"one card": lambda: ot.rollout(state, cfg, 5),
                 f"ring P={RING_P}": lambda: ot.make_sharded_rollout(cfg, mesh, state, 5)(
                     ot.shard_state(mesh, state))}
        steps = {k: summary([t / 5 for t in v])
                 for k, v in alternate_ms(rolls, 1, repeats=3).items()}
        host = {k: summary([t / 5 for t in host_ms(f, 1, repeats=1)]) for k, f in rolls.items()}
        busy = {}
        for k, f in rolls.items():
            dev = device_times(f)
            busy[k] = sum(v[1] for v in dev.values()) / 5 if dev else None
        self.p3m_ring_perf.update(step_ms=steps, host_ms=host, busy_ms=busy, wall_ms=wall,
                                  rank0_needed=mine, needed=total)
        print("perf_p3m_ring " + json.dumps(self.p3m_ring_perf, default=str), file=sys.stderr)
        return (f"P3M ring N={N_MAIN} uniform grid {P3M_GRID} capacity {c['cap']} over "
                f"{RING_P} one-card ranks: acc {r_a:.2e} <= {P3M_RING_RTOL:g}, U {r_u:.2e} of "
                f"the single card's; {pairs} two-table and {orders} view launches an "
                f"evaluation; rank 0's rounds need {mine:,} of the single card's {total:,} "
                f"pairs ({100 * mine / total:.1f}%); {RING_STEPS} recorded steps within "
                f"{err:.2e} of one card's, {P3M_RING_STEPS} in all, |dE/E| = {drift:.3e} <= "
                f"{P3M_DRIFT_BOUND:g} (one card: 3.931e-5 over 4,000 steps, phase 32); "
                f"{launches} two-table launches, 0 single-table; {wall:.3f} ms/step wall; "
                f"a step in turns: " + ", ".join(
                    f"{k} {v['median']:.3f} ms (host {host[k]['median']:.3f}, busy "
                    f"{fmt(busy[k], 3)})" for k, v in steps.items()))

    # phase 63
    def tree_ring(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.rollout import (_tree_kwargs, init_forces_staged,
                                                      rollout_staged)
        from orbital_tpu_torch.ops import cuda_tree
        from orbital_tpu_torch.ops.tree import tree_acc_potential, tree_sharded_force
        from orbital_tpu_torch.ops.tree_near_wl import clip_runs, tree_wl_budgets, wl_span

        torch, rel = self.torch, self.rel
        pos, vel, mass, budgets = self.plummer()
        t = self.tree_table(pos, mass, np.ones(N_MAIN, bool), TREE_LEVELS, 1, budgets)
        kw_b7 = dict(wl_entries=budgets[1], chunk=TREE_CHUNK, rj=TREE_RJ, ws=1, eps2=TREE_EPS2)
        spans = [wl_span(budgets[1], RING_P, r) for r in range(RING_P)]
        whole = cuda_tree.tree_near_cuda(t["pbods"], t["start_blk"], t["n_blk"], **kw_b7)
        parts = [cuda_tree.tree_near_part_cuda(t["pbods"], t["start_blk"], t["n_blk"],
                                               span=sp, **kw_b7) for sp in spans]
        e_sum = rel(sum(parts), whole)
        # each slice against its plain version, relative to the whole sweep's
        # scale (the last rank's span may hold only the padded tail)
        e_plain, absd, scale = 0.0, 0.0, float(whole.abs().max())
        for sp, out in zip(spans, parts):
            s, n = clip_runs(t["start_blk"], t["n_blk"], *sp)
            ref = cuda_tree.tree_near_plain(t["pbods"], s, n, **kw_b7)
            absd = max(absd, float((out - ref).abs().max()))
            e_plain = absd / scale
        if e_sum > NEAR_RTOL or e_plain > NEAR_RTOL:
            raise AssertionError(f"B7's slices: summed vs the whole sweep {e_sum:.3e}, each "
                                 f"vs its plain version {e_plain:.3e}")
        s0, n0 = clip_runs(t["start_blk"], t["n_blk"], *spans[0])
        w0 = tree_near_work(dict(t, start_blk=s0, n_blk=n0), N_MAIN, TREE_LEVELS, 1,
                            TREE_CHUNK, TREE_RJ)
        bnd = bound(OPS_TREE * w0["needed"], w0["nbytes"], rsqrt=w0["needed"])
        t_part = summary(time_ms(lambda: cuda_tree.tree_near_part_cuda(
            t["pbods"], t["start_blk"], t["n_blk"], span=spans[0], **kw_b7), 20))
        t_plain = summary(time_ms(lambda: cuda_tree.tree_near_plain(
            t["pbods"], s0, n0, **kw_b7), 1))
        self.kernels["B7S"].update(max_abs_err=absd, ms=t_part["median"],
                                   plain_ms=t_plain["median"], bound_ms=bnd[0],
                                   bound_by=bnd[1], library_ms=None)

        # the evaluation against one card's, and the main path
        cfg = self.tree_config(budgets)
        mesh = self.ring_mesh(RING_P)
        pt, mt = self.t(pos), self.t(mass)
        at = torch.ones(N_MAIN, dtype=torch.bool, device=self.dev)
        kw = _tree_kwargs(cfg, self.dev)
        out = mesh.run(lambda comm, x, y, z: tree_sharded_force(
            x, y, z, comm=comm, with_overflow=True, **kw),
            list(pt.chunk(RING_P)), list(mt.chunk(RING_P)), list(at.chunk(RING_P)))
        a = torch.cat([o[0] for o in out])
        a1, U1, ov1 = tree_acc_potential(pt, mt, at, **kw)
        r_a, r_u = rel(a, a1), abs(float(out[0][1]) - float(U1)) / abs(float(U1))
        if r_a > TREE_MODE_RTOL or r_u > TREE_MODE_RTOL or int(out[0][2]) or int(ov1):
            raise AssertionError(f"sharded tree vs one card: acc {r_a:.3e}, U {r_u:.3e}, "
                                 f"overflow {int(out[0][2])}")
        state = ot.init_forces(ot.make_state(pos, vel, mass, precision="f32", device=self.dev),
                               cfg)
        ref, _ = ot.rollout(state, cfg, TREE_RING_STEPS)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards, traj = ot.make_sharded_rollout(cfg, mesh, state, TREE_RING_STEPS,
                                               record_every=TREE_RING_STEPS // 2)(
            ot.shard_state(mesh, state))
        fin = ot.gather_state(mesh, shards)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / TREE_RING_STEPS
        part_l, whole_l = cuda_tree.tree_near_part_cuda.launches, cuda_tree.tree_near_cuda.launches
        err = max_state_err(fin, ref)
        if err > STATE_ATOL or part_l != RING_P * TREE_RING_STEPS or whole_l:
            raise AssertionError(f"sharded tree {TREE_RING_STEPS} steps: {err:.3e} from one "
                                 f"card, B7 slice {part_l}, B7 {whole_l} launches")
        self.kernels["B7S"]["launches"] = part_l

        # the staged route at TREE_STAGED_N, levels 8
        pos_b, vel_b, mass_b = make_plummer(TREE_STAGED_N, self.seed)
        b_big = tree_wl_budgets(pos_b, levels=TREE_BIG_LEVELS, ws=1, chunk=TREE_CHUNK,
                                rj=TREE_RJ)
        cfg_b = self.tree_config(b_big).replace(tree_levels=TREE_BIG_LEVELS)
        st_b = ot.make_state(pos_b, vel_b, mass_b, precision="f32", device=self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin_s, _, ov_s = rollout_staged(init_forces_staged(st_b, cfg_b, mesh=mesh), cfg_b,
                                        TREE_STAGED_STEPS, mesh=mesh)
        torch.cuda.synchronize()
        staged_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.dev) / 2 ** 30
        t0 = time.perf_counter()
        one_s, _, ov_1 = rollout_staged(init_forces_staged(st_b, cfg_b), cfg_b,
                                        TREE_STAGED_STEPS)
        torch.cuda.synchronize()
        one_s_t = time.perf_counter() - t0
        err_s = max_state_err(fin_s, one_s)
        if ov_s or ov_1 or err_s > STATE_ATOL:
            raise AssertionError(f"staged tree N={TREE_STAGED_N} over {RING_P} ranks: overflow "
                                 f"{ov_s} (one card {ov_1}), {err_s:.3e} from one card")
        return (f"B7's {RING_P} slices of bench_tree's worklist (Plummer {N_MAIN}, levels "
                f"{TREE_LEVELS}) summed vs the whole sweep {e_sum:.2e}, each vs its plain "
                f"version {e_plain:.2e} <= {NEAR_RTOL:g}; a slice {t_part['median']:.3f} ms "
                f"(spread {t_part['spread']:.3f}), plain {t_plain['median']:.3f}, bound "
                f"{bnd[0]:.4f} ({bnd[1]}; {w0['needed']:,} needed pairs); the sharded "
                f"evaluation vs one card's: acc {r_a:.2e}, U {r_u:.2e}, overflow 0; "
                f"{TREE_RING_STEPS} steps over {RING_P} ranks within {err:.2e} of one card's, "
                f"B7's slice {part_l} launches, B7 0; {wall:.3f} ms/step wall; staged route "
                f"N={TREE_STAGED_N} levels {TREE_BIG_LEVELS}: init + {TREE_STAGED_STEPS} steps "
                f"in {staged_s:.2f} s over {RING_P} ranks (one card {one_s_t:.2f} s), within "
                f"{err_s:.2e} of one card's, overflow 0, peak {peak:.1f} GiB allocated")

    # phase 64
    def respa_ring(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.engine.multirate import respa_rollout
        from orbital_tpu_torch.ops import cuda_neighbor as cn
        from orbital_tpu_torch.ops import neighbor as nb
        from orbital_tpu_torch.ops.cuda_forces import block_acc_cuda, pairwise_acc_cuda

        torch, rel = self.torch, self.rel
        pos, vel, mass, E0 = self.cluster()
        cfg = self.respa_config()
        state = ot.init_forces(ot.make_state(pos, vel, mass, precision="ds32",
                                             device=self.dev), cfg)
        # the near sweep of each rank's chunks against its plain version and
        # against the unsliced kernel sweep
        m, k_ch, w_blk, _ = self.respa_budgets()
        geom = nb.neighbor_geometry(state.pos, state.alive, cell=CELL_RESPA, m_grid=m,
                                    chunk=32, max_chunks=k_ch, w_blk=w_blk, rj=4)
        n_slots = (k_ch + 4) * 32
        ch = [nb.pack_slots(geom["slot"], state.pos[:, k].contiguous(), n_slots,
                            nb.SENTINEL_POS) for k in range(3)]
        ch.append(nb.pack_slots(geom["slot"], state.mass, n_slots, 0.0))
        kw = dict(r1=0.5 * RC_RESPA, rc=RC_RESPA, G=1.0, eps2=EPS2, chunk=32, rj=4)
        kd = k_ch // RING_P
        full = cn.near_acc_slots_cuda(*ch, geom["jbl"], **kw)
        # each rank's rows against the plain version's, relative to the whole
        # sweep's scale (the budget's headroom leaves the last ranks' chunks
        # empty or nearly)
        parts, e_plain, absd = [], 0.0, 0.0
        scale = [float(f.abs().max()) for f in full]
        for r in range(RING_P):
            jbl = geom["jbl"][r * kd:(r + 1) * kd]
            out = cn.near_acc_slots_rows_cuda(*ch, jbl, i0=r * kd, **kw)
            ref = nb.near_acc_slots(*ch, jbl, i0=r * kd, **kw)
            d = [float((o - q).abs().max()) for o, q in zip(out, ref)]
            e_plain = max(e_plain, max(x / sc for x, sc in zip(d, scale)))
            absd = max(absd, max(d))
            parts.append(out)
        same = all(torch.equal(torch.cat([o[k] for o in parts]), full[k]) for k in range(2))
        if e_plain > NEAR_RTOL or not same:
            raise AssertionError(f"the near sweep with i0: vs plain {e_plain:.3e}, the ranks' "
                                 f"rows {'' if same else 'not '}bit-equal to the whole sweep")
        jbl0 = geom["jbl"][:kd]
        w0 = near_work(dict(geom, jbl=jbl0), ch, RC_RESPA, 32, 4)
        bnd = bound(OPS_NEAR * w0["needed"], w0["nbytes"], rsqrt=w0["needed"])
        t_rows = summary(time_ms(lambda: cn.near_acc_slots_rows_cuda(*ch, jbl0, i0=0, **kw),
                                 50))
        t_plain = summary(time_ms(lambda: nb.near_acc_slots(*ch, jbl0, i0=0, **kw), 1))
        self.kernels["NEARI"].update(max_abs_err=absd, ms=t_rows["median"],
                                     plain_ms=t_plain["median"], bound_ms=bnd[0],
                                     bound_by=bnd[1], library_ms=None)

        # the main path: a few windows against one card's, then the drift
        mesh = self.ring_mesh(RING_P)
        steps = RESPA_RING_WINDOWS * RESPA_K
        one, _, _ = respa_rollout(state, cfg, steps)
        reset_launches()
        roll = ot.make_sharded_respa_rollout(cfg, mesh, state, steps, record_every=steps)
        shards, traj, diag = roll(ot.shard_state(mesh, state))
        rows_l, b3, b1 = (cn.near_acc_slots_rows_cuda.launches, block_acc_cuda.launches,
                          pairwise_acc_cuda.launches)
        rec = ot.gather_state(mesh, shards)
        err = max_state_err(rec, one)
        counters = {k: int(v) for k, v in diag.items()}
        if err > STATE_ATOL or any(counters.values()) or tuple(traj.pos.shape) != (
                1, N_MAIN, 3):
            raise AssertionError(f"sharded RESPA {RESPA_RING_WINDOWS} windows: {err:.3e} from "
                                 f"one card, counters {counters}")
        if (rows_l != RING_P * (RESPA_K + 1) * RESPA_RING_WINDOWS or b1
                or b3 != RING_P * RING_P * RESPA_RING_WINDOWS):
            raise AssertionError(f"sharded RESPA: near sweep rows {rows_l}, B3 {b3}, B1 {b1} "
                                 f"launches in {RESPA_RING_WINDOWS} windows")
        self.kernels["NEARI"]["launches"] = rows_l
        drift_steps = RESPA_RING_DRIFT_WINDOWS * RESPA_K
        cfg_d = cfg.replace(track_potential=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards, _, diag2 = ot.make_sharded_respa_rollout(cfg_d, mesh, rec, drift_steps)(shards)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / drift_steps
        drift = abs((energy_f64(ot.gather_state(mesh, shards)) - E0) / E0)
        if any(int(v) for v in diag2.values()) or drift > DRIFT_BUDGET:
            raise AssertionError(f"sharded RESPA drift {drift:.3e}, counters "
                                 f"{ {k: int(v) for k, v in diag2.items()} }")
        rolls = {"one card": lambda: respa_rollout(state, cfg_d, 2 * RESPA_K),
                 f"mesh P={RING_P}": lambda: ot.make_sharded_respa_rollout(
                     cfg_d, mesh, state, 2 * RESPA_K)(ot.shard_state(mesh, state))}
        sub = {k: summary([t / (2 * RESPA_K) for t in v])
               for k, v in alternate_ms(rolls, 1, repeats=3).items()}
        return (f"the near sweep of each of {RING_P} ranks' {kd} chunks (i0) at the RESPA "
                f"row's geometry vs its plain version {e_plain:.2e} <= {NEAR_RTOL:g}, the "
                f"ranks' rows bit-equal to the whole sweep; rank 0's {t_rows['median']:.3f} ms "
                f"(spread {t_rows['spread']:.3f}), plain {t_plain['median']:.3f}, bound "
                f"{bnd[0]:.4f} ({bnd[1]}; {w0['needed']:,} needed pairs); "
                f"make_sharded_respa_rollout K={RESPA_K} over {RING_P} ranks: "
                f"{RESPA_RING_WINDOWS} windows within {err:.2e} of one card's, counters 0, "
                f"near sweep rows {rows_l} and B3 {b3} launches, B1 0; "
                f"{RESPA_RING_DRIFT_WINDOWS} windows more, |dE/E| = {drift:.3e} <= "
                f"{DRIFT_BUDGET:g} (f64), {wall:.3f} ms a substep wall; a substep in turns: "
                + ", ".join(f"{k} {v['median']:.3f} ms" for k, v in sub.items()))

    # phase 65
    def ensemble_mesh(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_collisions import bounce_block_cuda
        from orbital_tpu_torch.ops.cuda_forces import block_acc_cuda
        from orbital_tpu_torch.parallel.ensemble import _member, _stack

        torch = self.torch
        E, n = ENS_MESH_E, ENS_MESH_N
        pos, vel, mass = make_cluster(n, self.seed + 65)
        rng = np.random.default_rng(self.seed + 66)
        mesh = ot.make_mesh(shape=ENS_MESH_SHAPE, axis_names=("ensemble", "body"),
                            devices=self.dev)
        lines = []
        for mode in ("bounce", "merge"):
            cfg = self.ring_cfg(collisions=mode, restitution=0.8)
            members = [ot.init_forces(ot.make_state(
                pos + ENS_MESH_SIGMA * rng.normal(size=pos.shape), vel, mass,
                np.full(n, ENS_MESH_R), precision="ds32", device=self.dev),
                cfg.replace(force_impl="dense", collisions="none")) for _ in range(E)]
            batched = _stack(members)
            reset_launches()
            step, place = ot.make_sharded_ensemble_step(cfg, mesh, batched)
            shards = place(batched)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ENS_MESH_STEPS):
                shards = step(shards)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / ENS_MESH_STEPS
            b3, bb = block_acc_cuda.launches, bounce_block_cuda.launches
            out = ot.gather_ensemble(mesh, shards)
            p_b = ENS_MESH_SHAPE[1]
            want = E * p_b * p_b * ENS_MESH_STEPS
            if b3 != want or (mode == "bounce" and bb != want):
                raise AssertionError(f"ensemble mesh {mode}: B3 {b3}, block bounce {bb} "
                                     f"launches, {want} expected")
            errs, dead = [], []
            for e in range(E):
                one, _ = ot.rollout(members[e], cfg, ENS_MESH_STEPS, fused="never")
                got = _member(out, e)
                if not torch.equal(got.alive, one.alive):
                    raise AssertionError(f"ensemble mesh {mode}: member {e}'s alive differs "
                                         f"from its single-card run")
                # live bodies only: a merged body is parked far, where the
                # mesh's merge (every step, as under JAX's vmap) and the
                # single card's (on contact steps) park it apart
                live = got.alive
                errs.append(max(float((getattr(got, f)()[live].double()
                                       - getattr(one, f)()[live].double()).abs().max())
                                for f in ("pos_full", "vel_full")))
                dead.append(int((~got.alive).sum()))
            if max(errs) > STATE_ATOL or (mode == "merge" and not any(dead)):
                raise AssertionError(f"ensemble mesh {mode}: members {errs} from one card, "
                                     f"merged {dead}")
            lines.append(f"{mode}: members within {max(errs):.2e} of their single-card runs"
                         + (f", merged {dead}" if mode == "merge" else "")
                         + f"; B3 {b3}" + (f", block bounce {bb}" if mode == "bounce" else "")
                         + f" launches; {wall:.3f} ms a step wall")
        return (f"(ensemble x body) mesh {ENS_MESH_SHAPE} of one-card ranks, {E} members of "
                f"the {n}-body cluster (positions perturbed by {ENS_MESH_SIGMA:g}), ds32, "
                f"R={ENS_MESH_R:g}, {ENS_MESH_STEPS} steps: " + " | ".join(lines))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--drift-steps", type=int, default=1000,
                        help="unrecorded steps of the 65,536-body drift run")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", metavar="DIR",
                        help="only hold B1, B2, B3, B5, B5 detect, the B5 subset, B13, B6, "
                             "B12, B7, the near sweep, B4, the P3M short range, the root "
                             "search and the ensemble kernel against DIR's kernel sources "
                             "(phases 1, 2 and this check)")
    parser.add_argument("--sweep", action="store_true",
                        help="only build and time the launch shapes of SWEEP (phases 1, 2 "
                             "and the sweep; with --parent, the parent check after it)")
    parser.add_argument("--ring-variants", action="store_true",
                        help="only build and time the ring kernels' launch shapes of "
                             "RING_VARIANTS (phases 1, 2 and this check)")
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
        ("41 ensemble kernel", smoke.check_ensemble),
        ("42 ensemble main path", smoke.ensemble_main_path),
        ("43 ensemble timings", smoke.ensemble_timings),
        ("44 facade main path", smoke.facade_main_path),
        ("45 viewer backend", smoke.viewer_backend),
        ("46 cli", smoke.cli_simulate),
        ("47 fitting", smoke.fitting),
        ("48 tree near modes", smoke.tree_modes),
        ("49 tree options", smoke.tree_options),
        ("50 compat core", smoke.compat_core),
        ("51 ring kernels", smoke.check_ring_kernels),
        ("52 ring force", smoke.check_ring_force),
        ("53 ring main path", smoke.ring_main_path),
        ("54+55+56 ring collisions", smoke.ring_collisions),
        ("57+58 ring pm simulate", smoke.ring_pm_simulate),
        ("59 ring nccl", smoke.ring_nccl),
        ("60 ring timings", smoke.ring_timings),
        ("61 p3m ring kernel", smoke.check_p3m_ring_kernel),
        ("62 p3m ring", smoke.p3m_ring_main_path),
        ("63 sharded tree", smoke.tree_ring),
        ("64 sharded respa", smoke.respa_ring),
        ("65 ensemble mesh", smoke.ensemble_mesh),
    ]
    if args.sweep or args.parent or args.ring_variants:
        phases = phases[:2] + ([("sweep", smoke.sweep)] if args.sweep else []) + (
            [("parent", lambda: smoke.check_parent(args.parent))] if args.parent else []) + (
            [("ring variants", smoke.ring_variants)] if args.ring_variants else [])
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

    if not (args.sweep or args.parent or args.ring_variants):
        print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
