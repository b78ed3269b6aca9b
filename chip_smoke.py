#!/usr/bin/env python3
"""Drive the PyTorch port (``orbital_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--drift-steps 1000] [--seed 0]

Phases, one line of output each; any failure exits nonzero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``orbital_tpu_torch/csrc``, one nvcc per
     source, all at once;
  3. the force kernel (B1) against its plain PyTorch version at N = 65536
     and a ragged N = 5000, PE on/off, eps2 > 0 and = 0, and the ds32 step
     at N = 8192 against the same step on plain forces;
  4. the fused-rollout kernel (B4) against the plain KDK loop at N = 4096
     (ds32 and f32, with dead padding bodies) and N = 32768;
  5. the main path: the 65,536-body virialised ds32 cluster through
     ``init_forces`` -> a recorded ``rollout`` -> an unrecorded ``rollout``,
     with the energy drift measured in f64 (kinetic on the host, potential
     from the C++ oracle in ``native/``) against |dE/E| <= 1e-6;
  6. an unrecorded N = 4096 rollout, which routes to the fused kernel;
  7. the detecting force kernel (B2) against its plain version (chunked
     forces plus the chunked contact count) at N = 65536 and 5000 with dead
     bodies parked far, and against B1 bit for bit;
  8. the bounce kernel (B6) against its plain version at N = 65536 on the
     contact-rich cluster, and its skip on a zero count;
  9. the collision main path, bench row: the same cluster with radius 1e-4
     and ``collisions="bounce"`` through ``init_forces`` -> a recorded and an
     unrecorded ``rollout``: no contacts, the drift budget, and a final state
     bit-equal to the collision-free run;
 10. the collision main path, contact-rich: radius 3e-3, restitution 0.8,
     200 steps, and the first 10 steps against the plain forces, counts and
     bounce sweep;
 11. kernel and plain times (CUDA events, median and spread of 3 repeats);
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
     against the f64 sum too;
 19. the multirate (RESPA) main path: the same cluster with the bench's
     configuration (rc = 5 eps, cell = 2 rc, K = 4, refresh every 4 macro
     windows) through ``init_forces`` -> a recorded and an unrecorded
     ``respa_rollout``: zero overflow and skin counters, |dE/E| <= 1e-6 in
     f64, three macro steps on the kernel against the plain sweep, and
     with bounce collisions (refresh 1) bit-equal to a collision-free run
     up to the first contact;
 20. near kernel, geometry, pack/unpack, macro-step and per-substep times at
     K = 4 and K = 5 against the KDK step.

The launch counters are set to 0 just before each main path (phases 5+6, 9,
10, 13, 14, 15, 16 and 19) and read just after it: each kernel must have
run on its path. The line before the last is a JSON summary of the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
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
           replaces="orbital_tpu/ops/pallas_jerk.py:175")
B5S = dict(name="nbody_jerk_subset", route="cuda",
           source="orbital_tpu_torch/csrc/nbody_jerk.cu",
           replaces="orbital_tpu/ops/pallas_jerk.py:52")
# one kernel for the four TPU schedules B8 (:165), B9 (:286), B10 (:394) and
# B11 (:80); the record names B8's
NEAR = dict(name="near_sweep", route="cuda", source="orbital_tpu_torch/csrc/neighbor.cu",
            replaces="orbital_tpu/ops/neighbor_pallas.py:165")


def bound(flops: float, nbytes: float, rsqrt: float = 0.0) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    t_ops = max(flops / PEAK_F32, rsqrt / PEAK_RSQRT)
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
    from orbital_tpu_torch.ops import (cuda_collisions, cuda_forces, cuda_jerk, cuda_neighbor,
                                       fused_rollout)

    for fn in (cuda_forces.pairwise_acc_cuda, cuda_forces.pairwise_acc_detect_cuda,
               fused_rollout.fused_rollout, cuda_collisions.bounce_deltas_cuda,
               cuda_jerk.accel_jerk_cuda, cuda_jerk.accel_jerk_detect_cuda,
               cuda_jerk.accel_jerk_subset_cuda, cuda_neighbor.near_acc_slots_cuda):
        fn.launches = 0


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
                        "NEAR": dict(NEAR)}
        self._cluster = None
        self._respa_budgets = None
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
        from orbital_tpu_torch.ops import (cuda_collisions, cuda_forces, cuda_jerk,
                                           cuda_neighbor, fused_rollout)
        from orbital_tpu_torch.utils import kernels

        names = kernels.SOURCES
        t0 = time.perf_counter()
        kernels.build(names)
        for mod in (cuda_forces, fused_rollout, cuda_collisions, cuda_jerk, cuda_neighbor):
            mod._load()
        total = time.perf_counter() - t0
        for name in names:
            for line in kernels.build_log(name).splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)
        each = ", ".join(f"{n} {kernels.build_seconds(n):.2f} s" for n in names)
        return f"built {each} in parallel (load total {total:.2f} s) for sm_90a"

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
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.fused_rollout import fused_rollout, fused_rollout_plain

        lines = []
        for n, live, precision in ((4096, 4000, "ds32"), (4096, 4000, "f32"),
                                   (32768, 32768, "ds32")):
            rng = np.random.default_rng(self.seed + 3)
            pos = rng.normal(size=(live, 3))
            vel = rng.normal(size=(live, 3)) * 0.3
            mass = rng.uniform(0.5, 1.5, live) / live
            cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2)
            st = ot.make_state(pos, vel, mass, precision=precision, pad_to=n,
                               device=self.dev)
            out = fused_rollout(st, cfg, 10)
            ref = fused_rollout_plain(st, cfg, 10)
            self.torch.cuda.synchronize()
            err = max_state_err(out, ref)
            if not bool(self.torch.isfinite(out.pos).all()) or err > STATE_ATOL:
                raise AssertionError(f"B4 vs plain N={n} {precision}: max diff {err:.3e}")
            if int(out.step) != 10 or abs(float(out.time) - 10 * DT) > 1e-9:
                raise AssertionError("B4 clock not advanced by 10 steps")
            if precision == "ds32" and n == 32768:
                self.kernels["B4"]["max_abs_err"] = err
            lines.append(f"N={n} ({live} live) {precision}: {err:.2e}")
        return (f"B4 == plain KDK loop over 10 steps within {STATE_ATOL:g} "
                f"[{'; '.join(lines)}]")

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

    def scene(self, n: int, radius: float, dead: int, seed_offset: int):
        """Cluster positions and velocities with radii in [R/2, 3R/2] and
        ``dead`` bodies at the end, parked far as make_state parks padding:
        f32 tensors (pos, vel, mass, radius, alive) on the card."""
        from orbital_tpu_torch.engine.state import far_positions

        torch = self.torch
        rng = np.random.default_rng(self.seed + seed_offset)
        if n == N_MAIN:
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

        pos, vel, mass, rad, alive = self.scene(N_MAIN, R_RICH, 7, seed_offset=5)
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
        touched = int((dv0.abs().amax(1) > 0).sum())
        if int(count) <= 0 or touched == 0:
            raise AssertionError(f"no contacts in the contact-rich scene ({int(count)})")
        err_v = float((dv - dv0).abs().max())
        err_p = float((dp - dp0).abs().max())
        rel_v, rel_p = err_v / float(dv0.abs().max()), err_p / float(dp0.abs().max())
        if rel_v > BOUNCE_RTOL or rel_p > BOUNCE_RTOL:
            raise AssertionError(f"B6 vs plain: max|d dv|/max|dv| = {rel_v:.3e}, "
                                 f"max|d dp|/max|dp| = {rel_p:.3e}")
        dead = ~alive
        if bool(dv[dead].any()) or bool(dp[dead].any()):
            raise AssertionError("B6 dead rows not exactly 0")
        m = mass.double()[:, None]
        p_sum = float((m * dv.double()).sum(0).abs().max())
        p_abs = float((m * dv.double().abs()).sum())
        if p_sum > 1e-5 * p_abs:
            raise AssertionError(f"B6 momentum: |sum m dv| = {p_sum:.3e} against "
                                 f"sum m |dv| = {p_abs:.3e}")
        if not (torch.equal(dv_c, dv) and torch.equal(dp_c, dp)):
            raise AssertionError("B6 gated on a count > 0 differs from the ungated sweep")
        if bool(dv_z.any()) or bool(dp_z.any()):
            raise AssertionError("B6 with a zero count is not exactly 0")
        self.kernels["B6"]["max_abs_err"] = err_v
        return (f"B6 == plain at N={N_MAIN} R={R_RICH:g} e=0.8 ({int(count)} contacts, "
                f"{touched} bodies bounced): max|d dv|/max|dv| = {rel_v:.2e}, "
                f"max|d dp|/max|dp| = {rel_p:.2e} <= {BOUNCE_RTOL:g}; dead rows 0; "
                f"|sum m dv| / sum m|dv| = {p_sum / p_abs:.2e}; zero count -> exact zeros")

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

        # per step, each run including its one seeding force sweep
        fused = {}
        for n_f, k_steps, p_steps in ((4096, 200, 50), (32768, 20, 10)):
            st_f, cfg_f = stepper("auto", n_f)
            kern = summary([t / k_steps for t in time_ms(
                lambda: fused_rollout(st_f, cfg_f, k_steps), 1)])
            plain = summary([t / p_steps for t in time_ms(
                lambda: fused_rollout_plain(st_f, cfg_f, p_steps), 1)])
            fused[n_f] = (kern, plain)

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

        n_f = 4096
        state_bytes = (12 + 2) * 4 * n_f + 12 * 4 * n_f  # read once, written once a launch
        bounds = {
            "B1": bound(OPS_B1 * n * n, 32 * n, rsqrt=n * n),
            "B2": bound(OPS_B2 * n * n, 36 * n + 4, rsqrt=n * n),
            "B4": bound(OPS_B1 * n_f * n_f, state_bytes / 200, rsqrt=n_f * n_f),
            "B6": bound(OPS_B6 * n * n + OPS_B6_TOUCH * touching, 57 * n + 4),
        }
        bound_b6_zero = bound(0.0, 24 * n + 4)
        timed = {"B1": (b1, b1p), "B2": (b2, b2p), "B4": fused[4096], "B6": (b6, b6p)}
        for k, (kern, plain) in timed.items():
            self.kernels[k].update(ms=kern["median"], plain_ms=plain["median"],
                                   bound_ms=bounds[k][0], bound_by=bounds[k][1],
                                   library_ms=None)
        self.perf = {"B1_nope_N65536": (b1, b1p), "B1_pe_N65536": b1pe,
                     "ds32_step_N65536": (step_k, step_p), "B4_N4096": fused[4096],
                     "B4_N32768": fused[32768], "B2_nope_N65536": (b2, b2p),
                     "B6_N65536_contacts": (b6, b6p), "B6_N65536_count0": b6z,
                     "B6_bound_count0_ms": bound_b6_zero[0], "B6_touching": touching,
                     "ds32_step_N65536_none_vs_bounce": (armed["none"], armed["bounce"]),
                     "bounds_ms": bounds}
        print("perf " + json.dumps(self.perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        return (f"B1 N=65536 no-PE {ms(b1)} vs plain {ms(b1p)}; PE {ms(b1pe)}; "
                f"ds32 step N=65536 {step_k['median']:.3f} vs plain "
                f"{step_p['median']:.3f} ms/step; B4 N=4096 {ms(fused[4096][0])}/step vs "
                f"plain {ms(fused[4096][1])}/step; B4 N=32768 {ms(fused[32768][0])}/step "
                f"vs plain {ms(fused[32768][1])}/step; B2 N=65536 no-PE {ms(b2)} vs plain "
                f"{ms(b2p)}; B6 N=65536 {touching} contacts {ms(b6)}, count 0 {ms(b6z)}, "
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
        as the bench probes them (bench.py:282-285)."""
        if self._respa_budgets is None:
            from orbital_tpu_torch.ops.neighbor import neighbor_budgets

            pos, _, _, _ = self.cluster()
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
        from orbital_tpu_torch.engine.state import far_positions
        from orbital_tpu_torch.ops import cuda_neighbor as cn
        from orbital_tpu_torch.ops import neighbor as nb
        from orbital_tpu_torch.utils import kernels

        torch = self.torch
        kw = dict(r1=0.5 * RC_RESPA, rc=RC_RESPA, G=1.0, eps2=EPS2, chunk=32, rj=4)

        def rel(x, ref):
            return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())

        pos, _, mass, _ = self.cluster()
        budgets = self.respa_budgets()
        rng = np.random.default_rng(self.seed + 9)
        pos_r = rng.normal(size=(N_NEAR_RAGGED, 3)) * NEAR_RAGGED_SCALE
        alive_r = np.ones(N_NEAR_RAGGED, bool)
        alive_r[-7:] = False
        pos_r[-7:] = far_positions(7, float(np.abs(pos_r).max()), np.float32,
                                   start=N_NEAR_RAGGED - 7)
        mass_r = np.full(N_NEAR_RAGGED, 1.0 / N_NEAR_RAGGED)
        m_r, k_r, w_r, q_r = nb.neighbor_budgets(pos_r, alive_r, cell=CELL_RESPA, chunk=32,
                                                 rj=4, with_wl=True)
        starved = (m_r, max(4, (k_r // 2) // 4 * 4), max(1, w_r // 3), max(8, q_r // 3))
        lines, vs64 = [], {}
        for name, (p_, m_, a_, b_) in (
                (f"N={N_MAIN}", (pos, mass, np.ones(N_MAIN, bool), budgets)),
                (f"N={N_NEAR_RAGGED} starved", (pos_r, mass_r, alive_r, starved))):
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

        live = int((geom_wl["jbl"] != cfg.respa_max_chunks // 4).sum())
        pairs = live * 128 * 32
        k_ch, w_blk = geom_wl["jbl"].shape
        nbytes = 16 * n_slots + 4 * k_ch * w_blk + 4 * k_ch + 16 * k_ch * 32
        bnd = bound(OPS_NEAR * pairs, nbytes, rsqrt=pairs)
        self.kernels["NEAR"].update(ms=near["median"], plain_ms=near_p["median"],
                                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        ratio = {k: sub["kdk"]["median"] / sub[k]["median"] for k in ("K4", "K5")}
        perf = {"near_N65536": (near, near_p), "near_wl_N65536": near_wl,
                "near_pairs": pairs, "near_bound_ms": bnd, "geometry_build": build,
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
        return (f"near kernel N={n} {ms(near)} (worklist {ms(near_wl)}) vs plain "
                f"{ms(near_p)}, {pairs} pairs, bound {bnd[0]:.4f} ms ({bnd[1]}, "
                f"{100 * bnd[0] / near['median']:.0f}%); geometry build {ms(build)}; "
                f"pack+unpack of 5 tables {ms(packs)}; one macro step K=4 {ms(one_macro)}; "
                f"per substep K=4 refresh 4 {ms(sub['K4'])}, K=5 refresh 3 {ms(sub['K5'])}; "
                f"KDK step {ms(sub['kdk'])}: KDK/substep {ratio['K4']:.2f}x (K=4), "
                f"{ratio['K5']:.2f}x (K=5); {profiled}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--drift-steps", type=int, default=1000,
                        help="unrecorded steps of the 65,536-body drift run")
    parser.add_argument("--seed", type=int, default=0)
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
    ]
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

    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
