#!/usr/bin/env python3
"""Drive the PyTorch port (``orbital_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--drift-steps 1000] [--seed 0]

Phases, one line of output each; any failure exits nonzero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``orbital_tpu_torch/csrc`` with nvcc;
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
  7. kernel and plain times (CUDA events, median and spread of 3 repeats).

The launch counters of both kernels are reset before phase 5 and read after
phase 6: each kernel must have run on the main path. The line before the
last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
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
ENERGY_RTOL = 1e-5
# positions / velocities after 10 KDK steps whose forces differ only in f32
# summation order (the tolerance of the JAX package's own fused-rollout test)
STATE_ATOL = 1e-6

B1 = dict(name="nbody_forces", route="cuda",
          source="orbital_tpu_torch/csrc/nbody_forces.cu",
          replaces="orbital_tpu/ops/pallas_forces.py:55")
B4 = dict(name="fused_kdk", route="cuda",
          source="orbital_tpu_torch/csrc/fused_rollout.cu",
          replaces="orbital_tpu/ops/fused_rollout.py:54")


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
        self.kernels = {"B1": dict(B1), "B4": dict(B4)}

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
        from orbital_tpu_torch.ops import cuda_forces, fused_rollout
        from orbital_tpu_torch.utils import kernels

        t0 = time.perf_counter()
        cuda_forces._load()
        fused_rollout._load()
        total = time.perf_counter() - t0
        for name in ("nbody_forces", "fused_rollout"):
            for line in kernels.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)
        return (f"built nbody_forces in {kernels.build_seconds('nbody_forces'):.2f} s, "
                f"fused_rollout in {kernels.build_seconds('fused_rollout'):.2f} s "
                f"(load total {total:.2f} s) for sm_90a")

    # phase 3
    def check_forces(self) -> str:
        torch = self.torch
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda, pairwise_acc_plain

        rng = np.random.default_rng(self.seed + 1)
        worst = {}
        for n in (65536, 5000):
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
                    if n == 65536 and eps2 > 0 and not pe:
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
        n = 65536
        pos, vel, mass = make_cluster(n, self.seed)
        cfg = ot.SimConfig(dt=DT, G=1.0, eps2=EPS2)
        state = ot.make_state(pos, vel, mass, precision="ds32", device=self.dev)
        small = make_cluster(4096, self.seed)
        state_small = ot.make_state(*small, precision="ds32", device=self.dev)

        pairwise_acc_cuda.launches = 0
        fused_rollout.launches = 0

        state = ot.init_forces(state, cfg)
        E0 = energy_f64(state)
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
        line5 = (f"N=65536 ds32: init_forces + 20 recorded + {self.drift_steps} unrecorded "
                 f"steps, |dE/E| = {drift:.3e} <= {DRIFT_BUDGET:g} (f64, {native.backend()}); "
                 f"{ms_per_step:.3f} ms/step wall; B1 launches {b1_main}")
        line6 = (f"N=4096 ds32 unrecorded 1000 steps: |dE/E| = {drift_small:.3e}; "
                 f"B4 launches {fused_rollout.launches}")
        return line5, line6

    # phase 7
    def timings(self) -> str:
        import orbital_tpu_torch as ot
        from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda, pairwise_acc_plain
        from orbital_tpu_torch.ops.fused_rollout import fused_rollout, fused_rollout_plain

        torch = self.torch
        rng = np.random.default_rng(self.seed + 4)
        n = 65536
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

        self.kernels["B1"].update(ms=b1["median"], plain_ms=b1p["median"])
        self.kernels["B4"].update(ms=fused[4096][0]["median"],
                                  plain_ms=fused[4096][1]["median"])
        self.perf = {"B1_nope_N65536": (b1, b1p), "B1_pe_N65536": b1pe,
                     "ds32_step_N65536": (step_k, step_p), "B4_N4096": fused[4096],
                     "B4_N32768": fused[32768]}
        print("perf " + json.dumps(self.perf), file=sys.stderr)

        def ms(s):
            return f"{s['median']:.3f} ms (spread {s['spread']:.3f})"

        return (f"B1 N=65536 no-PE {ms(b1)} vs plain {ms(b1p)}; PE {ms(b1pe)}; "
                f"ds32 step N=65536 {step_k['median']:.3f} vs plain "
                f"{step_p['median']:.3f} ms/step; B4 N=4096 {ms(fused[4096][0])}/step vs "
                f"plain {ms(fused[4096][1])}/step; B4 N=32768 {ms(fused[32768][0])}/step "
                f"vs plain {ms(fused[32768][1])}/step")


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
        ("7 timings", smoke.timings),
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
