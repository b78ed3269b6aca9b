"""CLI: python -m orbital_tpu_torch {simulate,serve,bench}.

``simulate`` runs the bundled solar system through ``simulate()`` on
``--device`` (the card by default) and prints one JSON line; ``serve`` runs
the port's live viewer (``serve.app``); ``bench`` has no port-side benchmark
yet (ROADMAP.md queue A, item A.5) and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys


def cmd_simulate(args) -> int:
    import orbital_tpu_torch as ot

    system = ot.solar_system_v2(moons=args.moons)
    result = ot.simulate(system, steps=args.steps, dt=args.dt, softening=args.softening,
                         integrator=args.integrator, precision=args.precision,
                         device=args.device)
    print(json.dumps({
        "bodies": len(result.names),
        "steps": args.steps,
        "sim_days": float(result.time[-1] / 86400.0),
        "energy_drift": result.energy_drift,
        "records": int(result.pos.shape[0]),
    }))
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        from orbital_tpu_torch.viz.plot import plot_trajectory

        plot_trajectory(result_traj_view(result), names=result.names, masses=None,
                        savepath=args.plot, show=False)
        print(f"plot saved to {args.plot}")
    return 0


def result_traj_view(result):
    class _V:  # duck-typed Trajectory for plot_trajectory
        pos = result.pos
        vel = result.vel

    return _V()


def cmd_serve(args) -> int:
    from orbital_tpu_torch.serve.app import serve

    serve(host=args.host, port=args.port, device=args.device)
    return 0


def cmd_bench(args) -> int:
    print("orbital_tpu_torch has no benchmark script yet: it is ROADMAP.md queue A, item "
          "A.5 (the benchmark cells). chip_smoke.py drives and times the port on the card "
          "meanwhile.", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="orbital_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate", help="simulate the bundled solar system")
    s.add_argument("--steps", type=int, default=365)
    s.add_argument("--dt", type=float, default=86400.0)
    s.add_argument("--softening", type=float, default=1e6)
    s.add_argument("--moons", action="store_true")
    s.add_argument("--integrator", default="kdk",
                   choices=["kdk", "euler", "rk4", "hermite"])
    s.add_argument("--precision", default=None,
                   choices=[None, "f32", "ds32", "f64"])
    s.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu runs the plain versions)")
    s.add_argument("--plot", default=None, help="save a trajectory PNG here")
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser("serve", help="run the live viewer service")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=5000)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("bench", help="the port's benchmark (not written yet: ROADMAP A.5)")
    s.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
