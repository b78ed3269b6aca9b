"""The port's bundled examples (``models/examples.py``), offline plots and
video (``viz/``) and CLI (``__main__.py``) against the JAX package's, on the
CPU (f64 in both: the examples' engines and ``simulate`` take f64 on the
CPU). Tolerances: the same KDK arithmetic in another summation order, 1e-12
of the largest value for states (measured <= 3.0e-15 over the examples'
runs); the CLI's energy drift, a difference of nearly equal energies, to
1e-6 of itself (measured 3.4e-10)."""
import json
import os

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import orbital_tpu_torch as tot  # noqa: E402
from orbital_tpu.__main__ import main as j_main  # noqa: E402
from orbital_tpu.models import examples as jex  # noqa: E402
from orbital_tpu_torch.__main__ import main as t_main  # noqa: E402
from orbital_tpu_torch.models import examples as tex  # noqa: E402
from orbital_tpu_torch.viz.plot import plot_orbits, plot_trajectory  # noqa: E402
from orbital_tpu_torch.viz.video import render_orbital_mp4  # noqa: E402

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-12


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


def _same(te, je):
    assert len(te.objects) == len(je.objects)
    assert te.step_idx == je.step_idx and te.time_elapsed == pytest.approx(je.time_elapsed)
    _close([o.position() for o in te.objects], [o.position() for o in je.objects], TOL,
           "positions")
    _close([o.velocity for o in te.objects], [o.velocity for o in je.objects], TOL,
           "velocities")


def _drifts(out):
    return [abs(float(line.split("dE=")[1].split(",")[0]))
            for line in out.splitlines() if "dE=" in line]


def test_two_body_problem_matches_jax(capsys):
    je = jex.two_body_problem(steps=100, show=False)
    te = tex.two_body_problem(steps=100, show=False, device="cpu")
    _same(te, je)
    out = capsys.readouterr().out
    assert out.count("dE=") == 2 and te.device.type == "cpu" and te.precision == "f64"


def test_sun_earth_moon_matches_jax(capsys):
    je = jex.sun_earth_moon(steps=300, show=False)
    capsys.readouterr()
    te = tex.sun_earth_moon(steps=300, show=False, device="cpu")
    _same(te, je)
    assert max(_drifts(capsys.readouterr().out)) < 1e-9


def test_three_body_equilateral_matches_jax():
    je = jex.three_body_equilateral(steps=500, render=False)
    te = tex.three_body_equilateral(steps=500, render=False, device="cpu")
    _same(te, je)
    pos = np.stack([o.position() for o in te.objects])
    d01 = np.linalg.norm(pos[0] - pos[1])
    assert d01 == pytest.approx(np.sqrt(3) * 1e7, rel=1e-3)
    assert np.linalg.norm(pos[1] - pos[2]) == pytest.approx(d01, rel=1e-3)


def test_sol_from_kepler_dataset_matches_jax():
    je = jex.sol_from_kepler_dataset(days=10, render=False, print_every=5)
    te = tex.sol_from_kepler_dataset(days=10, render=False, print_every=5, device="cpu")
    assert len(te.objects) == 15 and te.time_elapsed == pytest.approx(10 * 86400.0)
    _same(te, je)


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tex.two_body_problem(steps=1, show=False)


def test_plot_orbits_saves(tmp_path):
    eng = tex.two_body_problem(steps=50, show=False, device="cpu")
    out = tmp_path / "orbits.png"
    plot_orbits(eng, every_n=2, plane="xz", last_k=20, separate=True, barycenter_trail=True,
                savepath=str(out), show=False)
    assert out.exists() and out.stat().st_size > 0
    with pytest.raises(ValueError):
        plot_orbits(eng, plane="ab", show=False)


def test_plot_trajectory_from_port_records(tmp_path):
    """A Trajectory of torch tensors plots directly; far-parked dead bodies
    (a merge, padding) NaN out and never-alive padding rows drop, so the
    axes stay on the live scene."""
    pos = np.array([[-0.5, 0, 0], [0.5, 0, 0], [0, 8.0, 0]])
    vel = np.array([[0.2, 0, 0], [-0.2, 0, 0], [0, 0, 0]])
    st = tot.make_state(pos, vel, np.array([2.0, 1.0, 1e-3]), np.array([0.2, 0.2, 0.01]),
                        precision="f32", pad_to=4, device="cpu")
    cfg = tot.SimConfig(dt=0.1, G=1e-6, eps2=1e-8, collisions="merge", force_impl="dense")
    fin, traj = tot.rollout(tot.init_forces(st, cfg), cfg, 60, record_every=10)
    assert not bool(fin.alive[1])
    out = tmp_path / "merged.png"
    fig, axes = plot_trajectory(traj, masses=fin.mass, savepath=str(out), show=False)
    xlo, xhi = axes[0].get_xlim()
    assert abs(xlo) < 100 and abs(xhi) < 100 and out.exists()


def test_render_video_fallback_or_stitch(tmp_path):
    eng = tex.two_body_problem(steps=60, show=False, device="cpu")
    info = render_orbital_mp4(eng, out_path=str(tmp_path / "v.mp4"), fps=5, duration_s=1.0,
                              tmp_dir=str(tmp_path / "frames"), cleanup=False)
    assert info["frames"] >= 1
    assert any(f.endswith(".png") for f in os.listdir(tmp_path / "frames"))
    if info["ffmpeg"]:
        assert info["stitched"] and (tmp_path / "v.mp4").exists()


def test_cli_simulate_matches_jax(capsys, tmp_path):
    assert j_main(["simulate", "--steps", "365"]) is None
    want = json.loads(capsys.readouterr().out.splitlines()[0])
    plot = tmp_path / "traj.png"
    assert t_main(["simulate", "--steps", "365", "--device", "cpu", "--plot", str(plot)]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = json.loads(lines[0])
    assert set(got) == set(want) == {"bodies", "steps", "sim_days", "energy_drift", "records"}
    for k in ("bodies", "steps", "records"):
        assert got[k] == want[k], k
    assert got["sim_days"] == pytest.approx(want["sim_days"], rel=1e-15)
    assert got["energy_drift"] == pytest.approx(want["energy_drift"], rel=1e-6)
    assert plot.exists() and lines[1] == f"plot saved to {plot}"


def test_cli_bench_names_a5(capsys):
    assert t_main(["bench"]) != 0
    assert "A.5" in capsys.readouterr().err

