"""The port's live viewer (``orbital_tpu_torch.serve``) against the JAX
package's (``app/app.py``), on the CPU.

The JAX viewer builds its scene when ``app.app`` is imported, so each mode
imports it under the same environment as the port's backend is built from,
the way ``tests/test_app.py`` does. Tolerances:
  * solar mode (f64 in both on the CPU): positions within 1e-12 of the
    largest (the same KDK arithmetic in another summation order); masses,
    radii, periods and surface gravities equal to 1e-12.
  * cluster mode (256 bodies, ds32 in both): the viewed positions after the
    20-step warm-up and after one 5-step tick, f32 force sums in another
    order (XLA:CPU's fused rollout against the port's plain version) over a
    softened cluster; measured 5.4e-11 of the largest coordinate after 20
    steps and 6.8e-11 after 25 (2.3e-10 after 100), held to 1e-8.
"""
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from orbital_tpu_torch.engine.checkpoint import load_state
from orbital_tpu_torch.serve import app as t_app
from orbital_tpu_torch.serve.backend import ViewerConfig, create_backend

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = Path(__file__).resolve().parent.parent
SOLAR_ENV = {"SIM_INITIAL_STEPS": "20", "SIM_MAX_HISTORY": "100", "SIM_DISABLE_THREAD": "true",
             "SIM_MOONS": "false", "USE_CACHE": "false"}
CLUSTER_ENV = {"SIM_SCENE": "cluster", "SIM_N": "256", "SIM_VIEW_MAX": "64",
               "SIM_INITIAL_STEPS": "20", "SIM_STEPS_PER_TICK": "5",
               "SIM_DISABLE_THREAD": "true"}
CLUSTER_TOL = 1e-8
SNAPSHOT_KEYS = {"bodies", "mass_min", "mass_max", "radius_min", "radius_max",
                 "time_elapsed", "sim_time_jd", "sim_time_iso"}
BODY_KEYS = {"id", "name", "mass_kg", "radius_km", "T_seconds", "fg_ms2", "position"}


def _jax_app(env):
    """The JAX viewer's module, imported under ``env`` (restored after)."""
    keys = set(env) | {"SIM_SCENE"}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.pop("SIM_SCENE", None)
    os.environ.update(env)
    if sys.path[0] != str(REPO):
        sys.path.insert(0, str(REPO))
    sys.modules.pop("app.app", None)
    sys.modules.pop("app", None)
    try:
        return importlib.import_module("app.app")
    finally:
        sys.modules.pop("app.app", None)
        sys.modules.pop("app", None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _positions(snap):
    return np.array([[b["position"][c] for c in "xyz"] for b in snap["bodies"]])


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


def _same_solar(port, jax_snap):
    assert set(port) == set(jax_snap) == SNAPSHOT_KEYS
    assert [b["name"] for b in port["bodies"]] == [b["name"] for b in jax_snap["bodies"]]
    for bp, bj in zip(port["bodies"], jax_snap["bodies"]):
        assert set(bp) == set(bj) == BODY_KEYS
        for k in ("mass_kg", "radius_km", "T_seconds", "fg_ms2"):
            assert bp[k] == pytest.approx(bj[k], rel=1e-12), (bp["name"], k)
    _close(_positions(port), _positions(jax_snap), 1e-12, "positions")
    for k in ("mass_min", "mass_max", "radius_min", "radius_max", "time_elapsed",
              "sim_time_jd"):
        assert port[k] == pytest.approx(jax_snap[k], rel=1e-15), k
    assert port["sim_time_iso"] == jax_snap["sim_time_iso"]


@pytest.fixture(scope="module")
def solar():
    jmod = _jax_app(SOLAR_ENV)
    app = t_app.create_app(env=SOLAR_ENV, device="cpu")
    return jmod, app


@pytest.fixture(scope="module")
def cluster():
    jmod = _jax_app(CLUSTER_ENV)
    app = t_app.create_app(env=CLUSTER_ENV, device="cpu")
    return jmod, app


def test_viewer_config_matches_the_jax_viewer(solar, cluster):
    for jmod, env in ((solar[0], SOLAR_ENV), (cluster[0], CLUSTER_ENV)):
        cfg = ViewerConfig.from_env(env)
        assert (cfg.interval, cfg.initial_steps, cfg.max_history, cfg.use_cache,
                cfg.cache_fp, cfg.cache_every_n, cfg.fps, cfg.moons,
                cfg.resume_from_cache, cfg.scene, cfg.n, cfg.view_max,
                cfg.steps_per_tick, cfg.force, cfg.tree_levels) == (
            jmod.INTERVAL, jmod.INITIAL_STEPS, jmod.MAX_HISTORY, jmod.USE_CACHE,
            jmod.CACHE_FP, jmod.CACHE_EVERY_N, jmod.SIM_FPS, jmod.SIM_MOONS,
            jmod.RESUME_FROM_CACHE, jmod.SIM_SCENE, jmod.SIM_N, jmod.SIM_VIEW_MAX,
            jmod.SIM_STEPS_PER_TICK, jmod.SIM_FORCE, jmod.SIM_TREE_LEVELS)
    assert ViewerConfig.from_env({}) == ViewerConfig()


def test_solar_snapshots_match_jax(solar):
    jmod, app = solar
    backend = app.backend
    assert backend.engine.precision == "f64" and len(backend.snapshot["bodies"]) == 15
    _same_solar(backend.snapshot, jmod._snapshot)
    assert backend.snapshot["time_elapsed"] == pytest.approx(20 * 1800.0)
    # one tick: an engine step in each
    with jmod.engine_lock:
        jmod.engine.step()
        jmod._snapshot = jmod.build_snapshot()
    snap = backend.tick()
    assert snap is backend.snapshot
    _same_solar(snap, jmod._snapshot)
    json.dumps(snap)


def test_cluster_snapshots_match_jax(cluster):
    jmod, app = cluster
    backend = app.backend
    snap, jsnap = backend.snapshot, jmod._snapshot
    assert set(snap) == set(jsnap) == SNAPSHOT_KEYS | {"scene"}
    assert snap["scene"] == jsnap["scene"] == {"kind": "cluster", "n_total": 256, "n_view": 64,
                                               "steps_per_tick": 5}
    assert [b["name"] for b in snap["bodies"]] == [b["name"] for b in jsnap["bodies"]]
    for bp, bj in zip(snap["bodies"], jsnap["bodies"]):
        assert set(bp) == set(bj) == BODY_KEYS
        assert {k: bp[k] for k in BODY_KEYS - {"position"}} == {
            k: bj[k] for k in BODY_KEYS - {"position"}}
    _close(_positions(snap), _positions(jsnap), CLUSTER_TOL, "warm-up positions")
    for k in ("mass_min", "mass_max", "radius_min", "radius_max", "sim_time_iso"):
        assert snap[k] == jsnap[k], k
    assert snap["time_elapsed"] == pytest.approx(jsnap["time_elapsed"], rel=1e-6)
    assert backend.cluster.state.is_ds and backend.cluster.cfg.force_impl == "auto"
    # one tick of 5 steps in each
    with jmod.engine_lock:
        jmod._cl["advance"](jmod.SIM_STEPS_PER_TICK)
        jmod._snapshot = jmod.build_snapshot()
    t0 = snap["time_elapsed"]
    snap = backend.tick()
    assert snap["time_elapsed"] > t0
    _close(_positions(snap), _positions(jmod._snapshot), CLUSTER_TOL, "tick positions")
    assert np.isfinite(_positions(snap)).all()
    json.dumps(snap)


def test_cluster_trail_ring(cluster):
    _, app = cluster
    backend = app.backend
    cl = backend.cluster
    buf = cl.hist_buf
    assert buf.shape == (64, 300, 3) and buf.dtype == np.float32
    for _ in range(310):
        backend.build_cluster_snapshot()
    assert cl.hist_len == 300 and cl.hist_buf is buf
    hist = backend.history()
    assert set(hist) == {b["name"] for b in backend.snapshot["bodies"]}
    some = next(iter(hist.values()))
    assert len(some) == 300 and len(some[0]) == 3


@pytest.mark.parametrize("mode", ["solar", "cluster"])
def test_routes(mode, solar, cluster, tmp_path, monkeypatch):
    jmod, app = solar if mode == "solar" else cluster
    with app.test_client() as c:
        r = c.get("/health")
        assert r.status_code == 200 and r.get_json() == {"status": "ok"}
        d = c.get("/api/state").get_json()
        assert d == json.loads(json.dumps(app.backend.snapshot))
        r = c.get("/")
        html = r.get_data(as_text=True)
        assert r.status_code == 200 and "__BOOTSTRAP__" in html and "orbital-tpu" in html
        assert c.get("/static/js/main.js").status_code == 200
        assert c.get("/static/js/fallback2d.js").status_code == 200
        assert c.get("/static/../app.py").status_code in (403, 404)
        ck = tmp_path / "ck.npz"
        monkeypatch.setenv("CHECKPOINT_FP", str(ck))
        r = c.post("/api/checkpoint")
        assert r.status_code == 200 and r.get_json() == {"status": "ok", "path": str(ck)}
    state, meta = load_state(ck, device="cpu")
    live = (app.backend.cluster.state if mode == "cluster" else app.backend.engine.state)
    assert torch.equal(state.pos, live.pos) and torch.equal(state.time, live.time)
    if mode == "cluster":
        assert meta == {"scene": "cluster", "n": 256}
    else:
        assert meta["step_idx"] == app.backend.engine.step_idx


def test_engine_thread_ticks_and_stops():
    env = dict(SOLAR_ENV, SIM_INITIAL_STEPS="0", SIM_FPS="200")
    backend = create_backend(env, device="cpu")
    thread = t_app.EngineThread(backend).start()
    try:
        deadline = time.monotonic() + 30.0
        while backend.snapshot["time_elapsed"] < 3 * 1800.0 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        thread.stop(timeout=30.0)
    assert not thread._thread.is_alive()
    assert backend.snapshot["time_elapsed"] >= 3 * 1800.0
    assert backend.engine.step_idx * 1800.0 == pytest.approx(backend.snapshot["time_elapsed"])


def test_tree_cluster_mode_runs_the_kernel_near_field():
    env = dict(CLUSTER_ENV, SIM_VIEW_MAX="32", SIM_INITIAL_STEPS="4", SIM_FORCE="tree",
               SIM_TREE_LEVELS="4")
    backend = create_backend(env, device="cpu")
    cfg = backend.cluster.cfg
    assert (cfg.force_impl, cfg.tree_near, cfg.tree_levels) == ("tree", "kernel", 4)
    assert cfg.tree_max_chunks and cfg.tree_wl_entries and not backend.cluster.staged
    t0 = backend.snapshot["time_elapsed"]
    snap = backend.tick()
    assert snap["time_elapsed"] > t0 and len(snap["bodies"]) == 32
    assert np.isfinite(_positions(snap)).all()
    with pytest.raises(ValueError, match="SIM_FORCE"):
        create_backend(dict(CLUSTER_ENV, SIM_FORCE="pairs"), device="cpu")
    with pytest.raises(ValueError, match="SIM_SCENE"):
        create_backend(dict(SOLAR_ENV, SIM_SCENE="galaxy"), device="cpu")


def test_resume_from_cache(tmp_path):
    cache = tmp_path / "cache.jsonl"
    env = dict(SOLAR_ENV, SIM_INITIAL_STEPS="40", USE_CACHE="true", CACHE_FP=str(cache),
               CACHE_EVERY_N="10")
    first = create_backend(env, device="cpu")
    assert first.engine.time_elapsed == 40 * 1800.0
    second = create_backend(dict(env, SIM_INITIAL_STEPS="0", RESUME_FROM_CACHE="true"),
                            device="cpu")
    assert second.resumed and second.engine.time_elapsed == 30 * 1800.0
    assert len(second.engine.objects) == 15


def test_serve_app_imports_no_jax():
    code = ("import sys; import orbital_tpu_torch.serve.app, orbital_tpu_torch.serve.backend; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'orbital_tpu', 'flask', 'werkzeug', 'jinja2', 'matplotlib')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_backend_device_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_backend(SOLAR_ENV)
