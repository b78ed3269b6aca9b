"""The PyTorch port's object facade (``engine/engine.py``), its checkpoints
(``engine/checkpoint.py``), ``utils/io.py`` and ``utils/metrics.py`` against
the JAX package's, on the CPU.

Each package gets its own ``ObjectCollection`` built from the same numbers
(the engine mutates its objects). Tolerances:
  * f64 (the CPU default of both): the same KDK arithmetic in another
    summation order, 1e-12 of the largest value (measured <= 4.1e-16 for
    the Earth-Moon pair over 260 steps).
  * ds32 (both engines rescale to natural units): f32 arithmetic rounded
    in other places (XLA:CPU's fusions and torch's kernels) carried through
    260 steps of the Earth-Moon pair; measured 1.7e-9 of the largest
    position and 9.9e-8 of the largest velocity, held to 1e-6.
"""
import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.engine import checkpoint as j_ckpt
from orbital_tpu.engine.engine import SimulationEngine as JEngine
from orbital_tpu.models import objects as jobj
from orbital_tpu_torch.engine import checkpoint as t_ckpt
from orbital_tpu_torch.engine import engine as t_engine
from orbital_tpu_torch.engine.engine import SimulationEngine as TEngine
from orbital_tpu_torch.engine.engine import run_simulation
from orbital_tpu_torch.models import objects as tobj
from orbital_tpu_torch.utils import io as t_io
from orbital_tpu_torch.utils.metrics import MetricsRecorder

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F64_TOL = 1e-12
DS32_TOL = 1e-6


def _earth_moon(mod):
    a = mod.Object(5.972e24, 6.371e6, velocity=np.zeros(3),
                   coordinates=mod.Coordinates(0, 0, 0), name="earth")
    b = mod.Object(7.348e22, 1.737e6, velocity=np.zeros(3),
                   coordinates=mod.Coordinates(3.844e8, 0, 0), name="moon")
    mod.set_circular_orbit(a, b)
    return mod.ObjectCollection([a, b])


def _merge_scene(mod):
    """tests/test_engine_facade.py's merge scene: a head-on pair that merges
    and a far third body."""
    return mod.ObjectCollection([
        mod.Object(6.0, 1.0, velocity=np.array([1.0, 0, 0]),
                   coordinates=mod.Coordinates(0, 0, 0), name="big"),
        mod.Object(3.0, 1.0, velocity=np.array([-1.0, 0, 0]),
                   coordinates=mod.Coordinates(5.0, 0, 0), name="small"),
        mod.Object(0.5, 0.1, velocity=np.zeros(3),
                   coordinates=mod.Coordinates(0, 50.0, 0), name="far")])


def _pair(scene=_earth_moon, tmp_path=None, **kw):
    """The JAX engine and the port's (on the CPU) on the same scene."""
    jkw, tkw = dict(kw), dict(kw)
    if tmp_path is not None:
        jkw["cache_fp"] = str(tmp_path / "jax.jsonl")
        tkw["cache_fp"] = str(tmp_path / "port.jsonl")
    return JEngine(scene(jobj), **jkw), TEngine(scene(tobj), device="cpu", **tkw)


EM = dict(dt=3600.0, softening=1e3, max_hist=None)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = np.abs(b).max()
    err = np.abs(a - b).max() / (scale if scale > 0 else 1.0)
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


def _objects(engine):
    return (np.array([o.position() for o in engine.objects]),
            np.array([np.asarray(o.velocity, np.float64) for o in engine.objects]))


def _same_engines(je, te, tol):
    assert [o.name for o in je.objects] == [o.name for o in te.objects]
    jp, jv = _objects(je)
    tp, tv = _objects(te)
    _close(tp, jp, tol, "positions")
    _close(tv, jv, tol, "velocities")
    assert te.step_idx == je.step_idx
    assert te.time_elapsed == pytest.approx(je.time_elapsed, rel=1e-15)
    jh, th = je.named_history(), te.named_history()
    assert set(jh) == set(th)
    for name in jh:
        _close(th[name], jh[name], tol, f"history[{name}]")


def test_step_and_run_match_jax_f64(tmp_path):
    je, te = _pair(tmp_path=tmp_path, cache=False, **EM)
    assert te.precision == "f64" and te.device.type == "cpu"
    for _ in range(10):
        je.step()
        te.step()
    _same_engines(je, te, F64_TOL)
    je.run(50)
    te.run(50)
    _same_engines(je, te, F64_TOL)
    assert len(te.named_history()["moon"]) == 61
    assert te.total_energy() == pytest.approx(je.total_energy(), rel=F64_TOL)
    _close(te.angular_momentum(), je.angular_momentum(), F64_TOL, "angular momentum")
    assert te.last_potential == pytest.approx(je.last_potential, rel=F64_TOL)
    ja, ta = je.acc, te.acc
    for (ju, jv), (tu, tv) in zip(ja.items(), ta.items()):
        _close(tv, jv, F64_TOL, "acc")


def test_jsonl_frames_match_jax(tmp_path):
    je, te = _pair(tmp_path=tmp_path, cache=True, cache_every_n=100, **EM)
    je.run(250)
    te.run(250)
    jf = list(t_io.iter_jsonl(je.cache_fp))
    tf = list(t_io.iter_jsonl(te.cache_fp))
    assert len(tf) == len(jf) == 3  # steps 0, 100, 200
    assert t_io.last_jsonl(te.cache_fp) == tf[-1]
    for a, b in zip(tf, jf):
        assert set(a) == set(b) == {"time_elapsed", "objects", "history"}
        assert a["time_elapsed"] == b["time_elapsed"]
        assert [set(o) for o in a["objects"]] == [set(o) for o in b["objects"]]
        for oa, ob in zip(a["objects"], b["objects"]):
            for k, v in ob.items():
                if k in ("uuid", "angular_velocity"):
                    continue  # drawn at random when each Object is built
                if isinstance(v, dict):  # coordinates {x, y, z}
                    assert set(oa[k]) == set(v), k
                    _close([oa[k][c] for c in v], list(v.values()), F64_TOL, k)
                elif isinstance(v, (list, float)):
                    _close(oa[k], v, F64_TOL, f"frame object {k}")
                else:
                    assert oa[k] == v, k
        assert set(a["history"]) == set(b["history"]) == {"earth", "moon"}
        for k in a["history"]:
            _close(a["history"][k], b["history"][k], F64_TOL, "frame history")
    assert tf[-1]["time_elapsed"] == pytest.approx(200 * 3600.0)


def test_ds32_engine_matches_jax():
    je, te = _pair(precision="ds32", cache=False, **EM)
    assert dataclasses.asdict(te.rescale) == dataclasses.asdict(je.rescale)
    assert te.config == tot.SimConfig(**dataclasses.asdict(je.config))
    for _ in range(10):
        je.step()
        te.step()
    je.run(250)
    te.run(250)
    _same_engines(je, te, DS32_TOL)
    assert te.state.is_ds and te.state.dtype == torch.float32
    assert te.total_energy() == pytest.approx(je.total_energy(), rel=DS32_TOL)


def test_history_ring_buffer_matches_jax():
    je, te = _pair(cache=False, **EM)
    for e in (je, te):
        e.max_hist = 10
        e.run(30)
    assert all(len(te.history[o.uuid]) == 10 for o in te.objects)
    _same_engines(je, te, F64_TOL)
    for e in (je, te):
        e.max_hist = None
        e.run(5)
    assert len(te.history[te.objects[0].uuid]) == 15
    _same_engines(je, te, F64_TOL)


def test_auto_stride_warning_matches_jax():
    je, te = _pair(cache=False, **EM)
    for e in (je, te):
        e._HISTORY_FLOAT_BUDGET = 2 * 3 * 20  # 20 records of 2 bodies a run
    with pytest.warns(RuntimeWarning, match="records every 3-th step"):
        te.run(60)
    with pytest.warns(RuntimeWarning, match="records every 3-th step"):
        je.run(60)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per engine
        te.run(60)
        je.run(60)
    assert len(te.named_history()["moon"]) == 41
    _same_engines(je, te, F64_TOL)


def test_history_stride_phase_across_frame_segments(tmp_path):
    je, te = _pair(tmp_path=tmp_path, cache=True, cache_every_n=5, history_every=7, **EM)
    plain = TEngine(_earth_moon(tobj), device="cpu", cache=False, history_every=7, **EM)
    for e in (je, te, plain):
        e.run(50)
    assert np.asarray(te.named_history()["moon"]).shape == (8, 3)  # seed + 7, 14, ..., 49
    _same_engines(je, te, F64_TOL)
    np.testing.assert_allclose(te.named_history()["moon"], plain.named_history()["moon"],
                               rtol=1e-14)
    # the windowed recorded path: one record a window, the same history
    small = TEngine(_earth_moon(tobj), device="cpu", cache=False, history_every=1, **EM)
    small._WINDOW_FLOAT_BUDGET = 6 * 2 * 3
    dense = TEngine(_earth_moon(tobj), device="cpu", cache=False, history_every=1, **EM)
    small.run(20)
    dense.run(20)
    np.testing.assert_array_equal(small.named_history()["moon"], dense.named_history()["moon"])


def test_checkpoint_roundtrip_and_resume(tmp_path):
    te = TEngine(_earth_moon(tobj), device="cpu", cache=False, **EM)
    te.run(20)
    ck = tmp_path / "state.npz"
    te.checkpoint(ck)
    pos_before, _ = _objects(te)
    t_before = te.time_elapsed
    te.run(50)
    te.resume(ck)
    np.testing.assert_array_equal(_objects(te)[0], pos_before)
    assert te.time_elapsed == t_before and te.step_idx == 20
    te.run(10)
    pos_a = _objects(te)[0]
    fresh = TEngine(_earth_moon(tobj), device="cpu", cache=False, **EM)
    fresh.resume(ck)
    fresh.run(10)
    np.testing.assert_array_equal(_objects(fresh)[0], pos_a)
    for f in ("pos", "vel", "acc", "potential", "time", "step"):
        assert torch.equal(getattr(fresh.state, f), getattr(te.state, f)), f


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_load(writer, tmp_path):
    """A checkpoint written by either package's engine resumes in the
    other's and both continue identically (f64 within 1e-12; ds32 state
    bit-equal on load)."""
    je, te = _pair(cache=False, **EM)
    je.run(20)
    te.run(20)
    ck = tmp_path / f"{writer}.npz"
    (je if writer == "jax" else te).checkpoint(ck)
    je2, te2 = _pair(cache=False, **EM)
    je2.resume(ck)
    te2.resume(ck)
    _close(np.asarray(te2.state.pos), np.asarray(je2.state.pos), 0.0, "resumed pos")
    assert te2.step_idx == je2.step_idx == 20
    je2.run(10)
    te2.run(10)
    _same_engines(je2, te2, F64_TOL)
    # the raw state, ds32 compensation words included, loads bit for bit
    st = jot.make_state(np.ones((3, 3)) * 1.1, np.ones((3, 3)), np.ones(3), precision="ds32")
    j_ckpt.save_state(st, tmp_path / "ds.npz", meta={"k": 1})
    loaded, meta = t_ckpt.load_state(tmp_path / "ds.npz", device="cpu")
    assert meta == {"k": 1}
    for f in ("pos", "pos_lo", "vel", "vel_lo", "mass", "alive", "time", "step"):
        np.testing.assert_array_equal(getattr(loaded, f).numpy(), np.asarray(getattr(st, f)))
    t_ckpt.save_state(loaded, tmp_path / "back.npz", meta=meta)
    back, meta2 = j_ckpt.load_state(tmp_path / "back.npz")
    assert meta2 == meta
    for f in ("pos", "pos_lo", "vel", "vel_lo", "alive", "step"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(st, f)))


def test_hermite_checkpoint_roundtrip(tmp_path):
    """The Hermite jerk cache survives a checkpoint and the resumed run
    continues bit-identically (tests/test_engine_core.py:649's check, on the
    port)."""
    objs = _earth_moon(tobj)
    pos = np.array([o.position() for o in objs])
    vel = np.array([o.velocity for o in objs])
    mass = np.array([o.mass for o in objs])
    cfg = tot.SimConfig(dt=3600.0, G=tot.STANDARD.G, integrator="hermite")
    st = tot.init_forces(tot.make_state(pos, vel, mass, precision="f64", device="cpu"), cfg)
    fin, _ = tot.rollout(st, cfg, 10)
    tot.save_state(fin, tmp_path / "h.npz", meta={"x": 1})
    restored, meta = tot.load_state(tmp_path / "h.npz", device="cpu")
    assert meta == {"x": 1} and restored.jerk is not None
    a, _ = tot.rollout(fin, cfg, 5)
    b, _ = tot.rollout(restored, cfg, 5)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.jerk, b.jerk)
    # and the JAX package's Hermite continues from the port's checkpoint
    js, jmeta = j_ckpt.load_state(tmp_path / "h.npz")
    assert jmeta == meta and js.jerk is not None
    jb, _ = jot.rollout_jit(js, jot.SimConfig(dt=3600.0, G=jot.STANDARD.G,
                                              integrator="hermite"), 5)
    _close(b.pos.numpy(), np.asarray(jb.pos), F64_TOL, "hermite pos")


def test_resume_rejects_mismatched_dt_and_rescale(tmp_path):
    te = TEngine(_earth_moon(tobj), device="cpu", cache=False, **EM)
    te.run(5)
    ck = tmp_path / "s.npz"
    te.checkpoint(ck)
    wrong_dt = TEngine(_earth_moon(tobj), device="cpu", cache=False, dt=1800.0,
                       softening=1e3, max_hist=None)
    with pytest.raises(ValueError, match="dt"):
        wrong_dt.resume(ck)
    wrong_rs = TEngine(_earth_moon(tobj), device="cpu", cache=False, precision="ds32",
                       rescale=tot.Rescale(length=2.0, mass=3.0, time=5.0), **EM)
    with pytest.raises(ValueError, match="rescale"):
        wrong_rs.resume(ck)


def test_checkpoint_needs_npz(tmp_path):
    te = TEngine(_earth_moon(tobj), device="cpu", cache=False, **EM)
    with pytest.raises(ValueError, match="npz"):
        te.checkpoint(tmp_path / "orbax_dir")
    with pytest.raises(ValueError, match="npz"):
        t_ckpt.load_state(tmp_path / "orbax_dir", device="cpu")
    with pytest.raises(ValueError, match="jsonl"):
        TEngine(_earth_moon(tobj), device="cpu", cache_fp="frames.json")


def test_merge_prunes_objects_like_jax():
    kw = dict(dt=0.05, merge_on_capture=True, cache=False, max_hist=None, precision="f64")
    je, te = _pair(scene=_merge_scene, **kw)
    uuid_small = te.objects[1].uuid
    je.run(200)
    te.run(200)
    assert [o.name for o in te.objects] == ["big", "far"]
    assert te.objects[0].mass == pytest.approx(9.0)
    _same_engines(je, te, F64_TOL)
    # the merged body stopped accruing history at its merge record
    assert 1 < len(te.history[uuid_small]) < len(te.named_history()["far"]) == 201


def test_resume_from_cache_after_merge(tmp_path):
    kw = dict(dt=0.05, merge_on_capture=True, max_hist=None, precision="f64")
    je, te = _pair(scene=_merge_scene, tmp_path=tmp_path, cache=True, cache_every_n=10, **kw)
    je.run(200)
    te.run(200)
    je2 = JEngine(_merge_scene(jobj), cache=False, rescale=je.rescale, **kw)
    te2 = TEngine(_merge_scene(tobj), device="cpu", cache=False, rescale=te.rescale, **kw)
    assert je2.resume_from_cache(je.cache_fp) and te2.resume_from_cache(te.cache_fp)
    assert te2.state.n_bodies == je2.state.n_bodies == 2
    assert te2.time_elapsed == je2.time_elapsed
    te2.step()
    je2.step()
    te2.run(20)
    je2.run(20)
    jp, _ = _objects(je2)
    tp, _ = _objects(te2)
    _close(tp, jp, F64_TOL, "positions after resume")
    (tmp_path / "empty.jsonl").touch()
    assert not te2.resume_from_cache(str(tmp_path / "empty.jsonl"))


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(_earth_moon(tobj), cache=False, **EM)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_engine.engine_device("cuda")
    assert t_engine.engine_device("cpu") == torch.device("cpu")


def test_run_simulation_prints_drift(capsys):
    te = TEngine(_earth_moon(tobj), device="cpu", cache=False, **EM)
    run_simulation(te, 100, print_every=50)
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "dE=" in out and "dL=" in out
    assert te.step_idx == 100


def test_metrics_recorder_matches_jax():
    from orbital_tpu.utils.metrics import MetricsRecorder as JRecorder

    je, te = _pair(cache=False, **EM)
    jrec, trec = JRecorder.start(je), MetricsRecorder.start(te)
    emitted = []
    trec.emit = emitted.append
    for e in (je, te):
        e.run(100)
    jw, tw = jrec.record(je), trec.record(te)
    assert emitted == trec.windows == [tw]
    assert (tw.step, tw.n_alive, tw.n_merged) == (jw.step, jw.n_alive, jw.n_merged) == (100, 2, 0)
    assert tw.energy == pytest.approx(jw.energy, rel=F64_TOL)
    assert tw.dE_rel == pytest.approx(jw.dE_rel, rel=1e-6, abs=1e-15)
    assert tw.dL_rel < 1e-12 and tw.steps_per_s > 0
    assert set(json.loads(tw.to_json())) == set(json.loads(jw.to_json()))


def test_jsonl_io_matches_jax(tmp_path):
    from orbital_tpu.utils import io as j_io

    frames = [{"a": 1, "b": [1.5, 2.0]}, {"a": 2, "b": []}]
    for f in frames:
        t_io.append_jsonl(tmp_path / "t.jsonl", f)
        j_io.append_jsonl(tmp_path / "j.jsonl", f)
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert list(t_io.iter_jsonl(tmp_path / "j.jsonl")) == frames
    assert t_io.last_jsonl(tmp_path / "t.jsonl") == frames[-1]
    (tmp_path / "e.jsonl").write_text("\n")
    assert t_io.last_jsonl(tmp_path / "e.jsonl") is None


def test_engine_package_exports():
    assert tot.SimulationEngine is TEngine and tot.run_simulation is run_simulation
    assert tot.save_state is t_ckpt.save_state and tot.load_state is t_ckpt.load_state
    assert jax.config.read("jax_enable_x64")  # the JAX side runs f64 here
