"""State construction of the PyTorch port against the JAX package's."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from orbital_tpu.engine import state as jst
from orbital_tpu_torch.engine import state as tst

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

FIELDS = [f.name for f in dataclasses.fields(jst.NBodyState)]


def _scene(rng, n=37):
    return (rng.normal(size=(n, 3)) * 3.0, rng.normal(size=(n, 3)),
            rng.uniform(0.5, 1.5, n), rng.uniform(0.01, 0.02, n))


def _assert_same(port, ref):
    """Every field equal: dtype (by name) and values, None where None."""
    for name in FIELDS:
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if p is None:
            continue
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)


@pytest.mark.parametrize("precision", ["f32", "ds32", "f64"])
@pytest.mark.parametrize("pad_to,spare", [(1, 0), (64, 0), (16, 5)])
def test_make_state_matches_jax(rng, precision, pad_to, spare):
    pos, vel, mass, radius = _scene(rng)
    rs = jst.Rescale.natural(pos, mass, 6.6743e-11)
    kw = dict(precision=precision, pad_to=pad_to, spare=spare, time=2.5)
    ref = jst.make_state(pos, vel, mass, radius, rescale=rs, **kw)
    port = tst.make_state(pos, vel, mass, radius, device="cpu",
                          rescale=tst.Rescale(rs.length, rs.mass, rs.time), **kw)
    _assert_same(port, ref)
    n_pad = tst.pad_count(len(mass) + spare, pad_to)
    assert port.n_bodies == n_pad and port.is_ds == (precision == "ds32")
    assert int(port.alive.sum()) == len(mass)
    # padding: massless and parked far away at distinct spots
    dead = ~port.alive
    if dead.any():
        assert float(port.mass[dead].abs().max()) == 0.0
        assert float(port.pos[dead].abs().min()) > 1e7
        assert len(torch.unique(port.pos[dead][:, 0])) == int(dead.sum())


def test_make_state_needs_a_device(rng):
    pos, vel, mass, _ = _scene(rng)
    with pytest.raises(TypeError):
        tst.make_state(pos, vel, mass)
    with pytest.raises(ValueError):
        tst.make_state(pos, vel, mass, device="cpu", precision="f16")


@pytest.mark.parametrize("precision", ["f32", "ds32", "f64"])
def test_state_from_arrays_round_trip(rng, precision):
    pos, vel, mass, radius = _scene(rng)
    ref = jst.make_state(pos, vel, mass, radius, precision=precision, pad_to=8)
    fields = {k: (None if getattr(ref, k) is None else np.asarray(getattr(ref, k)))
              for k in FIELDS}
    port = tst.state_from_arrays(fields, device="cpu")
    _assert_same(port, ref)
    np.testing.assert_array_equal(port.pos_full().numpy(), np.asarray(ref.pos_full()))
    np.testing.assert_array_equal(port.vel_full().numpy(), np.asarray(ref.vel_full()))
    with pytest.raises(ValueError):
        tst.state_from_arrays({**fields, "bogus": np.zeros(3)}, device="cpu")


def test_rescale_and_far_positions_match_jax(rng):
    pos, _, mass, _ = _scene(rng)
    a = jst.Rescale.natural(pos, mass, 2.5)
    b = tst.Rescale.natural(pos, mass, 2.5)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    for prop in ("velocity", "energy", "angular_momentum"):
        assert getattr(a, prop) == getattr(b, prop)
    assert a.g_internal(2.5) == b.g_internal(2.5)
    for dtype in (np.float32, np.float64):
        for scale in (1.0, 1e12):  # the f32 cap keeps far^2 finite
            np.testing.assert_array_equal(
                tst.far_positions(7, scale, dtype, start=3),
                jst.far_positions(7, scale, dtype, start=3))
    assert tst.far_positions(2, 1e12, np.float32).max() <= 1e17 * 1.002
    assert [tst.pad_count(n, m) for n, m in ((5, 1), (5, 4), (8, 4), (0, 4))] == \
        [jst.pad_count(n, m) for n, m in ((5, 1), (5, 4), (8, 4), (0, 4))]


def test_state_is_frozen_and_replace_copies(rng):
    pos, vel, mass, _ = _scene(rng)
    s = tst.make_state(pos, vel, mass, device="cpu")
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.pos = s.vel
    t = s.replace(step=s.step + 1)
    assert int(t.step) == 1 and int(s.step) == 0
    assert s.device == torch.device("cpu") and s.dtype == torch.float32
