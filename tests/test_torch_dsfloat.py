"""Double-single helpers of the PyTorch port against the JAX package's.

Eager PyTorch evaluates each operation separately and rounded, and so does
un-jitted JAX (op-by-op dispatch), so the error-free transformations must
agree bit for bit. Jitted XLA:CPU may contract ``a*b + c`` into a fused
multiply-add, so parity against jitted JAX code is held to a tolerance in
the rollout tests instead.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbital_tpu.engine import dsfloat as jds
from orbital_tpu_torch.engine import dsfloat as tds

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _pair(rng, n=4096, scale=1e-6):
    a = rng.normal(size=n).astype(np.float32)
    b = (rng.normal(size=n) * scale).astype(np.float32)
    return a, b


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum"])
@pytest.mark.parametrize("scale", [1e-6, 1.0])
def test_error_free_sums_bit_equal_to_jax(rng, name, scale):
    a, b = _pair(rng, scale=scale)
    if name == "fast_two_sum":  # requires |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    s_t, e_t = getattr(tds, name)(torch.from_numpy(a), torch.from_numpy(b))
    s_j, e_j = getattr(jds, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s_t.numpy(), _np(s_j))
    np.testing.assert_array_equal(e_t.numpy(), _np(e_j))


def test_ds_add_bit_equal_to_jax(rng):
    hi, lo = tds.ds_from_f64(rng.normal(size=4096))
    _, x = _pair(rng)
    dt = np.float32(1e-3)
    # the integrator's shape: the increment dt * v is rounded before the sum
    inc_t = torch.from_numpy(x) * float(dt)
    inc_j = jnp.asarray(x) * float(dt)
    np.testing.assert_array_equal(inc_t.numpy(), _np(inc_j))
    h_t, l_t = tds.ds_add(torch.from_numpy(hi), torch.from_numpy(lo), inc_t)
    h_j, l_j = jds.ds_add(jnp.asarray(hi), jnp.asarray(lo), inc_j)
    np.testing.assert_array_equal(h_t.numpy(), _np(h_j))
    np.testing.assert_array_equal(l_t.numpy(), _np(l_j))


def test_ds_add_ds_bit_equal_to_jax(rng):
    a_hi, a_lo = tds.ds_from_f64(rng.normal(size=1024))
    b_hi, b_lo = tds.ds_from_f64(rng.normal(size=1024) * 1e-3)
    t = tds.ds_add_ds(*(torch.from_numpy(v) for v in (a_hi, a_lo, b_hi, b_lo)))
    j = jds.ds_add_ds(*(jnp.asarray(v) for v in (a_hi, a_lo, b_hi, b_lo)))
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x.numpy(), _np(y))


def test_dsfloat_identities(rng):
    # port of tests/test_engine_core.py::test_dsfloat_identities
    a = rng.normal(size=128).astype(np.float32)
    b = (rng.normal(size=128) * 1e-6).astype(np.float32)
    s, e = tds.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        s.numpy().astype(np.float64) + e.numpy().astype(np.float64),
        a.astype(np.float64) + b.astype(np.float64),
    )
    x64 = rng.normal(size=64)
    hi, lo = tds.ds_from_f64(torch.from_numpy(x64))
    np.testing.assert_allclose(hi.double().numpy() + lo.double().numpy(),
                               x64, rtol=0, atol=1e-14)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_ds_from_f64_matches_jax(rng, as_tensor):
    x64 = rng.normal(size=256) * 10.0
    hi, lo = tds.ds_from_f64(torch.from_numpy(x64) if as_tensor else x64)
    hi_j, lo_j = jds.ds_from_f64(x64)
    np.testing.assert_array_equal(np.asarray(hi), _np(hi_j))
    np.testing.assert_array_equal(np.asarray(lo), _np(lo_j))
    assert np.asarray(hi).dtype == np.float32 and np.asarray(lo).dtype == np.float32


def test_ds_accumulation_beats_f32(rng):
    """Many tiny increments: ds32 keeps the f64 sum, plain f32 does not."""
    inc = torch.from_numpy((rng.uniform(0.5, 1.5, size=(2000, 64)) * 1e-7)
                           .astype(np.float32))
    hi = torch.ones(64, dtype=torch.float32)
    lo = torch.zeros(64, dtype=torch.float32)
    plain = torch.ones(64, dtype=torch.float32)
    for row in inc:
        hi, lo = tds.ds_add(hi, lo, row)
        plain = plain + row
    exact = 1.0 + inc.double().sum(0)
    err_ds = (tds.ds_to_f32(hi.double(), lo.double()) - exact).abs().max()
    err_f32 = (plain.double() - exact).abs().max()
    assert float(err_ds) < 1e-12 < float(err_f32)
