"""Force paths of the PyTorch port against the JAX package's.

The JAX Pallas kernel runs in interpret mode here, as in
tests/test_pallas_forces.py (small tiles). f32 tolerances are f32
reduction order: the two sides sum the same terms in different orders
(measured max |d acc| / max |acc| ~ 1.6e-7 at N = 1024), so 1e-5 leaves a
wide margin while still catching any wrong term. f64 paths agree to
rtol 1e-12.
"""
import numpy as np
import pytest
import torch

from orbital_tpu.ops import diagnostics as jdiag
from orbital_tpu.ops.forces import pairwise_acc_dense as j_dense
from orbital_tpu.ops.pallas_forces import pairwise_acc_pallas
from orbital_tpu.utils import native as jnative
from orbital_tpu_torch.ops import diagnostics as tdiag
from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda, pairwise_acc_plain
from orbital_tpu_torch.ops.forces import pairwise_acc_chunked, pairwise_acc_dense
from orbital_tpu_torch.utils import native as tnative

F32_RTOL = 1e-5


def _cluster(rng, n, dtype=np.float32, dead=0):
    pos = rng.normal(size=(n, 3)).astype(dtype)
    mass = rng.uniform(0.1, 2.0, n).astype(dtype)
    alive = np.ones(n, bool)
    if dead:
        alive[n - dead:] = False
        pos[n - dead:] = 0.0  # dead rows parked at the origin (coincident)
    return pos, mass, alive


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("eps2", [1e-4, 0.0])
@pytest.mark.parametrize("with_potential", [True, False])
def test_plain_matches_pallas_interpret(rng, n, eps2, with_potential):
    pos, mass, _ = _cluster(rng, n)
    a_ref, U_ref = pairwise_acc_pallas(pos, mass, G=1.0, eps2=eps2, tile_i=64,
                                       tile_j=128, with_potential=with_potential)
    before = pairwise_acc_cuda.launches
    a, U = pairwise_acc_cuda(*_t(pos, mass), G=1.0, eps2=eps2,
                             with_potential=with_potential)
    assert pairwise_acc_cuda.launches == before  # CPU tensors: plain version
    assert a.dtype == torch.float32 and tuple(a.shape) == (n, 3)
    assert _relerr(a.numpy(), a_ref) < F32_RTOL
    if with_potential:
        assert float(U) == pytest.approx(float(U_ref), rel=F32_RTOL)
    else:
        assert float(U) == 0.0 == float(U_ref)


@pytest.mark.parametrize("eps2", [1e-4, 0.0])
def test_alive_mask_and_padding_match_pallas(rng, eps2):
    pos, mass, alive = _cluster(rng, 256, dead=56)
    a_ref, U_ref = pairwise_acc_pallas(pos, mass, alive, G=1.0, eps2=eps2,
                                       tile_i=64, tile_j=128)
    for fn in (pairwise_acc_dense, pairwise_acc_chunked):
        a, U = fn(*_t(pos, mass, alive), G=1.0, eps2=eps2)
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_array_equal(a.numpy()[~alive], 0.0)
        assert _relerr(a.numpy()[alive], np.asarray(a_ref)[alive]) < F32_RTOL
        assert float(U) == pytest.approx(float(U_ref), rel=F32_RTOL)


@pytest.mark.parametrize("eps2", [1e-4, 0.0])
def test_f64_dense_and_ragged_chunked_match_jax(rng, eps2):
    pos, mass, alive = _cluster(rng, 300, np.float64, dead=20)
    a_ref, U_ref = j_dense(pos, mass, alive, G=1.3, eps2=eps2)
    a_d, U_d = pairwise_acc_dense(*_t(pos, mass, alive), G=1.3, eps2=eps2)
    a_c, U_c = pairwise_acc_chunked(*_t(pos, mass, alive), G=1.3, eps2=eps2,
                                    chunk=64)  # 300 = 4 * 64 + a ragged 44
    for a, U in ((a_d, U_d), (a_c, U_c)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-12, atol=1e-12)
        assert float(U) == pytest.approx(float(U_ref), rel=1e-12)


def test_plain_kernel_twin_matches_f64_oracle(rng):
    pos, mass, _ = _cluster(rng, 512, np.float64)
    a, U = pairwise_acc_plain(*_t(pos.astype(np.float32), mass.astype(np.float32)),
                              G=1.0, eps2=1e-4, chunk=100)
    a64 = tnative.accelerations_f64(pos, mass, 1e-4)
    assert _relerr(a.numpy(), a64) < F32_RTOL
    assert float(U) == pytest.approx(tnative.potential_f64(pos, mass, 1e-4), rel=F32_RTOL)


def test_cuda_wrapper_launches_or_raises(rng):
    """Off the CPU the wrapper launches its kernel or raises: a tensor on a
    device it does not serve raises instead of being computed some other
    way."""
    pos = torch.empty((8, 3), device="meta")
    mass = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pairwise_acc_cuda(pos, mass, G=1.0, eps2=1e-4)


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    from orbital_tpu_torch.utils import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if kernels.os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("nbody_forces")


def test_kernel_build_failure_reports_compiler_output(tmp_path, monkeypatch):
    from orbital_tpu_torch.utils import kernels

    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        kernels.load("fused_rollout")
    assert not list((tmp_path / "build").glob("*.so"))


def test_kernel_library_name_tracks_source_and_flags(monkeypatch):
    from orbital_tpu_torch.utils import kernels

    src, lib = kernels._library_path("nbody_forces")
    assert src.is_file() and lib.parent == kernels.BUILD_DIR
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-DX",))
    assert kernels._library_path("nbody_forces")[1] != lib


def test_diagnostics_match_jax(rng):
    pos, mass, _ = _cluster(rng, 64, np.float64)
    vel = rng.normal(size=(64, 3))
    tp, tv, tm = _t(pos, vel, mass)
    pairs = [
        (tdiag.kinetic_energy(tv, tm), jdiag.kinetic_energy(vel, mass)),
        (tdiag.total_energy(tv, tm, torch.tensor(-0.7, dtype=torch.float64)),
         jdiag.total_energy(vel, mass, -0.7)),
        (tdiag.angular_momentum(tp, tv, tm), jdiag.angular_momentum(pos, vel, mass)),
        (tdiag.momentum(tv, tm), jdiag.momentum(vel, mass)),
        (tdiag.barycenter(tp, tm), jdiag.barycenter(pos, mass)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13, atol=1e-15)


def test_native_oracle_binding(rng, monkeypatch):
    """The port's own binding to native/ agrees with the JAX package's, and
    its numpy path agrees with the oracle."""
    pos, mass, _ = _cluster(rng, 256, np.float64)
    assert tnative.backend() in ("oracle", "numpy")
    assert tnative.backend() == ("oracle" if jnative.HAVE_NATIVE else "numpy")
    U = tnative.potential_f64(pos, mass, 1e-4, G=1.3)
    acc = tnative.accelerations_f64(pos, mass, 1e-4, G=1.3)
    assert U == pytest.approx(jnative.potential_f64(pos, mass, 1e-4, G=1.3), rel=1e-13)
    np.testing.assert_allclose(acc, jnative.accelerations_f64(pos, mass, 1e-4, G=1.3),
                               rtol=1e-12)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    assert tnative.backend() == "numpy"
    assert tnative.potential_f64(pos, mass, 1e-4, G=1.3) == pytest.approx(U, rel=1e-12)
    np.testing.assert_allclose(tnative.accelerations_f64(pos, mass, 1e-4, G=1.3), acc,
                               rtol=1e-11)
