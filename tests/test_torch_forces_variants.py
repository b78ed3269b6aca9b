"""The exact-force variants of the PyTorch port (``force_impl="pallas_sym"``,
``"mxu"``, ``"pallas_mxu"``) and the block sweep (B3) against the JAX
package's: the plain versions of the CUDA kernels against JAX's Pallas
kernels in interpret mode (as tests/test_pallas_forces.py runs them), the
Gram form against JAX's, the contracts, the routing, KDK rollouts and
simulate().

Inputs come from a numpy seed. Tolerances:
  * half-pair sweep and block sweep: max |d acc| / max |acc| <= 1e-5 (and
    the pe row alike), the f32 reduction-order margin of
    tests/test_torch_forces.py; the half-pair plain version sums every
    ordered pair, the TPU kernel each unordered pair once (measured 3.6e-7).
  * Gram forms: max |d acc| / max |acc| <= 5e-4, the JAX package's own bound
    for this formula (tests/test_pallas_forces.py:413): both sides cancel
    |r_i|^2 + |r_j|^2 - 2 r_i.r_j in f32, and a one-ulp difference in that
    sum moves a close pair's weight by ~|r|^2 2^-24 / eps2 (measured here:
    3.8e-5 between the two "mxu" forms, 3.2e-4 between B13's plain version,
    which rounds each term of the dot on its own as the CUDA kernel does,
    and JAX's kernel). U to rel 1e-5.
  * KDK rollouts over 10 steps at dt = 1e-3: atol 1e-7 on positions and
    velocities for the half-pair sweep, as tests/test_torch_rollout.py (f64
    state runs every variant in f32 in both packages, so the same bound);
    the Gram forms' forces, up to GRAM_RTOL * max |a| apart, move the
    velocities by up to 10 dt GRAM_RTOL max |a| ~ 5e-6 max |a|: atol 1e-6
    (measured 1.2e-7, one f32 ulp at |v| ~ 1).
  * simulate() in ds32, 10 steps: 1e-6 of the largest |pos| and |vel| for
    the half-pair sweep, 1e-4 for the Gram kernel (its forces up to
    GRAM_RTOL apart; measured 3.8e-5). The bounce scene has contacts but no
    pile-ups: with radii 3x larger, a grazing pair's contact test flips on
    f32 rounding in ds32 (in either force path) and the runs part by 2%.
"""
import dataclasses
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import orbital_tpu as jot
import orbital_tpu_torch as tot
from orbital_tpu.models.scene import SceneArrays as JScene
from orbital_tpu.ops.forces import pairwise_acc_dense as j_dense
from orbital_tpu.ops.mxu_forces import pairwise_acc_mxu as j_mxu
from orbital_tpu.ops.pallas_forces import block_acc_pallas
from orbital_tpu.ops.pallas_forces_mxu import pairwise_acc_pallas_mxu
from orbital_tpu.ops.pallas_forces_sym import pairwise_acc_pallas_sym
from orbital_tpu_torch.engine import rollout as R
from orbital_tpu_torch.models.scene import SceneArrays as TScene
from orbital_tpu_torch.ops import cuda_forces, cuda_forces_mxu, cuda_forces_sym, cuda_jerk
from orbital_tpu_torch.ops import mxu_forces

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F32_RTOL = 1e-5
GRAM_RTOL = 5e-4
GRAM_MAX_RTOL = 5e-3
EPS2 = 1e-4
IMPLS = ("pallas_sym", "mxu", "pallas_mxu")


def _bodies(n, seed, dead=0):
    """f32 positions ~ N(0, 1), masses in [0.1, 2]; ``dead`` bodies at the end
    parked far apart, as make_state parks padding."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    alive = np.ones(n, bool)
    if dead:
        alive[-dead:] = False
        pos[-dead:] = 1e6 * (1.0 + np.arange(dead, dtype=np.float32))[:, None]
    return pos, mass, alive


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def n512():
    return {dead: _bodies(512, 11, dead) for dead in (0, 12)}


# ---------------------------------------------------------------------------
# the plain versions against JAX's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [0, 12])
def test_sym_plain_matches_jax_kernel(n512, dead):
    """B12's plain version against ``pairwise_acc_pallas_sym`` at N = 512,
    tile 128 (interpret mode): acc within 1e-5, dead rows 0, U == 0."""
    pos, mass, alive = n512[dead]
    a_j, U_j = pairwise_acc_pallas_sym(pos, mass, alive, G=1.5, eps2=EPS2, tile=128)
    a, U = cuda_forces_sym.pairwise_acc_sym_cuda(*_t(pos, mass, alive), G=1.5, eps2=EPS2)
    assert a.dtype == torch.float32 and float(U) == 0.0 and float(U_j) == 0.0
    assert _rel(a.numpy()[alive], np.asarray(a_j)[alive]) < F32_RTOL
    np.testing.assert_array_equal(a.numpy()[~alive], 0.0)


@pytest.mark.parametrize("with_potential", [True, False])
def test_mxu_forces_matches_jax(n512, with_potential):
    """The Gram form (``force_impl="mxu"``) against JAX's, chunk 128."""
    pos, mass, alive = n512[12]
    kw = dict(G=1.0, eps2=EPS2, chunk=128, with_potential=with_potential)
    a_j, U_j = j_mxu(pos, mass, alive, **kw)
    a, U = mxu_forces.pairwise_acc_mxu(*_t(pos, mass, alive), **kw)
    assert _rel(a.numpy(), np.asarray(a_j)) < GRAM_RTOL
    if with_potential:
        assert float(U) == pytest.approx(float(U_j), rel=F32_RTOL)
    else:
        assert float(U) == 0.0
    np.testing.assert_array_equal(a.numpy()[~alive], 0.0)


def test_mxu_forces_float64_reference(n512):
    """The f64 compute type of the Gram form is the exact sum to ~1e-12."""
    pos, mass, alive = (x.astype(np.float64) if x.dtype == np.float32 else x
                        for x in n512[0])
    a, U = mxu_forces.pairwise_acc_mxu(*_t(pos, mass, alive), G=1.0, eps2=EPS2, chunk=256,
                                       _dtype=torch.float64)
    a_ref, U_ref = tot.ops.forces.pairwise_acc_dense(*_t(pos, mass, alive), G=1.0, eps2=EPS2)
    assert a.dtype == torch.float64 and _rel(a.numpy(), a_ref.numpy()) < 1e-10
    assert float(U) == pytest.approx(float(U_ref), rel=1e-12)


@pytest.mark.parametrize("with_potential", [True, False])
def test_gram_plain_matches_jax_kernel(n512, with_potential):
    """B13's plain version (r2 as the packed 8-deep product) against
    ``pairwise_acc_pallas_mxu`` at tiles 64 x 128 (interpret mode); its
    PE-off acc is bit-equal to its PE-on acc and U is 0."""
    pos, mass, alive = n512[12]
    a_j, U_j = pairwise_acc_pallas_mxu(pos, mass, alive, G=1.0, eps2=EPS2, tile_i=64,
                                       tile_j=128, with_potential=with_potential)
    a, U = cuda_forces_mxu.pairwise_acc_mxu_cuda(*_t(pos, mass, alive), G=1.0, eps2=EPS2,
                                                 with_potential=with_potential)
    assert _rel(a.numpy(), np.asarray(a_j)) < GRAM_RTOL
    np.testing.assert_array_equal(a.numpy()[~alive], 0.0)
    if with_potential:
        assert float(U) == pytest.approx(float(U_j), rel=F32_RTOL)
    else:
        a_pe, _ = cuda_forces_mxu.pairwise_acc_mxu_cuda(*_t(pos, mass, alive), G=1.0,
                                                        eps2=EPS2)
        np.testing.assert_array_equal(a.numpy(), a_pe.numpy())
        assert float(U) == 0.0 and float(U_j) == 0.0


# ---------------------------------------------------------------------------
# the Gram kernel's TF32 split: a torch mirror of csrc/nbody_forces_mxu.cu,
# its K slots and its fragment permutation read from the kernel's source
# ---------------------------------------------------------------------------

MXU_SOURCE = (Path(__file__).resolve().parents[1] / "orbital_tpu_torch" / "csrc"
              / "nbody_forces_mxu.cu")


def _mxu_source_fn(name):
    """The body of the kernel source's function ``name``."""
    src = MXU_SOURCE.read_text()
    body = src[src.index(f"void {name}("):]
    return body[:body.index("\n}\n")]


def _tf32_round(x):
    """float32 ``x`` rounded to TF32 (11 significant bits), to nearest with
    ties away from zero, as the kernel's tf32() and ``cvt.rna.tf32.f32``:
    0x1000 added to the magnitude bits, the low 13 cleared."""
    u = x.contiguous().view(torch.int32)
    mag = ((u & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | (u & -0x80000000)).view(torch.float32)


def _tf32_split(x):
    """The kernel's split(): hi = rna(x), mid = rna(x - hi), lo = x - hi -
    mid, exact (the pieces add back to x bit for bit)."""
    hi = _tf32_round(x)
    rest = x - hi
    mid = _tf32_round(rest)
    return [hi, mid, rest - mid]


def _gram_slots(rows, side):
    """The K slots of the kernel's r2 products for packed rows, [N, 24], in
    the order of the kernel's a_rows() (side "A": the pieces of -2x, -2y,
    -2z and |r_i|^2) or b_rows() (side "B": of x, y, z and |r_j|^2)."""
    cols = (0, 1, 2, 3) if side == "A" else (0, 1, 2, 4)
    values = {"1.0f": torch.ones(rows.shape[0]), "0.0f": torch.zeros(rows.shape[0])}
    for v, c in zip("xyzn", cols):
        for piece, part in zip("hml", _tf32_split(rows[:, c].contiguous())):
            values[f"{v}.{piece}"] = part
    body = _mxu_source_fn("a_rows" if side == "A" else "b_rows")
    table = re.findall(r"const float r\d\[8\] = \{([^}]*)\};", body)
    assert len(table) == 3
    return torch.stack([values[x.strip()] for row in table for x in row.split(",")], dim=1)


def test_tf32_split_is_exact():
    """The kernel's three-piece TF32 split of f32 values, from 1e-30 to the
    1e17 of parked bodies and of both signs: the pieces add back bit for
    bit, and each has its low 13 mantissa bits clear (what the tensor
    cores read of it is all of it). Round to nearest is ties away."""
    rng = np.random.default_rng(21)
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-30, 17, 4096)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([x, [0.0, -2.0, 1e17, 1.0 + 2 ** -23]]).astype(
        np.float32))
    hi, mid, lo = _tf32_split(x)
    assert torch.equal(hi + (mid + lo), x) and torch.equal(mid + lo, x - hi)
    for piece in (hi, mid, lo):
        assert not bool((piece.view(torch.int32) & 0x1FFF).any())
    assert _tf32_round(torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                                     1.0 + 2 ** -12])).tolist() == \
        [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0]


def test_split_r2_keeps_the_gram_gates():
    """r2 as the kernel forms it, its 24 K slots summed in f32 in its order
    (a model of the tensor-core accumulator, not of its rounding, which only
    the card shows), on a 1,024-body Gaussian cluster at eps2 = 1e-4: the
    accelerations within GRAM_RTOL in RMS and GRAM_MAX_RTOL in max of the
    JAX package's dense sum in f64, as chip_smoke.py holds the kernel, and
    no farther from it in RMS than the plain version (one fixed order of
    the exact f32 dot). Measured: RMS 6.5e-5, max 2.2e-4; the plain version
    1.1e-4, 5.4e-4."""
    n = 1024
    rng = np.random.default_rng(3)
    pos, mass = rng.normal(size=(n, 3)), rng.uniform(0.5, 1.5, n) / n
    p32, m32 = _t(pos.astype(np.float32), mass.astype(np.float32))
    a64, _ = j_dense(pos, mass, G=1.0, eps2=EPS2)
    a64 = torch.from_numpy(np.array(a64, np.float64))
    iA, jB = cuda_forces_mxu.pack_gram(p32, m32)
    a, b = _gram_slots(iA, "A"), _gram_slots(jB, "B")
    r2 = torch.zeros((n, n), dtype=torch.float32)
    for k in range(a.shape[1]):
        r2 = r2 + a[:, k, None] * b[None, :, k]
    with mxu_forces.full_f32_matmul():
        s, _ = mxu_forces.gram_rows(r2, 0, jB[:, 0:4], m32, EPS2, False)
    acc = (s[:, 0:3] - p32 * s[:, 3:4]).double()
    rms = float((acc - a64).norm() / a64.norm())
    worst = float((acc - a64).abs().max() / a64.abs().max())
    print(f"3-piece r2 vs the f64 sum at N={n}: RMS {rms:.2e}, max {worst:.2e}")
    assert rms < GRAM_RTOL and worst < GRAM_MAX_RTOL
    a0, _ = cuda_forces_mxu.pairwise_acc_mxu_plain(p32, m32, G=1.0, eps2=EPS2)
    assert rms <= float((a0.double() - a64).norm() / a64.norm())


def test_r2_columns_match_the_ptx_fragment_layouts():
    """The permutation pi of the r2 product's columns, read from the kernel's
    stage() (the lane of chunk slot s writes B column n(s), so pi(n(s)) = s),
    and the element order in which sweep_tile() passes the weights on,
    against the PTX ISA's m16n8k8 layouts (g = lane / 4, t = lane % 4): C
    element e of a thread is (row g + 8 (e // 2), column 2t + e % 2), A
    element e is (row g + 8 (e % 2), column t + 4 (e // 2)). The weight of
    C's (g, 2t + e) belongs to j body pi(2t + e) = t + 4e, which must be A's
    column in the S product."""
    cond, low, high = re.search(r"const int n = s < (\d+) \? ([^:]+) : ([^;]+);",
                                _mxu_source_fn("stage")).groups()
    pi = [0] * 8
    for s_ in range(8):
        pi[eval(low if s_ < int(cond) else high, {"s": s_})] = s_
    order = [int(x) for x in re.search(r"const int order\[4\] = \{([^}]*)\};",
                                       _mxu_source_fn("sweep_tile")).group(1).split(",")]
    assert sorted(pi) == list(range(8)) and sorted(order) == list(range(4))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(4):
            c_row, c_col = g + 8 * (order[e] // 2), 2 * t + order[e] % 2
            a_row, a_col = g + 8 * (e % 2), t + 4 * (e // 2)
            assert c_row == a_row and pi[c_col] == a_col


def test_split_slots_pair_the_dot_terms():
    """The kernel's 24 K slots pair each kept piece product once: summed in
    f64 they give |r_i|^2 + |r_j|^2 - 2 r_i.r_j up to the dropped piece
    products, each < 2^-22 of the largest."""
    pos, mass, _ = _bodies(64, 9)
    iA, jB = cuda_forces_mxu.pack_gram(*_t(pos, mass))
    a, b = _gram_slots(iA, "A").double(), _gram_slots(jB, "B").double()
    assert a.shape == (64, 24) and b.shape == (64, 24)
    r2 = a @ b.T
    p = torch.from_numpy(pos.astype(np.float64))
    exact = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    sq = torch.from_numpy(pos.astype(np.float32)).double().pow(2).sum(-1)
    scale = float((sq[:, None] + sq[None, :]).max())
    assert float((r2 - exact).abs().max()) < 2 ** -20 * scale


@pytest.mark.parametrize("n_i,n_j,same", [(256, 512, False), (512, 256, False),
                                          (512, 512, True)])
def test_block_plain_matches_jax_kernel(n_i, n_j, same):
    """B3's plain version against ``block_acc_pallas`` (interpret mode): acc
    and the pe row, whose i == j term stays where the tables coincide."""
    pos_j, mass_j, _ = _bodies(n_j, 5)
    pos_i = pos_j if same else _bodies(n_i, 6)[0]
    a_j, pe_j = block_acc_pallas(pos_i, pos_j, mass_j, G=1.0, eps2=EPS2, tile_i=128,
                                 tile_j=128)
    a, pe = cuda_forces.block_acc_cuda(*_t(pos_i, pos_j, mass_j), G=1.0, eps2=EPS2)
    assert a.shape == (n_i, 3) and pe.shape == (n_i,)
    assert _rel(a.numpy(), np.asarray(a_j)) < F32_RTOL
    assert _rel(pe.numpy(), np.asarray(pe_j)) < F32_RTOL
    if same:  # the self term m_i / eps is in the row
        full, _ = cuda_forces.pairwise_acc_plain(*_t(pos_i, mass_j), G=1.0, eps2=EPS2)
        assert _rel(a.numpy(), full.numpy()) < F32_RTOL
        pe_free = pe.numpy() - mass_j / np.sqrt(EPS2)
        assert float(-0.5 * np.sum(mass_j * pe_free)) == pytest.approx(
            float(cuda_forces.pairwise_acc_plain(*_t(pos_i, mass_j), G=1.0, eps2=EPS2)[1]),
            rel=F32_RTOL)


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def _raises(fn, n, **kw):
    pos, mass, alive = _t(*_bodies(n, 3))
    return lambda: fn(pos, mass, alive, G=1.0, **kw)


@pytest.mark.parametrize("case", [
    "sym_eps0", "sym_n", "gram_eps0", "gram_n", "mxu_eps0", "mxu_chunk", "block_eps0",
    "block_n"])
def test_contracts_raise(case):
    """Each contract's ValueError, on the CPU path as in JAX."""
    calls = {
        "sym_eps0": _raises(cuda_forces_sym.pairwise_acc_sym_cuda, 512, eps2=0.0),
        "sym_n": _raises(cuda_forces_sym.pairwise_acc_sym_cuda, 5000, eps2=EPS2),
        "gram_eps0": _raises(cuda_forces_mxu.pairwise_acc_mxu_cuda, 512, eps2=0.0),
        "gram_n": _raises(cuda_forces_mxu.pairwise_acc_mxu_cuda, 1000, eps2=EPS2),
        "mxu_eps0": _raises(mxu_forces.pairwise_acc_mxu, 512, eps2=0.0),
        "mxu_chunk": _raises(mxu_forces.pairwise_acc_mxu, 1000, eps2=EPS2, chunk=512),
        "block_eps0": lambda: cuda_forces.block_acc_cuda(
            *_t(*_bodies(256, 1)[:1], *_bodies(256, 2)[:2]), G=1.0, eps2=0.0),
        "block_n": lambda: cuda_forces.block_acc_cuda(
            *_t(*_bodies(200, 1)[:1], *_bodies(256, 2)[:2]), G=1.0, eps2=EPS2),
    }
    with pytest.raises(ValueError):
        calls[case]()


def test_tile_rules_copy_jax():
    """The port's copies of the tile rules raise where JAX's raise and pick
    JAX's tiles."""
    from orbital_tpu.ops.pallas_forces import _pick_tiles

    for n in (64, 128, 200, 384, 1000, 4992, 5000, 65536, 65600, 131072, 131200):
        try:
            _pick_tiles(n, 512, 2048)
            jax_raises = False
        except ValueError:
            jax_raises = True
        try:
            cuda_forces_mxu.check_tiles(n)
            port_raises = False
        except ValueError:
            port_raises = True
        assert port_raises == jax_raises, n
    assert [cuda_forces_sym.sym_tile(n, EPS2) for n in (4992, 65536, 768)] == [128, 512, 256]


# ---------------------------------------------------------------------------
# routing and the no-fallback rule
# ---------------------------------------------------------------------------

_PLAIN = {"pallas_sym": (cuda_forces_sym, "pairwise_acc_sym_plain"),
          "pallas_mxu": (cuda_forces_mxu, "pairwise_acc_mxu_plain"),
          "mxu": (mxu_forces, "pairwise_acc_mxu")}
_KERNEL = {"pallas_sym": (cuda_forces_sym, "pairwise_acc_sym_cuda"),
           "pallas_mxu": (cuda_forces_mxu, "pairwise_acc_mxu_cuda")}


def _spy(monkeypatch, mod, name, calls):
    inner = getattr(mod, name)

    def fn(*a, **k):
        calls.append(name)
        return inner(*a, **k)
    monkeypatch.setattr(mod, name, fn)


@pytest.mark.parametrize("impl", IMPLS)
def test_routing_cpu_takes_the_plain_version(impl, monkeypatch):
    """On CPU tensors each policy reaches its plain version at any N; no
    detecting variant; no "auto" routes to them."""
    calls = []
    _spy(monkeypatch, *_PLAIN[impl], calls)
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2, force_impl=impl, chunk=256)
    pos, mass, alive = _t(*_bodies(256, 4))
    a, U = R.resolve_force_fn(cfg, 256, "cpu")(pos, mass, alive)
    assert calls == [_PLAIN[impl][1]] and a.shape == (256, 3)
    assert R.resolve_force_detect_fn(cfg, 256, "cpu") is None
    calls.clear()
    R.resolve_force_fn(cfg.replace(force_impl="auto"), 256, "cpu")(pos, mass, alive)
    assert not calls


@pytest.mark.parametrize("impl", IMPLS)
def test_routing_cuda_takes_the_kernel(impl, monkeypatch):
    """On "cuda" each kernel policy reaches its wrapper (monkeypatched to its
    plain version here) at any N, "mxu" the plain-torch Gram form; the
    detect fn is None, and Hermite still reaches the acc + jerk kernel."""
    calls = []
    for mod, name in _KERNEL.values():
        plain = getattr(mod, name.replace("_cuda", "_plain"))
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _p=plain, **k: (
            calls.append(_n), _p(*a, **k))[1])
    _spy(monkeypatch, mxu_forces, "pairwise_acc_mxu", calls)
    monkeypatch.setattr(cuda_jerk, "accel_jerk_cuda", lambda *a, **k: (
        calls.append("accel_jerk_cuda"), cuda_jerk.accel_jerk_plain(*a, **k))[1])
    cfg = tot.SimConfig(dt=1e-3, eps2=EPS2, force_impl=impl, chunk=256,
                        track_potential=False)
    pos, mass, alive = _t(*_bodies(256, 4))
    R.resolve_force_fn(cfg, 256, "cuda")(pos, mass, alive)
    want = _KERNEL[impl][1] if impl in _KERNEL else "pairwise_acc_mxu"
    assert calls == [want]
    assert R.resolve_force_detect_fn(cfg, 256, "cuda") is None
    calls.clear()
    n = 4160
    pos, mass, alive = _t(*_bodies(n, 4))
    vel = torch.zeros_like(pos)
    R.resolve_accel_jerk_fn(cfg.replace(integrator="hermite"), n, "cuda")(pos, vel, mass,
                                                                          alive)
    assert calls == ["accel_jerk_cuda"]
    # f64 state takes the same kernel route (f32 inside), as the JAX package
    calls.clear()
    pos, mass, alive = _t(*_bodies(256, 4))
    R.resolve_force_fn(cfg, 256, "cuda", torch.float64)(pos.double(), mass.double(), alive)
    assert calls == [want]


@pytest.mark.parametrize("wrapper", ["sym", "gram", "block"])
def test_wrapper_raises_when_its_library_fails_to_load(wrapper, monkeypatch):
    """A wrapper whose kernel library cannot be built raises; it does not
    compute the plain version instead. (The device check is bypassed so that
    meta tensors stand in for CUDA ones up to the launch.)"""
    from orbital_tpu_torch.utils import kernels

    def broken(name):
        raise RuntimeError(f"nvcc failed to build {name}.cu")

    monkeypatch.setattr(kernels, "load", broken)
    monkeypatch.setattr(cuda_forces, "_check_inputs", lambda *a: None)
    monkeypatch.setattr(cuda_forces_mxu, "_check_packed", lambda *a: None)
    mod = {"sym": cuda_forces_sym, "gram": cuda_forces_mxu, "block": cuda_forces}[wrapper]
    monkeypatch.setattr(mod, "_lib", None)
    pos = torch.empty((512, 3), device="meta")
    mass = torch.empty((512,), device="meta")
    call = {"sym": lambda: cuda_forces_sym.pairwise_acc_sym_cuda(pos, mass, G=1.0, eps2=EPS2),
            "gram": lambda: cuda_forces_mxu.pairwise_acc_mxu_cuda(pos, mass, G=1.0,
                                                                  eps2=EPS2),
            "block": lambda: cuda_forces.block_acc_cuda(pos, pos, mass, G=1.0, eps2=EPS2)}
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call[wrapper]()
    with pytest.raises(ValueError, match="unsupported device"):
        monkeypatch.undo()
        call[wrapper]()


# ---------------------------------------------------------------------------
# rollouts and simulate()
# ---------------------------------------------------------------------------

def _port_state(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    return tot.engine.state.state_from_arrays(
        {k: None if v is None else np.asarray(v) for k, v in fields.items()}, device="cpu")


@pytest.mark.parametrize("precision", ["f32", "ds32", "f64"])
@pytest.mark.parametrize("impl", IMPLS)
def test_kdk_rollout_matches_jax(impl, precision):
    """10 KDK steps at N = 256 against ``rollout_jit`` (JAX's Pallas kernels
    in interpret mode), recorded every 5."""
    rng = np.random.default_rng(21)
    n = 256
    pos, vel = rng.normal(size=(n, 3)), 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    jcfg = jot.SimConfig(dt=1e-3, G=1.0, eps2=EPS2, force_impl=impl)
    tcfg = tot.SimConfig(**dataclasses.asdict(jcfg))
    js = jot.make_state(pos, vel, mass, precision=precision)
    ts = tot.init_forces(_port_state(js), tcfg)
    js = jot.init_forces(js, jcfg)
    np.testing.assert_allclose(ts.acc.numpy(), np.asarray(js.acc), rtol=0,
                               atol=(F32_RTOL if impl == "pallas_sym" else GRAM_RTOL)
                               * float(np.abs(np.asarray(js.acc)).max()))
    jf, jtr = jot.rollout_jit(js, jcfg, 10, 5)
    tf, ttr = tot.rollout(ts, tcfg, 10, 5)
    atol = 1e-7 if impl == "pallas_sym" else 1e-6
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(ttr, f).numpy(), np.asarray(getattr(jtr, f)),
                                   rtol=0, atol=atol, err_msg=f)
    # the f32 potential (kinetic only under "pallas_sym", whose U is 0)
    np.testing.assert_allclose(ttr.energy.numpy(), np.asarray(jtr.energy), rtol=1e-5)
    assert int(tf.step) == 10 and tf.pos.dtype == ts.pos.dtype


def _scenes(n=256, seed=31, radius=1e-3):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 1e9
    vel = rng.normal(size=(n, 3)) * 10.0
    mass = rng.uniform(0.5, 1.5, n) * 1e27
    kw = dict(pos=pos, vel=vel, mass=mass, radius=np.full(n, radius),
              names=[f"b{i}" for i in range(n)])
    return JScene(**kw), TScene(**kw)


@pytest.mark.parametrize("impl,collisions,radius", [("pallas_sym", "none", 1e3),
                                                    ("pallas_mxu", "none", 1e3),
                                                    ("pallas_sym", "bounce", 5e7)])
def test_simulate_matches_jax(impl, collisions, radius):
    """simulate() in ds32 (natural units) against JAX's, 10 steps recorded
    every 5; the bounce case has contacts (its sweep runs ungated every
    step in both packages)."""
    js, ts = _scenes(radius=radius)
    kw = dict(steps=10, dt=10.0, softening=1e7, record_every=5, precision="ds32",
              force_impl=impl, collisions=collisions, restitution=0.5)
    ref = jot.simulate(js, **kw)
    out = tot.simulate(ts, device="cpu", **kw)
    assert out.config.force_impl == impl and out.config.collisions == collisions
    tol = 1e-6 if impl == "pallas_sym" else 1e-4
    for f in ("pos", "vel"):
        a, b = getattr(out, f), getattr(ref, f)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(), err_msg=f)
    if collisions == "bounce":
        free = tot.simulate(ts, device="cpu", **dict(kw, collisions="none"))
        assert np.abs(out.vel - free.vel).max() > 1e-3 * np.abs(free.vel).max()
