"""Force paths of the PyTorch port against the JAX package's.

The JAX Pallas kernel runs in interpret mode here, as in
tests/test_pallas_forces.py (small tiles). f32 tolerances are f32
reduction order: the two sides sum the same terms in different orders
(measured max |d acc| / max |acc| ~ 1.6e-7 at N = 1024), so 1e-5 leaves a
wide margin while still catching any wrong term. f64 paths agree to
rtol 1e-12.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from orbital_tpu.ops import diagnostics as jdiag
from orbital_tpu.ops.forces import pairwise_acc_dense as j_dense
from orbital_tpu.ops.pallas_forces import pairwise_acc_pallas
from orbital_tpu_torch.ops import diagnostics as tdiag
from orbital_tpu_torch.ops.cuda_forces import pairwise_acc_cuda, pairwise_acc_plain
from orbital_tpu_torch.ops.forces import pairwise_acc_chunked, pairwise_acc_dense
from orbital_tpu_torch.utils import native as tnative

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

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


def test_compile_libraries_passes_extra_flags(tmp_path, monkeypatch):
    """Each job gets its own nvcc with the build flags and its extra flags,
    and its library lands under the name asked for."""
    import chip_smoke
    from orbital_tpu_torch.utils import kernels

    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\necho "$@"\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    src = kernels.CSRC_DIR / "nbody_forces.cu"
    outs = [tmp_path / "v" / f"lib{k}.so" for k in (1, 4)]
    done = chip_smoke.compile_libraries([(src, out, (f"-DOT_FORCES_K={k}",))
                                         for out, k in zip(outs, (1, 4))])
    for out, k in zip(outs, (1, 4)):
        log, seconds = done[out]
        assert out.is_file() and seconds >= 0.0
        assert "arch=compute_90a,code=sm_90a" in log and f"-DOT_FORCES_K={k}" in log
    assert chip_smoke.sass(outs[0]) == ""  # no cuobjdump beside this nvcc


def test_ptxas_usage_reads_registers_and_spills():
    import chip_smoke

    log = """ptxas info    : Compiling entry function '_Z3fooILb1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILb1EEvv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 93 registers, used 1 barriers, 16384 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 400 bytes cmem[0]
"""
    assert chip_smoke.ptxas_usage(log) == {"_Z3fooILb1EEvv": (93, 8, 4), "_Z3barv": (40, 0, 0)}


def test_inner_loop_counts_warp_instructions_a_pair():
    """The innermost loop with the most MUFU.RSQ, its instructions over
    them, in cuobjdump's form (address targets) and nvdisasm's (labels)."""
    import chip_smoke

    sass = """
\tcode for sm_90a
\t\tFunction : _Z6sweepv
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   FADD R2, R3, -R4 ;
        /*0020*/                   MUFU.RSQ R5, R2 ;
        /*0030*/                   FFMA R6, R5, R5, R6 ;
        /*0040*/                   MUFU.RSQ R7, R2 ;
        /*0050*/              @P0 BRA 0x10 ;
        /*0060*/                   MUFU.RSQ R7, R2 ;
        /*0070*/              @P1 BRA 0x60 ;
        /*0080*/                   BRA 0x0 ;
        /*0090*/                   EXIT ;
\t\tFunction : _Z4tailv
.L_x_1:
        /*0000*/                   LDS.128 R8, [R2] ;
        /*0010*/                   MUFU.RSQ R5, R2 ;
        /*0020*/                   FADD R2, R3, R4 ;
        /*0030*/              @!P1 BRA `(.L_x_1) ;
        /*0040*/                   EXIT ;
\t\tFunction : _Z4nonev
        /*0000*/                   EXIT ;
"""
    assert chip_smoke.inner_loop(sass) == {"_Z6sweepv": (5, 2), "_Z4tailv": (4, 1)}


def _ptxas_log(stems, spill=0):
    return "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{stem}EEvv' for "
        f"'sm_90a'\n    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used 93 registers, used 1 barriers\n" for stem in stems)


def test_launch_record_requires_each_instantiation():
    """Phase 2's record of a template: the shape its C function reports,
    registers and spills of each instantiation; an instantiation missing
    from the ptxas output, or from SASS that was read, raises."""
    import types

    import chip_smoke

    def shape(n, arr):
        for i, v in enumerate((4, 16, 128, 512, (n + 127) // 128)):
            arr[i] = v

    lib = types.SimpleNamespace(nbody_forces_shape=shape)
    stems = chip_smoke.SHAPED["nbody_forces"][1]
    log = _ptxas_log(stems.values())
    recs = chip_smoke.launch_record(lib, "nbody_forces", log, "", n=5000)
    assert sorted(recs) == ["B1", "B2", "B3"]
    assert recs["B2"] == {"shape": {"k": 4, "q": 16, "tile": 128, "threads": 512, "blocks": 40},
                          "registers": 93, "spill_bytes": 0,
                          "sass_slots_per_pair": "not measured"}
    with pytest.raises(AssertionError, match="B2: no entry function"):
        chip_smoke.launch_record(lib, "nbody_forces",
                                 _ptxas_log(v for k, v in stems.items() if k != "B2"), "")
    with pytest.raises(AssertionError, match="B1: no loop with MUFU.RSQ"):
        chip_smoke.launch_record(lib, "nbody_forces", log, "\t\tFunction : _Z3foov\n")


_HMMA_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_111gram_kernelILb0EEEvPK6float4S3_ifPS1_Pf
        /*0000*/                   LDS.128 R8, [R2] ;
        /*0010*/                   HMMA.1688.F32.TF32 R12, R4, R8, RZ ;
        /*0020*/                   MUFU.RSQ R5, R2 ;
        /*0030*/                   FMUL R6, R5, R5 ;
        /*0040*/                   HMMA.1688.F32.TF32 R16, R4, R8, R16 ;
        /*0050*/                   MUFU.RSQ R7, R3 ;
        /*0060*/              @P0 BRA 0x0 ;
        /*0070*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_113bounce_kernelEPKfS1_S1_S1_PKbifPKiPfS6_
        /*0000*/                   LDS.128 R8, [R2] ;
        /*0010*/                   FADD R2, R8, -R4 ;
        /*0020*/                   FMNMX R6, R2, R6, PT ;
        /*0030*/                   FMNMX R7, R2, R7, PT ;
        /*0040*/              @P0 BRA 0x0 ;
        /*0050*/                   MUFU.RSQ R5, R2 ;
        /*0060*/                   FSETP.GT.AND P1, PT, R2, R3, PT ;
        /*0070*/              @P1 BRA 0x50 ;
        /*0080*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_115sym_tile_kernelILi128EEEvPK6float4ifPf
        /*0000*/                   MUFU.RSQ R5, R2 ;
        /*0010*/              @P0 BRA 0x0 ;
        /*0020*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_115sym_tile_kernelILi512EEEvPK6float4ifPf
        /*0000*/                   LDS.128 R8, [R2] ;
        /*0010*/                   FADD R2, R8, -R4 ;
        /*0020*/                   MUFU.RSQ R5, R2 ;
        /*0030*/                   FFMA R6, R5, R5, R6 ;
        /*0040*/                   MUFU.RSQ R7, R3 ;
        /*0050*/                   STS.128 [R2], R8 ;
        /*0060*/              @P0 BRA 0x0 ;
        /*0070*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_116tree_near_kernelEPK6float4PKiS4_iiiiffPS0_
        /*0000*/                   LDG.E.128 R8, [R2] ;
        /*0010*/              @P0 BRA 0x0 ;
        /*0020*/                   LDS.128 R8, [R2] ;
        /*0030*/                   FSETP.GTU.AND P1, PT, |R2|, R3, PT ;
        /*0040*/                   MUFU.RSQ R5, R2 ;
        /*0050*/              @P1 BRA 0x20 ;
        /*0060*/                   EXIT ;
"""


@pytest.mark.parametrize("name,key", [("nbody_forces_mxu", "B13"), ("collisions", "B6"),
                                      ("nbody_forces_sym", "B12"), ("tree_near", "B7")])
def test_launch_record_of_the_gram_and_bounce_kernels(name, key):
    """Phase 2's records of B13, B6, B12 and B7: the shape their C functions
    report, instructions a pair over the pair marker of each (MUFU.RSQ; B6's
    FMNMX, not the exact pass's FSETP; B12's 512-row instantiation, not the
    128-row one; B7's sweep loop, not its staging loop), B13's TF32 HMMA
    count in that loop, and the issue floor each implies (B12 over its tile
    pairs' unordered pairs, B7's left to phase 24, which counts its visited
    pairs); B13 without HMMA in its inner loop (the tensor cores unused)
    raises, and so does an instantiation missing from the ptxas output."""
    import types

    import chip_smoke

    shape_fn, stems, _ = chip_smoke.SHAPED[name]

    def shape(n, arr):
        for i, v in enumerate((2, 4, 32, 128, n // 32)):
            arr[i] = v

    lib = types.SimpleNamespace(**{shape_fn: shape})
    log = _ptxas_log(stems.values())
    recs = chip_smoke.launch_record(lib, name, log, _HMMA_SASS, n=4992)
    assert sorted(recs) == [key]
    rec = recs[key]
    assert rec["shape"] == {"k": 2, "q": 4, "tile": 32, "threads": 128, "blocks": 156}
    assert rec["registers"] == 93 and rec["spill_bytes"] == 0
    assert rec["sass_slots_per_pair"] == {"B13": 3.5, "B6": 2.5, "B12": 3.5, "B7": 4.0}[key]
    assert rec.get("tf32_hmma_in_loop") == (2 if key == "B13" else None)
    pairs = {"B12": 156 * 32 * 32, "B7": None}.get(key, 4992 * 4992)
    assert chip_smoke.loop_pairs(key, rec, 4992) == pairs
    floor = ("from the visited pairs, phase 24" if key == "B7" else
             f"{chip_smoke.issue_floor_ms(rec['sass_slots_per_pair'], pairs):.3f} ms")
    assert f"(issue floor {floor})" in chip_smoke.describe_launch(key, rec, 4992)
    if key == "B13":
        assert chip_smoke.describe_launch(key, rec).endswith("2 TF32 HMMA in the inner loop")
        with pytest.raises(AssertionError, match="tensor cores are not in use"):
            chip_smoke.launch_record(lib, name, log, _HMMA_SASS.replace("HMMA.1688.F32.TF32",
                                                                          "FFMA"))
    with pytest.raises(AssertionError, match=f"{key}: no entry function"):
        chip_smoke.launch_record(lib, name, _ptxas_log(["other"]), "")


def test_parent_and_sweep_cover_the_redesigned_kernels(monkeypatch):
    """--parent and --sweep reach all eight redesigned sources: each has its
    exported functions, sweep shapes (k, q) and shape macro; each call of
    exact_calls, tree_calls, near_calls and fused_calls (at small sizes) is
    held by its tolerances (on the CPU the wrappers take their plain
    versions, so each holds with 0), B13 and B12 only where eps2 > 0, B13's
    S against the exact S within GRAM_S_RTOL in RMS and GRAM_MAX_RTOL in max
    and its pe by the Gram gates against the reference, B6 gated and
    ungated, B7's starved near phase with its overflow > 0, and B4 held to
    STATE_ATOL on its state."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    smoke = chip_smoke.Smoke(0, 10)
    smoke.dev = torch.device("cpu")
    for name in chip_smoke.SHAPED:
        assert name in chip_smoke.LIB_FUNCS and name in chip_smoke.SWEEP_MACRO
        assert chip_smoke.SWEEP[name] and name in smoke.TIMED
        for key in chip_smoke.SHAPED[name][1]:
            assert smoke.SOURCE[key] == name and key in smoke.TOLS
    assert all(len(s) == 2 for shapes in chip_smoke.SWEEP.values() for s in shapes)
    scene = smoke.scene(640, 0.05, 7, seed_offset=17, cluster=False)
    sizes = ((2048, 5), (1000, 4), (4096, 5))
    near_sizes = (2048, 1000)
    cases = {k: (256, 200, "ds32") if k in ("B4", "B4L") else (300, 300, "f32")
             for k in chip_smoke.FUSED_CASES}
    calls = {**smoke.exact_calls(scene, 1e-4, True), **smoke.tree_calls(sizes=sizes),
             **smoke.near_calls(sizes=near_sizes), **smoke.fused_calls(cases=cases)}
    refs = {**smoke.exact_calls(scene, 1e-4, True, plain=True),
            **smoke.tree_calls(plain=True, sizes=sizes),
            **smoke.near_calls(plain=True, sizes=near_sizes),
            **smoke.fused_calls(plain=True, cases=cases)}
    assert set(calls) == set(smoke.SOURCE)
    for key, (mod, call) in calls.items():
        assert mod.__name__.rsplit(".", 1)[1] == {
            "nbody_forces": "cuda_forces", "nbody_jerk": "cuda_jerk",
            "nbody_forces_mxu": "cuda_forces_mxu", "collisions": "cuda_collisions",
            "nbody_forces_sym": "cuda_forces_sym", "tree_near": "cuda_tree",
            "neighbor": "cuda_neighbor", "fused_rollout": "fused_rollout"}[
                smoke.SOURCE[key]]
        assert mod is smoke.redesigned()[smoke.SOURCE[key]]
        assert smoke.hold(key, call(), refs[key][1](), call) == (0.0, True)
    assert not {"B12", "B13"} & set(smoke.exact_calls(scene, 0.0, True))
    assert int(calls["B7S"][1]()[2]) > 0
    assert calls["B7"][1].pairs > 0 and calls["B7L"][1].pairs > calls["B7"][1].pairs
    assert calls["NEAR"][1].pairs > 0 and calls["B4"][1].pairs == 256 * 256 * 11
    out = calls["B4"][1]()
    with pytest.raises(AssertionError, match="B4 output 0"):
        smoke.hold("B4", (out[0] + 2e-6, out[1]), out)
    dv = calls["B6"][1]()[1]
    assert bool(dv.any())  # the scene has contacts
    b13 = calls["B13"][1]
    s, pe = b13()
    assert smoke.hold("B13", (s * 1.0005, pe), (s, pe), b13)[1] is False
    with pytest.raises(AssertionError, match="B13 S vs the exact S"):
        smoke.hold("B13", (s * 1.002, pe), (s, pe), b13)
    with pytest.raises(AssertionError, match="B13 pe: RMS difference"):
        smoke.hold("B13", (s, pe * 1.001), (s, pe), b13)
    bumped = pe.clone()
    bumped[0] *= 1.01
    with pytest.raises(AssertionError, match="B13 pe: RMS difference"):
        smoke.hold("B13", (s, bumped), (s, pe), b13)


def test_spill_free_raises_on_spills_or_no_output():
    import chip_smoke

    assert chip_smoke.spill_free("nbody_jerk", _ptxas_log(["a", "b"])) == 2
    with pytest.raises(AssertionError, match="spill bytes"):
        chip_smoke.spill_free("nbody_jerk", _ptxas_log(["a"]) + _ptxas_log(["b"], spill=8))
    with pytest.raises(AssertionError, match="not in the ptxas output"):
        chip_smoke.spill_free("nbody_jerk", "")


def test_held_gates_each_output():
    """chip_smoke's comparison of two calls' outputs: relative to the
    reference's max, scalars relative to themselves, integers exact."""
    import chip_smoke

    acc = torch.tensor([[1.0, -2.0, 0.5]])
    U, count = torch.tensor(-3.0), torch.tensor(7, dtype=torch.int32)
    assert chip_smoke.held((acc, U, count), (acc, U, count), (1e-5, 1e-5, 0)) == (0.0, True)
    near = acc + torch.tensor([[0.0, 1e-6, 0.0]])
    worst, equal = chip_smoke.held((near, U), (acc, U), (1e-5, 1e-5))
    assert worst == pytest.approx(5e-7, rel=0.1) and not equal
    with pytest.raises(AssertionError, match="output 0"):
        chip_smoke.held((acc * 1.001, U), (acc, U), (1e-5, 1e-5))
    with pytest.raises(AssertionError, match="output 1"):
        chip_smoke.held((acc, U * 1.001), (acc, U), (1e-5, 1e-5))
    with pytest.raises(AssertionError, match="output 2"):
        chip_smoke.held((acc, U, count + 1), (acc, U, count), (1e-5, 1e-5, 0))


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
    """The port's own binding to native/ (its own build of the oracle, under
    build/native/) agrees with the JAX package's, and its numpy path agrees
    with the oracle. JAX's binding is imported here, not when the file is
    collected: its import runs ``make -C native``."""
    from orbital_tpu.utils import native as jnative

    pos, mass, _ = _cluster(rng, 256, np.float64)
    assert tnative.backend() in ("oracle", "numpy")
    # the port builds the oracle wherever a compiler is, whatever JAX's import saw
    have_cxx = shutil.which(os.environ.get("CXX", "g++")) is not None
    assert tnative.backend() == ("oracle" if have_cxx else "numpy")
    assert tnative._LIB_PATH.parent.parts[-2:] == ("build", "native")
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
