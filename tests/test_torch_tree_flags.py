"""The tree's four layout-study flags in the PyTorch port (``ops/tree.py``:
``_SKIP`` from ``TREE_SKIP``, ``_FAR_NHWC``, ``_FAR_COMBINE`` and
``_PAIRS_CF``) against the same flags of the JAX package, flipped alike:
JAX's by monkeypatch with ``tree_acc_potential.clear_cache()`` around it, as
its own tests/test_tree.py:655-721 do (a module flag is not a jit cache
key), the port's by monkeypatch alone (it reads them at every call).

Sizes are JAX's flag tests': 256 bodies from a numpy seed, levels 4, ws 1,
the "cells" near mode (capacity 128, max_cells 256). The NHWC and lazy
flags change the far field only, so each mode is held against JAX on the
far phase (``_phase="far"``, JAX's staged far program), which keeps the
four order-1 and order-2 JAX compiles under ~30 s; TREE_SKIP is held on the
whole evaluation. Tolerances:
  * port against JAX in each mode: max |da| <= 2e-6 RMS|a| and U to rel
    1e-6 (f32 conv sums in another order; tests/test_torch_tree.py's);
  * the port's lazy against its push: 2e-6 RMS|a| and U to rel 1e-3, JAX's
    own (tests/test_tree.py:715-719: the hop-chained re-expansion keeps a
    small compounding term in the potential);
  * the port's NHWC against its channels-first conv: 2e-6 RMS|a| and rel
    1e-6 (the same sums, another conv algorithm);
  * the pairs geometry under "scan" and "table", and JAX's under "scan":
    equal integers.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbital_tpu.ops import tree as jt
from orbital_tpu_torch.ops import tree as tt

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, LEVELS, WS = 256, 4, 1
KW = dict(G_grav=1.0, eps2=1e-4, levels=LEVELS, ws=WS, capacity=128, max_cells=256,
          with_potential=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bodies():
    rng = np.random.default_rng(7)
    pos = rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    return pos, mass


def _jax(monkeypatch, flags: dict, **kw):
    """JAX's tree_acc_potential with its module flags set, compiled afresh
    and dropped from the cache again."""
    for name, value in flags.items():
        monkeypatch.setattr(jt, name, value)
    jt.tree_acc_potential.clear_cache()
    try:
        pos, mass = _bodies()
        a, U, ov = jt.tree_acc_potential(jnp.asarray(pos), jnp.asarray(mass), **KW, **kw)
        return np.asarray(a, np.float64), float(U), int(ov)
    finally:
        jt.tree_acc_potential.clear_cache()


def _port(monkeypatch, flags: dict, **kw):
    for name, value in flags.items():
        monkeypatch.setattr(tt, name, value)
    pos, mass = _bodies()
    a, U, ov = tt.tree_acc_potential(torch.from_numpy(pos), torch.from_numpy(mass), **KW,
                                     **kw)
    return a.double().numpy(), float(U), int(ov)


def _held(out, ref, u_rtol: float):
    a, U, ov = out
    a_ref, U_ref, ov_ref = ref
    rms = float(np.sqrt(np.mean(np.sum(a_ref ** 2, -1))))
    assert ov == ov_ref == 0
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=2e-6 * rms)
    assert U == pytest.approx(U_ref, rel=u_rtol)


FAR_MODES = {"nhwc": {"_FAR_NHWC": True}, "lazy": {"_FAR_COMBINE": "lazy"}}


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("mode", sorted(FAR_MODES))
def test_far_mode_against_jax(mode, order, monkeypatch):
    """The port's far field under each flag against JAX's under the same
    flag: the NHWC conv, and the lazy combine with its x-major finest
    layout."""
    flags = FAR_MODES[mode]
    ref = _jax(monkeypatch, flags, order=order, _phase="far")
    _held(_port(monkeypatch, flags, order=order, _phase="far"), ref, 1e-6)


@pytest.mark.parametrize("order", [1, 2])
def test_lazy_against_push(order, monkeypatch):
    """The port's lazy combine against its push (the far phase, all that the
    flag changes), to JAX's own tolerances for the two
    (tests/test_tree.py:715-719)."""
    push = _port(monkeypatch, {}, order=order, _phase="far")
    _held(_port(monkeypatch, {"_FAR_COMBINE": "lazy"}, order=order, _phase="far"), push,
          1e-3)


@pytest.mark.parametrize("order", [1, 2])
def test_nhwc_against_channels_first(order, monkeypatch):
    """The port's channels_last_3d conv against its channels-first one (the
    far phase)."""
    first = _port(monkeypatch, {}, order=order, _phase="far")
    _held(_port(monkeypatch, {"_FAR_NHWC": True}, order=order, _phase="far"), first, 1e-6)


@pytest.mark.parametrize("starved", [False, True])
def test_pairs_scan_equals_table(starved, monkeypatch):
    """``_pairs_geometry`` under "scan" gives the integers of JAX's "scan",
    and those of "table" wherever they are read: every entry but j_lo where
    a run is empty (cnt 0), which the sweeps never read (an empty neighbor
    column's j_lo lands below the chunk budget under "scan" and at it under
    "table", in both packages), on the sorted cell ids of the scene (a
    third dead), with room and with a starved chunk budget."""
    pos, mass = _bodies()
    alive = np.ones(N, bool)
    alive[::3] = False
    M, C = 2 ** LEVELS, 8
    *_, cc = tt._bin(torch.from_numpy(pos), torch.from_numpy(mass), torch.from_numpy(alive),
                     M, None, torch.float32)
    sc, _ = tt._sort_cells(cc, torch.from_numpy(alive), M)
    K = 12 if starved else N
    table = tt._pairs_geometry(sc, N, M, WS, C, K)
    monkeypatch.setattr(tt, "_PAIRS_CF", "scan")
    scan = tt._pairs_geometry(sc, N, M, WS, C, K)
    monkeypatch.setattr(jt, "_PAIRS_CF", "scan")
    jax_scan = jax.jit(jt._pairs_geometry, static_argnums=(1, 2, 3, 4, 5))(
        jnp.asarray(sc.numpy(), jnp.int32), N, M, WS, C, K)
    assert set(scan) == set(table) == set(jax_scan)
    read = table["cnt"].numpy() > 0
    for key in table:
        got, want = scan[key].numpy(), table[key].numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_scan[key]), err_msg=key)
        if key == "j_lo":
            got, want = got[read], want[read]
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert read.sum() > 0 and (table["j_lo"].numpy()[~read] != scan["j_lo"].numpy()[~read]).any()


@pytest.mark.parametrize("part", ["near", "far"])
def test_skip_against_jax(part, monkeypatch):
    """``_SKIP`` set to "near" or "far" on both packages (order 1, whole
    evaluations): the port's acc and U as JAX's, the skipped part's
    acceleration zero (the port's far or near phase alone is left); JAX
    keeps its cell-wise far potential under "far", and so does the port."""
    ref = _jax(monkeypatch, {"_SKIP": part}, order=1)
    out = _port(monkeypatch, {"_SKIP": part}, order=1)
    _held(out, ref, 1e-6)
    monkeypatch.setattr(tt, "_SKIP", "")
    left = _port(monkeypatch, {}, order=1, _phase="far" if part == "near" else "near")
    np.testing.assert_allclose(out[0], left[0], rtol=0,
                               atol=1e-6 * float(np.abs(left[0]).max()))


def test_tree_skip_warns_in_a_subprocess():
    """Importing the port's tree module with TREE_SKIP set warns with the
    JAX module's RuntimeWarning text and sets ``_SKIP``; unset, it is
    silent."""
    code = ("import warnings; warnings.simplefilter('always');"
            "import orbital_tpu_torch.ops.tree as t; print(repr(t._SKIP))")
    env = {k: v for k, v in os.environ.items() if k != "TREE_SKIP"}
    runs = {}
    for skip in ("near", None):
        e = dict(env, TREE_SKIP=skip) if skip else env
        runs[skip] = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                                    capture_output=True, text=True, timeout=120)
    assert runs["near"].returncode == 0, runs["near"].stderr
    assert "RuntimeWarning: TREE_SKIP='near' is set: the tree force will OMIT its " \
           "'near'-field contribution" in runs["near"].stderr
    assert runs["near"].stdout.strip() == "'near'"
    assert runs[None].stdout.strip() == "''" and "TREE_SKIP" not in runs[None].stderr
