"""The reference's ``core.*`` layout over the PyTorch port
(``orbital_tpu_torch/compat/core``): the verbatim reference-style user code of
``tests/test_compat_core.py`` runs unchanged on the port, with no JAX
imported, and its history matches the JAX layout's run.

Both runs are subprocesses, so neither ``core`` package meets the other or
the golden-test fixture's import of the actual reference ``core``. The port's
run starts in an empty directory with ``orbital_tpu_torch/compat`` ahead of
the repository on ``PYTHONPATH``, and selects the CPU by one line before the
user code (``core.use_device("cpu")``), as the JAX run selects JAX's
platform. Tolerance: the whole named history (201 positions of each body,
f64 on the CPU in both) within rel 1e-9 of its scale.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
COMPAT = REPO / "orbital_tpu_torch" / "compat"

_spec = importlib.util.spec_from_file_location("_jax_compat_test",
                                               REPO / "tests" / "test_compat_core.py")
_jax_compat = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jax_compat)
# the JAX test's script: its platform preamble, then the verbatim user code
PREAMBLE, USER_CODE = _jax_compat.SCRIPT.split("import numpy as np\n", 1)
USER_CODE = "import numpy as np\n" + USER_CODE

REPORT = '''
import json, sys
print("HISTORY " + json.dumps({k: np.asarray(v, dtype=float).tolist()
                               for k, v in engine.named_history().items()}))
print("JAX_LOADED", "jax" in sys.modules)
'''


def _run(script: str, cwd, pythonpath: str) -> tuple[dict, bool]:
    env = dict(os.environ, PYTHONPATH=pythonpath)
    out = subprocess.run([sys.executable, "-c", script], cwd=str(cwd), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "COMPAT_OK" in out.stdout
    lines = out.stdout.splitlines()
    hist = json.loads(next(ln for ln in lines if ln.startswith("HISTORY "))[8:])
    jax_loaded = next(ln for ln in lines if ln.startswith("JAX_LOADED ")).split()[1]
    return hist, jax_loaded == "True"


def test_reference_user_code_runs_on_the_port(tmp_path):
    port_script = 'import core; core.use_device("cpu")\n' + USER_CODE + REPORT
    hist_t, jax_t = _run(port_script, tmp_path, os.pathsep.join([str(COMPAT), str(REPO)]))
    assert not jax_t, "the port's core layout imported JAX"
    hist_j, jax_j = _run(PREAMBLE + USER_CODE + REPORT, REPO,
                         os.environ.get("PYTHONPATH", ""))
    assert jax_j
    # the names are random (a uuid each): the bodies pair up in object order
    assert len(hist_t) == len(hist_j) == 2
    for k, (got, ref) in enumerate(zip(hist_t.values(), hist_j.values())):
        ref, got = np.asarray(ref), np.asarray(got)
        assert got.shape == ref.shape == (201, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=f"body {k}")


def test_core_layout_defaults_to_the_card(tmp_path):
    """Without ``use_device``, an engine built through ``core.engine`` runs on
    the card: on a machine without CUDA it raises rather than fall back."""
    script = '''
import core, core.engine, core.examples
from core.physics import Object, Coordinates, ObjectCollection
import numpy as np
assert core.default_device() == "cuda"
objs = ObjectCollection([Object(1.0, 1.0, velocity=np.zeros(3),
                                coordinates=Coordinates(0, 0, 0))])
try:
    core.engine.SimulationEngine(objs, dt=1.0, cache=False)
except RuntimeError as exc:
    print("RAISED", "CUDA is not available" in str(exc))
else:
    import torch
    print("RAISED", torch.cuda.is_available())
core.use_device("cpu")
e = core.engine.SimulationEngine(objs, dt=1.0, cache=False)
print("DEVICE", e.device)
'''
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(COMPAT), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "RAISED True" in out.stdout and "DEVICE cpu" in out.stdout
