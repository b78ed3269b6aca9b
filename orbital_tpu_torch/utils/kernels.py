"""Build and load the hand-written CUDA kernels in ``orbital_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` holds kernels plus a plain C interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds. It is built at first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``) as

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

and loaded with ``ctypes``. ``<hash>`` covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. ``nvcc`` is
taken from ``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``.
:func:`build` starts one ``nvcc`` per missing library, all at once.

Calling convention of every C entry point: device pointers and the CUDA
stream are ``ctypes.c_void_p``; the function returns the ``cudaError_t`` of
its launch (``cudaGetLastError()``), and :func:`check` raises on nonzero.
Each library also exports ``ot_error_string(int)``.

The one-card mesh (``parallel.mesh``) launches from several threads of one
process: :func:`load` builds and loads under a lock, and the wrappers it
runs count their launches with :func:`count_launch`.

Float64 state: where the JAX package's route is a Pallas kernel, its
wrapper casts f64 state to f32 once at entry and returns the state's dtype;
the CUDA branch of each such wrapper here does the same through
:func:`in_f32`. The f64 ring's kernels (B3 detect's and the block bounce's
f64 instances) stage a shard's rows from its cast view, a float32 buffer
that the ring's first round writes; :func:`cast_f32`, :func:`tile_maxima`
and :func:`check_views` serve their plain versions and wrappers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build", "load", "check",
           "build_log", "build_seconds", "refuse_grad", "count_launch", "stream_handle",
           "in_f32", "cast_f32", "tile_maxima", "check_views", "view_args", "VIEW_TILE"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every source in csrc/, by library name
SOURCES = ("nbody_forces", "fused_rollout", "collisions", "nbody_jerk", "neighbor",
           "tree_near", "nbody_forces_sym", "nbody_forces_mxu", "p3m_short",
           "collision_roots", "fused_ensemble")

_loaded: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_seconds: dict[str, float] = {}
# one build and one load at a time: the temporary file is named by process
_lock = threading.RLock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _library_path(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every library of ``names`` (``SOURCES`` for all) that is
    missing or stale, one ``nvcc`` process per source, all running at once.
    Raises if ``nvcc`` is missing or any build fails (with the compiler's
    output)."""
    with _lock:
        _build(names)


def _build(names) -> None:
    started = []
    for name in names:
        src, out = _library_path(name)
        if name in _loaded or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in started:
        _logs[name] = proc.communicate()[0]
        _seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {src.name} (rc={proc.returncode}):\n"
                          f"{_logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing or stale, load it
    once per process and return it."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)[1]))
        lib.ot_error_string.restype = ctypes.c_char_p
        lib.ot_error_string.argtypes = [ctypes.c_int]
        _loaded[name] = lib
        return lib


def count_launch(fn, counter: str = "launches") -> None:
    """Add one to ``fn.launches`` (or the ``counter`` attribute, such as an
    f64 instance's ``f64_launches``) under a lock, so that launches from the
    threads of a one-card mesh are all counted."""
    with _count_lock:
        setattr(fn, counter, getattr(fn, counter) + 1)


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a CUDA ``torch.device``
    with its index) as the integer a C entry point takes, from the raw
    getter where PyTorch has it: ``torch.cuda.current_stream(device)``
    builds a Stream object a call, host time that a launch whose kernel
    returns at entry (the ring's gated rounds) consists of."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(device.index)


def in_f32(fn, *args, **kwargs):
    """Call the CUDA wrapper ``fn`` on float64 state as the JAX package's
    Pallas wrappers take it (``orbital_tpu/ops/pallas_forces.py:191-217``):
    each float64 tensor of ``args`` cast to float32 once, the kernel run in
    float32, and each floating tensor that ``fn`` returns (one, or a tuple)
    in float64. Integer and bool tensors pass as they are. A float64 value
    beyond +-2^100 becomes +-2^100 (the package's largest parked or sentinel
    coordinate, 1e30, passes as it is): a difference of two such values is
    finite, so a far row still gives r^2 = inf and 1/r = 0 in the kernel and
    adds exactly 0, never the NaN of inf - inf or 0 x inf."""
    import torch

    def down(a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.float64:
            return cast_f32(a)
        return a

    def up(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.to(torch.float64)
        return t

    out = fn(*(down(a) for a in args), **kwargs)
    return tuple(up(t) for t in out) if isinstance(out, tuple) else up(out)


def cast_f32(x):
    """A float64 tensor as :func:`in_f32` casts it: clamped to +-2^100, then
    rounded to float32 (NaN stays NaN)."""
    import torch

    big = 2.0 ** 100
    return x.clamp(-big, big).to(torch.float32)


# the rows of a cast view's tile (the f64 ring kernels' j tiles)
VIEW_TILE = 128


def tile_maxima(values, keep):
    """[ceil(n / VIEW_TILE)] float32: each tile's largest of the float32
    ``values`` [n] over the rows where ``keep`` [n] holds, NaN rows skipped
    and 0 where no row is left, as the kernels take it (``fmaxf`` from 0)."""
    import torch

    n = values.shape[0]
    tiles = -(-n // VIEW_TILE)
    v = torch.where(keep & ~torch.isnan(values), values, torch.zeros_like(values))
    v = torch.nn.functional.pad(v, (0, tiles * VIEW_TILE - n))
    return torch.clamp_min(v.reshape(tiles, VIEW_TILE).amax(1), 0.0)


def check_views(what: str, view_out, views, sizes: tuple, device, wide: bool) -> None:
    """A wrapper's cast-view arguments: ``view_out`` (the j side's view, to
    write) or ``views`` (the i and j sides', to read), not both, each a
    contiguous float32 tensor of ``sizes`` (i's, j's) elements on
    ``device``, and only on float64 tables (``wide``)."""
    import torch

    if view_out is None and views is None:
        return
    if not wide:
        raise TypeError(f"{what}: a cast view is for float64 tables")
    if view_out is not None and views is not None:
        raise ValueError(f"{what}: view_out (the first round's) or views (a later "
                         f"round's), not both")
    if views is not None and len(views) != 2:
        raise ValueError(f"{what}: views must be the i and j sides' two views")
    for v, size in [(view_out, sizes[1])] if views is None else zip(views, sizes):
        if v is None or v.dtype != torch.float32 or v.device != device or \
                v.numel() != size or not v.is_contiguous():
            raise ValueError(f"{what}: a view must be a contiguous float32 tensor of {size} "
                             f"elements on {device}")


def view_args(view_out, views):
    """The view entry points' (view_out, view_i, view_j), None where not
    given; None without a view (the bare entry point)."""
    if view_out is None and views is None:
        return None
    return (view_out, None, None) if views is None else (None, *views)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.ot_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise before a launch if autograd would record through it: a kernel
    reads its inputs through ``data_ptr()`` and has no backward pass, so its
    output would carry no ``grad_fn`` while the steps around it still carry
    gradients, and a gradient through it would come out wrong without an
    error. ``None`` entries are skipped. The CPU plain paths keep autograd."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the CUDA kernel has no backward pass; "
            "differentiate through the dense route (force_impl='dense', or 'auto' at "
            "N <= 4,096), which is plain PyTorch, or call under torch.no_grad()")


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for a
    library built by this process; empty if it was loaded from the cache."""
    return _logs.get(name, "")


def build_seconds(name: str) -> float:
    """Wall seconds this process spent compiling ``name`` (0 if cached)."""
    return _seconds.get(name, 0.0)
