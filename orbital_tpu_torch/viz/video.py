"""Video export: trajectory history -> mp4/gif via system ffmpeg.

Capability parity with the reference's ``render_orbital_mp4``
(core/plot.py:144-320): stride selection from fps x duration, a fixed
global camera computed from the full history, per-frame rendering through
``plot_orbits`` on a truncated-history view, and ffmpeg stitching (H.264
with even-dimension padding, or palette-based GIF) with cleanup and a
manual-command fallback when ffmpeg is unavailable.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .plot import _PLANES, plot_orbits

__all__ = ["render_orbital_mp4", "EngineView"]


@dataclass
class EngineView:
    """Duck-typed engine: just objects + (possibly truncated) history."""

    objects: list
    history: dict


def _global_limits(history: dict, ix: int, iy: int, pad_frac: float):
    xs, ys = [], []
    for arr in history.values():
        a = np.asarray(arr, float)
        xs.append(a[:, ix])
        ys.append(a[:, iy])
    x_all, y_all = np.concatenate(xs), np.concatenate(ys)
    dx = float(x_all.max() - x_all.min())
    dy = float(y_all.max() - y_all.min())
    pad_x = pad_frac * (dx if dx > 0 else 1.0)
    pad_y = pad_frac * (dy if dy > 0 else 1.0)
    return ((float(x_all.min()) - pad_x, float(x_all.max()) + pad_x),
            (float(y_all.min()) - pad_y, float(y_all.max()) + pad_y))


def _stitch(ffmpeg: str, tmp_dir: str, out_path: str, fps: int) -> bool:
    ext = os.path.splitext(out_path)[1].lower()
    frames = os.path.join(tmp_dir, "frame_%06d.png")
    try:
        if ext == ".gif":
            palette = os.path.join(tmp_dir, "palette.png")
            subprocess.run([ffmpeg, "-y", "-i", frames,
                            "-vf", "palettegen=stats_mode=single", palette],
                           check=True)
            subprocess.run([ffmpeg, "-y", "-framerate", str(fps), "-i", frames,
                            "-i", palette, "-lavfi",
                            "paletteuse=dither=sierra2_4a", "-loop", "0",
                            out_path], check=True)
        else:
            # H.264 needs even dimensions; pad rather than rescale
            subprocess.run([ffmpeg, "-y", "-framerate", str(fps), "-i", frames,
                            "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
                            "-c:v", "libx264", "-pix_fmt", "yuv420p",
                            out_path], check=True)
        return True
    except subprocess.CalledProcessError:
        return False


def render_orbital_mp4(
    engine,
    out_path: str = "orbits.mp4",
    plane: str = "xy",
    fps: int = 30,
    duration_s: Optional[float] = None,
    frame_every_n: int = 1,
    separate: bool = False,
    with_velocity: bool = False,
    labels: bool = True,
    show_barycenter: bool = True,
    barycenter_trail: bool = True,
    dpi: int = 150,
    pad_frac: float = 0.08,
    tmp_dir: Optional[str] = None,
    cleanup: bool = True,
    enforce_equal_aspect: bool = True,
    every_n: int = 1,
) -> dict:
    """Render the engine's history to a video. Returns an info dict with
    frame count, output path, and whether stitching succeeded."""
    import matplotlib.pyplot as plt

    if plane not in _PLANES:
        raise ValueError("plane must be one of 'xy', 'xz', 'yz'")
    ix, iy = _PLANES[plane]

    uuids = list(engine.history.keys())
    T_full = min(len(engine.history[u]) for u in uuids)
    if duration_s is not None:
        total_frames = max(1, int(round(fps * duration_s)))
        stride = max(1, int(np.ceil(T_full / total_frames)))
    else:
        stride = max(1, int(frame_every_n))
        total_frames = max(1, (T_full - 1) // stride)
    frame_indices = list(range(2, T_full + 1, stride))[:total_frames]

    x_lim, y_lim = _global_limits(engine.history, ix, iy, pad_frac)

    made_tmp = tmp_dir is None
    if made_tmp:
        tmp_dir = tempfile.mkdtemp(prefix="orbital_tpu_frames_")
    os.makedirs(tmp_dir, exist_ok=True)

    for f_idx, t_idx in enumerate(frame_indices):
        view = EngineView(
            objects=list(engine.objects),
            history={u: engine.history[u][:t_idx] for u in uuids},
        )
        fig, axes = plot_orbits(
            view, every_n=every_n, plane=plane, separate=separate,
            with_velocity=with_velocity, equal_axes=False, labels=labels,
            show=False, show_barycenter=show_barycenter,
            barycenter_trail=barycenter_trail,
        )
        for ax in np.atleast_1d(axes).ravel():
            ax.set_xlim(*x_lim)
            ax.set_ylim(*y_lim)
            if enforce_equal_aspect:
                ax.set_aspect("equal", adjustable="box")
        fig.savefig(os.path.join(tmp_dir, f"frame_{f_idx:06d}.png"),
                    dpi=dpi, bbox_inches=None)
        plt.close(fig)

    ffmpeg = shutil.which("ffmpeg")
    ext = os.path.splitext(out_path)[1].lower()
    if ext not in {".mp4", ".mov", ".mkv", ".gif"}:
        out_path = os.path.splitext(out_path)[0] + ".mp4"
    ok = bool(ffmpeg) and _stitch(ffmpeg, tmp_dir, out_path, fps)

    if ok and cleanup and made_tmp:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    if not ok:
        print(
            f"\nFrames were written to: {tmp_dir}\n"
            "Couldn't stitch automatically (ffmpeg missing or failed).\n"
            f'Try:\n  ffmpeg -y -framerate {fps} -i "{os.path.join(tmp_dir, "frame_%06d.png")}" '
            '-vf "pad=ceil(iw/2)*2:ceil(ih/2)*2" -c:v libx264 -pix_fmt yuv420p "orbits.mp4"\n'
        )
    return {
        "frames": len(frame_indices),
        "fps": fps,
        "path": out_path if ok else tmp_dir,
        "duration_s": len(frame_indices) / fps,
        "stitched": ok,
        "ffmpeg": bool(ffmpeg),
        "frame_dir": tmp_dir,
    }
