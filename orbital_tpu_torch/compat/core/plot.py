"""Compat: reference core/plot.py surface (orbital_tpu_torch.viz)."""
from orbital_tpu_torch.viz.plot import plot_orbits  # noqa: F401
from orbital_tpu_torch.viz.video import EngineView, render_orbital_mp4  # noqa: F401
