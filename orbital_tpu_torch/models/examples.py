"""Bundled example scenarios (reference: core/examples.py:11-233).

The four presets keep the reference's signatures, initial conditions, and
outputs (drift printout + plot/video), run on the port's engine: each
``run_simulation`` call advances ``rollout`` chunks on ``device`` (the card
unless the caller asks for the CPU; the precision follows the device, ds32
on the card and f64 on the CPU).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..engine.engine import SimulationEngine, run_simulation
from ..viz.plot import plot_orbits
from ..viz.video import render_orbital_mp4
from .constants import UnitSystem, get_unit_profile
from .objects import Coordinates, Object, ObjectCollection, set_circular_orbit

__all__ = [
    "two_body_problem",
    "sun_earth_moon",
    "three_body_equilateral",
    "sol_from_kepler_dataset",
]


def two_body_problem(
    body1_mass: float = 5.972e24,   # Earth
    body1_radius: float = 6.371e6,
    body2_mass: float = 7.348e22,   # Moon
    body2_radius: float = 1.737e6,
    distance: float = 384400e3,     # meters
    dt: float = 60 * 60,
    steps: int = 1000,
    unit_profile: UnitSystem = "si",
    show: bool = True,
    device: torch.device | str = "cuda",
):
    """Two-body circular orbit (reference: core/examples.py:11-49)."""
    profile = get_unit_profile(unit_profile)
    body1 = Object(mass=body1_mass, radius=body1_radius,
                   velocity=np.zeros(3), coordinates=Coordinates(0, 0, 0))
    body2 = Object(mass=body2_mass, radius=body2_radius,
                   velocity=np.zeros(3), coordinates=Coordinates(distance, 0, 0))
    set_circular_orbit(primary=body1, secondary=body2, unit_profile=profile)

    collection = ObjectCollection([body1, body2])
    for obj in collection:
        print(obj)
    engine = SimulationEngine(collection, dt=dt, softening=1e3,
                              restitution=1.0, cache=False, max_hist=None,
                              device=device)
    run_simulation(engine, steps=steps)
    plot_orbits(engine, every_n=5, plane="xy", separate=False,
                with_velocity=False, show=show)
    return engine


def sun_earth_moon(
    steps: int = 5000,
    dt: float = 3600.0,
    moon_incl_deg: float = 0.0,
    softening: float = 1e3,
    unit_profile: UnitSystem = "si",
    show: bool = True,
    device: torch.device | str = "cuda",
):
    """Earth-Moon system orbiting the Sun (reference: core/examples.py:52-121):
    Sun-Earth circular about their barycenter, then the EM relative circular
    velocity split so the EM barycenter keeps the solar-orbital velocity."""
    profile = get_unit_profile(unit_profile)
    M_sun, R_sun = 1.98847e30, 6.9634e8
    M_earth, R_earth = 5.972e24, 6.371e6
    M_moon, R_moon = 7.348e22, 1.737e6
    AU = 1.495978707e11
    R_em = 384400e3

    sun = Object(M_sun, R_sun, velocity=np.zeros(3), coordinates=Coordinates(0, 0, 0))
    earth = Object(M_earth, R_earth, velocity=np.zeros(3), coordinates=Coordinates(AU, 0, 0))

    moon_pos = np.array([AU + R_em, 0.0, 0.0])
    if abs(moon_incl_deg) > 0:
        i = np.deg2rad(moon_incl_deg)
        moon_pos = np.array([AU + R_em, 0.0, R_em * np.sin(i)])
    moon = Object(M_moon, R_moon, velocity=np.zeros(3),
                  coordinates=Coordinates.from_iterable(moon_pos))

    # 1) Sun-Earth circular about the barycenter (total momentum zero)
    set_circular_orbit(sun, earth, unit_profile=profile)
    em_bary_vel = earth.velocity.copy()

    # 2) EM circular velocity relative to Earth, split by mass so the EM
    #    barycenter keeps moving with the solar-orbital velocity
    earth_to_moon = moon.position() - earth.position()
    sep = np.linalg.norm(earth_to_moon)
    radial = earth_to_moon / sep
    tangential = np.cross(np.array([0.0, 0.0, 1.0]), radial)
    if np.linalg.norm(tangential) < 1e-12:
        tangential = np.array([0.0, 1.0, 0.0])
    tangential = tangential / np.linalg.norm(tangential)
    em_circ_vel = np.sqrt(profile.G * (M_earth + M_moon) / sep) * tangential
    m_tot = M_earth + M_moon
    earth.velocity = em_bary_vel - (M_moon / m_tot) * em_circ_vel
    moon.velocity = em_bary_vel + (M_earth / m_tot) * em_circ_vel

    collection = ObjectCollection([sun, earth, moon])
    engine = SimulationEngine(collection, dt=dt, softening=softening,
                              restitution=1.0, cache=False, max_hist=None,
                              device=device)
    run_simulation(engine, steps=steps, print_every=500)
    plot_orbits(engine, every_n=10, plane="xy", separate=False,
                with_velocity=False, show_barycenter=True,
                barycenter_trail=True, show=show)
    return engine


def three_body_equilateral(
    m: float = 1e22,
    R: float = 1e7,
    dt: float = 50.0,
    steps: int = 8000,
    softening: float = 1e3,
    unit_profile: UnitSystem = "si",
    out_path: str = "three_body_equilateral.mp4",
    render: bool = True,
    device: torch.device | str = "cuda",
):
    """Lagrange's equilateral three-body solution
    (reference: core/examples.py:124-178): equal masses on a triangle with
    tangential speed v = sqrt(G m / (sqrt(3) R)) rotate rigidly; longer
    integrations break symmetry chaotically."""
    profile = get_unit_profile(unit_profile)
    pos = [
        np.array([R, 0.0, 0.0]),
        np.array([-0.5 * R, np.sqrt(3) / 2 * R, 0.0]),
        np.array([-0.5 * R, -np.sqrt(3) / 2 * R, 0.0]),
    ]
    z_hat = np.array([0.0, 0.0, 1.0])
    v = np.sqrt(profile.G * m / (np.sqrt(3.0) * R))
    bodies = [
        Object(
            mass=m,
            radius=(m / 5000.0) ** (1 / 3),
            velocity=v * np.cross(z_hat, p / np.linalg.norm(p)),
            coordinates=Coordinates.from_iterable(p),
        )
        for p in pos
    ]
    engine = SimulationEngine(ObjectCollection(bodies), dt=dt,
                              softening=softening, restitution=1.0,
                              cache=False, max_hist=None, device=device)
    run_simulation(engine, steps=steps, print_every=500)
    if render:
        render_orbital_mp4(engine, out_path=out_path, plane="xy", fps=30,
                           duration_s=30, with_velocity=False,
                           show_barycenter=True, barycenter_trail=True,
                           every_n=5)
    return engine


def sol_from_kepler_dataset(
    out_path: str = "sol_from_keplerian.mp4",
    days: int = 365,
    dt: Optional[float] = None,
    print_every: int = 100,
    moons: bool = False,
    render: bool = True,
    device: torch.device | str = "cuda",
):
    """Sun + planets from the bundled Keplerian table, rendered to video
    (reference: core/examples.py:181-233)."""
    from .datasets import solar_system_v2
    from .scene import compile_system

    dt = 86400.0 if dt is None else dt
    system = solar_system_v2(moons=moons)
    scene = compile_system(system, compose_parents=moons)
    bodies = [
        Object(mass=float(scene.mass[i]), radius=float(scene.radius[i]),
               velocity=scene.vel[i], coordinates=Coordinates(*scene.pos[i]),
               name=scene.names[i])
        for i in range(scene.n)
    ]
    engine = SimulationEngine(ObjectCollection(bodies), dt=dt, softening=1e6,
                              restitution=1.0, cache=False, max_hist=None,
                              device=device)
    run_simulation(engine, steps=days, print_every=print_every)
    if render:
        render_orbital_mp4(engine, out_path=out_path, plane="xy", fps=30,
                           duration_s=30, with_velocity=False,
                           show_barycenter=True, barycenter_trail=True,
                           every_n=5)
    return engine
