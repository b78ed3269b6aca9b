"""Bundled J2000 solar-system element tables.

Same dataset the reference ships (reference: core/datasets.py:13-58): Sol,
the 8 planets, Pluto plus five more dwarf planets / TNOs (15 heliocentric
bodies), and optionally 11 major moons with parent links (26 bodies total).
Planet elements are the standard J2000 Keplerian table (a, e, I, L, varpi,
Omega); moons tabulate (a, e, I, omega, M, Omega) per JPL SSD
(https://ssd.jpl.nasa.gov/sats/elem/).

The table is declarative data here (tuples -> Body), so it can also be
vectorized straight into device state without constructing Body objects;
see ``orbital_tpu_torch.models.scene``. A copy of
``orbital_tpu.models.datasets``, so that this package never imports the JAX one.
"""
from __future__ import annotations

from .body import Body, System
from .constants import J2000_JD
from .units import AU, Degrees, Kilograms, Meters

__all__ = ["EPOCH", "solar_system_v2", "solar_system", "PLANET_TABLE", "MOON_TABLE"]

#: Epoch of the bundled elements (Julian Date).
EPOCH = J2000_JD

# Heliocentric bodies: name -> (mass_kg, radius_m, a_au, e, I_deg, L_deg,
#                               long_peri_deg, long_node_deg)
PLANET_TABLE: dict[str, tuple[float, float, float, float, float, float, float, float]] = {
    "Mercury":      (3.3011e23,  2.4397e6, 0.38709927, 0.20563593,  7.00497902, 252.25032350,  77.45779628,  48.33076593),
    "Venus":        (4.8675e24,  6.0518e6, 0.72333566, 0.00677672,  3.39467605, 181.97909950, 131.60246718,  76.67984255),
    "Earth":        (5.9722e24,  6.371e6,  1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193,   0.0),
    "Mars":         (6.4171e23,  3.3895e6, 1.52371034, 0.09339410,  1.84969142,  -4.55343205, -23.94362959,  49.55953891),
    "Jupiter":      (1.8982e27,  6.9911e7, 5.20288700, 0.04838624,  1.30439695,  34.39644051,  14.72847983, 100.47390909),
    "Saturn":       (5.6834e26,  5.8232e7, 9.53667594, 0.05386179,  2.48599187,  49.95424423,  92.59887831, 113.66242448),
    "Uranus":       (8.6810e25,  2.5362e7, 19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630,  74.01692503),
    "Neptune":      (1.02413e26, 2.4622e7, 30.06992276, 0.00859048, 1.77004347, -55.12002969,  44.96476227, 131.78422574),
    "Pluto":        (13024.6e18, 1188300.0, 39.5886,   0.2518,     17.1477,     38.68366,    113.709,      110.292),
    "Ceres":        (938.416e18, 469700.0,  2.766051,  0.0794,     10.588,     188.70268,     73.2734,      80.2522),
    "Eris":         (16600e18,   1163000.0, 68.0506,   0.435675,   43.821,     211.032,      150.714,       36.0460),
    "20000 Varuna": (3.698e20,   334000.0,  43.1374,   0.053565,   17.1395,    114.900,      272.579,       97.21338),
    "Makemake":     (3100e18,    714000.0,  45.4494,   0.16194,    29.03386,   168.8258,     296.95,        79.259),
    "28978 Ixion":  (3e20,       355000.0,  39.3745,   0.2449,     19.6745,    293.546,      300.585,       71.099),
}

# Moons: name -> (parent, mass_kg, radius_m, a, a_unit, e, I_deg,
#                 arg_peri_deg, M_deg, long_node_deg). Luna is tabulated in
# AU, the rest in meters (as in the JPL SSD source tables).
MOON_TABLE: dict[str, tuple] = {
    "Luna":      ("Earth",   7.346e22,  1.7371e6, 0.00257, "au", 0.0549, 5.16, 318.15, 135.27, 125.08),
    "Io":        ("Jupiter", 8.93e22,   1_821_600.0, 421_800_000.0, "m",   0.004, 0.0,  49.1,  330.9,   0.0),
    "Europa":    ("Jupiter", 4.8e22,    1_560_800.0, 671_100_000.0, "m",   0.009, 0.5,  45.0,  345.4, 184.0),
    "Ganymede":  ("Jupiter", 1.4819e23, 2_634_100.0, 1_070_400_000.0, "m", 0.001, 0.2, 198.3,  324.8,  58.5),
    "Callisto":  ("Jupiter", 1.08e23,   1_560_800.0, 1_882_700_000.0, "m", 0.007, 0.3,  43.8,   87.4, 309.1),
    "Titan":     ("Saturn",  1.345e23,  2_575_000.0, 1_221_900_000.0, "m", 0.029, 0.35, 78.3,   11.7,  78.6),
    "Enceladus": ("Saturn",  1.08e20,     252_000.0,   238_400_000.0, "m", 0.005, 0.0, 119.5,   57.0,   0.0),
    "Rhea":      ("Saturn",  2.31e21,     763_800.0,   527_200_000.0, "m", 0.001, 0.3,  44.3,   31.5, 133.7),
    "Iapetus":   ("Saturn",  1.805e21,    734_400.0, 3_561_700_000.0, "m", 0.028, 7.6, 254.5,   74.8,  86.5),
    "Triton":    ("Neptune", 2.14e22,   1_353_400.0,   354_800_000.0, "m", 0.0, 157.3,   0.0,   63.0, 178.1),
    "Titania":   ("Uranus",  3.455e21,    788_400.0,   436_298_000.0, "m", 0.002, 0.1, 184.0,   68.1,  29.5),
}

# The central body.
SOL = ("Sol", 1.9885e30, 6.9634e8)


def solar_system_v2(moons: bool = False, **kwargs) -> System:
    """Build the bundled J2000 solar system as a :class:`System`.

    With ``moons=False``: Sol + 14 heliocentric bodies. With ``moons=True``:
    adds the 11 major moons with parent links (26 bodies). Matches the
    reference dataset body-for-body (reference: core/datasets.py:13-56).
    """
    name, mass, radius = SOL
    sol = Body(
        parent=None, name=name, mass=Kilograms(mass), radius=Meters(radius),
        a=AU(0), e=0, I=Degrees(0), L=Degrees(0), long_peri=Degrees(0),
        long_node=Degrees(0), arg_peri=None, M=None,
    )
    bodies = [sol]
    by_name = {name: sol}

    for pname, (m_kg, r_m, a_au, e, i_deg, L_deg, lp_deg, ln_deg) in PLANET_TABLE.items():
        body = Body(
            parent=sol, name=pname, mass=Kilograms(m_kg), radius=Meters(r_m),
            a=AU(a_au), e=e, I=Degrees(i_deg), L=Degrees(L_deg),
            long_peri=Degrees(lp_deg), long_node=Degrees(ln_deg),
            M=None, arg_peri=None,
        )
        bodies.append(body)
        by_name[pname] = body

    if moons:
        for mname, (parent, m_kg, r_m, a_val, a_unit, e, i_deg, w_deg, M_deg, ln_deg) in MOON_TABLE.items():
            bodies.append(
                Body(
                    parent=by_name[parent], name=mname, mass=Kilograms(m_kg),
                    radius=Meters(r_m),
                    a=AU(a_val) if a_unit == "au" else Meters(a_val).to_au(),
                    e=e,
                    I=Degrees(i_deg), arg_peri=Degrees(w_deg), M=Degrees(M_deg),
                    long_node=Degrees(ln_deg), long_peri=None, L=None,
                )
            )
    return System(bodies, **kwargs)


#: Backwards-compatible alias (reference: core/datasets.py:58).
solar_system = solar_system_v2
