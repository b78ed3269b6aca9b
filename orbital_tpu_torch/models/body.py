"""Keplerian scene definition: ``Body`` (orbital elements) and ``System``.

This is the *static* description layer: bodies defined by classical orbital
elements (a, e, I, L, varpi, Omega, omega, M) with derivation of missing
elements and conversion to inertial state vectors. It mirrors the
reference's ``core/body.py`` public surface (reference: core/body.py:14-317)
so element tables and user scenes load unchanged; the *dynamic* state lives
on device as structure-of-arrays (see ``orbital_tpu_torch.engine.state``), and
``orbital_tpu_torch.models.scene.compile_system`` is the bridge. A copy of
``orbital_tpu.models.body``, so that this package never imports the JAX one.

Element conventions (reference: core/body.py:14-27):
  * planets tabulate (e, a, I, Omega, varpi, L);
  * moons/small bodies tabulate (e, a, I, Omega, omega, M);
  * varpi = Omega + omega (longitude of periapsis), L = varpi + M.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .constants import STANDARD
from .kepler import solve_kepler
from .rigid import moment_of_inertia
from .units import (
    AU,
    Days,
    Degrees,
    Kilograms,
    Meters,
    Radians,
    Seconds,
    SolarMasses,
    Unit,
)

__all__ = ["Body", "System"]

G = STANDARD.G


def _to_meters(x: Meters | AU) -> Meters:
    return x.to_meters() if isinstance(x, AU) else x


def _to_kg(x: Kilograms | SolarMasses) -> Kilograms:
    return x.to_kilograms() if isinstance(x, SolarMasses) else x


def _to_radians(x: Degrees | Radians) -> Radians:
    return x.to_radians() if isinstance(x, Degrees) else x


class Body:
    """A body defined by Keplerian orbital elements around ``parent``.

    Missing elements are derived at construction (reference:
    core/body.py:65-124): mu = G*M, b = a*sqrt(1-e^2), varpi <-> omega via
    varpi = Omega + omega, M <-> L via L = varpi + M, surface gravity
    fg = mu/r^2, and period T = 2*pi*sqrt(a^3 / (G*M_parent)).
    """

    def __init__(
        self,
        name: str,
        a: Meters | AU,
        e: float,
        I: Degrees | Radians,
        L: Optional[Degrees | Radians],
        M: Optional[Degrees | Radians],
        long_peri: Optional[Degrees | Radians],  # varpi
        long_node: Degrees | Radians,            # Omega
        arg_peri: Optional[Degrees | Radians],   # omega
        mass: Kilograms | SolarMasses,
        radius: Meters | AU,
        b: Optional[Meters | AU] = None,
        fg: Optional[float] = None,              # surface gravity, m/s^2
        T: Optional[Seconds | Days | float] = None,
        mu: Optional[float] = None,              # GM, m^3/s^2
        parent: Optional["Body"] = None,
    ):
        self.name = name
        self.a = a
        self.e = e
        self.I = I
        self.L = L
        self.M = M
        self.long_peri = long_peri
        self.long_node = long_node
        self.arg_peri = arg_peri
        self.mass = mass
        self.radius = radius
        self.b = b
        self.fg = fg
        self.T = Seconds(T) if isinstance(T, float) else T
        self.parent = parent
        self.mu = mu
        self.derive()

    # -- element derivation ------------------------------------------------

    def derive(self) -> None:
        """Fill in missing derived elements (reference: core/body.py:65-97)."""
        if self.mu is None:
            self.mu = self.get_mu()
        if self.b is None:
            self.b = self.get_b()

        if self.long_peri is None:
            assert self.arg_peri is not None, "Must provide either long_peri or arg_peri"
            self.long_peri = self.long_node + self.arg_peri
        elif self.arg_peri is None:
            self.arg_peri = self.long_peri - self.long_node

        if self.M is None:
            assert self.L is not None, "Must provide either L or M"
            self.M = self.L - self.long_peri
        elif self.L is None:
            self.L = self.long_peri + self.M

        if self.fg is None:
            self.fg = self.get_fg()
        if self.T is None:
            self.T = self.get_T()

    def get_mu(self) -> float:
        """Standard gravitational parameter GM in SI (m^3/s^2)."""
        return G * _to_kg(self.mass).value

    def get_b(self) -> Meters:
        """Semi-minor axis b = a*sqrt(1-e^2), in meters."""
        a_m = _to_meters(self.a).value
        return Meters(a_m * math.sqrt(1.0 - self.e**2))

    def get_fg(self) -> float:
        """Surface gravity mu/r^2 (m/s^2)."""
        r_m = _to_meters(self.radius).value
        return self.mu / (r_m**2)

    def get_T(self) -> Optional[Seconds]:
        """Orbital period T = 2*pi*sqrt(a^3/(G*M_parent)); None if no parent."""
        if self.parent is None:
            return None
        M_kg = _to_kg(self.parent.mass).value
        a_m = _to_meters(self.a).value
        return Seconds(2.0 * math.pi * math.sqrt(a_m**3 / (G * M_kg)))

    def mean_motion(self) -> float:
        """Mean motion n = sqrt(mu_parent / a^3) in rad/s; 0 if parentless
        (reference: core/body.py:159-169)."""
        if self.parent is None:
            return 0.0
        a_m = _to_meters(self.a).value
        return math.sqrt(self.parent.mu / a_m**3)

    def rotational_intertia(self) -> float:
        """Spin moment of inertia of a uniform solid sphere.

        (Name kept with the reference's spelling, core/body.py:171-182.)
        """
        mass = _to_kg(self.mass).value
        radius = _to_meters(self.radius).value
        return moment_of_inertia(mass, radius, shape="sphere")

    # -- elements -> state vectors -----------------------------------------

    def get_state(self) -> tuple[list[float], list[float]]:
        """Inertial position (m) and velocity (m/s) from the elements.

        Solves Kepler's equation for the eccentric anomaly E, builds the
        perifocal state, and rotates into the inertial frame with
        R = Rz(Omega) @ Rx(i) @ Rz(omega) (reference: core/body.py:184-249).
        Parentless bodies sit at the origin at rest. The returned state is
        relative to the parent; compose along the parent chain for
        heliocentric coordinates (see ``scene.compile_system``).
        """
        if self.parent is None:
            return [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]

        M = _to_radians(self.M).value
        a = _to_meters(self.a).value
        I = _to_radians(self.I).value
        Omega = _to_radians(self.long_node).value
        omega = _to_radians(self.arg_peri).value
        b = _to_meters(self.b).value
        n = self.mean_motion()
        e = self.e

        E = solve_kepler(M, e)
        cE, sE = math.cos(E), math.sin(E)

        # Perifocal-plane state.
        x_op = a * (cE - e)
        y_op = b * sE
        denom = 1.0 - e * cE
        vx_op = -a * n * sE / denom
        vy_op = a * n * math.sqrt(1.0 - e**2) * cE / denom

        # Rotation R = Rz(Omega) @ Rx(i) @ Rz(omega); perifocal z is 0 so
        # only the first two columns matter.
        cw, sw = math.cos(omega), math.sin(omega)
        ci, si = math.cos(I), math.sin(I)
        cO, sO = math.cos(Omega), math.sin(Omega)
        R = np.array(
            [
                [cO * cw - sO * sw * ci, -cO * sw - sO * cw * ci],
                [sO * cw + cO * sw * ci, -sO * sw + cO * cw * ci],
                [sw * si, cw * si],
            ]
        )
        r = R @ np.array([x_op, y_op])
        v = R @ np.array([vx_op, vy_op])
        return r.tolist(), v.tolist()

    # -- state vectors -> elements -------------------------------------------

    @classmethod
    def from_state(
        cls,
        name: str,
        position,
        velocity,
        mass: Kilograms | SolarMasses,
        radius: Meters | AU,
        parent: "Body",
    ) -> "Body":
        """Build a Keplerian ``Body`` from an inertial state vector.

        The inverse of :meth:`get_state` (the reference only ships the
        forward direction, core/body.py:184-249): ``position`` (m) and
        ``velocity`` (m/s) are relative to ``parent``, and the osculating
        elements are extracted with :func:`~orbital_tpu_torch.models.kepler.
        state_to_elements` using the parent's GM. The orbit must be bound
        (elliptic) — a ValueError is raised otherwise. Degenerate states
        follow the standard conventions (equatorial -> Omega = 0,
        circular -> omega = 0), under which ``get_state()`` round-trips
        the input state.
        """
        from .kepler import state_to_elements

        mu = G * _to_kg(parent.mass).value
        a, e, inc, long_node, arg_peri, mean_anom = state_to_elements(
            np.asarray(position, dtype=np.float64),
            np.asarray(velocity, dtype=np.float64),
            mu,
        )
        if a <= 0.0:
            raise ValueError(
                f"state for {name!r} is not a bound orbit (a = {a:.6g} m); "
                "Body.from_state only supports elliptic orbits"
            )
        return cls(
            name=name,
            a=Meters(a),
            e=float(e),
            I=Radians(inc),
            L=None,
            M=Radians(mean_anom),
            long_peri=None,
            long_node=Radians(long_node),
            arg_peri=Radians(arg_peri),
            mass=mass,
            radius=radius,
            parent=parent,
        )

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "a": self.a,
            "e": self.e,
            "I": self.I,
            "L": self.L,
            "long_peri": self.long_peri,
            "long_node": self.long_node,
            "M": self.M,
            "arg_peri": self.arg_peri,
            "mass": self.mass,
            "radius": self.radius,
            "b": self.b,
            "mu": self.mu,
            "fg": self.fg,
            "T": self.T,
            "parent": self.parent.name if self.parent else "",
        }

    def to_json(self) -> dict:
        """JSON-serializable dict: Unit-tagged values collapse to floats."""
        return {k: (v.value if isinstance(v, Unit) else v) for k, v in self.to_dict().items()}

    def __repr__(self) -> str:
        return f"Body({self.to_dict()})"


# Unit-tag dimension groups used by System.standardize_units. Aliases map
# the loose strings accepted by the reference API onto canonical tags.
_TAG_ALIASES = {
    "meters": "meters", "m": "meters", "au": "au",
    "radians": "radians", "degrees": "degrees",
    "kilograms": "kilograms", "kg": "kilograms",
    "m_solar": "m_solar", "solar_masses": "m_solar",
    "seconds": "seconds", "s": "seconds", "days": "days", "day": "days",
}
_DIMENSIONS = {
    "meters": "distance", "au": "distance",
    "radians": "angle", "degrees": "angle",
    "kilograms": "mass", "m_solar": "mass",
    "seconds": "time", "days": "time",
}


class System:
    """An ordered collection of bodies plus target unit tags
    (reference: core/body.py:252-317)."""

    def __init__(
        self,
        bodies: list[Body],
        distance_unit: str = "meters",
        mass_unit: str = "kg",
        angle_unit: str = "radians",
        time_unit: str = "seconds",
    ):
        self.bodies = bodies
        self.distance_unit = distance_unit
        self.mass_unit = mass_unit
        self.angle_unit = angle_unit
        self.time_unit = time_unit

    def __getitem__(self, idx: int) -> Body:
        return self.bodies[idx]

    def __len__(self) -> int:
        return len(self.bodies)

    def __repr__(self) -> str:
        return f"System({self.bodies})"

    def to_dict(self) -> dict:
        return {body.name: body.to_dict() for body in self.bodies}

    def to_json(self) -> dict:
        return {body.name: body.to_json() for body in self.bodies}

    def values(self) -> dict:
        return self.to_json()

    def _target_tag(self, unit: Unit) -> Optional[str]:
        dim = _DIMENSIONS.get(unit.unit)
        if dim is None:
            return None
        want = {
            "distance": self.distance_unit,
            "angle": self.angle_unit,
            "mass": self.mass_unit,
            "time": self.time_unit,
        }[dim]
        return _TAG_ALIASES.get(want)

    def _convert(self, value):
        if not isinstance(value, Unit):
            return value
        target = self._target_tag(value)
        if target is None or target == value.unit:
            return value
        from .units import convert

        return convert(value, target)

    def standardize_units(
        self,
        distance_unit: Optional[str] = None,
        mass_unit: Optional[str] = None,
        angle_unit: Optional[str] = None,
        time_unit: Optional[str] = None,
    ) -> None:
        """In-place conversion of every Unit-tagged attribute on every body
        to the requested tags (reference: core/body.py:307-317)."""
        self.distance_unit = distance_unit or self.distance_unit
        self.mass_unit = mass_unit or self.mass_unit
        self.angle_unit = angle_unit or self.angle_unit
        self.time_unit = time_unit or self.time_unit

        for body in self.bodies:
            for attr_name, attr in body.__dict__.items():
                setattr(body, attr_name, self._convert(attr))
