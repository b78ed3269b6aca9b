"""Host-side dynamic bodies: ``Coordinates``, ``Object``, ``ObjectCollection``.

API-parity layer over the reference's ``core/physics.py`` object model
(reference: core/physics.py:16-40, 161-332, 452-535). These are *scene
construction and inspection* objects only: the engine compiles an
``ObjectCollection`` into structure-of-arrays device state
(``orbital_tpu_torch.engine.state.NBodyState``) and steps it with PyTorch and
CUDA kernels — no per-object Python physics runs inside the hot loop. A
copy of ``orbital_tpu.models.objects``, so that this package never imports
the JAX one.

Numerics note: the reference coerces ``velocity`` and ``angular_velocity``
to float32 in the constructor (reference: core/physics.py:184,188), which
measurably degrades its solar-system energy drift. This build keeps float64
host-side; device precision is a policy of the engine (see
``engine.state.Precision``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional
from uuid import uuid4

import numpy as np

from .constants import ASTRO, STANDARD, UnitProfile, UnitSystem
from .rigid import moment_of_inertia, random_angular_velocity

__all__ = [
    "Coordinates",
    "Object",
    "ObjectCollection",
    "pairwise_accelerations",
    "collide_spheres",
    "set_circular_orbit",
    "fragmentation_probability",
    "resolve_collision",
]


@dataclass
class Coordinates:
    """3D position; the origin is arbitrary (reference: core/physics.py:16-40)."""

    x: float
    y: float
    z: float

    def to_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z])

    @classmethod
    def from_iterable(cls, lst: Iterable[float]) -> "Coordinates":
        lst = list(lst)
        return cls(x=float(lst[0]), y=float(lst[1]), z=float(lst[2]))

    @classmethod
    def random(cls) -> "Coordinates":
        """Uniform in [-1, 1]^3."""
        x, y, z = np.random.uniform(-1.0, 1.0, size=3)
        return cls(x=x, y=y, z=z)


class Object:
    """A massive dynamic body (reference: core/physics.py:161-332).

    Attributes mirror the reference: ``mass``, ``radius``, ``coordinates``,
    ``velocity``, ``moi`` (sphere moment of inertia by default),
    ``angular_velocity`` (random by default), ``uuid`` (hex uuid4),
    ``name`` (defaults to the first 6 uuid chars), ``unit_profile``.
    """

    def __init__(
        self,
        mass: float,
        radius: float,
        velocity: Optional[np.ndarray],
        coordinates: Optional[Coordinates] = None,
        moi: Optional[float] = None,
        angular_velocity: Optional[np.ndarray] = None,
        uuid: Optional[str] = None,
        unit_profile: UnitProfile = STANDARD,
        name: Optional[str] = None,
    ):
        self.mass = mass
        self.radius = radius
        self.coordinates = coordinates if coordinates else Coordinates.random()
        self.velocity = (
            np.asarray(velocity, dtype=np.float64).copy()
            if velocity is not None
            else np.zeros(3)
        )
        self.moi = moi if moi is not None else moment_of_inertia(mass, radius, shape="sphere")
        self.angular_velocity = (
            np.asarray(angular_velocity, dtype=np.float64).copy()
            if angular_velocity is not None
            else random_angular_velocity()
        )
        self.uuid = uuid if uuid else uuid4().hex
        self.name = name if name is not None else self.uuid[:6]
        self.unit_profile = unit_profile

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "mass": self.mass,
            "radius": self.radius,
            "coordinates": {"x": self.coordinates.x, "y": self.coordinates.y, "z": self.coordinates.z},
            "velocity": np.asarray(self.velocity).tolist(),
            "moi": self.moi,
            "angular_velocity": np.asarray(self.angular_velocity).tolist(),
            "uuid": self.uuid,
            # the reference's from_dict reads "name" but its to_dict never
            # writes it (core/physics.py:193-229); we close that round trip
            "name": self.name,
            "unit_profile": self.unit_profile.name.value
            if isinstance(self.unit_profile.name, UnitSystem)
            else str(self.unit_profile.name),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "Object":
        """JSON round-trip. Unlike the reference (whose astro branch builds a
        broken ad-hoc profile, core/physics.py:208-218), this resolves the
        canonical ASTRO profile so ``to_dict`` keeps working."""
        profile = ASTRO if data.get("unit_profile", "si") == "astro" else STANDARD
        return cls(
            mass=data["mass"],
            radius=data["radius"],
            coordinates=Coordinates.from_iterable(
                [data["coordinates"]["x"], data["coordinates"]["y"], data["coordinates"]["z"]]
            ),
            velocity=np.array(data["velocity"]),
            moi=data.get("moi"),
            angular_velocity=np.array(data.get("angular_velocity", [0.0, 0.0, 0.0])),
            uuid=data.get("uuid"),
            unit_profile=profile,
            name=data.get("name"),
        )

    def set_unit_profile(self, unit_profile: UnitProfile) -> None:
        self.unit_profile = unit_profile

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Object) and self.uuid == other.uuid

    def __hash__(self):
        return hash(self.uuid)

    def __repr__(self) -> str:
        return f"Object({self.to_dict()})"

    # -- kinematics ----------------------------------------------------------

    def position(self) -> np.ndarray:
        return self.coordinates.to_array()

    def lagrangian(self, system: Iterable["Object"]) -> float:
        """L = T - U: translational + rotational kinetic energy minus the
        pairwise potential against every other body
        (reference: core/physics.py:243-283)."""
        T_trans = 0.5 * self.mass * float(np.dot(self.velocity, self.velocity))
        T_rot = 0.5 * self.moi * float(np.dot(self.angular_velocity, self.angular_velocity))
        pe = 0.0
        r_self = self.position()
        for other in system:
            if other is not self:
                r = float(np.linalg.norm(r_self - other.position()))
                pe += -self.unit_profile.G * self.mass * other.mass / r
        return (T_trans + T_rot) - pe

    def force_vector(self, other: "Object") -> np.ndarray:
        """Gravitational force this body feels toward ``other``:
        F = G m1 m2 / r^2 along r_hat; zero at zero separation
        (reference: core/physics.py:285-313). Antisymmetric by construction:
        a.force_vector(b) == -b.force_vector(a)."""
        r_vec = other.position() - self.position()
        dist = float(np.linalg.norm(r_vec))
        if dist == 0.0:
            return np.zeros(3)
        mag = self.unit_profile.G * self.mass * other.mass / dist**2
        return mag * (r_vec / dist)

    def update(self, acceleration: np.ndarray, dt: float) -> None:
        """Plain (semi-implicit) Euler step: v += a dt; r += v dt
        (reference: core/physics.py:315-332). The engine's leapfrog stepper
        does not use this; it exists for API parity and one-off nudges."""
        self.velocity = self.velocity + acceleration * dt
        self.coordinates = Coordinates.from_iterable(self.position() + self.velocity * dt)


def pairwise_accelerations(
    objects: list[Object],
    eps: float = 0.0,
    unit_profile: UnitProfile = STANDARD,
) -> tuple[dict[str, np.ndarray], float]:
    """Softened O(N^2) gravitational accelerations + total potential energy.

    Same contract as the reference (dict keyed by uuid, plus the softened
    potential U = -sum_{i<j} G m_i m_j / sqrt(r^2 + eps^2); reference:
    core/physics.py:125-159) but fully vectorized over numpy — the host
    fallback of the device force kernels in ``orbital_tpu_torch.ops.forces``.
    """
    n = len(objects)
    if n == 0:
        return {}, 0.0
    pos = np.stack([o.position() for o in objects])  # [N,3] f64
    mass = np.array([o.mass for o in objects])       # [N]

    d = pos[None, :, :] - pos[:, None, :]            # r_j - r_i, [N,N,3]
    r2 = np.einsum("ijk,ijk->ij", d, d) + eps * eps
    np.fill_diagonal(r2, 1.0)                         # avoid 0/0 on the diagonal
    inv_r = 1.0 / np.sqrt(r2)
    inv_r3 = inv_r / r2
    np.fill_diagonal(inv_r, 0.0)
    np.fill_diagonal(inv_r3, 0.0)

    G = unit_profile.G
    acc = G * np.einsum("ij,ijk->ik", mass[None, :] * inv_r3, d)
    U = -0.5 * G * float(np.sum(mass[:, None] * mass[None, :] * inv_r))
    return {o.uuid: acc[i] for i, o in enumerate(objects)}, U


def collide_spheres(obj1: Object, obj2: Object, restitution: float = 1.0) -> None:
    """Impulse-based sphere collision along the contact normal with
    coefficient of restitution e, plus mass-weighted positional de-overlap
    (reference: core/physics.py:391-422). No-op for separating pairs or
    exact coincidence. Mutates both objects in place."""
    r1, r2 = obj1.position(), obj2.position()
    n = r1 - r2
    dist = float(np.linalg.norm(n))
    if dist == 0.0:
        return
    n = n / dist

    m1_inv, m2_inv = 1.0 / obj1.mass, 1.0 / obj2.mass
    v_rel = float(np.dot(obj1.velocity - obj2.velocity, n))
    if v_rel >= 0.0:
        return  # separating

    e = float(np.clip(restitution, 0.0, 1.0))
    j = -(1.0 + e) * v_rel / (m1_inv + m2_inv)
    impulse = j * n
    obj1.velocity = obj1.velocity + impulse * m1_inv
    obj2.velocity = obj2.velocity - impulse * m2_inv

    overlap = obj1.radius + obj2.radius - dist
    if overlap > 0.0:
        corr = overlap / (m1_inv + m2_inv)
        obj1.coordinates = Coordinates.from_iterable(r1 + n * (corr * m1_inv))
        obj2.coordinates = Coordinates.from_iterable(r2 - n * (corr * m2_inv))


def set_circular_orbit(
    primary: Object,
    secondary: Object,
    plane_normal: np.ndarray = np.array([0.0, 0.0, 1.0]),
    unit_profile: UnitProfile = STANDARD,
) -> None:
    """Set velocities for a circular two-body orbit about the barycenter,
    zeroing total momentum: v2 = sqrt(G(m1+m2)/R) tangentially and
    v1 = -(m2/m1) v2 (reference: core/physics.py:425-449)."""
    r = secondary.position() - primary.position()
    R = float(np.linalg.norm(r))
    if R == 0.0:
        raise ValueError("Bodies at same position.")

    t = np.cross(plane_normal / np.linalg.norm(plane_normal), r / R)
    if np.linalg.norm(t) < 1e-12:  # radius parallel to the plane normal
        t = np.cross(np.array([0.0, 1.0, 0.0]), r / R)
    t = t / np.linalg.norm(t)

    v_mag = np.sqrt(unit_profile.G * (primary.mass + secondary.mass) / R)
    v2 = v_mag * t
    primary.velocity = -(secondary.mass / primary.mass) * v2
    secondary.velocity = v2


def fragmentation_probability(obj1: Object, obj2: Object) -> float:
    """Logistic fragmentation probability in collision kinetic energy:
    p = sigmoid(k (E_coll/E_thresh - 1)) with E_coll = mu v_rel^2 / 2,
    E_thresh = (m1+m2) 1e3 / 2, k = 5 (reference: core/physics.py:335-359)."""
    v_rel = float(np.linalg.norm(obj1.velocity - obj2.velocity))
    mu = (obj1.mass * obj2.mass) / (obj1.mass + obj2.mass)
    E_coll = 0.5 * mu * v_rel**2
    E_thresh = 0.5 * (obj1.mass + obj2.mass) * 1e3
    k = 5.0
    return float(1.0 / (1.0 + np.exp(-k * (E_coll / E_thresh - 1.0))))


def resolve_collision(obj1: Object, obj2: Object, collection: "ObjectCollection") -> None:
    """Collision outcome model (reference: core/physics.py:361-388):
    mass ratio > 10 -> absorption (volume-additive radius); otherwise
    probabilistic fragmentation (both bodies removed; debris generation is
    not modeled); otherwise leave the elastic bounce to
    ``handle_collisions``."""
    mass_ratio = max(obj1.mass, obj2.mass) / min(obj1.mass, obj2.mass)
    if mass_ratio > 10.0:
        larger, smaller = (obj1, obj2) if obj1.mass > obj2.mass else (obj2, obj1)
        larger.mass += smaller.mass
        larger.radius = (larger.radius**3 + smaller.radius**3) ** (1.0 / 3.0)
        collection.remove(smaller)
    elif np.random.rand() < fragmentation_probability(obj1, obj2):
        collection.remove(obj1)
        collection.remove(obj2)


class ObjectCollection:
    """A list of objects with collision handling
    (reference: core/physics.py:452-535)."""

    def __init__(self, objects: list[Object]):
        self.objects = objects

    def to_dict(self) -> list[dict]:
        return [obj.to_dict() for obj in self.objects]

    @classmethod
    def from_dict(cls, data: list[dict]) -> "ObjectCollection":
        return cls([Object.from_dict(d) for d in data])

    def __len__(self) -> int:
        return len(self.objects)

    def __getitem__(self, index):
        return self.objects[index]

    def __iter__(self):
        return iter(self.objects)

    def extend(self, new_objects: Iterable[Object]) -> None:
        self.objects.extend(new_objects)

    def append(self, new_object: Object) -> None:
        self.objects.append(new_object)

    def pop(self, index: int = -1) -> Object:
        return self.objects.pop(index)

    def remove(self, obj: Object) -> None:
        self.objects.remove(obj)

    def force_vector_map(self) -> dict[str, np.ndarray]:
        """Unsoftened O(N^2) acceleration map via pairwise force vectors
        (reference: core/physics.py:478-492). Not used by the engine —
        ``pairwise_accelerations`` is the canonical force path."""
        out = {}
        for i, obj in enumerate(self.objects):
            a = np.zeros(3)
            for j, other in enumerate(self.objects):
                if i != j:
                    a += obj.force_vector(other) / obj.mass
            out[obj.uuid] = a
        return out

    def handle_collisions(self, restitution: float = 1.0, merge_on_capture: bool = False) -> None:
        """One sequential i<j sweep of overlap resolution per call, matching
        the reference's per-step semantics (reference: core/physics.py:510-535):
        either momentum-conserving merge (volume-additive radius, mass-weighted
        center) or an impulse bounce via :func:`collide_spheres`."""
        n = len(self.objects)
        to_remove: list[Object] = []
        for i in range(n):
            oi = self.objects[i]
            for j in range(i + 1, n):
                oj = self.objects[j]
                dist = float(np.linalg.norm(oi.position() - oj.position()))
                if dist <= (oi.radius + oj.radius):
                    if merge_on_capture:
                        m_new = oi.mass + oj.mass
                        v_new = (oi.mass * oi.velocity + oj.mass * oj.velocity) / m_new
                        r_new = (oi.mass * oi.position() + oj.mass * oj.position()) / m_new
                        R_new = (oi.radius**3 + oj.radius**3) ** (1.0 / 3.0)
                        oi.mass, oi.velocity, oi.radius = m_new, v_new, R_new
                        oi.coordinates = Coordinates.from_iterable(r_new)
                        to_remove.append(oj)
                    else:
                        collide_spheres(oi, oj, restitution=restitution)
        for obj in to_remove:
            self.remove(obj)
