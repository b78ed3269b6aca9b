"""Compat: reference core/physics.py surface (orbital_tpu_torch.models.*)."""
from orbital_tpu_torch.models.kepler import solve_kepler  # noqa: F401
from orbital_tpu_torch.models.objects import (  # noqa: F401
    Coordinates,
    Object,
    ObjectCollection,
    collide_spheres,
    fragmentation_probability,
    pairwise_accelerations,
    resolve_collision,
    set_circular_orbit,
)
from orbital_tpu_torch.models.rigid import (  # noqa: F401
    moment_of_inertia,
    random_angular_velocity,
)
