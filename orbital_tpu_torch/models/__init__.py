"""Host-side scene definition: units, constants, Keplerian bodies, datasets,
dynamic objects and the scene arrays they compile into (copies of
``orbital_tpu.models``, pure Python and numpy). ``orbital_tpu.models.examples``
is not ported yet (ROADMAP.md queue A item A.10b)."""
from . import body, constants, datasets, kepler, objects, rigid, scene, units  # noqa: F401
