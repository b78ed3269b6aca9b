"""Host-side scene definition: units, constants, Keplerian bodies, datasets,
dynamic objects and the scene arrays they compile into (copies of
``orbital_tpu.models``, pure Python and numpy), and the bundled examples
(``models.examples``, the reference's ``core/examples.py`` scenes)."""
from . import body, constants, datasets, kepler, objects, rigid, scene, units  # noqa: F401
