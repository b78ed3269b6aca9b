"""Multi-device and ensemble parallelism: device meshes (``parallel.mesh``:
one-card ranks or a ``torch.distributed`` process group), the body-sharded
ring forces, collisions and PM (``parallel.sharded``), and Monte-Carlo
ensembles of E systems stepped together on one device
(``parallel.ensemble``). The sharded P3M, tree and RESPA and the
(ensemble x body) mesh are ROADMAP.md queue A item A.15b."""
from .mesh import BODY_AXIS, ENSEMBLE_AXIS, make_mesh
from .sharded import gather_state, make_sharded_rollout, make_sharded_step, shard_state

__all__ = ["make_mesh", "BODY_AXIS", "ENSEMBLE_AXIS", "make_sharded_step",
           "make_sharded_rollout", "shard_state", "gather_state"]
