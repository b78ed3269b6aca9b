"""Multi-device and ensemble parallelism: device meshes (``parallel.mesh``:
one-card ranks or a ``torch.distributed`` process group, of one axis or
several), the body-sharded ring forces, collisions, the mesh solvers (PM,
P3M's ring, the sharded tree), the sharded RESPA and the (ensemble x body)
mesh step (``parallel.sharded``), and Monte-Carlo ensembles of E systems
stepped together on one device (``parallel.ensemble``)."""
from .mesh import BODY_AXIS, ENSEMBLE_AXIS, make_mesh
from .sharded import (gather_ensemble, gather_state, make_sharded_ensemble_step,
                      make_sharded_respa_rollout, make_sharded_rollout, make_sharded_step,
                      shard_ensemble, shard_state)

__all__ = ["make_mesh", "BODY_AXIS", "ENSEMBLE_AXIS", "make_sharded_step",
           "make_sharded_rollout", "make_sharded_respa_rollout", "make_sharded_ensemble_step",
           "shard_state", "gather_state", "shard_ensemble", "gather_ensemble"]
