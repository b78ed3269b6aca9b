"""Worker for the multi-process sharding test of the PyTorch port.

Launched twice by ``test_torch_sharded.py::test_gloo_processes_match_the_one_card_mesh``:
the two processes form one ``torch.distributed`` gloo group over a ``file://``
store, so the sharded step's ring shifts, psums and gathers cross a process
boundary. Each process builds the same state from the same seed
(``scene`` below, which the test imports too), keeps its shard, runs the
sharded steps and rollout of ``run`` on ``make_mesh()`` (the process group),
and rank 0 saves the gathered results to ``OUT_DIR/rank0.npz``.

Usage: python torch_dist_worker.py STORE_FILE RANK OUT_DIR
Imports torch and the port only, never JAX.
"""
import datetime
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def scene(n: int = 256, seed: int = 3):
    """A cluster with two cross-shard contact pairs (shards of 128)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 3.0
    vel = rng.normal(size=(n, 3)) * 0.01
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 2e-3)
    pos[200] = pos[5] + 1e-3
    pos[130] = pos[64] - 1e-3
    return pos, vel, mass, radius


def run(mesh, device: str = "cpu") -> dict:
    """Merge, bounce and collision-free steps and a recorded rollout on
    ``mesh``: every gathered field, by name."""
    import orbital_tpu_torch as tot

    pos, vel, mass, radius = scene()
    out = {}
    for mode, steps in (("merge", 3), ("bounce", 3)):
        cfg = tot.SimConfig(dt=1e-3, G=1e-3, eps2=1e-4, collisions=mode, restitution=0.5,
                            ring_block_impl="pallas")
        st = tot.init_forces(tot.make_state(pos, vel, mass, radius, precision="f32",
                                            device=device), cfg.replace(force_impl="dense"))
        step = tot.make_sharded_step(cfg, mesh, st)
        shards = tot.shard_state(mesh, st)
        for _ in range(steps):
            shards = step(shards)
        full = tot.gather_state(mesh, shards)
        for f in ("pos", "vel", "mass", "radius", "alive", "acc", "potential"):
            out[f"{mode}_{f}"] = getattr(full, f).numpy()
    cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    st = tot.init_forces(tot.make_state(pos, vel, mass, precision="ds32", device=device), cfg)
    roll = tot.make_sharded_rollout(cfg, mesh, st, steps=4, record_every=2)
    shards, traj = roll(tot.shard_state(mesh, st))
    full = tot.gather_state(mesh, shards)
    for f in ("pos", "pos_lo", "vel", "vel_lo", "acc", "potential"):
        out[f"roll_{f}"] = getattr(full, f).numpy()
    for f in ("pos", "vel", "energy", "ang_mom", "alive"):
        out[f"traj_{f}"] = getattr(traj, f).numpy()
    return out


def main() -> int:
    store, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        import orbital_tpu_torch as tot

        mesh = tot.make_mesh()
        assert mesh.shape == {"body": 2} and not mesh.local and mesh.ranks == [rank]
        out = run(mesh)
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
        print(f"RANK {rank} OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
