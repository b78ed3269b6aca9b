"""Worker for the multi-process sharding tests of the PyTorch port.

Launched twice by ``test_torch_sharded.py::test_gloo_processes_match_the_one_card_mesh``
(``run``: the ring's steps and rollout) and by
``test_torch_sharded_p3m.py::test_gloo_processes_match_the_one_card_mesh``
(``run_solvers``: P3M's ring and the sharded tree): the two processes form
one ``torch.distributed`` gloo group over a ``file://`` store, so the ring
shifts, psums and gathers cross a process boundary. Each process builds the
same state from the same seed (``scene`` below, which the tests import
too), keeps its shard, runs the sharded functions on ``make_mesh()`` (the
process group), and rank 0 saves the gathered results to
``OUT_DIR/rank0.npz``.

Usage: python torch_dist_worker.py STORE_FILE RANK OUT_DIR [solvers]
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


def run_solvers(mesh, device: str = "cpu") -> dict:
    """P3M's ring force (grid 32, pinned box) and a sharded tree step
    (``near="kernel"``, levels 4) on ``mesh``: the gathered results, by
    name."""
    import torch

    import orbital_tpu_torch as tot
    from orbital_tpu_torch.ops.p3m import p3m_max_occupancy, p3m_ring_force
    from orbital_tpu_torch.ops.tree_near_wl import tree_wl_budgets

    pos, vel, mass, _ = scene()
    out = {}
    p = torch.tensor(pos, dtype=torch.float32, device=device)
    m = torch.tensor(mass, dtype=torch.float32, device=device)
    alive = torch.ones(len(mass), dtype=torch.bool, device=device)
    box = (torch.zeros(3, device=device), torch.tensor(12.0, device=device))
    cap = p3m_max_occupancy(p, alive, grid=32, box=box)
    cut = [list(t.chunk(mesh.size)) for t in (p, m, alive)]
    mine = [[c[r] for r in mesh.ranks] for c in cut]
    res = mesh.run(lambda c, x, ms, a: p3m_ring_force(x, ms, a, G_grav=1.0, eps2=1e-4,
                                                      grid=32, capacity=cap, box=box, comm=c),
                   *mine)
    acc = torch.cat([r[0] for r in res]) if mesh.local else mesh.comms[0].all_gather(res[0][0])
    out["p3m_acc"], out["p3m_U"] = acc.numpy(), res[0][1].numpy()
    k_ch, q = tree_wl_budgets(pos, levels=4, chunk=32, rj=4)
    cfg = tot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="tree", tree_levels=4,
                        tree_near="kernel", tree_chunk=32, tree_wl_rj=4, tree_max_chunks=k_ch,
                        tree_wl_entries=q)
    st = tot.init_forces(tot.make_state(pos, vel, mass, precision="f32", device=device), cfg)
    full = tot.gather_state(mesh, tot.make_sharded_step(cfg, mesh, st)(
        tot.shard_state(mesh, st)))
    for f in ("pos", "vel", "acc", "potential"):
        out[f"tree_{f}"] = getattr(full, f).numpy()
    return out


def main() -> int:
    store, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    solvers = sys.argv[4:] == ["solvers"]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        import orbital_tpu_torch as tot

        mesh = tot.make_mesh()
        assert mesh.shape == {"body": 2} and not mesh.local and mesh.ranks == [rank]
        out = run_solvers(mesh) if solvers else run(mesh)
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
        print(f"RANK {rank} OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
