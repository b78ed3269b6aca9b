"""Body-sharded exact forces: a ring over the ranks of a mesh.

A port of ``orbital_tpu/parallel/sharded.py``'s exact-force path. The
O(N^2) sweep is ring attention's: each rank keeps its shard of the bodies
resident while a copy of another shard's positions and masses travels round
the ring (``Comm.ppermute``, rank r to r + 1); each round adds that shard's
partial accelerations and potential. After P rounds every shard has seen
every body. Each function here is the code of ONE rank, written against its
communicator (``parallel.mesh``), and a :class:`~.mesh.Mesh` runs it on
every rank: P threads on one card, or one process a rank under
``torch.distributed``.

  * :func:`ring_force_fn`: the ring. Each round's block is B3
    (``ops.cuda_forces.block_acc_cuda``) on CUDA tensors in float32 when
    the shard tiles by 128 and eps2 > 0 (``ring_block_impl="auto"`` or
    ``"pallas"``), else the dense ``ops.forces.block_acc_potential`` (an
    untileable shard, eps2 = 0, CPU tensors under "auto"; JAX's rule,
    ``sharded.py:254-257``). A float64 shard takes B3 too, f32 inside and
    its rounds added in f64, as JAX's ``block_acc_pallas`` returns them.
    Nothing falls back from the kernel when a build or launch fails. The
    self term m/eps comes off the pe row once, after the rounds; U is
    psum'd. With ``detect=True`` the same rounds also count the step's
    contacts: B3's detecting instance (``block_acc_detect_cuda``) with the
    blocks' global offsets, psum'd; a float64 shard takes its f64 instance
    (the forces f32 inside and bit-equal to B3's, the count in double, the
    tables read as they are). The JAX package counts in a separate
    sqrt-free ring after the step (``ring_contacts_fn``) on the same
    positions, in the state's dtype; here the step's closing force
    evaluation counts them, as B2 does on one card. On float64 CUDA shards
    the ring also ships each shard's cast view (:func:`_ships_views`):
    round 0, whose visitor is the rank's own shard, writes it as it stages,
    and every later round stages its rows from the rank's view and the
    visitor's.
  * :func:`ring_bounce_fn`: the bounce impulses over the same ring (the
    block bounce, ``ops.cuda_collisions.bounce_block_cuda``, each round
    adding into the rank's sums in place; a float64 shard on its f64
    instance, in double as JAX's ``_block_bounce``), gated on the
    device-held count: a contact-free step writes zeros in its first round
    and skips the others, and the stepper's ``torch.where`` keeps the state
    bit for bit; its float64 CUDA shards ship their cast views as the
    forces' do.
  * merge and resolve: when the psum'd count is > 0 (read on the host once
    a step, by every rank, after the step's force evaluation), every rank
    gathers the whole system, runs the single-card merge or resolve on it
    (``engine.integrators._apply_collisions``: the contact sweep on CUDA
    tensors; the draws from ``(frag_seed, step)``, replicated) and slices
    its shard back out. A contact-free step pays the host read and nothing
    else.
  * the mesh solvers: ``force_impl="pm"``, ``ops.pm.pm_acc_potential`` with
    the communicator (the cube by pmin/pmax, one psum of the density grid);
    ``"p3m"``, ``ops.p3m.p3m_ring_force`` (PM's pipeline plus the short
    range's ring on the kernel's two-table form); ``"tree"``,
    ``ops.tree.tree_sharded_force`` (the far field replicated, the near
    lists split across the ranks, B7's slice for ``"kernel"``). With
    collisions, the count comes from :func:`ring_contacts_fn` after the step:
    P rounds of the contact sweep's count mode on CUDA shards.

:func:`make_sharded_step` and :func:`make_sharded_rollout` build the whole
step on every rank. A sharded state is a list of the local shards' states
(:func:`shard_state`; every shard holds the replicated scalars), and
:func:`gather_state` assembles the full state.
:func:`make_sharded_respa_rollout` runs the multirate stepper with the
closing exact evaluation on the ring and the near sweep split by i chunk;
:func:`make_sharded_ensemble_step` steps an ensemble over an (ensemble x
body) mesh. Hermite under a mesh raises (``HERMITE_REFUSAL``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..engine.integrators import _apply_collisions, make_step_fn
from ..engine.state import NBodyState
from ..ops.collisions import block_contacts
from ..ops.forces import block_acc_potential
from ..utils.config import SimConfig
from .mesh import Comm, Mesh

__all__ = ["ring_force_fn", "ring_bounce_fn", "ring_contacts_fn", "make_sharded_step",
           "make_sharded_rollout", "make_sharded_respa_rollout",
           "make_sharded_ensemble_step", "state_sharding", "shard_state", "gather_state",
           "shard_ensemble", "gather_ensemble", "HERMITE_REFUSAL"]

_BODY_FIELDS = ("pos", "vel", "mass", "radius", "alive", "acc", "pos_lo", "vel_lo", "jerk")
_SCALAR_FIELDS = ("potential", "time", "step")

# why Hermite under a mesh is refused: the JAX package has no sharded
# Hermite to hold one against
HERMITE_REFUSAL = (
    "integrator='hermite' under a mesh: the JAX package's sharded step "
    "(orbital_tpu/parallel/sharded.py:393) builds make_step_fn(cfg, force) with no "
    "accel_jerk_fn, so its Hermite branch (orbital_tpu/engine/integrators.py:272-277) "
    "evaluates accel_jerk_dense on each shard alone, as if the shard were the whole "
    "system; there is no reference for an acc + jerk ring, and it is not ported")


def _ring_block_impl(cfg: SimConfig, block: int, pos: torch.Tensor) -> str:
    """``"pallas"`` (B3) or ``"dense"`` for a shard of ``block`` bodies."""
    tileable = block % 128 == 0 and cfg.eps2 > 0.0
    impl = cfg.ring_block_impl
    if impl == "auto":
        impl = "pallas" if tileable and pos.device.type == "cuda" else "dense"
    if impl == "pallas" and not tileable:
        raise ValueError(
            f"ring_block_impl='pallas' needs eps2 > 0 and a local block divisible by 128, "
            f"got block={block}, eps2={cfg.eps2}")
    return impl


def _ships_views(pos: torch.Tensor) -> bool:
    """Whether a ring ships the cast views of its shards with their tables:
    on float64 CUDA shards, whose f64 kernels (B3 detect's and the block
    bounce's) stage a shard's rows from its view (``ops.cuda_forces.
    detect_view_plain``, ``ops.cuda_collisions.bounce_view_plain``) in the
    rounds after the first.

    Each rank's round 0 (its visitor its own shard) writes its view; a
    later round reads the visitor's, which the shift hands over after that
    round 0. On one-card ranks every rank queues its work on one stream and
    a rank's round 0 is queued before the shift's barrier, so stream order
    finishes it before any later round reads it (``parallel.mesh``, the
    baton); under ``torch.distributed`` the shift's ``batch_isend_irecv``
    starts after the work queued on the sender's current stream and the
    receiver's stream waits for it (``req.wait()``)."""
    return pos.dtype == torch.float64 and pos.device.type == "cuda"


def ring_force_fn(cfg: SimConfig, comm: Comm, detect: bool = False):
    """The ring force of one rank: ``fn(pos, mass, alive) -> (acc, U)``, the
    rank's shard of the accelerations and the global potential; with
    ``detect``, ``fn(pos, mass, radius, alive) -> (acc, U, contacts)``,
    ``contacts`` the psum'd directed touching-pair count (int32 0-dim) of
    the whole system at these positions."""
    P, rank = comm.size, comm.rank
    from ..ops.cuda_forces import block_acc_cuda, block_acc_detect_cuda, detect_view_size

    def rounds(pos, mass, alive, radius=None):
        mass_eff = mass * alive.to(mass.dtype)
        block = pos.shape[0]
        impl = _ring_block_impl(cfg, block, pos)
        kw = dict(G=cfg.G, eps2=cfg.eps2)
        visit = (pos, mass_eff) if radius is None else (pos, mass_eff, radius, alive)
        # the rank's cast view, written by round 0 and shipped with the tables
        own = (torch.empty(detect_view_size(block), dtype=torch.float32, device=pos.device)
               if radius is not None and impl == "pallas" and _ships_views(pos) else None)
        acc = pe = count = None
        for k in range(P):
            j_off = ((rank - k) % P) * block  # the visiting shard's first global id
            if radius is None:
                a, p = (block_acc_cuda(pos, *visit, **kw) if impl == "pallas" else
                        block_acc_potential(pos, *visit, **kw))
            elif impl == "pallas":
                p_j, m_j, r_j, al_j = visit[:4]
                vkw = ({} if own is None else dict(view_out=own) if k == 0
                       else dict(views=(own, visit[4])))
                a, p, c = block_acc_detect_cuda(pos, radius, alive, rank * block, p_j, m_j,
                                                r_j, al_j, j_off, **kw, **vkw)
            else:
                p_j, m_j, r_j, al_j = visit
                a, p = block_acc_potential(pos, p_j, m_j, **kw)
                c = block_contacts(pos, radius, alive, rank * block, p_j, r_j, al_j, j_off)
            acc, pe = (a, p) if k == 0 else (acc + a, pe + p)
            if radius is not None:
                count = c if k == 0 else count + c
            if k < P - 1:
                visit = comm.ppermute(visit if k or own is None else visit + (own,))
        acc = acc * alive[:, None].to(acc.dtype)
        if cfg.eps2 > 0.0:
            # remove the analytic self term that the mask-free sweep includes
            pe = pe - mass_eff.to(pe.dtype) * (1.0 / float(cfg.eps2) ** 0.5)
        U = -0.5 * cfg.G * comm.psum(torch.sum(mass_eff.to(pe.dtype) * pe))
        U = U.to(pos.dtype)
        if radius is None:
            return acc.to(pos.dtype), U
        return acc.to(pos.dtype), U, comm.psum(count)

    if detect:
        return lambda pos, mass, radius, alive: rounds(pos, mass, alive, radius)
    return lambda pos, mass, alive: rounds(pos, mass, alive)


def ring_bounce_fn(cfg: SimConfig, comm: Comm):
    """Cross-shard restitution collisions over the same ring as the forces:
    ``fn(pos, vel, mass, radius, alive, restitution, contacts) -> (dpos,
    dvel)`` for the rank's shard (the signature of
    ``integrators.resolve_bounce_fn``'s sweep), every impulse from the
    pre-collision velocities (consistent with the unsharded sweep). Each
    round is the block bounce of the visiting shard, gated on ``contacts``
    (the psum'd count: 0 writes zeros in the first round and skips the rest
    on the card), in the shard's dtype (float32, or float64 on the f64
    instance, as JAX's ``_block_bounce`` runs in the state's dtype). Round
    0 writes the rank's (dpos, dvel) and each later round adds its sum to
    them in place (``out=``), the rounding of ``dpos + dp``; the wrapper's
    checks run on the first step of each shard shape and dtype only, when
    the shard's tables share one dtype and are contiguous."""
    from ..ops.cuda_collisions import bounce_block_cuda, bounce_view_size

    P = comm.size
    checked = set()  # shard shapes and dtypes whose tensors the wrapper has checked

    def fn(pos, vel, mass, radius, alive, restitution, contacts):
        local = (pos, vel, mass, radius, alive)
        visit, out = local, None
        key = (pos.shape[0], pos.device, pos.dtype)
        # the rank's cast view: round 0 writes it when the count lets it sweep
        own = (torch.empty(bounce_view_size(pos.shape[0]), dtype=torch.float32,
                           device=pos.device) if _ships_views(pos) else None)
        for k in range(P):
            vkw = ({} if own is None else dict(view_out=own) if k == 0
                   else dict(views=(own, visit[5])))
            out = bounce_block_cuda(*local, *visit[:5], restitution=restitution,
                                    contacts=contacts, out=out, checked=key in checked, **vkw)
            if k < P - 1:
                visit = comm.ppermute(visit if k or own is None else visit + (own,))
        if pos.device.type == "cuda" and alive.dtype == torch.bool and all(
                t.dtype == pos.dtype for t in local[:4]) and all(
                t.is_contiguous() for t in local):
            checked.add(key)
        dpos, dvel = out
        keep = alive[:, None].to(dpos.dtype)
        return dpos * keep, dvel * keep

    return fn


def ring_contacts_fn(cfg: SimConfig, comm: Comm):
    """The global directed touching-pair count of the sharded system:
    ``fn(pos, radius, alive) -> contacts`` (int32 0-dim, psum'd), each round
    the sqrt-free block count of the visiting shard with global ids
    (``ops.cuda_collisions.block_contacts_cuda``: on CUDA shards the contact
    sweep's count mode, f32 or f64 by the shard's dtype, each round adding
    into the rank's count in place; on CPU shards its plain version,
    ``ops.collisions.block_contacts``). The exact-force steps count inside
    the ring's force evaluation instead; the mesh solvers' steps with
    collisions call this after the step, as the JAX package does on every
    path."""
    P, rank = comm.size, comm.rank
    from ..ops.cuda_collisions import block_contacts_cuda

    def fn(pos, radius, alive):
        block = pos.shape[0]
        visit = (pos, radius, alive)
        count = torch.zeros((), dtype=torch.int32, device=pos.device)
        for k in range(P):
            block_contacts_cuda(pos, radius, alive, rank * block, *visit,
                                ((rank - k) % P) * block, out=count)
            if k < P - 1:
                visit = comm.ppermute(visit)
        return comm.psum(count)

    return fn


def _mesh_force_fn(cfg: SimConfig, comm: Comm):
    """The mesh solver's force of one rank: PM (a local deposit and one psum
    of the grid), P3M (PM's pipeline plus the short range's ring,
    ``ops.p3m.p3m_ring_force``) or the tree (the bodies gathered, the far
    field replicated, the near sweep split across the ranks,
    ``ops.tree.tree_sharded_force``)."""
    from ..engine.rollout import _box_on, _tree_kwargs

    box = _box_on(cfg)
    if cfg.force_impl == "tree":
        from ..ops.tree import tree_sharded_force

        def tree(pos, mass, alive):
            return tree_sharded_force(pos, mass, alive, comm=comm,
                                      **_tree_kwargs(cfg, pos.device))
        return tree
    if cfg.force_impl == "p3m":
        from ..ops.p3m import p3m_ring_force

        return lambda pos, mass, alive: p3m_ring_force(
            pos, mass, alive, G_grav=cfg.G, eps2=cfg.eps2, grid=cfg.pm_grid,
            capacity=cfg.p3m_capacity, with_potential=cfg.track_potential,
            box=box(pos.device), comm=comm)
    from ..ops.pm import pm_acc_potential

    return lambda pos, mass, alive: pm_acc_potential(
        pos, mass, alive, G_grav=cfg.G, eps2=cfg.eps2, grid=cfg.pm_grid,
        with_potential=cfg.track_potential, box=box(pos.device), comm=comm)


def state_sharding(mesh: Mesh, state: NBodyState, axis: str = "body") -> list[slice]:
    """The body rows each rank of this process holds (``slice`` objects in
    ``mesh.ranks`` order); the scalars are replicated."""
    n_shards = mesh.shape[axis]
    block = state.n_bodies // n_shards
    return [slice(r * block, (r + 1) * block) for r in mesh.ranks]


def _slice_fields(s: NBodyState, rows: slice) -> NBodyState:
    return s.replace(**{f: None if getattr(s, f) is None else getattr(s, f)[rows]
                        for f in _BODY_FIELDS})


def shard_state(mesh: Mesh, state: NBodyState, axis: str = "body") -> list[NBodyState]:
    """A full state cut into the shards this process's ranks hold (a list in
    ``mesh.ranks`` order) on the mesh's device; under a process group every
    process builds the same full state and keeps its own shard."""
    if state.n_bodies % mesh.shape[axis]:
        raise ValueError(f"N={state.n_bodies} must divide across {mesh.shape[axis]} shards "
                         f"(pad via make_state(pad_to=...))")
    state = _to(state, mesh.device)
    return [_slice_fields(state, rows) for rows in state_sharding(mesh, state, axis)]


def _to(state: NBodyState, device: torch.device) -> NBodyState:
    if state.device == device:
        return state
    return NBodyState(**{f.name: None if getattr(state, f.name) is None
                         else getattr(state, f.name).to(device)
                         for f in dataclasses.fields(NBodyState)})


def _gather_state_full(comm: Comm, s: NBodyState) -> NBodyState:
    """all_gather every body-sharded field of a rank's state to the full N
    (the scalars are replicated already)."""
    return s.replace(**{f: None if getattr(s, f) is None else comm.all_gather(getattr(s, f))
                        for f in _BODY_FIELDS})


def _slice_state_local(comm: Comm, s: NBodyState, block: int) -> NBodyState:
    """Inverse of :func:`_gather_state_full`: this rank's shard of a full
    state."""
    return _slice_fields(s, slice(comm.rank * block, (comm.rank + 1) * block))


def gather_state(mesh: Mesh, shards: list[NBodyState]) -> NBodyState:
    """The full state of a sharded one (on every process under a process
    group: a collective)."""
    if mesh.local:
        return shards[0].replace(**{
            f: None if getattr(shards[0], f) is None
            else torch.cat([getattr(s, f) for s in shards]) for f in _BODY_FIELDS})
    return _gather_state_full(mesh.comms[0], shards[0])


def _normalize_sharded_cfg(cfg: SimConfig, axis: str) -> tuple[SimConfig, bool]:
    """Resolve the force routing for a body-sharded axis: mesh solvers
    (pm/p3m/tree) keep their impl, everything else becomes the ring."""
    use_mesh_solver = cfg.force_impl in ("pm", "p3m", "tree")
    cfg = cfg.replace(shard_axis=axis,
                      force_impl=cfg.force_impl if use_mesh_solver else "ring")
    return cfg, use_mesh_solver


def _resolve_gathered_fn(cfg: SimConfig, comm: Comm) -> Callable:
    """Merge or resolve for a body-sharded axis: ``fn(state, contacts) ->
    state``. When the psum'd count is > 0 (read on the host; every rank
    reads the same value, so all take the same branch), gather the whole
    system, run the single-card collision step on it replicated (merge's
    root search or resolve's mark on the card, resolve's draws from the
    replicated step counter) and slice this rank's shard back out, the lo
    words reset as on one card. Otherwise the state as it is."""

    def fn(s: NBodyState, contacts: torch.Tensor) -> NBodyState:
        if int(contacts) <= 0:
            return s
        full = _apply_collisions(cfg, _gather_state_full(comm, s), contacts)
        return _slice_state_local(comm, full, s.n_bodies)

    return fn


def _build_local_step(cfg: SimConfig, comm: Comm, use_mesh_solver: bool,
                      force: Optional[Callable] = None):
    """One rank's step: the KDK (or euler, rk4, yoshida4) stepper on the
    ring or a mesh solver (``force``, when given, in its place), then its
    collision mode."""
    if force is not None:
        detect = None
    elif use_mesh_solver:
        force, detect = _mesh_force_fn(cfg, comm), None
    else:
        force, detect = ring_force_fn(cfg, comm), ring_force_fn(cfg, comm, detect=True)
    if cfg.collisions == "none":
        return make_step_fn(cfg, force)
    contacts_ring = ring_contacts_fn(cfg, comm)
    if cfg.collisions == "bounce":
        bounce = ring_bounce_fn(cfg, comm)

        def apply(s, contacts):
            return _apply_collisions(cfg, s, contacts, bounce=bounce)
    else:
        apply = _resolve_gathered_fn(cfg, comm)

    def collide(s: NBodyState, contacts: Optional[torch.Tensor]) -> NBodyState:
        if contacts is None:  # PM: no force sweep to count in
            contacts = contacts_ring(s.pos, s.radius, s.alive)
        return apply(s, contacts)

    return make_step_fn(cfg, force, detect, collide=collide)


def _prepare(cfg: SimConfig, mesh: Mesh, state_example: NBodyState,
             axis: Optional[str]) -> tuple[SimConfig, bool]:
    """The sharded config and its checks: N divides across the shards, an
    untileable shard under ``ring_block_impl="pallas"`` and Hermite raise,
    and RESPA is sent to :func:`make_sharded_respa_rollout`."""
    axis = axis or cfg.shard_axis or "body"
    cfg, use_mesh_solver = _normalize_sharded_cfg(cfg, axis)
    n_shards, n_bodies = mesh.shape[axis], state_example.n_bodies
    if n_bodies % n_shards != 0:
        raise ValueError(f"N={n_bodies} must divide across {n_shards} shards "
                         f"(pad via make_state(pad_to=...))")
    if not use_mesh_solver:  # an untileable shard under "pallas" raises here
        _ring_block_impl(cfg, n_bodies // n_shards, state_example.pos)
    if cfg.integrator == "respa":
        raise ValueError("integrator='respa' under a mesh runs through "
                         "make_sharded_respa_rollout")
    if cfg.integrator == "hermite":
        raise NotImplementedError(HERMITE_REFUSAL)
    return cfg, use_mesh_solver


def make_sharded_step(cfg: SimConfig, mesh: Mesh, state_example: NBodyState,
                      axis: Optional[str] = None):
    """The full simulation step over a body-sharded mesh: ``step(shards) ->
    shards``, ``shards`` the list :func:`shard_state` makes. The stepper runs
    elementwise on each rank's shard; the exact force is the ring (P - 1
    shifts, one psum of the potential, with collisions one psum of the
    count); ``force_impl="pm"`` runs no ring: pmin/pmax agree the cube
    (skipped with a pinned ``cfg.pm_box``) and one psum of the G^3 grid
    makes the density global; ``"p3m"`` adds its short range's ring (P - 1
    shifts of the visiting shard's bodies); ``"tree"`` gathers the bodies,
    psums its near sums and takes psum(U) / P. Collision modes add their
    own: bounce the impulse ring, merge and resolve a gather on contact
    steps."""
    cfg, use_mesh_solver = _prepare(cfg, mesh, state_example, axis)
    steps = [_build_local_step(cfg, comm, use_mesh_solver) for comm in mesh.comms]

    def step(shards: list[NBodyState]) -> list[NBodyState]:
        return mesh.run(lambda comm, fn, s: fn(s), steps, shards)

    return step


def make_sharded_rollout(cfg: SimConfig, mesh: Mesh, state_example: NBodyState, steps: int,
                         record_every: int = 0, axis: Optional[str] = None,
                         _force_for: Optional[Callable] = None):
    """A multi-step sharded rollout with strided recording: ``roll(shards)
    -> (shards, Trajectory or None)``. Each rank runs its loop of steps (the
    single-device ``engine.rollout.rollout``'s, collectives inside); the
    records are the global [R, N, ...] arrays, assembled after the run (a
    collective under a process group), and the energy and angular momentum
    records are global (K and L psum'd, U from the ring). With
    ``record_every=0`` nothing is recorded and the second return is None.
    ``_force_for(comm)``, when given, makes each rank's force in place of
    the config's (the staged tree keeps its overflow this way)."""
    cfg, use_mesh_solver = _prepare(cfg, mesh, state_example, axis)
    if record_every > 0 and steps % record_every != 0:
        raise ValueError(f"steps={steps} not divisible by record_every={record_every}")
    step_fns = [_build_local_step(cfg, comm, use_mesh_solver,
                                  None if _force_for is None else _force_for(comm))
                for comm in mesh.comms]
    return _sharded_roll(mesh, steps, record_every, step_fns)


def _sharded_roll(mesh: Mesh, steps: int, record_every: int, step_fns: list):
    """``roll(shards) -> (shards, Trajectory or None)`` over each rank's
    ``step_fns`` entry (see :func:`make_sharded_rollout`)."""
    from ..engine.rollout import Trajectory
    from ..ops import diagnostics as diag

    def snapshot(comm: Comm, s: NBodyState) -> dict:
        pos, vel = s.pos_full(), s.vel_full()
        K = comm.psum(diag.kinetic_energy(vel, s.mass))
        L = comm.psum(diag.angular_momentum(pos, vel, s.mass))
        return dict(pos=pos, vel=vel, time=s.time, energy=K + s.potential, ang_mom=L,
                    alive=s.alive)

    def local_roll(comm: Comm, step_fn, s: NBodyState):
        if record_every <= 0:
            for _ in range(steps):
                s = step_fn(s)
            return s, None
        records = None
        for r in range(steps // record_every):
            for _ in range(record_every):
                s = step_fn(s)
            snap = snapshot(comm, s)
            if records is None:
                records = {k: torch.empty((steps // record_every,) + tuple(v.shape),
                                          dtype=v.dtype, device=v.device)
                           for k, v in snap.items()}
            for k, v in snap.items():
                records[k][r] = v
        if not mesh.local:  # the body records of every rank, along dim 1
            for k in ("pos", "vel", "alive"):
                records[k] = comm.all_gather(records[k].transpose(0, 1)).transpose(0, 1)
        return s, records

    def roll(shards: list[NBodyState]):
        out = mesh.run(local_roll, step_fns, shards)
        finals = [s for s, _ in out]
        if record_every <= 0:
            return finals, None
        recs = [r for _, r in out]
        traj = dict(recs[0])
        if mesh.local:
            for k in ("pos", "vel", "alive"):
                traj[k] = torch.cat([r[k] for r in recs], dim=1)
        return finals, Trajectory(**traj)

    return roll


def make_sharded_respa_rollout(cfg: SimConfig, mesh: Mesh, state_example: NBodyState,
                               steps: int, record_every: int = 0,
                               axis: Optional[str] = None):
    """The multirate (RESPA) rollout over a body-sharded mesh: ``roll(shards)
    -> (shards, Trajectory or None, diag)``, ``diag`` the window-max
    counters as ``engine.multirate.respa_rollout`` returns them.

    Each rank gathers the whole state once and runs the macro windows on
    it replicated (``make_respa_macro(shard=comm)``): the neighbour
    geometry, pack and unpack and the elementwise substeps on every rank;
    each substep's near sweep on the rank's 1/P of the i chunks (the
    sweep's ``i0``: ``near_acc_slots_rows_cuda`` on CUDA tensors) and one
    all-gather of the slot rows; the closing exact evaluation on the rank's
    shard over the ring (:func:`ring_force_fn`, B3 rounds) and one
    all-gather of the acc rows. The records are the replicated state's
    snapshots. With collisions, the detecting closing evaluation and the
    collision step run replicated on the whole state, as in the JAX
    package. ``respa_max_chunks`` must divide across the ranks and the
    worklist be off (``respa_wl_entries`` = 0): ``simulate(mesh=)`` sizes
    them so."""
    from ..engine.multirate import _DIAG_KEYS, make_respa_macro
    from ..engine.rollout import Trajectory, _snapshot, resolve_force_detect_fn

    axis = axis or cfg.shard_axis or "body"
    cfg = cfg.replace(shard_axis=axis)
    P, n, K = mesh.shape[axis], state_example.n_bodies, int(cfg.respa_k)
    if n % P:
        raise ValueError(f"N={n} must divide across {P} shards (pad via "
                         f"make_state(pad_to=...))")
    if steps % K:
        raise ValueError(f"steps={steps} must divide by respa_k={K}")
    if record_every > 0 and (record_every % K or steps % record_every):
        raise ValueError(f"record_every={record_every} must be a multiple of respa_k={K} "
                         f"and divide steps={steps}")
    block = n // P
    ring_cfg = cfg.replace(force_impl="ring")
    _ring_block_impl(ring_cfg, block, state_example.pos)

    def build(comm: Comm):
        ring = ring_force_fn(ring_cfg, comm)
        rows = slice(comm.rank * block, (comm.rank + 1) * block)

        def force_full(pos, mass, alive):
            acc_l, U = ring(pos[rows], mass[rows], alive[rows])
            return comm.all_gather(acc_l), U
        fd = (resolve_force_detect_fn(cfg, n, mesh.device, state_example.dtype)
              if cfg.collisions != "none" else None)
        return make_respa_macro(cfg, force_full, force_detect_fn=fd, shard=comm)

    macros = [build(comm) for comm in mesh.comms]
    M, n_macros = int(cfg.respa_refresh), steps // K
    per_record = record_every // K if record_every > 0 else 0

    def local_roll(comm: Comm, macro, s_local: NBodyState):
        s = _gather_state_full(comm, s_local)
        diag = {k: torch.zeros((), dtype=torch.int32, device=s.device) for k in _DIAG_KEYS}
        geom = macro.build_geom(s)
        records = None
        for i in range(n_macros):
            if i % M == 0 and i > 0:
                geom = macro.build_geom(s)
            s, d = macro(s, geom)
            diag = {k: torch.maximum(diag[k], d[k]) for k in diag}
            if per_record and (i + 1) % per_record == 0:
                snap = _snapshot(s)
                if records is None:
                    records = {k: torch.empty((steps // record_every,) + tuple(v.shape),
                                              dtype=v.dtype, device=v.device)
                               for k, v in snap.items()}
                for k, v in snap.items():
                    records[k][(i + 1) // per_record - 1] = v
        return _slice_state_local(comm, s, block), records, diag

    def roll(shards: list[NBodyState]):
        out = mesh.run(local_roll, macros, shards)
        traj = Trajectory(**out[0][1]) if per_record else None
        return [o[0] for o in out], traj, out[0][2]

    return roll


def shard_ensemble(mesh: Mesh, states: NBodyState, ensemble_axis: str = "ensemble",
                   body_axis: str = "body") -> list[NBodyState]:
    """A batched state (every field with a leading member axis, as
    ``parallel.ensemble`` makes them) cut for an (ensemble x body) mesh: each
    of this process's ranks, in ``mesh.ranks`` order, gets its block of
    members and, of those, its block of bodies (the per-member scalars by
    member block only)."""
    E, n = states.pos.shape[0], states.pos.shape[1]
    n_e, n_b = mesh.shape[ensemble_axis], mesh.shape[body_axis]
    if E % n_e or n % n_b:
        raise ValueError(f"{E} members x {n} bodies must divide across the mesh's "
                         f"{n_e} x {n_b} ranks")
    ke, kb = mesh.axis_names.index(ensemble_axis), mesh.axis_names.index(body_axis)
    states = _to(states, mesh.device)
    out = []
    for coords in mesh.ranks:
        m = slice(coords[ke] * (E // n_e), (coords[ke] + 1) * (E // n_e))
        b = slice(coords[kb] * (n // n_b), (coords[kb] + 1) * (n // n_b))
        out.append(NBodyState(**{
            f.name: None if getattr(states, f.name) is None
            else getattr(states, f.name)[m, b] if f.name in _BODY_FIELDS
            else getattr(states, f.name)[m] for f in dataclasses.fields(NBodyState)}))
    return out


def gather_ensemble(mesh: Mesh, shards: list[NBodyState], ensemble_axis: str = "ensemble",
                    body_axis: str = "body") -> NBodyState:
    """The batched state of an (ensemble x body) mesh's shards: on one-card
    ranks from the list; under a process group a collective (each member
    block gathered over its body line, then the blocks over the ensemble
    line)."""
    ke, kb = mesh.axis_names.index(ensemble_axis), mesh.axis_names.index(body_axis)

    def field(f: str, parts) -> torch.Tensor:
        return torch.cat(parts, dim=1 if f in _BODY_FIELDS else 0)

    names = [f.name for f in dataclasses.fields(NBodyState)]
    if not mesh.local:
        s = shards[0]
        b_comm, e_comm = mesh.axis_comms(body_axis)[0], mesh.axis_comms(ensemble_axis)[0]
        out = {}
        for f in names:
            v = getattr(s, f)
            if v is None:
                out[f] = None
                continue
            if f in _BODY_FIELDS:  # bodies along dim 1: gather them on dim 0
                v = b_comm.all_gather(v.transpose(0, 1).contiguous()).transpose(0, 1)
            out[f] = e_comm.all_gather(v.contiguous())
        return NBodyState(**out)
    n_e, n_b = mesh.shape[ensemble_axis], mesh.shape[body_axis]
    grid = {(c[ke], c[kb]): sh for c, sh in zip(mesh.ranks, shards)}
    rows = [NBodyState(**{f: None if getattr(grid[(e, 0)], f) is None else
                          (field(f, [getattr(grid[(e, b)], f) for b in range(n_b)])
                           if f in _BODY_FIELDS else getattr(grid[(e, 0)], f))
                          for f in names}) for e in range(n_e)]
    return NBodyState(**{f: None if getattr(rows[0], f) is None else
                         torch.cat([getattr(r, f) for r in rows], dim=0) for f in names})


def make_sharded_ensemble_step(cfg: SimConfig, mesh: Mesh, state_example: NBodyState,
                               ensemble_axis: str = "ensemble", body_axis: str = "body"):
    """The step of an ensemble over an (ensemble x body) mesh: returns
    ``(step, place)``, ``place(states)`` cutting a batched state (leading
    member axis on every field) into the ranks' shards
    (:func:`shard_ensemble`) and ``step(shards) -> shards``;
    :func:`gather_ensemble` assembles the batched state.

    Each rank holds a block of members x a block of bodies and steps its
    members one after another (the JAX package ``vmap``s them): each
    member's step is the body-sharded step over the rank's ``body_axis``
    line (the ring, or a mesh solver), so the members stay independent.
    As under the JAX package's ``vmap``, which turns the contact gate into
    a select, collisions run every step without a gate: bounce's impulse
    ring, and merge or resolve on the member's gathered bodies (their lo
    words reset every step); each member's resolve draws follow its own
    step counter."""
    cfg, use_mesh_solver = _normalize_sharded_cfg(cfg, body_axis)
    n_b = mesh.shape[body_axis]
    n = state_example.pos.shape[-2]
    if n % n_b:
        raise ValueError(f"N={n} must divide across {n_b} shards")
    if cfg.integrator == "hermite":
        raise NotImplementedError(HERMITE_REFUSAL)
    if cfg.integrator == "respa":
        raise ValueError("integrator='respa' has no (ensemble x body) mesh step")
    block = n // n_b
    if not use_mesh_solver:
        _ring_block_impl(cfg, block, state_example.pos)

    def build(comm: Comm):
        force = _mesh_force_fn(cfg, comm) if use_mesh_solver else ring_force_fn(cfg, comm)
        kdk = make_step_fn(cfg.replace(collisions="none"), force)
        if cfg.collisions == "none":
            return kdk
        if cfg.collisions == "bounce":
            bounce = ring_bounce_fn(cfg, comm)
            return lambda s: _apply_collisions(cfg, kdk(s), None, bounce=bounce)

        def gathered(s: NBodyState) -> NBodyState:
            s = kdk(s)
            full = _apply_collisions(cfg, _gather_state_full(comm, s), None)
            return _slice_state_local(comm, full, block)
        return gathered

    steps = [build(comm) for comm in mesh.axis_comms(body_axis)]

    def local(comm: Comm, one, batch: NBodyState) -> NBodyState:
        from .ensemble import _member, _stack

        return _stack([one(_member(batch, e)) for e in range(batch.pos.shape[0])])

    def step(shards: list[NBodyState]) -> list[NBodyState]:
        return mesh.run(local, steps, shards, axis=body_axis)

    def place(states: NBodyState) -> list[NBodyState]:
        return shard_ensemble(mesh, states, ensemble_axis, body_axis)

    return step, place
