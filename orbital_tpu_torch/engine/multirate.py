"""Multirate (RESPA) leapfrog: the far force held between exact evaluations,
the switched near force every substep.

The exact O(N^2) sweep is dominated by the far field, which at the
benchmark's step changes far more slowly than the close encounters that set
the step. The impulse multiple-time-step splitting (r-RESPA, Tuckerman,
Berne & Martyna 1992) integrates the two on different clocks:

    V_far(K dt / 2) . [V_near(dt/2) D(dt) V_near(dt/2)]^K . V_far(K dt / 2)

``V_near`` is the smooth switched short-range force of ``ops/neighbor.py``;
``V_far = V_total - V_near`` needs one exact force evaluation per K substeps,
applied as impulses at the macro boundaries and held in between, which keeps
the composition symplectic.

Per macro window (K substeps):
  1. freeze the neighbor geometry at the sync positions (the skin covers all
     motion inside the window; violations are counted);
  2. pack the state into chunk-slot space once; the inner loop is
     elementwise f32/ds32 arithmetic plus the near sweep (the CUDA kernel of
     ``ops/cuda_neighbor.py`` for CUDA tensors);
  3. close with one exact force evaluation at the end positions: ``a_far =
     a_total - a_near`` at identical positions, so ``state.acc`` keeps its
     plain-KDK meaning.

Bodies dropped by the (probed, counted) budgets move ballistically on the
held total acceleration for that window. Collisions (bounce, merge,
resolve) are detected and resolved at macro boundaries, riding the closing
exact evaluation, with the geometry rebuilt every window (the config
refuses ``respa_refresh`` > 1 with collisions). A dead body has no slot and
is counted in ``overflow``; a debris fragment that resolve revives into a
dead slot at a window's close gets its slot at the next window's build, and
its first far kick takes the acceleration cached for the dead slot, as in
the JAX stepper.

This is the port of ``orbital_tpu/engine/multirate.py`` on one device: the
JAX ``lax.scan`` loops are Python loops of eager steps that read nothing back
to the host (the diagnostics stay 0-dim int32 tensors on the device), and
the geometry refresh test is a Python int. Not ported: the mesh variant
(``shard=``, and the sweep's ``i0`` hook), ROADMAP.md queue A item A.15.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.neighbor import SENTINEL_POS, near_acc_slots, neighbor_geometry, pack_rows, unpack_rows
from ..utils.config import SimConfig
from .dsfloat import ds_add
from .integrators import _apply_collisions
from .rollout import Trajectory, _snapshot, resolve_force_detect_fn, resolve_force_fn
from .state import NBodyState

__all__ = ["make_respa_macro", "respa_rollout", "respa_rollout_dyn"]

# the ROADMAP.md queue A item that ports what this module leaves out
_SHARD_ITEM = "A.15"

_DIAG_KEYS = ("overflow", "cap_overflow", "w_overflow", "q_overflow", "skin_violation")


def _fills_pos(dtype, device):
    """Fill row of packed (x, y, z, m) tables: sentinel positions, zero mass,
    so that padding slots are force-inert by value."""
    return torch.tensor([SENTINEL_POS] * 3 + [0.0], dtype=dtype, device=device)


def _resolve_sweep(cfg: SimConfig, dtype: torch.dtype, device: torch.device | str):
    """``sweep(xs, ys, zs, ms, geom) -> (acc, pe)`` over the slot channels.

    CUDA tensors take the kernel for every ``respa_impl`` but ``"xla"``,
    which names the plain sweep; ``"auto"`` and ``"pallas"`` use the
    worklist when ``cfg.respa_wl_entries > 0``, as the JAX package does. CPU
    tensors take the plain sweep under ``"auto"`` and ``"xla"`` and the
    wrappers' plain versions otherwise. The kernel is float32: f64 state on
    CUDA raises, and on the CPU f64 always takes the plain sweep."""
    device = torch.device(device)
    impl = cfg.respa_impl
    if device.type == "cuda" and dtype == torch.float64:
        raise NotImplementedError(
            "precision='f64' on CUDA: the CUDA kernels compute in float32; "
            "use ds32 on the card and f64 on the CPU")
    if impl == "auto":
        impl = "pallas" if device.type == "cuda" else "xla"
    if dtype != torch.float32:
        impl = "xla"
    kw = dict(r1=cfg.respa_r1 if cfg.respa_r1 > 0 else 0.5 * cfg.respa_rc,
              rc=cfg.respa_rc, G=cfg.G, eps2=cfg.eps2,
              chunk=cfg.respa_chunk, rj=cfg.respa_rj)
    if impl == "xla":
        return lambda xs, ys, zs, ms, geom: near_acc_slots(xs, ys, zs, ms, geom["jbl"], **kw)
    from ..ops import cuda_neighbor as cn

    if impl in ("pallas", "pallas_interpret") and cfg.respa_wl_entries > 0:
        return lambda xs, ys, zs, ms, geom: cn.near_acc_slots_cuda_wl(
            xs, ys, zs, ms, geom["wl_i"], geom["wl_jb"], **kw)
    f = cn.near_acc_slots_cuda_sb if impl == "pallas_sb" else cn.near_acc_slots_cuda
    return lambda xs, ys, zs, ms, geom: f(xs, ys, zs, ms, geom["jbl"], **kw)


def make_respa_macro(
    cfg: SimConfig,
    force_fn: Callable,
    force_detect_fn: Optional[Callable] = None,
    shard: Optional[tuple[str, int]] = None,
) -> Callable[..., tuple[NBodyState, dict]]:
    """Build the macro step ``macro(state, geom=None) -> (state', diag)``
    advancing ``cfg.respa_k`` substeps of ``cfg.dt``, with
    ``macro.build_geom(state)`` to freeze a geometry that may serve
    ``cfg.respa_refresh`` consecutive windows. ``diag`` holds 0-dim int32
    tensors: ``overflow`` (dropped bodies and blocks, with the split
    ``cap_overflow`` / ``w_overflow`` / ``q_overflow``) and
    ``skin_violation`` (1 if a body moved further than the skin covers).
    ``state.step`` advances by K; ``state.acc`` and ``potential`` stay the
    exact total-force caches.

    ``force_detect_fn(pos, mass, radius, alive) -> (acc, U, contacts)``
    makes the closing evaluation count contacts and gates the collision
    step on the count, as the exact-force steppers do."""
    if shard is not None:
        raise NotImplementedError(
            "make_respa_macro(shard=...): the mesh-sharded multirate stepper is not "
            f"ported to orbital_tpu_torch yet (ROADMAP.md queue A item {_SHARD_ITEM})")
    K = int(cfg.respa_k)
    dt = cfg.dt
    delta = K * dt
    C, RJ = cfg.respa_chunk, cfg.respa_rj
    K_ch, W_blk = cfg.respa_max_chunks, cfg.respa_w_blk
    n_slots = (K_ch + RJ) * C
    valid_below = K_ch * C
    skin_half = 0.5 * (cfg.respa_cell - cfg.respa_rc)
    if skin_half <= 0:
        raise ValueError("respa_cell must exceed respa_rc (skin > 0)")
    if cfg.eps2 <= 0:
        raise ValueError("integrator='respa' requires softening > 0 "
                         "(self-pairs vanish through the softened rsqrt)")
    fuse_detect = force_detect_fn is not None and cfg.collisions != "none"

    def build_geom(state: NBodyState) -> dict:
        """Neighbor geometry and the packed build positions the skin check
        measures against."""
        geom = neighbor_geometry(
            state.pos, state.alive, cell=cfg.respa_cell, m_grid=cfg.respa_m, chunk=C,
            max_chunks=K_ch, w_blk=W_blk, rj=RJ, wl_entries=cfg.respa_wl_entries)
        zcol = torch.zeros((state.n_bodies, 1), dtype=state.dtype, device=state.device)
        geom["pos0_build"] = pack_rows(geom["slot"], torch.cat([state.pos, zcol], dim=1),
                                       n_slots, _fills_pos(state.dtype, state.device))
        return geom

    def macro(state: NBodyState, geom: Optional[dict] = None) -> tuple[NBodyState, dict]:
        ds = state.pos_lo is not None
        dtype, dev = state.dtype, state.device
        sweep = _resolve_sweep(cfg, dtype, dev)
        if geom is None:
            geom = build_geom(state)
        slot = geom["slot"]
        zcol = torch.zeros((state.n_bodies, 1), dtype=dtype, device=dev)

        def pkr(v, fill):
            return pack_rows(slot, v, n_slots, fill)

        def run_sweep(P):
            acc, _ = sweep(P[:, 0], P[:, 1], P[:, 2], P[:, 3], geom)
            # rows (ax, ay, az, 0): the zero column keeps every whole-row
            # kick mass-neutral (column 3 of P is the mass); padded to the
            # slot table's length with zero rows
            return torch.nn.functional.pad(acc, (0, 1, 0, n_slots - valid_below))

        # row tables [n_slots, 4]: x y z m, and velocity, acceleration and
        # the lo words with a zero fourth column
        mass_eff = torch.where(state.alive, state.mass, 0.0)[:, None]
        P = pkr(torch.cat([state.pos, mass_eff], dim=1), _fills_pos(dtype, dev))
        V = pkr(torch.cat([state.vel, zcol], dim=1), 0.0)
        A = pkr(torch.cat([state.acc, zcol], dim=1), 0.0)
        PL = pkr(torch.cat([state.pos_lo, zcol], dim=1), 0.0) if ds else None
        VL = pkr(torch.cat([state.vel_lo, zcol], dim=1), 0.0) if ds else None

        a_n = run_sweep(P)
        # opening far half-impulse: a_far = a_total - a_near at the sync
        # positions, where state.acc is the last closing evaluation
        inc = (0.5 * delta) * (A - a_n)
        if ds:
            V, VL = ds_add(V, VL, inc)
        else:
            V = V + inc

        for _ in range(K):
            inc = (0.5 * dt) * a_n
            if ds:
                V, VL = ds_add(V, VL, inc)
                P, PL = ds_add(P, PL, dt * V)
                P, PL = ds_add(P, PL, dt * VL)
            else:
                V = V + inc
                P = P + dt * V
            a_n = run_sweep(P)
            inc = (0.5 * dt) * a_n
            if ds:
                V, VL = ds_add(V, VL, inc)
            else:
                V = V + inc

        # against the geometry's build positions: with respa_refresh > 1 the
        # frozen tables must cover all motion since the build (sentinel rows
        # and the mass column subtract to exactly 0)
        d2 = torch.sum((P - geom["pos0_build"]) ** 2, dim=1)
        skin_violation = (torch.max(d2) > skin_half * skin_half).to(torch.int32)

        # unpack; dropped bodies ride the held total force ballistically
        pos_fb = state.pos_full() + delta * state.vel_full() + (0.5 * delta * delta) * state.acc
        vel_fb = state.vel_full() + delta * state.acc
        dropped = slot >= valid_below

        def upkr(t, fb):
            return unpack_rows(slot, t, fb, valid_below)[:, :3]

        zeros4 = torch.zeros((state.n_bodies, 4), dtype=dtype, device=dev)
        pos_hi = upkr(P, torch.cat([pos_fb, zcol], dim=1))
        vel_hi = upkr(V, torch.cat([vel_fb, zcol], dim=1))
        pos_lo = upkr(PL, zeros4) if ds else None
        vel_lo = upkr(VL, zeros4) if ds else None
        a_near_end = upkr(a_n, zeros4)

        contacts = None
        if fuse_detect:
            acc_tot, potential, contacts = force_detect_fn(pos_hi, state.mass, state.radius,
                                                           state.alive)
        else:
            acc_tot, potential = force_fn(pos_hi, state.mass, state.alive)

        # closing far half-impulse (dropped rows took their whole window's
        # total impulse in the ballistic fallback)
        kick = torch.where(dropped[:, None], 0.0, (0.5 * delta) * (acc_tot - a_near_end))
        if ds:
            vel_hi, vel_lo = ds_add(vel_hi, vel_lo, kick)
        else:
            vel_hi = vel_hi + kick

        new = state.replace(pos=pos_hi, pos_lo=pos_lo, vel=vel_hi, vel_lo=vel_lo,
                            acc=acc_tot, potential=potential,
                            time=state.time + delta, step=state.step + K)
        if cfg.collisions != "none":
            new = _apply_collisions(cfg, new, contacts)
        q_overflow = geom.get("q_overflow", torch.zeros((), dtype=torch.int32, device=dev))
        diag = dict(
            overflow=(geom["cap_overflow"] + torch.sum(dropped).to(torch.int32)
                      + geom["w_overflow"] + q_overflow),
            # which budget blew: cap = chunk table, w = blocks of a chunk,
            # q = worklist entries
            cap_overflow=geom["cap_overflow"], w_overflow=geom["w_overflow"],
            q_overflow=q_overflow, skin_violation=skin_violation)
        return new, diag

    macro.build_geom = build_geom
    return macro


def respa_rollout(
    state: NBodyState,
    cfg: SimConfig,
    steps: int,
    record_every: int = 0,
    force_fn: Optional[Callable] = None,
    force_detect_fn: Optional[Callable] = None,
):
    """Advance ``steps`` substeps (a multiple of ``cfg.respa_k``) under the
    multirate stepper, recording every ``record_every``-th substep if asked
    (a multiple of K: snapshots exist at macro boundaries, where the state
    carries exact total-force caches). The geometry is rebuilt every
    ``cfg.respa_refresh`` macro windows.

    Returns ``(final, trajectory or None, diag)``, ``diag`` the window-max
    of each counter as 0-dim int32 tensors on the device, never read back
    here: a nonzero ``overflow`` or ``skin_violation`` means near pairs were
    missed (resize the budgets or the skin). ``force_fn`` and, with
    collisions on, ``force_detect_fn`` default to the exact-force routing of
    ``engine.rollout``."""
    K = int(cfg.respa_k)
    if steps % K:
        raise ValueError(f"steps={steps} must divide by respa_k={K}")
    n, dev, dtype = state.n_bodies, state.device, state.dtype
    fn = force_fn or resolve_force_fn(cfg, n, dev, dtype)
    fd = None
    if cfg.collisions != "none":
        fd = force_detect_fn or resolve_force_detect_fn(cfg, n, dev, dtype)
    macro = make_respa_macro(cfg, fn, force_detect_fn=fd)
    n_macros = steps // K
    M = int(cfg.respa_refresh)

    per_record = 0
    if record_every > 0:
        if record_every % K or steps % record_every:
            raise ValueError(f"record_every={record_every} must be a multiple of "
                             f"respa_k={K} and divide steps={steps}")
        per_record = record_every // K
        first = _snapshot(state)
        records = {k: torch.empty((steps // record_every,) + tuple(v.shape), dtype=v.dtype,
                                  device=v.device) for k, v in first.items()}

    diag = {k: torch.zeros((), dtype=torch.int32, device=dev) for k in _DIAG_KEYS}
    geom = macro.build_geom(state)
    for i in range(n_macros):
        if i % M == 0 and i > 0:
            geom = macro.build_geom(state)
        state, d = macro(state, geom)
        diag = {k: torch.maximum(diag[k], d[k]) for k in diag}
        if per_record and (i + 1) % per_record == 0:
            for k, v in _snapshot(state).items():
                records[k][(i + 1) // per_record - 1] = v
    return state, (Trajectory(**records) if per_record else None), diag


def respa_rollout_dyn(state: NBodyState, cfg: SimConfig, n_macros: int):
    """Advance ``n_macros`` macro windows without recording: ``(final,
    diag)``. The JAX package takes the count as a device value so that one
    compiled program serves every length; here it is a host int."""
    final, _, diag = respa_rollout(state, cfg, int(n_macros) * int(cfg.respa_k))
    return final, diag
