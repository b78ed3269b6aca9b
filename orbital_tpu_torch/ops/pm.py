"""Particle-mesh (PM) gravity: an FFT Poisson solve for N past the exact path.

Ported from ``orbital_tpu/ops/pm.py``; its ``axis_name`` collectives are a
``comm`` (``parallel.mesh.Comm``) here. The Hockney-Eastwood open-boundary
scheme in plain torch:

  1. cloud-in-cell (CIC) deposit of the masses onto a G^3 grid over the live
     bodies' bounding cube (or a pinned ``box``), by ``index_add_``;
  2. the potential as the convolution with the softened Green's function
     K(r) = 1/sqrt(|r|^2 + eps^2) on the zero-padded (2G)^3 cube, so the
     circular FFT convolution is the open-boundary linear one
     (``torch.fft.rfftn``/``irfftn``), with the CIC window deconvolved;
  3. acc = -grad(phi) by centered differences, CIC-gathered back to the
     bodies in one channel-stacked gather.

Body-sharded (``comm`` set, each rank holding its shard of the bodies):
the bounding cube is agreed by ``pmin``/``pmax`` (skipped under a pinned
box), each rank deposits its bodies and one ``psum`` of the G^3 grid makes
the density global; the FFT solve runs on every rank and the gather stays
local. U is ``psum``'d.

Accuracy contract (the JAX module's): pair forces are right to ~(h/r)^2
beyond a few cell spacings h and smoothed below ~h, so the effective
softening is max(eps, ~h); the potential subtracts the leading CIC
self-energy and is approximate at O(h/eps). For collisional dynamics use the
exact kernels or P3M (``ops.p3m``).

Numbers on the card: ``index_add_`` on CUDA adds with atomics in no fixed
order, so a deposit is not bit-reproducible from run to run; the FFTs are
cuFFT in float32 (no TF32 path).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["pm_acc_potential", "_bounding_cube", "_cic_weights", "_cic_corners",
           "_pm_core"]

f32 = torch.float32


def _cic_weights(uc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Trilinear (CIC) base cells and weights of cell-center coordinates
    ``uc`` [N, 3]: (i0 [N, 3] int64, fr [N, 3] in [0, 1])."""
    i0 = torch.floor(uc)
    return i0.to(torch.int64), uc - i0


def _bounding_cube(pos32: torch.Tensor, alive_f: torch.Tensor,
                   g: int, comm=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Center [3] and half-width (0-dim) of the live bodies' bounding cube,
    with a 2%-plus-one-cell margin (``g`` cells per side), in ``pos32``'s
    float type (float32 on every solver path); over every rank of ``comm``
    when given."""
    big = torch.tensor(3.4e38, dtype=pos32.dtype, device=pos32.device)
    live = (alive_f > 0)[:, None]
    lo = torch.where(live, pos32, big).amin(dim=0)
    hi = torch.where(live, pos32, -big).amax(dim=0)
    if comm is not None:
        lo, hi = comm.pmin(lo), comm.pmax(hi)
    center = 0.5 * (lo + hi)
    half = torch.clamp((0.5 * (hi - lo)).amax(), min=1e-30) * (1.02 + 2.0 / g)
    return center, half


def _cic_corners(pos32: torch.Tensor, origin: torch.Tensor, h: torch.Tensor,
                 g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flattened cell indices [8, N] (int64) and weights [8, N] of the 8 CIC
    corners, corners ordered (a, b, c) over x, y, z lowest first."""
    uc = (pos32 - origin) / h - 0.5
    uc = torch.clamp(uc, 0.0, g - 1.001)       # also tames far-parked dead
    i0, fr = _cic_weights(uc)
    i1 = torch.clamp(i0 + 1, max=g - 1)
    ws = [(1.0 - fr[:, d], fr[:, d]) for d in range(3)]
    ix = [(i0[:, d], i1[:, d]) for d in range(3)]
    corners = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    flat8 = torch.stack([(ix[0][a] * g + ix[1][b]) * g + ix[2][c] for a, b, c in corners])
    w8 = torch.stack([ws[0][a] * ws[1][b] * ws[2][c] for a, b, c in corners])
    return flat8, w8


def _sinc2(x: torch.Tensor) -> torch.Tensor:
    """(sin x / x)^2, 1 at x = 0."""
    zero = x == 0
    safe = torch.where(zero, torch.ones_like(x), x)
    return torch.where(zero, torch.ones_like(x), torch.sin(x) / safe) ** 2


def _pm_core(pos32: torch.Tensor, m_eff: torch.Tensor, alive_f: torch.Tensor, *, g: int,
             G_grav: float, kern_builder: Callable, with_potential: bool, deconvolve: bool,
             box=None, comm=None):
    """The mesh pipeline: deposit -> padded FFT convolution with the kernel
    ``kern_builder(r2_grid, h)`` -> gradient -> gather. Returns (acc [N, 3]
    alive-masked, phi_at [N] or None, h, center, half), h, center and half
    as 0-dim and [3] tensors. It computes in ``pos32``'s float type: float32
    on every solver path, as the JAX module does; float64 for a reference.

    ``box`` (center [3], half) pins the mesh instead of refitting it to the
    live extent every call: the mesh force is then a fixed smooth
    Hamiltonian, which leapfrog conserves. Bodies outside a pinned box clip
    to the boundary cells. With ``comm`` the bodies are one rank's shard:
    the cube and the density are global (see the module note)."""
    dev, ft = pos32.device, pos32.dtype
    if box is None:
        center, half = _bounding_cube(pos32, alive_f, g, comm)
    else:
        center = torch.as_tensor(box[0], dtype=ft, device=dev)
        half = torch.as_tensor(box[1], dtype=ft, device=dev)
    h = 2.0 * half / g
    origin = center - half

    flat8, w8 = _cic_corners(pos32, origin, h, g)
    rho = torch.zeros(g * g * g, dtype=ft, device=dev)
    rho.index_add_(0, flat8.reshape(-1), (w8 * m_eff[None]).reshape(-1))
    if comm is not None:
        rho = comm.psum(rho)  # the global density, one collective

    # open-boundary Green's function on the zero-padded cube: coordinate k in
    # [0, 2g) maps to the mirrored displacement ((k + g) mod 2g) - g
    p = 2 * g
    k = torch.arange(p, device=dev)
    d = torch.where(k > g, k - p, k).to(ft) * h
    r2 = d[:, None, None] ** 2 + d[None, :, None] ** 2 + d[None, None, :] ** 2
    kern_hat = torch.fft.rfftn(kern_builder(r2, h))
    if deconvolve:
        # divide by the squared CIC window of the deposit and the gather
        # (sinc^4 a axis), capped away from the Nyquist zero
        s2 = _sinc2(math.pi * torch.fft.fftfreq(p, device=dev, dtype=ft))
        s2r = _sinc2(math.pi * torch.fft.rfftfreq(p, device=dev, dtype=ft))
        W2 = (s2[:, None, None] * s2[None, :, None] * s2r[None, None, :]) ** 2
        kern_hat = kern_hat / torch.clamp(W2, min=0.05)

    rho_p = torch.zeros((p, p, p), dtype=ft, device=dev)
    rho_p[:g, :g, :g] = rho.reshape(g, g, g)
    phi = -G_grav * torch.fft.irfftn(torch.fft.rfftn(rho_p) * kern_hat, s=(p, p, p))

    # centered-difference field; the padded phi is exact one cell beyond the
    # image region, so the rolls never alias wrong data into [0, g)
    inv2h = 1.0 / (2.0 * h)

    def grad_axis(a: int) -> torch.Tensor:
        return ((torch.roll(phi, -1, a) - torch.roll(phi, 1, a)) * -inv2h)[:g, :g, :g]

    fields = [grad_axis(0), grad_axis(1), grad_axis(2)]
    if with_potential:
        fields.append(phi[:g, :g, :g])
    # one channel-stacked gather [C, 8, N]
    F = torch.stack([f.reshape(-1) for f in fields])
    out = (F[:, flat8] * w8[None]).sum(1)

    acc = out[0:3].T * alive_f[:, None]
    phi_at = out[3] if with_potential else None
    return acc, phi_at, h, center, half


def pm_acc_potential(
    pos: torch.Tensor,
    mass: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    *,
    G_grav: float,
    eps2: float,
    grid: int = 64,
    with_potential: bool = True,
    deconvolve: bool = True,
    box=None,
    comm=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """PM accelerations (and approximate potential) for all bodies: (acc
    [N, 3], U), dead bodies inert, in ``pos``'s dtype; computed in float32.

    ``box = (center [3], half)`` pins the mesh (a fixed mesh makes the
    approximate force conservative); by default the live bounding cube is
    refitted every call. ``grid`` is the mesh resolution a side (the FFT
    runs on the zero-padded (2 grid)^3 cube). Requires eps2 > 0. With
    ``comm`` (a ``parallel.mesh.Comm``) the arguments are one rank's shard
    of a body-sharded system and U is the global potential."""
    if eps2 <= 0.0:
        raise ValueError("the PM solver requires eps2 > 0")
    n, g, dev = pos.shape[0], int(grid), pos.device
    pos32 = pos.to(f32)
    alive_f = torch.ones((n,), dtype=f32, device=dev) if alive is None else alive.to(f32)
    m_eff = mass.to(f32) * alive_f

    def kern(r2_grid, h):
        return torch.rsqrt(r2_grid + eps2)

    acc, phi_at, _, _, _ = _pm_core(pos32, m_eff, alive_f, g=g, G_grav=G_grav,
                                    kern_builder=kern, with_potential=with_potential,
                                    deconvolve=deconvolve, box=box, comm=comm)
    if with_potential:
        # the leading CIC self-interaction (each body sees its own smoothed
        # cloud): -G m K(0) = -G m / eps
        self_phi = -G_grav * m_eff * (1.0 / float(eps2) ** 0.5)
        U = 0.5 * torch.sum(m_eff * (phi_at - self_phi))
        if comm is not None:
            U = comm.psum(U)
    else:
        U = torch.zeros((), dtype=f32, device=dev)
    return acc.to(pos.dtype), U.to(pos.dtype)
