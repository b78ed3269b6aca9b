"""On-device conservation diagnostics.

Total energy is the kinetic sum plus the softened potential cached by the
last force evaluation; angular momentum is sum_i r_i x (m_i v_i). Each is a
reduction on the tensors' own device, so the host only sees scalars when it
asks for them.
"""
from __future__ import annotations

import torch

__all__ = ["kinetic_energy", "total_energy", "angular_momentum", "momentum", "barycenter"]


def kinetic_energy(vel: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """K = sum_i 1/2 m_i |v_i|^2 (spin KE excluded, as in the reference)."""
    return 0.5 * torch.sum(mass * torch.sum(vel * vel, dim=-1), dim=-1)


def total_energy(vel: torch.Tensor, mass: torch.Tensor,
                 potential: torch.Tensor) -> torch.Tensor:
    """K + U with U from the most recent force evaluation."""
    return kinetic_energy(vel, mass) + potential


def angular_momentum(pos: torch.Tensor, vel: torch.Tensor,
                     mass: torch.Tensor) -> torch.Tensor:
    """L = sum_i r_i x m_i v_i, shape [..., 3]."""
    return torch.sum(torch.linalg.cross(pos, mass[..., None] * vel), dim=-2)


def momentum(vel: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Total linear momentum [..., 3]."""
    return torch.sum(mass[..., None] * vel, dim=-2)


def barycenter(pos: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Mass-weighted center [..., 3]."""
    total = torch.sum(mass, dim=-1, keepdim=True)
    return torch.sum(mass[..., None] * pos, dim=-2) / torch.where(
        total > 0, total, torch.ones_like(total))
