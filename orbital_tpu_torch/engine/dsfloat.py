"""Double-single ("ds") compensated float32 arithmetic.

The state accumulators of a long leapfrog run are kept as an unevaluated
sum of two float32s ``hi + lo`` (~49 bits of effective mantissa) while the
per-step increments (forces) stay plain f32:

    pos_new(hi, lo) = two_sum(pos_hi, dv) + pos_lo   (renormalized)

The error-free transformations below (Knuth two-sum, Dekker fast-two-sum)
need IEEE round-to-nearest with no reassociation and no fused multiply-add
contraction. PyTorch's eager CPU and CUDA elementwise kernels evaluate each
operation separately and rounded, so these helpers are exact as written;
the CUDA fused-rollout kernel keeps the same property with explicitly
rounded intrinsics (``csrc/fused_rollout.cu``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["two_sum", "fast_two_sum", "ds_add", "ds_add_ds", "ds_to_f32", "ds_from_f64"]


def two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a + b = s + err, assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def ds_add(hi, lo, x):
    """Add a plain float ``x`` to the double-single value (hi, lo).

    Returns a renormalized (hi, lo) pair: state += increment with
    O(eps^2) accumulated error.
    """
    s, e = two_sum(hi, x)
    e = e + lo
    return fast_two_sum(s, e)


def ds_add_ds(a_hi, a_lo, b_hi, b_lo):
    """Add two double-single values (renormalized)."""
    s, e = two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    return fast_two_sum(s, e)


def ds_to_f32(hi, lo):
    """Collapse to the nearest single float (hi already is, by invariant)."""
    return hi + lo


def ds_from_f64(x64):
    """Split a float64 array or tensor into a double-single float32 pair."""
    if isinstance(x64, torch.Tensor):
        hi = x64.to(torch.float32)
        lo = (x64 - hi.to(x64.dtype)).to(torch.float32)
        return hi, lo
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo
