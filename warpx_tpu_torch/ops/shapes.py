"""Particle shape factors (centered B-spline weights), orders 0-4.

The counterpart of ``warpx_tpu.ops.shapes`` (reference: ShapeFactors.H:27-155):
the weight of grid point ``i`` for a particle at grid coordinate ``x`` is
``S_n(x - i)`` with S_n the order-n centered B-spline.  Indices use floor
semantics.
"""

from __future__ import annotations

import torch

__all__ = ["start_index", "spline", "shape_weights", "esirkepov_weights"]


def start_index(x: torch.Tensor, order: int) -> torch.Tensor:
    """Leftmost grid index touched by an order-``order`` shape at x
    (ShapeFactors.H:36-77): order 0: floor(x+1/2); 1: floor(x);
    2: floor(x+1/2)-1; 3: floor(x)-1; 4: floor(x+1/2)-2."""
    base = torch.floor(x + 0.5) if order % 2 == 0 else torch.floor(x)
    return base.to(torch.int32) - order // 2


def spline(xi: torch.Tensor, order: int) -> torch.Tensor:
    """Centered B-spline S_order at signed distance ``xi``; 0 outside the
    support."""
    t = torch.abs(xi)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    if order == 0:
        return torch.where(t <= 0.5, 1.0 + zero, zero)
    if order == 1:
        return torch.where(t < 1.0, 1.0 - t, zero)
    if order == 2:
        inner = 0.75 - t * t
        outer = 0.5 * (1.5 - t) ** 2
        return torch.where(t <= 0.5, inner, torch.where(t < 1.5, outer, zero))
    if order == 3:
        inner = 2.0 / 3.0 - t * t * (1.0 - 0.5 * t)
        # a tensor divisor: PyTorch's CUDA kernels multiply by the rounded
        # reciprocal of a Python-number divisor, which is not the correctly
        # rounded quotient the CPU and the fused kernels compute
        outer = (2.0 - t) ** 3 / (zero + 6.0)
        return torch.where(t <= 1.0, inner, torch.where(t < 2.0, outer, zero))
    if order == 4:
        t2 = t * t
        inner = (115.0 / 192.0) + t2 * (-0.625 + 0.25 * t2)
        mid = (55.0 + 20.0 * t - 120.0 * t2 + 80.0 * t2 * t
               - 16.0 * t2 * t2) / (zero + 96.0)
        outer = (2.5 - t) ** 4 / (zero + 24.0)
        return torch.where(t <= 0.5, inner, torch.where(
            t <= 1.5, mid, torch.where(t < 2.5, outer, zero)))
    raise ValueError(f"Unsupported shape order {order}")


def shape_weights(x: torch.Tensor, order: int):
    """(start_index, [w_0..w_order]); weight m belongs to grid point
    start+m."""
    i0 = start_index(x, order)
    ws = [spline(x - (i0.to(x.dtype) + m), order) for m in range(order + 1)]
    return i0, ws


def esirkepov_weights(x_new: torch.Tensor, x_old: torch.Tensor, order: int):
    """Shape weights of x_new and x_old on the common (order+3)-point window
    starting at ``start_index(x_new, order) - 1`` (CurrentDeposition.H:
    754-771).  Returns (i0, s_new list, s_old list)."""
    i0 = start_index(x_new, order) - 1
    base = i0.to(x_new.dtype)
    s_new = [spline(x_new - (base + m), order) for m in range(order + 3)]
    s_old = [spline(x_old - (base + m), order) for m in range(order + 3)]
    return i0, s_new, s_old
