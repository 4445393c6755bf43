"""Field gather: staggered grid -> particle positions, shape orders 1-3.

The counterpart of ``warpx_tpu.ops.gather`` (reference: doGatherShapeN,
Source/Particles/Gather/FieldGather.H:38).  With ``galerkin`` (the
energy-conserving default) the shape order drops by one along an E
component's own axis and along a B component's two transverse axes
(FieldGather.H:73-199).

Two index modes:

* ``wrap=True``: the periodic torus; taps wrap with modular indexing, the
  analog of guard cells filled by a periodic FillBoundary;
* ``wrap=False``: arrays padded with ``offset`` guard cells per side whose
  index 0 sits at ``origin``; a tap is read at ``start + tap + offset``.
  Taps past the array are read at its edge: only a dead slot, which the
  moving window left behind and whose result nothing uses, reaches there.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

from .shapes import shape_weights

__all__ = ["interp_to_points", "gather_eb", "GALERKIN_AXES"]

# which (x, y, z) axes get the reduced-order shape, per component
GALERKIN_AXES = {
    "Ex": ("x",),
    "Ey": ("y",),
    "Ez": ("z",),
    "Bx": ("y", "z"),
    "By": ("x", "z"),
    "Bz": ("x", "y"),
}


def interp_to_points(
    field: torch.Tensor,
    grid_coords: Sequence[torch.Tensor],
    dim_orders: Sequence[int],
    dim_staggered: Sequence[bool],
    n_cell: Sequence[int],
    wrap: bool = True,
    offset: int = 0,
) -> torch.Tensor:
    """Interpolate ``field`` to particle grid coordinates.

    ``grid_coords[d]`` is the particle coordinate in grid units (0 at the
    array origin, guards excluded); ``dim_staggered[d]`` means the component
    lives at half-integer positions along d, so shapes are evaluated at
    coord - 1/2.
    """
    ndim = len(grid_coords)
    starts, weights = [], []
    for d in range(ndim):
        xd = grid_coords[d] - 0.5 if dim_staggered[d] else grid_coords[d]
        i0, ws = shape_weights(xd, dim_orders[d])
        starts.append(i0.long() + offset)
        weights.append(ws)
    flat = field.reshape(-1)
    shape = field.shape

    def index(d, tap):
        if wrap:
            return torch.remainder(starts[d] + tap, n_cell[d])
        return torch.clamp(starts[d] + tap, 0, shape[d] - 1)

    out = torch.zeros_like(grid_coords[0])
    for taps in itertools.product(*[range(o + 1) for o in dim_orders]):
        w = weights[0][taps[0]]
        for d in range(1, ndim):
            w = w * weights[d][taps[d]]
        lin = index(0, taps[0])
        for d in range(1, ndim):
            lin = lin * shape[d] + index(d, taps[d])
        out = out + w * flat[lin]
    return out


def gather_eb(
    positions: Sequence[torch.Tensor],
    field_arrays: dict,
    staggering: dict,
    geom,
    order: int,
    galerkin: bool = True,
    origin: Sequence | None = None,
    wrap: bool = True,
    offset: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Gather (Ex, Ey, Ez, Bx, By, Bz) at absolute particle ``positions``
    from the name -> grid array dict ``field_arrays`` (padded with ``offset``
    guards per side when ``wrap`` is False); ``origin`` is the coordinate of
    index 0 (default: the domain's lower corner)."""
    dx = geom.dx
    lo = geom.prob_lo if origin is None else origin
    coords = [
        (positions[d] - lo[d]) * (1.0 / dx[d]) for d in range(geom.ndim)
    ]
    results = []
    for comp in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        flags = staggering[comp]
        dim_orders, dim_staggered = [], []
        for d, ax in enumerate(geom.axis_names):
            reduced = galerkin and (ax in GALERKIN_AXES[comp])
            dim_orders.append(order - 1 if reduced else order)
            dim_staggered.append(flags[d] == 0)
        results.append(
            interp_to_points(field_arrays[comp], coords, dim_orders,
                             dim_staggered, geom.n_cell, wrap=wrap,
                             offset=offset)
        )
    return tuple(results)
