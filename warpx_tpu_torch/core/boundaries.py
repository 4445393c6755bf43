"""Field boundary conditions on guard-padded blocks.

The counterpart of ``warpx_tpu.core.boundaries`` on tensors.

Reimplements the reference's PEC rules (Source/BoundaryConditions/
WarpX_PEC.cpp):

* E: tangential components vanish on the wall node and are mirrored with a
  sign flip into the guards; normal components mirror symmetrically
  (SetEfieldOnPEC:118-190).
* B: normal components vanish on the wall node; tangential mirror
  symmetrically (SetBfieldOnPEC:257-340).

Array layout: like AMReX nodal MultiFabs, a component NODAL in a bounded
dimension stores n+1 valid values (both wall nodes); a staggered component
stores n.  Padded arrays carry ``ng`` guards per side, so the valid region is
[ng, ng+nv) with nv = n+1 (nodal) or n (staggered).  Mirror maps
(get_cell_count_to_boundary, WarpX_PEC.cpp:41-48):

  nodal   lo: wall node at ng;     guard ng-k     <- sign * ng+k
  stag.   lo:                      guard ng-k     <- sign * ng+k-1
  nodal   hi: wall node at ng+n;   guard ng+n+k   <- sign * ng+n-k
  stag.   hi:                      guard ng+n-1+k <- sign * ng+n-k
"""

from __future__ import annotations

import torch

__all__ = ["fill_guards_pec", "is_tangential"]


def is_tangential(comp_axis: int, boundary_axis_xyz: int) -> bool:
    """Whether vector component (0=x,1=y,2=z) is tangential to the boundary
    normal to xyz-axis ``boundary_axis_xyz`` (WarpX_PEC.cpp:143-151)."""
    return comp_axis != boundary_axis_xyz


def _take(P, d, idx):
    sl = [slice(None)] * P.ndim
    sl[d] = idx
    return P[tuple(sl)]


def _setslice(P, d, idx, value):
    sl = [slice(None)] * P.ndim
    sl[d] = idx
    P[tuple(sl)] = value


def fill_guards_pec(
    P: torch.Tensor,
    d: int,
    ng: int,
    n: int,
    nodal: bool,
    tangential: bool,
    side: str,
    zero_wall: bool,
) -> torch.Tensor:
    """Fill guard layers of padded array P along dim d for one PEC face.

    ``n`` is the CELL count of the domain in dim d (the nodal valid extent is
    n+1).  zero_wall: tangential-nodal E and normal-nodal B wall nodes are
    forced to 0.  Returns a new tensor; ``P`` is left as it was.
    """
    P = P.clone()
    sign = -1.0 if tangential else 1.0
    if side == "lo":
        if nodal:
            if zero_wall:
                _setslice(P, d, ng, 0.0)
            for k in range(1, ng + 1):
                _setslice(P, d, ng - k, sign * _take(P, d, ng + k))
        else:
            for k in range(1, ng + 1):
                _setslice(P, d, ng - k, sign * _take(P, d, ng + k - 1))
    else:
        if nodal:
            if zero_wall:
                _setslice(P, d, ng + n, 0.0)
            for k in range(1, ng + 1):
                if ng + n + k < P.shape[d]:
                    _setslice(P, d, ng + n + k, sign * _take(P, d, ng + n - k))
        else:
            for k in range(1, ng + 1):
                if ng + n - 1 + k < P.shape[d]:
                    _setslice(
                        P, d, ng + n - 1 + k, sign * _take(P, d, ng + n - k)
                    )
    return P
