"""Bilinear (binomial) smoothing filter for J and rho.

The counterpart of ``warpx_tpu.solvers.filter.bilinear_filter`` (reference:
Source/Filter/BilinearFilter.cpp: each pass convolves [1/4, 1/2, 1/4] along
one dimension; ``warpx.use_filter`` with ``warpx.filter_npass_each_dir``
passes per dimension, applied to the deposited current before the field
solve, WarpXComm.cpp:1357 ApplyFilterJ), and of its guard-padded form
``bilinear_filter_padded``; and the Godfrey NCI corrector's 5-point z
stencil (``nci_godfrey_stencil``, ``apply_z_stencil``; NCIGodfreyFilter.cpp,
the published tables in ``nci_tables.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["bilinear_filter", "bilinear_filter_padded",
           "nci_godfrey_stencil", "apply_z_stencil"]


def bilinear_filter(arr: torch.Tensor,
                    npass_each_dir: Sequence[int]) -> torch.Tensor:
    """Periodic binomial filter, ``npass_each_dir[d]`` passes along axis d."""
    out = arr
    for axis, npass in enumerate(npass_each_dir):
        for _ in range(npass):
            out = 0.5 * out + 0.25 * (torch.roll(out, 1, axis)
                                      + torch.roll(out, -1, axis))
    return out


def bilinear_filter_padded(arr: torch.Tensor,
                           npass_each_dir: Sequence[int]) -> torch.Tensor:
    """Binomial filter on a guard-padded block whose guards are filled: each
    pass leaves one more outermost layer per side invalid (set to zero), so
    the caller keeps the guards at least ``npass`` wide."""
    out = arr
    for axis, npass in enumerate(npass_each_dir):
        n = out.shape[axis]
        for _ in range(npass):
            new = torch.zeros_like(out)
            new.narrow(axis, 1, n - 2).copy_(
                0.5 * out.narrow(axis, 1, n - 2)
                + 0.25 * (out.narrow(axis, 0, n - 2)
                          + out.narrow(axis, 2, n - 2)))
            out = new
    return out


def nci_godfrey_stencil(cdtodz: float, coeff_set: str, nodal_gather: bool):
    """The 5-point symmetric z stencil of the Godfrey NCI corrector
    (NCIGodfreyFilter.cpp:48-120): the table row of index int(101 c dt/dz)
    with the reference's own residual weight, its prestencil expanded to
    the symmetric stencil's coefficients, the center one halved (DoFilter
    counts it twice).  ``coeff_set``: "ExEyBz" | "BxByEz"; the momentum
    tables for a nodal gather, the Galerkin ones otherwise.  float64 numpy
    on the host."""
    import numpy as np

    from . import nci_tables as tab

    tab_length = 101
    index = max(0, min(int(tab_length * cdtodz), tab_length - 2))
    weight_right = cdtodz - index / tab_length
    if nodal_gather:
        table = (tab.MOMENTUM_EX_EY_BZ if coeff_set == "ExEyBz"
                 else tab.MOMENTUM_BX_BY_EZ)
    else:
        table = (tab.GALERKIN_EX_EY_BZ if coeff_set == "ExEyBz"
                 else tab.GALERKIN_BX_BY_EZ)
    p = (1.0 - weight_right) * table[index] + weight_right * table[index + 1]
    s = np.empty(5)
    s[0] = (256 + 128 * p[0] + 96 * p[1] + 80 * p[2] + 70 * p[3]) / 256
    s[1] = -(64 * p[0] + 64 * p[1] + 60 * p[2] + 56 * p[3]) / 256
    s[2] = (16 * p[1] + 24 * p[2] + 28 * p[3]) / 256
    s[3] = -(4 * p[2] + 8 * p[3]) / 256
    s[4] = p[3] / 256
    s[0] /= 2.0
    return s


def apply_z_stencil(arr: torch.Tensor, stencil, axis: int) -> torch.Tensor:
    """The symmetric stencil along ``axis``: sum_k s_k (roll(+k) + roll(-k))
    with s_0 pre-halved.  On a guard-padded block the rolls wrap into the
    guards, whose outermost layers the caller never reads."""
    out = torch.zeros_like(arr)
    for k, s in enumerate(stencil):
        out = out + float(s) * (torch.roll(arr, k, axis)
                                + torch.roll(arr, -k, axis))
    return out
