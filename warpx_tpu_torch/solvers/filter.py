"""Bilinear (binomial) smoothing filter for J and rho.

The counterpart of ``warpx_tpu.solvers.filter.bilinear_filter`` (reference:
Source/Filter/BilinearFilter.cpp: each pass convolves [1/4, 1/2, 1/4] along
one dimension; ``warpx.use_filter`` with ``warpx.filter_npass_each_dir``
passes per dimension, applied to the deposited current before the field
solve, WarpXComm.cpp:1357 ApplyFilterJ), and of its guard-padded form
``bilinear_filter_padded``.  The Godfrey NCI stencil is not ported
(``nci_tables.py``, ROADMAP.md Queue A 11.3).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["bilinear_filter", "bilinear_filter_padded"]


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
