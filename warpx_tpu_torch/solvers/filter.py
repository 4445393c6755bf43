"""Bilinear (binomial) smoothing filter for J on the periodic torus.

The counterpart of ``warpx_tpu.solvers.filter.bilinear_filter`` (reference:
Source/Filter/BilinearFilter.cpp: each pass convolves [1/4, 1/2, 1/4] along
one dimension; ``warpx.use_filter`` with ``warpx.filter_npass_each_dir``
passes per dimension, applied to the deposited current before the field
solve, WarpXComm.cpp:1357 ApplyFilterJ).  The guard-padded filter and the
Godfrey NCI stencil come with the bounded step (ROADMAP.md Queue A 9).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["bilinear_filter"]


def bilinear_filter(arr: torch.Tensor,
                    npass_each_dir: Sequence[int]) -> torch.Tensor:
    """Periodic binomial filter, ``npass_each_dir[d]`` passes along axis d."""
    out = arr
    for axis, npass in enumerate(npass_each_dir):
        for _ in range(npass):
            out = 0.5 * out + 0.25 * (torch.roll(out, 1, axis)
                                      + torch.roll(out, -1, axis))
    return out
