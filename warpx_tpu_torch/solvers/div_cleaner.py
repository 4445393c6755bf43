"""The projection divergence cleaner of the initial B field.

The counterpart of ``warpx_tpu.solvers.div_cleaner`` (reference:
Source/Initialization/DivCleaner/ProjectionDivCleaner.cpp, run under
warpx.do_divb_cleaning_external, WarpXInitData.cpp:589-591): a loaded B
generally violates the discrete div B = 0; the cleaner solves
div(grad phi) = div B and subtracts grad phi so that the staggered
divergence (``yee.compute_div_b``'s stencil) vanishes to roundoff.  On the
periodic torus the projection is exact in k-space: with the up-difference
symbol s_d = (e^{i k_d dx_d} - 1) / dx_d of both the divergence and the
node-to-face gradient, phi_k = div_k / sum_d s_d^2 and B_k -= s_d phi_k.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import FieldState

__all__ = ["project_div_b"]


def project_div_b(fields: FieldState, geom) -> FieldState:
    """B -= grad(phi) with div(grad phi) = div(B) (periodic, staggered,
    1D Z, 2D XZ and 3D)."""
    ndim = geom.ndim
    names = {1: {"Bz": 0}, 2: {"Bx": 0, "Bz": 1},
             3: {"Bx": 0, "By": 1, "Bz": 2}}[ndim]
    shape = fields.Bx.shape
    dev = fields.Bx.device
    ks = []
    for d in range(ndim):
        k = 2.0 * np.pi * np.fft.fftfreq(shape[d], geom.dx[d])
        sym = (np.exp(1j * k * geom.dx[d]) - 1.0) / geom.dx[d]
        bshape = [1] * ndim
        bshape[d] = shape[d]
        ks.append(sym.reshape(bshape))
    div_k = 0.0
    b_k = {}
    for nm, d in names.items():
        b_k[nm] = torch.fft.fftn(getattr(fields, nm))
        div_k = div_k + torch.as_tensor(ks[d], device=dev) * b_k[nm]
    lap = sum(k * k for k in ks)
    # the zero mode (and a Nyquist-degenerate one) cannot be projected; a
    # periodic physical field has none
    lap = np.where(lap == 0.0, 1.0, lap)
    phi_k = div_k / torch.as_tensor(lap, device=dev)
    return fields.replace(**{
        nm: torch.fft.ifftn(b_k[nm] - torch.as_tensor(ks[d], device=dev)
                            * phi_k).real.to(fields.Bx.dtype).contiguous()
        for nm, d in names.items()})
