"""PSATD pseudo-spectral analytical time-domain Maxwell solver.

The counterpart of ``warpx_tpu.solvers.psatd`` (reference:
Source/FieldSolver/SpectralSolver/SpectralAlgorithms/
PsatdAlgorithmJConstantInTime.cpp, PsatdAlgorithmComoving.cpp,
PsatdAlgorithmPml.cpp): each step the fields are transformed over the
guard-grown box (guards filled periodically), advanced analytically in
k-space with precomputed coefficients, and transformed back:

  E+ = C E + i c^2 S_ck (k x B) - S_ck/eps0 J - i (X2 rho_new - X3 rho_old) k
  B+ = C B - i S_ck (k x E) + i X1 (k x J)
  C = cos(w dt), S_ck = sin(w dt)/w, w = c |k_mod|

Finite-order stencils enter as modified k vectors from Fornberg
coefficients (SpectralKSpace.cpp:191-266), with nox/2 guard cells on
staggered grids (GuardCellManager.cpp:205-208); staggered components are
shifted to nodal in k-space by exp(-+ i k dx/2) during the transforms.

Every coefficient is built on the host in numpy float64, exactly as the JAX
module builds it, and moved once to the solver's device and precision
(complex coefficients to the matching complex type).  The transforms are
full complex ``torch.fft.fftn``/``ifftn``, as the JAX package uses
``jnp.fft.fftn``; the per-step work is library FFTs and elementwise complex
arithmetic.

``PsatdSolver.push`` and ``spectral_div_e`` take a mapping of component name
to tensor (``Ex`` ... ``Bz``, ``jx`` ... ``jz``, and ``F``/``G`` with
divergence cleaning); ``push`` returns a new mapping with the advanced
components, and ``F``/``G``, the time-averaged ``*_avg`` fields or the
corrected J where the family produces them.  ``PsatdPmlSolver.push`` takes
and returns ``{(comp, dir): tensor}`` split fields.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..constants import c as _c
from ..constants import ep0 as _ep0

__all__ = ["PsatdSolver", "PsatdFirstOrder", "PsatdPmlSolver",
           "fornberg_coefficients", "modified_k", "pml_split_dirs"]

_c2 = _c * _c
_NAMES_E = ("Ex", "Ey", "Ez")
_NAMES_B = ("Bx", "By", "Bz")
_NAMES_J = ("jx", "jy", "jz")
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
# active xyz axes per dimensionality
_ACTIVE = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}


def fornberg_coefficients(n_order: int, collocated: bool) -> np.ndarray:
    """Fornberg stencil coefficients by recurrence (WarpX.cpp:3119-3160)."""
    m = n_order // 2
    coeffs = np.zeros(m)
    if collocated:
        coeffs[0] = m * 2.0 / (m + 1)
        for n in range(1, m):
            coeffs[n] = -(m - n) * 1.0 / (m + n + 1) * coeffs[n - 1]
    else:
        prod = 1.0
        for k in range(1, m + 1):
            prod *= (m + k) / (4.0 * k)
        coeffs[0] = 4.0 * m * prod * prod
        for n in range(1, m):
            coeffs[n] = (
                -((2 * n - 1) * (m - n)) * 1.0 / ((2 * n + 1) * (m + n))
                * coeffs[n - 1]
            )
    return coeffs


def modified_k(k: np.ndarray, dx: float, n_order: int,
               collocated: bool) -> np.ndarray:
    """Finite-order modified k (SpectralKSpace.cpp:191-266); n_order == -1
    is the infinite-order (exact) case."""
    if n_order == -1:
        return k.copy()
    coeffs = fornberg_coefficients(n_order, collocated)
    out = np.zeros_like(k)
    for n, cf in enumerate(coeffs):
        if collocated:
            out += cf * np.sin(k * (n + 1) * dx) / ((n + 1) * dx)
        else:
            out += cf * np.sin(k * (n + 0.5) * dx) / ((n + 0.5) * dx)
    if collocated:
        # exactly zero modified k at the Nyquist frequency
        N = k.shape[0]
        if N % 2 == 0:
            out[N // 2] = 0.0
    return out


def _bcast(v: np.ndarray, d: int, ndim: int) -> np.ndarray:
    shape = [1] * ndim
    shape[d] = v.shape[0]
    return v.reshape(shape)


def _wavenumbers(n: int, dx: float, d: int) -> np.ndarray:
    """FFT wavenumbers of an axis; the first axis keeps its Nyquist
    wavenumber positive, as the reference's R2C transform does
    (SpectralKSpace.cpp "the first axis contains only the positive k")."""
    k = 2.0 * np.pi * np.fft.fftfreq(n, d=dx)
    if d == 0 and n % 2 == 0:
        k[n // 2] = abs(k[n // 2])
    return k


class _Device:
    """Moves host coefficients to the solver's device and precision once."""

    def __init__(self, dtype, device):
        self.dtype = dtype
        self.cdtype = _COMPLEX[dtype]
        self.device = torch.device(device)

    def t(self, a) -> torch.Tensor:
        a = np.asarray(a)
        dt = self.cdtype if np.iscomplexobj(a) else self.dtype
        if a.dtype == np.bool_:
            dt = torch.bool
        return torch.as_tensor(a, device=self.device).to(dt)


class PsatdSolver:
    """Periodic-padded single-box PSATD push: the standard family and its
    update-with-rho, current-correction, Galilean, comoving, time-averaged
    and F/G-cleaning variants, as the JAX class builds them."""

    def __init__(
        self,
        geom,
        staggering: Dict,
        dt: float,
        n_order: int = 16,
        collocated_grid: bool = False,
        update_with_rho: bool = False,
        current_correction: bool = False,
        v_galilean=(0.0, 0.0, 0.0),
        v_comoving=(0.0, 0.0, 0.0),
        single_box: bool = False,
        vay_deposition: bool = False,
        time_averaging: bool = False,
        dive_cleaning: bool = False,
        divb_cleaning: bool = False,
        dtype: torch.dtype = torch.float64,
        device: torch.device | str = "cpu",
    ):
        self.geom = geom
        self.staggering = staggering
        self.dt = dt
        self.n_order = n_order
        self.collocated_grid = collocated_grid
        self.update_with_rho = update_with_rho
        self.current_correction = current_correction
        self.v_galilean = tuple(v_galilean)
        self.is_galilean = any(v != 0.0 for v in self.v_galilean)
        self.v_comoving = tuple(v_comoving)
        self.is_comoving = any(v != 0.0 for v in self.v_comoving)
        if self.is_comoving and self.is_galilean:
            raise NotImplementedError(
                "Galilean and comoving PSATD cannot be combined")
        if self.is_comoving and not update_with_rho:
            raise NotImplementedError(
                "psatd.update_with_rho must be 1 for comoving PSATD "
                "(WarpX.cpp:1610)")
        self.vay_deposition = vay_deposition
        # F/G spectral divergence cleaning
        # (PsatdAlgorithmJConstantInTime.cpp:294-316)
        self.dive_cleaning = dive_cleaning
        self.divb_cleaning = divb_cleaning
        if (dive_cleaning or divb_cleaning) and (
                self.is_galilean or self.is_comoving):
            raise NotImplementedError(
                "divergence cleaning not implemented for Galilean/comoving "
                "PSATD (PsatdAlgorithmJConstantInTime.cpp:98-105)")
        if dive_cleaning and not update_with_rho:
            raise NotImplementedError(
                "warpx.do_dive_cleaning = 1 requires psatd.update_with_rho "
                "(WarpX.cpp:1605)")
        self.time_averaging = time_averaging
        if time_averaging and not update_with_rho:
            raise NotImplementedError(
                "psatd.do_time_averaging requires update_with_rho")
        dev = self._dev = _Device(dtype, device)
        ndim = geom.ndim
        # guards: nox/2 staggered, nox collocated; the whole periodic domain
        # exactly (no guards) with periodic_single_box, infinite order or
        # Vay deposition (which divides by k: guard leakage near k = 0 would
        # be amplified)
        if n_order == -1 or single_box or vay_deposition:
            self.ng = 0
        else:
            self.ng = n_order if collocated_grid else n_order // 2
        self.n_fft = tuple(geom.n_cell[d] + 2 * self.ng for d in range(ndim))
        self._wrap_idx = [
            torch.arange(-self.ng, geom.n_cell[d] + self.ng,
                         device=dev.device) % geom.n_cell[d]
            for d in range(ndim)]

        # current correction on the padded path projects on the exact
        # whole-domain FFT, then re-pads for the E/B push (the JAX module's
        # __init__ says why)
        self._cc_exact = None
        if current_correction and self.ng > 0:
            self._cc_exact = PsatdSolver(
                geom, staggering, dt, n_order=n_order,
                collocated_grid=collocated_grid,
                update_with_rho=update_with_rho, current_correction=True,
                v_galilean=v_galilean, v_comoving=v_comoving,
                single_box=True, dtype=dtype, device=device)

        ks, kmods, shifts_fwd = [], [], []
        for d in range(ndim):
            k = _wavenumbers(self.n_fft[d], geom.dx[d], d)
            ks.append(k)
            kmods.append(modified_k(k, geom.dx[d], n_order, collocated_grid))
            shifts_fwd.append(np.exp(-1j * k * 0.5 * geom.dx[d]))
        self._kmod = [dev.t(_bcast(kmods[d], d, ndim)) for d in range(ndim)]
        self._shift_fwd = [dev.t(_bcast(shifts_fwd[d], d, ndim))
                           for d in range(ndim)]
        self._shift_bwd = [dev.t(_bcast(np.conj(shifts_fwd[d]), d, ndim))
                           for d in range(ndim)]

        kmod_full = np.zeros(self.n_fft)
        for d in range(ndim):
            kmod_full = kmod_full + _bcast(kmods[d], d, ndim) ** 2
        knorm = np.sqrt(kmod_full)
        om = _c * knorm
        om2 = om * om
        C = np.cos(om * dt)
        S_ck = np.where(om != 0.0,
                        np.sin(om * dt) / np.where(om == 0, 1, om), dt)
        w_c = None
        if self.is_galilean:
            # Galilean PSATD (PsatdAlgorithmJConstantInTime.cpp:400-520):
            # w_c = k_centered . v_gal on the CENTERED modified k
            w_c = np.zeros(self.n_fft)
            for d in range(ndim):
                vg = self.v_galilean[_ACTIVE[ndim][d]]
                if vg == 0.0:
                    continue
                kc = modified_k(ks[d], geom.dx[d], n_order, True)
                w_c = w_c + _bcast(kc, d, ndim) * vg
            self._w_c = dev.t(w_c)
            theta = np.exp(1j * w_c * dt * 0.5)
            theta_star = np.conj(theta)
            T2 = theta * theta
            om2_m_w2 = om2 - w_c * w_c
            nz = (om != 0.0) | (w_c != 0.0)
            X1 = np.where(
                nz,
                (1.0 - T2 * C + 1j * w_c * T2 * S_ck)
                / (_ep0 * np.where(om2_m_w2 == 0, 1, om2_m_w2)),
                0.5 * dt * dt / _ep0,
            )
            tmp = np.where(
                om != 0.0,
                (1.0 - C) / (_ep0 * np.where(om2 == 0, 1, om2)),
                0.5 * dt * dt / _ep0,
            )
            dth = np.where(theta_star - theta == 0, 1, theta_star - theta)
            wnz = w_c != 0.0
            X2 = np.where(
                wnz,
                _c2 * (theta_star * X1 - theta * tmp) / dth,
                np.where(
                    om != 0.0,
                    _c2 * (dt - S_ck) / (_ep0 * dt * np.where(om2 == 0, 1,
                                                              om2)),
                    _c2 * dt * dt / (6.0 * _ep0),
                ),
            )
            X3 = np.where(
                wnz,
                _c2 * (theta_star * X1 - theta_star * tmp) / dth,
                np.where(
                    om != 0.0,
                    _c2 * (dt * C - S_ck) / (_ep0 * dt * np.where(om2 == 0, 1,
                                                                  om2)),
                    -_c2 * dt * dt / (3.0 * _ep0),
                ),
            )
            X4 = 1j * w_c * X1 - T2 * S_ck / _ep0
            self._T2 = dev.t(T2)
            self._X4 = dev.t(X4)
        else:
            X1 = np.where(om != 0.0,
                          (1.0 - C) / (_ep0 * np.where(om2 == 0, 1, om2)),
                          0.5 * dt * dt / _ep0)
            X2 = np.where(
                om != 0.0,
                _c2 * (dt - S_ck) / (_ep0 * dt * np.where(om2 == 0, 1, om2)),
                _c2 * dt * dt / (6.0 * _ep0),
            )
            X3 = np.where(
                om != 0.0,
                _c2 * (dt * C - S_ck) / (_ep0 * dt * np.where(om2 == 0, 1,
                                                              om2)),
                -_c2 * dt * dt / (3.0 * _ep0),
            )
        if self.is_comoving:
            X1, X2, X3 = self._comoving(ks, om, om2, C, S_ck, X1, X2, X3)
        self._C = dev.t(C)
        self._S_ck = dev.t(S_ck)
        self._X1 = dev.t(X1)
        self._X2 = dev.t(X2)
        self._X3 = dev.t(X3)
        if time_averaging:
            self._averaging(w_c, om, om2, dt)
        if current_correction:
            # 1/k^2 with zero at k = 0
            self._inv_k2 = dev.t(np.where(
                kmod_full != 0.0,
                1.0 / np.where(kmod_full == 0, 1, kmod_full), 0.0))

    def _comoving(self, ks, om, om2, C, S_ck, X1, X2, X3):
        """Comoving PSATD (PsatdAlgorithmComoving.cpp:164-414): X1..X4 carry
        the phase theta = exp(-i k.v dt/2) on the INFINITE-order k, while C
        and S_ck keep the finite-order modified k; returns X1..X3 and keeps
        T2 (ones), X4 and k.v."""
        ndim = self.geom.ndim
        dt = self.dt
        kv = np.zeros(self.n_fft)
        k2_inf = np.zeros(self.n_fft)
        for d in range(ndim):
            kb = _bcast(ks[d], d, ndim)
            kv = kv + kb * self.v_comoving[_ACTIVE[ndim][d]]
            k2_inf = k2_inf + kb * kb
        om_i = _c * np.sqrt(k2_inf)
        om2_i = om_i * om_i
        om2_m = om2
        om_m = om
        theta = np.exp(-0.5j * kv * dt)
        theta_star = np.conj(theta)
        T2 = theta * theta

        def g(x):
            return np.where(x == 0, 1, x)

        # --- main branch: om_mod, om != 0, nu not 0 or +-om_mod/om
        den = g(om2_m - kv * kv)
        x1 = om2_i / den * (theta_star - theta * C - 1j * kv * theta * S_ck)
        X1_a = x1 / (_ep0 * g(om2_i))
        dth = g(theta_star - theta)
        X2_a = _c2 * (x1 * om2_m - theta * (1.0 - C) * om2_i) / (
            dth * _ep0 * g(om2_i) * g(om2_m))
        X3_a = _c2 * (x1 * om2_m - theta_star * (1.0 - C) * om2_i) / (
            dth * _ep0 * g(om2_i) * g(om2_m))
        X4_a = -1j * kv * X1_a - theta * S_ck / _ep0
        # --- resonant branches nu = +-om_mod/om, i.e. k.v = -+om_mod
        tmp1 = np.exp(1j * om_m * dt)
        tmp2 = np.exp(-1j * om_m * dt)
        tmp1s = np.exp(0.5j * om_m * dt)
        tmp2s = np.exp(-0.5j * om_m * dt)
        t1m1 = g(tmp1 - 1.0)
        X1_p = tmp1s * (1.0 - tmp2 * tmp2 - 2j * om_m * dt) / (
            4.0 * _ep0 * g(om2_m))
        X2_p = _c2 * (-4.0 + 3.0 * tmp1 + tmp2 - 2j * om_m * dt * tmp1) / (
            4.0 * _ep0 * g(om2_m) * t1m1)
        X3_p = _c2 * (2.0 - tmp2 - 3.0 * tmp1 + 2.0 * tmp1 * tmp1
                      - 2j * om_m * dt * tmp1) / (
            4.0 * _ep0 * g(om2_m) * t1m1)
        X4_p = tmp1s * (1j - 1j * tmp2 * tmp2 - 2.0 * om_m * dt) / (
            4.0 * _ep0 * g(om_m))
        X1_m = tmp2s * (1.0 - tmp1 * tmp1 + 2j * om_m * dt) / (
            4.0 * _ep0 * g(om2_m))
        X2_m = _c2 * (-3.0 + 4.0 * tmp1 - tmp1 * tmp1 - 2j * om_m * dt) / (
            4.0 * _ep0 * g(om2_m) * t1m1)
        X3_m = _c2 * (3.0 - 2.0 * tmp2 - 2.0 * tmp1 + tmp1 * tmp1
                      - 2j * om_m * dt) / (
            4.0 * _ep0 * g(om2_m) * t1m1)
        X4_m = tmp2s * (-1j + 1j * tmp1 * tmp1 - 2.0 * om_m * dt) / (
            4.0 * _ep0 * g(om_m))
        # --- om_mod = 0, om != 0, nu != 0 (collocated Nyquist)
        kv2 = g(kv * kv)
        T2m1 = g(T2 - 1.0)
        X1_c = (-theta_star + theta + 1j * kv * dt * theta) / (_ep0 * kv2)
        X2_c = _c2 * (1.0 - T2 - 1j * kv * dt * T2
                      + 0.5 * kv * kv * dt * dt * T2) / (_ep0 * kv2 * T2m1)
        X3_c = _c2 * (1.0 - T2 - 1j * kv * dt * T2
                      + 0.5 * kv * kv * dt * dt) / (_ep0 * kv2 * T2m1)
        X4_c = -1j * (theta - theta_star) / (_ep0 * g(kv))
        # --- branch masks (float equalities, as in the reference)
        kvnz = kv != 0.0
        res_p = kvnz & (om_m != 0.0) & (om_i != 0.0) & (kv == -om_m)
        res_m = kvnz & (om_m != 0.0) & (om_i != 0.0) & (kv == om_m)
        main = kvnz & (om_m != 0.0) & (om_i != 0.0) & ~res_p & ~res_m
        regc = kvnz & (om_m == 0.0) & (om_i != 0.0)
        conds = [main, res_p, res_m, regc]
        X1 = np.select(conds, [X1_a, X1_p, X1_m, X1_c], default=X1)
        X2 = np.select(conds, [X2_a, X2_p, X2_m, X2_c], default=X2)
        X3 = np.select(conds, [X3_a, X3_p, X3_m, X3_c], default=X3)
        X4 = np.select(conds, [X4_a, X4_p, X4_m, X4_c],
                       default=-S_ck / _ep0).astype(complex)
        self._T2 = self._dev.t(np.ones(self.n_fft, complex))
        self._X4 = self._dev.t(X4)
        self._kv_inf = self._dev.t(kv)
        return X1, X2, X3

    def _averaging(self, w_c, om, om2, dt):
        """Averaged (Galilean) PSATD: <E>, <B> over [t+dt/2, t+3dt/2]
        (PsatdAlgorithmJConstantInTime::
        InitializeSpectralCoefficientsAveraging, :530-695)."""
        w = w_c if self.is_galilean else np.zeros(self.n_fft)
        w2 = w * w
        w3 = w2 * w
        om4 = om2 * om2
        th1 = np.exp(1j * w * dt * 0.5)
        th2 = np.exp(1j * w * dt)
        th3 = np.exp(1j * w * dt * 1.5)
        th5 = np.exp(1j * w * dt * 2.5)
        C1 = np.cos(0.5 * om * dt)
        C3 = np.cos(1.5 * om * dt)
        S1_om = np.where(
            om != 0.0, np.sin(0.5 * om * dt) / np.where(om == 0, 1, om),
            0.5 * dt)
        S3_om = np.where(
            om != 0.0, np.sin(1.5 * om * dt) / np.where(om == 0, 1, om),
            1.5 * dt)
        nz = (om != 0.0) | (w != 0.0)
        o_m_w = np.where(om2 - w2 == 0, 1.0, om2 - w2)
        Psi1 = np.where(
            nz,
            (th3 * (om2 * S3_om + 1j * w * C3)
             - th1 * (om2 * S1_om + 1j * w * C1)) / (dt * o_m_w),
            1.0)
        Psi2 = np.where(
            nz,
            (th3 * (C3 - 1j * w * S3_om)
             - th1 * (C1 - 1j * w * S1_om)) / (dt * o_m_w),
            -dt)
        Psi3 = np.where(
            w != 0.0,
            -1j * (th3 - th1) / (dt * np.where(w == 0, 1, w)),
            1.0)
        dt2 = dt * dt
        Y1 = np.where(
            nz,
            (1.0 - Psi1 - 1j * w * Psi2) / (_ep0 * o_m_w),
            13.0 * dt2 / (24.0 * _ep0))
        om2s = np.where(om2 == 0, 1, om2)
        om4s = np.where(om4 == 0, 1, om4)
        w3s = np.where(w3 == 0, 1, w3)
        th2m1 = np.where(th2 == 1.0, 1.0, th2 - 1.0)
        conds = [(om != 0.0) & (w != 0.0), (om != 0.0) & (w == 0.0),
                 (om == 0.0) & (w != 0.0)]
        Y2 = np.select(
            conds,
            [
                1j * _c2 * (_ep0 * om2s * Y1 - Psi3 + Psi1)
                / (_ep0 * om2s * th2m1),
                1j * _c2 * (C1 - C3 - dt2 * om2) / (_ep0 * dt2 * om4s),
                _c2 * (9.0 * dt2 * w2 * th3 - dt2 * w2 * th1
                       - 24.0 * th3 + 24.0 * th1 + 1j * 8.0 * dt * w
                       + 1j * 24.0 * dt * w * th3
                       - 1j * 8.0 * dt * w * th1)
                / (8.0 * _ep0 * dt * w3s
                   * np.where(th2 == 1.0, 1.0, 1.0 - th2)),
            ],
            default=-1j * 5.0 * _c2 * dt2 / (24.0 * _ep0))
        Y3 = np.select(
            conds,
            [
                1j * _c2 * (Psi3 - Psi1 - _ep0 * th2 * om2s * Y1)
                / (_ep0 * om2s * th2m1),
                1j * _c2 * (C3 - C1 + dt * om2 * (S3_om - S1_om))
                / (_ep0 * dt2 * om4s),
                _c2 * (9.0 * dt2 * w2 * th3 - dt2 * w2 * th1
                       - 16.0 * th5 + 8.0 * th3 + 8.0 * th1
                       + 1j * 12.0 * dt * w * th5
                       + 1j * 8.0 * dt * w * th3
                       - 1j * 4.0 * dt * w * th1
                       + 1j * 8.0 * dt * w * th2)
                / (8.0 * _ep0 * dt * w3s * th2m1),
            ],
            default=-1j * _c2 * dt2 / (3.0 * _ep0))
        Y4 = (Psi2 + 1j * _ep0 * w * Y1) / _ep0
        t = self._dev.t
        self._Psi1, self._Psi2 = t(Psi1), t(Psi2)
        self._Y1, self._Y2, self._Y3, self._Y4 = t(Y1), t(Y2), t(Y3), t(Y4)

    # --------------------------------------------------------------- helpers
    def _pad(self, arr: torch.Tensor) -> torch.Tensor:
        """Periodic pad by ng per side (the guard fill before the FFT)."""
        if self.ng == 0:
            return arr
        for d, idx in enumerate(self._wrap_idx):
            arr = arr.index_select(d, idx)
        return arr

    def _crop(self, arr: torch.Tensor) -> torch.Tensor:
        if self.ng == 0:
            return arr
        return arr[tuple(slice(self.ng, s - self.ng) for s in arr.shape)]

    def forward(self, arr: torch.Tensor, comp_name: str) -> torch.Tensor:
        """Real field -> k-space nodal representation."""
        F = torch.fft.fftn(self._pad(arr))
        for d in range(self.geom.ndim):
            if self.staggering[comp_name][d] == 0:  # cell-centered in d
                F = F * self._shift_fwd[d]
        return F

    def backward(self, F: torch.Tensor, comp_name: str) -> torch.Tensor:
        for d in range(self.geom.ndim):
            if self.staggering[comp_name][d] == 0:
                F = F * self._shift_bwd[d]
        return self._crop(torch.fft.ifftn(F).real).contiguous()

    def _cc_corrected_J(self, J, rho_old_k, rho_new_k, kx, ky, kz):
        """k-space current correction on THIS solver's k-grid:
        F = [k.J - i (rho_new - rho_old)/dt] / k^2; J <- J - F k
        (PsatdAlgorithmJConstantInTime::CurrentCorrection:719-800), with
        the Galilean (:764-775) and comoving (PsatdAlgorithmComoving.cpp:
        478-499) time differences."""
        I = 1j
        dt = self.dt
        k_dot_J = kx * J[0] + ky * J[1] + kz * J[2]
        F_std = (k_dot_J - I * (rho_new_k - rho_old_k) / dt) * self._inv_k2
        if self.is_comoving:
            kv = self._kv_inf
            th = torch.exp(-0.5j * kv * dt)
            den = torch.where(th * th == 1.0, 1.0, 1.0 - th * th)
            F_com = (k_dot_J + kv * th * (rho_new_k - rho_old_k) / den
                     ) * self._inv_k2
            F = torch.where(kv != 0.0, F_com, F_std)
        elif self.is_galilean:
            w_c = self._w_c
            t2 = torch.exp(I * w_c * dt)
            den = torch.where(t2 == 1.0, 1.0, 1.0 - t2)
            F_gal = (k_dot_J - w_c * (rho_new_k - rho_old_k * t2) / den
                     ) * self._inv_k2
            F = torch.where(w_c != 0.0, F_gal, F_std)
        else:
            F = F_std
        return [J[0] - F * kx, J[1] - F * ky, J[2] - F * kz]

    def _k3(self):
        """(kx, ky, kz) modified k broadcastable over the box, 0.0 on the
        inactive axes."""
        ndim = self.geom.ndim
        if ndim == 3:
            return self._kmod[0], self._kmod[1], self._kmod[2]
        if ndim == 2:
            return self._kmod[0], 0.0, self._kmod[1]
        return 0.0, 0.0, self._kmod[0]

    def spectral_div_e(self, fields: Mapping[str, torch.Tensor]
                       ) -> torch.Tensor:
        """Nodal div(E) via i k.E in spectral space (SpectralSolver::
        ComputeSpectralDivE, the divE diagnostic under PSATD)."""
        E = [self.forward(fields[nm], nm) for nm in _NAMES_E]
        kx, ky, kz = self._k3()
        D = 1j * (kx * E[0] + ky * E[1] + kz * E[2])
        return self._crop(torch.fft.ifftn(D).real).contiguous()

    # ------------------------------------------------------------------ push
    def push(self, fields: Mapping[str, torch.Tensor], rho_pair=None,
             j_old=None) -> Dict[str, torch.Tensor]:
        """One PSATD step: E, B <- the analytic k-space advance with J (and
        rho).  ``rho_pair`` = (rho_old, rho_new) nodal arrays for current
        correction and update-with-rho.  ``j_old`` = (jx, jy, jz) at the
        start of the step makes J linear in time (multi-J,
        PsatdAlgorithmJLinearInTime.cpp:115-190); ``fields``' J is then J
        at the end of the step.  Returns ``fields`` with the new E and B
        (and F, G, the averaged fields or the corrected J where the family
        makes them; with ``j_old``, E and B only, as the JAX package
        returns them)."""
        E = [self.forward(fields[nm], nm) for nm in _NAMES_E]
        B = [self.forward(fields[nm], nm) for nm in _NAMES_B]
        if self.vay_deposition:
            # the deposited arrays are the NODAL D fields; the
            # charge-conserving J is i D/k per component
            # (PsatdAlgorithmJConstantInTime::VayDeposition:805-861)
            J = [self.forward(fields[nm], "rho") for nm in _NAMES_J]
        else:
            J = [self.forward(fields[nm], nm) for nm in _NAMES_J]
        kx, ky, kz = self._k3()
        dt = self.dt
        I = 1j
        out = dict(fields)

        # the J the push returns beside E and B (not with ``j_old``)
        late_j = {}
        if self.vay_deposition:
            def div_k(D, k):
                if isinstance(k, float):
                    return torch.zeros_like(D)
                return torch.where(k != 0.0,
                                   I * D / torch.where(k == 0, 1.0, k), 0.0)

            J = [div_k(J[0], kx), div_k(J[1], ky), div_k(J[2], kz)]
            # the real-space (nodal) J of the diagnostics
            # (PSATDBackwardTransformJ)
            late_j = {nm: self.backward(Jc, "rho")
                      for nm, Jc in zip(_NAMES_J, J)}

        rho_old_k = rho_new_k = None
        if rho_pair is not None:
            rho_old_k = self.forward(rho_pair[0], "rho")
            rho_new_k = self.forward(rho_pair[1], "rho")

        if self.current_correction:
            # the corrected J is transformed back too and becomes the
            # diagnostic current (PSATDBackwardTransformJ)
            if self._cc_exact is not None:
                # the exact periodic-domain projection, then re-padded for
                # the E/B push
                ex = self._cc_exact
                Jc = ex._cc_corrected_J(
                    [ex.forward(fields[nm], nm) for nm in _NAMES_J],
                    ex.forward(rho_pair[0], "rho"),
                    ex.forward(rho_pair[1], "rho"),
                    *ex._k3(),
                )
                out.update({nm: ex.backward(a, nm)
                            for nm, a in zip(_NAMES_J, Jc)})
                J = [self.forward(out[nm], nm) for nm in _NAMES_J]
            else:
                J = self._cc_corrected_J(J, rho_old_k, rho_new_k, kx, ky, kz)
                late_j = {nm: self.backward(Jc, nm)
                          for nm, Jc in zip(_NAMES_J, J)}

        k_dot_E = kx * E[0] + ky * E[1] + kz * E[2]
        k_dot_J = kx * J[0] + ky * J[1] + kz * J[2]
        if self.update_with_rho:
            rho_old = rho_old_k
            rho_new = rho_new_k
        else:
            rho_old = I * _ep0 * k_dot_E
            if self.is_galilean:
                w_c = self._w_c
                T2g = torch.exp(I * w_c * dt)
                rho_new = torch.where(
                    w_c != 0.0,
                    T2g * rho_old
                    + (1.0 - T2g) * k_dot_J / torch.where(w_c == 0, 1.0, w_c),
                    rho_old - I * k_dot_J * dt,
                )
            else:
                rho_new = rho_old - I * k_dot_J * dt

        C, S_ck, X1, X2, X3 = self._C, self._S_ck, self._X1, self._X2, self._X3
        if self.is_galilean or self.is_comoving:
            T2, X4 = self._T2, self._X4
        else:
            T2, X4 = 1.0, -S_ck / _ep0
        rho_fac = X2 * rho_new - T2 * X3 * rho_old

        if j_old is not None:
            # J linear in time: J(t) runs from J_old to J_new
            # (PsatdAlgorithmJLinearInTime.cpp:160-186); X1..X4 standard
            Jo = [self.forward(a, nm) for a, nm in zip(j_old, _NAMES_J)]
            dJ = [J[i] - Jo[i] for i in range(3)]
            new = {
                "Ex": (C * E[0] + I * _c2 * S_ck * (ky * B[2] - kz * B[1])
                       + X4 * Jo[0] - I * rho_fac * kx - X1 * dJ[0] / dt),
                "Ey": (C * E[1] + I * _c2 * S_ck * (kz * B[0] - kx * B[2])
                       + X4 * Jo[1] - I * rho_fac * ky - X1 * dJ[1] / dt),
                "Ez": (C * E[2] + I * _c2 * S_ck * (kx * B[1] - ky * B[0])
                       + X4 * Jo[2] - I * rho_fac * kz - X1 * dJ[2] / dt),
                "Bx": (C * B[0] - I * S_ck * (ky * E[2] - kz * E[1])
                       + I * X1 * (ky * Jo[2] - kz * Jo[1])
                       + I * X2 / _c2 * (ky * dJ[2] - kz * dJ[1])),
                "By": (C * B[1] - I * S_ck * (kz * E[0] - kx * E[2])
                       + I * X1 * (kz * Jo[0] - kx * Jo[2])
                       + I * X2 / _c2 * (kz * dJ[0] - kx * dJ[2])),
                "Bz": (C * B[2] - I * S_ck * (kx * E[1] - ky * E[0])
                       + I * X1 * (kx * Jo[1] - ky * Jo[0])
                       + I * X2 / _c2 * (kx * dJ[1] - ky * dJ[0])),
            }
            out.update({nm: self.backward(a, nm) for nm, a in new.items()})
            return out

        Ex = (T2 * C * E[0] + I * _c2 * T2 * S_ck * (ky * B[2] - kz * B[1])
              + X4 * J[0] - I * rho_fac * kx)
        Ey = (T2 * C * E[1] + I * _c2 * T2 * S_ck * (kz * B[0] - kx * B[2])
              + X4 * J[1] - I * rho_fac * ky)
        Ez = (T2 * C * E[2] + I * _c2 * T2 * S_ck * (kx * B[1] - ky * B[0])
              + X4 * J[2] - I * rho_fac * kz)
        Bx = (T2 * C * B[0] - I * T2 * S_ck * (ky * E[2] - kz * E[1])
              + I * X1 * (ky * J[2] - kz * J[1]))
        By = (T2 * C * B[1] - I * T2 * S_ck * (kz * E[0] - kx * E[2])
              + I * X1 * (kz * J[0] - kx * J[2]))
        Bz = (T2 * C * B[2] - I * T2 * S_ck * (kx * E[1] - ky * E[0])
              + I * X1 * (kx * J[1] - ky * J[0]))

        # F/G spectral divergence cleaning
        # (PsatdAlgorithmJConstantInTime.cpp:294-316)
        if self.dive_cleaning:
            F_old = self.forward(fields["F"], "F")
            Ex = Ex + I * _c2 * S_ck * F_old * kx
            Ey = Ey + I * _c2 * S_ck * F_old * ky
            Ez = Ez + I * _c2 * S_ck * F_old * kz
            F_new = (C * F_old + S_ck * (I * k_dot_E - rho_old / _ep0)
                     - X1 * ((rho_new - rho_old) / dt + I * k_dot_J))
            out["F"] = self.backward(F_new, "F")
        if self.divb_cleaning:
            G_old = self.forward(fields["G"], "G")
            k_dot_B = kx * B[0] + ky * B[1] + kz * B[2]
            Bx = Bx + I * S_ck * G_old * kx
            By = By + I * S_ck * G_old * ky
            Bz = Bz + I * S_ck * G_old * kz
            out["G"] = self.backward(C * G_old + I * _c2 * S_ck * k_dot_B,
                                     "G")

        for nm, a in zip(_NAMES_E + _NAMES_B, (Ex, Ey, Ez, Bx, By, Bz)):
            out[nm] = self.backward(a, nm)
        if self.time_averaging:
            # time-averaged <E>, <B> from the OLD fields and this step's
            # J / rho pair (PsatdAlgorithmJConstantInTime.cpp:319-358)
            P1, P2 = self._Psi1, self._Psi2
            Y1, Y2, Y3, Y4 = self._Y1, self._Y2, self._Y3, self._Y4
            rho_t = Y2 * rho_new + Y3 * rho_old
            avg = {
                "Ex": P1 * E[0] - I * _c2 * P2 * (ky * B[2] - kz * B[1])
                + Y4 * J[0] + rho_t * kx,
                "Ey": P1 * E[1] - I * _c2 * P2 * (kz * B[0] - kx * B[2])
                + Y4 * J[1] + rho_t * ky,
                "Ez": P1 * E[2] - I * _c2 * P2 * (kx * B[1] - ky * B[0])
                + Y4 * J[2] + rho_t * kz,
                "Bx": P1 * B[0] + I * P2 * (ky * E[2] - kz * E[1])
                + I * Y1 * (ky * J[2] - kz * J[1]),
                "By": P1 * B[1] + I * P2 * (kz * E[0] - kx * E[2])
                + I * Y1 * (kz * J[0] - kx * J[2]),
                "Bz": P1 * B[2] + I * P2 * (kx * E[1] - ky * E[0])
                + I * Y1 * (kx * J[1] - ky * J[0]),
            }
            for nm, a in avg.items():
                out[nm + "_avg"] = self.backward(a, nm)
        out.update(late_j)
        return out


class PsatdFirstOrder(PsatdSolver):
    """First-order-form PSATD (PsatdAlgorithmFirstOrder.cpp:60-355), the
    solver of multi-J with psatd.solution_type = first-order: J constant or
    linear and rho constant or linear in time, with or without the F/G
    cleaning potentials.  The closed form of the JAX class
    (``warpx_tpu.solvers.psatd.PsatdFirstOrder``, whose docstring spells it
    out), with k the modified k, S = sin(w dt), C = cos(w dt):

      E+ = C E + i c S/|k| (k x B) - mu0 c S/|k| Jc0 - mu0 (1-C)/k^2 Jc1
           + [(1-C) khat(khat.E) + A k(k.Jc0) + Bc k(k.Jc1)]  (no cleaning)
           + [i c S/|k| k F + i mu0 c^2 (C-1)/k^2 k rho_c0
              - i c D k rho_c1]                              (cleaning)
      B+ = C B - i S/(c|k|) (k x E) + i mu0 (1-C)/k^2 (k x Jc0)
           - i D (k x Jc1) [+ i S/(c|k|) k G]
      F+ = C F + i S/(c|k|) (k.E) + i mu0 (C-1)/k^2 (k.Jc0) + i D (k.Jc1)
           - mu0 c S/|k| rho_c0 + mu0 (C-1)/k^2 rho_c1;  G+ = C G + i c S/|k| k.B
      A = c^2 D, Bc = mu0 (2(1-C) - dt^2 c^2 k^2)/(2 k^4),
      D = mu0 (|k| S - dt c k^2)/(c k^4)

    and at k = 0: E+ = E - mu0 c^2 (dt Jc0 + dt^2/2 Jc1), F+ likewise with
    rho, B and G unchanged.  The coefficients are built in numpy float64 and
    moved once, as the parent's are.  Galilean, comoving, current
    correction and Vay deposition are not defined for it (the reference
    aborts)."""

    def __init__(self, *args, j_in_time="linear", rho_in_time="linear",
                 div_cleaning=False, **kw):
        super().__init__(*args, **kw)
        if self.is_galilean or self.is_comoving:
            raise NotImplementedError(
                "first-order PSATD with Galilean/comoving velocities")
        if self.current_correction or self.vay_deposition:
            raise NotImplementedError(
                "current correction / Vay deposition not implemented for "
                "first-order PSATD equations")
        self.j_in_time = j_in_time
        self.rho_in_time = rho_in_time
        self.div_cleaning = div_cleaning
        geom = self.geom
        ndim = geom.ndim
        kmod_full = np.zeros(self.n_fft)
        for d in range(ndim):
            k = modified_k(_wavenumbers(self.n_fft[d], geom.dx[d], d),
                           geom.dx[d], self.n_order, self.collocated_grid)
            kmod_full = kmod_full + _bcast(k, d, ndim) ** 2
        knorm = np.sqrt(kmod_full)
        k2 = knorm * knorm
        dt = self.dt
        mu0 = 1.0 / (_ep0 * _c2)
        om = _c * knorm
        C = np.cos(om * dt)
        nz = k2 != 0.0
        inv_k = np.where(nz, 1.0 / np.where(nz, knorm, 1.0), 0.0)
        inv_k2 = np.where(nz, 1.0 / np.where(nz, k2, 1.0), 0.0)
        inv_k4 = inv_k2 * inv_k2
        D = mu0 * (knorm * np.sin(om * dt) - dt * _c * k2) * inv_k4 / _c
        t = self._dev.t
        self._fo_nz = t(nz)
        self._fo_S_k = t(np.sin(om * dt) * inv_k)
        self._fo_1mC_k2 = t((1.0 - C) * inv_k2)
        self._fo_inv_k2 = t(inv_k2)
        self._fo_D = t(D)
        self._fo_A = t(_c2 * D)
        self._fo_Bc = t(mu0 * (2.0 * (1.0 - C) - dt * dt * _c2 * k2) * 0.5
                        * inv_k4)

    def push_first_order(self, fields: Mapping[str, torch.Tensor], j_c0,
                         j_c1=None, rho_c0=None, rho_c1=None
                         ) -> Dict[str, torch.Tensor]:
        """One sub-step advance of E, B (and F, G with cleaning).
        ``j_c0``/``j_c1`` are real-space (jx, jy, jz) tuples, ``rho_c0``/
        ``rho_c1`` real-space scalars; returns ``fields`` with the new
        components."""
        E = [self.forward(fields[nm], nm) for nm in _NAMES_E]
        B = [self.forward(fields[nm], nm) for nm in _NAMES_B]
        J0 = [self.forward(a, nm) for a, nm in zip(j_c0, _NAMES_J)]
        J1 = ([self.forward(a, nm) for a, nm in zip(j_c1, _NAMES_J)]
              if j_c1 is not None else None)
        R0 = self.forward(rho_c0, "rho") if rho_c0 is not None else None
        R1 = self.forward(rho_c1, "rho") if rho_c1 is not None else None
        Fk = self.forward(fields["F"], "F") if self.div_cleaning else None
        Gk = self.forward(fields["G"], "G") if self.div_cleaning else None

        k3 = self._k3()
        dt = self.dt
        I = 1j
        mu0 = 1.0 / (_ep0 * _c2)
        C = self._C
        nz = self._fo_nz
        S_k = self._fo_S_k
        one_m_C_k2 = self._fo_1mC_k2
        inv_k2 = self._fo_inv_k2
        D, A, Bc = self._fo_D, self._fo_A, self._fo_Bc

        def dot(V):
            return k3[0] * V[0] + k3[1] * V[1] + k3[2] * V[2]

        def cross(V, i):
            j, m = ((1, 2), (2, 0), (0, 1))[i]
            return k3[j] * V[m] - k3[m] * V[j]

        kdE = dot(E)
        kdB = dot(B)
        kdJ0 = dot(J0)
        kdJ1 = dot(J1) if J1 is not None else None
        out = dict(fields)
        for i in range(3):
            k_i = k3[i]
            e = (C * E[i] + I * _c * S_k * cross(B, i)
                 - mu0 * _c * S_k * J0[i])
            b = (C * B[i] - I * S_k / _c * cross(E, i)
                 + I * mu0 * one_m_C_k2 * cross(J0, i))
            if self.div_cleaning:
                e = (e + I * _c * S_k * k_i * Fk
                     + I * mu0 * _c2 * (C - 1.0) * inv_k2 * k_i * R0)
                b = b + I * S_k / _c * k_i * Gk
                if R1 is not None:
                    e = e - I * _c * D * k_i * R1
            else:
                e = e + one_m_C_k2 * k_i * kdE + A * k_i * kdJ0
            if J1 is not None:
                e = e - mu0 * one_m_C_k2 * J1[i]
                b = b - I * D * cross(J1, i)
                if not self.div_cleaning:
                    e = e + Bc * k_i * kdJ1
            # the k = 0 limits (PsatdAlgorithmFirstOrder.cpp:160-171)
            e0 = E[i] - mu0 * _c2 * dt * J0[i]
            if J1 is not None:
                e0 = e0 - 0.5 * mu0 * _c2 * dt * dt * J1[i]
            out[_NAMES_E[i]] = self.backward(torch.where(nz, e, e0),
                                             _NAMES_E[i])
            out[_NAMES_B[i]] = self.backward(torch.where(nz, b, B[i]),
                                             _NAMES_B[i])
        if self.div_cleaning:
            f_new = (C * Fk + I * S_k / _c * kdE
                     + I * mu0 * (C - 1.0) * inv_k2 * kdJ0
                     - mu0 * _c * S_k * R0)
            if kdJ1 is not None:
                f_new = f_new + I * D * kdJ1
            if R1 is not None:
                f_new = f_new + mu0 * (C - 1.0) * inv_k2 * R1
            f0 = Fk - mu0 * _c2 * dt * R0
            if R1 is not None:
                f0 = f0 - 0.5 * mu0 * _c2 * dt * dt * R1
            g_new = C * Gk + I * _c * S_k * kdB
            out["F"] = self.backward(torch.where(nz, f_new, f0), "F")
            out["G"] = self.backward(torch.where(nz, g_new, Gk), "G")
        return out


def pml_split_dirs(comp: str, cleaning: bool) -> tuple:
    """Split directions of a PML component, the first being the reference's
    component 0 (PMLComponent.H: xy=0/xz=1/xx=2 etc.; F/G split x/y/z)."""
    if comp in ("F", "G"):
        return ("x", "y", "z")
    own = comp[1]  # 'x' | 'y' | 'z'
    others = [a for a in "xyz" if a != own]
    return tuple(others) + ((own,) if cleaning else ())


class PsatdPmlSolver:
    """Spectral split-field PML push (PsatdAlgorithmPml.cpp:79-455).

    Evolves the Berenger split components of E/B (and, with divergence
    cleaning, the F/G splits) analytically in k-space over one extended box
    that covers the domain and its PML strips; the caller re-feeds the
    interior split values from the regular fields every step (the analog of
    PML::Exchange), so only the strips carry split dynamics, damped in real
    space afterwards.  Split keys are (comp, dir) tuples, e.g. ("Ex", "y")
    for the reference's Exy.
    """

    def __init__(
        self,
        geom,
        staggering: Dict,
        dt: float,
        n_order: int = 16,
        collocated_grid: bool = False,
        v_galilean=(0.0, 0.0, 0.0),
        dive_cleaning: bool = False,
        divb_cleaning: bool = False,
        dtype: torch.dtype = torch.float64,
        device: torch.device | str = "cpu",
    ):
        if dive_cleaning != divb_cleaning:
            raise NotImplementedError(
                "PML-PSATD requires do_pml_dive_cleaning == "
                "do_pml_divb_cleaning (PsatdAlgorithmPml.cpp only implements "
                "the neither/both branches)")
        ndim = geom.ndim
        if ndim == 1:
            raise NotImplementedError("PML in Cartesian 1D geometry")
        self.geom = geom
        self.staggering = staggering
        self.dt = dt
        self.cleaning = dive_cleaning
        self.is_galilean = any(v != 0.0 for v in v_galilean)
        self.n_fft = tuple(geom.n_cell)
        dev = _Device(dtype, device)
        t = dev.t

        ks, kmods, shifts = [], [], []
        for d in range(ndim):
            k = _wavenumbers(self.n_fft[d], geom.dx[d], d)
            ks.append(k)
            kmods.append(modified_k(k, geom.dx[d], n_order, collocated_grid))
            shifts.append(np.exp(-1j * k * 0.5 * geom.dx[d]))
        self._shift_fwd = [t(_bcast(shifts[d], d, ndim)) for d in range(ndim)]
        self._shift_bwd = [t(_bcast(np.conj(shifts[d]), d, ndim))
                           for d in range(ndim)]

        # the full xyz modified-k triple over the box (ky = 0 in 2D)
        zeros = np.zeros(self.n_fft)
        if ndim == 3:
            kx = _bcast(kmods[0], 0, ndim) + zeros
            ky = _bcast(kmods[1], 1, ndim) + zeros
            kz = _bcast(kmods[2], 2, ndim) + zeros
        else:
            kx = _bcast(kmods[0], 0, ndim) + zeros
            ky = zeros
            kz = _bcast(kmods[1], 1, ndim) + zeros
        kx2, ky2, kz2 = kx * kx, ky * ky, kz * kz
        k2 = kx2 + ky2 + kz2
        knorm = np.sqrt(k2)
        C = np.cos(_c * knorm * dt)
        S_ck = np.where(
            knorm != 0.0,
            np.sin(_c * knorm * dt) / np.where(knorm == 0, 1, _c * knorm),
            dt)
        inv_k2 = np.where(k2 != 0.0, 1.0 / np.where(k2 == 0, 1, k2), 0.0)
        knz = knorm != 0.0
        self._knz = t(knz)

        # C1..C9 (PsatdAlgorithmPml.cpp:208-216); identity at k = 0
        self._C1 = t(np.where(knz, (kx2 * C + ky2 + kz2) * inv_k2, 1.0))
        self._C2 = t(np.where(knz, (kx2 + ky2 * C + kz2) * inv_k2, 1.0))
        self._C3 = t(np.where(knz, (kx2 + ky2 + kz2 * C) * inv_k2, 1.0))
        self._C4 = t(kx2 * (C - 1.0) * inv_k2)
        self._C5 = t(ky2 * (C - 1.0) * inv_k2)
        self._C6 = t(kz2 * (C - 1.0) * inv_k2)
        self._C7 = t(ky * kz * (1.0 - C) * inv_k2)
        self._C8 = t(kx * kz * (1.0 - C) * inv_k2)
        self._C9 = t(kx * ky * (1.0 - C) * inv_k2)

        I = 1j
        if not self.cleaning:
            # C10..C22 (:221-233)
            dS = dt - S_ck
            self._C10 = t(I * _c2 * kx * ky * kz * dS * inv_k2)
            self._C11 = t(I * _c2 * ky2 * kz * dS * inv_k2)
            self._C12 = t(I * _c2 * kz2 * ky * dS * inv_k2)
            self._C13 = t(I * _c2 * kz2 * kx * dS * inv_k2)
            self._C14 = t(I * _c2 * kx2 * kz * dS * inv_k2)
            self._C15 = t(I * _c2 * kx2 * ky * dS * inv_k2)
            self._C16 = t(I * _c2 * ky2 * kx * dS * inv_k2)
            self._C17 = t(I * _c2 * kx * (ky2 * dt + (kz2 + kx2) * S_ck)
                          * inv_k2)
            self._C18 = t(I * _c2 * kx * (kz2 * dt + (ky2 + kx2) * S_ck)
                          * inv_k2)
            self._C19 = t(I * _c2 * ky * (kz2 * dt + (kx2 + ky2) * S_ck)
                          * inv_k2)
            self._C20 = t(I * _c2 * ky * (kx2 * dt + (kz2 + ky2) * S_ck)
                          * inv_k2)
            self._C21 = t(I * _c2 * kz * (kx2 * dt + (ky2 + kz2) * S_ck)
                          * inv_k2)
            self._C22 = t(I * _c2 * kz * (ky2 * dt + (kx2 + kz2) * S_ck)
                          * inv_k2)
        else:
            # C23..C25 (:292-294)
            self._C23 = t(I * _c2 * kx * S_ck)
            self._C24 = t(I * _c2 * ky * S_ck)
            self._C25 = t(I * _c2 * kz * S_ck)

        if self.is_galilean:
            # T2 = exp(i w_c dt), w_c on the CENTERED modified k (:428-441)
            w_c = np.zeros(self.n_fft)
            for d in range(ndim):
                vg = v_galilean[_ACTIVE[ndim][d]]
                if vg == 0.0:
                    continue
                kc = modified_k(ks[d], geom.dx[d], n_order, True)
                w_c = w_c + _bcast(kc, d, ndim) * vg
            self._T2 = t(np.exp(I * w_c * dt))
        else:
            self._T2 = 1.0

    def split_dirs(self, comp: str) -> tuple:
        return pml_split_dirs(comp, self.cleaning)

    def _fwd(self, arr: torch.Tensor, comp: str) -> torch.Tensor:
        F = torch.fft.fftn(arr)
        for d in range(self.geom.ndim):
            if self.staggering[comp][d] == 0:
                F = F * self._shift_fwd[d]
        return F

    def _bwd(self, F: torch.Tensor, comp: str) -> torch.Tensor:
        for d in range(self.geom.ndim):
            if self.staggering[comp][d] == 0:
                F = F * self._shift_bwd[d]
        return torch.fft.ifftn(F).real.contiguous()

    def push(self, splits: Dict) -> Dict:
        """One PML-PSATD step on {(comp, dir): real tensor} splits."""
        K = {key: self._fwd(arr, key[0]) for key, arr in splits.items()}

        def tot(nm):
            s = None
            for key, v in K.items():
                if key[0] == nm:
                    s = v if s is None else s + v
            return s

        Ex, Ey, Ez = tot("Ex"), tot("Ey"), tot("Ez")
        Bx, By, Bz = tot("Bx"), tot("By"), tot("Bz")
        T2 = self._T2
        C1, C2, C3 = self._C1, self._C2, self._C3
        C4, C5, C6 = self._C4, self._C5, self._C6
        C7, C8, C9 = self._C7, self._C8, self._C9
        out = {}
        if not self.cleaning:
            Exy, Exz = K[("Ex", "y")], K[("Ex", "z")]
            Eyx, Eyz = K[("Ey", "x")], K[("Ey", "z")]
            Ezx, Ezy = K[("Ez", "x")], K[("Ez", "y")]
            Bxy, Bxz = K[("Bx", "y")], K[("Bx", "z")]
            Byx, Byz = K[("By", "x")], K[("By", "z")]
            Bzx, Bzy = K[("Bz", "x")], K[("Bz", "y")]
            C10, C11, C12, C13 = self._C10, self._C11, self._C12, self._C13
            C14, C15, C16 = self._C14, self._C15, self._C16
            C17, C18, C19 = self._C17, self._C18, self._C19
            C20, C21, C22 = self._C20, self._C21, self._C22
            # (PsatdAlgorithmPml.cpp:252-287)
            out[("Ex", "y")] = T2 * (C2 * Exy + C5 * Exz + C9 * Ey
                                     + C10 * Bx + C11 * By + C19 * Bz)
            out[("Ex", "z")] = T2 * (C6 * Exy + C3 * Exz + C8 * Ez
                                     - C10 * Bx - C22 * By - C12 * Bz)
            out[("Ey", "z")] = T2 * (C3 * Eyz + C6 * Eyx + C7 * Ez
                                     + C21 * Bx + C10 * By + C13 * Bz)
            out[("Ey", "x")] = T2 * (C9 * Ex + C4 * Eyz + C1 * Eyx
                                     - C14 * Bx - C10 * By - C18 * Bz)
            out[("Ez", "x")] = T2 * (C8 * Ex + C1 * Ezx + C4 * Ezy
                                     + C15 * Bx + C17 * By + C10 * Bz)
            out[("Ez", "y")] = T2 * (C7 * Ey + C5 * Ezx + C2 * Ezy
                                     - C20 * Bx - C16 * By - C10 * Bz)
            out[("Bx", "y")] = T2 * (C2 * Bxy + C5 * Bxz + C9 * By
                                     - (C10 * Ex + C11 * Ey + C19 * Ez) / _c2)
            out[("Bx", "z")] = T2 * (C6 * Bxy + C3 * Bxz + C8 * Bz
                                     + (C10 * Ex + C22 * Ey + C12 * Ez) / _c2)
            out[("By", "z")] = T2 * (C3 * Byz + C6 * Byx + C7 * Bz
                                     - (C21 * Ex + C10 * Ey + C13 * Ez) / _c2)
            out[("By", "x")] = T2 * (C9 * Bx + C4 * Byz + C1 * Byx
                                     + (C14 * Ex + C10 * Ey + C18 * Ez) / _c2)
            out[("Bz", "x")] = T2 * (C8 * Bx + C1 * Bzx + C4 * Bzy
                                     - (C15 * Ex + C17 * Ey + C10 * Ez) / _c2)
            out[("Bz", "y")] = T2 * (C7 * By + C5 * Bzx + C2 * Bzy
                                     + (C20 * Ex + C16 * Ey + C10 * Ez) / _c2)
        else:
            F, G = tot("F"), tot("G")
            Exx, Exy, Exz = K[("Ex", "x")], K[("Ex", "y")], K[("Ex", "z")]
            Eyx, Eyy, Eyz = K[("Ey", "x")], K[("Ey", "y")], K[("Ey", "z")]
            Ezx, Ezy, Ezz = K[("Ez", "x")], K[("Ez", "y")], K[("Ez", "z")]
            Bxx, Bxy, Bxz = K[("Bx", "x")], K[("Bx", "y")], K[("Bx", "z")]
            Byx, Byy, Byz = K[("By", "x")], K[("By", "y")], K[("By", "z")]
            Bzx, Bzy, Bzz = K[("Bz", "x")], K[("Bz", "y")], K[("Bz", "z")]
            Fx, Fy, Fz = K[("F", "x")], K[("F", "y")], K[("F", "z")]
            Gx, Gy, Gz = K[("G", "x")], K[("G", "y")], K[("G", "z")]
            C23, C24, C25 = self._C23, self._C24, self._C25
            # (PsatdAlgorithmPml.cpp:296-371)
            out[("Ex", "x")] = T2 * (C1 * Exx + C4 * Exy + C4 * Exz
                                     - C9 * Ey - C8 * Ez + C23 * F)
            out[("Ex", "y")] = T2 * (C5 * Exx + C2 * Exy + C5 * Exz
                                     + C9 * Ey + C24 * Bz - C7 * G)
            out[("Ex", "z")] = T2 * (C6 * Exx + C6 * Exy + C3 * Exz
                                     + C8 * Ez - C25 * By + C7 * G)
            out[("Ey", "x")] = T2 * (C9 * Ex + C1 * Eyx + C4 * Eyy
                                     + C4 * Eyz - C23 * Bz + C8 * G)
            out[("Ey", "y")] = T2 * (-C9 * Ex + C5 * Eyx + C2 * Eyy
                                     + C5 * Eyz - C7 * Ez + C24 * F)
            out[("Ey", "z")] = T2 * (C6 * Eyx + C6 * Eyy + C3 * Eyz
                                     + C7 * Ez + C25 * Bx - C8 * G)
            out[("Ez", "x")] = T2 * (C8 * Ex + C1 * Ezx + C4 * Ezy
                                     + C4 * Ezz + C23 * By - C9 * G)
            out[("Ez", "y")] = T2 * (C7 * Ey + C5 * Ezx + C2 * Ezy
                                     + C5 * Ezz - C24 * Bx + C9 * G)
            out[("Ez", "z")] = T2 * (-C8 * Ex - C7 * Ey + C6 * Ezx
                                     + C6 * Ezy + C3 * Ezz + C25 * F)
            out[("Bx", "x")] = T2 * (C1 * Bxx + C4 * Bxy + C4 * Bxz
                                     - C9 * By - C8 * Bz + C23 / _c2 * G)
            out[("Bx", "y")] = T2 * (-C24 / _c2 * Ez + C5 * Bxx + C2 * Bxy
                                     + C5 * Bxz + C9 * By + C7 * F)
            out[("Bx", "z")] = T2 * (C25 / _c2 * Ey + C6 * Bxx + C6 * Bxy
                                     + C3 * Bxz + C8 * Bz - C7 * F)
            out[("By", "x")] = T2 * (C23 / _c2 * Ez + C9 * Bx + C1 * Byx
                                     + C4 * Byy + C4 * Byz - C8 * F)
            out[("By", "y")] = T2 * (-C9 * Bx + C5 * Byx + C2 * Byy
                                     + C5 * Byz - C7 * Bz + C24 / _c2 * G)
            out[("By", "z")] = T2 * (-C25 / _c2 * Ex + C6 * Byx + C6 * Byy
                                     + C3 * Byz + C7 * Bz + C8 * F)
            out[("Bz", "x")] = T2 * (-C23 / _c2 * Ey + C8 * Bx + C1 * Bzx
                                     + C4 * Bzy + C4 * Bzz + C9 * F)
            out[("Bz", "y")] = T2 * (C24 / _c2 * Ex + C7 * By + C5 * Bzx
                                     + C2 * Bzy + C5 * Bzz - C9 * F)
            out[("Bz", "z")] = T2 * (-C8 * Bx - C7 * By + C6 * Bzx
                                     + C6 * Bzy + C3 * Bzz + C25 / _c2 * G)
            out[("F", "x")] = T2 * (C23 / _c2 * Ex + C8 * By - C9 * Bz
                                    + C1 * Fx + C4 * Fy + C4 * Fz)
            out[("F", "y")] = T2 * (C24 / _c2 * Ey - C7 * Bx + C9 * Bz
                                    + C5 * Fx + C2 * Fy + C5 * Fz)
            out[("F", "z")] = T2 * (C25 / _c2 * Ez + C7 * Bx - C8 * By
                                    + C6 * Fx + C6 * Fy + C3 * Fz)
            out[("G", "x")] = T2 * (-C8 * Ey + C9 * Ez + C23 * Bx
                                    + C1 * Gx + C4 * Gy + C4 * Gz)
            out[("G", "y")] = T2 * (C7 * Ex - C9 * Ez + C24 * By
                                    + C5 * Gx + C2 * Gy + C5 * Gz)
            out[("G", "z")] = T2 * (-C7 * Ex + C8 * Ey + C25 * Bz
                                    + C6 * Gx + C6 * Gy + C3 * Gz)

        return {key: self._bwd(torch.where(self._knz, v, K[key]), key[0])
                for key, v in out.items()}
