"""RZ spectral (Hankel) PSATD solver.

The counterpart of ``warpx_tpu.rz.spectral`` (reference:
Source/FieldSolver/SpectralSolver/SpectralHankelTransform/ and
SpectralAlgorithms/PsatdAlgorithmRZ.cpp, PsatdAlgorithmGalileanRZ.cpp):

* the radial discrete Hankel transform is a dense (nk, nr) matrix product
  per azimuthal mode (the reference calls blas::gemm,
  HankelTransform.cpp:216-230); the matrices are built on the host in
  float64 with scipy's Bessel roots and functions and numpy's
  (pseudo-)inverses, exactly following HankelTransform.cpp:42-185, and
  cast to the run's type once;
* vector fields transform as the +/- circular combinations
  (F_r -/+ i F_t) / 2 with Hankel orders m + 1 and m - 1
  (SpectralHankelTransformer.cpp:86-131, 157-202);
* z is a complex FFT with the finite-order modified kz and the
  cell-centered half-shift (SpectralFieldDataRZ.cpp:54-60, 316-335);
* every component is stored cell-centered (WarpX.cpp:2153-2160);
* the k-space update is PsatdAlgorithmRZ::pushSpectralFields (:79-290)
  with update-with-rho, the RZ current correction (:424-487) and the
  Galilean coefficients.

The mode packing is ``rz/core.py``'s: component 0 is mode 0, components
(2m - 1, 2m) the cos/sin coefficients of mode m.  The transforms run as
real matrix products of the real and imaginary parts together
(``torch.matmul``, as the JAX package's dense einsum); no fused kernel lies
on this path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import c as _c, ep0 as _ep0
from ..core.state import SimState
from ..ops.push import PUSHERS
from ..ops.shapes import shape_weights
from ..solvers.psatd import modified_k
from .core import (_ATTR, _extend_axis, _fold_and_scale_modes, _idx,
                   _phases, _scatter_rz, _trig, field_shape, gather_rz,
                   rz_stagger)

__all__ = ["HankelTransform", "PsatdRZ", "RZSpectralStepper",
           "deposit_cc_rz", "bilinear_filter_rz", "rz_spectral_aux_fields"]

_c2 = _c * _c
_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


class HankelTransform:
    """The quasi-discrete Hankel transform of one (hankel_order, mode) pair
    (JAX spectral.py:49-99): physical samples at dr (ir + 1/2), spectral
    samples at kr = alpha_k / rmax with alpha_k the roots of J_mode (the
    trivial root included for mode > 0); ``Mf`` (nk, nr) forward, ``Mb``
    (nr, nk) backward, float64 numpy arrays."""

    def __init__(self, hankel_order: int, azimuthal_mode: int, nr: int,
                 rmax: float):
        from scipy.special import jn_zeros, jv

        p, m = hankel_order, azimuthal_mode
        assert m - 1 <= p <= m + 1
        nk = nr
        if m == 0:
            alphas = jn_zeros(0, nk)
        else:
            # the trivial root included (BesselRoots.cpp:105-124)
            alphas = np.concatenate([[0.0], jn_zeros(m, nk - 1)])
        kr = alphas / rmax
        dr = rmax / nr
        rmesh = dr * (np.arange(nr) + 0.5)

        # invM (spectral -> physical), imposed by the DHT of Bessel modes
        # (HankelTransform.cpp:64-119), as Mb[ir, ik]
        p_denom = p + 1 if p == m else p
        denom = np.pi * rmax * rmax * jv(p_denom, alphas) ** 2
        num = jv(p, np.outer(rmesh, kr))
        Mb = np.zeros((nr, nk))
        if m > 0:
            Mb[:, 1:] = num[:, 1:] / denom[None, 1:]
            if p == m - 1:
                # the extra kperp = 0 mode closing the curl/div algebra
                # (:96-104)
                Mb[:, 0] = rmesh ** (m - 1) / (np.pi * rmax ** (m + 1))
        else:
            Mb[:, :] = num / denom[None, :]

        # M (physical -> spectral): the inverse, or the Moore-Penrose
        # pseudo-inverse past the zero k = 0 column in the singular case
        # (:122-185)
        if m != 0 and p != m - 1:
            Mf = np.zeros((nk, nr))
            Mf[1:, :] = np.linalg.pinv(Mb[:, 1:])
        else:
            Mf = np.linalg.inv(Mb)
        self.kr = kr
        self.Mf = Mf
        self.Mb = Mb


class PsatdRZ:
    """The multi-mode RZ spectral solver: the transforms and the k-space
    push (JAX spectral.py:102-367), its tables on ``device`` in the run's
    precision."""

    def __init__(self, cfg, dtype, device):
        geom = cfg.geometry
        nr, nz = geom.n_cell
        rmax = geom.prob_hi[0]
        if geom.prob_lo[0] != 0.0:
            raise NotImplementedError("RZ spectral requires rmin = 0")
        nmodes = cfg.n_rz_modes
        dz = geom.dx[1]
        dt = cfg.dt
        self.cfg = cfg
        self.nmodes = nmodes
        self.dtype = dtype
        self.cdtype = _COMPLEX[dtype]
        self.device = torch.device(device)
        self.update_with_rho = cfg.psatd_update_with_rho
        self.current_correction = cfg.psatd_current_correction
        self.v_gal = cfg.psatd_v_galilean[2]
        self.is_galilean = self.v_gal != 0.0

        def real(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype)

        def cplx(a):
            return torch.from_numpy(np.asarray(a, np.complex128)).to(
                device=self.device, dtype=self.cdtype)

        # per-mode transforms (SpectralHankelTransformer.cpp:23-27)
        dht0 = [HankelTransform(m, m, nr, rmax) for m in range(nmodes)]
        dhtp = [HankelTransform(m + 1, m, nr, rmax) for m in range(nmodes)]
        dhtm = [HankelTransform(m - 1, m, nr, rmax) for m in range(nmodes)]

        def stack(hs, a):
            return real(np.stack([getattr(h, a) for h in hs]))

        self._Mf0, self._Mb0 = stack(dht0, "Mf"), stack(dht0, "Mb")
        self._Mfp, self._Mbp = stack(dhtp, "Mf"), stack(dhtp, "Mb")
        self._Mfm, self._Mbm = stack(dhtm, "Mf"), stack(dhtm, "Mb")
        kr = np.stack([h.kr for h in dht0])  # (nmodes, nk)

        # the modified kz and the cell-centered shift
        # (SpectralFieldDataRZ.cpp:54-60); the Fornberg family follows
        # warpx.grid_type
        kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=dz)
        kz_mod = modified_k(kz, dz, cfg.psatd_order,
                            cfg.grid_type == "collocated")
        self._zshift_fwd = cplx(np.exp(-1j * kz * 0.5 * dz))
        self._zshift_bwd = cplx(np.exp(+1j * kz * 0.5 * dz))

        # the coefficients (PsatdAlgorithmRZ.cpp:336-420), (nmodes, nk, nz)
        krb = kr[:, :, None]
        kzb = kz_mod[None, None, :]
        k_norm = np.sqrt(krb * krb + kzb * kzb)
        nzr = k_norm != 0.0
        g = np.where(nzr, k_norm, 1.0)
        C = np.where(nzr, np.cos(_c * k_norm * dt), 1.0)
        S_ck = np.where(nzr, np.sin(_c * k_norm * dt) / (_c * g), dt)
        X1 = np.where(nzr, (1.0 - C) / (_ep0 * _c2 * g * g),
                      0.5 * dt * dt / _ep0)
        X2 = np.where(nzr, (1.0 - S_ck / dt) / (_ep0 * g * g),
                      _c2 * dt * dt / (6.0 * _ep0))
        X3 = np.where(nzr, (C - S_ck / dt) / (_ep0 * g * g),
                      -_c2 * dt * dt / (3.0 * _ep0))
        self._kr = real(krb + np.zeros_like(k_norm))
        self._kz = real(kzb + np.zeros_like(k_norm))
        self._k2 = real(k_norm * k_norm)
        self._C = real(C)
        self._S = real(S_ck)
        coef = real
        if self.is_galilean:
            # the Galilean RZ coefficients
            # (PsatdAlgorithmGalileanRZ.cpp:208-288)
            vz = self.v_gal
            kzf = kzb + np.zeros_like(k_norm)
            kv = kzf * vz
            g2 = g * g
            nu = kv / (_c * g)
            theta = np.exp(0.5j * kv * dt)
            theta_star = np.conj(theta)
            e_theta = np.exp(1j * _c * k_norm * dt)
            T2 = theta * theta
            T_rho = np.where(
                kzf == 0.0, -dt,
                (1.0 - T2) / np.where(kzf == 0, 1.0, 1j * kzf * vz))
            # the main branch (nu != 0, 1)
            one_m_nu2 = np.where(nu * nu == 1.0, 1.0, 1.0 - nu * nu)
            x1 = (theta_star - C * theta + 1j * kv * S_ck * theta) / one_m_nu2
            X1_g = theta * x1 / (_ep0 * _c2 * g2)
            dth = np.where(theta_star == theta, 1.0, theta_star - theta)
            X2_g = (x1 - theta * (1.0 - C)) / (dth * _ep0 * g2)
            X3_g = (x1 - theta_star * (1.0 - C)) / (dth * _ep0 * g2)
            X4_g = 1j * kv * X1_g - T2 * S_ck / _ep0
            # nu == 0: the standard coefficients
            X1_0 = (1.0 - C) / (_ep0 * _c2 * g2)
            X2_0 = (1.0 - S_ck / dt) / (_ep0 * g2)
            X3_0 = (C - S_ck / dt) / (_ep0 * g2)
            X4_0 = -S_ck / _ep0 + 0j
            # nu == 1: the resonant branch
            et2 = e_theta * e_theta
            em1 = np.where(e_theta == 1.0, 1.0, e_theta - 1.0)
            X1_r = (1.0 - et2 + 2j * _c * k_norm * dt) / (4.0 * _c2 * _ep0
                                                          * g2)
            X2_r = (3.0 - 4.0 * e_theta + et2 + 2j * _c * k_norm * dt) / (
                4.0 * _ep0 * g2 * np.where(e_theta == 1.0, 1.0, 1.0 - e_theta))
            X3_r = (3.0 - 2.0 / e_theta - 2.0 * e_theta + et2
                    - 2j * _c * k_norm * dt) / (4.0 * _ep0 * em1 * g2)
            X4_r = 1j * (-1.0 + et2 + 2j * _c * k_norm * dt) / (
                4.0 * _ep0 * _c * g)
            res = nu == 1.0
            zero = nu == 0.0
            X1 = np.select([res, zero], [X1_r, X1_0], X1_g)
            X2 = np.select([res, zero], [X2_r, X2_0], X2_g)
            X3 = np.select([res, zero], [X3_r, X3_0], X3_g)
            X4 = np.select([res, zero], [X4_r, X4_0], X4_g)
            T2 = np.where(nzr, T2, 1.0)
            X1 = np.where(nzr, X1, 0.5 * dt * dt / _ep0)
            X2 = np.where(nzr, X2, _c2 * dt * dt / (6.0 * _ep0))
            X3 = np.where(nzr, X3, -_c2 * dt * dt / (3.0 * _ep0))
            X4 = np.where(nzr, X4, -dt / _ep0)
            self._T2 = cplx(T2)
            self._X4 = cplx(X4)
            self._T_rho = cplx(T_rho)
            coef = cplx
        self._X1 = coef(X1)
        self._X2 = coef(X2)
        self._X3 = coef(X3)
        self.dt = dt

    # ---------------------------------------------------------- transforms
    def _pack(self, arr):
        """(C, NR, NZ) real pairs -> (nmodes, NR, NZ) complex amplitudes."""
        modes = [torch.complex(arr[0], torch.zeros_like(arr[0]))]
        for m in range(1, self.nmodes):
            modes.append(torch.complex(arr[2 * m - 1], arr[2 * m]))
        return torch.stack(modes)

    def _unpack(self, modes, dtype):
        comps = [modes[0].real.to(dtype)]
        for m in range(1, self.nmodes):
            comps.append(modes[m].real.to(dtype))
            comps.append(modes[m].imag.to(dtype))
        return torch.stack(comps)

    @staticmethod
    def _apply(mat, u):
        """The real (nmodes, a, b) matrices times the complex (nmodes, b,
        nz) amplitudes: one real product of both parts together."""
        m, b, nz = u.shape
        ri = torch.view_as_real(u.contiguous()).reshape(m, b, 2 * nz)
        out = torch.matmul(mat, ri)
        return torch.view_as_complex(out.reshape(m, mat.shape[1], nz, 2))

    def _zfft(self, u):
        return torch.fft.fft(u, dim=-1) * self._zshift_fwd

    def _izfft(self, U):
        return torch.fft.ifft(U * self._zshift_bwd, dim=-1)

    def fwd_scalar(self, arr):
        return self._zfft(self._apply(self._Mf0, self._pack(arr)))

    def bwd_scalar(self, U, dtype):
        return self._unpack(self._apply(self._Mb0, self._izfft(U)), dtype)

    def fwd_vector(self, arr_r, arr_t):
        ur, ut = self._pack(arr_r), self._pack(arr_t)
        up = 0.5 * (ur - 1j * ut)
        um = 0.5 * (ur + 1j * ut)
        return (self._zfft(self._apply(self._Mfp, up)),
                self._zfft(self._apply(self._Mfm, um)))

    def bwd_vector(self, Gp, Gm, dtype):
        up = self._apply(self._Mbp, self._izfft(Gp))
        um = self._apply(self._Mbm, self._izfft(Gm))
        # F_r = G_p + G_m; F_t = i (G_p - G_m)
        # (SpectralHankelTransformer.cpp:192-199)
        return (self._unpack(up + um, dtype),
                self._unpack(1j * (up - um), dtype))

    # ---------------------------------------------------------------- push
    def push(self, fields, rho_pair=None):
        """One spectral step of the cell-centered mode arrays."""
        dtype = fields.Ex.dtype
        Ep, Em = self.fwd_vector(fields.Ex, fields.Ey)
        Ez = self.fwd_scalar(fields.Ez)
        Bp, Bm = self.fwd_vector(fields.Bx, fields.By)
        Bz = self.fwd_scalar(fields.Bz)
        Jp, Jm = self.fwd_vector(fields.jx, fields.jy)
        Jz = self.fwd_scalar(fields.jz)
        rho_old = rho_new = None
        if rho_pair is not None:
            rho_old = self.fwd_scalar(rho_pair[0])
            rho_new = self.fwd_scalar(rho_pair[1])

        kr, kz = self._kr, self._kz
        C, S, X1, X2, X3 = self._C, self._S, self._X1, self._X2, self._X3
        dt = self.dt
        I = 1j  # noqa: E741
        inv_ep0 = 1.0 / _ep0

        corrected = None
        if self.current_correction:
            k2 = self._k2
            k2g = torch.where(k2 == 0, torch.ones_like(k2), k2)
            if self.is_galilean:
                # (PsatdAlgorithmGalileanRZ.cpp:345-356)
                vz = self.v_gal
                theta2 = torch.exp(I * kz * vz * dt)
                kv = kz * vz
                inv_1_T2 = 1.0 / torch.where(
                    kv == 0.0, torch.ones_like(theta2), 1.0 - theta2)
                j_coef = torch.where(kz == 0.0,
                                     torch.full_like(theta2, 1.0 / dt),
                                     -I * kz * vz * inv_1_T2)
                F = -(j_coef * (rho_new - rho_old * theta2)
                      + I * kz * Jz + kr * (Jp - Jm)) / k2g
            else:
                # (PsatdAlgorithmRZ.cpp:458-486)
                F = -((rho_new - rho_old) / dt + I * kz * Jz
                      + kr * (Jp - Jm)) / k2g
            F = torch.where(k2 != 0.0, F, torch.zeros_like(F))
            Jp = Jp + 0.5 * kr * F
            Jm = Jm - 0.5 * kr * F
            Jz = Jz - I * kz * F
            jr_c, jt_c = self.bwd_vector(Jp, Jm, dtype)
            corrected = {"jx": jr_c, "jy": jt_c,
                         "jz": self.bwd_scalar(Jz, dtype)}

        if self.is_galilean:
            # (PsatdAlgorithmGalileanRZ.cpp:138-174)
            T2, X4, T_rho = self._T2, self._X4, self._T_rho
            if self.update_with_rho:
                rho_diff = X2 * rho_new - T2 * X3 * rho_old
            else:
                divE = kr * (Ep - Em) + I * kz * Ez
                divJ = kr * (Jp - Jm) + I * kz * Jz
                rho_diff = T2 * (X2 - X3) * _ep0 * divE + T_rho * X2 * divJ
            Ep_new = (T2 * C * Ep
                      + T2 * S * (-_c2 * I * kr * 0.5 * Bz + _c2 * kz * Bp)
                      + X4 * Jp + 0.5 * kr * rho_diff)
            Em_new = (T2 * C * Em
                      + T2 * S * (-_c2 * I * kr * 0.5 * Bz - _c2 * kz * Bm)
                      + X4 * Jm - 0.5 * kr * rho_diff)
            Ez_new = (T2 * C * Ez
                      + T2 * S * (_c2 * I * kr * Bp + _c2 * I * kr * Bm)
                      + X4 * Jz - I * kz * rho_diff)
            Bp_new = (T2 * C * Bp - T2 * S * (-I * kr * 0.5 * Ez + kz * Ep)
                      + X1 * (-I * kr * 0.5 * Jz + kz * Jp))
            Bm_new = (T2 * C * Bm - T2 * S * (-I * kr * 0.5 * Ez - kz * Em)
                      + X1 * (-I * kr * 0.5 * Jz - kz * Jm))
            Bz_new = (T2 * C * Bz - T2 * S * I * (kr * Ep + kr * Em)
                      + X1 * I * (kr * Jp + kr * Jm))
        else:
            if self.update_with_rho:
                rho_diff = X2 * rho_new - X3 * rho_old
            else:
                divE = kr * (Ep - Em) + I * kz * Ez
                divJ = kr * (Jp - Jm) + I * kz * Jz
                rho_diff = (X2 - X3) * _ep0 * divE - X2 * dt * divJ
            # (PsatdAlgorithmRZ.cpp:205-224)
            Ep_new = (C * Ep
                      + S * (-_c2 * I * kr * 0.5 * Bz + _c2 * kz * Bp
                             - inv_ep0 * Jp)
                      + 0.5 * kr * rho_diff)
            Em_new = (C * Em
                      + S * (-_c2 * I * kr * 0.5 * Bz - _c2 * kz * Bm
                             - inv_ep0 * Jm)
                      - 0.5 * kr * rho_diff)
            Ez_new = (C * Ez
                      + S * (_c2 * I * kr * Bp + _c2 * I * kr * Bm
                             - inv_ep0 * Jz)
                      - I * kz * rho_diff)
            Bp_new = (C * Bp - S * (-I * kr * 0.5 * Ez + kz * Ep)
                      + X1 * (-I * kr * 0.5 * Jz + kz * Jp))
            Bm_new = (C * Bm - S * (-I * kr * 0.5 * Ez - kz * Em)
                      + X1 * (-I * kr * 0.5 * Jz - kz * Jm))
            Bz_new = (C * Bz - S * I * (kr * Ep + kr * Em)
                      + X1 * I * (kr * Jp + kr * Jm))

        er, et = self.bwd_vector(Ep_new, Em_new, dtype)
        br, bt = self.bwd_vector(Bp_new, Bm_new, dtype)
        out = fields.replace(
            Ex=er, Ey=et, Ez=self.bwd_scalar(Ez_new, dtype),
            Bx=br, By=bt, Bz=self.bwd_scalar(Bz_new, dtype))
        if corrected is not None:
            out = out.replace(**corrected)
        return out


# ------------------------------------------------------- direct deposition
def deposit_cc_rz(pos3, w, q, cfg, order, ng, dtype, vel=None, dt=None,
                  z_origin=None):
    """Direct deposition at the cell centers, every azimuthal mode (JAX
    spectral.py:371-443): ``vel = None`` deposits rho; ``vel = (ux, uy,
    uz)`` deposits (jr, jt, jz) at the mid position x - dt v / 2 with the
    phases and the rotation taken there (CurrentDeposition.H
    doDepositionShapeN RZ branch).  ``z_origin`` replaces the z origin (the
    Galilean grid at the source's own time).  Returns the scaled
    (C, NR, NZ) arrays."""
    geom = cfg.geometry
    dr, dz = geom.dx
    rmin, zmin = geom.prob_lo
    if z_origin is not None:
        zmin = z_origin
    nr, nz = geom.n_cell
    nmodes = cfg.n_rz_modes
    ncomp = 2 * nmodes - 1
    x, y, z = pos3
    if vel is not None:
        ux, uy, uz = vel
        gaminv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) / _c2)
        x = x - 0.5 * dt * ux * gaminv
        y = y - 0.5 * dt * uy * gaminv
        z = z - 0.5 * dt * uz * gaminv
    r = torch.sqrt(x * x + y * y)
    c0, s0 = _trig(x, y, r)
    # 2 e^{i m theta}: the factor 2 scales exactly
    phases2 = [(2.0 * pc, 2.0 * ps) for pc, ps in _phases(c0, s0, nmodes)]
    # the cell-centered targets: a half-cell offset in r and z
    rg = (r - rmin) / dr - 0.5
    zg = (z - zmin) / dz - 0.5
    i0, wr = shape_weights(rg, order)
    k0, wz = shape_weights(zg, order)
    wq = (q / (dr * dz)) * w
    if vel is None:
        vals3 = [wq]
        names, kinds = ["rho"], ["rho"]
    else:
        vr = (ux * c0 + uy * s0) * gaminv
        vt = (-ux * s0 + uy * c0) * gaminv
        vz = uz * gaminv
        vals3 = [wq * vr, wq * vt, wq * vz]
        names, kinds = ["jr", "jt", "jz"], ["r", "t", "z"]
    exts = [torch.zeros((ncomp, nr + 2 * ng, nz), dtype=dtype,
                        device=w.device) for _ in vals3]
    zcols = [torch.remainder(k0 + b, nz) for b in range(order + 1)]
    for a, wa in enumerate(wr):
        rbase = torch.clamp(i0 + (a + ng), 0, nr + 2 * ng - 1) * nz
        bases = [base * wa for base in vals3]
        for b, wb in enumerate(wz):
            lin = _idx(rbase + zcols[b])
            for base_a, ext in zip(bases, exts):
                val = base_a * wb
                _scatter_rz(ext[0], lin, val)
                for m in range(1, nmodes):
                    pc2, ps2 = phases2[m]
                    _scatter_rz(ext[2 * m - 1], lin, val * pc2)
                    _scatter_rz(ext[2 * m], lin, val * ps2)
    outs = [_fold_and_scale_modes(ext, nm, cfg, ng, kind)
            for ext, nm, kind in zip(exts, names, kinds)]
    return outs[0] if vel is None else tuple(outs)


def bilinear_filter_rz(arr, name, cfg, npass=1, npass_each=None):
    """The [1/4, 1/2, 1/4] filter in (r, z) of a scaled (C, NR, NZ) mode
    array (the reference filters the volume-scaled J and rho; JAX
    spectral.py:446-474): the below-axis guard rows take the mode and
    component parity, beyond rmax zeros; ``npass_each`` = (r passes, z
    passes) as warpx.filter_npass_each_dir; bounded z pads zero guards."""
    parity_name = {"jr": "Er", "jt": "Et", "jz": "Ez"}.get(name, name)
    nodal_r = rz_stagger(cfg, name)[0] == 1
    n_r, n_z = (npass, npass) if npass_each is None else tuple(npass_each)
    per_z = cfg.geometry.periodic[1]
    for _ in range(n_r):
        ext = _extend_axis(arr, parity_name, 1, nodal_r=nodal_r)
        arr = 0.25 * ext[:, :-2] + 0.5 * ext[:, 1:-1] + 0.25 * ext[:, 2:]
    for _ in range(n_z):
        if per_z:
            arr = (0.25 * torch.roll(arr, 1, -1) + 0.5 * arr
                   + 0.25 * torch.roll(arr, -1, -1))
        else:
            zero = arr.new_zeros(arr.shape[:-1] + (1,))
            ext = torch.cat([zero, arr, zero], dim=-1)
            arr = (0.25 * ext[..., :-2] + 0.5 * ext[..., 1:-1]
                   + 0.25 * ext[..., 2:])
    return arr


# ------------------------------------------------------------ the stepper
class RZSpectralStepper:
    """The RZ spectral PSATD loop (the JAX package's
    ``make_rz_spectral_step``, spectral.py:478-602) on the periodic z
    domain: gather and push, the Galilean drifted z origins with each
    source at its own time, the direct cell-centered deposit, the filter
    and ``PsatdRZ.push``; ``solver`` is the run's ``PsatdRZ``."""

    def __init__(self, cfg, dtype, device):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.dt = cfg.dt
        self.order = cfg.particle_shape
        self.ng = self.order + 2
        self.solver = PsatdRZ(cfg, dtype, device)
        self.need_rho = (cfg.psatd_update_with_rho
                         or cfg.psatd_current_correction)
        self.v_gal = cfg.psatd_v_galilean[2]

    def gather_all(self, state, pos3, z_origin=None):
        farr = {nm: getattr(state.fields, attr)
                for nm, attr in _ATTR.items()}
        return gather_rz(pos3, farr, self.cfg, self.order, self.ng,
                         z_origin=z_origin)

    def step(self, state: SimState, draws=None) -> SimState:
        cfg = self.cfg
        geom = cfg.geometry
        dt, order, ng, dtype = self.dt, self.order, self.ng, self.dtype
        kw = dict(dtype=dtype, device=self.device)
        # Galilean: drifted z origins, each source at its own time
        # (WarpX::LowerCorner time_shift_delta)
        zlo0 = geom.prob_lo[1]
        v_gal = self.v_gal
        if v_gal != 0.0:
            zo = zlo0 + v_gal * state.time
            zo_h = zo + v_gal * (0.5 * dt)
            zo_n = zo + v_gal * dt
        else:
            zo = zo_h = zo_n = None
        need_rho = self.need_rho
        rho_old = rho_new = None
        if need_rho:
            rho_old = torch.zeros(field_shape(cfg, "rho"), **kw)
            rho_new = torch.zeros(field_shape(cfg, "rho"), **kw)
        j3 = None
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            pos3 = (sp.x, sp.y, sp.z)
            zero = torch.zeros_like(sp.w)
            if need_rho and not sp_cfg.do_not_deposit:
                w_eff = torch.where(sp.alive, sp.w, zero)
                rho_old = rho_old + deposit_cc_rz(
                    pos3, w_eff, sp_cfg.charge, cfg, order, ng, dtype,
                    z_origin=zo)
            e6 = self.gather_all(state, pos3, z_origin=zo)
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass, dt)
            del e6
            gi = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) / _c2)
            xn = sp.x + ux * gi * dt
            yn = sp.y + uy * gi * dt
            zn = sp.z + uz * gi * dt
            del gi
            # the wrap into the drifted periodic box (ShiftGalileanBoundary)
            zlo = zlo0 if zo_n is None else zo_n
            zhi = zlo + (geom.prob_hi[1] - zlo0)
            zn = zlo + torch.remainder(zn - zlo, zhi - zlo)
            rnew = torch.sqrt(xn * xn + yn * yn)
            alive = sp.alive & (rnew < geom.prob_hi[0])
            del rnew
            if not sp_cfg.do_not_deposit:
                w_dep = torch.where(sp.alive, sp.w, zero)
                jr, jt, jz = deposit_cc_rz(
                    (xn, yn, zn), w_dep, sp_cfg.charge, cfg, order, ng,
                    dtype, vel=(ux, uy, uz), dt=dt, z_origin=zo_h)
                j3 = (jr, jt, jz) if j3 is None else (
                    j3[0] + jr, j3[1] + jt, j3[2] + jz)
            if need_rho and not sp_cfg.do_not_deposit:
                w_al = torch.where(alive, sp.w, zero)
                rho_new = rho_new + deposit_cc_rz(
                    (xn, yn, zn), w_al, sp_cfg.charge, cfg, order, ng,
                    dtype, z_origin=zo_n)
            sp_out = sp.replace(x=xn, y=yn, z=zn, ux=ux, uy=uy, uz=uz,
                                alive=alive, w=torch.where(alive, sp.w, zero))
            if "theta" in sp.extra:
                # SetParticlePosition stores theta = atan2(y, x) after every
                # push (GetAndSetPosition.H:213)
                sp_out = sp_out.replace(extra={
                    **sp_out.extra,
                    "theta": torch.where(sp.alive, torch.atan2(yn, xn),
                                         sp.extra["theta"])})
            new_species[sp_cfg.name] = sp_out
        if j3 is None:
            j3 = tuple(torch.zeros(field_shape(cfg, nm), **kw)
                       for nm in ("jr", "jt", "jz"))
        if cfg.use_filter:
            npass = max(cfg.filter_npass_each_dir or (1,))
            j3 = tuple(bilinear_filter_rz(a, nm, cfg, npass)
                       for a, nm in zip(j3, ("jr", "jt", "jz")))
            if need_rho:
                rho_old = bilinear_filter_rz(rho_old, "rho", cfg, npass)
                rho_new = bilinear_filter_rz(rho_new, "rho", cfg, npass)
        fields = state.fields.replace(jx=j3[0], jy=j3[1], jz=j3[2])
        rho_pair = (rho_old, rho_new) if need_rho else None
        fields = self.solver.push(fields, rho_pair)
        return state.replace(fields=fields, species=new_species,
                             step=state.step + 1, time=state.time + dt)

    def half_push(self, state: SimState, dt_half) -> SimState:
        """The momenta pushed by ``dt_half``, gathered at the static z
        origin (as the JAX package's ``half_push`` gathers)."""
        new_species = {}
        for sp_cfg in self.cfg.species:
            sp = state.species[sp_cfg.name]
            e6 = self.gather_all(state, (sp.x, sp.y, sp.z))
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass,
                dt_half)
            new_species[sp_cfg.name] = sp.replace(ux=ux, uy=uy, uz=uz)
        return state.replace(species=new_species)


def rz_spectral_aux_fields(state, cfg, solver=None):
    """rho deposited now and the spectral div E as (C, NR, NZ) mode arrays
    for the diagnostics (rho_cp, SpectralSolverRZ::ComputeSpectralDivE;
    JAX spectral.py:605-630)."""
    ref = state.fields.Ex
    dtype = ref.dtype
    order = cfg.particle_shape
    ng = order + 2
    if solver is None:
        solver = PsatdRZ(cfg, dtype, ref.device)
    v_gal = cfg.psatd_v_galilean[2]
    zo = (cfg.geometry.prob_lo[1] + v_gal * float(state.time)
          if v_gal != 0.0 else None)
    rho = torch.zeros(field_shape(cfg, "rho"), dtype=dtype,
                      device=ref.device)
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if not sp_cfg.do_not_deposit:
            w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
            rho = rho + deposit_cc_rz((sp.x, sp.y, sp.z), w_eff,
                                      sp_cfg.charge, cfg, order, ng, dtype,
                                      z_origin=zo)
    Ep, Em = solver.fwd_vector(state.fields.Ex, state.fields.Ey)
    Ez = solver.fwd_scalar(state.fields.Ez)
    D = solver._kr * (Ep - Em) + 1j * solver._kz * Ez
    return {"rho": rho, "divE": solver.bwd_scalar(D, dtype)}

