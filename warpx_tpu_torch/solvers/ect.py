"""ECT (Enlarged Cell Technique) conformal FDTD for embedded boundaries.

The counterpart of ``warpx_tpu.solvers.ect`` (reference: EvolveB.cpp:220-385
EvolveBCartesianECT, EvolveECTRho.cpp, WarpXInitEB.cpp ComputeEdgeLengths /
ComputeFaceAreas / MarkCells, WarpXFaceExtensions.cpp one-way and
eight-way extensions, ApplyBCKCorrection).  The cut geometry and the
borrowing graph are static, so everything combinatorial runs once on the
host in numpy (a copy of the JAX package's helpers): edge fractions from
the node-sampled implicit function (a linear root along each edge),
cut-face areas (the marching-squares polygon of the uncovered region),
the stability threshold S_stab (half the largest edge rectangle), and the
one-way and eight-way borrowing passes in AMReX box order, densified into
one area array per neighbour offset of the 3x3 in-plane ring.

The per-step update (``make_ect_evolve_b``) is dense arithmetic on the
device: Rho = (signed edge-weighted E) / S, the enlarged Rho of an
unstable face = (Rho S + sum_k shift(Rho) borrow_k) / S_mod, the area lent
back, and the B decrement selected by the face's flag.  Faces that even
the eight-way extension cannot stabilize take the BCK correction (the
enlarged area, flag -1) and advance with B -= dt Rho, as in the JAX
package, where the reference freezes them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.expression import compile_expression

__all__ = ["ect_geometry", "cached_ect_geometry", "make_ect_evolve_b"]


# ------------------------------------------------------------ host geometry

def _edge_fraction(p0, p1):
    """Uncovered fraction of an edge from node values (phi > 0 = covered).

    Linear interpolation root, vectorized over arrays (ComputeEdgeLengths)."""
    inside0 = p0 <= 0.0
    inside1 = p1 <= 0.0
    denom = np.where(p0 == p1, 1.0, p0 - p1)
    t = p0 / denom  # crossing parameter from node 0
    frac = np.where(
        inside0 & inside1, 1.0,
        np.where(
            ~inside0 & ~inside1, 0.0,
            np.where(inside0, t, 1.0 - t),
        ),
    )
    # an edge lying exactly IN the EB surface (both endpoints at phi == 0,
    # e.g. a wall plane aligned to the grid) carries tangential E on the
    # PEC surface -> zero length, so that E stays frozen at 0
    frac = np.where((p0 == 0.0) & (p1 == 0.0), 0.0, frac)
    return np.clip(frac, 0.0, 1.0)


def _cut_face_area(c00, c10, c11, c01, phi_c):
    """Uncovered area fraction of one unit face from its corner phis.

    Marching-squares polygon of the {phi <= 0} region with linear edge
    crossings (exact for a planar boundary); the center sample resolves the
    two saddle configurations. Scalar helper — called only on cut faces."""
    corners = [(0.0, 0.0, c00), (1.0, 0.0, c10), (1.0, 1.0, c11),
               (0.0, 1.0, c01)]
    inside = [c[2] <= 0.0 for c in corners]
    n_in = sum(inside)
    if n_in == 0:
        return 0.0
    if n_in == 4:
        return 1.0
    # saddle: two opposite corners inside; the center sample resolves the
    # ambiguous connectivity (marching-squares convention)
    if n_in == 2 and inside[0] == inside[2]:
        joined = phi_c <= 0.0
        if joined:
            # connected band: complement of the two outside corner triangles
            return 1.0 - _outside_saddle(corners)
        # two disconnected inside corner triangles
        area = 0.0
        for a in range(4):
            b, d = (a + 1) % 4, (a + 3) % 4
            if inside[a] and not inside[b] and not inside[d]:
                fa_b = float(_edge_fraction(corners[a][2], corners[b][2]))
                fa_d = float(_edge_fraction(corners[a][2], corners[d][2]))
                area += 0.5 * fa_b * fa_d
        return area
    # generic: walk the cycle, emit inside corners + crossings, shoelace
    verts = []
    for a in range(4):
        b = (a + 1) % 4
        xa, ya, pa = corners[a]
        xb, yb, pb = corners[b]
        if pa <= 0.0:
            verts.append((xa, ya))
        if (pa <= 0.0) != (pb <= 0.0):
            t = pa / (pa - pb)
            verts.append((xa + t * (xb - xa), ya + t * (yb - ya)))
    if len(verts) < 3:
        return 0.0
    area = 0.0
    for a in range(len(verts)):
        xa, ya = verts[a]
        xb, yb = verts[(a + 1) % len(verts)]
        area += xa * yb - xb * ya
    return abs(area) * 0.5


def _outside_saddle(corners):
    """Area of the two OUTSIDE corner triangles in the joined saddle."""
    out = 0.0
    for a in range(4):
        b, d = (a + 1) % 4, (a + 3) % 4
        if corners[a][2] > 0.0 and corners[b][2] <= 0.0 \
                and corners[d][2] <= 0.0:
            fa_b = 1.0 - _edge_fraction(corners[a][2], corners[b][2])
            fa_d = 1.0 - _edge_fraction(corners[a][2], corners[d][2])
            out += 0.5 * float(fa_b) * float(fa_d)
    return out


def _face_areas_from_corners(phi4, phi_c):
    """Vectorized cut-face areas: phi4 = (c00, c10, c11, c01) arrays."""
    c00, c10, c11, c01 = phi4
    inside = [(c <= 0.0) for c in (c00, c10, c11, c01)]
    n_in = sum(m.astype(np.int32) for m in inside)
    S = np.where(n_in == 4, 1.0, 0.0)
    cut = (n_in > 0) & (n_in < 4)
    idxs = np.argwhere(cut)
    for idx in idxs:
        t = tuple(idx)
        S[t] = _cut_face_area(
            float(c00[t]), float(c10[t]), float(c11[t]), float(c01[t]),
            float(phi_c[t]),
        )
    return S


_DIRECT = ((-1, 0), (0, -1), (0, 1), (1, 0))
_RING = tuple(
    (a, b) for a in (-1, 0, 1) for b in (-1, 0, 1) if (a, b) != (0, 0)
)


def _plane_axes(d, ndim):
    """In-plane axes of face orientation d and the index-shift mapping of a
    ring offset (v0, v1) (EvolveBCartesianECT's uint8_to_inds branches)."""
    if ndim == 2:
        return (0, 1)  # (x, z); only d == 1 (By) is conformal in 2D
    return {0: (1, 2), 1: (0, 2), 2: (0, 1)}[d]


_GEO_CACHE: Dict = {}


def cached_ect_geometry(expr: str, consts_items, geom, origin) -> Dict:
    """ect_geometry keyed by the deck's implicit function + grid; shared
    between field init (covered entities stay exactly 0, the reference's
    skip-on-covered parser fill, WarpXInitData.cpp:1135) and the step
    kernels, so the cut-cell host computation runs once."""
    key = (expr, tuple(consts_items), geom.n_cell, tuple(origin),
           tuple(geom.dx))
    if key not in _GEO_CACHE:
        fn = compile_expression(expr, ("x", "y", "z"), dict(consts_items))
        axes3 = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}[geom.ndim]

        def phi_at(coords):
            xyz = [np.zeros_like(np.asarray(coords[0])) for _ in range(3)]
            for d in range(geom.ndim):
                xyz[axes3[d]] = np.asarray(coords[d])
            return np.asarray(fn(*xyz), np.float64)

        _GEO_CACHE[key] = ect_geometry(phi_at, geom, tuple(origin))
    return _GEO_CACHE[key]


def ect_geometry(phi_at, geom, origin) -> Dict:
    """Precompute the full ECT geometry from the implicit function.

    phi_at(coords_active) evaluates the deck's eb_implicit_function at a
    list of active-dim coordinate arrays. Returns edge lengths (absolute,
    on the E staggering), per-orientation absolute face areas S, modified
    areas S_mod, info flags (0 unstable / 1 lender / 2 intruded /
    -1 BCK / -2 covered), and dense per-offset borrow-area arrays."""
    ndim = geom.ndim
    dxs = geom.dx
    if ndim not in (2, 3):
        raise NotImplementedError("ECT is 2D-XZ/3D only")

    def nodes(n_pts, d):
        return origin[d] + np.arange(n_pts) * dxs[d]

    n_cell = tuple(geom.n_cell)
    node_coords = [nodes(n_cell[d] + 1, d) for d in range(ndim)]
    mesh = np.meshgrid(*node_coords, indexing="ij")
    phi_n = np.asarray(phi_at([m for m in mesh]), np.float64)

    # ---- edge lengths on the Yee E staggering (absolute units) ----------
    if ndim == 3:
        lx = _edge_fraction(phi_n[:-1, :, :], phi_n[1:, :, :]) * dxs[0]
        ly = _edge_fraction(phi_n[:, :-1, :], phi_n[:, 1:, :]) * dxs[1]
        lz = _edge_fraction(phi_n[:, :, :-1], phi_n[:, :, 1:]) * dxs[2]
        edges = {"Ex": lx, "Ey": ly, "Ez": lz}
    else:
        lx = _edge_fraction(phi_n[:-1, :], phi_n[1:, :]) * dxs[0]
        lz = _edge_fraction(phi_n[:, :-1], phi_n[:, 1:]) * dxs[1]
        # out-of-plane Ey "edges" live at nodes: covered flag only; a node
        # exactly ON the surface carries tangential E -> treated covered
        ly = np.where(phi_n < 0.0, 1.0, 0.0)
        edges = {"Ex": lx, "Ey": ly, "Ez": lz}

    # ---- cut-face areas (absolute) --------------------------------------
    def face_center_phi(d):
        cs = []
        for dd in range(ndim):
            if dd == d:
                cs.append(node_coords[dd])
            else:
                cs.append(node_coords[dd][:-1] + 0.5 * dxs[dd])
        m = np.meshgrid(*cs, indexing="ij")
        return np.asarray(phi_at([a for a in m]), np.float64)

    S = {}
    if ndim == 3:
        dA = {0: dxs[1] * dxs[2], 1: dxs[0] * dxs[2], 2: dxs[0] * dxs[1]}
        corner_slices = {
            0: lambda p: (p[:, :-1, :-1], p[:, 1:, :-1], p[:, 1:, 1:],
                          p[:, :-1, 1:]),
            1: lambda p: (p[:-1, :, :-1], p[1:, :, :-1], p[1:, :, 1:],
                          p[:-1, :, 1:]),
            2: lambda p: (p[:-1, :-1, :], p[1:, :-1, :], p[1:, 1:, :],
                          p[:-1, 1:, :]),
        }
        for d in range(3):
            S[d] = _face_areas_from_corners(
                corner_slices[d](phi_n), face_center_phi(d)
            ) * dA[d]
    else:
        # only the By (out-of-plane) faces are conformal in XZ
        cs = [node_coords[0][:-1] + 0.5 * dxs[0],
              node_coords[1][:-1] + 0.5 * dxs[1]]
        m = np.meshgrid(*cs, indexing="ij")
        phi_cc = np.asarray(phi_at([a for a in m]), np.float64)
        S[1] = _face_areas_from_corners(
            (phi_n[:-1, :-1], phi_n[1:, :-1], phi_n[1:, 1:],
             phi_n[:-1, 1:]),
            phi_cc,
        ) * (dxs[0] * dxs[1])

    # ---- stability thresholds (MarkCells / ComputeSStab) ----------------
    def s_stab(d):
        # S_stab = half the largest edge-times-transverse-spacing rectangle
        # (ComputeSStab, WarpXFaceExtensions.cpp:140-166)
        if ndim == 2:
            return 0.5 * np.maximum.reduce([
                lx[:, :-1] * dxs[1], lx[:, 1:] * dxs[1],
                lz[:-1, :] * dxs[0], lz[1:, :] * dxs[0],
            ])
        if d == 0:
            return 0.5 * np.maximum.reduce([
                ly[:, :, :-1] * dxs[2], ly[:, :, 1:] * dxs[2],
                lz[:, :-1, :] * dxs[1], lz[:, 1:, :] * dxs[1],
            ])
        if d == 1:
            return 0.5 * np.maximum.reduce([
                lx[:, :, :-1] * dxs[2], lx[:, :, 1:] * dxs[2],
                lz[:-1, :, :] * dxs[0], lz[1:, :, :] * dxs[0],
            ])
        return 0.5 * np.maximum.reduce([
            lx[:, :-1, :] * dxs[1], lx[:, 1:, :] * dxs[1],
            ly[:-1, :, :] * dxs[0], ly[1:, :, :] * dxs[0],
        ])

    dims = (1,) if ndim == 2 else (0, 1, 2)
    flags, S_mod, stab, borrow = {}, {}, {}, {}
    for d in dims:
        st = s_stab(d)
        stab[d] = st
        Sd = S[d]
        flag_ext = (Sd > 0) & (Sd < st)
        info = np.where(Sd <= 0, -2, np.where(flag_ext, 0, 1)).astype(
            np.int32
        )
        S_mod[d] = Sd.copy()
        flags[d] = info
        borrow[d] = {off: np.zeros_like(Sd) for off in _RING}
        axes = _plane_axes(d, ndim)

        def neigh(arr, t, off):
            idx = list(t)
            idx[axes[0]] += off[0]
            idx[axes[1]] += off[1]
            for ax in axes:
                if not (0 <= idx[ax] < arr.shape[ax]):
                    return None
            return tuple(idx)

        # --- one-way extensions (first available direct neighbour) -------
        order = np.argwhere(flag_ext)
        for t in map(tuple, order):
            S_ext = st[t] - Sd[t]
            for off in _DIRECT:
                nb = neigh(Sd, t, off)
                if nb is None:
                    continue
                if S_mod[d][nb] > S_ext and flags[d][nb] in (1, 2):
                    S_mod[d][nb] -= S_ext
                    borrow[d][off][t] = S_ext
                    flags[d][nb] = 2
                    S_mod[d][t] = Sd[t] + S_ext
                    flag_ext[t] = False
                    break

        # --- eight-way extensions (proportional-to-S patches) ------------
        for t in map(tuple, np.argwhere(flag_ext)):
            S_ext = st[t] - Sd[t]
            avail = {}
            for off in _RING:
                nb = neigh(Sd, t, off)
                if nb is not None and flags[d][nb] in (1, 2):
                    avail[off] = nb
            while True:
                denom = sum(Sd[nb] for nb in avail.values())
                if denom < S_ext or denom <= 0:
                    break
                neg = [
                    off for off, nb in avail.items()
                    if S_mod[d][nb] - S_ext * Sd[nb] / denom <= 0
                ]
                if not neg:
                    break
                for off in neg:
                    del avail[off]
            denom = sum(Sd[nb] for nb in avail.values())
            if denom >= S_ext and denom > 0:
                S_mod[d][t] = Sd[t]
                for off, nb in avail.items():
                    patch = S_ext * Sd[nb] / denom
                    borrow[d][off][t] = patch
                    flags[d][nb] = 2
                    S_mod[d][t] += patch
                    S_mod[d][nb] -= patch
                flag_ext[t] = False

        # --- BCK correction for anything left (ApplyBCKCorrection) -------
        for t in map(tuple, np.argwhere(flag_ext)):
            S[d][t] = st[t]
            S_mod[d][t] = st[t]
            flags[d][t] = -1

        borrow[d] = {
            off: arr for off, arr in borrow[d].items() if arr.any()
        }

    return {
        "edges": edges,
        "S": S,
        "S_mod": S_mod,
        "flags": flags,
        "borrow": borrow,
        "ndim": ndim,
    }


# ------------------------------------------------------------ device update

def make_ect_evolve_b(geo, dtype, device=None):
    """The ECT Faraday update B -= dth * Rho_face per flag case on the
    device: ``evolve_b(Ex, Ey, Ez, (Bx, By, Bz), dth) -> (Bx, By, Bz)``
    (in 2D XZ only By is conformal; Bx and Bz come back as they were)."""
    ndim = geo["ndim"]
    kw = dict(dtype=dtype, device=device)

    def dev(a):
        return torch.as_tensor(np.asarray(a), **kw)

    edges = {k: dev(v) for k, v in geo["edges"].items()}
    dims = (1,) if ndim == 2 else (0, 1, 2)
    Sd = {d: dev(geo["S"][d]) for d in dims}
    Smod = {d: dev(geo["S_mod"][d]) for d in dims}
    one = torch.ones((), **kw)
    zero = torch.zeros((), **kw)

    def inv_pos(a):
        return torch.where(a > 0, 1.0 / torch.where(a > 0, a, one), zero)

    inv_S = {d: inv_pos(Sd[d]) for d in dims}
    inv_Smod = {d: inv_pos(Smod[d]) for d in dims}
    flags = {d: torch.as_tensor(geo["flags"][d], device=device)
             for d in dims}
    borrow = {d: {off: dev(a) for off, a in geo["borrow"][d].items()}
              for d in dims}

    def shift(arr, off, axes, back=False):
        out = arr
        for ax, o in zip(axes, off):
            if back:
                o = -o
            if o == 0:
                continue
            out = torch.roll(out, -o, ax).clone()
            # zero the wrapped band: no borrowing across the walls
            idx = [slice(None)] * out.dim()
            idx[ax] = (slice(o, None) if o < 0
                       else slice(out.shape[ax] - o, None))
            out[tuple(idx)] = 0.0
        return out

    def rho_faces(Ex, Ey, Ez):
        wex, wey, wez = Ex * edges["Ex"], Ey * edges["Ey"], Ez * edges["Ez"]
        if ndim == 2:
            # Rhoy (XZ): Ez lz(i) - Ez lz(i+1) + Ex lx(j+1) - Ex lx(j)
            return {1: (wez[:-1, :] - wez[1:, :] + wex[:, 1:]
                        - wex[:, :-1]) * inv_S[1]}
        return {
            0: (wey[:, :, :-1] - wey[:, :, 1:] + wez[:, 1:, :]
                - wez[:, :-1, :]) * inv_S[0],
            1: (wez[:-1, :, :] - wez[1:, :, :] + wex[:, :, 1:]
                - wex[:, :, :-1]) * inv_S[1],
            2: (wex[:, :-1, :] - wex[:, 1:, :] + wey[1:, :, :]
                - wey[:-1, :, :]) * inv_S[2],
        }

    def evolve_b(Ex, Ey, Ez, B3, dth):
        rho = rho_faces(Ex, Ey, Ez)
        out = list(B3)
        for d in dims:
            axes = _plane_axes(d, ndim)
            r, f = rho[d], flags[d]
            # the enlarged-face Rho of the unstable faces
            venl = r * Sd[d]
            for off, ba in borrow[d].items():
                venl = venl + shift(r, off, axes) * ba
            rho_enl = torch.where(f == 0, venl * inv_Smod[d], zero)
            # the area lent back to the intruded faces
            lent = torch.zeros_like(r)
            for off, ba in borrow[d].items():
                lent = lent + shift(rho_enl * ba, off, axes, back=True)
            upd = torch.where(
                f == 0, rho_enl,
                torch.where((f == 1) | (f == -1), r,
                            torch.where(f == 2,
                                        (r * Smod[d] + lent) * inv_S[d],
                                        zero)))
            out[d] = B3[d] - dth * torch.where(Sd[d] > 0, upd, zero)
        return tuple(out)

    return evolve_b
