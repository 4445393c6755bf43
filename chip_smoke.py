#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``warpx_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It runs every phase, in order; each prints one JSON line and any failure
exits non-zero:

  device       the card's name, count and power limit;
  build        compile every kernel under warpx_tpu_torch/csrc with nvcc;
  k1_parity    kernel K1 (fused gather/push/deposit) against its plain
               PyTorch version at 16^3, two species, orders 1-3, the Boris,
               Vay and Higuera-Cary pushers, float64 and float32, each case
               launched K1_REPEATS times (its shared-memory atomics sum in
               an order that changes from launch to launch); then K1's
               branch cases (``branch_inputs``: a window wider than K1's
               shared box, a tile whose particles reach past the box, dead
               slots like and unlike their row's first, dead slots with a
               weight, a stencil clipped at the window's low side, a
               counted violation, an all-empty tile, external fields) in
               float64 and float32, every mode, orders 1-3, Galerkin on and
               off;
  k2_parity    kernel K2 (the 2D XZ fused kernel) against its plain version
               at 32^2, the same cases and launches, then K2's branch
               cases;
  k1d_parity   K1 and K2 in the precision modes 'mixed' and 'bf16' (kernel
               mode K1d), the same cases and launches, float32 to TOL_MXU,
               and each mode once per kernel in moving-window mode;
  k1c_parity   K1 and K2 in moving-window mode (smax = 8, zshift 0, 3 and 8,
               tiles anchored off prob_lo) against their plain versions, and
               the mode's neutral arguments against the call without them;
               then K1's and K2's branch cases in moving-window mode
               (zshift 3);
  k3_parity    kernel K3 (rebin slot expansion) against its plain version;
  lab_parity   the four kernels of the Hopper labs (warpx_tpu_torch/tools/:
               lab_fused, lab_widelane, tile_dot, slot_copy) against their
               plain versions at small shapes, every mode and both layouts,
               each case launched three times (slot_copy exactly);
  slice_parity 8 steps of Simulation at 16^3 in float64 on the card and on
               the CPU: every checksum but divE/divB agrees to 1e-9;
  slice2d_parity  the same for the 2D slice at 32^2;
  bounded_parity  the bounded step in float64 on the card (kernels) and on
               the CPU (plain versions): the 32 x 64 laser-wakefield deck
               (PML, moving window, antenna, continuous injection, beam,
               filter, order 3; 12 steps, K2 in moving-window mode) and the
               16^3 deck with PEC walls along z (three particles per cell,
               8 steps, K1): every
               checksum but divE/divB agrees to 1e-9, the window moved, the
               kernels were launched once per step;
  deck_parity  the 32 x 64 deck at tpu.tile_mxu = mixed through
               Simulation.from_deck, card against CPU, 12 steps (1e-9); then
               the CLI (python -m warpx_tpu_torch) on the card as a process
               of its own, its checksums against an in-process run;
  main         the 3D main path at 128^3 cells, 2 species, 8.39 M particles,
               float32: init, one warm step, 20 timed steps, 3 profiled
               steps, the closing step; then each kernel at the main path's
               shapes against its plain version, timed beside its bound;
  main_mixed   the same path at tile_mxu = 'mixed' (bench.py's default), and
               main_bf16 at 'bf16'; K1 in each mode at its shapes against
               its plain version, timed beside K1 at 'f32';
  main2d       the 2D main path at 2048^2 cells, 2 species, 33.6 M particles,
               order 3, float32: init, one warm step, 33 timed steps (rebins
               at steps 16 and 32), 3 profiled steps, the closing step; then
               K2 and K3 at its shapes as above;
  main_lwfa    the bounded main path, bench.py's 2D laser-wakefield deck at
               2048 x 8192 cells (PML on four faces, moving window along z,
               Gaussian laser antenna, continuously injected plasma of
               ~45 M electrons at 2 x 2 per cell, a 100-particle beam,
               bilinear filter, order 3, sort interval 16), float32: init,
               32 warm steps, 32 timed steps, 16 steps with the host's waits
               for the device counted, 3 profiled steps, the closing steps;
               then the step's layers timed one by one, and K2 in
               moving-window mode (K1c)
               at its shapes against its plain version, timed beside its
               bound;
  main_lwfa_deck  the same run from bench.py's deck text (a copy here)
               through Simulation.from_deck at tpu.tile_mxu = mixed, as
               bench.py runs it; then K2 in moving-window mode at 'mixed'
               against its plain version, timed beside K1c at 'f32';
  main_lwfa_diags  the same deck at 'mixed' with outputs, as a user runs
               it (Simulation.from_deck with an output directory), 40 steps:
               a plotfile of Ex Ez By jz rho and both species at steps 20
               and 40, each read back and held exactly against the tensors
               it was written from; a checkpoint at 20; eight reduced
               diagnostics every 4 steps (rows and ParticleNumber checked);
               an openPMD file of the beam at 40 where h5py is installed
               (held against the plotfile's beam); the host's waits for the
               device on steps with no output due against main_lwfa_deck's
               steps without a rebin; each flush kind timed alone on the
               final state (ms, bytes written, bytes from the device); then
               a fresh simulation restarted from the checkpoint and run to
               40, its checksums within TOL_RESTART of the run's;
  labs         each Hopper lab's main() at the TPU lab's default shapes (L1
               in every mode): kernel against plain version, times, bounds,
               the library's yardstick where there is one; each lab prints
               its lines and one JSON line.

The build line reports every library's registers and spill bytes (ptxas);
the kernels line gives K1's and K2's rows their registers, spills,
resident blocks per SM and the tiles of one launch that took the checked
path (``wide_tiles``).  The line before the last lists the kernels; the last
line is
{"ok": true, "device": {...}}.  With no GPU, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and the dense rates outside the
# tensor cores (float64 34, float32 67 TFLOP/s), at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# The main paths' current windows in float32: their thermal particles drift
# ~0.006 cells a step, and the current is a difference of shape factors over
# that drift.  Kernel and plain version push with velocities that differ in
# the 7th digit, so now and then x_new rounds to the neighbouring float32
# (2^-20 cells at W = 16, 2^-19 at W = 24), which moves that particle's
# current by ~1e-6/0.006 ~ 2e-4 of itself.  1e-4 of the largest window value
# bounds it.
TOL_J_MAIN = 1e-4
# The same for the laser-wakefield path's windows: at W = 48 an ulp of the
# window coordinate is 2^-18 cells, and the plasma is at rest but for what the
# laser's leading edge moves (a drift of a few hundredths of a cell a step
# carries the largest current), so one ulp of x_new is ~1e-4 of the largest
# window value; 8.2e-5 was measured.
TOL_J_WINDOW = 4e-4
# K1 at 'bf16' at the main path's shapes: an ulp of x_new that carries a
# deposit operand across a bfloat16 rounding boundary moves that point's
# value by up to 2^-8 (3.9e-3) of itself, and the point may hold the largest
# window value; 3.3e-4 was measured at uniform-128 after 25 steps.
TOL_J_BF16 = 4e-3


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` from CUDA events around ``reps`` calls
    made back to back, so the host's work of one call overlaps the device's
    work of the one before."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|) in float64."""
    d = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return d, d / scale if scale else d


# ---- kernels K1 (3D) and K2 (2D) -------------------------------------------

def kernel_inputs(ndim, n, order, dtype, dev, seed, smax=0, anchor_off=0.0,
                  margin=1):
    """Two species in the tile layout at n^ndim with random fields, dead
    slots, one empty (species, tile) and one alive particle whose deposit
    stencil is clipped at its window's low side (a counted violation).
    With ``smax`` the padded fields are that much longer on the last axis;
    with ``anchor_off`` the tiles are anchored that many cells above
    prob_lo; ``margin`` is the tiling's sort margin in cells.  Returns
    ((params, fields6, parts), counts, keywords, anchors).
    """
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.core.state import ParticleState
    from warpx_tpu_torch.ops.fused_pic import pad_fields, padded_shape
    from warpx_tpu_torch.ops.tiling import TileSpec, rebin
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    rng = np.random.default_rng(seed)
    lx = 40e-6
    geom = Geometry(ndim=ndim, n_cell=(n,) * ndim, prob_lo=(-lx / 2,) * ndim,
                    prob_hi=(lx / 2,) * ndim, periodic=(True,) * ndim)
    dt = compute_dt_yee(geom, 0.999)
    npart = 2 * n ** ndim
    spec = TileSpec.create(geom.n_cell, order=order, n_particles=npart,
                           margin=margin, interval=4)
    c = 299792458.0
    t64 = dict(dtype=torch.float64)
    names = ("x", "z") if ndim == 2 else ("x", "y", "z")
    parts = []
    for s in range(2):
        alive = rng.random(npart) > 0.1
        pos = rng.uniform(-lx / 2, lx / 2, (ndim, npart))
        if s == 1:  # leave tile 0 empty for this species
            alive &= ~np.all(pos < -lx / 2 + spec.tile[0] * geom.dx[0],
                             axis=0)
        u = rng.normal(0.0, 0.05 * c, (3, npart))
        sp = ParticleState(
            w=torch.tensor(rng.uniform(0.5, 1.5, npart) * 1e10 * alive, **t64),
            ux=torch.tensor(u[0], **t64), uy=torch.tensor(u[1], **t64),
            uz=torch.tensor(u[2], **t64), alive=torch.tensor(alive),
            **{nm: torch.tensor(pos[d], **t64) for d, nm in enumerate(names)},
        )
        sp, _ = rebin(sp, geom, spec)
        parts.append(sp)
    # first alive slot of species 0 in its tile: move it so the stencil
    # start of its x deposit is window row -1
    sp0 = parts[0]
    k = int(torch.nonzero(sp0.alive)[0])
    t = k // spec.p_max
    tx = t // int(np.prod(spec.tiles_per_dim[1:]))
    xwin = 0.25 + 0.5 * order  # start_index(x, order) == 0
    x = sp0.x.clone()
    x[k] = geom.prob_lo[0] + (tx * spec.tile[0] - spec.off + xwin) * geom.dx[0]
    ux = sp0.ux.clone()
    ux[k] = 0.0
    parts[0] = sp0.replace(x=x, ux=ux)
    nt, P = spec.n_tiles, spec.p_max
    anchors = tuple(lo + anchor_off * d
                    for lo, d in zip(geom.prob_lo, geom.dx))
    cols = [torch.cat([getattr(sp, a).reshape(nt, P) for sp in parts])
            + anchor_off * geom.dx[d] for d, a in enumerate(names)]
    cols += [torch.cat([getattr(sp, a).reshape(nt, P) for sp in parts])
             for a in ("ux", "uy", "uz")]
    cols.append(torch.cat([torch.where(sp.alive, sp.w, 0.0).reshape(nt, P)
                           for sp in parts]))
    counts = torch.cat([sp.alive.reshape(nt, P).sum(1, dtype=torch.int32)
                        for sp in parts])
    if int((counts == 0).sum()) < 1:
        raise AssertionError("the test layout lost its empty tile")
    to = dict(dtype=dtype, device=dev)
    fshape = geom.n_cell if smax == 0 else padded_shape(spec, geom.n_cell,
                                                        smax)
    fields = tuple(torch.tensor(rng.normal(0, scale, fshape), **t64).to(**to)
                   for scale in (1e10,) * 3 + (30.0,) * 3)
    if smax == 0:
        fields = pad_fields(fields, spec)
    params = torch.tensor([[-1.602176634e-19, 9.1093837015e-31, 1e9, 0, 0,
                            0, 0, 1.0],
                           [1.602176634e-19, 1.67262192369e-27, 0, 0, 0,
                            0, 0, 0]], **t64)
    args = (params.to(**to), fields,
            tuple(a.to(**to).contiguous() for a in cols))
    return args, counts.to(dev), dict(spec=spec, geom=geom, dt=dt), anchors


def kernel_compare(fp, args, counts, kw, tol, tol_j=None, repeats=1,
                   anchors=None, zshift=None, smax=0):
    """K1 or K2 against the plain version on the same inputs, over
    ``repeats`` launches of the kernel: max |diff| over max |ref| per output
    must stay within ``tol`` (``tol_j`` for the current windows, default
    ``tol``) in every launch; the violation counts must be equal.  Returns
    the errors of the worst launch per output, the violation count, the
    worst relative error of the particles and of the J windows, and the J
    error of each launch."""
    tol_j = tol if tol_j is None else tol_j
    mode = {} if zshift is None else dict(anchors=anchors, zshift=zshift)
    plain_mode = {} if zshift is None else dict(lo=anchors,
                                                zoff=smax - zshift)
    out_p = fp.binned_push_deposit_plain(*args, counts, **plain_mode, **kw)
    ndim = kw["spec"].ndim
    names = (("x", "z") if ndim == 2 else ("x", "y", "z")) + ("ux", "uy",
                                                              "uz")
    errs = {}
    j_runs = []
    for _ in range(repeats):
        out_k = fp.binned_push_deposit(*args, counts=counts, smax=smax,
                                       **mode, **kw)
        torch.cuda.synchronize()
        run = {}
        for nm, a, b in zip(names, out_k[0], out_p[0]):
            run[nm] = rel_err(a, b)
        for nm, a, b in zip(("jx", "jy", "jz"), out_k[1], out_p[1]):
            run[nm] = rel_err(a, b)
        if not torch.equal(out_k[2], out_p[2]):
            raise AssertionError("the kernel's violation counts differ from "
                                 "its plain version's")
        for nm, e in run.items():
            errs[nm] = max(errs.get(nm, e), e, key=lambda t: t[1])
        j_runs.append(max(run[nm][1] for nm in ("jx", "jy", "jz")))
    worst_p = max(errs[nm][1] for nm in names)
    worst_j = max(errs[nm][1] for nm in ("jx", "jy", "jz"))
    if worst_p > tol or worst_j > tol_j:
        raise AssertionError(f"the {ndim}D kernel disagrees with its plain "
                             f"version: {errs}")
    return errs, int(out_p[2].sum()), worst_p, worst_j, j_runs


K1_REPEATS = 5

# Sort margin of K2's branch cases: W = 32 at orders 1-3, wider than K2's
# shared box (kBox = 24 in csrc/fused_pic_2d.cu), so the box sits inside
# the window and a tile whose particles drifted apart reaches past it.  K1's
# take the main path's margin, 1: W = 16 at orders 1-2 and 24 at order 3,
# wider than its box of 12 + order cells an edge (csrc/fused_pic.cu).
BRANCH_MARGIN = {2: 8, 3: 1}


def branch_inputs(ndim, n, order, dtype, dev, seed, smax=0, anchor_off=0.0):
    """``kernel_inputs`` at BRANCH_MARGIN with every branch of K2 (ndim 2)
    or K1 (ndim 3) reached: besides the clipped particle and the empty
    (species, tile), an all-empty tile (the last, in both species); in
    every occupied row, dead slots 3 and 5 past the first dead one with
    other momenta and positions than it; in one row, dead slots with a
    weight (in 3D the first three), which deposit, so the first is copied
    by nobody; in one tile, two alive particles moved apart (2D: 6 cells up
    and down along x and z; 3D: to window coordinate off - 1.4 and off +
    tile + 1.4 on every axis, at rest, so their stencils stay in the window
    and count no violation), so the tile's reach exceeds the shared box;
    all six external particle fields of both species nonzero.  Returns what
    ``kernel_inputs`` returns and the slots of the changed dead slots."""
    args, counts, kw, anchors = kernel_inputs(
        ndim, n, order, dtype, dev, seed, smax=smax, anchor_off=anchor_off,
        margin=BRANCH_MARGIN[ndim])
    params, fields, cols = args
    spec, geom = kw["spec"], kw["geom"]
    nt, P = spec.n_tiles, spec.p_max
    cols = [c.clone() for c in cols]
    counts = counts.clone()
    iw = ndim + 3  # the weight column
    for s in range(2):
        counts[s * nt + nt - 1] = 0
        cols[iw][s * nt + nt - 1] = 0.0
    rows = torch.nonzero((counts > 0) & (counts + 6 <= P))[:, 0]
    first = counts[rows].long()
    c = 299792458.0
    cols[ndim][rows, first + 3] += 0.05 * c
    cols[ndim + 2][rows, first + 3] -= 0.03 * c
    cols[0][rows, first + 5] += 0.3 * geom.dx[0]
    cols[1][rows, first + 5] -= 0.2 * geom.dx[1]
    r0 = int(rows[len(rows) // 2])
    # 3D: three such slots, bitwise alike: a hundred coincident ones would
    # add one ulp of their common x_new coherently (2.0e-4 of the largest
    # J value on the card, the first design's K1 alike)
    heavy = P if ndim == 2 else int(counts[r0]) + 3
    cols[iw][r0, int(counts[r0]):heavy] = 1e10
    # a tile whose particles drifted apart: not the clipped particle's
    wt = int(rows[-1]) % nt
    if wt == int(rows[0]) % nt or int(counts[wt]) < 2:
        raise AssertionError("the branch layout has no tile to spread")
    if ndim == 2:
        for slot, sign in ((0, 1.0), (1, -1.0)):
            cols[0][wt, slot] += sign * 6 * geom.dx[0]
            cols[1][wt, slot] -= sign * 6 * geom.dx[1]
    else:
        tix = []
        for d in range(3):
            stride = int(np.prod(spec.tiles_per_dim[d + 1:]))
            tix.append(wt // stride % spec.tiles_per_dim[d])
        for slot, xwin in ((0, spec.off - 1.4), (1, spec.off + 1.4)):
            for d in range(3):
                x = xwin + (spec.tile[d] if slot else 0)
                cols[d][wt, slot] = anchors[d] + (
                    tix[d] * spec.tile[d] - spec.off + x) * geom.dx[d]
                cols[3 + d][wt, slot] = 0.0
    params = params.clone()
    params[:, 2:8] = torch.tensor([1e9, -2e9, 3e9, 5.0, -3.0, 2.0],
                                  dtype=params.dtype, device=params.device)
    changed = (rows, first)
    return (params, fields, tuple(cols)), counts, kw, anchors, changed


def branch_cases(ndim, dev, repeats, smax=0, zshift=None):
    """K2 (ndim 2, 32^2) or K1 (ndim 3, 16^3) against its plain version on
    ``branch_inputs``: float64 and float32, the modes 'f32', 'mixed' and
    'bf16', orders 1-3, Galerkin on and off, Boris; ``repeats`` launches a
    case.  Tolerances as in k1_parity, k2_parity and k1d_parity, but float32
    J at TOL_J_MAIN or more.  The tiles that took the kernel's checked path
    must be > 0 in every case; the changed dead slots must come out unlike
    the first dead slot of their row.  Returns the cases."""
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for dtype in (torch.float64, torch.float32):
        for mxu in ("f32", "mixed", "bf16"):
            tol = ({"particles": TOL[dtype], "j": TOL[dtype]}
                   if dtype == torch.float64 or mxu == "f32"
                   else dict(TOL_MXU[mxu]))
            if dtype == torch.float32:
                # window coordinates reach past 16 cells (2D: W = 32; 3D at
                # order 3: W = 24), where an ulp of x_new is 2^-19 cells as
                # at the main paths' W = 24
                tol["j"] = max(tol["j"], TOL_J_MAIN)
            for order in (1, 2, 3):
                for galerkin in (True, False):
                    args, counts, kw, anchors, (rows, first) = branch_inputs(
                        ndim, 32 if ndim == 2 else 16, order, dtype, dev,
                        seed=10 + order, smax=smax,
                        anchor_off=0.0 if zshift is None else 0.37)
                    kw.update(order=order, galerkin=galerkin,
                              pusher_name="boris",
                              stag_items=stag_items(ndim), mxu=mxu)
                    wide0 = fp.wide_tiles(dev, ndim)
                    _, nviol, worst_p, worst_j, _ = kernel_compare(
                        fp, args, counts, kw, tol["particles"], tol["j"],
                        repeats=repeats, anchors=anchors, zshift=zshift,
                        smax=smax)
                    wide = (fp.wide_tiles(dev, ndim) - wide0) // repeats
                    if wide < 1 or not nviol:
                        raise AssertionError(
                            f"the {ndim}D kernel's checked path ran in "
                            f"{wide} tiles, {nviol} violations")
                    out = fp.binned_push_deposit(
                        *args, counts=counts, smax=smax, **kw,
                        **({} if zshift is None else
                           dict(anchors=anchors, zshift=zshift)))[0]
                    for k in (3, 5):
                        if torch.equal(out[ndim][rows, first + k],
                                       out[ndim][rows, first]) and torch.equal(
                                out[0][rows, first + k], out[0][rows, first]):
                            raise AssertionError(
                                f"dead slot {k} past the first took its "
                                "outputs")
                    cases.append({"dtype": str(dtype), "mxu": mxu,
                                  "order": order, "galerkin": galerkin,
                                  "particles_rel_err": worst_p,
                                  "j_rel_err": worst_j, "violations": nviol,
                                  "wide_tiles": wide})
    return cases


def stag_items(ndim):
    from warpx_tpu_torch.core.grid import yee_staggering

    return tuple(sorted((k, tuple(v))
                        for k, v in yee_staggering(ndim).items()))


def phase_kernel_parity(dev, phase, ndim, n):
    """K1 (ndim 3) or K2 (ndim 2) against the plain version: both types,
    orders 1-3, three pushers, K1_REPEATS launches per case."""
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for dtype in (torch.float64, torch.float32):
        for order in (1, 2, 3):
            for pusher in ("boris", "vay", "higuera"):
                args, counts, kw, _ = kernel_inputs(ndim, n, order, dtype,
                                                    dev, seed=order)
                kw.update(order=order, galerkin=True, pusher_name=pusher,
                          stag_items=stag_items(ndim))
                _, nviol, worst_p, worst_j, j_runs = kernel_compare(
                    fp, args, counts, kw, TOL[dtype], repeats=K1_REPEATS)
                if not nviol:
                    raise AssertionError("the clipped particle was not "
                                         "counted as a violation")
                cases.append({"dtype": str(dtype), "order": order,
                              "pusher": pusher, "particles_rel_err": worst_p,
                              "j_rel_err": worst_j, "j_rel_err_min": min(j_runs),
                              "violations": nviol})
    worst = {str(dt): {k: max(c[k] for c in cases if c["dtype"] == str(dt))
                       for k in ("particles_rel_err", "j_rel_err")}
             for dt in TOL}
    branches = branch_cases(ndim, dev, K1_REPEATS)
    emit(phase, ok=True, repeats=K1_REPEATS, n_cell=(n,) * ndim,
         tol=dict((str(k), v) for k, v in TOL.items()), worst=worst,
         cases=cases, branch_cases=branches)


# The precision modes in float32, kernel against plain version at 16^3 and
# 32^2: the relative error of the particles and of the J windows that
# k1d_parity allows.  'mixed' splits each deposit operand into two bfloat16
# parts, so an ulp of x_new moves its current as in 'f32' (5.8e-6 measured);
# 'bf16' rounds each operand once, and an ulp of x_new that carries an
# operand across a bfloat16 rounding boundary moves that point's value by up
# to 2^-8 of itself (8.7e-5 measured).
TOL_MXU = {"mixed": {"particles": 1e-5, "j": 1e-5},
           "bf16": {"particles": 1e-5, "j": 4e-4}}


def phase_k1d_parity(dev):
    """K1d, the precision modes 'mixed' and 'bf16' of K1 (16^3) and K2
    (32^2), against the plain version: both types, orders 1-3, three
    pushers, K1_REPEATS launches per case (1e-12 in float64, TOL_MXU in
    float32); then each mode once per kernel in moving-window mode (smax 8,
    zshift 3, tiles anchored 0.37 cells off prob_lo)."""
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for ndim, n in ((3, 16), (2, 32)):
        for mxu in ("mixed", "bf16"):
            for dtype in (torch.float64, torch.float32):
                tol = ({"particles": TOL[dtype], "j": TOL[dtype]}
                       if dtype == torch.float64 else TOL_MXU[mxu])
                runs = [(order, pusher, None) for order in (1, 2, 3)
                        for pusher in ("boris", "vay", "higuera")]
                runs.append((1 if ndim == 3 else 3, "boris", 3))
                for order, pusher, zshift in runs:
                    smax = 0 if zshift is None else 8
                    args, counts, kw, anchors = kernel_inputs(
                        ndim, n, order, dtype, dev, seed=order, smax=smax,
                        anchor_off=0.0 if zshift is None else 0.37)
                    kw.update(order=order, galerkin=True, pusher_name=pusher,
                              stag_items=stag_items(ndim), mxu=mxu)
                    _, nviol, worst_p, worst_j, j_runs = kernel_compare(
                        fp, args, counts, kw, tol["particles"], tol["j"],
                        repeats=K1_REPEATS, anchors=anchors, zshift=zshift,
                        smax=smax)
                    if not nviol:
                        raise AssertionError("the clipped particle was not "
                                             "counted as a violation")
                    cases.append({"ndim": ndim, "mxu": mxu,
                                  "dtype": str(dtype), "order": order,
                                  "pusher": pusher, "zshift": zshift,
                                  "particles_rel_err": worst_p,
                                  "j_rel_err": worst_j,
                                  "j_rel_err_min": min(j_runs),
                                  "violations": nviol})
    worst = {f"{nd}d/{m}/{dt}": {
        k: max(c[k] for c in cases if (c["ndim"], c["mxu"], c["dtype"])
               == (nd, m, dt)) for k in ("particles_rel_err", "j_rel_err")}
        for nd in (3, 2) for m in ("mixed", "bf16")
        for dt in (str(torch.float64), str(torch.float32))}
    emit("k1d_parity", ok=True, repeats=K1_REPEATS,
         tol={"float64": TOL[torch.float64], "float32": TOL_MXU},
         worst=worst, cases=cases)


def phase_k1c_parity(dev):
    """The moving-window mode of K1 and K2: smax = 8 slack cells, zshift 0, 3
    and 8, tiles anchored 0.37 cells off prob_lo, against the plain versions.
    Then the mode's neutral arguments (anchors = prob_lo, zshift = 0,
    smax = 0) against the call without them: the particles and the violation
    counts must be bit-identical; the J windows are sums of shared-memory
    atomics, whose order changes from launch to launch, so they are held to
    the kernels' tolerance and their bitwise equality is only reported."""
    from warpx_tpu_torch.ops import fused_pic as fp

    smax = 8
    cases = []
    for ndim, n, order in ((3, 16, 1), (2, 32, 3)):
        for dtype in (torch.float64, torch.float32):
            for zshift in (0, 3, 8):
                args, counts, kw, anchors = kernel_inputs(
                    ndim, n, order, dtype, dev, seed=7, smax=smax,
                    anchor_off=0.37)
                kw.update(order=order, galerkin=True, pusher_name="boris",
                          stag_items=stag_items(ndim))
                _, nviol, worst_p, worst_j, _ = kernel_compare(
                    fp, args, counts, kw, TOL[dtype], anchors=anchors,
                    zshift=zshift, smax=smax)
                cases.append({"ndim": ndim, "dtype": str(dtype),
                              "zshift": zshift, "particles_rel_err": worst_p,
                              "j_rel_err": worst_j, "violations": nviol})
    neutral = []
    for ndim, n, order in ((3, 16, 1), (2, 32, 3)):
        for dtype in (torch.float64, torch.float32):
            args, counts, kw, anchors = kernel_inputs(ndim, n, order, dtype,
                                                      dev, seed=8)
            kw.update(order=order, galerkin=True, pusher_name="boris",
                      stag_items=stag_items(ndim), counts=counts)
            a = fp.binned_push_deposit(*args, **kw)
            b = fp.binned_push_deposit(*args, anchors=kw["geom"].prob_lo,
                                       zshift=0, smax=0, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a[0] + (a[2],),
                                                         b[0] + (b[2],))):
                raise AssertionError("neutral moving-window arguments "
                                     "changed the particles")
            j_err = max(rel_err(x, y)[1] for x, y in zip(a[1], b[1]))
            if j_err > TOL[dtype]:
                raise AssertionError(f"neutral moving-window arguments "
                                     f"changed J by {j_err}")
            neutral.append({"ndim": ndim, "dtype": str(dtype),
                            "particles_bitwise": True, "j_rel_err": j_err,
                            "j_bitwise": all(torch.equal(x, y) for x, y
                                             in zip(a[1], b[1]))})
    branches = {f"{nd}d": branch_cases(nd, dev, 1, smax=smax, zshift=3)
                for nd in (3, 2)}
    emit("k1c_parity", ok=True, smax=smax,
         tol=dict((str(k), v) for k, v in TOL.items()), cases=cases,
         neutral=neutral, branch_cases=branches)


# ---- kernel K3 ------------------------------------------------------------

def phase_k3_parity(dev):
    from warpx_tpu_torch.ops.tiling import ragged_expand, ragged_expand_plain

    rng = np.random.default_rng(3)
    cases = []
    for dtype in (torch.float64, torch.float32):
        n_tiles, p_max, n_attr = 64, 128, 8
        key = np.sort(rng.integers(0, n_tiles + 1, 6000)).astype(np.int32)
        key[:700] = 5  # one tile over capacity
        key = np.sort(key)
        cap = key.size
        edges = np.searchsorted(key, np.arange(n_tiles + 1)).astype(np.int32)
        payload = torch.tensor(rng.normal(size=(n_attr, cap)), dtype=dtype,
                               device=dev)
        fill = torch.tensor(rng.normal(size=(n_attr, n_tiles)), dtype=dtype,
                            device=dev)
        offsets = torch.tensor(edges[:-1], device=dev)
        counts = torch.tensor(edges[1:] - edges[:-1], device=dev)
        got = ragged_expand(payload, offsets, counts, fill, p_max)
        ref = ragged_expand_plain(payload, offsets, counts, fill, p_max)
        if not torch.equal(got, ref):
            raise AssertionError("K3 disagrees with its plain version")
        cases.append({"dtype": str(dtype), "equal": True,
                      "empty_tiles": int((counts == 0).sum()),
                      "overfull_tiles": int((counts > p_max).sum())})
    emit("k3_parity", ok=True, cases=cases)


# ---- the slice on the card against the CPU --------------------------------

def checksums_agree(got, ref, tol, what):
    """The worst relative difference of every checksum but divE/divB
    (roundoff noise; test_binned.py excludes them too); raises above
    ``tol``."""
    worst = 0.0
    for group in ref:
        for q, a in ref[group].items():
            if q in ("divE", "divB"):
                continue
            r = abs(got[group][q] - a) / abs(a) if a else abs(got[group][q])
            worst = max(worst, r)
            if r > tol:
                raise AssertionError(f"{what} checksum {group}/{q}: "
                                     f"{got[group][q]!r} vs {a!r}")
    return worst


def phase_slice_parity(dev, phase, ndim):
    import warpx_tpu_torch

    sums = {}
    for device in (dev, "cpu"):
        sim = warpx_tpu_torch.Simulation(small_cfg(ndim),
                                         dtype=torch.float64, device=device)
        sim.init()
        sim.evolve()
        sums[str(device)] = sim.checksums()
    worst = checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                            f"{phase} card vs CPU")
    emit(phase, ok=True, ndim=ndim, max_rel_err=worst, tol=1e-9)


# ---- the main path --------------------------------------------------------

PROFILED_STEPS = 3


def profile_steps(sim, steps, top=15):
    """Device time by kernel over ``steps`` steps of the main path (from
    torch.profiler), per step, and the device's busy share of the wall
    time of those steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        sim.evolve(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # operator rows repeat their kernels' device time
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3 / steps, evt.count // steps, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy,
            "device_busy_share": busy * steps / wall_ms if wall_ms else 0.0,
            "top": [{"ms_per_step": ms, "calls_per_step": n, "name": k[:80]}
                    for ms, n, k in rows[:top]]}


def plasma_cfg(ndim, n, ppc, order, u_th, second, max_step, **kw):
    """bench.py::_build_sim's uniform thermal plasma at n^ndim cells in a
    40 um box: electrons and a second species of the electron's mass and
    opposite charge, ``ppc`` particles per cell each, Yee, dt at 0.999 of
    the Courant limit; ``kw`` sets the tiling."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    lx = 40e-6
    geom = Geometry(ndim=ndim, n_cell=(n,) * ndim, prob_lo=(-lx / 2,) * ndim,
                    prob_hi=(lx / 2,) * ndim, periodic=(True,) * ndim)
    species = tuple(
        SpeciesConfig(
            name=nm, charge=q, mass=9.1093837015e-31,
            injection_style="nuniformpercell",
            num_particles_per_cell_each_dim=ppc,
            profile="constant", density=2.0e24,
            momentum_distribution="gaussian",
            ux_th=u_th, uy_th=u_th, uz_th=u_th,
        )
        for nm, q in (("electrons", -1.602176634e-19),
                      (second, 1.602176634e-19))
    )
    return SimConfig(geometry=geom, max_step=max_step,
                     dt=compute_dt_yee(geom, 0.999), particle_shape=order,
                     species=species, tiled_particles="on", **kw)


def small_cfg(ndim):
    """test_binned.py's order-1 configurations: 16^3 or 32^2, 8 steps."""
    return plasma_cfg(ndim, 16 if ndim == 3 else 32, (2, 1, 1), 1, 0.1,
                      "positrons", 8, sort_interval=3)


def main_cfg(n=128, steps=25):
    """uniform-128, the 3D main path: bench.py::_build_sim at n = 128,
    ppc = 2, order 1, with the f32 deposit and gather (tile_mxu='f32')."""
    return plasma_cfg(3, n, (2, 1, 1), 1, 0.01, "ions", steps,
                      sort_interval=60, sort_margin=1, tile_headroom=1.125,
                      tile_mxu="f32")


def main2d_cfg(n=2048, steps=38):
    """uniform2d-2048, the 2D main path: the same plasma in the XZ plane at
    2048^2 cells, (2, 2) particles per cell each, with the shape order (3)
    and the sort interval (16) of bench.py::run_lwfa's deck."""
    return plasma_cfg(2, n, (2, 2), 3, 0.01, "ions", steps,
                      sort_interval=16, sort_margin=1, tile_headroom=1.125,
                      tile_mxu="f32")


# Floating-point operations of one call of each pusher in
# csrc/fused_pic_common.cuh, counted term by term (an add, a multiply, a
# divide and a square root are one each; inv_gamma is 9)
PUSH_FLOPS = {"boris": 64, "vay": 99, "higuera": 95}
# ... and of the order + 1 non-zero values of spline() a particle has at
# orders 1-3 (order 2: one inner branch of 2 and two outer of 3; order 3: two
# inner of 5 and two outer of 4); a value outside the support costs none
SPLINE_SET_FLOPS = {1: 2, 2: 8, 3: 18}


def fused_flops(order, galerkin, ndim, pusher, mxu="f32"):
    """Floating-point operations of K1 (ndim 3) or K2 (ndim 2) for one slot,
    counted from the loops of csrc/fused_pic.cu and csrc/fused_pic_2d.cu as
    (what every slot of an occupied tile needs: coordinates, gather, push;
    what only an alive slot needs: the Esirkepov weights and the deposit).
    The kernels' tails for a stencil clipped at the window's low side are
    left out: on a path with zero violations no alive particle takes them.
    In the precision modes a conversion to or from bfloat16 is not counted
    (it is no arithmetic): the gather's count is unchanged, and a deposit
    product becomes dot3x's seven operations in 'mixed' (two remainders,
    three products, two adds); in 3D 'bf16' adds one per point (two
    products where 'f32' has one) and two per row (the two scaled rows).
    K1 computes each axis's two gather weight sets once; its deposit
    counts the ``order`` rows along the deposit axis that every alive
    particle visits (one that crosses a cell face visits one more)."""
    from warpx_tpu_torch.core.grid import yee_staggering
    from warpx_tpu_torch.ops.fused_pic import _gather_table

    nt = order + 3
    gorder, gstag = _gather_table(order, galerkin, yee_staggering(ndim), ndim)

    def weights(o):  # gather_weights(): rounding add, offsets, splines
        return 2 if o == 0 else (o % 2 == 0) + (o + 1) + SPLINE_SET_FLOPS[o]

    every = 3 * ndim  # X = (pos - lo) * inv_dx - worig
    if ndim == 3:  # per axis the nodal set, X - 1/2 and the staggered set
        every += 3 * (weights(order) + 1 + weights(order - bool(galerkin)))
    for c in range(6):
        o = gorder[c * ndim:(c + 1) * ndim]
        taps = int(np.prod([v + 1 for v in o]))
        if ndim == 2:
            every += sum(gstag[c * ndim:(c + 1) * ndim])  # X - 1/2
            every += sum(weights(v) for v in o)
        # per tap a multiply-add (3D: and the product of two weights), per x
        # row a multiply-add, then the external field
        every += (ndim * taps) + 2 * (o[0] + 1) + 1
    # the pusher, 1 / gamma again, the velocities, pos + v * dt
    every += PUSH_FLOPS[pusher] + 9 + 3 + 2 * ndim
    if ndim == 3:
        # X, 1 / gamma and the velocities again, x_new; per axis the old
        # and new weight sets and per spanned row sm, df and the running
        # sum; wq; per component its scale, per row cs * scale, per point
        # seven
        nu = order + 2
        point = {"f32": 7, "mixed": 13, "bf16": 8}[mxu]
        row = 1 + (2 if mxu == "bf16" else 0)
        alive = (9 + 9 + 3 + 6 + 3 * (2 * weights(order) + 3 * nu) + 1
                 + 3 * (1 + order * (row + nu * nu * point)))
    else:
        # per axis: x_new (2), its rounding add at order 2, and per stencil
        # row two offsets, sm, df and the running sum, with both spline sets
        alive = 2 * (2 + (order % 2 == 0) + nt * 5
                     + 2 * SPLINE_SET_FLOPS[order])
        # wq, the three scales (5); per x row four factors (6); per point
        # Jx (2), Jz (2), Jy (3) and their three atomic adds; 'mixed' makes
        # each of the four products seven
        point = 10 + (24 if mxu == "mixed" else 0)
        alive += 5 + nt * 6 + nt * nt * point
    return every, alive


def ptxas_report(log):
    """ptxas's -v report in a library's build log: {function: registers}
    for the kernels and {function: spill bytes (stores and loads)} for every
    function, device functions included."""
    import re

    regs, spills = {}, {}
    fn = entry = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        if "spill stores" in ln and fn is not None:
            spills[fn] = sum(int(v) for v in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", ln))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
    return regs, spills


def fused_resources(ndim, dtype, order, mxu):
    """K1's (ndim 3) or K2's (ndim 2) kernel in precision mode ``mxu``:
    registers a thread and spill bytes (stores and loads) from ptxas's
    report in its library's build log, resident blocks per SM from the CUDA
    occupancy calculator."""
    from warpx_tpu_torch import build
    from warpx_tpu_torch.ops import fused_pic as fp

    lib = fp._library_name(ndim, dtype, order)
    want = "{}_kernelI{}Li{}ELi{}E".format(
        "fused_pic" if ndim == 3 else "fused_pic_2d",
        "d" if dtype == torch.float64 else "f", order, fp.MXU_MODES[mxu])
    regs, spills = ptxas_report(build.build_log(lib))
    kern = [nm for nm in regs if want in nm]
    if len(kern) != 1 or kern[0] not in spills:
        raise AssertionError(f"no ptxas report for {want} in {lib}'s log")
    return {"registers": regs[kern[0]], "spills": spills[kern[0]],
            "blocks_per_sm": fp.blocks_per_sm(ndim, dtype, order, mxu)}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _counter(obj, key, value=None):
    """Read a launch counter (an attribute, or an entry of a dict such as
    ``binned_push_deposit.launches_by_mode``), or set it to ``value``."""
    if value is None:
        return obj[key] if isinstance(obj, dict) else getattr(obj, key)
    if isinstance(obj, dict):
        obj[key] = value
    else:
        setattr(obj, key, value)
    return value


def run_main_path(dev, smi, phase, cfg, n_particles, steps, counters):
    """Drive one main path through Simulation: init, a warm step, ``steps``
    timed steps, PROFILED_STEPS profiled steps and the closing step, with
    the launch counters in ``counters`` (name -> (object, attribute or
    key)) set to 0 just before and read just after.  Checks the result (zero overflow
    and violations, every particle alive, weight conserved, finite fields
    of the grid's shape) and emits the phase's line and its profile.
    Returns (sim, launches)."""
    import warpx_tpu_torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if not sim.binned:
        raise AssertionError(f"the {phase} path did not take the tile-binned "
                             "step")
    for obj, attr in counters.values():
        _counter(obj, attr, 0)
    sim.init()
    sim.evolve(1)  # warm step: rebins (K3) and the first fused launch
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the timed window, with an event after every step: the window's time
    # is first to last event, the series shows how the step's cost moves
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    ms_total = marks[0].elapsed_time(marks[-1])
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    breakdown = profile_steps(sim, PROFILED_STEPS)
    sim.evolve()  # the closing step, with the +dt/2 synchronization
    torch.cuda.synchronize()
    launches = {nm: _counter(obj, attr)
                for nm, (obj, attr) in counters.items()}
    peak_steps = torch.cuda.max_memory_allocated()
    # one more step from the state the run ended in, not kept: the step's
    # time under the conditions the kernels are timed in below
    ms_final = cuda_ms(lambda: sim.step(sim.state), 5)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the {phase} path never ran: "
                             f"{launches}")
    spec = sim.tile_spec
    geom = cfg.geometry
    stepped = sim.state
    sums = sim.checksums()  # raises on tile overflow or violations
    for group in sums.values():
        for q, v in group.items():
            if not np.isfinite(v):
                raise AssertionError(f"non-finite checksum {q}")
    alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    if alive != n_particles:
        raise AssertionError(f"{alive} alive particles of {n_particles}")
    for sp_cfg in cfg.species:
        # a uniform species' weights sum to density * volume
        total_w = sp_cfg.density * geom.cell_volume * np.prod(geom.n_cell)
        w_rel = abs(sums[sp_cfg.name]["particle_weight"] / total_w - 1)
        if w_rel > 1e-5:
            raise AssertionError(f"{sp_cfg.name} weight drifted by {w_rel}")
    for f in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        a = getattr(sim.state.fields, f)
        if (tuple(a.shape) != tuple(geom.n_cell)
                or not bool(torch.isfinite(a).all())):
            raise AssertionError(f"field {f} is not finite at {geom.n_cell}")
    ms_step = ms_total / steps
    emit(phase, ok=True, n_cell=geom.n_cell, n_particles=n_particles,
         order=cfg.particle_shape, tile_mxu=cfg.tile_mxu,
         n_tiles=spec.n_tiles, w=spec.w,
         p_max=spec.p_max, steps_timed=steps, ms_per_step=ms_step,
         pushes_per_s=n_particles / (ms_step * 1e-3), init_s=init_s,
         launches=launches, tile_overflow=0, tile_violations=0,
         ms_per_step_final_state=ms_final, ms_each_step=series,
         peak_memory_bytes={"steps": peak_steps, "with_checksums":
                            torch.cuda.max_memory_allocated()},
         checksum_Ex=sums["lev=0"]["Ex"], checksum_jx=sums["lev=0"]["jx"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit(phase + "_profile", steps=PROFILED_STEPS, **breakdown)
    # checksums() wrapped the positions; the kernels are timed on the state
    # the next step would give them
    sim.state = stepped
    return sim, launches


def fused_at_main_shapes(sim, plain_reps, window=None, mxu="f32"):
    """K1 or K2 on the state ``sim`` ended in, against the plain version:
    errors, times, bytes (each input read once, each output written once),
    operations (``fused_flops``: gather and push for every slot of an
    occupied tile, weights and deposit for the alive slots) and the bound.
    ``window`` = (fields6, pusher params, anchors, zshift, smax) runs the
    kernel in moving-window mode on the bounded step's inputs; ``mxu`` is
    the precision mode, and a mode other than 'f32' is timed beside the
    kernel at 'f32' on the same inputs.  The row adds the kernel's
    registers, spills and resident blocks per SM (``fused_resources``), the
    tiles of one launch that took its checked path and the tiles with an
    alive particle.  Returns the kernels-line fields that are measured
    here."""
    from warpx_tpu_torch.core.binned_step import pusher_groups
    from warpx_tpu_torch.ops import fused_pic as fp

    cfg, spec, state = sim.cfg, sim.tile_spec, sim.state
    mode, plain_mode, group_params = {}, {}, sim.params
    if window is None:
        farr = state.fields
        fields6 = fp.pad_fields((farr.Ex, farr.Ey, farr.Ez, farr.Bx, farr.By,
                                 farr.Bz), spec)
    else:
        fields6, group_params, anchors, zshift, smax = window
        mode = dict(anchors=anchors, zshift=zshift, smax=smax)
        plain_mode = dict(lo=anchors, zoff=smax - zshift)
    ((pname, _, params, parts, counts),) = list(
        pusher_groups(state, spec, group_params))
    kw = dict(spec=spec, geom=cfg.geometry, order=cfg.particle_shape,
              galerkin=cfg.galerkin, pusher_name=pname, dt=cfg.dt,
              stag_items=stag_items(spec.ndim), mxu=mxu)
    args = (params, fields6, parts)
    tol_j = (TOL_J_BF16 if mxu == "bf16"
             else TOL_J_MAIN if window is None else TOL_J_WINDOW)
    errs, _, worst_p, worst_j, _ = kernel_compare(
        fp, args, counts, kw, TOL[torch.float32], tol_j,
        anchors=mode.get("anchors"), zshift=mode.get("zshift"),
        smax=mode.get("smax", 0))

    def launch():
        return fp.binned_push_deposit(*args, counts=counts, **mode, **kw)

    ms = cuda_ms(launch, 10)
    f32_ms = None
    if mxu != "f32":
        f32_ms = cuda_ms(lambda: fp.binned_push_deposit(
            *args, counts=counts, **mode, **{**kw, "mxu": "f32"}), 10)
    plain_ms = cuda_ms(lambda: fp.binned_push_deposit_plain(
        *args, counts, **plain_mode, **kw), plain_reps)
    dev = parts[0].device
    wide0 = fp.wide_tiles(dev, spec.ndim)
    out = launch()
    n_bytes = (nbytes(params, counts, *fields6, *parts)
               + nbytes(*out[0], *out[1], out[2]))
    every, alive = fused_flops(cfg.particle_shape, cfg.galerkin, spec.ndim,
                               pname, mxu)
    flops = (int((counts > 0).sum()) * spec.p_max * every
             + int(counts.sum()) * alive)
    tb = n_bytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[torch.float32] * 1e3
    row = {"max_abs_err": max(a for a, _ in errs.values()),
           "max_rel_err": {"particles": worst_p, "j": worst_j},
           "tol_rel": {"particles": TOL[torch.float32], "j": tol_j},
           "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
           "bound_ms": max(tb, tf),
           "bound_by": "bytes" if tb >= tf else "operations",
           "bytes": n_bytes, "flops": flops,
           "flops_per_slot": {"every": every, "alive": alive},
           "library_ms": None}
    row.update(fused_resources(spec.ndim, torch.float32, cfg.particle_shape,
                               mxu),
               wide_tiles=fp.wide_tiles(dev, spec.ndim) - wide0,
               occupied_tiles=int((counts.reshape(
                   -1, spec.n_tiles) > 0).any(0).sum()))
    return row


def k3_at_main_shapes(sim, origin=None, wrap_dims=None):
    """K3 on the electrons of the state ``sim`` ended in, against the plain
    version (exactly), with its times, bytes and bound; ``origin`` and
    ``wrap_dims`` as the bounded step gives them to the rebin."""
    from warpx_tpu_torch.ops import tiling

    spec = sim.tile_spec
    k3_in = tiling.rebin_inputs(sim.state.species["electrons"],
                                sim.cfg.geometry, spec, origin=origin,
                                wrap_dims=wrap_dims)
    got = tiling.ragged_expand(*k3_in, spec.p_max)
    ref = tiling.ragged_expand_plain(*k3_in, spec.p_max)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K3 disagrees with its plain version at the "
                             "main path's shapes")
    del ref
    ms = cuda_ms(lambda: tiling.ragged_expand(*k3_in, spec.p_max), 10)
    plain_ms = cuda_ms(lambda: tiling.ragged_expand_plain(
        *k3_in, spec.p_max), 3)
    payload, offsets, counts, fill = k3_in
    kept = int(torch.clamp(counts, max=spec.p_max).sum())
    n_bytes = (payload.shape[0] * kept * payload.element_size()
               + nbytes(offsets, counts, fill, got))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": n_bytes, "library_ms": None}


def phase_main(dev, smi, n=128):
    """uniform-128 through K1 and K3; returns their kernels-line rows."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    sim, launches = run_main_path(
        dev, smi, "main", main_cfg(n), 2 * 2 * n ** 3, 20,
        {"fused_pic": (fp.binned_push_deposit, "launches"),
         "ragged_expand": (tiling.ragged_expand, "launches")})
    k1 = fused_at_main_shapes(sim, 2)
    k3 = k3_at_main_shapes(sim)
    return ({"name": "fused_pic", "route": "cuda",
             "source": "warpx_tpu_torch/csrc/fused_pic.cu",
             "replaces": "warpx_tpu/ops/pallas_pic.py:116",
             "launches": launches["fused_pic"], **k1},
            {"name": "ragged_expand", "route": "cuda",
             "source": "warpx_tpu_torch/csrc/ragged_expand.cu",
             "replaces": "warpx_tpu/ops/tiling.py:142",
             "launches": launches["ragged_expand"],
             "launches_by_path": {"main": launches["ragged_expand"]}, **k3})


def phase_main_mixed(dev, smi, k3_row, n=128):
    """uniform-128 at tile_mxu = 'mixed', bench.py's default for this
    workload, driven as ``main`` drives it; then the same at 'bf16', which
    bench.py measures beside 'f32'.  After each, K1 in that mode at
    the main path's shapes against its plain version, timed beside K1 at
    'f32' on the same inputs and beside its bound.  Returns the two
    kernels-line rows and adds these paths' K3 launches to ``k3_row``."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    by_mode = fp.binned_push_deposit.launches_by_mode
    rows = []
    for mxu in ("mixed", "bf16"):
        phase = f"main_{mxu}"
        by_mode["f32"] = 0
        sim, launches = run_main_path(
            dev, smi, phase, dataclasses.replace(main_cfg(n), tile_mxu=mxu),
            2 * 2 * n ** 3, 20,
            {"fused_pic": (fp.binned_push_deposit, "launches"),
             f"fused_pic_{mxu}": (by_mode, mxu),
             "ragged_expand": (tiling.ragged_expand, "launches")})
        if by_mode["f32"] or launches[f"fused_pic_{mxu}"] != launches[
                "fused_pic"]:
            raise AssertionError(f"{phase} launched K1 in another mode: "
                                 f"{launches}, {by_mode}")
        k1 = fused_at_main_shapes(sim, 2, mxu=mxu)
        k3_row["launches"] += launches["ragged_expand"]
        k3_row["launches_by_path"][phase] = launches["ragged_expand"]
        rows.append({"name": f"fused_pic_{mxu}", "route": "cuda",
                     "source": "warpx_tpu_torch/csrc/fused_pic.cu",
                     "replaces": "warpx_tpu/ops/pallas_pic.py:133",
                     "mxu": mxu, "launches": launches[f"fused_pic_{mxu}"],
                     **k1})
        del sim
    return rows


def phase_main2d(dev, smi, k3_row, n=2048):
    """uniform2d-2048 through K2 and K3; returns K2's kernels-line row and
    adds this path's K3 launches and times to ``k3_row``."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    steps = 33  # after the warm step 0: rebins at steps 16 and 32
    sim, launches = run_main_path(
        dev, smi, "main2d", main2d_cfg(n), 2 * 4 * n * n, steps,
        {"fused_pic_2d": (fp.binned_push_deposit, "launches_2d"),
         "ragged_expand": (tiling.ragged_expand, "launches")})
    k2 = fused_at_main_shapes(sim, 1)
    k3 = k3_at_main_shapes(sim)
    k3_row["launches"] += launches["ragged_expand"]
    k3_row["launches_by_path"]["main2d"] = launches["ragged_expand"]
    k3_row["at_main2d"] = k3
    return {"name": "fused_pic_2d", "route": "cuda",
            "source": "warpx_tpu_torch/csrc/fused_pic_2d.cu",
            "replaces": "warpx_tpu/ops/pallas_pic.py:408",
            "launches": launches["fused_pic_2d"], **k2}


# ---- the bounded step ------------------------------------------------------

Q_E = 1.602176634e-19
M_E = 9.1093837015e-31
M_P = 1.67262192369e-27


def lwfa_cfg(n_cell, lo, hi, x_bound, zmin, beam_z, laser_z, ppc, max_step,
             interval, **kw):
    """The 2D laser-wakefield deck of bench.py (``_LWFA_2D_DECK``) and of
    tests/test_binned_bounded.py as a SimConfig, field for field: PML on the
    four faces, absorbing particle faces, moving window along z at c, current
    filter, order 3, Yee at 0.98 of the Courant limit; electrons at
    2e23 m^-3 within |x| <= ``x_bound`` above ``zmin``, continuously
    injected; a 100-particle Gaussian beam at ``beam_z``; a Gaussian laser
    antenna at ``laser_z``.  The laser's species comes last, as the deck
    reader orders it."""
    from warpx_tpu_torch.core.config import (LaserConfig, SimConfig,
                                             SpeciesConfig)
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    inf = float("inf")
    geom = Geometry(ndim=2, n_cell=tuple(n_cell), prob_lo=tuple(lo),
                    prob_hi=tuple(hi), periodic=(False, False))
    electrons = SpeciesConfig(
        name="electrons", charge=-Q_E, mass=M_E, species_type="electron",
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=ppc, profile="constant",
        density=2.0e23, momentum_distribution="at_rest",
        bounds_lo=(-x_bound, zmin), bounds_hi=(x_bound, inf),
        do_continuous_injection=True)
    beam = SpeciesConfig(
        name="beam", charge=-Q_E, mass=M_E, species_type="electron",
        injection_style="gaussian_beam", x_rms=0.5e-6, y_rms=0.5e-6,
        z_rms=0.5e-6, x_m=0.0, y_m=0.0, z_m=beam_z, npart=100,
        q_tot=-1.0e-12, momentum_distribution="gaussian", ux=0.0, uy=0.0,
        uz=500.0, ux_th=2.0, uy_th=2.0, uz_th=50.0,
        bounds_lo=(-inf, -inf), bounds_hi=(inf, inf))
    laser = LaserConfig(
        name="laser1", profile="gaussian", position=(0.0, 0.0, laser_z),
        direction=(0.0, 0.0, 1.0), polarization=(0.0, 1.0, 0.0),
        e_max=16.0e12, profile_waist=5.0e-6, profile_duration=15.0e-15,
        profile_t_peak=30.0e-15, profile_focal_distance=100.0e-6,
        wavelength=0.8e-6)
    antenna = SpeciesConfig(name="laser1", charge=1.0, mass=0.0,
                            injection_style="laser")
    return SimConfig(
        geometry=geom, max_step=max_step, dt=compute_dt_yee(geom, 0.98),
        cfl=0.98, particle_shape=3, em_solver="yee", use_filter=True,
        filter_npass_each_dir=(1, 1), species=(electrons, beam, antenna),
        lasers=(laser,), field_bc_lo=("pml", "pml"),
        field_bc_hi=("pml", "pml"), particle_bc_lo=("absorbing",) * 2,
        particle_bc_hi=("absorbing",) * 2, do_moving_window=True,
        moving_window_dir=1, moving_window_v=1.0, sort_interval=interval,
        tiled_particles="on", tile_mxu="f32", **kw)


# The deck texts this script runs through Simulation.from_deck, kept as
# copies (it imports neither bench.py nor the tests, which import JAX;
# tests/test_torch_deck.py holds the copies equal): bench.py::_LWFA_2D_DECK
# and tests/test_binned_bounded.py::_LWFA_2D.
LWFA_2D_DECK = """
max_step = {max_step}
amr.n_cell = {nx} {nz}
geometry.dims = 2
geometry.prob_lo = -30.e-6 -56.e-6
geometry.prob_hi =  30.e-6  12.e-6
boundary.field_lo = pml pml
boundary.field_hi = pml pml
warpx.verbose = 0
warpx.use_filter = 1
warpx.cfl = 0.98
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = {interval}
tpu.tiled_particles = on
tpu.tile_mxu = {mxu}
algo.particle_shape = 3
algo.maxwell_solver = yee
particles.species_names = electrons beam
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {ppcx} {ppcz} 1
electrons.xmin = -20.e-6
electrons.xmax =  20.e-6
electrons.zmin = -56.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.momentum_distribution_type = at_rest
electrons.do_continuous_injection = 1
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = .5e-6
beam.y_rms = .5e-6
beam.z_rms = .5e-6
beam.x_m = 0.
beam.y_m = 0.
beam.z_m = -28.e-6
beam.npart = 100
beam.q_tot = -1.e-12
beam.momentum_distribution_type = gaussian
beam.ux_m = 0.0
beam.uy_m = 0.0
beam.uz_m = 500.
beam.ux_th = 2.
beam.uy_th = 2.
beam.uz_th = 50.
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. 9.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 16.e12
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
laser1.wavelength = 0.8e-6
"""
LWFA_32X64_DECK = """
max_step = 12
amr.n_cell = 32 64
geometry.dims = 2
geometry.prob_lo = -15.e-6 -28.e-6
geometry.prob_hi =  15.e-6   6.e-6
boundary.field_lo = pml pml
boundary.field_hi = pml pml
warpx.cfl = 0.98
warpx.use_filter = 1
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = 4
algo.particle_shape = 3
algo.maxwell_solver = yee
particles.species_names = electrons beam
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.xmin = -12.e-6
electrons.xmax =  12.e-6
electrons.zmin = -20.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.momentum_distribution_type = at_rest
electrons.do_continuous_injection = 1
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = .5e-6
beam.y_rms = .5e-6
beam.z_rms = .5e-6
beam.x_m = 0.
beam.y_m = 0.
beam.z_m = -14.e-6
beam.npart = 100
beam.q_tot = -1.e-12
beam.momentum_distribution_type = gaussian
beam.ux_m = 0.0
beam.uy_m = 0.0
beam.uz_m = 500.
beam.ux_th = 2.
beam.uy_th = 2.
beam.uz_th = 50.
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -10.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 16.e12
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
laser1.wavelength = 0.8e-6
"""


def small_lwfa_cfg():
    """tests/test_binned_bounded.py's 32 x 64 deck, 12 steps."""
    return lwfa_cfg((32, 64), (-15e-6, -28e-6), (15e-6, 6e-6), 12e-6, -20e-6,
                    -14e-6, -10e-6, (1, 1, 1), 12, 4)


def main_lwfa_cfg(nx=2048, nz=8192, steps=95):
    """lwfa2d-2048x8192: bench.py::run_lwfa's deck (60 um x 68 um window,
    the plasma filling it from its lower edge, 2 x 2 per cell, sort interval
    16) with tile_mxu='f32'."""
    return lwfa_cfg((nx, nz), (-30e-6, -56e-6), (30e-6, 12e-6), 20e-6,
                    -56e-6, -28e-6, 9e-6, (2, 2, 1), steps, 16)


def pec3d_cfg():
    """tests/test_binned_bounded.py's 16^3 deck: periodic in x and y, PEC
    walls and reflecting particles along z, thermal electrons and protons
    at rest, order 2, current filter, 8 steps; with three particles per
    cell instead of one, because a species of at most 8192 particles keeps
    its compact layout and would never reach K1."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    geom = Geometry(ndim=3, n_cell=(16,) * 3, prob_lo=(-8e-6,) * 3,
                    prob_hi=(8e-6,) * 3, periodic=(True, True, False))
    common = dict(injection_style="nuniformpercell",
                  num_particles_per_cell_each_dim=(1, 1, 3),
                  profile="constant", density=1.0e24)
    species = (
        SpeciesConfig(name="electrons", charge=-Q_E, mass=M_E,
                      species_type="electron",
                      momentum_distribution="gaussian", ux_th=0.05,
                      uy_th=0.05, uz_th=0.05, **common),
        SpeciesConfig(name="protons", charge=Q_E, mass=M_P,
                      species_type="proton",
                      momentum_distribution="at_rest", **common))
    return SimConfig(
        geometry=geom, max_step=8, dt=compute_dt_yee(geom, 0.98), cfl=0.98,
        particle_shape=2, use_filter=True, filter_npass_each_dir=(1, 1, 1),
        species=species, field_bc_lo=("periodic", "periodic", "pec"),
        field_bc_hi=("periodic", "periodic", "pec"),
        particle_bc_lo=("periodic", "periodic", "reflecting"),
        particle_bc_hi=("periodic", "periodic", "reflecting"),
        tiled_particles="on")


def phase_bounded_parity(dev):
    """The bounded tile-binned step on the card (kernels) against the same
    run on the CPU (plain versions), float64: every checksum but divE/divB
    within 1e-9, no overflow or violation, the window moved, and the fused
    kernel was launched once per step, so that a fall to the per-particle
    step fails."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for name, cfg, counter in (("lwfa_32x64", small_lwfa_cfg(), "launches_2d"),
                               ("pec_16^3", pec3d_cfg(), "launches")):
        sums = {}
        before = getattr(fp.binned_push_deposit, counter)
        for device in (dev, "cpu"):
            sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                             device=device)
            if not (sim.is_bounded and sim.binned):
                raise AssertionError(f"{name} did not take the bounded "
                                     "tile-binned step")
            sim.init()
            sim.evolve()
            sums[str(device)] = sim.checksums()  # raises on overflow etc.
            if device is dev:
                aux = sim.state.aux
                zshifts = sorted(sim.stepper.zshifts_seen)
        grew = getattr(fp.binned_push_deposit, counter) - before
        if grew != cfg.max_step:
            raise AssertionError(f"{name}: {grew} fused launches in "
                                 f"{cfg.max_step} steps")
        if cfg.do_moving_window and not (
                aux["window_offset"] > 0
                and aux["window_lo"] > cfg.geometry.prob_lo[1]):
            raise AssertionError(f"{name}: the window did not move")
        worst = checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                                f"{name} card vs CPU")
        cases.append({"case": name, "steps": cfg.max_step,
                      "fused_launches": grew, "max_rel_err": worst,
                      "window_offset": int(aux.get("window_offset", 0)),
                      "zshifts_seen": zshifts})
    emit("bounded_parity", ok=True, tol=1e-9, cases=cases)


def quiet_step(s0, interval):
    """Whether the bounded binned step from step ``s0`` neither rebins (it
    does when ``s0`` is a multiple of the sort interval) nor injects (at the
    end of the step before a rebin)."""
    return bool(s0 % interval and (s0 + 1) % interval)


def count_device_waits(fn):
    """The number of times ``fn()`` makes the host wait for the device, from
    PyTorch's own warnings (torch.cuda.set_sync_debug_mode)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def lwfa_layers(sim, anchors, zshift):
    """Device milliseconds of the bounded step's layers, each called alone
    on the state the run ended in (a step without rebin or injection), and
    of the whole step there."""
    from warpx_tpu_torch.core.binned_step import pusher_groups
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling
    from warpx_tpu_torch.solvers.filter import bilinear_filter_padded

    stepper, spec, cfg, state = sim.stepper, sim.tile_spec, sim.cfg, sim.state
    geom, fields = cfg.geometry, state.fields
    fields6 = stepper.to_kernel_frame(stepper._padded_eb(fields))
    ((pname, _, params, parts, counts),) = list(
        pusher_groups(state, spec, stepper.params))
    _, jw, _ = fp.binned_push_deposit(
        params, fields6, parts, anchors, zshift, counts=counts, spec=spec,
        geom=geom, order=cfg.particle_shape, galerkin=cfg.galerkin,
        pusher_name=pname, dt=cfg.dt, stag_items=stepper.stag_items,
        smax=stepper.smax)
    del fields6, parts

    def fold():
        return tuple(stepper.embed_folded(
            tiling.fold_windows_open(jw[i], spec), zshift) for i in range(3))

    j_total = fold()
    npass = cfg.filter_npass_each_dir
    el = state.species["electrons"]
    return {
        "pad_eb_and_kernel_frame": cuda_ms(
            lambda: stepper.to_kernel_frame(stepper._padded_eb(fields)), 5),
        "pack_species_columns": cuda_ms(
            lambda: list(pusher_groups(state, spec, stepper.params)), 5),
        "fold_windows_open_and_embed": cuda_ms(fold, 5),
        "filter_j": cuda_ms(
            lambda: [bilinear_filter_padded(a, npass) for a in j_total], 5),
        "field_tail_filter_included": cuda_ms(
            lambda: stepper.field_tail(state, state.species, j_total, {}), 5),
        "step_window_shift_and_faces": cuda_ms(
            lambda: stepper.step_window(state, False), 5),
        "rebin_electrons": cuda_ms(
            lambda: tiling.rebin(el, geom, spec, origin=anchors,
                                 wrap_dims=stepper.wrap_dims), 3),
        "continuous_injection": cuda_ms(
            lambda: stepper.continuous_injection(
                state, cfg.species[0], el, stepper.phys_lo_of(state),
                stepper.domain_hi_of(state)), 3),
        "step_binned": cuda_ms(lambda: stepper.step(state), 5),
    }


LWFA_PLAN = dict(warm=32, timed=32, counted=16, interval=16)


def lwfa_steps(plan):
    """The steps a laser-wakefield phase runs: warm, timed, counted, one
    rebin step, the profiled steps and two closing steps."""
    return (plan["warm"] + plan["timed"] + plan["counted"] + 1
            + PROFILED_STEPS + 2)


def run_lwfa_path(dev, smi, phase, sim, plan):
    """Drive the bounded laser-wakefield path ``sim`` (built, not yet
    initialised): init, ``warm`` steps (two rebins, the window moving),
    ``timed`` steps with an event after each, ``counted`` steps with the
    host's waits for the device counted, a rebin step, PROFILED_STEPS
    profiled steps and the closing steps, with the launch counters of K2
    (in ``cfg.tile_mxu``, and in no other mode) and K3 set to 0 just before
    and read just after.  Checks the result (zero overflow and violations,
    finite fields of the block's shapes, the window moved, the alive
    electrons explained by the rows absorbed and injected) and emits the
    phase's line and its profile.  Returns (launches, anchors, zshift,
    waits): the tiling anchor and the window's slide the next step would
    give K2, and the counted steps' waits for the device (``idle``: the set
    of counts of the steps that neither rebin nor inject)."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    cfg = sim.cfg
    geom = cfg.geometry
    steps = lwfa_steps(plan)
    if cfg.max_step != steps:
        raise AssertionError(f"{phase}: max_step {cfg.max_step} for {steps} "
                             "steps")
    if not (sim.is_bounded and sim.binned):
        raise AssertionError(f"{phase} did not take the bounded tile-binned "
                             "step")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    by_mode = fp.binned_push_deposit.launches_by_mode
    for k in by_mode:
        by_mode[k] = 0
    fp.binned_push_deposit.launches_2d = 0
    tiling.ragged_expand.launches = 0
    sim.init()
    spec, stepper = sim.tile_spec, sim.stepper
    n0 = {nm: int(sp.alive.sum()) for nm, sp in sim.state.species.items()}
    host_init_s = time.perf_counter() - t0
    sim.evolve(plan["warm"])  # two rebins, the window moving
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = plan["timed"]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    ms_step = marks[0].elapsed_time(marks[-1]) / timed
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    first = sim.state.step
    per_step = [count_device_waits(lambda: sim.evolve(1))
                for _ in range(plan["counted"])]
    waits_by_step = {
        "first_step": first, "per_step": per_step,
        "idle": sorted({w for i, w in enumerate(per_step)
                        if quiet_step(first + i, plan["interval"])})}
    sim.evolve(1)  # a rebin step: the profiled ones that follow have none
    breakdown = profile_steps(sim, PROFILED_STEPS, top=30)
    sim.evolve()  # the closing steps, with the +dt/2 synchronization
    torch.cuda.synchronize()
    if sim.state.step != steps:
        raise AssertionError(f"{phase} ended at step {sim.state.step}")
    launches = {"fused_pic_2d": fp.binned_push_deposit.launches_2d,
                "ragged_expand": tiling.ragged_expand.launches}
    rebins = len(range(0, steps, plan["interval"]))
    if launches != {"fused_pic_2d": steps, "ragged_expand": rebins}:
        raise AssertionError(f"{phase} launched {launches} in {steps} "
                             f"steps with {rebins} rebins")
    if by_mode != {m: (steps if m == cfg.tile_mxu else 0) for m in by_mode}:
        raise AssertionError(f"{phase} at tile_mxu={cfg.tile_mxu!r} "
                             f"launched K2 in the modes {by_mode}")
    peak_steps = torch.cuda.max_memory_allocated()
    zshifts = sorted(stepper.zshifts_seen)
    if not (zshifts[0] == 0 and zshifts[-1] < stepper.smax
            and len(zshifts) >= plan["interval"] - 1):
        raise AssertionError(f"zshift took {zshifts} of [0, {stepper.smax})")
    stepped = sim.state
    sums = sim.checksums()  # raises on tile overflow or violations
    for group in sums.values():
        for q, v in group.items():
            if not np.isfinite(v):
                raise AssertionError(f"non-finite checksum {q}")
    for nm, shape in stepper.shapes.items():
        if nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
            a = getattr(sim.state.fields, nm)
            if (tuple(a.shape) != tuple(shape)
                    or not bool(torch.isfinite(a).all())):
                raise AssertionError(f"field {nm} is not finite at {shape}")
    aux = sim.state.aux
    offset = int(aux["window_offset"])
    if offset <= 0:
        raise AssertionError("the window did not move")
    # the electrons are at rest: each cell row along z that the window left
    # behind took its particles along, each row injected brought as many
    alive = {nm: int(sp.alive.sum()) for nm, sp in sim.state.species.items()}
    per_row = n0["electrons"] / geom.n_cell[1]
    rows_in = round(float(aux["inject_pos:electrons"] - geom.prob_hi[1])
                    / geom.dx[1])
    expected = n0["electrons"] + (rows_in - offset) * per_row
    if abs(alive["electrons"] - expected) > per_row:
        raise AssertionError(f"{alive['electrons']} electrons alive, "
                             f"{expected} explained by {offset} rows "
                             f"absorbed and {rows_in} injected")
    n_mean = 0.5 * (n0["electrons"] + alive["electrons"])
    emit(phase, ok=True, n_cell=geom.n_cell, tile_mxu=cfg.tile_mxu,
         field_shape=stepper.shapes["Ex"], alive_at_init=n0,
         alive_at_end=alive, electrons_expected=expected,
         rows_absorbed=offset, rows_injected=rows_in, order=cfg.particle_shape,
         n_tiles=spec.n_tiles, w=spec.w, p_max=spec.p_max,
         slots=spec.capacity, smax=stepper.smax, zshifts_seen=zshifts,
         slow_species=sorted(stepper.slow_species), steps=steps,
         steps_timed=timed, ms_per_step=ms_step,
         pushes_per_s=n_mean / (ms_step * 1e-3), ms_each_step=series,
         host_init_s=host_init_s, init_and_warm_s=init_s, launches=launches,
         launches_by_mode=dict(by_mode),
         device_waits={"steps": plan["counted"], "waits": sum(per_step),
                       **waits_by_step},
         tile_overflow=0, tile_violations=0,
         window_offset=offset,
         peak_memory_bytes={"steps": peak_steps, "with_checksums":
                            torch.cuda.max_memory_allocated()},
         checksum_Ey=sums["lev=0"]["Ey"], checksum_jz=sums["lev=0"]["jz"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit(phase + "_profile", steps=PROFILED_STEPS, nvidia_smi=smi,
         **breakdown)
    # checksums() wrapped the positions; the kernels are timed on the state
    # the next step would give them, with these inputs in moving-window mode
    sim.state = stepped
    f = stepper._f
    anchors = list(geom.prob_lo)
    anchors[1] = aux["tile_anchor"]
    zshift = int(np.round(f(f(aux["window_lo"] - aux["tile_anchor"])
                            / f(geom.dx[1]))))
    return launches, tuple(anchors), zshift, waits_by_step


def k2_window_at_main_shapes(sim, anchors, zshift, mxu="f32"):
    """K2 in moving-window mode on the state the run ended in, against its
    plain version and timed (``fused_at_main_shapes``)."""
    stepper = sim.stepper
    fields6 = stepper.to_kernel_frame(stepper._padded_eb(sim.state.fields))
    return fused_at_main_shapes(
        sim, 1, window=(fields6, stepper.params, anchors, zshift,
                        stepper.smax), mxu=mxu)


def add_launches(rows_by_name, launches, phase):
    for nm, row in rows_by_name.items():
        row["launches"] += launches[nm]
        row.setdefault("launches_by_path", {})[phase] = launches[nm]


def phase_main_lwfa(dev, smi, k2_row, k3_row, nx=2048, nz=8192):
    """lwfa2d-2048x8192 (the configuration built field for field) through K2
    in moving-window mode (K1c) at 'f32' and K3; returns K1c's kernels-line
    row and adds this path's launches to the rows of K2 and K3."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import tiling

    cfg = main_lwfa_cfg(nx, nz, lwfa_steps(LWFA_PLAN))
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    launches, anchors, zshift, _ = run_lwfa_path(dev, smi, "main_lwfa",
                                                 sim, LWFA_PLAN)
    k1c = k2_window_at_main_shapes(sim, anchors, zshift)
    k3 = k3_at_main_shapes(sim, origin=anchors,
                           wrap_dims=sim.stepper.wrap_dims)
    emit("main_lwfa_layers", step=sim.state.step, zshift=zshift,
         ms=lwfa_layers(sim, anchors, zshift), fused_pic_2d=k1c["ms"],
         ragged_expand=k3["ms"], nvidia_smi=smi)
    add_launches({"fused_pic_2d": k2_row, "ragged_expand": k3_row}, launches,
                 "main_lwfa")
    k3_row["at_main_lwfa"] = k3
    return {"name": "fused_pic_moving_window", "route": "cuda",
            "source": "warpx_tpu_torch/csrc/fused_pic_2d.cu",
            "replaces": "warpx_tpu/ops/pallas_pic.py:197",
            "launches": launches["fused_pic_2d"], "zshift": zshift,
            "smax": sim.stepper.smax, **k1c}


def lwfa_deck_text(nx, nz, steps, mxu):
    """bench.py::run_lwfa's deck as bench.py formats it (2 x 2 particles
    per cell, sort interval 16), with max_step the steps the phase runs:
    the slot capacity of continuous injection grows with max_step."""
    return LWFA_2D_DECK.format(nx=nx, nz=nz, ppcx=2, ppcz=2, interval=16,
                               max_step=steps, mxu=mxu)


def phase_main_lwfa_deck(dev, smi, k3_row, nx=2048, nz=8192):
    """lwfa2d-2048x8192 from bench.py's deck text through
    Simulation.from_deck at tile_mxu = mixed (bench.py's default), driven
    as main_lwfa is; its configuration must equal main_lwfa's but for the
    mode.  Then K2 in moving-window mode at 'mixed' at its shapes against
    its plain version, timed beside K1c at 'f32' on the same state and
    beside its bound.  Returns the kernels-line row; adds this path's K3
    launches to ``k3_row``."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    steps = lwfa_steps(LWFA_PLAN)
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(lwfa_deck_text(nx, nz, steps, "mixed")),
        dtype=torch.float32, device=dev)
    if sim.cfg != dataclasses.replace(main_lwfa_cfg(nx, nz, steps),
                                      tile_mxu="mixed"):
        raise AssertionError("the deck's configuration differs from "
                             "main_lwfa's")
    launches, anchors, zshift, waits = run_lwfa_path(
        dev, smi, "main_lwfa_deck", sim, LWFA_PLAN)
    row = k2_window_at_main_shapes(sim, anchors, zshift, mxu="mixed")
    add_launches({"ragged_expand": k3_row}, launches, "main_lwfa_deck")
    return {"name": "fused_pic_moving_window_mixed", "route": "cuda",
            "source": "warpx_tpu_torch/csrc/fused_pic_2d.cu",
            "replaces": "warpx_tpu/ops/pallas_pic.py:433", "mxu": "mixed",
            "launches": launches["fused_pic_2d"], "launches_by_path": {
                "main_lwfa_deck": launches["fused_pic_2d"]},
            "zshift": zshift, "smax": sim.stepper.smax, **row}, waits


# ---- the output path -------------------------------------------------------

# The outputs main_lwfa_diags adds to bench.py's deck: a plotfile at steps 20
# and 40, a checkpoint at 20, the reduced diagnostics every 4 steps, and (where
# h5py is installed) an openPMD file of the beam at 40.
LWFA_DIAGS = """
diagnostics.diags_names = {names}
diag1.intervals = 20
diag1.fields_to_plot = Ex Ez By jz rho
diag1.species = electrons beam
chk.format = checkpoint
chk.intervals = 20:20
diag2.format = openpmd
diag2.intervals = 40:40
diag2.fields_to_plot = none
diag2.species = beam
warpx.reduced_diags_names = fe fm pe pn px rm br ph
fe.type = FieldEnergy
fm.type = FieldMaximum
pe.type = ParticleEnergy
pn.type = ParticleNumber
px.type = ParticleExtrema
rm.type = RhoMaximum
br.type = BeamRelevant
br.species = beam
ph.type = ParticleHistogram
ph.species = electrons
ph.histogram_function(t,x,y,z,ux,uy,uz) = "uz"
ph.bin_number = 50
ph.bin_min = -0.05
ph.bin_max = 0.05
fe.intervals = 4
fm.intervals = 4
pe.intervals = 4
pn.intervals = 4
px.intervals = 4
rm.intervals = 4
br.intervals = 4
ph.intervals = 4
"""
DIAGS_STEPS = 40
# Restarted from step 20 and run to 40, the card's run differs from the
# uninterrupted one only in the order of K2's float32 shared-memory atomics:
# J differs by up to ~1.5e-7 of itself from launch to launch (ROADMAP Queue
# C), and 20 steps carry that into the fields and the particles.  Two runs
# on one NVIDIA H100 80GB HBM3 at 700 W measured 2.1e-8 and 4.7e-7 (the
# spread itself varies by 20x from run to run); 1e-4 leaves a factor 200
# over the larger, and a restart that lost a field, a window scalar or the
# synchronization flag moves the checksums by far more.
TOL_RESTART = 1e-4


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def state_bytes(state) -> int:
    """The bytes of every tensor of a state (a checkpoint's transfer)."""
    tensors = [*vars(state.fields).values(), *state.aux.values()]
    for sp in state.species.values():
        tensors += [t for t in vars(sp).values() if t is not None]
    return sum(t.nelement() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def phase_main_lwfa_diags(dev, smi, k2_row, k3_row, idle_waits, nx=2048,
                          nz=8192):
    """lwfa2d-2048x8192 from bench.py's deck text at 'mixed' with the
    outputs of LWFA_DIAGS, 40 steps (rebins at 0, 16, 32), as a user runs a
    deck with outputs (Simulation.from_deck with an output directory).  It
    checks that each plotfile reads back exactly as the port held it (the
    cell-centered fields and the compacted particle columns, float64 of the
    float32 tensors), that the reduced files have a row every 4 steps and
    ParticleNumber the alive counts, the openPMD beam against the plotfile's
    beam, that a step with no output due waits for the device as often as
    main_lwfa_deck's steps that neither rebin nor inject (``idle_waits``;
    ``quiet_step``), and that a
    fresh simulation restarted from the step-20 checkpoint and run to 40
    agrees with the run on every checksum but divE/divB within TOL_RESTART.
    It times each flush kind alone on the final state.  Adds the run's K2
    and K3 launches to ``k2_row`` and ``k3_row``."""
    import gc
    import importlib.util
    import shutil

    from warpx_tpu_torch.core.simulation import Simulation
    from warpx_tpu_torch.diagnostics.fields import cell_centered_output
    from warpx_tpu_torch.diagnostics.reduced import compute_reduced
    from warpx_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from warpx_tpu_torch.io.openpmd import write_openpmd_iteration
    from warpx_tpu_torch.io.plotfile import read_particles, read_plotfile
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling
    from warpx_tpu_torch.utils.parser import Deck

    has_h5py = importlib.util.find_spec("h5py") is not None
    names = "diag1 chk diag2" if has_h5py else "diag1 chk"
    text = (lwfa_deck_text(nx, nz, DIAGS_STEPS, "mixed")
            + LWFA_DIAGS.format(names=names))
    if not has_h5py:
        # no openPMD diagnostic at all: its keys would be unread
        text = "\n".join(ln for ln in text.splitlines()
                         if not ln.startswith("diag2."))
    plotfiles = []

    class Checked(Simulation):
        """The port's Simulation with each plotfile read back right after
        it is written, held against the tensors it was written from, then
        deleted (each is ~2.8 GB)."""

        def _flush_plotfile(self, dg, path, step, fields, select):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._flush_plotfile(dg, path, step, fields, select)
            write_s = time.perf_counter() - t0
            (level,), meta = read_plotfile(path)
            if list(level) != list(fields) or meta["step"] != step:
                raise AssertionError(f"plotfile {path}: {list(level)}")
            for k, v in fields.items():
                if not np.array_equal(level[k], v.double().cpu().numpy()):
                    raise AssertionError(f"plotfile {path}: {k} differs")
            n_cols = 0
            for sp, cols in self.plotfile_particles(dg["species"],
                                                    select).items():
                back = read_particles(path, sp)
                for c, a in cols.items():
                    n_cols += a.size
                    if not np.array_equal(back[c], np.asarray(a, np.float64)):
                        raise AssertionError(f"plotfile {path}: {sp}.{c}")
            plotfiles.append({
                "step": step, "write_s": write_s, "bytes": dir_bytes(path),
                "d2h_bytes": sum(v.nelement() * v.element_size()
                                 for v in fields.values()) + 4 * n_cols})
            shutil.rmtree(path)

    out = pathlib.Path(tempfile.mkdtemp(prefix="lwfa_diags_"))
    try:
        for k in fp.binned_push_deposit.launches_by_mode:
            fp.binned_push_deposit.launches_by_mode[k] = 0
        fp.binned_push_deposit.launches_2d = 0
        tiling.ragged_expand.launches = 0
        sim = Checked.from_deck(Deck.from_string(text), dtype=torch.float32,
                                device=dev, output_dir=str(out / "run"))
        t0 = time.perf_counter()
        sim.init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_el = int(sim.state.species["electrons"].alive.sum())
        chk_bytes = state_bytes(sim.state)
        plot_bytes = 8 * (5 * nx * nz + 6 * 2 * n_el)
        free = shutil.disk_usage(out).free
        if free < 2 * (chk_bytes + plot_bytes):
            raise AssertionError(f"{free} bytes free under {out}, "
                                 f"{2 * (chk_bytes + plot_bytes)} needed")
        interval = sim.cfg.sort_interval
        outputs = sim.reduced + sim.diags
        step_s, due_steps, waits = {}, {}, {}
        while sim.state.step < DIAGS_STEPS:
            s0 = sim.state.step
            due = sorted(o["name"] for o in outputs
                         if o["intervals"].contains(s0 + 1))
            if (not due and quiet_step(s0, interval)
                    and s0 >= DIAGS_STEPS // 2 and len(waits) < 3):
                waits[s0 + 1] = count_device_waits(lambda: sim.evolve(1))
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.evolve(1)
            torch.cuda.synchronize()
            step_s[s0 + 1] = time.perf_counter() - t0
            due_steps[s0 + 1] = due
        launches = {"fused_pic_2d": fp.binned_push_deposit.launches_2d,
                    "ragged_expand": tiling.ragged_expand.launches}
        rebins = len(range(0, DIAGS_STEPS, interval))
        if (launches != {"fused_pic_2d": DIAGS_STEPS, "ragged_expand": rebins}
                or fp.binned_push_deposit.launches_by_mode["mixed"]
                != DIAGS_STEPS):
            raise AssertionError(f"main_lwfa_diags launched {launches}")
        if sorted(set(waits.values())) != idle_waits:
            raise AssertionError(f"steps with no output due waited {waits} "
                                 f"times; main_lwfa_deck's idle steps "
                                 f"{idle_waits}")
        if [p["step"] for p in plotfiles] != [20, 40]:
            raise AssertionError(f"plotfiles at {plotfiles}")
        if not (out / "run" / "chk000020" / "state.npz").exists():
            raise AssertionError("no checkpoint at step 20")
        alive = {nm: int(sp.alive.sum())
                 for nm, sp in sim.state.species.items()}
        reduced_rows = {}
        for rd in sim.reduced:
            lines = pathlib.Path(rd["writer"].path).read_text().splitlines()
            rows = [ln.split(",") for ln in lines[1:]]
            if [int(r[0]) for r in rows] != list(range(4, DIAGS_STEPS + 1,
                                                       4)):
                raise AssertionError(f"{rd['name']}: rows {len(rows)}")
            reduced_rows[rd["name"]] = dict(zip(
                lines[0].lstrip("#").split(","), rows[-1]))
        last = {k.split("]", 1)[1]: float(v)
                for k, v in reduced_rows["pn"].items()}
        for nm in ("electrons", "beam"):
            if last[f"{nm}_macroparticles()"] != alive[nm]:
                raise AssertionError(f"ParticleNumber {nm}: {last}, "
                                     f"alive {alive}")
        if has_h5py:
            import h5py

            cols = sim.plotfile_particles(["beam"])["beam"]
            with h5py.File(out / "run" / "diag2.h5") as fh:
                grp = fh[f"data/{DIAGS_STEPS}/particles/beam"]
                got = {"x": grp["position/x"][...],
                       "y": grp["position/z"][...],
                       "weight": grp["weighting/value"][...],
                       **{f"momentum_{c}": grp[f"momentum/{c}"][...]
                          for c in "xyz"}}
            for c, a in cols.items():
                if not np.array_equal(np.asarray(got[c], np.float64),
                                      np.asarray(a, np.float64)):
                    raise AssertionError(f"openPMD beam {c} differs")
        sums = sim.checksums()

        # each flush kind alone on the final state
        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        alone = out / "alone"
        dg1 = next(d for d in sim.diags if d["name"] == "diag1")
        flush = {}
        by_kind = {rd["kind"]: timed(lambda: compute_reduced(
            rd["kind"], sim.state, sim.cfg, sim.staggering,
            params=rd["params"])) for rd in sim.reduced}
        flush["reduced"] = {
            "ms": sum(by_kind.values()), "ms_by_kind": by_kind,
            "bytes_a_row": sum(len(",".join(r.values())) + 1
                               for r in reduced_rows.values()),
            "d2h_bytes": 8 * sum(len(r) - 2 for r in reduced_rows.values())}
        flush["plotfile"] = {"ms": timed(lambda: Simulation._flush_plotfile(
            sim, dg1, str(alone / "plt"), DIAGS_STEPS,
            dict(sorted(cell_centered_output(
                sim.state, sim.cfg, sim.staggering,
                names=dg1["fields"]).items())), None)),
            "bytes": dir_bytes(alone / "plt"),
            "d2h_bytes": plotfiles[-1]["d2h_bytes"]}
        shutil.rmtree(alone / "plt")
        flush["checkpoint"] = {"ms": timed(lambda: save_checkpoint(
            str(alone / "chk"), sim.state, sim.is_synchronized)),
            "bytes": dir_bytes(alone / "chk"),
            "d2h_bytes": state_bytes(sim.state)}
        shutil.rmtree(alone / "chk")
        if has_h5py:
            flush["openpmd"] = {"ms": timed(lambda: write_openpmd_iteration(
                str(alone / "beam.h5"), DIAGS_STEPS, sim.state, sim.cfg, {},
                sim.state.time, sim.cfg.dt, [0.0, 0.0],
                species_names=["beam"])),
                "bytes": dir_bytes(alone), "d2h_bytes": 4 * 6 * alive["beam"]}
        flush_steps = {s: t for s, t in step_s.items() if due_steps[s]}
        idle_steps = {s: t for s, t in step_s.items()
                      if not due_steps[s] and quiet_step(s - 1, interval)}
        del sim
        gc.collect()
        torch.cuda.empty_cache()

        sim = Checked.from_deck(Deck.from_string(text), dtype=torch.float32,
                                device=dev, output_dir=str(out / "restart"))
        sim.init()
        sim.state, sim.is_synchronized = load_checkpoint(
            str(out / "run" / "chk000020"), sim.state)
        if sim.state.step != 20:
            raise AssertionError(f"restarted at step {sim.state.step}")
        sim.evolve()
        restarted = sim.checksums()
        restart_err = checksums_agree(restarted, sums, TOL_RESTART,
                                      "restart vs uninterrupted")
        worst_of = max(((g, q) for g in sums for q in sums[g]
                        if q not in ("divE", "divB") and sums[g][q]),
                       key=lambda k: abs(restarted[k[0]][k[1]]
                                         - sums[k[0]][k[1]])
                       / abs(sums[k[0]][k[1]]))
        del sim
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    add_launches({"fused_pic_2d": k2_row, "ragged_expand": k3_row}, launches,
                 "main_lwfa_diags")
    emit("main_lwfa_diags", ok=True, n_cell=[nx, nz], steps=DIAGS_STEPS,
         h5py=has_h5py, alive_at_end=alive, launches=launches,
         init_s=init_s, plotfiles_read_back_exactly=plotfiles,
         flush_alone=flush,
         s_a_step_with_outputs=flush_steps, outputs_due=due_steps,
         s_a_step_without=idle_steps,
         mean_s_idle=sum(idle_steps.values()) / max(len(idle_steps), 1),
         device_waits_idle_steps=waits, main_lwfa_deck_idle=idle_waits,
         restart={"from_step": 20, "to_step": DIAGS_STEPS,
                  "max_rel_err": restart_err, "tol": TOL_RESTART,
                  "worst": "/".join(worst_of)},
         checksum_jz=sums["lev=0"]["jz"], nvidia_smi=smi)


def phase_deck_parity(dev):
    """tests/test_binned_bounded.py's 32 x 64 laser-wakefield deck at
    tpu.tile_mxu = mixed through Simulation.from_deck, float64, on the card
    (K2 at 'mixed', once a step) and on the CPU (plain versions), 12 steps:
    every checksum but divE/divB within 1e-9.  Then the CLI as a process of
    its own on the card, on the same deck with --steps 4 --checksums: its
    printed checksums against an in-process run of 4 steps, within 1e-12
    (the J windows' shared-memory atomics sum in an order that changes from
    run to run)."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.utils.parser import Deck

    text = LWFA_32X64_DECK + "\ntpu.tiled_particles = on\ntpu.tile_mxu = mixed\n"
    by_mode = fp.binned_push_deposit.launches_by_mode
    sums = {}
    before = by_mode["mixed"]
    for device in (dev, "cpu"):
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float64, device=device)
        if not (sim.is_bounded and sim.binned and sim.cfg.tile_mxu == "mixed"):
            raise AssertionError("the deck did not take the bounded "
                                 "tile-binned step at 'mixed'")
        sim.init()
        sim.evolve()
        sums[str(device)] = sim.checksums()
        if device is dev:
            launched = by_mode["mixed"] - before
    if launched != sim.cfg.max_step:
        raise AssertionError(f"{launched} launches of K2 at 'mixed' in "
                             f"{sim.cfg.max_step} steps")
    worst = checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                            "deck card vs CPU")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "inputs"
        path.write_text(text)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "warpx_tpu_torch", str(path), "--steps",
             "4", "--checksums"], capture_output=True, text=True, timeout=600,
            cwd=pathlib.Path(__file__).resolve().parent)
        cli_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"the CLI failed: {run.stderr[-2000:]}")
        printed = json.loads(run.stdout[run.stdout.index("\n") + 1:])
        sim = warpx_tpu_torch.Simulation.from_deck(
            str(path), dtype=torch.float64, device=dev)
        sim.init()
        sim.evolve(4)
        cli_err = checksums_agree(printed, sim.checksums(), 1e-12,
                                  "CLI vs in-process")
    emit("deck_parity", ok=True, tol=1e-9, steps=12, max_rel_err=worst,
         k2_mixed_launches=launched, cli={
             "steps": 4, "max_rel_err": cli_err, "tol": 1e-12,
             "seconds": cli_s, "first_line": run.stdout.splitlines()[0]})


# ---- the Hopper labs (warpx_tpu_torch/tools/) ------------------------------

# tile_dot (L3, L4) against its plain version, relative to the largest
# output: both add reps products, each a float32 sum of K exact products
# (bfloat16 operands, or float32 in both) taken in another order (the
# tensor cores' float32 accumulation also truncates), which a sequential
# sum bounds by ~K 2^-24 (7e-5 at K = 1152); random rounding keeps it near
# sqrt(K) 2^-24 (2e-6).
TOL_DOT = 1e-4
# lab_widelane (L2): exact bfloat16 products, float32 sums of up to W^2
# (gather) or P (deposit) terms in another order.
TOL_WIDELANE = 1e-5
# lab_fused (L1), per output: the particles (their fields are float32 sums
# of W^2 exact bfloat16 products, or float32 FMA sums, in another order) and
# the J windows.  J's bands are differences over a drift of ~1e-4 cells, so
# an ulp of a particle's field moves x_new across a float32 rounding now and
# then, which changes that particle's df by ~1e-3 of itself; where the
# deposit's operands are rounded to bfloat16 such a change can also cross a
# bfloat16 rounding boundary (2^-8 of that operand).
TOL_LAB_FUSED = {"particles": 1e-5, "j_f32": 1e-4, "j_bf16": 4e-3}
# Each lab at its own shapes (`labs`), relative to the largest output.  The
# sums are longer than lab_parity's: L1 adds 32 chunks of 64 particles into
# J, and L3 and L4 add the same product reps times (400 in L3, up to 16384
# in L4), where the accumulator's rounding is systematic, up to
# reps 2^-24 of it (L4 at M = 8: 9.8e-4).  Each limit stays below the
# difference a lower precision makes: bfloat16 operands against float32
# move L1's outputs ('full' against 'prec_xx') and L3/L4's zero-mean
# products by more than 1e-3 (the tests *_limit*_sees_bf16_operands in
# tests/test_torch_labs_*.py).  L5 moves values and must be exact.
TOL_LABS = {"L1": 1e-4, "L2": 1e-4, "L3": 1e-4, "L4": 1e-3, "L5": 0.0}


def lab_err(got, ref):
    d = (got.double() - ref.double()).abs().max().item()
    s = ref.double().abs().max().item()
    return d, (d / s if s else d)


def phase_lab_parity(dev):
    """Each lab kernel against its plain version at small shapes, every
    mode and both layouts, each case launched three times: L5 exactly (and
    its wrapper refuses rows that are not 16-byte aligned), L3/L4 within
    TOL_DOT, L2 within TOL_WIDELANE, L1 within TOL_LAB_FUSED."""
    from warpx_tpu_torch.tools import bench_dot_shapes as dots
    from warpx_tpu_torch.tools import kernel_lab as l1
    from warpx_tpu_torch.tools import lab_widelane as l2
    from warpx_tpu_torch.tools import profile_rebin_lwfa as l5

    launches = 3
    out = {}
    # L5: random offsets (bulk copies of the enclosing aligned ranges,
    # shifted), for a payload whose length is and one whose length is not a
    # multiple of 4 (padded to 16-byte rows by l5.pad); then a row of
    # 50,513 floats, which the wrapper must refuse
    cases = []
    for cap in (50_000, 50_001):
        ps, ks = l5.inputs(cap, 96, 5, dev)
        offsets, counts = l5.prelude(ks, 96)
        psp = l5.pad(ps, 512)
        ref = l5.slot_copy_plain(psp, offsets, counts, 512)
        for _ in range(launches):
            got = l5.slot_copy(psp, offsets, counts, 512)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"slot_copy (cap {cap}) differs from "
                                     "its plain version")
        cases.append({"cap": cap, "row_len": psp.shape[1], "equal": True})
    try:
        l5.slot_copy(psp[:, :50_513].contiguous(), offsets, counts, 512)
    except ValueError:
        pass
    else:
        raise AssertionError("slot_copy took a row that is not 16-byte "
                             "aligned")
    out["L5"] = {"cases": cases, "misaligned_row_refused": True}
    # L3/L4: both layouts, every mode, both operand types, padded rows
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    cases = []
    for layout in ("nn", "nt"):
        for mode in ("f32", "bf16", "3pass"):
            for dtype in (torch.float32, torch.bfloat16):
                for batch, m, k, n in ((3, 8, 64, 40), (2, 16, 1152, 256),
                                       (2, 40, 256, 64)):
                    bshape = ((batch, k, n) if layout == "nn" else
                              (batch, n, k))
                    # zero-mean, so that a lower precision shows
                    a = (torch.rand((batch, m, k), generator=gen)
                         - 0.5).to(dev, dtype)
                    b = (torch.rand(bshape, generator=gen) - 0.5).to(dev,
                                                                     dtype)
                    ref = dots.tile_dot_plain(a, b, 3, mode, layout)
                    for _ in range(launches):
                        got = dots.tile_dot(a, b, 3, mode, layout)
                        e = lab_err(got, ref)[1]
                        worst = max(worst, e)
                        if e > TOL_DOT:
                            raise AssertionError(
                                f"tile_dot {layout} {mode} {dtype} "
                                f"({batch}, {m}, {k}, {n}): {e}")
                    cases.append({"layout": layout, "mode": mode,
                                  "operands": str(dtype), "shape":
                                  (batch, m, k, n), "rel_err": e})
    out["L3_L4"] = {"worst_rel_err": worst, "tol": TOL_DOT,
                    "cases": len(cases)}
    # L2: both layouts, both deposit precisions, W 16 and 8
    worst = {}
    for w in (16, 8):
        for mode in ("batched", "wide"):
            for dep in ("bf16", "f32"):
                fn, args = l2.make(mode, dep, dev, nt=5, w=w, p=256, seed=w)
                ref = l2.widelane_plain(*args, mode == "batched", dep)
                for _ in range(launches):
                    got = fn(*args)
                    for nm, x, y in zip(("out", "jw"), got, ref):
                        e = lab_err(x, y)[1]
                        key = f"W{w}/{mode}/{dep}/{nm}"
                        worst[key] = max(worst.get(key, 0.0), e)
                        if e > TOL_WIDELANE:
                            raise AssertionError(f"lab_widelane {key}: {e}")
    out["L2"] = {"worst_rel_err": worst, "tol": TOL_WIDELANE}
    # L1: every mode, unpacked and packed, W 16 (and W 8 for three modes)
    worst = {}
    runs = [(m, 16) for m in l1.MODES] + [(m, 8) for m in
                                          ("full", "nomxu", "prec_xh")]
    for mode, w in runs:
        for packed in (False, True):
            name = f"pk_{mode}" if packed else mode
            wins, parts, _ = l1.inputs(name, nt=3, w=w, p=256, seed=11,
                                       device=dev)
            ref = l1.lab_fused_plain(name, wins, parts, packed)
            spec = l1.mode_spec(name)
            tol_j = TOL_LAB_FUSED["j_bf16" if spec["deposit"] == "bf16"
                                  else "j_f32"]
            for _ in range(launches):
                got = l1.lab_fused(name, wins, parts, packed)
                if packed:
                    pairs = [("particles", got[0], ref[0]),
                             ("j", got[1], ref[1])]
                else:
                    pairs = ([("particles", x, y) for x, y in zip(got[0],
                                                                  ref[0])]
                             + [("j", x, y)
                                for x, y in zip(got[1], ref[1])])
                for kind, x, y in pairs:
                    e = lab_err(x, y)[1]
                    key = f"W{w}/{name}/{kind}"
                    worst[key] = max(worst.get(key, 0.0), e)
                    tol = (TOL_LAB_FUSED["particles"]
                           if kind == "particles" else tol_j)
                    if e > tol:
                        raise AssertionError(
                            f"lab_fused {key}: {e} > {tol}")
    out["L1"] = {"worst_rel_err": worst, "tol": TOL_LAB_FUSED}
    emit("lab_parity", ok=True, launches_per_case=launches, **out)


def lab_row(name, source, replaces, case, launches):
    """A kernels-line row from a lab's principal case."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: case[k] for k in keys}, "case": case["lab"]}


def phase_labs(dev):
    """Each lab's main() at the TPU lab's default shapes (L1 in every mode),
    with the labs' launch counters set to 0 just before and read just after
    (launches made by lab_parity do not count); each lab prints its lines
    and one JSON line.  Returns the kernels-line rows of L1-L5."""
    from warpx_tpu_torch.tools import bench_deposit_prec as l3
    from warpx_tpu_torch.tools import bench_dot_shapes as l4
    from warpx_tpu_torch.tools import kernel_lab as l1
    from warpx_tpu_torch.tools import lab_widelane as l2
    from warpx_tpu_torch.tools import profile_rebin_lwfa as l5

    counters = ((l1.lab_fused, "L1"), (l2.widelane, "L2"),
                (l4.tile_dot, "L3/L4"), (l5.slot_copy, "L5"))
    for fn, _ in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = {"L5": l5.main([])}
    n5 = l5.slot_copy.launches
    res["L4"] = l4.main([])
    n4 = l4.tile_dot.launches
    res["L3"] = l3.main([])
    n3 = l4.tile_dot.launches - n4
    res["L1"] = l1.main(list(l1.MODES) + ["pk_full", "pk_empty"])
    res["L2"] = l2.main([])
    seconds = time.perf_counter() - t0
    launches = {"L1": l1.lab_fused.launches, "L2": l2.widelane.launches,
                "L3": n3, "L4": n4, "L5": n5}
    if not all(launches.values()):
        raise AssertionError(f"a lab kernel never ran: {launches}")
    for lab in ("L1", "L2", "L3", "L4", "L5"):
        for case in res[lab]["cases"]:
            rel = case.get("max_rel_err", case["max_abs_err"])
            if isinstance(rel, dict):
                rel = max(rel.values())
            if not rel <= TOL_LABS[lab]:
                raise AssertionError(f"{case['lab']} disagrees with its "
                                     f"plain version: {case}")
    emit("labs", ok=True, seconds=seconds, launches=launches, tol=TOL_LABS,
         reps_scaling_x4={"L4": res["L4"]["reps_scaling_x4"],
                          "L3": res["L3"]["reps_scaling_x4"]})
    full = next(c for c in res["L1"]["cases"] if c["mode"] == "full")
    return [
        lab_row("lab_fused", "warpx_tpu_torch/csrc/lab_fused.cu",
                "tools/kernel_lab.py:289", full, launches["L1"]),
        lab_row("lab_widelane", "warpx_tpu_torch/csrc/lab_widelane.cu",
                "tools/lab_widelane.py:158", res["L2"]["cases"][0],
                launches["L2"]),
        lab_row("tile_dot_deposit_prec", "warpx_tpu_torch/csrc/tile_dot.cu",
                "tools/bench_deposit_prec.py:69", res["L3"]["cases"][0],
                launches["L3"]),
        lab_row("tile_dot_shapes", "warpx_tpu_torch/csrc/tile_dot.cu",
                "tools/bench_dot_shapes.py:40", res["L4"]["cases"][0],
                launches["L4"]),
        lab_row("slot_copy", "warpx_tpu_torch/csrc/slot_copy.cu",
                "tools/profile_rebin_lwfa.py:338", res["L5"]["cases"][0],
                launches["L5"]),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from warpx_tpu_torch import build
    except ImportError as e:
        print(f"chip_smoke: the warpx_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    secs = build.build_all()
    regs = {nm: [ln.strip() for ln in build.build_log(nm).splitlines()
                 if "registers" in ln or "spill" in ln][:8]
            for nm in build.SOURCES}
    reports = {nm: ptxas_report(build.build_log(nm)) for nm in build.SOURCES}
    emit("build", ok=True, seconds=time.perf_counter() - t0,
         per_library=secs, ptxas=regs,
         registers={nm: sorted(set(r.values()))
                    for nm, (r, _) in reports.items()},
         spill_bytes={nm: sum(sp.values()) for nm, (_, sp) in reports.items()})
    phase_kernel_parity(dev, "k1_parity", 3, 16)
    phase_kernel_parity(dev, "k2_parity", 2, 32)
    phase_k1d_parity(dev)
    phase_k1c_parity(dev)
    phase_k3_parity(dev)
    phase_lab_parity(dev)
    phase_slice_parity(dev, "slice_parity", 3)
    phase_slice_parity(dev, "slice2d_parity", 2)
    phase_bounded_parity(dev)
    phase_deck_parity(dev)
    k1_row, k3_row = phase_main(dev, smi)
    k1d_rows = phase_main_mixed(dev, smi, k3_row)
    k2_row = phase_main2d(dev, smi, k3_row)
    k2_row["launches_by_path"] = {"main2d": k2_row["launches"]}
    torch.cuda.empty_cache()
    k1c_row = phase_main_lwfa(dev, smi, k2_row, k3_row)
    torch.cuda.empty_cache()
    k1c_mixed_row, waits = phase_main_lwfa_deck(dev, smi, k3_row)
    torch.cuda.empty_cache()
    phase_main_lwfa_diags(dev, smi, k1c_mixed_row, k3_row, waits["idle"])
    torch.cuda.empty_cache()
    lab_rows = phase_labs(dev)
    print(smi)
    print(json.dumps({"kernels": [k1_row, *k1d_rows, k2_row, k1c_row,
                                  k1c_mixed_row, k3_row, *lab_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
