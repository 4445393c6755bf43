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
               an order that changes from launch to launch);
  k3_parity    kernel K3 (rebin slot expansion) against its plain version;
  slice_parity 8 steps of Simulation at 16^3 in float64 on the card and on
               the CPU: every checksum but divE/divB agrees to 1e-9;
  main         the main path at 128^3 cells, 2 species, 8.39 M particles,
               float32: init, one warm step, 20 timed steps, 3 profiled
               steps, the closing step; then each kernel at the main path's
               shapes against its plain version, timed beside its bound.

The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}.  With no GPU, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and the dense rates outside the
# tensor cores (float64 34, float32 67 TFLOP/s), at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# The main path's current windows in float32: its thermal particles drift
# ~0.006 cells a step, and the current is a difference of shape factors over
# that drift.  Kernel and plain version push with velocities that differ in
# the 7th digit, so now and then x_new rounds to the neighbouring float32
# (2^-20 cells at W = 16), which moves that particle's current by
# ~1e-6/0.006 ~ 2e-4 of itself.  1e-4 of the largest window value bounds it.
TOL_J_MAIN = 1e-4


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


# ---- kernel K1 ------------------------------------------------------------

def k1_inputs(n, order, dtype, dev, seed):
    """Two species in the tile layout at n^3 with random fields, dead slots,
    one empty (species, tile) and one alive particle whose deposit stencil
    is clipped at its window's low side (a counted violation)."""
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.core.state import ParticleState
    from warpx_tpu_torch.ops.fused_pic import pad_fields
    from warpx_tpu_torch.ops.tiling import TileSpec, rebin
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    rng = np.random.default_rng(seed)
    lx = 40e-6
    geom = Geometry(ndim=3, n_cell=(n,) * 3, prob_lo=(-lx / 2,) * 3,
                    prob_hi=(lx / 2,) * 3, periodic=(True,) * 3)
    dt = compute_dt_yee(geom, 0.999)
    npart = 2 * n ** 3
    spec = TileSpec.create(geom.n_cell, order=order, n_particles=npart,
                           margin=1, interval=4)
    c = 299792458.0
    t64 = dict(dtype=torch.float64)
    parts = []
    for s in range(2):
        alive = rng.random(npart) > 0.1
        pos = rng.uniform(-lx / 2, lx / 2, (3, npart))
        if s == 1:  # leave tile 0 empty for this species
            alive &= ~np.all(pos < -lx / 2 + spec.tile[0] * geom.dx[0],
                             axis=0)
        u = rng.normal(0.0, 0.05 * c, (3, npart))
        sp = ParticleState(
            w=torch.tensor(rng.uniform(0.5, 1.5, npart) * 1e10 * alive, **t64),
            ux=torch.tensor(u[0], **t64), uy=torch.tensor(u[1], **t64),
            uz=torch.tensor(u[2], **t64), alive=torch.tensor(alive),
            x=torch.tensor(pos[0], **t64), y=torch.tensor(pos[1], **t64),
            z=torch.tensor(pos[2], **t64),
        )
        sp, _ = rebin(sp, geom, spec)
        parts.append(sp)
    # first alive slot of species 0 in its tile: move it so the stencil
    # start of its x deposit is window row -1
    sp0 = parts[0]
    k = int(torch.nonzero(sp0.alive)[0])
    t = k // spec.p_max
    tx = t // (spec.tiles_per_dim[1] * spec.tiles_per_dim[2])
    xwin = 0.25 + 0.5 * order  # start_index(x, order) == 0
    x = sp0.x.clone()
    x[k] = geom.prob_lo[0] + (tx * spec.tile[0] - spec.off + xwin) * geom.dx[0]
    ux = sp0.ux.clone()
    ux[k] = 0.0
    parts[0] = sp0.replace(x=x, ux=ux)
    nt, P = spec.n_tiles, spec.p_max
    cols = [torch.cat([getattr(sp, a).reshape(nt, P) for sp in parts])
            for a in ("x", "y", "z", "ux", "uy", "uz")]
    cols.append(torch.cat([torch.where(sp.alive, sp.w, 0.0).reshape(nt, P)
                           for sp in parts]))
    counts = torch.cat([sp.alive.reshape(nt, P).sum(1, dtype=torch.int32)
                        for sp in parts])
    assert int((counts == 0).sum()) >= 1
    fields = []
    for scale in (1e10,) * 3 + (30.0,) * 3:
        fields.append(torch.tensor(rng.normal(0, scale, geom.n_cell), **t64))
    params = torch.tensor([[-1.602176634e-19, 9.1093837015e-31, 1e9, 0, 0,
                            0, 0, 1.0],
                           [1.602176634e-19, 1.67262192369e-27, 0, 0, 0,
                            0, 0, 0]], **t64)
    to = dict(dtype=dtype, device=dev)
    args = (params.to(**to), pad_fields(tuple(f.to(**to) for f in fields),
                                        spec),
            tuple(a.to(**to).contiguous() for a in cols))
    return args, counts.to(dev), dict(spec=spec, geom=geom, dt=dt)


def k1_compare(fp, args, counts, kw, tol, tol_j=None, repeats=1):
    """K1 against its plain version on the same inputs, over ``repeats``
    launches of K1: max |diff| over max |ref| per output must stay within
    ``tol`` (``tol_j`` for the current windows, default ``tol``) in every
    launch; the violation counts must be equal.  Returns the errors of the
    worst launch per output, the violation count, the worst relative error
    of the particles and of the J windows, and the J error of each launch."""
    tol_j = tol if tol_j is None else tol_j
    out_p = fp.binned_push_deposit_plain(*args, counts, **kw)
    names = ("x", "y", "z", "ux", "uy", "uz")
    errs = {}
    j_runs = []
    for _ in range(repeats):
        out_k = fp.binned_push_deposit(*args, counts=counts, **kw)
        torch.cuda.synchronize()
        run = {}
        for nm, a, b in zip(names, out_k[0], out_p[0]):
            run[nm] = rel_err(a, b)
        for nm, a, b in zip(("jx", "jy", "jz"), out_k[1], out_p[1]):
            run[nm] = rel_err(a, b)
        if not torch.equal(out_k[2], out_p[2]):
            raise AssertionError("K1's violation counts differ from its "
                                 "plain version's")
        for nm, e in run.items():
            errs[nm] = max(errs.get(nm, e), e, key=lambda t: t[1])
        j_runs.append(max(run[nm][1] for nm in ("jx", "jy", "jz")))
    worst_p = max(errs[nm][1] for nm in names)
    worst_j = max(errs[nm][1] for nm in ("jx", "jy", "jz"))
    if worst_p > tol or worst_j > tol_j:
        raise AssertionError(f"K1 disagrees with its plain version: {errs}")
    return errs, int(out_p[2].sum()), worst_p, worst_j, j_runs


K1_REPEATS = 5


def phase_k1_parity(dev):
    from warpx_tpu_torch.core.grid import yee_staggering
    from warpx_tpu_torch.ops import fused_pic as fp

    stag = tuple(sorted((k, tuple(v)) for k, v in yee_staggering(3).items()))
    cases = []
    for dtype in (torch.float64, torch.float32):
        for order in (1, 2, 3):
            for pusher in ("boris", "vay", "higuera"):
                args, counts, kw = k1_inputs(16, order, dtype, dev,
                                             seed=order)
                kw.update(order=order, galerkin=True, pusher_name=pusher,
                          stag_items=stag)
                _, nviol, worst_p, worst_j, j_runs = k1_compare(
                    fp, args, counts, kw, TOL[dtype], repeats=K1_REPEATS)
                cases.append({"dtype": str(dtype), "order": order,
                              "pusher": pusher, "particles_rel_err": worst_p,
                              "j_rel_err": worst_j, "j_rel_err_min": min(j_runs),
                              "violations": nviol})
    worst = {str(dt): max(max(c["particles_rel_err"], c["j_rel_err"])
                          for c in cases if c["dtype"] == str(dt))
             for dt in TOL}
    emit("k1_parity", ok=True, repeats=K1_REPEATS,
         tol=dict((str(k), v) for k, v in TOL.items()), worst=worst,
         cases=cases)


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

def phase_slice_parity(dev):
    import warpx_tpu_torch

    sums = {}
    for device in (dev, "cpu"):
        sim = warpx_tpu_torch.Simulation(small_cfg(), dtype=torch.float64,
                                         device=device)
        sim.init()
        sim.evolve()
        sums[str(device)] = sim.checksums()
    got, ref = sums[str(dev)], sums["cpu"]
    worst = 0.0
    for group in ref:
        for q, a in ref[group].items():
            if q in ("divE", "divB"):
                continue  # roundoff noise; test_binned.py excludes them too
            r = abs(got[group][q] - a) / abs(a) if a else abs(got[group][q])
            worst = max(worst, r)
            if r > 1e-9:
                raise AssertionError(f"slice checksum {group}/{q}: card "
                                     f"{got[group][q]!r} vs CPU {a!r}")
    emit("slice_parity", ok=True, max_rel_err=worst, tol=1e-9)


# ---- the main path --------------------------------------------------------

PROFILED_STEPS = 3


def profile_steps(sim, steps):
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
                    for ms, n, k in rows[:15]]}


def plasma_cfg(n, u_th, second, max_step, **kw):
    """bench.py::_build_sim's uniform thermal plasma at n^3 cells: electrons
    and a second species of the electron's mass and opposite charge, (2,1,1)
    particles per cell each, order 1, Yee, dt at 0.999 of the Courant
    limit; ``kw`` sets the tiling."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    lx = 40e-6
    geom = Geometry(ndim=3, n_cell=(n,) * 3, prob_lo=(-lx / 2,) * 3,
                    prob_hi=(lx / 2,) * 3, periodic=(True,) * 3)
    species = tuple(
        SpeciesConfig(
            name=nm, charge=q, mass=9.1093837015e-31,
            injection_style="nuniformpercell",
            num_particles_per_cell_each_dim=(2, 1, 1),
            profile="constant", density=2.0e24,
            momentum_distribution="gaussian",
            ux_th=u_th, uy_th=u_th, uz_th=u_th,
        )
        for nm, q in (("electrons", -1.602176634e-19),
                      (second, 1.602176634e-19))
    )
    return SimConfig(geometry=geom, max_step=max_step,
                     dt=compute_dt_yee(geom, 0.999), particle_shape=1,
                     species=species, tiled_particles="on", **kw)


def small_cfg():
    """test_binned.py's 3D order-1 configuration: 16^3, 8 steps."""
    return plasma_cfg(16, 0.1, "positrons", 8, sort_interval=3)


def main_cfg(n=128, steps=25):
    """The main path: bench.py::_build_sim at n = 128, ppc = 2, with the
    f32 deposit and gather (tile_mxu='f32')."""
    return plasma_cfg(n, 0.01, "ions", steps, sort_interval=60,
                      sort_margin=1, tile_headroom=1.125, tile_mxu="f32")


def k1_flops_per_slot(order, galerkin):
    """Arithmetic of the kernel's loops for one slot: 3 per gather tap,
    ~80 for the push, 6 per Esirkepov tap of each current component and
    ~16 per deposit stencil row."""
    from warpx_tpu_torch.core.grid import yee_staggering
    from warpx_tpu_torch.ops.fused_pic import _gather_table

    gorder, _ = _gather_table(order, galerkin, yee_staggering(3))
    taps = sum(int(np.prod([gorder[c * 3 + d] + 1 for d in range(3)]))
               for c in range(6))
    nt = order + 3
    return 3 * taps + 80 + 3 * nt ** 3 * 6 + 3 * nt * 16


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_main(dev, smi, n=128):
    import warpx_tpu_torch
    from warpx_tpu_torch.core.binned_step import pusher_groups
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    cfg = main_cfg(n)
    n_particles = 2 * 2 * n ** 3
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    fp.binned_push_deposit.launches = 0
    tiling.ragged_expand.launches = 0
    sim.init()
    sim.evolve(1)  # warm step: rebins (K3) and the first K1 launch
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = 20
    ms_total = cuda_ms(lambda: sim.evolve(steps), 1)
    breakdown = profile_steps(sim, PROFILED_STEPS)
    sim.evolve()  # the closing step, with the +dt/2 synchronization
    torch.cuda.synchronize()
    launches = {"fused_pic": fp.binned_push_deposit.launches,
                "ragged_expand": tiling.ragged_expand.launches}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    spec = sim.tile_spec
    state = sim.state
    sums = sim.checksums()  # raises on tile overflow or violations
    for group in sums.values():
        for q, v in group.items():
            if not np.isfinite(v):
                raise AssertionError(f"non-finite checksum {q}")
    alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    if alive != n_particles:
        raise AssertionError(f"{alive} alive particles of {n_particles}")
    w0 = 2.0e24 * sim.cfg.geometry.cell_volume / 2  # weight per particle
    for nm, group in sums.items():
        if nm != "lev=0":
            w_rel = abs(group["particle_weight"] / (n_particles / 2 * w0) - 1)
            if w_rel > 1e-5:
                raise AssertionError(f"{nm} weight drifted by {w_rel}")
    for f in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        a = getattr(sim.state.fields, f)
        if tuple(a.shape) != (n,) * 3 or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"field {f} is not finite at ({n},)*3")
    ms_step = ms_total / steps
    emit("main", ok=True, n_cell=n, n_particles=n_particles,
         n_tiles=spec.n_tiles, w=spec.w, p_max=spec.p_max,
         steps_timed=steps, ms_per_step=ms_step,
         pushes_per_s=n_particles / (ms_step * 1e-3), init_s=init_s,
         launches=launches, tile_overflow=0, tile_violations=0,
         checksum_Ex=sums["lev=0"]["Ex"], checksum_jx=sums["lev=0"]["jx"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_profile", steps=PROFILED_STEPS, **breakdown)

    # ---- each kernel at the main path's shapes ---------------------------
    stag = tuple(sorted((k, tuple(v)) for k, v in sim.staggering.items()))
    farr = state.fields
    fields6 = fp.pad_fields((farr.Ex, farr.Ey, farr.Ez, farr.Bx, farr.By,
                             farr.Bz), spec)
    ((pname, _, params, parts7, counts),) = list(
        pusher_groups(state, spec, sim.params))
    kw = dict(spec=spec, geom=cfg.geometry, order=cfg.particle_shape,
              galerkin=cfg.galerkin, pusher_name=pname, dt=cfg.dt,
              stag_items=stag)
    args = (params, fields6, parts7)
    errs, _, worst_p, worst_j, _ = k1_compare(
        fp, args, counts, kw, TOL[torch.float32], TOL_J_MAIN)
    k1_abs = max(a for a, _ in errs.values())
    k1_ms = cuda_ms(lambda: fp.binned_push_deposit(*args, counts=counts,
                                                   **kw), 10)
    k1_plain_ms = cuda_ms(lambda: fp.binned_push_deposit_plain(
        *args, counts, **kw), 2)
    out = fp.binned_push_deposit(*args, counts=counts, **kw)
    k1_bytes = (nbytes(params, counts, *fields6, *parts7)
                + nbytes(*out[0], *out[1], out[2]))
    occupied_slots = int((counts > 0).sum()) * spec.p_max
    k1_flops = occupied_slots * k1_flops_per_slot(cfg.particle_shape,
                                                  cfg.galerkin)
    k1_tb = k1_bytes / PEAK_BYTES_PER_S * 1e3
    k1_tf = k1_flops / PEAK_FLOPS[torch.float32] * 1e3

    sp = state.species["electrons"]
    k3_in = tiling.rebin_inputs(sp, cfg.geometry, spec)
    got = tiling.ragged_expand(*k3_in, spec.p_max)
    ref = tiling.ragged_expand_plain(*k3_in, spec.p_max)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K3 disagrees with its plain version at the "
                             "main path's shapes")
    k3_ms = cuda_ms(lambda: tiling.ragged_expand(*k3_in, spec.p_max), 10)
    k3_plain_ms = cuda_ms(lambda: tiling.ragged_expand_plain(
        *k3_in, spec.p_max), 3)
    payload, offsets, k3_counts, fill = k3_in
    kept = int(torch.clamp(k3_counts, max=spec.p_max).sum())
    k3_bytes = (payload.shape[0] * kept * payload.element_size()
                + nbytes(offsets, k3_counts, fill, got))
    k3_tb = k3_bytes / PEAK_BYTES_PER_S * 1e3

    kernels = [
        {"name": "fused_pic", "route": "cuda",
         "source": "warpx_tpu_torch/csrc/fused_pic.cu",
         "replaces": "warpx_tpu/ops/pallas_pic.py:116",
         "launches": launches["fused_pic"], "max_abs_err": k1_abs,
         "max_rel_err": {"particles": worst_p, "j": worst_j},
         "tol_rel": {"particles": TOL[torch.float32], "j": TOL_J_MAIN},
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": max(k1_tb, k1_tf),
         "bound_by": "bytes" if k1_tb >= k1_tf else "operations",
         "bytes": k1_bytes, "flops": k1_flops, "library_ms": None},
        {"name": "ragged_expand", "route": "cuda",
         "source": "warpx_tpu_torch/csrc/ragged_expand.cu",
         "replaces": "warpx_tpu/ops/tiling.py:142",
         "launches": launches["ragged_expand"], "max_abs_err": 0.0,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_tb,
         "bound_by": "bytes", "bytes": k3_bytes, "library_ms": None},
    ]
    return kernels


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
    emit("build", ok=True, seconds=time.perf_counter() - t0,
         per_library=secs, ptxas=regs)
    phase_k1_parity(dev)
    phase_k3_parity(dev)
    phase_slice_parity(dev)
    kernels = phase_main(dev, smi)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
