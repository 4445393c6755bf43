"""Kernel K2 (``warpx_tpu_torch/csrc/fused_pic_2d.cu``) against a parent
source and against its own lever ablations, on the main paths' inputs, on
one card.

    python3 k2_ab.py

Run from the repository's root, beside ``chip_smoke.py``, whose main paths
it drives.  ``_ab/parent/`` (git-ignored) holds the parent commit's
``fused_pic_2d.cu`` and ``fused_pic_common.cuh``:

    mkdir -p _ab/parent && for f in fused_pic_2d.cu fused_pic_common.cuh; do
      git show <rev>:warpx_tpu_torch/csrc/$f > _ab/parent/$f; done

Each variant is a copy of the kernel's source with the named edits in
VARIANTS, built by ``nvcc`` for float32 at order 3 into
``warpx_tpu_torch/_build/k2_ab/`` (git-ignored); the ablations give wrong
current windows where they say so and exist for timing only.  The inputs
are the states ``chip_smoke.py``'s main2d (uniform2d-2048, after 4 steps)
and main_lwfa (lwfa2d-2048x8192, its whole plan) reach; at each shape and
in each precision mode every variant runs on the same inputs: its
particles, its violation counts and its J windows against the first
variant's (bitwise and relative), then ten launches timed with CUDA
events, three rounds in the order first..last, last..first.  Prints one
JSON line per result: the card, the build (ptxas registers and spills),
the form of the shared and global atomics in the built SASS, the resident
blocks per SM, one line per (shape, mode).  ``k1_ab.py`` runs kernel K1
through the same helpers.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs

from warpx_tpu_torch import build
from warpx_tpu_torch.ops import fused_pic as fp

ROOT = pathlib.Path(__file__).resolve().parent
PARENT = ROOT / "_ab" / "parent"
SRC = ROOT / "warpx_tpu_torch" / "csrc"

# (old, new) edits of csrc/fused_pic_2d.cu, each found exactly once
VARIANTS = {
    "new": [],
    # lever 1 off: every dead slot takes the full path
    "noL1": [("if (has_ref && i > cnt) {", "if (false) {")],
    # lever 3 off: a 48 x 48 box, the window at lwfa2d's W = 48 (at
    # uniform2d's W = 24 it only allocates the larger box)
    "noL3": [("constexpr int kBox = 24;", "constexpr int kBox = 48;")],
    # lever 4 off: the first design's 192 threads, no resident-block bound
    "noL4": [("constexpr int kThreads = 160;",
              "constexpr int kThreads = 192;"),
             ("return sizeof(T) == 8 ? 1 : ORDER == 2 ? 3 : 4;",
              "return 1;")],
    # the deposit's shared atomics replaced by plain stores (wrong J)
    "store": [("if (vx != T(0)) atomicAdd(Jx + at, vx);",
               "if (vx != T(0)) Jx[at] = vx;"),
              ("if (vz != T(0)) atomicAdd(Jz + at, vz);",
               "if (vz != T(0)) Jz[at] = vz;"),
              ("if (vyv != T(0)) atomicAdd(Jy + at, vyv);",
               "if (vyv != T(0)) Jy[at] = vyv;")],
    # no deposit at all (J stays zero)
    "nodep": [("  if (wq == T(0)) return;\n", "  return;\n")],
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def start_build(name, src_dir, edits, stem, order, out):
    """Copy the kernel's source ``stem``.cu from ``src_dir`` with ``edits``
    into ``out``/``name`` and start nvcc on it for float32 at ``order``;
    returns (process, library path)."""
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    text = (src_dir / f"{stem}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: edit target not found once: {old!r}")
        text = text.replace(old, new)
    (d / f"{stem}.cu").write_text(text)
    shutil.copy(src_dir / "fused_pic_common.cuh", d)
    lib = d / "lib.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-DFP_REAL=float",
           f"-DFP_ORDER={order}", "-o", str(lib), str(d / f"{stem}.cu")]
    with open(d / "build.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, lib


def load(lib, parent, stem):
    """The variant's launch function: (args, stream) for the parent's
    source, (args, galerkin, wide counter, stream) for this kernel's."""
    L = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    launch = getattr(L, f"{stem}_launch")
    launch.restype = I
    launch.argtypes = [P, P] if parent else [P, I, P, P]
    if not parent:
        getattr(L, f"{stem}_blocks_per_sm").argtypes = [I]
        getattr(L, f"{stem}_blocks_per_sm").restype = I
    return L


def sass_atomics(lib):
    """Counts of the atomic instructions in the SASS of ``lib``."""
    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return dict(collections.Counter(re.findall(
        r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9_.]+)", sass)))


def main2d_inputs(dev):
    import warpx_tpu_torch
    from warpx_tpu_torch.core.binned_step import pusher_groups

    cfg = cs.main2d_cfg(2048)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    sim.init()
    sim.evolve(4)
    f = sim.state.fields
    fields6 = fp.pad_fields((f.Ex, f.Ey, f.Ez, f.Bx, f.By, f.Bz),
                            sim.tile_spec)
    ((pname, _, params, parts, counts),) = list(
        pusher_groups(sim.state, sim.tile_spec, sim.params))
    return sim, (params, fields6, parts, counts), pname, {}


def lwfa_inputs(dev, smi):
    import warpx_tpu_torch
    from warpx_tpu_torch.core.binned_step import pusher_groups

    cfg = cs.main_lwfa_cfg(2048, 8192, cs.lwfa_steps(cs.LWFA_PLAN))
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    _, anchors, zshift = cs.run_lwfa_path(dev, smi, "k2_ab_lwfa", sim,
                                          cs.LWFA_PLAN)
    st = sim.stepper
    fields6 = st.to_kernel_frame(st._padded_eb(sim.state.fields))
    ((pname, _, params, parts, counts),) = list(
        pusher_groups(sim.state, sim.tile_spec, st.params))
    return sim, (params, fields6, parts, counts), pname, dict(
        anchors=anchors, zshift=zshift, smax=st.smax)


def first_difference(parts, got, ref):
    """The first slot where ``got`` and ``ref`` differ: its column, row,
    slot, inputs and both outputs; None where they are bitwise equal."""
    for c, (x, y) in enumerate(zip(got, ref)):
        nz = torch.nonzero(x != y)
        if len(nz):
            r, p = (int(v) for v in nz[0])
            return {"column": c, "row": r, "slot": p,
                    "inputs": [float(a[r, p]) for a in parts],
                    "got": [float(a[r, p]) for a in got],
                    "ref": [float(a[r, p]) for a in ref]}
    return None


def run_shape(shape, libs, sim, inputs, pname, mode, mxu, stem):
    params, fields6, parts, counts = inputs
    cfg, spec = sim.cfg, sim.tile_spec
    nd = spec.ndim
    kw = dict(spec=spec, geom=cfg.geometry, order=cfg.particle_shape,
              galerkin=cfg.galerkin, pusher_name=pname, dt=cfg.dt,
              stag_items=cs.stag_items(nd), mxu=mxu)
    counts, lo, zoff = fp._check(parts, counts, spec, cfg.geometry, mxu,
                                 mode.get("anchors"), mode.get("zshift"),
                                 mode.get("smax", 0))
    a, outs = fp._kernel_args(params, fields6, parts, counts, lo=lo,
                              zoff=zoff, smax=mode.get("smax", 0), **kw)
    table = fp.gather_table_3d if nd == 3 else fp.gather_table_2d
    gal = table(kw["galerkin"], kw["stag_items"])
    wide = torch.zeros(1, dtype=torch.int32, device=parts[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    addr = ctypes.addressof(a)

    def launcher(L, parent):
        launch = getattr(L, f"{stem}_launch")
        if parent:
            return lambda: launch(addr, stream)
        return lambda: launch(addr, gal, wide.data_ptr(), stream)

    fns = {nm: launcher(L, parent) for nm, (L, parent) in libs.items()}
    results, first = {}, None
    for nm, fn in fns.items():
        wide.zero_()
        err = fn()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"{nm}: launch error {err}")
        got = ([t.clone() for t in outs[0]], [t.clone() for t in outs[1]],
               outs[2].clone())
        res = {"wide_tiles": int(wide.item())}
        if first is None:
            first = got
        else:
            res.update(
                particles_differ=[int((x != y).sum())
                                  for x, y in zip(got[0], first[0])],
                first_difference=first_difference(parts, got[0], first[0]),
                particles_bitwise=all(torch.equal(x, y)
                                      for x, y in zip(got[0], first[0])),
                violations_bitwise=torch.equal(got[2], first[2]),
                particles_rel_err=max(cs.rel_err(x, y)[1]
                                      for x, y in zip(got[0], first[0])),
                j_rel_err=max(cs.rel_err(x, y)[1]
                              for x, y in zip(got[1], first[1])))
        results[nm] = res
        del got
    times = {nm: [] for nm in fns}
    order = list(fns)
    for _ in range(3):
        for nm in order + order[::-1]:
            times[nm].append(cs.cuda_ms(fns[nm], 10))
    for nm in fns:
        results[nm].update(ms_min=min(times[nm]),
                           ms_median=float(np.median(times[nm])),
                           ms_all=times[nm])
    emit(kind="ab", shape=shape, mxu=mxu, first=order[0], results=results)


def run_ab(tool, stem, order, parents, variants, states):
    """Build every parent variant (edits of ``_ab/parent/``) and every
    variant of the kernel ``stem`` at ``order`` side by side, print the
    build's registers, spills and SASS atomics and the resident blocks per
    SM, then run all of them on each state that ``states(dev, smi)``
    yields, (shape, sim, inputs, pusher, mode), in every precision mode."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    emit(kind="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)
    out = ROOT / "warpx_tpu_torch" / "_build" / tool
    t0 = time.perf_counter()
    procs = {nm: start_build(nm, PARENT, edits, stem, order, out)
             for nm, edits in parents.items()}
    procs.update({nm: start_build(nm, SRC, edits, stem, order, out)
                  for nm, edits in variants.items()})
    for nm, (proc, _) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"{tool}: the build of {nm} failed:\n"
                             + (out / nm / "build.log").read_text())
    reports = {nm: cs.ptxas_report((out / nm / "build.log").read_text())
               for nm in procs}
    emit(kind="build", seconds=time.perf_counter() - t0,
         registers={nm: dict(sorted(r.items()))
                    for nm, (r, _) in reports.items()},
         spill_bytes={nm: sum(sp.values())
                      for nm, (_, sp) in reports.items()},
         sass_atomics={nm: sass_atomics(lib)
                       for nm, (_, lib) in procs.items()
                       if nm in ("parent", "new")})
    libs = {nm: (load(lib, nm in parents, stem), nm in parents)
            for nm, (_, lib) in procs.items()}
    emit(kind="blocks_per_sm", modes=list(fp.MXU_MODES),
         blocks={nm: [getattr(L, f"{stem}_blocks_per_sm")(m)
                      for m in range(3)]
                 for nm, (L, parent) in libs.items() if not parent})
    for shape, sim, inputs, pname, mode in states(dev, smi):
        for mxu in fp.MXU_MODES:
            run_shape(shape, libs, sim, inputs, pname, mode, mxu, stem)
        del sim, inputs
        torch.cuda.empty_cache()
    emit(kind="done", seconds=time.perf_counter() - t0)
    return 0


def states_2d(dev, smi):
    yield ("uniform2d", *main2d_inputs(dev))
    yield ("lwfa", *lwfa_inputs(dev, smi))


def main() -> int:
    return run_ab("k2_ab", "fused_pic_2d", 3, {"parent": []}, VARIANTS,
                  states_2d)


if __name__ == "__main__":
    raise SystemExit(main())
