"""The tiles of kernel K1c (K2 in moving-window mode,
``warpx_tpu_torch/csrc/fused_pic_2d.cu``) that take its checked path on the
laser-wakefield deck at 2048 x 8192, under PSATD and under Yee, on one card.

    python3 k1c_wide_tiles.py

Run from the repository's root, beside ``chip_smoke.py``, whose helpers it
runs.  For each solver it builds ``chip_smoke.py``'s ``main_lwfa_psatd``
deck (bench.py's deck text at 'mixed', 38 steps; Yee without the PSATD
lines), steps it to each of ``STEPS`` and launches K2 once there on the
inputs the next step would give it: the tiles that took the checked path
(``fused_pic.wide_tiles``), the occupied tiles, the largest spread of a
tile's alive electrons along x and z (cells) and the largest |u|/c.  Prints
one JSON line per solver.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import chip_smoke as cs
import warpx_tpu_torch
from warpx_tpu_torch import build
from warpx_tpu_torch.core.binned_step import pusher_groups
from warpx_tpu_torch.ops import fused_pic as fp
from warpx_tpu_torch.utils.parser import Deck

# a step after the rebin at 32 (zshift 1) and the step main_lwfa_psatd ends
# at (zshift 5-6)
STEPS = (33, 38)


def tile_spread(sim):
    """(largest x spread, largest z spread) of a tile's alive electrons, in
    cells, and the occupied tiles."""
    spec, geom = sim.tile_spec, sim.cfg.geometry
    el = sim.state.species["electrons"]
    alive = el.alive.reshape(spec.n_tiles, spec.p_max)
    big = torch.tensor(1e30, device=el.x.device)
    out = []
    for d, a in enumerate((el.x, el.z)):
        a = a.reshape(spec.n_tiles, spec.p_max)
        hi = torch.where(alive, a, -big).max(1).values
        lo = torch.where(alive, a, big).min(1).values
        spread = torch.where(alive.any(1), hi - lo, torch.zeros_like(hi))
        out.append(float(spread.max()) / geom.dx[d])
    return out, int(alive.any(1).sum())


def main():
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    build.build_all()
    steps = cs.lwfa_steps(cs.LWFA_PSATD_PLAN)
    for solver in ("psatd", "yee"):
        text = cs.lwfa_deck_text(2048, 8192, steps, "mixed")
        if solver == "psatd":
            text = cs.psatd_deck(text)
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float32, device=dev)
        sim.init()
        rows = []
        for upto in STEPS:
            sim.evolve(upto - sim.state.step)
            st, spec, geom = sim.stepper, sim.tile_spec, sim.cfg.geometry
            aux, f = sim.state.aux, st._f
            anchors = list(geom.prob_lo)
            anchors[1] = aux["tile_anchor"]
            zshift = int(np.round(f(f(aux["window_lo"] - aux["tile_anchor"])
                                    / f(geom.dx[1]))))
            fields6 = st.to_kernel_frame(st._padded_eb(sim.state.fields))
            ((pname, _, params, parts, counts),) = list(
                pusher_groups(sim.state, spec, st.params))
            before = fp.wide_tiles(dev, 2)
            fp.binned_push_deposit(
                params, fields6, parts, tuple(anchors), zshift,
                counts=counts, spec=spec, geom=geom,
                order=sim.cfg.particle_shape, galerkin=sim.cfg.galerkin,
                pusher_name=pname, dt=sim.cfg.dt, stag_items=st.stag_items,
                mxu=sim.cfg.tile_mxu, smax=st.smax)
            wide = fp.wide_tiles(dev, 2) - before
            (sx, sz), occupied = tile_spread(sim)
            el = sim.state.species["electrons"]
            u = torch.sqrt(el.ux ** 2 + el.uy ** 2 + el.uz ** 2)
            rows.append({
                "step": upto, "zshift": zshift, "wide_tiles": wide,
                "occupied_tiles": occupied, "max_spread_x_cells": sx,
                "max_spread_z_cells": sz,
                "max_u_over_c": float(torch.where(el.alive, u, 0.0).max())
                / 299792458.0})
        print(json.dumps({"solver": solver, "states": rows,
                          "nvidia_smi": smi}), flush=True)
        del sim
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
