"""Dynamic load balancing: cost-driven tile->chip assignment.

The JAX package's ``warpx_tpu.parallel.load_balance``, line for line (numpy
only); what follows is its account of the scheme, whose device-side half
the port runs over ``torch.distributed`` ranks in
``core/sharded_step.py`` and ``DistSimulation.load_balance``.

The reference rebalances by recomputing an amrex DistributionMapping from
per-box costs — either a space-filling-curve split (makeSFC) or a greedy
knapsack (makeKnapSack) — and only adopts the new mapping when the proposed
efficiency beats the current one by a configurable ratio
(Source/Parallelization/WarpXRegrid.cpp:74-160).  Costs come from a
heuristic (cells_wt * n_cells + particles_wt * n_particles,
WarpXRegrid.cpp:316 ComputeCostsHeuristic) or from per-box timers.

Translation: fields stay in their even slab blocks (the Maxwell update
is per-cell uniform, so the even split IS the balanced mapping for field
work); what gets rebalanced is the PARTICLE work.  The domain is
over-decomposed into a Morton-ordered tile grid, per-tile costs are
measured from the live particle histogram, and the knapsack/SFC map
decides which rank PROCESSES each tile's particles.  Migrating a particle
to a rank that does not own its slab is legal in the "balanced" step
variant (core/sharded_step.make_balanced_step): gather reads from an
all-gathered field copy and deposition runs one all-reduce over the ranks,
the same traffic the reference's FillBoundary/SyncCurrent pay, traded
against idle-rank time exactly like the reference's efficiency threshold.

Efficiency follows amrex's definition: average per-rank cost normalized to
the max per-rank cost (DistributionMapping.cpp ComputeDistributionMappingEfficiency).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "morton_order",
    "sfc_assignment",
    "knapsack_assignment",
    "assignment_efficiency",
]


def morton_order(tile_shape: Sequence[int]) -> np.ndarray:
    """Indices of the tile grid (C-order raveled) along a Morton curve.

    The analog of amrex's makeSFC box ordering: tiles that are close on the
    curve are close in space, so contiguous curve chunks give compact
    per-chip particle sets (good for the tile-binned kernels downstream).
    """
    shape = tuple(int(s) for s in tile_shape)
    coords = np.indices(shape).reshape(len(shape), -1)  # (ndim, T)
    nbits = max(int(np.ceil(np.log2(max(s, 2)))) for s in shape)
    key = np.zeros(coords.shape[1], dtype=np.uint64)
    ndim = len(shape)
    for b in range(nbits):
        for d in range(ndim):
            bit = (coords[d] >> b) & 1
            key |= bit.astype(np.uint64) << np.uint64(b * ndim + d)
    order = np.argsort(key, kind="stable")
    return order


def sfc_assignment(costs: np.ndarray, order: np.ndarray,
                   n_chips: int) -> np.ndarray:
    """Contiguous split of the SFC-ordered tiles into n_chips chunks.

    Greedy walk matching amrex's Distribute(): accumulate tiles along the
    curve until the running chunk reaches the remaining-average cost, then
    start the next chunk (every chip gets at least one tile while tiles
    remain).
    """
    T = len(costs)
    assign = np.zeros(T, dtype=np.int64)
    remaining_total = float(np.asarray(costs, np.float64)[order].sum())
    i = 0
    for chip in range(n_chips):
        chips_left = n_chips - chip
        if chips_left == 1:
            assign[order[i:]] = chip
            i = T
            break
        target = remaining_total / chips_left
        acc = 0.0
        count = 0
        # take tiles while under target (half-tile rounding), always at
        # least one, and always leaving one per remaining chip
        while i < T and (count == 0 or
                         ((T - i) > (chips_left - 1) and
                          acc + 0.5 * float(costs[order[i]]) < target)):
            acc += float(costs[order[i]])
            assign[order[i]] = chip
            i += 1
            count += 1
        remaining_total -= acc
    return assign


def knapsack_assignment(costs: np.ndarray, n_chips: int,
                        nmax: int | None = None) -> np.ndarray:
    """Greedy LPT knapsack: heaviest tile to the lightest chip.

    ``nmax`` caps tiles per chip (algo.load_balance_knapsack_factor:
    nmax = ceil(T/n * factor), WarpXRegrid.cpp:101).
    """
    T = len(costs)
    if nmax is None:
        nmax = T
    assign = np.zeros(T, dtype=np.int64)
    loads = np.zeros(n_chips)
    counts = np.zeros(n_chips, dtype=np.int64)
    for t in np.argsort(-np.asarray(costs, dtype=np.float64), kind="stable"):
        open_chips = np.where(counts < nmax)[0]
        if len(open_chips) == 0:  # cap too tight: fall back to lightest
            open_chips = np.arange(n_chips)
        chip = open_chips[np.argmin(loads[open_chips])]
        assign[t] = chip
        loads[chip] += float(costs[t])
        counts[chip] += 1
    return assign


def assignment_efficiency(costs: np.ndarray, assign: np.ndarray,
                          n_chips: int) -> float:
    """Average per-chip cost / max per-chip cost (amrex efficiency)."""
    loads = np.bincount(assign, weights=np.asarray(costs, np.float64),
                        minlength=n_chips)
    mx = float(loads.max())
    if mx <= 0.0:
        return 1.0
    return float(loads.mean()) / mx
