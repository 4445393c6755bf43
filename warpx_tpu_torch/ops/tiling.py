"""Tile-binned particle layout for the fused hot path.

The counterpart of ``warpx_tpu.ops.tiling``.  Particles live in a
fixed-capacity padded layout of ``n_tiles x p_max`` slots, re-sorted every
``interval`` steps (the reference's SortParticlesByBin cadence,
WarpXEvolve.cpp:575-580), so the fused kernel (``ops/fused_pic.py``) can
process one tile per CUDA block with its J window in shared memory (the
reference's shared-memory binned deposition,
WarpXParticleContainer.cpp:490-548).

Pieces:
  * TileSpec        -- static tiling geometry (a copy of the JAX package's)
  * rebin           -- sort particles into the padded tile layout
  * ragged_expand   -- the rebin's slot expansion, kernel K3
                       (``csrc/ragged_expand.cu``)
  * extract_windows -- grid -> per-tile field windows (periodic)
  * fold_windows    -- per-tile J windows -> grid (periodic overlap-add)
  * fold_windows_open -- the same overlap-add without the wrap, for the
                       bounded step's guard-padded deposition block
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .. import build

__all__ = ["TileSpec", "tile_ids", "rebin", "rebin_inputs", "ragged_expand",
           "ragged_expand_plain", "extract_windows", "fold_windows",
           "fold_windows_open"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Static tile/window geometry for the binned hot path (2D XZ or 3D).

    ``w`` is the per-dim window width: every index an order-``order``
    Esirkepov deposition (T = order+3 taps, start index floor(x)-s_lo) or
    shape-``order`` gather can touch for any particle that was inside the
    tile at the last rebin and has drifted at most ``margin`` cells since.
    Window start (grid units) for tile t is ``t*tile - off``.
    """

    tile: Tuple[int, ...]
    tiles_per_dim: Tuple[int, ...]
    p_max: int
    order: int
    margin: int
    interval: int
    w: int
    off: int

    @property
    def ndim(self) -> int:
        return len(self.tile)

    @property
    def n_tiles(self) -> int:
        return int(np.prod(self.tiles_per_dim))

    @property
    def capacity(self) -> int:
        return self.n_tiles * self.p_max

    @classmethod
    def create(
        cls,
        n_cell: Tuple[int, ...],
        order: int,
        n_particles: int,
        tile: Tuple[int, ...] = (8, 8, 8),
        margin: int = 1,
        interval: int = 1,
        headroom: float = 2.0,
        p_max: int | None = None,
    ) -> "TileSpec":
        if len(n_cell) not in (2, 3):
            raise NotImplementedError("tiled layout is 2D/3D-only")
        tile = tuple(tile)[-len(n_cell):] if len(tile) != len(n_cell) \
            else tuple(tile)
        tiles_per_dim = []
        for n, t in zip(n_cell, tile):
            if n % t:
                raise ValueError(f"n_cell {n} not divisible by tile {t}")
            tiles_per_dim.append(n // t)
        n_tiles = int(np.prod(tiles_per_dim))
        if p_max is None:
            # 128-granular slot capacity, as in the JAX package, so both
            # packages lay out the same slots
            mean = max(1, n_particles // n_tiles)
            p_max = _round_up(int(math.ceil(mean * headroom)), 128)
        taps = order + 3
        s_lo = (order + 1) // 2 + 1  # window reaches floor(x) - s_lo + 1
        off = margin + s_lo
        w_min = tile[0] + taps + 2 * margin + 1
        w = _round_up(w_min, 8)
        return cls(
            tile=tuple(tile),
            tiles_per_dim=tuple(tiles_per_dim),
            p_max=int(p_max),
            order=order,
            margin=margin,
            interval=interval,
            w=w,
            off=off,
        )


def tile_ids(positions, geom, spec: TileSpec, origin=None) -> torch.Tensor:
    """Linear (C-order) tile id per particle from wrapped positions.
    ``origin`` replaces ``prob_lo`` as the tiling origin (the moving-window
    step anchors the tiles where the window stood at the last rebin);
    positions outside the tiling clip into the edge tiles."""
    lo = geom.prob_lo if origin is None else origin
    ids = 0
    for d in range(spec.ndim):
        gd = (positions[d] - lo[d]) * (1.0 / geom.dx[d])
        idx = torch.clamp(
            torch.floor(gd).to(torch.int32) // spec.tile[d],
            0, spec.tiles_per_dim[d] - 1,
        )
        ids = ids * spec.tiles_per_dim[d] + idx
    return ids


def tile_centers(geom, spec: TileSpec, dtype, device,
                 origin=None) -> torch.Tensor:
    """(ndim, n_tiles) tile-center coordinates, the dead-slot position."""
    lo = geom.prob_lo if origin is None else origin
    tile_i = torch.arange(spec.n_tiles, dtype=torch.int32, device=device)
    out = []
    for d in range(spec.ndim):
        stride = int(np.prod(spec.tiles_per_dim[d + 1:], initial=1))
        idx_d = (tile_i // stride) % spec.tiles_per_dim[d]
        out.append(lo[d]
                   + (idx_d.to(dtype) + 0.5) * (spec.tile[d] * geom.dx[d]))
    return torch.stack(out, dim=0)


# ---- kernel K3: slot expansion -------------------------------------------

def ragged_expand_plain(payload_sorted, offsets, counts, fill, p_max):
    """Plain PyTorch version of K3 (the gather branch of
    ``warpx_tpu.ops.tiling.rebin``, tiling.py:293-296, plus its dead-slot
    fills, tiling.py:298-330):

        out[a, t*p_max + s] = payload_sorted[a, offsets[t] + s]  if s < counts[t]
                              fill[a, t]                         otherwise
    """
    n_attr, cap_in = payload_sorted.shape
    n_tiles = offsets.shape[0]
    slot = torch.arange(p_max, device=offsets.device)[None, :]
    valid = slot < counts.long()[:, None]
    src = torch.clamp(offsets.long()[:, None] + slot, 0, cap_in - 1)
    gathered = payload_sorted[:, src.reshape(-1)]
    fills = torch.broadcast_to(fill[:, :, None], (n_attr, n_tiles, p_max))
    return torch.where(valid.reshape(-1), gathered,
                       fills.reshape(n_attr, -1))


def ragged_expand(payload_sorted, offsets, counts, fill, p_max):
    """Kernel K3: expand tile-sorted ragged segments into the padded slot
    layout with the dead-slot fills fused (see ``ragged_expand_plain``).

    Replaces ``warpx_tpu/ops/tiling.py::_ragged_expand`` (Pallas DMA slot
    expansion).  A CUDA tensor launches ``csrc/ragged_expand.cu``; a CPU
    tensor takes the plain version.
    """
    if payload_sorted.device.type == "cpu":
        return ragged_expand_plain(payload_sorted, offsets, counts, fill,
                                   p_max)
    if payload_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {payload_sorted.device}")
    dtype = payload_sorted.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ragged_expand takes float32/float64, got {dtype}")
    n_attr, cap_in = payload_sorted.shape
    n_tiles = offsets.shape[0]
    dev = payload_sorted.device
    for name, t, dt_ in (("offsets", offsets, torch.int32),
                         ("counts", counts, torch.int32),
                         ("fill", fill, dtype)):
        if t.dtype != dt_ or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt_} tensor on "
                             f"{dev}")
    if fill.shape != (n_attr, n_tiles) or counts.shape != (n_tiles,):
        raise ValueError("fill must be (n_attr, n_tiles), counts (n_tiles,)")
    src = payload_sorted.contiguous()
    out = torch.empty((n_attr, n_tiles * p_max), dtype=dtype, device=dev)
    lib = build.library("ragged_expand")
    err = lib.ragged_expand_launch(
        int(dtype == torch.float64), src.data_ptr(), cap_in,
        offsets.data_ptr(), counts.data_ptr(), fill.data_ptr(),
        out.data_ptr(), n_attr, n_tiles, p_max,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"ragged_expand launch failed: "
            f"{build.cuda_error('ragged_expand', 'ragged_expand_error_string', err)}"
        )
    ragged_expand.launches += 1
    return out


ragged_expand.launches = 0


# ---- rebin ---------------------------------------------------------------

def rebin_inputs(sp, geom, spec: TileSpec, origin=None, wrap_dims=None):
    """The rebin up to the slot expansion: wrap the positions on
    ``wrap_dims`` (default: all), sort the payload by tile
    (``torch.sort(stable=True)`` on the key, then one gather of the
    payload), and locate each tile's segment.  Dead slots sort to the bucket
    past the last tile, which no segment covers: the rebin frees them.

    Returns (payload_sorted (n_attr, cap), offsets, counts (n_tiles,) int32,
    fill (n_attr, n_tiles)); the payload rows are the positions, ux, uy, uz,
    w, alive (as 0/1) and the runtime attributes in sorted name order.
    """
    ndim = spec.ndim
    n_tiles = spec.n_tiles
    dtype = sp.w.dtype
    lo_all = geom.prob_lo if origin is None else origin
    pos = list(sp.positions(ndim))
    for d in range(ndim):
        if wrap_dims is not None and not wrap_dims[d]:
            continue
        lo = lo_all[d]
        hi = lo + (geom.prob_hi[d] - geom.prob_lo[d])
        pos[d] = lo + torch.remainder(pos[d] - lo, hi - lo)
    tid = torch.where(sp.alive, tile_ids(pos, geom, spec, origin=lo_all),
                      torch.full_like(sp.alive, n_tiles, dtype=torch.int32))
    # the runtime attributes ride as further rows in sorted name order,
    # in the payload's floating type (JAX tiling.py:257-264)
    payload = torch.stack(
        pos + [sp.ux, sp.uy, sp.uz, sp.w, sp.alive.to(dtype)]
        + [sp.extra[k].to(dtype) for k in sorted(sp.extra)], dim=0
    )
    key_sorted, perm = torch.sort(tid, stable=True)
    payload_sorted = payload[:, perm]
    edges = torch.arange(n_tiles + 1, dtype=torch.int32, device=tid.device)
    bounds = torch.searchsorted(key_sorted, edges, out_int32=True)
    offsets = bounds[:-1].contiguous()
    counts = (bounds[1:] - bounds[:-1]).contiguous()
    fill = torch.zeros((payload.shape[0], n_tiles), dtype=dtype,
                       device=tid.device)
    fill[:ndim] = tile_centers(geom, spec, dtype, tid.device, origin=lo_all)
    return payload_sorted, offsets, counts, fill


def rebin(sp, geom, spec: TileSpec, origin=None, wrap_dims=None):
    """Sort a species into the padded (n_tiles, p_max) tile layout.

    Positions are wrapped into the periodic domain first (between rebins
    the step leaves them unwrapped so window-relative coordinates stay
    continuous across the boundary).  Dead slots get weight 0, zero
    momentum, and the center position of their tile.

    ``origin`` (ndim host numbers) replaces ``prob_lo`` as the tiling origin
    for the bounded and moving-window steps; ``wrap_dims`` selects the dims
    that wrap (default: all).  On the others a particle outside the domain
    clips into the edge tile: the caller has absorbed it (alive False)
    beforehand.

    Returns (new ParticleState with capacity n_tiles*p_max, overflow): the
    overflow counts alive particles that did not fit in their tile's p_max
    slots; callers treat overflow > 0 as a hard error.
    """
    ndim = spec.ndim
    payload_sorted, offsets, counts, fill = rebin_inputs(
        sp, geom, spec, origin=origin, wrap_dims=wrap_dims)
    overflow = torch.clamp(counts - spec.p_max, min=0).sum(dtype=torch.int32)
    out = ragged_expand(payload_sorted, offsets, counts, fill, spec.p_max)
    names = ("x", "z") if ndim == 2 else ("x", "y", "z")
    new = sp.replace(
        **{nm: out[d] for d, nm in enumerate(names)},
        ux=out[ndim], uy=out[ndim + 1], uz=out[ndim + 2], w=out[ndim + 3],
        alive=out[ndim + 4] > 0.5,
        extra={k: _like(out[ndim + 5 + i], sp.extra[k])
               for i, k in enumerate(sorted(sp.extra))},
    )
    return new, overflow


def _like(row, attr):
    """A payload row back in its attribute's type: an integer attribute
    was floated exactly below 2^24 in float32 (2^53 in float64), and the
    JAX package, whose rebin leaves it floated, raises on it in its binned
    steps (ROADMAP.md Queue C)."""
    if attr.dtype.is_floating_point:
        return row
    return torch.round(row).to(attr.dtype)


# ---- field windows -------------------------------------------------------

def _window_index(spec: TileSpec, d: int, n: int, device):
    """(n_tiles_d, W) periodic grid indices of the windows along axis d."""
    t = torch.arange(spec.tiles_per_dim[d], device=device)[:, None]
    a = torch.arange(spec.w, device=device)[None, :]
    return torch.remainder(t * spec.tile[d] - spec.off + a, n)


def _tile_window_view(windows, spec: TileSpec, axes):
    """``windows`` as (tiles_per_dim..., W per spatial axis): ``axes`` names
    the spatial axis of each window dim (default: in order)."""
    ndim = spec.ndim
    arr = windows.reshape(*spec.tiles_per_dim, *((spec.w,) * ndim))
    if axes is not None and tuple(axes) != tuple(range(ndim)):
        inv = [0] * ndim
        for pos_, ax in enumerate(axes):
            inv[ax] = ndim + pos_
        arr = arr.permute(*range(ndim), *inv)
    return arr


def broadcast_index(idx, ndim):
    """Per-axis (n_tiles_d, W) index tables shaped to broadcast over
    (tiles..., windows...)."""
    out = []
    for d, ix in enumerate(idx):
        shape = [1] * (2 * ndim)
        shape[d], shape[ndim + d] = ix.shape
        out.append(ix.reshape(shape))
    return out


def extract_windows(grid: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Per-tile periodic windows: (n_tiles, W, W*W) with layout (x, (y,z))
    in 3D, (n_tiles, W, W) with layout (x, z) in 2D:

        windows[t, a, b*W+c] = grid[(t_x*tx - off + a) % nx,
                                    (t_y*ty - off + b) % ny,
                                    (t_z*tz - off + c) % nz]
    """
    ndim = spec.ndim
    idx = broadcast_index(
        [_window_index(spec, d, grid.shape[d], grid.device)
         for d in range(ndim)], ndim)
    win = grid[tuple(idx)]
    return win.reshape(spec.n_tiles, spec.w, spec.w ** (ndim - 1))


def fold_windows(windows: torch.Tensor, spec: TileSpec, n_cell,
                 axes=None) -> torch.Tensor:
    """Overlap-add per-tile windows onto the periodic grid, the adjoint of
    ``extract_windows`` and the analog of SumBoundary after deposition
    (WarpXComm.cpp:1074): grid[(t*tile - off + a) % n] += windows[t, a].
    ``axes`` names the spatial axis of each window dim (the 3D fused kernel
    emits each J component in its own axis order)."""
    w, off = spec.w, spec.off
    ndim = spec.ndim
    arr = _tile_window_view(windows, spec, axes)
    if all(w % t == 0 for t in spec.tile):
        # roll-based overlap-add: chunk j of the window axis adds into tile
        # t+j; then merge (nt, tile) -> n and shift back by off
        out = arr
        for d in reversed(range(ndim)):
            tile = spec.tile[d]
            t_ax, w_ax = d, ndim + d
            chunks = [
                torch.roll(out.narrow(w_ax, j * tile, tile), j, dims=t_ax)
                for j in range(w // tile)
            ]
            out = sum(chunks[1:], chunks[0])
            moved = torch.movedim(out, w_ax, t_ax + 1)
            ms = list(moved.shape)
            merged = moved.reshape(ms[:t_ax] + [n_cell[d]] + ms[t_ax + 2:])
            out = torch.roll(merged, -off, dims=t_ax)
        return out
    # general case: one scatter-add through the periodic window indices
    idx = broadcast_index(
        [_window_index(spec, d, n_cell[d], arr.device) for d in range(ndim)],
        ndim)
    lin = idx[0]
    for d in range(1, ndim):
        lin = lin * n_cell[d] + idx[d]
    out = torch.zeros(int(np.prod(n_cell)), dtype=arr.dtype,
                      device=arr.device)
    out.index_add_(0, torch.broadcast_to(lin, arr.shape).reshape(-1),
                   arr.reshape(-1))
    return out.reshape(tuple(n_cell))


def fold_windows_open(windows: torch.Tensor, spec: TileSpec,
                      axes=None) -> torch.Tensor:
    """Open (non-periodic) overlap-add of per-tile windows: no wrap-around.
    Returns an array of extent ``n_d + w - tile_d`` per dim whose index p
    is the anchor-frame grid index ``p - off``; the bounded step embeds it
    in its guard-padded deposition block.  Needs ``w % tile == 0``."""
    w = spec.w
    ndim = spec.ndim
    if not all(w % t == 0 for t in spec.tile):
        raise NotImplementedError("fold_windows_open needs w % tile == 0")
    out = _tile_window_view(windows, spec, axes)
    for d in reversed(range(ndim)):
        tile = spec.tile[d]
        k = w // tile
        t_ax, w_ax = d, ndim + d
        nt = spec.tiles_per_dim[d]
        # chunk j of the window axis adds into padded tile slot t + j: the
        # tile axis grows to nt + k - 1 (extent n + w - tile)
        shape = list(out.shape)
        shape[t_ax] = nt + k - 1
        shape[w_ax] = tile
        total = torch.zeros(shape, dtype=out.dtype, device=out.device)
        for j in range(k):
            total.narrow(t_ax, j, nt).add_(out.narrow(w_ax, j * tile, tile))
        moved = torch.movedim(total, w_ax, t_ax + 1)
        ms = list(moved.shape)
        out = moved.reshape(ms[:t_ax] + [(nt + k - 1) * tile]
                            + ms[t_ax + 2:])
    return out
