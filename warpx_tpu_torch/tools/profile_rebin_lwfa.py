"""Lab L5: the rebin's DMA slot-copy variant on the card.

The Hopper counterpart of ``tools/profile_rebin_lwfa.py::variants3`` (the
TPU lab's Pallas kernel ``kern`` and its plain reference ``v_base``): the
payload of ``cap`` particles in 7 rows, sorted by tile, is copied into
``nt`` tiles of ``pmax`` slots, each tile's segment starting at its offset,
and masked by the tile's count.  ``slot_copy`` launches
``csrc/slot_copy.cu`` (bulk asynchronous copies through shared memory,
which need 16-byte-aligned rows: ``pad`` makes them so);
``slot_copy_plain`` is its plain PyTorch version; ``variants3`` times both
beside ``v_base`` and beside K3 (``ops/tiling.py::ragged_expand``) on the
same offsets.

Precision: the lab moves float32 values and computes nothing, so the TPU's
matrix-unit precisions (DEFAULT: one bfloat16 pass; HIGH: three bfloat16
passes, hi*hi + lo*hi + hi*lo; HIGHEST: float32) do not arise; the kernel
must match its plain version exactly.

    python -m warpx_tpu_torch.tools.profile_rebin_lwfa [--device cpu]
        [--cap 4194304] [--nt 8192] [--pmax 512]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build
from ..ops import tiling
from . import _timing

__all__ = ["slot_copy", "slot_copy_plain", "pad", "prelude", "v_base",
           "v_pallas", "variants3", "main"]

TB = 16  # tiles per block in csrc/slot_copy.cu, as the TPU kernel's program
N_ATTR = 7
SEED = 0
REPS = 10  # timed repetitions


def slot_copy_plain(psp, offsets, counts, pmax):
    """Plain PyTorch version of the slot copy:

        out[r, t*pmax + s] = psp[r, offsets[t] + s]  if s < counts[t]
                             0                       otherwise

    (a column outside the row reads as 0)."""
    n_rows, row_len = psp.shape
    slot = torch.arange(pmax, device=psp.device)[None, :]
    col = offsets.long()[:, None] + slot
    valid = (slot < counts.long()[:, None]) & (col >= 0) & (col < row_len)
    g = psp[:, torch.clamp(col, 0, row_len - 1).reshape(-1)]
    zero = torch.zeros((), dtype=psp.dtype, device=psp.device)
    return torch.where(valid.reshape(-1)[None], g, zero)


def slot_copy(psp, offsets, counts, pmax):
    """The slot copy (see ``slot_copy_plain``): a CUDA tensor launches
    ``csrc/slot_copy.cu``, a CPU tensor takes the plain version.  On the
    card the rows must be 16-byte aligned (a row length and ``pmax`` that
    are multiples of 4 floats, an aligned base) for the bulk copies."""
    if psp.device.type == "cpu":
        return slot_copy_plain(psp, offsets, counts, pmax)
    if psp.device.type != "cuda":
        raise ValueError(f"unsupported device {psp.device}")
    dev = psp.device
    _timing.check_tensor("psp", psp, torch.float32, dev)
    if psp.dim() != 2:
        raise ValueError("psp must be (n_rows, row_len)")
    n_rows, row_len = psp.shape
    n_tiles = offsets.shape[0]
    _timing.check_tensor("offsets", offsets, torch.int32, dev, (n_tiles,))
    _timing.check_tensor("counts", counts, torch.int32, dev, (n_tiles,))
    if pmax <= 0 or pmax % 4 or row_len % 4 or psp.data_ptr() % 16:
        raise ValueError("the bulk copies need pmax > 0 and 16-byte-aligned "
                         f"rows: pmax {pmax}, row length {row_len}, base "
                         f"{psp.data_ptr()} (see pad)")
    out = torch.empty((n_rows, n_tiles * pmax), dtype=torch.float32,
                      device=dev)
    err = build.library("slot_copy").slot_copy_launch(
        psp.data_ptr(), row_len, offsets.data_ptr(), counts.data_ptr(),
        out.data_ptr(), n_rows, n_tiles, pmax,
        torch.cuda.current_stream(dev).cuda_stream)
    _timing.check_launch("slot_copy", "slot_copy_error_string", err,
                         "slot_copy")
    slot_copy.launches += 1
    return out


slot_copy.launches = 0


def pad(ps, pmax):
    """The payload padded with zero columns, at least ``pmax`` of them, to
    a row length that is a multiple of 4 (16-byte rows for the bulk
    copies); a column past the payload reads as 0 either way."""
    n_rows, cap = ps.shape
    extra = pmax + (-(cap + pmax)) % 4
    return torch.cat([ps, torch.zeros((n_rows, extra), dtype=ps.dtype,
                                      device=ps.device)], dim=1)


def prelude(key_sorted, nt):
    """Each tile's segment in the sorted keys: (offsets, counts), int32."""
    edges = torch.arange(nt + 1, dtype=torch.int32, device=key_sorted.device)
    bounds = torch.searchsorted(key_sorted, edges, out_int32=True)
    return bounds[:-1].contiguous(), (bounds[1:] - bounds[:-1]).contiguous()


def v_base(ps, ks, nt, pmax):
    """The TPU lab's plain reference (``v_base``, :348): one gather of
    clipped source columns, masked by the counts."""
    cap = ps.shape[1]
    offsets, counts = prelude(ks, nt)
    slot_s = torch.arange(pmax, device=ps.device).repeat(nt)
    slot_t = torch.arange(nt, device=ps.device).repeat_interleave(pmax)
    src = torch.clamp(offsets.long()[slot_t] + slot_s, 0, cap - 1)
    valid = slot_s < counts.long()[slot_t]
    return torch.where(valid[None], ps[:, src],
                       torch.zeros((), dtype=ps.dtype, device=ps.device))


def v_pallas(ps, ks, nt, pmax):
    """The TPU lab's ``v_pallas`` (:325): pad the payload by pmax columns
    (and up to 3 more, see ``pad``) and run the slot copy."""
    offsets, counts = prelude(ks, nt)
    return slot_copy(pad(ps, pmax), offsets, counts, pmax)


def inputs(cap, nt, seed, device):
    """The lab's inputs: tile keys drawn uniformly and sorted, a payload of
    standard normals in 7 rows (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    tid = np.sort(rng.integers(0, nt, cap)).astype(np.int32)
    payload = rng.standard_normal((N_ATTR, cap)).astype(np.float32)
    return (torch.from_numpy(payload).to(device),
            torch.from_numpy(tid).to(device))


def variants3(device="cuda", cap=4_194_304, nt=8192, pmax=512):
    """The lab at its shapes: ``v_pallas`` against ``v_base`` (they must be
    equal), then the slot copy timed beside its plain version, beside
    ``v_base`` and beside K3 on the same offsets, and its bound.  Returns
    the result dict."""
    device = torch.device(device)
    ps, ks = inputs(cap, nt, SEED, device)
    a = v_base(ps, ks, nt, pmax)
    b = v_pallas(ps, ks, nt, pmax)
    err = (a - b).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"the slot copy differs from v_base by {err}")
    offsets, counts = prelude(ks, nt)
    psp = pad(ps, pmax)
    fill = torch.zeros((N_ATTR, nt), dtype=ps.dtype, device=device)
    ms = _timing.time_ms(lambda: slot_copy(psp, offsets, counts, pmax), REPS,
                         device)
    plain_ms = _timing.time_ms(
        lambda: slot_copy_plain(psp, offsets, counts, pmax), REPS, device)
    base_ms = _timing.time_ms(lambda: v_base(ps, ks, nt, pmax), REPS, device)
    k3_ms = _timing.time_ms(
        lambda: tiling.ragged_expand(ps, offsets, counts, fill, pmax), REPS,
        device)
    kept = int(torch.clamp(counts, max=pmax).sum())
    n_bytes = N_ATTR * 4 * (kept + nt * pmax) + _timing.nbytes(offsets,
                                                              counts)
    bound, by = _timing.bound_ms(n_bytes, 0)
    res = _timing.result(
        "L5 slot_copy", device, ms, plain_ms,
        rates={"bound_share": bound / ms}, v_base_ms=base_ms,
        k3_ragged_expand_ms=k3_ms, bound_ms=bound, bound_by=by,
        bytes=n_bytes, library_ms=None,
        library="none: no single PyTorch call copies ragged segments with a "
                "count mask (v_base is a gather and a where)",
        max_abs_err=err, cap=cap, nt=nt, pmax=pmax, tb=TB)
    return _timing.summary("L5 profile_rebin_lwfa", device, cases=[res],
                           launches=slot_copy.launches)


def main(argv=None):
    def extra(p):
        p.add_argument("--cap", type=int, default=4_194_304)
        p.add_argument("--nt", type=int, default=8192)
        p.add_argument("--pmax", type=int, default=512)

    args = _timing.lab_args(__doc__, argv, extra)
    res = variants3(args.device, args.cap, args.nt, args.pmax)
    _timing.emit(res)
    return res


if __name__ == "__main__":
    main()
