"""Placing the particles an event creates into the free slots of a species.

The counterpart of the masked-emit pattern of ``warpx_tpu.ops.ionization``
and ``warpx_tpu.ops.qed._emit_products``: the k-th event (in slot order)
takes the k-th free slot of the product species (in slot order); an event
beyond the last free slot is dropped, as the JAX package drops it (ROADMAP.md
Queue C).  The ranks come from prefix sums and one scatter, so placing never
waits for the device (``torch.nonzero`` would).
"""

from __future__ import annotations

import torch

__all__ = ["emit_targets", "put_rows"]


def emit_targets(mask: torch.Tensor, free: torch.Tensor):
    """For each source slot, the product slot its event lands in.

    ``mask`` (n_src,) marks the events, ``free`` (n_dst,) the product
    species' free slots.  Returns (tgt, placeable): ``tgt`` (n_src,) int64 is
    the product slot of an event placed, ``n_dst`` otherwise (a slot past
    the end that ``put_rows`` discards); ``placeable`` marks the events
    placed."""
    n_dst = free.shape[0]
    dev = mask.device
    frank = torch.cumsum(free.to(torch.int64), 0) - 1
    slot_of_rank = torch.full((n_dst + 1,), n_dst, dtype=torch.int64,
                              device=dev)
    slot_of_rank.scatter_(
        0, torch.where(free, frank, torch.full_like(frank, n_dst)),
        torch.arange(n_dst, dtype=torch.int64, device=dev))
    # the non-free slots all scattered into the spare entry: reset it
    slot_of_rank[n_dst] = n_dst
    srank = torch.cumsum(mask.to(torch.int64), 0) - 1
    rank = torch.where(mask, srank, torch.full_like(srank, n_dst))
    tgt = slot_of_rank[torch.clamp(rank, max=n_dst)]
    return tgt, mask & (tgt < n_dst)


def put_rows(dst: torch.Tensor, tgt: torch.Tensor, vals) -> torch.Tensor:
    """A copy of ``dst`` with ``vals`` (a tensor of ``tgt``'s length, or a
    scalar) written at ``tgt``; targets equal to ``len(dst)`` are
    dropped."""
    n = dst.shape[0]
    out = torch.cat([dst, dst.new_zeros(1)])
    if not isinstance(vals, torch.Tensor) or vals.dim() == 0:
        vals = torch.full(tgt.shape, vals, dtype=dst.dtype,
                          device=dst.device)
    out.index_copy_(0, tgt, vals.to(dst.dtype))
    return out[:n]
