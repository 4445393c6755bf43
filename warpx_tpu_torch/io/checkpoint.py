"""Checkpoint / restart: the whole ``SimState`` in one self-describing file.

The counterpart of ``warpx_tpu.io.checkpoint`` (reference: the checkpoint
flush format, Source/Diagnostics/FlushFormats/FlushFormatCheckpoint.cpp,
restored by InitFromCheckpoint, Source/Diagnostics/WarpXIO.cpp:90-330).  A
checkpoint directory holds ``state.npz``, one array per entry of
``state_to_numpy``'s nesting under its path (``fields/Ex``,
``species/electrons/x``, ``aux/pml:Ex:z``, ``aux/window_lo``, ``step``,
``time``; ``fields/F``, ``fields/Ex_avg`` and the like where the
configuration carries them, ``fields/smg/<ring>`` for the RZ
Silver-Mueller guard rings; ``species/<name>/extra/<attribute>`` for the
runtime attributes; ``rng`` for the state of the simulation's draw source,
``utils/draws.py``, where it has one, as the JAX package keeps its key in
the state), and ``header.json`` with the JAX package's keys (``n_leaves``,
``is_synchronized``, ``step``).  ``load_checkpoint`` restores into a
template state of the same configuration and refuses an entry whose name,
shape or dtype differs from the template's.  On the CPU a restarted run
repeats the uninterrupted one bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from ..core.state import SimState, field_names, state_from_numpy

__all__ = ["save_checkpoint", "load_checkpoint"]


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        elif val is not None:
            out[path] = val
    return out


def _entries(state: SimState, draws=None):
    """``state_to_numpy``'s nesting, flat (``fields/Ex``), with the state's
    own tensors and host numbers as values (nothing moved), and the draw
    source's state under ``rng``."""
    fields = {nm: getattr(state.fields, nm)
              for nm in field_names(state.fields)}
    if state.fields.smg is not None:
        fields["smg"] = dict(state.fields.smg)
    out = _flatten({
        "fields": fields,
        "species": {name: {**{nm: getattr(sp, nm)
                              for nm in ("w", "ux", "uy", "uz", "alive",
                                         "x", "y", "z")},
                           "extra": dict(sp.extra)}
                    for name, sp in state.species.items()},
        "step": state.step,
        "time": state.time,
        "aux": dict(state.aux),
    })
    if draws is not None:
        out["rng"] = draws.get_state()
    return out


def _layout(val):
    """(shape, numpy dtype) of a tensor or a host number."""
    if isinstance(val, torch.Tensor):
        return tuple(val.shape), torch.empty((), dtype=val.dtype).numpy().dtype
    a = np.asarray(val)
    return a.shape, a.dtype


def _nest(flat):
    tree = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def save_checkpoint(path: str, state: SimState, is_synchronized: bool,
                    draws=None):
    """Write ``state`` (one transfer to the host a tensor) and the state of
    the draw source ``draws`` under ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
              for k, v in _entries(state, draws).items()}
    np.savez(os.path.join(path, "state.npz"), **arrays)
    meta = {
        "n_leaves": len(arrays),
        "is_synchronized": bool(is_synchronized),
        "step": int(state.step),
    }
    with open(os.path.join(path, "header.json"), "w") as fh:
        json.dump(meta, fh)


def load_checkpoint(path: str, template: SimState,
                    draws=None) -> Tuple[SimState, bool]:
    """The state saved under ``path``, on the template's device and in its
    precision, and whether it was synchronized; ``draws`` (the draw source
    of the simulation that saved it, where it had one) continues the saved
    stream."""
    with open(os.path.join(path, "header.json")) as fh:
        meta = json.load(fh)
    want = {k: _layout(v) for k, v in _entries(template, draws).items()}
    with np.load(os.path.join(path, "state.npz")) as data:
        flat = {k: data[k] for k in data.files}
    if meta["n_leaves"] != len(flat) or set(flat) != set(want):
        raise ValueError(
            f"checkpoint {path} does not match the configuration: entries "
            f"{sorted(set(flat) ^ set(want))} differ")
    for key, (shape, dtype) in want.items():
        got = flat[key]
        if got.shape != shape or got.dtype != dtype:
            raise ValueError(
                f"checkpoint {path}: {key} is {got.dtype}{list(got.shape)}, "
                f"the configuration has {dtype}{list(shape)}")
    if draws is not None:
        draws.set_state(torch.from_numpy(flat.pop("rng")))
    f = template.fields.Ex
    return (state_from_numpy(_nest(flat), dtype=f.dtype, device=f.device),
            bool(meta["is_synchronized"]))
