"""pywarpx-compatible field data views (reference: Python/pywarpx/fields.py).

The counterpart of ``warpx_tpu.fields``: numpy-like wrappers over the live
simulation's field tensors with global indexing, slicing and assignment.
Reads return numpy arrays with numpy's semantics (negative indices, reversed
slices, index arrays); an index that ``torch`` takes with the same result
(integers and forward slices) is applied on the device, so that only the
selection crosses to the host.  The states are frozen dataclasses, so an
assignment builds a new tensor of the state's dtype and device and puts it
in through ``.replace``; the next step reads it:

    from warpx_tpu_torch import fields
    Ex = fields.ExWrapper()
    mid = Ex[:, :, 16]          # numpy array
    Ex[:, :, 16] = 2 * mid      # writes into the running simulation

The factories carry the reference's class names: ExWrapper..BzWrapper,
JxWrapper.., RhoFPWrapper, PhiFPWrapper, FFPWrapper, GFPWrapper and the *FP
aliases.  Guard cells (``include_ghosts``) are not exposed: the state keeps
none between steps.  The views of a run spread over ranks raise (ROADMAP.md
Queue A 14.4).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.particle_dist import ParticleDistSimulation
from .core.simulation import DistSimulation
from .runtime import get_simulation

__all__ = [
    "FieldWrapper",
    "ExWrapper", "EyWrapper", "EzWrapper",
    "BxWrapper", "ByWrapper", "BzWrapper",
    "JxWrapper", "JyWrapper", "JzWrapper",
    "ExFPWrapper", "EyFPWrapper", "EzFPWrapper",
    "BxFPWrapper", "ByFPWrapper", "BzFPWrapper",
    "JxFPWrapper", "JyFPWrapper", "JzFPWrapper",
    "RhoFPWrapper", "PhiFPWrapper", "FFPWrapper", "GFPWrapper",
]

_ATTR = {
    "Ex": "Ex", "Ey": "Ey", "Ez": "Ez",
    "Bx": "Bx", "By": "By", "Bz": "Bz",
    "Jx": "jx", "Jy": "jy", "Jz": "jz",
    "Rho": "rho", "Phi": "phi", "F": "F", "G": "G",
}


def check_local(sim) -> None:
    """Refuse the views of a run spread over ranks: each rank holds its
    own block of the fields and segment of the particles, where the JAX
    package's views read one global state."""
    if isinstance(sim, (DistSimulation, ParticleDistSimulation)):
        raise NotImplementedError(
            "data views of a distributed run (each rank holds one segment; "
            "ROADMAP.md Queue A 14.4)")


def _device_index(index) -> bool:
    """Whether ``torch`` indexing gives numpy's result for ``index``:
    integers, forward slices, ``...`` and ``None``."""
    parts = index if isinstance(index, tuple) else (index,)
    for p in parts:
        if isinstance(p, slice):
            if p.step is not None and (not isinstance(p.step, int)
                                       or p.step <= 0):
                return False
        elif not (p is Ellipsis or p is None
                  or isinstance(p, (int, np.integer))
                  and not isinstance(p, bool)):
            return False
    return True


class FieldWrapper:
    """View of one field component (reference: fields._MultiFABWrapper):
    len(), .shape, .mesh(direction), numpy-style ``__getitem__`` /
    ``__setitem__``, and the reductions min/max/sum/norm0."""

    def __init__(self, name, level=0, include_ghosts=False, sim=None):
        if level != 0:
            raise NotImplementedError("mesh-refinement levels")
        self.name = name
        self._attr = _ATTR[name]
        self._sim = sim

    @property
    def sim(self):
        sim = self._sim or get_simulation()
        check_local(sim)
        return sim

    def _array(self) -> torch.Tensor:
        arr = getattr(self.sim.state.fields, self._attr, None)
        if arr is None:
            raise RuntimeError(
                f"field '{self.name}' is not allocated in this run"
            )
        return arr

    @property
    def shape(self):
        return tuple(self._array().shape)

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def mesh(self, direction):
        """Physical coordinates of this component's points along an axis
        (reference: fields.py mesh()), with the grid's staggering."""
        sim = self.sim
        geom = sim.cfg.geometry
        d = geom.axis_names.index(direction)
        flags = sim.staggering.get(self.name, (1,) * geom.ndim)
        n = self._array().shape[d]
        offset = 0.0 if flags[d] == 1 else 0.5
        return geom.prob_lo[d] + (np.arange(n) + offset) * geom.dx[d]

    def __getitem__(self, index):
        arr = self._array()
        if _device_index(index):
            out = arr[index].detach().cpu().numpy()
            return out[()] if out.ndim == 0 else out
        return arr.detach().cpu().numpy()[index]

    def __setitem__(self, index, value):
        sim = self.sim
        old = self._array()
        arr = old.detach().cpu().numpy().copy()
        arr[index] = value
        new = torch.from_numpy(arr).to(device=old.device, dtype=old.dtype)
        sim.state = sim.state.replace(
            fields=sim.state.fields.replace(**{self._attr: new}))

    # min, max and norm0 are exact in any order: reduced on the device
    def min(self):
        return float(self._array().min())

    def max(self):
        return float(self._array().max())

    def sum(self):
        return float(np.sum(self[...]))

    def norm0(self):
        return float(self._array().abs().max())


def _factory(name):
    def make(level=0, include_ghosts=False):
        return FieldWrapper(name, level, include_ghosts)

    make.__name__ = f"{name}Wrapper"
    return make


ExWrapper = _factory("Ex")
EyWrapper = _factory("Ey")
EzWrapper = _factory("Ez")
BxWrapper = _factory("Bx")
ByWrapper = _factory("By")
BzWrapper = _factory("Bz")
JxWrapper = _factory("Jx")
JyWrapper = _factory("Jy")
JzWrapper = _factory("Jz")
RhoFPWrapper = _factory("Rho")
PhiFPWrapper = _factory("Phi")
FFPWrapper = _factory("F")
GFPWrapper = _factory("G")

# fine-patch aliases (single-level runs: fp == the only level)
ExFPWrapper, EyFPWrapper, EzFPWrapper = ExWrapper, EyWrapper, EzWrapper
BxFPWrapper, ByFPWrapper, BzFPWrapper = BxWrapper, ByWrapper, BzWrapper
JxFPWrapper, JyFPWrapper, JzFPWrapper = JxWrapper, JyWrapper, JzWrapper
