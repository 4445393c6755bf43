"""Simulation state as frozen dataclasses of tensors.

The counterpart of ``warpx_tpu.core.state``: the same containers and field
names, holding ``torch.Tensor``s on one device.  Steps return new states
through ``.replace``; nothing updates a state in place.

``state_from_numpy`` / ``state_to_numpy`` carry a state across frameworks as
a nested dict of numpy arrays (``{"fields": {...}, "species": {name:
{...}}, "step", "time", "aux"}``); the RZ Silver-Mueller rings ride under
``fields["smg"]`` as a dict, a species' runtime attributes in its
dict under ``"extra"`` (``{"ionizationLevel": ..., ...}``; absent when it
has none).  The tests use them to start the port
from a ``warpx_tpu`` state and to compare the two.  In ``aux`` the moving
window's scalars (``HOST_AUX``, ``inject_pos:<species>``) are host numbers
in the state's precision, because the step branches on them and hands them
to the kernels; everything else there (PML split fields, the layout's
safety counters) is a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["FieldState", "ParticleState", "SimState", "state_from_numpy",
           "state_to_numpy", "HOST_AUX", "is_host_aux", "OPTIONAL_FIELDS",
           "field_names"]

# aux entries kept as host numbers; ``inject_pos:`` prefixes one entry per
# continuously injected species
HOST_AUX = ("window_x", "window_lo", "window_hi", "window_offset",
            "tile_anchor")
# the injection fronts, and the rigid-injection planes and mean speeds
_HOST_AUX_PREFIX = ("inject_pos:", "zinject:", "vzave:")


def is_host_aux(key: str) -> bool:
    return key in HOST_AUX or key.startswith(_HOST_AUX_PREFIX)


_FIELD_NAMES = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
# present only in the configurations that carry them (None otherwise)
OPTIONAL_FIELDS = ("F", "G", "phi", "Ex_avg", "Ey_avg", "Ez_avg", "Bx_avg",
                   "By_avg", "Bz_avg", "hrho", "hjx", "hjy", "hjz")
_PARTICLE_NAMES = ("w", "ux", "uy", "uz", "alive", "x", "y", "z")


@dataclasses.dataclass(frozen=True)
class FieldState:
    """Per-level electromagnetic grid state: one array per component
    (reference: Source/Fields.H:28-81), of the grid's shape on the periodic
    torus and of ``DomainLayout.field_shapes`` on a bounded domain."""

    Ex: torch.Tensor
    Ey: torch.Tensor
    Ez: torch.Tensor
    Bx: torch.Tensor
    By: torch.Tensor
    Bz: torch.Tensor
    jx: torch.Tensor
    jy: torch.Tensor
    jz: torch.Tensor
    # the divergence-cleaning scalars (warpx.do_dive_cleaning /
    # do_divb_cleaning)
    F: Optional[torch.Tensor] = None
    G: Optional[torch.Tensor] = None
    # the nodal potential of the last Poisson solve (electrostatic runs;
    # the reference's phi_fp, diagnostic "phi")
    phi: Optional[torch.Tensor] = None
    # the time-averaged fields of averaged PSATD (Efield_avg_fp), zero at
    # the start of a run
    Ex_avg: Optional[torch.Tensor] = None
    Ey_avg: Optional[torch.Tensor] = None
    Ez_avg: Optional[torch.Tensor] = None
    Bx_avg: Optional[torch.Tensor] = None
    By_avg: Optional[torch.Tensor] = None
    Bz_avg: Optional[torch.Tensor] = None
    # hybrid-PIC: rho^n and the ion current J_i^{n-1/2} carried from one
    # step to the next (hybrid_rho_fp_temp, hybrid_current_fp_temp)
    hrho: Optional[torch.Tensor] = None
    hjx: Optional[torch.Tensor] = None
    hjy: Optional[torch.Tensor] = None
    hjz: Optional[torch.Tensor] = None
    # RZ Silver-Mueller: the guard-cell B rings outside the absorbing walls
    # (br_zlo, bt_zlo, br_zhi, bt_zhi: (C, NR(+1)); bt_rhi, bz_rhi: (C,
    # NZ(+1))), advanced once a step (the JAX package's FieldState.smg)
    smg: Optional[Dict[str, torch.Tensor]] = None

    def e(self):
        return (self.Ex, self.Ey, self.Ez)

    def b(self):
        return (self.Bx, self.By, self.Bz)

    def j(self):
        return (self.jx, self.jy, self.jz)

    def replace(self, **kw) -> "FieldState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """Fixed-capacity SoA particle arrays for one species with an ``alive``
    mask.  Positions are absolute SI coordinates; ``ux, uy, uz`` are proper
    velocities gamma*v [m/s]."""

    w: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    alive: torch.Tensor  # bool
    x: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None
    # runtime attributes, one value per slot: ionizationLevel (int32),
    # opticalDepthQSR and opticalDepthBW (the reference's runtime
    # components, e.g. PhysicalParticleContainer::InitIonizationModule)
    extra: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.w.shape[0]

    def positions(self, ndim: int):
        if ndim == 1:
            return (self.z,)
        if ndim == 2:
            return (self.x, self.z)
        return (self.x, self.y, self.z)

    def with_positions(self, ndim: int, pos) -> "ParticleState":
        if ndim == 1:
            return dataclasses.replace(self, z=pos[0])
        if ndim == 2:
            return dataclasses.replace(self, x=pos[0], z=pos[1])
        return dataclasses.replace(self, x=pos[0], y=pos[1], z=pos[2])

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SimState:
    """Complete state advanced by the step function.  ``step`` and ``time``
    are host numbers (the step loop branches on them without a device
    sync); ``aux`` holds device tensors such as ``tile_overflow`` and the
    PML split fields, and the moving window's host scalars."""

    fields: FieldState
    species: Dict[str, ParticleState]
    step: int
    time: float
    aux: Dict[str, object] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def field_names(fields: FieldState):
    """The names of the components ``fields`` holds, in a fixed order."""
    return _FIELD_NAMES + tuple(nm for nm in OPTIONAL_FIELDS
                                if getattr(fields, nm) is not None)


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)


def _host_scalar(v, dtype):
    v = np.asarray(v)
    if np.issubdtype(v.dtype, np.integer):
        return int(v)
    return torch.empty((), dtype=dtype).numpy().dtype.type(v)


def state_from_numpy(data: dict, dtype: torch.dtype,
                     device: torch.device | str) -> SimState:
    """Build a ``SimState`` from the nested numpy dict described in the
    module docstring (absent position arrays stay None)."""
    fields = FieldState(**{
        nm: _tensor(a, dtype, device) for nm, a in data["fields"].items()
        if nm in _FIELD_NAMES + OPTIONAL_FIELDS and a is not None
    })
    if data["fields"].get("smg") is not None:
        fields = fields.replace(smg={
            k: _tensor(a, dtype, device)
            for k, a in data["fields"]["smg"].items()})
    species = {}
    for name, sp in data["species"].items():
        species[name] = ParticleState(
            **{nm: _tensor(sp[nm], dtype, device)
               for nm in _PARTICLE_NAMES if sp.get(nm) is not None},
            extra={k: _tensor(a, dtype, device)
                   for k, a in (sp.get("extra") or {}).items()})
    return SimState(
        fields=fields,
        species=species,
        step=int(data["step"]),
        time=float(data["time"]),
        aux={k: (_host_scalar(v, dtype) if is_host_aux(k)
                 else _tensor(v, dtype, device))
             for k, v in data.get("aux", {}).items()},
    )


def state_to_numpy(state: SimState) -> dict:
    """The inverse of ``state_from_numpy``."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    fields = {nm: host(getattr(state.fields, nm))
              for nm in field_names(state.fields)}
    if state.fields.smg is not None:
        fields["smg"] = {k: host(v) for k, v in state.fields.smg.items()}
    return {
        "fields": fields,
        "species": {
            name: {**{nm: host(getattr(sp, nm)) for nm in _PARTICLE_NAMES},
                   **({"extra": {k: host(v) for k, v in sp.extra.items()}}
                      if sp.extra else {})}
            for name, sp in state.species.items()
        },
        "step": state.step,
        "time": state.time,
        "aux": {k: (np.asarray(v) if is_host_aux(k) else host(v))
                for k, v in state.aux.items()},
    }
