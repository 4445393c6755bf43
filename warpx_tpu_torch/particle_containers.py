"""pywarpx-compatible particle data views
(reference: Python/pywarpx/particle_containers.py).

The counterpart of ``warpx_tpu.particle_containers``.
``ParticleContainerWrapper`` reads the live simulation's per-species arrays
(the alive slots only), writes new particles with ``add_particles``, and
``ParticleBoundaryBufferWrapper`` reads the boundary-scraping buffers.  The
reference returns zero-copy views per tile; the state here is a
fixed-capacity masked SoA, so the getters return compacted copies on the
host and ``add_particles`` fills the first free slots in flat order,
whichever tile of a binned layout holds them, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import check_local
from .runtime import get_simulation

__all__ = ["ParticleContainerWrapper", "ParticleBoundaryBufferWrapper"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class ParticleContainerWrapper:
    def __init__(self, species_name, sim=None):
        self.name = species_name
        self._sim = sim

    @property
    def sim(self):
        sim = self._sim or get_simulation()
        check_local(sim)
        return sim

    def _sp(self):
        return self.sim.state.species[self.name]

    def _get(self, arr):
        sp = self._sp()
        # compacted on the device: only the alive slots cross to the host
        return _host(arr[sp.alive])

    # ---- getters (reference: get_particle_x etc., compacted copies)
    def get_particle_count(self, local=False):
        return int(self._sp().alive.sum())

    nps = property(get_particle_count)

    def get_particle_x(self, level=0, copy_to_host=True):
        return [self._get(self._sp().x)]

    def get_particle_y(self, level=0, copy_to_host=True):
        sp = self._sp()
        if sp.y is None:
            return [np.zeros(self.get_particle_count())]
        return [self._get(sp.y)]

    def get_particle_z(self, level=0, copy_to_host=True):
        return [self._get(self._sp().z)]

    def get_particle_weight(self, level=0, copy_to_host=True):
        return [self._get(self._sp().w)]

    def get_particle_ux(self, level=0, copy_to_host=True):
        return [self._get(self._sp().ux)]

    def get_particle_uy(self, level=0, copy_to_host=True):
        return [self._get(self._sp().uy)]

    def get_particle_uz(self, level=0, copy_to_host=True):
        return [self._get(self._sp().uz)]

    def get_particle_real_arrays(self, comp_name, level=0, copy_to_host=True):
        sp = self._sp()
        std = {"w": sp.w, "ux": sp.ux, "uy": sp.uy, "uz": sp.uz,
               "x": sp.x, "y": sp.y, "z": sp.z}
        if comp_name in std and std[comp_name] is not None:
            return [self._get(std[comp_name])]
        if comp_name in sp.extra:
            return [self._get(sp.extra[comp_name])]
        raise KeyError(comp_name)

    # the aliases pywarpx user scripts use
    xp = property(lambda self: self.get_particle_x()[0])
    yp = property(lambda self: self.get_particle_y()[0])
    zp = property(lambda self: self.get_particle_z()[0])
    wp = property(lambda self: self.get_particle_weight()[0])
    uxp = property(lambda self: self.get_particle_ux()[0])
    uyp = property(lambda self: self.get_particle_uy()[0])
    uzp = property(lambda self: self.get_particle_uz()[0])

    def get_species_charge_sum(self, local=False):
        by_name = {s.name: s for s in self.sim.cfg.species}
        q = by_name[self.name].charge
        return float(q * self.wp.sum())

    def add_particles(self, x=None, y=None, z=None, ux=None, uy=None,
                      uz=None, w=None, unique_particles=True, **kwargs):
        """Put particles into the first free slots (reference:
        add_particles); too few free slots raise instead of growing the
        tile.  A runtime attribute named in ``kwargs`` takes its value
        there, one the species lacks is ignored, as in the JAX package."""
        arrs = {k: np.atleast_1d(np.asarray(v, float)) for k, v in
                (("x", x), ("y", y), ("z", z), ("ux", ux), ("uy", uy),
                 ("uz", uz), ("w", w)) if v is not None}
        n = max(a.size for a in arrs.values())
        sim = self.sim
        sp = self._sp()
        free = np.nonzero(~_host(sp.alive))[0]
        if free.size < n:
            raise RuntimeError(
                f"species '{self.name}' has {free.size} free slots, "
                f"need {n} (increase the capacity factor)"
            )
        tgt = free[:n]

        def put(cur, vals):
            new = _host(cur).copy()
            new[tgt] = vals
            return torch.from_numpy(new).to(cur.device)

        upd = {}
        for k in ("x", "y", "z", "ux", "uy", "uz", "w"):
            cur = getattr(sp, k)
            if cur is None:
                continue
            vals = arrs.get(k)
            if vals is None:
                vals = np.zeros(n)
            elif vals.size == 1:
                vals = np.full(n, float(vals[0]))
            upd[k] = put(cur, vals)
        upd["alive"] = put(sp.alive, True)
        extra = dict(sp.extra)
        for k, v in kwargs.items():
            if k in extra:
                extra[k] = put(extra[k], np.broadcast_to(
                    np.asarray(v, float), (n,)))
        sim.state = sim.state.replace(species={
            **sim.state.species, self.name: sp.replace(extra=extra, **upd)})


class ParticleBoundaryBufferWrapper:
    """Reader of the boundary-scraping buffers
    (reference: particle_containers.ParticleBoundaryBufferWrapper); they
    live in ``state.aux`` as ``scrape:<species>:<face>:<field>``, with the
    fill count under ``:n``."""

    @property
    def sim(self):
        sim = get_simulation()
        check_local(sim)
        return sim

    def get_particle_boundary_buffer_size(self, species_name, boundary,
                                          local=False):
        return int(self.sim.state.aux[f"scrape:{species_name}:{boundary}:n"])

    def get_particle_boundary_buffer(self, species_name, boundary,
                                     comp_name, level=0):
        n = self.get_particle_boundary_buffer_size(species_name, boundary)
        key = f"scrape:{species_name}:{boundary}:{comp_name}"
        return [_host(self.sim.state.aux[key])[:n]]

    def clear_buffer(self):
        sim = self.sim
        aux = dict(sim.state.aux)
        for k in aux:
            if k.startswith("scrape:") and k.endswith(":n"):
                aux[k] = torch.zeros_like(aux[k])
        sim.state = sim.state.replace(aux=aux)
