"""What each rank runs in a local group started by ``launch.run_ranks``:
the distributed pieces driven on inputs handed in as numpy arrays and deck
texts, with the results handed back as numpy arrays.

``run_jobs(rank, world, jobs)`` runs a list of ``(name, kwargs)`` jobs in
order, each over the first ``kwargs["world"]`` ranks (a subgroup; the
other ranks sit it out and return None), so that one start of the ranks
serves a whole list of cases.  The jobs:

* ``halo``: ``exchange_halos`` of each rank's block and
  ``accumulate_guards`` of each rank's padded block;
* ``particles``: ``exchange_particles`` of each rank's columns;
* ``dist``: a ``DistSimulation`` of a deck over a mesh; the gathered
  state, the checksums, each load balance's figures;
* ``pdist``: a ``ParticleDistSimulation`` of a deck; its gathered state,
  checksums and live count;
* ``barrier``: a barrier that only some ranks enter (a hang).

A simulation job's state comes back from rank 0 only.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..core.deck import config_from_deck
from ..core.state import state_to_numpy
from ..utils.parser import Deck
from .halo import accumulate_guards, exchange_halos
from .particles import exchange_particles
from .topology import SpatialMesh

__all__ = ["run_jobs"]

def _halo(smesh, blocks, padded, ng, mesh_axes):
    r = smesh.rank
    ex = exchange_halos(torch.from_numpy(blocks[r]), ng, mesh_axes, smesh)
    acc = accumulate_guards(torch.from_numpy(padded[r]), ng, mesh_axes,
                            smesh)
    return {"exchanged": ex.numpy(), "accumulated": acc.numpy()}


def _particles(smesh, ndim, columns, lo, hi, K, dim_axes):
    from ..core.state import ParticleState

    r = smesh.rank
    cols = {k: torch.from_numpy(v) for k, v in columns[r].items()}
    sp, lost = exchange_particles(ParticleState(**cols), ndim, dim_axes,
                                  lo[r], hi[r], K, smesh)
    out = {k: getattr(sp, k).numpy() for k in columns[r]}
    return {"columns": out, "lost": int(lost)}


def _config(deck_text):
    return config_from_deck(Deck.from_string(deck_text))


def _dist(smesh, deck, steps=-1, half_push=None):
    """A float64 ``DistSimulation`` of ``deck`` on the CPU evolved
    ``steps`` (with ``half_push``: that one push of dt * half_push after
    init first); every load balance recorded: the costs before, the
    decision, the assignment, the costs after.  An exchange overflow's
    error is reported, not raised."""
    from ..core.simulation import DistSimulation

    sim = DistSimulation(_config(deck), dict(smesh.axis_shards),
                         dtype=torch.float64, device="cpu",
                         group=smesh.group)
    sim.init()
    out = {"balances": []}
    balance = sim.load_balance

    def recorded():
        _, tile_costs, chip_costs, _ = sim.measure_costs()
        adopted = balance()
        out["balances"].append(dict(
            step=sim.state.step, tile_costs=tile_costs,
            chip_costs=chip_costs, adopted=adopted,
            assignment=sim.last_assignment,
            lb_efficiency=float(sim.state.aux["lb_efficiency"]),
            costs_after=sim.measure_costs()[1:3]))
        return adopted

    sim.load_balance = recorded
    if half_push is not None:
        sim.state = sim._half_push(half_push * sim.cfg.dt)
    try:
        sim.evolve(steps)
    except RuntimeError as e:  # the exchange buffers overflowed
        out["error"] = str(e)
    out["balanced"] = sim._balanced
    out["lost"] = int(sim.state.aux["lost"])
    out["lb_efficiency"] = float(sim.state.aux["lb_efficiency"])
    out["checksums"] = sim.checksums()
    state = sim.gather_state()
    if smesh.rank == 0:
        out["state"] = state_to_numpy(state)
    return out


def _pdist(smesh, deck, steps=-1):
    """A float64 ``ParticleDistSimulation`` of ``deck`` on the CPU."""
    from ..core.particle_dist import ParticleDistSimulation

    sim = ParticleDistSimulation(_config(deck), dtype=torch.float64,
                                 device="cpu", group=smesh.group)
    sim.init()
    sim.evolve(steps)
    out = {"checksums": sim.checksums(), "alive": sim.alive_count(),
           "local_capacity": {nm: sp.capacity
                              for nm, sp in sim.state.species.items()}}
    state = sim.gather_state()
    if smesh.rank == 0:
        out["state"] = state_to_numpy(state)
    return out


def _barrier(smesh, ranks, hold=0.0):
    """A barrier that only ``ranks`` enter while the others stay away for
    ``hold`` seconds: a collective that hangs, as one does when a rank
    falls out of step."""
    if smesh.rank in ranks:
        dist.barrier(group=smesh.group)
    else:
        time.sleep(hold)
    return smesh.rank


_JOBS = {"halo": _halo, "particles": _particles, "dist": _dist,
         "pdist": _pdist, "barrier": _barrier}


def run_jobs(rank: int, world: int, jobs):
    """Each ``(name, kwargs)`` job over the first ``kwargs["world"]``
    ranks, on the mesh ``kwargs["mesh"]`` (default: one axis "p" over
    them); the results
    in order (None where this rank sat the job out)."""
    groups = {world: None}
    results = []
    for name, kw in jobs:
        kw = dict(kw)
        w = kw.pop("world")
        if w not in groups:
            # every rank of the world takes part in making a group
            groups[w] = dist.new_group(list(range(w)))
        if rank >= w:
            results.append(None)
            continue
        smesh = SpatialMesh.create(kw.pop("mesh", None) or {"p": w},
                                   groups[w])
        results.append(_JOBS[name](smesh, **kw))
    return results
