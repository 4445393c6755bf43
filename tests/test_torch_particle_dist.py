"""The port's particle decomposition (``ParticleDistSimulation``, the bounded
step's hooks) against the JAX package's.

``test_binned_bounded._LWFA_2D`` (PML, moving window, antenna, continuous
injection, a beam, filter; 12 steps) and ``_PEC_3D`` (PEC z walls,
reflecting particles; 8 steps), per particle in float64, through
``warpx_tpu.ParticleDistSimulation(n_devices=n)`` in-process and the
port's over gloo ranks (``launch.run_ranks``, started once for the
module): the dealt slots at init bitwise; after the run the gathered state
slot by slot within 1e-9 (fields against the largest component of their
kind), the window's scalars and the checksums within 1e-9 of JAX's at 4
devices, and at 2 ranks the checksums within 1e-9 of JAX's at 4 (JAX
compiles each count anew); the checksums within 1e-9 and the live count
exactly the port's single-device run's.  Then JAX's gates word for word, the refusal
of a periodic deck, and the card default.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.particle_dist import \
    ParticleDistSimulation as JParticleDistSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.particle_dist import ParticleDistSimulation
from warpx_tpu_torch.parallel.launch import init_single_rank, run_ranks
from warpx_tpu_torch.parallel.programs import run_jobs
from warpx_tpu_torch.utils.parser import Deck

from .test_binned_bounded import _LWFA_2D, _PEC_3D
from .test_torch_bounded_util import assert_checksums, port_config
from .test_torch_sharded import FIELDS, assert_fields_close

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

LWFA = _LWFA_2D + "\ntpu.tiled_particles = off\n"
PEC = _PEC_3D + "\ntpu.tiled_particles = off\n"
# (id, deck, ranks, JAX's count to hold the run against)
CASES = [("lwfa-2", LWFA, 2, 4), ("lwfa-4", LWFA, 4, 4),
         ("pec-4", PEC, 4, 4), ("pec-2", PEC, 2, 4)]
WINDOW = ("window_x", "window_lo", "window_hi", "window_offset",
          "inject_pos:electrons")


@pytest.fixture(scope="module")
def port_runs():
    jobs = [("pdist", dict(world=n, deck=d)) for _, d, n, _ in CASES]
    jobs.append(("pdist", dict(world=4, deck=LWFA, steps=0)))
    res = run_ranks(4, run_jobs, (jobs,), timeout=300)
    names = [c[0] for c in CASES] + ["lwfa-4-init"]
    return dict(zip(names, res[0])), dict(zip(names, res[1]))


def _host_state(state):
    return {
        "fields": {nm: np.asarray(getattr(state.fields, nm))
                   for nm in FIELDS},
        "species": {nm: {k: None if getattr(sp, k) is None
                         else np.asarray(getattr(sp, k))
                         for k in ("w", "ux", "uy", "uz", "alive", "x", "y",
                                   "z")}
                    for nm, sp in state.species.items()},
        "aux": {k: np.asarray(v) for k, v in state.aux.items()},
    }


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's run of each deck at each count (its state after init too)."""
    out = {}
    for key in {(d, j) for _, d, _, j in CASES}:
        deck, n = key
        sim = JParticleDistSimulation(
            jax_config_from_deck(JDeck.from_string(deck)), n_devices=n)
        sim.init()
        init = _host_state(sim.state)
        sim.evolve()
        out[key] = dict(init=init, final=_host_state(sim.state),
                        sums=sim.checksums())
    return out


def _single(deck):
    sim = warpx_tpu_torch.Simulation(config_from_deck(Deck.from_string(deck)),
                                     dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    return sim


def assert_species_match(got, ref, exact=False):
    for name, sp in ref.items():
        g = got[name]
        np.testing.assert_array_equal(g["alive"], sp["alive"], err_msg=name)
        for k, a in sp.items():
            if a is None:
                assert g[k] is None
                continue
            if exact or k == "alive":
                assert np.array_equal(g[k], a), (name, k)
                continue
            live = sp["alive"]
            scale = max(np.abs(a[live]).max(), 1e-300) if live.any() else 1
            err = np.abs(g[k][live] - a[live]).max() if live.any() else 0
            assert err <= 1e-9 * scale, (name, k, err, scale)


def test_deal_is_jax_round_robin(port_runs, jax_runs):
    """The slots after init: JAX's dealt layout bitwise, ceil(cap / n) a
    rank."""
    got = port_runs[0]["lwfa-4-init"]
    ref = jax_runs[(LWFA, 4)]["init"]
    assert_species_match(got["state"]["species"], ref["species"], exact=True)
    for nm, sp in ref["species"].items():
        assert got["local_capacity"][nm] * 4 == sp["w"].shape[0]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pdist_matches_jax_and_single(port_runs, jax_runs, case):
    name, deck, n, nj = case
    got = port_runs[0][name]
    ref = jax_runs[(deck, nj)]
    assert_checksums(ref["sums"], got["checksums"])
    if n == nj:
        st = got["state"]
        assert_fields_close(st["fields"], ref["final"]["fields"])
        assert_species_match(st["species"], ref["final"]["species"])
        for k in WINDOW:
            if k in ref["final"]["aux"]:
                assert float(st["aux"][k]) == pytest.approx(
                    float(ref["final"]["aux"][k]), rel=1e-13), k
    single = _single(deck)
    assert_checksums(single.checksums(), got["checksums"])
    assert got["alive"] == sum(int(sp.alive.sum())
                               for sp in single.state.species.values())
    # every rank computed the same checksums by collectives
    assert port_runs[1][name]["checksums"] == got["checksums"]
    if deck is LWFA:
        assert float(got["state"]["aux"]["window_lo"]) > -28.0e-6


# ---- refusals and the device --------------------------------------------

GATED = [
    lambda c: dict(geometry=dataclasses.replace(c.geometry, rz=True)),
    lambda c: dict(max_level=1),
    lambda c: dict(evolve_scheme="theta_implicit_em"),
    lambda c: dict(do_qed_schwinger=True),
    lambda c: dict(species=(dataclasses.replace(
        c.species[0], do_field_ionization=True, physical_element="H"),)
        + c.species[1:]),
    lambda c: dict(species=(dataclasses.replace(
        c.species[0], do_qed_breit_wheeler=True),) + c.species[1:]),
    lambda c: dict(species=(dataclasses.replace(
        c.species[0], do_resampling=True),) + c.species[1:]),
    lambda c: dict(species=(dataclasses.replace(
        c.species[0], save_particles_at=("zlo",)),) + c.species[1:]),
    lambda c: dict(species=(dataclasses.replace(
        c.species[0], injection_style="nfluxpercell"),) + c.species[1:]),
]


@pytest.mark.parametrize("i", range(len(GATED)))
def test_gates_match_jax(i):
    jcfg = jax_config_from_deck(JDeck.from_string(_LWFA_2D))
    with pytest.raises(NotImplementedError) as je:
        JParticleDistSimulation._check_supported(
            dataclasses.replace(jcfg, **GATED[i](jcfg)))
    tcfg = port_config(jcfg)
    with pytest.raises(NotImplementedError) as te:
        ParticleDistSimulation._check_supported(
            dataclasses.replace(tcfg, **GATED[i](tcfg)))
    assert str(te.value) == str(je.value)
    ParticleDistSimulation._check_supported(tcfg)


def test_periodic_deck_and_card_default():
    """A periodic deck belongs to DistSimulation; ``device=None`` asks for
    CUDA and raises without a card."""
    cfg = config_from_deck(Deck.from_string(PEC))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParticleDistSimulation(cfg)
    periodic = dataclasses.replace(
        cfg, field_bc_lo=("periodic",) * 3, field_bc_hi=("periodic",) * 3,
        particle_bc_lo=("periodic",) * 3, particle_bc_hi=("periodic",) * 3,
        geometry=dataclasses.replace(cfg.geometry, periodic=(True,) * 3))
    init_single_rank("gloo")
    try:
        with pytest.raises(NotImplementedError, match="DistSimulation"):
            ParticleDistSimulation(periodic, device="cpu")
    finally:
        dist.destroy_process_group()
