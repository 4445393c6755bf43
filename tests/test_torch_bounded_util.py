"""Helpers shared by the bounded-step tests of the port
(``tests/test_torch_bounded*.py``): deck texts, the conversion of a
``warpx_tpu`` configuration and state into the port's, and comparisons."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck
from warpx_tpu_torch.core import config as tconfig
from warpx_tpu_torch.core.grid import Geometry

from .test_binned_bounded import _LWFA_2D, _PEC_3D

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

LWFA_2D = _LWFA_2D
PEC_3D = _PEC_3D
# three particles per cell: 12288 per species, above the 8192 below which a
# static species keeps its compact layout and never reaches the fused kernel
PEC_3D_BINNED = _PEC_3D.replace(
    "num_particles_per_cell_each_dim = 1 1 1",
    "num_particles_per_cell_each_dim = 1 1 3")

FIELDS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
RTOL = 1e-9

# fields of the JAX configuration that the port lacks and that no ported
# branch reads: the refinement ratio (read with max_level > 0 only),
# verbosity, and the deck's constants at the top level (the port's parsed
# profiles read each species' copy)
_UNREAD = {"ref_ratio", "verbose", "user_constants"}


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


def port_config(obj, cls=tconfig.SimConfig, **replace):
    """The port's configuration from the JAX package's: every field the
    port has is carried over; a field it lacks must hold its default."""
    have = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name not in have:
            assert f.name in _UNREAD or v == _default(f), (
                f"{cls.__name__}.{f.name} = {v!r} has no field in the port")
            continue
        if f.name == "geometry":
            v = Geometry(**dataclasses.asdict(v))
        elif f.name in ("species", "fluids"):
            v = tuple(port_config(s, tconfig.SpeciesConfig) for s in v)
        elif f.name == "lasers":
            v = tuple(port_config(s, tconfig.LaserConfig) for s in v)
        kw[f.name] = v
    kw.update(replace)
    return cls(**kw)


def jax_config(deck_text, tiled):
    return config_from_deck(Deck.from_string(
        deck_text + f"\ntpu.tiled_particles = {tiled}\n"))


def jax_state_numpy(state):
    f = state.fields
    return {
        "fields": {nm: np.asarray(getattr(f, nm)) for nm in FIELDS},
        "species": {
            nm: {k: None if getattr(sp, k) is None
                 else np.asarray(getattr(sp, k))
                 for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z")}
            for nm, sp in state.species.items()
        },
        "step": int(state.step),
        "time": float(state.time),
        "aux": {k: np.asarray(v) for k, v in state.aux.items()},
    }


def jax_state_replace(state, data):
    """``state`` (JAX) with the fields, species arrays and aux of the numpy
    dict ``data``."""
    fields = state.fields.replace(
        **{nm: jnp.asarray(a) for nm, a in data["fields"].items()})
    species = {
        nm: state.species[nm].replace(
            **{k: jnp.asarray(a) for k, a in sp.items() if a is not None})
        for nm, sp in data["species"].items()
    }
    aux = {k: jnp.asarray(a, dtype=state.aux[k].dtype)
           for k, a in data["aux"].items()}
    return state.replace(fields=fields, species=species, aux=aux)


def randomize_fields(data, seed):
    """Random E, B, J and PML split fields in the numpy state ``data``."""
    rng = np.random.default_rng(seed)
    out = dict(data)
    out["fields"] = {
        nm: rng.normal(size=a.shape) * (30.0 if nm[0] == "B" else 1e10)
        for nm, a in data["fields"].items()}
    out["aux"] = {
        k: (rng.normal(size=a.shape) * (30.0 if k[4] == "B" else 1e10)
            if k.startswith("pml:") else a)
        for k, a in data["aux"].items()}
    return out


def run_jax(deck_text, tiled="on", keep_at=None):
    """Run the deck through the JAX package; returns (sim, numpy state at
    step ``keep_at`` or None)."""
    sim = JSimulation(jax_config(deck_text, tiled))
    sim.init()
    kept = None
    if keep_at is not None:
        sim.evolve(keep_at)
        kept = jax_state_numpy(sim.state)
    sim.evolve()
    return sim, kept


def run_port(cfg):
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    return sim


def assert_checksums(ref, got, rtol=RTOL):
    assert set(ref) == set(got)
    for group in ref:
        assert set(ref[group]) == set(got[group])
        for q in ref[group]:
            if q in ("divB", "divE"):
                continue  # roundoff noise whose value depends on sum order
            a, b = ref[group][q], got[group][q]
            assert abs(a - b) <= rtol * abs(a) + 1e-300, (group, q, a, b)


def assert_close(got, ref, what, tol=1e-12):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max() if ref.size else 0.0
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * scale + 1e-300, (what, err, scale)


def assert_states_close(got, ref, tol=1e-12):
    """Two numpy states slot by slot: fields, PML splits, window scalars,
    particles."""
    assert got["step"] == ref["step"]
    for nm in FIELDS:
        assert_close(got["fields"][nm], ref["fields"][nm], nm, tol)
    assert set(got["aux"]) == set(ref["aux"])
    for k, a in ref["aux"].items():
        assert_close(got["aux"][k], a, k, tol)
    for name, sp in ref["species"].items():
        np.testing.assert_array_equal(got["species"][name]["alive"],
                                      sp["alive"])
        for k, a in sp.items():
            if a is None:
                assert got["species"][name][k] is None
            elif k != "alive":
                assert_close(got["species"][name][k], a, (name, k), tol)
