"""Helpers shared by the tests of the port's field models
(``tests/test_torch_electrostatic.py``, ``test_torch_hybrid.py``,
``test_torch_macroscopic.py``, ``test_torch_nci.py``): one configuration
run through both packages from the same seed, and their states compared."""

import numpy as np
import torch

import warpx_tpu_torch
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu_torch.core.state import state_to_numpy

from .test_torch_bounded_util import port_config

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-9
_PARTICLE = ("w", "ux", "uy", "uz", "x", "y", "z")


def rel_err(got, ref, scale=None):
    """max |got - ref| over ``scale`` (by default max |ref|; 0 when both
    vanish); complex arrays compare as complex."""
    got, ref = np.asarray(got), np.asarray(ref)
    kind = (np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref)
            else np.float64)
    got, ref = got.astype(kind), ref.astype(kind)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if scale is None:
        scale = np.abs(ref).max() if ref.size else 0.0
    err = np.abs(got - ref).max() if ref.size else 0.0
    return 0.0 if err == 0.0 else err / max(scale, 1e-300)


def run_both(jcfg, steps, **port_kw):
    """(JAX simulation, port simulation) of ``jcfg`` after ``steps`` steps
    of ``evolve`` each, the port in float64 on the CPU."""
    jsim = JSimulation(jcfg)
    jsim.init()
    jsim.evolve(steps)
    sim = warpx_tpu_torch.Simulation(port_config(jcfg, **port_kw),
                                     dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve(steps)
    return jsim, sim


def assert_runs_agree(jsim, sim, fields=(), rtol=RTOL):
    """E, B, J and every field of ``fields`` (names of FieldState), each
    within ``rtol`` of the largest value of its group (E, B, J, or itself:
    a component that the physics leaves at roundoff compares at the
    group's scale), every particle array slot by slot and every checksum
    within ``rtol``."""
    got = state_to_numpy(sim.state)
    groups = [("Ex", "Ey", "Ez"), ("Bx", "By", "Bz"), ("jx", "jy", "jz")]
    groups += [(nm,) for nm in fields]
    for group in groups:
        refs = [np.asarray(getattr(jsim.state.fields, nm)) for nm in group]
        scale = max(np.abs(r).max() for r in refs)
        for nm, ref in zip(group, refs):
            assert got["fields"][nm] is not None, nm
            assert rel_err(got["fields"][nm], ref, scale) <= rtol, nm
    for name, sp in jsim.state.species.items():
        np.testing.assert_array_equal(got["species"][name]["alive"],
                                      np.asarray(sp.alive))
        u_scale = max(np.abs(np.asarray(getattr(sp, k))).max()
                      for k in ("ux", "uy", "uz"))
        for k in _PARTICLE:
            a = getattr(sp, k)
            if a is None:
                continue
            scale = u_scale if k[0] == "u" else None
            assert rel_err(got["species"][name][k], a, scale) <= rtol, (
                name, k)
    assert_checksums_grouped(jsim.checksums(), sim.checksums(), rtol)


def _checksum_group(key):
    """E*, B*, j*, particle_momentum_* and particle_position_* each share a
    scale; any other quantity is its own."""
    for prefix in ("particle_momentum_", "particle_position_"):
        if key.startswith(prefix):
            return prefix
    if len(key) == 2 and key[0] in "EBj":
        return key[0]
    return key


def assert_checksums_grouped(ref, got, rtol=RTOL):
    """``assert_checksums`` with each quantity held within ``rtol`` of the
    largest of its group: a component at roundoff (an E_y the physics
    leaves at zero) compares at the scale of the others."""
    assert set(ref) == set(got)
    for group in ref:
        assert set(ref[group]) == set(got[group]), group
        scales = {}
        for q, v in ref[group].items():
            g = _checksum_group(q)
            scales[g] = max(scales.get(g, 0.0), abs(v))
        for q in ref[group]:
            if q in ("divB", "divE"):
                continue  # roundoff noise whose value depends on sum order
            a, b = ref[group][q], got[group][q]
            scale = scales[_checksum_group(q)]
            assert abs(a - b) <= rtol * scale + 1e-300, (group, q, a, b)
