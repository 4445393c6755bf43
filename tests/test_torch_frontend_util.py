"""Helpers shared by the tests of the port's front ends
(``tests/test_torch_{picmi,pywarpx,data_views,callbacks,models}.py``): the
module globals both packages keep (the active simulation, the callback
registry, the PICMI diagnostic counter, the pywarpx buckets), states of
both packages as numpy, and comparisons scaled by a field or particle
family's largest value."""

import importlib

import numpy as np
import pytest
import torch

import warpx_tpu.pywarpx
import warpx_tpu.runtime
import warpx_tpu.utils.callbacks
import warpx_tpu_torch.pywarpx
import warpx_tpu_torch.runtime
import warpx_tpu_torch.utils.callbacks
from warpx_tpu import picmi as jpicmi
from warpx_tpu_torch import picmi as tpicmi
from warpx_tpu_torch.core.state import state_to_numpy

from .test_torch_bounded_util import jax_state_numpy

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-9
C = 299792458.0
# the scale of momenta at roundoff (a plasma at rest that no field has
# reached): 1e-6 c
U_FLOOR = 1e-6 * C
# the port's keyword-only arguments that run a PICMI scene on the CPU in
# float64, as the JAX package runs it here
CPU64 = dict(device="cpu", dtype=torch.float64)


def reset_frontends():
    """Both packages' module globals back to a fresh interpreter's: no
    active simulation, no callback, the PICMI diagnostics' counter at 0,
    fresh pywarpx buckets."""
    for rt in (warpx_tpu.runtime, warpx_tpu_torch.runtime):
        rt._active = None
    for cb in (warpx_tpu.utils.callbacks, warpx_tpu_torch.utils.callbacks):
        cb.clear_callbacks()
    for pm in (jpicmi, tpicmi):
        pm._Diag.counter[0] = 0
    for pw in (warpx_tpu.pywarpx, warpx_tpu_torch.pywarpx):
        importlib.reload(pw)


@pytest.fixture
def clean_frontends():
    """Each test starts from, and leaves, fresh front-end globals, so that
    no test of the same worker sees another's registry."""
    reset_frontends()
    yield
    reset_frontends()


def states(jsim, tsim):
    """(JAX, port) states as nested numpy dicts, taken before anything
    (``checksums``) wraps the positions."""
    return jax_state_numpy(jsim.state), state_to_numpy(tsim.state)


def _family(name: str) -> str:
    if name.startswith("particle_"):
        return name.rstrip("xyz")
    return name[0].upper() if name[0] in "EBj" else name


def sums_close(ref, got, rtol=RTOL):
    """Checksums within ``rtol`` of the largest of their family in the
    group (Ex/Ey/Ez, Bx.., jx.., particle_momentum_x/y/z, ...): a component
    at roundoff (Ey of a wave polarized along x) is held to its family's
    scale, and B at least to E's over c."""
    assert set(ref) == set(got)
    for group in ref:
        assert set(ref[group]) == set(got[group]), group
        scale = {}
        for q, a in ref[group].items():
            f = _family(q)
            scale[f] = max(scale.get(f, 0.0), abs(a))
        if "B" in scale:
            scale["B"] = max(scale["B"], scale.get("E", 0.0) / C)
        for q, a in ref[group].items():
            if q in ("divB", "divE"):
                continue  # roundoff noise whose value depends on sum order
            b = got[group][q]
            assert abs(a - b) <= rtol * scale[_family(q)] + 1e-300, (
                group, q, a, b)


def _close(got, ref, what, rtol):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not ref.size:
        return
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale + 1e-300, (what, err, scale)


FIELDS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")


def fields_close(ref, got, rtol=RTOL):
    """The fields of two numpy states, each component against its family's
    largest value (B at least against E's over c)."""
    scale = {fam: max(np.abs(ref["fields"][nm]).max() for nm in FIELDS
                      if nm[0] == fam) for fam in "EBj"}
    scale["B"] = max(scale["B"], scale["E"] / C)
    for nm in FIELDS:
        a = np.asarray(ref["fields"][nm], np.float64)
        b = np.asarray(got["fields"][nm], np.float64)
        assert a.shape == b.shape, (nm, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= rtol * scale[nm[0]] + 1e-300, (nm, err, scale)


def particles_close(ref, got, rtol=RTOL):
    """The alive particles of two numpy states of different layouts (a
    tile-binned run against a per-particle one), as multisets: the alive
    counts exactly, each component's sorted values within ``rtol`` of its
    scale (sorting moves no value further than the largest difference of
    any pairing)."""
    for name, sp in ref["species"].items():
        gsp = got["species"][name]
        a_alive, g_alive = sp["alive"], gsp["alive"]
        assert int(a_alive.sum()) == int(g_alive.sum()), name
        vals = {k: (np.sort(np.asarray(sp[k])[a_alive]),
                    np.sort(np.asarray(gsp[k])[g_alive]))
                for k in ("x", "y", "z", "ux", "uy", "uz", "w")
                if sp[k] is not None}
        u = max([U_FLOOR] + [np.abs(vals[k][0]).max()
                             for k in ("ux", "uy", "uz") if vals[k][0].size])
        for k, (a, b) in vals.items():
            scale = u if k.startswith("u") else (np.abs(a).max()
                                                 if a.size else 0.0)
            assert np.abs(a - b).max(initial=0.0) <= rtol * scale, (name, k)


def states_close(ref, got, rtol=RTOL, aux=True):
    """Two numpy states slot by slot: the fields (``fields_close``), the
    aux tensors, the alive masks exactly and the alive slots'
    particles."""
    assert got["step"] == ref["step"]
    fields_close(ref, got, rtol)
    if aux:
        for k, a in ref["aux"].items():
            _close(got["aux"][k], a, k, rtol)
    for name, sp in ref["species"].items():
        gsp = got["species"][name]
        alive = sp["alive"]
        np.testing.assert_array_equal(gsp["alive"], alive)
        # the momenta as one family, held at least to U_FLOOR
        u_scale = max([U_FLOOR] + [np.abs(sp[k][alive]).max()
                                   for k in ("ux", "uy", "uz") if alive.any()])
        for k, a in sp.items():
            if k == "alive":
                continue
            if a is None:
                assert gsp[k] is None, (name, k)
                continue
            # a dead slot's values carry nothing (the tile-binned kernels
            # push and copy them as they please)
            a = np.asarray(a, np.float64)[alive]
            b = np.asarray(gsp[k], np.float64)[alive]
            scale = u_scale if k in ("ux", "uy", "uz") else (
                np.abs(a).max() if a.size else 0.0)
            err = np.abs(a - b).max() if a.size else 0.0
            assert err <= rtol * scale + 1e-300, ((name, k), err, scale)
