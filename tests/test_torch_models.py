"""The port's ready-made configurations (``warpx_tpu_torch.models``)
against the JAX package's (``warpx_tpu.models``): each function's
configuration equals
JAX's carried over by ``port_config``, and two steps of each at a small
size agree in float64 on the CPU at 1e-9 (both per particle, JAX's
"auto" on the CPU)."""

import dataclasses

import pytest

import warpx_tpu_torch
from warpx_tpu import models as jmodels
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu_torch import models as tmodels

from .test_torch_bounded_util import port_config
from .test_torch_frontend_util import (CPU64, clean_frontends,  # noqa: F401
                                       states, states_close, sums_close)

pytestmark = pytest.mark.usefixtures("clean_frontends")

MODELS = {
    "uniform_plasma": ("uniform_plasma", dict(n=8, ndim=2, max_step=2)),
    "uniform_plasma_3d": ("uniform_plasma", dict(n=8, ndim=3, max_step=2)),
    "langmuir_wave": ("langmuir_wave", dict(n=8, ndim=2, max_step=2)),
    "langmuir_wave_1d": ("langmuir_wave", dict(n=16, ndim=1, max_step=2)),
    "lwfa_3d": ("lwfa_3d", dict(n_trans=8, n_long=16, max_step=2)),
}


def test_the_models_are_jax_s():
    assert tmodels.__all__ == jmodels.__all__


@pytest.mark.parametrize("case", list(MODELS))
def test_model_config_and_two_steps_match_jax(case):
    name, kw = MODELS[case]
    jcfg = getattr(jmodels, name)(**kw)
    tcfg = getattr(tmodels, name)(**kw)
    assert tcfg == port_config(jcfg)
    # the defaults too (no state: the configuration alone)
    assert getattr(tmodels, name)() == port_config(getattr(jmodels, name)())
    jsim = JSimulation(jcfg)
    jsim.init()
    jsim.evolve()
    tsim = warpx_tpu_torch.Simulation(
        dataclasses.replace(tcfg, tiled_particles="off"), **CPU64)
    tsim.init()
    tsim.evolve()
    assert tsim.state.step == 2
    states_close(*states(jsim, tsim))
    sums_close(jsim.checksums(), tsim.checksums())
