"""The port's user callbacks (``warpx_tpu_torch.utils.callbacks``) against
the JAX package's (``tests/test_utils.py::test_callbacks_registry``),
float64 on the CPU.

The registry keeps the pywarpx calls (install, uninstall, isinstalled, the
``callfrom*`` decorators); ``Simulation.evolve`` fires every hook at JAX's
site and in JAX's order, also when a break or a checkpoint is asked for,
and what a callback changes through the data views the step sees."""

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import fields as jfields
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils import callbacks as jcb
from warpx_tpu.utils.observability import SignalFlags as JSignalFlags
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch import fields as tfields
from warpx_tpu_torch.utils import callbacks as tcb
from warpx_tpu_torch.utils.observability import SignalFlags as TSignalFlags
from warpx_tpu_torch.utils.parser import Deck as TDeck

from .test_torch_electrostatic import ES_DECK
from .test_torch_frontend_util import (CPU64, clean_frontends,  # noqa: F401
                                       states, states_close)

pytestmark = pytest.mark.usefixtures("clean_frontends")


def test_callbacks_registry():
    """tests/test_utils.py's registry case on the port: a lambda and a
    decorated function fire in evolve, in the JAX package's order."""
    from warpx_tpu_torch.models import uniform_plasma
    from warpx_tpu_torch.utils.callbacks import (callfromafterstep,
                                                 clear_callbacks,
                                                 installcallback,
                                                 isinstalled,
                                                 uninstallcallback)

    calls = []
    installcallback("beforestep", lambda: calls.append("b"))

    @callfromafterstep
    def after():
        calls.append("a")

    assert isinstalled("afterstep", after)
    assert isinstalled("afterstep") and not isinstalled("afterEsolve")
    sim = warpx_tpu_torch.Simulation(
        uniform_plasma(n=8, ndim=2, max_step=2), **CPU64)
    sim.init()
    sim.evolve()
    assert calls == ["b", "a", "b", "a"]
    uninstallcallback("afterstep", after)
    assert not isinstalled("afterstep", after)
    uninstallcallback("beforestep")
    assert not isinstalled("beforestep")
    clear_callbacks()
    assert not tcb._registry


def test_registry_refusals_and_names_match_jax():
    assert tcb.HOOKS == jcb.HOOKS
    assert tcb.__all__ == jcb.__all__
    for mod in (tcb, jcb):
        with pytest.raises(ValueError, match="unknown callback hook"):
            mod.installcallback("midstep", print)
    for deco in ("callfromafterstep", "callfrombeforestep",
                 "callfrombeforeEsolve", "callfromafterEsolve"):
        assert getattr(tcb, deco).__name__ == getattr(jcb, deco).__name__


def _record(mod, log, sim_of):
    """Install a recorder on every hook of ``mod``: (hook, step) pairs."""
    for h in mod.HOOKS:
        mod.installcallback(h, lambda h=h: log.append((h, sim_of().state
                                                       .step)))


def _es_pair(tmp_path):
    text = ES_DECK.format(es="labframe")
    jsim = JSimulation.from_deck(JDeck.from_string(text),
                                 output_dir=str(tmp_path / "jax"))
    tsim = warpx_tpu_torch.Simulation.from_deck(
        TDeck.from_string(text), output_dir=str(tmp_path / "port"), **CPU64)
    return jsim, tsim


def _run(sim, mod, fld, signals):
    """Every hook recorded through a run of ``sim`` whose afterstep asks
    for a checkpoint after step 1 and a break after step 2, and whose
    beforeEsolve of step 2 doubles Ez through the data views of ``fld``."""
    log = []
    _record(mod, log, lambda: sim)
    sim.signals = signals

    def ask():
        if sim.state.step == 1:
            sim.signals.checkpoint_requested = True
        elif sim.state.step == 2:
            sim.signals.break_requested = True

    def scale():
        if sim.state.step == 2:
            Ez = fld.FieldWrapper("Ez", sim=sim)
            Ez[...] = 2.0 * Ez[...]

    mod.installcallback("afterstep", ask)
    mod.installcallback("beforeEsolve", scale)
    sim.init()
    sim.evolve()
    mod.clear_callbacks()
    return log


def test_hook_order_matches_jax_on_a_bounded_electrostatic_deck(tmp_path):
    """Every hook, on the bounded electrostatic deck with a checkpoint and
    then a break asked for by the signals: the same (hook, step) sequence
    as JAX's, the signal's checkpoint written, the same state after."""
    jsim, tsim = _es_pair(tmp_path)
    ref = _run(jsim, jcb, jfields, JSignalFlags())
    got = _run(tsim, tcb, tfields, TSignalFlags())
    assert got == ref
    hooks = [h for h, _ in got]
    # two steps, then the break before the third
    assert hooks.count("afterstep") == 2 and hooks[-1] == "onbreaksignal"
    assert hooks.count("beforeEsolve") == hooks.count("afterEsolve") == 2
    assert hooks.count("oncheckpointsignal") == 1
    assert ("oncheckpointsignal", 1) in got
    assert hooks.index("afterstep") < hooks.index("oncheckpointsignal")
    step1 = [h for h, s in got if s == 1][:7]
    assert step1 == ["afterdeposition", "aftercollisions", "beforeEsolve",
                     "afterEsolve", "afterdiagnostics", "afterstep",
                     "oncheckpointsignal"]
    assert (tmp_path / "port" / "chk_signal000001").is_dir()
    assert tsim.state.step == jsim.state.step == 2
    ref_state, got_state = states(jsim, tsim)
    states_close(ref_state, got_state)
    np.testing.assert_allclose(np.asarray(tsim.state.fields.phi),
                               np.asarray(jsim.state.fields.phi),
                               rtol=1e-9, atol=1e-9 * float(
                                   np.abs(np.asarray(jsim.state.fields.phi))
                                   .max()))


def test_in_step_hooks_warn_and_an_empty_registry_costs_nothing(
        monkeypatch):
    """An in-step hook warns that it fires at the step's edges; evolve
    reads the registry once a step and calls nothing when it is empty."""
    from warpx_tpu_torch.models import uniform_plasma
    from warpx_tpu_torch.utils.observability import WarnManager

    WarnManager.instance().reset()
    tcb.installcallback("beforedeposition", lambda: None)
    assert any("beforedeposition" in str(r)
               for r in WarnManager.instance()._records)
    tcb.clear_callbacks()
    called = []
    monkeypatch.setattr(
        "warpx_tpu_torch.core.simulation._cb",
        lambda h: called.append(h))
    sim = warpx_tpu_torch.Simulation(
        uniform_plasma(n=8, ndim=2, max_step=1), **CPU64)
    sim.evolve()
    assert called == []
    assert sim.state.fields.Ex.dtype == torch.float64
