"""User callback registry (reference: Python/pywarpx/callbacks.py).

The counterpart of ``warpx_tpu.utils.callbacks``.  Functions installed at
named hook points run on the host at the matching moments of
``Simulation.evolve``, between the steps' phases, as the reference's Python
callbacks run between the C++ phases.  The hooks are the
``ExecutePythonCallback`` sites of WarpXEvolve.cpp that this loop has:

  beforestep, afterstep, beforeEsolve, afterEsolve, afterdiagnostics,
  onbreaksignal, oncheckpointsignal; ``loadbalance`` and ``poissonsolver``
  are accepted names that nothing fires, and particleinjection,
  particlescraper, beforedeposition, afterdeposition, beforecollisions and
  aftercollisions fire at the step's edges (with a warning), because the
  port's step runs those phases in one call.

Only a non-empty registry costs the loop anything.  Usage (the pywarpx
spelling):

    from warpx_tpu_torch.utils.callbacks import (installcallback,
                                                 callfromafterstep)

    installcallback("afterstep", lambda: print("step done"))

    @callfromafterstep
    def my_diag():
        ...
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .observability import warn

__all__ = [
    "installcallback", "uninstallcallback", "isinstalled",
    "clear_callbacks", "execute_callbacks", "callfromafterstep",
    "callfrombeforestep", "callfrombeforeEsolve", "callfromafterEsolve",
    "HOOKS",
]

HOOKS = (
    "beforestep", "afterstep", "beforeEsolve", "afterEsolve",
    "afterdiagnostics", "onbreaksignal", "oncheckpointsignal",
    "loadbalance", "particleinjection", "particlescraper",
    "beforedeposition", "afterdeposition", "beforecollisions",
    "aftercollisions", "poissonsolver",
)

_in_step_hooks = {
    "particleinjection", "particlescraper", "beforedeposition",
    "afterdeposition", "beforecollisions", "aftercollisions",
}

_registry: Dict[str, List[Callable]] = {}


def installcallback(name: str, fn: Callable) -> None:
    if name not in HOOKS:
        raise ValueError(f"unknown callback hook {name!r}; one of {HOOKS}")
    if name in _in_step_hooks:
        warn(
            "Callbacks",
            f"hook '{name}' names a phase inside the step, which runs as "
            "one call here; the callback fires at the step's start (before*"
            ", particle*) or after the window's move (after*)", "low",
        )
    _registry.setdefault(name, []).append(fn)


def uninstallcallback(name: str, fn: Callable | None = None) -> None:
    if fn is None:
        _registry.pop(name, None)
    elif name in _registry and fn in _registry[name]:
        _registry[name].remove(fn)


def isinstalled(name: str, fn: Callable | None = None) -> bool:
    if fn is None:
        return bool(_registry.get(name))
    return fn in _registry.get(name, [])


def clear_callbacks() -> None:
    _registry.clear()


def execute_callbacks(name: str, *args, **kwargs) -> None:
    for fn in _registry.get(name, []):
        fn(*args, **kwargs)


def _make_decorator(hook):
    def deco(fn):
        installcallback(hook, fn)
        return fn
    deco.__name__ = f"callfrom{hook}"
    return deco


callfromafterstep = _make_decorator("afterstep")
callfrombeforestep = _make_decorator("beforestep")
callfrombeforeEsolve = _make_decorator("beforeEsolve")
callfromafterEsolve = _make_decorator("afterEsolve")
