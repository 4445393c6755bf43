"""Active-simulation registry for the pywarpx-style data views.

The counterpart of ``warpx_tpu.runtime``.  The reference's ``pywarpx``
talks to the C++ singleton through libwarpx (``Python/pywarpx/
_libwarpx.py``); here the data views (``fields.py``,
``particle_containers.py``) need a handle on the live ``Simulation``, which
this module keeps.  ``Simulation.init`` registers itself first, so a
``picmi.Simulation``, ``pywarpx.init()`` and the CLI all register their run.
"""

from __future__ import annotations

_active = None


def set_simulation(sim) -> None:
    global _active
    _active = sim


def get_simulation():
    if _active is None:
        raise RuntimeError(
            "no active simulation: initialize a Simulation (or picmi "
            "Simulation) before using the data-view wrappers"
        )
    return _active
