"""warpx_tpu_torch: the PyTorch + CUDA port of warpx_tpu for NVIDIA Hopper.

The package mirrors ``warpx_tpu``'s layout module by module.  Plain tensor
code is PyTorch; each Pallas TPU kernel of the ported path is a CUDA C++
kernel under ``csrc/``, compiled with ``nvcc`` for ``sm_90a`` on first use and
bound through ``ctypes`` (``build.py``).  Every kernel wrapper keeps a plain
PyTorch version of the same function beside it: the wrapper runs that version
only for tensors on the CPU (the parity tests) and launches the kernel for
CUDA tensors.

Ported so far: the explicit electromagnetic PIC step in 2D XZ and 3D,
periodic (``core/binned_step.py``, ``core/step.py``) and bounded
(``core/bounded_step.py``), driven by ``Simulation``, which is built from a
configuration or from an inputs deck (``Simulation.from_deck``,
``core/deck.py``; the CLI is ``python -m warpx_tpu_torch``), and the deck's
outputs: plotfile, openPMD and checkpoint files (``io/``) and reduced
diagnostics (``diagnostics/reduced.py``), written on the deck's schedule;
with the field models of ``solvers/`` (PSATD, electrostatic, hybrid,
macroscopic, the implicit schemes, ECT), cold fluids and embedded
boundaries; and runs over several devices on ``torch.distributed``
(``parallel/``): the spatially decomposed ``core.simulation.
DistSimulation`` with dynamic load balancing and the particle-decomposed
``core.particle_dist.ParticleDistSimulation``.
"""

from . import constants  # noqa: F401
from .core.simulation import Simulation  # noqa: F401

__version__ = "0.1.0"
