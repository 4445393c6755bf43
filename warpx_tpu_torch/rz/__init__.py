"""RZ (quasi-cylindrical) geometry: the cylindrical FDTD step
(``core.py``) and the Hankel PSATD step (``spectral.py``), the
counterparts of ``warpx_tpu.rz``."""

from .core import RZStepper, check_rz_supported, compute_dt_rz
from .spectral import PsatdRZ, RZSpectralStepper

__all__ = ["RZStepper", "RZSpectralStepper", "PsatdRZ",
           "check_rz_supported", "compute_dt_rz"]
