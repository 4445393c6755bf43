"""pywarpx-style input buckets (reference: Python/pywarpx/Bucket.py and
the per-group modules WarpX.py, Amr.py, Geometry.py, Algo.py,
Particles.py...).

The counterpart of ``warpx_tpu.pywarpx``.  Attribute assignments on the
bucket objects build the ParmParse key table; ``write_input_file()`` writes
it as a deck the reference reads, and ``init()/evolve()`` run it through the
port's ``Simulation``, on the card unless ``init`` is given another
device:

    from warpx_tpu_torch import pywarpx
    pywarpx.amr.n_cell = [32, 32, 32]
    pywarpx.geometry.dims = 3
    pywarpx.geometry.prob_lo = [-1e-5]*3
    pywarpx.geometry.prob_hi = [1e-5]*3
    pywarpx.warpx.cfl = 0.9
    pywarpx.max_step = 10
    sim = pywarpx.init()
    pywarpx.evolve()

Where the reference hands an argv table to the C++ ParmParse, the table is
written as deck lines and read by ``utils.parser.Deck``, the CLI's path, so
a bucket run and its written deck run alike.  The module's ``picmi``
attribute is the port's PICMI, so that ``sys.modules["pywarpx"] =
warpx_tpu_torch.pywarpx`` runs an unchanged ``from pywarpx import picmi``
script.
"""

from __future__ import annotations

from typing import Any, Dict, List

__all__ = [
    "Bucket", "warpx", "amr", "geometry", "boundary", "algo", "particles",
    "psatd", "lasers", "diagnostics", "collisions", "interpolation",
    "max_step", "stop_time", "bucket_dict", "attr_list", "write_input_file",
    "init", "evolve", "getsim", "finalize",
]


class Bucket:
    """One ParmParse group: attribute writes record `group.key = value`
    (reference: Bucket.py:84 attrlist)."""

    def __init__(self, instancename: str, **defaults):
        self._instancename = instancename
        self._localdict: Dict[str, Any] = {}
        for k, v in defaults.items():
            self._localdict[k] = v

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._localdict[name] = value

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._localdict[name]
        except KeyError:
            raise AttributeError(name) from None

    def add_new_attr(self, name, value):
        self._localdict[name] = value

    def add_new_group_attr(self, group, name, value):
        """e.g. add_new_group_attr('electrons', 'density', 1e24)."""
        self._localdict[f"{group}.{name}" if group else name] = value

    def attrlist(self) -> List[str]:
        """Deck lines for this bucket (Bucket.py attrlist)."""
        out = []
        for key, value in self._localdict.items():
            if value is None:
                continue
            rhs = _fmt(value)
            if rhs is None:
                continue
            out.append(f"{self._instancename}.{key} = {rhs}")
        return out


def _fmt(value):
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (list, tuple)):
        if len(value) == 0:
            return None
        return " ".join(str(v) for v in value)
    return str(value)


# the standard bucket set (reference: pywarpx/__init__.py imports)
warpx = Bucket("warpx")
amr = Bucket("amr")
geometry = Bucket("geometry")
boundary = Bucket("boundary")
algo = Bucket("algo")
particles = Bucket("particles")
psatd = Bucket("psatd")
lasers = Bucket("lasers")
diagnostics = Bucket("diagnostics")
collisions = Bucket("collisions")
interpolation = Bucket("interpolation")
my_constants = Bucket("my_constants")

max_step: int | None = None
stop_time: float | None = None

_extra_buckets: Dict[str, Bucket] = {}
_sim = None


def Species(name: str) -> Bucket:
    """A per-species bucket (the reference creates these dynamically)."""
    b = _extra_buckets.get(name)
    if b is None:
        b = Bucket(name)
        _extra_buckets[name] = b
    return b


def bucket_dict() -> Dict[str, Bucket]:
    base = {
        b._instancename: b
        for b in (warpx, amr, geometry, boundary, algo, particles, psatd,
                  lasers, diagnostics, collisions, interpolation,
                  my_constants)
    }
    base.update(_extra_buckets)
    return base


def attr_list() -> List[str]:
    lines = []
    if max_step is not None:
        lines.append(f"max_step = {max_step}")
    if stop_time is not None:
        lines.append(f"stop_time = {stop_time}")
    for b in bucket_dict().values():
        lines.extend(b.attrlist())
    return lines


def write_input_file(filename: str = "inputs") -> str:
    """Emit the deck (reference: picmi.Simulation.write_input_file ->
    pywarpx.warpx.write_inputs)."""
    text = "\n".join(attr_list()) + "\n"
    with open(filename, "w") as fh:
        fh.write(text)
    return filename


def init(output_dir: str = "diags", dtype=None, device=None):
    """Build and initialize a Simulation from the current buckets
    (``Simulation.from_deck``: float32 unless ``dtype`` says otherwise, on
    the card unless ``device`` names another)."""
    global _sim
    from .core.simulation import Simulation
    from .utils.parser import Deck

    deck = Deck.from_string("\n".join(attr_list()))
    kw = {} if dtype is None else {"dtype": dtype}
    _sim = Simulation.from_deck(deck, output_dir=output_dir, device=device,
                                **kw)
    _sim.init()
    return _sim


def getsim():
    return _sim


def evolve(nsteps: int = -1):
    if _sim is None:
        raise RuntimeError("call pywarpx.init() first")
    return _sim.evolve(nsteps)


def finalize():
    global _sim
    _sim = None


# `from pywarpx import picmi` compatibility: reference PICMI scripts run
# unchanged once `pywarpx` is aliased to this module (picmi.py:2976 path)
from . import picmi  # noqa: E402,F401
