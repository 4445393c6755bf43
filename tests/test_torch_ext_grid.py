"""Initial external grid fields of the port
(``warpx.E/B_ext_grid_init_style``: ``Simulation._init_external_grid``,
``core/deck.py::_ext_grid``) against the JAX package, CPU, float64.

Constant and parsed fields (each component at its own staggered
positions) on a periodic 16^3 deck and on a bounded 32^2 deck (PEC along z;
array index 0 at the padded block's corner, ``DomainLayout.
static_origin``), and a field read from an openPMD file (as
``tests/test_from_file.py`` writes it), periodic and bounded: the initial
fields equal the JAX package's at 1e-12 of their largest value, a linear
field from the file is reproduced exactly, and 3 steps of a plasma in those
fields land within 1e-9 of the JAX run.
"""

import numpy as np
import pytest
import torch

from warpx_tpu.core.deck import config_from_deck as jconfig_from_deck
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch import Simulation
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.domain import DomainLayout
from warpx_tpu_torch.utils.parser import Deck

from .test_from_file import DECK_EXT, _write_field_file
from .test_torch_bounded_util import port_config
from .test_torch_draws_util import (assert_checksums_close,
                                    assert_runs_close, jax_run, port_run)

torch.set_num_threads(1)

_PERIODIC = """
max_step = 3
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
tpu.tiled_particles = off
"""

_BOUNDED = """
max_step = 3
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
boundary.field_lo = periodic pec
boundary.field_hi = periodic pec
boundary.particle_lo = periodic reflecting
boundary.particle_hi = periodic reflecting
warpx.cfl = 0.9
tpu.tiled_particles = off
"""

_PLASMA = """
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
"""

_FIELDS = {
    "constant": """
warpx.E_ext_grid_init_style = constant
warpx.E_external_grid = 1.e9 -2.e9 3.e9
warpx.B_ext_grid_init_style = constant
warpx.B_external_grid = 0.5 0. 1.
""",
    "parse": """
my_constants.k = 3.e5
warpx.E_ext_grid_init_style = parse_E_ext_grid_function
warpx.Ex_external_grid_function(x,y,z) = "1.e9 * sin(k * z)"
warpx.Ey_external_grid_function(x,y,z) = "2.e9 * cos(k * x) * (1 + y / 1.e-5)"
warpx.Ez_external_grid_function(x,y,z) = "1.e8 * x * 1.e5"
warpx.B_ext_grid_init_style = parse_B_ext_grid_function
warpx.Bx_external_grid_function(x,y,z) = "0.2 * z * 1.e5"
warpx.By_external_grid_function(x,y,z) = "0.3 + 0.1 * sin(k * x)"
warpx.Bz_external_grid_function(x,y,z) = "1."
""",
}

_COMPS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")


def _init_fields_agree(text):
    """The configurations equal the JAX reader's, and the initial fields
    equal the JAX package's at 1e-12 of their largest value."""
    assert config_from_deck(Deck.from_string(text)) == port_config(
        jconfig_from_deck(JDeck.from_string(text)))
    j = JSimulation.from_deck(JDeck.from_string(text))
    j.init()
    p = Simulation.from_deck(Deck.from_string(text), dtype=torch.float64,
                             device="cpu")
    p.init()
    for nm in _COMPS:
        ref = np.asarray(getattr(j.state.fields, nm))
        got = getattr(p.state.fields, nm).numpy()
        assert got.shape == ref.shape, nm
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-12 * scale + 1e-300, nm
    return p


@pytest.mark.parametrize("style", ["constant", "parse"])
@pytest.mark.parametrize("domain", ["periodic", "bounded"])
def test_ext_grid_fields_at_init(style, domain):
    base = _PERIODIC if domain == "periodic" else _BOUNDED
    p = _init_fields_agree(base + _FIELDS[style] + "particles.species_names ="
                           "\n")
    assert p.is_bounded == (domain == "bounded")
    if style == "constant":
        assert float(p.state.fields.Ey.min()) == -2e9
        assert float(p.state.fields.Bz.max()) == 1.0


@pytest.mark.parametrize("style", ["constant", "parse"])
@pytest.mark.parametrize("domain", ["periodic", "bounded"])
def test_ext_grid_runs_as_jax(style, domain):
    """3 steps of a thermal plasma in the external fields: species,
    fields and checksums within 1e-9 of the JAX run."""
    base = _PERIODIC if domain == "periodic" else _BOUNDED
    text = base + _FIELDS[style] + _PLASMA
    j = jax_run(text)
    p = port_run(text, replay=False)
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


def _linear(ci, X, Y, Z):
    return (1.0 + ci) * X + 0.5 * Y - 2.0 * Z + 0.25 * ci


def test_ext_grid_from_file_periodic(tmp_path):
    """``tests/test_from_file.py::test_external_grid_field_from_file`` on
    the port: a linear field read from a node lattice that spans the
    domain is reproduced exactly at every staggered position, and equals
    the JAX package's."""
    path = str(tmp_path / "bfield.h5")
    _write_field_file(path, _linear, lo=(-1.2, -1.2, -1.2),
                      hi=(1.2, 1.2, 1.2), n=(13, 11, 17))
    p = _init_fields_agree(DECK_EXT.format(path=path))
    geom = p.cfg.geometry
    for ci, comp in enumerate(("Bx", "By", "Bz")):
        arr = getattr(p.state.fields, comp).numpy()
        flags = p.staggering[comp]
        coords = [geom.prob_lo[d] + (np.arange(arr.shape[d])
                                     + (0.0 if flags[d] else 0.5))
                  * geom.dx[d] for d in range(3)]
        X, Y, Z = np.meshgrid(*coords, indexing="ij")
        np.testing.assert_allclose(arr, _linear(ci, X, Y, Z), rtol=0,
                                   atol=1e-12)


def test_ext_grid_from_file_bounded(tmp_path):
    """A field read from a file on a bounded 3D domain (PEC along z): the
    padded block's every staggered node interpolates from the file, as in
    the JAX package; the field is the linear function at the block's own
    positions, clipped to the file's lattice."""
    path = str(tmp_path / "bfield.h5")
    _write_field_file(path, _linear, lo=(-2.0, -2.0, -2.0),
                      hi=(2.0, 2.0, 2.0), n=(9, 9, 9))
    text = DECK_EXT.format(path=path).replace(
        "boundary.field_lo = periodic periodic periodic",
        "boundary.field_lo = periodic periodic pec").replace(
        "boundary.field_hi = periodic periodic periodic",
        "boundary.field_hi = periodic periodic pec")
    p = _init_fields_agree(text)
    assert p.is_bounded
    geom = p.cfg.geometry
    origin = DomainLayout.from_config(p.cfg).static_origin()
    arr = p.state.fields.Bz.numpy()
    flags = p.staggering["Bz"]
    coords = [np.clip(origin[d] + (np.arange(arr.shape[d])
                                   + (0.0 if flags[d] else 0.5))
                      * geom.dx[d], -2.0, 2.0) for d in range(3)]
    X, Y, Z = np.meshgrid(*coords, indexing="ij")
    np.testing.assert_allclose(arr, _linear(2, X, Y, Z), rtol=0, atol=1e-12)
