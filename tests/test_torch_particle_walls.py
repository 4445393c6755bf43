"""The port's particle walls against the JAX package: thermal walls and the
boundary-scraping buffers.

A hot 2D plasma in a PEC box re-emitted by thermal walls across x (the
draws replay the JAX package's key chain,
``tests/test_torch_draws_util.py``) while absorbing z faces record what
they absorb (``<species>.save_particles_at_*``), per particle and
tile-binned; every face and an embedded sphere recording, per particle;
``Simulation.scraped_particles`` against the JAX package's.  CPU,
float64, within 1e-9.
"""

import numpy as np
import pytest
import torch

from .test_torch_draws_util import (assert_checksums_close, assert_runs_close,
                                    jax_run, port_run)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

BOX = """
max_step = {steps}
amr.n_cell = 16 32
geometry.dims = 2
geometry.prob_lo = -4.e-6 -8.e-6
geometry.prob_hi =  4.e-6  8.e-6
boundary.field_lo = pec pec
boundary.field_hi = pec pec
warpx.cfl = 0.98
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.3
electrons.uy_th = 0.3
electrons.uz_th = 0.3
"""

# thermal walls across x, absorbing z faces that record what they absorb
WALLS = """
boundary.particle_lo = thermal absorbing
boundary.particle_hi = thermal absorbing
boundary.electrons.u_th = 0.05
electrons.save_particles_at_zlo = 1
electrons.save_particles_at_zhi = 1
"""

# every face absorbing and recording, and an embedded sphere that does too
SCRAPE_ALL = """
boundary.particle_lo = absorbing absorbing
boundary.particle_hi = absorbing absorbing
electrons.save_particles_at_xlo = 1
electrons.save_particles_at_xhi = 1
electrons.save_particles_at_zlo = 1
electrons.save_particles_at_zhi = 1
electrons.save_particles_at_eb = 1
eb2.geom_type = sphere
eb2.sphere_center = 0. 0. 0.
eb2.sphere_radius = 2.e-6
eb2.sphere_has_fluid_inside = 0
"""


def _deck(extra, tiled, steps=4):
    # tile-binned: 5 x 4 a cell, above the 8192 particles below which a
    # species keeps its compact layout and never reaches the fused kernel
    ppc = "5 4" if tiled == "on" else "1 1"
    return (BOX.format(steps=steps).replace(
        "num_particles_per_cell_each_dim = 1 1",
        f"num_particles_per_cell_each_dim = {ppc}") + extra
        + f"tpu.tiled_particles = {tiled}\n")


def _buffers_match(p, j, faces):
    total = 0
    for face in faces:
        got, ref = (p.scraped_particles("electrons", face),
                    j.scraped_particles("electrons", face))
        assert set(got) == set(ref) == {"w", "ux", "uy", "uz", "p0", "p1",
                                        "step"}
        for k, a in ref.items():
            np.testing.assert_allclose(got[k], a, rtol=1e-12, atol=0.0,
                                       err_msg=f"{face} {k}")
        total += got["w"].shape[0]
    return total


@pytest.mark.parametrize("tiled", ["off", "on"])
def test_thermal_walls_and_buffers_match_jax(tiled):
    """Re-emission from the x walls on the JAX package's own draws (the
    normal momentum from the Gaussian flux distribution into the box, the
    tangential ones Gaussian), and the z faces' records in slot order with
    the step of their crossing; the alive count falls by the records'."""
    text = _deck(WALLS, tiled)
    j = jax_run(text)
    p = port_run(text)
    assert p.binned == (tiled == "on") and p.draws is not None
    n0 = int(port_run(text.replace("max_step = 4", "max_step = 0"),
                      replay=False).state.species["electrons"].alive.sum())
    total = _buffers_match(p, j, ("zlo", "zhi"))
    assert total > 0
    assert int(p.state.species["electrons"].alive.sum()) == n0 - total
    if tiled == "off":
        assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


def test_thermal_walls_keep_every_particle_inside():
    """Nothing is lost, every particle is inside the box, and the ones the
    walls re-emitted carry a spread of the order of u_th."""
    text = _deck(WALLS.replace("thermal absorbing", "thermal thermal"),
                 "off", steps=8)
    sim = port_run(text, replay=False)
    sp = sim.state.species["electrons"]
    assert int(sp.alive.sum()) == 16 * 32
    geom = sim.cfg.geometry
    for d, p in enumerate(sp.positions(2)):
        assert float(p.min()) >= geom.prob_lo[d]
        assert float(p.max()) <= geom.prob_hi[d]
    u = torch.sqrt(sp.ux ** 2 + sp.uy ** 2 + sp.uz ** 2) / 299792458.0
    slow = u[u < 0.2]  # re-emitted: the plasma's own spread is 0.3
    assert slow.numel() > 0
    u_rms = float(torch.sqrt((slow ** 2).mean() / 3.0))
    assert 0.5 * 0.05 < u_rms < 2.0 * 0.05


def test_buffers_on_every_face_and_the_embedded_boundary_match_jax():
    """Every face and an embedded sphere (``save_particles_at_eb``) remove
    and record what crosses them."""
    text = _deck(SCRAPE_ALL, "off")
    j = jax_run(text)
    p = port_run(text, replay=False)
    for face in ("xlo", "xhi", "zlo", "zhi", "eb"):
        assert p.scraped_particles("electrons", face)["w"].shape[0] > 0, face
    _buffers_match(p, j, ("xlo", "xhi", "zlo", "zhi", "eb"))
    assert_runs_close(p, j, 1e-9)
