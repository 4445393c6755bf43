"""Helpers shared by the tests of the port's stochastic operators
(``tests/test_torch_{ionization,qed,radiation_reaction,resampling,coulomb,
fusion,dsmc_mcc}.py``): a
draw source that follows the JAX package's key chain, so that the port runs
on the very numbers ``jax.random`` gave the JAX package, and the runs of a
deck through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import warpx_tpu_torch
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.utils.parser import Deck

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

_JDTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


class _Leaf:
    """The draws of one JAX subkey."""

    def __init__(self, key, device):
        self.key = key
        self.device = device

    def _t(self, a, dtype):
        return torch.from_numpy(np.asarray(a).copy()).to(
            device=self.device, dtype=dtype)

    def split(self, n):
        """``jax.random.split(key, n)``, every subkey handed back."""
        return tuple(_Leaf(k, self.device)
                     for k in jax.random.split(self.key, n))

    def fold_in(self, i):
        return _Leaf(jax.random.fold_in(self.key, i), self.device)

    def uniform(self, shape, dtype, lo=0.0, hi=1.0):
        return self._t(jax.random.uniform(self.key, tuple(shape),
                                          dtype=_JDTYPE[dtype], minval=lo,
                                          maxval=hi), dtype)

    def normal(self, shape, dtype):
        return self._t(jax.random.normal(self.key, tuple(shape),
                                         dtype=_JDTYPE[dtype]), dtype)

    def poisson(self, lam):
        lam_j = jnp.asarray(lam.detach().cpu().numpy())
        return self._t(jax.random.poisson(self.key, lam_j), lam.dtype)

    def exponential(self, shape, dtype):
        return -torch.log(1.0 - self.uniform(shape, dtype))


class ReplayDraws:
    """A ``utils.draws`` source on JAX's key chain: ``split(n)`` splits the
    carried key into it and ``n`` subkeys, as ``jax.random.split(key,
    n + 1)`` does in the JAX package's operators."""

    def __init__(self, key, device="cpu"):
        self.key = key
        self.device = torch.device(device)

    @classmethod
    def from_seed(cls, seed, device="cpu"):
        return cls(jax.random.PRNGKey(seed), device)

    def split(self, n):
        keys = jax.random.split(self.key, n + 1)
        self.key = keys[0]
        return tuple(_Leaf(k, self.device) for k in keys[1:])

    def fold_in(self, i):
        """``jax.random.fold_in(key, i)`` of the carried key, which stays
        (the Gaussian continuous injection reads the state's key so)."""
        return _Leaf(jax.random.fold_in(self.key, i), self.device)


def jax_run(text, steps=None, hook=None):
    """The deck through the JAX package (float64, CPU, per particle):
    ``hook(sim)`` after init."""
    sim = JSimulation.from_deck(JDeck.from_string(text))
    sim.init()
    if hook is not None:
        hook(sim)
    sim.evolve(-1 if steps is None else steps)
    return sim


def port_run(text, steps=None, hook=None, replay=True, **kw):
    """The deck through the port (float64, CPU): on JAX's key chain from
    the configuration's seed with ``replay``, on its own generator
    otherwise; ``hook(sim)`` after init."""
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu", **kw)
    if replay:
        sim.draws = ReplayDraws.from_seed(sim.cfg.seed)
    sim.init()
    if hook is not None:
        hook(sim)
    sim.evolve(-1 if steps is None else steps)
    return sim


def jax_species_numpy(sp):
    out = {k: None if getattr(sp, k) is None else np.asarray(getattr(sp, k))
           for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z")}
    out["extra"] = {k: np.asarray(v) for k, v in sp.extra.items()}
    return out


def port_species_numpy(sp):
    out = {k: None if getattr(sp, k) is None
           else getattr(sp, k).detach().cpu().numpy()
           for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z")}
    out["extra"] = {k: v.detach().cpu().numpy() for k, v in sp.extra.items()}
    return out


def assert_species_close(got, ref, tol, what=""):
    """Two species slot by slot: alive masks and integer attributes
    bitwise, the rest within ``tol`` of the largest magnitude."""
    np.testing.assert_array_equal(got["alive"], ref["alive"], err_msg=what)
    for k, a in ref.items():
        if k in ("alive", "extra"):
            continue
        if a is None:
            assert got[k] is None, (what, k)
            continue
        if k in ("x", "y", "z"):
            # the JAX package streams a photon at c / max(|u|, 1e-300),
            # which overflows for a dead slot (u = 0) and leaves its
            # position NaN; the port keeps it where it was
            keep = ref["alive"] | np.isfinite(a)
            a, g = a[keep], got[k][keep]
        else:
            g = got[k]
        _close(g, a, tol, (what, k))
    assert set(got["extra"]) == set(ref["extra"]), what
    for k, a in ref["extra"].items():
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(got["extra"][k], a,
                                          err_msg=f"{what} {k}")
        else:
            _close(got["extra"][k], a, tol, (what, k))


def _close(got, ref, tol, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not ref.size:
        return
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= tol * scale + 1e-300, (what, err, scale)


def assert_runs_close(port_sim, jax_sim, tol=1e-9, fields=True):
    """Every species (with its attributes) and the fields of two runs at
    the same step within ``tol``."""
    assert port_sim.state.step == int(jax_sim.state.step)
    for name, sp in jax_sim.state.species.items():
        assert_species_close(port_species_numpy(port_sim.state.species[name]),
                             jax_species_numpy(sp), tol, name)
    if fields:
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
            _close(getattr(port_sim.state.fields, nm).numpy(),
                   np.asarray(getattr(jax_sim.state.fields, nm)), tol, nm)


def assert_checksums_close(got, ref, tol=1e-9):
    assert set(ref) == set(got)
    for group in ref:
        assert set(ref[group]) == set(got[group]), group
        for q in ref[group]:
            if q in ("divB", "divE"):
                continue  # roundoff noise whose value depends on sum order
            a, b = ref[group][q], got[group][q]
            assert abs(a - b) <= tol * abs(a) + 1e-300, (group, q, a, b)


# a 16 x 16 periodic plasma with a nitrogen species (initial level 2) whose
# electrons go to ``eprod``; the tests write a seeded Ex after init
ION_2D = """
max_step = 6
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
particles.species_names = electrons ions eprod
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1
electrons.profile = constant
electrons.density = 1.e24
ions.species_type = nitrogen
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 2 2
ions.profile = constant
ions.density = 1.e22
ions.do_field_ionization = 1
ions.physical_element = N
ions.ionization_initial_level = 2
ions.ionization_product_species = eprod
eprod.species_type = electron
eprod.injection_style = none
"""


def lwfa_nitrogen_deck(base, steps=8, level=2):
    """The 32 x 64 laser-wakefield deck (``base``) with a nitrogen dopant
    around the antenna (initial level ``level``, electrons into
    ``electrons_n``), the laser's peak 6 fs into the run, per particle."""
    return base.replace("max_step = 12", f"max_step = {steps}").replace(
        "particles.species_names = electrons beam",
        "particles.species_names = electrons beam nitrogen electrons_n",
    ).replace("laser1.profile_t_peak = 30.e-15",
              "laser1.profile_t_peak = 6.e-15") + f"""
nitrogen.species_type = nitrogen
nitrogen.injection_style = NUniformPerCell
nitrogen.num_particles_per_cell_each_dim = 2 2
nitrogen.xmin = -10.e-6
nitrogen.xmax = 10.e-6
nitrogen.zmin = -13.e-6
nitrogen.zmax = -7.e-6
nitrogen.profile = constant
nitrogen.density = 2.e21
nitrogen.do_field_ionization = 1
nitrogen.physical_element = N
nitrogen.ionization_initial_level = {level}
nitrogen.ionization_product_species = electrons_n
electrons_n.species_type = electron
electrons_n.injection_style = none
tpu.tiled_particles = off
"""


# the constant external particle fields of the reference's QED decks
# (tests/test_qed.py E_f, B_f)
QED_FIELDS = """
particles.E_ext_particle_init_style = constant
particles.B_ext_particle_init_style = constant
particles.E_external_particle = -2433321316961438.0 973328526784575.0 1459992790176863.0
particles.B_external_particle = 2857142.85714286 4285714.28571428 8571428.57142857
"""


def qed_deck(ppc=2, steps=3, n=16, u_lep=100.0, u_phot=1000.0, dt=5e-17):
    """A periodic 2D box under the QED decks' fields: ``ele1`` (u_y =
    ``u_lep`` m_e c) emits photons into ``phot1``; photons ``g1`` (u_z =
    ``u_phot`` m_e c) make pairs into ``bwe`` (which itself emits into
    ``phot1``) and ``bwp``; ``ppc`` x ``ppc`` per cell at a negligible
    density; at dt = 5e-17 s about 17 % of the leptons emit and 6 % of the
    photons convert in a step."""
    return f"""
max_step = {steps}
amr.n_cell = {n} {n}
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
warpx.const_dt = {dt}
particles.species_names = ele1 phot1 g1 bwe bwp
ele1.species_type = electron
ele1.injection_style = NUniformPerCell
ele1.num_particles_per_cell_each_dim = {ppc} {ppc}
ele1.profile = constant
ele1.density = 1.e2
ele1.momentum_distribution_type = constant
ele1.uy = {u_lep}
ele1.do_qed_quantum_sync = 1
ele1.qed_quantum_sync_phot_product_species = phot1
phot1.species_type = photon
phot1.injection_style = none
g1.species_type = photon
g1.injection_style = NUniformPerCell
g1.num_particles_per_cell_each_dim = {ppc} {ppc}
g1.profile = constant
g1.density = 1.e2
g1.momentum_distribution_type = constant
g1.uz = {u_phot}
g1.do_qed_breit_wheeler = 1
g1.qed_breit_wheeler_ele_product_species = bwe
g1.qed_breit_wheeler_pos_product_species = bwp
bwe.species_type = electron
bwe.injection_style = none
bwe.do_qed_quantum_sync = 1
bwe.qed_quantum_sync_phot_product_species = phot1
bwp.species_type = positron
bwp.injection_style = none
""" + QED_FIELDS


def schwinger_deck(threshold=25.0, steps=2):
    """An 8^3 periodic box with Schwinger pair creation into ``es`` and
    ``ps`` (its field is written after init)."""
    return f"""
max_step = {steps}
amr.n_cell = 8 8 8
geometry.dims = 3
geometry.prob_lo = -4.e-7 -4.e-7 -4.e-7
geometry.prob_hi =  4.e-7  4.e-7  4.e-7
warpx.use_filter = 0
warpx.do_qed_schwinger = 1
qed_schwinger.ele_product_species = es
qed_schwinger.pos_product_species = ps
qed_schwinger.threshold_poisson_gaussian = {threshold}
qed_schwinger.zmin = -2.e-7
qed_schwinger.zmax = 2.e-7
particles.species_names = es ps
es.species_type = electron
es.injection_style = none
ps.species_type = positron
ps.injection_style = none
"""


def field_hook(arrs, jax_side):
    """A hook writing the numpy arrays ``arrs`` (by component) into a run's
    fields after init, in either package."""
    def hook(sim):
        if jax_side:
            upd = {k: jnp.asarray(v) for k, v in arrs.items()}
        else:
            upd = {k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}
        sim.state = sim.state.replace(fields=sim.state.fields.replace(**upd))
    return hook


def seeded_ex(shape, seed=3, scale=3e11, mean=2e11):
    return {"Ex": np.random.default_rng(seed).normal(size=shape) * scale
            + mean}
