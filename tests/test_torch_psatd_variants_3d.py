"""The PSATD families of ``test_torch_psatd_variants.py`` in 3D: the
drifting two-species plasma at 16^3, order 1, ``psatd_order = 16`` on the
guard-padded box, 3 steps per family, on the port's per-particle step
against the JAX package's (checksums at 1e-9, divE and divB at 1e-9 of
their largest value cell by cell; CPU, float64)."""

import pytest
import torch

from .test_torch_psatd_variants import FAMILIES, check_family

torch.set_num_threads(1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_3d_matches_jax(family):
    sim = check_family(3, family)
    assert sim.psatd.ng == (0 if family == "vay" else 8)
    assert sim.state.species["electrons"].x.shape[0] == 2 * 16 ** 3
