"""The port's multi-device layer (``warpx_tpu_torch/parallel/``) against the
JAX package's ``warpx_tpu/parallel/``.

The rank mesh against JAX's device reshape; the numpy helpers
(``_owner_index``, ``pack_by_owner``, ``distribute_particles`` and the four
load-balance functions) bitwise on seeded inputs, and JAX's own load-balance
tests in form; the halo exchange, the guard accumulation and the particle
exchange at 2 and 4 gloo ranks (``launch.run_ranks``, started once for the
module) against JAX's under ``shard_map`` on the virtual CPU devices, with
overflow cases that count ``lost`` as JAX counts it; and that the port and
``chip_smoke.py`` import nothing of JAX.
"""

import math
import pathlib
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.parallel import distribute as jdist
from warpx_tpu.parallel import halo as jhalo
from warpx_tpu.parallel import load_balance as jlb
from warpx_tpu.parallel import particles as jparticles
from warpx_tpu.parallel.topology import SpatialMesh as JSpatialMesh
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import ParticleState
from warpx_tpu_torch.parallel import distribute as tdist
from warpx_tpu_torch.parallel import load_balance as tlb
from warpx_tpu_torch.parallel.halo import axis_ring
from warpx_tpu_torch.parallel.launch import run_ranks
from warpx_tpu_torch.parallel.programs import run_jobs
from warpx_tpu_torch.parallel.topology import SpatialMesh

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = {1: ("z",), 2: ("x", "z"), 3: ("x", "y", "z")}


def port_mesh(shape, rank=0):
    n = math.prod(shape.values())
    return SpatialMesh(axis_shards=tuple(shape.items()), rank=rank,
                       global_ranks=tuple(range(n)))


def geometries(ndim, n_cell):
    kw = dict(ndim=ndim, n_cell=tuple(n_cell), prob_lo=(-8e-6,) * ndim,
              prob_hi=tuple(8e-6 + 4e-6 * d for d in range(ndim)),
              periodic=(True,) * ndim)
    return JGeometry(**kw), Geometry(**kw)


# ---- the mesh of ranks ------------------------------------------------------

MESHES = [{"z": 4}, {"x": 2}, {"x": 2, "z": 2}, {"x": 2, "y": 2, "z": 2},
          {"z": 2, "x": 4}]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_rank_coords_match_jax_device_mesh(shape):
    """Rank r sits where JAX's mesh puts device r; the neighbours along an
    axis are the ring's."""
    jm = JSpatialMesh.create(shape)
    ids = [d.id for d in jax.devices()]
    devs = jm.mesh.devices
    for pos in np.ndindex(devs.shape):
        r = ids.index(devs[pos].id)
        sm = port_mesh(shape, r)
        assert tuple(sm.coords()[a] for a in sm.axis_names) == pos
        assert sm.rank_of(sm.coords()) == r
        for d, (ax, n) in enumerate(shape.items()):
            for shift in (-1, 1):
                nb = list(pos)
                nb[d] = (nb[d] + shift) % n
                assert sm.neighbor(ax, shift) == ids.index(devs[tuple(nb)].id)
            assert axis_ring(n, 1) == [(i, (i + 1) % n) for i in range(n)]
    assert sm.total_shards == jm.total_shards


def test_local_n_cell_and_refusal_match_jax():
    jg, tg = geometries(2, (16, 24))
    for shape in ({"x": 2, "z": 4}, {"z": 8}):
        assert port_mesh(shape).local_n_cell(tg) == \
            JSpatialMesh.create(shape).local_n_cell(jg)
    with pytest.raises(ValueError, match="not divisible") as te:
        port_mesh({"z": 5}).local_n_cell(tg)
    with pytest.raises(ValueError, match="not divisible") as je:
        JSpatialMesh.create({"z": 5}).local_n_cell(jg)
    assert str(te.value) == str(je.value)


# ---- the numpy helpers, bitwise --------------------------------------------

def particle_columns(ndim, n, geom, seed, extra=True):
    rng = np.random.default_rng(seed)
    cols = {k: rng.normal(size=n) for k in ("w", "ux", "uy", "uz")}
    for d, nm in enumerate(AXES[ndim]):
        lo, hi = geom.prob_lo[d], geom.prob_hi[d]
        # a few particles outside the domain: the owner index clips them
        cols[nm] = rng.uniform(lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo),
                               size=n)
    cols["alive"] = rng.uniform(size=n) < 0.8
    ext = ({"ionizationLevel": rng.integers(0, 5, n).astype(np.int32)}
           if extra else {})
    return cols, ext


def both_states(cols, ext):
    jps = JParticleState(**{k: jnp.asarray(v) for k, v in cols.items()},
                         extra={k: jnp.asarray(v) for k, v in ext.items()})
    tps = ParticleState(**{k: torch.from_numpy(v.copy())
                           for k, v in cols.items()},
                        extra={k: torch.from_numpy(v.copy())
                               for k, v in ext.items()})
    return jps, tps


def assert_same_particles(got, ref):
    for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z"):
        a, b = getattr(ref, k), getattr(got, k)
        if a is None:
            assert b is None, k
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert set(ref.extra) == set(got.extra)
    for k, v in ref.extra.items():
        assert np.array_equal(np.asarray(v), got.extra[k].numpy()), k


CASES = [(1, {"z": 2}), (2, {"z": 4}), (2, {"x": 2, "z": 2}),
         (3, {"x": 2, "y": 2, "z": 2})]


@pytest.mark.parametrize("ndim,shape", CASES, ids=str)
def test_owner_index_and_distribute_bitwise(ndim, shape):
    jg, tg = geometries(ndim, (16,) * ndim)
    cols, ext = particle_columns(ndim, 700, tg, seed=ndim)
    pos = np.stack([cols[nm] for nm in AXES[ndim]], axis=-1)
    jm = JSpatialMesh.create(shape)
    assert np.array_equal(tdist._owner_index(pos, tg, port_mesh(shape)),
                          jdist._owner_index(pos, jg, jm))
    jps, tps = both_states(cols, ext)
    for headroom in (1.5, 1.0):
        assert_same_particles(
            tdist.distribute_particles(tps, tg, port_mesh(shape), headroom),
            jdist.distribute_particles(jps, jg, jm, headroom))


@pytest.mark.parametrize("ndim,n_shards", [(2, 4), (3, 2)])
def test_pack_by_owner_bitwise(ndim, n_shards):
    jg, tg = geometries(ndim, (16,) * ndim)
    cols, ext = particle_columns(ndim, 300, tg, seed=10 + ndim)
    jps, tps = both_states(cols, ext)
    owner = np.random.default_rng(3).integers(-1, n_shards, 300)
    cap = int(np.bincount(owner[owner >= 0]).max()) + 5
    assert_same_particles(
        tdist.pack_by_owner(tps, owner, n_shards, cap, tg),
        jdist.pack_by_owner(jps, owner, n_shards, cap, jg))
    with pytest.raises(RuntimeError, match="repack overflow") as te:
        tdist.pack_by_owner(tps, owner, n_shards, cap - 6, tg)
    with pytest.raises(RuntimeError, match="repack overflow") as je:
        jdist.pack_by_owner(jps, owner, n_shards, cap - 6, jg)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("tiles", [(4, 4, 4), (2, 8), (8,), (3, 5, 2),
                                   (1, 1, 16)], ids=str)
def test_morton_order_bitwise(tiles):
    assert np.array_equal(tlb.morton_order(tiles), jlb.morton_order(tiles))


@pytest.mark.parametrize("seed,n_tiles,n_chips",
                         [(0, 64, 2), (1, 64, 4), (2, 128, 8), (3, 30, 3),
                          (4, 16, 16)])
def test_assignments_bitwise(seed, n_tiles, n_chips):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.0, 3.0, n_tiles)
    costs[rng.uniform(size=n_tiles) < 0.3] = 0.0  # empty tiles
    order = jlb.morton_order((n_tiles,))
    assert np.array_equal(tlb.sfc_assignment(costs, order, n_chips),
                          jlb.sfc_assignment(costs, order, n_chips))
    for nmax in (None, int(math.ceil(n_tiles / n_chips * 1.24)), 1):
        t = tlb.knapsack_assignment(costs, n_chips, nmax)
        j = jlb.knapsack_assignment(costs, n_chips, nmax)
        assert np.array_equal(t, j)
        assert tlb.assignment_efficiency(costs, t, n_chips) == \
            jlb.assignment_efficiency(costs, j, n_chips)


def test_knapsack_balances_skewed_costs():
    """JAX's test of the same name, on the port's functions."""
    costs = np.array([100.0, 1.0, 1.0, 1.0, 50.0, 50.0, 1.0, 1.0])
    assign = tlb.knapsack_assignment(costs, 2)
    assert tlb.assignment_efficiency(costs, assign, 2) > 0.98
    counts = np.bincount(tlb.knapsack_assignment(costs, 4, nmax=2),
                         minlength=4)
    assert counts.max() <= 2


def test_sfc_split_is_contiguous_and_fair():
    rng = np.random.default_rng(0)
    costs = rng.uniform(1.0, 2.0, size=64)
    order = tlb.morton_order((4, 4, 4))
    assert sorted(order.tolist()) == list(range(64))
    assign = tlb.sfc_assignment(costs, order, 8)
    chunks = assign[order]
    assert set(chunks.tolist()) == set(range(8))
    assert np.all(np.diff(chunks) >= 0)
    assert tlb.assignment_efficiency(costs, assign, 8) > 0.8


def test_efficiency_definition():
    costs = np.array([3.0, 1.0])
    assert tlb.assignment_efficiency(costs, np.array([0, 1]), 2) == \
        pytest.approx(2.0 / 3.0)


# ---- halos and particles across gloo ranks ----------------------------------

def _dim_names(geom_axes, shape):
    """Per array dim: the mesh axis sharding it, or None."""
    return [ax if shape.get(ax, 1) > 1 else None for ax in geom_axes]


# (mesh, grid, guard width, leading batch of components)
HALO_CASES = [({"x": 2, "z": 2}, (16, 24), 4, 0),
              ({"z": 2}, (12, 16), 3, 0),
              ({"x": 4}, (16, 10), 2, 2),
              ({"z": 4}, (6, 8, 16), 3, 0),
              ({"x": 2, "y": 2}, (8, 8, 6), 2, 3)]


def halo_inputs(case_idx):
    shape, n_cell, ng, batch = HALO_CASES[case_idx]
    ndim = len(n_cell)
    rng = np.random.default_rng(100 + case_idx)
    lead = (batch,) if batch else ()
    A = rng.normal(size=lead + n_cell)
    names = _dim_names(AXES[ndim], shape)
    sm = port_mesh(shape)
    local = [n // shape.get(ax, 1) for ax, n in zip(AXES[ndim], n_cell)]
    # the padded blocks of the accumulation, laid side by side
    pshape = [(l + 2 * ng) * shape.get(ax, 1)
              for ax, l in zip(AXES[ndim], local)]
    Pd = rng.normal(size=lead + tuple(pshape))
    blocks, padded = [], []
    for r in range(sm.total_shards):
        c = port_mesh(shape, r).coords()
        sl = tuple(slice(c.get(ax, 0) * l, (c.get(ax, 0) + 1) * l)
                   for ax, l in zip(AXES[ndim], local))
        psl = tuple(slice(c.get(ax, 0) * (l + 2 * ng),
                          (c.get(ax, 0) + 1) * (l + 2 * ng))
                    for ax, l in zip(AXES[ndim], local))
        blocks.append(np.ascontiguousarray(A[(Ellipsis,) + sl]))
        padded.append(np.ascontiguousarray(Pd[(Ellipsis,) + psl]))
    return A, Pd, blocks, padded, names, local


def jax_halo(case_idx):
    """JAX's exchange and accumulation under shard_map, cut back into the
    blocks of each rank (component by component for a batch)."""
    shape, n_cell, ng, batch = HALO_CASES[case_idx]
    A, Pd, _, _, names, local = halo_inputs(case_idx)
    ndim = len(n_cell)
    jm = JSpatialMesh.create(shape)
    spec = P(*[nm for nm in names])
    ex = jax.jit(shard_map(lambda a: jhalo.exchange_halos(a, ng, names),
                           mesh=jm.mesh, in_specs=(spec,), out_specs=spec))
    acc = jax.jit(shard_map(lambda a: jhalo.accumulate_guards(a, ng, names),
                            mesh=jm.mesh, in_specs=(spec,), out_specs=spec))
    comps = range(batch) if batch else [None]
    outs_ex = [np.asarray(ex(jnp.asarray(A if c is None else A[c])))
               for c in comps]
    outs_acc = [np.asarray(acc(jnp.asarray(Pd if c is None else Pd[c])))
                for c in comps]
    per_rank = []
    for r in range(math.prod(shape.values())):
        co = port_mesh(shape, r).coords()

        def cut(arr, width):
            return arr[tuple(slice(co.get(ax, 0) * (l + width),
                                   (co.get(ax, 0) + 1) * (l + width))
                             for ax, l in zip(AXES[ndim], local))]

        e = [cut(o, 2 * ng) for o in outs_ex]
        a = [cut(o, 0) for o in outs_acc]
        per_rank.append((np.stack(e) if batch else e[0],
                         np.stack(a) if batch else a[0]))
    return per_rank


# (mesh, ndim, slots a rank, live share, K)
PARTICLE_CASES = [({"x": 2, "z": 2}, 2, 96, 0.6, 16),
                  ({"x": 2, "z": 2}, 2, 96, 0.6, 2),   # K overflows
                  ({"x": 2, "z": 2}, 2, 40, 0.95, 16),  # no free slot
                  ({"z": 2}, 2, 64, 0.5, 64),
                  ({"z": 2}, 2, 64, 0.5, 3),
                  ({"x": 2, "y": 2}, 3, 80, 0.7, 8)]


def particle_inputs(case_idx):
    """Each rank's columns: live particles in and around its block (a
    third of a block's width out at most, some across two faces), the
    block's bounds."""
    shape, ndim, cap, live, K = PARTICLE_CASES[case_idx]
    _, tg = geometries(ndim, (16,) * ndim)
    rng = np.random.default_rng(200 + case_idx)
    cols, lo, hi = [], [], []
    for r in range(math.prod(shape.values())):
        co = port_mesh(shape, r).coords()
        blo, bhi = [], []
        c = {k: rng.normal(size=cap) for k in ("w", "ux", "uy", "uz")}
        for d, ax in enumerate(AXES[ndim]):
            ext = (tg.prob_hi[d] - tg.prob_lo[d]) / shape.get(ax, 1)
            a = tg.prob_lo[d] + co.get(ax, 0) * ext
            blo.append(a)
            bhi.append(a + ext)
            c[ax] = rng.uniform(a - ext / 3, a + ext + ext / 3, size=cap)
        c["alive"] = rng.uniform(size=cap) < live
        cols.append(c)
        lo.append(blo)
        hi.append(bhi)
    return cols, lo, hi, _dim_names(AXES[ndim], shape), K


def jax_particles(case_idx):
    shape, ndim, cap, _, K = PARTICLE_CASES[case_idx]
    cols, lo, hi, names, _ = particle_inputs(case_idx)
    jm = JSpatialMesh.create(shape)
    axes = tuple(shape)
    glob = {k: jnp.asarray(np.concatenate([c[k] for c in cols]))
            for k in cols[0]}
    bounds = jnp.asarray(np.stack([lo, hi], axis=1))  # (n, 2, ndim)

    def local(g, b):
        sp = JParticleState(**g)
        out, lost = jparticles.exchange_particles(sp, ndim, names, b[0, 0],
                                                  b[0, 1], K)
        return ({k: getattr(out, k) for k in g}, lost[None])

    fn = jax.jit(shard_map(local, mesh=jm.mesh,
                           in_specs=({k: P(axes) for k in glob}, P(axes)),
                           out_specs=({k: P(axes) for k in glob}, P(axes))))
    out, lost = fn(glob, bounds)
    return [({k: np.asarray(v)[r * cap:(r + 1) * cap] for k, v in out.items()},
             int(lost[r])) for r in range(len(cols))]


@pytest.fixture(scope="module")
def port_runs():
    """Every halo and particle case in one start of 4 gloo ranks (the
    2-rank cases on a subgroup)."""
    jobs = []
    for i, (shape, n_cell, ng, _) in enumerate(HALO_CASES):
        _, _, blocks, padded, names, _ = halo_inputs(i)
        jobs.append(("halo", dict(world=math.prod(shape.values()),
                                  mesh=shape, blocks=blocks, padded=padded,
                                  ng=ng, mesh_axes=names)))
    for i, (shape, ndim, _, _, K) in enumerate(PARTICLE_CASES):
        cols, lo, hi, names, _ = particle_inputs(i)
        jobs.append(("particles", dict(world=math.prod(shape.values()),
                                       mesh=shape, ndim=ndim, columns=cols,
                                       lo=lo, hi=hi, K=K, dim_axes=names)))
    per_rank = run_ranks(4, run_jobs, (jobs,), timeout=240)
    # results[job][rank]
    return [[per_rank[r][j] for r in range(4)] for j in range(len(jobs))]


@pytest.mark.parametrize("case", range(len(HALO_CASES)),
                         ids=[str(c[:3]) for c in HALO_CASES])
def test_halos_match_jax_shard_map(port_runs, case):
    got = port_runs[case]
    for r, (ex, acc) in enumerate(jax_halo(case)):
        # copies exactly; sums of the same terms in the same order
        assert np.array_equal(got[r]["exchanged"], ex), r
        np.testing.assert_allclose(got[r]["accumulated"], acc, rtol=1e-15,
                                   atol=0, err_msg=str(r))


@pytest.mark.parametrize("case", range(len(PARTICLE_CASES)),
                         ids=[f"{c[0]}-K{c[4]}-cap{c[2]}"
                              for c in PARTICLE_CASES])
def test_particle_exchange_matches_jax_shard_map(port_runs, case):
    got = port_runs[len(HALO_CASES) + case]
    ref = jax_particles(case)
    for r, (cols, lost) in enumerate(ref):
        assert got[r]["lost"] == lost, (r, got[r]["lost"], lost)
        for k, v in cols.items():
            assert np.array_equal(got[r]["columns"][k], v), (r, k)
    if PARTICLE_CASES[case][4] <= 3 or PARTICLE_CASES[case][3] > 0.9:
        # the overflow cases really overflowed
        assert sum(lost for _, lost in ref) > 0


def test_failed_rank_fails_the_call():
    """A rank that raises fails ``run_ranks`` with its traceback."""
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed") as e:
        run_ranks(2, run_jobs, ([("no_such_job", dict(world=2))],),
                  timeout=60)
    assert "KeyError" in str(e.value)


def test_hung_collective_times_out():
    """A collective that one rank never joins ends in a raised timeout
    (the ranks killed), never in a pass."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(2, run_jobs, ([("barrier", dict(world=2, ranks=[0],
                                                  hold=120.0))],),
                  timeout=8)
    assert time.monotonic() - t0 < 60


# ---- no JAX in the port ----------------------------------------------------

def test_port_imports_no_jax():
    """The package and chip_smoke.py import neither jax nor warpx_tpu."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|warpx_tpu)(\.|\s|$)")
    files = sorted((ROOT / "warpx_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = [f"{f.relative_to(ROOT)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad
    assert any(f.parent.name == "parallel" for f in files)
