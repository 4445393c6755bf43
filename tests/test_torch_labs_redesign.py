"""The redesigned Hopper labs L1 (``csrc/lab_fused.cu``) and L3
(``csrc/tile_dot.cu`` in layout NT), on the CPU: the launch plan of layout
NT (``bench_dot_shapes._plan_nt``), plain models of the orders of sums the
new kernels take, and the ablation edits of ``labs_ab.py``.

The kernels themselves run only on the card (``chip_smoke.py``'s
``lab_parity`` and ``labs`` phases, ``labs_ab.py``).  Here each new order of
sums is modelled in PyTorch and held to the plain versions within the
limits chip_smoke.py holds the kernels to (TOL_DOT, TOL_LAB_FUSED).
"""

import math
import pathlib

import pytest
import torch

from warpx_tpu_torch.tools import bench_deposit_prec as l3
from warpx_tpu_torch.tools import bench_dot_shapes as dots
from warpx_tpu_torch.tools import kernel_lab as l1

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# chip_smoke.py's limits (TOL_DOT, TOL_LAB_FUSED), relative to the largest
# output
TOL_DOT = 1e-4
TOL_LAB_FUSED = {"particles": 1e-5, "j_f32": 1e-4, "j_bf16": 4e-3}
SMS, SMEM_MAX = 132, 227 * 1024

# (batch, m, n, k): the L3 cases at their shapes (bench_deposit_prec's
# CASES at K = 1152 over 8 entries; the 2D deposit as 32 entries of
# 16 x 16 and 8 of 64 x 64)
L3_SHAPES = [(l3.NT, m, n, 1152) for m, n, _ in l3.CASES] + [
    (4 * l3.NT, l3.W2D, l3.W2D, 1152), (l3.NT, 4 * l3.W2D, 4 * l3.W2D, 1152)]
# lab_parity's layout-NT shapes (batch, m, k, n), and its edge shapes
PARITY_SHAPES = [(3, 8, 64, 40), (2, 16, 1152, 256), (2, 40, 256, 64),
                 (2, 8, 1000, 200), (2, 40, 1000, 72), (3, 16, 52, 130),
                 (5, 16, 264, 16)]
MODES = ("f32", "bf16", "3pass")


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _check_cover(plan, batch, m, n, k):
    """Every (entry, row, column) in exactly one unit, every k in exactly
    one slice."""
    cover = torch.zeros((batch, m, n), dtype=torch.int32)
    for e in range(batch):
        for mb in range(plan["mg"]):
            for nb in range(plan["ng"]):
                cover[e, mb * plan["tm"]:(mb + 1) * plan["tm"],
                      nb * plan["tn"]:(nb + 1) * plan["tn"]] += 1
    assert plan["units"] == batch * plan["mg"] * plan["ng"]
    assert bool((cover == 1).all())
    ks = [kk for sl in dots.nt_slices(plan, k) for kk in sl]
    assert sorted(ks) == list(range(k))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", L3_SHAPES)
def test_plan_nt_at_l3_shapes(shape, mode):
    """At every L3 case the plan covers the output and K once, fits in
    shared memory and keeps at least two warps a SM in flight."""
    batch, m, n, k = shape
    plan = dots._plan_nt(batch, m, n, k, mode)
    _check_cover(plan, batch, m, n, k)
    assert plan["smem"] <= SMEM_MAX
    assert plan["warps"] >= 2 * SMS
    assert plan["path"] == ("fma" if mode == "f32" else
                            "wgmma" if n >= 64 else "mma")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", PARITY_SHAPES)
def test_plan_nt_at_parity_shapes(shape, mode):
    """lab_parity's shapes, edges included: the output and K covered once,
    within shared memory; 2 x 132 warps where the shape has enough units
    and slices of the plan's finest depth, else the finest split there is
    (one warp a block, the shallowest slice)."""
    batch, m, k, n = shape
    plan = dots._plan_nt(batch, m, n, k, mode)
    _check_cover(plan, batch, m, n, k)
    assert plan["smem"] <= SMEM_MAX
    if plan["warps"] < 2 * SMS:
        finest = 12 if plan["path"] == "fma" else 16
        assert plan["wb"] == 1 and plan["kw"] == finest


def test_plan_nt_refuses_what_it_cannot_serve():
    for args in ((0, 16, 256, 1152, "f32"), (8, 0, 256, 1152, "f32"),
                 (8, 16, 256, 0, "bf16"), (8, 16, 256, 1152, "tf32")):
        with pytest.raises(ValueError):
            dots._plan_nt(*args)


def test_plan_nt_smem_formula():
    """The staged slices or the warps' partials, whichever is larger: the
    formula of csrc/tile_dot.cu::plan_smem."""
    assert dots._nt_smem("fma", 16, 64, 24, 1, "f32") == (16 + 64) * 24 * 4
    assert dots._nt_smem("fma", 16, 64, 12, 8, "f32") == 8 * 16 * 64 * 4
    assert dots._nt_smem("wgmma", 16, 64, 96, 1, "3pass") == \
        (16 + 64) * 96 * 2 * 2
    assert dots._nt_smem("mma", 16, 16, 32, 2, "bf16") == \
        2 * 16 * (64 + 8) * 2


def _rounded_terms(a, b, mode):
    if mode == "f32":
        return ((a, b),)
    ah, bh = dots._bf16(a), dots._bf16(b)
    if mode == "bf16":
        return ((ah, bh),)
    return ((ah, bh), (ah, dots._bf16(b - bh)), (dots._bf16(a - ah), bh))


def nt_model(a, b, reps, mode, plan):
    """The new kernel's order of sums: each slice of K (nt_slices) runs its
    reps, a fresh product a rep added to the slice's sum; then the slices
    are added in the kernel's order."""
    k = a.shape[2]
    out = torch.zeros((a.shape[0], a.shape[1], b.shape[1]))
    for ks in dots.nt_slices(plan, k):
        if not ks:
            continue
        idx = torch.tensor(ks)
        part = torch.zeros_like(out)
        for _ in range(reps):
            p = torch.zeros_like(out)
            for x, y in _rounded_terms(a[:, :, idx], b[:, :, idx], mode):
                p = p + torch.matmul(x, y.transpose(1, 2))
            part = part + p
        out = out + part
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [0, 1, 4])
def test_l3_order_of_sums_matches_plain(case, mode):
    """The plan's slicing at L3's shapes (two entries, 3 reps) lands on
    tile_dot_plain within TOL_DOT."""
    _, m, n, k = L3_SHAPES[case]
    batch = 2
    gen = torch.Generator().manual_seed(case)
    a, b = l3.make_case(m, n, k, batch, torch.float32, "cpu", gen)
    plan = dots._plan_nt(l3.NT, m, n, k, mode)
    got = nt_model(a, b, 3, mode, plan)
    ref = dots.tile_dot_plain(a, b, 3, mode, "nt")
    assert rel(got, ref) <= TOL_DOT


def test_nt_issued_flops_count_the_plan():
    useful, issued = dots.dot_flops(8, 16, 1152, 256, 4, "f32", "nt")
    assert issued == useful  # 16 x 64 units, K in whole slices
    useful, issued = dots.dot_flops(8, 16, 1152, 256, 4, "bf16", "nt")
    plan = dots._plan_nt(8, 16, 256, 1152, "bf16")
    assert issued == useful * plan["kb"] * plan["kw"] // 1152


def l1_chunked_model(mode, wins, parts, chunk):
    """The lab's body as csrc/lab_fused.cu orders it: the particles in
    chunks of ``chunk`` (the last one partial), each chunk's byz formed
    once for each of the four distinct (y, z) keys and shared by the
    components that use it, J summed over the chunks."""
    spec = l1.mode_spec(mode)
    linear = spec["band"] == "linear"
    x, y, z, ux0, uy0, uz0, wq = [p_[:, 0] for p_ in parts]
    nt, w, w2 = wins[0].shape
    p = x.shape[1]
    outs = [[] for _ in range(6)]
    jw = [torch.zeros((nt, w, w2)) for _ in range(3)]
    for p0 in range(0, p, chunk):
        sl = slice(p0, min(p, p0 + chunk))
        cpos = [v[:, sl] for v in (x, y, z)]
        X = [v * 0.1 for v in cpos]

        def axis(d, order, stag):
            return l1._band(X[d] - (0.5 if stag else 0.0), w, linear, order)

        byz = {}
        for (kx, ky, kz) in l1.KEYSETS:
            if (ky, kz) not in byz:
                byz[ky, kz] = l1._outer(axis(1, *ky), axis(2, *kz))
        assert len(byz) == 4
        e6 = []
        for (kx, ky, kz), win in zip(l1.KEYSETS, wins):
            h = l1._dot(win, byz[ky, kz], spec["gather"])
            e6.append((axis(0, *kx) * h).sum(dim=1))
        ex, ey, ez, bx, by, bz = e6
        qm = l1.Q_M
        ux = ux0[:, sl] + qm * ex
        uy = uy0[:, sl] + qm * ey
        uz = uz0[:, sl] + qm * ez
        tx, ty, tz = qm * bx, qm * by, qm * bz
        upx = ux + uy * tz - uz * ty
        upy = uy + uz * tx - ux * tz
        upz = uz + ux * ty - uy * tx
        s = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
        ux = ux + (upy * tz - upz * ty) * s + qm * ex
        uy = uy + (upz * tx - upx * tz) * s + qm * ey
        uz = uz + (upx * ty - upy * tx) * s + qm * ez
        gaminv = torch.rsqrt(1.0 + (ux * ux + uy * uy + uz * uz) * 1e-17)
        vel = (ux * gaminv, uy * gaminv, uz * gaminv)
        for d in range(3):
            outs[d].append(cpos[d] + vel[d] * 1e-12)
        for d, u in enumerate((ux, uy, uz)):
            outs[3 + d].append(u)
        sm, df, cs = [], [], []
        for d in range(3):
            nn = l1._band(X[d] + vel[d] * 1e-4, w, linear, 1)
            no = axis(d, 1, False)
            sm.append(nn + no)
            df.append(no - nn)
            cs.append(l1._scan(no - nn))
        for d, (ia, ib) in enumerate(l1.PAIRS):
            lhs = cs[d] * wq[:, None, sl]
            jw[d] = jw[d] + (
                l1._dot(0.25 * lhs, l1._outer(sm[ia], sm[ib]).transpose(1, 2),
                        spec["deposit"])
                + l1._dot((1.0 / 12.0) * lhs,
                          l1._outer(df[ia], df[ib]).transpose(1, 2),
                          spec["deposit"]))
    return [torch.cat(o, dim=1)[:, None, :] for o in outs], jw


@pytest.mark.parametrize("w,p", [(16, 320), (8, 192)])
@pytest.mark.parametrize("mode", ["full", "split3", "prec_xx"])
def test_l1_chunked_model_matches_plain(mode, w, p):
    """Chunks of lab_fused.cu's size (P a multiple of 64 but not of the
    chunk, so the last chunk is partial) land on lab_fused_plain within
    TOL_LAB_FUSED."""
    assert l1.CHUNK == 128
    wins, parts, _ = l1.inputs(mode, 2, w, p, seed=11)
    got = l1_chunked_model(mode, wins, parts, l1.CHUNK)
    ref = l1.lab_fused_plain(mode, wins, parts)
    for a, b in zip(got[0], ref[0]):
        assert rel(a, b) <= TOL_LAB_FUSED["particles"]
    tol_j = TOL_LAB_FUSED["j_bf16" if l1.mode_spec(mode)["deposit"] == "bf16"
                          else "j_f32"]
    for a, b in zip(got[1], ref[1]):
        assert rel(a, b) <= tol_j


def test_labs_ab_edits_apply_to_this_source():
    """Each ablation of labs_ab.py edits its source (csrc/lab_fused.cu,
    lab_widelane.cu, tile_dot.cu) at exactly one place (the parents' edits
    apply to the parents' sources, which are not in the repository), and
    the ablations that break the outputs are timing-only."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("labs_ab",
                                                  REPO / "labs_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    csrc = REPO / "warpx_tpu_torch" / "csrc"
    for stem, variants in (("lab_fused", ab.L1_VARIANTS),
                           ("lab_widelane", ab.L2_VARIANTS),
                           ("tile_dot", ab.L4_VARIANTS)):
        text = (csrc / f"{stem}.cu").read_text()
        for name, edits in variants.items():
            for old, _ in edits:
                assert text.count(old) == 1, name
    assert set(ab.TIMING_ONLY) >= {"nodep", "nomma", "nogather", "l2_nodep",
                                   "l2_nogather", "l2_gather_byz_free",
                                   "l2_dep_byz_free"}
    assert not set(ab.TIMING_ONLY) & {"l2_new", "l4_new", "l4_wait_per_rep"}
    assert math.prod(len(v) for v in (ab.L2_VARIANTS, ab.L4_VARIANTS)) > 0
