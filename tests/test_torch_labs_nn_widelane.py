"""The redesigned Hopper labs L4 (``csrc/tile_dot.cu`` in layout NN) and L2
(``csrc/lab_widelane.cu``), on the CPU: the plan of layout NN
(``bench_dot_shapes._plan_nt`` with ``layout="nn"``), plain models of the
orders of sums the new kernels take, and the operations they issue.

The kernels themselves run only on the card (``chip_smoke.py``'s
``lab_parity`` and ``labs`` phases, ``labs_ab.py``).  Here each new order of
sums is modelled in PyTorch and held to the plain versions within the
limits chip_smoke.py holds the kernels to (TOL_DOT, TOL_WIDELANE).
"""

import pytest
import torch

from warpx_tpu_torch.tools import bench_dot_shapes as dots
from warpx_tpu_torch.tools import lab_widelane as l2

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

# chip_smoke.py's limits, relative to the largest output
TOL_DOT = 1e-4
TOL_WIDELANE = 1e-5
SMEM_MAX = 227 * 1024
MODES = ("f32", "bf16", "3pass")
# L4's cases (batch, m, n, k), then lab_parity's NN shapes (its shapes, the
# edge shapes of both layouts and NN's own)
L4_SHAPES = [(dots.NT, m, n, k) for m, k, n in dots.CASES]
PARITY_SHAPES = [(3, 8, 40, 64), (2, 16, 256, 1152), (2, 40, 64, 256),
                 (2, 8, 200, 1000), (2, 40, 72, 1000), (3, 16, 130, 52),
                 (5, 16, 16, 264), (2, 72, 200, 1000), (2, 128, 256, 2048),
                 (8, 64, 2048, 256)]
CHUNK = 64  # csrc/lab_widelane.cu::kChunk


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", L4_SHAPES + PARITY_SHAPES)
def test_plan_nn_fits_and_covers(shape, mode):
    """Every (entry, row, column) in exactly one unit, every k in exactly
    one slice in nt_slices order, within shared memory; the orientation
    follows m on the tensor cores."""
    batch, m, n, k = shape
    plan = dots._plan_nt(batch, m, n, k, mode, "nn")
    assert plan["smem"] <= SMEM_MAX
    assert plan["units"] == batch * plan["mg"] * plan["ng"]
    assert plan["mg"] * plan["tm"] >= m > (plan["mg"] - 1) * plan["tm"]
    assert plan["ng"] * plan["tn"] >= n > (plan["ng"] - 1) * plan["tn"]
    slices = dots.nt_slices(plan, k)
    ks = [kk for sl in slices for kk in sl]
    assert sorted(ks) == list(range(k))
    assert len(slices) == plan["kb"] * plan["wb"] * plan["tk"]
    if mode == "f32":
        assert plan["path"] == "fma"
    else:  # contiguous slices, in order
        assert ks == list(range(k))
        assert plan["path"] == ("wgmma" if m < 64 else "wgmma_n")
        assert plan["kw"] % 16 == 0 and plan["tk"] == 1
        assert plan["tn" if m >= 64 else "tm"] in dots.WGMMA_N


def test_plan_nn_at_l4_cases():
    """At L4's cases no block stages all of K = 2048, M = 8 needs no padded
    rows, and every case fills the 132 SMs with at least 128 warpgroups."""
    for batch, m, n, k in L4_SHAPES:
        plan = dots._plan_nt(batch, m, n, k, "bf16", "nn")
        assert plan["wb"] * plan["kw"] < 2048
        assert plan["blocks"] * plan["wb"] >= 128
        if m == 8:
            assert plan["tm"] == 8
    p128 = dots._plan_nt(dots.NT, 128, 256, 2048, "bf16", "nn")
    assert p128["kb"] > 1


def test_plan_nn_refuses_what_it_cannot_serve():
    for args in ((0, 16, 2048, 256, "bf16"), (8, 16, 0, 256, "bf16"),
                 (8, 16, 2048, 0, "f32"), (8, 16, 2048, 256, "tf32")):
        with pytest.raises(ValueError):
            dots._plan_nt(*args, "nn")
    with pytest.raises(ValueError):
        dots._plan_nt(8, 16, 2048, 256, "bf16", "tn")


def _terms(a, b, mode):
    if mode == "f32":
        return ((a, b),)
    ah, bh = dots._bf16(a), dots._bf16(b)
    if mode == "bf16":
        return ((ah, bh),)
    return ((ah, bh), (ah, dots._bf16(b - bh)), (dots._bf16(a - ah), bh))


def nn_model(a, b, reps, mode, plan):
    """The NN kernel's order of sums: each slice of K (nt_slices) runs its
    reps, a fresh product a rep added to the slice's sum in rep order (two
    accumulators alternate, the sums do not); then the slices are added in
    the kernel's order."""
    k = a.shape[2]
    out = torch.zeros((a.shape[0], a.shape[1], b.shape[2]))
    for ks in dots.nt_slices(plan, k):
        if not ks:
            continue
        idx = torch.tensor(ks)
        part = torch.zeros_like(out)
        for _ in range(reps):
            p = torch.zeros_like(out)
            for x, y in _terms(a[:, :, idx], b[:, idx, :], mode):
                p = p + torch.matmul(x, y)
            part = part + p
        out = out + part
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,reps", [
    ((2, 16, 256, 1152), 3), ((2, 72, 200, 1000), 3),
    ((2, 128, 256, 2048), 2), ((3, 16, 130, 52), 1), ((3, 16, 130, 52), 4),
    ((2, 8, 200, 1000), 3)])
def test_nn_order_of_sums_matches_plain(shape, reps, mode):
    """The plan's slicing lands on tile_dot_plain within TOL_DOT."""
    batch, m, n, k = shape
    gen = torch.Generator().manual_seed(m + k)
    a = torch.rand((batch, m, k), generator=gen) - 0.5
    b = torch.rand((batch, k, n), generator=gen) - 0.5
    plan = dots._plan_nt(batch, m, n, k, mode, "nn")
    got = nn_model(a, b, reps, mode, plan)
    ref = dots.tile_dot_plain(a, b, reps, mode, "nn")
    assert rel(got, ref) <= TOL_DOT


# plans the planner does not make, which chip_smoke.py's lab_parity
# launches on the card (the kernels serve either orientation in either
# layout): (layout, (batch, m, n, k), path, kw, wb, kb, tc)
FORCED_PLANS = [("nn", (2, 128, 200, 256), "wgmma", 64, 2, 2, 0),
                ("nt", (2, 72, 130, 200), "wgmma_n", 64, 1, 4, 8)]


@pytest.mark.parametrize("mode", ("bf16", "3pass"))
@pytest.mark.parametrize("layout,shape,path,kw,wb,kb,tc", FORCED_PLANS)
def test_forced_plans_fit_and_match_plain(layout, shape, path, kw, wb, kb,
                                          tc, mode):
    """Each forced plan covers its output and K, fits in shared memory, has
    a kernel instance at its wgmma N (NN on out^T at m = 128: N = 128), and
    its order of sums lands on tile_dot_plain within TOL_DOT."""
    batch, m, n, k = shape
    tm, tn = dots._nt_tile(path, m, tc=tc)
    assert (tm if path == "wgmma" else tn) in dots.WGMMA_N
    assert kb * wb * kw >= k
    assert dots._nt_smem(path, tm, tn, kw, wb, mode) <= SMEM_MAX
    plan = dict(path=path, kw=kw, wb=wb, kb=kb, tk=1)
    gen = torch.Generator().manual_seed(m + k)
    a = torch.rand((batch, m, k), generator=gen) - 0.5
    b = torch.rand((batch, k, n), generator=gen) - 0.5
    got = nn_model(a, b, 3, mode, plan)
    ref = (dots.tile_dot_plain(a, b, 3, mode, "nn") if layout == "nn" else
           dots.tile_dot_plain(a, b.transpose(1, 2).contiguous(), 3, mode,
                               "nt"))
    assert rel(got, ref) <= TOL_DOT


@pytest.mark.parametrize("mode", ("bf16", "3pass"))
def test_nn_issued_flops_count_the_plan(mode):
    """dot_flops(layout='nn') counts the plan's units over its slices: at
    L4's cases the tensor cores issue only useful work (M = 8 no longer
    pads to 16); at (2, 72, 200, 1000) the units and the k16 steps pad."""
    passes = 3 if mode == "3pass" else 1
    for batch, m, n, k in L4_SHAPES:
        useful, issued = dots.dot_flops(batch, m, k, n, 4, mode, "nn")
        assert issued == passes * useful
    useful, issued = dots.dot_flops(2, 72, 1000, 200, 4, mode, "nn")
    plan = dots._plan_nt(2, 72, 200, 1000, mode, "nn")
    kpad = plan["kb"] * plan["wb"] * plan["kw"]
    assert kpad >= 1000
    assert issued == passes * 2 * 2 * (2 * 64) * (4 * 64) * kpad * 4
    assert useful == 2 * 2 * 72 * 1000 * 200 * 4


def widelane_model(win, ay, az, lhs, batched, dep):
    """lab_widelane.cu's order of sums: chunks of 64 particles; per chunk
    each gather group's h = bf16(win) . byz (float32 sums), a lane's row
    sum over its four window rows b = 8 j + 2 t + e by FMA, its quad's sums
    pairwise ((t0 + t1) + (t2 + t3)), the groups added in order; the
    deposit summed chunk by chunk (the 'f32' deposit particle by particle
    by FMA), its three components added as (jd + jd) + jd."""
    nt, rows, w2 = win.shape
    w = rows // 2
    A, Z = l2._wide(ay, batched), l2._wide(az, batched)
    L = l2._wide(lhs, batched)
    p = A.shape[1]
    L = l2._bf16(L) if dep == "bf16" else L
    winb = l2._bf16(win)
    out = torch.empty((nt, p))
    jd = torch.zeros((nt, w, w2))
    for c0 in range(0, p, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        byz = l2._bf16((A[:, None, sl] * Z[None, :, sl]).reshape(w2, -1))
        racc = None
        for g in range(4):
            h = torch.matmul(winb[:, :rows if g < 2 else w], byz)
            lanes = []
            for t in range(4):
                r = torch.zeros((nt, CHUNK))
                for j in range(w // 8):
                    for e in range(2):
                        b = 8 * j + 2 * t + e
                        r = torch.addcmul(r, A[b, sl], h[:, b])
                lanes.append(r)
            r = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
            racc = r if racc is None else racc + r
        out[:, sl] = racc
        if dep == "bf16":
            jd = jd + torch.matmul(L[:, sl], byz.T)
        else:
            for j in range(CHUNK):
                jd = torch.addcmul(jd, L[:, c0 + j, None], byz[None, :, j])
    jw = (jd + jd) + jd
    shape = (nt, p // l2.LANES, l2.LANES) if batched else (nt, 1, p)
    return out.reshape(shape), jw


@pytest.mark.parametrize("dep", ("bf16", "f32"))
@pytest.mark.parametrize("mode,w,p", [("batched", 16, 256), ("wide", 16, 320),
                                      ("batched", 8, 384), ("wide", 8, 192)])
def test_widelane_order_of_sums_matches_plain(mode, w, p, dep):
    """The chunked order (P an odd number of chunks in the wide cases) lands
    on widelane_plain within TOL_WIDELANE."""
    _, args = l2.make(mode, dep, "cpu", nt=2, w=w, p=p, seed=w + p)
    got = widelane_model(*args, mode == "batched", dep)
    ref = l2.widelane_plain(*args, mode == "batched", dep)
    for x, y in zip(got, ref):
        assert rel(x, y) <= TOL_WIDELANE


def test_widelane_flops_are_what_the_kernel_issues():
    """lab_flops counts the four gather groups at rows 2W, 2W, W, W (rows
    W..2W of groups 0-1 computed, not read) and the three deposit
    components, as csrc/lab_widelane.cu issues them: per chunk of 64
    particles, W^2 / 16 k16 steps of m64n{2W}k16 x 2 and m64n{W}k16 x 2,
    and W^2 / 64 m tiles x 4 k16 steps x 3 m64n{W}k16."""
    for w in (8, 16):
        nt, p = 3, 5 * CHUNK
        chunks = p // CHUNK
        gather = chunks * (w * w // 16) * 2 * 64 * 16 * (2 * (2 * w) + 2 * w)
        deposit = chunks * (w * w // 64) * 4 * 3 * 2 * 64 * w * 16
        flops = l2.lab_flops(nt, w, p, "bf16")
        assert flops["bf16"] == nt * (gather + deposit)
        assert l2.lab_flops(nt, w, p, "f32")["fp32"] - flops["fp32"] == \
            nt * deposit
