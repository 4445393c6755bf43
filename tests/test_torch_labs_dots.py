"""The Hopper labs L3 (``tools/bench_deposit_prec.py``), L4
(``tools/bench_dot_shapes.py``) and L5 (``tools/profile_rebin_lwfa.py``):
their plain PyTorch versions against the TPU labs' Pallas kernels in
interpret mode (CPU).

The TPU labs are loaded from their files and run as they are, with
``pl.pallas_call`` patched to interpret mode.  Interpret mode computes a
float32 dot in float32 whatever its precision, where the TPU (and the port)
round both operands to bfloat16 at DEFAULT: those cases take operands that
are bfloat16 values already, so that both roundings are exact.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from warpx_tpu_torch.tools import (bench_deposit_prec, bench_dot_shapes,
                                   profile_rebin_lwfa)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# float32 sums of reps x K exact products in another order (torch's matmul
# against XLA's dot): K 2^-24 bounds it at K = 1152 (7e-5), random rounding
# keeps it near sqrt(K) 2^-24
TOL = 1e-5
REPS = 3


def load_tpu_lab(name):
    spec = importlib.util.spec_from_file_location(
        f"tpu_lab_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def rel(a, b):
    b = torch.as_tensor(np.array(b))
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def operands(shape_a, shape_b, seed, bf16_values):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.random(shape_a), dtype=torch.float32)
    b = torch.tensor(rng.random(shape_b), dtype=torch.float32)
    if bf16_values:
        a, b = (x.to(torch.bfloat16).float() for x in (a, b))
    return a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (8, 32, 64)])
def test_l4_plain_matches_tpu_lab(dtype, m, k, n, interpret):
    """bench_dot_shapes.make: the float32 case runs at DEFAULT (operands of
    bfloat16 values), the bfloat16 case on bfloat16 operands: both are the
    port's mode 'bf16', layout 'nn'."""
    lab = load_tpu_lab("bench_dot_shapes")
    a, b = operands((2, m, k), (2, k, n), m, bf16_values=True)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = lab.make(m, k, n, 2, jdt, REPS)(jnp.asarray(a.numpy(), jdt),
                                          jnp.asarray(b.numpy(), jdt))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = bench_dot_shapes.tile_dot_plain(a.to(tdt), b.to(tdt), REPS, "bf16",
                                          "nn")
    assert got.shape == (2, m, n) and rel(got, ref) <= TOL


# label -> (the TPU lab's dtype, precision, three_pass; the port's mode;
# whether the operands must be bfloat16 values for interpret mode to agree)
L3_MODES = {
    "f32/HIGHEST": ("float32", "HIGHEST", False, "f32", False),
    "f32/DEFAULT": ("float32", "DEFAULT", False, "bf16", True),
    "3-pass": ("float32", "DEFAULT", True, "3pass", False),
    "bf16-cast": ("bfloat16", "DEFAULT", False, "bf16", False),
}


@pytest.mark.parametrize("label", sorted(L3_MODES))
def test_l3_plain_matches_tpu_lab(label, interpret):
    """bench_deposit_prec.make: a (m, K) . b (n, K)^T, layout 'nt'."""
    lab = load_tpu_lab("bench_deposit_prec")
    jdt, prec, three, mode, bf16_values = L3_MODES[label]
    m, k, n = 16, 64, 32
    a, b = operands((2, m, k), (2, n, k), 7, bf16_values)
    fn = lab.make(m, k, n, getattr(jnp, jdt), lab._PREC[prec], REPS, nt=2,
                  three_pass=three)
    ref = fn(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    got = bench_dot_shapes.tile_dot_plain(a, b, REPS, mode, "nt")
    assert rel(got, ref) <= TOL, rel(got, ref)


def _one_step(spec):
    nd = len(spec.block_shape)
    return pl.BlockSpec(spec.block_shape, lambda i: (i,) + (0,) * (nd - 1),
                        memory_space=spec.memory_space)


@pytest.fixture(scope="module")
def l3_main_kernels():
    """The 2D kernels kb and ks that the TPU lab's main() builds, each run
    once in interpret mode on one grid step of random inputs as main()
    builds it (the kernels read main's loop variables, so they run then);
    every other call returns zeros instead of running.  Returns [(name,
    input, output)] in main's order."""
    lab = load_tpu_lab("bench_deposit_prec")
    real = pl.pallas_call
    runs = []

    def record(kernel, **kw):
        shape = kw["out_shape"]
        if kernel.__name__ in ("kb", "ks"):
            gs = kw["grid_spec"]
            block = gs.in_specs[0].block_shape
            out_block = gs.out_specs.block_shape
            call = real(kernel, grid_spec=pl.GridSpec(
                grid=(1,), in_specs=[_one_step(s) for s in gs.in_specs],
                out_specs=_one_step(gs.out_specs)),
                out_shape=jax.ShapeDtypeStruct(out_block, jnp.float32),
                interpret=True)
            rng = np.random.default_rng(len(runs))
            a = rng.random(block).astype(np.float32)
            runs.append((kernel.__name__, torch.from_numpy(a),
                         torch.from_numpy(np.asarray(call(a, a)))))
        return lambda *a: jnp.zeros(shape.shape, shape.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", record)
        lab.main()
    assert [r[0] for r in runs] == ["kb", "ks", "kb", "ks"]
    return runs


@pytest.mark.parametrize("which", range(4))
def test_l3_2d_kernels_match(which, l3_main_kernels):
    """main()'s kb (batch of four (16, K).(16, K)^T) and ks (the stacked
    (64, K).(64, K)^T), float32/HIGHEST and then bfloat16, on one grid
    step (their K = 1152 and reps = 400 are main's)."""
    name, a, ref = l3_main_kernels[which]
    mode = "f32" if which < 2 else "bf16"
    if name == "kb":  # (1, 4, w, K): four products
        x = a.reshape(4, a.shape[2], a.shape[3])
        got = bench_dot_shapes.tile_dot_plain(x, x, 400, mode, "nt")
        got = got.reshape(ref.shape)
    else:  # (1, 4w, K)
        got = bench_dot_shapes.tile_dot_plain(a, a, 400, mode, "nt")
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL, rel(got, ref)


class _Stop(Exception):
    pass


def test_l5_slot_copy_matches_tpu_lab(monkeypatch):
    """variants3's Pallas kernel at its own shapes (cap 4,194,304, 8192
    tiles of 512 slots), captured at its first call and stopped there: its
    unmasked slot copy equals the port's with every count at p_max, and the
    port's masked copy equals the lab's v_base formula on those offsets."""
    lab = load_tpu_lab("profile_rebin_lwfa")
    real = pl.pallas_call
    seen = {}

    def capture(kernel, **kw):
        call = real(kernel, interpret=True, **kw)

        def run(offsets, psp):
            seen["args"] = (np.asarray(offsets), np.asarray(psp))
            seen["out"] = np.asarray(call(offsets, psp))
            raise _Stop

        return run

    monkeypatch.setattr(pl, "pallas_call", capture)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    with pytest.raises(_Stop):
        lab.variants3()
    offsets, psp = (torch.from_numpy(x) for x in seen["args"])
    pmax = 512
    assert offsets.shape == (8192,) and psp.shape == (7, 4_194_304 + pmax)
    full = torch.full_like(offsets, pmax)
    got = profile_rebin_lwfa.slot_copy_plain(psp, offsets, full, pmax)
    assert torch.equal(got, torch.from_numpy(seen["out"]))
    # the mask: counts from the offsets, as v_pallas takes them
    cap = 4_194_304
    counts = torch.diff(torch.cat([offsets, torch.tensor([cap],
                                                         dtype=torch.int32)]))
    masked = profile_rebin_lwfa.slot_copy_plain(psp, offsets,
                                                counts.to(torch.int32), pmax)
    slot = torch.arange(pmax).repeat(8192)
    valid = slot < counts.repeat_interleave(pmax)
    assert torch.equal(masked, torch.where(valid[None], got, 0.0))


@pytest.mark.parametrize("cap", [30_000, 30_001])
def test_l5_v_pallas_equals_v_base(cap):
    """v_pallas equals v_base; its padded payload has 16-byte rows (a
    length that is a multiple of 4 and at least cap + pmax) whatever cap."""
    ps, ks = profile_rebin_lwfa.inputs(cap, 64, 2, "cpu")
    a = profile_rebin_lwfa.v_base(ps, ks, 64, 512)
    b = profile_rebin_lwfa.v_pallas(ps, ks, 64, 512)
    assert torch.equal(a, b)
    offsets, counts = profile_rebin_lwfa.prelude(ks, 64)
    assert int(counts.sum()) == cap and int(counts.max()) > 0
    psp = profile_rebin_lwfa.pad(ps, 512)
    assert psp.shape[1] % 4 == 0 and cap + 512 <= psp.shape[1] < cap + 516
    assert torch.equal(psp[:, :cap], ps) and not psp[:, cap:].any()


def test_l5_slot_copy_edges():
    """Offsets past the row's end read zeros; counts above p_max keep
    p_max slots; an empty tile is all zeros."""
    psp = torch.arange(2 * 40, dtype=torch.float32).reshape(2, 40)
    offsets = torch.tensor([0, 36, 39, 5], dtype=torch.int32)
    counts = torch.tensor([3, 8, 8, 0], dtype=torch.int32)
    out = profile_rebin_lwfa.slot_copy(psp, offsets, counts, 4)
    assert out.shape == (2, 16)
    assert out[0].tolist() == [0, 1, 2, 0, 36, 37, 38, 39, 39, 0, 0, 0,
                               0, 0, 0, 0]
    assert out[1, :3].tolist() == [40, 41, 42]


def test_wrappers_take_the_plain_version_on_cpu():
    a, b = operands((2, 8, 32), (2, 24, 32), 1, False)
    before = bench_dot_shapes.tile_dot.launches
    for mode in bench_dot_shapes.MODES:
        assert torch.equal(bench_dot_shapes.tile_dot(a, b, 2, mode, "nt"),
                           bench_dot_shapes.tile_dot_plain(a, b, 2, mode,
                                                           "nt"))
    assert bench_dot_shapes.tile_dot.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        bench_dot_shapes.tile_dot(a.to("meta"), b.to("meta"), 2, "f32", "nt")
    with pytest.raises(ValueError, match="unknown mode"):
        bench_dot_shapes.tile_dot_plain(a, b, 2, "tf32", "nt")
    ps = torch.zeros((7, 100))
    with pytest.raises(ValueError, match="unsupported device"):
        profile_rebin_lwfa.slot_copy(ps.to("meta"), torch.zeros(
            4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), 8)


@pytest.mark.parametrize("lab", ["L3", "L4"])
def test_lab_limits_see_bf16_operands(lab):
    """chip_smoke.py holds L3 at its own shapes to 1e-4 and L4 to 1e-3 of
    the largest output (TOL_LABS); on the labs' zero-mean operands,
    bfloat16 rounding moves the products by more than 1e-3 from float32,
    so a kernel that lost precision fails there."""
    gen = torch.Generator().manual_seed(0)
    if lab == "L3":
        a, b = bench_deposit_prec.make_case(16, 256, 1152, 2, torch.float32,
                                            "cpu", gen)
        layout = "nt"
    else:
        a = torch.rand((2, 8, 256), generator=gen) - 0.5
        b = torch.rand((2, 256, 2048), generator=gen) - 0.5
        layout = "nn"
    lo = bench_dot_shapes.tile_dot_plain(a, b, 1, "bf16", layout)
    hi = bench_dot_shapes.tile_dot_plain(a, b, 1, "f32", layout)
    assert rel(lo, hi) > 1e-3


def test_dot_flops_count_the_padding():
    # layout NN at M = 40: wgmma's N, the rows of a, is rounded up to 64
    useful, issued = bench_dot_shapes.dot_flops(8, 40, 256, 2048, 4, "bf16")
    assert 40 * issued == 64 * useful
    useful, issued = bench_dot_shapes.dot_flops(8, 16, 64, 64, 4, "3pass")
    assert issued == 3 * useful


def test_l4_l3_l5_cli_on_cpu(capsys):
    out = bench_dot_shapes.main(["--device", "cpu", "--reps-div", "4000",
                                 "--k-scale", "8"])
    assert len(out["cases"]) == 10 and out["device"] == "cpu"
    assert all(c["max_abs_err"] == 0.0 and "ms" not in c
               for c in out["cases"])
    out = bench_deposit_prec.main(["--device", "cpu", "--reps", "2", "--k",
                                   "64"])
    assert len(out["cases"]) == 20
    out = profile_rebin_lwfa.main(["--device", "cpu", "--cap", "20000",
                                   "--nt", "64", "--pmax", "512"])
    assert out["cases"][0]["max_abs_err"] == 0.0
    text = capsys.readouterr().out
    for lab in ("L4 bench_dot_shapes", "L3 bench_deposit_prec",
                "L5 profile_rebin_lwfa"):
        assert lab in text
