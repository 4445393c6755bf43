"""The Hopper labs L1 (``tools/kernel_lab.py``) and L2
(``tools/lab_widelane.py``): their plain PyTorch versions against the TPU
labs' Pallas kernels in interpret mode (CPU, float32).

The TPU labs are loaded from their files and run as they are, with
``pl.pallas_call`` patched to interpret mode.  Interpret mode computes every
dot in float32, whatever its precision; the TPU (and the port) round a
DEFAULT operand to bfloat16 and split a HIGH one into three bfloat16 passes.
So each port mode is held against the JAX mode that rounds at the same
points: 'full' and 'prec_dd' against JAX 'bf16' (explicit casts),
'prec_xx' against JAX 'full', 'empty' and 'nomxu' against themselves, at
TIGHT; a mode that rounds where interpret mode does not is held at a looser
bound, with its reason.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from warpx_tpu_torch.tools import kernel_lab, lab_widelane

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# float32 sums of the same exactly rounded terms in another order (torch's
# matmul and row sums against XLA's); 2.1e-7 measured
TIGHT = 1e-6
# modes whose operands the port splits into three bfloat16 passes where
# interpret mode keeps float32: the split keeps ~2^-16 of each operand
# (3.5e-6 measured)
HIGH_BOUND = 1e-4
# modes with a DEFAULT product that interpret mode computes in float32: one
# bfloat16 rounding per operand moves a product by up to 2^-8, and sums
# with cancellation move the largest output by a few 1e-3 (1.3e-3 measured)
BF16_BOUND = 1e-2
# 'novpu' at DEFAULT: its linear ramps are not bounded by 1 (up to W/4), so
# its gather sums cancel more and the rounding of byz moves the largest
# output further (1.6e-2 measured)
NOVPU_BOUND = 5e-2
W, P, NT = 8, 128, 2


def load_tpu_lab(name):
    spec = importlib.util.spec_from_file_location(
        f"tpu_lab_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


@pytest.fixture(scope="module")
def jax_l1(interpret):
    """The TPU lab's run(mode) at W = 8, P = 128, NT = 2: its inputs and
    its outputs as torch tensors, per JAX mode (cached)."""
    lab = load_tpu_lab("kernel_lab")
    lab.W, lab.P, lab.NT = W, P, NT
    captured = []
    lab.timeit = lambda fn, *args, **kw: captured.append((fn, args)) or 1.0
    cache = {}

    def get(mode):
        if mode not in cache:
            captured.clear()
            lab.run(mode)
            fn, args = captured[0]
            cache[mode] = (
                [torch.tensor(np.asarray(a)) for a in args],
                [torch.tensor(np.asarray(o)) for o in fn(*args)])
        return cache[mode]

    return get


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


# port mode -> (JAX mode, tolerance)
L1_CASES = {
    "empty": ("empty", TIGHT), "full": ("bf16", TIGHT),
    "bf16": ("bf16", TIGHT), "nomxu": ("nomxu", TIGHT),
    "prec_dd": ("bf16", TIGHT), "prec_xx": ("full", TIGHT),
    "novpu": ("novpu", NOVPU_BOUND), "split3": ("split3", BF16_BOUND),
    "prec_dh": ("full", BF16_BOUND), "prec_dx": ("full", BF16_BOUND),
    "prec_hd": ("full", BF16_BOUND), "prec_xd": ("full", BF16_BOUND),
    "prec_hh": ("full", HIGH_BOUND), "prec_hx": ("full", HIGH_BOUND),
    "prec_xh": ("full", HIGH_BOUND),
    "pk_full": ("pk_bf16", TIGHT), "pk_empty": ("pk_empty", TIGHT),
    "pk_nomxu": ("pk_nomxu", TIGHT), "pk_prec_xx": ("pk_full", TIGHT),
}


def test_l1_cases_cover_every_mode():
    assert set(kernel_lab.MODES) <= set(L1_CASES)
    for mode in L1_CASES:
        kernel_lab.mode_spec(mode)
    with pytest.raises(ValueError):
        kernel_lab.mode_spec("prec_qq")


@pytest.mark.parametrize("mode", sorted(L1_CASES))
def test_l1_plain_matches_tpu_lab(mode, jax_l1):
    jmode, tol = L1_CASES[mode]
    args, ref = jax_l1(jmode)
    if mode.startswith("pk_"):
        got = kernel_lab.lab_fused_plain(mode, args[0], args[1], packed=True)
        got = list(got)
    else:
        outs, jw = kernel_lab.lab_fused_plain(mode, tuple(args[:6]),
                                              tuple(args[6:]))
        got = list(outs) + list(jw)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert rel(a, b) <= tol, (mode, jmode, rel(a, b))


def test_l1_limit_sees_bf16_operands():
    """chip_smoke.py holds L1 at its own shapes to 1e-4 of the largest
    output (TOL_LABS["L1"]); bfloat16 operands ('full') move some output
    by more than ten times that from float32 ('prec_xx'), so a kernel
    that lost precision fails there."""
    wins, parts, _ = kernel_lab.inputs("full", 2, 16, 256)
    lo = kernel_lab.lab_fused_plain("full", wins, parts)
    hi = kernel_lab.lab_fused_plain("prec_xx", wins, parts)
    assert max(rel(a, b) for a, b in zip(list(lo[0]) + list(lo[1]),
                                         list(hi[0]) + list(hi[1]))) > 1e-3


def test_l1_inputs_are_the_tpu_labs(jax_l1):
    args, _ = jax_l1("bf16")
    wins, parts, packed = kernel_lab.inputs("bf16", NT, W, P)
    assert not packed
    for a, b in zip(list(wins) + list(parts), args):
        assert torch.equal(a, b)
    args, _ = jax_l1("pk_bf16")
    wins, parts, packed = kernel_lab.inputs("pk_full", NT, W, P)
    assert packed and torch.equal(wins, args[0]) and torch.equal(parts,
                                                                 args[1])


@pytest.mark.parametrize("mode", ["batched", "wide"])
@pytest.mark.parametrize("dep", ["bf16", "f32"])
def test_l2_plain_matches_tpu_lab(mode, dep, interpret):
    """Random inputs (lhs bfloat16-valued, so the TPU's rounding of it at
    DEFAULT is exact and interpret mode's float32 agrees) through the TPU
    lab's make() at NT = 2, P = 256 and through the port."""
    lab = load_tpu_lab("lab_widelane")
    lab.NT, lab.P, lab.S = 2, 256, 2
    prec = None if dep == "bf16" else lab.HI
    fn, _ = lab.make(mode, prec, lab.jnp.bfloat16)
    _, args = lab_widelane.make(mode, dep, "cpu", nt=2, w=16, p=256, seed=3)
    ref = fn(*[lab.jnp.asarray(a.numpy()) for a in args])
    got = lab_widelane.widelane_plain(*args, mode == "batched", dep)
    for a, b in zip(got, ref):
        b = torch.tensor(np.asarray(b))
        assert a.shape == b.shape
        assert rel(a, b) <= TIGHT, rel(a, b)


def test_l2_layouts_agree():
    """The two layouts compute the same function: the batched inputs
    rearranged into the wide layout give the same outputs."""
    _, bargs = lab_widelane.make("batched", "bf16", "cpu", nt=2, w=8, p=256)
    win, ay, az, lhs = bargs
    wide = [x.permute(1, 0, 2).reshape(1, 8, 256) for x in (ay, az, lhs)]
    ob, jb = lab_widelane.widelane_plain(win, ay, az, lhs, True, "bf16")
    ow, jw = lab_widelane.widelane_plain(win, *wide, False, "bf16")
    assert torch.allclose(ob.reshape(2, 256), ow.reshape(2, 256), rtol=1e-6,
                          atol=1e-6 * ob.abs().max().item())
    assert rel(jb, jw) <= TIGHT


def test_wrappers_take_the_plain_version_on_cpu():
    wins, parts, packed = kernel_lab.inputs("split3", 2, 8, 128)
    before = kernel_lab.lab_fused.launches
    got = kernel_lab.lab_fused("split3", wins, parts, packed)
    ref = kernel_lab.lab_fused_plain("split3", wins, parts, packed)
    for a, b in zip(list(got[0]) + list(got[1]), list(ref[0]) + list(ref[1])):
        assert torch.equal(a, b)
    fn, args = lab_widelane.make("wide", "f32", "cpu", nt=2, w=8, p=128)
    for a, b in zip(fn(*args),
                    lab_widelane.widelane_plain(*args, False, "f32")):
        assert torch.equal(a, b)
    assert kernel_lab.lab_fused.launches == before
    meta = [w.to("meta") for w in wins]
    with pytest.raises(ValueError, match="unsupported device"):
        kernel_lab.lab_fused("full", meta, parts)
    with pytest.raises(ValueError, match="unsupported device"):
        lab_widelane.widelane(*[a.to("meta") for a in args], False, "f32")


def test_l1_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(kernel_lab, "W", 8)
    monkeypatch.setattr(kernel_lab, "P", 128)
    monkeypatch.setattr(kernel_lab, "NT", 2)
    out = kernel_lab.main(["--device", "cpu", "full", "pk_nomxu", "empty"])
    assert [c["mode"] for c in out["cases"]] == ["full", "pk_nomxu", "empty"]
    for case in out["cases"]:
        assert case["max_abs_err"] == 0.0 and "ms" not in case
        assert case["cpu_ms"] > 0
    assert out["device"] == "cpu"
    assert '"lab": "L1 kernel_lab"' in capsys.readouterr().out


def test_l2_cli_on_cpu(capsys):
    out = lab_widelane.main(["--device", "cpu", "--nt", "2", "--w", "8",
                             "--p", "128"])
    assert len(out["cases"]) == 4
    assert all(c["max_abs_err"] == 0.0 for c in out["cases"])
    assert "L2 lab_widelane" in capsys.readouterr().out


def test_lab_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        kernel_lab.main(["full"])
