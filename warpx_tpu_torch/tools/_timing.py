"""Helpers the Hopper labs share: timing, bounds, the card's line, results.

Times on the card come from CUDA events: one warm-up call, then the best of
three runs of ``n`` calls made back to back, divided by ``n``.  A CPU run
(``--device cpu``) times the plain versions on the host's clock and prints
them as ``cpu_ms``: no number of a CPU run is a device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .. import build

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(nbytes, flops, unit="fp32"):
    """The least time the card could take: the larger of ``nbytes`` over
    the HBM rate and the operations over their unit's peak.  ``flops`` is a
    count at ``unit`` ('bf16' tensor cores or 'fp32'), or a dict
    {unit: count} whose times add.  Returns (ms, 'bytes' or
    'operations')."""
    if not isinstance(flops, dict):
        flops = {unit: flops}
    t_ops = sum(f / PEAK[u] for u, f in flops.items()) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def time_ms(fn, n, device):
    """Milliseconds per call of ``fn()``: warm-up, then the best of three
    runs of ``n`` calls (CUDA events on the card, the host clock on the
    CPU)."""
    fn()
    best = float("inf")
    for _ in range(3):
        if torch.device(device).type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b) / n
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / n
        best = min(best, ms)
    return best


def smi_line():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_launch(lib_name, fn_name, err, what):
    """Raise if a lab kernel's C function returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{build.cuda_error(lib_name, fn_name, err)}")


def check_tensor(name, t, dtype, device, shape=None):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape`` where given)."""
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def lab_args(doc, argv=None, extra=None):
    """The labs' command line: ``--device`` (default cuda) and the lab's
    own arguments (``extra(parser)``)."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    if extra is not None:
        extra(p)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for the "
                         "plain versions")
    return args


def result(lab, device, ms, plain_ms, rates=None, **kw):
    """One lab result as a dict: times are ``ms``/``plain_ms`` on the card,
    with ``rates`` (rates and roofline shares, device metrics) beside them;
    on the CPU they are ``cpu_ms``/``plain_cpu_ms``, every other time
    ``*_cpu_ms`` (``bound_ms`` stays: it is the card's bound), and ``rates``
    is dropped."""
    if torch.device(device).type == "cuda":
        return {"lab": lab, "ms": ms, "plain_ms": plain_ms, **(rates or {}),
                **kw}
    kw = {(k[:-3] + "_cpu_ms" if k.endswith("_ms") and k != "bound_ms"
           else k): v for k, v in kw.items()}
    return {"lab": lab, "cpu_ms": ms, "plain_cpu_ms": plain_ms, **kw}


def summary(lab, device, **kw):
    """A lab's closing line: its results with the device, and on the card
    the card's name and power limit."""
    if torch.device(device).type == "cuda":
        return {"lab": lab, **kw, "device": torch.cuda.get_device_name(0),
                "nvidia_smi": smi_line()}
    return {"lab": lab, **kw, "device": "cpu"}


def emit(res):
    print(json.dumps(res), flush=True)
