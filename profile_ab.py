#!/usr/bin/env python3
"""chip_smoke.py's profiler settings against each other on the card.

    python3 profile_ab.py

Builds uniform-128-mr (``chip_smoke.main_mr_cfg``, per particle, float32),
warms it up, then profiles one step at a time under torch.profiler with the
host's operators and the device traced (CPU + CUDA activities) and with the
device alone (CUDA), in turns (both, cuda, cuda, both, both, cuda): for
each, the seconds the profiled call took (the step and reading its trace
back), the step's wall ms, the device ms summed over the kernels, the busy
share and the kernel count, one line each.  Needs one GPU; launches none of
the port's kernels (the MR path is per particle).
"""
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as c
import warpx_tpu_torch


def profiled_step(sim, acts):
    """One step under the profiler with ``acts``: its numbers."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=acts, acc_events=True) as p:
        t0 = time.perf_counter()
        sim.evolve(1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, n = 0.0, 0
    for evt in p.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        dev += us / 1e3
        n += evt.count
    return {"call_s": time.perf_counter() - t, "wall_ms": wall,
            "device_ms": dev, "busy": dev / wall, "kernels": n}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_ab: no CUDA device", file=sys.stderr)
        return 1
    print(c.nvidia_smi_line(), flush=True)
    sim = warpx_tpu_torch.Simulation(c.main_mr_cfg(False, steps=40),
                                     dtype=torch.float32, device="cuda")
    sim.init()
    sim.evolve(2)
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda = [ProfilerActivity.CUDA]
    for name, acts in (("both", both), ("cuda", cuda), ("cuda", cuda),
                       ("both", both), ("both", both), ("cuda", cuda)):
        print(name, profiled_step(sim, acts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
