"""Runtime observability: warn manager, signal handling, step timing.

The counterpart of ``warpx_tpu.utils.observability`` (reference:
ablastr/warn_manager/WarnManager.H:86,227; ablastr/utils/SignalHandling.H:
43-53; the per-step timing print of WarpXEvolve.cpp:323-328):
  * ``WarnManager``: deduplicated, priority-tagged warnings printed as a
    summary at the end of the run;
  * ``SignalFlags``: named POSIX signals set break/checkpoint flags that the
    step loop reads once per step (WarpXEvolve.cpp:118, :457-462,
    :1248-1259);
  * ``StepTimer``: the per-step timing print.  On a CUDA device it records
    an event after each step and waits for it, so the printed times are the
    device's; ``Simulation`` makes one only when ``warpx.verbose`` asks, so
    a quiet run adds no wait a step.
"""

from __future__ import annotations

import signal as _signal
import sys
import time
from collections import OrderedDict

import torch

__all__ = ["WarnManager", "warn", "SignalFlags", "StepTimer"]


class WarnManager:
    """Collect warnings with priorities; dedupe; print a summary."""

    _GLOBAL: "WarnManager | None" = None

    def __init__(self):
        self._records: "OrderedDict[tuple, int]" = OrderedDict()

    @classmethod
    def instance(cls) -> "WarnManager":
        if cls._GLOBAL is None:
            cls._GLOBAL = cls()
        return cls._GLOBAL

    def record(self, topic: str, msg: str, priority: str = "medium"):
        key = (topic, msg, priority)
        self._records[key] = self._records.get(key, 0) + 1

    @property
    def empty(self) -> bool:
        return not self._records

    def summary(self) -> str:
        if not self._records:
            return "No recorded warnings.\n"
        lines = ["", "*" * 21 + " WARNINGS " + "*" * 21]
        for (topic, msg, priority), count in self._records.items():
            tag = (f"[{priority}][raised {count}x]" if count > 1
                   else f"[{priority}]")
            lines.append(f"* --> {tag} [{topic}] {msg}")
        lines.append("*" * 52)
        return "\n".join(lines) + "\n"

    def print_summary(self, stream=None):
        (stream or sys.stdout).write(self.summary())

    def reset(self):
        self._records.clear()


def warn(topic: str, msg: str, priority: str = "medium"):
    WarnManager.instance().record(topic, msg, priority)


class SignalFlags:
    """Register handlers for named signals that request a break or a
    checkpoint at the next step boundary (SignalHandling.H semantics)."""

    _NAMES = {
        "HUP": _signal.SIGHUP, "INT": _signal.SIGINT,
        "TERM": _signal.SIGTERM, "USR1": _signal.SIGUSR1,
        "USR2": _signal.SIGUSR2,
    }

    def __init__(self, break_signals=(), checkpoint_signals=()):
        self.break_requested = False
        self.checkpoint_requested = False
        for name in break_signals:
            self._install(name, "break")
        for name in checkpoint_signals:
            self._install(name, "checkpoint")

    def _install(self, name: str, action: str):
        signum = self._NAMES.get(str(name).upper().replace("SIG", ""))
        if signum is None:
            warn("SignalHandling", f"unknown signal name {name}", "low")
            return

        def handler(_sig, _frame):
            if action == "break":
                self.break_requested = True
            else:
                self.checkpoint_requested = True

        _signal.signal(signum, handler)

    def pop_checkpoint(self) -> bool:
        req, self.checkpoint_requested = self.checkpoint_requested, False
        return req


class StepTimer:
    """Per-step time report in WarpXEvolve.cpp:323-328's format.  On a
    CUDA ``device`` each step's span closes at an event recorded after the
    step, which the timer waits for; elsewhere at the host's clock."""

    def __init__(self, device: torch.device | None = None, stream=None):
        self.stream = stream or sys.stdout
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.n = 0
        self.total = 0.0
        if self.cuda:
            self.last = torch.cuda.Event(enable_timing=True)
            self.last.record()
        else:
            self.last = time.perf_counter()

    def _lap(self) -> float:
        if self.cuda:
            now = torch.cuda.Event(enable_timing=True)
            now.record()
            now.synchronize()
            this = self.last.elapsed_time(now) * 1e-3
        else:
            now = time.perf_counter()
            this = now - self.last
        self.last = now
        return this

    def step_done(self, step: int, sim_time: float, dt: float):
        this = self._lap()
        self.n += 1
        self.total += this
        self.stream.write(
            f"STEP {step} ends. TIME = {sim_time:.10e} DT = {dt:.10e}\n"
            f"Evolve time = {self.total:.6g} s; This step = "
            f"{this:.6g} s; Avg. per step = {self.total / self.n:.6g} s\n"
        )
        self.stream.flush()
