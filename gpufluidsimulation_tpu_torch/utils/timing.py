"""Per-frame timing and console colours for the CLI: the reference's
cudaEvent wall clock ("[Bimocq GPU Time: X ms]",
BimocqGPUSolver.cpp:110-126) and its coloured per-frame logs, with
``torch.profiler`` traces through ``profiler_trace``.

Every time is fenced on the card: ``torch.cuda.synchronize`` before the
clock starts and before it is read, so a step's milliseconds are its own
work and not the launch queue's.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

GREEN = "\033[32m"
YELLOW = "\033[33m"
BLUE = "\033[34m"
RED = "\033[31m"
RESET = "\033[0m"


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class FrameTimer:
    """Accumulates per-phase and per-step wall times on `device`'s clock
    (no fence on the CPU)."""

    device: Optional[object] = None
    phases: Dict[str, float] = field(default_factory=dict)
    history: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block, fenced on the card at both ends."""
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.phases[name] = (self.phases.get(name, 0.0)
                             + time.perf_counter() - t0)

    def time_step(self, step_fn, state, *args):
        """out = step_fn(state, *args) and its milliseconds, fenced."""
        _sync(self.device)
        t0 = time.perf_counter()
        out = step_fn(state, *args)
        _sync(self.device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.history.append(dt_ms)
        return out, dt_ms

    def report(self, frame: int, extras: Optional[dict] = None) -> str:
        ms = self.history[-1] if self.history else 0.0
        msg = f"[Bimocq GPU Time: {ms:.2f} ms]"
        if extras:
            for k, v in extras.items():
                msg += f" {k}={v}"
        return msg


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace (host, and the card when there is one)
    around a region, written to ``<trace_dir>/trace.json`` (Chrome trace
    format); no trace without a `trace_dir`."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
