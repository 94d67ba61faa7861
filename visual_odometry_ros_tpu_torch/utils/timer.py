"""Wall-clock instrumentation: tic/toc, StopWatch, per-stage accumulators.

Counterpart of `visual_odometry_ros_tpu/utils/timer.py`. CUDA work is
asynchronous, so `toc` and `StageTimer.stage` can first wait for the
devices that hold a given tree of tensors (`block_until_ready`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_T0 = [time.perf_counter()]


def _devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _devices(v, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            _devices(getattr(tree, name), out)
    return out


def block_until_ready(tree):
    """Wait until every CUDA device holding a tensor of `tree` is idle;
    returns `tree`. CPU tensors are always ready."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


def tic() -> None:
    _T0[0] = time.perf_counter()


def toc(block_on=None, verbose: bool = False) -> float:
    """Milliseconds since the last tic(). Pass tensors via block_on to wait
    for their devices first."""
    if block_on is not None:
        block_until_ready(block_on)
    dt = (time.perf_counter() - _T0[0]) * 1e3
    if verbose:
        print(f"elapsed: {dt:.3f} ms")
    return dt


class StopWatch:
    def __init__(self, name: str = ""):
        self.name = name
        self.start_time = time.perf_counter()

    def start(self) -> None:
        self.start_time = time.perf_counter()

    def lap_ms(self) -> float:
        return (time.perf_counter() - self.start_time) * 1e3

    def stop_ms(self, verbose: bool = False) -> float:
        dt = self.lap_ms()
        if verbose:
            print(f"[{self.name}] {dt:.3f} ms")
        return dt


class StageTimer:
    """Accumulates per-stage wall times across frames (host side)."""

    def __init__(self):
        self.totals_ms = defaultdict(float)
        self.counts = defaultdict(int)
        self.last_ms = {}

    @contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.record(name, (time.perf_counter() - t0) * 1e3)

    def record(self, name: str, ms: float) -> None:
        self.totals_ms[name] += ms
        self.counts[name] += 1
        self.last_ms[name] = ms

    def mean_ms(self, name: str) -> float:
        c = self.counts[name]
        return self.totals_ms[name] / c if c else 0.0

    def summary(self) -> dict:
        return {k: self.mean_ms(k) for k in self.totals_ms}
