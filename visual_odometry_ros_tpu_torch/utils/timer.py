"""Wall-clock instrumentation: tic/toc, StopWatch, per-stage accumulators,
and the pipelines' stage spans.

Counterpart of `visual_odometry_ros_tpu/utils/timer.py`. CUDA work is
asynchronous, so `toc` and `StageTimer.stage` can first wait for the
devices that hold a given tree of tensors (`block_until_ready`).

`span` marks a stage of the pipelines' entry points (`vo.entry`, `vo.track`,
...). Every entry is counted in `SPAN_COUNTS`. With `tracing` switched on a
span is a `torch.profiler.record_function` range: a profiler trace then
holds it as a host event on the clock of the device's kernels and copies.
Off (the default) a span does nothing else: no profiler range, no clock
read, no sync.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

_T0 = [time.perf_counter()]

# Entries of each span by name since the last reset_span_counts(), tracing
# on or off (the counterpart of ops/kernels.LAUNCHES for spans).
SPAN_COUNTS: dict = defaultdict(int)
_TRACING = [False]
_OFF = nullcontext()


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


def reset_span_counts() -> None:
    SPAN_COUNTS.clear()


@contextmanager
def tracing(on: bool = True):
    """Spans are profiler ranges inside the block (on) or not (off); the
    setting before the block is restored after it."""
    prev = _TRACING[0]
    _TRACING[0] = bool(on)
    try:
        yield
    finally:
        _TRACING[0] = prev


def span(name: str, stage_ms: dict | None = None, key: str | None = None, device=None):
    """The context of one stage `name`, counted in SPAN_COUNTS.

    With tracing on, a `record_function(name)` range; off, a shared no-op.
    With `stage_ms` (the entry points' timed=True path) the stage runs
    between two synchronises of `device` (a CUDA device; nothing to wait
    for on the CPU) and its wall ms are added to stage_ms[key]."""
    SPAN_COUNTS[name] += 1
    if stage_ms is not None:
        return _timed(name, stage_ms, key, torch.device(device or "cpu"))
    if _TRACING[0]:
        return torch.profiler.record_function(name)
    return _OFF


@contextmanager
def _timed(name: str, stage_ms: dict, key: str, device: torch.device):
    wait = torch.cuda.synchronize if device.type == "cuda" else (lambda _: None)
    with torch.profiler.record_function(name) if _TRACING[0] else _OFF:
        wait(device)
        t0 = time.perf_counter()
        yield
        wait(device)
        stage_ms[key] = stage_ms.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
