"""Reading a traced window: the device's busy intervals from a
`torch.profiler` trace, device time by kernel name, the longest idle gaps
labelled by what the host was doing, and the host syncs the window made.

The busy/idle union follows the program's `profile_stages._merged_ms`; the
trace is read from the raw kineto events (a window holds ~10^5-10^6 device
events, too many for the profiler's FunctionEvent tree)."""

from __future__ import annotations

import bisect
import warnings
from contextlib import contextmanager

import torch

WINDOW = "vo_bench.window"
CALL = "vo_bench.call"  # the benchmark's span around each call into an entry point


def merged_us(intervals) -> list:
    """The union of [start, end] intervals, as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof) -> dict:
    """The window's length, device busy seconds, device seconds and event
    counts by operation name, and idle seconds by host label."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host, dev, calls = [], [], []
    lo = hi = None
    for e in events:
        s, t = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == cuda:
            if e.name() not in (WINDOW, CALL):  # the benchmark's own spans, mirrored on the device
                dev.append((e.name(), s, t))
        elif e.device_type() == cpu:
            if e.name() == WINDOW:
                lo, hi = s, t
            elif e.name() == CALL:
                calls.append((s, t))
            else:
                host.append((e.name(), s, t))
    if lo is None:
        raise RuntimeError(f"the profiler trace holds no '{WINDOW}' range")
    busy = merged_us((max(s, lo), min(t, hi)) for _, s, t in dev)
    by_op: dict = {}
    for name, s, t in dev:
        n, us = by_op.get(name, (0, 0.0))
        by_op[name] = (n + 1, us + (t - s))
    # Idle gaps between busy intervals, each labelled by the innermost host
    # span (a torch operation or a CUDA runtime call) that holds its middle,
    # else by whether the host was inside a call into an entry point.
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    host.sort(key=lambda h: h[1])
    idle: dict = {}
    starts = [h[1] for h in host]
    calls.sort()
    call_starts = [c[0] for c in calls]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        k = bisect.bisect_right(starts, mid)
        c = bisect.bisect_right(call_starts, mid) - 1
        in_call = c >= 0 and calls[c][1] >= mid
        label = "host Python in an entry call" if in_call else "host between calls (the benchmark's loop)"
        best = None
        # Host spans are short except the window's and the calls'; look back
        # a bounded number of spans for the innermost that holds mid.
        for name, s, t in host[max(0, k - 400) : k]:
            if s <= mid <= t and (best is None or t - s < best):
                label, best = name, t - s
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_ops": {k: {"count": n, "s": us * 1e-6} for k, (n, us) in by_op.items()},
        "idle_by_host": idle,
    }


@contextmanager
def count_syncs(device, out: dict):
    """Counts the host syncs made inside the block, as
    torch.cuda.set_sync_debug_mode("warn") flags them (a `.item()`, `bool()`
    or `.cpu()` of a device tensor, a blocking copy), into out["syncs"]."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        out["syncs"] = sum(1 for w in caught if "synchroniz" in str(w.message))
