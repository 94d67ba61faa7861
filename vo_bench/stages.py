"""The program's stage spans in a traced window: which stage of the entry
points holds the host's time and leaves the device idle.

The pipelines (`models/stereo_vo.py`, `models/mono_vo.py`) mark their
stages with `utils/timer.span` (`vo.entry`, `vo.track`, `vo.stereo`,
`vo.onep`, `vo.pose`, `vo.fallback`, `vo.update`, `vo.replenish`,
`vo.recover`, `vo.keyframe`). With the program's tracing
switched on a span is a `record_function` range: a host event of the
profiler's trace, on the clock of the kernels and copies. The profiler also
mirrors such a range onto the device's timeline, so `read` leaves every
`vo.` event out of what `tracing.read_trace` reads (the device intervals,
`device_ops`, the host labels), which then reads what it reads with the
spans off, and reads the spans beside it (`read_stages`).

    python3 -m vo_bench.stages --workload <cell> --seed <n> [--seconds 20] [--cost-seconds 10]

from the root of a checkout, on a card: the cell's set-up, then its traced
window (`run.Run.window`, as a `--trace 1` run has it) with the spans on,
then untraced windows with the spans off, on, on and off (either part left
out at 0 seconds). It prints the stage table to standard error and one
JSON line: the per-layer metrics of the traced window (the benchmark's,
and the stage metrics `metrics/*.host_ms_per_frame.py` and
`metrics/driver.unspanned_ms_per_frame.py`), `idle_by_stage`, the checks
of the spans against each other and against the benchmark's call spans,
and what the spans cost untraced. No comparison with the reference is made.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from types import SimpleNamespace

from .tracing import CALL, WINDOW, merged_us

PREFIX = "vo."  # the program's span names; the benchmark's own are "vo_bench."
ENTRY = "vo.entry"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")  # host waits for the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
# The stage metrics (metrics/<name>.py); those but replenish add up, with
# the entry's self time, to the entry's host time.
STAGE_METRICS = ("track.host_ms_per_frame", "stereo.host_ms_per_frame", "onep.host_ms_per_frame",
                 "pose.host_ms_per_frame", "update.host_ms_per_frame", "recover.host_ms_per_frame",
                 "keyframe.host_ms_per_frame", "driver.unspanned_ms_per_frame", "replenish.host_ms_per_frame")


def plain_events(events) -> list:
    """Kineto events as (name, on_device, start us, end us, correlation id)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.correlation_id())
            for e in events]


def read(prof) -> dict:
    """`tracing.read_trace` of the window with every `vo.` event left out,
    and its `stages` (`read_stages`)."""
    from .tracing import read_trace

    events = prof.profiler.kineto_results.events()
    kept = [e for e in events if not e.name().startswith(PREFIX)]
    rec = read_trace(SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: kept))))
    rec["stages"] = read_stages(plain_events(events))
    return rec


def _innermost(spans: list, points: list) -> list:
    """For each point (us), the name of the innermost span (name, start,
    end) holding it, or None. Spans of one thread nest, so a stack of the
    spans open at a point, swept in time order, has the innermost on top,
    however long ago it opened."""
    spans = sorted(spans, key=lambda x: (x[1], -x[2]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out, stack, j = [None] * len(points), [], 0
    for k in order:
        p = points[k]
        while j < len(spans) and spans[j][1] <= p:
            while stack and stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        out[k] = stack[-1][0] if stack else None
    return out


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read_stages(events: list) -> dict:
    """The spans of the window from (name, on_device, start us, end us,
    correlation id) events: per span name its count and summed host
    seconds (`spans`); `vo.entry`'s self time, its ranges less the union of
    the spans inside them (`entry_self_s`); the calls' host seconds
    (`call_s`); the device's idle seconds inside entries (`idle_in_entries_s`)
    and by the innermost span holding each idle gap's middle
    (`idle_by_stage`); and, by innermost span, the host's syncs, kernel
    launches and the device seconds of the kernels launched (`table`); and
    how many of the spans the profiler mirrored on the device (`mirrors`)."""
    lo = hi = None
    spans, calls, dev, runtime = [], [], [], []
    mirrors = 0
    for name, on_dev, s, t, corr in events:
        if on_dev:
            if name.startswith(PREFIX):
                mirrors += 1
            elif name not in (WINDOW, CALL):
                dev.append((name, s, t, corr))
        elif name == WINDOW:
            lo, hi = s, t
        elif name == CALL:
            calls.append((s, t))
        elif name.startswith(PREFIX):
            spans.append((name, s, t))
        elif name in SYNCS or name in LAUNCHES:
            runtime.append((name, s, corr))
    if lo is None:
        raise RuntimeError(f"the profiler trace holds no '{WINDOW}' range")

    by_name: dict = {}
    for name, s, t in spans:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (t - s))

    inner = sorted((s, t) for name, s, t in spans if name != ENTRY)
    starts = [s for s, _ in inner]
    entries = sorted((s, t) for name, s, t in spans if name == ENTRY)
    self_us = 0.0
    for s, t in entries:
        a, b = bisect.bisect_left(starts, s), bisect.bisect_right(starts, t)
        self_us += (t - s) - sum(e - b0 for b0, e in merged_us((x, min(y, t)) for x, y in inner[a:b]))

    busy = merged_us((max(s, lo), min(t, hi)) for _, s, t, _ in dev)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    idle: dict = {}
    for (g0, g1), label in zip(gaps, _innermost(spans, [0.5 * (g0 + g1) for g0, g1 in gaps])):
        if label is not None:
            idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6

    table: dict = {}

    def row(label):
        return table.setdefault(label or "outside the spans", {"syncs": 0, "launches": 0, "device_s": 0.0})

    launched = {}
    for (name, _, corr), label in zip(runtime, _innermost(spans, [s for _, s, _ in runtime])):
        r = row(label)
        if name in SYNCS:
            r["syncs"] += 1
        else:
            r["launches"] += 1
            launched[corr] = r
    for _, s, t, corr in dev:
        if corr in launched:
            launched[corr]["device_s"] += (t - s) * 1e-6

    return {
        "spans": {k: {"count": n, "s": us * 1e-6} for k, (n, us) in by_name.items()},
        "entry_self_s": self_us * 1e-6,
        "call_s": sum(t - s for s, t in calls) * 1e-6,
        "idle_in_entries_s": _overlap(gaps, entries) * 1e-6,
        "idle_by_stage": idle,
        "table": table,
        "mirrors": mirrors,
    }


def host_ms_per_frame(run: dict, names) -> float | None:
    """Host ms of the spans `names`, summed, over the window's frames. None
    without spans in the run, or where the trace's count of a span is not
    the program's (`span_counts`): the profiler dropped events."""
    st, counts = run.get("stages"), run.get("span_counts")
    if st is None or counts is None or not run.get("frames"):
        return None
    total = 0.0
    for name in names:
        sp = st["spans"].get(name, {"count": 0, "s": 0.0})
        if sp["count"] != counts.get(name, 0):
            return None
        total += sp["s"]
    return 1e3 * total / run["frames"]


def unspanned_ms_per_frame(run: dict) -> float | None:
    """`vo.entry`'s self time over the window's frames (None as above)."""
    if host_ms_per_frame(run, [ENTRY]) is None:
        return None
    return 1e3 * run["stages"]["entry_self_s"] / run["frames"]


# ---------------------------------------------------------------------------
# A run on the card
# ---------------------------------------------------------------------------


def traced(r) -> dict:
    """`run.Run.traced_window` with the program's spans on: the same window,
    read by `read`, with the span counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from visual_odometry_ros_tpu_torch.ops import kernels as KN
    from visual_odometry_ros_tpu_torch.utils import timer

    from .run import KERNELS
    from .tracing import count_syncs

    syncs: dict = {}
    KN.reset_launch_counts()
    timer.reset_span_counts()
    with count_syncs(r.device, syncs):
        with timer.tracing(True), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                r.window()
                torch.cuda.synchronize(r.device)
    span_counts, launches = dict(timer.SPAN_COUNTS), dict(KN.LAUNCHES)
    rec = read(prof)
    return {"trace": rec, "stages": rec.pop("stages"), "span_counts": span_counts, "syncs": syncs["syncs"],
            "launches": launches, "frames": r.n_frames, "keyframes": r.keyframes(), "stage_ms": [],
            "kernels": KERNELS}


def untraced_fps(r, i: int, seconds: float, spans_on: bool) -> tuple:
    """Calls into the entry from frame i for `seconds`, untraced, with the
    spans on or off. Returns (frames/s, spans per frame, the next frame)."""
    from visual_odometry_ros_tpu_torch.utils import timer

    drv, fpc, n_max = r.driver, r.driver.frames_per_call(), r.frames["left"].shape[0]
    timer.reset_span_counts()
    n = 0
    with timer.tracing(spans_on):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and i + fpc <= n_max:
            drv.call(i)
            i, n = i + fpc, n + fpc
        dt = time.perf_counter() - t0
    return n / dt, sum(timer.SPAN_COUNTS.values()) / max(n, 1), i


def span_us(spans_on: bool, n: int = 200000) -> float:
    """Host us of one span's enter and exit, outside any profiler."""
    from visual_odometry_ros_tpu_torch.utils import timer

    with timer.tracing(spans_on):
        t0 = time.perf_counter()
        for _ in range(n):
            with timer.span("vo.track"):
                pass
        return (time.perf_counter() - t0) / n * 1e6


def stage_table(st: dict, frames: int) -> str:
    rows = [f"{'span':<14}{'count':>7}{'host ms/frame':>15}{'idle s':>9}{'syncs':>7}{'launches':>10}"
            f"{'device ms':>11}"]
    names = sorted(set(st["spans"]) | set(st["table"]), key=lambda k: -st["spans"].get(k, {"s": 0.0})["s"])
    for k in names:
        sp = st["spans"].get(k, {"count": 0, "s": 0.0})
        t = st["table"].get(k, {"syncs": 0, "launches": 0, "device_s": 0.0})
        rows.append(f"{k:<14}{sp['count']:>7}{1e3 * sp['s'] / frames:>15.3f}{st['idle_by_stage'].get(k, 0.0):>9.3f}"
                    f"{t['syncs']:>7}{t['launches']:>10}{1e3 * t['device_s']:>11.3f}")
    rows.append(f"{'entry self':<14}{'':>7}{1e3 * st['entry_self_s'] / frames:>15.3f}")
    return "\n".join(rows)


def main(argv=None) -> int:
    from . import run as R

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=R.TRACED_S, help="the traced window; 0: none")
    ap.add_argument("--cost-seconds", type=float, default=10.0,
                    help="each of the four untraced windows (spans off, on, on, off); 0: none")
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(R.CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("vo_bench.stages: needs a CUDA device", file=sys.stderr)
        return 2
    r = R.Run(args.workload, args.seed, args.seconds, True)
    r.device = torch.device("cuda", 0)
    r.setup()
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(r.device)}
    i = len(r.warm)
    if args.seconds > 0:
        layer = traced(r)
        i += r.n_frames
        st, frames = layer["stages"], layer["frames"]
        metrics = {k: R.read_metric(k, layer) for k in [m["name"] for m in r.spec["per_layer"]] + list(STAGE_METRICS)}
        parts = sum(metrics[k] or 0.0 for k in STAGE_METRICS if k != "replenish.host_ms_per_frame")
        idle = sorted(st["idle_by_stage"].items(), key=lambda kv: -kv[1])
        out.update({
            "frames": frames, "keyframes": layer["keyframes"], "recoveries": r.recoveries(),
            "window_s": layer["trace"]["window_s"], "busy_s": layer["trace"]["busy_s"],
            "metrics": metrics, "span_counts": layer["span_counts"], "idle_by_stage": [[k, s] for k, s in idle],
            "checks": {"entry_ms_per_frame": host_ms_per_frame(layer, [ENTRY]),
                       "stages_plus_unspanned_ms_per_frame": parts,
                       "call_ms_per_frame": 1e3 * st["call_s"] / frames,
                       "idle_by_stage_s": sum(st["idle_by_stage"].values()),
                       "idle_in_entries_s": st["idle_in_entries_s"],
                       "device_s_matched": sum(t["device_s"] for t in st["table"].values()),
                       "span_mirrors_on_device": st["mirrors"]},
            "table": st["table"],
        })
        print(f"vo_bench.stages: {args.workload} seed {args.seed}, {frames} frames traced\n"
              + stage_table(st, frames), file=sys.stderr)
    if args.cost_seconds > 0:
        runs = []
        for on in (False, True, True, False):
            fps, per_frame, i = untraced_fps(r, i, args.cost_seconds, on)
            runs.append({"spans_on": on, "fps": fps, "spans_per_frame": per_frame})
        out["cost"] = {"windows": runs, "span_us_off": span_us(False), "span_us_on": span_us(True)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
