"""The stage spans' reading (`vo_bench/stages.py`) and the stage metrics'
readers, on synthetic traces."""

import pytest
import torch

from vo_bench import run, stages, tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

# One window (us): a call holding one entry, with a track stage, an update
# holding a replenishment, and a keyframe step. Two kernels, launched inside
# the track stage and the replenishment; one sync inside the update; the
# profiler's mirrors of the window, the call and the entry on the device.
HOST = [(tracing.WINDOW, 0, 100, 0), (tracing.CALL, 5, 95, 0), ("vo.entry", 10, 90, 0), ("vo.track", 12, 30, 0),
        ("vo.update", 35, 70, 0), ("vo.replenish", 40, 60, 0), ("vo.keyframe", 72, 85, 0),
        ("cudaLaunchKernel", 13, 14, 101), ("cudaLaunchKernel", 41, 42, 102), ("cudaStreamSynchronize", 64, 66, 0),
        ("aten::mul", 42, 44, 0)]
DEV = [("klt_pyr_kernel", 14, 18, 101), ("elementwise", 44, 52, 102), (tracing.WINDOW, 14, 52, 0),
       (tracing.CALL, 14, 52, 0), ("vo.entry", 14, 52, 0), ("vo.update", 44, 52, 0)]


def _events():
    return [(n, False, s, t, c) for n, s, t, c in HOST] + [(n, True, s, t, c) for n, s, t, c in DEV]


def test_read_stages():
    st = stages.read_stages(_events())
    us = {"vo.entry": 80, "vo.track": 18, "vo.update": 35, "vo.replenish": 20, "vo.keyframe": 13}
    assert st["spans"] == {k: {"count": 1, "s": pytest.approx(v * 1e-6)} for k, v in us.items()}
    assert st["entry_self_s"] == pytest.approx((80 - 18 - 35 - 13) * 1e-6)
    assert st["call_s"] == pytest.approx(90e-6)
    # Busy 14-18 and 44-52: gaps 0-14 (middle 7, outside the entry), 18-44
    # (middle 31, in the entry between stages), 52-100 (middle 76, keyframe).
    assert st["idle_by_stage"] == pytest.approx({"vo.entry": 26e-6, "vo.keyframe": 48e-6})
    assert st["idle_in_entries_s"] == pytest.approx((4 + 26 + 38) * 1e-6)
    assert st["table"]["vo.track"] == {"syncs": 0, "launches": 1, "device_s": pytest.approx(4e-6)}
    assert st["table"]["vo.replenish"] == {"syncs": 0, "launches": 1, "device_s": pytest.approx(8e-6)}
    assert st["table"]["vo.update"] == {"syncs": 1, "launches": 0, "device_s": 0.0}
    assert st["mirrors"] == 2


def test_innermost_reaches_a_span_that_opened_long_before():
    spans = [("vo.entry", 0, 10_000)] + [("vo.track", 1 + 2 * k, 2 + 2 * k) for k in range(1000)]
    assert stages._innermost(spans, [9000.0, 3.5, 2.5, 10_001.0]) == ["vo.entry", "vo.track", "vo.entry", None]


class _Event:
    def __init__(self, name, on_dev, s, t, corr):
        self._v = name, CUDA if on_dev else CPU, int(s * 1000), int(t * 1000), corr

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _prof(events):
    from types import SimpleNamespace

    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def test_program_spans_and_their_device_mirrors_leave_the_trace_reading_as_it_was():
    """A trace with the spans on reads, through `stages.read`, what the same
    trace without them reads through `tracing.read_trace`: the mirrored
    ranges add no busy time and no device operation, and no host label."""
    with_spans = [_Event(*e) for e in _events()]
    without = [e for e in with_spans if not e.name().startswith("vo.")]
    plain = tracing.read_trace(_prof(without))
    rec = stages.read(_prof(with_spans))
    assert rec.pop("stages")["spans"]["vo.entry"]["count"] == 1
    assert rec == plain
    assert plain["busy_s"] == pytest.approx(12e-6) and set(plain["device_ops"]) == {"klt_pyr_kernel", "elementwise"}
    # Read as it stands, the same trace would count the mirrors as busy.
    assert tracing.read_trace(_prof(with_spans))["busy_s"] > plain["busy_s"]


def _layer(counts=None):
    st = stages.read_stages(_events())
    return {"frames": 2, "stages": st,
            "span_counts": counts or {"vo.entry": 1, "vo.track": 1, "vo.update": 1, "vo.replenish": 1,
                                      "vo.keyframe": 1}}


def test_stage_readers():
    r = _layer()
    assert run.read_metric("track.host_ms_per_frame", r) == pytest.approx(18e-3 / 2)
    assert run.read_metric("update.host_ms_per_frame", r) == pytest.approx(35e-3 / 2)
    assert run.read_metric("replenish.host_ms_per_frame", r) == pytest.approx(20e-3 / 2)
    assert run.read_metric("keyframe.host_ms_per_frame", r) == pytest.approx(13e-3 / 2)
    assert run.read_metric("driver.unspanned_ms_per_frame", r) == pytest.approx(14e-3 / 2)
    # Spans that did not run read 0, as counted.
    for name in ("stereo.host_ms_per_frame", "onep.host_ms_per_frame", "pose.host_ms_per_frame",
                 "recover.host_ms_per_frame"):
        assert run.read_metric(name, r) == 0.0
    # The stages that do not nest and the entry's self time make the entry.
    top = [k for k in stages.STAGE_METRICS if k != "replenish.host_ms_per_frame"]
    assert sum(run.read_metric(k, r) for k in top) == pytest.approx(stages.host_ms_per_frame(r, ["vo.entry"]))


def test_stage_readers_with_nothing_to_read_return_nothing():
    r = _layer({"vo.entry": 1, "vo.track": 2, "vo.update": 1, "vo.replenish": 1, "vo.keyframe": 1})
    assert run.read_metric("track.host_ms_per_frame", r) is None  # a dropped trace event
    assert run.read_metric("update.host_ms_per_frame", r) is not None
    r = _layer({"vo.track": 1, "vo.update": 1, "vo.replenish": 1, "vo.keyframe": 1})
    assert run.read_metric("driver.unspanned_ms_per_frame", r) is None
    # A run of a program without spans, or of a harness that does not read them.
    for r in ({"frames": 2}, {"frames": 2, "stages": _layer()["stages"]}):
        for name in stages.STAGE_METRICS:
            assert run.read_metric(name, r) is None, name
