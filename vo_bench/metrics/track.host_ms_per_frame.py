"""track.host_ms_per_frame: host ms of the pipelines' span `vo.track`, the track stage: pyramids,
priors, the KLT kernels (`ops/klt.py`, `ops/pyramid.py`), over the traced window's frames; None
where the trace's count of a span is not the program's."""

from vo_bench.stages import host_ms_per_frame


def read(run):
    return host_ms_per_frame(run, ["vo.track"])
