"""pose.host_ms_per_frame: host ms of the pipelines' spans `vo.pose` + `vo.fallback`, the pose stage
and mono's 5-point fallback (`ops/pose_gn.py`, `ops/epipolar.py`), over the traced window's frames;
None where the trace's count of a span is not the program's."""

from vo_bench.stages import host_ms_per_frame


def read(run):
    return host_ms_per_frame(run, ["vo.pose", "vo.fallback"])
