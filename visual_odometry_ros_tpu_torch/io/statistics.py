"""Per-frame statistics records + aggregation (the statistics-topic analog).

The port's copy of `visual_odometry_ros_tpu/io/statistics.py` (numpy and
the standard library only), so the port loads no file of the JAX package.

Capability parity with the reference's observability stack (SURVEY.md §5):
  - `statisticsStamped.msg` (ros1/msg/statisticsStamped.msg:1-21): per-frame
    timings (total/track/1p/5p/new), landmark counts (initial/bidirection/
    1p/5p/new/final/parallax-ok), avg parallax/age, steering angle, scale
    gt vs est.
  - `AlgorithmStatistics` accumulators (mono_vo.h:118-200): landmark count
    series, per-frame poses, keyframe poses + mappoints, execution times.

Here the record is a plain dataclass appended per frame; export to JSON lines
or converted to numpy series for plotting/rqt-multiplot-style dashboards.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class ExecStats:
    """Per-frame wall-clock stage timings in milliseconds."""

    time_total: float = 0.0
    time_track: float = 0.0
    time_stereo: float = 0.0  # static stereo matching (stereo mode)
    time_1p: float = 0.0
    time_5p: float = 0.0
    time_pose: float = 0.0  # pose-only GN + gates
    time_new: float = 0.0
    time_ba: float = 0.0


@dataclass
class LandmarkStats:
    """Per-frame landmark funnel counts (statisticsStamped fields)."""

    n_initial: int = 0  # tracks entering the frame
    n_pass_bidirection: int = 0
    n_pass_1p: int = 0
    n_pass_5p: int = 0
    n_new: int = 0
    n_final: int = 0
    n_ok_parallax: int = 0
    avg_parallax: float = 0.0
    avg_age: float = 0.0


@dataclass
class FrameRecord:
    frame: int
    timestamp: float = 0.0
    keyframe: bool = False
    steering_angle: float = 0.0
    scale_est: float = 0.0
    scale_gt: float = 0.0
    exec: ExecStats = field(default_factory=ExecStats)
    landmarks: LandmarkStats = field(default_factory=LandmarkStats)

    def to_dict(self) -> dict:
        return asdict(self)


class StatisticsLog:
    """Append-only per-frame log with JSONL export and series extraction."""

    def __init__(self):
        self.records: list[FrameRecord] = []

    def append(self, rec: FrameRecord) -> None:
        self.records.append(rec)

    def series(self, path: str):
        """Dotted-path series, e.g. 'exec.time_total' or 'landmarks.n_final'."""
        out = []
        for r in self.records:
            obj = r
            for part in path.split("."):
                obj = getattr(obj, part)
            out.append(obj)
        return out

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_dict()) + "\n")

    @staticmethod
    def load_jsonl(path: str) -> list[dict]:
        return [json.loads(line) for line in open(path)]

    def summary(self) -> dict:
        if not self.records:
            return {}
        import numpy as np

        tt = np.asarray(self.series("exec.time_total"))
        nf = np.asarray(self.series("landmarks.n_final"))
        return {
            "frames": len(self.records),
            "keyframes": sum(1 for r in self.records if r.keyframe),
            "mean_time_total_ms": float(tt.mean()),
            "p95_time_total_ms": float(np.percentile(tt, 95)),
            "mean_n_final": float(nf.mean()),
        }
