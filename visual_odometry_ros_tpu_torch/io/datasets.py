"""Dataset readers: KITTI odometry (grayscale stereo) and EuRoC MAV (ASL).

The port's copy of `visual_odometry_ros_tpu/io/datasets.py`: direct
host-side readers and a prefetching iterator in place of the reference's
ROS ingest layer (rosbag + image topics + message_filters stereo sync).
Image decode uses PIL, as the JAX package does; `config()` returns the
port's `VOConfig`.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np


def load_gray(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.float32)


@dataclass
class StereoFrameRecord:
    index: int
    timestamp: float
    left_path: str
    right_path: str


class KittiOdometry:
    """KITTI odometry layout: sequences/<seq>/image_0, image_1, times.txt;
    poses/<seq>.txt for ground truth (12 floats, T_w_cam0 rows)."""

    def __init__(self, root: str, sequence: str = "00"):
        self.root = root
        self.sequence = sequence
        seq_dir = os.path.join(root, "sequences", sequence)
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        times_path = os.path.join(seq_dir, "times.txt")
        self.times = (
            [float(x) for x in open(times_path)] if os.path.exists(times_path) else None
        )
        names = sorted(os.listdir(self.left_dir)) if os.path.isdir(self.left_dir) else []
        self.frames = [
            StereoFrameRecord(
                i,
                self.times[i] if self.times else i * 0.1,
                os.path.join(self.left_dir, n),
                os.path.join(self.right_dir, n),
            )
            for i, n in enumerate(names)
        ]
        self.calib = self._load_calib(os.path.join(seq_dir, "calib.txt"))
        gt_path = os.path.join(root, "poses", sequence + ".txt")
        self.gt_poses = self._load_poses(gt_path) if os.path.exists(gt_path) else None

    @staticmethod
    def _load_calib(path: str):
        if not os.path.exists(path):
            return None
        out = {}
        for line in open(path):
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = np.asarray([float(x) for x in v.split()], np.float64).reshape(3, 4)
        return out

    @staticmethod
    def _load_poses(path: str):
        poses = []
        for line in open(path):
            vals = [float(x) for x in line.split()]
            T = np.eye(4)
            T[:3, :4] = np.asarray(vals).reshape(3, 4)
            poses.append(T)
        return np.stack(poses)

    def config(self):
        """VOConfig from calib.txt (P0/P1 projection matrices)."""
        from ..config import VOConfig

        cfg = VOConfig()
        if self.calib is not None and "P0" in self.calib:
            P0, P1 = self.calib["P0"], self.calib["P1"]
            cfg.cam.fx = float(P0[0, 0])
            cfg.cam.fy = float(P0[1, 1])
            cfg.cam.cx = float(P0[0, 2])
            cfg.cam.cy = float(P0[1, 2])
            cfg.cam_right.fx = float(P1[0, 0])
            cfg.cam_right.fy = float(P1[1, 1])
            cfg.cam_right.cx = float(P1[0, 2])
            cfg.cam_right.cy = float(P1[1, 2])
            # P1 = K [I | -b] in cam0 frame: baseline = -P1[0,3]/fx
            baseline = -float(P1[0, 3]) / float(P1[0, 0])
            T_lr = np.eye(4, dtype=np.float32)
            T_lr[0, 3] = baseline
            cfg.T_lr = T_lr
        if self.frames:
            img = load_gray(self.frames[0].left_path)
            cfg.cam.height, cfg.cam.width = img.shape
            cfg.cam_right.height, cfg.cam_right.width = img.shape
        cfg.flagDoUndistortion = False  # KITTI odometry frames are rectified
        return cfg

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        for f in self.frames:
            yield f.timestamp, load_gray(f.left_path), load_gray(f.right_path)


class EurocMav:
    """EuRoC ASL layout: mav0/cam0/data.csv + data/<t>.png, mav0/cam1/...,
    ground truth in mav0/state_groundtruth_estimate0/data.csv."""

    def __init__(self, root: str, stereo: bool = True, sync_tol_ns: int = 2_000_000):
        self.root = root
        cam0 = os.path.join(root, "mav0", "cam0")
        cam1 = os.path.join(root, "mav0", "cam1")
        self.cam0_list = self._read_cam_csv(cam0)
        self.cam1_list = self._read_cam_csv(cam1) if stereo else []
        self.stereo = stereo and bool(self.cam1_list)
        if self.stereo:
            # Approximate-time pairing (message_filters analog).
            t1 = np.asarray([t for t, _ in self.cam1_list])
            pairs = []
            for t0, p0 in self.cam0_list:
                j = int(np.argmin(np.abs(t1 - t0)))
                if abs(int(t1[j]) - t0) <= sync_tol_ns:
                    pairs.append((t0, p0, self.cam1_list[j][1]))
            self.pairs = pairs
        else:
            self.pairs = [(t, p, None) for t, p in self.cam0_list]
        self.gt = self._read_gt(os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv"))

    @staticmethod
    def _read_cam_csv(cam_dir: str):
        csv_path = os.path.join(cam_dir, "data.csv")
        if not os.path.exists(csv_path):
            return []
        out = []
        with open(csv_path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                t = int(row[0])
                out.append((t, os.path.join(cam_dir, "data", row[1].strip())))
        return out

    @staticmethod
    def _read_gt(path: str):
        if not os.path.exists(path):
            return None
        ts, poses = [], []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                t = int(row[0])
                px, py, pz = (float(row[i]) for i in (1, 2, 3))
                qw, qx, qy, qz = (float(row[i]) for i in (4, 5, 6, 7))
                R = _quat_to_R(qw, qx, qy, qz)
                T = np.eye(4)
                T[:3, :3] = R
                T[:3, 3] = [px, py, pz]
                ts.append(t)
                poses.append(T)
        return np.asarray(ts), np.stack(poses)

    def __len__(self):
        return len(self.pairs)

    def __iter__(self):
        for t, p0, p1 in self.pairs:
            l = load_gray(p0)
            r = load_gray(p1) if p1 else None
            yield t * 1e-9, l, r


def _quat_to_R(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class Prefetcher:
    """Background-thread frame prefetch (the ROS-subscriber queue analog)."""

    def __init__(self, iterable, depth: int = 4):
        import queue
        import threading

        self.q = queue.Queue(maxsize=depth)
        self._done = object()

        def worker():
            for item in iterable:
                self.q.put(item)
            self.q.put(self._done)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._done:
                return
            yield item
