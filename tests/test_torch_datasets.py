"""The port's dataset readers and statistics log against the JAX package's,
on the fabricated KITTI and EuRoC layouts of tests/test_datasets_io.py:
the same frames (exact), `config()` fields, ground truth, Prefetcher order
and StatisticsLog JSON lines (line for line).
"""

import dataclasses
import importlib.util
import os

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from visual_odometry_ros_tpu.io import datasets as JD  # noqa: E402
from visual_odometry_ros_tpu.io import statistics as JS  # noqa: E402
from visual_odometry_ros_tpu_torch import config as TC  # noqa: E402
from visual_odometry_ros_tpu_torch.io import datasets as TD  # noqa: E402
from visual_odometry_ros_tpu_torch.io import statistics as TS  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "datasets_fixtures", os.path.join(os.path.dirname(__file__), "test_datasets_io.py"))
_fix = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fix)


def _assert_frames_equal(a, b):
    fa, fb = list(a), list(b)
    assert len(fa) == len(fb) > 0
    for (ta, la, ra), (tb, lb, rb) in zip(fa, fb):
        assert ta == tb
        np.testing.assert_array_equal(la, lb)
        assert la.dtype == lb.dtype == np.float32
        if ra is None:
            assert rb is None
        else:
            np.testing.assert_array_equal(ra, rb)


def _config_dict(cfg):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in dataclasses.asdict(cfg).items()}


def test_kitti_reader_matches_jax(tmp_path):
    root = str(_fix._make_kitti(tmp_path, n=4))
    t, j = TD.KittiOdometry(root, "00"), JD.KittiOdometry(root, "00")
    assert len(t) == len(j) == 4 and t.times == j.times
    assert [dataclasses.astuple(f) for f in t.frames] == [dataclasses.astuple(f) for f in j.frames]
    _assert_frames_equal(t, j)
    np.testing.assert_array_equal(t.gt_poses, j.gt_poses)
    assert t.calib.keys() == j.calib.keys()
    for k in t.calib:
        np.testing.assert_array_equal(t.calib[k], j.calib[k])
    ct, cj = t.config(), j.config()
    assert isinstance(ct, TC.VOConfig)
    assert _config_dict(ct) == _config_dict(cj)
    assert ct.cam.width == 96 and ct.cam.height == 64 and abs(ct.T_lr[0, 3] - 386.1448 / 718.856) < 1e-6


def test_kitti_reader_without_times_calib_or_poses(tmp_path):
    root = _fix._make_kitti(tmp_path, n=2)
    for name in ("sequences/00/times.txt", "sequences/00/calib.txt", "poses/00.txt"):
        os.remove(root / name)
    t, j = TD.KittiOdometry(str(root), "00"), JD.KittiOdometry(str(root), "00")
    assert t.gt_poses is None and j.gt_poses is None and t.calib is None
    assert [f.timestamp for f in t.frames] == [f.timestamp for f in j.frames] == [0.0, 0.1]
    assert _config_dict(t.config()) == _config_dict(j.config())


def test_euroc_reader_matches_jax(tmp_path):
    root = str(_fix._make_euroc(tmp_path, n=4))
    for stereo in (True, False):
        t, j = TD.EurocMav(root, stereo=stereo), JD.EurocMav(root, stereo=stereo)
        assert t.stereo == j.stereo == stereo and t.pairs == j.pairs
        _assert_frames_equal(t, j)
        np.testing.assert_array_equal(t.gt[0], j.gt[0])
        np.testing.assert_array_equal(t.gt[1], j.gt[1])
    # Approximate-time pairing: a right frame 3 ms late is dropped (2 ms
    # tolerance), as in the reference.
    csv1 = tmp_path / "mav0" / "cam1" / "data.csv"
    rows = csv1.read_text().splitlines()
    t1, name = rows[2].split(",")
    rows[2] = f"{int(t1) + 3_000_000},{name}"
    csv1.write_text("\n".join(rows))
    t, j = TD.EurocMav(root), JD.EurocMav(root)
    assert len(t) == len(j) == 3 and t.pairs == j.pairs


def test_quat_to_R_matches_jax(rng):
    for q in rng.normal(0, 1, (8, 4)):
        np.testing.assert_array_equal(TD._quat_to_R(*q), JD._quat_to_R(*q))


def test_prefetcher_order_matches_jax():
    items = [(i, np.full(3, i)) for i in range(30)]
    a = list(TD.Prefetcher(iter(items), depth=3))
    b = list(JD.Prefetcher(iter(items), depth=3))
    assert [x for x, _ in a] == [x for x, _ in b] == list(range(30))
    assert all(x is y for (_, x), (_, y) in zip(a, items))


def _records(S, rng):
    log = S.StatisticsLog()
    for i in range(6):
        log.append(S.FrameRecord(
            frame=i, timestamp=0.1 * i, keyframe=i % 3 == 0, steering_angle=float(rng.normal()),
            scale_est=0.25, scale_gt=0.25 + 0.01 * i,
            exec=S.ExecStats(time_total=10.0 + i, time_track=1.5, time_pose=2.0 * i),
            landmarks=S.LandmarkStats(n_initial=100 + i, n_pass_5p=90, n_new=i, n_final=90 + i,
                                      avg_parallax=0.5 * i, avg_age=1.0 + i),
        ))
    return log


def test_statistics_log_matches_jax(tmp_path):
    t, j = _records(TS, np.random.default_rng(3)), _records(JS, np.random.default_rng(3))
    pt, pj = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    t.save_jsonl(str(pt))
    j.save_jsonl(str(pj))
    assert pt.read_text().splitlines() == pj.read_text().splitlines()
    assert TS.StatisticsLog.load_jsonl(str(pt)) == JS.StatisticsLog.load_jsonl(str(pj))
    assert t.summary() == j.summary()
    for path in ("exec.time_total", "landmarks.n_final", "keyframe"):
        assert t.series(path) == j.series(path)
    assert TS.StatisticsLog().summary() == {}
