"""The port's CLI (`python -m visual_odometry_ros_tpu_torch.run_vo`) on CPU:
against the JAX package's scripts/run_vo.py on the synthetic stereo world,
against the port's drivers called directly on fabricated KITTI and EuRoC
layouts, and its exits, interrupt dump, trace and optional plot.
"""

import importlib.util
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from visual_odometry_ros_tpu_torch import run_vo  # noqa: E402
from visual_odometry_ros_tpu_torch.config import load_yaml  # noqa: E402
from visual_odometry_ros_tpu_torch.io import datasets as TD  # noqa: E402
from visual_odometry_ros_tpu_torch.io.synthetic import PlaneSequence, forward_trajectory  # noqa: E402
from visual_odometry_ros_tpu_torch.io.trajectory import save_kitti_trajectory  # noqa: E402
from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import run_vo as jax_run_vo  # noqa: E402

torch.set_num_threads(2)


def _records(out):
    with open(os.path.join(out, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def synthetic_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("syn")
    args = ["--dataset", "synthetic", "--frames", "6", "--mode", "stereo", "--quiet"]
    t = run_vo.main(args + ["--out", str(d / "port"), "--device", "cpu"])
    j = jax_run_vo.main(args + ["--out", str(d / "jax"), "--platform", "cpu"])
    return t, j, str(d / "port"), str(d / "jax")


def test_synthetic_stereo_matches_jax_cli(synthetic_runs):
    """Poses to 1 mm (measured 0.31 mm: the port's CPU default runs the
    kernels' plain versions, the JAX package its jnp leg), the same keyframe
    indices, and the landmark funnel within the bounds below."""
    t, j, out_t, out_j = synthetic_runs
    for name in ("frame_poses.txt", "keyframe_poses.txt", "stats.jsonl", "trajectory.png"):
        assert os.path.exists(os.path.join(out_t, name)), name
    pt, pj = (np.loadtxt(os.path.join(o, "frame_poses.txt")) for o in (out_t, out_j))
    assert pt.shape == pj.shape == (6, 13)
    np.testing.assert_allclose(pt, pj, atol=1e-3, rtol=0)
    kt, kj = (np.loadtxt(os.path.join(o, "keyframe_poses.txt"), ndmin=2)[:, 0] for o in (out_t, out_j))
    assert kt.tolist() == kj.tolist()
    assert t["frames"] == j["frames"] == 6 and t["keyframes"] == j["keyframes"]
    assert abs(t["ate_rmse"] - j["ate_rmse"]) < 1e-3
    rt, rj = _records(out_t), _records(out_j)
    assert [r["frame"] for r in rt] == [r["frame"] for r in rj] == list(range(6))
    for a, b in zip(rt, rj):
        assert a.keys() == b.keys() and a["exec"].keys() == b["exec"].keys()
        assert a["keyframe"] == b["keyframe"] and a["timestamp"] == b["timestamp"]
        # Ground truth from each package's float32 forward_trajectory: ulps.
        assert abs(a["scale_est"] - b["scale_est"]) < 1e-3 and abs(a["scale_gt"] - b["scale_gt"]) < 1e-6
        la, lb = a["landmarks"], b["landmarks"]
        # The two legs' gates admit a few tracks differently (frame 1: 225
        # against 232 tracks entering): counts within 5%.
        for k in ("n_initial", "n_pass_bidirection", "n_pass_5p"):
            assert abs(la[k] - lb[k]) <= 0.05 * max(la[k], lb[k]), (a["frame"], k, la[k], lb[k])
        assert abs(la["n_ok_parallax"] - lb["n_ok_parallax"]) <= 2
        assert abs(la["avg_parallax"] - lb["avg_parallax"]) <= 0.02 * max(lb["avg_parallax"], 1e-9)
        assert abs(la["avg_age"] - lb["avg_age"]) <= 0.1
        # n_new / n_final are not compared: a replenish fires when the live
        # track count falls under a threshold, which a few tracks more or
        # less cross at different frames.


def _write_plane_frames(tmp_path, n=4):
    world = PlaneSequence(width=320, height=240, fx=250.0, fy=250.0, cx=160.0, cy=120.0, z0=14.0, sx=0.3, sy=0.15,
                          baseline=0.5)
    poses = forward_trajectory(n, step=0.22, yaw_rate=0.0015)
    return [[np.clip(x, 0, 255).astype(np.uint8) for x in world.stereo_pair(T.astype(np.float64))] for T in poses], poses


def _kitti_layout(tmp_path):
    pairs, poses = _write_plane_frames(tmp_path)
    seq = tmp_path / "sequences" / "00"
    for cam in ("image_0", "image_1"):
        (seq / cam).mkdir(parents=True)
    for i, (l, r) in enumerate(pairs):
        Image.fromarray(l).save(seq / "image_0" / f"{i:06d}.png")
        Image.fromarray(r).save(seq / "image_1" / f"{i:06d}.png")
    (seq / "times.txt").write_text("".join(f"{i * 0.1:.6f}\n" for i in range(len(pairs))))
    (seq / "calib.txt").write_text("P0: 250 0 160 0 0 250 120 0 0 0 1 0\nP1: 250 0 160 -125 0 250 120 0 0 0 1 0\n")
    (tmp_path / "poses").mkdir()
    (tmp_path / "poses" / "00.txt").write_text(
        "".join(" ".join(str(v) for v in T[:3, :4].reshape(-1)) + "\n" for T in poses))
    return str(tmp_path)


def _small(cfg):
    cfg.extractor.n_features = 256
    cfg.extractor.n_bins_u, cfg.extractor.n_bins_v = 16, 8
    cfg.map.landmark_capacity = 1024
    cfg.keyframe.n_max_keyframes_in_window = 5
    cfg.extractor.thres_fastscore = 8.0
    cfg.tracker.max_level = 3
    return cfg


def _direct(vo, frames, mode):
    for ts, l, r in frames:
        if mode == "stereo":
            vo.track_stereo_images(l, r, ts)
        else:
            vo.track_image(l, ts)
    return vo


def _same_trajectory_file(tmp_path, out, traj):
    ref = tmp_path / "direct_poses.txt"
    save_kitti_trajectory(str(ref), np.stack(traj))
    assert (tmp_path / out / "frame_poses.txt").read_text() == ref.read_text()


def test_kitti_layout_matches_the_driver_called_directly(tmp_path, monkeypatch):
    root = _kitti_layout(tmp_path)
    ds = TD.KittiOdometry(root, "00")
    monkeypatch.setattr(TD.KittiOdometry, "config", lambda self, _c=TD.KittiOdometry.config: _small(_c(self)))
    for extra, tag in (([], "per_frame"), (["--batch", "2"], "batch")):
        s = run_vo.main(["--dataset", "kitti", "--root", root, "--mode", "stereo", "--out", str(tmp_path / tag),
                         "--device", "cpu", "--quiet"] + extra)
        assert s["frames"] == 4 and len(_records(str(tmp_path / tag))) == 4
        recs = _records(str(tmp_path / tag))
        assert [r["timestamp"] for r in recs] == [f.timestamp for f in ds.frames]
        assert s["ate_rmse"] < 0.05 * 0.22 * 3 and s["mean_n_final"] > 30  # it tracks
    vo = _direct(StereoVO(ds.config(), device="cpu"), ds, "stereo")
    _same_trajectory_file(tmp_path, "per_frame", vo.trajectory)
    # The batch run takes the same steps on the same frames.
    np.testing.assert_allclose(np.loadtxt(tmp_path / "batch" / "frame_poses.txt"),
                               np.loadtxt(tmp_path / "per_frame" / "frame_poses.txt"), atol=1e-6, rtol=0)


def _euroc_layout(tmp_path):
    pairs, poses = _write_plane_frames(tmp_path)
    t0 = 1403636579763555584
    for c, cam in enumerate(("cam0", "cam1")):
        d = tmp_path / "mav0" / cam / "data"
        d.mkdir(parents=True)
        rows = ["#timestamp [ns],filename"]
        for i, pair in enumerate(pairs):
            t = t0 + i * 50_000_000
            Image.fromarray(pair[c]).save(d / f"{t}.png")
            rows.append(f"{t},{t}.png")
        (tmp_path / "mav0" / cam / "data.csv").write_text("\n".join(rows))
    cfg = tmp_path / "tiny_euroc.yaml"
    cam = "".join(f"Camera.{side}.{k}: {v}\n" for side in ("left", "right")
                  for k, v in (("fx", 250.0), ("fy", 250.0), ("cx", 160.0), ("cy", 120.0), ("width", 320),
                               ("height", 240)))
    cfg.write_text("%YAML:1.0\nflagDoUndistortion: 0\n" + cam
                   + "T_lr: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n"
                   + "  data: [1,0,0,0.5, 0,1,0,0, 0,0,1,0, 0,0,0,1]\n"
                   + "feature_tracker.max_level: 3\nfeature_extractor.n_features: 256\n"
                   + "feature_extractor.n_bins_u: 16\nfeature_extractor.n_bins_v: 8\nfeature_extractor.thres_fastscore: 8.0\n")
    return str(tmp_path), str(cfg)


@pytest.mark.parametrize("mode", ["stereo", "mono"])
def test_euroc_layout_matches_the_driver_called_directly(tmp_path, mode):
    root, cfg_path = _euroc_layout(tmp_path)
    s = run_vo.main(["--dataset", "euroc", "--root", root, "--config", cfg_path, "--mode", mode,
                     "--out", str(tmp_path / "out"), "--device", "cpu", "--quiet"])
    assert s["frames"] == 4 and "ate_rmse" not in s  # no ground truth in this layout
    assert mode == "mono" or s["mean_n_final"] > 30  # stereo tracks from the first frame
    ds = TD.EurocMav(root, stereo=mode == "stereo")
    cls = StereoVO if mode == "stereo" else MonoVO
    vo = _direct(cls(load_yaml(cfg_path), device="cpu"), ds, mode)
    _same_trajectory_file(tmp_path, "out", vo.trajectory)


def test_exits_with_the_reference_messages(tmp_path):
    with pytest.raises(SystemExit, match="--config YAML is required for EuRoC"):
        run_vo.main(["--dataset", "euroc", "--root", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no frames processed"):
        run_vo.main(["--dataset", "kitti", "--root", str(tmp_path / "missing"), "--out", str(tmp_path / "o"),
                     "--device", "cpu", "--quiet"])


def test_interrupt_dumps_then_exits_130_and_optional_outputs(tmp_path, monkeypatch, capsys):
    """An interrupt after three frames dumps them and exits 130. Without
    matplotlib the plot is the one output skipped, with a line saying so;
    --trace writes a Chrome trace and --debug-images the overlays."""
    build = run_vo.build_dataset

    def interrupted(args):
        ds, cfg, gt = build(args)

        def frames():
            for i, item in enumerate(ds):
                if i == 3:
                    raise KeyboardInterrupt
                yield item

        return frames(), cfg, gt

    monkeypatch.setattr(run_vo, "build_dataset", interrupted)
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        run_vo.main(["--dataset", "synthetic", "--frames", "6", "--mode", "stereo", "--out", str(out),
                     "--device", "cpu", "--quiet", "--trace", str(tmp_path / "trace"), "--debug-images"])
    assert e.value.code == 130
    err = capsys.readouterr().err
    assert "interrupted" in err and "trajectory.png not written: matplotlib is not installed" in err
    assert len(_records(str(out))) == 3 and np.loadtxt(out / "frame_poses.txt").shape == (3, 13)
    assert not (out / "trajectory.png").exists()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"vo.entry", "vo.track", "vo.pose"} <= names  # the pipelines' stage spans, on for --trace
    assert sorted(os.listdir(out / "debug")) == ["000000.png", "000001.png", "000002.png"]
