"""The port's accuracy leg (`visual_odometry_ros_tpu_torch.eval_accuracy`)
against the JAX package's scripts/eval_accuracy.py, on CPU, at a small size.

The sequence: the first frames of the HardSequence at 160x120 (intrinsics
scaled from the 640x480 camera: fx = fy = 125, cx = 80, cy = 60), rendered
once by the port. Both harnesses run their own schedule functions
(`run_stereo`, `run_mono`) with chunks of 5 frames over 9 frames (so the
reference's two scans have one length and compile once), the reference's
configuration at that size and the jnp leg (the port's "off"), on the same
frames. Bounds: tests/test_torch_batch.py's for chunked runs, positions
1e-3 m and rotations 1e-4 (float32 differences through a BA window).
"""

import hashlib
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import concurrent.futures  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from reference_mono_smoke import jax_config  # noqa: E402
from scripts import eval_accuracy as JEA  # noqa: E402
from visual_odometry_ros_tpu.models.mono_vo import MonoVO as JMono  # noqa: E402
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JStereo  # noqa: E402
from visual_odometry_ros_tpu_torch import eval_accuracy as EA  # noqa: E402

SIZE = (160, 120)
N = 9
CHUNK = 5

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    return EA.load_frames(N, SIZE, cache=False, workers=2)


@pytest.fixture
def chunks(monkeypatch):
    monkeypatch.setattr(EA, "CHUNK", CHUNK)
    monkeypatch.setattr(JEA, "CHUNK", CHUNK)


def test_scaled_configuration():
    cfg = EA._config("off", SIZE)
    assert (cfg.cam.fx, cfg.cam.fy, cfg.cam.cx, cfg.cam.cy, cfg.cam.width, cfg.cam.height) == (
        125.0, 125.0, 80.0, 60.0, 160, 120)
    ref = EA._config("auto")
    assert (ref.cam.fx, ref.cam.cx, ref.cam.cy, ref.extractor.n_features, ref.map.landmark_capacity,
            ref.keyframe.n_max_keyframes_in_window, ref.keyframe.thres_translation, ref.tracker.max_level,
            ref.tracker.max_iter, float(ref.T_lr[0, 3])) == (500.0, 320.0, 240.0, 512, 4096, 7, 1.2, 3, 15, 0.5)
    assert EA.resolve_kernels("auto", "cpu") == "off" and EA.resolve_kernels("on", "cpu") == "on"


def test_stereo_matches_jax(monkeypatch, frames, chunks):
    il, ir, poses = frames
    monkeypatch.setattr(JEA, "build_stereo", lambda use_pallas: JStereo(jax_config(EA._config("off", SIZE))))
    tj, _, jlog = JEA.run_stereo(list(zip(il, ir)), False)
    tt, wall, tlog = EA.run_stereo(il, ir, "off", "cpu", SIZE)
    assert tt.shape == tj.shape == (N, 4, 4) and wall > 0
    np.testing.assert_allclose(tt[:, :3, 3], tj[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(tt[:, :3, :3], tj[:, :3, :3], atol=1e-4)
    for k in ("keyframe", "pose_ok", "recovered"):
        assert [s.get(k) for s in tlog] == [s.get(k) for s in jlog], k
    assert sum(1 for s in tlog if s.get("pose_ok")) >= N // 2


def test_mono_matches_jax(monkeypatch, frames, chunks):
    """At this size and length mono stays in its init phase (the features
    move too little for the bootstrap): the same phases and poses."""
    il = list(frames[0])
    monkeypatch.setattr(JEA, "build_mono", lambda use_pallas: JMono(jax_config(EA._config("off", SIZE, mono=True))))
    tj, _, jfirst = JEA.run_mono(il, False)
    tt, _, tfirst = EA.run_mono(il, "off", "cpu", SIZE)
    assert tt.shape == tj.shape == (N, 4, 4) and tfirst == jfirst
    np.testing.assert_allclose(tt[:, :3, 3], tj[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(tt[:, :3, :3], tj[:, :3, :3], atol=1e-4)


def test_cache_key_follows_every_world_parameter_and_the_renderer():
    params = EA.world_params(N, SIZE)
    assert set(params) == {"frames", "step", "seed", "baseline", "width", "height"}
    src = "class HardSequence: ...\n"
    base = EA.cache_key(params, src)
    keys = {base}
    for k, v in params.items():
        keys.add(EA.cache_key(dict(params, **{k: v * 2 + 1}), src))
    keys.add(EA.cache_key(params, src + "# changed\n"))
    assert len(keys) == len(params) + 2
    assert EA.cache_key(dict(reversed(list(params.items()))), src) == base
    assert EA.cache_key(params) != base  # the default is the renderer's own source


def test_cached_frames_are_reused_without_rendering(monkeypatch, tmp_path):
    monkeypatch.setattr(EA, "CACHE_DIR", tmp_path / "accuracy")
    il, ir, poses = EA.load_frames(3, SIZE, workers=1)
    files = list((tmp_path / "accuracy").iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"

    def refuse(*a, **kw):
        raise AssertionError("rendered although the frames were cached")

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", refuse)
    il2, ir2, poses2 = EA.load_frames(3, SIZE)
    assert np.array_equal(il, il2) and np.array_equal(ir, ir2) and np.array_equal(poses, poses2)
    assert il2.dtype == np.float32 and il2.shape == (3, 120, 160)
    with pytest.raises(AssertionError, match="rendered"):
        EA.load_frames(3, SIZE, cache=False)


def test_main_writes_its_own_files_and_leaves_accuracy_json_alone(monkeypatch, tmp_path):
    """main at the reference's size over 2 frames, writing into a
    directory of its own."""
    ref = {name: hashlib.sha256(open(os.path.join(REPO, name), "rb").read()).hexdigest()
           for name in ("ACCURACY.json", "ACCURACY.md")}
    monkeypatch.setattr(EA, "CACHE_DIR", tmp_path / "cache")
    out = tmp_path / "out"
    rec = EA.main(["--device", "cpu", "--frames", "2", "--tag", "cpu_short", "--out", str(out)])
    for name, h in ref.items():
        assert hashlib.sha256(open(os.path.join(REPO, name), "rb").read()).hexdigest() == h, name
    assert sorted(p.name for p in out.iterdir()) == ["ACCURACY_TORCH.json", "ACCURACY_TORCH.md"]
    assert rec["platform"] == "cpu" and rec["kernels"] == "plain" and rec["frames"] == 2 and rec["card"] is None
    assert rec["size"] == [640, 480] and rec["klt_leg"] == "off"
    assert set(rec["stereo"]) >= {"ate_rmse_m", "rpe_trans_m", "rpe_rot_deg", "n_pose_fail", "n_recoveries"}
    assert rec["mono"]["ate_rmse_sim3_m"] is None or np.isfinite(rec["mono"]["ate_rmse_sim3_m"])
    md = (out / "ACCURACY_TORCH.md").read_text()
    assert "cpu_short" in md and "not the gated sequence" in md and "0.2402 m" in md and "0.2428 m" in md and "| cpu (JAX) |" in md


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the leg there")
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        EA.main(["--frames", "2"])
    with pytest.raises((RuntimeError, AssertionError)):
        EA.build_stereo()
