"""The ported stereo pipeline against the JAX one, on CPU.

World: the tests/test_stereo_vo_pipeline.py plane sequence (640x480,
N = 384 tracks, 12 frames). The JAX pipeline runs with its jnp KLT leg (the
CPU default); the port runs its plain leg ("off") for tight parity and its
kernel leg ("on", plain kernel versions on CPU) against ground truth.
Checkpoints cross between the two packages in both directions.
"""

import os
import subprocess
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.config import VOConfig as JConfig  # noqa: E402
from visual_odometry_ros_tpu.io import checkpoint as JCK  # noqa: E402
from visual_odometry_ros_tpu.io.synthetic import PlaneSequence, forward_trajectory  # noqa: E402
from visual_odometry_ros_tpu.io.trajectory import ate_rmse, rpe  # noqa: E402
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JVO  # noqa: E402
from visual_odometry_ros_tpu_torch import io as tio  # noqa: E402
from visual_odometry_ros_tpu_torch.io import checkpoint as TCK  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import (  # noqa: E402
    StereoVO as TVO,
    state_from_numpy,
    state_to_numpy,
)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg(cls, use_pallas="auto"):
    """tests/test_stereo_vo_pipeline.py:_small_cfg, for either package's VOConfig."""
    cfg = cls()
    cfg.cam.fx = cfg.cam.fy = 500.0
    cfg.cam.cx, cfg.cam.cy = 320.0, 240.0
    cfg.cam.width, cfg.cam.height = 640, 480
    cfg.cam_right = cfg.cam
    cfg.T_lr = np.eye(4, dtype=np.float32)
    cfg.T_lr[0, 3] = 0.5
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = 384
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.extractor.score_min = 10.0
    cfg.extractor.thres_fastscore = 8.0
    cfg.map.landmark_capacity = 2048
    cfg.keyframe.n_max_keyframes_in_window = 5
    cfg.keyframe.thres_translation = 1.0
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    cfg.tracker.use_pallas = use_pallas
    return cfg


@pytest.fixture(scope="module")
def seq():
    world = PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    poses = forward_trajectory(12, step=0.22, yaw_rate=0.0015)
    frames = [world.stereo_pair(T.astype(np.float64)) for T in poses]
    return poses, frames


@pytest.fixture(scope="module")
def jvo():
    return JVO(small_cfg(JConfig))  # "auto" = jnp leg on CPU, same programs as the pipeline tests


@pytest.fixture(scope="module")
def jax_run(seq, jvo):
    """Drive the JAX pipeline frame by frame (as track_stereo_images does),
    keeping numpy snapshots of the state around each step."""
    _, frames = seq
    vo = jvo
    recs = []
    state = None
    for il, ir in frames:
        il_j, ir_j = jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32)
        if state is None:
            state = vo._first_frame(il_j, ir_j)
            recs.append(dict(post=jax.device_get(state), kf=True, T_wc=np.eye(4, dtype=np.float32)))
            continue
        rec = dict(pre=jax.device_get(state))
        state, fstats = vo._steady_step(state, il_j, ir_j)
        rec["steady"] = jax.device_get(state)
        rec["stats"] = jax.device_get(fstats)
        rec["kf"] = bool(fstats.need_keyframe)
        if rec["kf"]:
            state, ba_err, acc = vo._keyframe_step(state)
            rec["ba_err"], rec["ba_acc"] = float(ba_err), bool(acc)
        rec["T_wc"] = np.asarray(state.T_wc)
        rec["post"] = jax.device_get(state)
        recs.append(rec)
    return recs


def _port(use_pallas="off"):
    return TVO(small_cfg(tio.VOConfig, use_pallas), device="cpu")


def test_state_round_trip(jax_run):
    src = jax_run[4]["post"]
    back = state_to_numpy(state_from_numpy(src, device="cpu"))
    leaves_src = jax.tree_util.tree_leaves(src)
    leaves_back = jax.tree_util.tree_leaves(back)
    assert len(leaves_src) == len(leaves_back)
    for a, b in zip(leaves_src, leaves_back):
        assert np.asarray(a).dtype == b.dtype and np.asarray(a).shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)


def test_steady_step_from_jax_state(seq, jax_run):
    _, frames = seq
    i = next(k for k in range(2, len(jax_run)) if not jax_run[k]["kf"])
    pre, ref, st = jax_run[i]["pre"], jax_run[i]["steady"], jax_run[i]["stats"]
    vo = _port("off")
    il, ir = (torch.as_tensor(x, dtype=torch.float32) for x in frames[i])
    new, stats = vo._steady_step(state_from_numpy(pre, device="cpu"), il, ir)
    # Survivors: valid before and after, same landmark (not a refilled lane).
    keep = pre.tracks.valid & ref.tracks.valid & (pre.tracks.lm_idx == ref.tracks.lm_idx)
    assert keep.sum() > 100
    # pts1 after three KLT levels + scale refinement: float32 rounding of the
    # patch sums, well under the pose gate's pixel scale.
    np.testing.assert_allclose(new.tracks.pts.numpy()[keep], ref.tracks.pts[keep], atol=1e-3)
    np.testing.assert_array_equal(new.tracks.valid.numpy(), ref.tracks.valid)  # survived
    for f in ("n_tracked", "n_inliers", "n_new", "need_keyframe", "pose_ok"):
        assert int(getattr(stats, f)) == int(getattr(st, f)), f
    # Pose from the same correspondences through the same GN: 1e-5 m / rad.
    np.testing.assert_allclose(new.T_wc.numpy(), ref.T_wc, atol=1e-5)


def test_keyframe_step_from_jax_state(jax_run):
    i = next(k for k in range(1, len(jax_run)) if jax_run[k]["kf"])
    pre_kf, ref = jax_run[i]["steady"], jax_run[i]["post"]
    vo = _port("off")
    new, ba_err, acc = vo._keyframe_step(state_from_numpy(pre_kf, device="cpu"))
    assert bool(acc) == jax_run[i]["ba_acc"]
    # 10 BA iterations through a float32 Cholesky, sums in another order.
    np.testing.assert_allclose(float(ba_err), jax_run[i]["ba_err"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(new.T_wc.numpy(), ref.T_wc, atol=1e-4)
    np.testing.assert_allclose(new.ring.T_cw.numpy(), ref.ring.T_cw, atol=1e-4)
    alive = ref.arena.alive
    np.testing.assert_array_equal(new.arena.alive.numpy(), alive)
    np.testing.assert_array_equal(new.arena.triangulated.numpy(), ref.arena.triangulated)
    # Landmarks 10-20 m away, weakly constrained along their rays: 1e-3 relative.
    np.testing.assert_allclose(new.arena.Xw.numpy()[alive], ref.arena.Xw[alive], rtol=1e-3, atol=1e-3)


def test_full_run_plain_leg_matches_jax(seq, jax_run):
    poses, frames = seq
    vo = _port("off")
    for il, ir in frames:
        vo.track_stereo_images(il, ir)
    traj = np.stack(vo.trajectory)
    ref = np.stack([r["T_wc"] for r in jax_run])
    assert [s["keyframe"] for s in vo.stats_log] == [r["kf"] for r in jax_run]
    # Per-frame poses: float32 differences compound through 11 frames and
    # 2 BA windows; 1 mm and 1e-4 rad are far below the 2.4 m travelled.
    np.testing.assert_allclose(traj[:, :3, 3], ref[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(traj[:, :3, :3], ref[:, :3, :3], atol=1e-4)
    assert abs(ate_rmse(traj, poses, align="none") - ate_rmse(ref, poses, align="none")) < 1e-3


def test_full_run_kernel_leg_tracks_ground_truth(seq):
    """Bounds of test_stereo_vo_tracks_sequence and test_stereo_vo_keyframes_and_ba."""
    poses, frames = seq
    vo = _port("on")
    for il, ir in frames:
        vo.track_stereo_images(il, ir)
    traj = np.stack(vo.trajectory)
    assert len(traj) == len(poses)
    assert ate_rmse(traj, poses, align="none") < 0.05 * 0.22 * 11
    t_rmse, r_rmse = rpe(traj, poses)
    assert t_rmse < 0.02 and r_rmse < 0.2
    assert vo.stats_log[-1]["n_inliers"] > 50 and vo.stats_log[-1]["pose_ok"]
    assert sum(1 for s in vo.stats_log if s.get("keyframe")) >= 2
    ba = [s["ba_err"] for s in vo.stats_log if s.get("ba_err") is not None]
    assert len(ba) >= 2 and all(e < 1.0 for e in ba)


def test_timed_stages_stats_and_debug_overlay(seq):
    """tests/test_stereo_vo_pipeline.py:test_stage_timing_stats_and_debug_overlay
    on the port: timed=True fills every stage time, the funnel counts are
    filled, and debug_overlay draws markers over the frame."""
    _, frames = seq
    vo = _port("off")
    stats = None
    for il, ir in frames[:5]:
        _, stats = vo.track_stereo_images(il, ir, timed=True)
    sm = stats["stage_ms"]
    for k in ("time_track", "time_stereo", "time_pose", "time_new"):
        assert sm[k] > 0.0, (k, sm)
    assert stats["n_initial"] > 50 and stats["n_tracked"] > 50 and stats["avg_age"] > 1.0
    assert stats["n_ok_parallax"] >= 0
    rgb = vo.debug_overlay(frames[4][0])
    assert rgb.shape == (480, 640, 3) and rgb.dtype == np.uint8
    gray3 = np.stack([np.clip(frames[4][0], 0, 255).astype(np.uint8)] * 3, axis=-1)
    assert (rgb != gray3).any()


def test_timer_matches_jax_and_takes_a_state_to_wait_on(jax_run):
    """utils/timer: StageTimer accumulates as the reference's does; toc and
    StageTimer.stage wait on a whole state tree (dataclasses, tuples)."""
    from visual_odometry_ros_tpu.utils import timer as JT
    from visual_odometry_ros_tpu_torch.utils import timer as TT

    jt, tt = JT.StageTimer(), TT.StageTimer()
    for name, ms in [("track", 3.0), ("pose", 5.5), ("track", 4.0)]:
        jt.record(name, ms)
        tt.record(name, ms)
    assert tt.summary() == jt.summary() == {"track": 3.5, "pose": 5.5}
    assert tt.last_ms == jt.last_ms and dict(tt.counts) == dict(jt.counts)
    assert tt.mean_ms("absent") == jt.mean_ms("absent") == 0.0
    state = state_from_numpy(jax_run[4]["post"], device="cpu")
    assert TT.block_until_ready(state) is state
    with tt.stage("wait", block_on=state):
        pass
    assert tt.counts["wait"] == 1 and tt.last_ms["wait"] >= 0.0
    TT.tic()
    assert TT.toc(block_on=(state, [state.T_wc])) >= 0.0
    assert TT.StopWatch("s").stop_ms() >= 0.0


def _resume_frame(jax_run):
    """A frame i such that frames i + 1 and i + 2 are not keyframes."""
    return next(i for i in range(2, len(jax_run) - 2) if not jax_run[i + 1]["kf"] and not jax_run[i + 2]["kf"])


def test_checkpoint_crosses_both_ways(tmp_path, seq, jax_run, jvo):
    """JAX save_vo -> port load_vo -> the port's next frame equals JAX's
    (1e-5, as a steady step from JAX state); then port save_vo -> JAX
    load_vo -> JAX's next frame equals the port's."""
    _, frames = seq
    i = _resume_frame(jax_run)
    src = JVO(small_cfg(JConfig))
    src.state = jax_run[i]["post"]
    src.trajectory = [r["T_wc"] for r in jax_run[: i + 1]]
    src.kf_trajectory = [(k, r["T_wc"]) for k, r in enumerate(jax_run[: i + 1]) if r["kf"]]
    JCK.save_vo(str(tmp_path / "jax"), src)

    vo = _port("off")
    TCK.load_vo(str(tmp_path / "jax"), vo)
    assert len(vo.trajectory) == i + 1 and len(vo.kf_trajectory) == len(src.kf_trajectory)
    T_port, _ = vo.track_stereo_images(*frames[i + 1])
    np.testing.assert_allclose(T_port, jax_run[i + 1]["T_wc"], atol=1e-5)

    TCK.save_vo(str(tmp_path / "port"), vo)
    JCK.load_vo(str(tmp_path / "port"), jvo)
    assert len(jvo.trajectory) == i + 2
    T_jax, _ = jvo.track_stereo_images(*frames[i + 2])
    T_port, _ = vo.track_stereo_images(*frames[i + 2])
    np.testing.assert_allclose(T_port, T_jax, atol=1e-5)


def test_checkpoint_state_round_trip_and_shape_check(tmp_path, jax_run):
    """Port save_state -> load_state is bit-exact, with the reference's leaf
    keys; a template of another capacity is refused."""
    st = state_from_numpy(jax_run[4]["post"], device="cpu")
    TCK.save_state(str(tmp_path / "s.npz"), st)
    with np.load(str(tmp_path / "s.npz")) as data:
        keys = set(data.files)
    assert {"T_wc", "tracks/pts", "arena/desc", "ring/head", "pyr_prev/0/1", "fail_count"} <= keys
    back = TCK.load_state(str(tmp_path / "s.npz"), st)
    for (ka, a), (kb, b) in zip(TCK._leaves(st), TCK._leaves(back)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
    cfg = small_cfg(tio.VOConfig, "off")
    cfg.extractor.n_features = 128
    small = TVO(cfg, device="cpu")
    with pytest.raises(ValueError):
        TCK.load_state(str(tmp_path / "s.npz"), small.init_state(small._build_pyr(torch.zeros(480, 640))))


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import visual_odometry_ros_tpu_torch.models.stereo_vo, visual_odometry_ros_tpu_torch.ops.klt_kernels\n"
        "import visual_odometry_ros_tpu_torch.camera, visual_odometry_ros_tpu_torch.ops.pnp\n"
        "import visual_odometry_ros_tpu_torch.io.checkpoint, visual_odometry_ros_tpu_torch.utils.timer\n"
        "from visual_odometry_ros_tpu_torch import io\n"
        "import chip_smoke\n"
        "cfg = chip_smoke.bench_config(); io.forward_trajectory(3)\n"
        "io.ate_rmse(io.forward_trajectory(3), io.forward_trajectory(3))\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not any(m == 'visual_odometry_ros_tpu' or m.startswith('visual_odometry_ros_tpu.')"
        " for m in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
