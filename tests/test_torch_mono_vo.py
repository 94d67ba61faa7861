"""The ported mono pipeline against the JAX one, on CPU.

World and configuration: tests/test_mono_vo_pipeline.py (the two-plane world,
640x480, N = 384 tracks, 16 frames of forward motion with a lateral
component). The JAX pipeline runs its jnp KLT leg (the CPU default) through
`track_image`, with every stage call recorded; the port runs its plain leg
("off") for parity and its kernel leg ("on", plain kernel versions on CPU)
against ground truth.

RANSAC draws: the reference draws from `jax.random`; the parity tests hand
the port the reference's own draws, recomputed here from the recorded keys.
"""

import types

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.config import VOConfig as JConfig  # noqa: E402
from visual_odometry_ros_tpu.io import checkpoint as JCK  # noqa: E402
from visual_odometry_ros_tpu.io.synthetic import TwoPlaneSequence, forward_trajectory  # noqa: E402
from visual_odometry_ros_tpu.io.trajectory import ate_rmse  # noqa: E402
from visual_odometry_ros_tpu.models.mono_vo import MonoVO as JVO  # noqa: E402
from visual_odometry_ros_tpu_torch import io as tio  # noqa: E402
from visual_odometry_ros_tpu_torch.io import checkpoint as TCK  # noqa: E402
from visual_odometry_ros_tpu_torch.models.mono_vo import (  # noqa: E402
    MonoVO as TVO,
    state_from_numpy,
    state_to_numpy,
)

from test_torch_epipolar import jax_essential_draws  # noqa: E402
from test_torch_recovery import N_HYP  # noqa: E402

torch.set_num_threads(2)
_STAGES = ("_first_frame", "_init_track", "_init_bootstrap", "_steady_step", "_fallback_5pt",
           "_keyframe_step", "_recover")


def mono_cfg(cls, use_pallas="auto"):
    """tests/test_mono_vo_pipeline.py:_mono_cfg, for either package's VOConfig."""
    cfg = cls()
    cfg.cam.fx = cfg.cam.fy = 500.0
    cfg.cam.cx, cfg.cam.cy = 320.0, 240.0
    cfg.cam.width, cfg.cam.height = 640, 480
    cfg.extractor.n_features = 384
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.extractor.score_min = 10.0
    cfg.extractor.thres_fastscore = 8.0
    cfg.map.landmark_capacity = 2048
    cfg.map.thres_parallax = 0.4
    cfg.keyframe.n_max_keyframes_in_window = 5
    cfg.keyframe.thres_translation = 1e9  # mono scale is arbitrary: use overlap
    cfg.keyframe.thres_overlap_ratio = 0.75
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    cfg.tracker.thres_sampson = 100.0
    cfg.tracker.use_pallas = use_pallas
    return cfg


@pytest.fixture(scope="module")
def seq():
    world = TwoPlaneSequence(z0_a=9.0, z0_b=18.0)
    poses = forward_trajectory(16, step=0.3, yaw_rate=0.001, lateral=0.12)
    return poses, [world.render(np.linalg.inv(T.astype(np.float64))) for T in poses]


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX MonoVO through track_image, each stage call recorded as
    {frame, name, args, out} (device arrays: consecutive states share their
    buffers). Returns (vo, calls)."""
    _, frames = seq
    vo = JVO(mono_cfg(JConfig))
    calls = []

    def record(name):
        fn = getattr(vo, name)

        def run(*args):
            out = fn(*args)
            calls.append(dict(frame=len(vo.trajectory), name=name, args=args, out=out))
            return out

        setattr(vo, name, run)

    for name in _STAGES:
        record(name)
    for f in frames:
        vo.track_image(f)
    return vo, calls


def np_tree(x):
    return jax.device_get(x)


def essential_keys(calls):
    """The reference's RANSAC keys in call order (bootstrap and fallback)."""
    return [c["args"][-1] for c in calls if c["name"] in ("_init_bootstrap", "_fallback_5pt")]


def jax_recovery_draws(frame_id):
    """The reference's recovery PnP draws at `frame_id` (mono_vo.py:624, pnp.py sampler)."""
    key = jax.random.fold_in(jax.random.key(0x5EC1), frame_id)

    def draw(valid):
        v = jnp.asarray(valid.cpu().numpy())
        p = v.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        ks = jax.random.split(key, N_HYP)
        idx = jax.vmap(lambda k: jax.random.choice(k, v.shape[0], shape=(6,), replace=False, p=p))(ks)
        return torch.as_tensor(np.asarray(idx))

    return draw


def port(calls, use_pallas="off"):
    """A CPU MonoVO whose RANSAC draws are the reference's, in call order."""
    vo = TVO(mono_cfg(tio.VOConfig, use_pallas), device="cpu")
    keys = iter(essential_keys(calls))
    vo._draw_essential = lambda valid: jax_essential_draws(next(keys), valid.numpy())
    vo._draw_recovery = lambda frame_id, valid: jax_recovery_draws(frame_id)(valid)
    return vo


@pytest.fixture(scope="module")
def port_run(seq, jax_run):
    _, frames = seq
    vo = port(jax_run[1])
    for f in frames:
        vo.track_image(f)
    return vo


def test_state_round_trip(jax_run):
    src = np_tree(next(c for c in jax_run[1] if c["name"] == "_steady_step")["out"][0])
    back = state_to_numpy(state_from_numpy(src, device="cpu"))
    leaves_src, leaves_back = jax.tree_util.tree_leaves(src), jax.tree_util.tree_leaves(back)
    assert len(leaves_src) == len(leaves_back)
    for a, b in zip(leaves_src, leaves_back):
        assert np.asarray(a).dtype == b.dtype and np.asarray(a).shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)


def test_plain_leg_matches_jax_frame_by_frame(seq, jax_run, port_run):
    """Same phase per frame, bootstrap frame and keyframes; T_wc within
    2e-3 in bootstrap units (||t|| = 1 over the bootstrap span) and rotation
    within 1e-3: the bootstrap's essential matrix carries the float32 error
    of the reference's unnormalised 8-point solve (test_torch_epipolar.py
    holds the two packages to 1e-8 in float64 and explains the float32
    spread), and every later pose is relative to it."""
    jvo, _ = jax_run
    vo = port_run
    phases = [s["phase"] for s in vo.stats_log]
    assert phases == [s["phase"] for s in jvo.stats_log]
    assert "bootstrapped" in phases and phases.count("steady") >= 5
    assert [s["keyframe"] for s in vo.stats_log] == [s["keyframe"] for s in jvo.stats_log]
    steady = [(a, b) for a, b in zip(vo.stats_log, jvo.stats_log) if a["phase"] == "steady"]
    assert [a["pose_ok"] for a, _ in steady] == [b["pose_ok"] for _, b in steady]
    for a, b in steady:
        assert abs(a["n_inliers"] - b["n_inliers"]) <= 0.02 * b["n_inliers"] + 2, (a, b)
    traj, ref = np.stack(vo.trajectory), np.stack(jvo.trajectory)
    np.testing.assert_allclose(traj[:, :3, 3], ref[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(traj[:, :3, :3], ref[:, :3, :3], atol=1e-3)
    poses, _ = seq
    b = phases.index("bootstrapped")
    assert abs(ate_rmse(traj[b:], poses[b:], align="sim3") - ate_rmse(ref[b:], poses[b:], align="sim3")) < 1e-3


def test_steady_step_from_jax_state(seq, jax_run):
    """One steady step from the reference's state: the same survivors and
    counts, pts1 to 1e-3 px, T_wc to 1e-5."""
    _, frames = seq
    c = [c for c in jax_run[1] if c["name"] == "_steady_step"][3]
    pre, (ref, sc) = np_tree(c["args"][0]), np_tree(c["out"])
    vo = TVO(mono_cfg(tio.VOConfig, "off"), device="cpu")
    img = torch.as_tensor(frames[c["frame"]], dtype=torch.float32)
    new, stats = vo._steady_step(state_from_numpy(pre, device="cpu"), img)
    keep = pre.tracks.valid & ref.tracks.valid & (pre.tracks.lm_idx == ref.tracks.lm_idx)
    assert keep.sum() > 100
    np.testing.assert_allclose(new.tracks.pts.numpy()[keep], ref.tracks.pts[keep], atol=1e-3)
    np.testing.assert_array_equal(new.tracks.valid.numpy(), ref.tracks.valid)
    for f in ("n_tracked", "n_gn", "n_inliers", "n_new", "need_keyframe", "pose_ok", "n_pass_1p"):
        assert int(getattr(stats, f)) == int(sc[f]), f
    np.testing.assert_allclose(float(stats.steering_angle), float(sc["steering_angle"]), atol=1e-6)
    np.testing.assert_allclose(new.T_wc.numpy(), ref.T_wc, atol=1e-5)
    np.testing.assert_allclose(float(new.step_len), float(ref.step_len), atol=1e-5)


def test_keyframe_step_from_jax_state(jax_run):
    """Depth filter, promotion, triangulation and BA from the reference's
    state: the same accept, triangulated set and counts, poses to 1e-4."""
    jvo, calls = jax_run
    kfs = [c for c in calls if c["name"] == "_keyframe_step"]
    c = max(kfs, key=lambda c: int(c["out"][2]))  # the one that triangulates most
    pre = np_tree(c["args"][0])
    ref, ba_err, n_tri, acc = np_tree(c["out"])
    vo = TVO(mono_cfg(tio.VOConfig, "off"), device="cpu")
    new, ba_err_t, n_tri_t, acc_t = vo._keyframe_step(state_from_numpy(pre, device="cpu"))
    assert bool(acc_t) == bool(acc) and int(n_tri_t) == int(n_tri) and int(n_tri) > 0
    np.testing.assert_allclose(float(ba_err_t), float(ba_err), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(new.T_wc.numpy(), ref.T_wc, atol=1e-4)
    np.testing.assert_allclose(new.ring.T_cw.numpy(), ref.ring.T_cw, atol=1e-4)
    np.testing.assert_array_equal(new.arena.alive.numpy(), ref.arena.alive)
    np.testing.assert_array_equal(new.arena.triangulated.numpy(), ref.arena.triangulated)
    alive = ref.arena.alive
    for f in ("Xw", "inv_depth"):
        np.testing.assert_allclose(getattr(new.arena, f).numpy()[alive], getattr(ref.arena, f)[alive],
                                   rtol=1e-3, atol=1e-3)
    for f in ("df_a", "df_b"):
        np.testing.assert_allclose(getattr(new.arena, f).numpy(), getattr(ref.arena, f), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(new.tracks.scale.numpy(), ref.tracks.scale, rtol=1e-4, atol=1e-5)


def test_fallback_from_jax_state(jax_run):
    """The 5-point fallback on every steady step's states, with the
    reference's draws: the same fb_ok, track mask and births, and the step
    length carried over exactly (scale propagation). The motion itself is a
    one-frame 5-point solve at 0.3 m of baseline against 9-18 m of depth:
    the reference's own answer moves by 1e-2 to 4e-2 in T_wc when only its
    key changes, and the float32 error of its unnormalised 8-point solve
    (test_torch_epipolar.py) moves it the same way. So the rotation is held
    to 5e-3 and the direction of the step to a cosine > 0.985."""
    jvo, calls = jax_run
    key = jax.random.key(11)
    vo = TVO(mono_cfg(tio.VOConfig, "off"), device="cpu")
    for c in [c for c in calls if c["name"] == "_steady_step"]:
        prev, new = np_tree(c["args"][0]), np_tree(c["out"][0])
        ref, fb_ok = np_tree(jvo._fallback_5pt(prev, new, key))
        ok = prev.tracks.valid & new.tracks.valid
        out, fb_ok_t = vo._fallback_5pt(state_from_numpy(prev, device="cpu"), state_from_numpy(new, device="cpu"),
                                        idx=jax_essential_draws(key, ok))
        assert bool(fb_ok) and bool(fb_ok_t)
        np.testing.assert_array_equal(out.tracks.valid.numpy(), ref.tracks.valid)
        np.testing.assert_array_equal(out.arena.alive.numpy(), ref.arena.alive)
        assert int(out.fail_count) == int(ref.fail_count) == 0
        d_ref = np.linalg.inv(prev.T_wc) @ ref.T_wc
        d_out = np.linalg.inv(prev.T_wc) @ out.T_wc.numpy()
        np.testing.assert_allclose(np.linalg.norm(d_out[:3, 3]), float(prev.step_len), rtol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(d_ref[:3, 3]), float(prev.step_len), rtol=1e-5)
        np.testing.assert_allclose(d_out[:3, :3], d_ref[:3, :3], atol=5e-3)
        cos = d_out[:3, 3] @ d_ref[:3, 3] / (np.linalg.norm(d_out[:3, 3]) * np.linalg.norm(d_ref[:3, 3]))
        assert cos > 0.985, (c["frame"], cos)


@pytest.mark.parametrize("mode", [1, 2])
def test_recovery_from_jax_state(jax_run, mode):
    """`_recover` on a steady state with the reference's draws: PnP on the
    tracked landmarks (mode 1), or, with every track dropped, a re-bootstrap
    (mode 2). The same mode and track mask, T_wc to 1e-4."""
    jvo, calls = jax_run
    state = np_tree([c for c in calls if c["name"] == "_steady_step"][-2]["out"][0])
    if mode == 2:
        state = state._replace(tracks=state.tracks._replace(valid=np.zeros_like(state.tracks.valid)))
    ref, ref_mode = np_tree(jvo._recover(state))
    assert int(ref_mode) == mode
    vo = TVO(mono_cfg(tio.VOConfig, "off"), device="cpu")
    new, got = vo._recover(state_from_numpy(state, device="cpu"), draw=jax_recovery_draws(int(state.frame_id)))
    assert int(got) == mode
    np.testing.assert_allclose(new.T_wc.numpy(), ref.T_wc, atol=1e-4)
    np.testing.assert_array_equal(new.tracks.valid.numpy(), ref.tracks.valid)
    assert int(new.fail_count) == 0
    if mode == 2:
        np.testing.assert_array_equal(new.ring.valid.numpy(), ref.ring.valid)
        assert int(new.ring.count) == 1


def test_kernel_leg_tracks_ground_truth(seq):
    """tests/test_mono_vo_pipeline.py's bounds on the port's kernel leg (the
    plain kernel versions on CPU), with the port's own draws."""
    poses, frames = seq
    vo = TVO(mono_cfg(tio.VOConfig, "on"), device="cpu")
    for f in frames:
        vo.track_image(f)
    phases = [s["phase"] for s in vo.stats_log]
    b = phases.index("bootstrapped")
    assert b < 8
    steady = [s for s in vo.stats_log if s["phase"] == "steady"]
    assert len(steady) >= 5 and np.mean([s["pose_ok"] for s in steady]) > 0.8
    path = np.sum(np.linalg.norm(np.diff(poses[b:, :3, 3], axis=0), axis=1))
    assert ate_rmse(np.stack(vo.trajectory)[b:], poses[b:], align="sim3") < 0.08 * path
    assert sum(s.get("n_triangulated", 0) for s in vo.stats_log if s.get("keyframe")) > 20


def test_batch_equals_sequential(seq, jax_run, port_run):
    """track_batch after a per-frame bootstrap gives the per-frame run's
    poses (1e-4) and keyframes."""
    _, frames = seq
    vo = port(jax_run[1])
    i = 0
    while vo.phase != 2:
        vo.track_image(frames[i])
        i += 1
    out = vo.track_batch(np.stack(frames[i:]))
    assert len(out) == len(frames) - i
    ref = port_run.stats_log
    assert not any(s.get("used_fallback") for s in ref)
    np.testing.assert_allclose(np.stack(vo.trajectory), np.stack(port_run.trajectory), atol=1e-4)
    assert [s["keyframe"] for s in vo.stats_log] == [s["keyframe"] for s in ref]
    for a, b in zip(out, ref[i:]):
        assert {k: a[k] for k in ("n_inliers", "n_new", "pose_ok", "recovered")} == {
            k: b[k] for k in ("n_inliers", "n_new", "pose_ok", "recovered")}
    with pytest.raises(RuntimeError):
        TVO(mono_cfg(tio.VOConfig, "off"), device="cpu").track_batch(np.stack(frames[:2]))


def test_timed_stages_stats_and_debug_overlay(seq, jax_run):
    """timed=True fills every stage time (time_ba on a keyframe); the
    overlay draws over the frame."""
    _, frames = seq
    vo = port(jax_run[1])
    stats = []
    for f in frames:
        stats.append(vo.track_image(f, timed=True)[1])
    sm = [s["stage_ms"] for s in stats if "stage_ms" in s]
    assert len(sm) == sum(s["phase"] == "steady" for s in stats) >= 5
    for d in sm:
        assert all(d[k] > 0.0 for k in ("time_track", "time_1p", "time_pose", "time_new")), d
    assert any("time_ba" in d for d in sm)
    rgb = vo.debug_overlay(frames[-1])
    assert rgb.shape == (480, 640, 3) and rgb.dtype == np.uint8
    gray3 = np.stack([np.clip(frames[-1], 0, 255).astype(np.uint8)] * 3, axis=-1)
    assert (rgb != gray3).any()


def test_checkpoint_crosses_both_ways_with_phase(tmp_path, seq, jax_run, port_run):
    """JAX save_vo -> port load_vo (phase 2 restored) -> the port's next frame
    equals JAX's (1e-5); port save_vo -> JAX load_vo -> JAX's next frame
    equals the port's."""
    _, frames = seq
    jvo, calls = jax_run
    steps = [c for c in calls if c["name"] == "_steady_step"]
    # A frame i whose next two frames are neither keyframes nor fallbacks.
    log = jvo.stats_log
    i = next(c["frame"] for c in steps[1:] if all(
        log[k]["phase"] == "steady" and not log[k]["keyframe"] and log[k]["pose_ok"]
        for k in (c["frame"], c["frame"] + 1, c["frame"] + 2)))
    post = next(c for c in steps if c["frame"] == i)["out"][0]
    src = types.SimpleNamespace(state=post, phase=2, trajectory=list(jvo.trajectory[: i + 1]),
                                kf_trajectory=[(k, T) for k, T in jvo.kf_trajectory if k <= i])
    JCK.save_vo(str(tmp_path / "jax"), src)

    vo = TVO(mono_cfg(tio.VOConfig, "off"), device="cpu")
    TCK.load_vo(str(tmp_path / "jax"), vo)
    assert vo.phase == 2 and len(vo.trajectory) == i + 1
    T_port, _ = vo.track_image(frames[i + 1])
    np.testing.assert_allclose(T_port, jvo.trajectory[i + 1], atol=1e-5)

    TCK.save_vo(str(tmp_path / "port"), vo)
    with np.load(str(tmp_path / "port.state.npz")) as data:
        assert {"pyr_first/0/0", "pyr_prev/2/1", "init_pts0", "step_len", "tracks/scale"} <= set(data.files)
    jvo.phase = 0
    JCK.load_vo(str(tmp_path / "port"), jvo)
    assert jvo.phase == 2 and len(jvo.trajectory) == i + 2
    T_jax, _ = jvo.track_image(frames[i + 2])
    T_port, _ = vo.track_image(frames[i + 2])
    np.testing.assert_allclose(T_port, T_jax, atol=1e-5)


def test_checkpoint_state_round_trip(tmp_path, jax_run):
    st = state_from_numpy(np_tree(next(c for c in jax_run[1] if c["name"] == "_steady_step")["out"][0]), device="cpu")
    TCK.save_state(str(tmp_path / "s.npz"), st)
    back = TCK.load_state(str(tmp_path / "s.npz"), st)
    for (ka, a), (kb, b) in zip(TCK._leaves(st), TCK._leaves(back)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
