"""Tracking-loss recovery in the port against the JAX package, on CPU.

Worlds: the blackout sequence of tests/test_stereo_vo_pipeline.py (6
moving frames, then a stationary camera; frames 6-8 are uncorrelated noise
in both eyes), on its 640x480 plane and on a 640x480 corridor. The pose
fails on the noise frames, and recovery fires once the failures reach
`recover_after` = 3: a re-bootstrap (mode 2) on the last noise frame, then
descriptor relocalization (mode 3) three frames later.

The state parity tests run on the corridor. On the plane every 6-point DLT
hypothesis is degenerate (coplanar points leave a 4-dimensional null
space), so which null vector `eigh` returns, and with it the winning
hypothesis, is arbitrary in both packages; the plane world checks the
port's own recovery against ground truth instead.

RANSAC draws: the reference draws from `jax.random`; the parity tests hand
the port the reference's own draws, recomputed here from the same keys.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.config import VOConfig as JConfig  # noqa: E402
from visual_odometry_ros_tpu.io.synthetic import (  # noqa: E402
    CorridorSequence,
    PlaneSequence,
    forward_trajectory,
)
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JVO  # noqa: E402
from visual_odometry_ros_tpu_torch import io as tio  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO as TVO, state_from_numpy  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pnp as TPNP  # noqa: E402

from test_torch_stereo_vo import small_cfg  # noqa: E402

torch.set_num_threads(2)
N_HYP = 128  # the reference's recovery hypotheses


def blackout_frames(world, poses):
    frames = [world.stereo_pair(T.astype(np.float64)) for T in poses]
    rng = np.random.default_rng(3)
    for i in range(6, 9):
        frames[i] = tuple(rng.uniform(0, 255, frames[i][0].shape).astype(np.float32) for _ in range(2))
    return frames


@pytest.fixture(scope="module")
def poses():
    p = forward_trajectory(6, step=0.22, yaw_rate=0.0015)
    return np.concatenate([p, np.repeat(p[-1:], 8, axis=0)])


@pytest.fixture(scope="module")
def plane_frames(poses):
    return blackout_frames(PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5), poses)


@pytest.fixture(scope="module")
def corridor_frames(poses):
    world = CorridorSequence.fit(poses, width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                 baseline=0.5)
    return blackout_frames(world, poses)


@pytest.fixture(scope="module")
def jax_run(corridor_frames):
    """The JAX pipeline frame by frame over the corridor, with state
    snapshots around each step; also returns the JAX StereoVO."""
    frames = corridor_frames
    vo = JVO(small_cfg(JConfig))
    recs = []
    state = None
    for il, ir in frames:
        il_j, ir_j = jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32)
        if state is None:
            state = vo._first_frame(il_j, ir_j)
            recs.append(dict(mode=0))
            continue
        rec = dict(pre=jax.device_get(state))
        state, fstats = vo._steady_step(state, il_j, ir_j)
        rec["steady"] = jax.device_get(state)
        rec["mode"] = int(fstats.recovered)
        if bool(fstats.need_keyframe):
            state, _, _ = vo._keyframe_step(state)
        recs.append(rec)
    return vo, recs


def jax_draws(frame_id: int):
    """draw(tier, valid) returning the reference's RANSAC indices for a
    recovery at `frame_id` (stereo_vo.py `_recover_impl` keys, pnp.py sampler)."""
    key = jax.random.fold_in(jax.random.key(0x5EC0), frame_id)
    keys = {1: key, 2: jax.random.fold_in(key, 1)}

    def draw(tier, valid):
        v = jnp.asarray(valid.cpu().numpy())
        p = v.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        ks = jax.random.split(keys[tier], N_HYP)
        idx = jax.vmap(lambda k: jax.random.choice(k, v.shape[0], shape=(6,), replace=False, p=p))(ks)
        return torch.as_tensor(np.asarray(idx))

    return draw


def test_reference_recovers_through_both_rebootstrap_tiers(jax_run):
    assert [r["mode"] for r in jax_run[1]] == [0] * 8 + [2, 0, 0, 3, 0, 0]


@pytest.mark.parametrize("mode", [2, 3])
def test_recovery_from_jax_state_matches(corridor_frames, jax_run, mode):
    """The steady step that recovers, from the reference's state before it:
    same mode, T_wc to 1e-4 (PnP + GN polish from the same draws, sums in
    another order), the same track mask, and a reset velocity."""
    recs = jax_run[1]
    k = next(i for i, r in enumerate(recs) if r["mode"] == mode)
    pre, ref = recs[k]["pre"], recs[k]["steady"]
    vo = TVO(small_cfg(tio.VOConfig, "off"), device="cpu")
    il, ir = (torch.as_tensor(x, dtype=torch.float32) for x in corridor_frames[k])
    new, stats = vo._steady_step(state_from_numpy(pre, device="cpu"), il, ir, draw=jax_draws(int(pre.frame_id) + 1))
    assert int(stats.recovered) == mode
    np.testing.assert_allclose(new.T_wc.numpy(), ref.T_wc, atol=1e-4)
    np.testing.assert_array_equal(new.tracks.valid.numpy(), ref.tracks.valid)
    assert int(new.fail_count) == 0 and np.array_equal(new.dT.numpy(), np.eye(4, dtype=np.float32))


def test_track_pnp_tier_matches_jax(corridor_frames, jax_run):
    """Tier 1 (mode 1) on healthy tracks: `_recover` called directly on the
    reference's track-stage outputs at frame 3, where PnP on the surviving
    landmarks relocalizes."""
    jvo, recs = jax_run
    k = 3
    pre = recs[k]["pre"]
    il, ir = (jnp.asarray(x, jnp.float32) for x in corridor_frames[k])
    pyr_l, pyr_r, pts1, ok_track, has_3d, _, _ = jax.jit(jvo._track_stage_impl)(pre, il, ir)
    ref, ref_mode = jax.jit(jvo._recover_impl)(pre, pyr_l, pyr_r, pts1, ok_track, has_3d)
    assert int(ref_mode) == 1

    def T(x):
        return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)), x)

    vo = TVO(small_cfg(tio.VOConfig, "off"), device="cpu")
    new, mode = vo._recover(state_from_numpy(pre, device="cpu"), T(pyr_l), T(pyr_r), T(pts1), T(ok_track), T(has_3d),
                            draw=jax_draws(int(pre.frame_id)))
    assert int(mode) == 1
    np.testing.assert_allclose(new.T_wc.numpy(), np.asarray(ref.T_wc), atol=1e-4)
    np.testing.assert_array_equal(new.tracks.valid.numpy(), np.asarray(ref.tracks.valid))


def test_blackout_world_relocalizes_by_descriptor(poses, plane_frames):
    """tests/test_stereo_vo_pipeline.py:test_descriptor_relocalization_after_blackout
    on the port, with the port's own draws: mode 3 fires and the final pose
    is back within 0.25 m of the truth."""
    vo = TVO(small_cfg(tio.VOConfig, "off"), device="cpu")
    for il, ir in plane_frames:
        vo.track_stereo_images(il, ir)
    modes = [s.get("recovered", 0) for s in vo.stats_log]
    assert 3 in modes, modes
    assert np.linalg.norm(vo.trajectory[-1][:3, 3] - poses[-1][:3, 3]) < 0.25


def test_recovery_draws_repeat_per_frame_and_tier():
    vo = TVO(small_cfg(tio.VOConfig, "off"), device="cpu")
    valid = torch.zeros(200, dtype=torch.bool)
    valid[::3] = True

    def draws(fid, tier):
        return TPNP.sample_minimal_sets(valid, N_HYP, vo._recovery_generator(fid, tier))

    a = draws(9, 1)
    assert torch.equal(a, draws(9, 1))
    assert not torch.equal(a, draws(9, 2)) and not torch.equal(a, draws(10, 1))
    assert bool(valid[a].all())  # only valid points while there are >= 6
    assert all(len(set(row.tolist())) == 6 for row in a)  # without replacement
