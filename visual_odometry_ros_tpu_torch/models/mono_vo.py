"""Monocular visual-odometry pipeline: a three-phase state machine with the
5-point bootstrap and fallback, depth-filter seeds, recovery, the keyframe
step with window BA, and the per-frame, timed and batch entry points.

Counterpart of `visual_odometry_ros_tpu/models/mono_vo.py`. Phases: 0 first
frame (detect only), 1 init (track from the anchor frame until the median
displacement allows a 5-point bootstrap, which fixes ||t|| = 1 as the map's
scale), 2 steady (track, 1-point vote, pose, update; on a failed pose the
5-point fallback with the previous step length; recovery after
`recover_after` failures; at keyframes parallax-gated triangulation, the
inverse-range depth filter and window BA). Each of the reference's
`lax.cond` gates is a Python branch on one synchronised scalar, and its
`lax.scan` over a batch is a frame loop whose per-frame outputs stay on the
device until one readback per batch.

RANSAC draws: the bootstrap and the fallback draw from one generator per
pipeline (seed 42, as the reference's key); a recovery draws from a generator
seeded from (0x5EC1, frame_id), as the reference folds its key. Tests hand
in the reference's own draws instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import camera as cam_mod
from ..mapping import arena as A
from ..ops import ba as BA
from ..ops import depth_filter as DF
from ..ops import epipolar as EP
from ..ops import features as F
from ..ops import klt as KLT
from ..ops import pnp as PNP
from ..ops import pose_gn as PG
from ..ops import triangulate as TRI
from ..ops.pyramid import build_pyramid_with_gradients
from ..utils import geometry as geo
from ..utils import timer
from ._state import at, rot_deg, tree_from_numpy, tree_to_numpy

_ESSENTIAL_HYPOTHESES = 256  # the reference's n_hypotheses
_RECOVERY_HYPOTHESES = 128


@dataclass
class MonoVOState(A._Replace):
    T_wc: torch.Tensor  # [4, 4]
    dT: torch.Tensor  # [4, 4] last frame motion
    step_len: torch.Tensor  # [] last translation magnitude (scale propagation)
    tracks: A.TrackState
    arena: A.LandmarkArena
    ring: A.KeyframeRing
    pyr_prev: tuple  # previous-frame pyramid ((img, gx, gy), ...)
    pyr_first: tuple  # init-phase anchor pyramid
    init_pts0: torch.Tensor  # [N, 2] detections in the anchor frame
    frame_id: torch.Tensor  # [] int32
    fail_count: torch.Tensor  # [] int32: frames where the pose and the fallback failed


class MonoFrameStats(NamedTuple):
    """A steady frame's scalars, in the order of the reference's dict."""

    n_initial: torch.Tensor
    n_tracked: torch.Tensor
    n_gn: torch.Tensor
    n_inliers: torch.Tensor
    n_new: torch.Tensor
    n_ok_parallax: torch.Tensor
    pose_ok: torch.Tensor
    mean_reproj_err: torch.Tensor
    overlap_ratio: torch.Tensor
    need_keyframe: torch.Tensor
    steering_angle: torch.Tensor
    n_pass_1p: torch.Tensor
    avg_parallax: torch.Tensor
    avg_age: torch.Tensor


# Per-frame values of the batch path's readback, after T_wc and the stats.
_BATCH_EXTRA = ("recovered", "fail_count", "est_ok", "ba_err", "n_triangulated", "ba_acc")


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the non-NaN values, the mean of the two middle ones for an
    even count (as jnp.nanmedian; torch.nanmedian takes the lower one)."""
    return torch.nanquantile(x, 0.5)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)


class MonoVO:
    """Mono VO on one device; phases 0 = first, 1 = init, 2 = steady."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        c = cfg.cam
        self.cam = cam_mod.make_camera(c.fx, c.fy, c.cx, c.cy, c.dist, c.width, c.height, self.device)
        self.fx, self.fy = float(c.fx), float(c.fy)
        self.cx, self.cy = float(c.cx), float(c.cy)
        # Undistortion: one source map built on the device; the pipeline then
        # sees ideal-pinhole images under the same K.
        if cfg.flagDoUndistortion and float(np.abs(c.dist).max()) > 0:
            self._undist_map = cam_mod.image_undistort_maps(self.cam)
        else:
            self._undist_map = None
        self.N = cfg.extractor.n_features
        self.M = cfg.map.landmark_capacity
        self.K = cfg.keyframe.n_max_keyframes_in_window + 1
        t = cfg.tracker
        self.klt_params = KLT.KLTParams(
            window_radius=t.window_size // 2,
            levels=t.max_level,
            iters=t.max_iter,
            eps=t.eps,
            min_eig=t.min_eig,
            max_err=t.thres_error,
            fb_thresh=t.thres_bidirection,
            use_kernel=KLT.resolve_use_kernel(t.use_pallas),
            iters_coarse=t.coarse_iter,
        )
        m = cfg.motion
        self.pose_params = PG.PoseGNParams(
            max_iters=m.pose_ba_iters,
            huber_delta=m.huber_delta,
            reproj_thresh=m.thres_poseba_error,
            min_inlier_ratio=m.min_inlier_ratio,
            min_inliers=m.min_inliers,
        )
        self.ba_params = BA.BAParams(iters=m.lba_iters, n_fix=cfg.keyframe.n_fix, huber_delta=m.lba_huber)
        self.T_rl_dummy = torch.eye(4, dtype=torch.float32, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(42)

        self.phase = 0
        self.state: MonoVOState | None = None
        self.trajectory: list[np.ndarray] = []
        self.kf_trajectory: list[tuple[int, np.ndarray]] = []
        self.stats_log: list[dict] = []

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _eye4(self):
        return torch.eye(4, dtype=torch.float32, device=self.device)

    def _i32(self, v):
        return torch.tensor(v, dtype=torch.int32, device=self.device)

    def _detect(self, img, pts, valid, n_max):
        e = self.cfg.extractor
        return F.detect_features(img, pts, valid, gh=e.n_bins_v, gw=e.n_bins_u, n_max=n_max,
                                 fast_thresh=e.thres_fastscore, score_min=e.score_min)

    def _build_pyr(self, img):
        # The kernel leg takes template gradients itself; gradient pyramids
        # are only needed by the plain ("off") leg.
        return build_pyramid_with_gradients(
            img, self.klt_params.levels, with_gradients=not self.klt_params.use_kernel
        )

    def _draw_essential(self, valid):
        """[256, 8] draws of one essential RANSAC (bootstrap and fallback)."""
        return EP.sample_eight_point_sets(valid, _ESSENTIAL_HYPOTHESES, self._gen)

    def _draw_recovery(self, frame_id: int, valid):
        """[128, 6] draws of the recovery PnP at `frame_id`: runs repeat."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((0x5EC1 << 32) | frame_id)
        return PNP.sample_minimal_sets(valid, _RECOVERY_HYPOTHESES, gen)

    def init_state(self, pyr) -> MonoVOState:
        """An empty state of the pipeline's capacities (a checkpoint template)."""
        d = self.device
        tracks = A.make_tracks(self.N, d)
        return MonoVOState(
            T_wc=self._eye4(), dT=self._eye4(), step_len=torch.tensor(0.0, device=d), tracks=tracks,
            arena=A.make_arena(self.M, d), ring=A.make_ring(self.K, self.N, d), pyr_prev=pyr,
            pyr_first=pyr, init_pts0=tracks.pts, frame_id=self._i32(1), fail_count=self._i32(0),
        )

    # ------------------------------------------------------------------
    # init phase
    # ------------------------------------------------------------------

    def _first_frame(self, img) -> MonoVOState:
        state = self.init_state(self._build_pyr(img))
        pts, ok = self._detect(img, state.tracks.pts, state.tracks.valid, self.N)
        return state.replace(tracks=state.tracks.replace(pts=pts, valid=ok), init_pts0=pts)

    def _init_track(self, state: MonoVOState, img):
        """Track the init features frame to frame (previous pyramid, not the
        anchor's); the median displacement from the anchor detections says
        when a bootstrap is ready. Returns (state, median disp, n tracked)."""
        pyr = self._build_pyr(img)
        tr = state.tracks
        pts1, ok = KLT.track_bidirectional_pyr(state.pyr_prev, pyr, tr.pts, tr.pts, tr.valid,
                                               self.klt_params, back_levels=1)
        disp = torch.linalg.norm(pts1 - state.init_pts0, dim=-1)
        med_disp = _nanmedian(torch.where(ok, disp, torch.nan))
        new = state.replace(tracks=tr.replace(pts=pts1, valid=ok), pyr_prev=pyr, frame_id=state.frame_id + 1)
        return new, med_disp, torch.sum(ok)

    def _init_bootstrap(self, state: MonoVOState, idx=None):
        """5-point bootstrap between the anchor and the current frame: R, t
        (||t|| = 1, the map's scale), DLT landmarks in the anchor frame with
        depth seeds on their rays, two keyframes. Returns (state, ok, n landmarks)."""
        cfg = self.cfg
        d = self.device
        pts0 = state.init_pts0
        pts1 = state.tracks.pts
        valid = state.tracks.valid
        xn0 = cam_mod.pixel_to_normalized(self.cam, pts0)
        xn1 = cam_mod.pixel_to_normalized(self.cam, pts1)
        res = EP.estimate_essential_ransac(
            xn0, xn1, valid, thresh_px=cfg.motion.thres_5p_error, focal=self.fx,
            n_hypotheses=_ESSENTIAL_HYPOTHESES,
            # The inlier floor scales with the detection capacity.
            min_inliers=max(16, self.N // 16),
            idx=self._draw_essential(valid) if idx is None else idx,
        )
        T10 = geo.rt_to_se3(res.R_10, res.t_10)
        X0, X1 = TRI.triangulate(xn0, xn1, T10)
        ok3 = (res.inliers & (X0[:, 2] > cfg.map.min_depth) & (X1[:, 2] > 0.1)
               & (X0[:, 2] < cfg.map.max_depth))

        arena = A.make_arena(self.M, d)
        slots, slot_ok = A.allocate_slots(~arena.alive, self.N)
        ok_new = ok3 & slot_ok
        # Birth descriptors at the current observation (relocalization).
        dw, desc_ok = F.orb_descriptors(state.pyr_prev[0][0], pts1)
        up = A.indexed_update
        full = torch.full((self.N,), 10.0, dtype=torch.float32, device=d)
        arena = arena.replace(
            Xw=up(arena.Xw, slots, ok_new, X0),  # world = the anchor camera
            alive=up(arena.alive, slots, ok_new, op="or"),
            tracked=up(arena.tracked, slots, ok_new, op="or"),
            triangulated=up(arena.triangulated, slots, ok_new, op="or"),
            age=up(arena.age, slots, ok_new, torch.full((self.N,), 2, dtype=torch.int32, device=d)),
            last_pt=up(arena.last_pt, slots, ok_new, pts1),
            # Inverse-range seed on the unit ray through the anchor observation.
            inv_depth=up(arena.inv_depth, slots, ok_new,
                         1.0 / torch.clamp(torch.linalg.norm(X0, dim=-1), min=1e-3)),
            inv_depth_var=up(arena.inv_depth_var, slots, ok_new,
                             DF.measurement_tau2(X0[:, 2], 1.0, self.fx)),
            df_a=up(arena.df_a, slots, ok_new, full),
            df_b=up(arena.df_b, slots, ok_new, full),
            ray_d=up(arena.ray_d, slots, ok_new, _unit(torch.cat([xn0, torch.ones_like(xn0[:, :1])], -1))),
            desc=up(arena.desc, slots, ok_new & desc_ok, F.desc_to_u8(dw)),
            # set over every born slot: a reused slot keeps no stale descriptor
            desc_valid=up(arena.desc_valid, slots, ok_new, desc_ok),
        )
        no_r = torch.zeros((self.N,), dtype=torch.bool, device=d)
        ring = A.ring_push(state.ring, self._eye4(), 0, pts0, torch.zeros_like(pts0), slots, ok_new, no_r)
        ring = A.ring_push(ring, T10, state.frame_id, pts1, torch.zeros_like(pts1), slots, ok_new, no_r)
        T_wc = geo.se3_inverse(T10)
        # The bootstrap spans frame_id - 1 frames: the velocity prior takes
        # the per-frame motion.
        n_span = torch.clamp(state.frame_id.to(torch.float32) - 1.0, min=1.0)
        dT = geo.se3_exp(geo.se3_log(T_wc) / n_span)
        new = state.replace(
            T_wc=T_wc, dT=dT, step_len=torch.linalg.norm(dT[:3, 3]),
            tracks=state.tracks.replace(lm_idx=slots, valid=ok_new), arena=arena, ring=ring,
        )
        return new, res.ok, torch.sum(ok_new)

    # ------------------------------------------------------------------
    # steady phase
    # ------------------------------------------------------------------

    def _replenish(self, img, tracks, arena, T_wc, allow=True):
        """New features -> untriangulated landmarks, each with a depth-filter
        seed on its world ray. `allow` (bool or [] tensor) False births
        nothing: a ray anchored at an untrusted pose poisons the filter.
        Returns (tracks, arena, n born)."""
        with timer.span("vo.replenish"):
            d = self.device
            n = self.N // 2
            new_pts, new_ok = self._detect(img, tracks.pts, tracks.valid, n)
            slots, slot_ok = A.allocate_slots(~arena.alive, n)
            ok_new = new_ok & slot_ok & allow
            zeros_n = torch.zeros((n,), dtype=torch.float32, device=d)
            false_n = torch.zeros((n,), dtype=torch.bool, device=d)
            xn = cam_mod.pixel_to_normalized(self.cam, new_pts)
            d_w = _unit(torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1) @ T_wc[:3, :3].T)
            seeds0 = DF.init_seeds(torch.full((n,), self.cfg.map.init_depth, dtype=torch.float32, device=d),
                                   depth_min=self.cfg.map.min_depth)
            dw, desc_ok = F.orb_descriptors(img, new_pts)
            up = A.indexed_update
            arena = arena.replace(
                alive=up(arena.alive, slots, ok_new, op="or"),
                tracked=up(arena.tracked, slots, ok_new, op="or"),
                triangulated=up(arena.triangulated, slots, ok_new, false_n),
                bundled=up(arena.bundled, slots, ok_new, false_n),
                age=up(arena.age, slots, ok_new, torch.ones((n,), dtype=torch.int32, device=d)),
                last_pt=up(arena.last_pt, slots, ok_new, new_pts),
                inv_depth=up(arena.inv_depth, slots, ok_new, seeds0.mu),
                inv_depth_var=up(arena.inv_depth_var, slots, ok_new, seeds0.sigma2),
                df_a=up(arena.df_a, slots, ok_new, seeds0.a),
                df_b=up(arena.df_b, slots, ok_new, seeds0.b),
                ray_o=up(arena.ray_o, slots, ok_new, T_wc[:3, 3].expand(n, 3)),
                ray_d=up(arena.ray_d, slots, ok_new, d_w),
                parallax_last=up(arena.parallax_last, slots, ok_new, zeros_n),
                parallax_max=up(arena.parallax_max, slots, ok_new, zeros_n),
                parallax_min=up(arena.parallax_min, slots, ok_new, torch.full_like(zeros_n, A.PARALLAX_MIN_INIT)),
                parallax_sum=up(arena.parallax_sum, slots, ok_new, zeros_n),
                parallax_n=up(arena.parallax_n, slots, ok_new, torch.zeros((n,), dtype=torch.int32, device=d)),
                desc=up(arena.desc, slots, ok_new & desc_ok, F.desc_to_u8(dw)),
                desc_valid=up(arena.desc_valid, slots, ok_new, desc_ok),
            )
            lanes, lane_ok = A.allocate_slots(~tracks.valid, n)
            put = ok_new & lane_ok
            tracks = tracks.replace(
                pts=up(tracks.pts, lanes, put, new_pts),
                lm_idx=up(tracks.lm_idx, lanes, put, slots),
                valid=up(tracks.valid, lanes, put, op="or"),
                scale=up(tracks.scale, lanes, put, torch.ones((n,), dtype=torch.float32, device=d)),
            )
            return tracks, arena, torch.sum(put).to(torch.int32)

    def _track_stage(self, state: MonoVOState, img):
        """Pyramid, priors, prior-seeded bidirectional KLT, scale refinement.
        Returns (pyr, pts1, ok_track, has_3d, scale_prior)."""
        tracks = state.tracks
        arena = state.arena
        lm = tracks.lm_idx.to(torch.int64)
        pyr = self._build_pyr(img)
        T_cw_prior = geo.se3_inverse(state.T_wc @ state.dT)
        lm_X = arena.Xw[lm]
        has_3d = tracks.valid & arena.triangulated[lm]
        prior_pts, prior_depth = KLT.calc_prior(lm_X, T_cw_prior, self.fx, self.fy, self.cx, self.cy)
        depth_prev = geo.transform_points(geo.se3_inverse(state.T_wc), lm_X)[..., 2]
        scale_prior = torch.clamp(depth_prev / torch.clamp(prior_depth, min=0.1), 0.25, 4.0)
        scale_prior = torch.where(has_3d, scale_prior, 1.0)
        prior_pts = torch.where((has_3d & (prior_depth > 0.1))[:, None], prior_pts, tracks.pts)
        pts1, ok_track = KLT.track_bidirectional_pyr(
            state.pyr_prev, pyr, tracks.pts, prior_pts, tracks.valid, self.klt_params,
            fb_scale=5.0, back_levels=1,
        )
        img_prev, du0, dv0 = state.pyr_prev[0]
        # Mono keeps the reference's 30 scale iterations (stereo's scale_iter
        # budget does not apply).
        pts1_ref, ok_scale = KLT.track_with_scale(
            img_prev, du0, dv0, img, tracks.pts, pts1, scale_prior, ok_track,
            use_kernel=self.klt_params.use_kernel,
        )
        pts1 = torch.where(ok_scale[:, None], pts1_ref, pts1)
        return pyr, pts1, ok_track, has_3d, scale_prior

    def _onep_stage(self, state: MonoVOState, pts1, ok_track):
        """The 1-point steering-angle vote; its epipolar gate only where
        configured (planar rigs). Returns (theta, n passing, ok_track)."""
        op = EP.one_point_pose(state.tracks.pts, pts1, ok_track, self.fx, self.fy, self.cx, self.cy,
                               thres_px=self.cfg.motion.thres_1p_error)
        if self.cfg.motion.use_1point_gate:
            ok_track = ok_track & op.inliers
        return op.theta, op.n_inliers, ok_track

    def _pose_stage(self, state: MonoVOState, pts1, ok_track, has_3d):
        """Two-pass pose GN, motion-sanity gate, Sampson gate.
        Returns (T10, dT_new, T_wc_new, survived, pose_ok, mean_err, n_gn)."""
        tracks = state.tracks
        X0 = geo.transform_points(geo.se3_inverse(state.T_wc), state.arena.Xw[tracks.lm_idx.to(torch.int64)])
        gn_valid = ok_track & has_3d & (X0[..., 2] > 0.1)
        n_gn = torch.sum(gn_valid)
        T10_init = geo.se3_inverse(state.dT)
        res, _ = PG.pose_only_gn_mono_robust(X0, pts1, gn_valid, self.fx, self.fy, self.cx, self.cy,
                                             T10_init, self.pose_params)
        m = self.cfg.motion
        dT_cand = geo.se3_inverse(res.T10)
        step_prev = torch.linalg.norm(state.dT[:3, 3])
        step_new = torch.linalg.norm(dT_cand[:3, 3])
        sane = (step_new <= torch.clamp(m.sanity_step_mult * step_prev, min=m.max_step_abs)) & (
            rot_deg(dT_cand[:3, :3])
            <= torch.clamp(m.sanity_step_mult * rot_deg(state.dT[:3, :3]), min=m.max_rot_abs_deg)
        )
        pose_ok = res.ok & sane & (n_gn >= 10)
        T10 = torch.where(pose_ok, res.T10, T10_init)
        dT_new = geo.se3_inverse(T10)
        T_wc_new = geo.se3_project(state.T_wc @ dT_new)

        # Sampson gate on the estimated motion.
        t_dir = T10[:3, 3] / torch.clamp(torch.linalg.norm(T10[:3, 3]), min=1e-9)
        E = EP.essential_from_rt(T10[:3, :3], t_dir)
        xn0 = cam_mod.pixel_to_normalized(self.cam, tracks.pts)
        xn1 = cam_mod.pixel_to_normalized(self.cam, pts1)
        samp_ok = EP.sampson_distance(E, xn0, xn1) * self.fx * self.fx < self.cfg.tracker.thres_sampson
        # A failed pose keeps every KLT-consistent track.
        inliers = torch.where(pose_ok, res.inliers, True)
        survived = ok_track & samp_ok & torch.where(has_3d, inliers, True)
        return T10, dT_new, T_wc_new, survived, pose_ok, res.mean_err, n_gn

    def _update_stage(self, state: MonoVOState, pyr, img, pts1, ok_track, scale_prior, T10, dT_new,
                      T_wc_new, survived, pose_ok, mean_err, n_gn, theta_1p, n_pass_1p):
        """Arena and parallax updates, keyframe rule, replenishment, stats."""
        cfg = self.cfg
        d = self.device
        tracks = state.tracks
        arena = state.arena
        lm = tracks.lm_idx
        ones = torch.ones(self.N, device=d)
        r0 = torch.stack([(tracks.pts[:, 0] - self.cx) / self.fx, (tracks.pts[:, 1] - self.cy) / self.fy, ones], -1)
        r1 = torch.stack([(pts1[:, 0] - self.cx) / self.fx, (pts1[:, 1] - self.cy) / self.fy, ones], -1)
        r1 = _unit(r1 @ T10[:3, :3])
        r0 = r0 / torch.linalg.norm(r0, dim=-1, keepdim=True)
        par = torch.arccos(torch.clamp(torch.sum(r0 * r1, dim=-1), -1.0, 1.0))

        up = A.indexed_update
        arena = arena.replace(
            tracked=up(torch.zeros_like(arena.tracked), lm, survived, op="or"),
            age=up(arena.age, lm, survived, torch.ones((self.N,), dtype=torch.int32, device=d), op="add"),
            last_pt=up(arena.last_pt, lm, survived, pts1),
        )
        arena = A.parallax_observe(arena, lm, survived, par)
        avg_parallax, avg_age = A.landmark_stat_means(arena)
        tracks = tracks.replace(pts=pts1, valid=survived, scale=scale_prior)

        # Keyframe rule, decided before replenishment (births cannot change
        # the overlap with the last keyframe).
        head = state.ring.head
        last_kf_lm = at(state.ring.lm_idx, head).to(torch.int64)
        last_kf_ov = at(state.ring.obs_valid, head)
        still = up(torch.zeros((self.M,), dtype=torch.bool, device=d), tracks.lm_idx, tracks.valid, op="or")
        still = torch.cat([still, torch.zeros((1,), dtype=torch.bool, device=d)])
        overlap = torch.sum(still[torch.where(last_kf_ov, last_kf_lm, self.M)] & last_kf_ov) / torch.clamp(
            torch.sum(last_kf_ov), min=1
        )
        dT_kf = geo.se3_inverse(geo.se3_inverse(at(state.ring.T_cw, head))) @ T_wc_new
        need_kf = (
            (overlap < cfg.keyframe.thres_overlap_ratio)
            | (torch.linalg.norm(dT_kf[:3, 3]) > cfg.keyframe.thres_translation)
            | (rot_deg(dT_kf[:3, :3]) > cfg.keyframe.thres_rotation)
        )

        # Replenish only under a trusted pose (the fallback replenishes after
        # correcting it), and only on a track deficit or a keyframe.
        deficit = torch.sum(tracks.valid) < int(cfg.extractor.replenish_min_ratio * self.N)
        if bool(pose_ok & (deficit | need_kf)):
            tracks, arena, n_new = self._replenish(img, tracks, arena, T_wc_new, allow=True)
        else:
            n_new = self._i32(0)

        new_state = state.replace(
            T_wc=T_wc_new, dT=dT_new,
            step_len=torch.where(pose_ok, torch.linalg.norm(dT_new[:3, 3]), state.step_len),
            tracks=tracks, arena=arena, pyr_prev=pyr, frame_id=state.frame_id + 1,
            # Tentative: a successful fallback resets it.
            fail_count=torch.where(pose_ok, 0, state.fail_count + 1).to(torch.int32),
        )
        stats = MonoFrameStats(
            n_initial=torch.sum(state.tracks.valid),
            n_tracked=torch.sum(ok_track),
            n_gn=n_gn,
            n_inliers=torch.sum(survived),
            n_new=n_new,
            n_ok_parallax=torch.sum(arena.alive & (arena.parallax_max >= math.radians(cfg.map.thres_parallax))),
            pose_ok=pose_ok,
            mean_reproj_err=mean_err,
            overlap_ratio=overlap,
            need_keyframe=need_kf,
            steering_angle=theta_1p,
            n_pass_1p=n_pass_1p,
            avg_parallax=avg_parallax,
            avg_age=avg_age,
        )
        return new_state, stats

    def _steady_step(self, state: MonoVOState, img, stage_ms=None):
        """One steady frame: track, 1-point, pose, update. stage_ms: a dict to
        fill with per-stage wall times (time_track, time_1p, time_pose,
        time_new); each stage then runs between two device synchronises."""
        d = self.device
        with timer.span("vo.track", stage_ms, "time_track", d):
            pyr, pts1, ok_track, has_3d, scale_prior = self._track_stage(state, img)
        with timer.span("vo.onep", stage_ms, "time_1p", d):
            theta_1p, n_pass_1p, ok_track = self._onep_stage(state, pts1, ok_track)
        with timer.span("vo.pose", stage_ms, "time_pose", d):
            pose = self._pose_stage(state, pts1, ok_track, has_3d)
        with timer.span("vo.update", stage_ms, "time_new", d):
            return self._update_stage(state, pyr, img, pts1, ok_track, scale_prior, *pose, theta_1p, n_pass_1p)

    def _steady_step_timed(self, state: MonoVOState, img):
        """The steady step with each stage synchronised and host-timed.
        Returns (state, stats, stage_ms)."""
        stage_ms = {}
        state, stats = self._steady_step(state, img, stage_ms=stage_ms)
        return state, stats, stage_ms

    def _fallback_5pt(self, state_prev: MonoVOState, state_new: MonoVOState, idx=None):
        """5-point fallback with scale propagation: this frame's motion from
        2-D/2-D geometry, the translation rescaled to the previous step
        length; on success the skipped replenishment runs and the failure
        count resets. Returns (state, fb_ok)."""
        ok = state_prev.tracks.valid & state_new.tracks.valid
        xn0 = cam_mod.pixel_to_normalized(self.cam, state_prev.tracks.pts)
        xn1 = cam_mod.pixel_to_normalized(self.cam, state_new.tracks.pts)  # same lanes
        res = EP.estimate_essential_ransac(
            xn0, xn1, ok, thresh_px=self.cfg.motion.thres_5p_error, focal=self.fx,
            n_hypotheses=_ESSENTIAL_HYPOTHESES, idx=self._draw_essential(ok) if idx is None else idx,
        )
        dT = geo.se3_inverse(geo.rt_to_se3(res.R_10, res.t_10 * state_prev.step_len))
        T_wc = state_prev.T_wc @ dT
        # Sanity-gate the rotation against the prior too.
        m = self.cfg.motion
        fb_ok = res.ok & (
            rot_deg(dT[:3, :3])
            <= torch.clamp(m.sanity_step_mult * rot_deg(state_prev.dT[:3, :3]), min=m.max_rot_abs_deg)
        )
        T_wc = torch.where(fb_ok, T_wc, state_new.T_wc)
        dT = torch.where(fb_ok, dT, state_new.dT)
        img = state_new.pyr_prev[0][0]  # the current frame
        tracks, arena, _ = self._replenish(img, state_new.tracks, state_new.arena, T_wc, allow=fb_ok)
        return state_new.replace(
            T_wc=T_wc, dT=dT, tracks=tracks, arena=arena,
            fail_count=torch.where(fb_ok, 0, state_new.fail_count).to(torch.int32),
        ), fb_ok

    def _recover(self, state: MonoVOState, draw=None):
        """Tracking-loss recovery after `recover_after` frames where the pose
        and the fallback both failed: PnP relocalization on the tracked
        triangulated landmarks (mode 1), else a re-bootstrap (mode 2): fresh
        tracks with depth seeds at the current pose and a fresh keyframe
        window. draw(valid) -> [128, 6] replaces the PnP draws. Returns
        (state, mode)."""
        m = self.cfg.motion
        if draw is None:
            fid = int(state.frame_id)

            def draw(valid):
                return self._draw_recovery(fid, valid)

        tracks = state.tracks
        lm = tracks.lm_idx.to(torch.int64)
        lm_X = state.arena.Xw[lm]
        tri = (state.arena.alive & state.arena.triangulated)[lm]
        cand = tracks.valid & tri
        pnp = PNP.pnp_ransac(
            lm_X, tracks.pts, cand, self.fx, self.fy, self.cx, self.cy,
            thresh_px=1.5 * self.pose_params.reproj_thresh, n_hypotheses=_RECOVERY_HYPOTHESES,
            min_inlier_ratio=0.3, T_init=geo.se3_inverse(state.T_wc), idx=draw(cand),
        )
        T_wc_pnp = geo.se3_inverse(pnp.T_cw)
        jump = torch.linalg.norm(T_wc_pnp[:3, 3] - state.T_wc[:3, 3])
        if bool(pnp.ok & (pnp.n_inliers >= 15) & (jump <= 2.0 * m.recover_after * m.max_step_abs)):
            valid_new = (cand & pnp.inliers) | (tracks.valid & ~tri)
            return state.replace(T_wc=T_wc_pnp, tracks=tracks.replace(valid=valid_new),
                                 fail_count=self._i32(0)), self._i32(1)
        d = self.device
        arena = state.arena.replace(tracked=torch.zeros_like(state.arena.tracked))
        tracks2, arena, _ = self._replenish(state.pyr_prev[0][0], A.make_tracks(self.N, d), arena, state.T_wc)
        ring = A.ring_push(
            A.make_ring(self.K, self.N, d), geo.se3_inverse(state.T_wc), state.frame_id, tracks2.pts,
            torch.zeros_like(tracks2.pts), tracks2.lm_idx, tracks2.valid,
            torch.zeros((self.N,), dtype=torch.bool, device=d),
        )
        return state.replace(tracks=tracks2, arena=arena, ring=ring, fail_count=self._i32(0)), self._i32(2)

    def _keyframe_step(self, state: MonoVOState):
        """Push a keyframe; triangulate the window's untriangulated landmarks
        (parallax-gated DLT, each with its own relative pose) and feed the
        inverse-range depth filter, promoting converged seeds; window BA with
        the acceptance rule; refresh the tracks' patch scales from the
        refined geometry. Returns (state, BA mean error, n triangulated, accepted)."""
        cfg = self.cfg
        d = self.device
        M, K = self.M, self.K
        no_r = torch.zeros((self.N,), dtype=torch.bool, device=d)
        ring = A.ring_push(state.ring, geo.se3_inverse(state.T_wc), state.frame_id, state.tracks.pts,
                           torch.zeros_like(state.tracks.pts), state.tracks.lm_idx, state.tracks.valid, no_r)
        arena = state.arena
        g = A.gather_ba_problem(ring, arena)
        mask = g["mask"]  # [M, K], keyframes oldest -> newest
        T_cw_win = g["T_cw"]

        # Landmarks with >= 2 window observations: first and last observing keyframes.
        mask_i = mask.to(torch.int32)
        first_k = torch.argmax(mask_i, dim=1)
        last_k = K - 1 - torch.argmax(mask_i.flip(1), dim=1)
        cand = arena.alive & ~arena.triangulated & (torch.sum(mask_i, dim=1) >= 2) & (first_k < last_k)
        rows = torch.arange(M, device=d)
        p0 = g["pts"][rows, first_k]
        p1 = g["pts"][rows, last_k]
        T0 = T_cw_win[first_k]
        T1 = T_cw_win[last_k]
        T_wc0 = geo.se3_inverse(T0)
        T_10 = T1 @ T_wc0
        xn0 = cam_mod.pixel_to_normalized(self.cam, p0)
        xn1 = cam_mod.pixel_to_normalized(self.cam, p1)
        X0, X1 = TRI.triangulate(xn0, xn1, T_10)
        # Parallax between the two rays, rotation-compensated.
        r0 = torch.cat([xn0, torch.ones_like(xn0[:, :1])], dim=-1)
        r1 = torch.cat([xn1, torch.ones_like(xn1[:, :1])], dim=-1)
        r1w = torch.einsum("mij,mj->mi", T_10[:, :3, :3].transpose(1, 2), r1)
        cosang = torch.sum(r0 * r1w, dim=-1) / torch.clamp(
            torch.linalg.norm(r0, dim=-1) * torch.linalg.norm(r1w, dim=-1), min=1e-9
        )
        par_deg = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
        uv0 = cam_mod.project_to_pixel(self.cam, X0)
        uv1 = cam_mod.project_to_pixel(self.cam, X1)
        reproj_ok = (torch.linalg.norm(uv0 - p0, dim=-1) < 2.0) & (torch.linalg.norm(uv1 - p1, dim=-1) < 2.0)
        depth_ok = (X0[:, 2] > cfg.map.min_depth) & (X1[:, 2] > 0.05) & (X0[:, 2] < cfg.map.max_depth)
        tri_ok = cand & (par_deg >= cfg.map.thres_parallax) & depth_ok & reproj_ok
        Xw_new = torch.einsum("mij,mj->mi", T_wc0[:, :3, :3], X0) + T_wc0[:, :3, 3]

        # Inverse-range depth filter on each landmark's birth ray: every sane
        # DLT result feeds it, low-parallax ones included; converged seeds
        # are promoted.
        meas_ok = cand & depth_ok & reproj_ok & (par_deg >= 0.15)
        x_meas = 1.0 / torch.clamp(torch.linalg.norm(Xw_new - arena.ray_o, dim=-1), min=1e-3)
        c1 = -torch.einsum("mij,mi->mj", T1[:, :3, :3], T1[:, :3, 3])  # newest-view centres
        tau2 = DF.measurement_tau2(X0[:, 2], torch.linalg.norm(c1 - T_wc0[:, :3, 3], dim=-1), self.fx)
        seeds = DF.DepthSeeds(
            mu=arena.inv_depth, sigma2=arena.inv_depth_var, a=arena.df_a, b=arena.df_b,
            z_range=torch.full((M,), 1.0 / cfg.map.min_depth, dtype=torch.float32, device=d),
        )
        seeds = DF.update_seeds(seeds, x_meas, tau2, meas_ok)
        promote = (cand & ~tri_ok & DF.converged(seeds, cfg.map.df_converge_ratio)
                   & (DF.inlier_probability(seeds) > cfg.map.df_min_inlier_prob))
        Xw_df = arena.ray_o + arena.ray_d / torch.clamp(seeds.mu, min=1e-4)[:, None]
        arena = arena.replace(
            Xw=torch.where(tri_ok[:, None], Xw_new, torch.where(promote[:, None], Xw_df, arena.Xw)),
            triangulated=arena.triangulated | tri_ok | promote,
            inv_depth=torch.where(tri_ok, x_meas, seeds.mu),
            inv_depth_var=torch.where(tri_ok, tau2, seeds.sigma2),
            df_a=seeds.a,
            df_b=seeds.b,
        )

        # Window BA.
        lm_valid = arena.alive & arena.triangulated
        problem = BA.BAProblem(T_cw=T_cw_win, Xw=arena.Xw, pts=g["pts"], mask=mask, pts_r=g["pts_r"],
                               mask_r=g["mask_r"], kf_valid=g["kf_valid"], lm_valid=lm_valid)
        res = BA.ba_solve_impl(problem, self.fx, self.fy, self.cx, self.cy, self.T_rl_dummy, self.ba_params)
        accept = BA.ba_accept(res.mean_err_px, res.mean_err0_px, self.pose_params.reproj_thresh)
        T_cw_res = torch.where(accept, res.T_cw, T_cw_win)
        killed = res.killed & accept
        # Refined poses back into their ring slots (oldest -> newest order).
        ring = ring.replace(T_cw=ring.T_cw.index_put((A.ring_order(ring),), T_cw_res))
        T_wc_new = geo.se3_inverse(at(ring.T_cw, ring.head))
        touched = lm_valid & (torch.sum(mask_i, dim=1) >= 2) & accept
        arena = arena.replace(
            Xw=torch.where(accept, res.Xw, arena.Xw),
            alive=arena.alive & ~killed,
            desc_valid=arena.desc_valid & ~killed,  # a killed slot's descriptor goes too
            bundled=arena.bundled | touched,
        )
        n_tri = torch.sum(tri_ok | promote)

        # Patch scale per track: depth in the first observing keyframe (BA
        # refined) over depth in the current frame.
        T0_ref = T_cw_res[first_k]
        d0 = torch.sum(T0_ref[:, 2, :3] * arena.Xw, dim=-1) + T0_ref[:, 2, 3]
        T_cw_new = geo.se3_inverse(T_wc_new)
        d1 = arena.Xw @ T_cw_new[2, :3] + T_cw_new[2, 3]
        scale_lm = torch.clamp(d0 / torch.clamp(d1, min=0.1), 0.25, 4.0)
        lm = state.tracks.lm_idx.to(torch.int64)
        scale_ok = (state.tracks.valid & (arena.alive & arena.triangulated)[lm] & (d1[lm] > 0.1)
                    & (d0[lm] > 0.1))
        tracks = state.tracks.replace(scale=torch.where(scale_ok, scale_lm[lm], state.tracks.scale))
        return (state.replace(T_wc=T_wc_new, ring=ring, arena=arena, tracks=tracks),
                res.mean_err_px, n_tri, accept)

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def _to_image(self, img):
        im = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        return im if self._undist_map is None else cam_mod.remap(im, self._undist_map)

    def _init_frame(self, im):
        """One frame of phases 0 and 1. Returns (T_wc numpy, stats)."""
        if self.phase == 0:
            self.state = self._first_frame(im)
            self.phase = 1
            eye = np.eye(4, dtype=np.float32)
            self.trajectory.append(eye)
            stats = {"frame": 0, "phase": "first", "keyframe": False}
            self.stats_log.append(stats)
            return eye, stats

        self.state, med_disp, n_ok = self._init_track(self.state, im)
        med_disp, n_ok = torch.stack([med_disp, n_ok.to(torch.float32)]).cpu().tolist()
        n_ok = int(n_ok)
        stats = {"frame": len(self.trajectory), "phase": "init", "median_disp": med_disp, "n_tracked": n_ok,
                 "keyframe": False}
        # Bootstrap once the features moved enough for a conditioned 5-point
        # solve; forward motion builds flow slowly, so a long span bootstraps
        # on less. The survivor floor scales with the detection capacity.
        span = int(self.state.frame_id) - 1
        n_min_boot = max(24, self.N // 8)
        ready = n_ok > n_min_boot and (med_disp > 20.0 or (span >= 8 and med_disp > 6.0))
        if ready:
            self.state, ok, n_lm = self._init_bootstrap(self.state)
            if bool(ok):
                self.phase = 2
                stats["phase"] = "bootstrapped"
                stats["n_landmarks"] = int(n_lm)
                stats["keyframe"] = True
                self.kf_trajectory.append((stats["frame"], self.state.T_wc.cpu().numpy()))
        elif n_ok <= n_min_boot:
            # Track starvation before the bootstrap: re-anchor the init
            # epoch at this frame.
            self.state = self._first_frame(im)
            stats["phase"] = "init_reanchor"
        T_wc = self.state.T_wc.cpu().numpy()
        self.trajectory.append(T_wc)
        self.stats_log.append(stats)
        return T_wc, stats

    def track_image(self, img, timestamp: float = 0.0, timed: bool = False):
        """Process one frame ([H, W] array or tensor; raw when
        `flagDoUndistortion`). Returns (T_wc [4, 4] numpy, stats dict).

        timed=True (steady phase) synchronises and host-times every stage and
        adds stats["stage_ms"] (time_track, time_1p, time_pose, time_new;
        time_5p after a fallback, time_ba on keyframes)."""
        with timer.span("vo.entry"):
            im = self._to_image(img)
            if self.phase != 2:
                return self._init_frame(im)

            prev_state = self.state
            if timed:
                self.state, sc, stage_ms = self._steady_step_timed(self.state, im)
            else:
                self.state, sc = self._steady_step(self.state, im)
                stage_ms = None
            pose_ok = bool(sc.pose_ok)
            est_ok = pose_ok
            if not pose_ok:
                with timer.span("vo.fallback", stage_ms, "time_5p", self.device):
                    self.state, fb_ok = self._fallback_5pt(prev_state, self.state)
                est_ok = bool(fb_ok)
            recovered = 0
            if int(self.state.fail_count) >= self.cfg.motion.recover_after:
                with timer.span("vo.recover"):
                    self.state, mode = self._recover(self.state)
                recovered = int(mode)
            # A keyframe needs a trusted pose and no recovery this frame (a
            # re-bootstrap already pushed a fresh keyframe window).
            need_kf = bool(sc.need_keyframe) and est_ok and recovered == 0
            ba_err, n_tri, ba_rejected = None, 0, False
            if need_kf:
                with timer.span("vo.keyframe", stage_ms, "time_ba", self.device):
                    self.state, ba_err_t, n_tri_t, ba_acc = self._keyframe_step(self.state)
                ba_err, n_tri = float(ba_err_t), int(n_tri_t)
                ba_rejected = not bool(ba_acc)

            f = dict(zip(MonoFrameStats._fields, torch.stack([v.to(torch.float64) for v in sc]).cpu().tolist()))
            T_wc = self.state.T_wc.cpu().numpy()
            stats = self._record(T_wc, f, int(self.state.fail_count), recovered, need_kf, ba_err, ba_rejected,
                                 n_tri)
            if stage_ms is not None:
                stats["stage_ms"] = stage_ms
            return T_wc, stats

    def track_batch(self, imgs):
        """Process B frames ([B, H, W], camera-native dtype such as uint8) in
        one call; steady phase only (bootstrap through `track_image` first).
        The batch crosses to the device in one copy and is converted to
        float32 once; poses and stats stay on the device until one readback
        per batch. Returns the B stats dicts."""
        if self.phase != 2:
            raise RuntimeError(
                "track_batch requires a bootstrapped pipeline (phase 2); "
                "feed initial frames through track_image first"
            )
        with timer.span("vo.entry"):
            ims = torch.as_tensor(np.asarray(imgs)).to(self.device).to(torch.float32)
            if self._undist_map is not None:
                ims = torch.stack([cam_mod.remap(im, self._undist_map) for im in ims])
            f64 = torch.float64
            rows = []
            for im in ims:
                prev = self.state
                self.state, sc = self._steady_step(prev, im)
                est_ok = sc.pose_ok
                if not bool(sc.pose_ok):
                    with timer.span("vo.fallback"):
                        self.state, est_ok = self._fallback_5pt(prev, self.state)
                rec = self._i32(0)
                if bool(self.state.fail_count >= self.cfg.motion.recover_after):
                    with timer.span("vo.recover"):
                        self.state, rec = self._recover(self.state)
                ba = torch.tensor([-1.0, 0.0, 1.0], dtype=f64, device=self.device)
                if bool(sc.need_keyframe & est_ok & (rec == 0)):
                    with timer.span("vo.keyframe"):
                        self.state, ba_err, n_tri, ba_acc = self._keyframe_step(self.state)
                    ba = torch.stack([ba_err.to(f64), n_tri.to(f64), ba_acc.to(f64)])
                rows.append(torch.cat([
                    self.state.T_wc.reshape(16).to(f64),
                    torch.stack([v.to(f64) for v in sc]),
                    torch.stack([rec.to(f64), self.state.fail_count.to(f64), est_ok.to(f64)]),
                    ba,
                ]))
            host = torch.stack(rows).cpu().numpy()  # the batch's one readback
            names = MonoFrameStats._fields + _BATCH_EXTRA
            out = []
            for row in host:
                f = dict(zip(names, row[16:]))
                need_kf = bool(f["need_keyframe"]) and bool(f["est_ok"]) and int(f["recovered"]) == 0
                out.append(self._record(
                    row[:16].reshape(4, 4).astype(np.float32), f, int(f["fail_count"]), int(f["recovered"]), need_kf,
                    float(f["ba_err"]) if f["ba_err"] >= 0 else None, need_kf and not bool(f["ba_acc"]),
                    int(f["n_triangulated"]),
                ))
            return out

    def _record(self, T_wc: np.ndarray, f: dict, fail_count: int, recovered: int, need_kf: bool, ba_err,
                ba_rejected: bool, n_tri: int) -> dict:
        """Append one steady frame's pose and stats (host values; f holds the
        MonoFrameStats fields) to the logs. Returns the stats dict."""
        stats = {
            # Trajectory index (matches frame_poses.txt rows and batch numbering).
            "frame": len(self.trajectory),
            "phase": "steady",
            "keyframe": need_kf,
            "n_initial": int(f["n_initial"]),
            "n_ok_parallax": int(f["n_ok_parallax"]),
            "n_tracked": int(f["n_tracked"]),
            "n_gn": int(f["n_gn"]),
            "n_inliers": int(f["n_inliers"]),
            "n_new": int(f["n_new"]),
            "pose_ok": bool(f["pose_ok"]),
            "used_fallback": not bool(f["pose_ok"]),
            "fail_count": fail_count,
            "recovered": recovered,
            "mean_reproj_err": float(f["mean_reproj_err"]),
            "overlap_ratio": float(f["overlap_ratio"]),
            "steering_angle": float(f["steering_angle"]),
            "n_pass_1p": int(f["n_pass_1p"]),
            "avg_parallax": float(f["avg_parallax"]),
            "avg_age": float(f["avg_age"]),
            "ba_err": ba_err,
            "ba_rejected": ba_rejected,
            "n_triangulated": n_tri,
        }
        self.trajectory.append(T_wc)
        if need_kf:
            self.kf_trajectory.append((stats["frame"], T_wc))
        self.stats_log.append(stats)
        return stats

    def debug_overlay(self, img: np.ndarray) -> np.ndarray:
        """Debug image of the current frame: tracked features green, new
        features blue, landmark reprojections red. Returns RGB uint8."""
        from ..io import draw_tracking

        st = self.state
        pts = st.tracks.pts.cpu().numpy()
        valid = st.tracks.valid.cpu().numpy()
        lm_idx = st.tracks.lm_idx.cpu().numpy()
        new_mask = st.arena.age.cpu().numpy()[lm_idx] <= 1
        T_cw = geo.se3_inverse(st.T_wc).cpu().numpy()
        Xc = st.arena.Xw.cpu().numpy()[lm_idx] @ T_cw[:3, :3].T + T_cw[:3, 3]
        tri = st.arena.triangulated.cpu().numpy()[lm_idx] & valid & (Xc[:, 2] > 0.1)
        uv = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-6) * np.array([self.fx, self.fy]) + np.array(
            [self.cx, self.cy]
        )
        return draw_tracking(img, pts, valid, new_mask, uv[tri])


def state_to_numpy(state: MonoVOState) -> tuple:
    """The state as nested tuples of numpy arrays, in the field order of the
    reference `MonoVOState` (its pytree leaf order), pyramids included."""
    return tree_to_numpy(state)


def state_from_numpy(tree, device="cuda") -> MonoVOState:
    """Build the port's state from the reference `MonoVOState` after
    `jax.device_get` (or any nested tuple with the same field order)."""
    return tree_from_numpy(MonoVOState, tree, torch.device(device))
