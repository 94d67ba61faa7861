"""Stereo visual-odometry pipeline: first frame, steady step, recovery,
keyframe + BA, and the per-frame, timed and batch entry points.

Counterpart of `visual_odometry_ros_tpu/models/stereo_vo.py`. The steady
step runs the same four stages (track, stereo, pose, update with
replenishment) over fixed-capacity state (tracks N, arena M, ring K). Each
of the reference's `lax.cond` gates is a Python branch on one synchronised
scalar: the global-shift alignment, replenishment, tracking-loss recovery
and its tiers, and the keyframe step. The reference's `lax.scan` over a
batch is a frame loop whose per-frame outputs stay on the device until one
readback per batch.
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
from ..ops import features as F
from ..ops import klt as KLT
from ..ops import pnp as PNP
from ..ops import pose_gn as PG
from ..ops import stereo_disparity as SD
from ..ops import triangulate as TRI
from ..ops.pyramid import build_pyramid_with_gradients, global_shift_zncc
from ..utils import geometry as geo
from ..utils import interp, robust, timer
from ._state import at, rot_deg, tree_from_numpy, tree_to_numpy

# Minimal-set hypotheses per recovery PnP (the reference's n_hypotheses).
_RECOVERY_HYPOTHESES = 128


@dataclass
class StereoVOState(A._Replace):
    T_wc: torch.Tensor  # [4, 4] current left-cam pose (cam->world)
    dT: torch.Tensor  # [4, 4] last frame-to-frame motion
    tracks: A.TrackState
    tracks_r: torch.Tensor  # [N, 2] right-cam pixel per track lane
    tracks_r_valid: torch.Tensor  # [N]
    arena: A.LandmarkArena
    ring: A.KeyframeRing
    pyr_prev: tuple  # previous left pyramid ((img, gx, gy), ...)
    img_r: torch.Tensor  # previous right level-0 image
    frame_id: torch.Tensor  # [] int32
    fail_count: torch.Tensor  # [] int32 — consecutive failed poses


class FrameStats(NamedTuple):
    n_initial: torch.Tensor
    n_tracked: torch.Tensor
    n_inliers: torch.Tensor
    n_new: torch.Tensor
    pose_ok: torch.Tensor
    mean_reproj_err: torch.Tensor
    overlap_ratio: torch.Tensor
    kf_translation: torch.Tensor
    kf_rotation_deg: torch.Tensor
    need_keyframe: torch.Tensor
    avg_parallax: torch.Tensor
    avg_age: torch.Tensor
    n_ok_parallax: torch.Tensor
    fail_count: torch.Tensor
    recovered: torch.Tensor


class StereoVO:
    """Stereo VO on one device: per-frame scalar control flow in Python, tensor
    work on `device`."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        c, cr = cfg.cam, cfg.cam_right
        T_lr = torch.as_tensor(np.asarray(cfg.T_lr, np.float32)).to(self.device)
        left = cam_mod.make_camera(c.fx, c.fy, c.cx, c.cy, c.dist, c.width, c.height, self.device)
        if cfg.flagDoUndistortion:
            # Every frame is rectified; the pipeline sees the rectified
            # camera and the rectified extrinsics.
            right = cam_mod.make_camera(cr.fx, cr.fy, cr.cx, cr.cy, cr.dist, cr.width, cr.height,
                                        self.device)
            self.stereo = cam_mod.make_stereo_camera(left, right, T_lr)
            self.rect = self.stereo.rect
            self.T_rl = geo.se3_inverse(self.stereo.T_lr_rect)
        else:
            self.stereo = None
            self.rect = left
            self.T_rl = geo.se3_inverse(T_lr)
        # Intrinsics as float32 values, as the reference camera stores them.
        self.fx = float(self.rect.fx)
        self.fy = float(self.rect.fy)
        self.cx = float(self.rect.cx)
        self.cy = float(self.rect.cy)
        self.baseline = float(torch.linalg.norm(T_lr[:3, 3]))

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
        self.klt_params_epi = self.klt_params._replace(iters=t.epi_iter, iters_coarse=t.epi_iter)
        m = cfg.motion
        self.pose_params = PG.PoseGNParams(
            max_iters=m.pose_ba_iters,
            huber_delta=m.huber_delta,
            reproj_thresh=m.thres_poseba_error,
            min_inlier_ratio=m.min_inlier_ratio,
            min_inliers=m.min_inliers,
        )
        self.ba_params = BA.BAParams(iters=m.lba_iters, n_fix=cfg.keyframe.n_fix, huber_delta=m.lba_huber)

        self.state: StereoVOState | None = None
        self.trajectory: list[np.ndarray] = []
        self.kf_trajectory: list[tuple[int, np.ndarray]] = []
        self.stats_log: list[dict] = []

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _eye4(self):
        return torch.eye(4, dtype=torch.float32, device=self.device)

    def init_state(self, pyr) -> StereoVOState:
        d = self.device
        return StereoVOState(
            T_wc=self._eye4(),
            dT=self._eye4(),
            tracks=A.make_tracks(self.N, d),
            tracks_r=torch.zeros((self.N, 2), dtype=torch.float32, device=d),
            tracks_r_valid=torch.zeros((self.N,), dtype=torch.bool, device=d),
            arena=A.make_arena(self.M, d),
            ring=A.make_ring(self.K, self.N, d),
            pyr_prev=pyr,
            img_r=torch.zeros_like(pyr[0][0]),
            frame_id=torch.tensor(0, dtype=torch.int32, device=d),
            fail_count=torch.tensor(0, dtype=torch.int32, device=d),
        )

    def _build_pyr(self, img):
        # The kernel leg takes template gradients itself; gradient pyramids
        # are only needed by the plain ("off") leg.
        return build_pyramid_with_gradients(
            img, self.klt_params.levels, with_gradients=not self.klt_params.use_kernel
        )

    def _coarse_disparity_prior(self, pyr_l, pyr_r, pts):
        """Per-feature disparity prior for new features from a coarse-level
        ZNCC cost volume; ambiguous (repeated-texture) pixels are flagged,
        unmatched ones fall back to the median of the valid map."""
        lvl = min(2, len(pyr_l) - 1)
        scale = float(2**lvl)
        dres = SD.zncc_disparity(
            pyr_l[lvl][0], pyr_r[lvl][0], max_disp=48, radius=3, min_zncc=0.5,
            peak_margin=0.03, fxb=self.fx * self.baseline / scale,
        )
        pts_c = pts / scale
        d_s, ok_s = interp.bilinear_sample(dres.disparity, pts_c, valid_border=1.0)
        v_s, _ = interp.bilinear_sample(dres.valid.to(torch.float32), pts_c, valid_border=1.0)
        a_s, _ = interp.bilinear_sample(dres.ambiguous.to(torch.float32), pts_c, valid_border=1.0)
        med = robust.masked_median_histogram(
            dres.disparity.reshape(-1), dres.valid.reshape(-1), 0.0, 48.0, 96
        )
        med = torch.where(torch.any(dres.valid), med, 8.0 / scale)
        good = ok_s & (v_s > 0.99)
        return torch.where(good, d_s, med) * scale, good, a_s > 0.01

    def _stereo_match(self, pyr_l, pyr_r, pts_l, valid, depth_prior=None, disp_prior=None,
                      bidir=True):
        """Prior-seeded 1-D epipolar KLT left->right (rectified stereo)."""
        if depth_prior is not None:
            disp = self.fx * self.baseline / torch.clamp(depth_prior, min=0.5)
        elif disp_prior is not None:
            disp = disp_prior
        else:
            disp = torch.full(pts_l.shape[:1], 8.0, device=self.device)
        prior = pts_l - torch.stack([disp, torch.zeros_like(disp)], dim=-1)
        if bidir:
            pts_r, ok = KLT.track_bidirectional_pyr(
                pyr_l, pyr_r, pts_l, prior, valid, self.klt_params_epi,
                fb_scale=5.0, back_levels=1, epi1d=True,
            )
        else:
            pts_r, ok = KLT.track_with_prior_pyr(
                pyr_l, pyr_r, pts_l, prior, valid, self.klt_params_epi, track_levels=1, epi1d=True,
            )
        disp_out = pts_l[:, 0] - pts_r[:, 0]
        row_ok = torch.abs(pts_r[:, 1] - pts_l[:, 1]) < 2.0
        return pts_r, ok & row_ok & (disp_out > 0.3), disp_out

    def _invd_sigma2(self, img, pts):
        """Inverse-depth measurement variance from the local unit gradient."""
        ex = torch.tensor([1.0, 0.0], device=self.device)
        ey = torch.tensor([0.0, 1.0], device=self.device)
        ipx, _ = interp.bilinear_sample(img, pts + ex)
        imx, _ = interp.bilinear_sample(img, pts - ex)
        ipy, _ = interp.bilinear_sample(img, pts + ey)
        imy, _ = interp.bilinear_sample(img, pts - ey)
        du = (ipx - imx) * 0.5
        dv = (ipy - imy) * 0.5
        mag = torch.clamp(torch.sqrt(du * du + dv * dv), min=1e-6)
        duh = du / mag
        dvh = dv / mag
        eps_edge, eps_epi = 0.5, 1.0
        bfinv = 1.0 / (self.fx * self.baseline)
        sig = (
            torch.sqrt(eps_edge**2 + eps_epi**2 * dvh * dvh)
            / torch.clamp(torch.abs(duh), min=0.05)
            * bfinv
        )
        return sig * sig

    def _triangulate_stereo(self, pts_l, disp, ok):
        """Rectified closed form: z = fx b / d; X from the left pixel ray."""
        z = self.fx * self.baseline / torch.where(ok, torch.clamp(disp, min=1e-3), 1.0)
        ok = ok & (z > self.cfg.map.min_depth) & (z < self.cfg.map.max_depth)
        x = (pts_l[:, 0] - self.cx) / self.fx * z
        y = (pts_l[:, 1] - self.cy) / self.fy * z
        return torch.stack([x, y, z], dim=-1), ok

    def _replenish(self, pyr_l, pyr_r, tracks, arena, T_wc, allow=True):
        """Detect in empty bins, stereo-match, verify, triangulate, allocate
        arena slots and merge into free track lanes."""
        with timer.span("vo.replenish"):
            cfg = self.cfg
            d = self.device
            n_new = self.N // 2
            new_pts, new_ok = F.detect_features(
                pyr_l[0][0], tracks.pts, tracks.valid, gh=cfg.extractor.n_bins_v,
                gw=cfg.extractor.n_bins_u, n_max=n_new, fast_thresh=cfg.extractor.thres_fastscore,
                score_min=cfg.extractor.score_min,
            )
            new_ok = new_ok & allow
            disp_prior, prior_ok, ambiguous = self._coarse_disparity_prior(pyr_l, pyr_r, new_pts)
            pts_r, ok_r, disp = self._stereo_match(pyr_l, pyr_r, new_pts, new_ok, disp_prior=disp_prior)
            # Birth gate: distinct coarse peak -> KLT must agree (+-4 px);
            # ambiguous -> veto; no signal -> KLT gates alone.
            ok_r = ok_r & ~ambiguous & (~prior_ok | (torch.abs(disp - disp_prior) < 4.0))
            ok_v, _ = SD.verify_disparity_zncc(pyr_l[0][0], pyr_r[0][0], new_pts, disp, new_ok & ok_r)
            ok_r = ok_r & ok_v
            Xc, ok3 = self._triangulate_stereo(new_pts, disp, new_ok & ok_r)
            Xw = geo.transform_points(T_wc, Xc)
            desc_w, desc_ok = F.orb_descriptors(pyr_l[0][0], new_pts)
            desc_u8 = F.desc_to_u8(desc_w)

            slots, slot_ok = A.allocate_slots(~arena.alive, n_new)
            ok_new = ok3 & slot_ok
            zeros_n = torch.zeros((n_new,), dtype=torch.float32, device=d)
            up = A.indexed_update
            arena = arena.replace(
                Xw=up(arena.Xw, slots, ok_new, Xw),
                alive=up(arena.alive, slots, ok_new, op="or"),
                tracked=up(arena.tracked, slots, ok_new, op="or"),
                triangulated=up(arena.triangulated, slots, ok_new, op="or"),
                bundled=up(arena.bundled, slots, ok_new, torch.zeros((n_new,), dtype=torch.bool, device=d)),
                age=up(arena.age, slots, ok_new, torch.ones((n_new,), dtype=torch.int32, device=d)),
                last_pt=up(arena.last_pt, slots, ok_new, new_pts),
                inv_depth=up(arena.inv_depth, slots, ok_new, 1.0 / torch.clamp(Xc[:, 2], min=1e-3)),
                inv_depth_var=up(arena.inv_depth_var, slots, ok_new, self._invd_sigma2(pyr_l[0][0], new_pts)),
                parallax_last=up(arena.parallax_last, slots, ok_new, zeros_n),
                parallax_max=up(arena.parallax_max, slots, ok_new, zeros_n),
                parallax_min=up(arena.parallax_min, slots, ok_new, torch.full_like(zeros_n, A.PARALLAX_MIN_INIT)),
                parallax_sum=up(arena.parallax_sum, slots, ok_new, zeros_n),
                parallax_n=up(arena.parallax_n, slots, ok_new, torch.zeros((n_new,), dtype=torch.int32, device=d)),
                desc=up(arena.desc, slots, ok_new & desc_ok, desc_u8),
                # set over EVERY born slot: a reused slot whose birth descriptor
                # is invalid must not keep the dead landmark's descriptor.
                desc_valid=up(arena.desc_valid, slots, ok_new, desc_ok),
            )

            lanes, lane_ok = A.allocate_slots(~tracks.valid, n_new)
            put = ok_new & lane_ok
            tracks = tracks.replace(
                pts=up(tracks.pts, lanes, put, new_pts),
                lm_idx=up(tracks.lm_idx, lanes, put, slots),
                valid=up(tracks.valid, lanes, put, op="or"),
                scale=up(tracks.scale, lanes, put, torch.ones((n_new,), dtype=torch.float32, device=d)),
            )
            pts_r_new = up(torch.zeros((self.N, 2), dtype=torch.float32, device=d), lanes, put, pts_r)
            pts_r_valid_new = up(torch.zeros((self.N,), dtype=torch.bool, device=d), lanes, put, op="or")
            return tracks, arena, pts_r_new, pts_r_valid_new, torch.sum(put).to(torch.int32)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _first_frame(self, img_l, img_r) -> StereoVOState:
        pyr_l = self._build_pyr(img_l)
        pyr_r = self._build_pyr(img_r)
        state = self.init_state(pyr_l)
        tracks, arena, pts_r_new, pts_r_valid, _ = self._replenish(
            pyr_l, pyr_r, state.tracks, state.arena, state.T_wc
        )
        ring = A.ring_push(
            state.ring, self._eye4(), 0, tracks.pts, pts_r_new, tracks.lm_idx, tracks.valid,
            pts_r_valid,
        )
        return state.replace(
            tracks=tracks, tracks_r=pts_r_new, tracks_r_valid=pts_r_valid, arena=arena, ring=ring,
            pyr_prev=pyr_l, img_r=pyr_r[0][0],
            frame_id=torch.tensor(1, dtype=torch.int32, device=self.device),
        )

    def _track_stage(self, state: StereoVOState, img_l, img_r):
        """Pyramids, constant-velocity priors, prior-seeded KLT, scale refinement."""
        tracks = state.tracks
        arena = state.arena
        lm = tracks.lm_idx.to(torch.int64)
        pyr_l = self._build_pyr(img_l)
        pyr_r = self._build_pyr(img_r)

        T_wc_prior = state.T_wc @ state.dT
        T_cw_prior = geo.se3_inverse(T_wc_prior)
        T_cw_prev = geo.se3_inverse(state.T_wc)
        lm_X = arena.Xw[lm]
        prior_pts, prior_depth = KLT.calc_prior(lm_X, T_cw_prior, self.fx, self.fy, self.cx, self.cy)
        depth_prev = geo.transform_points(T_cw_prev, lm_X)[..., 2]
        scale_prior = torch.clamp(depth_prev / torch.clamp(prior_depth, min=0.1), 0.25, 4.0)
        has_3d = tracks.valid & arena.triangulated[lm] & (prior_depth > 0.1)

        # Untrusted pose or no velocity yet: seed from the measured dominant
        # image shift; otherwise features without depth get a far-point
        # (z = 20 m) motion seed through dT.
        blackout = state.fail_count > 0
        dT_fresh = torch.sum(torch.abs(state.dT - self._eye4())) < 1e-6
        prior_trusted = has_3d & ~blackout & ~dT_fresh
        lvl_c = len(pyr_l) - 1
        need_gs = blackout | dT_fresh
        if bool(need_gs):
            gshift = global_shift_zncc(state.pyr_prev[lvl_c][0], pyr_l[lvl_c][0])[0] * (2.0**lvl_c)
        else:
            gshift = torch.zeros(2, dtype=torch.float32, device=self.device)
        z_far = 20.0
        xn = (tracks.pts[:, 0] - self.cx) / self.fx
        yn = (tracks.pts[:, 1] - self.cy) / self.fy
        Xp = torch.stack([xn * z_far, yn * z_far, torch.full_like(xn, z_far)], dim=-1)
        T10 = geo.se3_inverse(state.dT)
        Xc = Xp @ T10[:3, :3].T + T10[:3, 3]
        zc = torch.clamp(Xc[:, 2], min=1.0)
        far_pts = torch.stack(
            [Xc[:, 0] / zc * self.fx + self.cx, Xc[:, 1] / zc * self.fy + self.cy], dim=-1
        )
        fallback_pts = torch.where(need_gs, tracks.pts + gshift[None, :], far_pts)
        prior_pts = torch.where(prior_trusted[:, None], prior_pts, fallback_pts)
        scale_prior = torch.where(blackout, torch.ones_like(scale_prior), scale_prior)

        pts1, ok_track = KLT.track_with_prior_pyr(
            state.pyr_prev, pyr_l, tracks.pts, prior_pts, tracks.valid, self.klt_params
        )
        img_prev, du0, dv0 = state.pyr_prev[0]
        pts1_ref, ok_scale = KLT.track_with_scale(
            img_prev, du0, dv0, img_l, tracks.pts, pts1, scale_prior, ok_track,
            iters=self.cfg.tracker.scale_iter, use_kernel=self.klt_params.use_kernel,
        )
        pts1 = torch.where(ok_scale[:, None], pts1_ref, pts1)
        return pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth, scale_prior

    def _stereo_stage(self, pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth):
        """Static stereo matching with the landmark depth prior (forward only)."""
        return self._stereo_match(
            pyr_l, pyr_r, pts1, ok_track, torch.where(has_3d, prior_depth, 10.0), bidir=False
        )

    def _pose_stage(self, state: StereoVOState, pts1, pts_r1, ok_track, ok_stereo, has_3d):
        """Stereo pose-only GN, motion-sanity gate, reprojection outlier gate."""
        T_cw_prev = geo.se3_inverse(state.T_wc)
        lm_X = state.arena.Xw[state.tracks.lm_idx.to(torch.int64)]
        X0 = geo.transform_points(T_cw_prev, lm_X)
        gn_valid = ok_track & has_3d
        T10_init = geo.se3_inverse(state.dT)
        res, _ = PG.pose_only_gn_stereo_robust(
            X0, pts1, pts_r1, gn_valid, gn_valid & ok_stereo, self.fx, self.fy, self.cx, self.cy,
            self.T_rl, T10_init, self.pose_params,
        )
        m = self.cfg.motion
        dT_cand = geo.se3_inverse(res.T10)
        step_prev = torch.linalg.norm(state.dT[:3, 3])
        step_new = torch.linalg.norm(dT_cand[:3, 3])
        rot_prev = rot_deg(state.dT[:3, :3])
        rot_new = rot_deg(dT_cand[:3, :3])
        sane = (step_new <= torch.clamp(m.sanity_step_mult * step_prev, min=m.max_step_abs)) & (
            rot_new <= torch.clamp(m.sanity_step_mult * rot_prev, min=m.max_rot_abs_deg)
        )
        pose_ok = res.ok & sane
        T10 = torch.where(pose_ok, res.T10, T10_init)
        dT_new = geo.se3_inverse(T10)
        T_wc_new = geo.se3_project(state.T_wc @ dT_new)
        # Trusted pose: keep reprojection inliers. Failed pose: keep every
        # KLT-consistent track (the prior drifts during a blackout).
        inliers = torch.where(pose_ok, res.inliers, True)
        survived = ok_track & torch.where(has_3d, inliers, True)
        return T10, dT_new, T_wc_new, survived, pose_ok, res.mean_err

    def _update_stage(self, state: StereoVOState, pyr_l, pyr_r, pts1, pts_r1, ok_track, ok_stereo,
                      scale_prior, T10, dT_new, T_wc_new, survived, pose_ok, mean_err):
        """Arena/parallax updates, keyframe rule, replenishment, stats."""
        cfg = self.cfg
        d = self.device
        tracks = state.tracks
        arena = state.arena
        lm = tracks.lm_idx
        T_cw_prev = geo.se3_inverse(state.T_wc)
        lm_X = arena.Xw[lm.to(torch.int64)]

        ray_prev = geo.transform_points(T_cw_prev, lm_X)
        ray_curr = torch.stack(
            [(pts1[:, 0] - self.cx) / self.fx, (pts1[:, 1] - self.cy) / self.fy,
             torch.ones(self.N, device=d)], dim=-1,
        )
        r0 = ray_prev / torch.clamp(torch.linalg.norm(ray_prev, dim=-1, keepdim=True), min=1e-9)
        r1 = ray_curr @ T10[:3, :3]
        r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-9)
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

        # Keyframe rule: overlap with the last keyframe + motion thresholds,
        # decided before replenishment (births cannot change the overlap).
        head = state.ring.head
        last_kf_lm = at(state.ring.lm_idx, head).to(torch.int64)
        last_kf_ov = at(state.ring.obs_valid, head)
        still = up(torch.zeros((self.M,), dtype=torch.bool, device=d), tracks.lm_idx, tracks.valid, op="or")
        still = torch.cat([still, torch.zeros((1,), dtype=torch.bool, device=d)])
        overlap = torch.sum(still[torch.where(last_kf_ov, last_kf_lm, self.M)] & last_kf_ov) / torch.clamp(
            torch.sum(last_kf_ov), min=1
        )
        T_kf_wc = geo.se3_inverse(at(state.ring.T_cw, head))
        dT_kf = geo.se3_inverse(T_kf_wc) @ T_wc_new
        trans = torch.linalg.norm(dT_kf[:3, 3])
        rot_kf = rot_deg(dT_kf[:3, :3])
        need_kf = (
            (overlap < cfg.keyframe.thres_overlap_ratio)
            | (trans > cfg.keyframe.thres_translation)
            | (rot_kf > cfg.keyframe.thres_rotation)
        ) & pose_ok

        # Replenish only under a trusted pose, and only on a track deficit
        # or a keyframe.
        deficit = torch.sum(tracks.valid) < int(cfg.extractor.replenish_min_ratio * self.N)
        if bool(pose_ok & (deficit | need_kf)):
            tracks, arena, pts_r_new, pts_r_valid_new, n_new = self._replenish(
                pyr_l, pyr_r, tracks, arena, T_wc_new, allow=True
            )
        else:
            pts_r_new = torch.zeros((self.N, 2), dtype=torch.float32, device=d)
            pts_r_valid_new = torch.zeros((self.N,), dtype=torch.bool, device=d)
            n_new = torch.tensor(0, dtype=torch.int32, device=d)
        tracks_r = torch.where(pts_r_valid_new[:, None], pts_r_new, pts_r1)
        tracks_r_valid = pts_r_valid_new | (survived & ok_stereo)
        fail_count = torch.where(pose_ok, 0, state.fail_count + 1).to(torch.int32)
        n_ok_parallax = torch.sum(arena.alive & (arena.parallax_max >= math.radians(cfg.map.thres_parallax)))

        stats = FrameStats(
            n_initial=torch.sum(state.tracks.valid),
            n_tracked=torch.sum(ok_track),
            n_inliers=torch.sum(survived),
            n_new=n_new,
            pose_ok=pose_ok,
            mean_reproj_err=mean_err,
            overlap_ratio=overlap,
            kf_translation=trans,
            kf_rotation_deg=rot_kf,
            need_keyframe=need_kf,
            avg_parallax=avg_parallax,
            avg_age=avg_age,
            n_ok_parallax=n_ok_parallax,
            fail_count=fail_count,
            recovered=torch.tensor(0, dtype=torch.int32, device=d),
        )
        new_state = state.replace(
            T_wc=T_wc_new, dT=dT_new, tracks=tracks, tracks_r=tracks_r,
            tracks_r_valid=tracks_r_valid, arena=arena, pyr_prev=pyr_l, img_r=pyr_r[0][0],
            frame_id=state.frame_id + 1, fail_count=fail_count,
        )
        return new_state, stats

    def _recovery_generator(self, frame_id: int, tier: int) -> torch.Generator:
        """Generator of one recovery tier's RANSAC draws, seeded from
        (0x5EC0, frame_id, tier) as the reference folds its key: runs
        repeat, and each tier's draws do not depend on the other's."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((0x5EC0 << 40) | (frame_id << 8) | tier)
        return gen

    def _rebootstrap(self, s: StereoVOState, pyr_l, pyr_r) -> StereoVOState:
        """Fresh tracks and landmarks at s.T_wc, a fresh keyframe window (a
        new BA gauge) and dT = I. Landmarks of the old map stay in the arena
        but are no longer tracked."""
        d = self.device
        arena = s.arena.replace(tracked=torch.zeros_like(s.arena.tracked))
        tracks, arena, pts_r_new, pts_r_valid, _ = self._replenish(
            pyr_l, pyr_r, A.make_tracks(self.N, d), arena, s.T_wc, allow=True
        )
        ring = A.ring_push(
            A.make_ring(self.K, self.N, d), geo.se3_inverse(s.T_wc), s.frame_id, tracks.pts,
            pts_r_new, tracks.lm_idx, tracks.valid, pts_r_valid,
        )
        return s.replace(
            dT=self._eye4(), tracks=tracks, tracks_r=pts_r_new, tracks_r_valid=pts_r_valid,
            arena=arena, ring=ring, fail_count=torch.zeros_like(s.fail_count),
        )

    def _recover(self, state: StereoVOState, pyr_l, pyr_r, pts1, ok_track, has_3d, draw=None):
        """Tracking-loss recovery after `recover_after` consecutive failed poses.

        Tier 1 (mode 1): PnP relocalization on the surviving tracked
        landmarks; keeps their inlier tracks. Tier 2 (mode 3): fresh
        detections matched by descriptor against the arena's birth
        descriptors, PnP on those matches, then a re-bootstrap at the
        corrected pose. Tier 3 (mode 2): re-bootstrap at the dead-reckoned
        pose. Every tier resets dT to I: a stale velocity prior locks tracks
        on repeated texture onto the alias consistent with it.

        Tier 2 runs only when tier 1 fails (the reference computes it always
        and discards it then). draw(tier, valid) -> [128, 6] replaces the
        RANSAC draws (tests inject the reference's). Returns (state, mode)."""
        m = self.cfg.motion
        if draw is None:
            fid = int(state.frame_id)

            def draw(tier, valid):
                return PNP.sample_minimal_sets(valid, _RECOVERY_HYPOTHESES,
                                               self._recovery_generator(fid, tier))

        def mode_t(mode):
            return torch.tensor(mode, dtype=torch.int32, device=self.device)

        arena = state.arena
        lm = state.tracks.lm_idx.to(torch.int64)
        cand = ok_track & has_3d & arena.alive[lm]
        T_cw_prior = geo.se3_inverse(state.T_wc)
        max_jump = 2.0 * m.recover_after * m.max_step_abs
        thr = self.pose_params.reproj_thresh
        intr = (self.fx, self.fy, self.cx, self.cy)

        pnp = PNP.pnp_ransac(
            arena.Xw[lm], pts1, cand, *intr, thresh_px=1.5 * thr, n_hypotheses=_RECOVERY_HYPOTHESES,
            min_inlier_ratio=0.3, T_init=T_cw_prior, idx=draw(1, cand),
        )
        T_wc_pnp = geo.se3_inverse(pnp.T_cw)
        jump = torch.linalg.norm(T_wc_pnp[:3, 3] - state.T_wc[:3, 3])
        if bool(pnp.ok & (pnp.n_inliers >= 15) & (jump <= max_jump)):
            valid_new = (cand & pnp.inliers) | (state.tracks.valid & ~has_3d)
            return state.replace(
                T_wc=T_wc_pnp, dT=self._eye4(), tracks=state.tracks.replace(valid=valid_new),
                fail_count=torch.zeros_like(state.fail_count),
            ), mode_t(1)

        cfg = self.cfg.extractor
        img0 = pyr_l[0][0]
        det_pts, det_ok = F.detect_features(
            img0, torch.zeros((self.N, 2), dtype=torch.float32, device=self.device),
            torch.zeros((self.N,), dtype=torch.bool, device=self.device), gh=cfg.n_bins_v,
            gw=cfg.n_bins_u, n_max=self.N // 2, fast_thresh=cfg.thres_fastscore,
            score_min=cfg.score_min,
        )
        dw, dv = F.orb_descriptors(img0, det_pts)
        lm_ok = arena.alive & arena.triangulated & arena.desc_valid
        midx, m_ok = F.match_descriptors(F.desc_to_u8(dw), det_ok & dv, arena.desc, lm_ok, max_dist=60)
        pnp_d = PNP.pnp_ransac(
            arena.Xw[torch.clamp(midx, min=0)], det_pts, m_ok, *intr, thresh_px=2.0 * thr,
            n_hypotheses=_RECOVERY_HYPOTHESES, min_inlier_ratio=0.3, T_init=T_cw_prior,
            idx=draw(2, m_ok),
        )
        T_wc_d = geo.se3_inverse(pnp_d.T_cw)
        jump_d = torch.linalg.norm(T_wc_d[:3, 3] - state.T_wc[:3, 3])
        if bool(pnp_d.ok & (pnp_d.n_inliers >= 15) & (jump_d <= max_jump)):
            return self._rebootstrap(state.replace(T_wc=T_wc_d), pyr_l, pyr_r), mode_t(3)
        return self._rebootstrap(state, pyr_l, pyr_r), mode_t(2)

    def _steady_step(self, state: StereoVOState, img_l, img_r, draw=None, stage_ms=None):
        """One steady-state frame: track, stereo, pose, update, and recovery
        once the pose has failed `recover_after` frames in a row.

        stage_ms: a dict to fill with per-stage wall times (time_track,
        time_stereo, time_pose, time_new: the update and a recovery); each
        stage then runs between two device synchronises. draw: see `_recover`."""
        d = self.device
        with timer.span("vo.track", stage_ms, "time_track", d):
            pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth, scale_prior = self._track_stage(state, img_l, img_r)
        with timer.span("vo.stereo", stage_ms, "time_stereo", d):
            pts_r1, ok_stereo, _ = self._stereo_stage(pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth)
        with timer.span("vo.pose", stage_ms, "time_pose", d):
            T10, dT_new, T_wc_new, survived, pose_ok, mean_err = self._pose_stage(
                state, pts1, pts_r1, ok_track, ok_stereo, has_3d
            )
        with timer.span("vo.update", stage_ms, "time_new", d):
            new_state, stats = self._update_stage(
                state, pyr_l, pyr_r, pts1, pts_r1, ok_track, ok_stereo, scale_prior,
                T10, dT_new, T_wc_new, survived, pose_ok, mean_err,
            )
        if bool(new_state.fail_count >= self.cfg.motion.recover_after):
            with timer.span("vo.recover", stage_ms, "time_new", d):
                new_state, mode = self._recover(new_state, pyr_l, pyr_r, pts1, ok_track, has_3d, draw)
            stats = stats._replace(recovered=mode)
        return new_state, stats

    def _steady_step_timed(self, state: StereoVOState, img_l, img_r):
        """The steady step with each stage synchronised and host-timed.
        Returns (state, stats, stage_ms)."""
        stage_ms = {}
        state, stats = self._steady_step(state, img_l, img_r, stage_ms=stage_ms)
        return state, stats, stage_ms

    def _retriangulate_tracked(self, state: StereoVOState):
        """Keyframe-time depth refresh: two-view re-triangulation of tracked
        landmarks, both-view reprojection + chirality + full-res ZNCC checks,
        then product-of-Gaussians fusion with a 3-sigma gate."""
        tracks = state.tracks
        lm = tracks.lm_idx.to(torch.int64)
        both = tracks.valid & state.tracks_r_valid
        xn_l = torch.stack(
            [(tracks.pts[:, 0] - self.cx) / self.fx, (tracks.pts[:, 1] - self.cy) / self.fy], dim=-1
        )
        xn_r = torch.stack(
            [(state.tracks_r[:, 0] - self.cx) / self.fx, (state.tracks_r[:, 1] - self.cy) / self.fy],
            dim=-1,
        )
        Xl, Xr = TRI.triangulate(xn_l, xn_r, self.T_rl)
        zl = torch.clamp(Xl[:, 2], min=1e-6)
        zr = torch.clamp(Xr[:, 2], min=1e-6)
        pl = torch.stack([Xl[:, 0] / zl * self.fx + self.cx, Xl[:, 1] / zl * self.fy + self.cy], -1)
        pr = torch.stack([Xr[:, 0] / zr * self.fx + self.cx, Xr[:, 1] / zr * self.fy + self.cy], -1)
        el2 = torch.sum((pl - tracks.pts) ** 2, dim=-1)
        er2 = torch.sum((pr - state.tracks_r) ** 2, dim=-1)
        sane2 = self.pose_params.reproj_thresh**2
        good = (
            both & (el2 <= sane2) & (er2 <= sane2)
            & (Xl[:, 2] > self.cfg.map.min_depth) & (Xr[:, 2] > 0.0)
            & (Xl[:, 2] < self.cfg.map.max_depth)
        )
        disp_rt = tracks.pts[:, 0] - state.tracks_r[:, 0]
        ok_v, _ = SD.verify_disparity_zncc(state.pyr_prev[0][0], state.img_r, tracks.pts, disp_rt, good)
        good = good & ok_v

        bfinv = 1.0 / (self.fx * self.baseline)
        lm_X = state.arena.Xw[lm]
        z_prev = geo.transform_points(geo.se3_inverse(state.T_wc), lm_X)[:, 2]
        invd_prev = 1.0 / torch.clamp(z_prev, min=1e-3)
        var_stored = state.arena.inv_depth_var[lm]
        var_prev = torch.where(var_stored > 0, var_stored, 1.0)
        invd_meas = torch.clamp(disp_rt, min=1e-3) * bfinv
        var_meas = self._invd_sigma2(state.pyr_prev[0][0], tracks.pts)
        good = good & ((invd_meas - invd_prev) ** 2 <= 9.0 * (var_prev + var_meas))
        invd_f, var_f = DF.update_gaussian(invd_prev, var_prev, invd_meas, var_meas)
        z_f = 1.0 / torch.clamp(invd_f, min=1e-6)
        good = good & (z_f > self.cfg.map.min_depth) & (z_f < self.cfg.map.max_depth)
        Xl_f = torch.stack(
            [(tracks.pts[:, 0] - self.cx) / self.fx * z_f, (tracks.pts[:, 1] - self.cy) / self.fy * z_f, z_f],
            dim=-1,
        )
        Xw_new = geo.transform_points(state.T_wc, Xl_f)
        up = A.indexed_update
        a = state.arena
        arena = a.replace(
            Xw=up(a.Xw, tracks.lm_idx, good, Xw_new),
            inv_depth=up(a.inv_depth, tracks.lm_idx, good, invd_f),
            inv_depth_var=up(a.inv_depth_var, tracks.lm_idx, good, var_f),
            triangulated=up(a.triangulated, tracks.lm_idx, good, op="or"),
        )
        return state.replace(arena=arena), torch.sum(good)

    def _keyframe_step(self, state: StereoVOState):
        """Push the current frame as a keyframe and run windowed BA.
        Returns (state, BA mean error after the solve, accepted)."""
        state, _ = self._retriangulate_tracked(state)
        ring = A.ring_push(
            state.ring, geo.se3_inverse(state.T_wc), state.frame_id, state.tracks.pts,
            state.tracks_r, state.tracks.lm_idx, state.tracks.valid,
            state.tracks_r_valid & state.tracks.valid,
        )
        g = A.gather_ba_problem(ring, state.arena)
        problem = BA.BAProblem(
            T_cw=g["T_cw"], Xw=state.arena.Xw, pts=g["pts"], mask=g["mask"], pts_r=g["pts_r"],
            mask_r=g["mask_r"], kf_valid=g["kf_valid"], lm_valid=g["lm_valid"],
        )
        res = BA.ba_solve_impl(problem, self.fx, self.fy, self.cx, self.cy, self.T_rl, self.ba_params)
        accept = BA.ba_accept(res.mean_err_px, res.mean_err0_px, self.pose_params.reproj_thresh)
        T_cw_res = torch.where(accept, res.T_cw, g["T_cw"])
        Xw_res = torch.where(accept, res.Xw, state.arena.Xw)
        killed = res.killed & accept
        # Refined poses back into their ring slots (oldest -> newest order).
        ring = ring.replace(T_cw=ring.T_cw.index_put((A.ring_order(ring),), T_cw_res))
        T_wc_new = geo.se3_inverse(at(ring.T_cw, ring.head))
        touched = g["lm_valid"] & (torch.sum(problem.mask, dim=1) >= 2) & accept
        arena = state.arena.replace(
            Xw=Xw_res,
            alive=state.arena.alive & ~killed,
            desc_valid=state.arena.desc_valid & ~killed,
            bundled=state.arena.bundled | touched,
        )
        return state.replace(T_wc=T_wc_new, ring=ring, arena=arena), res.mean_err_px, accept

    # ------------------------------------------------------------------
    # entry point
    # ------------------------------------------------------------------

    def _rectify(self, il, ir):
        if self.stereo is None:
            return il, ir
        return cam_mod.rectify_stereo_images(self.stereo, il, ir)

    def _bootstrap(self, il, ir):
        """Frame 0: seed the state; the pose is the identity."""
        self.state = self._first_frame(il, ir)
        eye = np.eye(4, dtype=np.float32)
        self.trajectory.append(eye)
        self.kf_trajectory.append((0, eye))
        stats = {"frame": 0, "keyframe": True, "n_tracked": 0}
        self.stats_log.append(stats)
        return eye, stats

    def _record(self, T_wc: np.ndarray, f: dict, ba_err, ba_rejected: bool) -> dict:
        """Append one tracked frame's pose and stats (host values) to the logs."""
        need_kf = bool(f["need_keyframe"])
        stats = {
            # Trajectory index of this frame (state.frame_id counts frames seen).
            "frame": len(self.trajectory),
            "keyframe": need_kf,
            "n_initial": int(f["n_initial"]),
            "n_tracked": int(f["n_tracked"]),
            "n_inliers": int(f["n_inliers"]),
            "n_new": int(f["n_new"]),
            "n_ok_parallax": int(f["n_ok_parallax"]),
            "pose_ok": bool(f["pose_ok"]),
            "mean_reproj_err": float(f["mean_reproj_err"]),
            "overlap_ratio": float(f["overlap_ratio"]),
            "avg_parallax": float(f["avg_parallax"]),
            "avg_age": float(f["avg_age"]),
            "fail_count": int(f["fail_count"]),
            "recovered": int(f["recovered"]),
            "ba_err": ba_err,
            # A BA-rejected keyframe stays observable (a silently frozen BA
            # shows up here).
            "ba_rejected": ba_rejected,
        }
        self.trajectory.append(T_wc)
        if need_kf:
            self.kf_trajectory.append((stats["frame"], T_wc))
        self.stats_log.append(stats)
        return stats

    def track_stereo_images(self, img_l, img_r, timestamp: float = 0.0, timed: bool = False):
        """Process one stereo pair ([H, W] arrays or tensors; raw when
        `flagDoUndistortion`, else rectified). Returns (T_wc [4, 4] numpy,
        stats dict).

        timed=True synchronises and host-times every stage and adds
        stats["stage_ms"] (time_track, time_stereo, time_pose, time_new, and
        time_ba on keyframes)."""
        with timer.span("vo.entry"):
            il = torch.as_tensor(img_l, dtype=torch.float32).to(self.device)
            ir = torch.as_tensor(img_r, dtype=torch.float32).to(self.device)
            il, ir = self._rectify(il, ir)
            if self.state is None:
                return self._bootstrap(il, ir)

            stage_ms = None
            if timed:
                self.state, fstats, stage_ms = self._steady_step_timed(self.state, il, ir)
            else:
                self.state, fstats = self._steady_step(self.state, il, ir)
            ba_err = None
            ba_rejected = False
            if bool(fstats.need_keyframe):
                with timer.span("vo.keyframe", stage_ms, "time_ba", self.device):
                    self.state, ba_err_t, ba_acc = self._keyframe_step(self.state)
                ba_err = float(ba_err_t)
                ba_rejected = not bool(ba_acc)

            host = torch.stack([v.to(torch.float64) for v in fstats]).cpu().tolist()
            T_wc = self.state.T_wc.cpu().numpy()
            stats = self._record(T_wc, dict(zip(FrameStats._fields, host)), ba_err, ba_rejected)
            if timed:
                stats["stage_ms"] = stage_ms
            return T_wc, stats

    def track_stereo_batch(self, imgs_l, imgs_r):
        """Process B stereo pairs ([B, H, W], camera-native dtype such as
        uint8) in one call: the serving path. Returns the B stats dicts.

        The batch crosses to the device in one copy and is converted to
        float32 once (then rectified frame by frame under
        `flagDoUndistortion`). Poses, frame stats and BA results stay on the
        device until one readback per batch. The first call bootstraps
        frame 0 from the batch head."""
        with timer.span("vo.entry"):
            il = torch.as_tensor(np.asarray(imgs_l)).to(self.device).to(torch.float32)
            ir = torch.as_tensor(np.asarray(imgs_r)).to(self.device).to(torch.float32)
            if self.stereo is not None:
                pairs = [self._rectify(a, b) for a, b in zip(il, ir)]
                il = torch.stack([a for a, _ in pairs])
                ir = torch.stack([b for _, b in pairs])
            start = 0
            if self.state is None:
                self._bootstrap(il[0], ir[0])
                start = 1
                if il.shape[0] == 1:
                    return [self.stats_log[-1]]

            no_ba = torch.tensor([-1.0, 1.0], dtype=torch.float64, device=self.device)
            rows = []
            for i in range(start, il.shape[0]):
                self.state, fstats = self._steady_step(self.state, il[i], ir[i])
                ba = no_ba
                if bool(fstats.need_keyframe):
                    with timer.span("vo.keyframe"):
                        self.state, ba_err, ba_acc = self._keyframe_step(self.state)
                    ba = torch.stack([ba_err.to(torch.float64), ba_acc.to(torch.float64)])
                rows.append(torch.cat([
                    self.state.T_wc.reshape(16).to(torch.float64),
                    torch.stack([v.to(torch.float64) for v in fstats]),
                    ba,
                ]))
            host = torch.stack(rows).cpu().numpy()  # the batch's one readback
            out = []
            n_f = len(FrameStats._fields)
            for row in host:
                f = dict(zip(FrameStats._fields, row[16 : 16 + n_f]))
                ba_err, ba_acc = row[16 + n_f], row[17 + n_f]
                need_kf = bool(f["need_keyframe"])
                out.append(self._record(
                    row[:16].reshape(4, 4).astype(np.float32), f,
                    float(ba_err) if need_kf else None, need_kf and not bool(ba_acc),
                ))
            return out

    def debug_overlay(self, img_l: np.ndarray) -> np.ndarray:
        """Debug image of the current frame: tracked features green, new
        features blue, landmark reprojections red. Returns RGB uint8."""
        from ..io import draw_tracking

        st = self.state
        pts = st.tracks.pts.cpu().numpy()
        valid = st.tracks.valid.cpu().numpy()
        lm_idx = st.tracks.lm_idx.cpu().numpy()
        new_mask = st.arena.age.cpu().numpy()[lm_idx] <= 1
        T_cw = geo.se3_inverse(st.T_wc).cpu().numpy()
        Xw = st.arena.Xw.cpu().numpy()[lm_idx]
        Xc = Xw @ T_cw[:3, :3].T + T_cw[:3, 3]
        tri = st.arena.triangulated.cpu().numpy()[lm_idx] & valid & (Xc[:, 2] > 0.1)
        uv = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-6) * np.array([self.fx, self.fy]) + np.array(
            [self.cx, self.cy]
        )
        return draw_tracking(img_l, pts, valid, new_mask, uv[tri])


# ----------------------------------------------------------------------
# State exchange with the JAX package (numpy nested tuples)
# ----------------------------------------------------------------------


def state_to_numpy(state: StereoVOState) -> tuple:
    """The state as nested tuples of numpy arrays, in the field order of the
    reference `StereoVOState` (its pytree leaf order), pyramids included."""
    return tree_to_numpy(state)


def state_from_numpy(tree, device="cuda") -> StereoVOState:
    """Build the port's state from the reference `StereoVOState` after
    `jax.device_get` (or any nested tuple with the same field order)."""
    return tree_from_numpy(StereoVOState, tree, torch.device(device))
