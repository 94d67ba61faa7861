"""Typed configuration tree with the defaults of the program's `VOConfig`:
camera intrinsics (+T_lr for stereo) and every algorithm threshold and
capacity. A cell's configuration file overrides it field by field
(`vo_bench.run.vo_config`)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CameraConfig:
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 1241
    height: int = 376

    @property
    def dist(self):
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], np.float32)


@dataclass
class TrackerConfig:
    thres_error: float = 60.0  # feature_tracker.thres_error
    thres_bidirection: float = 0.5  # feature_tracker.thres_bidirection
    thres_sampson: float = 60.0  # feature_tracker.thres_sampson (px^2 gate)
    window_size: int = 21  # feature_tracker.window_size (odd)
    max_level: int = 4  # feature_tracker.max_level (pyramid levels)
    max_iter: int = 20
    eps: float = 0.03
    min_eig: float = 1e-4
    # Convergence-bounded iteration budgets. All tracking
    # passes in the steady step are prior-seeded (pose-projected landmarks,
    # previous disparity, the forward track's own answer), so:
    #   coarse_iter — non-finest pyramid levels, where the seed error is
    #     <= prior_err / 2^lvl px (sub-pixel by level 1-2);
    #   epi_iter    — rectified-stereo 1-D epipolar refinement (scalar
    #     normal equation, converges in ~3-5 steps);
    #   scale_iter  — trackWithScale refinement, seeded at the converged
    #     forward-KLT answer (reference uses 30 from a cold seed,
    #     feature_tracker.cpp:236-504).
    coarse_iter: int = 6
    epi_iter: int = 8
    scale_iter: int = 12


@dataclass
class ExtractorConfig:
    n_features: int = 1024  # static track capacity (feature_extractor.n_features)
    n_bins_u: int = 24
    n_bins_v: int = 12
    thres_fastscore: float = 15.0
    radius: float = 5.0  # kept for parity; bucketing enforces spacing
    score_min: float = 50.0  # Harris response floor for new features
    # Replenishment trigger: detection + disparity-prior +
    # stereo-match + verify + descriptor births cost ~5x the rest of the
    # steady step combined; running them every frame was ~80% of frame time.
    # They now run only when live tracks fall below this fraction of
    # capacity, on keyframe frames, and during bootstrap/recovery.
    replenish_min_ratio: float = 0.75


@dataclass
class MotionEstimatorConfig:
    thres_1p_error: float = 120.0
    use_1point_gate: bool = False  # apply the 1-point circular-arc inlier gate (planar rigs)
    thres_5p_error: float = 1.5  # px, essential inlier gate
    thres_poseba_error: float = 3.0  # px, pose-only BA inlier gate
    pose_ba_iters: int = 50
    huber_delta: float = 0.5
    # Pose acceptance: absolute inlier floor (reference mono_vo.cpp:864-866
    # requires >=10 points) + a low ratio floor; the reference itself fails
    # pose-only BA only on NaN (motion_estimator.cpp:857,1084).
    min_inlier_ratio: float = 0.25
    min_inliers: int = 10
    # Motion-sanity gate vs the constant-velocity prior: reject a solved
    # step beyond max(mult x previous step, absolute floor) in translation
    # or rotation. Protects against wrong-but-self-consistent solves from a
    # poisoned map (r2 death-spiral defect #1).
    sanity_step_mult: float = 4.0
    max_step_abs: float = 3.0  # meters/frame
    max_rot_abs_deg: float = 10.0  # degrees/frame
    # Tracking-loss recovery: after this many consecutive failed poses, try
    # PnP relocalization against surviving landmarks, else re-bootstrap the
    # track/landmark set at the prior-propagated pose.
    recover_after: int = 3
    lba_iters: int = 10  # local BA LM iterations (reference hardcodes 10)
    lba_huber: float = 1.0


@dataclass
class KeyframeConfig:
    thres_overlap_ratio: float = 0.7  # keyframe_update.thres_overlap_ratio / alive_ratio
    thres_translation: float = 4.0  # meters (keyframe_update.thres_trans)
    thres_rotation: float = 10.0  # degrees
    n_max_keyframes_in_window: int = 9
    n_fix: int = 2


@dataclass
class MapConfig:
    thres_parallax: float = 1.0  # degrees (map_update.thres_parallax)
    landmark_capacity: int = 4096
    min_depth: float = 0.5
    max_depth: float = 200.0
    init_depth: float = 10.0  # depth-filter seed prior mean (world units)
    df_converge_ratio: float = 100.0  # seed accepted when std < range/ratio
    df_min_inlier_prob: float = 0.5  # Beta inlier probability floor for promotion


@dataclass
class VOConfig:
    flagDoUndistortion: bool = False
    cam: CameraConfig = field(default_factory=CameraConfig)
    cam_right: CameraConfig = field(default_factory=CameraConfig)
    T_lr: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    motion: MotionEstimatorConfig = field(default_factory=MotionEstimatorConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    map: MapConfig = field(default_factory=MapConfig)
