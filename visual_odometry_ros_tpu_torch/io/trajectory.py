"""Trajectory export + evaluation (ATE/RPE with Umeyama alignment).

Parity targets:
  - the reference's KITTI-format dumps: 13 columns = frame id + row-major 3x4
    Twc (mono_vo.cpp:64-127, stereo_vo.cpp:55-120) — but first-class instead
    of hardcoded /home/kch destructor paths.
  - its online GT scale comparison (mono_vo_ros1.cpp:260-274) generalized to
    standard ATE RMSE / RPE metrics used by the BASELINE.md targets.
"""

from __future__ import annotations

import numpy as np


def save_kitti_trajectory(path: str, poses, frame_ids=None) -> None:
    """Write 13-column lines: id + 12 row-major entries of the 3x4 T_wc."""
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            fid = i if frame_ids is None else frame_ids[i]
            row = np.asarray(T, dtype=np.float64)[:3, :4].reshape(-1)
            f.write(str(fid) + " " + " ".join(f"{v:.9f}" for v in row) + "\n")


def load_kitti_trajectory(path: str):
    ids, poses = [], []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) == 13:
                ids.append(int(float(vals[0])))
                vals = vals[1:]
            else:
                ids.append(len(ids))
            T = np.eye(4)
            T[:3, :4] = np.asarray([float(v) for v in vals], np.float64).reshape(3, 4)
            poses.append(T)
    return np.asarray(ids), np.stack(poses)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing ||dst - (s R src + t)||."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: str = "sim3") -> float:
    """Absolute trajectory error RMSE over positions.

    align: 'sim3' (mono, scale ambiguous), 'se3' (stereo/metric), 'none'.
    """
    p_est = np.asarray([T[:3, 3] for T in est_poses])
    p_gt = np.asarray([T[:3, 3] for T in gt_poses])
    if not np.isfinite(p_est).all():
        # A diverged run must report NaN (consumers render it as null/n-a),
        # not crash the harness inside the alignment SVD.
        return float("nan")
    if align == "sim3":
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale=True)
        p_al = (s * (R @ p_est.T)).T + t
    elif align == "se3":
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale=False)
        p_al = (R @ p_est.T).T + t
    else:
        p_al = p_est
    err = np.linalg.norm(p_al - p_gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over `delta`-frame steps.

    Returns (trans_rmse, rot_rmse_deg).
    """
    et, er = [], []
    n = len(est_poses)
    for i in range(n - delta):
        dE = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dG = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        dd = np.linalg.inv(dG) @ dE
        et.append(np.linalg.norm(dd[:3, 3]))
        ang = np.degrees(np.arccos(np.clip((np.trace(dd[:3, :3]) - 1) / 2, -1, 1)))
        er.append(ang)
    return float(np.sqrt(np.mean(np.square(et)))), float(np.sqrt(np.mean(np.square(er))))
