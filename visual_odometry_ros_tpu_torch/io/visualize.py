"""Debug-image rendering + trajectory/map plotting (rviz/imshow analog).

Capability parity with the reference's visual diagnostics:
  - `showTracking`/`showTrackingBA` overlays (mono_vo.cpp:392-475): tracked
    features, newly minted features, reprojected landmarks drawn over the
    current image — here returned as an RGB array (and optionally saved),
    instead of a blocking cv::imshow window.
  - the rviz trajectory + point-cloud views (visualize/ros1/*.rviz) as a
    matplotlib figure (top-down path + 3D landmarks).
"""

from __future__ import annotations

import numpy as np


def _draw_marker(rgb: np.ndarray, u: float, v: float, color, size: int = 2):
    H, W, _ = rgb.shape
    iu, iv = int(round(u)), int(round(v))
    if not (0 <= iu < W and 0 <= iv < H):
        return
    rgb[max(0, iv - size) : min(H, iv + size + 1), iu] = color
    rgb[iv, max(0, iu - size) : min(W, iu + size + 1)] = color


def draw_tracking(img: np.ndarray, pts, valid, new_mask=None, reproj_pts=None) -> np.ndarray:
    """Overlay feature markers on a grayscale image -> RGB uint8.

    Green cross = tracked feature, blue = newly created, red = landmark
    reprojection (matching the reference's color scheme at mono_vo.cpp:392-446).
    """
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    rgb = np.stack([g, g, g], axis=-1)
    pts = np.asarray(pts)
    valid = np.asarray(valid)
    new_mask = np.zeros(len(pts), bool) if new_mask is None else np.asarray(new_mask)
    for i in range(len(pts)):
        if not valid[i]:
            continue
        color = (80, 120, 255) if new_mask[i] else (0, 220, 0)
        _draw_marker(rgb, pts[i, 0], pts[i, 1], color)
    if reproj_pts is not None:
        for p in np.asarray(reproj_pts):
            _draw_marker(rgb, p[0], p[1], (255, 60, 60), size=1)
    return rgb


def save_image(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)


def plot_trajectory(est_poses, gt_poses=None, landmarks=None, out_path=None):
    """Top-down (x-z) trajectory plot, optional GT + map points."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.asarray([T[:3, 3] for T in est_poses])
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(est[:, 0], est[:, 2], "-", lw=1.5, label="estimate")
    if gt_poses is not None:
        gt = np.asarray([T[:3, 3] for T in gt_poses])
        ax.plot(gt[:, 0], gt[:, 2], "--", lw=1.0, label="ground truth")
    if landmarks is not None:
        lm = np.asarray(landmarks)
        ax.scatter(lm[:, 0], lm[:, 2], s=0.5, c="gray", alpha=0.4, label="map")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig
