"""Standalone stereo rectification tool of the port: the counterpart of
scripts/rectify_stereo.py (the `StereoRectifier` node analog, reference
ros1/stereo_rectifier/stereo_rectifier.cpp:3-98). Reads a raw stereo
stream (two directories of images with the same file names), writes the
rectified grayscale images under <out>/left and <out>/right, and prints the
rectified intrinsics and baseline.

  python -m visual_odometry_ros_tpu_torch.rectify_stereo --config cfg.yaml \\
      --left raw/left --right raw/right --out rect/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="reference-format stereo YAML")
    p.add_argument("--left", required=True)
    p.add_argument("--right", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="torch device of the remap (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from . import camera as cam_mod
    from .config import load_yaml
    from .io.datasets import load_gray

    dev = torch.device(args.device)
    cfg = load_yaml(args.config, stereo=True)
    c, cr = cfg.cam, cfg.cam_right
    left = cam_mod.make_camera(c.fx, c.fy, c.cx, c.cy, c.dist, c.width, c.height, dev)
    right = cam_mod.make_camera(cr.fx, cr.fy, cr.cx, cr.cy, cr.dist, cr.width, cr.height, dev)
    stereo = cam_mod.make_stereo_camera(left, right, torch.as_tensor(np.asarray(cfg.T_lr, np.float32), device=dev))

    for side in ("left", "right"):
        os.makedirs(os.path.join(args.out, side), exist_ok=True)
    names = sorted(os.listdir(args.left))
    for n in names:
        il = torch.as_tensor(load_gray(os.path.join(args.left, n)), device=dev)
        ir = torch.as_tensor(load_gray(os.path.join(args.right, n)), device=dev)
        for side, img in zip(("left", "right"), cam_mod.rectify_stereo_images(stereo, il, ir)):
            Image.fromarray(np.clip(img.cpu().numpy(), 0, 255).astype(np.uint8)).save(
                os.path.join(args.out, side, n))
    rect = stereo.rect
    line = (f"rectified {len(names)} pairs; K_rect: fx={float(rect.fx):.2f} cx={float(rect.cx):.2f} "
            f"cy={float(rect.cy):.2f} baseline={float(stereo.baseline):.4f}")
    print(line)
    return line


if __name__ == "__main__":
    main()
