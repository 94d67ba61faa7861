"""The port's rectification tool (`python -m visual_odometry_ros_tpu_torch.
rectify_stereo`) against the JAX package's scripts/rectify_stereo.py, on
CPU, in-process, on a radtan stereo pair written as PNGs.

Both tools remap in float32 and round to uint8 on the way out, so a pixel
may differ by one grey level where the two float32 remaps straddle a
rounding edge; the printed rectified intrinsics and baseline agree to 1e-3.
The JAX tool imports JAX only inside its main (and runs it on the CPU with
--platform cpu), so this module imports no JAX and tests/test_torch_cuda.py
takes its helpers on a machine without JAX.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts import rectify_stereo as JR  # noqa: E402
from visual_odometry_ros_tpu_torch import rectify_stereo as TR  # noqa: E402
from visual_odometry_ros_tpu_torch.io.synthetic import (  # noqa: E402
    DistortedStereoSequence,
    PlaneSequence,
    forward_trajectory,
)

DIST = (-0.28, 0.07, 1e-4, -1e-4, 0.0)
W, H, F, CX, CY = 160, 120, 125.0, 80.0, 60.0

torch.set_num_threads(2)


def write_stereo_yaml(path, yaw=0.01):
    """A reference-format stereo YAML at 160x120 with radtan lenses on both
    cameras and a right camera turned by `yaw` rad about y, 0.5 m away."""
    cams = []
    for side in ("left", "right"):
        vals = dict(fx=F, fy=F, cx=CX, cy=CY, k1=DIST[0], k2=DIST[1], p1=DIST[2], p2=DIST[3], k3=DIST[4],
                    width=W, height=H)
        cams += [f"Camera.{side}.{k}: {v}" for k, v in vals.items()]
    c, s = np.cos(yaw), np.sin(yaw)
    T = [c, 0, s, 0.5, 0, 1, 0, 0, -s, 0, c, 0, 0, 0, 0, 1]
    text = "\n".join(["%YAML:1.0", "flagDoUndistortion: 1", *cams, "T_lr: !!opencv-matrix", "  rows: 4",
                      "  cols: 4", "  dt: f", f"  data: [{', '.join(repr(float(v)) for v in T)}]", ""])
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def write_raw_pairs(root, n=2):
    """n radtan stereo pairs of the plane world as 8-bit PNGs under
    root/left and root/right; returns (left dir, right dir)."""
    plane = PlaneSequence(width=W, height=H, fx=F, fy=F, cx=CX, cy=CY, z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    world = DistortedStereoSequence(plane, np.asarray(DIST))
    dirs = [os.path.join(root, side) for side in ("left", "right")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for i, T in enumerate(forward_trajectory(n, step=0.3, yaw_rate=0.0015)):
        for d, img in zip(dirs, world.stereo_pair(T.astype(np.float64))):
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(d, f"{i:06d}.png"))
    return dirs


def rectified(out):
    """{side/name: uint8 image} of a tool's output directory."""
    return {f"{side}/{n}": np.asarray(Image.open(os.path.join(out, side, n)), dtype=np.int16)
            for side in ("left", "right") for n in sorted(os.listdir(os.path.join(out, side)))}


def k_rect(line):
    return [float(v) for v in re.findall(r"(?:fx|cx|cy|baseline)=([-\d.]+)", line)]


@pytest.mark.parametrize("yaw", [0.0, 0.01])
def test_port_tool_matches_jax_tool(tmp_path, capsys, yaw):
    cfg = write_stereo_yaml(tmp_path / "stereo.yaml", yaw)
    left, right = write_raw_pairs(str(tmp_path / "raw"))
    common = ["--config", cfg, "--left", left, "--right", right, "--out"]
    JR.main(common + [str(tmp_path / "jax"), "--platform", "cpu"])
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    tline = TR.main(common + [str(tmp_path / "port"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == tline
    j, t = rectified(tmp_path / "jax"), rectified(tmp_path / "port")
    assert list(j) == list(t) and len(t) == 4
    for k in j:
        assert j[k].shape == t[k].shape == (H, W), k
        assert np.abs(j[k] - t[k]).max() <= 1, k
        assert np.abs(j[k] - t[k]).mean() < 0.01, k  # a rounding edge here and there, no offset
    assert tline.split(";")[0] == jline.split(";")[0] == "rectified 2 pairs"
    np.testing.assert_allclose(k_rect(tline), k_rect(jline), atol=1e-3, rtol=0)
    assert len(k_rect(tline)) == 4


def test_port_tool_defaults_to_the_card(tmp_path):
    """Without --device the tool remaps on the card; with no card it raises
    before writing an image."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the tool there")
    cfg = write_stereo_yaml(tmp_path / "stereo.yaml")
    left, right = write_raw_pairs(str(tmp_path / "raw"), n=1)
    with pytest.raises((RuntimeError, AssertionError)):
        TR.main(["--config", cfg, "--left", left, "--right", right, "--out", str(tmp_path / "port")])
    assert not os.path.exists(tmp_path / "port" / "left" / "000000.png")
