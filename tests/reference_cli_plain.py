"""The port's plain-version reference for the full-width run of
chip_smoke.py's CLI phase.

Runs the port's CLI with --device cpu (the KLT kernels' plain versions) on
chip_smoke's full-width KITTI layout of the corridor frames, with
config/stereo/kitti_00_stereo.yaml (1241x376, N = 1024), and prints the
constants chip_smoke's full-width bounds are built on: CLI_PLAIN_ATE_M (se3
ATE) and CLI_PLAIN_KEYFRAMES. It imports no JAX, so it runs on the machine
that holds the card. This is a full-size configuration on the CPU (a minute
or two with 8 cores); run it from the repository root:

    python3 tests/reference_cli_plain.py
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from visual_odometry_ros_tpu_torch import run_vo  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    frames = CS.make_frames({"main": CS.N_MAIN})
    with tempfile.TemporaryDirectory() as tmp:
        root, cfg = CS.kitti_layouts(tmp, frames)["full"]
        t1 = time.perf_counter()
        s = run_vo.main(["--dataset", "kitti", "--root", root, "--config", cfg, "--mode", "stereo",
                         "--out", os.path.join(tmp, "full"), "--device", "cpu", "--quiet"])
    print(json.dumps({
        "reference": "the port's run_vo, --device cpu (plain kernel versions)",
        "CLI_PLAIN_ATE_M": s["ate_rmse"], "CLI_PLAIN_KEYFRAMES": s["keyframes"], "frames": s["frames"],
        "run_s": time.perf_counter() - t1, "wall_s": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
