"""The JAX package's accuracy harness on the port's frames.

Runs scripts/eval_accuracy.py's `run_stereo` and `run_mono` (the JAX
StereoVO and MonoVO at its configuration, jnp leg, on the CPU) on the
frames the port's accuracy leg renders (`eval_accuracy.load_frames`: the
port's renderer and trajectory, cached under build/accuracy/), and prints
the metrics of an ACCURACY_TORCH.json row. It tells a difference between
the port's rows and ACCURACY.json's JAX rows that the frames make (the two
packages' trajectory generators differ by float32 rounding) from one the
port makes. Run from the repository root (~12 min for 200 frames, the
render included if the frames are not cached):

    JAX_PLATFORMS=cpu python tests/reference_accuracy_jax.py --frames 200
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from scripts import eval_accuracy as JEA  # noqa: E402
from visual_odometry_ros_tpu_torch import eval_accuracy as EA  # noqa: E402
from visual_odometry_ros_tpu_torch.io import ate_rmse, rpe  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=200)
    args = p.parse_args()
    il, ir, poses = EA.load_frames(args.frames)
    dist = float(np.sum(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)))
    traj_s, wall_s, slog = JEA.run_stereo(list(zip(il, ir)), False)
    ate_s = float(ate_rmse(traj_s, poses, align="none"))
    t_rmse, r_rmse = rpe(traj_s, poses)
    traj_m, wall_m, first = JEA.run_mono(list(il), False)
    ate_m = float(ate_rmse(traj_m, poses, align="sim3"))
    print(json.dumps({
        "reference": "scripts/eval_accuracy run_stereo / run_mono on CPU (JAX, jnp leg), the port's frames",
        "frames": args.frames, "distance_m": dist,
        "stereo": {"ate_rmse_m": ate_s, "rpe_trans_m": float(t_rmse), "rpe_rot_deg": float(r_rmse),
                   "n_pose_fail": sum(1 for s in slog if s.get("pose_ok") is False),
                   "pose_fail_frames": [s["frame"] for s in slog if s.get("pose_ok") is False],
                   "n_recoveries": sum(1 for s in slog if s.get("recovered", 0) > 0), "wall_s": wall_s},
        "mono": {"ate_rmse_sim3_m": ate_m, "first_steady": first, "wall_s": wall_m},
    }))


if __name__ == "__main__":
    main()
