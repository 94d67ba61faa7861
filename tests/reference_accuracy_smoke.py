"""The JAX package's CPU reference for chip_smoke.py's accuracy-leg phase.

Runs scripts/eval_accuracy.py's `run_stereo` (the JAX StereoVO at its
build_stereo configuration, jnp leg, track_stereo_batch in chunks of 25) on
chip_smoke's N_MONO float32 stereo pairs of the accuracy sequence (the
port's renderer, the same pixels) and prints the constants phase 12 is held
to: ACC_REF_ATE_M (ATE, no alignment), ACC_REF_POSE_FAILS and
ACC_REF_RECOVERIES (counted from stats_log, as the reference harness
counts them). Run from the repository root (~3 min):

    JAX_PLATFORMS=cpu python tests/reference_accuracy_smoke.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke as CS  # noqa: E402
from scripts import eval_accuracy as JEA  # noqa: E402
from visual_odometry_ros_tpu_torch.io import ate_rmse, rpe  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    il, ir, poses = CS.make_frames({"mono": CS.N_MONO})["mono"]
    print(f"rendered {len(il)} stereo pairs in {time.perf_counter() - t0:.1f} s", flush=True)
    traj, wall, slog = JEA.run_stereo(list(zip(il, ir)), False)
    print(json.dumps({
        "reference": "scripts/eval_accuracy.run_stereo on CPU (JAX, jnp leg)", "frames": len(traj),
        "ACC_REF_ATE_M": float(ate_rmse(traj, poses, align="none")),
        "ACC_REF_POSE_FAILS": sum(1 for s in slog if s.get("pose_ok") is False),
        "ACC_REF_RECOVERIES": sum(1 for s in slog if s.get("recovered", 0) > 0),
        "rpe_m_deg": [float(v) for v in rpe(traj, poses)],
        "pose_fail_frames": [s["frame"] for s in slog if s.get("pose_ok") is False],
        "wall_s": wall,
    }))


if __name__ == "__main__":
    main()
