"""The rectified radtan corridor on the CPU, through the JAX package and
through the port.

The world: chip_smoke.py's bench corridor (KITTI geometry, 1241x376, fit
around the 0.25 m/frame trajectory) seen through radtan lenses on both
cameras (chip_smoke.DIST, `DistortedStereoSequence`), 1 + 8 frames as uint8.
The pipeline: chip_smoke.bench_config() (N = 1024, M = 4096, K = 10, 3
levels, 15 iterations) with those lenses and `flagDoUndistortion=True`, all
9 frames in one `track_stereo_batch` call. The JAX StereoVO runs its jnp
leg (its CPU default); the port runs with device="cpu" twice: its kernel
leg (the KLT kernels' plain versions, the leg the card runs) and the port
of the jnp leg (use_pallas "off", the leg that mirrors the JAX run). Prints
each run's ATE (no alignment) and the frames whose pose failed or that
recovered. Run from the repository root (~10 minutes; a full-size
configuration, so run it alone):

    JAX_PLATFORMS=cpu python tests/reference_rectified_corridor.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke as CS  # noqa: E402
from reference_mono_smoke import jax_config  # noqa: E402
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JVO  # noqa: E402
from visual_odometry_ros_tpu_torch.io import ate_rmse  # noqa: E402
from visual_odometry_ros_tpu_torch.io.synthetic import DistortedStereoSequence  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO as TVO  # noqa: E402

N_FRAMES = 9


def render(i):
    world, poses = CS._world("main")
    l, r = DistortedStereoSequence(world, np.asarray(CS.DIST)).stereo_pair(poses[i].astype(np.float64))
    return np.clip(l, 0, 255).astype(np.uint8), np.clip(r, 0, 255).astype(np.uint8)


def config(use_pallas="auto"):
    cfg = CS.bench_config()
    cfg.tracker.use_pallas = use_pallas
    cfg.cam.k1, cfg.cam.k2, cfg.cam.p1, cfg.cam.p2, cfg.cam.k3 = CS.DIST
    cfg.cam_right = cfg.cam
    cfg.flagDoUndistortion = True
    return cfg


def run(vo, il, ir, poses) -> dict:
    t = time.perf_counter()
    vo.track_stereo_batch(il, ir)
    log = vo.stats_log
    return {
        "ate_m": float(ate_rmse(np.stack(vo.trajectory), poses, align="none")),
        "pose_fail_frames": [s["frame"] for s in log if s.get("pose_ok") is False],
        "recovered": [[s["frame"], int(s["recovered"])] for s in log if s.get("recovered", 0)],
        "wall_s": time.perf_counter() - t,
    }


def main() -> None:
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1), mp_context=mp.get_context("spawn")) as ex:
        pairs = list(ex.map(render, range(N_FRAMES)))
    il, ir = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    poses = CS._world("main")[1][:N_FRAMES]
    print(f"rendered {N_FRAMES} distorted pairs in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"jax_cpu": run(JVO(jax_config(config())), il, ir, poses)}
    print(json.dumps(out), flush=True)
    out["port_cpu_kernel_leg"] = run(TVO(config("on"), device="cpu"), il, ir, poses)
    print(json.dumps(out), flush=True)
    out["port_cpu_jnp_leg"] = run(TVO(config("off"), device="cpu"), il, ir, poses)
    print(json.dumps({"reference": "rectified radtan corridor, 1 + 8 frames at 0.25 m/frame, N = 1024",
                      "distance_m": float(np.sum(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1))),
                      **out}))


if __name__ == "__main__":
    main()
