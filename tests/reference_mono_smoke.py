"""The JAX package's CPU reference for chip_smoke.py's mono path.

Runs the JAX MonoVO (its jnp leg, the CPU default) on chip_smoke's mono
frames (the port's renderer, the same pixels) with chip_smoke's mono
configuration and schedule, and prints the numbers chip_smoke's mono bounds
are built on: MONO_REF_BOOT, MONO_REF_ATE_M, and for the same frames with
chip_smoke's blackout stretch (`blackout_frames`) MONO_BLACKOUT_REF_RECOVERIES
and MONO_BLACKOUT_REF_POST_ATE_M. Run from the repository root (~3 min):

    JAX_PLATFORMS=cpu python tests/reference_mono_smoke.py
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke as CS  # noqa: E402
from visual_odometry_ros_tpu.config import VOConfig  # noqa: E402
from visual_odometry_ros_tpu.models.mono_vo import MonoVO  # noqa: E402
from visual_odometry_ros_tpu_torch.io import ate_rmse  # noqa: E402


def jax_config(src=None) -> VOConfig:
    """A port VOConfig (by default chip_smoke.mono_config()), field by field,
    in the JAX package's VOConfig."""
    src, cfg = src or CS.mono_config(), VOConfig()
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                setattr(getattr(cfg, f.name), g.name, getattr(v, g.name))
        else:
            setattr(cfg, f.name, v)
    return cfg


def run(imgs) -> MonoVO:
    """The JAX MonoVO over imgs in chip_smoke's mono schedule."""
    vo = MonoVO(jax_config())
    i = 0
    while vo.phase != 2:
        vo.track_image(imgs[i])
        i += 1
    for _ in range(CS.N_MONO_TIMED):
        vo.track_image(imgs[i], timed=True)
        i += 1
    for a, b in CS.mono_chunks(i):
        vo.track_batch(imgs[a:b])
    return vo


def main() -> None:
    t0 = time.perf_counter()
    imgs, _, poses = CS.make_frames({"mono": CS.N_MONO})["mono"]
    print(f"rendered {len(imgs)} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    vo = run(imgs)
    log = vo.stats_log
    phases = [s["phase"] for s in log]
    kfs = [s for s in log if s["phase"] == "steady" and s["keyframe"]]
    print(json.dumps({
        "reference": "JAX MonoVO on CPU, jnp leg", "frames": len(vo.trajectory),
        "boot_frame": phases.index("bootstrapped"),
        "ate_sim3_m": float(ate_rmse(np.stack(vo.trajectory), poses, align="sim3")),
        "keyframe_steps": len(kfs),
        "ba_accepted": sum(1 for s in kfs if s["ba_err"] is not None and not s["ba_rejected"]),
        "used_fallback": sum(1 for s in log if s.get("used_fallback")),
        "recovered": sum(1 for s in log if s.get("recovered", 0)),
        "chunks": CS.mono_chunks(phases.index("bootstrapped") + 1 + CS.N_MONO_TIMED),
        "wall_s": time.perf_counter() - t0,
    }), flush=True)
    t0 = time.perf_counter()
    vo = run(CS.blackout_frames(imgs))
    got = CS.recovery_summary(vo.stats_log, np.stack(vo.trajectory), poses)
    print(json.dumps({
        "reference": "JAX MonoVO on CPU, jnp leg, blackout", "blackout": list(CS.BLACKOUT),
        "boot_frame": [s["phase"] for s in vo.stats_log].index("bootstrapped"),
        "MONO_BLACKOUT_REF_RECOVERIES": got["recoveries"],
        "MONO_BLACKOUT_REF_POST_ATE_M": got["post_recovery_ate_sim3_m"],
        "fallback_frames": got["fallback_frames"], "wall_s": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
