"""Shared numpy-only modules of the JAX package, reached without importing jax.

`visual_odometry_ros_tpu/config.py`, `io/synthetic.py`, `io/trajectory.py` and
`io/visualize.py` import only numpy at module level, but importing them the normal way runs
`visual_odometry_ros_tpu/__init__.py`, which imports jax — and a machine
running this port has no jax. So each file is loaded by path under a private
module name; the JAX package's `__init__` never runs.

`forward_trajectory` in `synthetic.py` calls the JAX geometry module when it
is called, so the port provides its own, built on the port's `se3_exp`.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

_JAX_PKG = Path(__file__).resolve().parents[2] / "visual_odometry_ros_tpu"


def _load(name: str, rel: str):
    mod_name = f"{__name__}._shared_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, _JAX_PKG / rel)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {_JAX_PKG / rel}")
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolve their module through sys.modules while the class
    # body executes, so register before running it.
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


config = _load("config", "config.py")
synthetic = _load("synthetic", "io/synthetic.py")
trajectory = _load("trajectory", "io/trajectory.py")
visualize = _load("visualize", "io/visualize.py")

VOConfig = config.VOConfig
CorridorSequence = synthetic.CorridorSequence
PlaneSequence = synthetic.PlaneSequence
ate_rmse = trajectory.ate_rmse
rpe = trajectory.rpe
DistortedStereoSequence = synthetic.DistortedStereoSequence
draw_tracking = visualize.draw_tracking


def forward_trajectory(n_frames: int, step=0.25, yaw_rate=0.002, lateral=0.0) -> np.ndarray:
    """[n, 4, 4] T_wc poses: forward (+z) motion with gentle yaw — the
    counterpart of `io/synthetic.py:forward_trajectory`, computed in float32
    with the port's `se3_exp`."""
    from ..utils.geometry import se3_exp

    # Products in float64, then one rounding to float32 — as the reference
    # builds each xi from Python floats.
    i = np.arange(n_frames, dtype=np.float64)
    xi = np.zeros((n_frames, 6), np.float64)
    xi[:, 0] = lateral * i
    xi[:, 2] = step * i
    xi[:, 4] = yaw_rate * i
    return se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy()


__all__ = [
    "VOConfig",
    "CorridorSequence",
    "PlaneSequence",
    "DistortedStereoSequence",
    "draw_tracking",
    "ate_rmse",
    "rpe",
    "forward_trajectory",
]
