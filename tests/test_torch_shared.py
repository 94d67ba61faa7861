"""The port's own configuration, renderers and trajectory metrics against the
JAX package's, and a check that the port loads nothing of the JAX package.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from visual_odometry_ros_tpu import config as JC  # noqa: E402
from visual_odometry_ros_tpu.io import synthetic as JS  # noqa: E402
from visual_odometry_ros_tpu.io import trajectory as JT  # noqa: E402
from visual_odometry_ros_tpu_torch import config as TC  # noqa: E402
from visual_odometry_ros_tpu_torch import io as tio  # noqa: E402
from visual_odometry_ros_tpu_torch.io import synthetic as TS  # noqa: E402
from visual_odometry_ros_tpu_torch.io import trajectory as TT  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "visual_odometry_ros_tpu_torch"


def test_voconfig_equals_jax_field_by_field():
    a, b = dataclasses.asdict(TC.VOConfig()), dataclasses.asdict(JC.VOConfig())
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
    assert tio.VOConfig is TC.VOConfig


def _worlds(S):
    plane = S.PlaneSequence(width=160, height=120, fx=125.0, fy=125.0, cx=80.0, cy=60.0, z0=14.0,
                            sx=0.3, sy=0.15, baseline=0.5)
    return {
        "corridor": S.CorridorSequence(width=160, height=120, fx=125.0, fy=125.0, cx=80.0, cy=60.0,
                                       tex_size=128, length=30.0),
        "plane": plane,
        "distorted": S.DistortedStereoSequence(plane, np.asarray([-0.28, 0.07, 1e-4, -1e-4, 0.0])),
    }


@pytest.mark.parametrize("kind", ["corridor", "plane", "distorted"])
def test_rendered_frames_equal_jax(kind):
    """The same world, seed and poses render to the same pixels."""
    poses = JS.forward_trajectory(3, step=0.3, yaw_rate=0.0015)
    tw, jw = _worlds(TS)[kind], _worlds(JS)[kind]
    for T in poses:
        for a, b in zip(tw.stereo_pair(T.astype(np.float64)), jw.stereo_pair(T.astype(np.float64))):
            np.testing.assert_array_equal(a, b)


def test_trajectories_and_metrics_equal_jax():
    # The same float32 se3_exp in another op order: a few ulps per step,
    # carried through 20 chained float32 products over ~5 m of travel.
    np.testing.assert_allclose(TS.varied_trajectory(20), JS.varied_trajectory(20), atol=1e-4)
    gt = JS.varied_trajectory(30)
    rng = np.random.default_rng(2)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0.0, 0.05, (30, 3)).astype(np.float32)
    for align in ("sim3", "se3", "none"):
        assert TT.ate_rmse(est, gt, align=align) == JT.ate_rmse(est, gt, align=align)
    for delta in (1, 3):
        assert TT.rpe(est, gt, delta) == JT.rpe(est, gt, delta)


_PROBE = r"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "jaxlib" or name.startswith("jaxlib."):
            raise ImportError("the port imported " + name)
        return None
sys.meta_path.insert(0, Refuse())
sys.path = [p for p in sys.path if p not in ("", REPO)]
sys.path.insert(0, COPY)
import visual_odometry_ros_tpu_torch.io
import visual_odometry_ros_tpu_torch.models.stereo_vo
import visual_odometry_ros_tpu_torch.models.mono_vo
import visual_odometry_ros_tpu_torch.ops.epipolar
import visual_odometry_ros_tpu_torch.io.checkpoint
import visual_odometry_ros_tpu_torch.io.datasets
import visual_odometry_ros_tpu_torch.io.statistics
import visual_odometry_ros_tpu_torch.utils.pose3d
import visual_odometry_ros_tpu_torch.runtime.ingest
import visual_odometry_ros_tpu_torch.parallel.mesh
import visual_odometry_ros_tpu_torch.parallel.dist_ba
import visual_odometry_ros_tpu_torch.parallel.multihost
import visual_odometry_ros_tpu_torch.run_vo
import visual_odometry_ros_tpu_torch.eval_accuracy
import visual_odometry_ros_tpu_torch.rectify_stereo
import visual_odometry_ros_tpu_torch.profile_stages
import visual_odometry_ros_tpu_torch.ab_frames
import visual_odometry_ros_tpu_torch.bench_scaling
import visual_odometry_ros_tpu_torch.h2d_overlap_probe
from visual_odometry_ros_tpu_torch.io import VOConfig, forward_trajectory, PlaneSequence
assert VOConfig().tracker.max_iter > 0 and forward_trajectory(3).shape == (3, 4, 4)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "visual_odometry_ros_tpu"))
files = sorted(getattr(m, "__file__", None) or "" for m in list(sys.modules.values()))
bad += [f for f in files if f.startswith(REPO)]
assert not bad, bad
print("ok")
"""


def test_port_loads_nothing_of_the_jax_package(tmp_path):
    """A copy of the port alone, with the repository off the path: its
    modules import, and no module of the JAX package (or jax) is loaded."""
    shutil.copytree(PORT, tmp_path / PORT.name, ignore=shutil.ignore_patterns("__pycache__"))
    code = _PROBE.replace("REPO", repr(str(REPO))).replace("COPY", repr(str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
