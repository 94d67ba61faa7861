"""The port's kernel-leg A/B (`visual_odometry_ros_tpu_torch.ab_frames`)
against scripts/ab_frames.py, on CPU, at a small size.

Both harnesses run over the first 6 frames of the HardSequence at 160x120
(the port's renderer, intrinsics scaled from the 640x480 camera), built the
way tests/test_torch_eval_accuracy.py builds them: the reference's
configuration at that size (`eval_accuracy._config`) in each package. The
JAX script's own main runs, with its world swapped for the port's frames
and poses and its Pallas leg in interpret mode (as
tests/test_klt_pallas_fp.py runs it).

- The port's `plain` rows (the jnp leg's port) against the JAX `jnp` rows:
  tracks and inliers within 2, rotation error within 1e-3 deg.
- The port's `kernel` rows (on the CPU, the KLT kernels' plain versions)
  against the JAX `pallas` rows: tracks and inliers within KERNEL_COUNT_TOL,
  rotation error within KERNEL_ROT_TOL_DEG. Looser, because the two kernel
  legs decide differently at the image border by design: the port's kernel
  processes a feature when p0 and its seed lie within the image grown by
  the window's half-extent, where the Pallas rule follows its slab padding
  (ROADMAP C, "Choices checked in PR 1"), so a border feature can live in one
  leg and not the other. The pose then moves by a hair, but the rotation
  error of a near-identity float32 rotation, arccos((trace - 1) / 2), comes
  in steps of about 0.03-0.04 deg at these angles (float32 spacing near
  trace = 3), so a hair can read as one step: the bound is one step and a
  margin, 0.05 deg.

The JAX script's Pallas leg compiles its steady step with the kernels in
interpret mode, which takes most of this file's ~2.5 minutes.
"""

import json
import os
import sys
from functools import partial

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from reference_mono_smoke import jax_config  # noqa: E402
from scripts import ab_frames as JAB  # noqa: E402
from scripts import eval_accuracy as JEA  # noqa: E402
from visual_odometry_ros_tpu.io import synthetic as JS  # noqa: E402
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JStereo  # noqa: E402
from visual_odometry_ros_tpu.ops import klt_pallas_fp  # noqa: E402
from visual_odometry_ros_tpu_torch import ab_frames as AB  # noqa: E402
from visual_odometry_ros_tpu_torch import eval_accuracy as EA  # noqa: E402

SIZE = (160, 120)
N = 6
KERNEL_COUNT_TOL = 4
KERNEL_ROT_TOL_DEG = 0.05

torch.set_num_threads(2)


class _PortWorld:
    """The JAX script's HardSequence, rendering the port's frames."""

    frames = None

    def __init__(self, poses_T_wc, baseline):
        pass

    def stereo_pair(self, T, frame):
        return self.frames[0][frame], self.frames[1][frame]


@pytest.fixture(scope="module")
def frames():
    il, ir, poses = EA.load_frames(N, SIZE, cache=False, workers=2)
    return il, ir, poses


@pytest.fixture(scope="module")
def port_run(frames):
    return AB.run_ab(*frames, device="cpu", size=SIZE)


def test_both_harnesses_agree(monkeypatch, tmp_path, frames, port_run):
    il, ir, poses = frames
    _PortWorld.frames = (il, ir)
    monkeypatch.setattr(JS, "varied_trajectory", lambda n, step=0.3: poses[:n])
    monkeypatch.setattr(JS, "HardSequence", _PortWorld)
    monkeypatch.setattr(JEA, "build_stereo", lambda use_pallas: JStereo(
        jax_config(EA._config("on" if use_pallas else "off", SIZE))))
    monkeypatch.setattr(klt_pallas_fp, "track_level_fp", partial(klt_pallas_fp.track_level_fp, interpret=True))
    monkeypatch.setattr(klt_pallas_fp, "track_scale_fp", partial(klt_pallas_fp.track_scale_fp, interpret=True))
    out = tmp_path / "AB_FRAMES.json"
    JAB.main(["--frames", str(N), "--out", str(out)])
    ref = json.loads(out.read_text())
    rows, summary = port_run
    assert len(rows) == len(ref["rows"]) == N
    for mine, theirs in zip(rows, ref["rows"]):
        for leg, jleg, cnt, rot in (("plain", "jnp", 2, 1e-3), ("kernel", "pallas", KERNEL_COUNT_TOL,
                                                                KERNEL_ROT_TOL_DEG)):
            a, b = mine[leg], theirs[jleg]
            for k in ("n_tracked", "n_inliers"):
                assert abs(a[k] - b[k]) <= cnt, (mine["frame"], leg, k, a, b)
            assert a["pose_ok"] == b["pose_ok"] and a["rec"] == b["rec"], (mine["frame"], leg, a, b)
            if mine["frame"] >= 1:
                assert abs(a["rot_err_deg"] - b["rot_err_deg"]) <= rot, (mine["frame"], leg, a, b)
    s = ref["summary"]
    assert summary["frames"] == s["frames"] == N
    assert summary["first_divergent_frame"] == s["first_divergent_frame"]
    np.testing.assert_allclose(summary["rot_err_deg_plain_q50_q90_max"], s["rot_err_deg_jnp_q50_q90_max"], atol=1e-3)


def test_summary_and_artifact(monkeypatch, tmp_path, frames, port_run):
    rows, summary = port_run
    assert summary == AB.summarize(rows)
    assert set(summary) == {"frames", "rot_err_deg_plain_q50_q90_max", "rot_err_deg_kernel_q50_q90_max",
                            "n_pose_fail_plain", "n_pose_fail_kernel", "first_divergent_frame"}
    # A frame whose legs part by more than 0.2 deg is the first divergent one.
    moved = [dict(r, kernel=dict(r["kernel"])) for r in rows]
    moved[3]["kernel"]["rot_err_deg"] = moved[3]["plain"]["rot_err_deg"] + 0.25
    assert AB.summarize(moved)["first_divergent_frame"] == 3
    monkeypatch.setattr(EA, "load_frames", lambda n: tuple(x[:n] for x in frames))
    monkeypatch.setattr(AB, "run_ab", lambda il, ir, poses, device: port_run)
    rec = AB.main(["--device", "cpu", "--frames", str(N), "--out", str(tmp_path)])
    saved = json.loads((tmp_path / AB.OUT_NAME).read_text())
    assert saved["platform"] == "cpu" and saved["card"] is None
    assert "plain PyTorch versions" in saved["legs"]["kernel"]
    assert saved["summary"] == rec["summary"] == summary and len(saved["rows"]) == N
