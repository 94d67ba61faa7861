"""The port's stage profile (`visual_odometry_ros_tpu_torch.profile_stages`)
against bench.py and scripts/profile_stages.py, on CPU.

bench.py's configuration and world are copied into the port: the
configuration field by field, three frames within one grey level. A
`--device cpu` run on a narrow crop of the corridor (256x192, cx and cy
shifted, N = 256, batch 2) returns every stage key of the reference's
artifact with host times and its device fields null. The replenishment
cascade's sub-stages on the profile's evolved state (the plain KLT leg)
equal the JAX package's functions on the same inputs: the port's tracks,
detections, disparity priors and matches, carried over as numpy (the
state through `state_to_numpy`), and each package's own pyramids of the
same frame. Bounds: tests/test_torch_ops.py's (detections as sets,
descriptors exact, ZNCC verdicts equal) and tests/test_torch_stereo_vo.py's
for KLT positions (1e-3 px).
"""

import dataclasses
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from reference_mono_smoke import jax_config  # noqa: E402
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JVO  # noqa: E402
from visual_odometry_ros_tpu.ops import features as JF  # noqa: E402
from visual_odometry_ros_tpu.ops import stereo_disparity as JSD  # noqa: E402
from visual_odometry_ros_tpu_torch import profile_stages as PS  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import state_to_numpy  # noqa: E402

torch.set_num_threads(2)
CROP = dict(width=256, height=192, features=256)
CPU_RUN = ["--device", "cpu", "--crop", "256", "192", "--features", "256", "--batch", "2", "--reps", "1",
           "--trials", "1"]


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_bench_config_equals_bench_py_field_by_field():
    a, b = _asdict(PS.build_vo("cpu").cfg), _asdict(bench.build_vo().cfg)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
    assert PS.BATCH == bench.BATCH


def test_frames_equal_bench_py():
    il, ir = PS.make_frames(3)
    jl, jr = bench.make_frames(3)
    assert il.dtype == jl.dtype == np.uint8 and il.shape == jl.shape == (3, 376, 1241)
    for a, b in ((il, jl), (ir, jr)):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_cpu_run_has_every_stage_key_and_no_device_number(tmp_path):
    rec = PS.main(CPU_RUN + ["--out", str(tmp_path)])
    assert set(rec["stages"]) == set(rec["stages_ms"]) == set(PS.STAGE_KEYS)
    assert rec["platform"] == "cpu" and rec["card"] is None and rec["step"] == PS.STEP
    for k, st in rec["stages"].items():
        assert st["device_ms"] is None and st["busy_ms"] is None, k
        assert 0 < st["host_ms"]["min"] <= st["host_ms"]["median"] <= st["host_ms"]["max"], k
        assert rec["stages_ms"][k] == st["host_ms"]["min"]
    assert rec["stages"]["steady_step_full"]["recovered"] in (0, 1, 2, 3)
    assert rec["device"] is None and rec["host_syncs"] is None and rec["mono"] is None
    f = rec["flops"]
    assert f["per_frame"] == f["scan_batch"] / 2 >= 0 and f["steady_step"] >= 0
    assert f["achieved_flops_per_s"] is None and f["mfu_f32"] is None and f["peak_f32_flops_per_s"] == 67e12
    saved = json.loads((tmp_path / PS.OUT_NAME).read_text())
    assert list(saved) == ["cpu_step0.8"] and saved["cpu_step0.8"]["stages_ms"] == rec["stages_ms"]


@pytest.fixture(scope="module")
def evolved():
    """The profile's evolved state on the crop (plain KLT leg) and the next frame."""
    cfg = PS.bench_config(**CROP)
    cfg.tracker.use_pallas = "off"
    from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO

    vo = StereoVO(cfg, device="cpu")
    il, ir = PS.make_frames(4, CROP["width"], CROP["height"], step=0.25, workers=2)
    vo.track_stereo_batch(il[:3], ir[:3])
    im_l, im_r = (torch.as_tensor(x, dtype=torch.float32) for x in (il[3], ir[3]))
    return vo, vo.state, im_l, im_r


def test_replenish_substages_equal_jax(evolved):
    vo, state, im_l, im_r = evolved
    calls = PS.stage_calls(vo, state, im_l, im_r)
    jvo = JVO(jax_config(vo.cfg))
    jl, jr = jvo._build_pyr(jnp.asarray(im_l.numpy())), jvo._build_pyr(jnp.asarray(im_r.numpy()))
    tracks = state_to_numpy(state)[2]  # StereoVOState.tracks, as the JAX state holds it
    N = lambda t: t.numpy()  # noqa: E731

    pts, ok = (N(x) for x in calls["rep_detect"]())
    ex = vo.cfg.extractor
    pj, vj = JF.detect_features(jl[0][0], jnp.asarray(tracks[0]), jnp.asarray(tracks[2]), gh=ex.n_bins_v,
                                gw=ex.n_bins_u, n_max=vo.N // 2, fast_thresh=ex.thres_fastscore,
                                score_min=ex.score_min)
    assert ok.sum() == np.asarray(vj).sum() > 20
    assert set(map(tuple, pts[ok].tolist())) == set(map(tuple, np.asarray(pj)[np.asarray(vj)].tolist()))

    disp_prior, prior_ok, amb = (N(x) for x in calls["rep_coarse_disp"]())
    dj, pokj, ambj = (np.asarray(x) for x in jvo._coarse_disparity_prior(jl, jr, jnp.asarray(pts)))
    np.testing.assert_array_equal(prior_ok, pokj)
    np.testing.assert_array_equal(amb, ambj)
    np.testing.assert_allclose(disp_prior, dj, atol=1e-3)

    pts_r, ok_r, disp = (N(x) for x in calls["rep_stereo_match"]())
    prj, okj, _ = (np.asarray(x) for x in jvo._stereo_match(jl, jr, jnp.asarray(pts), jnp.asarray(ok),
                                                              disp_prior=jnp.asarray(disp_prior)))
    np.testing.assert_array_equal(ok_r, okj)
    assert ok_r.sum() > 10
    np.testing.assert_allclose(pts_r[ok_r], prj[ok_r], atol=1e-3)

    ok_v, score = (N(x) for x in calls["rep_zncc_verify"]())
    ovj, svj = JSD.verify_disparity_zncc(jl[0][0], jr[0][0], jnp.asarray(pts), jnp.asarray(disp),
                                         jnp.asarray(ok & ok_r))
    np.testing.assert_array_equal(ok_v, np.asarray(ovj))
    np.testing.assert_allclose(score, np.asarray(svj), atol=1e-4)

    desc, dvalid = (N(x) for x in calls["rep_descriptors"]())
    dsj, dvj = JF.orb_descriptors(jl[0][0], jnp.asarray(pts))
    np.testing.assert_array_equal(dvalid, np.asarray(dvj))
    np.testing.assert_array_equal(desc.astype(np.uint32)[dvalid], np.asarray(dsj)[dvalid])
