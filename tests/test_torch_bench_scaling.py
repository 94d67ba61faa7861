"""The port's BA scaling sweep (`visual_odometry_ros_tpu_torch.bench_scaling`)
against scripts/bench_scaling.py, on CPU.

The efficiency line equals the reference's formula (scripts/bench_scaling.py:
289-327, copied here as it stands) in both modes and for both kinds of
ideal. A gloo sweep of worlds 1 and 2 (weak scaling, 256 landmarks per rank,
K = 9, 10 iterations; each rank a `parallel/multihost` process) appends its
records to the JSON file; the bytes `ops/ba.COLLECTIVES` counted per solve
equal iters * 4 (36 K^2 + 6 K + 1) plus the starting and final error sums
(2 + 3 float32 values); each world's mean error matches the single-device
`ba_solve_impl` on the same problem to tests/test_torch_dist_ba.py's 1e-3 px.
"""

import json

import numpy as np
import pytest
import torch

from visual_odometry_ros_tpu_torch import bench_scaling as BS
from visual_odometry_ros_tpu_torch.ops import ba as BA
from visual_odometry_ros_tpu_torch.parallel import multihost as MH

torch.set_num_threads(2)
K, ITERS, M_PER_RANK = 9, 10, 256


def jax_efficiency(results, strong, host_limited):
    """scripts/bench_scaling.py:289-327 as it stands (with `args.strong` a
    parameter)."""
    base = results[0]
    last = results[-1]
    dev_ratio = last["devices"] / base["devices"]
    raw_ratio = last["value"] / base["value"]
    if strong:
        eff = raw_ratio if host_limited else raw_ratio / dev_ratio
    else:
        eff = raw_ratio * (dev_ratio if host_limited else 1.0)
    return {
        "metric": "scaling_efficiency",
        "mode": "strong" if strong else "weak",
        "host_limited_ideal": host_limited,
        "devices": last["devices"],
        "value": round(min(eff, 1.0), 3),
        "raw_iters_ratio": round(raw_ratio, 3),
        "unit": "fraction",
    }


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("host_limited", [False, True])
def test_efficiency_equals_the_reference_formula(strong, host_limited):
    for base, last in (({"devices": 1, "value": 100.0}, {"devices": 4, "value": 80.0}),
                       ({"devices": 1, "value": 100.0}, {"devices": 2, "value": 190.0}),
                       ({"devices": 2, "value": 50.0}, {"devices": 8, "value": 12.5})):
        got = BS.scaling_efficiency(base, last, strong, host_limited)
        assert got == jax_efficiency([base, {}, last], strong, host_limited)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    path = tmp_path_factory.mktemp("scaling") / "SCALING_TORCH.json"
    path.write_text(json.dumps([{"metric": "earlier"}]))
    out = BS.main(["--device", "cpu", "--worlds", "1", "2", "--lm-per-rank", str(M_PER_RANK), "--window", str(K),
                   "--iters", str(ITERS), "--reps", "2", "--timeout", "240", "--json-out", str(path)])
    return out, json.loads(path.read_text())


def test_gloo_sweep_appends_its_records(sweep):
    out, saved = sweep
    assert saved[0] == {"metric": "earlier"} and saved[1:] == out
    worlds = [r for r in out if r["metric"] == "ba_iters_per_s"]
    assert [r["devices"] for r in worlds] == [1, 2]
    assert [r["landmarks"] for r in worlds] == [M_PER_RANK, 2 * M_PER_RANK]
    for r in worlds:
        assert r["backend"] == "gloo" and r["device"] == "cpu" and r["card"] is None
        assert r["value"] > 0 and r["ms_per_solve"] > 0 and r["assembly_ms_per_iter"] > 0
        assert r["collective_and_solve_ms_per_iter"] >= 0
        assert r["value"] == pytest.approx(r["iters_run"] * 1e3 / r["ms_per_solve"])
    eff = out[-1]
    assert eff["metric"] == "scaling_efficiency" and eff["mode"] == "weak" and eff["host_limited_ideal"] is True
    assert eff == BS.scaling_efficiency(worlds[0], worlds[1], False, True)


def test_counted_payload_bytes_match_the_formula(sweep):
    for r in sweep[0][:2]:
        n = r["iters_run"]
        want = n * 4 * (36 * K * K + 6 * K + 1) + 4 * 2 + 4 * 3
        assert r["all_reduces_per_solve"] == n + 2
        assert r["psum_payload_bytes_per_solve"] == want == BS.payload_bytes_per_solve(n, K)
        assert r["psum_payload_bytes_per_iter"] == want / n


def test_mean_error_matches_the_single_device_solve(sweep):
    for r in sweep[0][:2]:
        prob, fx, fy, cx, cy, T_rl = MH.build_problem_np(r["landmarks"], K)
        info = {}
        ref = BA.ba_solve_impl(BA.BAProblem(*(torch.as_tensor(a) for a in prob)), fx, fy, cx, cy,
                               torch.as_tensor(T_rl), BA.BAParams(iters=ITERS), info=info)
        assert r["iters_run"] == info["iters"]
        assert r["n_obs"] == int(ref.n_obs)
        np.testing.assert_allclose(r["mean_err_px"], float(ref.mean_err_px), atol=1e-3)
