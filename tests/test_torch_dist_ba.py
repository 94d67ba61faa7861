"""The port's landmark-sharded BA (`parallel/dist_ba.py` over
`torch.distributed`) on CPU: gloo worlds of 2 and 4 ranks, each rank a
fresh `python -m visual_odometry_ros_tpu_torch.parallel.multihost` process
that imports the port only, on test_ba.py's mono and stereo windows. Held
against the JAX package's `make_distributed_ba` on a mesh of the same size
and against the port's single-device solve, to test_dist_ba.py's
tolerances (poses 2e-4, landmarks 5e-3, mean error 1e-3 px; the sums run
in another float32 order), with the same n_obs and the same number of
iterations on every rank.
"""

import importlib.util
import os
import subprocess
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from visual_odometry_ros_tpu.ops import ba as JBA  # noqa: E402
from visual_odometry_ros_tpu.parallel import dist_ba as JDB  # noqa: E402
from visual_odometry_ros_tpu.parallel.mesh import make_mesh  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import ba as TBA  # noqa: E402
from visual_odometry_ros_tpu_torch.parallel import dist_ba as TDB  # noqa: E402
from visual_odometry_ros_tpu_torch.parallel import mesh as TM  # noqa: E402
from visual_odometry_ros_tpu_torch.parallel import multihost as MH  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"T_cw": 2e-4, "Xw": 5e-3, "err": 1e-3}

_spec = importlib.util.spec_from_file_location("ba_fixtures", os.path.join(REPO, "tests", "test_ba.py"))
_bafix = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bafix)

torch.set_num_threads(2)


def _window(stereo):
    problem, _, _, T_rl = _bafix._make_window(np.random.default_rng(7), stereo=stereo)
    return JBA.BAProblem(*(np.asarray(a) for a in problem)), np.asarray(T_rl)


def _spawn_world(tmp_path, world, problem_npz, iters=10):
    """Run `world` gloo ranks on the problem file; returns their npz results."""
    init = tmp_path / "rendezvous"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "visual_odometry_ros_tpu_torch.parallel.multihost", "--world", str(world),
             "--rank", str(r), "--init", f"file://{init}", "--backend", "gloo", "--timeout", "60",
             "--problem-npz", str(problem_npz), "--iters", str(iters), "--out", str(tmp_path / "res_{rank}.npz")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            p.kill()
    assert all(rc == 0 for rc, _ in outs), [e[-2000:] for _, e in outs]
    return [np.load(tmp_path / f"res_{r}.npz") for r in range(world)]


def _assert_close(rows, T_cw, Xw, err, n_obs, what):
    for z in rows:
        np.testing.assert_allclose(z["T_cw"], T_cw, atol=TOL["T_cw"], rtol=0, err_msg=what)
        np.testing.assert_allclose(z["Xw"], Xw[int(z["lm_start"]):int(z["lm_stop"])], atol=TOL["Xw"], rtol=0,
                                   err_msg=what)
        assert abs(float(z["mean_err_px"]) - float(err)) < TOL["err"], what
        assert int(z["n_obs"]) == int(n_obs), what


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("stereo", [False, True])
def test_gloo_world_matches_jax_sharded_and_port_single(tmp_path, world, stereo):
    problem, T_rl = _window(stereo)
    path = tmp_path / "problem.npz"
    MH.save_problem_npz(str(path), problem, _bafix.FX, _bafix.FY, _bafix.CX, _bafix.CY, T_rl)
    rows = _spawn_world(tmp_path, world, path)

    # Every rank ran the same iterations and holds the same replicated values.
    iters = {int(z["iters_run"]) for z in rows}
    assert len(iters) == 1, f"ranks left the GN loop at different iterations: {iters}"
    # One all-reduce per GN iteration, one for the starting error and one
    # for the final error with the observation counts.
    assert [int(z["all_reduces"]) for z in rows] == [int(rows[0]["iters_run"]) + 2] * world
    for z in rows[1:]:
        for k in ("T_cw", "mean_err_px", "n_obs", "mean_err0_px"):
            np.testing.assert_array_equal(z[k], rows[0][k])
    assert [int(z["lm_stop"]) - int(z["lm_start"]) for z in rows] == [problem.Xw.shape[0] // world] * world

    info = {}
    single = TBA.ba_solve_impl(TBA.BAProblem(*(torch.as_tensor(a) for a in problem)), _bafix.FX, _bafix.FY,
                               _bafix.CX, _bafix.CY, torch.as_tensor(T_rl), info=info)
    _assert_close(rows, single.T_cw.numpy(), single.Xw.numpy(), single.mean_err_px, single.n_obs, "port single")
    # The single-device sums run in another order: the stop test may fall
    # one iteration apart.
    assert abs(info["iters"] - iters.pop()) <= 1

    jres = JDB.make_distributed_ba(make_mesh(world))(
        JBA.BAProblem(*(jnp.asarray(a) for a in problem)), _bafix.FX, _bafix.FY, _bafix.CX, _bafix.CY,
        jnp.asarray(T_rl))
    _assert_close(rows, np.asarray(jres.T_cw), np.asarray(jres.Xw), jres.mean_err_px, jres.n_obs, "JAX sharded")
    # And the solve converges (not only agrees): stereo pins the poses.
    if stereo:
        et, _ = _bafix._pose_errors(rows[0]["T_cw"], _bafix._make_window(np.random.default_rng(7), stereo=True)[1], 8)
        assert et[2:].max() < 0.01


def _one_rank_group_against_no_group(tmp_path, monkeypatch, stereo):
    """Without a group the solve is the single-device one and calls no
    collective; a one-rank gloo group (all-reduce = identity) returns the
    same bits after iters + 2 packed all-reduces, so packing only adds the
    reductions."""
    problem, T_rl = _window(stereo)
    tp = TBA.BAProblem(*(torch.as_tensor(a) for a in problem))
    args = (_bafix.FX, _bafix.FY, _bafix.CX, _bafix.CY, torch.as_tensor(T_rl))

    def refuse(*a, **kw):
        raise AssertionError("group=None must not call a collective")

    with monkeypatch.context() as m:
        m.setattr(dist, "all_reduce", refuse)
        TBA.reset_collective_counts()
        base = TBA.ba_solve_impl(tp, *args)
        assert TBA.COLLECTIVES["all_reduce"] == 0
    dev = MH.init_worker(f"file://{tmp_path / 'rdv1'}", 1, 0, backend="gloo", timeout=30)
    try:
        assert dev.type == "cpu"
        group = MH.global_mesh()
        local = MH.host_tree(problem, group, TDB._sharded_specs()[0], dev)
        info = {}
        TBA.reset_collective_counts()
        res = TDB.make_distributed_ba(group)(local, *args, info=info)
        assert TBA.COLLECTIVES["all_reduce"] == info["iters"] + 2
        assert TM.landmark_slice(problem.Xw.shape[0], group) == slice(0, problem.Xw.shape[0])
    finally:
        dist.destroy_process_group()
    for a, b in zip(res, base):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert info["iters"] >= 1


def test_group_none_makes_no_collective_and_one_rank_group_is_identical(tmp_path, monkeypatch):
    _one_rank_group_against_no_group(tmp_path, monkeypatch, stereo=True)


def test_one_rank_group_is_identical_on_the_mono_window(tmp_path, monkeypatch):
    _one_rank_group_against_no_group(tmp_path, monkeypatch, stereo=False)


def test_problem_builders_match_bench_scaling_and_dryrun():
    """The port's seeded problems equal scripts/bench_scaling.py's
    build_problem_np and __graft_entry__.dryrun_multichip's construction.
    Poses come from the port's float32 se3_exp and inverse, whose operation
    order differs: 2.4e-5 m on translations up to 3.2 m, so 5e-3 px on
    pixels 5-60 m away at fx 718; no mask flips."""
    sys.path.insert(0, REPO)
    from scripts.bench_scaling import build_problem_np

    jp, *jrest = build_problem_np(512, 5)
    tp, *trest = MH.build_problem_np(512, 5)
    np.testing.assert_allclose(tp.T_cw, np.asarray(jp.T_cw), atol=5e-5, rtol=0)
    np.testing.assert_allclose(tp.pts, np.asarray(jp.pts), atol=5e-3, rtol=0)
    np.testing.assert_allclose(tp.pts_r, np.asarray(jp.pts_r), atol=5e-3, rtol=0)
    for k in ("Xw", "mask", "mask_r", "kf_valid", "lm_valid"):
        np.testing.assert_array_equal(getattr(tp, k), np.asarray(getattr(jp, k)), err_msg=k)
    assert trest[:4] == jrest[:4]
    np.testing.assert_array_equal(trest[4], np.asarray(jrest[4]))
    dp, fx, fy, cx, cy, T_rl = MH.dryrun_problem_np()
    assert dp.Xw.shape == (4096, 3) and dp.pts.shape == (4096, 9, 2) and (fx, cx, cy) == (300.0, 80.0, 60.0)
    assert dp.mask.mean() > 0.9 and T_rl[0, 3] == -0.5
    # Its 3-iteration solve, as chip_smoke.py runs it, against the JAX
    # package's on the same numpy problem. Its right rows repeat the left
    # pixels, so the left-row error rises over the solve in both packages.
    params = dict(iters=3)
    t = TBA.ba_solve_impl(TBA.BAProblem(*(torch.as_tensor(a) for a in dp)), fx, fy, cx, cy, torch.as_tensor(T_rl),
                          TBA.BAParams(**params))
    j = JBA.ba_solve(JBA.BAProblem(*(jnp.asarray(a) for a in dp)), fx, fy, cx, cy, jnp.asarray(T_rl),
                     JBA.BAParams(**params))
    np.testing.assert_allclose(t.T_cw.numpy(), np.asarray(j.T_cw), atol=TOL["T_cw"], rtol=0)
    for k in ("mean_err_px", "mean_err0_px"):
        assert abs(float(getattr(t, k)) - float(getattr(j, k))) < TOL["err"], k
    assert int(t.n_obs) == int(j.n_obs) and float(t.mean_err_px) > float(t.mean_err0_px)


def test_mesh_helpers():
    assert TM.pad_to_multiple(4095, 4) == 4096 and TM.pad_to_multiple(8, 4) == 8
    assert TM.LM_AXIS == "lm"
    prob_spec, scalar_specs, out_spec = TDB._sharded_specs()
    assert prob_spec.Xw == TM.LM_AXIS and prob_spec.T_cw is None and len(scalar_specs) == 5
    assert out_spec.killed == TM.LM_AXIS and out_spec.n_obs is None
