"""Window BA's apply step as the tail of `ba_backsub`'s launch, on CPU.

The kernels' algorithm (csrc/ba_gn.cuh) built for one host thread with g++
(csrc/ba_gn_host.cpp, whose blocks take their tickets in block order) and
driven through ops/ba.py's launch sequence:
  - a single-device solve is 3 iters + 2 launches and a group solve of n
    iterations 4 n + 2, with n + 2 all-reduces; no `ba_apply` launcher is
    left;
  - every `ba_backsub` launch leaves the state as the apply step defines it
    (the guard from dx, the all-reduced count and every tile's non-finite
    dy; Xr += dy on the listed landmarks and T_cr = T_new unless refused;
    stop_at = it + 1 once done), bit for bit, computed here from the state
    before the launch, and hands its ticket counter back at 0;
on windows where the grid has more tiles than blocks, blocks without a
tile, no active landmark, a refused step, and a non-finite pixel.
"""

import numpy as np
import pytest
import torch
from test_torch_ba_gn import CASES as GN_CASES
from test_torch_ba_gn import assert_same_solve, build_host_lib, host_solve, jax_solve, torch_problem
from test_torch_ba_redesign import CASES as RD_CASES

from visual_odometry_ros_tpu_torch.ops import ba as TBA
from visual_odometry_ros_tpu_torch.ops import kernels as KN

torch.set_num_threads(2)

TBA_KERNELS = ("ba_terms", "ba_solve", "ba_backsub")  # a solve's launches, in iteration order
WINDOWS = {
    "stereo_main": GN_CASES["stereo_main"][:2],  # 256 tiles on 132 blocks
    "scattered_active": RD_CASES["scattered_active"][:2],  # most blocks without a tile
    "none_active": RD_CASES["none_active"][:2],  # no tile at all
    "trans_trip": GN_CASES["trans_trip"][:2],  # dx refused by max_trans_update
    "nan_obs": GN_CASES["nan_obs"][:2],  # a non-finite system: refused
}


@pytest.fixture(scope="module")
def host_lib():
    return build_host_lib()


def logged(lib, problem, intr, T_rl, params, group=None, info=None):
    """The solve on the host build with each launch's (name, iteration)."""
    log = []
    res = host_solve(lib, problem, intr, T_rl, params, info, log, group=group)
    return res, log


@pytest.mark.parametrize("iters", [0, 1, 6])
def test_single_device_solve_is_3_iters_plus_2_launches(iters, host_lib):
    args, intr, T_rl = GN_CASES["early_stop"][0]()
    problem, T_rl_t = torch_problem(args, T_rl)
    _, log = logged(host_lib, problem, intr, T_rl_t, TBA.BAParams(iters=iters))
    assert len(log) == TBA.launches_per_solve(iters) == 3 * iters + 2
    assert log == [("ba_terms", -1)] + [(k, it) for it in range(iters) for k in TBA_KERNELS] + [("ba_terms", -1)]
    assert not hasattr(host_lib, "ba_apply_launch") and "ba_apply" not in KN.LAUNCHES


def test_group_solve_is_4n_plus_2_launches_and_n_plus_2_all_reduces(host_lib, tmp_path):
    """Over one gloo rank: per iteration run, ba_terms, ba_solve's sum and
    solve phases around the all-reduce, ba_backsub with the apply step as
    its tail; the host reads the stop flag once per iteration. The result is
    the single-device solve's, bit for bit."""
    import torch.distributed as dist

    args, intr, T_rl = GN_CASES["sparse_landmarks"][0]()
    problem, T_rl_t = torch_problem(args, T_rl)
    params = TBA.BAParams()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1, rank=0)
    try:
        info = {}
        TBA.reset_collective_counts()
        got, log = logged(host_lib, problem, intr, T_rl_t, params, group=dist.group.WORLD, info=info)
        reduces = TBA.COLLECTIVES["all_reduce"]
    finally:
        dist.destroy_process_group()
    n = info["iters"]
    assert 1 < n < params.iters
    counts = {k: sum(1 for name, _ in log if name == k) for k in TBA_KERNELS}
    assert counts == {"ba_terms": n + 2, "ba_solve": 2 * n, "ba_backsub": n} and len(log) == 4 * n + 2
    assert reduces == n + 2
    alone = host_solve(host_lib, problem, intr, T_rl_t, params)
    for a, b in zip(got, alone):
        assert torch.equal(a, b)


def expected_apply(before: dict, after_dy, after_dy_bad, it: int, n_sys: int):
    """The apply step of iteration `it` on the state `before` the ba_backsub
    launch, in PyTorch (ops/ba.py's guard and update as the kernels order
    them): (X, T, stop_at)."""
    X, T, stop_at = before["X"].clone(), before["T"].clone(), int(before["stop_at"])
    if it >= stop_at:
        return X, T, stop_at
    n_act = int(before["n_act"])
    G = min(-(-n_act // TBA._TL), len(after_dy_bad))
    bad = bool(before["dx_bad"]) or float(before["sys"][n_sys - 1]) > 0.0 or int(after_dy_bad[:G].sum()) > 0
    mx = 0.0
    if not bad:
        lst = before["list"][:n_act].to(torch.int64)
        Xv, dy = X.view(-1, 3), after_dy.view(-1, 3)
        Xv[lst] = Xv[lst] + dy[lst]
        T = before["T_new"].clone()
        mx = float(before["dx"].abs().max())
    return X, T, it + 1 if bad or mx < 1e-5 else stop_at


@pytest.mark.parametrize("case", list(WINDOWS))
def test_every_backsub_launch_ends_with_the_apply_step(case, host_lib):
    make, prm = WINDOWS[case]
    args, intr, T_rl = make()
    problem, T_rl_t = torch_problem(args, T_rl)
    params = TBA.BAParams(**prm)
    n_sys = TBA.n_sys(TBA.n_opt(problem.kf_valid, params))
    keys = ("X", "T", "T_new", "dx", "dx_bad", "sys", "stop_at", "n_act", "list", "dy", "dy_bad", "ticket")
    checked = []

    def launch(name, c_fn, argv):
        _, _, bufs = argv[0]._obj.tensors
        before = {k: bufs[k].clone() for k in keys}
        assert c_fn(*argv) == 0
        if name != "ba_backsub":
            return
        X, T, stop_at = expected_apply(before, bufs["dy"], bufs["dy_bad"], argv[1], n_sys)
        assert torch.equal(bufs["X"].nan_to_num(), X.nan_to_num()), (case, argv[1])  # inactive slots: scratch
        assert torch.equal(bufs["T"], T) and int(bufs["stop_at"]) == stop_at, (case, argv[1])
        assert int(bufs["ticket"]) == 0
        checked.append(argv[1] < int(before["stop_at"]))

    info = {}
    got = TBA._ba_kernels(problem, *intr, T_rl_t, params, None, info, host_lib, launch=launch)
    assert sum(checked) == info["iters"] and len(checked) == params.iters
    ref = TBA.ba_solve_ref(problem, *intr, T_rl_t, params)
    if case == "nan_obs":
        assert np.isnan(float(got.mean_err_px)) and np.isnan(float(ref.mean_err_px))
        assert torch.equal(got.Xw, ref.Xw)
    else:
        assert_same_solve(got, ref, f"{case}: kernel algorithm vs plain", tight=True)
    if case == "none_active":
        want = jax_solve(args, intr, T_rl, prm)
        assert_same_solve(ref, want, f"{case}: plain vs JAX")
