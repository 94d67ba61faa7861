"""Window BA's apply step inside `ba_backsub`'s launch, on CPU.

The kernels' algorithm (csrc/ba_gn.cuh) built for one host thread with g++
(csrc/ba_gn_host.cpp, whose blocks take their tickets in block order) and
driven through ops/ba.py's launch sequence:
  - a single-device solve is 3 iters + 2 launches and a group solve of n
    iterations 4 n + 2, with n + 2 all-reduces; no `ba_apply` launcher is
    left;
  - every `ba_backsub` launch leaves the state as the apply step defines it,
    bit for bit, computed here from the state before the launch: unless the
    step was refused before it (ba_solve's step_bad: dx's guard or the
    system's count), dy = Cinv (b - B^T dx) from the blocks ba_terms
    stored, in the kernel's order, Xr += dy on the listed landmarks and
    T_cr = T_new, each with the previous state in its second half; the
    guard's last part (a non-finite dy turns the state to the second half);
    stop_at = it + 1 once done; the count and the ticket counter back at 0;
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


def halves(t: torch.Tensor) -> torch.Tensor:
    """Both halves of a state buffer whose first half `t` views."""
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage(), 0, (2, t.numel()))


def expected_dy(bufs: dict, K: int, n_fix: int) -> tuple:
    """dy of every listed landmark (list position order) from the stored
    blocks and dx, in the kernel's order of float32 operations; and the
    list's slots."""
    n_act = int(bufs["n_act"])
    M = bufs["active"].numel()
    blk = bufs["blk"].view(-1, M)[:, :n_act]
    dx = bufs["dx"].view(K, 6)
    opt = [k for k in range(K) if bool(bufs["kf_valid"][k]) and k >= n_fix]
    rhs = []
    for c in range(3):
        acc = torch.zeros(n_act)
        for o, k in enumerate(opt):
            for r in range(6):
                acc = acc + blk[12 + 18 * o + 3 * r + c] * dx[k, r]
        rhs.append(blk[9 + c] - acc)
    dy = torch.stack([(blk[3 * i] * rhs[0] + blk[3 * i + 1] * rhs[1]) + blk[3 * i + 2] * rhs[2] for i in range(3)], -1)
    return dy, bufs["list"][:n_act].to(torch.int64)


def expected_apply(before: dict, it: int, K: int, n_fix: int):
    """The apply step of iteration `it` on the state `before` the ba_backsub
    launch (X and T with both halves), in PyTorch (ops/ba.py's
    back-substitution, guard and update as the kernels order them): (X, T,
    half, stop_at)."""
    X, T = before["X"].clone(), before["T"].clone()
    half, stop_at = int(before["half"]), int(before["stop_at"])
    if it >= stop_at:
        return X, T, half, stop_at
    refused = bool(before["step_bad"])
    bad = refused
    if not refused:
        dy, lst = expected_dy(before, K, n_fix)
        X0, X1 = X[0].view(-1, 3), X[1].view(-1, 3)
        X1[lst] = X0[lst]
        X0[lst] = X0[lst] + dy
        T[1], T[0] = T[0].clone(), before["T_new"]
        bad = bool((~torch.isfinite(dy)).any())
    half = 1 if bad and not refused else half
    return X, T, half, it + 1 if bad or float(before["dx_max"]) < 1e-5 else stop_at


@pytest.mark.parametrize("case", list(WINDOWS))
def test_every_backsub_launch_ends_with_the_apply_step(case, host_lib):
    make, prm = WINDOWS[case]
    args, intr, T_rl = make()
    problem, T_rl_t = torch_problem(args, T_rl)
    params = TBA.BAParams(**prm)
    K = problem.T_cw.shape[0]
    keys = ("X", "T", "T_new", "half", "dx", "step_bad", "dx_max", "sys", "stop_at", "n_act", "list", "blk",
            "active", "n_dy", "ticket")
    checked = []

    def launch(name, c_fn, argv):
        ins, _, bufs = argv[0]._obj.tensors
        before = {k: (halves(bufs[k]) if k in ("X", "T") else bufs[k]).clone() for k in keys}
        before["kf_valid"] = ins["kf_valid"]
        assert c_fn(*argv) == 0
        if name == "ba_solve" and argv[1] < int(before["stop_at"]):  # the guard's part and max |dx| from dx
            dx = bufs["dx"].view(K, 6)
            n_bad = float(bufs["sys"][TBA.n_sys(TBA.n_opt(ins["kf_valid"], params)) - 1])
            refused = (not bool(torch.isfinite(dx).all()) or n_bad > 0.0
                       or float(dx[:, :3].norm(dim=1).max()) > params.max_trans_update)
            assert bool(bufs["step_bad"]) == refused, (case, argv[1])
            if not refused:
                assert float(bufs["dx_max"]) == float(dx.abs().max()), (case, argv[1])
            assert torch.equal(bufs["T"], before["T"][0]), (case, argv[1])  # ba_backsub takes the step's poses
        if name != "ba_backsub":
            return
        X, T, half, stop_at = expected_apply(before, argv[1], K, params.n_fix)
        lst = before["list"][:int(before["n_act"])].to(torch.int64)
        for h in range(2):  # the listed landmarks (the rest is scratch, and so is the second half until written)
            got = halves(bufs["X"])[h].view(-1, 3)[lst]
            assert torch.equal(got.nan_to_num(), X[h].view(-1, 3)[lst].nan_to_num()), (case, argv[1], h)
        assert torch.equal(halves(bufs["T"]).nan_to_num(), T.nan_to_num()), (case, argv[1])  # unwritten: scratch
        assert int(bufs["half"]) == half, (case, argv[1])
        assert int(bufs["stop_at"]) == stop_at, (case, argv[1])
        assert int(bufs["ticket"]) == 0 and int(bufs["n_dy"]) == 0
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
