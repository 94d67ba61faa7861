"""`ba_backsub` reading the landmark blocks that `ba_terms` stored, on CPU.

The kernels' algorithm (csrc/ba_gn.cuh) built for one host thread with g++
(csrc/ba_gn_host.cpp) and driven through ops/ba.py's launch sequence:
  - the blocks ba_terms stores by list position (Cinv, b, and B over the
    optimisable slots, zero where a slot does not observe the landmark)
    against the plain version's assemble_normal_blocks / schur_reduce at the
    anchored start, K = 10 stereo, K = 8 mono and K = 16;
  - every solve of tests/test_torch_ba_redesign.py's windows, each
    ba_backsub launch's state after it bit for bit against the apply step
    computed in PyTorch from the state before it (back-substitution from the
    stored blocks in the kernel's order), the result against ba_solve_ref
    and the JAX package under the tolerances that file uses;
  - a step that only a non-finite dy refuses: the state turns to the second
    half, T_cr and Xr as they were before the step, and the solve ends as
    one that stopped before that step, bit for bit;
  - dryrun_multichip's dense window, whose 256 tiles outnumber the 132
    blocks and whose 4096 listed landmarks stride the back-substitution's
    grid.
"""

import numpy as np
import pytest
import torch
from test_torch_ba_apply_fold import expected_apply, halves
from test_torch_ba_gn import CASES as GN_CASES
from test_torch_ba_gn import assert_same_solve, build_host_lib, host_solve, jax_solve, torch_problem
from test_torch_ba_redesign import CASES as RD_CASES

from visual_odometry_ros_tpu_torch.ops import ba as TBA

torch.set_num_threads(2)

KEYS = ("X", "T", "T_new", "half", "dx", "step_bad", "dx_max", "stop_at", "n_act", "list", "blk", "active", "n_dy",
        "ticket")


@pytest.fixture(scope="module")
def host_lib():
    return build_host_lib()


def checked_solve(lib, problem, intr, T_rl, params, info, before_backsub=None):
    """The kernels' solve on the host build, every working ba_backsub
    launch's state held bit for bit to `expected_apply`; before_backsub(it,
    bufs), where given, may edit the state before each ba_backsub launch.
    Returns (result, the iterations whose launch was checked)."""
    K = problem.T_cw.shape[0]
    checked = []

    def launch(name, c_fn, argv):
        ins, _, bufs = argv[0]._obj.tensors
        if name == "ba_backsub" and before_backsub is not None:
            before_backsub(argv[1], bufs)
        before = {k: (halves(bufs[k]) if k in ("X", "T") else bufs[k]).clone() for k in KEYS}
        before["kf_valid"] = ins["kf_valid"]
        assert c_fn(*argv) == 0
        if name != "ba_backsub" or argv[1] >= int(before["stop_at"]):
            return
        X, T, half, stop_at = expected_apply(before, argv[1], K, params.n_fix)
        lst = before["list"][:int(before["n_act"])].to(torch.int64)
        for h in range(2):
            got = halves(bufs["X"])[h].view(-1, 3)[lst]
            assert torch.equal(got.nan_to_num(), X[h].view(-1, 3)[lst].nan_to_num()), (argv[1], h)
        assert torch.equal(halves(bufs["T"]).nan_to_num(), T.nan_to_num()), argv[1]  # unwritten: scratch
        assert int(bufs["half"]) == half, argv[1]
        assert int(bufs["stop_at"]) == stop_at and int(bufs["n_dy"]) == int(bufs["ticket"]) == 0, argv[1]
        checked.append(argv[1])

    res = TBA._ba_kernels(problem, *intr, T_rl, params, None, info, lib, launch=launch)
    return res, checked


# The stored blocks at the anchored start against the plain version's: the
# same float32 formulas in another order. A residual is a small difference
# of pixel coordinates near 600 px, so one rounding of the projection moves
# it by ~1e-4 relative, and with it b and, through the Huber weight, B:
# each landmark's b and B are held to BLOCK_TOL of its largest entry
# (measured at most 2.6e-4). Cinv also carries C's condition number, up to
# 1e7 for a mono landmark seen across a short baseline: held to
# CINV_TOL x cond(C) of its largest entry (measured at most 1.6e-7).
BLOCK_TOL, CINV_TOL = 1e-3, 1e-6
BLOCK_WINDOWS = {
    "stereo_main": GN_CASES["stereo_main"][0],  # K = 10, 8 optimisable slots
    "mono": GN_CASES["mono"][0],  # K = 8, no right rows
    "largest_k16": RD_CASES["n_opt_14_blocked"][0],  # K = 16, 14 optimisable slots
}


@pytest.mark.parametrize("case", list(BLOCK_WINDOWS))
def test_stored_blocks_match_the_plain_version(case, host_lib):
    args, intr, T_rl = BLOCK_WINDOWS[case]()
    problem, T_rl_t = torch_problem(args, T_rl)
    params = TBA.BAParams(iters=1)
    snap = {}

    def launch(name, c_fn, argv):
        assert c_fn(*argv) == 0
        if name == "ba_terms" and argv[2] == TBA._TERMS:
            _, _, bufs = argv[0]._obj.tensors
            snap.update({k: bufs[k].clone() for k in ("blk", "list", "n_act")})

    TBA._ba_kernels(problem, *intr, T_rl_t, params, None, None, host_lib, launch=launch)
    an = TBA._anchor(problem, params)
    w, r, Q, Rj = TBA.build_observation_terms(an.T_cr, an.Xr, problem.pts, an.mask, problem.pts_r, an.mask_r,
                                              *intr, T_rl_t, params.huber_delta)
    A, a, C, b, B = TBA.assemble_normal_blocks(w, r, Q, Rj)
    _, _, Cinv, _ = TBA.schur_reduce(A, a, C, b, B, params.lam)
    M, n_act = problem.Xw.shape[0], int(snap["n_act"])
    lst = snap["list"][:n_act].to(torch.int64)
    opt = torch.nonzero(an.opt_mask)[:, 0]
    assert n_act > 100
    blk = snap["blk"].view(-1, M)[:TBA.blk_rows(len(opt)), :n_act]
    got = {"Cinv": blk[:9].T.reshape(-1, 3, 3), "b": blk[9:12].T,
           "B": blk[12:].T.reshape(n_act, len(opt), 6, 3)}
    want = {"Cinv": Cinv[lst], "b": b[lst], "B": B[lst][:, opt]}
    eye = torch.eye(3)
    cond = torch.linalg.cond((C + params.lam * C * eye + 1e-6 * eye)[lst].double()).float()
    for key in got:
        err = ((got[key] - want[key]).abs().flatten(1).amax(dim=1)
               / want[key].abs().flatten(1).amax(dim=1).clamp(min=1e-30))
        if key == "Cinv":
            err = err / cond
        assert float(err.max()) <= (CINV_TOL if key == "Cinv" else BLOCK_TOL), (case, key, float(err.max()))
    unseen = ~(an.mask | an.mask_r)[lst][:, opt]  # a pair not observed stores an exact zero
    assert bool(unseen.any()) and bool((got["B"][unseen] == 0).all())


@pytest.mark.parametrize("case", list(RD_CASES))
def test_every_solve_reads_the_stored_blocks(case, host_lib):
    """Every working ba_backsub launch of the solve bit for bit against the
    apply step from the stored blocks, the solve against the plain version
    and JAX (tests/test_torch_ba_redesign.py's tolerances and checks)."""
    make, prm, _ = RD_CASES[case]
    args, intr, T_rl = make()
    problem, T_rl_t = torch_problem(args, T_rl)
    params = TBA.BAParams(**prm)
    info_ref, info_host = {}, {}
    host, checked = checked_solve(host_lib, problem, intr, T_rl_t, params, info_host)
    ref = TBA.ba_solve_ref(problem, *intr, T_rl_t, params, info=info_ref)
    assert checked == list(range(info_host["iters"]))
    assert abs(info_ref["iters"] - info_host["iters"]) <= 1
    if case == "nan_fixed_slot":  # refused before back-substitution on both sides
        assert info_host["iters"] == 1
        np.testing.assert_array_equal(host.Xw.numpy(), ref.Xw.numpy())
        return
    assert_same_solve(host, ref, f"{case}: kernel algorithm vs plain", tight=True)
    assert_same_solve(ref, jax_solve(args, intr, T_rl, prm), f"{case}: plain vs JAX")


def test_a_step_refused_for_dy_alone_turns_the_state_to_the_second_half(host_lib):
    """Before iteration 1's ba_backsub launch, one listed landmark's stored
    Cinv and b are made to overflow its dy (3e38 times 1e3): the launch's
    count refuses the step it took, the state turns to the second half (T_cr
    and Xr as they were before it), the loop stops, and the solve equals one
    of a single iteration, bit for bit."""
    args, intr, T_rl = GN_CASES["stereo_main"][0]()
    problem, T_rl_t = torch_problem(args, T_rl)
    params = TBA.BAParams()
    seen = {}

    def overflow(it, bufs):
        if it == 1:
            M = bufs["active"].numel()
            blk = bufs["blk"].view(-1, M)
            blk[0, 0], blk[9, 0] = 3e38, 1e3
            seen["T"], seen["T_step"] = bufs["T"].clone(), bufs["T_new"].clone()

    info = {}
    got, checked = checked_solve(host_lib, problem, intr, T_rl_t, params, info, overflow)
    assert info["iters"] == 2 and checked == [0, 1]
    assert not torch.equal(seen["T"], seen["T_step"])  # the refused step would have moved the poses
    one = host_solve(host_lib, problem, intr, T_rl_t, TBA.BAParams(iters=1))
    for a, b in zip(got, one):
        assert torch.equal(a, b)


def test_dense_window_strides_the_grid(host_lib):
    """dryrun_multichip's window: all 4096 landmarks listed in 256 tiles on
    132 blocks, every working launch bit for bit, the solve against the
    plain version under the dense window's T_cw spread (2e-4,
    tests/test_torch_ba_gn.py's float64 witness)."""
    from visual_odometry_ros_tpu_torch.parallel import multihost as MH

    prob, fx, fy, cx, cy, T_rl = MH.dryrun_problem_np()
    problem, T_rl_t = torch_problem(prob, T_rl)
    params = TBA.BAParams(iters=3)
    info = {}
    got, checked = checked_solve(host_lib, problem, (fx, fy, cx, cy), T_rl_t, params, info)
    assert checked == [0, 1, 2]
    ref = TBA.ba_solve_ref(problem, fx, fy, cx, cy, T_rl_t, params)
    assert float((got.T_cw - ref.T_cw).abs().max()) <= 2e-4
    assert torch.equal(got.killed, ref.killed) and int(got.n_obs) == int(ref.n_obs)
