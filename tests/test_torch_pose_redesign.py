"""The pose solve's redesigned parts, on CPU: several solves in one launch
(`pose_only_gn_mono_many`, pnp_ransac's two polishes), and the walk over
every point, weighted or not.

The kernel's algorithm (csrc/pose_gn.cuh) built for one host thread with g++
(csrc/pose_gn_host.cpp; `pose_gn_host_many` takes a launch's solves as the
card's blocks do) is held to the port's plain version and the JAX package
under tests/test_torch_pose_gn.py's tolerances (T10 to 5e-5, the same
inlier mask and ok, mean error and per-point error to 1e-3 relative):
  - the solves of one launch equal their single launches bit for bit, and
    the plain versions and JAX within those tolerances;
  - `nan_unweighted`: an unweighted point with a NaN observation. The JAX
    reference multiplies every row by its weight, so a mono row (masked
    only by depth) carries the NaN into the step, which is refused; a
    stereo row is masked by its view's mask first and contributes nothing.
    A kernel that walked only the weighted points would miss the first and
    so differ from the reference. The mean error counts the valid points
    only, as the reference's does, NaN or not at the others.
"""

import ctypes

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_pose_gn import (  # noqa: E402
    CX, CY, FX, FY, KINDS, assert_same_solve, host_solve, jax_solve, problem, torch_solve,
)
from test_torch_pose_gn import host_lib as host_lib  # noqa: E402,F401  (the module's g++ build)

from visual_odometry_ros_tpu.ops import pose_gn as JPG  # noqa: E402
from visual_odometry_ros_tpu.utils import geometry as JG  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import kernels as KN  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pnp as TPNP  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pose_gn as TPG  # noqa: E402

torch.set_num_threads(2)

PRM = TPG.PoseGNParams(max_iters=30)  # pnp_ransac's polish


def polish_pair(seed=31, nan_obs=False):
    """pnp_ransac's two polishes of one recovery: the RANSAC winner's
    inlier set (the first 2x-threshold inliers: here the first 40 valid
    points) from a perturbed pose, and the prior's polish over every valid
    point from the identity. Returns [(X0, pts, valid, fx, fy, cx, cy,
    T_init)] as CPU tensors."""
    p = problem(seed=seed, n_out=60, nan_obs=nan_obs)
    X0, pl, vl = (torch.as_tensor(p[k]) for k in ("X0", "pl", "vl"))
    winner = vl & (torch.cumsum(vl.to(torch.int64), 0) <= 40)
    T_w = torch.as_tensor(np.asarray(JG.se3_exp(jnp.asarray(np.float32([0.03, -0.02, -0.2, 0.004, 0.01, -0.003])))))
    return [(X0, pl, winner, FX, FY, CX, CY, T_w), (X0, pl, vl, FX, FY, CX, CY, torch.eye(4))]


def same(a, b):
    """Bit for bit, NaN where NaN."""
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    return torch.equal(a, b)


def host_many(lib, solves, params):
    """One launch of len(solves) blocks on the host build, through the
    port's own `_pack`."""
    packed = [TPG._pack(X0, pl, None, v, None, None, T, fx, fy, cx, cy, params, 1, 0.0)
              for X0, pl, v, fx, fy, cx, cy, T in solves]
    args = (TPG._Args * len(packed))(*(p[2] for p in packed))
    lib.pose_gn_host_many.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert lib.pose_gn_host_many(args, len(packed)) == 0
    return [res for res, _, _ in packed]


def host_single(lib, solve, params):
    X0, pl, v, fx, fy, cx, cy, T = solve
    res, _, args = TPG._pack(X0, pl, None, v, None, None, T, fx, fy, cx, cy, params, 1, 0.0)
    assert lib.pose_gn_host(ctypes.byref(args)) == 0
    return res


def jax_mono(solve, params):
    X0, pl, v, fx, fy, cx, cy, T = (np.asarray(x) if isinstance(x, torch.Tensor) else x for x in solve)
    return JPG.pose_only_gn_mono(jnp.asarray(X0), jnp.asarray(pl), jnp.asarray(v), fx, fy, cx, cy, jnp.asarray(T),
                                 JPG.PoseGNParams(**params._asdict()))


@pytest.mark.parametrize("case", ["main", "cholesky_fails"])
def test_one_launch_of_two_solves_equals_two_single_launches(case, host_lib):  # noqa: F811
    """The two-block launch gives each solve bit for bit what its own
    launch gives, and that equals the plain version and JAX."""
    solves = polish_pair(nan_obs=case == "cholesky_fails")
    pair = host_many(host_lib, solves, PRM)
    for s, got in zip(solves, pair):
        alone = host_single(host_lib, s, PRM)
        assert all(same(a, b) for a, b in zip(got, alone))
    refs = TPG.pose_only_gn_mono_many_ref(solves, PRM)
    for s, got, ref in zip(solves, pair, refs):
        assert_same_solve((got, None), (ref, None), f"{case}: kernel algorithm vs plain")
        assert_same_solve((ref, None), (jax_mono(s, PRM), None), f"{case}: plain vs JAX")
        assert abs(int(got.n_iter) - int(ref.n_iter)) <= 2
    if case == "cholesky_fails":  # the NaN observation is valid in the prior's polish only
        assert int(refs[1].n_iter) == 1 and not bool(refs[1].ok)


def test_many_on_cpu_is_the_plain_version_and_checks_its_inputs():
    """On CPU tensors `pose_only_gn_mono_many` runs the single plain solves
    in turn, bit for bit, and launches nothing; it takes 1 to MAX_SOLVES
    solves of well-formed inputs."""
    solves = polish_pair()
    KN.reset_launch_counts()
    got = TPG.pose_only_gn_mono_many(solves, PRM)
    assert KN.LAUNCHES["pose_gn"] == 0
    for s, g in zip(solves, got):
        want = TPG.pose_only_gn_mono_ref(*s, PRM)
        assert all(torch.equal(a, b) for a, b in zip(g, want))
    with pytest.raises(ValueError):
        TPG.pose_only_gn_mono_many([], PRM)
    with pytest.raises(ValueError):
        TPG.pose_only_gn_mono_many(solves * (TPG.MAX_SOLVES // 2 + 1), PRM)
    with pytest.raises(TypeError):
        X0, *rest = solves[1]
        TPG.pose_only_gn_mono_many([solves[0], (X0.double(), *rest)], PRM)


def test_pnp_ransac_polishes_the_winner_and_the_prior_in_one_call(monkeypatch):
    """With a prior, pnp_ransac makes one `pose_only_gn_mono_many` call of
    its two polishes (the winner's, then the prior's), none alone; without
    one, one `pose_only_gn_mono` call."""
    p = problem(seed=33, n_out=80)
    Xw, pts, valid = (torch.as_tensor(p[k]) for k in ("X0", "pl", "vl"))
    calls = []
    many, one = TPG.pose_only_gn_mono_many, TPG.pose_only_gn_mono
    monkeypatch.setattr(TPG, "pose_only_gn_mono_many",
                        lambda s, *a, **k: calls.append(("many", len(s))) or many(s, *a, **k))
    monkeypatch.setattr(TPG, "pose_only_gn_mono", lambda *a, **k: calls.append(("one", 1)) or one(*a, **k))
    idx = torch.as_tensor(np.random.default_rng(0).choice(np.flatnonzero(p["vl"]), (16, 6)))
    with_prior = TPNP.pnp_ransac(Xw, pts, valid, FX, FY, CX, CY, n_hypotheses=16, T_init=torch.eye(4), idx=idx)
    TPNP.pnp_ransac(Xw, pts, valid, FX, FY, CX, CY, n_hypotheses=16, idx=idx)
    assert calls == [("many", 2), ("one", 1)]
    assert torch.isfinite(with_prior.T_cw).all()


def nan_unweighted(seed=21):
    """tests/test_torch_pose_gn.py's frame pair with one unweighted (left
    invalid) point whose left observation is NaN."""
    p = problem(seed=seed)
    i = int(np.flatnonzero(~p["vl"])[0])
    p["pl"][i, 0] = np.nan
    return p


@pytest.mark.parametrize("kind", KINDS)
def test_nan_unweighted_point_is_held_to_jax(kind, host_lib):  # noqa: F811
    """Every point is walked, weighted or not: the kernel's algorithm, the
    plain version and JAX agree on a NaN observation at an unweighted
    point. Mono carries it into H (the first step of each pass is refused);
    stereo masks the row and solves as if the point were absent."""
    p = nan_unweighted()
    want = jax_solve(kind, p, {})
    ref = torch_solve(kind, p, {}, "_ref")
    assert_same_solve(ref, want, f"{kind}/nan_unweighted: plain vs JAX")
    host = host_solve(host_lib, kind, p, {})
    assert_same_solve(host, ref, f"{kind}/nan_unweighted: kernel algorithm vs plain")
    n = [int(r[0].n_iter) for r in (want, ref, host)]
    if kind == "mono_polish":
        assert n == [1, 1, 1], n  # refused at the first step: T10 stays the start
        np.testing.assert_array_equal(np.asarray(ref[0].T10), np.eye(4, dtype=np.float32))
    elif kind == "stereo_robust":
        clean = problem()
        clean["vl"], clean["vr"] = p["vl"], p["vr"]
        base = torch_solve(kind, clean, {}, "_ref")
        assert all(torch.equal(a, b) for a, b in zip(ref[0], base[0]))
    else:
        assert max(n) - min(n) <= 2, n


@pytest.mark.parametrize("leg", ["pose_ab", "kernel_split"])
def test_measurement_legs_need_a_card(leg, tmp_path):
    """The pose A/B leg and the kernel split measure the card only: without
    one they exit before they read a case, build or write a record."""
    import importlib

    mod = importlib.import_module(f"visual_odometry_ros_tpu_torch.{leg}")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA"):
        mod.main(["--cases", str(tmp_path), "--tag", "t", "--out", str(tmp_path / "ab.jsonl")])
    assert not (tmp_path / "ab.jsonl").exists()


def test_kernel_split_marks_the_kernels_once_and_its_copy_compiles(tmp_path):
    """The split's stamps go around statements the kernels carry: each mark
    matches the tree's sources once (so an edit that moves one fails here,
    not on the card), the copy takes another team size, and the copy's host
    builds still compile, the stamps empty there."""
    import shutil
    import subprocess

    from visual_odometry_ros_tpu_torch import kernel_split as KSP

    src = KSP.instrument(str(tmp_path), 128)
    text = {f: open(f"{src}/{f}").read() for f in ("pose_gn.cuh", "pose_gn.cu", "ba_gn.cuh")}
    assert [text[f].count("KS(") for f in text] == [6, 2, 9]
    assert text["ba_gn.cuh"].count("KS_CLOCK(") == text["ba_gn.cuh"].count("KS_AT(") == 1
    assert "constexpr int kThreads = 128;" in text["pose_gn.cu"]
    assert "ks_read_ba_gn" in open(f"{src}/ba_gn.cu").read()
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the copy's host builds")
    for f in ("pose_gn_host.cpp", "ba_gn_host.cpp"):
        proc = subprocess.run([cxx, "-std=c++17", "-fsyntax-only", f"{src}/{f}"], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
