"""The pose layer (ops/pose_gn.py) against the JAX package at the main path's
size, on CPU: N = 1024 points, default PoseGNParams (max_iters = 100).

Three implementations meet on the same numpy inputs: the JAX package's
while-loop solve, the port's plain PyTorch version (`*_ref`, which the
public functions run on CPU tensors), and the `pose_gn` kernel's algorithm
(csrc/pose_gn.cuh) compiled for one host thread with g++
(csrc/pose_gn_host.cpp), so that a formula or branch error in the kernel
shows here without a card. All three compute in float32; only the order of
the 1024-point sums differs, so the tolerances are those of
tests/test_torch_ops.py's pose test: T10 to 5e-5, the same inlier mask and
ok, mean error and per-point error to 1e-3 relative.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.ops import pose_gn as JPG  # noqa: E402
from visual_odometry_ros_tpu.utils import geometry as JG  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import kernels as KN  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pose_gn as TPG  # noqa: E402

torch.set_num_threads(2)

N = 1024
FX = FY = 718.856  # bench.py's KITTI intrinsics
CX, CY = 607.1928, 185.2157
BASELINE = 0.5371657
HOST_SRC = KN.CSRC / "pose_gn_host.cpp"


def problem(seed=21, n_out=120, behind=0, n_valid=None, nan_obs=False):
    """A stereo frame pair: X0 in the previous left camera, the current
    left/right observations with 0.3 px noise and n_out gross outliers,
    valid_l ~95%, valid_r ~80% of valid_l. behind: that many points moved
    behind the camera; n_valid: keep only the first n_valid valid; nan_obs:
    one valid left observation is NaN."""
    rng = np.random.default_rng(seed)
    X0 = np.stack([rng.uniform(-8, 8, N), rng.uniform(-2, 2, N), rng.uniform(4, 40, N)], -1).astype(np.float32)
    T10 = np.asarray(JG.se3_exp(jnp.asarray(np.float32([0.02, -0.01, -0.25, 0.003, 0.008, -0.002]))))
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -BASELINE
    Xl = X0 @ T10[:3, :3].T + T10[:3, 3]
    Xr = Xl + T_rl[:3, 3]
    pl = np.stack([Xl[:, 0] / Xl[:, 2] * FX + CX, Xl[:, 1] / Xl[:, 2] * FY + CY], -1)
    pr = np.stack([Xr[:, 0] / Xr[:, 2] * FX + CX, Xr[:, 1] / Xr[:, 2] * FY + CY], -1)
    pl = (pl + rng.normal(0, 0.3, pl.shape)).astype(np.float32)
    pr = (pr + rng.normal(0, 0.3, pr.shape)).astype(np.float32)
    pl[:n_out] += rng.uniform(-30, 30, (n_out, 2)).astype(np.float32)
    vl = rng.uniform(size=N) > 0.05
    vr = vl & (rng.uniform(size=N) > 0.2)
    if behind:
        X0[n_out:n_out + behind, 2] *= -1.0
    if n_valid is not None:
        vl[np.cumsum(vl) > n_valid] = False
        vr &= vl
    if nan_obs:
        pl[np.flatnonzero(vl)[-1], 0] = np.nan
    return dict(X0=X0, pl=pl, pr=pr, vl=vl, vr=vr, T_rl=T_rl)


# name: (problem kwargs, PoseGNParams overrides)
CASES = {
    "main": ({}, {}),
    "max_iters": ({}, dict(step_tol=0.0, cost_tol=0.0)),  # the stop test never fires
    "few_valid": (dict(n_out=0, n_valid=4), {}),  # rank-deficient H: ok fails on min_inliers
    "cholesky_fails": (dict(nan_obs=True), {}),  # a NaN in H: `bad` stops the pass at once
    "all_invalid": (dict(n_valid=0), {}),
    "behind_camera": (dict(behind=200), {}),  # the z > 0.01 masks
}
KINDS = ("stereo_robust", "mono_robust", "mono_polish")


def jax_solve(kind, p, prm):
    params = JPG.PoseGNParams(**prm)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    if kind == "stereo_robust":
        return JPG.pose_only_gn_stereo_robust(j["X0"], j["pl"], j["pr"], j["vl"], j["vr"], FX, FY, CX, CY,
                                              j["T_rl"], jnp.eye(4), params)
    if kind == "mono_robust":
        return JPG.pose_only_gn_mono_robust(j["X0"], j["pl"], j["vl"], FX, FY, CX, CY, jnp.eye(4), params)
    return JPG.pose_only_gn_mono(j["X0"], j["pl"], j["vl"], FX, FY, CX, CY, jnp.eye(4), params), None


def torch_inputs(kind, p):
    """The port's arguments before T_10_init, as CPU tensors."""
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    if kind == "stereo_robust":
        return (t["X0"], t["pl"], t["pr"], t["vl"], t["vr"], FX, FY, CX, CY, t["T_rl"])
    return (t["X0"], t["pl"], t["vl"], FX, FY, CX, CY)


def torch_solve(kind, p, prm, suffix=""):
    params = TPG.PoseGNParams(**prm)
    name = {"stereo_robust": "pose_only_gn_stereo_robust", "mono_robust": "pose_only_gn_mono_robust",
            "mono_polish": "pose_only_gn_mono"}[kind]
    out = getattr(TPG, name + suffix)(*torch_inputs(kind, p), torch.eye(4), params)
    return out if kind != "mono_polish" else (out, None)


@pytest.fixture(scope="module")
def host_lib():
    """The kernel's algorithm as one host thread: csrc/pose_gn_host.cpp and
    pose_gn.cuh compiled with g++ into build/kernels/ (named by their hash)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's host version")
    h = hashlib.sha1(HOST_SRC.read_bytes() + (KN.CSRC / "pose_gn.cuh").read_bytes()).hexdigest()[:12]
    so = KN.BUILD_DIR / f"libpose_gn_host_{h}.so"
    if not so.exists():
        KN.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = KN.BUILD_DIR / f"libpose_gn_host_{h}.{os.getpid()}.tmp.so"
        cmd = [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(HOST_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.pose_gn_host.argtypes = [ctypes.c_void_p]
    lib.pose_gn_host.restype = ctypes.c_int
    return lib


def host_solve(lib, kind, p, prm):
    """The kernel's algorithm on CPU tensors, through the port's own `_pack`."""
    params = TPG.PoseGNParams(**prm)
    a = torch_inputs(kind, p)
    if kind == "stereo_robust":
        X0, pl, pr, vl, vr, fx, fy, cx, cy, T_rl = a
    else:
        (X0, pl, vl, fx, fy, cx, cy), pr, vr, T_rl = a, None, None, None
    passes = 1 if kind == "mono_polish" else 2
    T_init = torch.eye(4)  # held: `args` points at it
    res, err, args = TPG._pack(X0, pl, pr, vl, vr, T_rl, T_init, fx, fy, cx, cy, params, passes, 2.0)
    assert lib.pose_gn_host(ctypes.byref(args)) == 0
    return res, err


def N_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def assert_same_solve(got, want, case):
    (rg, eg), (rw, ew) = got, want
    assert bool(rg.ok) == bool(rw.ok), case
    # Same GN iterates; the 6x6 normal sums accumulate in another order.
    np.testing.assert_allclose(N_(rg.T10), N_(rw.T10), atol=5e-5, err_msg=case)
    np.testing.assert_array_equal(N_(rg.inliers), N_(rw.inliers), err_msg=case)
    np.testing.assert_allclose(N_(rg.mean_err), N_(rw.mean_err), rtol=1e-3, err_msg=case)
    if ew is not None:
        np.testing.assert_allclose(N_(eg), N_(ew), rtol=1e-3, atol=1e-3, err_msg=case)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_pose_layer_matches_jax_and_the_kernels_algorithm(kind, case, host_lib):
    kw, prm = CASES[case]
    p = problem(**kw)
    want = jax_solve(kind, p, prm)
    ref = torch_solve(kind, p, prm, "_ref")
    assert_same_solve(ref, want, f"{kind}/{case}: plain vs JAX")
    host = host_solve(host_lib, kind, p, prm)
    assert_same_solve(host, ref, f"{kind}/{case}: kernel algorithm vs plain")
    n = [int(r[0].n_iter) for r in (want, ref, host)]
    if case == "max_iters":
        assert n == [{"mono_polish": 100}.get(kind, 200)] * 3, n
    elif case == "cholesky_fails" and kind == "mono_polish":
        assert n == [1, 1, 1] and not bool(ref[0].ok), n  # stopped by `bad` at the first step
    elif case == "all_invalid":
        assert not bool(ref[0].ok) and not N_(ref[0].inliers).any()
    else:  # the |step| < step_tol stop may move by an iteration with the sum order
        assert max(n) - min(n) <= 2, n


@pytest.mark.parametrize("kind", KINDS + ("stereo_polish",))
def test_public_functions_run_the_plain_version_on_cpu(kind):
    """On CPU tensors each public function is its `*_ref`, bit for bit, and
    launches nothing."""
    p = problem()
    prm = {}
    KN.reset_launch_counts()
    if kind == "stereo_polish":
        a = torch_inputs("stereo_robust", p)
        got = (TPG.pose_only_gn_stereo(*a, torch.eye(4)), None)
        ref = (TPG.pose_only_gn_stereo_ref(*a, torch.eye(4)), None)
    else:
        got, ref = torch_solve(kind, p, prm), torch_solve(kind, p, prm, "_ref")
    assert KN.LAUNCHES["pose_gn"] == 0
    for a, b in zip(got[0], ref[0]):
        assert torch.equal(a, b)
    assert (got[1] is None and ref[1] is None) or torch.equal(got[1], ref[1])


def test_public_functions_check_their_inputs():
    t = {k: torch.as_tensor(v) for k, v in problem().items()}
    args = (t["X0"], t["pl"], t["vl"], FX, FY, CX, CY)
    with pytest.raises(TypeError):
        TPG.pose_only_gn_mono(t["X0"].double(), *args[1:], torch.eye(4))
    with pytest.raises(ValueError):
        TPG.pose_only_gn_mono(*args[:2], t["vl"][:-1], *args[3:], torch.eye(4))
    with pytest.raises(ValueError):
        TPG.pose_only_gn_mono_robust(t["X0"].T.contiguous().T, *args[1:], torch.eye(4))
    with pytest.raises(ValueError):
        TPG.pose_only_gn_stereo_robust(t["X0"], t["pl"], t["pr"], t["vl"], t["vr"], FX, FY, CX, CY,
                                       t["T_rl"][:3], torch.eye(4))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_count_the_work_a_solve_needs(kind):
    """`counts` (what chip_smoke.py's bound reads): each pass's valid points
    times its iterations, N points per final evaluation, N for the gate."""
    p = problem()
    a, params = torch_inputs(kind, p), TPG.PoseGNParams()
    rows = "stereo" if kind == "stereo_robust" else "mono"
    name = {"stereo_robust": "pose_only_gn_stereo_robust", "mono_robust": "pose_only_gn_mono_robust",
            "mono_polish": "pose_only_gn_mono"}[kind]
    work = {}
    out = getattr(TPG, name + "_ref")(*a, torch.eye(4), params, counts=work)
    res = out if kind == "mono_polish" else out[0]
    vl = torch.as_tensor(p["vl"])
    if kind == "mono_polish":
        assert work == {"pose_point_iter_mono": int(vl.sum()) * int(res.n_iter), "pose_point_eval_mono": N}
        return
    one = TPG.pose_only_gn_stereo_ref if rows == "stereo" else TPG.pose_only_gn_mono_ref
    res1 = one(*a, torch.eye(4), params)
    T1 = torch.where(res1.ok, res1.T10, torch.eye(4))
    keep = vl & (TPG._reproj_err_px(T1, a[0], a[1], FX, FY, CX, CY) < 2.0 * params.reproj_thresh)
    n1, n2 = int(res1.n_iter), int(res.n_iter) - int(res1.n_iter)
    assert 0 < int(keep.sum()) < int(vl.sum()) and n2 > 0
    assert work == {f"pose_point_iter_{rows}": int(vl.sum()) * n1 + int(keep.sum()) * n2,
                    f"pose_point_eval_{rows}": 2 * N, "pose_point_gate": N}
