#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`visual_odometry_ros_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero before
the final line):
  1. environment: torch / CUDA versions, the card's name and power limit;
     every world below is rendered in one process pool;
  2. build: compiles csrc/klt.cu with nvcc for sm_90a into build/kernels/;
  3. kernels: `klt_pyr` one level at a time (2-D and epi1d, all three
     pyramid level sizes), as the fused forward climb (N = 1024) and as the
     bidirectional epi1d climb (N = 512), and `klt_scale` (s = 1, s in
     [0.9, 1.12], s = 0.5 and s = 2) on KITTI-size corridor frames, each
     against its plain PyTorch version on the same inputs; then, at the
     main path's four KLT call sites (track climb, scale, stereo,
     replenish), one launch per call asserted, device time per launch (C
     launcher alone, back to back), host time per call, the plain version's
     time and the bound from this run's work counts;
  4. per-frame path: `StereoVO(cfg, device="cuda")` at the bench.py
     configuration over 1 + 18 frames of the bench corridor at 0.25 m/frame
     through `track_stereo_images`; times steady and keyframe steps and
     counts KLT launches frame by frame;
  5. per-stage times: 6 more frames of the same run with `timed=True`;
     checks kernel launches, BA keyframes and the 25-frame trajectory error;
  6. serving path: bench.py's workload -- the corridor at bench.py's
     0.8 m/frame, 1 + 24 uint8 frames through `track_stereo_batch` in two
     calls (1 + 12, then 12); tracking-loss recovery must fire; checks
     launches, trajectory error and post-recovery RPE against the JAX
     package's CPU run, and times the batch calls;
  7. rectification: the same tracker and map configuration with
     `flagDoUndistortion=True` on the 640x480 plane world rendered through
     radtan-distorted lenses, 1 + 8 frames at 0.22 m/frame through
     `track_stereo_batch`.
Every path is driven with the kernel launch counts set to 0 just before it
and read just after. The last two lines are the kernel table (launches of
the serving path) and {"ok": true, "device": ...}. This script imports no
JAX.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FEAT = 1024

# Kernel vs plain version, same inputs. Only the summation order (warp
# shuffle tree vs PyTorch reductions) and FMA contraction differ, so the two
# agree to float32 rounding except where rounding moves the |step| < eps
# stop test by one iteration (an extra step is < eps = 0.03 px) or tips a
# feature across a gate threshold.
TOL_MEDIAN_PX = 1e-3  # median |dp| over features live in both
TOL_FAR_PX = 0.05  # a jointly-live feature farther apart than this is "divergent"
TOL_FAR_SHARE = 0.005  # at most 0.5% divergent features
TOL_FLAG_AGREE = 0.995  # live/ok flags agree on at least 99.5% of features

# Per-frame path: the bench corridor at 0.25 m/frame, 1 + 24 frames, of which
# the last N_TIMED run with timed=True. ATE bound: the JAX package's CPU run
# over the same 25 frames cropped to the central 620 columns (cx shifted,
# 512 tracks -- the full-width run is too large for a CPU check) scored
# 0.01042 m; the port's plain leg matched it to 1e-6 m. Bound: 3x that.
STEP_MAIN = 0.25
N_MAIN = 25
N_TIMED = 6
ATE_BOUND_M = 0.03

# Serving path: bench.py's step and batch (bench.py:27,59), 1 + 24 frames.
# At 0.8 m/frame the pose fails from the first tracked frame and recovery
# fires, in the JAX package as in the port. Bounds: 3x the JAX package's CPU
# run on the same 25 frames cropped as above (track_stereo_batch, 1 + 12 then
# 12): ATE 10.4508 m; RPE over the frames from its last recovery (frame 19)
# on, 0.4487 m and 0.2203 deg per frame.
STEP_BENCH = 0.8
N_BENCH = 25
ATE_BENCH_BOUND_M = 3 * 10.4508
RPE_POST_BOUND = (3 * 0.4487, 3 * 0.2203)  # (m, deg) per frame

# Rectification: the world, lenses, step and bound of
# tests/test_stereo_vo_pipeline.py's distorted run (radtan on both lenses,
# the 640x480 plane world, 0.22 m/frame, ATE < 5% of the distance), 1 + 8
# frames, with the bench configuration's tracks, arena, window and tracker.
# The bench corridor is not used here: at its full 1241-column width the
# pose fails on the first tracked frame once N is cut to 512, distorted or
# not, in the JAX package as in the port (CPU runs), and the rectified run
# at N = 1024 lost 1.1 m over 2 m on the card.
DIST = (-0.28, 0.07, 1e-4, -1e-4, 0.0)
STEP_DIST = 0.22
N_DIST = 9
ATE_DIST_BOUND_M = 0.05 * STEP_DIST * (N_DIST - 1)


# Bounds (least device time for a call's work): the fp32 operations the
# function needs per unit of work (add, mul, min/max, floor, compare; a fused
# multiply-add counts 2), counted from the plain versions' formulas, not from
# what one kernel happens to do, times the units this run's data needs
# (`counts` of the plain versions: templates built, Gauss-Newton steps
# taken, residuals evaluated), over 67 TFLOP/s; bytes: every input read once
# and every output written once, over 3.35 TB/s (NVIDIA H100 SXM data sheet,
# at 700 W). A window's points, cells and masks are separable, so they are
# counted once per window line (row or column); klt_pyr's offsets are
# integers, so its window shares one bilinear fraction (weights computed
# once: a sample is a mul and three FMAs) and its gradients are needed on
# the (S+1)^2 lattice only. Per-feature work (the 2x2 solve, the stop test,
# the gates) and Scharr's smoothing ring are left out: under 1% of a call.
OPS = {
    "template_px": 31,  # three samples (value, gx, gy) 21, mask 1, Hessian sums 9
    "lattice_px": 10,  # Scharr gx, gy: a 3-tap smooth 4 and a difference 1 each
    "step_px": 14,  # sample 7, mask 1, residual 2, two accumulations 4
    "err_px": 13,  # sample 7, mask 1, |residual| into the sum 4, mask sum 1
    "line": 7,  # point 1, clamp 2, floor 1, cell clamp 1, inside test 2
    "bank_px": 9,  # a sample with its own fraction: three lerps
    "scale_template_px": 20,  # Scharr on the bank 10, mask 1, Hessian sums 9
    "scale_step_px": 16,  # sample 9, then as step_px
    "scale_err_px": 15,  # sample 9, then as err_px
    "scale_line": 9,  # point (FMA) 2, clamp 2, floor 1, cell clamp 1, fraction 1, inside test 2
}
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(counts: dict, n_bytes: int) -> tuple:
    """(bound_ms, bound_by) of one call from its work counts and bytes."""
    ops = sum(OPS[k] * v for k, v in counts.items())
    t_ops, t_bytes = ops / PEAK_FP32, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bench_config():
    """bench.py:31-50 — KITTI-size stereo, 1024 tracks, 3 pyramid levels."""
    from visual_odometry_ros_tpu_torch.io import VOConfig

    cfg = VOConfig()
    cfg.cam_right = cfg.cam
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = 0.5371657
    cfg.T_lr = T_lr
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = N_FEAT
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 9
    cfg.keyframe.thres_translation = 4.0
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    return cfg


@functools.lru_cache(maxsize=None)
def _world(kind: str):
    """(world, poses) of one run: "main" is the corridor at 0.25 m/frame,
    "bench" bench.py's at 0.8 m/frame (bench.py:53-76: a corridor fit around
    the trajectory), "distorted" the plane world through radtan lenses."""
    from visual_odometry_ros_tpu_torch.io import (
        CorridorSequence,
        DistortedStereoSequence,
        PlaneSequence,
        forward_trajectory,
    )

    if kind == "distorted":
        plane = PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
        return (DistortedStereoSequence(plane, np.asarray(DIST)),
                forward_trajectory(N_DIST, step=STEP_DIST, yaw_rate=0.0015))
    step, n = (STEP_BENCH, N_BENCH) if kind == "bench" else (STEP_MAIN, N_MAIN)
    poses = forward_trajectory(n, step=step, yaw_rate=0.0015)
    world = CorridorSequence.fit(
        poses, width=1241, height=376, fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        baseline=0.5371657, wall_tex_size=256, wall_tex_scale=40.0,
    )
    return world, poses


def render_pair(job):
    """Frame i of world `kind` as camera-native uint8 (left, right)."""
    kind, i = job
    world, poses = _world(kind)
    l, r = world.stereo_pair(poses[i].astype(np.float64))
    return np.clip(l, 0, 255).astype(np.uint8), np.clip(r, 0, 255).astype(np.uint8)


def make_frames():
    """{kind: (uint8 left [n, H, W], uint8 right, poses)} for every run."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    sizes = {"main": N_MAIN, "bench": N_BENCH, "distorted": N_DIST}
    jobs = [(k, i) for k, n in sizes.items() for i in range(n)]
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        pairs = list(ex.map(render_pair, jobs))
    out = {}
    for k, n in sizes.items():
        mine = [p for (kind, _), p in zip(jobs, pairs) if kind == k]
        out[k] = (np.stack([l for l, _ in mine]), np.stack([r for _, r in mine]), _world(k)[1][:n])
    return out


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() on the device, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(launches, reps=100, warmup=5):
    """Device milliseconds of one pass over `launches` (C launcher calls on
    preallocated outputs): `reps` passes back to back between two CUDA
    events, queued behind a spin kernel so that the host's enqueue time
    stays off the device's clock. Inputs stay warm in L2, as on the main
    path."""
    import torch

    for _ in range(warmup):
        for fn, argv in launches:
            fn(*argv)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of spinning covers the enqueue
    a.record()
    for _ in range(reps):
        for fn, argv in launches:
            fn(*argv)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps=50):
    """Host microseconds per call of fn(): perf_counter around `reps` calls,
    no synchronise inside (the enqueue cost the Python caller pays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def recorded_launches(fn):
    """Run fn() once. Returns the C launcher calls it made, [(name, c_fn,
    argv)], and the launch helpers' inputs and outputs: the tensors behind
    argv's pointers, which the caller holds while it replays argv."""
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    calls, tensors = [], []
    orig = {k: getattr(KK, k) for k in ("_launch", "_pyr_launch", "_scale_launch")}

    def rec(name, c_fn, argv):
        calls.append((name, c_fn, argv))
        return orig["_launch"](name, c_fn, argv)

    def holding(helper):
        def run(*args):
            out = orig[helper](*args)
            tensors.append((args, out))
            return out
        return run

    KK._launch = rec
    KK._pyr_launch, KK._scale_launch = holding("_pyr_launch"), holding("_scale_launch")
    try:
        fn()
    finally:
        for k, v in orig.items():
            setattr(KK, k, v)
    return calls, tensors


def klt_call_sites(pairs, dev):
    """The main path's KLT call sites at the bench configuration, on frames
    10 -> 11 of the 0.25 m/frame corridor (N = 1024; 512 for replenish):
    {name: {call, wrapper, plain, bytes}}: the call as the main path makes
    it, its kernel's wrapper alone and the plain version (taking a `counts`
    dict) on the same inputs, and the bytes the kernel must move.
    Parameters come from StereoVO."""
    import torch

    from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO
    from visual_odometry_ros_tpu_torch.ops import klt as KLT
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    vo = StereoVO(bench_config(), device=dev)
    up = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    img_a, img_b, img_r = up(pairs[10][0]), up(pairs[11][0]), up(pairs[11][1])
    pyr_a, pyr_b, pyr_r = vo._build_pyr(img_a), vo._build_pyr(img_b), vo._build_pyr(img_r)
    lv_a, lv_b, lv_r = ([lv[0] for lv in pyr] for pyr in (pyr_a, pyr_b, pyr_r))
    H, W = img_a.shape
    gy, gx = np.meshgrid(np.linspace(12, H - 13, 32), np.linspace(12, W - 13, 32), indexing="ij")
    p = up(np.stack([gx.ravel(), gy.ravel()], -1))
    rng = np.random.default_rng(0)
    seed = (p + up(rng.uniform(-2, 2, p.shape))).contiguous()
    sc = up(rng.uniform(0.9, 1.12, len(p)))
    valid = torch.ones(len(p), dtype=torch.bool, device=dev)
    disp = torch.tensor([8.0, 0.0], device=dev)
    kp, kpe, cfg_t = vo.klt_params, vo.klt_params_epi, vo.cfg.tracker
    p1, ok = KLT.track_with_prior_pyr(pyr_a, pyr_b, p, seed, valid, kp)
    p1s = (p1 - disp).contiguous()
    half = p[: len(p) // 2].contiguous()
    half_s = (half - disp).contiguous()
    vh = valid[: len(half)]
    r, it, ic, itx = kp.window_radius, kp.iters, kp.iters_coarse, kpe.iters
    img_bytes = lambda lv: sum(2 * x.numel() * 4 for x in lv)  # noqa: E731
    pt_bytes = lambda n, out: n * (8 + 8 + 1) + n * out  # noqa: E731
    track = (lv_a, lv_b, p, seed, valid, r, it, ic, kp.eps, kp.min_eig)
    stereo = (lv_b[:1], lv_r[:1], p1, p1s, ok, r, itx, itx, kpe.eps, kpe.min_eig, True)
    replenish = (lv_b, lv_r, half, half_s, vh, r, itx, itx, kpe.eps, kpe.min_eig, True, 1)
    scale = (img_a, img_b, p, p1, sc, ok, 11, cfg_t.scale_iter)
    return {
        "track": dict(
            call=lambda: KLT.track_with_prior_pyr(pyr_a, pyr_b, p, seed, valid, kp),
            wrapper=lambda: KK.track_pyr(*track), plain=lambda c: KK.track_pyr_ref(*track, counts=c),
            bytes=img_bytes(lv_a) + pt_bytes(len(p), 8 + 4 + 1)),
        "scale": dict(
            call=lambda: KLT.track_with_scale(img_a, img_a, img_a, img_b, p, p1, sc, ok,
                                              iters=cfg_t.scale_iter, use_kernel=True),
            wrapper=lambda: KK.track_scale(*scale), plain=lambda c: KK.track_scale_ref(*scale, counts=c),
            bytes=2 * img_a.numel() * 4 + pt_bytes(len(p), 4 + 8 + 4 + 1)),
        "stereo": dict(
            call=lambda: KLT.track_with_prior_pyr(pyr_b, pyr_r, p1, p1s, ok, kpe, track_levels=1, epi1d=True),
            wrapper=lambda: KK.track_pyr(*stereo), plain=lambda c: KK.track_pyr_ref(*stereo, counts=c),
            bytes=img_bytes(lv_b[:1]) + pt_bytes(len(p), 8 + 4 + 1)),
        "replenish": dict(
            call=lambda: KLT.track_bidirectional_pyr(pyr_b, pyr_r, half, half_s, vh, kpe, fb_scale=5.0,
                                                     back_levels=1, epi1d=True),
            wrapper=lambda: KK.track_pyr_bidir(*replenish),
            plain=lambda c: KK.track_pyr_bidir_ref(*replenish, counts=c),
            bytes=img_bytes(lv_b) + pt_bytes(len(half), 8 + 4 + 1 + 8 + 1)),
    }


def call_site_times(pairs, dev, card):
    """For each main-path KLT call site: its kernel launches (exactly one),
    device ms per call (the C launcher alone, replayed back to back), host
    us per call of the kernel's wrapper and of the call site, the plain
    version's ms, and the bound from this run's work counts."""
    sites = klt_call_sites(pairs, dev)
    out = {}
    for name, site in sites.items():
        counts = {}
        site["plain"](counts)
        b_ms, b_by = bound(counts, site["bytes"])
        calls, tensors = recorded_launches(site["call"])
        assert len(calls) == 1, f"{name}: {len(calls)} launches per call, expected 1"
        row = {"kernel": calls[0][0], "ms": device_ms([(c[1], c[2]) for c in calls]),
               "bound_ms": b_ms, "bound_by": b_by, "work": counts, "bytes": site["bytes"],
               "plain_ms": cuda_ms(lambda: site["plain"](None), reps=5, warmup=1)}
        del tensors  # held until the replays are done
        row["host_us"] = host_us(site["wrapper"])
        row["call_host_us"] = host_us(site["call"])
        row["bound_share"] = b_ms / row["ms"]
        out[name] = row
    print(json.dumps({"klt_call_sites": out, "card": card}))
    return out


def compare(name, p_k, ok_k, p_r, ok_r):
    """|dp| statistics over features live in both, flag agreement; raises on
    exceeding the tolerances."""
    import torch

    both = ok_k & ok_r
    n_both = int(both.sum())
    dp = torch.linalg.norm(p_k - p_r, dim=-1)[both]
    agree = float((ok_k == ok_r).float().mean())
    res = {
        "case": name,
        "n_live_kernel": int(ok_k.sum()),
        "n_live_plain": int(ok_r.sum()),
        "max_dp_px": float(dp.max()) if n_both else float("nan"),
        "median_dp_px": float(dp.median()) if n_both else float("nan"),
        "far_share": float((dp > TOL_FAR_PX).float().mean()) if n_both else float("nan"),
        "flag_agree": agree,
    }
    print(json.dumps(res))
    if n_both < 0.25 * ok_r.numel():
        raise AssertionError(f"{name}: only {n_both} features live in both")
    if not (res["median_dp_px"] <= TOL_MEDIAN_PX and res["far_share"] <= TOL_FAR_SHARE
            and agree >= TOL_FLAG_AGREE):
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {res}")
    return res


def launched(phase: str) -> dict:
    """The kernel launch counts since the last reset; both kernels must have run."""
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    counts = dict(KK.LAUNCHES)
    for name in ("klt_pyr", "klt_scale"):
        assert counts[name] > 0, f"{phase}: the path never launched {name}"
    return counts


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def per_frame_path(frames, device, card):
    """Phases 4 and 5: the 0.25 m/frame corridor through track_stereo_images,
    the last N_TIMED frames with timed=True."""
    from visual_odometry_ros_tpu_torch.io import ate_rmse
    from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    pairs = list(zip(frames["main"][0], frames["main"][1]))
    poses_main = frames["main"][2]
    vo = StereoVO(bench_config(), device=device)
    kf_ms = []
    orig_kf = vo._keyframe_step

    def timed_kf(state):
        sync(device)
        t = time.perf_counter()
        out = orig_kf(state)
        sync(device)
        kf_ms.append((time.perf_counter() - t) * 1e3)
        return out

    vo._keyframe_step = timed_kf
    replenishes = [0]
    orig_rep = vo._replenish

    def counted_rep(*a, **kw):
        replenishes[0] += 1
        return orig_rep(*a, **kw)

    vo._replenish = counted_rep
    n_plain = N_MAIN - N_TIMED
    KK.reset_launch_counts()
    frame_ms, frame_launches = [], []
    for il, ir in pairs[:n_plain]:
        before = dict(KK.LAUNCHES)
        replenishes[0] = 0
        sync(device)
        t = time.perf_counter()
        vo.track_stereo_images(il, ir)
        sync(device)
        frame_ms.append((time.perf_counter() - t) * 1e3)
        frame_launches.append(dict({k: KK.LAUNCHES[k] - before[k] for k in before},
                                   replenish=replenishes[0]))
    launches = launched("per-frame path")
    tracked = [dict(n, n_new=s["n_new"], recovered=s.get("recovered", 0))
               for s, n in zip(vo.stats_log[1:], frame_launches[1:])]
    kinds = {}
    for n in tracked:
        kind = "replenish" if n["replenish"] else "steady"
        kinds.setdefault(kind, set()).add(json.dumps({k: n[k] for k in KK.LAUNCHES}, sort_keys=True))
    print(json.dumps({"klt_launches_per_frame": {k: sorted(v) for k, v in kinds.items()},
                      "frames": tracked}))
    # A tracked frame: one klt_pyr launch each for the track climb and the
    # stereo pass, one more for each replenish it ran; one klt_scale.
    for n in tracked:
        assert not n["recovered"], f"recovery fired at {STEP_MAIN} m/frame: {n}"
        assert n["klt_scale"] == 1 and n["klt_pyr"] == 2 + n["replenish"], f"KLT launches of a frame: {n}"
    steady = [ms for ms, s in zip(frame_ms[3:], vo.stats_log[3:]) if not s["keyframe"]]
    print(f"time steady frame: median {statistics.median(steady):.2f} ms over {len(steady)} frames; "
          f"keyframe step: median {statistics.median(kf_ms[1:] or kf_ms):.2f} ms over "
          f"{len(kf_ms)} keyframes; first frame {frame_ms[0]:.1f} ms; on {card}")

    KK.reset_launch_counts()
    stage_ms, timed_frame_ms = [], []
    for il, ir in pairs[n_plain:]:
        sync(device)
        t = time.perf_counter()
        _, st = vo.track_stereo_images(il, ir, timed=True)
        sync(device)
        timed_frame_ms.append((time.perf_counter() - t) * 1e3)
        stage_ms.append(st["stage_ms"])
    launched("timed path")
    keys = ("time_track", "time_stereo", "time_pose", "time_new", "time_ba")
    med = {k: statistics.median(d[k] for d in stage_ms if k in d) for k in keys
           if any(k in d for d in stage_ms)}
    print(json.dumps({"stage_ms_median": med, "frames": len(stage_ms),
                      "keyframes": sum("time_ba" in d for d in stage_ms),
                      "frame_ms_median": statistics.median(timed_frame_ms), "card": card}))
    traj = np.stack(vo.trajectory)
    assert traj.shape == (N_MAIN, 4, 4) and np.isfinite(traj).all(), "non-finite trajectory"
    ate = ate_rmse(traj, poses_main, align="none")
    kfs = [s for s in vo.stats_log[1:] if s["keyframe"]]
    n_ba_ok = sum(1 for s in kfs if s["ba_err"] is not None and not s["ba_rejected"])
    print(json.dumps({
        "path": "StereoVO.track_stereo_images", "step_m": STEP_MAIN, "frames": N_MAIN,
        "ate_m": ate, "ate_bound_m": ATE_BOUND_M, "keyframes": len(kfs), "ba_accepted": n_ba_ok,
        "ba_err_px": [s["ba_err"] for s in kfs], "launches": launches,
        "pose_ok": sum(1 for s in vo.stats_log[1:] if s["pose_ok"]),
        "last_n_inliers": vo.stats_log[-1]["n_inliers"],
    }))
    for d in stage_ms:
        assert all(d[k] > 0 for k in keys[:4]), d
    assert n_ba_ok >= 2, f"only {n_ba_ok} accepted BA keyframes"
    assert ate <= ATE_BOUND_M, f"ATE {ate:.4f} m above bound {ATE_BOUND_M:.4f} m"


def serving_path(frames, device, card) -> dict:
    """Phase 6: bench.py's 0.8 m/frame workload through track_stereo_batch.
    Returns its kernel launch counts."""
    from visual_odometry_ros_tpu_torch.io import ate_rmse, rpe
    from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    il, ir, poses = frames["bench"]
    vo = StereoVO(bench_config(), device=device)
    KK.reset_launch_counts()
    batch_s = []
    for a, b in ((0, 13), (13, N_BENCH)):
        sync(device)
        t = time.perf_counter()
        vo.track_stereo_batch(il[a:b], ir[a:b])
        sync(device)
        batch_s.append((b - a, time.perf_counter() - t))
    launches = launched("serving path")
    traj = np.stack(vo.trajectory)
    assert traj.shape == (N_BENCH, 4, 4) and np.isfinite(traj).all(), "non-finite trajectory"
    modes = [s.get("recovered", 0) for s in vo.stats_log]
    rec = [i for i, m in enumerate(modes) if m]
    assert rec, f"recovery never fired at {STEP_BENCH} m/frame: modes {modes}"
    last = rec[-1]
    assert last <= N_BENCH - 3, f"recovered at frame {last}: too few frames after it"
    ate = ate_rmse(traj, poses, align="none")
    rpe_t, rpe_r = rpe(traj[last:], poses[last:])
    print(json.dumps({
        "path": "StereoVO.track_stereo_batch", "step_m": STEP_BENCH, "frames": N_BENCH,
        "batches": [n for n, _ in batch_s], "recovered": modes,
        "pose_ok": [bool(s.get("pose_ok", True)) for s in vo.stats_log],
        "keyframes": [s["frame"] for s in vo.stats_log if s.get("keyframe")],
        "launches": launches, "ate_m": ate, "ate_bound_m": ATE_BENCH_BOUND_M,
        "last_recovery": last, "rpe_post_m_deg": [rpe_t, rpe_r], "rpe_post_bound": RPE_POST_BOUND,
    }))
    print("time serving path: " + "; ".join(f"batch of {n}: {n / sec:.2f} frames/s ({sec * 1e3:.1f} ms)"
                                            for n, sec in batch_s)
          + f"; synchronised host clock, the first batch holds the bootstrap frame; on {card}")
    assert ate <= ATE_BENCH_BOUND_M, f"ATE {ate:.3f} m above bound {ATE_BENCH_BOUND_M:.3f} m"
    assert rpe_t <= RPE_POST_BOUND[0] and rpe_r <= RPE_POST_BOUND[1], (
        f"post-recovery RPE {rpe_t:.4f} m / {rpe_r:.4f} deg above {RPE_POST_BOUND}")
    return launches


def rectification_path(frames, device, card):
    """Phase 7: distorted lenses, flagDoUndistortion=True, track_stereo_batch."""
    from visual_odometry_ros_tpu_torch.io import ate_rmse
    from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    il, ir, poses = frames["distorted"]
    cfg = bench_config()
    c = cfg.cam
    c.width, c.height, c.fx, c.fy, c.cx, c.cy = 640, 480, 500.0, 500.0, 320.0, 240.0
    c.k1, c.k2, c.p1, c.p2, c.k3 = DIST
    cfg.cam_right = c
    cfg.T_lr[0, 3] = 0.5
    cfg.flagDoUndistortion = True
    vo = StereoVO(cfg, device=device)
    KK.reset_launch_counts()
    sync(device)
    t = time.perf_counter()
    vo.track_stereo_batch(il, ir)
    sync(device)
    sec = time.perf_counter() - t
    launches = launched("rectification path")
    traj = np.stack(vo.trajectory)
    assert traj.shape == (N_DIST, 4, 4) and np.isfinite(traj).all(), "non-finite trajectory"
    ate = ate_rmse(traj, poses, align="none")
    print(json.dumps({
        "path": "StereoVO.track_stereo_batch, flagDoUndistortion", "step_m": STEP_DIST,
        "frames": N_DIST, "dist": DIST, "rect_fx_cx_cy": [vo.fx, vo.cx, vo.cy],
        "ate_m": ate, "ate_bound_m": ATE_DIST_BOUND_M, "launches": launches,
        "pose_ok": sum(1 for s in vo.stats_log[1:] if s["pose_ok"]),
        "recovered": [s.get("recovered", 0) for s in vo.stats_log],
        "batch_ms": sec * 1e3, "card": card,
    }))
    assert ate <= ATE_DIST_BOUND_M, f"ATE {ate:.4f} m above bound {ATE_DIST_BOUND_M:.4f} m"


def main() -> int:
    import torch

    # 1. environment -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK
    from visual_odometry_ros_tpu_torch.ops.pyramid import build_pyramid

    card = gpu_name_power()
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(card)

    t0 = time.perf_counter()
    frames = make_frames()
    print(f"data: {sum(len(v[0]) for v in frames.values())} stereo pairs "
          f"({', '.join(f'{k} {v[0].shape}' for k, v in frames.items())}) rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    pairs = list(zip(frames["main"][0], frames["main"][1]))

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    KK.build()
    regs = [ln.strip() for ln in KK.BUILD_INFO.get("ptxas", "").splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s -> {KK.BUILD_INFO['library']}; ptxas: {regs}")

    # 3. kernels against their plain versions, main-path shapes --------------
    dev = torch.device("cuda")
    f0, f1 = 10, 11
    img_l0 = torch.as_tensor(pairs[f0][0], dtype=torch.float32, device=dev)
    img_r0 = torch.as_tensor(pairs[f0][1], dtype=torch.float32, device=dev)
    img_l1 = torch.as_tensor(pairs[f1][0], dtype=torch.float32, device=dev)
    pyr0 = build_pyramid(img_l0, 3)
    pyr1 = build_pyramid(img_l1, 3)
    H, W = img_l0.shape
    gy, gx = np.meshgrid(np.linspace(12, H - 13, 32), np.linspace(12, W - 13, 32), indexing="ij")
    p_grid = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1), dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    noise = (torch.rand((N_FEAT, 2), generator=gen) * 4.0 - 2.0).to(dev)
    valid = torch.ones(N_FEAT, dtype=torch.bool, device=dev)
    radius, iters = 10, 15
    cases = {"klt_pyr": [], "klt_scale": []}
    for lvl in range(3):
        s = 2.0**lvl
        p0 = (p_grid / s).contiguous()
        p1 = (p0 + noise / s).contiguous()
        a, b = pyr0[lvl], pyr1[lvl]
        args = (a, b, p0, p1, valid, radius, iters, 0.03, 1e-4, False)
        k = KK.track_level(*args)
        r = KK.track_level_ref(*args)
        cases["klt_pyr"].append(compare(f"level{lvl}_2d", k[0], k[1], r[0], r[1]))
    # epi1d: left -> right along the row from a constant 8 px disparity seed.
    pr0 = build_pyramid(img_r0, 3)
    for lvl in range(3):
        s = 2.0**lvl
        p0 = (p_grid / s).contiguous()
        seed = (p0 - torch.tensor([8.0 / s, 0.0], device=dev)).contiguous()
        args = (pyr0[lvl], pr0[lvl], p0, seed, valid, radius, 8, 0.03, 1e-4, True)
        k = KK.track_level(*args)
        r = KK.track_level_ref(*args)
        cases["klt_pyr"].append(compare(f"level{lvl}_epi1d", k[0], k[1], r[0], r[1]))
    # The fused climb at main-path shapes: the track stage's forward climb
    # (N = 1024, 3 levels, 15/6 iterations) and replenish's bidirectional
    # epi1d climb (N = 512, 3 levels forward, 1 back, 8 iterations).
    seed = (p_grid + noise).contiguous()
    args = (list(pyr0), list(pyr1), p_grid, seed, valid, radius, iters, 6)
    k, r = KK.track_pyr(*args), KK.track_pyr_ref(*args)
    cases["klt_pyr"].append(compare("climb_2d", k[0], k[1], r[0], r[1]))
    half = p_grid[: N_FEAT // 2].contiguous()
    seed = (half - torch.tensor([8.0, 0.0], device=dev)).contiguous()
    args = (list(pyr1), list(pr0), half, seed, valid[: N_FEAT // 2], radius, 8, 8, 0.03, 1e-4, True)
    k = KK.track_pyr_bidir(*args, back_levels=1)
    r = KK.track_pyr_bidir_ref(*args, back_levels=1)
    cases["klt_pyr"].append(compare("climb_bidir_epi1d_fwd", k[0], k[1], r[0], r[1]))
    cases["klt_pyr"].append(compare("climb_bidir_epi1d_back", k[3], k[4], r[3], r[4]))
    # scale: seeded by the forward level-0 track, s = 1, s in [0.9, 1.12]
    # (the corridor's range), and the clip limits 0.5 and 2.
    seed, ok_seed, _, _ = KK.track_level(pyr0[0], pyr1[0], p_grid, (p_grid + noise).contiguous(),
                                         valid, radius, iters)
    for tag, sc in (("s1", torch.ones(N_FEAT)),
                    ("s_corridor", 0.9 + 0.22 * torch.rand(N_FEAT, generator=gen)),
                    ("s0.5", torch.full((N_FEAT,), 0.5)), ("s2", torch.full((N_FEAT,), 2.0))):
        args = (img_l0, img_l1, p_grid, seed.contiguous(), sc.to(dev), ok_seed, 11, 12, 0.01)
        k = KK.track_scale(*args)
        r = KK.track_scale_ref(*args)
        cases["klt_scale"].append(compare(f"scale_{tag}", k[0], k[2], r[0], r[2]))
    torch.cuda.synchronize()
    sites = call_site_times(pairs, dev, card)
    timing = {
        "klt_pyr": sites["track"],
        "klt_scale": sites["scale"],
    }
    for name, row in timing.items():
        print(f"time {name}: device {row['ms']:.4f} ms per launch (100 back-to-back launches), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}, plain {row['plain_ms']:.4f} ms, wrapper host "
              f"{row['host_us']:.1f} us per call (N={N_FEAT}) on {card}")

    # 4.-7. the paths -------------------------------------------------------
    per_frame_path(frames, dev, card)
    launches = serving_path(frames, dev, card)
    rectification_path(frames, dev, card)

    # 8. result ------------------------------------------------------------
    replaces = {
        "klt_pyr": "visual_odometry_ros_tpu/ops/klt_pallas_fp.py:380",
        "klt_scale": "visual_odometry_ros_tpu/ops/klt_pallas_fp.py:621",
    }
    table = {"kernels": [
        {
            "name": name, "route": "cuda", "source": "visual_odometry_ros_tpu_torch/csrc/klt.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(c["max_dp_px"] for c in cases[name]),
            "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
            "library_ms": None, "host_ms": timing[name]["host_us"] * 1e-3,
        }
        for name in ("klt_pyr", "klt_scale")
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
