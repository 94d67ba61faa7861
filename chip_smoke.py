#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`visual_odometry_ros_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero before
the final line):
  1. environment: torch / CUDA versions, the card's name and power limit;
     every world below is rendered in one process pool;
  2. build: compiles csrc/klt.cu with nvcc for sm_90a into build/kernels/;
  3. kernels: `klt_level` (2-D and epi1d, all three pyramid level sizes) and
     `klt_scale` (s = 1 and s != 1) on KITTI-size corridor frames with
     N = 1024 features, each against its plain PyTorch version on the same
     inputs, with CUDA-event timings of both;
  4. per-frame path: `StereoVO(cfg, device="cuda")` at the bench.py
     configuration over 1 + 18 frames of the bench corridor at 0.25 m/frame
     through `track_stereo_images`; times steady and keyframe steps;
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
    for name in ("klt_level", "klt_scale"):
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
    n_plain = N_MAIN - N_TIMED
    KK.reset_launch_counts()
    frame_ms = []
    for il, ir in pairs[:n_plain]:
        sync(device)
        t = time.perf_counter()
        vo.track_stereo_images(il, ir)
        sync(device)
        frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = launched("per-frame path")
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
    cases = {"klt_level": [], "klt_scale": []}
    timing = {}
    for lvl in range(3):
        s = 2.0**lvl
        p0 = (p_grid / s).contiguous()
        p1 = (p0 + noise / s).contiguous()
        a, b = pyr0[lvl], pyr1[lvl]
        args = (a, b, p0, p1, valid, radius, iters, 0.03, 1e-4, False)
        k = KK.track_level(*args)
        r = KK.track_level_ref(*args)
        cases["klt_level"].append(compare(f"level{lvl}_2d", k[0], k[1], r[0], r[1]))
        if lvl == 0:
            timing["klt_level"] = (cuda_ms(lambda: KK.track_level(*args)),
                                   cuda_ms(lambda: KK.track_level_ref(*args)))
    # epi1d: left -> right along the row from a constant 8 px disparity seed.
    for lvl in range(3):
        s = 2.0**lvl
        p0 = (p_grid / s).contiguous()
        seed = (p0 - torch.tensor([8.0 / s, 0.0], device=dev)).contiguous()
        pr0 = build_pyramid(img_r0, 3)
        args = (pyr0[lvl], pr0[lvl], p0, seed, valid, radius, 8, 0.03, 1e-4, True)
        k = KK.track_level(*args)
        r = KK.track_level_ref(*args)
        cases["klt_level"].append(compare(f"level{lvl}_epi1d", k[0], k[1], r[0], r[1]))
    # scale: seeded by the forward level-0 track, s = 1 and s in [0.9, 1.12].
    seed, ok_seed, _, _ = KK.track_level(pyr0[0], pyr1[0], p_grid, (p_grid + noise).contiguous(),
                                         valid, radius, iters)
    for tag, sc in (("s1", torch.ones(N_FEAT)),
                    ("s_corridor", 0.9 + 0.22 * torch.rand(N_FEAT, generator=gen))):
        sc = sc.to(dev)
        args = (img_l0, img_l1, p_grid, seed.contiguous(), sc, ok_seed, 11, 12, 0.01)
        k = KK.track_scale(*args)
        r = KK.track_scale_ref(*args)
        cases["klt_scale"].append(compare(f"scale_{tag}", k[0], k[2], r[0], r[2]))
        if tag == "s_corridor":
            timing["klt_scale"] = (cuda_ms(lambda: KK.track_scale(*args)),
                                   cuda_ms(lambda: KK.track_scale_ref(*args)))
    torch.cuda.synchronize()
    for name, (ms, plain) in timing.items():
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms (N={N_FEAT}, level 0, "
              f"median of 20 CUDA-event timings) on {card}")

    # 4.-7. the paths -------------------------------------------------------
    per_frame_path(frames, dev, card)
    launches = serving_path(frames, dev, card)
    rectification_path(frames, dev, card)

    # 8. result ------------------------------------------------------------
    replaces = {
        "klt_level": "visual_odometry_ros_tpu/ops/klt_pallas_fp.py:380",
        "klt_scale": "visual_odometry_ros_tpu/ops/klt_pallas_fp.py:621",
    }
    table = {"kernels": [
        {
            "name": name, "route": "cuda", "source": "visual_odometry_ros_tpu_torch/csrc/klt.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(c["max_dp_px"] for c in cases[name]),
            "ms": timing[name][0], "plain_ms": timing[name][1],
        }
        for name in ("klt_level", "klt_scale")
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
