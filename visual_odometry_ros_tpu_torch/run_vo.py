"""VO driver CLI of the PyTorch + CUDA port: the counterpart of
scripts/run_vo.py, which replaces the reference ROS nodes
(ros1/visual_odometry/node_{mono,stereo}_vo.cpp + launch files).

Examples:
  # KITTI stereo sequence with calib from the dataset, on the card
  python -m visual_odometry_ros_tpu_torch.run_vo --dataset kitti --root /data/kitti_odom \\
      --seq 00 --mode stereo --out out/kitti00

  # Synthetic smoke run (no dataset needed) on the CPU
  python -m visual_odometry_ros_tpu_torch.run_vo --dataset synthetic --frames 30 \\
      --mode stereo --out out/syn --device cpu

  # EuRoC mono with a reference-format YAML config
  python -m visual_odometry_ros_tpu_torch.run_vo --dataset euroc --root /data/MH_01 \\
      --mode mono --config config/mono/euroc_mav.yaml --out out/mh01

Outputs (reference trajectory-dump parity, mono_vo.cpp:64-127):
  <out>/frame_poses.txt     13-column KITTI-format all-frame trajectory
  <out>/keyframe_poses.txt  keyframe subset
  <out>/stats.jsonl         per-frame statistics records
  <out>/trajectory.png      top-down plot (with GT when available); needs
                            matplotlib, and is the one output skipped, with
                            a line saying so, where it is not installed
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import signal
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["kitti", "euroc", "synthetic"], required=True)
    p.add_argument("--root", default=None, help="dataset root directory")
    p.add_argument("--seq", default="00", help="KITTI sequence id")
    p.add_argument("--mode", choices=["mono", "stereo"], default="stereo")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--frames", type=int, default=None, help="limit frame count")
    p.add_argument("--out", default="out/run")
    p.add_argument("--device", default="cuda", help="torch device of the pipeline (cuda, cuda:1, cpu)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run (the pipelines' stage spans, "
                        "CUDA activity on the card) to DIR/trace.json")
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="serving path: B frames per device call (0 = per-frame)")
    p.add_argument("--stage-timing", action="store_true",
                   help="per-stage timing in stats.jsonl (statisticsStamped time_track/1p/pose/new/ba "
                        "fields; slower: a device sync per stage)")
    p.add_argument("--debug-images", action="store_true",
                   help="write per-frame tracking overlays to <out>/debug/ (showTracking analog, "
                        "mono_vo.cpp:392-475)")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def build_dataset(args):
    from .config import VOConfig, load_yaml

    if args.dataset == "kitti":
        from .io.datasets import KittiOdometry

        ds = KittiOdometry(args.root, args.seq)
        cfg = load_yaml(args.config) if args.config else ds.config()
        return ds, cfg, ds.gt_poses
    if args.dataset == "euroc":
        from .io.datasets import EurocMav

        ds = EurocMav(args.root, stereo=(args.mode == "stereo"))
        if args.config is None:
            raise SystemExit("--config YAML is required for EuRoC (distorted cameras)")
        cfg = load_yaml(args.config)
        gt = None if ds.gt is None else ds.gt[1]
        return ds, cfg, gt
    from .io.synthetic import TwoPlaneSequence, forward_trajectory

    n = args.frames or 30
    # Keep the whole trajectory comfortably in front of the near plane: at
    # 0.25 m/frame the camera reaches the default z0_a=9 m plane by frame 36
    # and the chirality guard (correctly) aborts the render.
    step = 0.25
    z_needed = step * n + 4.0
    world = TwoPlaneSequence(z0_a=max(9.0, z_needed), z0_b=max(18.0, 2.0 * z_needed))
    poses = forward_trajectory(n, step=step, yaw_rate=0.002, lateral=0.1 if args.mode == "mono" else 0.0)

    def it():
        for i, T in enumerate(poses):
            l, r = world.stereo_pair(T.astype(np.float64))
            yield i * 0.1, l, r

    cfg = VOConfig()
    cfg.cam.fx = cfg.cam.fy = world.a.fx
    cfg.cam.cx, cfg.cam.cy = world.a.cx, world.a.cy
    cfg.cam.width, cfg.cam.height = world.width, world.height
    cfg.cam_right = cfg.cam
    cfg.T_lr = np.eye(4, dtype=np.float32)
    cfg.T_lr[0, 3] = world.a.baseline
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = 512
    cfg.extractor.score_min = 10.0
    cfg.extractor.thres_fastscore = 8.0
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 7
    cfg.keyframe.thres_translation = 1.0
    if args.mode == "mono":
        cfg.map.thres_parallax = 0.4
        cfg.keyframe.thres_translation = 1e9
        cfg.keyframe.thres_overlap_ratio = 0.75
    return it(), cfg, poses


@contextlib.contextmanager
def device_trace(out_dir: str, device):
    """torch.profiler over the block (CUDA activity on a card), with the
    pipelines' stage spans on (`vo.entry`, `vo.track`, ... above the kernels),
    written as a Chrome trace to out_dir/trace.json when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .utils import timer

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with timer.tracing(True), profile(activities=acts) as prof:
        yield prof
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def main(argv=None):
    args = parse_args(argv)

    # Explicit SIGINT -> KeyboardInterrupt, even when the inherited
    # disposition is SIG_IGN (non-interactive shells start background jobs
    # that way, and Python then skips its default handler), so the
    # trajectory dump always runs (core/util/signal_handler_linux.cpp).
    def _sigint(_sig, _frm):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGINT, _sigint)
    except ValueError:
        pass  # not the main thread (embedded use): rely on the caller

    from .io.statistics import ExecStats, FrameRecord, LandmarkStats, StatisticsLog
    from .io.trajectory import ate_rmse, save_kitti_trajectory

    ds, cfg, gt = build_dataset(args)

    if args.mode == "stereo":
        from .models.stereo_vo import StereoVO

        vo = StereoVO(cfg, device=args.device)
    else:
        from .models.mono_vo import MonoVO

        vo = MonoVO(cfg, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    slog = StatisticsLog()
    n_done = 0
    tracer = None
    if args.trace:
        tracer = contextlib.ExitStack()
        tracer.enter_context(device_trace(args.trace, args.device))
    t_start = time.perf_counter()

    def record(stats, ts, dt_ms):
        nonlocal n_done
        sm = stats.get("stage_ms") or {}
        # scale est/gt per frame (statisticsStamped scale_cur_frame / gt):
        # translation step length vs ground truth's.
        scale_est = scale_gt = 0.0
        fidx = stats.get("frame", n_done)
        if 1 <= fidx < len(vo.trajectory):
            scale_est = float(np.linalg.norm(vo.trajectory[fidx][:3, 3] - vo.trajectory[fidx - 1][:3, 3]))
            if gt is not None and fidx < len(gt):
                scale_gt = float(np.linalg.norm(gt[fidx][:3, 3] - gt[fidx - 1][:3, 3]))
        slog.append(FrameRecord(
            frame=fidx,
            timestamp=ts,
            keyframe=bool(stats.get("keyframe")),
            steering_angle=float(stats.get("steering_angle", 0.0) or 0.0),
            scale_est=scale_est,
            scale_gt=scale_gt,
            exec=ExecStats(
                time_total=dt_ms,
                time_track=sm.get("time_track", 0.0),
                time_stereo=sm.get("time_stereo", 0.0),
                time_1p=sm.get("time_1p", 0.0),
                time_5p=sm.get("time_5p", 0.0),
                time_pose=sm.get("time_pose", 0.0),
                time_new=sm.get("time_new", 0.0),
                time_ba=sm.get("time_ba", 0.0),
            ),
            landmarks=LandmarkStats(
                n_initial=stats.get("n_initial", 0) or 0,
                n_pass_bidirection=stats.get("n_tracked", 0) or 0,
                n_pass_1p=stats.get("n_pass_1p", 0) or 0,
                n_pass_5p=stats.get("n_inliers", 0) or 0,
                n_new=stats.get("n_new", 0) or 0,
                n_final=(stats.get("n_inliers", 0) or 0) + (stats.get("n_new", 0) or 0),
                n_ok_parallax=stats.get("n_ok_parallax", 0) or 0,
                avg_parallax=float(stats.get("avg_parallax", 0.0) or 0.0),
                avg_age=float(stats.get("avg_age", 0.0) or 0.0),
            ),
        ))
        n_done += 1
        if not args.quiet and n_done % 25 == 0:
            print(f"[{n_done}] t={ts:.2f} tracks={stats.get('n_inliers')} {dt_ms:.1f}ms", flush=True)

    pend_ts, pend_l, pend_r = [], [], []

    def flush_batch():
        if not pend_ts:
            return
        n0 = len(vo.stats_log)
        t0 = time.perf_counter()
        if args.mode == "stereo":
            vo.track_stereo_batch(np.stack(pend_l), np.stack(pend_r))
        else:
            vo.track_batch(np.stack(pend_l))
        # One record per frame of the batch: the bootstrap frame that a first
        # stereo batch starts with is in the log too, though the batch call
        # returns only the tracked frames' stats.
        done = vo.stats_log[n0:]
        dt_ms = (time.perf_counter() - t0) * 1e3 / max(len(done), 1)
        for s_, ts_ in zip(done, pend_ts):
            record(s_, ts_, dt_ms)
        pend_ts.clear()
        pend_l.clear()
        pend_r.clear()

    def dump_outputs():
        """Write every output from whatever state exists: on clean completion
        and on interrupt (an interrupted 4,000-frame run must not lose
        everything; mono_vo.cpp:64-127)."""
        if not vo.trajectory:
            return None
        traj = np.stack(vo.trajectory)
        save_kitti_trajectory(os.path.join(args.out, "frame_poses.txt"), traj)
        save_kitti_trajectory(
            os.path.join(args.out, "keyframe_poses.txt"),
            [T for _, T in vo.kf_trajectory],
            [i for i, _ in vo.kf_trajectory],
        )
        slog.save_jsonl(os.path.join(args.out, "stats.jsonl"))
        summary = slog.summary()
        summary["fps"] = n_done / max(time.perf_counter() - t_start, 1e-9)
        gt_plot = None
        if gt is not None and len(gt) >= len(traj):
            align = "se3" if args.mode == "stereo" else "sim3"
            summary["ate_rmse"] = ate_rmse(traj, gt[: len(traj)], align=align)
            if args.mode == "mono" and vo.kf_trajectory:
                # Mono holds identity until bootstrap; report the tracked
                # segment separately so init frames don't dominate the ATE.
                b = vo.kf_trajectory[0][0]
                if b + 2 < len(traj):
                    summary["ate_rmse_post_init"] = ate_rmse(traj[b:], gt[b : len(traj)], align=align)
            gt_plot = gt[: len(traj)]
        png = os.path.join(args.out, "trajectory.png")
        if importlib.util.find_spec("matplotlib") is None:
            print(f"{png} not written: matplotlib is not installed", file=sys.stderr, flush=True)
        else:
            from .io.visualize import plot_trajectory

            plot_trajectory(traj, gt_plot, out_path=png)
        return summary

    interrupted = False
    try:
        for ts, left, right in ds:
            if args.frames is not None and n_done + len(pend_ts) >= args.frames:
                break
            # Mono batching only once bootstrapped (phase 2).
            batch_ready = args.batch > 0 and (args.mode == "stereo" or getattr(vo, "phase", 2) == 2)
            if batch_ready:
                pend_ts.append(ts)
                pend_l.append(left)
                pend_r.append(right)
                if len(pend_ts) >= args.batch:
                    flush_batch()
                continue
            t0 = time.perf_counter()
            if args.mode == "stereo":
                _, stats = vo.track_stereo_images(left, right, ts, timed=args.stage_timing)
            else:
                _, stats = vo.track_image(left, ts, timed=args.stage_timing)
            record(stats, ts, (time.perf_counter() - t0) * 1e3)
            if args.debug_images and vo.state is not None:
                from .io.visualize import save_image

                dbg_dir = os.path.join(args.out, "debug")
                os.makedirs(dbg_dir, exist_ok=True)
                save_image(os.path.join(dbg_dir, f"{n_done - 1:06d}.png"), vo.debug_overlay(left))
        flush_batch()
    except KeyboardInterrupt:
        interrupted = True
        print(f"\ninterrupted — dumping {n_done} processed frames to {args.out}", file=sys.stderr, flush=True)
    except BaseException:
        # Dump whatever state exists, but never let a dump failure (e.g.
        # plotting a diverged trajectory) mask the original error, and never
        # turn a crash into the misleading "no frames processed" exit.
        if tracer is not None:
            tracer.close()
            tracer = None
        try:
            dump_outputs()
        except Exception as dump_exc:  # noqa: BLE001 — diagnostic only; the original error is re-raised
            print(f"warning: output dump failed after error: {dump_exc!r}", file=sys.stderr, flush=True)
        raise
    finally:
        if tracer is not None:
            tracer.close()

    summary = dump_outputs()
    if summary is None:
        raise SystemExit(
            f"no frames processed — check --root/--seq (dataset yielded 0 frames) or --frames ({args.frames})"
        )
    print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in summary.items()})
    if interrupted:
        raise SystemExit(130)
    return summary


if __name__ == "__main__":
    main()
