"""Stage profile of the stereo pipeline: the port's counterpart of
scripts/profile_stages.py.

Runs bench.py's configuration and world (KITTI-size 1241x376, 1024 tracks,
3 pyramid levels, the corridor at 0.8 m/frame as uint8 pairs), warms the
pipeline with one `track_stereo_batch` over 1 + BATCH frames, and from that
evolved state times the serving path (`track_stereo_batch` over the next
BATCH frames, per frame), the steady step, its four stages, the
replenishment cascade and its sub-stages, the keyframe step, and the window
BA solve alone on the keyframe step's own problem (`ba_solve`):

- device ms: CUDA events around n calls, divided by n, after a warm-up;
- host ms: the host clock around the same n calls, ending in a synchronise;
- busy ms: the union of the device's kernel and copy intervals in a
  `torch.profiler` trace of one call.

Each is the min over trials (the reference's number) with the median and
the max beside it. Then, over one steady `track_stereo_batch` call, the
device's busy and idle share and its top operations (`torch.profiler`; the
hand-written kernels' trace events are held to `ops/kernels.LAUNCHES`), the host
syncs of one `_steady_step`, of one `_keyframe_step` and of its BA solve
alone, and per frame of the batch (`torch.cuda.set_sync_debug_mode`), and the matmul-class FLOPs per frame
(`torch.utils.flop_counter`). --mono adds the idle share and syncs of
`MonoVO.track_batch` at eval_accuracy's mono configuration.

  python -m visual_odometry_ros_tpu_torch.profile_stages                  # on the card
  python -m visual_odometry_ros_tpu_torch.profile_stages --step 0.25 --mono
  python -m visual_odometry_ros_tpu_torch.profile_stages --device cpu --crop 256 192 --features 256 \\
      --batch 2 --reps 1 --trials 1 --out /tmp/p

With --device cpu only host times are taken and every device field is null.
Writes PROFILE_TORCH.json (in --out, by default the repository root), never
PROFILE.json. `main(argv)` returns the record.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT_NAME = "PROFILE_TORCH.json"

BATCH = 24  # bench.py:27
STEP = 0.8  # bench.py:59, metres per frame
FULL = (1241, 376)  # KITTI-size frames (bench.py:53)
FX, CX, CY, BASELINE = 718.856, 607.1928, 185.2157, 0.5371657

# NVIDIA H100 SXM, float32 outside the tensor cores, at the 700 W limit (data
# sheet): the pipeline is float32 end to end, with TF32 off.
PEAK_FP32_FLOPS = 67e12

STAGE_KEYS = (
    "scan_per_frame", "steady_step_full", "track_stage", "stereo_stage", "pose_stage", "update_stage",
    "replenish_total", "rep_detect", "rep_coarse_disp", "rep_stereo_match", "rep_zncc_verify",
    "rep_descriptors", "keyframe_ba", "ba_solve",
)
KERNELS = {"klt_pyr": "klt_pyr_kernel", "klt_scale": "klt_scale_kernel", "pose_gn": "pose_gn_kernel",
           **{k: f"{k}_kernel" for k in ("ba_terms", "ba_solve", "ba_backsub")}}
WINDOW_LABEL = "vo_profile_window"
MONO_FRAMES = 49  # --mono: the first HardSequence frames, as chip_smoke's mono path
MONO_BATCH = 12  # mono frames per track_batch call: the warm-up's and the profiled one's


# ---------------------------------------------------------------------------
# bench.py's configuration and world
# ---------------------------------------------------------------------------


def bench_config(width: int = FULL[0], height: int = FULL[1], features: int = 1024):
    """bench.py:31-50: KITTI-size stereo (fx 718.856, baseline 0.537 m), 1024
    tracks, a 4096-landmark arena, a 9 + 1 keyframe window, 3 prior-seeded
    pyramid levels of 15 iterations. width, height < full size take the
    central crop (cx, cy shifted); `features` sets the track count."""
    from .config import VOConfig

    cfg = VOConfig()
    cfg.cam.width, cfg.cam.height = width, height
    cfg.cam.cx = CX - (FULL[0] - width) / 2
    cfg.cam.cy = CY - (FULL[1] - height) / 2
    cfg.cam_right = cfg.cam
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = BASELINE
    cfg.T_lr = T_lr
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = features
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 9
    cfg.keyframe.thres_translation = 4.0
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    return cfg


def build_vo(device="cuda", **config):
    """bench.py's StereoVO on `device` (`bench_config(**config)`)."""
    from .models.stereo_vo import StereoVO

    return StereoVO(bench_config(**config), device=device)


@functools.lru_cache(maxsize=4)
def corridor_world(n: int, step: float = STEP, width: int = FULL[0], height: int = FULL[1]):
    """(world, poses) of bench.py:53-70: a corridor fit around
    forward_trajectory(n, step, yaw_rate=0.0015); width, height < full size
    render the central crop."""
    from .io import CorridorSequence, forward_trajectory

    poses = forward_trajectory(n, step=step, yaw_rate=0.0015)
    world = CorridorSequence.fit(
        poses, width=width, height=height, fx=FX, fy=FX, cx=CX - (FULL[0] - width) / 2,
        cy=CY - (FULL[1] - height) / 2, baseline=BASELINE, wall_tex_size=256, wall_tex_scale=40.0,
    )
    return world, poses


def _render(job):
    (n, step, width, height), i = job
    world, poses = corridor_world(n, step, width, height)
    l, r = world.stereo_pair(poses[i].astype(np.float64))
    return np.clip(l, 0, 255).astype(np.uint8), np.clip(r, 0, 255).astype(np.uint8)


def make_frames(n: int, width: int = FULL[0], height: int = FULL[1], step: float = STEP,
                workers: int | None = None):
    """bench.py:53-76: (il, ir) [n, H, W] camera-native uint8 pairs of the
    corridor, frame i at pose i; rendered in a spawn process pool of
    `workers` (default: up to 8) or in this process for workers=1."""
    jobs = [((n, step, width, height), i) for i in range(n)]
    workers = workers or max(1, min(8, os.cpu_count() or 1, n))
    if workers == 1:
        pairs = [_render(j) for j in jobs]
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
            pairs = list(ex.map(_render, jobs))
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def _spread(xs) -> dict:
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}


def time_call(fn, device, reps: int = 20, trials: int = 5) -> dict:
    """fn() `reps` times per trial, after one warm-up call: host ms per call
    (host clock ending in a synchronise) and, on the card, device ms per
    call (CUDA events around the reps), each as min / median / max over
    trials."""
    card = _on_card(device)
    fn()
    _sync(device)
    host, dev = [], []
    for _ in range(trials):
        if card:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        if card:
            b.record()
        _sync(device)
        host.append((time.perf_counter() - t) * 1e3 / reps)
        if card:
            dev.append(a.elapsed_time(b) / reps)
    return {"host_ms": _spread(host), "device_ms": _spread(dev) if card else None}


def _merged_ms(intervals, lo: float, hi: float) -> float:
    """Length (ms) of the union of [start, end] us intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-3


def trace_window(fn, device) -> dict:
    """fn() once under torch.profiler (CPU and CUDA activities), then a
    synchronise, inside one record_function range (the window). Returns the
    window's length, the device's busy ms (the union of its kernel and copy
    intervals in the window), the idle share (1 - busy / window), the 10
    device operations of most total time, the hand-written kernels' trace
    events and `ops/kernels.LAUNCHES` over the same window. Without device events
    in the trace, busy ms and the idle share are None (not measured)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .ops import kernels as KN

    _sync(device)
    KN.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_LABEL):
            fn()
            _sync(device)
    launches = dict(KN.LAUNCHES)
    # The raw trace events (the profiler's FunctionEvent tree is not built:
    # a serving batch holds over 10^5 device events).
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_LABEL and e.device_type() == cpu]
    if len(win) != 1:
        raise RuntimeError(f"profiler trace holds {len(win)} '{WINDOW_LABEL}' ranges, expected 1")
    lo, hi = win[0].start_ns() * 1e-3, win[0].end_ns() * 1e-3
    spans = [(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3) for e in events
             if e.device_type() == cuda and e.name() != WINDOW_LABEL]
    by_name: dict = {}
    for name, s, e in spans:
        n, ms = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, ms + (e - s) * 1e-3)
    busy = _merged_ms([(s, e) for _, s, e in spans], lo, hi) if spans else None
    window_ms = (hi - lo) * 1e-3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_ms": window_ms,
        "device_events": len(spans),
        "busy_ms": busy,
        "idle_share": None if busy is None else 1.0 - busy / window_ms,
        "top_ops": [{"name": k[:160], "count": n, "total_ms": ms} for k, (n, ms) in ranked],
        "kernel_trace_events": {k: sum(1 for name, _, _ in spans if v in name) for k, v in KERNELS.items()},
        "kernel_launches": launches,
    }


def count_syncs(fn, device) -> int:
    """Host syncs that fn() makes, as torch.cuda.set_sync_debug_mode("warn")
    flags them (a `.item()`, `bool()` or `.cpu()` of a device tensor, a
    blocking copy). Not flagged: an explicit torch.cuda.synchronize, and
    waits inside the hand-written kernels' C launchers."""
    prev = torch.cuda.get_sync_debug_mode()
    _sync(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    _sync(device)
    return sum(1 for w in caught if "synchronizing" in str(w.message))


def count_flops(fn) -> int:
    """Matmul-class FLOPs of fn() (torch.utils.flop_counter.FlopCounterMode:
    mm, bmm, addmm, matmul, convolutions; elementwise work is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


# ---------------------------------------------------------------------------
# The stereo profile
# ---------------------------------------------------------------------------


def keyframe_problem(vo, state) -> tuple:
    """The arguments of the window BA solve that `vo._keyframe_step(state)`
    makes (`ops/ba.ba_solve_impl`'s), caught by running the step once."""
    from .ops import ba as BA

    orig, seen = BA.ba_solve_impl, []

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return orig(*args, **kwargs)

    BA.ba_solve_impl = record
    try:
        vo._keyframe_step(state)
    finally:
        BA.ba_solve_impl = orig
    if len(seen) != 1:
        raise RuntimeError(f"the keyframe step made {len(seen)} BA solves, expected 1")
    return seen[0]


def stage_calls(vo, state, im_l, im_r) -> dict:
    """{stage key: zero-argument call} of every stage of one steady frame
    from `state` on the float32 frame (im_l, im_r) (the reference script's
    stage decomposition), each fed the outputs of the stages before it,
    which run once here. `scan_per_frame` is not among them."""
    from .ops import ba as BA
    from .ops import features as F
    from .ops import stereo_disparity as SD

    cfg = vo.cfg
    pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth, scale_prior = vo._track_stage(state, im_l, im_r)
    pts_r1, ok_stereo, _ = vo._stereo_stage(pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth)
    pose = vo._pose_stage(state, pts1, pts_r1, ok_track, ok_stereo, has_3d)
    tracks = state.tracks
    ex = cfg.extractor

    def detect():
        return F.detect_features(pyr_l[0][0], tracks.pts, tracks.valid, gh=ex.n_bins_v, gw=ex.n_bins_u,
                                 n_max=vo.N // 2, fast_thresh=ex.thres_fastscore, score_min=ex.score_min)

    new_pts, new_ok = detect()
    disp_prior, _, _ = vo._coarse_disparity_prior(pyr_l, pyr_r, new_pts)
    _, ok_rn, disp_n = vo._stereo_match(pyr_l, pyr_r, new_pts, new_ok, disp_prior=disp_prior)
    state2 = vo._steady_step(state, im_l, im_r)[0]
    ba_args, ba_kwargs = keyframe_problem(vo, state2)
    return {
        "steady_step_full": lambda: vo._steady_step(state, im_l, im_r),
        "track_stage": lambda: vo._track_stage(state, im_l, im_r),
        "stereo_stage": lambda: vo._stereo_stage(pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth),
        "pose_stage": lambda: vo._pose_stage(state, pts1, pts_r1, ok_track, ok_stereo, has_3d),
        "update_stage": lambda: vo._update_stage(state, pyr_l, pyr_r, pts1, pts_r1, ok_track, ok_stereo,
                                                 scale_prior, *pose),
        "replenish_total": lambda: vo._replenish(pyr_l, pyr_r, tracks, state.arena, state.T_wc),
        "rep_detect": detect,
        "rep_coarse_disp": lambda: vo._coarse_disparity_prior(pyr_l, pyr_r, new_pts),
        "rep_stereo_match": lambda: vo._stereo_match(pyr_l, pyr_r, new_pts, new_ok, disp_prior=disp_prior),
        "rep_zncc_verify": lambda: SD.verify_disparity_zncc(pyr_l[0][0], pyr_r[0][0], new_pts, disp_n,
                                                            new_ok & ok_rn),
        "rep_descriptors": lambda: F.orb_descriptors(pyr_l[0][0], new_pts),
        "keyframe_ba": lambda: vo._keyframe_step(state2),
        "ba_solve": lambda: BA.ba_solve_impl(*ba_args, **ba_kwargs),
    }


def _replay(vo, state, logs):
    """Put the pipeline back at `state` with the logs as they were."""
    vo.state = state
    vo.trajectory, vo.kf_trajectory, vo.stats_log = (list(x) for x in logs)


def profile_stereo(vo, il, ir, batch: int, reps: int = 20, trials: int = 5, flops: bool = True) -> dict:
    """The stereo profile on frames il, ir (>= 1 + 2 * batch uint8 pairs):
    the warm-up over the first 1 + batch, then every stage from that state.
    flops=False skips the FLOP count (two more passes, each several times
    slower under FlopCounterMode). Returns the record's measurement fields."""
    device = vo.device
    card = _on_card(device)
    if len(il) < 1 + 2 * batch:
        raise ValueError(f"{len(il)} frames: the profile needs 1 + 2 x {batch}")
    vo.track_stereo_batch(il[: 1 + batch], ir[: 1 + batch])
    _sync(device)
    state = vo.state
    logs = (vo.trajectory, vo.kf_trajectory, vo.stats_log)
    nl, nr = il[1 + batch : 1 + 2 * batch], ir[1 + batch : 1 + 2 * batch]

    def scan():
        _replay(vo, state, logs)
        return vo.track_stereo_batch(nl, nr)

    wall, t0 = {}, time.perf_counter()
    stages = {}
    t = time_call(scan, device, reps=min(reps, 3), trials=min(trials, 4))
    t["recovered_frames"] = sum(1 for s in vo.stats_log[len(logs[2]):] if s.get("recovered", 0))
    stages["scan_per_frame"] = {k: ({q: x / batch for q, x in v.items()} if isinstance(v, dict) else v)
                                for k, v in t.items()}
    im_l = torch.as_tensor(nl[0]).to(device).to(torch.float32)
    im_r = torch.as_tensor(nr[0]).to(device).to(torch.float32)
    calls = stage_calls(vo, state, im_l, im_r)
    for key, fn in calls.items():
        slow = key in ("keyframe_ba", "ba_solve")
        stages[key] = time_call(fn, device, reps=max(1, reps // 4) if slow else reps, trials=trials)
        stages[key]["busy_ms"] = trace_window(fn, device)["busy_ms"] if card else None
    steady_stats = calls["steady_step_full"]()[1]
    stages["steady_step_full"]["recovered"] = int(steady_stats.recovered)
    stages["scan_per_frame"]["busy_ms"] = None
    wall["stages"], t0 = time.perf_counter() - t0, time.perf_counter()

    out = {"stages": {k: stages[k] for k in STAGE_KEYS},
           "state": {"fail_count": int(state.fail_count), "recover_after": vo.cfg.motion.recover_after,
                     "tracks_valid": int(state.tracks.valid.sum()), "frame_id": int(state.frame_id)}}
    if flops:
        out["flops"] = flop_record(count_flops(scan), count_flops(calls["steady_step_full"]), batch,
                                   stages["scan_per_frame"]["device_ms"])
        wall["flops"], t0 = time.perf_counter() - t0, time.perf_counter()
    else:
        out["flops"] = None
    if card:
        win = trace_window(scan, device)
        stages["scan_per_frame"]["busy_ms"] = win["busy_ms"] / batch if win["busy_ms"] is not None else None
        out["device"] = win
        wall["trace"], t0 = time.perf_counter() - t0, time.perf_counter()
        out["host_syncs"] = {
            "steady_step": count_syncs(calls["steady_step_full"], device),
            "keyframe_step": count_syncs(calls["keyframe_ba"], device),
            "ba_solve": count_syncs(calls["ba_solve"], device),
            "batch_per_frame": count_syncs(scan, device) / batch,
        }
        wall["syncs"] = time.perf_counter() - t0
    else:
        out["device"] = None
        out["host_syncs"] = None
    out["wall_s_by_part"] = wall
    _replay(vo, state, logs)
    return out


def flop_record(flops: int, steady_flops: int, batch: int, dev_ms) -> dict:
    """The reference artifact's `flops` block: per-frame matmul FLOPs of the
    serving path and, given its device ms per frame, the achieved rate and
    its share of the float32 peak."""
    per_frame = flops / batch
    achieved = per_frame / (dev_ms["min"] * 1e-3) if dev_ms else None
    return {
        "scan_batch": flops,
        "steady_step": steady_flops,
        "per_frame": per_frame,
        "achieved_flops_per_s": achieved,
        "peak_f32_flops_per_s": PEAK_FP32_FLOPS,
        "mfu_f32": achieved / PEAK_FP32_FLOPS if achieved is not None else None,
        "note": "torch.utils.flop_counter.FlopCounterMode over one track_stereo_batch call: matmul-class "
                "ops only (mm, bmm, addmm, matmul, convolutions); elementwise, gather and the hand-written "
                "kernels' work are not counted. VO is gather- and launch-bound, so a low share of the float32 peak "
                "(H100 SXM, outside the tensor cores, 700 W) is structural. Achieved = per-frame FLOPs over "
                "the serving path's device ms per frame.",
    }


def profile_mono(vo, imgs, trials: int = 3) -> dict:
    """MonoVO over imgs: track_image to the bootstrap, one warm track_batch
    of MONO_BATCH frames, then the next MONO_BATCH through track_batch:
    host and device ms per frame over trials, one traced call (idle share,
    top operations, KLT events against the counters) and the host syncs of
    one `_steady_step` and per frame of that batch."""
    device = vo.device
    batch = MONO_BATCH
    t0 = time.perf_counter()
    i = 0
    while vo.phase != 2:
        if i >= len(imgs) - 2 * batch:
            raise RuntimeError(f"mono did not bootstrap within {i} frames")
        vo.track_image(imgs[i])
        i += 1
    boot = i - 1
    vo.track_batch(imgs[i : i + batch])
    _sync(device)
    state = vo.state
    logs = (vo.trajectory, vo.kf_trajectory, vo.stats_log)
    nb = imgs[i + batch : i + 2 * batch]

    def run():
        _replay(vo, state, logs)
        return vo.track_batch(nb)

    t = time_call(run, device, reps=1, trials=trials)
    im = torch.as_tensor(nb[0], dtype=torch.float32).to(device)
    out = {"boot_frame": boot, "frames": [i + batch, i + 2 * batch], "batch": batch, "trials": trials,
           "host_ms_per_frame": {k: v / batch for k, v in t["host_ms"].items()},
           "device_ms_per_frame": ({k: v / batch for k, v in t["device_ms"].items()}
                                   if t["device_ms"] else None)}
    if _on_card(device):
        out["device"] = trace_window(run, device)
        out["host_syncs"] = {"steady_step": count_syncs(lambda: vo._steady_step(state, im), device),
                             "batch_per_frame": count_syncs(run, device) / batch}
    else:
        out["device"] = out["host_syncs"] = None
    out["wall_s"] = time.perf_counter() - t0
    _replay(vo, state, logs)
    return out


NOTE = (
    "Stages are timed from one evolved state (after a warm track_stereo_batch over 1 + batch frames), so "
    "every timed call repeats the same frame; steady_step_full and the stages run without stage_ms, so the "
    "timed path's per-stage synchronises are in neither the times nor the sync count. device_ms: CUDA "
    "events around `reps` calls (device time between the first and last call, gaps where the device waits "
    "for the host included); host_ms: host clock ending in a synchronise; busy_ms: union of kernel and copy "
    "intervals in a torch.profiler trace of one call. min / median / max over trials; the reference's "
    "number is the min. `recovered`: the timed steady step ran tracking-loss recovery (PnP) from this "
    "state. Host syncs: torch.cuda.set_sync_debug_mode('warn') warnings; an explicit "
    "torch.cuda.synchronize and waits inside the KLT C launchers are not counted."
)


def _ms(d, q="min"):
    return "n/a" if d is None else f"{d[q]:.3f}"


def summary_lines(rec) -> list:
    """The stage table (device, host and busy ms, recovery) and the device
    lines of a record, as text."""
    lines = [f"stage profile on {rec['card'] or 'CPU'}: {rec['width']}x{rec['height']}, N = {rec['features']}, "
             f"batch {rec['batch']}, {rec['step']} m/frame; min over {rec['trials']} trials of {rec['reps']} calls",
             f"{'stage':18s} {'device ms':>10s} {'host ms':>10s} {'busy ms':>10s}  recovery"]
    for k in STAGE_KEYS:
        st = rec["stages"][k]
        busy = "n/a" if st.get("busy_ms") is None else f"{st['busy_ms']:.3f}"
        rc = st.get("recovered", st.get("recovered_frames", ""))
        lines.append(f"{k:18s} {_ms(st['device_ms']):>10s} {_ms(st['host_ms']):>10s} {busy:>10s}  {rc}")
    for name, part in (("stereo", rec), ("mono", rec.get("mono") or {})):
        d = part.get("device")
        if d is None:
            continue
        share = "not measured (no device events in the trace)" if d["idle_share"] is None else \
            f"{d['idle_share']:.4f} ({d['busy_ms']:.2f} of {d['window_ms']:.2f} ms busy)"
        syncs = part["host_syncs"]
        kf = (f"{syncs['keyframe_step']} per _keyframe_step ({syncs['ba_solve']} in its BA solve), "
              if "keyframe_step" in syncs else "")
        lines.append(f"{name} device idle share over one batch call: {share}; host syncs: "
                     f"{syncs['steady_step']} per _steady_step, {kf}"
                     f"{syncs['batch_per_frame']:.2f} per frame of the batch")
        lines.append(f"{name} top device ops: " + "; ".join(
            f"{o['name'][:60]} x{o['count']} {o['total_ms']:.3f} ms" for o in d["top_ops"][:5]))
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--step", type=float, default=STEP, help="metres per frame (chip_smoke phase 4: 0.25)")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--crop", type=int, nargs=2, default=list(FULL), metavar=("W", "H"),
                   help="central crop of the KITTI-size frame (cx, cy shifted)")
    p.add_argument("--features", type=int, default=1024, help="tracks N")
    p.add_argument("--reps", type=int, default=20, help="calls per timed trial (the reference's n)")
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--mono", action="store_true",
                   help="also profile MonoVO.track_batch at eval_accuracy's mono configuration")
    p.add_argument("--tag", default=None, help="record key (default: <platform>_step<step>)")
    p.add_argument("--out", default=str(ROOT), help=f"directory of {OUT_NAME}")
    return p.parse_args(argv)


def run(vo, il, ir, batch, step, reps=20, trials=5, mono_vo=None, mono_imgs=None, flops=True) -> dict:
    """The whole record: the stereo profile of `vo` on (il, ir) and, given
    mono_vo and mono_imgs, the mono one (`profile_stereo`, `profile_mono`)."""
    from .eval_accuracy import card_info

    t0 = time.perf_counter()
    rec = {"platform": "cuda" if _on_card(vo.device) else "cpu", **card_info(vo.device),
           "width": vo.cfg.cam.width, "height": vo.cfg.cam.height, "features": vo.N, "batch": batch,
           "step": step, "reps": reps, "trials": trials}
    rec.update(profile_stereo(vo, il, ir, batch, reps, trials, flops))
    rec["stages_ms"] = {k: rec["stages"][k]["host_ms"]["min"] for k in STAGE_KEYS}
    rec["implied_scan_fps"] = 1000.0 / rec["stages_ms"]["scan_per_frame"]
    rec["mono"] = profile_mono(mono_vo, mono_imgs, trials=trials) if mono_vo is not None else None
    rec["note"] = NOTE
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> dict:
    args = parse_args(argv)
    if _on_card(args.device) and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA GPU here (pass --device cpu for host times only)")
    W, H = args.crop
    vo = build_vo(args.device, width=W, height=H, features=args.features)
    il, ir = make_frames(1 + 2 * args.batch, W, H, args.step)
    mono_vo = mono_imgs = None
    if args.mono:
        from . import eval_accuracy as EA

        mono_vo = EA.build_mono("on", args.device)
        mono_imgs = EA.load_frames(MONO_FRAMES)[0]
    rec = run(vo, il, ir, args.batch, args.step, args.reps, args.trials, mono_vo, mono_imgs)
    for line in summary_lines(rec):
        print(line)
    out = Path(args.out)
    path = out / OUT_NAME
    records = json.loads(path.read_text()) if path.exists() else {}
    records[args.tag or f"{rec['platform']}_step{args.step:g}"] = rec
    out.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(records, indent=1) + "\n")
    print(f"wrote {path}")
    return rec


if __name__ == "__main__":
    main()
