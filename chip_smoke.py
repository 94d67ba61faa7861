#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`visual_odometry_ros_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero before
the final line):
  1. environment: torch / CUDA versions, the card's name and power limit;
     every world below is rendered in one process pool;
  2. build: compiles csrc/*.cu (klt.cu, pose_gn.cu, ba_gn.cu) in one nvcc
     call for sm_90a into one library under build/kernels/;
  3. kernels: `klt_pyr` one level at a time (2-D and epi1d, all three
     pyramid level sizes), as the fused forward climb (N = 1024), as the
     bidirectional epi1d climb (N = 512) and as mono's 2-D bidirectional
     climb (HardSequence 640x480, N = 512, backward over level 0, forward
     and backward outputs), and `klt_scale` (s = 1, s in [0.9, 1.12],
     s = 0.5 and s = 2, and mono's 30 iterations with s over [0.25, 4]),
     each against its plain PyTorch version on the same inputs; then, at
     the six KLT call sites (stereo track climb, scale, stereo, replenish;
     mono track, mono scale), one launch per call asserted, device time per
     launch (C launcher alone, back to back), host time per call, the plain
     version's time and the bound from this run's work counts. Once phases
     4, 6 and 8 have recorded the pose stage's inputs (a steady stereo
     frame, a steady mono frame, two PnP polishes of a recovery: the first
     and the one over the most valid points, each alone, and a recovery's
     pair of polishes in its one launch), `pose_gn` on each against the
     plain versions (`*_ref`), two launches bit-identical, the pair's solves
     bit-identical to their single launches, and timed the same way (us
     per iteration beside ms per launch), its bound from the plain
     versions' work counts; each case is saved under build/chip_smoke_pose/
     for `pose_ab` and `kernel_split`; and once
     phases 4 and 8 have recorded a stereo and a mono keyframe step's window
     BA problem, the `ba_*` kernels on each and on dryrun_multichip's
     against `ba_solve_ref`, two solves bit-identical, launches per solve,
     device ms per solve (its launches replayed) and per kernel
     (torch.profiler), wrapper host us and its parts, the plain version's
     ms, the bound from the problem's masks, ba_solve's library yardstick
     (torch.linalg.cholesky_ex + cholesky_solve of the same system) and
     each launch's registers, shared memory and blocks per SM; each problem
     is saved under build/chip_smoke_ba/ for `ba_ab`;
  4. per-frame path: `StereoVO(cfg, device="cuda")` at the bench.py
     configuration over 1 + 18 frames of the bench corridor at 0.25 m/frame
     through `track_stereo_images`; times steady and keyframe steps and
     counts kernel launches frame by frame (one robust pose solve, so one
     pose_gn, per frame);
  5. per-stage times: 6 more frames of the same run with `timed=True`;
     checks kernel launches, BA keyframes and the 25-frame trajectory error;
  6. serving path: bench.py's workload -- the corridor at bench.py's
     0.8 m/frame, 1 + 24 uint8 frames through `track_stereo_batch` in two
     calls (1 + 12, then 12); tracking-loss recovery must fire; checks
     launches (per steady step one robust pose solve and the PnP polishes
     of its recovery), trajectory error and post-recovery RPE against the JAX
     package's CPU run, and times the batch calls;
  7. rectification: the same tracker and map configuration with
     `flagDoUndistortion=True` on the 640x480 plane world rendered through
     radtan-distorted lenses, 1 + 8 frames at 0.22 m/frame through
     `track_stereo_batch`;
  8. mono path: `MonoVO(cfg, device="cuda")` at scripts/eval_accuracy.py's
     mono configuration over the first 49 frames of the accuracy sequence:
     `track_image` until the bootstrap, 6 frames with `timed=True`, then
     `track_batch`; checks the bootstrap frame, keyframe steps and BA
     acceptance, sim3 ATE against the JAX package's CPU run
     (tests/reference_mono_smoke.py) and kernel launches frame by frame
     (one robust pose solve per steady frame); then
     the same frames with a flat grey stretch (frames 30-32): the 5-point
     fallback and recovery must fire, recovery modes, first recovery frame
     and post-recovery sim3 ATE against the JAX run of those frames; then
     `_fallback_5pt` and `_recover` (modes 1 and 2) on the card against a
     CPU copy of the same state with the same draws;
  9. image-level KLT: `ops/klt.track`, `track_with_prior` and
     `track_bidirectional` (default KLTParams, kernel leg) on corridor
     frames 10 -> 11 at N = 1024: one `klt_pyr` launch per call, each
     against the same call on the plain kernel versions, and timed as the
     call sites of phase 3;
 10. the CLI (`python -m visual_odometry_ros_tpu_torch.run_vo`, called
     in-process): the 25 corridor frames of phases 4-5 written as a KITTI
     odometry sequence under build/, run with config/stereo/
     kitti_00_stereo.yaml per frame (--stage-timing) and with --batch 12,
     and on the central 620 columns: ATE and keyframes against the JAX
     package's CPU runs of both layouts (tests/reference_cli_smoke.py) and,
     at full width, against the port's --device cpu run as well; the two
     full-width runs' poses against each other, KLT launches frame by
     frame, one stats.jsonl record per frame; then --dataset synthetic
     --mode mono --frames 14 against the same reference;
 11. distributed BA: a 1-rank NCCL group (`parallel/multihost.init_worker`),
     `make_distributed_ba` at __graft_entry__.dryrun_multichip's problem
     (K = 9, M = 4096, 3 iterations, stereo rows) against the single-device
     solve, timed by CUDA events, with its all-reduces per solve counted
     (iterations + 2) and its ba_* launches (ba_solve twice per iteration,
     around the all-reduce);
 12. the accuracy leg (`visual_odometry_ros_tpu_torch.eval_accuracy`):
     `run_stereo` on the card with the kernel leg over phase 8's 49 frames
     as float32 stereo pairs, ATE against the JAX package's CPU run of
     scripts/eval_accuracy.run_stereo on the same frames
     (tests/reference_accuracy_smoke.py), pose fails beside it;
 13. the measurement legs: `profile_stages` (stage table with device, host
     and busy ms and recovery, device idle share, host syncs per frame and
     top device operations; the trace's KLT events against the launch
     counters) on phase 6's frames and `--mono` on phase 8's, `ab_frames`
     over phase 8's frames (its kernel leg's pose fails against phase
     12's), `bench_scaling`'s one-rank NCCL world (all-reduces and their
     bytes per solve) and `h2d_overlap_probe`'s two upload routes.
Every path is driven with the kernel launch counts set to 0 just before it
and read just after; every KLT and pose kernel must have run on every path,
pose_gn once for each solve of the public pose functions less one for each
pair (a recovery's two PnP polishes share one launch), and the ba_* kernels
3 iters + 2 times (ba_terms iters + 2, ba_solve and ba_backsub iters; the
apply step has no launch of its own: ba_solve takes the poses, ba_backsub's
blocks Xr += dy and its last block the decision) for each single-device
window BA solve (both counted by wrappers around them over phases 4-13),
checked per keyframe step on the per-frame and mono paths. The last two
lines are the kernel table (its ba_apply row says where the apply step
runs, with no launch and no ms of its own, and ba_backsub's row holds that
launch against both jobs' bound; launches of
the serving, mono (with the blackout run), image-level KLT, CLI,
accuracy-leg and A/B kernel-leg paths) and {"ok": true,
"device": ...}. This script imports no JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time
import zlib

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

# pose_gn against its plain version on the pose inputs that phases 4, 6 and
# 8 recorded (a steady stereo frame, a steady mono frame, a PnP polish of a
# recovery). Only the order of the point sums differs, which can move the
# stop test by an iteration: T10 to POSE_TOL_T (an extra iteration at the
# step_tol = 1e-4 stop moves it by less), the same ok, mean_err to
# POSE_TOL_ERR relative. A pose within POSE_TOL_T moves a pixel by up to
# about fx * POSE_TOL_T (0.07 px at KITTI's fx): err to POSE_TOL_ERR
# relative plus that, and the same inliers except for points within that of
# reproj_thresh.
POSE_TOL_T = 1e-4
POSE_TOL_ERR = 1e-3
POSE_LOG_MAX = 64  # pose calls a phase records
MONO_POSE_CALL = 10  # the recorded mono call held (a steady frame of phase 8's first run)

# The ba_* kernels against ba_solve_ref on the window BA problems that
# phases 4 and 8 recorded (a stereo and a mono keyframe step) and on
# dryrun_multichip's. Only the order of the float32 sums differs (normal
# equations, Schur complement, Cholesky), which the Schur complement
# amplifies mildly and which can move the max |dx| < 1e-5 stop by an
# iteration: tests/test_torch_ops.py's BA tolerances, T_cw to 2e-4, Xw to
# 2e-3 relative and absolute (a landmark seen from few keyframes is weakly
# constrained along its ray), mean error to 1e-3 relative (the starting
# error, one sum over the same terms, to 1e-5); killed and n_obs equal;
# iterations equal or one apart.
BA_KTOL = {"T_cw": 2e-4, "Xw": 2e-3, "err": 1e-3, "err0": 1e-5}
BA_LOG_MAX = 8  # BA solves a phase records
BA_KERNELS = ("ba_terms", "ba_solve", "ba_backsub")  # the launches of a solve
# The parts of a solve whose work, bound and plain share are counted: the
# kernels, and the apply step, which runs inside ba_backsub's launch (Xr +=
# dy in its blocks, the decision in its last) and ba_solve's (the poses).
BA_PARTS = (*BA_KERNELS, "ba_apply")

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


# Mono path: scripts/eval_accuracy.py:66-84's mono configuration (640x480,
# fx = fy = 500, N = 512 tracks in 16x10 bins, M = 4096 landmarks, K = 8 ring
# slots, 3 levels, 15 iterations, kernel leg) on the left images of the first
# N_MONO frames of ACCURACY.json's sequence (HardSequence fit around
# varied_trajectory(200, step=0.3), baseline 0.5 m, frame i rendered with
# frame=i). Schedule: track_image until phase 2, then N_MONO_TIMED frames with
# timed=True, then track_batch in near-equal chunks of at most MONO_CHUNK.
# The JAX package on CPU (its jnp leg), same frames and schedule
# (tests/reference_mono_smoke.py): bootstrap at frame MONO_REF_BOOT, sim3
# ATE MONO_REF_ATE_M over all N_MONO frames. Bounds: the bootstrap frame
# within +-2 of it, ATE at most 3x.
N_MONO = 49
N_MONO_TIMED = 6
MONO_PAIR = 20  # frames 20 -> 21: the mono kernel checks and call sites
MONO_CHUNK = 24
MONO_REF_BOOT = 12
MONO_REF_ATE_M = 0.36036
# Blackout: the same frames and schedule with frames BLACKOUT[0] ..
# BLACKOUT[1] - 1 a flat grey image. The JAX package on CPU
# (tests/reference_mono_smoke.py): recoveries MONO_BLACKOUT_REF_RECOVERIES
# ([frame, mode]), sim3 ATE of the frames from the last recovery on
# MONO_BLACKOUT_REF_POST_ATE_M. Bounds: the same modes in order, the first
# recovery within +-2 frames, that ATE at most 3x.
BLACKOUT = (30, 33)
BLACKOUT_GREY = 128.0
MONO_BLACKOUT_REF_RECOVERIES = [[32, 2], [35, 2]]
MONO_BLACKOUT_REF_POST_ATE_M = 0.00798273204559132
# Card against CPU on the same state and draws (mono_unit_checks): the
# fallback's rotation, step direction (cosine) and step length (relative)
# to test_fallback_from_jax_state's bounds; recovery's T_wc.
MONO_UNIT_TOL = {"fb_rot": 5e-3, "fb_cos": 0.985, "fb_len": 1e-5, "T_wc": 1e-4}

# The CLI on a KITTI layout: the N_MAIN corridor frames of phases 4-5 as
# sequence 00 (calib P0/P1 for fx 718.856, baseline 0.5371657 m), two ways:
#  - full width with the KITTI 00 stereo configuration
#    (config/stereo/kitti_00_stereo.yaml: 1241x376, N = 1024 in 24x12 bins,
#    4 levels, window 21, K = 10), per frame and with --batch CLI_BATCH.
#    References: the JAX package's scripts/run_vo.py on CPU on the same
#    layout (tests/reference_cli_smoke.py): se3 ATE CLI_REF_FULL_ATE_M,
#    keyframes CLI_REF_FULL_KEYFRAMES; and, as a second check, the port's
#    own CLI with --device cpu (the kernels' plain versions,
#    tests/reference_cli_plain.py, run on the CPU of the machine that holds
#    the card): CLI_PLAIN_ATE_M, CLI_PLAIN_KEYFRAMES;
#  - the central CLI_CROP_W columns (cx shifted, 512 tracks in 12x12 bins,
#    the configuration's bin size; `crop_layout`). Reference: the JAX
#    package's CLI on CPU on the same crop (the same script): CLI_REF_ATE_M,
#    CLI_REF_KEYFRAMES.
# Bounds: ATE at most 3x each reference, keyframes within +-1. The per-frame
# and --batch runs agree to CLI_BATCH_TOL_M on every position (the same
# steps on the same float32 frames).
KITTI_CONFIG = "config/stereo/kitti_00_stereo.yaml"
KITTI_FX, KITTI_CX, KITTI_CY, KITTI_BASELINE = 718.856, 607.1928, 185.2157, 0.5371657
CLI_CROP_W = 620
CLI_REF_FULL_ATE_M = 0.04184284740311028
CLI_REF_FULL_KEYFRAMES = 5
CLI_REF_ATE_M = 0.006513906530240936
CLI_REF_KEYFRAMES = 4
CLI_PLAIN_ATE_M = 0.04180905436665646
CLI_PLAIN_KEYFRAMES = 5
CLI_BATCH = 12
CLI_BATCH_TOL_M = 1e-4
# The mono CLI: --dataset synthetic --mode mono --frames CLI_MONO_FRAMES. The
# JAX package's CPU run of the same command (the same reference script):
# ate_rmse_post_init CLI_MONO_REF_ATE_M. Bound: at most 3x.
CLI_MONO_FRAMES = 14
CLI_MONO_REF_ATE_M = 0.0028401497356199496

# The accuracy leg (visual_odometry_ros_tpu_torch/eval_accuracy.py) over the
# N_MONO frames of phase 8 as float32 stereo pairs (the first frames of its
# 200-frame sequence): `eval_accuracy.run_stereo` with the kernel leg on the
# card, track_stereo_batch in chunks of 25. The JAX package's
# scripts/eval_accuracy.run_stereo on CPU (jnp leg) on the same frames
# (tests/reference_accuracy_smoke.py): ACC_REF_ATE_M, ACC_REF_POSE_FAILS,
# ACC_REF_RECOVERIES. Bound: ATE at most 3x; the pose fails are printed
# beside the reference's.
ACC_REF_ATE_M = 0.0276957917958498
ACC_REF_POSE_FAILS = 0
ACC_REF_RECOVERIES = 0

# Distributed BA: __graft_entry__.dryrun_multichip's problem (K = 9,
# M = 4096, 3 iterations), one NCCL rank against the single-device solve.
# Tolerances of tests/test_dist_ba.py: poses 2e-4, landmarks 5e-3 m, mean
# error 1e-3 px, n_obs and iterations equal.
BA_ITERS = 3
BA_TOL = {"T_cw": 2e-4, "Xw": 5e-3, "err": 1e-3}

# The measurement legs (phase 13), cut to fit about a minute of the run:
# profile_stages at a batch of PROFILE_BATCH (phase 6's 1 + 24 frames: the
# warm-up over 1 + 12, the profile over the next 12), PROFILE_TRIALS trials
# of PROFILE_REPS calls per stage and no FLOP count (the module's own runs
# take those: PROFILE_TORCH.json); bench_scaling's weak world of one rank at
# its own problem (M landmarks per rank, K keyframes, 10 iterations, 5
# timed solves); the upload probe with H2D_TRIALS trials.
PROFILE_BATCH = 12
PROFILE_REPS = 1
PROFILE_TRIALS = 1
SCALING_M, SCALING_K, SCALING_ITERS, SCALING_REPS = 4096, 9, 10, 5
H2D_TRIALS = 4


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
    # pose_gn, per weighted point (valid in its pass; the others have
    # weight 0 and add nothing to H and g) and GN iteration: mono
    # residual_fn 50 (transform 18, inverse depth 4, pixel residual 8,
    # projection Jacobian 7, the chain P [I | -[Xc]x] at its 10 nonzero
    # products (the left block is P; the skew's signs fold into them),
    # front mask 3: a compare, a select on the squared norm and on the
    # weight), then 133 (|r| 5, Huber weight 5, cost 3, J*w 12, H's 21
    # distinct entries 84, g 24); stereo residual_fn 129 (two transforms
    # 36, two projections 24, left Jacobian 17, right Jacobian 43: P_r 7,
    # P_r R_rl 18, its chain 18; masks 9: two compares and three ands, a
    # select on each view's squared norm and weight), then 257 (|r| 9,
    # weight 5, cost 3, J*w 24, H 168, g 48). A pass's final evaluation,
    # over all N points (per-point outputs): residuals without Jacobians,
    # error, inlier test and sums. The robust gate, over all N: four
    # reprojection errors (36 each) and their counts. The 6x6 step (damping,
    # Cholesky, solves, se3_exp: ~0.5 k per iteration) is left out: under
    # 1% at the main path's counts. The units come from the plain
    # versions' `counts`. Latency, not these operations, is what limits the
    # solve: up to 2 x 100 dependent iterations (PERF.md).
    "pose_point_iter_mono": 183,
    "pose_point_iter_stereo": 386,
    "pose_point_eval_mono": 43,
    "pose_point_eval_stereo": 83,
    "pose_point_gate": 154,
    # ba_*, per unit of one GN iteration's work that the recorded problem's
    # masks give (a masked row is no work: the plain version multiplies it by
    # a zero weight; a fixed or empty slot's pose rows are no work either:
    # solve_reduced gives its unknowns an identity row and dx = 0 there).
    # Left rows of a (landmark, keyframe) pair: the point into the camera 18,
    # inverse depth 3, normalised point 2, residuals 6, the pose rows Q 18,
    # the point rows Rj 20, |r| 6, Huber and the depth gate 5 (78), then per
    # row its point part, the weighted Rj 3 and its products into C 18 and b
    # 6 (27), and on an optimisable slot its pose part, the weighted Q 6 and
    # the products into A 72, a 12, B 36 (126). Right rows: the point in the
    # right camera 18, inverse depth 3, normalised 2, residuals 6, dpiR 20,
    # Xc x dpiR (Q's rotation half) 18, Rj 30, |r| 6, Huber and gate 5 (108),
    # then per row as the left. On a fixed slot the pair needs no Q (18 less).
    # Per observed pair: its C and b into the landmark's sums 12; on an
    # optimisable slot also BCinv 90 and sb 36. S_off over the unordered
    # pairs of optimisable slots a landmark is seen in (it is symmetric):
    # j < k a 6x6 block, 36 dot products of 3 (216); j = k its 21 distinct
    # entries (126). Per active landmark damping 6, the 3x3 inverse 45, the
    # divergence test 6. Per iteration the reduced system of the n = 6 x
    # (optimisable slots) unknowns that carry work: the Cholesky n^3 / 3,
    # the equilibration n^2 (its symmetric half, two products an entry), the
    # two triangular solves 2 n^2, the guard and se3_exp of those poses
    # ~150 each (ba_solve). ba_backsub: B^T dx per pair on an optimisable
    # slot 36, dy per active landmark 18; ba_apply: Xr += dy per active
    # landmark 3. The errors before and after (ba_terms' error launches):
    # per observed left pair 33.
    "ba_left_pair": 78 + 2 * (27 + 126),
    "ba_left_pair_fixed": 78 - 18 + 2 * 27,
    "ba_right_pair": 108 + 2 * (27 + 126),
    "ba_right_pair_fixed": 108 - 18 + 2 * 27,
    "ba_pair": 12,
    "ba_pair_opt": 90 + 36,
    "ba_pair_pair": 216,
    "ba_pair_diag": 126,
    "ba_landmark": 57,
    "ba_err_pair": 33,
    "ba_pose": 150,
    "ba_backsub_pair": 36,
    "ba_backsub_landmark": 18,
    "ba_apply_landmark": 3,
}
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(counts: dict, n_bytes: int) -> tuple:
    """(bound_ms, bound_by) of one call from its work counts and bytes."""
    ops = sum(OPS[k] * v for k, v in counts.items())
    t_ops, t_bytes = ops / PEAK_FP32, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bench_config():
    """bench.py:31-50 — KITTI-size stereo, 1024 tracks, 3 pyramid levels
    (`profile_stages.bench_config`)."""
    from visual_odometry_ros_tpu_torch.profile_stages import bench_config as config

    return config(features=N_FEAT)


def mono_config():
    """scripts/eval_accuracy.py:66-84 (build_mono), kernel leg."""
    from visual_odometry_ros_tpu_torch.io import VOConfig

    cfg = VOConfig()
    cfg.cam.fx = cfg.cam.fy = 500.0
    cfg.cam.cx, cfg.cam.cy = 320.0, 240.0
    cfg.cam.width, cfg.cam.height = 640, 480
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = 512
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 7
    cfg.keyframe.thres_translation = 1.2
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    cfg.tracker.use_pallas = "auto"
    return cfg


def mono_chunks(start: int, stop: int = N_MONO) -> list:
    """[(a, b), ...] near-equal track_batch chunks of at most MONO_CHUNK frames."""
    n = -(-(stop - start) // MONO_CHUNK)
    edges = [start + round(k * (stop - start) / n) for k in range(n + 1)] if n else [start]
    return list(zip(edges[:-1], edges[1:]))


@functools.lru_cache(maxsize=None)
def _world(kind: str):
    """(world, poses) of one run: "main" is the corridor at 0.25 m/frame,
    "bench" bench.py's at 0.8 m/frame (bench.py:53-76: a corridor fit around
    the trajectory), "distorted" the plane world through radtan lenses."""
    from visual_odometry_ros_tpu_torch.io import DistortedStereoSequence, PlaneSequence, forward_trajectory

    if kind == "mono":
        from visual_odometry_ros_tpu_torch.io.synthetic import HardSequence, varied_trajectory

        poses = varied_trajectory(200, step=0.3)
        return HardSequence(poses_T_wc=poses, baseline=0.5), poses[:N_MONO]
    if kind == "distorted":
        plane = PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
        return (DistortedStereoSequence(plane, np.asarray(DIST)),
                forward_trajectory(N_DIST, step=STEP_DIST, yaw_rate=0.0015))
    from visual_odometry_ros_tpu_torch.profile_stages import corridor_world

    step, n = (STEP_BENCH, N_BENCH) if kind == "bench" else (STEP_MAIN, N_MAIN)
    return corridor_world(n, step)


def render_pair(job):
    """Frame i of world `kind`: camera-native uint8 (left, right); for "mono"
    the float32 pair as scripts/eval_accuracy.py feeds it (its left image is
    `world.render(inv(T), frame=i)`, the mono frame)."""
    kind, i = job
    world, poses = _world(kind)
    if kind == "mono":
        return world.stereo_pair(poses[i].astype(np.float64), frame=i)
    l, r = world.stereo_pair(poses[i].astype(np.float64))
    return np.clip(l, 0, 255).astype(np.uint8), np.clip(r, 0, 255).astype(np.uint8)


def make_frames(sizes=None):
    """{kind: (left [n, H, W], right [n, H, W], poses)} for every run."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    sizes = sizes or {"main": N_MAIN, "bench": N_BENCH, "distorted": N_DIST, "mono": N_MONO}
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
    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK
    from visual_odometry_ros_tpu_torch.ops import pose_gn as PG

    calls, tensors = [], []
    # (ops/ba.py's launch arguments hold the tensors they point at.)
    helpers = {KK: ("_pyr_launch", "_scale_launch"), PG: ("_pg_launch",), BA: ()}
    orig = {(m, k): getattr(m, k) for m, names in helpers.items() for k in ("_launch", *names)}

    def rec(launch):
        def run(name, c_fn, argv):
            calls.append((name, c_fn, argv))
            return launch(name, c_fn, argv)
        return run

    def holding(helper):
        def run(*args):
            out = helper(*args)
            tensors.append((args, out))
            return out
        return run

    for m, names in helpers.items():
        m._launch = rec(orig[m, "_launch"])
        for k in names:
            setattr(m, k, holding(orig[m, k]))
    try:
        fn()
    finally:
        for (m, k), v in orig.items():
            setattr(m, k, v)
    return calls, tensors


def _img_bytes(levels) -> int:
    """Both pyramids' level images, read once."""
    return sum(2 * x.numel() * 4 for x in levels)


def _pt_bytes(n: int, out: int) -> int:
    """p0, the seed and valid read once, `out` bytes per feature written."""
    return n * (8 + 8 + 1) + n * out


def _feature_grid(H: int, W: int, rows: int, cols: int, dev):
    import torch

    gy, gx = np.meshgrid(np.linspace(12, H - 13, rows), np.linspace(12, W - 13, cols), indexing="ij")
    return torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1), dtype=torch.float32, device=dev)


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
    img_bytes, pt_bytes = _img_bytes, _pt_bytes
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


def mono_call_sites(imgs, dev):
    """MonoVO's two KLT call sites at the mono configuration, on frames
    MONO_PAIR -> MONO_PAIR + 1 of the mono sequence (N = 512): the steady
    track (the 2-D bidirectional climb from a prior seed, fb_scale 5,
    backward over level 0; the init track is the same launch seeded at p0)
    and the 30-iteration scale refinement (s in [0.9, 1.12], the range of
    forward motion's depth ratios). Same layout as `klt_call_sites`."""
    import torch

    from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO
    from visual_odometry_ros_tpu_torch.ops import klt as KLT
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    vo = MonoVO(mono_config(), device=dev)
    img_a = torch.as_tensor(imgs[MONO_PAIR], dtype=torch.float32, device=dev)
    img_b = torch.as_tensor(imgs[MONO_PAIR + 1], dtype=torch.float32, device=dev)
    pyr_a, pyr_b = vo._build_pyr(img_a), vo._build_pyr(img_b)
    lv_a, lv_b = [lv[0] for lv in pyr_a], [lv[0] for lv in pyr_b]
    p = _feature_grid(*img_a.shape, 16, 32, dev)
    rng = np.random.default_rng(1)
    seed = (p + torch.as_tensor(rng.uniform(-2, 2, p.shape), dtype=torch.float32, device=dev)).contiguous()
    sc = torch.as_tensor(rng.uniform(0.9, 1.12, len(p)), dtype=torch.float32, device=dev)
    valid = torch.ones(len(p), dtype=torch.bool, device=dev)
    kp = vo.klt_params
    p1, ok = KLT.track_bidirectional_pyr(pyr_a, pyr_b, p, seed, valid, kp, fb_scale=5.0, back_levels=1)
    p1 = p1.contiguous()
    track = (lv_a, lv_b, p, seed, valid, kp.window_radius, kp.iters, kp.iters_coarse, kp.eps, kp.min_eig,
             False, 1)
    scale = (img_a, img_b, p, p1, sc, ok, 11, 30)
    return {
        "mono_track": dict(
            call=lambda: KLT.track_bidirectional_pyr(pyr_a, pyr_b, p, seed, valid, kp, fb_scale=5.0,
                                                     back_levels=1),
            wrapper=lambda: KK.track_pyr_bidir(*track),
            plain=lambda c: KK.track_pyr_bidir_ref(*track, counts=c),
            bytes=_img_bytes(lv_a) + _pt_bytes(len(p), 8 + 4 + 1 + 8 + 1)),
        "mono_scale": dict(
            call=lambda: KLT.track_with_scale(img_a, img_a, img_a, img_b, p, p1, sc, ok, use_kernel=True),
            wrapper=lambda: KK.track_scale(*scale), plain=lambda c: KK.track_scale_ref(*scale, counts=c),
            bytes=2 * img_a.numel() * 4 + _pt_bytes(len(p), 4 + 8 + 4 + 1)),
    }


def call_site_times(sites, card):
    """For each KLT call site of `sites` ({name: {call, wrapper, plain,
    bytes}}): its kernel launches (exactly one), device ms per call (the C
    launcher alone, replayed back to back), host us per call of the
    kernel's wrapper and of the call site, the plain version's ms, and the
    bound from this run's work counts."""
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
    """The kernel launch counts since the last `reset_counts`; every KLT and
    pose kernel must have run, pose_gn once for each call of a public pose
    function (pose solves less pairs: a pair's two solves share one), and the ba_* kernels exactly as the single-device BA solves on
    the card enqueue them (`ba_launches_ok`), at least one of them on a path
    whose keyframe steps ran."""
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    counts = dict(KN.LAUNCHES)
    for name in counts:
        assert name in BA_KERNELS or counts[name] > 0, f"{phase}: the path never launched {name}"
    assert counts["pose_gn"] == POSE_CALLS["pose_calls"] - POSE_CALLS["pose_pairs"], (
        f"{phase}: {counts['pose_gn']} pose_gn launches for {POSE_CALLS['pose_calls']} pose solves, "
        f"{POSE_CALLS['pose_pairs']} of them a second solve in a shared launch")
    assert ba_launches_ok({**counts, **BA_CALLS}), f"{phase}: ba launches {counts} for the solves {BA_CALLS}"
    return counts


def ba_launches_ok(d: dict) -> bool:
    """The ba_* launches of `d` (launch counts and BA_CALLS, or a difference
    of two such) are what its single-device solves enqueue: per solve of
    `iters` iterations, 3 iters + 2: ba_terms iters + 2 times (the errors
    before and after), ba_solve and ba_backsub (the apply step inside
    both) iters times."""
    want = {"ba_terms": d["ba_iters"] + 2 * d["ba_solves"], "ba_solve": d["ba_iters"], "ba_backsub": d["ba_iters"]}
    return all(d[k] == v for k, v in want.items())


# Solves of the public pose functions on CUDA tensors while `pose_calls`
# runs: all of them, the robust ones (the pose stage of a tracked frame; the
# others are the PnP polishes of a recovery), and the pairs (the second
# solve of each `pose_only_gn_mono_many` call of two: a recovery's two
# polishes, which share one launch).
MANY = "pose_only_gn_mono_many"
POSE_FNS = ("pose_only_gn_stereo_robust", "pose_only_gn_mono_robust", "pose_only_gn_mono", "pose_only_gn_stereo",
            MANY)
POSE_CALLS = {"pose_calls": 0, "pose_robust": 0, "pose_pairs": 0}
# Single-device window BA solves on CUDA tensors while `pose_calls` runs
# (ops/ba.ba_solve_impl without a group), and the iterations they enqueue.
BA_CALLS = {"ba_solves": 0, "ba_iters": 0}


def reset_counts() -> None:
    """Sets the kernel launch counts, POSE_CALLS and BA_CALLS to 0."""
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    KN.reset_launch_counts()
    for d in (POSE_CALLS, BA_CALLS):
        for k in d:
            d[k] = 0


def counts() -> dict:
    """The kernel launch counts, POSE_CALLS and BA_CALLS, for per-frame
    differences."""
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    return dict(KN.LAUNCHES, **POSE_CALLS, **BA_CALLS)


def diff(before: dict) -> dict:
    now = counts()
    return {k: now[k] - before[k] for k in before}


@contextlib.contextmanager
def pose_calls():
    """While the block runs, POSE_CALLS counts the solves of the public pose
    functions on CUDA tensors and BA_CALLS the single-device BA solves
    (ops/ba.ba_solve_impl) on them. Yields `record`: `with record() as log`
    keeps the block's calls in log, {name: [(args, kwargs)]}, the first
    POSE_LOG_MAX of each pose function and BA_LOG_MAX BA solves
    ("ba_solve_impl"), tensors cloned."""
    import torch

    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.ops import pose_gn as PG
    from visual_odometry_ros_tpu_torch.ba_ab import tensors

    orig = {n: getattr(PG, n) for n in POSE_FNS}
    orig_ba = BA.ba_solve_impl
    sink = [None]

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return type(x)(*map(clone, x)) if isinstance(x, BA.BAProblem) else x

    def counted_ba(*a, **kw):
        params = kw.get("params", a[6] if len(a) > 6 else BA.BAParams())
        if a[0].T_cw.is_cuda and kw.get("group", a[7] if len(a) > 7 else None) is None:
            BA_CALLS["ba_solves"] += 1
            BA_CALLS["ba_iters"] += params.iters
            log = sink[0]
            if log is not None and len(log["ba_solve_impl"]) < BA_LOG_MAX:
                log["ba_solve_impl"].append((tuple(map(clone, a)), dict(kw)))
        return orig_ba(*a, **kw)

    def counted(name):
        def run(*a, **kw):
            if (a[0][0][0] if name == MANY else a[0]).is_cuda:
                solves = len(a[0]) if name == MANY else 1
                POSE_CALLS["pose_calls"] += solves
                POSE_CALLS["pose_pairs"] += solves - 1
                POSE_CALLS["pose_robust"] += name.endswith("_robust")
                log = sink[0]
                if log is not None and len(log[name]) < POSE_LOG_MAX:
                    log[name].append((tensors(a, torch.Tensor.clone), dict(kw)))
            return orig[name](*a, **kw)
        return run

    @contextlib.contextmanager
    def record():
        sink[0] = {n: [] for n in (*POSE_FNS, "ba_solve_impl")}
        try:
            yield sink[0]
        finally:
            sink[0] = None

    for n in POSE_FNS:
        setattr(PG, n, counted(n))
    BA.ba_solve_impl = counted_ba
    try:
        yield record
    finally:
        for n, f in orig.items():
            setattr(PG, n, f)
        BA.ba_solve_impl = orig_ba


def pose_bytes(stereo: bool, robust: bool, n: int) -> int:
    """Bytes a solve must move: X0, pts, valid (and the right view's), T_init
    (and T_rl) read once; T, inliers, mean_err, ok, n_iter (and err) written once."""
    read = n * (12 + 8 + 1) + 64 + (n * (8 + 1) + 64 if stereo else 0)
    return read + 64 + n + 4 + 1 + 4 + (4 * n if robust else 0)


def pose_gn_checks(cases: dict, card: str) -> dict:
    """Phase 3, pose_gn, on the recorded inputs `cases` ({name: (function
    name, args, kwargs)}; `pose_only_gn_mono_many` takes its solves in one
    launch): one launch per call, two launches bit-identical, each solve of
    a several-solve launch bit-identical to its own single launch, kernel
    against `*_ref` to the POSE_TOL_* tolerances, n_iter of both; then
    device ms per launch (the C launcher replayed 100 times back to back
    between CUDA events) and per iteration (of the call's longest solve),
    wrapper host us, the plain version's ms and the bound from the plain
    version's work counts on these inputs (the weighted points of each pass
    times its iterations). Each case is saved for `pose_ab`. Returns {name:
    row}."""
    import torch

    from visual_odometry_ros_tpu_torch.ops import kernels as KN
    from visual_odometry_ros_tpu_torch.ops import pose_gn as PG

    def flat(results):
        return [t for r, e in results for t in (*r, *([] if e is None else [e]))]

    def worst(a, b):  # the larger, and NaN fails the gate as it would alone
        return float("inf") if b != b else max(a, b)

    rows = {}
    for name, (fn_name, args, kwargs) in cases.items():
        many = fn_name == "pose_only_gn_mono_many"
        robust = fn_name.endswith("_robust")
        stereo = "stereo" in fn_name
        fn, ref = getattr(PG, fn_name), getattr(PG, fn_name + "_ref")
        # Each solve as a single call: (function name, args).
        singles = [("pose_only_gn_mono", (*sv, *args[1:])) for sv in args[0]] if many else [(fn_name, args)]

        def call(f):
            """[(PoseGNResult, err or None)], one per solve."""
            out = f(*args, **kwargs)
            return [(r, None) for r in out] if many else [out if robust else (out, None)]

        KN.reset_launch_counts()
        got, again = call(fn), call(fn)
        assert KN.LAUNCHES["pose_gn"] == 2, f"{name}: {KN.LAUNCHES['pose_gn']} launches for two calls"
        want = call(ref)
        alone = [(PG.pose_only_gn_mono(*a, **kwargs), None) for _, a in singles] if many else got
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
        same_alone = all(torch.equal(a, b) for a, b in zip(flat(got), flat(alone)))
        d_T = d_mean = d_err = edge = px = 0.0
        n_flip, same_nan = 0, True
        for (one, a), (rk, ek), (rr, er) in zip(singles, got, want):
            st = "stereo" in one
            X0, pts_l = a[0], a[1]
            fx, fy, cx, cy = a[5:9] if st else a[3:7]
            i_params = 11 if st else 8  # after T_10_init
            params = a[i_params] if len(a) > i_params else kwargs.get("params", PG.PoseGNParams())
            thr = params.reproj_thresh
            px = max(px, max(fx, fy) * POSE_TOL_T)  # the pixel shift of a pose within POSE_TOL_T
            e_ref = PG._reproj_err_px(rr.T10, X0, pts_l, fx, fy, cx, cy)
            flip = rk.inliers != rr.inliers
            n_flip += int(flip.sum())
            edge = worst(edge, float((e_ref[flip] - thr).abs().max()) if bool(flip.any()) else 0.0)
            d_T = worst(d_T, float((rk.T10 - rr.T10).abs().max()))
            d_mean = worst(d_mean, abs(float(rk.mean_err) - float(rr.mean_err)) - POSE_TOL_ERR * abs(float(rr.mean_err)))
            if ek is not None:
                d_err = worst(d_err, float(((ek - er).abs() - POSE_TOL_ERR * er.abs()).nan_to_num(0.0).max()))
                same_nan = same_nan and torch.equal(ek.isnan(), er.isnan())
        n = [a[0].shape[0] for _, a in singles]
        n_iter = [[int(r.n_iter) for r, _ in got], [int(r.n_iter) for r, _ in want]]
        row = {"case": name, "function": fn_name, "solves": len(singles), "n": n,
               "n_valid": [int(a[3 if "stereo" in one else 2].sum()) for one, a in singles],
               "ok": [[bool(r.ok) for r, _ in got], [bool(r.ok) for r, _ in want]],
               "n_iter_kernel_plain": n_iter, "max_abs_err_T10": d_T, "inliers_flipped": n_flip,
               "flipped_max_px_from_thresh": edge, "mean_err_excess": d_mean,
               "err_excess_px": d_err if robust else None, "px_tol": px, "bit_identical_relaunch": same,
               "bit_identical_to_single_launches": same_alone}
        print(json.dumps(row))
        assert same, f"{name}: two launches on the same inputs differ"
        assert same_alone, f"{name}: a solve of the shared launch differs from its own launch"
        assert row["ok"][0] == row["ok"][1] and d_T <= POSE_TOL_T, row
        assert edge <= px and same_nan, row
        assert d_mean <= 0.0, row
        assert not robust or d_err <= px, row

        work = {}
        ref(*args, **kwargs, counts=work)
        b_ms, b_by = bound(work, sum(pose_bytes(stereo, robust, k) for k in n))
        calls, tensors = recorded_launches(lambda: call(fn))
        assert [c[0] for c in calls] == ["pose_gn"], f"{name}: launches per call {[c[0] for c in calls]}"
        row.update(ms=device_ms([(c[1], c[2]) for c in calls]), bound_ms=b_ms, bound_by=b_by,
                   plain_ms=cuda_ms(lambda: call(ref), reps=5, warmup=1), host_us=host_us(lambda: call(fn)),
                   saved=save_pose_case(name, fn_name, args, kwargs))
        del tensors  # held until the replays are done
        row["bound_share"] = b_ms / row["ms"]
        row["us_per_iter"] = row["ms"] * 1e3 / max(max(n_iter[0]), 1)
        rows[name] = row
        print(f"time pose_gn {name} ({fn_name}, {len(n)} solve(s), N={n}, {n_iter[0]} iterations): device "
              f"{row['ms']:.4f} ms per launch (100 back-to-back launches), {row['us_per_iter']:.2f} us per "
              f"iteration, bound {b_ms:.6f} ms by {b_by}, plain {row['plain_ms']:.4f} ms, wrapper host "
              f"{row['host_us']:.1f} us per call on {card}")
    return rows


def save_pose_case(name: str, fn_name: str, args: tuple, kwargs: dict) -> str:
    """One recorded pose call (the public function's name, its arguments,
    tensors on the CPU) under build/chip_smoke_pose/, for `python -m
    visual_odometry_ros_tpu_torch.pose_ab` and `kernel_split` to time in
    another tree of the port."""
    import torch

    from visual_odometry_ros_tpu_torch.ba_ab import tensors

    path = os.path.join(ROOT, "build", "chip_smoke_pose", name + ".pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"function": fn_name, "args": tensors(args, torch.Tensor.cpu), "kwargs": kwargs}, path)
    return path


def ba_work(problem, params, iters: int) -> dict:
    """{kernel: (operations, bytes)} that a solve of `iters` iterations
    needs on `problem`, from its masks as the solve sees them (OPS' ba_*
    entries; a kernel's bytes are the inputs it must read and the outputs it
    must write once per solve: ba_terms the observations, points and poses
    in and, since it writes the window back, the points, kill flags and
    poses out; ba_solve the poses; ba_backsub dy and, since it runs the
    apply step (its blocks Xr += dy, its last block the decision), that
    step's work too; ba_apply the apply step alone, the points in and
    out)."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    an = BA._anchor(problem, params)
    opt = an.opt_mask[None, :]
    n_left, n_right = int((an.mask & opt).sum()), int((an.mask_r & opt).sum())
    n_left_fix, n_right_fix = int((an.mask & ~opt).sum()), int((an.mask_r & ~opt).sum())
    seen = an.mask | an.mask_r
    per_lm = (seen & opt).sum(dim=1)  # optimisable slots each landmark is seen in
    pairs, pairs_opt = int(seen.sum()), int(per_lm.sum())
    pair_pairs = int((per_lm * (per_lm - 1) // 2).sum())  # j < k
    lms = int(an.lm_active.sum())
    M = problem.Xw.shape[0]
    K, K_opt = problem.T_cw.shape[0], int(an.opt_mask.sum())
    n = 6 * K_opt
    ops = {
        "ba_terms": iters * (OPS["ba_left_pair"] * n_left + OPS["ba_right_pair"] * n_right
                             + OPS["ba_left_pair_fixed"] * n_left_fix + OPS["ba_right_pair_fixed"] * n_right_fix
                             + OPS["ba_pair"] * pairs + OPS["ba_pair_opt"] * pairs_opt
                             + OPS["ba_pair_pair"] * pair_pairs + OPS["ba_pair_diag"] * pairs_opt
                             + OPS["ba_landmark"] * lms)
        + 2 * OPS["ba_err_pair"] * int(an.mask.sum()),
        "ba_solve": iters * (n ** 3 // 3 + n * n + 2 * n * n + OPS["ba_pose"] * K_opt),
        "ba_backsub": iters * (OPS["ba_backsub_pair"] * pairs_opt + OPS["ba_backsub_landmark"] * lms
                               + OPS["ba_apply_landmark"] * lms),
        "ba_apply": iters * OPS["ba_apply_landmark"] * lms,
    }
    nbytes = {
        "ba_terms": 2 * M * K + 8 * int(an.mask.sum() + an.mask_r.sum()) + 12 * M + M + 64 * K + K
        + 12 * M + M + 64 * K,
        "ba_solve": 2 * 64 * K,
        "ba_backsub": 12 * M + 24 * M + 64 * K,
        "ba_apply": 24 * M + 64 * K,
    }
    return {k: (ops[k], nbytes[k]) for k in BA_PARTS}


def kernel_split_ms(calls, reps=5, whole_ms=None) -> dict:
    """Device ms per replay of `calls` (C launcher calls) spent in each ba_*
    kernel: torch.profiler's kernel events over `reps` replays, by name.
    Given `whole_ms` (the replay's device ms), a split whose kernels add up
    to less than half of it (the profiler now and then records no kernel
    event) is taken again, up to three times in all, and then raises."""
    for _ in range(3 if whole_ms else 1):
        split = _profiled_split_ms(calls, reps)
        if not whole_ms or sum(split.values()) >= 0.5 * whole_ms:
            return split
    raise AssertionError(f"the profiler's ba_* kernels add up to {sum(split.values()):.4f} ms "
                         f"of a {whole_ms:.4f} ms solve in three tries: {split}")


def _profiled_split_ms(calls, reps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for _, fn, argv in calls:
                fn(*argv)
        torch.cuda.synchronize()
    split = dict.fromkeys(BA_KERNELS, 0.0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for k in BA_KERNELS:
            if f"{k}_kernel" in e.name():
                split[k] += (e.end_ns() - e.start_ns()) * 1e-6 / reps
    return split


def plain_split_ms(problem, fx, fy, cx, cy, T_rl, params, iters: int) -> dict:
    """The plain version's time (CUDA events) for each part's share of
    a solve of `iters` iterations at the start state of `problem`: per
    iteration build_observation_terms, assemble_normal_blocks and
    schur_reduce with the divergence flags (ba_terms, which also takes the
    two error sums and, once, `_anchor` and `_write_back`), solve_reduced
    (ba_solve), back_substitute (ba_backsub), the guard and the update
    (ba_apply, inside ba_backsub's launch)."""
    import torch

    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.utils import geometry as geo

    an = BA._anchor(problem, params)
    mask, mask_r, T_cr, Xr = an.mask, an.mask_r, an.T_cr, an.Xr
    obs = (problem.pts, mask, problem.pts_r, mask_r, fx, fy, cx, cy, T_rl)

    def terms():
        w, r, Q, Rj = BA.build_observation_terms(T_cr, Xr, *obs, params.huber_delta)
        A, a, C, b, B = BA.assemble_normal_blocks(w, r, Q, Rj)
        S, s, Cinv, _ = BA.schur_reduce(A, a, C, b, B, params.lam)
        bad = an.lm_active & ~(torch.isfinite(Cinv).all(dim=(1, 2)) & torch.isfinite(b).all(dim=1)
                               & torch.isfinite(B).all(dim=(1, 2, 3)))
        return S, s, Cinv, b, B, torch.sum(bad)

    def err():
        _, r_, _, _ = BA.build_observation_terms(T_cr, Xr, *obs, 1e9)
        return torch.sum(torch.sqrt(torch.sum(r_[..., :2] ** 2, dim=-1)) * mask), torch.sum(mask)

    S, s, Cinv, b, B, n_bad = terms()
    dx = BA.solve_reduced(S, s, an.opt_mask)
    dy = torch.where(an.lm_active[:, None], BA.back_substitute(Cinv, b, B, dx), 0.0)

    def apply():
        bad = (~torch.all(torch.isfinite(dx)) | (n_bad > 0) | ~torch.all(torch.isfinite(dy))
               | (torch.amax(torch.linalg.norm(dx[:, :3], dim=-1)) > params.max_trans_update))
        d = torch.where(bad, 0.0, dx)
        T = torch.where(an.opt_mask[:, None, None], geo.add_front_se3(T_cr, d), T_cr)
        return T, Xr + torch.where(bad, 0.0, dy), torch.amax(torch.abs(d)) < 1e-5

    def ends():
        a = BA._anchor(problem, params)
        return BA._write_back(problem, params, a, a.T_cr, a.Xr, *[torch.zeros((), device=T_cr.device)] * 4)

    def ms(fn):
        return cuda_ms(fn, reps=5, warmup=1)

    return {"ba_terms": iters * ms(terms) + 2 * ms(err) + ms(ends),
            "ba_solve": iters * ms(lambda: BA.solve_reduced(S, s, an.opt_mask)),
            "ba_backsub": iters * ms(lambda: BA.back_substitute(Cinv, b, B, dx)),
            "ba_apply": iters * ms(apply)}


def ba_host_split(solve, reps=20) -> dict:
    """Host us per call of `solve` (a single-device ba_solve_impl on CUDA
    tensors) in each part of the kernel route: the input checks (`_check`),
    the 3 iters + 2 ctypes launches (`kernels.launch`), the small ops that
    turn the kernels' per-block error sums into the result (`_result`), and
    the rest (the build lookup, scratch from torch.empty, `_Args`, the
    per-block sums' reduction) as the total less these; perf_counter around
    each part over `reps` calls, no synchronise inside. The timers add ~0.3
    us a part."""
    import torch

    from visual_odometry_ros_tpu_torch.ops import ba as BA

    parts = {"check": "_check", "launches": "_launch", "result": "_result"}
    acc = dict.fromkeys(parts, 0.0)
    orig = {k: getattr(BA, v) for k, v in parts.items()}

    def timed(key):
        fn = orig[key]

        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t
        return run

    for k, v in parts.items():
        setattr(BA, v, timed(k))
    try:
        solve()
        torch.cuda.synchronize()
        acc.update(dict.fromkeys(parts, 0.0))
        t = time.perf_counter()
        for _ in range(reps):
            solve()
        total = time.perf_counter() - t
        torch.cuda.synchronize()
    finally:
        for k, v in parts.items():
            setattr(BA, v, orig[k])
    out = {k: v / reps * 1e6 for k, v in acc.items()}
    out["rest"] = total / reps * 1e6 - sum(out.values())
    out["total"] = total / reps * 1e6
    return out


def ba_occupancy(K: int, n_fix: int) -> dict:
    """How each ba_* launch of a window of K slots sits on the card
    (ba_gn.cu's `ba_occupancy`: cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor): {launch: {registers,
    static and dynamic shared bytes, threads, blocks per SM}}."""
    import ctypes

    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    out = (ctypes.c_int * 20)()
    rc = KN.build().ba_occupancy(K, n_fix, out)
    assert rc == 0, f"ba_occupancy: cudaError {rc}"
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "threads", "blocks_per_sm")
    return {name: dict(zip(keys, out[5 * i:5 * i + 5]))
            for i, name in enumerate(("ba_terms", "ba_terms_err", "ba_solve", "ba_backsub"))}


def ba_solve_library_ms(problem, fx, fy, cx, cy, T_rl, params) -> dict:
    """The yardstick for ba_solve, which the port never calls: one
    torch.linalg.cholesky_ex and one torch.cholesky_solve of the Jacobi-
    equilibrated reduced system at the problem's anchored start (CUDA
    events), at n = 6 K (solve_reduced's gated system) and at n = 6 n_opt
    (the optimisable slots only, what ba_solve factors)."""
    import torch

    from visual_odometry_ros_tpu_torch.ops import ba as BA

    an = BA._anchor(problem, params)
    w, r, Q, Rj = BA.build_observation_terms(an.T_cr, an.Xr, problem.pts, an.mask, problem.pts_r, an.mask_r,
                                             fx, fy, cx, cy, T_rl, params.huber_delta)
    S, s, _, _ = BA.schur_reduce(*BA.assemble_normal_blocks(w, r, Q, Rj), params.lam)
    Hn, z, _ = BA.equilibrated_system(S, s, an.opt_mask)
    idx = an.opt_mask.repeat_interleave(6)  # the optimisable slots' rows: their own equilibrated system

    def solve(Hn, z):
        L, _ = torch.linalg.cholesky_ex(Hn)
        return torch.cholesky_solve(z[:, None], L)

    comp = (Hn[idx][:, idx].contiguous(), z[idx])
    return {"n_full": len(z), "ms_full": cuda_ms(lambda: solve(Hn, z), reps=50, warmup=5),
            "n_opt": len(comp[1]), "ms_opt": cuda_ms(lambda: solve(*comp), reps=50, warmup=5)}


def save_ba_problem(name: str, args: tuple, kwargs: dict) -> str:
    """One recorded BA problem (ba_solve_impl's arguments, tensors on the
    CPU) under build/chip_smoke_ba/, for `python -m
    visual_odometry_ros_tpu_torch.ba_ab` to time in another tree of the
    port."""
    import torch

    from visual_odometry_ros_tpu_torch.ba_ab import tensors

    path = os.path.join(ROOT, "build", "chip_smoke_ba", name + ".pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save((tuple(tensors(a, torch.Tensor.cpu) for a in args), {k: v for k, v in kwargs.items() if k != "info"}),
               path)
    return path


def ba_checks(cases: dict, card: str) -> dict:
    """Phase 3, ba_*, on the recorded window BA problems `cases` ({name:
    (args, kwargs) of ops/ba.ba_solve_impl}): launches per solve as
    `launches_per_solve(iters)` says, two solves bit-identical, the kernels
    against ba_solve_ref to BA_KTOL, both against a float64 run of
    ba_solve_ref on the CPU (a witness, not a gate); then device ms per
    solve (the solve's C launcher calls replayed 20 times back to back
    between CUDA events) and its split by kernel (torch.profiler), ba_backsub's
    device us per working and per stopped launch (`ba_ab.launch_us`), the
    wrapper's host us per solve and per part (`ba_host_split`), the plain
    version's ms per solve and per kernel share, each kernel's bound from
    the problem's masks, ba_solve's library yardstick
    (`ba_solve_library_ms`) and how each launch sits on the card
    (`ba_occupancy`). Each problem is saved for `ba_ab` (`save_ba_problem`).
    Returns {name: row}."""
    import torch

    from visual_odometry_ros_tpu_torch.ba_ab import launch_us
    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    def cpu64(a):
        if isinstance(a, BA.BAProblem):
            return BA.BAProblem(*map(cpu64, a))
        if isinstance(a, torch.Tensor):
            return (a.double() if a.is_floating_point() else a).cpu()
        return a

    rows = {}
    for name, (args, kwargs) in cases.items():
        kwargs = {k: v for k, v in kwargs.items() if k != "info"}
        problem, (fx, fy, cx, cy), T_rl = args[0], args[1:5], args[5]
        params = args[6] if len(args) > 6 else kwargs.get("params", BA.BAParams())

        def solve(fn, info=None):
            return fn(*args, **kwargs, **({} if info is None else {"info": info}))

        info_k, info_r = {}, {}
        KN.reset_launch_counts()
        rk, rk2 = solve(BA.ba_solve_impl, info_k), solve(BA.ba_solve_impl)
        launches = {k: KN.LAUNCHES[k] for k in BA_KERNELS}
        rr = solve(BA.ba_solve_ref, info_r)
        torch.cuda.synchronize()
        assert ba_launches_ok({**launches, "ba_solves": 2, "ba_iters": 2 * params.iters}), (name, launches)
        same = all(torch.equal(a, b) for a, b in zip(rk, rk2))
        d_T = float((rk.T_cw - rr.T_cw).abs().max())
        x_excess = float(((rk.Xw - rr.Xw).abs() - BA_KTOL["Xw"] * (1.0 + rr.Xw.abs())).max())
        r_err = abs(float(rk.mean_err_px) - float(rr.mean_err_px)) / abs(float(rr.mean_err_px))
        r_err0 = abs(float(rk.mean_err0_px) - float(rr.mean_err0_px)) / abs(float(rr.mean_err0_px))
        K, M = problem.T_cw.shape[0], problem.Xw.shape[0]
        row = {"case": name, "K": K, "M": M, "kf_valid": int(problem.kf_valid.sum()),
               "lm_valid": int(problem.lm_valid.sum()), "obs_left": int((problem.mask & problem.kf_valid).sum()),
               "iters_kernel_plain": [info_k["iters"], info_r["iters"]], "max_abs_err_T_cw": d_T,
               "max_abs_err_Xw_m": float((rk.Xw - rr.Xw).abs().max()), "Xw_excess_over_tol_m": x_excess,
               "mean_err_px": [float(rk.mean_err_px), float(rr.mean_err_px)], "mean_err_rel": r_err,
               "mean_err0_rel": r_err0, "killed": [int(rk.killed.sum()), int(rr.killed.sum())],
               "n_obs": [int(rk.n_obs), int(rr.n_obs)], "launches_per_solve": sum(launches.values()) // 2,
               "bit_identical_relaunch": same}
        print(json.dumps(row))
        assert same, f"{name}: two solves on the same inputs differ"
        assert d_T <= BA_KTOL["T_cw"] and x_excess <= 0.0, row
        assert r_err <= BA_KTOL["err"] and r_err0 <= BA_KTOL["err0"], row
        assert torch.equal(rk.killed, rr.killed) and row["n_obs"][0] == row["n_obs"][1], row
        assert abs(info_k["iters"] - info_r["iters"]) <= 1, row

        # A witness for the float32 spread: the plain version in float64 on
        # the CPU (the same formulas, rounded 2^29 times finer).
        T64 = BA.ba_solve_ref(*map(cpu64, args), **kwargs).T_cw
        row["max_abs_err_T_cw_vs_float64"] = {
            "kernels": float((rk.T_cw.cpu().double() - T64).abs().max()),
            "plain": float((rr.T_cw.cpu().double() - T64).abs().max())}
        print(json.dumps({"case": name, "max_abs_err_T_cw_vs_float64": row["max_abs_err_T_cw_vs_float64"]}))

        calls, tensors = recorded_launches(lambda: solve(BA.ba_solve_impl))
        assert [c[0] for c in calls] == ["ba_terms"] + list(BA_KERNELS) * params.iters + ["ba_terms"], name
        work = ba_work(problem, params, info_k["iters"])
        bounds = {}
        for k, (ops, nb) in work.items():
            t_ops, t_bytes = ops / PEAK_FP32, nb / PEAK_BYTES
            bounds[k] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
        row.update(ms=device_ms([(c[1], c[2]) for c in calls], reps=20))
        row.update(split_ms=kernel_split_ms(calls, whole_ms=row["ms"]),
                   backsub_us=launch_us(calls, "ba_backsub", info_k["iters"]),
                   plain_ms=cuda_ms(lambda: solve(BA.ba_solve_ref), reps=3, warmup=1),
                   plain_split_ms=plain_split_ms(problem, fx, fy, cx, cy, T_rl, params, info_k["iters"]),
                   host_us=host_us(lambda: solve(BA.ba_solve_impl), reps=20),
                   host_split_us=ba_host_split(lambda: solve(BA.ba_solve_impl)),
                   bound_ms={k: b[0] for k, b in bounds.items()}, bound_by={k: b[1] for k, b in bounds.items()},
                   library=ba_solve_library_ms(problem, fx, fy, cx, cy, T_rl, params),
                   occupancy=ba_occupancy(K, params.n_fix), saved=save_ba_problem(name, args, kwargs))
        del tensors
        b_all = sum(row["bound_ms"][k] for k in BA_KERNELS)  # ba_apply's work is in ba_backsub's
        row["bound_share"] = b_all / row["ms"]
        rows[name] = row
        print(f"time ba_* {name} (K={K}, M={M}, {info_k['iters']} of {params.iters} iterations, "
              f"{row['launches_per_solve']} launches): device {row['ms']:.4f} ms per solve (20 back-to-back "
              f"solves), by kernel " + ", ".join(f"{k} {v:.4f}" for k, v in row["split_ms"].items())
              + f" ms (ba_backsub {row['backsub_us']['working']:.2f} us a working launch, "
              + (f"{row['backsub_us']['stopped']:.2f} a stopped one" if row["backsub_us"]["stopped"]
                 else "none stopped")
              + f"); bound {b_all:.6f} ms (" + ", ".join(f"{k} {row['bound_ms'][k]:.6f} by {row['bound_by'][k]}"
                                                         for k in BA_KERNELS)
              + f"; of ba_backsub's, the apply step {row['bound_ms']['ba_apply']:.6f}"
              + f"); plain {row['plain_ms']:.3f} ms per solve (by share " + ", ".join(
                  f"{k} {v:.3f}" for k, v in row["plain_split_ms"].items())
              + f"); wrapper host {row['host_us']:.1f} us per solve (" + ", ".join(
                  f"{k} {v:.1f}" for k, v in row["host_split_us"].items()) + f" us) on {card}")
        lib = row["library"]
        print(f"time ba_solve {name} library yardstick (cholesky_ex + cholesky_solve, CUDA events): "
              f"{lib['ms_full']:.4f} ms at n = {lib['n_full']}, {lib['ms_opt']:.4f} ms at n = {lib['n_opt']} "
              f"per call; ba_solve {row['split_ms']['ba_solve'] / max(info_k['iters'], 1):.4f} ms per iteration "
              f"on {card}")
        print(f"occupancy ba_* {name} (K = {K}): " + "; ".join(
            f"{k} {v['registers']} registers, {v['static_smem_bytes']} + {v['dynamic_smem_bytes']} B shared, "
            f"{v['threads']} threads, {v['blocks_per_sm']} blocks/SM" for k, v in row["occupancy"].items()))
    return rows


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def per_frame_path(frames, device, card):
    """Phases 4 and 5: the 0.25 m/frame corridor through track_stereo_images,
    the last N_TIMED frames with timed=True."""
    from visual_odometry_ros_tpu_torch.io import ate_rmse
    from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

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
    reset_counts()
    frame_ms, frame_launches = [], []
    for il, ir in pairs[:n_plain]:
        before = counts()
        replenishes[0] = 0
        sync(device)
        t = time.perf_counter()
        vo.track_stereo_images(il, ir)
        sync(device)
        frame_ms.append((time.perf_counter() - t) * 1e3)
        frame_launches.append(dict(diff(before), replenish=replenishes[0]))
    launches = launched("per-frame path")
    tracked = [dict(n, n_new=s["n_new"], recovered=s.get("recovered", 0))
               for s, n in zip(vo.stats_log[1:], frame_launches[1:])]
    kinds = {}
    for n in tracked:
        kind = "replenish" if n["replenish"] else "steady"
        kinds.setdefault(kind, set()).add(json.dumps({k: n[k] for k in KN.LAUNCHES}, sort_keys=True))
    print(json.dumps({"klt_launches_per_frame": {k: sorted(v) for k, v in kinds.items()},
                      "frames": tracked}))
    # A tracked frame: one klt_pyr launch each for the track climb and the
    # stereo pass, one more for each replenish it ran; one klt_scale; one
    # pose solve, the robust one, in one pose_gn launch.
    # A keyframe: one BA solve, its launches as launches_per_solve says.
    for n, s in zip(tracked, vo.stats_log[1:]):
        assert not n["recovered"], f"recovery fired at {STEP_MAIN} m/frame: {n}"
        assert n["klt_scale"] == 1 and n["klt_pyr"] == 2 + n["replenish"], f"KLT launches of a frame: {n}"
        assert n["pose_gn"] == n["pose_calls"] == n["pose_robust"] == 1, f"pose_gn launches of a frame: {n}"
        assert n["ba_solves"] == int(s["keyframe"]) and ba_launches_ok(n), f"ba launches of a frame: {n}"
    steady = [ms for ms, s in zip(frame_ms[3:], vo.stats_log[3:]) if not s["keyframe"]]
    print(f"time steady frame: median {statistics.median(steady):.2f} ms over {len(steady)} frames; "
          f"keyframe step: median {statistics.median(kf_ms[1:] or kf_ms):.2f} ms over "
          f"{len(kf_ms)} keyframes; first frame {frame_ms[0]:.1f} ms; on {card}")

    reset_counts()
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
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    il, ir, poses = frames["bench"]
    vo = StereoVO(bench_config(), device=device)
    steps = []
    orig_step = vo._steady_step

    def logged_step(*a, **kw):
        before = counts()
        out = orig_step(*a, **kw)
        steps.append(diff(before))
        return out

    vo._steady_step = logged_step
    reset_counts()
    batch_s = []
    for a, b in ((0, 13), (13, N_BENCH)):
        sync(device)
        t = time.perf_counter()
        vo.track_stereo_batch(il[a:b], ir[a:b])
        sync(device)
        batch_s.append((b - a, time.perf_counter() - t))
    launches = launched("serving path")
    # A steady step: one robust pose solve, and the PnP polishes of a
    # recovery, in pairs; one pose_gn launch for each solve, a pair's two
    # solves in one.
    pose_steps = [[st["pose_gn"], st["pose_calls"], st["pose_robust"], st["pose_pairs"]] for st in steps]
    assert len(steps) == N_BENCH - 1 and all(a == b - d and c == 1 for a, b, c, d in pose_steps), (
        f"per steady step [pose_gn launches, pose solves, robust solves, pairs]: {pose_steps}")
    assert any(d > 0 for *_, d in pose_steps), f"no recovery ran a pair of PnP polishes: {pose_steps}"
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
        "launches": launches, "pose_gn_solves_robust_pairs_per_step": pose_steps, "ate_m": ate,
        "ate_bound_m": ATE_BENCH_BOUND_M,
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
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    il, ir, poses = frames["distorted"]
    cfg = bench_config()
    c = cfg.cam
    c.width, c.height, c.fx, c.fy, c.cx, c.cy = 640, 480, 500.0, 500.0, 320.0, 240.0
    c.k1, c.k2, c.p1, c.p2, c.k3 = DIST
    cfg.cam_right = c
    cfg.T_lr[0, 3] = 0.5
    cfg.flagDoUndistortion = True
    vo = StereoVO(cfg, device=device)
    reset_counts()
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


def _mono_run(imgs, device) -> dict:
    """MonoVO at the mono configuration over `imgs` in phase 8's schedule:
    track_image until phase 2, N_MONO_TIMED frames with timed=True, then
    track_batch in chunks of at most MONO_CHUNK, KLT launches counted frame
    by frame and batch by batch from a reset. Also keeps the state before
    the first track_batch frame (`snap`: (state_to_numpy, frame index))."""
    from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO, state_to_numpy
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    vo = MonoVO(mono_config(), device=device)
    reset_counts()
    per_frame = []

    def step(i, timed=False):
        before = counts()
        sync(device)
        t = time.perf_counter()
        _, st = vo.track_image(imgs[i], timed=timed)
        sync(device)
        per_frame.append(dict(diff(before), frame=i, phase=st["phase"],
                              ms=(time.perf_counter() - t) * 1e3, keyframe=st["keyframe"],
                              fallback=st.get("used_fallback", False), recovered=st.get("recovered", 0)))
        return st

    i = 0
    while vo.phase != 2:
        assert i < N_MONO - N_MONO_TIMED - 1, "mono never bootstrapped"
        step(i)
        i += 1
    boot = i - 1
    stage_ms = [step(j, timed=True)["stage_ms"] for j in range(i, i + N_MONO_TIMED)]
    i += N_MONO_TIMED
    snap = (state_to_numpy(vo.state), i)
    batches = []
    for a, b in mono_chunks(i):
        before = counts()
        sync(device)
        t = time.perf_counter()
        vo.track_batch(imgs[a:b])
        sync(device)
        batches.append(dict(diff(before), frames=b - a, s=time.perf_counter() - t))
    return dict(vo=vo, boot=boot, stage_ms=stage_ms, per_frame=per_frame, batches=batches, snap=snap,
                launches=dict(KN.LAUNCHES))


def _check_mono_launches(run) -> None:
    """KLT launches: none on the first frame, one klt_pyr on an init frame,
    one klt_pyr and one klt_scale on a steady frame; a fallback, recovery
    or keyframe step adds none. Pose: one robust solve on a steady frame,
    and the PnP polishes of a recovery; one pose_gn launch for each solve,
    a pair's two solves in one. BA: one solve on a steady keyframe, its launches as launches_per_solve
    says."""
    want = {"first": (0, 0), "init": (1, 0), "init_reanchor": (1, 0), "bootstrapped": (1, 0), "steady": (1, 1)}
    for f in run["per_frame"]:
        assert (f["klt_pyr"], f["klt_scale"]) == want[f["phase"]], f"mono KLT launches of a frame: {f}"
        assert f["pose_gn"] == f["pose_calls"] - f["pose_pairs"] and f["pose_robust"] == (f["phase"] == "steady"), (
            f"mono pose_gn launches of a frame: {f}")
        assert f["ba_solves"] == int(f["phase"] == "steady" and f["keyframe"]) and ba_launches_ok(f), (
            f"mono ba launches of a frame: {f}")
    for b in run["batches"]:
        assert b["klt_pyr"] == b["klt_scale"] == b["frames"], f"mono KLT launches of a batch: {b}"
        assert b["pose_gn"] == b["pose_calls"] - b["pose_pairs"] and b["pose_robust"] == b["frames"], (
            f"mono pose_gn launches of a batch: {b}")
        assert ba_launches_ok(b), f"mono ba launches of a batch: {b}"


def mono_path(frames, device, card) -> dict:
    """Phase 8: MonoVO at the mono configuration over the first N_MONO frames
    of the accuracy sequence (`_mono_run`), then the same frames with a
    blackout stretch (`mono_blackout_path`) and the fallback and recovery
    on the card against the CPU (`mono_unit_checks`). Returns the kernel
    launch counts of the two runs."""
    import torch

    from visual_odometry_ros_tpu_torch.io import ate_rmse

    imgs, _, poses = frames["mono"]
    run = _mono_run(imgs, device)
    vo, boot, stage_ms, per_frame, batches = (run[k] for k in ("vo", "boot", "stage_ms", "per_frame", "batches"))
    on_card = torch.device(device).type == "cuda"
    launches = launched("mono path") if on_card else run["launches"]

    log = vo.stats_log
    traj = np.stack(vo.trajectory)
    assert traj.shape == (N_MONO, 4, 4) and np.isfinite(traj).all(), "non-finite mono trajectory"
    ate = ate_rmse(traj, poses, align="sim3")
    kfs = [s for s in log if s["phase"] == "steady" and s["keyframe"]]
    n_ba_ok = sum(1 for s in kfs if s["ba_err"] is not None and not s["ba_rejected"])
    keys = ("time_track", "time_1p", "time_pose", "time_new", "time_5p", "time_ba")
    med = {k: statistics.median(d[k] for d in stage_ms if k in d) for k in keys if any(k in d for d in stage_ms)}
    steady_ms = [f["ms"] for f in per_frame if f["phase"] == "steady"]
    print(json.dumps({
        "path": "MonoVO.track_image + track_batch", "frames": N_MONO, "boot_frame": boot,
        "boot_frame_ref": MONO_REF_BOOT, "ate_sim3_m": ate, "ate_ref_m": MONO_REF_ATE_M,
        "keyframe_steps": len(kfs), "ba_accepted": n_ba_ok,
        "used_fallback": sum(1 for s in log if s.get("used_fallback")),
        "recovered": sum(1 for s in log if s.get("recovered", 0)),
        "per_frame": per_frame, "batches": batches, "launches": launches, "card": card,
    }))
    print(json.dumps({"mono_stage_ms_median": med, "timed_frames": len(stage_ms),
                      "steady_frame_ms_median": statistics.median(steady_ms), "card": card}))
    print("time mono path: timed steady frame median "
          f"{statistics.median(steady_ms):.2f} ms over {len(steady_ms)} frames; track_batch "
          + "; ".join(f"{b['frames']} frames at {b['frames'] / b['s']:.2f} frames/s" for b in batches)
          + f"; synchronised host clock; on {card}")
    if on_card:
        _check_mono_launches(run)
    assert abs(boot - MONO_REF_BOOT) <= 2, f"bootstrap at frame {boot}, reference {MONO_REF_BOOT}"
    assert len(kfs) >= 2, f"only {len(kfs)} mono keyframe steps"
    assert 2 * n_ba_ok >= len(kfs), f"BA accepted on {n_ba_ok} of {len(kfs)} mono keyframes"
    assert ate <= 3 * MONO_REF_ATE_M, f"mono sim3 ATE {ate:.4f} m above 3x {MONO_REF_ATE_M:.4f} m"

    blackout = mono_blackout_path(frames, device, card)
    if on_card:
        mono_unit_checks(run["snap"], imgs, card)
    return {k: launches[k] + blackout[k] for k in launches}


def blackout_frames(imgs) -> np.ndarray:
    """The mono frames with frames BLACKOUT[0] .. BLACKOUT[1] - 1 replaced by
    a flat grey image: every track is lost there."""
    out = np.array(imgs, copy=True)
    out[BLACKOUT[0]:BLACKOUT[1]] = BLACKOUT_GREY
    return out


def recovery_summary(log, traj, poses) -> dict:
    """Fallback frames, (frame, mode) of each recovery and the sim3 ATE of
    the frames from the last recovery on."""
    from visual_odometry_ros_tpu_torch.io import ate_rmse

    rec = [[s["frame"], int(s["recovered"])] for s in log if s.get("recovered", 0)]
    post = rec[-1][0] if rec else None
    return {
        "fallback_frames": [s["frame"] for s in log if s.get("used_fallback")],
        "recoveries": rec,
        "post_recovery_ate_sim3_m": (float(ate_rmse(traj[post:], poses[post:], align="sim3"))
                                     if rec and len(traj) - post >= 3 else None),
    }


def mono_blackout_path(frames, device, card) -> dict:
    """Phase 8, blackout: the mono frames with a flat grey stretch
    (`blackout_frames`) in phase 8's schedule. The pose and the 5-point
    fallback must fail there and recovery must fire; the recovery modes, the
    first recovery's frame and the sim3 ATE after the last recovery are held
    to the JAX package's CPU run of the same frames and schedule
    (tests/reference_mono_smoke.py). Returns the kernel launch counts."""
    import torch

    imgs, _, poses = frames["mono"]
    run = _mono_run(blackout_frames(imgs), device)
    on_card = torch.device(device).type == "cuda"
    launches = launched("mono blackout path") if on_card else run["launches"]
    vo = run["vo"]
    traj = np.stack(vo.trajectory)
    assert traj.shape == (N_MONO, 4, 4) and np.isfinite(traj).all(), "non-finite mono blackout trajectory"
    got = recovery_summary(vo.stats_log, traj, poses)
    print(json.dumps({
        "path": "MonoVO blackout", "blackout": list(BLACKOUT), "boot_frame": run["boot"], **got,
        "recoveries_ref": MONO_BLACKOUT_REF_RECOVERIES, "post_recovery_ate_ref_m": MONO_BLACKOUT_REF_POST_ATE_M,
        "batches": run["batches"], "launches": launches, "card": card,
    }))
    if on_card:
        _check_mono_launches(run)
    assert got["fallback_frames"] and got["recoveries"], f"the blackout fired no fallback or recovery: {got}"
    assert got["fallback_frames"][0] < got["recoveries"][0][0], got
    modes, ref_modes = [m for _, m in got["recoveries"]], [m for _, m in MONO_BLACKOUT_REF_RECOVERIES]
    assert modes == ref_modes, f"recovery modes {modes}, reference {ref_modes}"
    first, ref_first = got["recoveries"][0][0], MONO_BLACKOUT_REF_RECOVERIES[0][0]
    assert abs(first - ref_first) <= 2, f"first recovery at frame {first}, reference {ref_first}"
    post = got["post_recovery_ate_sim3_m"]
    assert post is not None and post <= 3 * MONO_BLACKOUT_REF_POST_ATE_M, (
        f"post-recovery sim3 ATE {post} m above 3x {MONO_BLACKOUT_REF_POST_ATE_M} m")
    return launches


def mono_unit_checks(snap, imgs, card, device="cuda") -> None:
    """Phase 8, unit level: `_fallback_5pt` and `_recover` (mode 1 on the
    state as it is, mode 2 with every track dropped) on the card and on a
    CPU copy of the same inputs with the same injected draws. The inputs:
    the mono run's steady state before its first track_batch frame and that
    frame's steady step on the card. Fallback: the same fb_ok, track mask
    and fail_count; its motion to test_fallback_from_jax_state's bounds (a
    one-frame 5-point solve, ill-conditioned in float32). Recovery: the same
    mode, track mask and fail_count, T_wc to MONO_UNIT_TOL["T_wc"]."""
    import torch

    from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO, state_from_numpy, state_to_numpy

    prev_np, i = snap
    devs = {"card": device, "cpu": "cpu"}
    vos = {k: MonoVO(mono_config(), device=d) for k, d in devs.items()}
    img = torch.as_tensor(imgs[i], dtype=torch.float32, device=device)
    new_np = state_to_numpy(vos["card"]._steady_step(state_from_numpy(prev_np, device), img)[0])
    prev, new = state_from_numpy(prev_np, "cpu"), state_from_numpy(new_np, "cpu")
    idx = vos["cpu"]._draw_essential(prev.tracks.valid & new.tracks.valid)
    fid = int(new.frame_id)

    def draw(valid):  # the CPU's recovery draws, on the caller's device
        return vos["cpu"]._draw_recovery(fid, valid.cpu()).to(valid.device)

    def host(state):
        return state_from_numpy(state_to_numpy(state), "cpu")

    fb, rec = {}, {}
    for k, vo in vos.items():  # every call on a fresh copy of its inputs
        d = devs[k]
        out, fb_ok = vo._fallback_5pt(state_from_numpy(prev_np, d), state_from_numpy(new_np, d), idx=idx.to(d))
        fb[k] = (host(out), bool(fb_ok))
        for mode in (1, 2):
            st = state_from_numpy(new_np, d)
            if mode == 2:
                st = st.replace(tracks=st.tracks.replace(valid=torch.zeros_like(st.tracks.valid)))
            out, got = vo._recover(st, draw=draw)
            rec[k, mode] = (host(out), int(got))
    (fc, okc), (fp, okp) = fb["card"], fb["cpu"]
    step_len = float(prev.step_len)
    prev_T = prev.T_wc.double().numpy()
    d_c, d_p = (np.linalg.inv(prev_T) @ f.T_wc.double().numpy() for f in (fc, fp))
    cos = float(d_c[:3, 3] @ d_p[:3, 3] / max(np.linalg.norm(d_c[:3, 3]) * np.linalg.norm(d_p[:3, 3]), 1e-12))
    row = {
        "frame": i, "fb_ok": [okc, okp], "fb_track_mask_equal": bool(torch.equal(fc.tracks.valid, fp.tracks.valid)),
        "fb_fail_count": [int(fc.fail_count), int(fp.fail_count)],
        "fb_rot_max_diff": float(np.abs(d_c[:3, :3] - d_p[:3, :3]).max()), "fb_step_cos": cos,
        "fb_step_len": [float(np.linalg.norm(d_c[:3, 3])), float(np.linalg.norm(d_p[:3, 3])), step_len],
    }
    for mode in (1, 2):
        (rc, mc), (rp, mp) = rec["card", mode], rec["cpu", mode]
        row[f"recover{mode}"] = {
            "mode": [mc, mp], "T_wc_max_diff": float((rc.T_wc - rp.T_wc).abs().max()),
            "track_mask_equal": bool(torch.equal(rc.tracks.valid, rp.tracks.valid)),
            "n_tracks": [int(rc.tracks.valid.sum()), int(rp.tracks.valid.sum())],
            "fail_count": [int(rc.fail_count), int(rp.fail_count)],
        }
    print(json.dumps({"mono_fallback_recover_card_vs_cpu": row, "card": card}))
    assert okc and okp and row["fb_track_mask_equal"] and row["fb_fail_count"] == [0, 0], row
    assert row["fb_rot_max_diff"] <= MONO_UNIT_TOL["fb_rot"] and cos > MONO_UNIT_TOL["fb_cos"], row
    for n in row["fb_step_len"][:2]:
        assert abs(n - step_len) <= MONO_UNIT_TOL["fb_len"] * step_len, row
    for mode in (1, 2):
        r = row[f"recover{mode}"]
        assert r["mode"] == [mode, mode] and r["track_mask_equal"] and r["fail_count"] == [0, 0], (mode, row)
        assert r["T_wc_max_diff"] <= MONO_UNIT_TOL["T_wc"], (mode, row)


@contextlib.contextmanager
def plain_kernels():
    """The kernel wrappers replaced by their plain versions while the block
    runs: the same calls on the same tensors, without the kernels."""
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    names = ("track_pyr", "track_pyr_bidir", "track_scale")
    orig = {n: getattr(KK, n) for n in names}
    for n in names:
        setattr(KK, n, getattr(KK, n + "_ref"))
    try:
        yield
    finally:
        for n, f in orig.items():
            setattr(KK, n, f)


def image_api_sites(pairs, dev):
    """Phase 9's calls: ops/klt.track, track_with_prior and
    track_bidirectional with default KLTParams on the kernel leg, corridor
    frames 10 -> 11, N = 1024 (seeds 2 px off for the prior-seeded calls).
    Same layout as `klt_call_sites`; the wrapper and plain entries take the
    pyramids the call builds."""
    import torch

    from visual_odometry_ros_tpu_torch.ops import klt as KLT
    from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK

    kp = KLT.KLTParams(use_kernel=True)
    up = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    img_a, img_b = up(pairs[10][0]), up(pairs[11][0])
    lv_a, lv_b = ([lv[0] for lv in pyr] for pyr in KLT._image_pyramids(img_a, img_b, kp))
    p = _feature_grid(*img_a.shape, 32, 32, dev)
    rng = np.random.default_rng(2)
    seed = (p + up(rng.uniform(-2, 2, p.shape))).contiguous()
    valid = torch.ones(len(p), dtype=torch.bool, device=dev)
    common = (kp.window_radius, kp.iters, kp.iters_coarse, kp.eps, kp.min_eig)
    fwd0, fwd = (lv_a, lv_b, p, p, valid, *common), (lv_a, lv_b, p, seed, valid, *common)
    bidir = (lv_a, lv_b, p, seed, valid, *common, False, kp.levels)
    pt_bytes = _pt_bytes(len(p), 8 + 4 + 1)
    return {
        "api_track": dict(
            call=lambda: KLT.track(img_a, img_b, p, valid, kp),
            wrapper=lambda: KK.track_pyr(*fwd0), plain=lambda c: KK.track_pyr_ref(*fwd0, counts=c),
            bytes=_img_bytes(lv_a) + pt_bytes),
        "api_track_with_prior": dict(
            call=lambda: KLT.track_with_prior(img_a, img_b, p, seed, valid, kp),
            wrapper=lambda: KK.track_pyr(*fwd), plain=lambda c: KK.track_pyr_ref(*fwd, counts=c),
            bytes=_img_bytes(lv_a) + pt_bytes),
        "api_track_bidirectional": dict(
            call=lambda: KLT.track_bidirectional(img_a, img_b, p, seed, valid, kp),
            wrapper=lambda: KK.track_pyr_bidir(*bidir), plain=lambda c: KK.track_pyr_bidir_ref(*bidir, counts=c),
            bytes=_img_bytes(lv_a) + _pt_bytes(len(p), 8 + 4 + 1 + 8 + 1)),
    }


def image_api_path(sites) -> tuple:
    """Phase 9: each image-level call once with the counts reset: exactly
    one klt_pyr launch, and (p1, ok) against the same call on the plain
    versions. Returns (launches, compare rows)."""
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    total = {k: 0 for k in KN.LAUNCHES}
    rows = []
    for name, site in sites.items():
        KN.reset_launch_counts()
        p_k, ok_k = site["call"]()
        got = dict(KN.LAUNCHES)
        assert got == {**dict.fromkeys(got, 0), "klt_pyr": 1}, f"{name}: launches {got}, expected one klt_pyr"
        for k in total:
            total[k] += got[k]
        with plain_kernels():
            p_r, ok_r = site["call"]()
        rows.append(compare(name, p_k, ok_k, p_r, ok_r))
    return total, rows


def write_png_gray(path: str, img: np.ndarray) -> None:
    """8-bit grey PNG through the standard library (filter 0 on every row)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_kitti_layout(root: str, left, right, poses, fx: float, cx: float, cy: float,
                       baseline: float) -> str:
    """KITTI odometry sequence 00 under root: image_0/1 PNGs, times.txt,
    calib.txt (P0, P1) and poses/00.txt (T_wc rows). Returns root."""
    seq = os.path.join(root, "sequences", "00")
    for cam, imgs in (("image_0", left), ("image_1", right)):
        os.makedirs(os.path.join(seq, cam), exist_ok=True)
        for i, img in enumerate(imgs):
            write_png_gray(os.path.join(seq, cam, f"{i:06d}.png"), img)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{0.1 * i:.6e}\n" for i in range(len(left)))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for name, tx in (("P0", 0.0), ("P1", -fx * baseline)):
            f.write(f"{name}: {fx} 0 {cx} {tx} 0 {fx} {cy} 0 0 0 1 0\n")
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        f.writelines(" ".join(f"{v:.9e}" for v in np.asarray(T, np.float64)[:3, :4].ravel()) + "\n"
                     for T in poses)
    return root


def crop_config(path: str, x0: int) -> str:
    """KITTI_CONFIG at the crop's width, cx shifted by x0, 512 tracks in
    12x12 bins; written to `path`."""
    with open(os.path.join(ROOT, KITTI_CONFIG)) as f:
        text = f.read()
    subs = {
        r"(Camera\.(left|right)\.width): \d+": rf"\1: {CLI_CROP_W}",
        r"(Camera\.(left|right)\.cx): [\d.]+": rf"\1: {KITTI_CX - x0}",
        r"(feature_extractor\.n_features): \d+": r"\1: 512",
        r"(feature_extractor\.n_bins_u): \d+": r"\1: 12",
    }
    for pat, rep in subs.items():
        text, n = re.subn(pat, rep, text)
        assert n, pat
    with open(path, "w") as f:
        f.write(text)
    return path


def kitti_layouts(work: str, frames) -> dict:
    """The corridor frames as KITTI sequences under `work`:
    {"full": (root, config), "crop": (root, config)}."""
    left, right, poses = frames["main"]
    x0 = (left.shape[2] - CLI_CROP_W) // 2
    crop = slice(x0, x0 + CLI_CROP_W)
    return {
        "full": (write_kitti_layout(os.path.join(work, "kitti_full"), left, right, poses, KITTI_FX, KITTI_CX,
                                    KITTI_CY, KITTI_BASELINE), os.path.join(ROOT, KITTI_CONFIG)),
        "crop": (write_kitti_layout(os.path.join(work, "kitti_crop"), left[:, :, crop], right[:, :, crop], poses,
                                    KITTI_FX, KITTI_CX - x0, KITTI_CY, KITTI_BASELINE),
                 crop_config(os.path.join(work, "kitti_crop.yaml"), x0)),
    }


@contextlib.contextmanager
def frame_launch_log():
    """While the block runs: the KLT launches and replenishes of every
    StereoVO.track_stereo_images / track_stereo_batch call, [{klt_pyr,
    klt_scale, replenish, frames}], and the StereoVO the calls ran on
    (log[i]["vo"])."""
    from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO

    log, rep = [], [0]
    orig = {n: getattr(StereoVO, n) for n in ("track_stereo_images", "track_stereo_batch", "_replenish")}

    def counted_rep(self, *a, **kw):
        rep[0] += 1
        return orig["_replenish"](self, *a, **kw)

    def logged(name):
        def run(self, *a, **kw):
            before = counts()
            rep[0] = 0
            out = orig[name](self, *a, **kw)
            frames = len(out) if name == "track_stereo_batch" else 1
            log.append(dict(diff(before), replenish=rep[0], frames=frames, vo=self))
            return out
        return run

    StereoVO._replenish = counted_rep
    StereoVO.track_stereo_images = logged("track_stereo_images")
    StereoVO.track_stereo_batch = logged("track_stereo_batch")
    try:
        yield log
    finally:
        for n, f in orig.items():
            setattr(StereoVO, n, f)


def cli_path(frames, card) -> dict:
    """Phase 10: the run_vo CLI on the corridor frames written as KITTI
    sequences: full width per frame (--stage-timing) and with --batch
    CLI_BATCH, and the crop per frame; then the mono CLI on the synthetic
    world. Returns the launch counts."""
    from visual_odometry_ros_tpu_torch import run_vo
    from visual_odometry_ros_tpu_torch.io.trajectory import load_kitti_trajectory
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    t = time.perf_counter()
    layouts = kitti_layouts(work, frames)
    print(f"cli: wrote {N_MAIN} KITTI stereo pairs at full width and cropped in {time.perf_counter() - t:.1f} s")
    runs, total = {}, {k: 0 for k in KN.LAUNCHES}
    for tag, layout, extra in (("full", "full", ["--stage-timing"]), ("full_batch", "full", ["--batch", str(CLI_BATCH)]),
                               ("crop", "crop", [])):
        root, cfg = layouts[layout]
        out = os.path.join(work, tag)
        reset_counts()
        with frame_launch_log() as log:
            summary = run_vo.main(["--dataset", "kitti", "--root", root, "--config", cfg, "--mode", "stereo",
                                   "--quiet", "--out", out] + extra)
        launches = launched(f"CLI {tag}")
        for k in total:
            total[k] += launches[k]
        vo = log[0]["vo"]
        log = [{k: v for k, v in e.items() if k != "vo"} for e in log]
        n_tracked = N_MAIN - 1
        # A tracked frame: one klt_pyr for the track climb and one for the
        # stereo pass, one more per replenish; one klt_scale.
        if "batch" not in tag:
            for e in log[1:]:
                assert e["klt_scale"] == 1 and e["klt_pyr"] == 2 + e["replenish"], f"CLI KLT launches of a frame: {e}"
        n_rep = sum(e["replenish"] for e in log)
        assert launches["klt_scale"] == n_tracked and launches["klt_pyr"] == 2 * n_tracked + n_rep, (
            f"CLI {tag}: launches {launches} with {n_rep} replenishes over {n_tracked} tracked frames")
        n_robust = sum(e["pose_robust"] for e in log)
        assert n_robust == n_tracked, f"CLI {tag}: {n_robust} robust pose solves over {n_tracked} tracked frames"
        assert not any(s.get("recovered", 0) for s in vo.stats_log), f"CLI {tag}: recovery fired"
        with open(os.path.join(out, "stats.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert len(recs) == N_MAIN == summary["frames"], f"CLI {tag}: {len(recs)} stats records"
        _, traj = load_kitti_trajectory(os.path.join(out, "frame_poses.txt"))
        assert traj.shape == (N_MAIN, 4, 4) and np.isfinite(traj).all(), f"CLI {tag}: bad trajectory"
        keys = ("time_track", "time_stereo", "time_pose", "time_new", "time_ba")
        timed = {k: [r["exec"][k] for r in recs if r["exec"][k] > 0] for k in keys}
        med = {k: statistics.median(v) for k, v in timed.items() if v}
        runs[tag] = dict(summary=summary, traj=traj)
        print(json.dumps({"path": f"run_vo kitti {tag}", "summary": summary, "launches": launches,
                          "calls": log, "stage_ms_median": med, "card": card}))
        print(f"time CLI {tag}: {summary['fps']:.2f} frames/s over {N_MAIN} frames "
              f"(mean {summary['mean_time_total_ms']:.1f} ms, p95 {summary['p95_time_total_ms']:.1f} ms per frame"
              f"{'; stage medians ' + json.dumps(med) if med else ''}); on {card}")
    full, crop = runs["full"]["summary"], runs["crop"]["summary"]
    dpos = float(np.abs(runs["full_batch"]["traj"][:, :3, 3] - runs["full"]["traj"][:, :3, 3]).max())
    print(json.dumps({"cli_kitti": {
        "full_ate_m": full["ate_rmse"], "full_ate_ref_m": CLI_REF_FULL_ATE_M, "full_ate_plain_m": CLI_PLAIN_ATE_M,
        "full_keyframes": full["keyframes"], "full_keyframes_ref": CLI_REF_FULL_KEYFRAMES,
        "full_keyframes_plain": CLI_PLAIN_KEYFRAMES, "crop_ate_m": crop["ate_rmse"], "crop_ate_ref_m": CLI_REF_ATE_M,
        "crop_keyframes": crop["keyframes"], "crop_keyframes_ref": CLI_REF_KEYFRAMES,
        "batch_vs_per_frame_max_m": dpos}}))
    for name, got, ate_ref, kf_ref in (("full width (JAX)", full, CLI_REF_FULL_ATE_M, CLI_REF_FULL_KEYFRAMES),
                                       ("full width (plain versions)", full, CLI_PLAIN_ATE_M, CLI_PLAIN_KEYFRAMES),
                                       ("crop (JAX)", crop, CLI_REF_ATE_M, CLI_REF_KEYFRAMES)):
        assert got["ate_rmse"] <= 3 * ate_ref, f"CLI {name}: ATE {got['ate_rmse']:.4f} m above 3x {ate_ref}"
        assert abs(got["keyframes"] - kf_ref) <= 1, f"CLI {name}: {got['keyframes']} keyframes, reference {kf_ref}"
    assert runs["full_batch"]["summary"]["keyframes"] == full["keyframes"], "CLI batch and per-frame keyframes differ"
    assert dpos <= CLI_BATCH_TOL_M, f"CLI batch and per-frame positions differ by {dpos:.2e} m"

    # The mono CLI on the synthetic two-plane world.
    reset_counts()
    t = time.perf_counter()
    summary = run_vo.main(["--dataset", "synthetic", "--mode", "mono", "--frames", str(CLI_MONO_FRAMES),
                           "--out", os.path.join(work, "mono"), "--quiet"])
    launches = launched("CLI mono")
    for k in total:
        total[k] += launches[k]
    print(json.dumps({"path": "run_vo synthetic mono", "summary": summary, "launches": launches,
                      "ate_post_init_ref_m": CLI_MONO_REF_ATE_M, "wall_s": time.perf_counter() - t, "card": card}))
    assert summary["frames"] == CLI_MONO_FRAMES, summary
    assert summary["ate_rmse_post_init"] <= 3 * CLI_MONO_REF_ATE_M, (
        f"mono CLI post-init ATE {summary['ate_rmse_post_init']:.4f} m above 3x {CLI_MONO_REF_ATE_M}")
    return total


def dist_ba_path(card) -> dict:
    """Phase 11: make_distributed_ba over a 1-rank NCCL group against the
    single-device solve at dryrun_multichip's problem."""
    import torch
    import torch.distributed as dist

    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.ops import kernels as KN
    from visual_odometry_ros_tpu_torch.parallel import dist_ba
    from visual_odometry_ros_tpu_torch.parallel import multihost as MH

    rdv = os.path.join(ROOT, "build", "chip_smoke_ba_rendezvous")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    dev = MH.init_worker("file://" + rdv, 1, 0, backend="nccl")
    try:
        group = MH.global_mesh()
        prob_np, fx, fy, cx, cy, T_rl = MH.dryrun_problem_np()
        local = MH.host_tree(prob_np, group, dist_ba._sharded_specs()[0], dev)
        T_rl = torch.as_tensor(T_rl, device=dev)
        params = BA.BAParams(iters=BA_ITERS)
        solve = dist_ba.make_distributed_ba(group, params)
        full = BA.BAProblem(*(torch.as_tensor(a, device=dev) for a in prob_np))
        info_d, info_s = {}, {}
        BA.reset_collective_counts()
        KN.reset_launch_counts()
        res = solve(local, fx, fy, cx, cy, T_rl, info_d)
        all_reduces = BA.COLLECTIVES["all_reduce"]
        group_launches = {k: KN.LAUNCHES[k] for k in BA_KERNELS}
        ref = BA.ba_solve_impl(full, fx, fy, cx, cy, T_rl, params, info=info_s)
        row = {
            "problem": "dryrun_multichip", "K": int(full.T_cw.shape[0]), "M": int(full.Xw.shape[0]),
            "ranks": dist.get_world_size(group), "backend": dist.get_backend(group),
            "d_T_cw": float((res.T_cw - ref.T_cw).abs().max()), "d_Xw_m": float((res.Xw - ref.Xw).abs().max()),
            "d_err_px": abs(float(res.mean_err_px) - float(ref.mean_err_px)),
            "mean_err_px": float(res.mean_err_px), "mean_err0_px": float(res.mean_err0_px),
            "n_obs": [int(res.n_obs), int(ref.n_obs)], "iters": [info_d["iters"], info_s["iters"]],
            "all_reduces_per_solve": all_reduces, "ba_launches_per_solve": group_launches,
            "ms_per_solve": cuda_ms(lambda: solve(local, fx, fy, cx, cy, T_rl), reps=10, warmup=2),
            "single_ms_per_solve": cuda_ms(lambda: BA.ba_solve_impl(full, fx, fy, cx, cy, T_rl, params),
                                           reps=10, warmup=2),
            "card": card,
        }
    finally:
        dist.destroy_process_group()
    print(json.dumps({"dist_ba": row}))
    print(f"time distributed BA (1 NCCL rank, K = {row['K']}, M = {row['M']}, {BA_ITERS} iterations, "
          f"{all_reduces} all-reduces per solve): {row['ms_per_solve']:.2f} ms per solve, single-device "
          f"{row['single_ms_per_solve']:.2f} ms (CUDA events); on {card}")
    assert row["d_T_cw"] <= BA_TOL["T_cw"] and row["d_Xw_m"] <= BA_TOL["Xw"] and row["d_err_px"] <= BA_TOL["err"], row
    # The error rises over the solve, in the JAX package too: the problem's
    # right rows repeat the left pixels (tests/test_torch_dist_ba.py holds
    # the port's solve of it to the JAX package's).
    assert row["n_obs"][0] == row["n_obs"][1] and row["iters"][0] == row["iters"][1], row
    # One all-reduce per GN iteration, plus the error sums before and after.
    assert all_reduces == info_d["iters"] + 2, row
    # The group solve on the ba_* kernels, 4 n + 2 launches: per iteration
    # run ba_solve twice (the partials' sum, then the solve, around the
    # all-reduce) and ba_backsub once, the apply step's decision its end.
    n = info_d["iters"]
    assert group_launches == {"ba_terms": n + 2, "ba_solve": 2 * n, "ba_backsub": n}, row
    assert np.isfinite(row["mean_err_px"]), row
    return row


def accuracy_path(frames, card) -> tuple:
    """Phase 12: the accuracy leg's stereo run (`eval_accuracy.run_stereo`,
    kernel leg, on the card) over the N_MONO float32 stereo pairs. Returns
    its kernel launch counts and its pose fails."""
    from visual_odometry_ros_tpu_torch import eval_accuracy as EA
    from visual_odometry_ros_tpu_torch.io import ate_rmse, rpe
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    il, ir, poses = frames["mono"]
    reset_counts()
    with frame_launch_log() as log:
        traj, wall, slog = EA.run_stereo(il, ir, "on", "cuda")
    launches = launched("accuracy leg")
    calls = [{k: v for k, v in e.items() if k != "vo"} for e in log]
    assert traj.shape == (N_MONO, 4, 4) and np.isfinite(traj).all(), "non-finite accuracy-leg trajectory"
    ate = float(ate_rmse(traj, poses, align="none"))
    rpe_t, rpe_r = rpe(traj, poses)
    fails = sum(1 for s in slog if s.get("pose_ok") is False)
    recs = sum(1 for s in slog if s.get("recovered", 0) > 0)
    tracked = N_MONO - 1
    print(json.dumps({
        "path": "eval_accuracy.run_stereo (kernel leg)", "frames": N_MONO, "chunk": EA.CHUNK, "ate_m": ate,
        "ate_ref_m": ACC_REF_ATE_M, "rpe_m_deg": [rpe_t, rpe_r], "n_pose_fail": fails,
        "n_pose_fail_ref": ACC_REF_POSE_FAILS, "n_recoveries": recs, "n_recoveries_ref": ACC_REF_RECOVERIES,
        "launches": launches, "launches_per_tracked_frame": {k: v / tracked for k, v in launches.items()},
        "calls": calls, "wall_s": wall, "card": card,
    }))
    print(f"time accuracy leg: {N_MONO} frames in {wall:.2f} s ({N_MONO / wall:.2f} frames/s, "
          f"track_stereo_batch in chunks of {EA.CHUNK}, float32 640x480); on {card}")
    # Every tracked frame runs one klt_scale; two klt_pyr (track, stereo)
    # and one more per replenish, unless a recovery replaced its tracks; one
    # robust pose solve; pose_gn once per solve, once per pair (`launched`).
    assert launches["klt_scale"] == tracked, f"accuracy leg: {launches} over {tracked} tracked frames"
    n_robust = sum(c["pose_robust"] for c in calls)
    assert n_robust == tracked, f"accuracy leg: {n_robust} robust pose solves over {tracked} tracked frames"
    assert ate <= 3 * ACC_REF_ATE_M, f"accuracy leg ATE {ate:.4f} m above 3x {ACC_REF_ATE_M} m"
    return launches, fails


def measurement_legs(frames, card, acc_fails: int) -> dict:
    """Phase 13: the port's measurement harnesses on frames already
    rendered. profile_stages at PROFILE_BATCH on phase 6's 1 + 24 serving
    frames (stage table, idle share, host syncs, top device operations) and
    --mono on phase 8's frames, each trace's KLT events held to the launch
    counters; ab_frames over phase 8's frames as stereo pairs (its kernel
    leg's pose fails equal phase 12's); bench_scaling's world of one NCCL
    rank (iters + 2 all-reduces per solve, their bytes as ops/ba.py packs
    them); h2d_overlap_probe's two upload routes. Returns the A/B kernel
    leg's kernel launch counts."""
    import torch

    from visual_odometry_ros_tpu_torch import ab_frames as AB
    from visual_odometry_ros_tpu_torch import bench_scaling as BS
    from visual_odometry_ros_tpu_torch import eval_accuracy as EA
    from visual_odometry_ros_tpu_torch import h2d_overlap_probe as H2D
    from visual_odometry_ros_tpu_torch import profile_stages as PS
    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.ops import kernels as KN

    out = os.path.join(ROOT, "build", "chip_smoke_legs")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    il, ir, _ = frames["bench"]
    prof = PS.run(PS.build_vo("cuda"), il, ir, PROFILE_BATCH, STEP_BENCH, reps=PROFILE_REPS,
                  trials=PROFILE_TRIALS, mono_vo=EA.build_mono("on", "cuda"), mono_imgs=frames["mono"][0],
                  flops=False)
    with open(os.path.join(out, PS.OUT_NAME), "w") as f:
        json.dump(prof, f, indent=1)
    for line in PS.summary_lines(prof):
        print(line)
    for name, part in (("stereo", prof), ("mono", prof["mono"])):
        d = part["device"]
        print(json.dumps({"profile": name, "idle_share": d["idle_share"], "busy_ms": d["busy_ms"],
                          "window_ms": d["window_ms"], "device_events": d["device_events"],
                          "kernel_trace_events": d["kernel_trace_events"], "kernel_launches": d["kernel_launches"],
                          "host_syncs": part["host_syncs"], "card": card}))
        assert d["kernel_trace_events"] == d["kernel_launches"] and min(
            v for k, v in d["kernel_launches"].items() if k not in BA_KERNELS) > 0, (
            f"{name}: the trace's kernels {d['kernel_trace_events']} are not the launches counted "
            f"{d['kernel_launches']}")
    t_prof = time.perf_counter() - t0

    t0 = time.perf_counter()
    mil, mir, mposes = frames["mono"]
    reset_counts()
    _, ab = AB.run_ab(mil, mir, mposes, "cuda")
    launches = launched("A/B kernel leg")
    print(json.dumps({"ab_frames": ab, "card": card}))
    print(f"A/B over {ab['frames']} frames: first divergent frame {ab['first_divergent_frame']}; rotation "
          f"error q50/q90/max plain {ab['rot_err_deg_plain_q50_q90_max']}, kernel "
          f"{ab['rot_err_deg_kernel_q50_q90_max']} deg; pose fails plain {ab['n_pose_fail_plain']}, kernel "
          f"{ab['n_pose_fail_kernel']} (phase 12: {acc_fails})")
    assert ab["n_pose_fail_kernel"] == acc_fails, (ab, acc_fails)
    t_ab = time.perf_counter() - t0

    t0 = time.perf_counter()
    (world,) = BS.main(["--worlds", "1", "--lm-per-rank", str(SCALING_M), "--window", str(SCALING_K),
                        "--iters", str(SCALING_ITERS), "--reps", str(SCALING_REPS),
                        "--json-out", os.path.join(out, BS.OUT_NAME)])
    full = torch.ones(SCALING_K, dtype=torch.bool)  # bench_scaling's window: every slot live
    want_bytes = BS.payload_bytes_per_solve(world["iters_run"], SCALING_K, n_opt=BA.n_opt(full, BA.BAParams()))
    print(f"time BA scaling, world 1 ({world['backend']}, M = {world['landmarks']}, K = {SCALING_K}): "
          f"{world['value']:.2f} GN iters/s, {world['ms_per_solve']:.2f} ms per solve; per iteration assembly "
          f"{world['assembly_ms_per_iter']:.3f} ms, collective and solve "
          f"{world['collective_and_solve_ms_per_iter']:.3f} ms; {world['all_reduces_per_solve']} all-reduces, "
          f"{world['psum_payload_bytes_per_solve']} bytes per solve (formula {want_bytes}); on {card}")
    assert world["backend"] == "nccl" and world["all_reduces_per_solve"] == world["iters_run"] + 2, world
    assert world["psum_payload_bytes_per_solve"] == want_bytes, world
    t_ba = time.perf_counter() - t0

    t0 = time.perf_counter()
    h2d = H2D.probe(trials=H2D_TRIALS)
    print(json.dumps({"h2d_overlap": h2d}))
    print("time upload of " + f"{h2d['payload_bytes']} bytes: " + "; ".join(
        f"{k} {r['upload_GBps']:.2f} GB/s ({r['upload_ms']:.2f} ms), overlap ratio {r['overlap_ratio']:.3f} "
        f"beside {r['compute_ms']:.2f} ms of compute" for k, r in h2d["routes"].items()) + f"; on {card}")
    print(f"phase 13 wall: profile {t_prof:.1f} s, A/B {t_ab:.1f} s, BA scaling {t_ba:.1f} s, "
          f"upload probe {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    import torch

    # 1. environment -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from visual_odometry_ros_tpu_torch.ops import kernels as KN
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
    KN.build()
    regs = [ln.strip() for ln in KN.BUILD_INFO.get("ptxas", "").splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s -> {KN.BUILD_INFO['library']}; ptxas: {regs}")

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
    # Mono's configurations on a HardSequence pair (640x480, N = 512): the
    # 2-D bidirectional climb (3 levels, 15/6 iterations, backward over
    # level 0) and klt_scale at 30 iterations with s over [0.25, 4], so the
    # kernel's clamp to [0.5, 2] is crossed on both sides.
    m0 = torch.as_tensor(frames["mono"][0][MONO_PAIR], device=dev)
    m1 = torch.as_tensor(frames["mono"][0][MONO_PAIR + 1], device=dev)
    pm = _feature_grid(*m0.shape, 16, 32, dev)
    nm = len(pm)
    seed = (pm + noise[:nm]).contiguous()
    vm = valid[:nm]
    args = (list(build_pyramid(m0, 3)), list(build_pyramid(m1, 3)), pm, seed, vm, radius, iters, 6)
    k = KK.track_pyr_bidir(*args, back_levels=1)
    r = KK.track_pyr_bidir_ref(*args, back_levels=1)
    cases["klt_pyr"].append(compare("climb_bidir_2d_fwd", k[0], k[1], r[0], r[1]))
    cases["klt_pyr"].append(compare("climb_bidir_2d_back", k[3], k[4], r[3], r[4]))
    # The backward climb alone on the same inputs: the plain version seeded
    # with the kernel's forward result. A feature whose backward climb is
    # chaotic (its plain result moves by pixels when the seed moves by
    # 1e-4 px) can differ end to end by far more than rounding; this case
    # and the sensitivity line say whether that is the kernel or the input.
    back = args[:2]
    b = KK.track_pyr_ref(back[1][:1], back[0][:1], k[0].contiguous(), pm, k[1], radius, iters, 6)
    compare("climb_bidir_2d_back_same_seed", k[3], k[4], b[0], b[1])
    pert = KK.track_pyr_ref(back[1][:1], back[0][:1], (r[0] + 1e-4).contiguous(), pm, r[1], radius, iters, 6)
    dpp = torch.linalg.norm(pert[0] - r[3], dim=-1)[pert[1] & r[4]]
    print(json.dumps({"case": "climb_bidir_2d_back_plain_seed_plus_1e-4px",
                      "max_dp_px": float(dpp.max()), "n_over_tol_far": int((dpp > TOL_FAR_PX).sum())}))
    seed_m, ok_m, _, _ = KK.track_level(m0, m1, pm, seed, vm, radius, iters)
    sc = (0.25 + 3.75 * torch.rand(nm, generator=gen)).to(dev)
    args = (m0, m1, pm, seed_m.contiguous(), sc, ok_m, 11, 30)
    k = KK.track_scale(*args)
    r = KK.track_scale_ref(*args)
    cases["klt_scale"].append(compare("scale_mono", k[0], k[2], r[0], r[2]))
    torch.cuda.synchronize()
    sites = call_site_times({**klt_call_sites(pairs, dev), **mono_call_sites(frames["mono"][0], dev)}, card)
    timing = {
        "klt_pyr": sites["track"],
        "klt_scale": sites["scale"],
    }
    for name, row in [*timing.items(), ("klt_pyr mono_track", sites["mono_track"]),
                      ("klt_scale mono_scale", sites["mono_scale"])]:
        n = 512 if "mono" in name else N_FEAT
        print(f"time {name}: device {row['ms']:.4f} ms per launch (100 back-to-back launches), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}, plain {row['plain_ms']:.4f} ms, wrapper host "
              f"{row['host_us']:.1f} us per call (N={n}) on {card}")

    with pose_calls() as record:
        # 4.-8. the paths, recording the pose stage's inputs ----------------------
        with record() as rec4:
            per_frame_path(frames, dev, card)
        with record() as rec6:
            serving = serving_path(frames, dev, card)
        rectification_path(frames, dev, card)
        with record() as rec8:
            mono = mono_path(frames, dev, card)

        # 3. (continued) pose_gn on the inputs phases 4, 6 and 8 recorded -------
        # The PnP polishes, each alone: the first (a RANSAC winner's inlier
        # set) and the one over the most valid points (a prior's polish over
        # every valid point), so the one-pass solve is held over many active
        # rows too; and the first recovery's pair (winner and prior) in its
        # one launch.
        mono_calls = rec8["pose_only_gn_mono_robust"]
        pnp_pairs = rec6[MANY]
        polishes = [((*sv, *a[1:]), kw) for a, kw in pnp_pairs for sv in a[0]] + rec6["pose_only_gn_mono"]
        widest = max(polishes, key=lambda c: int(c[0][2].sum()))
        pose_rows = pose_gn_checks({
            "stereo_steady": ("pose_only_gn_stereo_robust", *rec4["pose_only_gn_stereo_robust"][-1]),
            "mono_steady": ("pose_only_gn_mono_robust", *mono_calls[min(MONO_POSE_CALL, len(mono_calls) - 1)]),
            "pnp_polish": ("pose_only_gn_mono", *polishes[0]),
            "pnp_polish_widest": ("pose_only_gn_mono", *widest),
            "pnp_pair": (MANY, *pnp_pairs[0]),
        }, card)

        # 3. (continued) ba_* on the BA problems phases 4 and 8 recorded and
        # on dryrun_multichip's -------------------------------------------
        # The last keyframe step of each path: the ring at its fullest.
        from visual_odometry_ros_tpu_torch.ops import ba as BA
        from visual_odometry_ros_tpu_torch.parallel import multihost as MH

        prob_np, *intr, T_rl_np = MH.dryrun_problem_np()
        dryrun = ((BA.BAProblem(*(torch.as_tensor(a, device=dev) for a in prob_np)), *intr,
                   torch.as_tensor(T_rl_np, device=dev), BA.BAParams(iters=BA_ITERS)), {})
        ba_rows = ba_checks({"stereo_keyframe": rec4["ba_solve_impl"][-1], "mono_keyframe": rec8["ba_solve_impl"][-1],
                             "dryrun_multichip": dryrun}, card)
        del rec4, rec6, rec8

        # 9. image-level KLT ----------------------------------------------------
        api_sites = image_api_sites(pairs, dev)
        api, api_rows = image_api_path(api_sites)
        cases["klt_pyr"] += api_rows
        api_times = call_site_times(api_sites, card)
        for name, row in api_times.items():
            print(f"time {name}: device {row['ms']:.4f} ms per launch (100 back-to-back launches), bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']}, plain {row['plain_ms']:.4f} ms, call host "
                  f"{row['call_host_us']:.1f} us (N={N_FEAT}) on {card}")

        # 10. the CLI -----------------------------------------------------------
        cli = cli_path(frames, card)

        # 11. distributed BA ----------------------------------------------------
        dist_ba_path(card)

        # 12. the accuracy leg --------------------------------------------------
        acc, acc_fails = accuracy_path(frames, card)

        # 13. the measurement legs ----------------------------------------------
        ab = measurement_legs(frames, card, acc_fails)
        launches = {k: serving[k] + mono[k] + api[k] + cli[k] + acc[k] + ab[k] for k in serving}

    # result ----------------------------------------------------------------
    replaces = {
        "klt_pyr": "visual_odometry_ros_tpu/ops/klt_pallas_fp.py:380",
        "klt_scale": "visual_odometry_ros_tpu/ops/klt_pallas_fp.py:621",
        # Not a Pallas kernel: the device-side lax.while_loop of the pose solve.
        "pose_gn": "visual_odometry_ros_tpu/ops/pose_gn.py:87",
        # Not Pallas kernels: the device-side lax.while_loop of window BA.
        **dict.fromkeys(BA_PARTS, "visual_odometry_ros_tpu/ops/ba.py:417"),
    }
    timing["pose_gn"] = pose_rows["stereo_steady"]
    max_err = {name: max(c["max_dp_px"] for c in cases[name]) for name in cases}
    max_err["pose_gn"] = max(r["max_abs_err_T10"] for r in pose_rows.values())
    source = {"klt_pyr": "klt.cu", "klt_scale": "klt.cu", "pose_gn": "pose_gn.cu", **dict.fromkeys(BA_PARTS, "ba_gn.cu")}
    # ba_*: the stereo keyframe step's solve, each kernel's device ms per
    # solve (its launches summed), the plain version's ms for the same share,
    # the bound of that share, and the wrapper's host time per solve. The
    # apply step has no launch of its own: ba_backsub's blocks add dy and its
    # last block decides, so ba_backsub's row holds the launch's time against
    # both jobs' bound and plain time, and the ba_apply row only describes
    # the step (no launch and no ms of its own; its plain share and its
    # work's bound).
    kf = ba_rows["stereo_keyframe"]
    launches["ba_apply"] = 0
    plain = dict(kf["plain_split_ms"])
    plain["ba_backsub"] += plain["ba_apply"]
    for k in BA_PARTS:
        timing[k] = {"ms": kf["split_ms"].get(k), "plain_ms": plain[k],
                     "bound_ms": kf["bound_ms"][k], "bound_by": kf["bound_by"][k],
                     "host_us": kf["host_us"] if k in BA_KERNELS else None}
        max_err[k] = max(r["max_abs_err_T_cw"] for r in ba_rows.values())
    # ba_solve's yardstick per solve: the library's factor and solve of the
    # optimisable slots' system, once per iteration run.
    timing["ba_solve"]["library_ms"] = kf["library"]["ms_opt"] * kf["iters_kernel_plain"][0]
    table = {"kernels": [
        {
            "name": name, "route": "cuda", "source": f"visual_odometry_ros_tpu_torch/csrc/{source[name]}",
            "replaces": replaces[name], "launches": launches[name], "max_abs_err": max_err[name],
            "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
            "library_ms": timing[name].get("library_ms"),
            "host_ms": None if timing[name]["host_us"] is None else timing[name]["host_us"] * 1e-3,
            **({"runs_as": "inside ba_backsub's launch (Xr += dy in its blocks, the decision in its last block; "
                           "ba_solve takes the poses), no launch of its own"}
               if name == "ba_apply" else {}),
        }
        for name in ("klt_pyr", "klt_scale", "pose_gn", *BA_PARTS)
    ]}
    assert all(r["launches"] > 0 for r in table["kernels"] if "runs_as" not in r), table
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
