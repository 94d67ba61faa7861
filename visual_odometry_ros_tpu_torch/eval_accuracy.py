"""Accuracy leg of the port: the counterpart of scripts/eval_accuracy.py.

Runs stereo and mono VO over the 200-frame adversarial HardSequence
(exposure drift, a moving occluder, repeated texture, varying speed with
S-curves; `io/synthetic.py`) with the reference harness's configuration and
schedule, records ATE and RPE, and renders the port's rows beside the JAX
package's (ACCURACY.json, read only) with the reference's gate, ATE <= the
JAX CPU leg's x 1.2 + 1 cm, for stereo and for mono.

  python -m visual_odometry_ros_tpu_torch.eval_accuracy --tag h100              # kernel leg, on the card
  python -m visual_odometry_ros_tpu_torch.eval_accuracy --kernels off --tag h100_plain
  python -m visual_odometry_ros_tpu_torch.eval_accuracy --device cpu --frames 30 --tag cpu30
  python -m visual_odometry_ros_tpu_torch.eval_accuracy --render-only           # just write the md

--kernels: "on" runs the KLT kernel leg (the hand CUDA kernels on the card,
their plain versions on the CPU), "off" the port of the JAX package's jnp
leg (plain PyTorch, no kernel), "auto" the kernel leg on the card and the
jnp leg on the CPU, as the reference picks Pallas on a non-CPU backend.

Frames are rendered once in a process pool and cached under
build/accuracy/, keyed by the world's parameters and the renderer's source.
Each run writes its row into ACCURACY_TORCH.json and regenerates
ACCURACY_TORCH.md (in --out, by default the repository root); ACCURACY.json
and ACCURACY.md are never written. `main(argv)` returns the row.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import inspect
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REF_JSON = ROOT / "ACCURACY.json"
CACHE_DIR = ROOT / "build" / "accuracy"
JSON_NAME, MD_NAME = "ACCURACY_TORCH.json", "ACCURACY_TORCH.md"

CHUNK = 25  # frames per track_stereo_batch / track_batch call (eval_accuracy.py:87)
SIZE = (640, 480)
STEP, TRAJ_SEED, BASELINE = 0.3, 5, 0.5  # varied_trajectory(n, step=0.3), HardSequence(baseline=0.5)


def _config(kernels: str, size=SIZE, mono: bool = False):
    """eval_accuracy.py:41-85's configuration; `size` (W, H) scales the
    intrinsics of the 640x480 camera (fx = fy = 500, cx = 320, cy = 240)."""
    from .config import VOConfig

    W, H = size
    cfg = VOConfig()
    cfg.cam.fx = cfg.cam.fy = 500.0 * W / SIZE[0]
    cfg.cam.cx, cfg.cam.cy = 320.0 * W / SIZE[0], 240.0 * H / SIZE[1]
    cfg.cam.width, cfg.cam.height = W, H
    if not mono:
        cfg.cam_right = cfg.cam
        T_lr = np.eye(4, dtype=np.float32)
        T_lr[0, 3] = BASELINE
        cfg.T_lr = T_lr
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = 512
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 7
    cfg.keyframe.thres_translation = 1.2
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    cfg.tracker.use_pallas = kernels
    return cfg


def resolve_kernels(kernels: str, device) -> str:
    """"auto" -> "on" on the card, "off" on the CPU; "on" / "off" as given."""
    import torch

    if kernels == "auto":
        return "on" if torch.device(device).type == "cuda" else "off"
    if kernels not in ("on", "off"):
        raise ValueError(f"kernels must be 'auto', 'on' or 'off', got {kernels!r}")
    return kernels


def build_stereo(kernels: str = "auto", device="cuda", size=SIZE):
    from .models.stereo_vo import StereoVO

    return StereoVO(_config(resolve_kernels(kernels, device), size), device=device)


def build_mono(kernels: str = "auto", device="cuda", size=SIZE):
    from .models.mono_vo import MonoVO

    return MonoVO(_config(resolve_kernels(kernels, device), size, mono=True), device=device)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_stereo(il, ir, kernels: str = "auto", device="cuda", size=SIZE):
    """track_stereo_batch in chunks of CHUNK on the float32 frames as
    `stereo_pair` returns them (eval_accuracy.py:87-101). Returns
    (trajectory [n, 4, 4], wall seconds, stats_log)."""
    vo = build_stereo(kernels, device, size)
    _sync(device)
    t0 = time.perf_counter()
    for s in range(0, len(il), CHUNK):
        vo.track_stereo_batch(il[s : s + CHUNK], ir[s : s + CHUNK])
    _sync(device)
    return np.stack(vo.trajectory), time.perf_counter() - t0, vo.stats_log


def run_mono(imgs, kernels: str = "auto", device="cuda", size=SIZE):
    """track_image until the bootstrap (phase 2), then track_batch in chunks
    of CHUNK (eval_accuracy.py:104-119). Returns (trajectory, wall seconds,
    the first frame that reached phase bootstrapped or steady)."""
    vo = build_mono(kernels, device, size)
    _sync(device)
    t0 = time.perf_counter()
    first_steady = None
    i = 0
    while i < len(imgs) and vo.phase != 2:
        _, stats = vo.track_image(imgs[i])
        if first_steady is None and stats.get("phase") in ("bootstrapped", "steady"):
            first_steady = i
        i += 1
    while i < len(imgs):
        vo.track_batch(np.stack(imgs[i : i + CHUNK]))
        i += CHUNK
    _sync(device)
    return np.stack(vo.trajectory), time.perf_counter() - t0, first_steady or 0


# ---------------------------------------------------------------------------
# The world and its frame cache
# ---------------------------------------------------------------------------


def world_params(frames: int, size=SIZE) -> dict:
    return {"frames": frames, "step": STEP, "seed": TRAJ_SEED, "baseline": BASELINE,
            "width": size[0], "height": size[1]}


@functools.lru_cache(maxsize=2)
def _world(frames, step, seed, baseline, width, height):
    """(HardSequence fit around varied_trajectory(frames, step, seed), poses)."""
    from .io.synthetic import HardSequence, varied_trajectory

    poses = varied_trajectory(frames, step=step, seed=seed)
    s = width / SIZE[0]
    world = HardSequence(width=width, height=height, fx=500.0 * s, fy=500.0 * s, cx=320.0 * s,
                         cy=240.0 * height / SIZE[1], poses_T_wc=poses, baseline=baseline)
    return world, poses


def _render(job):
    params, i = job
    world, poses = _world(*params)
    return world.stereo_pair(poses[i].astype(np.float64), frame=i)


def cache_key(params: dict, source: str | None = None) -> str:
    """sha256 of the world's parameters and of the renderer's source
    (io/synthetic.py unless `source` is given)."""
    if source is None:
        from .io import synthetic

        source = inspect.getsource(synthetic)
    h = hashlib.sha256(json.dumps(params, sort_keys=True).encode())
    h.update(source.encode())
    return h.hexdigest()


def load_frames(frames: int, size=SIZE, cache: bool = True, workers: int | None = None):
    """(il, ir [n, H, W] float32, poses [n, 4, 4]) of the sequence: frame i
    rendered with frame=i in a spawn process pool, or read from the cache."""
    params = world_params(frames, size)
    poses = _world(*params.values())[1]
    path = CACHE_DIR / f"frames_{cache_key(params)[:20]}.npz"
    if cache and path.exists():
        with np.load(path) as z:
            print(f"loaded {frames} cached stereo pairs from {path}", flush=True)
            return z["il"], z["ir"], poses
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    workers = workers or max(1, min(8, os.cpu_count() or 1))
    t = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        pairs = list(ex.map(_render, [(tuple(params.values()), i) for i in range(frames)]))
    il, ir = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    print(f"rendered {frames} stereo pairs at {size[0]}x{size[1]} in {time.perf_counter() - t:.1f} s "
          f"({workers} processes)", flush=True)
    if cache:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, il=il, ir=ir)
        os.replace(tmp, path)
    return il, ir, poses


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def card_info(device) -> dict:
    """The device's name and power limit (nvidia-smi) and the versions."""
    import torch

    info = {"torch": torch.__version__, "cuda": torch.version.cuda, "card": None}
    if torch.device(device).type == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
        info["card"] = out.stdout.strip().splitlines()[torch.device(device).index or 0]
    return info


def _de_nan(obj):
    """NaN / Inf -> None, so a failed metric is an explicit null."""
    if isinstance(obj, dict):
        return {k: _de_nan(v) for k, v in obj.items()}
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def evaluate(il, ir, poses, kernels: str = "auto", device="cuda", size=SIZE) -> dict:
    """Both legs over the frames; returns the row (without the tag)."""
    import torch

    from .io.trajectory import ate_rmse, rpe
    from .ops import kernels as KN

    leg = resolve_kernels(kernels, device)
    KN.reset_launch_counts()
    dist = float(np.sum(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)))
    print(f"stereo run ({device}, kernels {leg}) ...", flush=True)
    traj_s, wall_s, slog = run_stereo(il, ir, leg, device, size)
    ate_s = float(ate_rmse(traj_s, poses, align="none"))
    t_rmse, r_rmse = rpe(traj_s, poses)
    print(f"mono run ({device}, kernels {leg}) ...", flush=True)
    traj_m, wall_m, first = run_mono(list(il), leg, device, size)
    ate_m = float(ate_rmse(traj_m, poses, align="sim3"))
    launches = dict(KN.LAUNCHES)
    on_card = torch.device(device).type == "cuda"
    return _de_nan({
        "platform": "cuda" if on_card else "cpu",
        "kernels": "cuda" if leg == "on" and on_card else "plain",
        "klt_leg": leg,
        "launches": launches,
        "frames": len(poses),
        "size": list(size),
        "distance_m": dist,
        "stereo": {
            "ate_rmse_m": ate_s,
            "ate_pct_of_dist": 100.0 * ate_s / dist,
            "rpe_trans_m": float(t_rmse),
            "rpe_rot_deg": float(r_rmse),
            "n_pose_fail": sum(1 for s in slog if s.get("pose_ok") is False),
            "n_recoveries": sum(1 for s in slog if s.get("recovered", 0) > 0),
            "wall_s": wall_s,
        },
        "mono": {"ate_rmse_sim3_m": ate_m, "ate_pct_of_dist": 100.0 * ate_m / dist, "first_steady": first,
                 "wall_s": wall_m},
        **card_info(device),
    })


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device of both pipelines (cuda, cuda:1, cpu)")
    p.add_argument("--kernels", choices=["auto", "on", "off"], default="auto",
                   help="KLT leg: on = the kernel leg, off = the port of the jnp leg (no kernel); "
                        "auto = on on the card, off on the CPU")
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--tag", default=None, help="record key (default: the platform's name)")
    p.add_argument("--render-only", action="store_true", help="only regenerate ACCURACY_TORCH.md")
    p.add_argument("--no-cache", action="store_true", help="render the frames even if they are cached")
    p.add_argument("--out", default=str(ROOT), help="directory of ACCURACY_TORCH.json and .md")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out = Path(args.out)
    if args.render_only:
        render_md(out)
        return None
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA GPU here (pass --device cpu for a CPU run)")
    il, ir, poses = load_frames(args.frames, cache=not args.no_cache)
    rec = evaluate(il, ir, poses, args.kernels, args.device)
    print(json.dumps(rec, indent=1, allow_nan=False), flush=True)
    path = out / JSON_NAME
    records = json.loads(path.read_text()) if path.exists() else {}
    records[args.tag or rec["platform"]] = rec
    out.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(records, indent=1, allow_nan=False) + "\n")
    render_md(out)
    return rec


# ---------------------------------------------------------------------------
# ACCURACY_TORCH.md
# ---------------------------------------------------------------------------


def gates(ref: dict) -> dict:
    """The reference's rule (ACCURACY.md:29, eval_accuracy.py:280-290):
    ATE <= the JAX CPU leg's x 1.2 + 0.01 m, for stereo and for mono."""
    cpu = ref["cpu"]
    return {"stereo": cpu["stereo"]["ate_rmse_m"] * 1.2 + 0.01, "mono": cpu["mono"]["ate_rmse_sim3_m"] * 1.2 + 0.01}


def _fmt(v, nd=4, pct=False):
    if v is None:
        return "n/a"
    return f"{v:.3f}%" if pct else f"{round(v, nd)}"


def render_md(out: Path) -> None:
    ref = json.loads(REF_JSON.read_text())
    path = out / JSON_NAME
    rows = json.loads(path.read_text()) if path.exists() else {}
    g = gates(ref)
    pallas = ref["tpu"]
    lines = [
        "# ACCURACY_TORCH — the port on the 200-frame HardSequence",
        "",
        "The PyTorch + CUDA port (`visual_odometry_ros_tpu_torch`) on the sequence and",
        "configuration of `ACCURACY.md` (640x480, fx = fy = 500, N = 512 in 16x10 bins,",
        "M = 4096, K = 7 + 1, 3 levels, 15 iterations; stereo through `track_stereo_batch`",
        "in chunks of 25 float32 frames, mono through `track_image` to the bootstrap and",
        "then `track_batch`), rendered by the port's own `io/synthetic.py`. Harness:",
        "`python -m visual_odometry_ros_tpu_torch.eval_accuracy`. The JAX rows are read",
        "from `ACCURACY.json`, unchanged. Kernels: `cuda (kernel leg)` = the hand KLT",
        "kernels on the card; `plain (kernel leg)` = their plain PyTorch versions (CPU);",
        "`plain (jnp leg)` = the port of the JAX jnp leg (plain PyTorch, no KLT kernel);",
        "`+ pose_gn` = the pose solve ran as the hand `pose_gn` kernel, `+ ba_*` = the",
        "keyframe steps' window BA as the hand `ba_*` kernels (rows that record their",
        "kernel launches; on the card both legs run them); `pallas` / `jnp` = the JAX legs.",
        "",
        "| row | platform | card | kernels | frames | dist (m) | stereo ATE (m) | stereo ATE %dist "
        "| stereo RPE t (m) | stereo RPE r (deg) | pose fails | recoveries | mono ATE sim3 (m) "
        "| mono ATE %dist | stereo s | mono s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for tag, r in sorted(ref.items()):
        s, m = r["stereo"], r["mono"]
        lines.append(
            f"| {tag} (JAX) | {r['platform']} | | {'pallas' if r['use_pallas'] else 'jnp'} | {r['frames']} "
            f"| {r['distance_m']} | {s['ate_rmse_m']} | {s['ate_pct_of_dist']}% | {s['rpe_trans_m']} "
            f"| {s['rpe_rot_deg']} | {s['n_pose_fail']} | {s['n_recoveries']} | {m['ate_rmse_sim3_m']} "
            f"| {m['ate_pct_of_dist']}% | {s['wall_s']} | {m['wall_s']} |")
    for tag, r in sorted(rows.items()):
        s, m = r["stereo"], r["mono"]
        lines.append(
            f"| {tag} | {r['platform']} | {r['card'] or 'CPU'} | {r['kernels']} "
            f"({'kernel' if r['klt_leg'] == 'on' else 'jnp'} leg)"
            f"{' + pose_gn' if r.get('launches', {}).get('pose_gn') else ''}"
            f"{' + ba_*' if r.get('launches', {}).get('ba_solve') else ''} | {r['frames']} "
            f"| {_fmt(r['distance_m'], 2)} | {_fmt(s['ate_rmse_m'])} | {_fmt(s['ate_pct_of_dist'], pct=True)} "
            f"| {_fmt(s['rpe_trans_m'])} | {_fmt(s['rpe_rot_deg'])} | {s['n_pose_fail']} | {s['n_recoveries']} "
            f"| {_fmt(m['ate_rmse_sim3_m'])} | {_fmt(m['ate_pct_of_dist'], pct=True)} | {_fmt(s['wall_s'], 1)} "
            f"| {_fmt(m['wall_s'], 1)} |")
    lines += [
        "",
        f"**Gates** (the JAX CPU leg x 1.2 + 1 cm): stereo ATE <= {g['stereo']:.4f} m, mono sim3 ATE <= "
        f"{g['mono']:.4f} m. Beside them, each row against the JAX Pallas leg ({pallas['stereo']['ate_rmse_m']} m "
        f"stereo, {pallas['mono']['ate_rmse_sim3_m']} m mono).",
        "",
    ]

    def verdict(v, limit):
        if v is None:
            return "FAIL (diverged: ATE is null)"
        return f"{'PASS' if v <= limit else 'FAIL'} ({v:.4f} m vs {limit:.4f} m)"

    for tag, r in sorted(rows.items()):
        if r["frames"] != ref["cpu"]["frames"] or r["size"] != list(SIZE):
            lines.append(f"- **{tag}**: {r['frames']} frames at {r['size'][0]}x{r['size'][1]}: not the gated "
                         "sequence")
            continue
        s, m = r["stereo"]["ate_rmse_m"], r["mono"]["ate_rmse_sim3_m"]
        vs = [f"{v / p:.2f}x" if v is not None else "n/a"
              for v, p in ((s, pallas["stereo"]["ate_rmse_m"]), (m, pallas["mono"]["ate_rmse_sim3_m"]))]
        lines.append(f"- **{tag}**: stereo {verdict(s, g['stereo'])}; mono {verdict(m, g['mono'])}; "
                     f"against the Pallas leg: stereo {vs[0]}, mono {vs[1]}")
    lines.append("")
    out.mkdir(parents=True, exist_ok=True)
    (out / MD_NAME).write_text("\n".join(lines))
    print(f"wrote {out / MD_NAME}")


if __name__ == "__main__":
    main()
