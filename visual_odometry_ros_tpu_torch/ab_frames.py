"""Frame-synced A/B of the port's two KLT legs: the counterpart of
scripts/ab_frames.py.

Runs two StereoVOs in one process over the same HardSequence frames
(`varied_trajectory(frames, step=0.3)`, baseline 0.5 m; the accuracy leg's
sequence, configuration and frame cache, `eval_accuracy.py`), one frame at a
time through `track_stereo_images`:

- `kernel`: `eval_accuracy.build_stereo("on")`, the KLT kernel leg (the hand
  CUDA kernels on the card, their plain PyTorch versions on the CPU); the
  reference's `pallas` leg;
- `plain`: `build_stereo("off")`, the port of the reference's jnp leg (plain
  PyTorch, no kernel); the reference's `jnp` leg.

Each frame logs both legs' surviving tracks, inliers, pose flag, pose-GN
error, recovery mode and the frame-to-frame motion error against the ground
truth (rotation in degrees, translation in metres). The summary gives the
rotation error's median, 90% quantile and max per leg and the first frame
where the two legs' rotation errors part by more than 0.2 degrees.

  python -m visual_odometry_ros_tpu_torch.ab_frames --frames 120      # on the card
  python -m visual_odometry_ros_tpu_torch.ab_frames --device cpu --frames 30 --out /tmp/ab

Writes AB_FRAMES_TORCH.json (in --out, by default the repository root),
never AB_FRAMES.json. `main(argv)` returns the record.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from . import eval_accuracy as EA

ROOT = Path(__file__).resolve().parents[1]
OUT_NAME = "AB_FRAMES_TORCH.json"
DIVERGE_DEG = 0.2  # scripts/ab_frames.py's threshold
LEGS = {"plain": "off", "kernel": "on"}  # the reference's "jnp" and "pallas"


def rot_deg(R) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def run_ab(il, ir, poses, device="cuda", size=EA.SIZE) -> tuple:
    """Both legs over the float32 pairs il, ir [n, H, W] with ground-truth
    poses [n, 4, 4]. Returns (rows, summary) in the reference's layout."""
    vos = {name: EA.build_stereo(leg, device, size) for name, leg in LEGS.items()}
    rows = []
    for i in range(len(il)):
        row = {"frame": i}
        for name, vo in vos.items():
            _, st = vo.track_stereo_images(il[i], ir[i])
            row[name] = {
                "n_tracked": st.get("n_tracked", 0),
                "n_inliers": st.get("n_inliers", 0),
                "pose_ok": st.get("pose_ok", True),
                "err": st.get("mean_reproj_err", 0.0),
                "rec": st.get("recovered", 0),
            }
        if i >= 1:
            dT_gt = np.linalg.inv(poses[i - 1]) @ poses[i]
            for name, vo in vos.items():
                dT = np.linalg.inv(vo.trajectory[-2]) @ vo.trajectory[-1]
                E = np.linalg.inv(dT_gt) @ dT
                row[name]["rot_err_deg"] = rot_deg(E[:3, :3])
                row[name]["t_err"] = float(np.linalg.norm(E[:3, 3]))
        rows.append(row)
    return rows, summarize(rows)


def summarize(rows) -> dict:
    """Quantiles of each leg's per-frame rotation error and the first frame
    where the legs part by more than DIVERGE_DEG."""
    out = {"frames": len(rows)}
    for name in LEGS:
        r = np.array([row[name]["rot_err_deg"] for row in rows[1:]])
        out[f"rot_err_deg_{name}_q50_q90_max"] = [float(np.median(r)), float(np.quantile(r, 0.9)), float(r.max())]
        out[f"n_pose_fail_{name}"] = sum(1 for row in rows if row[name]["pose_ok"] is False)
    out["first_divergent_frame"] = next(
        (row["frame"] for row in rows[1:]
         if abs(row["plain"]["rot_err_deg"] - row["kernel"]["rot_err_deg"]) > DIVERGE_DEG), None)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device of both legs (cuda, cuda:1, cpu)")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--out", default=str(ROOT), help=f"directory of {OUT_NAME}")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA GPU here (pass --device cpu for a CPU run)")
    il, ir, poses = EA.load_frames(args.frames)
    t = time.perf_counter()
    rows, summary = run_ab(il, ir, poses, args.device)
    rec = {
        "platform": "cuda" if on_card else "cpu",
        "legs": {"plain": "build_stereo('off'): the port of the reference's jnp leg (the JAX key 'jnp')",
                 "kernel": ("build_stereo('on'): the hand CUDA KLT kernels" if on_card else
                            "build_stereo('on') on the CPU: the KLT kernels' plain PyTorch versions")
                           + " (the JAX key 'pallas')"},
        **EA.card_info(args.device), "wall_s": time.perf_counter() - t, "summary": summary,
        "rows": [EA._de_nan(r) for r in rows],  # a NaN pose-GN error becomes null
    }
    print(json.dumps(summary, indent=1))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / OUT_NAME).write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {out / OUT_NAME}")
    return rec


if __name__ == "__main__":
    main()
