"""The pose solve's kernel timed on saved pose calls: two trees of the port
compared on one card.

`chip_smoke.py`'s phase 3 saves the pose calls it checks (a steady stereo
frame, a steady mono frame, the first PnP polish of a recovery, the polish
over the most valid points, and a recovery's pair of polishes) under
`build/chip_smoke_pose/`. This leg loads them and times the tree's public
pose function on the card, with that tree's `chip_smoke.py` helpers, as
phase 3 times them:
  - device ms per call (`device_ms`: the call's C launcher calls replayed
    back to back between CUDA events), the launches per call and the
    iterations (the most of the call's solves), so us per iteration;
  - host us per call (`host_us`: perf_counter over calls, no synchronise
    inside);
and appends one JSON line per case to `--out`. A case of several solves
(`pose_only_gn_mono_many`) runs, in a tree without that function, as single
calls of `pose_only_gn_mono` in turn. It reads nothing of a tree but its
pose entry points and its chip_smoke.py, so a copy of this file in another
tree's package times that tree's kernel. Run each tree from its root, in
turns (A, B, B, A):

    python -m visual_odometry_ros_tpu_torch.pose_ab --cases build/chip_smoke_pose --tag pr --out pose_ab.jsonl
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import torch

from .ba_ab import tensors
from .ops import kernels as KN
from .ops import pose_gn as PG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANY = "pose_only_gn_mono_many"


def smoke():
    """The tree's chip_smoke.py (its root's), whose timing helpers this leg
    uses."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def load_case(path: str, dev):
    """(function name, args, kwargs) of a saved pose call, tensors on dev."""
    case = torch.load(path, weights_only=False)
    return case["function"], tensors(case["args"], lambda t: t.to(dev)), case["kwargs"]


def results(fn_name: str, args, kwargs) -> list:
    """The call's PoseGNResult of each solve, through the tree's public
    function (a pair in a tree without `pose_only_gn_mono_many`: single
    calls in turn)."""
    if fn_name == MANY and not hasattr(PG, MANY):
        return [PG.pose_only_gn_mono(*s, *args[1:], **kwargs) for s in args[0]]
    out = getattr(PG, fn_name)(*args, **kwargs)
    if fn_name == MANY:
        return list(out)
    return [out[0] if fn_name.endswith("_robust") else out]


def time_case(path: str, dev) -> dict:
    cs = smoke()
    fn_name, args, kwargs = load_case(path, dev)
    first = results(fn_name, args, kwargs)  # builds and loads the kernels
    iters = [int(r.n_iter) for r in first]

    def call():
        return results(fn_name, args, kwargs)

    calls, held = cs.recorded_launches(call)
    row = {"case": os.path.splitext(os.path.basename(path))[0], "function": fn_name, "solves": len(first),
           "launches": len(calls), "n_iter": iters, "ms": cs.device_ms([c[1:] for c in calls]),
           "host_us": cs.host_us(call)}
    row["us_per_iter"] = row["ms"] * 1e3 / max(max(iters), 1)
    del held  # held until the replays are done
    return row


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cases", default="build/chip_smoke_pose", help="directory of the saved pose calls (*.pt)")
    p.add_argument("--tag", required=True, help="the tree's name in the records")
    p.add_argument("--out", required=True, help="JSON lines file to append to")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pose_ab: needs a CUDA GPU")
    dev = torch.device("cuda")
    KN.build()
    rows = []
    for path in sorted(glob.glob(os.path.join(args.cases, "*.pt"))):
        row = {"tag": args.tag, **time_case(path, dev), "device": torch.cuda.get_device_name(0)}
        rows.append(row)
        print(json.dumps(row))
    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
