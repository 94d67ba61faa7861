"""Window BA's kernels timed on saved BA problems: two trees of the port
compared on one card.

`chip_smoke.py`'s phase 3 saves the BA problems it checks (the last stereo
and mono keyframe steps' and dryrun_multichip's) under
`build/chip_smoke_ba/`. This leg loads them and times `ops/ba.ba_solve_impl`
on the card for the tree it runs in, with that tree's `chip_smoke.py`
helpers, as phase 3 times them:
  - device ms per solve (`device_ms`: the solve's C launcher calls replayed
    back to back between CUDA events) and its split by kernel
    (`kernel_split_ms`: torch.profiler's kernel events);
  - `ba_backsub`'s device us per working launch and per stopped one
    (`launch_us`: the profiler's ba_backsub events in launch order, the
    first `iters` of a solve's launches working, the rest stopped);
  - the first iteration's ba_solve launch split into its two phases, the
    partials' sum alone and the factor and solve alone (`cuda_ms` around a
    launch of one phase; a ba_solve launch writes nothing it reads);
  - host us per solve (`host_us`: perf_counter over calls, no synchronise
    inside);
  - the result's digest (sha1 of T_cw, Xw, the kill flags, both errors and
    the observation count, and the iterations run), so two trees' solves
    are compared bit for bit;
and appends one JSON line per problem to `--out`. `--accuracy LEG` instead
runs the 200-frame HardSequence's stereo leg (`eval_accuracy.run_stereo`,
KLT leg `on` or `off`) twice, window BA on the kernels (every problem
recorded) and on `ba_solve_ref`, and appends one line: both ATEs, and every
recorded problem solved both ways (the largest |dT_cw| and relative error
gaps, the solves whose iteration counts, kill flags or observation counts
differ). It reads nothing of a tree but its BA entry point, its constants
and its chip_smoke.py, so a copy of this file in another tree's package
times that tree's kernels. Run each tree from its root, in turns (A, B, B,
A):

    python -m visual_odometry_ros_tpu_torch.ba_ab --problems build/chip_smoke_ba --tag pr --out ba_ab.jsonl
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import statistics
import sys

import torch

from .ops import ba as BA
from .ops import kernels as KN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """The tree's chip_smoke.py (its root's), whose timing helpers this leg
    uses."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def solve_phase_ms(cs, calls) -> dict:
    """The first iteration's ba_solve launch (calls[2]) with each phase
    alone, after the launches before it."""
    for _, fn, argv in calls[:2]:
        fn(*argv)
    _, fn, (ref, it, _, stream) = calls[2]
    return {name: cs.cuda_ms(lambda: fn(ref, it, phase, stream), reps=100)
            for name, phase in (("sum", BA._SUM), ("solve", BA._SOLVE))}


def launch_us(calls, name: str, n_working: int, reps: int = 5) -> dict:
    """Device us of each launch of kernel `name` in a replay of `calls` (C
    launcher calls of one solve): torch.profiler's events of `name`_kernel
    in launch order over `reps` replays, medians over the launches that did
    work (the first `n_working` of a replay) and over the rest (None where
    there is none)."""
    from torch.profiler import ProfilerActivity, profile

    per = sum(1 for c in calls if c[0] == name)
    for _ in range(3):  # the profiler now and then records no kernel event: take it again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for _, fn, argv in calls:
                    fn(*argv)
            torch.cuda.synchronize()
        ev = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA and f"{name}_kernel" in e.name())
        if len(ev) == per * reps:
            break
    else:
        raise AssertionError(f"launch_us: {len(ev)} {name} events for {reps} replays of {per} launches")
    us = [(e - s) * 1e-3 for s, e in ev]
    working = [t for i, t in enumerate(us) if i % per < n_working]
    stopped = [t for i, t in enumerate(us) if i % per >= n_working]
    return {"working": statistics.median(working) if working else None,
            "stopped": statistics.median(stopped) if stopped else None, "launches": per, "working_launches": n_working}


def time_problem(path: str, dev) -> dict:
    cs = smoke()
    args, kwargs = torch.load(path, weights_only=False)
    args = tuple(tensors(a, lambda t: t.to(dev)) for a in args)
    info = {}
    res = BA.ba_solve_impl(*args, **kwargs, info=info)  # builds and loads the kernels

    def solve():
        return BA.ba_solve_impl(*args, **kwargs)

    calls, held = cs.recorded_launches(solve)
    row = {"problem": os.path.splitext(os.path.basename(path))[0], "K": int(args[0].T_cw.shape[0]),
           "iters": info["iters"], "launches": len(calls), "ms": cs.device_ms([c[1:] for c in calls], reps=20),
           "split_ms": cs.kernel_split_ms(calls), "backsub_us": launch_us(calls, "ba_backsub", info["iters"]),
           "solve_phase_ms": solve_phase_ms(cs, calls),
           "host_us": cs.host_us(solve, reps=20), "result_sha1": digest(res, info["iters"])}
    del held  # held until the replays are done
    return row


def digest(res, iters: int) -> dict:
    """sha1 of each field of a BAResult's bytes, and the iterations run."""
    out = {f: hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]
           for f, t in zip(res._fields, res)}
    return {**out, "iters": iters}


def accuracy(leg: str, frames: int = 200, device="cuda") -> dict:
    """The stereo leg of the accuracy harness on the card with window BA on
    the kernels and on the plain version, and the kernels against the plain
    version on every problem the first run solved."""
    from . import eval_accuracy as EA
    from .io.trajectory import ate_rmse

    il, ir, poses = EA.load_frames(frames)
    kernel_route, problems = BA.ba_solve_impl, []

    def recording(*args, **kwargs):
        args = tuple(tensors(a, torch.Tensor.clone) for a in args)
        problems.append((args, kwargs))
        return kernel_route(*args, **kwargs)

    ate = {}
    for route, fn in (("kernels", recording), ("plain", BA.ba_solve_ref)):
        BA.ba_solve_impl = fn
        try:
            traj, _, _ = EA.run_stereo(il, ir, leg, device)
        finally:
            BA.ba_solve_impl = kernel_route
        ate[route] = float(ate_rmse(traj, poses, align="none"))
    worst = dict.fromkeys(("d_T_cw", "err_rel", "err0_rel"), 0.0)
    differ = {"iters": [], "killed": [], "n_obs": []}
    for i, (args, kwargs) in enumerate(problems):
        info_k, info_r = {}, {}
        k = BA.ba_solve_impl(*args, **kwargs, info=info_k)
        r = BA.ba_solve_ref(*args, **kwargs, info=info_r)
        worst["d_T_cw"] = max(worst["d_T_cw"], float((k.T_cw - r.T_cw).abs().max()))
        for key, a, b in (("err_rel", k.mean_err_px, r.mean_err_px), ("err0_rel", k.mean_err0_px, r.mean_err0_px)):
            worst[key] = max(worst[key], abs(float(a) - float(b)) / max(abs(float(b)), 1e-12))
        for key, same in (("iters", info_k["iters"] == info_r["iters"]), ("killed", torch.equal(k.killed, r.killed)),
                          ("n_obs", int(k.n_obs) == int(r.n_obs))):
            if not same:
                differ[key].append(i)
    return {"accuracy_leg": leg, "frames": frames, "stereo_ate_m": ate, "solves": len(problems),
            "kernels_vs_plain": {**worst, "differ": differ}}


def tensors(x, fn):
    """fn applied to every tensor in x, through named tuples (BAProblem,
    BAParams), tuples and lists; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tensors(v, fn) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tensors(v, fn) for v in x)
    return x


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--problems", default="build/chip_smoke_ba", help="directory of the saved problems (*.pt)")
    p.add_argument("--tag", required=True, help="the tree's name in the records")
    p.add_argument("--out", required=True, help="JSON lines file to append to")
    p.add_argument("--accuracy", choices=["on", "off"], default=None,
                   help="run the accuracy harness's stereo leg (this KLT leg) instead of timing the problems")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ba_ab: needs a CUDA GPU")
    dev = torch.device("cuda")
    KN.build()
    rows = []
    if args.accuracy:
        rows.append({"tag": args.tag, **accuracy(args.accuracy), "device": torch.cuda.get_device_name(0)})
        print(json.dumps(rows[-1]))
    for path in [] if args.accuracy else sorted(glob.glob(os.path.join(args.problems, "*.pt"))):
        row = {"tag": args.tag, **time_problem(path, dev), "device": torch.cuda.get_device_name(0)}
        rows.append(row)
        print(json.dumps(row))
    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
