"""The readings that a cell's comparison limits are set from, on the card.

    python3 -m vo_bench.control --workload <name> --seeds 11,12,13 --seconds 8 [--out FILE]

For each seed, one run of the cell (set-up and a window at the cell's own
load, as `vo_bench.run` makes them), then checks of the same copied
spans: the program against the reference (the sound reading), and each
control (`run.CONTROLS`: the reference in TF32) put in the program's place
against the reference. One JSON line per seed; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="tf32", help="comma-separated names of run.CONTROLS, or none")
    ap.add_argument("--frames", type=int, help="frames to render (default: the traffic file's)")
    ap.add_argument("--out", help="also append each line to this file")
    args = ap.parse_args(argv)

    import torch

    from .run import Run

    if not torch.cuda.is_available():
        print("vo_bench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ov = {"traffic": {"frames": args.frames}} if args.frames else None
        run = Run(args.workload, seed, args.seconds, False, device=torch.device("cuda", 0), overrides=ov)
        t0 = time.perf_counter()
        run.setup()
        run.window()
        run.free_program()
        t1 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed, "frames": run.n_frames, "window_s": run.window_s,
               "setup_s": t1 - t0 - run.window_s, "keyframes": run.keyframes(), "recoveries": run.recoveries(),
               "sound": run.check()}
        rec["compared"] = run.compared
        t2 = time.perf_counter()
        rec["check_s"] = t2 - t1
        for name in filter(None, args.controls.replace("none", "").split(",")):
            t2 = time.perf_counter()
            rec[name] = run.check(name)
            rec[name + "_s"] = time.perf_counter() - t2
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
