"""A cell cut to a size the CPU runs in seconds, for the rehearsal and fault tests."""

import json

from vo_bench import run


def small(batch=4, frames=40, warmup=9, span_calls=1):
    return {"crop": {"width": 320, "height": 160, "n_features": 128, "landmark_capacity": 4096},
            "traffic": {"frames": frames, "batch": batch, "warmup_frames": warmup, "bootstrap_max_frames": 30,
                        "check": {"start_frames": 5, "spans": 1, "span_calls": span_calls}}}


def run_cell(capsys, workload, seconds=4.0, seed=2**31 + 7, with_err=False, **kw):
    """One run of `workload` on the CPU at the small size; its result line
    (and with `with_err`, what it wrote to standard error)."""
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                  device="cpu", overrides=small(**kw))
    assert rc == 0
    cap = capsys.readouterr()
    res = json.loads(cap.out.strip().splitlines()[-1])
    return (res, cap.err) if with_err else res
