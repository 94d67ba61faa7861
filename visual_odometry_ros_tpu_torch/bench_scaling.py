"""BA scaling sweep over world sizes: the port's counterpart of
scripts/bench_scaling.py.

For each world size in --worlds, spawns that many ranks of
`python -m visual_odometry_ros_tpu_torch.parallel.multihost` (one process
per rank, rendezvous by `file://` in a temporary directory, each child with
a timeout) on scripts/bench_scaling.py's seeded problem, and records one
line per world: GN iterations per second of the landmark-sharded Schur BA,
ms per solve, the shard-local assembly's ms per iteration against the rest
of an iteration (the all-reduce and the replicated 6K x 6K solve), the bytes
that `ops/ba._all_reduce` reduces (counted by `ops/ba.COLLECTIVES`) and the
final mean reprojection error; then the scaling efficiency of the last
world against the first.

Weak scaling by default (--lm-per-rank landmarks per rank); --strong
--landmarks M shards one problem. With a card the ranks use NCCL, one card
each: one card holds a world of 1 (NCCL refuses two ranks on one card).
--device cpu runs gloo ranks on the CPU, where worlds of 2 and 4 share the
host's cores.

  python -m visual_odometry_ros_tpu_torch.bench_scaling --worlds 1               # on the card
  python -m visual_odometry_ros_tpu_torch.bench_scaling --device cpu --worlds 1 2 4 --lm-per-rank 1024

Appends its records to --json-out (default SCALING_TORCH.json at the
repository root; never the reference's SCALING_r*.json). `main(argv)`
returns the records.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_NAME = "SCALING_TORCH.json"


def payload_bytes_per_solve(iters: int, window: int, n_opt: int | None = None) -> int:
    """The float32 bytes `ops/ba.ba_solve_impl` all-reduces in a solve of
    `iters` GN iterations over a window of K keyframes: per iteration the
    reduced system with the divergence count (the plain version, on CPU
    ranks: S [K, K, 6, 6] and s [K, 6]; the kernels, on CUDA ranks, given
    the n_opt optimisable slots: S's lower block triangle and s over those,
    `ops/ba.n_sys`); the starting error's sum and count; the final error's
    sum and both observation counts."""
    from .ops.ba import n_sys

    K = window
    per_iter = 36 * K * K + 6 * K + 1 if n_opt is None else n_sys(n_opt)
    return iters * 4 * per_iter + 4 * 2 + 4 * 3


def scaling_efficiency(base: dict, last: dict, strong: bool, host_limited: bool) -> dict:
    """scripts/bench_scaling.py:289-327's efficiency line of the last world
    against the first. Weak scaling's ideal is flat iters/s; strong
    scaling's is iters/s growing with the world. `host_limited`: the ranks
    share one host's cores (gloo worlds on the CPU), so the total compute is
    fixed: strong scaling's ideal is then flat and weak scaling's 1/N.
    Capped at 1, with the raw iters/s ratio beside it."""
    dev_ratio = last["devices"] / base["devices"]
    raw_ratio = last["value"] / base["value"]
    if strong:
        eff = raw_ratio if host_limited else raw_ratio / dev_ratio
    else:
        eff = raw_ratio * (dev_ratio if host_limited else 1.0)
    return {
        "metric": "scaling_efficiency",
        "mode": "strong" if strong else "weak",
        "host_limited_ideal": host_limited,
        "devices": last["devices"],
        "value": round(min(eff, 1.0), 3),
        "raw_iters_ratio": round(raw_ratio, 3),
        "unit": "fraction",
    }


def spawn_world(world: int, landmarks: int, window: int, iters: int, reps: int, backend: str,
                timeout: float = 600.0, seed: int = 0) -> list:
    """Run `world` multihost ranks on build_problem_np(landmarks, window,
    seed); returns every rank's record (the JSON line each prints)."""
    env = dict(os.environ)
    if backend == "gloo":
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "visual_odometry_ros_tpu_torch.parallel.multihost", "--world", str(world),
               "--init", f"file://{tmp}/rendezvous", "--backend", backend, "--timeout", str(timeout),
               "--landmarks", str(landmarks), "--window", str(window), "--iters", str(iters),
               "--reps", str(reps), "--seed", str(seed)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                p.kill()
    bad = [(r, rc, err[-2000:]) for r, (rc, _, err) in enumerate(outs) if rc != 0]
    if bad:
        raise RuntimeError(f"world {world}: ranks failed: {bad}")
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def world_record(ranks: list) -> dict:
    """One world's line from its ranks' records (rank 0's times; every rank
    ran the same number of iterations and all-reduces)."""
    r0 = ranks[0]
    its = {r["iters_run"] for r in ranks}
    if len(its) != 1 or len({r["all_reduces"] for r in ranks}) != 1:
        raise RuntimeError(f"ranks disagree on iterations or all-reduces: {ranks}")
    iters = r0["iters_run"]
    iter_ms = r0["ms_per_solve"] / iters
    return {
        "metric": "ba_iters_per_s",
        "devices": r0["world"],
        "backend": r0["backend"],
        "device": r0["device"],
        "landmarks": r0["landmarks"],
        "window": r0["window"],
        "iters_run": iters,
        "value": iters * 1e3 / r0["ms_per_solve"],
        "unit": "GN iters/s",
        "ms_per_solve": r0["ms_per_solve"],
        "assembly_ms_per_iter": r0["assembly_ms"],
        "collective_and_solve_ms_per_iter": max(iter_ms - r0["assembly_ms"], 0.0),
        "all_reduces_per_solve": r0["all_reduces"],
        "psum_payload_bytes_per_solve": r0["all_reduce_bytes"],
        "psum_payload_bytes_per_iter": r0["all_reduce_bytes"] / iters,
        "mean_err_px": r0["mean_err_px"],
        "n_obs": r0["n_obs"],
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: NCCL ranks, one card each; cpu: gloo ranks")
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--lm-per-rank", type=int, default=4096)
    p.add_argument("--landmarks", type=int, default=None, help="total landmarks (strong scaling)")
    p.add_argument("--strong", action="store_true")
    p.add_argument("--window", type=int, default=9)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--timeout", type=float, default=600.0, help="seconds a rank may take")
    p.add_argument("--json-out", default=str(ROOT / OUT_NAME), help="append the records to this JSON file")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA GPU here (pass --device cpu for gloo ranks)")
        backend, have = "nccl", torch.cuda.device_count()
    else:
        backend, have = "gloo", max(args.worlds)
    sizes = [w for w in args.worlds if w <= have]
    if sizes != args.worlds:
        print(f"# {have} cards: running worlds {sizes}", file=sys.stderr)
    if not sizes:
        raise SystemExit(f"no world of {args.worlds} fits {have} cards")
    from .eval_accuracy import card_info

    card = card_info(args.device)
    results = []
    for nd in sizes:
        M = (args.landmarks or args.lm_per_rank * max(sizes)) if args.strong else args.lm_per_rank * nd
        M = (M + nd - 1) // nd * nd
        rec = world_record(spawn_world(nd, M, args.window, args.iters, args.reps, backend, args.timeout))
        rec.update(card)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if len(results) >= 2:
        eff = scaling_efficiency(results[0], results[-1], args.strong, host_limited=backend == "gloo")
        results.append(eff)
        print(json.dumps(eff))
    if args.json_out:
        path = Path(args.json_out)
        existing = json.loads(path.read_text()) if path.exists() else []
        path.write_text(json.dumps(existing + results, indent=1) + "\n")
    return results


if __name__ == "__main__":
    main()
