"""Multi-process runtime for the distributed BA path.

Counterpart of `visual_odometry_ros_tpu/parallel/multihost.py`: one process
per device, joined in a `torch.distributed` process group (NCCL between
cards, gloo between CPU processes), and the landmark-sharded Schur BA of
`parallel/dist_ba.py` over it. Every process builds the same numpy problem
from a seed (or reads the same file) and keeps only its own landmark rows.

Worker entry, one process per rank (the port's counterpart of
`scripts/bench_scaling.py --multiprocess`):

    python -m visual_odometry_ros_tpu_torch.parallel.multihost \\
        --world 4 --rank 0 --init file:///tmp/vo_ba_rendezvous --out out/ba_{rank}.npz

Nothing tells a process of its peers: give each the same `--init` (a
`file://` path that does not exist yet, or `tcp://localhost:<port>`), the
world size and its rank. Each rank writes its result to `--out` with
`{rank}` replaced.
"""

from __future__ import annotations

import argparse
import datetime
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ba as BA
from ..utils import geometry as geo
from . import dist_ba
from .mesh import LM_AXIS, landmark_slice


def init_worker(init_method: str, world_size: int, rank: int, backend: str | None = None,
                timeout: float = 60.0) -> torch.device:
    """Join the process group as `rank` of `world_size`; returns this rank's
    device. backend: "nccl" (one card per rank, card rank % cards) or
    "gloo" (CPU); by default NCCL when a card is present. Collectives that
    wait longer than `timeout` seconds raise instead of hanging."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return device


def global_mesh():
    """The process group over every rank of every process, in rank order."""
    return dist.group.WORLD


def host_array(full: np.ndarray, group, spec, device) -> torch.Tensor:
    """This rank's part of a host-replicated numpy array, on `device` (what
    `init_worker` returned): rows `landmark_slice` of the leading axis for
    spec LM_AXIS, the whole array for spec None (replicated)."""
    a = np.asarray(full)
    if spec == LM_AXIS:
        a = a[landmark_slice(a.shape[0], group)]
    elif spec is not None:
        raise ValueError(f"unknown placement {spec!r}")
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def host_tree(tree_np, group, spec_tree, device):
    """`host_array` over a NamedTuple of numpy leaves and its specs."""
    return type(tree_np)(*(host_array(a, group, s, device) for a, s in zip(tree_np, spec_tree)))


# ---------------------------------------------------------------------------
# Seeded problems (host numpy, identical on every rank)
# ---------------------------------------------------------------------------


def _poses(K: int, step) -> np.ndarray:
    """T_cw of K keyframes whose T_wc = exp(step(k)) (se3 tangent [v, w])."""
    xi = torch.as_tensor(np.stack([step(k) for k in range(K)]), dtype=torch.float32)
    return geo.se3_inverse(geo.se3_exp(xi)).numpy()


def build_problem_np(M: int, K: int, seed: int = 0):
    """The seeded stereo BA problem of scripts/bench_scaling.py (build_problem_np):
    K keyframes 0.8 m apart, M landmarks 5-60 m ahead, 0.3 px noise.
    Returns (BAProblem of numpy arrays, FX, FY, CX, CY, T_rl)."""
    rng = np.random.default_rng(seed)
    FX = FY = 718.0
    CX, CY = 607.0, 185.0
    T_cw = _poses(K, lambda k: np.array([0.01 * k, 0.0, -0.8 * k, 0.0, 0.002 * k, 0.0], np.float32))
    Xw = np.stack(
        [rng.uniform(-15, 15, M), rng.uniform(-3, 3, M), rng.uniform(5, 60, M)], -1
    ).astype(np.float32)
    pts = np.zeros((M, K, 2), np.float32)
    mask = np.zeros((M, K), bool)
    for k in range(K):
        Xc = Xw @ T_cw[k, :3, :3].T + T_cw[k, :3, 3]
        z = np.maximum(Xc[:, 2], 1e-3)
        uv = np.stack([Xc[:, 0] / z * FX + CX, Xc[:, 1] / z * FY + CY], -1)
        pts[:, k] = uv + rng.normal(0, 0.3, (M, 2))
        mask[:, k] = (Xc[:, 2] > 1.0) & (np.abs(uv[:, 0] - CX) < 700) & (np.abs(uv[:, 1] - CY) < 250)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.537
    problem = BA.BAProblem(T_cw=T_cw, Xw=Xw, pts=pts, mask=mask, pts_r=pts, mask_r=mask,
                           kf_valid=np.ones(K, bool), lm_valid=np.ones(M, bool))
    return problem, FX, FY, CX, CY, T_rl


def dryrun_problem_np(M: int = 4096, K: int = 9, seed: int = 0):
    """The windowed-BA problem of __graft_entry__.dryrun_multichip: a full
    9-keyframe window over 4096 landmarks 5-20 m ahead, 0.2 px noise,
    stereo rows. Same return layout as `build_problem_np`."""
    rng = np.random.default_rng(seed)
    FX = FY = 300.0
    CX, CY = 80.0, 60.0
    T_cw = _poses(K, lambda k: np.array([0.01 * k, 0.0, -0.3 * k, 0.0, 0.01 * k, 0.0], np.float32))
    Xw = np.stack(
        [rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(5, 20, M)], -1
    ).astype(np.float32)
    pts = np.zeros((M, K, 2), np.float32)
    mask = np.zeros((M, K), bool)
    for k in range(K):
        Xc = Xw @ T_cw[k, :3, :3].T + T_cw[k, :3, 3]
        uv = np.stack([Xc[:, 0] / Xc[:, 2] * FX + CX, Xc[:, 1] / Xc[:, 2] * FY + CY], -1)
        pts[:, k] = uv + rng.normal(0, 0.2, (M, 2))
        mask[:, k] = Xc[:, 2] > 1.0
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.5
    problem = BA.BAProblem(T_cw=T_cw, Xw=Xw, pts=pts, mask=mask, pts_r=pts, mask_r=mask,
                           kf_valid=np.ones(K, bool), lm_valid=np.ones(M, bool))
    return problem, FX, FY, CX, CY, T_rl


def save_problem_npz(path: str, problem, fx, fy, cx, cy, T_rl) -> None:
    """A numpy problem as one file, for `--problem-npz`."""
    np.savez(path, **problem._asdict(), intrinsics=np.float64([fx, fy, cx, cy]), T_rl=T_rl)


def load_problem_npz(path: str):
    """The problem `save_problem_npz` wrote: (BAProblem, fx, fy, cx, cy, T_rl)."""
    with np.load(path) as z:
        problem = BA.BAProblem(*(z[k] for k in BA.BAProblem._fields))
        fx, fy, cx, cy = (float(v) for v in z["intrinsics"])
        return problem, fx, fy, cx, cy, z["T_rl"]


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def assembly_ms(problem, fx, fy, cx, cy, T_rl, reps: int) -> float:
    """Median ms of the shard-local half of one GN iteration on this rank's
    problem (scripts/bench_scaling.py:253-269): observation terms, normal
    blocks and the Schur elimination, no collective; host clock ending in a
    synchronise."""
    dev = problem.T_cw.device

    def once():
        w, r, Q, Rj = BA.build_observation_terms(problem.T_cw, problem.Xw, problem.pts, problem.mask,
                                                 problem.pts_r, problem.mask_r, fx, fy, cx, cy, T_rl, 1.0)
        return BA.schur_reduce(*BA.assemble_normal_blocks(w, r, Q, Rj), 1e-4)

    times = []
    for _ in range(reps + 1):  # the first call warms up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        once()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times[1:]))


def run_worker(args) -> dict:
    dev = init_worker(args.init, args.world, args.rank, args.backend, args.timeout)
    try:
        group = global_mesh()
        if args.problem_npz:
            problem, fx, fy, cx, cy, T_rl = load_problem_npz(args.problem_npz)
        else:
            problem, fx, fy, cx, cy, T_rl = build_problem_np(args.landmarks, args.window, args.seed)
        prob_spec = dist_ba._sharded_specs()[0]
        local = host_tree(problem, group, prob_spec, dev)
        T_rl_t = torch.as_tensor(T_rl, device=dev)
        solve = dist_ba.make_distributed_ba(group, BA.BAParams(iters=args.iters))
        info = {}
        BA.reset_collective_counts()
        res = solve(local, fx, fy, cx, cy, T_rl_t, info)
        all_reduces, reduced_bytes = BA.COLLECTIVES["all_reduce"], BA.COLLECTIVES["bytes"]
        times = []
        for _ in range(args.reps):
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            solve(local, fx, fy, cx, cy, T_rl_t)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t) * 1e3)
        rows = landmark_slice(problem.Xw.shape[0], group)
        rec = {"rank": args.rank, "world": args.world, "backend": dist.get_backend(), "device": str(dev),
               "landmarks": int(problem.Xw.shape[0]), "window": int(problem.T_cw.shape[0]),
               "iters_run": info["iters"], "all_reduces": all_reduces, "all_reduce_bytes": reduced_bytes,
               "mean_err_px": float(res.mean_err_px), "n_obs": int(res.n_obs),
               "ms_per_solve": float(np.median(times)) if times else None,
               "assembly_ms": assembly_ms(local, fx, fy, cx, cy, T_rl_t, args.reps) if args.reps else None}
        if args.out:
            np.savez(args.out.replace("{rank}", str(args.rank)), **{k: v.cpu().numpy() for k, v in res._asdict().items()},
                     iters_run=info["iters"], all_reduces=all_reduces, lm_start=rows.start, lm_stop=rows.stop)
        print(json.dumps(rec), flush=True)
        return rec
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--world", type=int, required=True, help="number of ranks")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--init", required=True, help="rendezvous: file://PATH or tcp://localhost:PORT")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None, help="default: nccl with a card, else gloo")
    p.add_argument("--timeout", type=float, default=60.0, help="seconds a collective may wait")
    p.add_argument("--problem-npz", default=None,
                   help="read the problem from this file instead of building scripts/bench_scaling.py's")
    p.add_argument("--landmarks", type=int, default=4096, help="M")
    p.add_argument("--window", type=int, default=9, help="K keyframes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reps", type=int, default=0,
                   help="timed solves after the first, and timed assembly-only passes")
    p.add_argument("--out", default=None, help="npz of this rank's result; {rank} is replaced")
    return run_worker(p.parse_args(argv))


if __name__ == "__main__":
    main()
