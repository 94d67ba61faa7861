"""Distributed sliding-window BA: landmark-sharded Schur complement.

Counterpart of `visual_odometry_ros_tpu/parallel/dist_ba.py`, over a
`torch.distributed` process group with one rank per device:
  - landmark blocks (Xw, observation incidence, C/Cinv/B blocks, back-
    substitution) are cut along the landmark axis and never move;
  - keyframe poses and the reduced camera system (6K x 6K, a few KB) are
    replicated; each GN iteration makes one all-reduce, of (S, s) and the
    dy divergence count packed into one float32 buffer, a small
    latency-bound payload, and a solve of n iterations makes n + 2 (the
    error sums before and after; `ops/ba.COLLECTIVES` counts them);
  - the replicated dense solve is deterministic, so every rank steps the
    poses identically with no further synchronization.

Agreement with the single-device solver is up to float32 reduction order.
"""

from __future__ import annotations

from ..ops import ba as BA
from .mesh import LM_AXIS


def _sharded_specs():
    """(problem, scalars, result) placement: LM_AXIS for rows cut along the
    landmark axis, None for values replicated on every rank."""
    prob_spec = BA.BAProblem(
        T_cw=None, Xw=LM_AXIS, pts=LM_AXIS, mask=LM_AXIS, pts_r=LM_AXIS, mask_r=LM_AXIS,
        kf_valid=None, lm_valid=LM_AXIS,
    )
    out_spec = BA.BAResult(
        T_cw=None, Xw=LM_AXIS, killed=LM_AXIS, mean_err_px=None, n_obs=None, mean_err0_px=None,
    )
    return prob_spec, (None,) * 5, out_spec


def make_distributed_ba(group, params: BA.BAParams = BA.BAParams()):
    """A landmark-sharded BA solve over the ranks of `group`.

    Returns fn(problem, fx, fy, cx, cy, T_rl, info=None) -> BAResult, which
    every rank of the group calls with its own shard of the problem (see
    `_sharded_specs`; `multihost.host_tree` cuts one). The global landmark
    capacity M must be divisible by the group size. Results: Xw and killed
    are this rank's rows, the rest is the same on every rank."""

    def fn(problem, fx, fy, cx, cy, T_rl, info=None):
        return BA.ba_solve_impl(problem, fx, fy, cx, cy, T_rl, params, group=group, info=info)

    return fn
