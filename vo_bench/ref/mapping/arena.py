"""Fixed-capacity map state: landmark arena, track state, keyframe ring.

Copy of the port's `mapping/arena.py`. State containers
are dataclasses of tensors with the same fields, in the same order, as the
reference NamedTuples (so numpy state converts field by field). Updates are
functional: each returns new tensors and leaves its inputs untouched.

The reference scatters through one-hot contractions (a TPU scatter-emitter
workaround). Here every scatter is an indexed write of the masked lanes
only: masked-out lanes are redirected to one scratch row past the end,
which is dropped. Indices need only be unique among the masked lanes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class LandmarkArena(_Replace):
    """Global landmark store; capacity M is fixed."""

    Xw: torch.Tensor  # [M, 3] world position
    alive: torch.Tensor  # [M] bool
    tracked: torch.Tensor  # [M] bool — tracked into the current frame
    triangulated: torch.Tensor  # [M] bool — Xw is valid
    bundled: torch.Tensor  # [M] bool — touched by BA at least once
    age: torch.Tensor  # [M] int32 — #frames observed
    last_pt: torch.Tensor  # [M, 2] most recent pixel observation
    inv_depth: torch.Tensor  # [M] depth-filter mean
    inv_depth_var: torch.Tensor  # [M] depth-filter variance
    df_a: torch.Tensor  # [M] Beta inlier count
    df_b: torch.Tensor  # [M] Beta outlier count
    ray_o: torch.Tensor  # [M, 3]
    ray_d: torch.Tensor  # [M, 3]
    parallax_last: torch.Tensor  # [M] rad
    parallax_max: torch.Tensor  # [M] rad
    parallax_min: torch.Tensor  # [M] rad (PARALLAX_MIN_INIT until first sample)
    parallax_sum: torch.Tensor  # [M] rad
    parallax_n: torch.Tensor  # [M] int32
    desc: torch.Tensor  # [M, 32] int32 descriptor bytes
    desc_valid: torch.Tensor  # [M] bool

    @property
    def capacity(self) -> int:
        return self.Xw.shape[0]


PARALLAX_MIN_INIT = 1e9


def make_arena(capacity: int, device="cpu") -> LandmarkArena:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LandmarkArena(
        Xw=z(capacity, 3),
        alive=z(capacity, dtype=torch.bool),
        tracked=z(capacity, dtype=torch.bool),
        triangulated=z(capacity, dtype=torch.bool),
        bundled=z(capacity, dtype=torch.bool),
        age=z(capacity, dtype=torch.int32),
        last_pt=z(capacity, 2),
        inv_depth=z(capacity),
        inv_depth_var=z(capacity),
        df_a=z(capacity),
        df_b=z(capacity),
        ray_o=z(capacity, 3),
        ray_d=z(capacity, 3),
        parallax_last=z(capacity),
        parallax_max=z(capacity),
        parallax_min=torch.full((capacity,), PARALLAX_MIN_INIT, dtype=torch.float32, device=device),
        parallax_sum=z(capacity),
        parallax_n=z(capacity, dtype=torch.int32),
        desc=z(capacity, 32, dtype=torch.int32),
        desc_valid=z(capacity, dtype=torch.bool),
    )


@dataclass
class TrackState(_Replace):
    """Per-frame active tracks; capacity N is fixed."""

    pts: torch.Tensor  # [N, 2] pixel position in the current frame
    lm_idx: torch.Tensor  # [N] int32 arena slot (undefined where ~valid)
    valid: torch.Tensor  # [N] bool
    scale: torch.Tensor  # [N] patch-scale prior (depth ratio)

    @property
    def capacity(self) -> int:
        return self.pts.shape[0]


def make_tracks(capacity: int, device="cpu") -> TrackState:
    return TrackState(
        pts=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        lm_idx=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        scale=torch.ones((capacity,), dtype=torch.float32, device=device),
    )


@dataclass
class KeyframeRing(_Replace):
    """Sliding keyframe window; capacity K fixed. Slot `head` is newest."""

    T_cw: torch.Tensor  # [K, 4, 4]
    valid: torch.Tensor  # [K] bool
    frame_id: torch.Tensor  # [K] int32
    pts: torch.Tensor  # [K, N, 2]
    pts_r: torch.Tensor  # [K, N, 2]
    lm_idx: torch.Tensor  # [K, N] int32
    obs_valid: torch.Tensor  # [K, N]
    obs_valid_r: torch.Tensor  # [K, N]
    head: torch.Tensor  # [] int32 — newest slot
    count: torch.Tensor  # [] int32 — live keyframes

    @property
    def capacity(self) -> int:
        return self.T_cw.shape[0]


def make_ring(K: int, N: int, device="cpu") -> KeyframeRing:
    return KeyframeRing(
        T_cw=torch.eye(4, dtype=torch.float32, device=device).repeat(K, 1, 1),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
        frame_id=torch.full((K,), -1, dtype=torch.int32, device=device),
        pts=torch.zeros((K, N, 2), dtype=torch.float32, device=device),
        pts_r=torch.zeros((K, N, 2), dtype=torch.float32, device=device),
        lm_idx=torch.full((K, N), -1, dtype=torch.int32, device=device),
        obs_valid=torch.zeros((K, N), dtype=torch.bool, device=device),
        obs_valid_r=torch.zeros((K, N), dtype=torch.bool, device=device),
        head=torch.tensor(-1, dtype=torch.int32, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def _targets(idx: torch.Tensor, mask: torch.Tensor, M: int) -> torch.Tensor:
    """Row per lane: its index where masked and in range, else the scratch row M."""
    idx = idx.to(torch.int64)
    return torch.where(mask & (idx >= 0) & (idx < M), idx, M)


def indexed_update(dest: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, vals=None,
                   op: str = "set") -> torch.Tensor:
    """Masked scatter: dest [M] or [M, D]; idx, mask [n]; op "set", "or" or "add".

    Counterpart of `onehot_update`; indices must be unique among masked
    lanes ("add" accumulates duplicates, as the contraction does)."""
    M = dest.shape[0]
    tgt = _targets(idx, mask, M)
    if op == "or":
        hit = torch.zeros(M + 1, dtype=torch.bool, device=dest.device)
        hit[tgt] = True
        return dest | hit[:M]
    ext = torch.cat([dest, dest.new_zeros((1,) + tuple(dest.shape[1:]))])
    vals = vals.to(dest.dtype)
    if op == "add":
        return ext.index_add(0, tgt, vals)[:M]
    if op == "set":
        return ext.index_put((tgt,), vals)[:M]
    raise ValueError(f"unknown op {op!r}")


def parallax_observe(arena: LandmarkArena, lm_idx, mask, par) -> LandmarkArena:
    """Record one parallax sample per masked lane (last/max/min/avg)."""
    new_last = indexed_update(arena.parallax_last, lm_idx, mask, par)
    hit = indexed_update(torch.zeros_like(arena.alive), lm_idx, mask, op="or")
    return arena.replace(
        parallax_last=new_last,
        parallax_max=torch.where(hit, torch.maximum(arena.parallax_max, new_last), arena.parallax_max),
        parallax_min=torch.where(hit, torch.minimum(arena.parallax_min, new_last), arena.parallax_min),
        parallax_sum=torch.where(hit, arena.parallax_sum + new_last, arena.parallax_sum),
        parallax_n=arena.parallax_n + hit.to(torch.int32),
    )


def landmark_stat_means(arena: LandmarkArena):
    """(avg parallax, avg age) over alive & tracked landmarks."""
    sel = arena.alive & arena.tracked
    n = torch.clamp(torch.sum(sel), min=1)
    avg_age = torch.sum(torch.where(sel, arena.age, 0)) / n
    per_lm = arena.parallax_sum / torch.clamp(arena.parallax_n, min=1)
    avg_par = torch.sum(torch.where(sel, per_lm, 0.0)) / n
    return avg_par.to(torch.float32), avg_age.to(torch.float32)


def allocate_slots(free: torch.Tensor, n_request: int):
    """The first `n_request` free slots: slot j = index of the (j+1)-th free
    lane (0 where fewer exist). Returns (slots [n_request] int32, ok)."""
    M = free.shape[0]
    rank = torch.cumsum(free.to(torch.int64), dim=0) - 1
    tgt = torch.where(free & (rank < n_request), rank, n_request)
    slots = torch.zeros(n_request + 1, dtype=torch.int64, device=free.device)
    slots = slots.index_put((tgt,), torch.arange(M, device=free.device))[:n_request]
    ok = torch.arange(n_request, device=free.device) < torch.sum(free)
    return slots.to(torch.int32), ok


def ring_push(ring: KeyframeRing, T_cw, frame_id, pts, pts_r, lm_idx, obs_valid, obs_valid_r):
    """Insert a keyframe at the next ring slot (evicting the oldest when full)."""
    K = ring.capacity
    slot = ((ring.head + 1) % K).to(torch.int64).reshape(1)

    def put(arr, v):
        v = torch.as_tensor(v, dtype=arr.dtype, device=arr.device)
        return arr.index_put((slot,), v.reshape((1,) + tuple(arr.shape[1:])))

    return ring.replace(
        T_cw=put(ring.T_cw, T_cw),
        valid=put(ring.valid, True),
        frame_id=put(ring.frame_id, frame_id),
        pts=put(ring.pts, pts),
        pts_r=put(ring.pts_r, pts_r),
        lm_idx=put(ring.lm_idx, lm_idx),
        obs_valid=put(ring.obs_valid, obs_valid),
        obs_valid_r=put(ring.obs_valid_r, obs_valid_r),
        head=slot[0].to(torch.int32),
        count=torch.clamp(ring.count + 1, max=K),
    )


def ring_order(ring: KeyframeRing) -> torch.Tensor:
    """[K] slot indices oldest -> newest among live slots (dead slots last)."""
    K = ring.capacity
    offs = torch.arange(K, dtype=torch.int64, device=ring.head.device)
    return (ring.head.to(torch.int64) - (ring.count.to(torch.int64) - 1) + offs) % K


def gather_ba_problem(ring: KeyframeRing, arena: LandmarkArena):
    """The ring's per-keyframe observation tables as the dense [M, K]
    incidence BA consumes, keyframes ordered oldest -> newest."""
    K = ring.capacity
    M = arena.capacity
    N = ring.lm_idx.shape[1]
    dev = ring.T_cw.device
    order = ring_order(ring)
    kf_valid = ring.valid[order]
    lm = ring.lm_idx[order]  # [K, N]
    ov = ring.obs_valid[order] & kf_valid[:, None]
    ovr = ring.obs_valid_r[order] & kf_valid[:, None]
    kk = torch.arange(K, device=dev)[:, None].expand(K, N)

    def scatter(mask, vals):
        tgt = _targets(lm, mask, M)
        pts = torch.zeros((M + 1, K, 2), dtype=torch.float32, device=dev)
        pts = pts.index_put((tgt, kk), vals)
        hit = torch.zeros((M + 1, K), dtype=torch.bool, device=dev)
        hit[tgt, kk] = True
        return pts[:M], hit[:M]

    pts_mk, mask_mk = scatter(ov, ring.pts[order])
    pts_r_mk, mask_r_mk = scatter(ovr, ring.pts_r[order])
    return dict(
        T_cw=ring.T_cw[order],
        pts=pts_mk,
        mask=mask_mk,
        pts_r=pts_r_mk,
        mask_r=mask_r_mk,
        kf_valid=kf_valid,
        lm_valid=arena.alive & arena.triangulated,
    )
