"""Driving the program's entry points, and the plain reference beside them.

`Driver` hands a cell's frames to one of three entry points of a pipeline
object (the program's `StereoVO` / `MonoVO`, or the reference's copies,
which have the same interface) and returns each frame's pose and stats as
the entry gave them. `snapshot` copies a pipeline's state between calls;
`restore` puts such a copy into the reference, which then replays the same
frames (`replay`). `compare` holds two runs of the same frames to each
other.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

ENTRIES = ("stereo_batch", "stereo_frame", "mono_batch")


class Driver:
    """One entry point of `vo` over `frames` ({"left", "right"} uint8)."""

    def __init__(self, entry: str, vo, frames: dict, batch: int, timed: bool = False):
        if entry not in ENTRIES:
            raise ValueError(f"unknown entry {entry!r}; expected one of {ENTRIES}")
        self.entry, self.vo, self.batch, self.timed = entry, vo, batch, timed
        self.left, self.right = frames["left"], frames["right"]
        self.stage_ms: list = []  # per-frame entry with timed=True: each frame's stage_ms

    def frames_per_call(self) -> int:
        return 1 if self.entry == "stereo_frame" else self.batch

    def warmup(self, n: int, bootstrap_max: int = 0) -> list:
        """Frames 0..n-1 through the entry (mono: `track_image` until the
        pipeline bootstraps, within `bootstrap_max` frames, then batches).
        Returns their outputs; n is rounded up to whole calls."""
        vo, out, i = self.vo, [], 0
        if self.entry == "mono_batch":
            while vo.phase != 2:
                if i >= bootstrap_max:
                    raise RuntimeError(f"mono pipeline not bootstrapped after {bootstrap_max} frames")
                T, st = vo.track_image(self.left[i])
                out.append((np.asarray(T, np.float64), st))
                i += 1
        elif self.entry == "stereo_batch":
            out += self.call(0, 1)  # the first call bootstraps from the batch head
            i = 1
        while i < n:
            out += self.call(i)
            i += self.frames_per_call()
        return out

    def call(self, i: int, count: int | None = None) -> list:
        """One call of the entry on frames i..i+count-1 (count: the batch).
        Returns [(T_wc [4, 4] float64, stats)] per frame."""
        vo, n = self.vo, count or self.frames_per_call()
        if self.entry == "stereo_frame":
            T, st = vo.track_stereo_images(self.left[i], self.right[i], timed=self.timed)
            if "stage_ms" in st:
                self.stage_ms.append(st["stage_ms"])
            return [(np.asarray(T, np.float64), st)]
        if self.entry == "stereo_batch":
            stats = vo.track_stereo_batch(self.left[i : i + n], self.right[i : i + n])
        else:
            stats = vo.track_batch(self.left[i : i + n])
        poses = vo.trajectory[-len(stats):]
        return [(np.asarray(T, np.float64), st) for T, st in zip(poses, stats)]


# ---------------------------------------------------------------------------
# State copies
# ---------------------------------------------------------------------------


def _clone(x):
    if dataclasses.is_dataclass(x):
        return tuple(_clone(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_clone(v) for v in x)
    return x.detach().clone()


def snapshot(vo) -> dict:
    """A copy of `vo`'s state (field order, as nested tuples of tensors),
    taken between calls: what the next call starts from."""
    snap = {"state": _clone(vo.state), "frames_seen": len(vo.trajectory)}
    if hasattr(vo, "phase"):
        snap["phase"] = vo.phase
        snap["gen"] = vo._gen.get_state()
    return snap


def _build(cls, tree, map_fields):
    kw = {}
    for f, v in zip(dataclasses.fields(cls), tree):
        sub = map_fields.get(f.name)
        kw[f.name] = _build(sub, v, map_fields) if sub is not None else _tensors(v)
    return cls(**kw)


def _tensors(v):
    if isinstance(v, tuple):
        return tuple(_tensors(a) for a in v)
    return v.clone()


def restore(ref_vo, snap: dict, state_cls, map_fields) -> None:
    """Put a snapshot of the program into the reference pipeline `ref_vo`."""
    ref_vo.state = _build(state_cls, snap["state"], map_fields)
    ref_vo.trajectory = [None] * snap["frames_seen"]
    if "phase" in snap:
        ref_vo.phase = snap["phase"]
        ref_vo._gen.set_state(snap["gen"])


def replay(driver: Driver, i0: int, n: int) -> list:
    """Frames i0..i0+n-1 through `driver`, call by call as the window made them."""
    out, i = [], i0
    while i < i0 + n:
        out += driver.call(i)
        i += driver.frames_per_call()
    return out


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


def _rot_deg(R: np.ndarray) -> float:
    """Rotation angle of R in degrees, accurate for small angles."""
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) * 0.5
    return math.degrees(math.atan2(float(np.linalg.norm(v)), (np.trace(R) - 1.0) * 0.5))


def compare(prog: list, ref: list) -> dict:
    """Gaps between the program's outputs and the reference's for the same
    frames: the widest pose gap (translation m, rotation deg), the widest
    gap in tracked features, the frames whose keyframe decision differs, and
    the widest gap of window BA's error on frames where both ran it."""
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program outputs against {len(ref)} reference outputs")
    t_gap = r_gap = trk_gap = ba_gap = 0.0
    kf_diff = 0
    for (Tp, sp), (Tr, sr) in zip(prog, ref):
        if not (np.isfinite(Tp).all() and np.isfinite(Tr).all()):
            t_gap = r_gap = math.inf
            continue
        t_gap = max(t_gap, float(np.linalg.norm(Tp[:3, 3] - Tr[:3, 3])))
        r_gap = max(r_gap, _rot_deg(Tp[:3, :3].T @ Tr[:3, :3]))
        trk_gap = max(trk_gap, abs(float(sp.get("n_tracked", 0)) - float(sr.get("n_tracked", 0))))
        kp, kr = bool(sp.get("keyframe")), bool(sr.get("keyframe"))
        kf_diff += int(kp != kr)
        if kp and kr and sp.get("ba_err") is not None and sr.get("ba_err") is not None:
            ba_gap = max(ba_gap, abs(float(sp["ba_err"]) - float(sr["ba_err"])))
    return {"pose_t_gap_m": t_gap, "pose_r_gap_deg": r_gap, "tracked_gap": trk_gap,
            "keyframe_diff": float(kf_diff), "ba_err_gap_px": ba_gap}


def merge(gaps: list) -> dict:
    """Each gap over several comparisons: the widest, and for the keyframe
    decisions the sum."""
    out: dict = {}
    for g in gaps:
        for k, v in g.items():
            out[k] = out.get(k, 0.0) + v if k == "keyframe_diff" else max(out.get(k, 0.0), v)
    return out
