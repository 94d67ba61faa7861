"""Map/state checkpointing: save and resume a VO session.

Counterpart of `visual_odometry_ros_tpu/io/checkpoint.py`, with its file
format: `<path>.state.npz` holds every state leaf under its tree path
(`T_wc`, `tracks/pts`, `pyr_prev/0/1`, ...; the reference's pytree paths)
and `<path>.meta.json` the host-side trajectories. A checkpoint written by
either package resumes in the other.

Pyramids: the KLT kernel leg of either package stores its pyramids without
gradients (gx = gy = img), the plain legs with them. `save_vo` therefore
writes the gradients out in full, and `load_vo` rebuilds each pyramid
(`pyr_prev`, and the mono pipeline's `pyr_first`) for the loading pipeline's own
leg from the stored level-0 image, so a checkpoint from any leg resumes in
any other. The meta file carries the mono pipeline's `phase` (null for stereo).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..ops.pyramid import build_pyramid_with_gradients


def _leaves(tree, prefix: str = ""):
    """(path, tensor) pairs in the reference's pytree leaf order."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{prefix}{f.name}/")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: _rebuild(getattr(tree, f.name), leaves) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, tuple):
        return tuple(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def save_state(path: str, state) -> None:
    """Save a state (e.g. StereoVOState) to an npz file."""
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() for k, v in _leaves(state)})


def load_state(path: str, template):
    """Load into the structure of `template` (same type and shapes); each
    leaf takes the template's dtype and device."""
    new = []
    with np.load(path) as data:
        for key, tmpl in _leaves(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf '{key}'")
            arr = data[key]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(f"leaf '{key}' shape {arr.shape} != template {tuple(tmpl.shape)}")
            new.append(torch.from_numpy(np.array(arr)).to(device=tmpl.device, dtype=tmpl.dtype))
    return _rebuild(template, iter(new))


def _pyramid_fields(state) -> list:
    return [f.name for f in dataclasses.fields(state) if f.name.startswith("pyr_")]


def save_vo(path: str, vo) -> None:
    """Checkpoint a StereoVO or MonoVO (device state + host trajectories)."""
    st = vo.state
    pyrs = {name: build_pyramid_with_gradients(getattr(st, name)[0][0], len(getattr(st, name)),
                                               with_gradients=True) for name in _pyramid_fields(st)}
    save_state(path + ".state.npz", st.replace(**pyrs))
    meta = {
        "phase": getattr(vo, "phase", None),
        "trajectory": [np.asarray(T).tolist() for T in vo.trajectory],
        "kf_trajectory": [[i, np.asarray(T).tolist()] for i, T in vo.kf_trajectory],
    }
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_vo(path: str, vo) -> None:
    """Resume a StereoVO or MonoVO in place. `vo` must be freshly constructed
    with the same config, and must not have processed a frame."""
    if vo.state is None:
        h, w = vo.cfg.cam.height, vo.cfg.cam.width
        vo.state = vo.init_state(vo._build_pyr(torch.zeros((h, w), dtype=torch.float32, device=vo.device)))
    st = load_state(path + ".state.npz", vo.state)
    vo.state = st.replace(**{name: vo._build_pyr(getattr(st, name)[0][0]) for name in _pyramid_fields(st)})
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("phase") is not None and hasattr(vo, "phase"):
        vo.phase = meta["phase"]
    vo.trajectory = [np.asarray(T, np.float32) for T in meta["trajectory"]]
    vo.kf_trajectory = [(int(i), np.asarray(T, np.float32)) for i, T in meta["kf_trajectory"]]
