"""Helpers shared by the stereo and mono drivers: indexing by a device
scalar, rotation angles, and the exchange of a driver state with the JAX
package as nested tuples of numpy arrays (the reference's pytree leaf
order)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mapping import arena as A

# A driver state's map structures, by field name; every other field is a
# tensor or a nested tuple of tensors (a pyramid).
_MAP_FIELDS = {"tracks": A.TrackState, "arena": A.LandmarkArena, "ring": A.KeyframeRing}


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a host round trip."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def rot_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of R [3, 3] in degrees."""
    cos = torch.clamp((torch.diagonal(R).sum() - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def tree_to_numpy(x):
    """A state (dataclasses, tuples, tensors) as nested tuples of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return tuple(tree_to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(tree_to_numpy(v) for v in x)
    return x.detach().cpu().numpy()


def _tensors(v, device):
    if isinstance(v, (tuple, list)):
        return tuple(_tensors(a, device) for a in v)
    return torch.as_tensor(np.asarray(v)).to(device)


def tree_from_numpy(cls, tree, device: torch.device):
    """Build a `cls` state from nested tuples in its field order."""
    vals = list(tree)
    fields = dataclasses.fields(cls)
    if len(vals) != len(fields):
        raise ValueError(f"{cls.__name__}: expected {len(fields)} fields, got {len(vals)}")
    kw = {}
    for f, v in zip(fields, vals):
        sub = _MAP_FIELDS.get(f.name)
        kw[f.name] = tree_from_numpy(sub, v, device) if sub is not None else _tensors(v, device)
    return cls(**kw)
