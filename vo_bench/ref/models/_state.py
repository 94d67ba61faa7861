"""Helpers shared by the stereo and mono drivers: indexing by a device
scalar, rotation angles, and the map structures of a driver state."""

from __future__ import annotations

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
