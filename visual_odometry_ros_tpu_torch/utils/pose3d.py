"""Quaternion-backed Rotation3/Pose3d value classes (operator-overloaded).

Counterpart of `visual_odometry_ros_tpu/utils/pose3d.py`: immutable SO(3) /
SE(3) values over the batched functions of `utils/geometry.py`, with `*`
composing (and mapping points) and the quaternion renormalised on every
multiply, so long chains of small rotations keep det(R) = 1.

Values are float32 tensors on `device`, which defaults to the device of the
inputs (the CPU for numpy or Python inputs). These are value classes, not
entry points.
"""

from __future__ import annotations

import torch

from . import geometry as geo


def _tensor(x, device) -> torch.Tensor:
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Rotation3:
    """SO(3) value backed by a unit quaternion [w, x, y, z]."""

    __slots__ = ("q",)

    def __init__(self, q=None, device=None):
        if q is None:
            self.q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=device)
        else:
            self.q = geo.quat_normalize(_tensor(q, device))

    @classmethod
    def from_matrix(cls, R, device=None):
        return cls(geo.rotation_to_quat(_tensor(R, device)))

    @classmethod
    def from_rotvec(cls, w, device=None):
        return cls(geo.rotvec_to_quat(_tensor(w, device)))

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def R(self) -> torch.Tensor:
        return geo.quat_to_rotation(self.q)

    def inverse(self) -> "Rotation3":
        return Rotation3(geo.quat_conjugate(self.q))

    def __mul__(self, other):
        if isinstance(other, Rotation3):
            return Rotation3(geo.quat_multiply(self.q, other.q))
        v = _tensor(other, self.device)
        return (self.R @ v[..., None])[..., 0]

    def __repr__(self):
        return f"Rotation3(q={self.q})"


class Pose3d:
    """SE(3) value: Rotation3 + translation; `*` composes, also maps points."""

    __slots__ = ("rot", "t")

    def __init__(self, rot: Rotation3 | None = None, t=None, device=None):
        if device is None:
            device = rot.device if rot is not None else (t.device if isinstance(t, torch.Tensor) else None)
        self.rot = rot if rot is not None else Rotation3(device=device)
        self.t = torch.zeros(3, dtype=torch.float32, device=device) if t is None else _tensor(t, device)

    @classmethod
    def from_matrix(cls, T, device=None):
        T = _tensor(T, device)
        return cls(Rotation3.from_matrix(T[:3, :3]), T[:3, 3])

    @classmethod
    def from_se3(cls, xi, device=None):
        return cls.from_matrix(geo.se3_exp(_tensor(xi, device)))

    @property
    def T(self) -> torch.Tensor:
        return geo.rt_to_se3(self.rot.R, self.t)

    def inverse(self) -> "Pose3d":
        rinv = self.rot.inverse()
        return Pose3d(rinv, -(rinv * self.t))

    def __mul__(self, other):
        if isinstance(other, Pose3d):
            return Pose3d(self.rot * other.rot, self.rot * other.t + self.t)
        return self.rot * other + self.t

    def __repr__(self):
        return f"Pose3d(q={self.rot.q}, t={self.t})"
