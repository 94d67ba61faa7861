"""Process-group helpers for distributed VO.

Counterpart of `visual_odometry_ros_tpu/parallel/mesh.py`. Where the
reference builds a one-axis `jax.sharding.Mesh` ('lm') over devices, the
port has one process per device in a `torch.distributed` process group: the
landmark axis is cut into contiguous, equal slices in rank order, and
keyframe poses are replicated on every rank (they are tiny and every shard
needs them for Hessian assembly).
"""

from __future__ import annotations

import torch.distributed as dist

LM_AXIS = "lm"


def make_mesh(n_devices: int | None = None):
    """The process group over the first `n_devices` ranks (all of them by
    default). Every rank of the world must call it, as `new_group` asks."""
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return dist.group.WORLD
    if not 0 < n_devices <= world:
        raise ValueError(f"need {n_devices} ranks, the world has {world}")
    return dist.new_group(list(range(n_devices)))


def landmark_slice(n: int, group=None) -> slice:
    """This rank's contiguous slice of a landmark axis of length n, which
    must be divisible by the group's size (pad the arena; masked lanes are
    free)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % size:
        raise ValueError(f"landmark axis {n} is not divisible by the group size {size}")
    m = n // size
    return slice(rank * m, (rank + 1) * m)


def pad_to_multiple(n: int, devices: int) -> int:
    return ((n + devices - 1) // devices) * devices
