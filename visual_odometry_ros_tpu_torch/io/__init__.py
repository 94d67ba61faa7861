"""Data, configuration and evaluation helpers of the port.

`config.py`, `io/synthetic.py`, `io/trajectory.py`, `io/visualize.py`,
`io/datasets.py` and `io/statistics.py` are the port's own copies of the JAX
package's numpy-only modules; the two trajectory generators of
`synthetic.py` are built on the port's `se3_exp`. Nothing here imports or
loads a file of the JAX package.
"""

from __future__ import annotations

from ..config import VOConfig
from .synthetic import CorridorSequence, DistortedStereoSequence, PlaneSequence, forward_trajectory
from .trajectory import ate_rmse, rpe
from .visualize import draw_tracking

__all__ = [
    "VOConfig",
    "CorridorSequence",
    "PlaneSequence",
    "DistortedStereoSequence",
    "draw_tracking",
    "ate_rmse",
    "rpe",
    "forward_trajectory",
]
