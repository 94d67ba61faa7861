"""The plain reference of the benchmark: a frozen copy of the port's
stereo and mono pipelines on their plain PyTorch versions, cut to the paths
that the benchmark's three entry points run.

Every module here follows the module of the same path in
`visual_odometry_ros_tpu_torch` as it stood when the benchmark was defined,
with the hand-written kernels, their launch wrappers and every path the
benchmark never runs taken out: the KLT runs the kernels' plain semantics
(`ops/klt.py`), the pose solves and window BA theirs (`ops/pose_gn.py`,
`ops/ba.py`), on whatever device the tensors lie on; no YAML loader, no
rectification, no process group, no timed step. It launches no kernel and
imports nothing of the program, so a later change to the program leaves the
yardstick as it is. Comments that speak of "the reference" mean the JAX
system that the port was written from.
"""
