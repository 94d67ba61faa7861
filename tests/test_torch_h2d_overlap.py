"""The port's upload-overlap probe (`visual_odometry_ros_tpu_torch.
h2d_overlap_probe`) on CPU: its overlap ratio is the reference's expression
(scripts/h2d_overlap_probe.py:97-98, copied here as it stands), and without a
card it refuses to run (there is no host-to-device link to measure; it has no
CPU mode). The probe itself runs on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from visual_odometry_ros_tpu_torch import h2d_overlap_probe as H2D


def jax_overlap(a, b, c):
    return max(0.0, min(1.0, (a + b - c) / max(min(a, b), 1e-9)))


@pytest.mark.parametrize("abc", [(2.0, 3.0, 5.0), (2.0, 3.0, 3.0), (2.0, 3.0, 3.5), (2.0, 3.0, 6.0),
                                 (3.0, 2.0, 2.5), (1e-3, 4e-3, 4.1e-3), (0.0, 1.0, 1.0)])
def test_overlap_ratio_is_the_reference_expression(abc):
    assert H2D.overlap_ratio(*abc) == jax_overlap(*abc)


def test_main_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs (tests/test_torch_cuda.py)")
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        H2D.main(["--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        H2D.probe(device="cpu")
    assert not (tmp_path / H2D.OUT_NAME).exists()
