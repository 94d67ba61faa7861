"""The port's native ingest runtime (its own runtime/ingest.cpp, built with
g++ under build/ingest/) against the JAX package's, on grey and RGB PNG and
on PGM: grey decodes exactly (and equal to the pixels written), RGB to the
same BT.601 luma; the decode-ahead sequence yields the same frames in order.
"""

import os
import shutil

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from visual_odometry_ros_tpu.runtime import ingest as J  # noqa: E402
from visual_odometry_ros_tpu_torch.runtime import ingest as T  # noqa: E402

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.exists("/usr/include/zlib.h"),
    reason="needs g++ and zlib's header to build the native ingest library",
)


@pytest.fixture
def imgs(tmp_path, rng):
    from PIL import Image

    g = rng.integers(0, 255, (37, 53)).astype(np.uint8)
    Image.fromarray(g).save(tmp_path / "g.png")
    c = rng.integers(0, 255, (24, 31, 3)).astype(np.uint8)
    Image.fromarray(c).save(tmp_path / "c.png")
    Image.fromarray(np.dstack([c, g[:24, :31]])).save(tmp_path / "ca.png")
    with open(tmp_path / "p.pgm", "wb") as f:
        f.write(b"P5\n# comment\n53 37\n255\n")
        f.write(g.tobytes())
    return tmp_path, g, c


def test_library_is_the_ports_own_build():
    so = T.build()
    assert so.parent == T.BUILD_DIR and so.name.startswith("libvo_ingest_") and so.exists()
    assert "visual_odometry_ros_tpu/" not in str(so) and T.native_available()


@pytest.mark.parametrize("name", ["g.png", "p.pgm"])
def test_decode_grey_exact(imgs, name):
    d, g, _ = imgs
    a = T.decode_image(str(d / name))
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, g.astype(np.float32))
    np.testing.assert_array_equal(a, J.decode_image(str(d / name)))


@pytest.mark.parametrize("name", ["c.png", "ca.png"])
def test_decode_rgb_luma_matches_jax(imgs, name):
    d, _, c = imgs
    a = T.decode_image(str(d / name))
    # The same C++ luma expression on both sides; the JAX package's library
    # is built with -march=native, which may contract it into FMAs: one
    # float32 ulp of values below 256.
    np.testing.assert_allclose(a, J.decode_image(str(d / name)), rtol=0, atol=1e-4)
    luma = 0.299 * c[:, :, 0] + 0.587 * c[:, :, 1] + 0.114 * c[:, :, 2]
    assert a.shape == c.shape[:2] and np.abs(a - luma).max() < 1.0


@pytest.mark.parametrize("stereo", [True, False])
def test_sequence_matches_jax(imgs, stereo):
    d, g, _ = imgs
    left = [str(d / "g.png"), str(d / "p.pgm")] * 3
    right = list(reversed(left)) if stereo else None
    out = []
    for mod in (T, J):
        seq = mod.NativeSequence(left, right, queue_depth=2)
        out.append(list(seq))
        seq.close()
    assert [i for i, _, _ in out[0]] == [i for i, _, _ in out[1]] == list(range(6))
    for (_, lt, rt), (_, lj, rj) in zip(*out):
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(lt, g.astype(np.float32))
        if stereo:
            np.testing.assert_array_equal(rt, rj)
        else:
            assert rt is None and rj is None


def test_errors(tmp_path, imgs):
    d, _, _ = imgs
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"definitely not an image")
    with pytest.raises(ValueError):
        T.decode_image(str(bad))
    with pytest.raises(ValueError):
        T.decode_image(str(d / "g.png"), max_h=8)  # larger than the buffer
    seq = T.NativeSequence([str(d / "g.png"), str(bad)])
    it = iter(seq)
    assert next(it)[0] == 0
    with pytest.raises(ValueError):
        next(it)
    seq.close()
    with pytest.raises(ValueError):
        T.NativeSequence([str(d / "g.png")], [str(d / "g.png")] * 2)
