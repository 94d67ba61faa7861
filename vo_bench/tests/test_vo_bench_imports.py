"""Nothing on the card's path loads JAX or the JAX package: module names are
compared by their top-level part, whole (the port's name begins with the
JAX package's)."""

import ast
import subprocess
import sys

import pytest

from vo_bench import run

FILES = sorted(p for p in run.ROOT.rglob("*.py") if "tests" not in p.parts)


def _top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(run.ROOT)))
def test_no_jax_import_in_the_harness(path):
    assert not set(_top_levels(path)) & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (run.ROOT / "ref").rglob("*.py"):
        assert "visual_odometry_ros_tpu_torch" not in set(_top_levels(path)), path


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "visual_odometry_ros_tpu_torch_probe", sys)
    assert "visual_odometry_ros_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "visual_odometry_ros_tpu.models", sys)
    assert "visual_odometry_ros_tpu" in run.loaded_forbidden()


def test_a_run_loads_no_jax():
    """Imports everything a run imports, in a fresh interpreter."""
    code = ("import sys; import vo_bench.run, vo_bench.world, vo_bench.pipeline, vo_bench.tracing, "
            "vo_bench.control, vo_bench.ref.models.stereo_vo, vo_bench.ref.models.mono_vo; "
            "import visual_odometry_ros_tpu_torch.models.stereo_vo, visual_odometry_ros_tpu_torch.models.mono_vo, "
            "visual_odometry_ros_tpu_torch.ops.kernels; "
            "print(vo_bench.run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
