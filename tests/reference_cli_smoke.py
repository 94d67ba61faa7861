"""The JAX package's CPU reference for chip_smoke.py's CLI phase: the
full-width and crop stereo runs and the mono CLI run.

Runs scripts/run_vo.py (the JAX CLI) on the CPU with chip_smoke's inputs
and prints the constants its bounds are built on:
  - stereo, full width: the N_MAIN corridor frames (the port's renderer,
    the same pixels) written by chip_smoke's `kitti_layouts` at 1241x376,
    run with config/stereo/kitti_00_stereo.yaml (N = 1024) ->
    CLI_REF_FULL_ATE_M (se3 ATE), CLI_REF_FULL_KEYFRAMES;
  - stereo, crop: the same frames cut to the central CLI_CROP_W columns, run
    with that configuration at that width (cx shifted, 512 tracks in 12x12
    bins) -> CLI_REF_ATE_M, CLI_REF_KEYFRAMES;
  - mono: --dataset synthetic --mode mono --frames CLI_MONO_FRAMES ->
    CLI_MONO_REF_ATE_M (ate_rmse_post_init).
Run from the repository root (about 8 minutes, the full-width run ~2.5 of
them):

    JAX_PLATFORMS=cpu python tests/reference_cli_smoke.py
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke as CS  # noqa: E402
from scripts import run_vo  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    frames = CS.make_frames({"main": CS.N_MAIN})
    with tempfile.TemporaryDirectory() as tmp:
        layouts = CS.kitti_layouts(tmp, frames)
        print(f"wrote the layouts in {time.perf_counter() - t0:.1f} s", flush=True)
        stereo = {}
        for tag, (root, cfg) in layouts.items():
            stereo[tag] = run_vo.main(["--dataset", "kitti", "--root", root, "--config", cfg, "--mode", "stereo",
                                       "--out", os.path.join(tmp, tag), "--platform", "cpu", "--quiet"])
        mono = run_vo.main(["--dataset", "synthetic", "--mode", "mono", "--frames", str(CS.CLI_MONO_FRAMES),
                            "--out", os.path.join(tmp, "mono"), "--platform", "cpu", "--quiet"])
    print(json.dumps({
        "reference": "scripts/run_vo.py on CPU (JAX)",
        "CLI_REF_FULL_ATE_M": stereo["full"]["ate_rmse"], "CLI_REF_FULL_KEYFRAMES": stereo["full"]["keyframes"],
        "CLI_REF_ATE_M": stereo["crop"]["ate_rmse"], "CLI_REF_KEYFRAMES": stereo["crop"]["keyframes"],
        "stereo_frames": [stereo["full"]["frames"], stereo["crop"]["frames"]],
        "CLI_MONO_REF_ATE_M": mono["ate_rmse_post_init"], "mono_frames": mono["frames"],
        "mono_keyframes": mono["keyframes"], "wall_s": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
