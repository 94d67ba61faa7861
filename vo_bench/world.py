"""A cell's frames: the trajectory and corridor from the traffic file and the
seed, rendered on the device in batches and kept as uint8 in pinned host
memory, where a camera driver leaves its frames.

Every seed gets the same textures, drawn from the traffic file's
`texture_seed`, each rolled by an offset drawn from the run's seed: the same
texels in another order. The host work a frame costs depends on the texture
that the tracker sees (on an NVIDIA H100, a stereo run at 0.8 m/frame read
25.0 frames/s on two seeds' textures and 29.6-30.5 on a third's), so a
texture set drawn anew for each seed made the rate a property of the seed."""

from __future__ import annotations

import numpy as np
import torch

from . import render as R


def make_frames(cam: dict, baseline: float | None, traffic: dict, seed: int, device) -> dict:
    """Render traffic["frames"] frames for camera `cam` (fx, fy, cx, cy,
    width, height); a stereo pair per frame where `baseline` is given.
    Returns {"left": [n, H, W] uint8, "right": ... or None, "T_wc": [n, 4, 4]}."""
    device = torch.device(device)
    n = int(traffic["frames"])
    rng = np.random.default_rng(seed)
    T_wc = R.trajectory(n, traffic["speed_m_per_frame"], traffic["yaw_rate_rad_per_frame"],
                        int(traffic["yaw_period_frames"]), traffic["speed_jitter"],
                        int(traffic["jitter_period_frames"]), rng)
    world = traffic["world"]
    geom = R.corridor_geometry(T_wc, **world["margins_m"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(world.get("texture_seed", seed)))
    textures = rolled(R.seeded_textures(geom, world, gen, device), np.random.default_rng([seed, 2]))
    planes = R.build_planes(geom, textures, world, device)
    W, H = int(cam["width"]), int(cam["height"])
    rnd = R.CorridorRenderer(planes, cam["fx"], cam["fy"], cam["cx"], cam["cy"], W, H, device,
                             cull_m=world["cull_m"])
    views = [R.se3_inv(T_wc)]
    if baseline is not None:
        T_lr = np.eye(4)
        T_lr[0, 3] = baseline
        views.append(R.se3_inv(T_wc @ T_lr))
    pin = device.type == "cuda"
    out = [torch.empty((n, H, W), dtype=torch.uint8, pin_memory=pin) for _ in views]
    step = int(world["render_batch"])
    cam_z = torch.as_tensor(T_wc[:, 2, 3])
    for i in range(0, n, step):
        j = min(n, i + step)
        for buf, T_cw in zip(out, views):
            img = rnd.render(torch.as_tensor(T_cw[i:j], device=device), cam_z[i:j])
            # Camera-native bytes: clipped and truncated, as the numpy harness casts them.
            buf[i:j].copy_(torch.clamp(img, 0.0, 255.0).to(torch.uint8), non_blocking=pin)
    if pin:
        torch.cuda.synchronize(device)
    return {"left": out[0], "right": out[1] if len(out) > 1 else None, "T_wc": T_wc}


def rolled(textures: dict, rng: np.random.Generator) -> dict:
    """Each texture rolled along both axes by an offset from `rng` (the
    panels together): the renderer wraps textures, so a roll moves the
    texture's origin on its plane."""
    out = {}
    for k in sorted(textures):
        t = textures[k]
        n = t.shape[-1]
        out[k] = torch.roll(t, (int(rng.integers(n)), int(rng.integers(n))), dims=(-2, -1))
    return out
