"""Does a host-to-device upload of a frame batch hide behind compute on the
card? The port's counterpart of scripts/h2d_overlap_probe.py.

Times (a) the upload of one bench batch's worth of uint8 frame pairs alone,
(b) a compute-only chain alone (`tanh(x @ x) * 0.5` on a 2048 x 2048 float32
tensor on the card, doubled in length until it takes at least 0.7x the
upload; a probe workload, not a kernel of the pipeline), and (c) the upload
issued first and the compute right after, both awaited together:
overlap_ratio = clip((a + b - c) / min(a, b), 0, 1): 1 = the upload hides
behind the compute, 0 = the two run one after the other. Two upload routes:

- `pageable`: as `track_stereo_batch` uploads today
  (`torch.as_tensor(frames).to(device)` from pageable memory,
  models/stereo_vo.py);
- `pinned`: from a pinned host buffer with `non_blocking=True` on a side
  stream, joined to the compute stream by an event before the compute
  stream reads the uploaded frames.

The probe only measures; the serving path does not change. It needs a card:
there is no host-to-device link to measure on the CPU. Writes
H2D_OVERLAP_TORCH.json (in --out, by default the repository root).
`main(argv)` returns the record.

  python -m visual_odometry_ros_tpu_torch.h2d_overlap_probe [--mb 22] [--trials 6]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT_NAME = "H2D_OVERLAP_TORCH.json"
FRAME = (1241, 376)  # the reference's payload shape per image


def overlap_ratio(a: float, b: float, c: float) -> float:
    """clip((a + b - c) / min(a, b), 0, 1) of the upload alone (a), the
    compute alone (b) and both together (c)."""
    return max(0.0, min(1.0, (a + b - c) / max(min(a, b), 1e-9)))


class _Routes:
    """The two upload routes of one payload (left and right uint8 stacks).
    Each is `start()`, which issues the upload, and `read(pending)`, which
    reads the uploaded frames on the compute stream (their float32
    conversion, as track_stereo_batch does)."""

    def __init__(self, host, device):
        self.host, self.device = host, device
        self.pinned = [torch.from_numpy(h).pin_memory() for h in host]
        self.side = torch.cuda.Stream(device)

    def pageable_start(self):
        """As track_stereo_batch: a blocking copy from pageable memory on the
        compute stream."""
        return [torch.as_tensor(h).to(self.device) for h in self.host], None

    def pinned_start(self):
        """A non-blocking copy from pinned memory on the side stream, and the
        event that marks its end."""
        with torch.cuda.stream(self.side):
            up = [p.to(self.device, non_blocking=True) for p in self.pinned]
        done = torch.cuda.Event()
        done.record(self.side)
        return up, done

    def read(self, pending):
        """The compute stream waits for the copy's event (pinned route), then
        reads the frames."""
        up, done = pending
        if done is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(done)
            for u in up:
                u.record_stream(main)  # the allocator keeps it until main has read it
        return up, [u.to(torch.float32) for u in up]


def _wall(fn, device) -> float:
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t
    del out
    return dt


def probe(mb: int = 22, trials: int = 6, device="cuda") -> dict:
    """Both routes' upload, compute and together times (min over trials)."""
    from .eval_accuracy import card_info

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("h2d_overlap_probe needs a CUDA GPU: the CPU has no host-to-device link to measure")
    n = max(1, int(mb * 1e6 / (FRAME[0] * FRAME[1] * 2)))
    host = tuple(np.random.default_rng(s).integers(0, 255, (n, FRAME[0], FRAME[1]), np.uint8) for s in (0, 1))
    payload = sum(h.nbytes for h in host)
    routes = _Routes(host, device)
    x0 = torch.as_tensor(np.random.default_rng(2).normal(size=(2048, 2048)).astype(np.float32), device=device)
    steps = [8]

    def work():
        x = x0
        for _ in range(steps[0]):
            x = torch.tanh(x @ x) * 0.5
        return x

    rec = {"platform": "cuda", **card_info(device), "payload_bytes": payload, "frames": n, "routes": {}}
    for name, start in (("pageable", routes.pageable_start), ("pinned", routes.pinned_start)):

        def upload():
            return routes.read(start())

        def together():
            pending = start()  # the upload is issued first,
            out = work()  # the compute right after it,
            return routes.read(pending), out  # and the frames are read last

        up = min(_wall(upload, device) for _ in range(3))
        cp = min(_wall(work, device) for _ in range(3))
        while cp < 0.7 * up and steps[0] < 4096:
            steps[0] *= 2
            cp = min(_wall(work, device) for _ in range(3))
        ups, cps, boths = [], [], []
        for _ in range(trials):
            ups.append(_wall(upload, device))
            cps.append(_wall(work, device))
            boths.append(_wall(together, device))
        a, b, c = min(ups), min(cps), min(boths)
        rec["routes"][name] = {
            "upload_ms": a * 1e3, "upload_GBps": payload / a / 1e9, "compute_ms": b * 1e3,
            "compute_steps": steps[0], "together_ms": c * 1e3, "overlap_ratio": overlap_ratio(a, b, c),
        }
    # The pinned route's frames are the pageable route's, byte for byte.
    page, pin = routes.read(routes.pageable_start())[0], routes.read(routes.pinned_start())[0]
    if not all(torch.equal(p, q) for p, q in zip(page, pin)):
        raise AssertionError("the pinned route's uploaded frames differ from the pageable route's")
    rec["interpretation"] = (
        "1.0 = the upload hides behind the compute; 0.0 = the two are serialized. upload_ms is the upload "
        "with the float32 conversion that reads it (as track_stereo_batch does), host clock ending in a "
        "synchronise, min over trials")
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mb", type=int, default=22, help="payload MB (24 uint8 1241x376 pairs is ~22 MB)")
    p.add_argument("--trials", type=int, default=6)
    p.add_argument("--out", default=str(ROOT), help=f"directory of {OUT_NAME}")
    args = p.parse_args(argv)
    rec = probe(args.mb, args.trials)
    print(json.dumps(rec, indent=1))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / OUT_NAME).write_text(json.dumps(rec, indent=1) + "\n")
    return rec


if __name__ == "__main__":
    main()
