"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 -m vo_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(`vo_bench/configs/<config>.json`) and a traffic mix
(`vo_bench/traffic/<traffic>.json`); its comparison limits are in
`vo_bench/checks/<workload>.json` and each per-layer metric has a reader in
`vo_bench/metrics/<metric>.py`, all found by name. A run:

1. renders the cell's frames on the card from the seed (`world.py`) and
   builds the program's pipeline (`visual_odometry_ros_tpu_torch`);
2. warms up through the cell's entry point (`pipeline.Driver.warmup`);
   everything up to here is `setup_s`;
3. hands frames to the entry point, call after call, for `--seconds`
   (traced: at most TRACED_S; one closed loop: each call waits for the
   last pose). Before the calls
   drawn from the seed it copies the pipeline's state;
4. reads `memory_peak_bytes`, frees the program, and replays the copied
   spans and the warm-up's first frames through the plain reference
   (`vo_bench/ref`), holding every compared number to its limit;
5. prints one JSON line: the end-to-end metrics with `--trace 0`, the
   per-layer metrics (from a torch.profiler trace of the window, the host
   syncs it made and the program's launch counters) with `--trace 1`.

It exits non-zero without a result where there is no card, and where JAX or
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = REPO / "build" / "vo_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "visual_odometry_ros_tpu")
# A traced window lasts at most this long: the profiler halves the rate and
# reading its trace takes seconds per second traced, so a longer one would
# not end within a run's time limit. Its metrics are per frame, per solve
# and shares of the window.
TRACED_S = 20.0
# The program's hand-written kernels, by launch counter, and their names in a trace.
KERNELS = {"klt_pyr": "klt_pyr_kernel", "klt_scale": "klt_scale_kernel", "pose_gn": "pose_gn_kernel",
           "ba_terms": "ba_terms_kernel", "ba_solve": "ba_solve_kernel", "ba_backsub": "ba_backsub_kernel"}


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_spec(workload: str) -> dict:
    """The cell's entry in BENCHMARK.json with its files, found by name."""
    bench = load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {
        "workload": w,
        "config": load_json(ROOT / "configs" / f"{w['config']}.json"),
        "traffic": load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(ROOT / "checks" / f"{workload}.json"),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


def vo_config(config_module, doc: dict, crop: dict | None = None):
    """A `VOConfig` of `config_module` (the program's or the reference's)
    from a configuration file. crop {"width", "height", "n_features",
    "landmark_capacity"} (tests only) keeps the image centre and the focal
    length."""
    cfg = config_module.VOConfig()
    for f in dataclasses.fields(cfg):
        if f.name not in doc["vo"]:
            continue
        v, cur = doc["vo"][f.name], getattr(cfg, f.name)
        if dataclasses.is_dataclass(cur):
            for k, x in v.items():
                setattr(cur, k, x)
        elif f.name == "T_lr":
            cfg.T_lr = np.asarray(v, np.float32).reshape(4, 4)
        else:
            setattr(cfg, f.name, v)
    if crop:
        for cam in (cfg.cam, cfg.cam_right):
            cam.cx -= (cam.width - crop["width"]) / 2
            cam.cy -= (cam.height - crop["height"]) / 2
            cam.width, cam.height = crop["width"], crop["height"]
        cfg.extractor.n_features = crop["n_features"]
        cfg.map.landmark_capacity = crop["landmark_capacity"]
    return cfg


def check_times(traffic: dict, seed: int, seconds: float) -> list:
    """The times into the window (s) after which the next call starts a
    span of `span_calls` calls whose state is copied: one drawn from the
    seed in the first half of each of `spans` equal slices of the window, so
    that the spans cover the whole window whatever its rate."""
    n = int(traffic["check"]["spans"])
    u = np.random.default_rng([seed, 1]).uniform(0.0, 0.5, n)
    return [(k + float(u[k])) * seconds / n for k in range(n)]


def read_metric(name: str, run: dict):
    """The per-layer metric `name` from its reader, vo_bench/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"vo_bench_metric_{name}", ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def fps(frames: int, window_s: float) -> float:
    """Frames completed over the whole window."""
    return frames / window_s


def frame_ms_p95(frame_ms: list) -> float:
    """The 95th percentile over all frames of the window (linear between ranks)."""
    return float(np.percentile(np.asarray(frame_ms, np.float64), 95))


class Run:
    """One run of a cell: set-up, window, check (see the module docstring)."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device=None,
                 overrides: dict | None = None):
        self.spec = cell_spec(workload)
        ov = overrides or {}
        self.traffic = {**self.spec["traffic"], **ov.get("traffic", {})}
        self.crop = ov.get("crop")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.window_len = min(seconds, TRACED_S) if trace else seconds
        self.device = device

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        import torch

        from visual_odometry_ros_tpu_torch import config as pcfg
        from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO
        from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO

        from . import world
        from .pipeline import Driver

        doc, tr = self.spec["config"], self.traffic
        self.stereo = doc["mode"] == "stereo"
        self.cfg = vo_config(pcfg, doc, self.crop)
        c = self.cfg.cam
        cam = dict(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height)
        baseline = float(np.linalg.norm(np.asarray(self.cfg.T_lr)[:3, 3])) if self.stereo else None
        t0 = time.perf_counter()
        self.frames = world.make_frames(cam, baseline, tr, self.seed, self.device)
        self.times = {"render_s": time.perf_counter() - t0}
        self.vo = (StereoVO if self.stereo else MonoVO)(self.cfg, device=self.device)
        timed = self.trace and tr["entry"] == "stereo_frame"
        self.driver = Driver(tr["entry"], self.vo, self.frames, int(tr["batch"]), timed=timed)
        self.warm = self.driver.warmup(int(tr["warmup_frames"]), int(tr.get("bootstrap_max_frames", 0)))
        self.driver.stage_ms.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.times["warmup_s"] = time.perf_counter() - t0 - self.times["render_s"]

    # -- the window ----------------------------------------------------------
    def window(self) -> None:
        from torch.profiler import record_function

        from .pipeline import snapshot
        from .tracing import CALL

        drv, n_frames = self.driver, self.frames["left"].shape[0]
        fpc = drv.frames_per_call()
        due = check_times(self.traffic, self.seed, self.window_len)
        span_calls = int(self.traffic["check"]["span_calls"])
        self.snaps, self.outs, self.call_ms = {}, [], []
        self.exhausted = False
        i, k = len(self.warm), 0
        t0 = time.perf_counter()
        while (now := time.perf_counter()) - t0 < self.window_len:
            if i + fpc > n_frames:
                self.exhausted = True
                break
            # A span starts at the first call after its time, and after the
            # last span's end.
            if due and now - t0 >= due[0] and (not self.snaps or k >= max(self.snaps) + span_calls):
                self.snaps[k] = (i, snapshot(self.vo))
                due.pop(0)
            ta = time.perf_counter()
            with record_function(CALL):
                out = drv.call(i)
            self.call_ms.append((time.perf_counter() - ta) * 1e3)
            self.outs.append(out)
            i += fpc
            k += 1
        self.window_s = time.perf_counter() - t0
        self.n_frames = k * fpc

    def traced_window(self) -> dict:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from visual_odometry_ros_tpu_torch.ops import kernels as KN

        from .tracing import WINDOW, count_syncs, read_trace

        syncs: dict = {}
        KN.reset_launch_counts()
        with count_syncs(self.device, syncs):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(WINDOW):
                    self.window()
                    torch.cuda.synchronize(self.device)
        launches = dict(KN.LAUNCHES)
        return {"trace": read_trace(prof), "syncs": syncs["syncs"], "launches": launches,
                "frames": self.n_frames, "keyframes": self.keyframes(), "stage_ms": list(self.driver.stage_ms),
                "kernels": KERNELS}

    def keyframes(self) -> int:
        return sum(1 for out in self.outs for _, st in out if st.get("keyframe"))

    def recoveries(self) -> int:
        return sum(1 for out in self.outs for _, st in out if st.get("recovered"))

    # -- the check -----------------------------------------------------------
    def reference(self, control: str | None = None):
        """A fresh reference pipeline (for a control, with the control's
        change), its state class and its map fields."""
        from .ref import config as rcfg
        from .ref.models import _state
        from .ref.models.mono_vo import MonoVO, MonoVOState
        from .ref.models.stereo_vo import StereoVO, StereoVOState

        cfg = vo_config(rcfg, self.spec["config"], self.crop)
        if control is not None:
            CONTROLS[control](cfg)
        vo = (StereoVO if self.stereo else MonoVO)(cfg, device=self.device)
        return vo, (StereoVOState if self.stereo else MonoVOState), _state._MAP_FIELDS

    def check(self, control: str | None = None) -> dict:
        """Replays the warm-up's first frames from frame 0, and each copied
        span from the program's state, through the reference. Returns the
        gaps of the program's outputs to the reference's; with a `control`
        (a name in CONTROLS), of the control's outputs in the program's place."""
        from .pipeline import Driver, compare, merge, replay, restore

        tr, batch = self.traffic, int(self.traffic["batch"])
        start = int(tr["check"]["start_frames"])
        span_calls = int(tr["check"]["span_calls"])
        fpc = self.driver.frames_per_call()

        def ref_start(ctl):
            vo, _, _ = self.reference(ctl)
            with _Precision(ctl):
                return Driver(tr["entry"], vo, self.frames, batch).warmup(
                    start, int(tr.get("bootstrap_max_frames", 0)))

        def ref_span(ctl, k):
            vo, cls, mf = self.reference(ctl)
            i0, snap = self.snaps[k]
            restore(vo, snap, cls, mf)
            with _Precision(ctl):
                return replay(Driver(tr["entry"], vo, self.frames, batch), i0, span_calls * fpc)

        # A span that the window closed on before its end is not compared.
        self.snaps = {k: v for k, v in self.snaps.items() if k + span_calls <= len(self.outs)}
        if not hasattr(self, "_ref"):  # the float32 reference, once for the program and every control
            self._ref = {"start": ref_start(None), **{k: ref_span(None, k) for k in self.snaps}}
        ref0 = self._ref["start"]
        probe = ref_start(control) if control else self.warm
        n = min(len(ref0), len(probe))
        gaps = [compare(probe[:n], ref0[:n])]
        self.compared = (n, sum(len(self._ref[k]) for k in self.snaps))
        for k in sorted(self.snaps):
            ref = self._ref[k]
            probe = ref_span(control, k) if control else [o for out in self.outs[k : k + span_calls] for o in out]
            gaps.append(compare(probe, ref))
        return merge(gaps)

    def free_program(self) -> None:
        import torch

        del self.vo, self.driver.vo
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class _Precision:
    """float32 products in TF32 inside the block for the "tf32" control, in
    full float32 otherwise, as the program pins them at import."""

    def __init__(self, control: str | None):
        self.tf32 = control == "tf32"

    def __enter__(self):
        import torch

        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.set_float32_matmul_precision("high" if self.tf32 else "highest")

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec = self.prev
        torch.set_float32_matmul_precision(prec)


# The controls that the comparison must fail (vo_bench/control.py reads
# them), each a change to the reference's configuration: "tf32" runs the
# reference's float32 products in TF32 (`_Precision`), one step below the
# program's float32 with TF32 off.
CONTROLS = {"tf32": lambda cfg: None}


def judge(gaps: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each compared number against its limit."""
    checks = {k: {"value": gaps[k], "limit": lim} for k, lim in limits["limits"].items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, overrides=None) -> int:
    """One run. `device` and `overrides` ({"crop", "traffic"}) are for tests
    on the CPU: with a device given, the run does not look for a card."""
    t_start = T_START if argv is None else time.perf_counter()
    args = parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    # One host thread: the pipeline's host work is one Python thread, and an
    # intra-op pool spinning on a shared host's cores spreads the runs.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)

    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), overrides=overrides)
    if device is None:
        need = int(run.spec["workload"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"vo_bench: this cell needs {need} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    run.device = torch.device(device)
    on_card = run.device.type == "cuda"

    run.setup()
    setup_s = time.perf_counter() - t_start
    layer = run.traced_window() if args.trace else None
    if not args.trace:
        run.window()
    if run.exhausted:
        print(f"vo_bench: the window used up the {run.frames['left'].shape[0]} rendered frames after "
              f"{run.window_s:.3f} s; it ends there", file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(run.device)) if on_card else 0
    run.free_program()
    t_check = time.perf_counter()
    correct, checks = judge(run.check(), run.spec["limits"])
    run.times["check_s"] = time.perf_counter() - t_check
    print("vo_bench: " + ", ".join(f"{k} {v:.3f}" for k, v in run.times.items()), file=sys.stderr)
    q = np.percentile(run.call_ms, [0, 25, 50, 75, 100]) if run.call_ms else []
    print(f"vo_bench: window {run.window_s:.3f} s, {len(run.call_ms)} calls, call ms quartiles "
          f"{' '.join(f'{x:.1f}' for x in q)}, {run.keyframes()} keyframes, {run.recoveries()} recoveries",
          file=sys.stderr)
    print(f"vo_bench: compared {sum(run.compared)} frames: {run.compared[0]} from frame 0, and "
          f"{run.compared[1]} in {len(run.snaps)} spans at calls {sorted(run.snaps)} of {len(run.outs)}",
          file=sys.stderr)

    poses = [T for out in run.outs for T, _ in out]
    failed = sum(1 for T in poses if not np.isfinite(T).all())
    metrics = {}
    if args.trace:
        for m in run.spec["per_layer"]:
            v = read_metric(m["name"], layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"fps": fps(run.n_frames, run.window_s), "setup_s": setup_s}
        if run.driver.entry == "stereo_frame":
            values["frame_ms_p95"] = frame_ms_p95(run.call_ms)
        for m in run.spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.n_frames, "failed": failed, "metrics": metrics, "device": dev}
    if args.trace:
        t = layer["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        ops = sorted(t["device_ops"].items(), key=lambda kv: -kv[1]["s"])[:10]
        idle = sorted(t["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:160], v["s"]] for k, v in ops],
                               "idle_gaps": [[k[:160], s] for k, s in idle]}
    result["checks"] = checks

    bad = loaded_forbidden()
    if bad:
        print(f"vo_bench: modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
