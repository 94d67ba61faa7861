"""Where a pose solve's iteration and a working `ba_backsub` launch spend
their time on the card: clock stamps from one thread, in an instrumented
copy of the tree's kernels.

The leg copies the tree's `csrc/` under `build/kernel_split/`, puts stamps
(`clock64()` and `%globaltimer`, stored by one thread into a device buffer)
around statements the kernels carry (`MARKS`), builds the copy with the
nvcc flags of `ops/kernels.build` and loads it in place of the tree's
library. No timing code lives in `csrc/`. Stamps:
  - `pose_gn` (thread 0 of the first block), per GN iteration: the walk
    over the points (loop head to `b.sum(acc);`), the block-wide sum, the
    step (`step(a, acc, ...);`) and, where the design has one, the barrier
    after it; per launch, the whole `run(...)` and what lies outside the
    iterations (the robust wrapper's walks and sums, the outputs);
  - window BA, per working iteration's `ba_backsub` launch: in block 0
    (thread 0, its first tile or warp of landmarks) the prologue, the
    landmark blocks (rebuilt from the observations where a tree's
    ba_backsub rebuilds them; read, with B^T dx, where it reads what
    ba_terms stored), dy and its write; in the block that takes the last
    ticket, the ticket itself (from its own work's end) and the apply
    step's tail (`apply_tail`) in four parts: the count, then X += dy and
    T and max |dx| where a tree's tail walks them (where it only decides,
    the guard and the stop test), the stores.
A mark is a list of alternatives, of which one must match once: the marks
match the pose loop of both the one-thread step (a barrier after it) and
the step taken by every warp, and `backsub_block` / `apply_tail` of both
the tail that applies the step over the landmark list and the one that
only decides, so a copy of this file, with `pose_ab.py` and `ba_ab.py`, in
another tree's package splits that tree's kernels; a tree without
`apply_tail` gives pose rows only. A stamp costs a clock read and two
stores (a load's wait shows where its value is first used); cycles become
ns by the pose launches' clock64 / globaltimer ratio. `--threads` sets
`kThreads` of pose_gn.cu in the copy (one copy per size, built in
parallel), to re-time the team size.
One JSON line per case and size goes to `--out`, medians over `--reps`
launches. Run from the tree's root after chip_smoke.py has saved the cases:

    python -m visual_odometry_ros_tpu_torch.kernel_split --tag pr --threads 128,256,512 --out split.jsonl
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import shutil
import statistics
import subprocess

import torch

from . import pose_ab
from .ba_ab import tensors
from .ops import ba as BA
from .ops import kernels as KN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 8192  # stamp slots: pose (pass, iteration, tag) at 0..2047, launch ends 2048.., BA (it, tag) from 4096

HELPER = r"""
#ifdef __CUDACC__
static __device__ unsigned long long ks_buf[2 * %(slots)d];
static __device__ __forceinline__ void ks_put(int slot) {
  unsigned long long gt;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(gt));
  ks_buf[2 * slot] = clock64();
  ks_buf[2 * slot + 1] = gt;
}
#endif
#ifdef __CUDACC__
static __device__ __forceinline__ void ks_put_at(int slot, unsigned long long clk) {
  unsigned long long gt;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(gt));
  ks_buf[2 * slot] = clk;
  ks_buf[2 * slot + 1] = gt;
}
#endif
#ifdef __CUDA_ARCH__
#define KS(slot, who) do { if (who) ::pose_gn::ks_put(slot); } while (0)
#define KS_CLOCK(v) const unsigned long long v = clock64()
#define KS_AT(slot, who, clk) do { if (who) ::pose_gn::ks_put_at(slot, clk); } while (0)
#else
#define KS(slot, who) do { } while (0)
#define KS_CLOCK(v) const unsigned long long v = 0; (void)v
#define KS_AT(slot, who, clk) do { } while (0)
#endif
""" % {"slots": SLOTS}

READER = r"""
extern "C" int ks_read_%(tu)s(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pose_gn::ks_buf, sizeof(pose_gn::ks_buf));
  if (e != cudaSuccess) return (int)e;
  void* p;
  e = cudaGetSymbolAddress(&p, pose_gn::ks_buf);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(pose_gn::ks_buf));
}
"""

# Pose slots: (pass * 128 + iteration) * 8 + tag, tags 1 top, 2 walk done,
# 3 sum done, 4 step done, 5 barrier after the step done; 2048 / 2049 the
# launch's start and end. BA slots: 4096 + iteration * 64 + tag: in block
# 0, 50 entry, 51 prologue done, 52 blocks ready, 53 dy done; in the last
# block, 54 its own work done (before the ticket), 40 the tail's start, 41
# count, 42 before the X / T part, 43 after it, 44 the tail's end.
P = "threadIdx.x == 0 && blockIdx.x == 0"
T0 = "b.tid == 0"
B0 = "b.tid == 0 && b.bid == 0"


def _pose(tag: int) -> str:
    return f"KS(((second ? 1 : 0) * 128 + ks_i) * 8 + {tag}, {P});"


def _ba(tag: int, who: str = T0) -> str:
    return f"KS(4096 + it * 64 + {tag}, {who});"


def _step(m) -> str:
    ind = m["ind"]
    out = f"\n{ind}{_pose(2)}\n{ind}b.sum(acc);\n{ind}{_pose(3)}\n{ind}{m['step']}\n{ind}{_pose(4)}\n"
    return out + (f"{ind}b.sync();\n{ind}{_pose(5)}\n" if m["sync"] else "")


def _after(tag: int, who: str = T0):
    return lambda m: f"{m[0]}{m['ind']}{_ba(tag, who)}\n"


def _before(tag: int, who: str = T0):
    return lambda m: f"\n{m['ind']}{_ba(tag, who)}{m[0]}"


def _ticket(m) -> str:
    ind = m["ind"]
    return (f"\n{ind}KS_CLOCK(ks_t);\n{ind}if (b.last(a.ticket)) {{\n{ind}  KS_AT(4096 + it * 64 + 54, {T0}, ks_t);\n"
            f"{ind}  apply_tail({m['args']});\n{ind}  {_ba(44)}\n{ind}}}\n")


FIRST_TILE = f"{B0} && tile == b.bid"  # block 0's first tile of landmarks (a tree that rebuilds them)
FIRST_WARP = f"{B0} && q == 0"  # block 0's first warp of landmarks (a tree that reads them)

# {file: [mark, ...]}, a mark a list of (statement pattern, what it becomes)
# alternatives, exactly one of which matches, once.
MARKS = {
    "pose_gn.cuh": [
        [(r"\n(?P<ind>[ \t]*)while \((?P<st>\w+)\.it < a\.max_iters && !(?P=st)\.done\) \{\n",
          lambda m: f"{m[0]}{m['ind']}  const int ks_i = {m['st']}.it;\n{m['ind']}  {_pose(1)}\n")],
        [(r"\n(?P<ind>[ \t]*)b\.sum\(acc\);\n(?P=ind)(?P<step>(?:if \(b\.tid == 0\) )?step\(a, acc, [^;\n]*\);)\n"
          r"(?:(?P=ind)(?P<sync>b\.sync\(\);)\n)?", _step)],
    ],
    "pose_gn.cu": [
        [(r"\n(?P<ind>[ \t]*)(?P<run>run\(a, b[^;\n]*\);)\n",
          lambda m: f"\n{m['ind']}KS(2048, {P});\n{m['ind']}{m['run']}\n{m['ind']}KS(2049, {P});\n")],
    ],
    "ba_gn.cuh": [
        [(r"PG_HD void backsub_block\(const Args& a, Blk& b[^)\n]*\) \{\n", lambda m: f"{m[0]}  {_ba(50, B0)}\n")],
        [(r"\n(?P<ind>[ \t]*)if \(b\.bid < s\.n_tiles\) \{\n", _before(51, B0)),
         (r"\n(?P<ind>[ \t]*)const int L = Blk::kLmPerWarp[^;\n]*;\n", _before(51, B0))],
        [(r"\n(?P<ind>[ \t]*)tile_blocks\(a, b, s, t, p0, false\);\n", _after(52, FIRST_TILE)),
         (r"\n[ \t]*b\.put_row\([^;\n]*\);\n(?P<ind>[ \t]*)\}\n", _after(52, FIRST_WARP))],
        [(r"\n(?P<ind>[ \t]*)b\.sync\(\);\n"
          r"(?=(?P=ind)if \(b\.tid == 0\)\n[ \t]*for \(int l = 0; l < kTL; \+\+l\) count)", _after(53, FIRST_TILE)),
         (r"\n(?P<ind>[ \t]*)if \(n_bad > 0 && b\.lane\(\) == 0\) b\.atomic_add\(a\.n_dy, n_bad\);\n",
          _after(53, FIRST_WARP))],
        [(r"\n(?P<ind>[ \t]*)if \(b\.last\(a\.ticket\)\) apply_tail\((?P<args>a, b, it(?:, refused)?)\);\n", _ticket)],
        [(r"PG_HD void apply_tail\(const Args& a, Blk& b, int it(?:, bool refused)?\) \{\n",
          lambda m: f"{m[0]}  {_ba(40)}\n")],
        [(r"\n(?P<ind>[ \t]*)n_dy = b\.sum\(n_dy\);\n", _after(41)),
         (r"\n(?P<ind>[ \t]*)const int n_dy = ld_cg\(a\.n_dy\);\n", _after(41))],
        [(r"\n(?P<ind>[ \t]*)for \(int i = b\.tid; i < 16 \* a\.K; i \+= b\.nthr\) a\.T\[i\] = a\.T_new\[i\];\n",
          _before(42)),
         (r"\n(?P<ind>[ \t]*)if \(bad && !refused\) \*a\.half = 1;\n", _before(42))],
        [(r"\n(?P<ind>[ \t]*)mx = b\.max\(mx\);\n", _after(43)),
         (r"\n(?P<ind>[ \t]*)const float mx = \*a\.dx_max;\n", _after(43))],
    ],
}
# A working ba_backsub launch's spans, (from tag, to tag): block 0's, then
# the last block's.
BA_SPANS = {"prologue": (50, 51), "blocks": (51, 52), "dy": (52, 53), "ticket": (54, 40), "tail_counts": (40, 41),
            "tail_X": (41, 42), "tail_T_max": (42, 43), "tail_end": (43, 44)}


def has_tail() -> bool:
    """Whether the tree's ba_backsub runs the apply step as its tail."""
    return "apply_tail(" in open(os.path.join(KN.CSRC, "ba_gn.cuh")).read()


def instrument(out_dir: str, threads: int | None) -> str:
    """The tree's csrc/ under out_dir with the stamps inserted (and pose_gn's
    team set to `threads`); returns the directory."""
    src = os.path.join(out_dir, "csrc")
    if os.path.exists(src):
        shutil.rmtree(src)
    shutil.copytree(KN.CSRC, src)
    for name, marks in MARKS.items():
        if name == "ba_gn.cuh" and not has_tail():
            continue
        path = os.path.join(src, name)
        text = open(path).read()
        for alternatives in marks:
            counts = [len(re.findall(pattern, text)) for pattern, _ in alternatives]
            if sorted(counts) != [0] * (len(counts) - 1) + [1]:
                raise RuntimeError(f"kernel_split: the alternatives {[p for p, _ in alternatives]!r} matched "
                                   f"{counts} times in {name}, not one of them once")
            pattern, new = alternatives[counts.index(1)]
            text = re.sub(pattern, new, text)
        open(path, "w").write(text)
    path = os.path.join(src, "pose_gn.cuh")
    text = open(path).read()
    open(path, "w").write(text.replace("namespace pose_gn {\n", "namespace pose_gn {\n" + HELPER, 1))
    for tu in ("pose_gn", "ba_gn"):
        path = os.path.join(src, tu + ".cu")
        text = open(path).read() + READER % {"tu": tu}
        if tu == "pose_gn" and threads:
            text, n = re.subn(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", text)
            if n != 1:
                raise RuntimeError("kernel_split: pose_gn.cu has no `constexpr int kThreads`")
        open(path, "w").write(text)
    return src


def start_build(src: str) -> tuple:
    """nvcc on the instrumented copy, started (ops/kernels.build's flags);
    returns (process, path of the library)."""
    so = os.path.join(os.path.dirname(src), "libvo_kernels_split.so")
    cmd = [KN._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", so, *sorted(glob.glob(os.path.join(src, "*.cu")))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so


def load(proc, so: str) -> ctypes.CDLL:
    """The built copy, bound and put in place of the tree's library."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
    lib = ctypes.CDLL(so)
    KN._bind(lib)
    for tu in ("pose_gn", "ba_gn"):
        getattr(lib, f"ks_read_{tu}").argtypes = [ctypes.c_void_p]
    KN._LIB = lib
    return lib


def read(lib, tu: str) -> torch.Tensor:
    """The stamp buffer of translation unit `tu` as [SLOTS, 2] (clock64,
    globaltimer; 0 where no stamp), then zeroed."""
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * SLOTS))()
    rc = getattr(lib, f"ks_read_{tu}")(buf)
    if rc != 0:
        raise RuntimeError(f"ks_read_{tu}: cudaError {rc}")
    return torch.tensor(list(buf), dtype=torch.float64).view(SLOTS, 2)


def pose_parts(s) -> dict:
    """One pose launch's stamps: per iteration the walk, sum, step and
    barrier cycles (lists over the iterations run), the launch's cycles and
    the cycles outside the iterations."""
    parts = {"walk": [], "sum": [], "step": [], "barrier": []}
    inside = 0.0
    for p in range(2):
        for i in range(128):
            t = s[(p * 128 + i) * 8:(p * 128 + i) * 8 + 6, 0]
            if t[1] == 0:
                break
            for k, name in enumerate(parts):
                if t[k + 2] > 0:
                    parts[name].append(float(t[k + 2] - t[k + 1]))
            inside += float((t[5] if t[5] > 0 else t[4]) - t[1])
    total = float(s[2049, 0] - s[2048, 0])
    ns_per_cycle = float((s[2049, 1] - s[2048, 1]) / (s[2049, 0] - s[2048, 0]))
    return {**parts, "launch": total, "outside": total - inside, "ns_per_cycle": ns_per_cycle}


def split_pose(lib, path: str, dev, reps: int) -> dict:
    fn_name, args, kwargs = pose_ab.load_case(path, dev)
    pose_ab.results(fn_name, args, kwargs)
    read(lib, "pose_gn")
    runs = []
    for _ in range(reps):
        res = pose_ab.results(fn_name, args, kwargs)
        runs.append(pose_parts(read(lib, "pose_gn")))
    ns = statistics.median(r["ns_per_cycle"] for r in runs)
    row = {"case": os.path.splitext(os.path.basename(path))[0], "function": fn_name,
           "n_iter": [int(r.n_iter) for r in res], "ns_per_cycle": ns}
    for k in ("walk", "sum", "step", "barrier"):
        vals = [statistics.median(r[k]) for r in runs if r[k]]
        row[f"{k}_ns_per_iter"] = statistics.median(vals) * ns if vals else None
    for k in ("launch", "outside"):
        row[f"{k}_ns"] = statistics.median(r[k] for r in runs) * ns
    return row


def split_ba(lib, path: str, dev, reps: int, ns: float) -> dict:
    """Median ns of each span of a working ba_backsub launch (`BA_SPANS`:
    cycles of block 0's clock, then of the last block's, at `ns` per cycle:
    the pose launches' ratio)."""
    args, kwargs = torch.load(path, weights_only=False)
    args = tensors(args, lambda t: t.to(dev))
    info = {}
    BA.ba_solve_impl(*args, **kwargs, info=info)
    read(lib, "ba_gn")
    spans = {k: [] for k in BA_SPANS}
    for _ in range(reps):
        BA.ba_solve_impl(*args, **kwargs)
        s = read(lib, "ba_gn")
        for it in range(info["iters"]):
            t = s[4096 + it * 64:4096 + it * 64 + 64, 0]
            for k, (a, b) in BA_SPANS.items():
                if t[a] > 0 and t[b] > 0:
                    spans[k].append(float(t[b] - t[a]))
    return {"case": os.path.splitext(os.path.basename(path))[0], "iters": info["iters"],
            **{f"{k}_ns": statistics.median(v) * ns for k, v in spans.items() if v}}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cases", default="build/chip_smoke_pose", help="saved pose calls (*.pt)")
    p.add_argument("--problems", default="build/chip_smoke_ba", help="saved BA problems (*.pt)")
    p.add_argument("--tag", required=True, help="the tree's name in the records")
    p.add_argument("--out", required=True, help="JSON lines file to append to")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--threads", default="", help="pose_gn team sizes to split at, comma-separated ('' the tree's)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: needs a CUDA GPU")
    dev = torch.device("cuda")
    sizes = [int(t) for t in args.threads.split(",") if t] or [None]
    builds = {t: start_build(instrument(os.path.join(ROOT, "build", "kernel_split", f"t{t or 0}"), t))
              for t in sizes}
    rows = []
    for t in sizes:
        lib = load(*builds[t])
        head = {"tag": args.tag, "threads": t}
        pose = [{**head, "kernel": "pose_gn", **split_pose(lib, path, dev, args.reps)}
                for path in sorted(glob.glob(os.path.join(args.cases, "*.pt")))]
        rows += pose
        if has_tail() and pose:
            ns = statistics.median(r["ns_per_cycle"] for r in pose)
            rows += [{**head, "kernel": "ba", **split_ba(lib, path, dev, args.reps, ns)}
                     for path in sorted(glob.glob(os.path.join(args.problems, "*.pt")))]
    with open(args.out, "a") as f:
        for row in rows:
            row["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(row))
            f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
