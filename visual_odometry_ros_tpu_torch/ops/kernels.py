"""Build, launch counting and input checks shared by the hand-written CUDA
kernels of `csrc/` (`klt_pyr`, `klt_scale` in klt.cu; `pose_gn` in
pose_gn.cu; `ba_terms`, `ba_solve`, `ba_backsub` in ba_gn.cu).

`build()` compiles every `csrc/*.cu` in one nvcc call for sm_90a into one
shared library with a plain C interface under `build/kernels/` at the
repository root, named by a hash over all of `csrc/`'s kernel sources and
headers, and loads it with ctypes. Nothing here imports or builds anything
when the module is imported: the CPU tests import every module.

`LAUNCHES` counts kernel launches: a wrapper adds one exactly where it
launches its kernel (`launch`), and the plain PyTorch versions never touch it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

LAUNCHES = {"klt_pyr": 0, "klt_scale": 0, "pose_gn": 0, "ba_terms": 0, "ba_solve": 0, "ba_backsub": 0}

_LIB = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit to build")
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    """Hash over every kernel source and header of csrc/."""
    h = hashlib.sha1()
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _bind(lib: ctypes.CDLL) -> None:
    """Argument types of the C launchers (a pointer or the stream as c_void_p,
    never as a default int)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.klt_pyr_launch.argtypes = [P, P]
    lib.klt_pyr_launch.restype = I
    lib.klt_scale_launch.argtypes = [P, P, I, I, P, P, P, P, I, I, I, F, P, P, P, P]
    lib.klt_scale_launch.restype = I
    lib.pose_gn_launch.argtypes = [P, I, P]
    lib.pose_gn_launch.restype = I
    lib.ba_occupancy.argtypes = [I, I, ctypes.POINTER(I)]
    lib.ba_occupancy.restype = I
    bind_ba(lib)


def bind_ba(lib: ctypes.CDLL) -> None:
    """Argument types of ba_gn.cu's three launchers and `ba_layout` (the
    one-thread host build, csrc/ba_gn_host.cpp, exports them under the same
    names); then ops/ba.check_layout, which raises if ops/ba.py's copy of the
    kernels' layout differs from the library's."""
    from .ba import check_layout

    P, I = ctypes.c_void_p, ctypes.c_int
    for name, argv in (("ba_terms", [P, I, I, P]), ("ba_solve", [P, I, I, P]), ("ba_backsub", [P, I, P])):
        fn = getattr(lib, name + "_launch")
        fn.argtypes = argv
        fn.restype = I
    lib.ba_layout.argtypes = [I, ctypes.POINTER(I), I]
    lib.ba_layout.restype = I
    check_layout(lib)


def build() -> ctypes.CDLL:
    """Compile csrc/*.cu for sm_90a in one nvcc call (once per source
    version) and load the library. Raises RuntimeError with nvcc's stderr on
    failure; `BUILD_INFO` holds the library's path, the build's seconds and
    ptxas' report (registers, shared memory, spills of every kernel)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    tag = _tag()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libvo_kernels_{tag}.so"
    report = BUILD_DIR / f"libvo_kernels_{tag}.ptxas.txt"
    t0 = time.perf_counter()
    if not so.exists():
        tmp = BUILD_DIR / f"libvo_kernels_{tag}.{os.getpid()}.tmp.so"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
            *map(str, _sources()),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        report.write_text(proc.stderr)
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    BUILD_INFO.update(library=str(so), seconds=time.perf_counter() - t0,
                      ptxas=report.read_text() if report.exists() else "")
    _LIB = lib
    return lib


def launch(name: str, fn, argv: tuple) -> None:
    """Call the C launcher `fn(*argv)`, raise on its CUDA error code, and
    count the launch."""
    rc = fn(*argv)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


def check(name, t, dtype, shape=None, contiguous=True) -> None:
    """Raise unless `t` is a tensor of `dtype` (and `shape`), contiguous
    unless `contiguous` is False."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def one_device(tensors) -> torch.device:
    """The one device all `tensors` lie on (cpu or cuda); raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
