"""Build and load the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` into a shared library and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library is built at first
use into ``build/kernels/`` beside the package, named by a hash of its
source, the headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from scalable_ccd_tpu_torch.utils.profiler import profiler

__all__ = ["NVCC_FLAGS", "load_library", "build_library", "BUILD_DIR", "LaunchCounts",
           "launch_counts", "count_launch"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

#: Hopper only (``sm_90a``); ``-fmad=false`` keeps every multiply and add
#: separately rounded, in float and in double, as the solver's exact dyadic
#: unwind and its error filter require (``ops/solver.py``).  ``-Xptxas -v``
#: records registers and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict = {}
#: seconds each library took to build in this process (0.0 when reused)
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from csrc/ at first use"
    )


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of the same source exists;
    returns the library path.  Raises ``RuntimeError`` with the compiler
    output when ``nvcc`` fails."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name)))
            _LOADED[name] = lib
        return lib


class LaunchCounts(dict):
    """A kernel wrapper's launch-count table (:func:`launch_counts`)."""

    def __init__(self, kernel: str, keys):
        super().__init__(dict.fromkeys(keys, 0))
        #: the kernel's name, its ``csrc/<kernel>.cu``
        self.kernel = kernel

    @property
    def total(self) -> int:
        """Every launch of the kernel in this process."""
        return self["f32"] + self["f64"]


def launch_counts(kernel: str, *modes: str) -> LaunchCounts:
    """A zeroed launch-count table of the kernel ``kernel``: one entry per
    mode, counting launches of either scalar type, one per
    ``"<mode>_f64"``, counting the double instantiation alone, and
    ``"f32"`` / ``"f64"``, every launch by scalar type."""
    keys = list(modes) + [m + "_f64" for m in modes] + ["f32", "f64"]
    return LaunchCounts(kernel, keys)


def count_launch(counts: LaunchCounts, modes, f64: bool) -> None:
    """Add one launch in each of ``modes`` to a :func:`launch_counts` table,
    and, while the profiler counts (:mod:`scalable_ccd_tpu_torch.utils.
    profiler`: a call recorded or ``SCALABLE_CCD_PROFILE=1``), one to its
    counter ``launch.<kernel>.<modes joined by +>`` (``_f64`` appended for
    the double instantiation)."""
    for m in modes:
        counts[m] += 1
        if f64:
            counts[m + "_f64"] += 1
    counts["f64" if f64 else "f32"] += 1
    prof = profiler()
    if prof.counting:
        prof.count(f"launch.{counts.kernel}.{'+'.join(modes)}" + ("_f64" if f64 else ""))
