"""Native host (CPU) broad phase.

The port's own copy of ``scalable_ccd_tpu/host/`` (which the port cannot
import: its package imports jax), with the same C ABI and Python API: a C++
sort-and-sweep (``_native/sweep.cpp``, ``std::thread``) that serves callers
who want candidate pairs without a device round-trip, and an oracle for the
sweep kernels independent of them.  Inputs are numpy arrays or CPU tensors
(a tensor on another device raises); outputs are numpy arrays.

The library is compiled with ``g++`` at first use into ``build/host/`` at
the repository root (beside ``build/kernels/``), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused; nothing is built at import time.  Without ``g++`` the functions
raise ``RuntimeError`` (``native_available()`` is False).

``sort_and_sweep(n_threads=0)`` takes the thread count from
``SCCD_HOST_THREADS`` (0 or unset: the hardware's), and ``SCCD_HOST_BATCH``
caps the boxes per sweep batch (the reference's halve-on-out-of-memory
loop, ``sort_and_sweep.cpp:144-196``), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "native_available",
    "build_vertex_boxes",
    "build_element_boxes",
    "sort_and_sweep",
]

_SRC = Path(__file__).resolve().parent / "_native" / "sweep.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "host"
#: -march=native: the library is built on the machine that loads it
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[Exception] = None


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsccd_host-{digest}.so"


def _compile(out: Path) -> None:
    """``g++`` into a temporary file beside ``out``, then renamed, so a
    concurrent loader never sees half a library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            path = _library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError) as e:  # no g++, or it failed
            _load_error = e
            return None
        lib.sccd_build_vertex_boxes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.sccd_build_vertex_boxes.restype = None
        lib.sccd_build_element_boxes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.sccd_build_element_boxes.restype = None
        lib.sccd_sort_and_sweep.restype = ctypes.c_int64
        lib.sccd_sort_and_sweep.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.sccd_free.argtypes = [ctypes.c_void_p]
        lib.sccd_free.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library is built (building it on first call)."""
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host library unavailable: {_load_error}")
    return lib


def _array(x, dtype) -> np.ndarray:
    """A C-contiguous numpy copy or view of a numpy array or CPU tensor."""
    if torch.is_tensor(x):
        if x.device.type != "cpu":
            raise ValueError(f"the host broad phase takes CPU tensors, got one on {x.device}")
        x = x.detach().numpy()
    return np.ascontiguousarray(x, dtype)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_vertex_boxes(
    vertices_t0,
    vertices_t1=None,
    inflation_radius: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Conservative ``(min, max)`` vertex boxes, float64, ulp-widened."""
    lib = _library()
    v0 = _array(vertices_t0, np.float64)
    v1 = None if vertices_t1 is None else _array(vertices_t1, np.float64)
    n = len(v0)
    vmin = np.empty((n, 3), np.float64)
    vmax = np.empty((n, 3), np.float64)
    lib.sccd_build_vertex_boxes(
        _ptr(v0), None if v1 is None else _ptr(v1), n,
        float(inflation_radius), _ptr(vmin), _ptr(vmax),
    )
    return vmin, vmax


def build_element_boxes(vmin, vmax, elements) -> Tuple[np.ndarray, np.ndarray]:
    """``(min, max)`` boxes of edges (k=2) or faces (k=3) as unions of their
    vertex boxes."""
    lib = _library()
    el = _array(elements, np.int32)
    n, k = el.shape
    emin = np.empty((n, 3), np.float64)
    emax = np.empty((n, 3), np.float64)
    lib.sccd_build_element_boxes(
        _ptr(_array(vmin, np.float64)), _ptr(_array(vmax, np.float64)),
        _ptr(el), n, k, _ptr(emin), _ptr(emax),
    )
    return emin, emax


def sort_and_sweep(
    bmin,
    bmax,
    vertex_ids,
    element_ids,
    axis: int = 0,
    two_lists: bool = False,
    n_threads: int = 0,
) -> Tuple[np.ndarray, int]:
    """All filtered candidate pairs, ``(P, 2)`` int32, and the recommended
    next sort axis.

    The emit convention of the device sweeps and of the reference's CPU
    path (``sort_and_sweep.cpp:106-118``): one-list ``(min, max)`` element
    ids; two-list ``(list-A id, list-B id)`` with list A tagged by negative
    element ids (``flip_id``).  ``n_threads=0`` takes ``SCCD_HOST_THREADS``
    (0 or unset: the hardware's thread count).
    """
    lib = _library()
    if n_threads == 0:
        # the reference's --nthreads / tbb::global_control (tests/main.cpp:67-68)
        n_threads = int(os.environ.get("SCCD_HOST_THREADS", "0"))
    bmin = _array(bmin, np.float64)
    bmax = _array(bmax, np.float64)
    vids = _array(vertex_ids, np.int32)
    eids = _array(element_ids, np.int32)
    n = len(bmin)
    out = ctypes.POINTER(ctypes.c_int32)()
    next_axis = ctypes.c_int(0)
    count = lib.sccd_sort_and_sweep(
        _ptr(bmin), _ptr(bmax), _ptr(vids), _ptr(eids), n,
        int(axis), int(bool(two_lists)), int(n_threads),
        ctypes.byref(out), ctypes.byref(next_axis),
    )
    try:
        if count < 0:
            raise MemoryError(
                "native sweep ran out of memory even at batch size 1 "
                "(the adaptive halving of sort_and_sweep.cpp:144-196)"
            )
        if count == 0:
            return np.zeros((0, 2), np.int32), int(next_axis.value)
        pairs = np.ctypeslib.as_array(out, shape=(int(count), 2)).copy()
        return pairs, int(next_axis.value)
    finally:
        if out:
            lib.sccd_free(out)
