"""Hierarchical JSON profiler.

PyTorch counterpart of ``scalable_ccd_tpu/utils/profiler.py`` (the
reference's ``utils/profiler.hpp:15-97``): nested scopes add their wall
time in ``time_ms`` to a tree of dicts keyed by scope name.  Off unless the
environment sets ``SCALABLE_CCD_PROFILE=1`` (or :meth:`Profiler.enable` is
called); an off scope costs one attribute test.  When on, a scope that ran
CUDA work synchronises the device as it closes, so its time covers the
asynchronous kernels it launched (the JAX package blocks on the scope's
values instead).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List

import torch

__all__ = ["Profiler", "profiler"]


class Profiler:
    def __init__(self) -> None:
        self._enabled = os.environ.get("SCALABLE_CCD_PROFILE", "0") not in ("0", "")
        self._root: Dict[str, Any] = {}
        self._stack: List[Dict[str, Any]] = [self._root]

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        self._root.clear()
        self._stack = [self._root]

    @contextlib.contextmanager
    def scope(self, name: str, device=None):
        """Time the enclosed block under ``name``; ``device`` is the torch
        device its work ran on (a CUDA device is synchronised on exit)."""
        if not self._enabled:
            yield
            return
        dev = torch.device(device) if device is not None else None
        on_cuda = dev is not None and dev.type == "cuda"
        node = self._stack[-1].setdefault(name, {"time_ms": 0.0, "device": on_cuda})
        self._stack.append(node)
        start = time.perf_counter()
        try:
            yield
        finally:
            if on_cuda:
                torch.cuda.synchronize(dev)
            node["time_ms"] += (time.perf_counter() - start) * 1e3
            self._stack.pop()

    def data(self) -> Dict[str, Any]:
        """The tree of scopes: ``{name: {"time_ms", "device", children}}``."""
        return self._root


_profiler: Profiler | None = None


def profiler() -> Profiler:
    """The process's profiler (reference: ``profiler()``, profiler.hpp:22)."""
    global _profiler
    if _profiler is None:
        _profiler = Profiler()
    return _profiler
