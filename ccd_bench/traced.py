"""What a traced run reads: the device events of a profiled window, the
device's busy time in it, the idle gaps and what the host was doing in
them, and the host syncs of a run of calls.

The arithmetic of the busy time (the union of device events inside the
window's span) and of the sync count (the warnings of
``torch.cuda.set_sync_debug_mode("warn")``) is a copy of the port's stage
tool (``scalable_ccd_tpu_torch/tools/stages.py``: ``idle_share``,
``count_syncs``); how events are grouped into layers is each per-layer
metric's own (``metrics/``).
"""

from __future__ import annotations

import bisect
import math
import re
import time
import warnings
from typing import NamedTuple

import torch

__all__ = ["Trace", "profile_calls", "count_syncs", "breakdown", "union_s"]

#: the benchmark's own span around the traced window
WINDOW_LABEL = "ccd_bench.window"


class Trace(NamedTuple):
    """A traced window: its span and its device events, seconds."""

    #: the window's span on the profiler's clock, where the host was traced
    #: (``None`` otherwise: the device events all lie inside the window)
    start: float | None
    end: float | None
    #: the window's length, on the profiler's clock or the host's
    window_s: float
    #: (name, start, end) of every device event (kernels, copies, fills)
    device: list
    #: (name, start, end) of every host event, sorted by start
    host: list

    def busy_s(self) -> float:
        lo = -math.inf if self.start is None else self.start
        hi = math.inf if self.end is None else self.end
        return union_s(self.device, lo, hi)


def union_s(events, t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` that at least one ``(name, start, end)`` event
    covers."""
    total, end = 0.0, t0
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def profile_calls(fn, cuda: bool = True, host: bool = True):
    """``(fn(), Trace)``: ``fn`` run once under ``torch.profiler``, ending in
    a device synchronize.

    With ``host``, the host's operations are traced too, inside the span
    :data:`WINDOW_LABEL`, which gives the window; that costs the host time
    in every operation, so the idle gaps read long.  Without it only the
    device's activity is traced and the window is the host clock's span
    from one synchronize to the next, close to an untraced run's.  With
    ``cuda`` false (a dry run on the CPU) there are no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(cuda)
    activities = (([ProfilerActivity.CPU] if host or not cuda else [])
                  + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=activities) as prof:
        a = time.perf_counter()
        with record_function(WINDOW_LABEL):
            out = fn()
            _sync(cuda)
        b = time.perf_counter()
    span, device, host_ev = None, [], []
    for name, dev, t0, t1, note in _events(prof):
        rec = (name, t0, t1)
        if dev == DeviceType.CUDA:
            if not note and name != WINDOW_LABEL:
                device.append(rec)
        elif name == WINDOW_LABEL:
            span = rec
        else:
            host_ev.append(rec)
    host_ev.sort(key=lambda e: e[1])
    if host or not cuda:
        if span is None:
            raise RuntimeError("the profiler recorded no window span")
        return out, Trace(span[1], span[2], span[2] - span[1], device, host_ev)
    return out, Trace(None, None, b - a, device, [])


def _events(prof):
    """``(name, device type, start s, end s, user annotation)`` of every
    event of the profile, read from the raw results (building the
    profiler's own event objects takes some fifteen times as long)."""
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        for e in prof.events():
            yield (e.name, e.device_type, e.time_range.start / 1e6, e.time_range.end / 1e6,
                   False)
        return
    for e in raw.events():
        t0 = e.start_ns() / 1e9
        yield e.name(), e.device_type(), t0, t0 + e.duration_ns() / 1e9, e.is_user_annotation()


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list (the
    last parenthesised group); a copy's or a fill's name whole."""
    name = re.sub(r"^void ", "", name)
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i and not name[i - 1].isspace():
                    name = name[:i]
                break
    return name[:120]


def _host_op_at(host, starts, t: float) -> str:
    """The innermost host event running at ``t``: of those that started
    before it and have not ended, the last to start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 512, -1), -1):
        name, a, b = host[j]
        if a <= t <= b:
            return name
    return "python (no op)"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[host op, s], ...]}``:
    the device operations that took most time, summed by kernel name, and
    the device's idle time inside the window summed by the host op that was
    running in the middle of each gap, the largest ``top`` of each."""
    ops = {}
    for name, a, b in trace.device:
        k = _short(name)
        ops[k] = ops.get(k, 0.0) + (b - a)
    starts = [e[1] for e in trace.host]
    gaps, end = {}, trace.start
    for _, a, b in sorted(trace.device, key=lambda e: e[1]) + [("", trace.end, trace.end)]:
        a = min(a, trace.end)
        if a > end:
            label = _host_op_at(trace.host, starts, (a + end) / 2)
            gaps[label] = gaps.get(label, 0.0) + (a - end)
        end = max(end, b)
    by = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": by(ops), "idle_gaps": by(gaps)}


def count_syncs(fn, cuda: bool = True):
    """``(fn(), n)``: the synchronizing CUDA calls ``fn`` makes (host reads
    of device values, blocking copies); ``n`` is ``None`` without ``cuda``."""
    if not cuda:
        return fn(), None
    seen = [0]

    def show(message, *_args, **_kw):
        if "called a synchronizing CUDA operation" in str(message):
            seen[0] += 1

    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, seen[0]
