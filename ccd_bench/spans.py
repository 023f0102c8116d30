"""What the span and counter readers share: the program's own records of
the calls of the device-only traced pass, and the arithmetic of the
device's idle time inside host spans.

The program (``scalable_ccd_tpu_torch/utils/profiler.py``) keeps, while a
``torch.profiler`` runs, one record per call of its entry point: the root
span, the spans inside it and the call's counters, stamped on the
profiler's clock (Unix-epoch ns).  The warm cycle and the untraced cycles
run with no profiler, so the device-only pass's calls are the process's
first records.  A program that keeps no records (one older than its spans)
gives ``None`` to every reader here.
"""

from __future__ import annotations

import bisect

__all__ = ["call_records", "span_s", "counter_sum", "idle_gaps", "overlap_s",
           "idle_in_spans_s"]

#: how long after the last call's root span the device may still run that
#: call's work (its caller's read of the TOI waits for it)
TAIL_S = 1.0


def call_records(run):
    """The program's records of the ``run.calls`` calls of the device-only
    traced pass, or ``None`` unless there are as many and every device
    event of ``run.trace.device`` lies between the first record's start and
    :data:`TAIL_S` past the last record's end."""
    try:
        from scalable_ccd_tpu_torch.utils.profiler import profiler
    except ImportError:
        return None
    prof = profiler()
    if not callable(getattr(prof, "records", None)) or getattr(prof, "dropped", 0):
        return None
    recs = prof.records()[:run.calls]
    if not run.calls or len(recs) != run.calls:
        return None
    lo, hi = recs[0].root.start_ns / 1e9, recs[-1].root.end_ns / 1e9 + TAIL_S
    if any(a < lo or b > hi for _, a, b in run.trace.device):
        return None
    return recs


def span_s(rec, names) -> float:
    """Seconds of the call ``rec`` spent in spans named in ``names``."""
    return sum(s.end_ns - s.start_ns for s in rec.spans if s.name in names) / 1e9


def counter_sum(rec, prefix: str) -> int:
    """The sum of the call's counters whose name starts with ``prefix``."""
    return sum(v for k, v in rec.counters.items() if k.startswith(prefix))


def idle_gaps(events, t0: float, t1: float) -> list:
    """The ``(start, end)`` intervals of ``[t0, t1]`` that no ``(name,
    start, end)`` event covers; ``events`` sorted by start."""
    gaps, end = [], t0
    for _, a, b in events:
        if a >= t1:
            break
        if b <= end:
            continue
        if a > end:
            gaps.append((end, a))
        end = b
    if end < t1:
        gaps.append((end, t1))
    return gaps


def overlap_s(gaps, spans) -> float:
    """Seconds that the intervals ``gaps`` share with ``(start, end)``
    intervals ``spans``."""
    return sum(max(0.0, min(b, d) - max(a, c)) for a, b in gaps for c, d in spans)


def idle_in_spans_s(run, recs, names) -> float:
    """Seconds, over every call, in which the card ran nothing while the
    host was inside a span named in ``names``: the idle intervals of the
    device events within each call's root span, intersected with those
    spans."""
    events = sorted(run.trace.device, key=lambda e: e[1])
    starts = [e[1] for e in events]
    longest = max((b - a for _, a, b in events), default=0.0)
    total = 0.0
    for rec in recs:
        t0, t1 = rec.root.start_ns / 1e9, rec.root.end_ns / 1e9
        near = events[bisect.bisect_left(starts, t0 - longest):bisect.bisect_left(starts, t1)]
        spans = [(s.start_ns / 1e9, s.end_ns / 1e9) for s in rec.spans if s.name in names]
        total += overlap_s(idle_gaps(near, t0, t1), spans)
    return total
