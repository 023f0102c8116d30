"""Spans and counters of the pipelines, and the hierarchical JSON profiler.

PyTorch counterpart of ``scalable_ccd_tpu/utils/profiler.py`` (the
reference's ``utils/profiler.hpp:15-97``).  A span (:meth:`Profiler.span`)
marks a stage of ``fused_ccd`` or ``ccd()``; a counter
(:meth:`Profiler.count`) counts what the stage decided on the host
(batches, chunks solved in one launch, kernel launches, budget retries).  Neither reads the device: a
span closes when the host has enqueued its stage, not when the card has run
it, so tracing keeps the overlap of host and device that it measures.

A span does work only while one of two consumers is on:

- **a running** ``torch.profiler``: the span opens a ``record_function``
  range of its name, so the profile holds it, and appends ``(name, parent,
  start_ns, end_ns)`` to the open call's :class:`CallRecord`, stamped with
  ``time.time_ns()``, the Unix-epoch clock the profiler's events carry.  A
  span given ``entry`` opens a call (unless one is open); counters add to
  it.  :meth:`Profiler.records` returns the calls in order, the newest
  :data:`MAX_CALLS` of them;
- ``SCALABLE_CCD_PROFILE=1`` (or :meth:`Profiler.enable`): nested spans add
  their host wall time in ``time_ms`` to a tree of dicts keyed by span
  name (:meth:`Profiler.data`), as the reference's JSON profiler does, and
  counters add to the innermost open span's ``"counters"``.  The times are
  the host's: for the device's time per stage take a ``torch.profiler``
  trace, in which the spans appear.

Both consumers share one pair of stamps per span.  Off, a span costs one
flag test (``torch._C._autograd._profiler_enabled``, about 0.1 us) and
returns a shared ``nullcontext``, and a counter costs two attribute tests.
One thread records at a time.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Any, Dict, List, NamedTuple

import torch
from torch.profiler import record_function

__all__ = ["CallRecord", "MAX_CALLS", "Profiler", "Span", "profiler"]

#: call records kept; older ones are dropped and counted
MAX_CALLS = 4096

_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One span of a call: host time on the profiler's clock, ns."""

    name: str
    #: the enclosing span's name (``None`` for the call's root)
    parent: str | None
    start_ns: int
    end_ns: int


class CallRecord(NamedTuple):
    """One call of an entry point, recorded while a ``torch.profiler`` ran."""

    #: the entry point, ``"fused_ccd"`` or ``"ccd"``
    entry: str
    #: the call's root span (its ``end_ns`` is 0 while the call is open)
    root: Span
    #: the spans inside it, in the order they opened
    spans: List[Span]
    #: ``{name: count}`` of the call's counters
    counters: Dict[str, int]


class Profiler:
    def __init__(self) -> None:
        self._enabled = os.environ.get("SCALABLE_CCD_PROFILE", "0") not in ("0", "")
        self._root: Dict[str, Any] = {}
        self._stack: List[Dict[str, Any]] = [self._root]
        self._records: collections.deque = collections.deque(maxlen=MAX_CALLS)
        #: calls recorded and then dropped for :data:`MAX_CALLS`
        self.dropped = 0
        self._call: CallRecord | None = None
        self._names: List[str] = []

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        """Drop the tree and the call records."""
        self._root.clear()
        self._stack = [self._root]
        self._records.clear()
        self.dropped = 0

    def span(self, name: str, device=None, entry: str | None = None):
        """A context manager that marks the enclosed block as the stage
        ``name``.  ``entry`` names the entry point of a call's root span;
        ``device`` is the torch device the stage enqueues its work on (the
        tree's ``device`` flag: CUDA or not; a span without it takes its
        parent's)."""
        tracing = _profiler_enabled()
        if not (tracing or self._enabled):
            return _OFF
        return _Span(self, name, device, entry, tracing)

    @property
    def counting(self) -> bool:
        """Whether :meth:`count` counts: a call is open or the tree is on."""
        return self._call is not None or self._enabled

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` of the open call and, with the
        tree on, of the innermost open span's node (its ``"counters"``)."""
        call = self._call
        if call is not None:
            call.counters[name] = call.counters.get(name, 0) + n
        if self._enabled:
            counters = self._stack[-1].setdefault("counters", {})
            counters[name] = counters.get(name, 0) + n

    def records(self) -> List[CallRecord]:
        """The recorded calls, oldest first (the newest :data:`MAX_CALLS`;
        :attr:`dropped` counts the rest)."""
        return list(self._records)

    def data(self) -> Dict[str, Any]:
        """The tree of spans: ``{name: {"time_ms", "device", "counters",
        children}}``, host milliseconds and counts summed over every time
        the span ran (``"counters"`` only where a counter counted)."""
        return self._root


def _on_cuda(device, parent: Dict[str, Any]) -> bool:
    if device is None:
        return parent.get("device", False)
    try:
        return torch.device(device).type == "cuda"
    except (RuntimeError, TypeError):  # the entry point's own checks report it
        return False


class _Span:
    """One span while a consumer is on: one pair of stamps feeds both the
    tree and the open call's record."""

    __slots__ = ("prof", "name", "device", "entry", "tracing", "node", "rf", "opens",
                 "parent", "slot", "start")

    def __init__(self, prof: Profiler, name: str, device, entry, tracing: bool):
        self.prof, self.name, self.device, self.entry = prof, name, device, entry
        self.tracing = tracing

    def __enter__(self):
        prof = self.prof
        self.node = None
        if prof._enabled:
            parent = prof._stack[-1]
            self.node = parent.setdefault(
                self.name, {"time_ms": 0.0, "device": _on_cuda(self.device, parent)})
            prof._stack.append(self.node)
        if not self.tracing:
            self.rf = None
            self.start = time.time_ns()
            return self
        self.rf = record_function(self.name)
        # the profiler stamps a range's start inside its enter and its end
        # late in its exit: the start is the midpoint of stamps on either
        # side of the enter, the end a stamp just after the exit
        t0 = time.time_ns()
        self.rf.__enter__()
        self.start = (t0 + time.time_ns()) // 2
        self.opens = self.entry is not None and prof._call is None
        self.parent = prof._names[-1] if prof._names else None
        if self.opens:
            prof._call = CallRecord(self.entry, Span(self.name, None, self.start, 0), [], {})
        elif prof._call is not None:
            self.slot = len(prof._call.spans)
            prof._call.spans.append(None)
        prof._names.append(self.name)
        return self

    def __exit__(self, *exc):
        prof = self.prof
        if self.rf is not None:
            prof._names.pop()
            self.rf.__exit__(*exc)
        end = time.time_ns()
        if self.node is not None:
            self.node["time_ms"] += (end - self.start) / 1e6
            prof._stack.pop()
        if self.rf is None:
            return False
        call = prof._call
        if self.opens:
            prof._call = None
            if len(prof._records) == prof._records.maxlen:
                prof.dropped += 1
            prof._records.append(call._replace(root=Span(self.name, None, self.start, end)))
        elif call is not None:
            call.spans[self.slot] = Span(self.name, self.parent, self.start, end)
        return False


_OFF = contextlib.nullcontext()


_profiler: Profiler | None = None


def profiler() -> Profiler:
    """The process's profiler (reference: ``profiler()``, profiler.hpp:22)."""
    global _profiler
    if _profiler is None:
        _profiler = Profiler()
    return _profiler
