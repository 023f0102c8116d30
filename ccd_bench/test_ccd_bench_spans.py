"""CPU tests of the readers of the program's spans and counters
(``metrics/narrow_host_ms.py``, ``broad_host_ms.py``, ``narrow_idle_ms.py``,
``batches_idle_ms.py``, ``narrow_batches_per_call.py``,
``solver_launches_per_call.py``, ``pack_launches_per_call.py`` and
:mod:`ccd_bench.spans`).

    python -m pytest ccd_bench/test_ccd_bench_spans.py -q
"""

from __future__ import annotations

import pytest

from ccd_bench import cells, spans, traced
from ccd_bench.harness import TraceRun
from ccd_bench.test_ccd_bench_harness import BASE, _dry_run, _tiny_tree

READERS = ("narrow_host_ms", "broad_host_ms", "narrow_idle_ms", "batches_idle_ms",
           "narrow_batches_per_call", "solver_launches_per_call", "pack_launches_per_call")
#: a hand-made call's clock origin, s (Unix-epoch-like)
T = 1.8e9


def _ns(t: float) -> int:
    return int(round((T + t) * 1e9))


def _record(spans_at, counters):
    """A call record of the program's form: root span [0, 10] s after
    :data:`T`, and ``(name, start, end)`` spans in seconds after it."""
    from scalable_ccd_tpu_torch.utils.profiler import CallRecord, Span

    return CallRecord("fused_ccd", Span("sccd.fused_ccd", None, _ns(0), _ns(10)),
                      [Span(n, "sccd.phase.vf", _ns(a), _ns(b)) for n, a, b in spans_at],
                      dict(counters))


class _Store:
    """Stands in for the program's profiler: its records and nothing else."""

    def __init__(self, recs, dropped=0):
        self._recs, self.dropped = recs, dropped

    def records(self):
        return list(self._recs)


def _run(device, calls=1):
    trace = traced.Trace(None, None, 10.0, [(n, T + a, T + b) for n, a, b in device], [])
    return TraceRun(trace, [{}] * calls, None, 0, 0, 0, untraced_s=10.0)


def _read(name, run):
    return cells.load_reader(BASE, name)(run)


@pytest.fixture
def store(monkeypatch):
    from scalable_ccd_tpu_torch.utils import profiler as profiler_mod

    def put(recs, dropped=0):
        monkeypatch.setattr(profiler_mod, "_profiler", _Store(recs, dropped))
    return put


HAND = [("sccd.upload", 0.1, 0.3), ("sccd.boxes", 0.3, 0.5), ("sccd.sweep", 0.5, 1.0),
        ("sccd.narrow", 1.0, 4.0), ("sccd.sweep", 5.0, 6.0), ("sccd.narrow", 6.0, 9.0),
        ("sccd.batches", 1.5, 2.5), ("sccd.batches", 6.5, 8.0)]
COUNTERS = {"batches": 7, "launch.solver.round_limit": 2, "launch.solver.global": 5,
            "launch.gather_pack.vf": 1}
#: three device events; the card idles in [0, 0.5], [2, 3], [5, 7] and [7.5, 10]
DEVICE = [("k1", 0.5, 2.0), ("k2", 3.0, 5.0), ("k3", 7.0, 7.5)]


def test_hand_made_trace(store):
    store([_record(HAND, COUNTERS)])
    run = _run(DEVICE)
    # idle inside the narrow spans [1, 4] and [6, 9]: [2, 3], [6, 7], [7.5, 9]
    assert _read("narrow_idle_ms", run) == pytest.approx(3500.0)
    # idle inside the batch loops [1.5, 2.5] and [6.5, 8]: [2, 2.5], [6.5, 7], [7.5, 8]
    assert _read("batches_idle_ms", run) == pytest.approx(1500.0)
    assert _read("narrow_host_ms", run) == pytest.approx(6000.0)
    assert _read("broad_host_ms", run) == pytest.approx(1900.0)
    assert _read("narrow_batches_per_call", run) == 7
    assert _read("solver_launches_per_call", run) == 7
    assert _read("pack_launches_per_call", run) == 1
    gaps = spans.idle_gaps(sorted(run.trace.device, key=lambda e: e[1]), T, T + 10)
    assert [(round(a - T, 6), round(b - T, 6)) for a, b in gaps] == [
        (0.0, 0.5), (2.0, 3.0), (5.0, 7.0), (7.5, 10.0)]


def test_idle_counts_each_call_in_its_own_root_span(store):
    # a second call 20 s on; a device event that spans both roots' gap
    later = _record([], {"batches": 3})
    later = later._replace(root=later.root._replace(start_ns=_ns(20), end_ns=_ns(30)),
                           spans=[later.root._replace(name="sccd.narrow", parent="x",
                                                      start_ns=_ns(21), end_ns=_ns(29))])
    store([_record(HAND, COUNTERS), later])
    run = _run(DEVICE + [("k4", 9.5, 22.0)], calls=2)
    # call 1: [2, 3], [6, 7], [7.5, 9]; call 2: [22, 29]
    assert _read("narrow_idle_ms", run) == pytest.approx((3500.0 + 7000.0) / 2)
    assert _read("narrow_batches_per_call", run) == 5
    assert _read("solver_launches_per_call", run) == 3.5
    assert _read("pack_launches_per_call", run) == 0.5
    # call 2 has no batch loop: call 1's 1.5 s over two calls
    assert _read("batches_idle_ms", run) == pytest.approx(750.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_refuse_a_record_count_that_does_not_match(store, monkeypatch, name):
    store([_record(HAND, COUNTERS)])
    assert _read(name, _run(DEVICE, calls=2)) is None
    # the records of later passes are left out: the first ``calls`` are read
    store([_record(HAND, COUNTERS)] * 3)
    assert _read(name, _run(DEVICE)) is not None
    # dropped records: the first ones are not the traced pass's
    store([_record(HAND, COUNTERS)], dropped=1)
    assert _read(name, _run(DEVICE)) is None
    # a device event before the first call: another pass's records
    store([_record(HAND, COUNTERS)])
    assert _read(name, _run(DEVICE + [("k0", -2.0, -1.0)])) is None
    # a program that keeps no records reads as nothing to read
    store([])
    assert _read(name, _run(DEVICE)) is None
    from scalable_ccd_tpu_torch.utils import profiler as profiler_mod

    monkeypatch.setattr(profiler_mod, "_profiler", object())
    assert _read(name, _run(DEVICE)) is None


def test_dry_run_reports_the_span_metrics(tmp_path):
    bench = _tiny_tree(tmp_path)
    line, _ = _dry_run(bench, "clothball.sim", 1)
    metrics = line["metrics"]
    for name in ("narrow_host_ms", "broad_host_ms"):
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms"
    assert metrics["narrow_batches_per_call"]["value"] >= 2
    # no device events on the CPU, and the plain versions launch no kernel
    for name in ("narrow_idle_ms", "batches_idle_ms", "solver_launches_per_call",
                 "pack_launches_per_call"):
        assert name not in metrics
    assert line["correct"] is True
