"""``narrow_host_ms``: host ms per call inside the program's ``sccd.narrow``
spans, both phases (``pipeline/fused.py``: chunk packs, the escalation's
first pass, the per-batch loop, the frame pool), from the program's own
records of the device-only traced pass (:mod:`ccd_bench.spans`).  Layer:
PyTorch glue."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None:
        return None
    return 1000.0 * sum(spans.span_s(r, ("sccd.narrow",)) for r in recs) / len(recs)
