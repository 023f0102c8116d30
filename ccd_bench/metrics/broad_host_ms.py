"""``broad_host_ms``: host ms per call inside the program's ``sccd.upload``,
``sccd.boxes`` and ``sccd.sweep`` spans (``pipeline/fused.py``: checks,
validation and upload of the positions, box build and sort, both phases'
sweeps with their totals read and budget retries), from the program's own
records of the device-only traced pass (:mod:`ccd_bench.spans`).  Layer:
PyTorch glue."""

from ccd_bench import spans

NAMES = ("sccd.upload", "sccd.boxes", "sccd.sweep")


def read(run):
    recs = spans.call_records(run)
    if recs is None:
        return None
    return 1000.0 * sum(spans.span_s(r, NAMES) for r in recs) / len(recs)
