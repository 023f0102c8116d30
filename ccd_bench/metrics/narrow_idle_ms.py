"""``narrow_idle_ms``: ms per call in which the card ran nothing while the
host was inside the program's ``sccd.narrow`` spans: the idle intervals of
the device-only traced pass (the complement of the union of its device
events within each call's root span ``sccd.fused_ccd``) intersected with
those spans (:mod:`ccd_bench.spans`).  Layer: device."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None or not run.trace.device:
        return None
    return 1000.0 * spans.idle_in_spans_s(run, recs, ("sccd.narrow",)) / len(recs)
