"""``batches_idle_ms``: ms per call in which the card ran nothing while the
host was inside the program's ``sccd.batches`` spans, the per-batch loops
of the narrow phase (``pipeline/fused.py``: ``NarrowSolver.solve_chunk``
and ``_frame_pool_loop``), from the device-only traced pass's idle
intervals within each call's root span (:mod:`ccd_bench.spans`).  The rest
of ``narrow_idle_ms`` is the presample's, the packs', the escalation's
first passes' and the frame pool's.  Layer: device."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None or not run.trace.device:
        return None
    return 1000.0 * spans.idle_in_spans_s(run, recs, ("sccd.batches",)) / len(recs)
