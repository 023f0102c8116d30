"""``narrow_batches_per_call``: narrow batches the program cut per call,
the presample's included (its ``batches`` counter, counted on the host
where each chunk's batches are decided), from its records of the
device-only traced pass (:mod:`ccd_bench.spans`).  Layer: solver."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None:
        return None
    return sum(r.counters.get("batches", 0) for r in recs) / len(recs)
