"""``chunk_solves_per_call``: chunks of a phase's candidates the program
solved with one unbounded kernel B launch each, per call (its
``chunk_solves`` counter, counted on the host where a chunk's solve is
decided), from its records of the device-only traced pass
(:mod:`ccd_bench.spans`); none where the program keeps no such counter.
Layer: solver."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None or not any("chunk_solves" in r.counters for r in recs):
        return None
    return sum(r.counters.get("chunk_solves", 0) for r in recs) / len(recs)
