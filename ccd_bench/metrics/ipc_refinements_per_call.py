"""``ipc_refinements_per_call``: broad chunks per ``ipc_ccd_strategy`` call
that the IPC rule solved again (the program's ``ipc_refinements``
counter), from its records of the device-only traced pass
(:mod:`ccd_bench.spans`); none where the program keeps no such counter.
It shows that the rule runs; its value is set by the semantics and the
chunking, not by the speed.  Layer: API and host syncs."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None or not any("ipc_refinements" in r.counters for r in recs):
        return None
    return sum(r.counters.get("ipc_refinements", 0) for r in recs) / len(recs)
