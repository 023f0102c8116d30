"""``solver_launches_per_call``: kernel B launches per call, every mode
(the program's ``launch.solver.*`` counters, ``ops/_build.py:
count_launch``), from its records of the device-only traced pass
(:mod:`ccd_bench.spans`); none where the plain versions ran.  Layer:
solver."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None:
        return None
    n = sum(spans.counter_sum(r, "launch.solver.") for r in recs)
    return n / len(recs) if n else None
