"""``pack_launches_per_call``: kernel C launches per call, every mode (the
program's ``launch.gather_pack.*`` counters, ``ops/_build.py:
count_launch``: one per chunk of a phase's candidates, and the presample's
and exact modes' own packs), from its records of the device-only traced
pass (:mod:`ccd_bench.spans`); none where the plain versions ran.  Layer:
gather and pack: kernel C."""

from ccd_bench import spans


def read(run):
    recs = spans.call_records(run)
    if recs is None:
        return None
    n = sum(spans.counter_sum(r, "launch.gather_pack.") for r in recs)
    return n / len(recs) if n else None
