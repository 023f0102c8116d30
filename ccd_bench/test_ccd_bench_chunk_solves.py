"""CPU tests of ``metrics/chunk_solves_per_call.py``, the reader of the
program's ``chunk_solves`` counter.

    python -m pytest ccd_bench/test_ccd_bench_chunk_solves.py -q
"""

from __future__ import annotations

import pytest

from ccd_bench.test_ccd_bench_spans import (  # noqa: F401  (store is a fixture)
    COUNTERS, DEVICE, HAND, _read, _record, _run, store)


def test_counts_per_call(store):
    store([_record(HAND, {**COUNTERS, "chunk_solves": 7})])
    assert _read("chunk_solves_per_call", _run(DEVICE)) == 7
    # a call that solved no chunk in one launch counts 0
    store([_record(HAND, {**COUNTERS, "chunk_solves": 7}), _record(HAND, COUNTERS)])
    assert _read("chunk_solves_per_call", _run(DEVICE, calls=2)) == pytest.approx(3.5)


def test_nothing_to_read_without_the_counter(store):
    # a program that counts batches but keeps no chunk_solves counter
    store([_record(HAND, COUNTERS)])
    assert _read("chunk_solves_per_call", _run(DEVICE)) is None
    # a record count that is not the traced pass's, or no records at all
    store([_record(HAND, {"chunk_solves": 3})])
    assert _read("chunk_solves_per_call", _run(DEVICE, calls=2)) is None
    store([])
    assert _read("chunk_solves_per_call", _run(DEVICE)) is None
