"""The port's spans and counters (``scalable_ccd_tpu_torch/utils/profiler.py``)
on the CPU.

Off (no ``torch.profiler`` running, ``SCALABLE_CCD_PROFILE`` unset) a call
records nothing and enters no ``record_function``.  Under a profiler each
call of ``fused_ccd`` or ``ccd()`` leaves one record: its span tree, stamped
on the profiler's clock, and its counters, which must equal what the loop's
own arithmetic gives.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from scalable_ccd_tpu_torch import CCDConfig, CCDStats, MemoryConfig, ccd, fused_ccd, \
    ipc_ccd_strategy
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
from scalable_ccd_tpu_torch.ops._build import count_launch, launch_counts
from scalable_ccd_tpu_torch.pipeline import fused as port_fused
from scalable_ccd_tpu_torch.pipeline import narrow as port_narrow
from scalable_ccd_tpu_torch.utils import profiler as profiler_mod
from scalable_ccd_tpu_torch.utils.profiler import Profiler, profiler

torch.set_num_threads(2)

CPU = dict(device="cpu")
BATCH = 256

#: every span of fused_ccd and the span it sits in
PARENTS = {
    "sccd.upload": "sccd.fused_ccd", "sccd.boxes": "sccd.fused_ccd",
    "sccd.phase.vf": "sccd.fused_ccd", "sccd.phase.ee": "sccd.fused_ccd",
    "sccd.tables": ("sccd.phase.vf", "sccd.phase.ee"),
    "sccd.sweep": ("sccd.phase.vf", "sccd.phase.ee"),
    "sccd.narrow": ("sccd.phase.vf", "sccd.phase.ee"),
    "sccd.presample": "sccd.narrow", "sccd.pack": "sccd.narrow",
    "sccd.first_pass": "sccd.narrow", "sccd.batches": "sccd.narrow",
    "sccd.pool": "sccd.narrow",
}


@pytest.fixture(scope="module")
def cloth():
    s = cloth_on_sphere(grid_n=20, sphere_subdiv=2, drop=0.3, seed=1)
    return s.vertices_t0, s.vertices_t1, s.edges, s.faces


@pytest.fixture(autouse=True)
def _fresh():
    profiler().clear()
    yield
    profiler().clear()


def _traced(fn):
    """``(fn(), records, profile)`` of one run of ``fn`` under a CPU
    profile, inside a range of the caller's own, as the benchmark's traced
    window is: the profiler sets up its thread's store at its first event,
    which is then no span's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window"):
            out = fn()
    return out, profiler().records(), prof


def test_off_records_nothing_and_enters_no_record_function(cloth, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(profiler_mod, "record_function", refuse)
    res = fused_ccd(*cloth, narrow_batch=BATCH, **CPU)
    ccd(*cloth, **CPU)
    assert profiler().records() == [] and profiler().data() == {}
    assert not profiler().counting and int(res.vf_total) > 0


@pytest.mark.parametrize("kw,first_pass,pool", [
    ({}, True, True),                                   # frame pool (the default)
    ({"escalate_pool": "batch"}, True, False),          # the per-batch ladder
    ({"escalate_rounds": -1}, False, False),            # no escalation
])
def test_span_tree_of_fused_ccd(cloth, kw, first_pass, pool):
    (a, b), recs, _ = _traced(lambda: [fused_ccd(*cloth, narrow_batch=BATCH, **kw, **CPU)
                                       for _ in range(2)])
    assert len(recs) == 2 and int(a.vf_total) > 0
    for rec in recs:
        assert rec.entry == "fused_ccd" and rec.root.name == "sccd.fused_ccd"
        assert rec.root.parent is None and rec.root.start_ns < rec.root.end_ns
        names = {s.name for s in rec.spans}
        assert ("sccd.first_pass" in names) == first_pass
        assert ("sccd.pool" in names) == pool
        assert names >= set(PARENTS) - {"sccd.first_pass", "sccd.pool"}
        assert names <= set(PARENTS)
        for s in rec.spans:
            want = PARENTS[s.name]
            assert s.parent in (want if isinstance(want, tuple) else (want,)), s
            assert rec.root.start_ns <= s.start_ns <= s.end_ns <= rec.root.end_ns
        # the phase spans hold their children in time, VF before EE
        phases = [s for s in rec.spans if s.name.startswith("sccd.phase.")]
        assert [p.name for p in phases] == ["sccd.phase.vf", "sccd.phase.ee"]
        for s in rec.spans:
            if s.parent in ("sccd.phase.vf", "sccd.phase.ee"):
                p = phases[s.parent == "sccd.phase.ee"]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert sum(s.name == "sccd.narrow" for s in rec.spans) == 2


def test_exact_modes_record_the_narrow_span(cloth):
    hits = []
    _, recs, _ = _traced(lambda: fused_ccd(*cloth, collisions=hits, narrow_batch=BATCH, **CPU))
    (rec,) = recs
    names = [s.name for s in rec.spans]
    assert names.count("sccd.narrow") == 2 and "sccd.first_pass" not in names and hits


@pytest.mark.parametrize("presample", [True, False])
@pytest.mark.parametrize("pool", ["frame", "batch"])
def test_batches_counter_is_the_loop_arithmetic(cloth, presample, pool):
    res, (rec,), _ = _traced(lambda: fused_ccd(*cloth, narrow_batch=BATCH, presample=presample,
                                               escalate_pool=pool, **CPU))
    vf, ee = int(res.vf_total), int(res.ee_total)
    # auto budgets of at least 2^14 hold four batches: the presample runs
    want = 2 * presample + math.ceil(vf / BATCH) + math.ceil(ee / BATCH)
    assert vf > BATCH and rec.counters["batches"] == want


def test_budget_retries_counts_each_overflowing_phase(cloth, monkeypatch):
    monkeypatch.setattr(port_fused, "_AUTO_VF_GUESS", 0.01)
    monkeypatch.setattr(port_fused, "_AUTO_EE_GUESS", 0.01)
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MIN", 16)
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MEMO", {})
    (first, second), recs, _ = _traced(
        lambda: [fused_ccd(*cloth, narrow_batch=BATCH, **CPU) for _ in range(2)])
    assert int(first.vf_total) > 16 and int(first.ee_total) > 16
    assert not bool(first.overflowed) and not bool(second.overflowed)
    assert [r.counters.get("budget_retries", 0) for r in recs] == [2, 0]


def test_spans_match_the_profile_events(cloth):
    _, recs, prof = _traced(lambda: fused_ccd(*cloth, narrow_batch=BATCH, **CPU))
    (rec,) = recs
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sccd."):
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = sorted([rec.root] + rec.spans, key=lambda s: s.start_ns)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == set(events)
    for name, mine in by_name.items():
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for s, (a, b) in zip(mine, theirs):
            assert abs(s.start_ns - a) <= 50_000, (s, a)
            assert abs(s.end_ns - b) <= 50_000, (s, b)


def test_ccd_spans_record_and_time_without_a_sync(cloth, monkeypatch):
    _, (rec,), _ = _traced(lambda: ccd(*cloth, **CPU))
    assert rec.entry == "ccd" and rec.root.name == "sccd.ccd"
    top = [s.name for s in rec.spans if s.parent == "sccd.ccd"]
    assert top == ["sccd.upload", "sccd.boxes", "sccd.phase.vf", "sccd.phase.ee"]
    assert {s.parent for s in rec.spans} == {"sccd.ccd", "sccd.phase.vf", "sccd.phase.ee"}

    def refuse(*_a, **_k):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    prof = Profiler()
    prof.enable()
    with prof.span("stage", device="cuda"):
        with prof.span("inner"):
            pass
    node = prof.data()["stage"]
    assert node["device"] is True and node["inner"]["device"] is True
    assert node["time_ms"] >= node["inner"]["time_ms"] >= 0.0
    assert prof.records() == []


#: every span of ccd() and the span it sits in
CCD_PARENTS = {
    "sccd.upload": "sccd.ccd", "sccd.boxes": "sccd.ccd",
    "sccd.phase.vf": "sccd.ccd", "sccd.phase.ee": "sccd.ccd",
    "sccd.sweep": ("sccd.phase.vf", "sccd.phase.ee"),
    "sccd.narrow": ("sccd.phase.vf", "sccd.phase.ee"),
    "sccd.presample": ("sccd.narrow", "sccd.ipc_refine"), "sccd.ipc_refine": "sccd.narrow",
}


def _touching_rig():
    """``tests/test_pipeline.py:231-258``: a still unit triangle and a
    vertex that starts inside a 0.05 separation of it and crosses its plane
    at t = 1/3."""
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    v0 = np.concatenate([tri, [[0.25, 0.25, 0.01]]])
    v1 = v0.copy()
    v1[3, 2] -= 0.03
    faces = np.arange(3, dtype=np.int32)[None]
    edges = np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int32)
    return v0, v1, edges, faces


@pytest.mark.parametrize("scene", ["rig", "cloth"])
def test_ipc_ccd_strategy_leaves_one_ccd_record(cloth, monkeypatch, scene):
    """A profiled ``ipc_ccd_strategy`` call (the chunked path) leaves one
    record of ``ccd()``, whose root opens before the upload and every other
    span; its ``chunk_solves`` counter is the chunks solved in one launch
    (one a ``sccd.narrow`` span), its ``batches`` counter the other solves
    (the re-solve's batches) and its ``ipc_refinements`` the call's own
    count: on the touching rig, and on the cloth in batches of 64
    candidates, where a chunk solved in one launch takes no warm-start
    batch (only a re-solved chunk of more than 256 does)."""
    solved = []

    def counting(name):
        real = getattr(port_narrow.NarrowSolver, name)

        def counted(self, pairs, *a, **kw):
            solved.append(pairs.shape[0])
            return real(self, pairs, *a, **kw)

        monkeypatch.setattr(port_narrow.NarrowSolver, name, counted)

    counting("solve")
    counting("solve_pairs")
    stats = CCDStats()
    if scene == "rig":
        args, kw = _touching_rig(), dict(min_distance=0.05)
    else:
        args = cloth
        kw = dict(min_distance=1e-3, config=CCDConfig(memory=MemoryConfig(
            box_chunk_size=256, query_buckets=(64,))))
    toi, (rec,), _ = _traced(lambda: ipc_ccd_strategy(*args, stats=stats, **kw, **CPU))
    assert rec.entry == "ccd" and rec.root.name == "sccd.ccd" and rec.root.parent is None
    assert all(rec.root.start_ns < s.start_ns <= s.end_ns <= rec.root.end_ns
               for s in rec.spans)
    names = [s.name for s in rec.spans]
    assert names[:2] == ["sccd.upload", "sccd.boxes"] and set(names) <= set(CCD_PARENTS)
    for s in rec.spans:
        want = CCD_PARENTS[s.name]
        assert s.parent in (want if isinstance(want, tuple) else (want,)), s
    assert rec.counters.get("batches", 0) + rec.counters["chunk_solves"] == len(solved) > 0
    assert rec.counters["chunk_solves"] == names.count("sccd.narrow")
    assert rec.counters.get("ipc_refinements", 0) == stats.ipc_refinements
    assert names.count("sccd.ipc_refine") == stats.ipc_refinements
    if scene == "rig":
        assert stats.ipc_refinements == 1 and toi == pytest.approx(0.8 / 3.0, rel=1e-3)
    else:
        assert names.count("sccd.sweep") >= 4 and rec.counters["chunk_solves"] >= 4
        assert all(s.parent == "sccd.ipc_refine" for s in rec.spans
                   if s.name == "sccd.presample")


def test_profile_tree_of_fused_ccd(cloth):
    prof = profiler()
    prof.enable()
    try:
        fused_ccd(*cloth, narrow_batch=BATCH, **CPU)
        tree = prof.data()["sccd.fused_ccd"]
    finally:
        prof.disable()
    assert tree["device"] is False and prof.records() == []
    narrow = tree["sccd.phase.vf"]["sccd.narrow"]
    assert {"sccd.presample", "sccd.pack", "sccd.first_pass", "sccd.batches",
            "sccd.pool"} <= set(narrow)
    ee = tree["sccd.phase.ee"]
    assert tree["time_ms"] >= ee["time_ms"] >= ee["sccd.narrow"]["time_ms"] > 0.0


def _tree_counters(node, into=None):
    """Every ``"counters"`` dict of a profile tree, summed by name."""
    into = {} if into is None else into
    for key, val in node.items():
        if key == "counters":
            for name, n in val.items():
                into[name] = into.get(name, 0) + n
        elif isinstance(val, dict):
            _tree_counters(val, into)
    return into


def test_profile_tree_holds_the_counters(cloth, monkeypatch):
    monkeypatch.setattr(port_fused, "_AUTO_VF_GUESS", 0.01)
    monkeypatch.setattr(port_fused, "_AUTO_EE_GUESS", 0.01)
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MIN", 16)
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MEMO", {})
    prof = profiler()
    prof.enable()
    try:
        _, (rec,), _ = _traced(lambda: fused_ccd(*cloth, narrow_batch=BATCH, **CPU))
        tree = prof.data()["sccd.fused_ccd"]
        first = _tree_counters(tree)
        # the call's counters, each where it counted; the retry in each sweep
        assert first == rec.counters and first["budget_retries"] == 2
        for phase in ("sccd.phase.vf", "sccd.phase.ee"):
            assert tree[phase]["sccd.sweep"]["counters"] == {"budget_retries": 1}
        assert tree["sccd.phase.vf"]["sccd.narrow"]["counters"]["batches"] > 0
        # with no profiler running the tree counts alone; the memo holds
        fused_ccd(*cloth, narrow_batch=BATCH, **CPU)
        second = _tree_counters(prof.data()["sccd.fused_ccd"])
    finally:
        prof.disable()
    assert second["budget_retries"] == 2 and second["batches"] == 2 * first["batches"]
    assert prof.records() == [rec]


def test_launch_counter_of_the_open_call():
    table = launch_counts("solver", "global", "round_limit")
    prof = profiler()
    count_launch(table, ["global"], False)
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("sccd.fused_ccd", entry="fused_ccd"):
            count_launch(table, ["global"], False)
            count_launch(table, ["round_limit"], True)
            count_launch(table, ["round_limit"], True)
    (rec,) = prof.records()
    assert rec.counters == {"launch.solver.global": 1, "launch.solver.round_limit_f64": 2}
    assert table.kernel == "solver" and table.total == 4 and table["round_limit_f64"] == 2


def test_the_store_keeps_the_newest_calls(monkeypatch):
    monkeypatch.setattr(profiler_mod, "MAX_CALLS", 3)
    prof = Profiler()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with prof.span("sccd.fused_ccd", entry="fused_ccd"):
                prof.count("batches", i)
                # a nested entry is a span of the open call
                with prof.span("sccd.fused_ccd", entry="fused_ccd"):
                    pass
    recs = prof.records()
    assert [r.counters["batches"] for r in recs] == [2, 3, 4] and prof.dropped == 2
    assert all(len(r.spans) == 1 and r.spans[0].parent == "sccd.fused_ccd" for r in recs)
    prof.count("batches")
    prof.clear()
    assert prof.records() == [] and prof.dropped == 0
