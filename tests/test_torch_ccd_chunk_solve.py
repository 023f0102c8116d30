"""``ccd()``'s global solves on the CPU: each broad chunk solved on the
device with one host read (``pipeline/ccd.py``), held to the per-batch
paths they replace.

A bounded solve is one kernel B launch over the chunk's pairs
(``ops/solver.py:solve_pairs``); an unbounded one, and the IPC rule's
re-solve, its warm-start batch and batches seeded from the device TOI.
The per-batch path here (:func:`_per_batch`) is the loop ``ccd()`` ran
before, less the warm-start batch of a bounded solve, which the one launch
drops: per broad chunk batches of ``query_buckets[-1]`` candidates, each
packed by kernel C's plain twin and solved from the TOI read on the host
after the batch before, stopping at a TOI of 0, and the IPC rule's re-solve
the same way with its warm-start batch.  On the CPU ``solve_pairs`` solves
its pairs in batches of that size too, so the TOI and the checks are equal
bit for bit; the counters ``chunk_solves``, ``batches`` and
``ipc_refinements`` follow the loop's arithmetic, except that a batch after
the TOI reached 0 inside a chunk is now launched and skips on the device.
"""

import os

import numpy as np
import pytest
import torch

from scalable_ccd_tpu_torch import CCDConfig, CCDStats, MemoryConfig, ccd, ipc_ccd_strategy
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb, edges_from_faces, read_ply
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
from scalable_ccd_tpu_torch.narrow_phase import types
from scalable_ccd_tpu_torch.ops import gather_pack as gp
from scalable_ccd_tpu_torch.ops import solver
from scalable_ccd_tpu_torch.ops.sweep_ap import sweep_pairs
from scalable_ccd_tpu_torch.pipeline.ccd import sweep_chunks
from scalable_ccd_tpu_torch.pipeline.narrow import IPC_BACKOFF, IPC_MIN_TOI, NarrowSolver
from scalable_ccd_tpu_torch.pipeline.policy import (
    CONGESTION_MIN_BOXES,
    mesh_tensors,
    resolve_auto_escalation,
)
from scalable_ccd_tpu_torch.utils.profiler import profiler

torch.set_num_threads(2)

TOL = 1e-6
#: chunks of 256 boxes in batches of 64 candidates: several batches a
#: chunk, and a warm-start batch in every chunk of more than 256
MEMORY = MemoryConfig(box_chunk_size=256, query_buckets=(64,))
PRECISIONS = {"f32": dict(), "f64": dict(dtype="float64"),
              "compensated": dict(precision="compensated")}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def touching():
    """``cloth_on_sphere(20, 2)`` advanced to 99% of its first contact, so
    that a 1e-3 separation is crossed at once and the IPC rule re-solves
    the chunks that hold it."""
    s = cloth_on_sphere(grid_n=20, sphere_subdiv=2, drop=0.3, seed=1)
    v0, v1 = np.asarray(s.vertices_t0), np.asarray(s.vertices_t1)
    toi = ccd(v0, v1, s.edges, s.faces, device="cpu")
    assert 0.0 < toi < 1.0
    return v0 + 0.99 * toi * (v1 - v0), v1, s.edges, s.faces


@pytest.fixture(scope="module")
def dense():
    """The ``dense-cluster`` golden frames: in f32 the TOI reaches 0 inside
    the one EE chunk, with batches of that chunk still to come."""
    frame = [read_ply(os.path.join(GOLDEN, "dense-cluster", "frames", f"f{k}.ply"))
             for k in (0, 1)]
    (v0, f), (v1, _) = frame
    return v0, v1, edges_from_faces(f), f


def _per_batch(args, min_distance, max_iterations, config, ipc_refine):
    """The per-batch path on the CPU: ``(toi, counts)``, counts the checks,
    the capped batches, the candidates, the non-empty chunks, the batches
    (the re-solve's alone for a bounded solve, its warm-start batch
    included), and the refinements."""
    v0, v1, e, f = mesh_tensors(*args, torch.device("cpu"), False)
    vb = aabb.build_vertex_boxes(v0, v1, inflation_radius=min_distance,
                                 dtype=config.torch_dtype)
    phases = ((True, sort_boxes(merge_two_lists(vb, aabb.build_face_boxes(vb, f)))),
              (False, sort_boxes(aabb.build_edge_boxes(vb, e))))
    mem = config.memory
    max_b = mem.query_buckets[-1]
    compensated = config.precision == "compensated"
    round_limit = resolve_auto_escalation(
        config.escalate_rounds, max_iterations,
        plain_f32=config.dtype == "float32" and not compensated)
    counts = dict(checks=0, capped=0, vf=0, ee=0, chunks=0, batches=0, refinements=0)
    toi = 1.0
    for is_vf, sb in phases:
        if toi <= 0:
            break
        nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, min_distance, TOL, True,
                                     max_iterations, round_limit, config.torch_dtype,
                                     compensated)
        presample = (sb.n < CONGESTION_MIN_BOXES if config.presample == "auto"
                     else config.presample)

        def chunk(pairs, count, toi, exact):
            batches = [pairs[s:min(s + max_b, count)] for s in range(0, count, max_b)]
            warm = exact or max_iterations < 0
            if presample and warm and count > 4 * max_b:
                idx = np.minimum(np.arange(max_b) * count // max_b, count - 1)
                toi = solve(pairs[torch.as_tensor(idx)], toi, exact)
            for b in batches:
                if toi <= 0:
                    break
                toi = solve(b, toi, exact)
            return toi

        def solve(batch, toi, exact):
            counts["batches"] += exact or max_iterations < 0
            out = nar.solve(batch, toi, exact=exact)
            counts["checks"] += int(out[2])
            counts["capped"] += int(out[1])
            return float(out[0])

        for pairs, count in sweep_chunks(sb, is_vf, mem.box_chunk_size, mem.pair_chunk_size):
            if count == 0:
                continue
            counts["chunks"] += 1
            counts["vf" if is_vf else "ee"] += count
            before = toi
            toi = chunk(pairs, count, toi, False)
            if ipc_refine and toi < IPC_MIN_TOI:
                counts["refinements"] += 1
                toi = chunk(pairs, count, before, True) * IPC_BACKOFF
            if toi <= 0:
                break
    return toi, counts


def _counters(tree, into=None):
    """Every counter of a profile tree, summed by name."""
    into = {} if into is None else into
    for key, val in tree.items():
        if key == "counters":
            for name, n in val.items():
                into[name] = into.get(name, 0) + n
        elif isinstance(val, dict):
            _counters(val, into)
    return into


def _profiled(fn):
    prof = profiler()
    prof.clear()
    prof.enable()
    try:
        out = fn()
        counters = _counters(prof.data()["sccd.ccd"])
    finally:
        prof.disable()
        prof.clear()
    return out, counters


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
@pytest.mark.parametrize("min_distance", [0.0, 1e-3])
@pytest.mark.parametrize("entry", ["ccd", "ipc_ccd_strategy"])
def test_chunk_solve_equals_the_per_batch_path(touching, entry, min_distance, precision):
    """The TOI and the checks of the per-batch path bit for bit, in VF and
    EE chunks; ``chunk_solves`` the non-empty chunks, ``batches`` the
    re-solve's batches alone, ``ipc_refinements`` exact."""
    config = CCDConfig(memory=MEMORY, **PRECISIONS[precision])
    ipc = entry == "ipc_ccd_strategy"
    stats = CCDStats()
    if ipc:
        run = lambda: ipc_ccd_strategy(*touching, min_distance=min_distance,  # noqa: E731
                                       config=config, stats=stats, device="cpu")
    else:
        run = lambda: ccd(*touching, min_distance=min_distance,  # noqa: E731
                          max_iterations=1_000_000, config=config, stats=stats,
                          device="cpu")
    got, counters = _profiled(run)
    want, counts = _per_batch(touching, min_distance, 1_000_000, config, ipc)
    assert got == want and stats.narrow_checks == counts["checks"] > 0
    assert counters["chunk_solves"] == counts["chunks"] > 0
    assert counters.get("batches", 0) == counts["batches"]
    assert counters.get("ipc_refinements", 0) == stats.ipc_refinements == counts["refinements"]
    assert stats.overflow_queries == 0 and stats.vf_candidates > 0
    if ipc and min_distance > 0:
        # the separation is crossed: chunks are re-solved, the TOI backed off
        assert stats.ipc_refinements > 0 and 0.0 < got < 1.0 and stats.ee_candidates > 0
    elif min_distance > 0:
        assert got == 0.0 and stats.ee_candidates == 0  # VF stops at a zero TOI
    else:
        assert stats.ipc_refinements == 0 and got > 0.0 and stats.ee_candidates > 0


@pytest.mark.parametrize("cap", [10, 100])
def test_chunk_solve_with_a_binding_cap_equals_the_per_batch_path(touching, cap):
    """Caps of 10 and 100 checks a query, which bind on these candidates:
    on the CPU the chunk's batches run in the per-batch path's order, so the
    TOI, the checks and the capped launches follow it."""
    config = CCDConfig(memory=MEMORY)
    stats = CCDStats()
    got = ccd(*touching, max_iterations=cap, config=config, stats=stats, device="cpu")
    want, counts = _per_batch(touching, 0.0, cap, config, False)
    assert got == want and stats.narrow_checks == counts["checks"] > 0


@pytest.mark.parametrize("presample", [True, False])
@pytest.mark.parametrize("rounds", [-2, -1, (2, 8)], ids=["auto", "off", "ladder"])
@pytest.mark.parametrize("scene", ["touching", "dense"])
def test_unbounded_chunk_equals_the_per_batch_path(request, scene, rounds, presample):
    """An unbounded global solve (no cap; escalation at the auto 128 rounds,
    off, or a ladder), with and without the warm-start batch: the TOI, the
    candidates, the checks and the capped batches of the per-batch path
    bit for bit, and no chunk solved in one launch.  Where the TOI stays
    above 0 the ``batches`` counter is the loop's; on ``dense-cluster`` it
    reaches 0 inside a chunk, and the chunk's later batches are launched
    and skipped on the device, adding launches and no checks."""
    args = request.getfixturevalue(scene)
    config = CCDConfig(memory=MEMORY, escalate_rounds=rounds, presample=presample)
    stats = CCDStats()
    got, counters = _profiled(lambda: ccd(*args, config=config, stats=stats, device="cpu"))
    want, counts = _per_batch(args, 0.0, -1, config, False)
    assert got == want
    assert (stats.vf_candidates, stats.ee_candidates) == (counts["vf"], counts["ee"])
    assert stats.narrow_checks == counts["checks"] > 0
    assert stats.overflow_queries == counts["capped"]
    assert "chunk_solves" not in counters
    if scene == "touching":
        assert got > 0.0 and counters["batches"] == counts["batches"]
    else:
        assert got == 0.0 and counters["batches"] > counts["batches"]


def _phase_pairs(args, is_vf, dtype, compensated):
    """``(pairs, n, vcat, table)`` of one phase of ``args`` on the CPU."""
    v0, v1, e, f = mesh_tensors(*args, torch.device("cpu"), False)
    vb = aabb.build_vertex_boxes(v0, v1, dtype=dtype)
    boxes = merge_two_lists(vb, aabb.build_face_boxes(vb, f)) if is_vf else \
        aabb.build_edge_boxes(vb, e)
    pairs, n, _, _ = sweep_pairs(sort_boxes(boxes), is_vf, 1 << 16)
    vcat = types.concat_frames(v0, v1, dtype)
    table = types.pack_face_table(vcat, f) if is_vf else types.pack_edge_table(vcat, e)
    return pairs, int(n), vcat, table


@pytest.mark.parametrize("ms", [0.0, 1e-3])
@pytest.mark.parametrize("kind", sorted(PRECISIONS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_solve_pairs_equals_pack_and_solve(touching, is_vf, kind, ms):
    """``solve_pairs`` on the CPU: kernel C's plain twin followed by kernel
    B's, bit for bit, in one batch and in batches seeded one from the other;
    an empty range returns its seed, and a seed of 0 skips."""
    dtype = torch.float64 if kind == "f64" else torch.float32
    comp = kind == "compensated"
    pairs, n, vcat, table = _phase_pairs(touching, is_vf, dtype, comp)
    assert n > 300
    start, stop = 7, n - 3
    cols = gp.gather_pack_reference(pairs, start, stop, vcat, table, is_vf, ms, TOL, comp)
    valid = torch.ones((stop - start,), dtype=torch.bool)
    want = solver.solve_packed_reference(cols.t(), valid, is_vf, 1.0, TOL,
                                         max_iterations=1_000_000, widened=comp)
    got = solver.solve_pairs(pairs, start, stop, vcat, table, is_vf, 1.0, ms, TOL,
                             compensated=comp, batch=1 << 20)
    assert [t.item() for t in got] == [t.item() for t in want]
    assert got[0].dtype == (torch.float64 if comp else dtype)
    toi, checks = torch.tensor(1.0, dtype=got[0].dtype), 0
    for s in range(start, stop, 100):
        part = gp.gather_pack_reference(pairs, s, min(s + 100, stop), vcat, table, is_vf, ms,
                                        TOL, comp)
        toi, _, c = solver.solve_packed_reference(
            part.t(), torch.ones((part.shape[1],), dtype=torch.bool), is_vf, toi, TOL,
            max_iterations=1_000_000, widened=comp)
        checks += int(c)
    batched = solver.solve_pairs(pairs, start, stop, vcat, table, is_vf, 1.0, ms, TOL,
                                 compensated=comp, batch=100)
    assert batched[0].item() == toi.item() and int(batched[2]) == checks
    empty = solver.solve_pairs(pairs, 5, 5, vcat, table, is_vf, 0.25, ms, TOL,
                               compensated=comp)
    assert empty[0].item() == 0.25 and int(empty[2]) == 0 and not bool(empty[1])
    skipped = solver.solve_pairs(pairs, start, stop, vcat, table, is_vf, 0.0, ms, TOL,
                                 compensated=comp, skip_if_done=True)
    assert skipped[0].item() == 0.0 and int(skipped[2]) == 0


