"""A phase of candidate pairs solved in one unbounded launch, on the CPU.

On CUDA, ``fused_ccd``'s global solve with neither a cap nor escalation
solves a :class:`PairStream`'s whole phase in one launch of kernel B's
shared form, whose threads compute the rows from the pairs
(``NarrowSolver.solve_phase``), where it packed and solved the phase chunk
by chunk before (``NarrowSolver.solve_chunk`` over ``PairStream.cols``).
Here the plain twins of both paths run on the same candidates: the global
TOI is a minimum over the queries, so the TOI and the overflow flag agree
bit for bit, whatever the split into launches (only the checks differ).
"""

import numpy as np
import pytest
import torch

from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
from scalable_ccd_tpu_torch.ops import gather_pack as gp
from scalable_ccd_tpu_torch.ops import solver
from scalable_ccd_tpu_torch.ops.sweep_ap import sweep_pairs
from scalable_ccd_tpu_torch.ops.sweep_records import sweep_records
from scalable_ccd_tpu_torch.pipeline.narrow import NarrowSolver, PairStream, RecordStream
from scalable_ccd_tpu_torch.pipeline.policy import mesh_tensors
from scalable_ccd_tpu_torch.utils.profiler import profiler

torch.set_num_threads(2)

TOL = 1e-6
#: batches of 64 candidates, chunks of three of them
BATCH = 64
PRECISIONS = {"f32": (torch.float32, False), "f64": (torch.float64, False),
              "compensated": (torch.float32, True)}


@pytest.fixture(scope="module")
def frames():
    """``cloth_on_sphere(20, 2)`` moving into contact (``contact``, a TOI
    inside (0, 1)) and the same cloth stopped halfway to its first contact
    (``clear``, TOI 1)."""
    s = cloth_on_sphere(grid_n=20, sphere_subdiv=2, drop=0.3, seed=1)
    v0, v1 = np.asarray(s.vertices_t0), np.asarray(s.vertices_t1)
    toi = float(fused_ccd(v0, v1, s.edges, s.faces, device="cpu").toi)
    assert 0.0 < toi < 1.0
    return {"contact": (v0, v1, s.edges, s.faces),
            "clear": (v0, v0 + 0.5 * toi * (v1 - v0), s.edges, s.faces)}


def _stream(args, is_vf, kind, monkeypatch):
    """A phase's :class:`PairStream` of ``args`` on the CPU, in chunks of
    three batches of :data:`BATCH`, and its narrow solver at the defaults
    (no cap, no escalation)."""
    dtype, comp = PRECISIONS[kind]
    monkeypatch.setattr(gp, "CHUNK_ROWS", 3 * BATCH + 5)
    v0, v1, e, f = mesh_tensors(*args, torch.device("cpu"), False)
    vb = aabb.build_vertex_boxes(v0, v1, dtype=dtype)
    boxes = merge_two_lists(vb, aabb.build_face_boxes(vb, f)) if is_vf else \
        aabb.build_edge_boxes(vb, e)
    sb = sort_boxes(boxes)
    pairs, n, _, _ = sweep_pairs(sb, is_vf, 1 << 16)
    nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, 0.0, TOL, True, -1, -1, dtype, comp)
    return PairStream(pairs, int(n), nar, BATCH), sb


def _chunked(stream, toi):
    """The phase chunk by chunk, as ``fused_ccd`` ran it on CUDA before:
    kernel C's twin packs each chunk, one unbounded solve each."""
    ovf = torch.zeros((), dtype=torch.bool)
    for c0 in range(0, stream.n, stream.chunk):
        toi, o, _ = stream.nar.solve_chunk(stream.cols(c0, min(c0 + stream.chunk, stream.n)),
                                           toi, stream.batch)
        ovf = ovf | o
    return toi, ovf


def _counted(fn):
    """``(fn(), counters)``: the profiler's counters of what ``fn`` ran."""
    prof = profiler()
    prof.clear()
    prof.enable()
    try:
        out = fn()
        counters = dict(prof.data().get("counters", {}))
    finally:
        prof.disable()
        prof.clear()
    return out, counters


@pytest.mark.parametrize("frame", ["contact", "clear"])
@pytest.mark.parametrize("kind", sorted(PRECISIONS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_phase_in_one_launch_equals_its_chunks(frames, monkeypatch, is_vf, kind, frame):
    """The unbounded pairs solve of the whole phase (its plain twin) against
    the chunked columns path on the same candidates, from a TOI of 1: the
    TOI and the overflow flag bit for bit, with a pair count that is no
    multiple of the chunk; one launch counted in ``chunk_solves``."""
    stream, _ = _stream(frames[frame], is_vf, kind, monkeypatch)
    n, chunk = stream.n, stream.chunk
    assert chunk == 3 * BATCH and n > 2 * chunk and n % chunk
    one = torch.ones((), dtype=PRECISIONS[kind][0])
    want_toi, want_ovf = _chunked(stream, one)
    (toi, ovf, checks), counters = _counted(lambda: stream.nar.solve_phase(stream, one))
    assert toi.dtype == want_toi.dtype
    assert toi.item().hex() == want_toi.item().hex()
    assert bool(ovf) == bool(want_ovf) and int(checks) > 0
    assert counters == {"chunk_solves": 1}
    if frame == "clear":
        assert toi.item() == 1.0
    else:
        assert 0.0 < toi.item() < 1.0


@pytest.mark.parametrize("kind", sorted(PRECISIONS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_phase_solve_from_a_zero_toi_does_nothing(frames, monkeypatch, is_vf, kind):
    """Seeded with a TOI of 0 (the loop's exit), the phase's launch
    evaluates nothing and returns the seed; on the CPU, and for a stream of
    records, a global solve keeps its chunks (``whole_phase`` is false)."""
    stream, sb = _stream(frames["contact"], is_vf, kind, monkeypatch)
    zero = torch.zeros((), dtype=PRECISIONS[kind][0])
    toi, ovf, checks = stream.nar.solve_phase(stream, zero)
    assert toi.item() == 0.0 and not bool(ovf) and int(checks) == 0
    rec, n_rec, _, _ = sweep_records(sb, is_vf, 1 << 16)
    records = RecordStream(sb, rec, int(n_rec), 1 << 16, is_vf, stream.nar, BATCH)
    assert not stream.nar.whole_phase(stream) and not stream.nar.whole_phase(records)


@pytest.mark.parametrize("kind", sorted(PRECISIONS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_solve_pairs_unbounded_equals_pack_and_solve(frames, monkeypatch, is_vf, kind):
    """``solve_pairs`` with no cap on the CPU: kernel C's plain twin
    followed by kernel B's unbounded one, bit for bit in the TOI, the
    overflow flag and the checks, over a range that starts and stops inside
    the buffer."""
    stream, _ = _stream(frames["contact"], is_vf, kind, monkeypatch)
    nar, start, stop = stream.nar, 7, stream.n - 3
    cols = gp.gather_pack_reference(stream.pairs, start, stop, nar.vcat, nar.table, is_vf, 0.0,
                                    TOL, nar.compensated)
    want = solver.solve_packed_reference(cols.t(), torch.ones((stop - start,), dtype=torch.bool),
                                         is_vf, 1.0, TOL, widened=nar.compensated)
    got = solver.solve_pairs(stream.pairs, start, stop, nar.vcat, nar.table, is_vf, 1.0, 0.0,
                             TOL, max_iterations=-1, compensated=nar.compensated, batch=1 << 20)
    assert [t.item() for t in got] == [t.item() for t in want] and int(got[2]) > 0
