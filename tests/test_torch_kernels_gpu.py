"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips elsewhere.  The
file imports no jax, so it also runs where only PyTorch is installed:
``python -m pytest tests/test_torch_kernels_gpu.py -m cuda --noconftest -q``
(``--noconftest`` skips the suite's jax setup).
"""

import numpy as np
import pytest
import torch

from scalable_ccd_tpu_torch import CCDStats, ccd, fused_ccd, ipc_ccd_strategy
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb, scenes
from scalable_ccd_tpu_torch.interop import from_numpy_scene
from scalable_ccd_tpu_torch.narrow_phase import types
from scalable_ccd_tpu_torch.ops import gather_pack as gp
from scalable_ccd_tpu_torch.ops import solver, sweep_ap, sweep_records
from scalable_ccd_tpu_torch.pipeline.narrow import NarrowSolver, PairStream, RecordStream

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scene():
    return scenes.cloth_on_sphere(grid_n=16, sphere_subdiv=2, drop=0.3)


def _sorted(device, two_lists):
    s = from_numpy_scene(_scene(), device)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    if two_lists:
        return sort_boxes(merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)))
    return sort_boxes(aabb.build_edge_boxes(vb, s.edges))


def _set(pairs, n):
    return set(map(tuple, pairs[: int(n)].cpu().numpy().tolist()))


@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_kernel_equals_plain(cuda, two_lists):
    sb = _sorted(cuda, two_lists)
    before = sweep_ap.LAUNCHES_BY_MODE.total
    k = sweep_ap.sweep_pairs(sb, two_lists, 1 << 16)
    torch.cuda.synchronize()
    assert sweep_ap.LAUNCHES_BY_MODE.total == before + 1
    p = sweep_ap.sweep_pairs_reference(sb, two_lists, 1 << 16)
    assert int(k[2]) == int(p[2]) > 0 and not bool(k[3])
    assert _set(k[0], k[1]) == _set(p[0], p[1])


def test_sweep_kernel_overflow_keeps_exact_total(cuda):
    sb = _sorted(cuda, False)
    pairs, n_pairs, n_true, ovf = sweep_ap.sweep_pairs(sb, False, 64)
    full = sweep_ap.sweep_pairs_reference(sb, False, 1 << 16)
    assert bool(ovf) and int(n_pairs) == 64 and int(n_true) == int(full[2])
    assert _set(pairs, 64) <= _set(full[0], full[1])


@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_equals_plain(cuda, is_vf):
    s = from_numpy_scene(_scene(), cuda)
    pairs, n, _, _ = sweep_ap.sweep_pairs_reference(_sorted(cuda, is_vf), is_vf, 1 << 16)
    pairs = pairs[: int(n)]
    vcat = types.concat_frames(s.vertices_t0, s.vertices_t1, torch.float32)
    if is_vf:
        q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, s.faces), pairs)
    else:
        q = types.gather_ee_queries(types.pack_edge_table(vcat, s.edges), pairs)
    rows = solver.pack_query_rows(q, is_vf, 0.0, TOL)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=cuda)
    valid[::7] = False
    toi_k, ovf_k, checks_k = solver.solve_packed(rows, valid, is_vf, 1.0, TOL)
    torch.cuda.synchronize()
    toi_p, ovf_p, checks_p = solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL)
    assert float(toi_k) == pytest.approx(float(toi_p), abs=1e-7)
    assert 0.0 <= float(toi_k) < 1.0 and int(checks_k) > 0
    # a seed below every contact comes back unchanged
    seed = float(toi_p) * 0.5
    toi_s, _, _ = solver.solve_packed(rows, valid, is_vf, seed, TOL)
    assert float(toi_s) == pytest.approx(seed, rel=1e-6)


def _rows(device, is_vf, ms=0.0):
    """Packed rows of every candidate of the scene, and a mask with every
    seventh row invalid."""
    s = from_numpy_scene(_scene(), device)
    pairs, n, _, _ = sweep_ap.sweep_pairs_reference(_sorted(device, is_vf), is_vf, 1 << 16)
    pairs = pairs[: int(n)]
    vcat = types.concat_frames(s.vertices_t0, s.vertices_t1, torch.float32)
    if is_vf:
        q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, s.faces), pairs)
    else:
        q = types.gather_ee_queries(types.pack_edge_table(vcat, s.edges), pairs)
    rows = solver.pack_query_rows(q, is_vf, ms, TOL)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=device)
    valid[::7] = False
    return rows, valid


@pytest.mark.parametrize("is_vf", [True, False])
@pytest.mark.parametrize("cap", [-1, 10, 100])
def test_solver_kernel_per_query_equals_plain(cuda, is_vf, cap):
    """Per-query mode, unbounded and bounded: the same per-query TOIs
    (bounded ones follow the same depth-first order, so bitwise)."""
    rows, valid = _rows(cuda, is_vf)
    before = dict(solver.LAUNCHES_BY_MODE)
    toi_k, _, _, pq_k = solver.solve_packed(rows, valid, is_vf, 0.5, TOL, per_query=True,
                                            max_iterations=cap)
    torch.cuda.synchronize()
    assert solver.LAUNCHES_BY_MODE["per_query"] == before["per_query"] + 1
    assert solver.LAUNCHES_BY_MODE["bounded"] == before["bounded"] + (cap >= 0)
    toi_p, _, _, pq_p = solver.solve_packed_reference(rows, valid, is_vf, 0.5, TOL,
                                                      per_query=True, max_iterations=cap)
    assert torch.equal(pq_k < 1, pq_p < 1) and torch.equal(torch.isinf(pq_k), torch.isinf(pq_p))
    assert torch.isinf(pq_k[~valid]).all()
    fin = torch.isfinite(pq_p)
    if fin.any():
        assert float((pq_k[fin] - pq_p[fin]).abs().max()) <= 1e-7
    if cap >= 0:
        assert torch.equal(pq_k, pq_p)
    assert float(toi_k) == pytest.approx(float(toi_p), abs=1e-7)
    assert float(toi_k) == min(0.5, float(pq_k.min()))


@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_min_separation_and_idle_cap(cuda, is_vf):
    """Global mode with ms > 0 equals the plain version; a cap that never
    binds gives the unbounded TOI."""
    rows, valid = _rows(cuda, is_vf, ms=1e-3)
    toi_k, _, _ = solver.solve_packed(rows, valid, is_vf, 1.0, TOL)
    toi_p, _, _ = solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL)
    assert float(toi_k) == pytest.approx(float(toi_p), abs=1e-7)
    toi_b, _, checks_b = solver.solve_packed(rows, valid, is_vf, 1.0, TOL,
                                             max_iterations=1_000_000)
    assert float(toi_b) == float(toi_k) and int(checks_b) > 0


@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_kernel_box_range_union_is_whole(cuda, two_lists):
    sb = _sorted(cuda, two_lists)
    whole = sweep_ap.sweep_pairs(sb, two_lists, 1 << 16)
    before = sweep_ap.LAUNCHES_BY_MODE["range"]
    got, total, chunks = set(), 0, 0
    for b0 in range(0, sb.n, 37):
        p, n, n_true, ovf = sweep_ap.sweep_pairs(sb, two_lists, 1 << 14, box_range=(b0, b0 + 37))
        assert not bool(ovf)
        part = _set(p, n)
        assert not part & got
        got |= part
        total += int(n_true)
        chunks += 1
    assert sweep_ap.LAUNCHES_BY_MODE["range"] == before + chunks
    assert got == _set(whole[0], whole[1]) and total == int(whole[2]) > 0
    launches = sweep_ap.LAUNCHES_BY_MODE.total
    empty = sweep_ap.sweep_pairs(sb, two_lists, 16, box_range=(5, 5))
    assert int(empty[2]) == 0 and sweep_ap.LAUNCHES_BY_MODE.total == launches


def test_ccd_and_ipc_cuda_equal_cpu(cuda):
    s = _scene()
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    gs, cs = CCDStats(), CCDStats()
    assert ccd(*args, device=cuda, stats=gs) == pytest.approx(
        ccd(*args, stats=cs, device="cpu"), abs=1e-7)
    assert (gs.vf_candidates, gs.ee_candidates) == (cs.vf_candidates, cs.ee_candidates)
    hg, hc = [], []
    ccd(*args, device=cuda, collisions=hg)
    fused_ccd(*args, collisions=hc, device="cpu")
    assert [(a, b) for a, b, _ in sorted(hg)] == [(a, b) for a, b, _ in sorted(hc)]
    assert max(abs(x[2] - y[2]) for x, y in zip(sorted(hg), sorted(hc))) <= 1e-7
    for impl in ("chunked", "fused"):
        kw = dict(min_distance=1e-3, impl=impl)
        assert ipc_ccd_strategy(*args, device=cuda, **kw) == pytest.approx(
            ipc_ccd_strategy(*args, device="cpu", **kw), abs=1e-7)


def test_fused_cuda_equals_cpu(cuda):
    s = _scene()
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    res = fused_ccd(*args, device=cuda)
    ref = fused_ccd(*args, device="cpu")
    assert res.toi.device.type == "cuda" and not bool(res.overflowed)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert int(res.vf_total) == int(ref.vf_total)
    assert int(res.ee_total) == int(ref.ee_total)


def test_wrappers_reject_bad_tensors(cuda):
    rows = torch.zeros((4, 31), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        solver.solve_packed(rows, torch.ones(4, dtype=torch.bool, device=cuda), True, 1.0, TOL)
    sb = _sorted(cuda, False)
    with pytest.raises(ValueError):
        sweep_ap.sweep_pairs(sb._replace(minor_min=sb.minor_min.t()), False, 16)
    assert int(sweep_ap.sweep_pairs(sb, False, 16)[1]) <= 16


def _bucket_sorted(device, two_lists):
    s = from_numpy_scene(_scene(), device)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if two_lists
             else aabb.build_edge_boxes(vb, s.edges))
    return sort_boxes(boxes, bucket_minor=True)


@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_kernel_any_order_equals_plain(cuda, two_lists):
    sb = _bucket_sorted(cuda, two_lists)
    before = sweep_ap.LAUNCHES_BY_MODE["any_order"]
    k = sweep_ap.sweep_pairs(sb, two_lists, 1 << 16, any_order=True)
    torch.cuda.synchronize()
    assert sweep_ap.LAUNCHES_BY_MODE["any_order"] == before + 1
    p = sweep_ap.sweep_pairs_reference(sb, two_lists, 1 << 16, any_order=True)
    assert int(k[2]) == int(p[2]) > 0 and not bool(k[3])
    assert _set(k[0], k[1]) == _set(p[0], p[1]) == _set(*sweep_ap.sweep_pairs(
        _sorted(cuda, two_lists), two_lists, 1 << 16)[:2])
    # the box range in this mode
    got = set()
    for b0 in range(0, sb.n, 53):
        got |= _set(*sweep_ap.sweep_pairs(sb, two_lists, 1 << 14, box_range=(b0, b0 + 53),
                                          any_order=True)[:2])
    assert got == _set(k[0], k[1])


def _records(rec, n):
    r = rec[: int(n)].cpu().numpy()
    return r[np.lexsort(r.T[::-1])]


@pytest.mark.parametrize("any_order", [True, False])
@pytest.mark.parametrize("two_lists", [True, False])
def test_records_kernel_equals_plain(cuda, two_lists, any_order):
    sb = _bucket_sorted(cuda, two_lists) if any_order else _sorted(cuda, two_lists)
    before = sweep_records.LAUNCHES_BY_MODE.total
    k = sweep_records.sweep_records(sb, two_lists, 1 << 16, any_order=any_order)
    torch.cuda.synchronize()
    assert sweep_records.LAUNCHES_BY_MODE.total == before + 1
    p = sweep_records.sweep_records_reference(sb, two_lists, 1 << 16, any_order=any_order)
    assert (int(k[1]), int(k[2])) == (int(p[1]), int(p[2])) and int(k[1]) > 0
    assert not bool(k[3])
    assert np.array_equal(_records(k[0], k[1]), _records(p[0], p[1]))
    pairs = sweep_ap.sweep_pairs(sb, two_lists, 1 << 16, any_order=any_order)
    assert int(k[2]) == int(pairs[2])
    cum = sweep_records.records_pair_prefix(k[0], k[1])
    dec, _ = sweep_records.decode_records_range(sb, k[0], cum, 0, int(k[2]), 0, two_lists)
    assert _set(dec, dec.shape[0]) == _set(pairs[0], pairs[1])
    small = sweep_records.sweep_records(sb, two_lists, 64, any_order=any_order)
    assert bool(small[3]) and (int(small[1]), int(small[2])) == (int(p[1]), int(p[2]))


@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_round_limit_equals_plain(cuda, is_vf):
    """Seeded with the final TOI nothing lowers it, so each thread's search
    is the plain lockstep DFS's: the same unfinished rows and checks.  From
    a cold start the ladder gives the unbounded TOI bitwise."""
    rows, valid = _rows(cuda, is_vf)
    final, _, _ = solver.solve_packed(rows, valid, is_vf, 1.0, TOL)
    before = solver.LAUNCHES_BY_MODE["round_limit"]
    for limit in (0, 7, 30):
        toi_k, ovf_k, ck_k, un_k = solver.solve_packed(rows, valid, is_vf, final, TOL,
                                                       round_limit=limit)
        torch.cuda.synchronize()
        toi_p, ovf_p, ck_p, un_p = solver.solve_packed_reference(rows, valid, is_vf, final,
                                                                 TOL, round_limit=limit)
        assert torch.equal(un_k, un_p) and int(ck_k) == int(ck_p)
        assert float(toi_k) == float(toi_p) == float(final)
        assert not un_k[~valid].any()
    assert solver.LAUNCHES_BY_MODE["round_limit"] == before + 3
    for limits in (4, (2, 16)):
        toi, _, _ = solver.solve_escalated_cols(rows.t().contiguous(), valid, is_vf, 1.0, TOL,
                                                round_limit=limits)
        assert float(toi) == float(final)


def test_fused_congested_knobs_cuda_equal_cpu(cuda):
    s = _scene()
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    for kw in (dict(bucket_minor=True, escalate_pool="batch"),
               dict(bucket_minor=True, sweep_impl="records"),
               dict(sweep_impl="records", escalate_rounds=(2, 8))):
        res = fused_ccd(*args, device=cuda, **kw)
        ref = fused_ccd(*args, device="cpu", **kw)
        assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
        assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))
        assert not bool(res.overflowed)


# ---- f64 instantiations and count_only -----------------------------------------

def _sorted_f64(device, two_lists, bucket=False):
    s = from_numpy_scene(_scene(), device)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=torch.float64)
    boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if two_lists
             else aabb.build_edge_boxes(vb, s.edges))
    return sort_boxes(boxes, bucket_minor=bucket)


@pytest.mark.parametrize("any_order", [True, False])
@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_kernels_f64_equal_plain(cuda, two_lists, any_order):
    """Kernels A (whole and ranged) and A' on f64 boxes: the plain version's
    pair set and record multiset, a subset of the f32 pair set."""
    sb = _sorted_f64(cuda, two_lists, any_order)
    assert sb.major_min.dtype == torch.float64
    before = dict(sweep_ap.LAUNCHES_BY_MODE), dict(sweep_records.LAUNCHES_BY_MODE)
    k = sweep_ap.sweep_pairs(sb, two_lists, 1 << 16, any_order=any_order)
    torch.cuda.synchronize()
    assert sweep_ap.LAUNCHES_BY_MODE["whole_f64"] == before[0]["whole_f64"] + 1
    assert sweep_ap.LAUNCHES_BY_MODE["f32"] == before[0]["f32"]
    p = sweep_ap.sweep_pairs_reference(sb, two_lists, 1 << 16, any_order=any_order)
    assert int(k[2]) == int(p[2]) > 0 and not bool(k[3])
    assert _set(k[0], k[1]) == _set(p[0], p[1])
    f32 = sweep_ap.sweep_pairs(_sorted(cuda, two_lists), two_lists, 1 << 16)
    assert _set(k[0], k[1]) <= _set(f32[0], f32[1])
    got = set()
    for b0 in range(0, sb.n, 41):
        got |= _set(*sweep_ap.sweep_pairs(sb, two_lists, 1 << 14, box_range=(b0, b0 + 41),
                                          any_order=any_order)[:2])
    assert got == _set(k[0], k[1])
    r = sweep_records.sweep_records(sb, two_lists, 1 << 16, any_order=any_order)
    torch.cuda.synchronize()
    assert sweep_records.LAUNCHES_BY_MODE["f64"] == before[1]["f64"] + 1
    rp = sweep_records.sweep_records_reference(sb, two_lists, 1 << 16, any_order=any_order)
    assert (int(r[1]), int(r[2])) == (int(rp[1]), int(rp[2])) and int(r[2]) == int(k[2])
    assert np.array_equal(_records(r[0], r[1]), _records(rp[0], rp[1]))
    cum = sweep_records.records_pair_prefix(r[0], r[1])
    dec, _ = sweep_records.decode_records_range(sb, r[0], cum, 0, int(r[2]), 0, two_lists)
    assert _set(dec, dec.shape[0]) == _set(k[0], k[1])


@pytest.mark.parametrize("f64", [True, False])
@pytest.mark.parametrize("any_order", [True, False])
@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_kernel_count_only_equals_emitting_total(cuda, two_lists, any_order, f64):
    if f64:
        sb = _sorted_f64(cuda, two_lists, any_order)
    else:
        sb = _bucket_sorted(cuda, two_lists) if any_order else _sorted(cuda, two_lists)
    before = sweep_ap.LAUNCHES_BY_MODE["count_only_f64" if f64 else "count_only"]
    total = sweep_ap.sweep_pairs(sb, two_lists, any_order=any_order, count_only=True)
    torch.cuda.synchronize()
    assert sweep_ap.LAUNCHES_BY_MODE["count_only_f64" if f64 else "count_only"] == before + 1
    emitted = sweep_ap.sweep_pairs(sb, two_lists, 64, any_order=any_order)
    plain = sweep_ap.sweep_pairs_reference(sb, two_lists, any_order=any_order, count_only=True)
    assert int(total) == int(emitted[2]) == int(plain) > 64
    ranged = sum(int(sweep_ap.sweep_pairs(sb, two_lists, box_range=(b0, b0 + 300),
                                          any_order=any_order, count_only=True))
                 for b0 in range(0, sb.n, 300))
    assert ranged == int(total)
    with pytest.raises(ValueError, match="no budget"):
        sweep_ap.sweep_pairs(sb, two_lists, 64, count_only=True)


def _rows_f64(device, is_vf, widened=False, ms=0.0):
    """Packed f64 rows of every candidate of the scene (f32 rows widened to
    f64 with the compensated filter when ``widened``), every seventh row
    invalid."""
    s = from_numpy_scene(_scene(), device)
    pairs, n, _, _ = sweep_ap.sweep_pairs_reference(_sorted(device, is_vf), is_vf, 1 << 16)
    pairs = pairs[: int(n)]
    vcat = types.concat_frames(s.vertices_t0, s.vertices_t1,
                               torch.float32 if widened else torch.float64)
    if is_vf:
        q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, s.faces), pairs)
    else:
        q = types.gather_ee_queries(types.pack_edge_table(vcat, s.edges), pairs)
    rows = solver.pack_query_rows(q, is_vf, ms, TOL, compensated=widened).double()
    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=device)
    valid[::7] = False
    return rows, valid


@pytest.mark.parametrize("widened", [True, False])
@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_f64_global_equals_plain(cuda, is_vf, widened):
    """f64 rows, and f32 rows widened to f64 (the compensated precision):
    the global TOI within 1e-12 of the plain version's (expected bitwise),
    f64 out, no conservative accept."""
    rows, valid = _rows_f64(cuda, is_vf, widened)
    before = dict(solver.LAUNCHES_BY_MODE)
    toi_k, ovf_k, checks_k = solver.solve_packed(rows, valid, is_vf, 1.0, TOL, widened=widened)
    torch.cuda.synchronize()
    assert solver.LAUNCHES_BY_MODE["global_f64"] == before["global_f64"] + 1
    assert solver.LAUNCHES_BY_MODE["f32"] == before["f32"]
    toi_p, ovf_p, _ = solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL,
                                                    widened=widened)
    assert toi_k.dtype == torch.float64
    assert float(toi_k) == pytest.approx(float(toi_p), abs=1e-12)
    assert 0.0 < float(toi_k) < 1.0 and int(checks_k) > 0
    assert not bool(ovf_k) and not bool(ovf_p)
    if widened:  # every bound is an f32 dyadic
        assert float(toi_k) == float(toi_k.float())
    toi_ms, _, _ = solver.solve_packed(*_rows_f64(cuda, is_vf, widened, ms=1e-3), is_vf, 1.0,
                                       TOL, widened=widened)
    toi_ms_p, _, _ = solver.solve_packed_reference(*_rows_f64(cuda, is_vf, widened, ms=1e-3),
                                                   is_vf, 1.0, TOL, widened=widened)
    assert float(toi_ms) == pytest.approx(float(toi_ms_p), abs=1e-12)


@pytest.mark.parametrize("is_vf", [True, False])
@pytest.mark.parametrize("cap", [-1, 10, 100])
def test_solver_kernel_f64_per_query_equals_plain(cuda, is_vf, cap):
    rows, valid = _rows_f64(cuda, is_vf)
    before = dict(solver.LAUNCHES_BY_MODE)
    toi_k, _, _, pq_k = solver.solve_packed(rows, valid, is_vf, 0.5, TOL, per_query=True,
                                            max_iterations=cap)
    torch.cuda.synchronize()
    assert solver.LAUNCHES_BY_MODE["per_query_f64"] == before["per_query_f64"] + 1
    assert solver.LAUNCHES_BY_MODE["bounded_f64"] == before["bounded_f64"] + (cap >= 0)
    toi_p, _, _, pq_p = solver.solve_packed_reference(rows, valid, is_vf, 0.5, TOL,
                                                      per_query=True, max_iterations=cap)
    assert pq_k.dtype == torch.float64
    assert torch.equal(pq_k < 1, pq_p < 1) and torch.equal(torch.isinf(pq_k), torch.isinf(pq_p))
    fin = torch.isfinite(pq_p)
    if fin.any():
        assert float((pq_k[fin] - pq_p[fin]).abs().max()) <= 1e-12
    if cap >= 0:
        assert torch.equal(pq_k, pq_p)
    assert float(toi_k) == min(0.5, float(pq_k.min()))
    assert float(toi_k) == pytest.approx(float(toi_p), abs=1e-12)


@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_f64_round_limit_equals_plain(cuda, is_vf):
    rows, valid = _rows_f64(cuda, is_vf)
    final, _, _ = solver.solve_packed(rows, valid, is_vf, 1.0, TOL)
    before = solver.LAUNCHES_BY_MODE["round_limit_f64"]
    for limit in (0, 7, 30):
        toi_k, _, ck_k, un_k = solver.solve_packed(rows, valid, is_vf, final, TOL,
                                                   round_limit=limit)
        torch.cuda.synchronize()
        toi_p, _, ck_p, un_p = solver.solve_packed_reference(rows, valid, is_vf, final, TOL,
                                                             round_limit=limit)
        assert torch.equal(un_k, un_p) and int(ck_k) == int(ck_p)
        assert float(toi_k) == float(toi_p) == float(final)
    assert solver.LAUNCHES_BY_MODE["round_limit_f64"] == before + 3
    for limits in (4, (2, 16)):
        toi, _, _ = solver.solve_escalated_cols(rows.t().contiguous(), valid, is_vf, 1.0, TOL,
                                                round_limit=limits)
        assert float(toi) == float(final)


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float64), dict(precision="compensated"),
    dict(dtype="float64", sweep_impl="records", bucket_minor=True),
    dict(dtype="float64", escalate_rounds=8, escalate_pool="frame"),
    dict(precision="compensated", escalate_rounds=(2, 8)),
])
def test_fused_precision_cuda_equals_cpu(cuda, kw):
    s = _scene()
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    before = dict(solver.LAUNCHES_BY_MODE)
    res = fused_ccd(*args, device=cuda, **kw)
    torch.cuda.synchronize()
    assert solver.LAUNCHES_BY_MODE["f64"] > before["f64"]
    assert solver.LAUNCHES_BY_MODE["f32"] == before["f32"]
    ref = fused_ccd(*args, device="cpu", **kw)
    want = torch.float32 if "precision" in kw else torch.float64
    assert res.toi.dtype == ref.toi.dtype == want
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))
    assert not bool(res.overflowed) and not bool(res.solver_capped)


def test_ccd_precision_cuda_equals_cpu(cuda):
    from scalable_ccd_tpu_torch import CCDConfig

    s = _scene()
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    for cfg in (CCDConfig(dtype="float64"), CCDConfig(precision="compensated")):
        assert ccd(*args, config=cfg, device=cuda) == pytest.approx(
            ccd(*args, config=cfg, device="cpu"), abs=1e-7)
        hg, hc = [], []
        ccd(*args, config=cfg, device=cuda, collisions=hg)
        ccd(*args, config=cfg, device="cpu", collisions=hc)
        assert [(a, b) for a, b, _ in sorted(hg)] == [(a, b) for a, b, _ in sorted(hc)]
        assert ipc_ccd_strategy(*args, min_distance=1e-3, config=cfg, device=cuda) == \
            pytest.approx(ipc_ccd_strategy(*args, min_distance=1e-3, config=cfg, device="cpu"),
                          abs=1e-7)


# ---- kernel B's layout: ragged blocks, empty blocks, every mode and type ---------

_KINDS = {"f32": (torch.float32, False), "f64": (torch.float64, False),
          "widened": (torch.float64, True)}


def _rows_kind(device, is_vf, kind, scene=None):
    """Packed rows of every candidate of ``scene`` (the small cloth by
    default) in ``kind``'s type: f32, f64, or f32 rows with the compensated
    filter widened to f64; every seventh row invalid."""
    dtype, widened = _KINDS[kind]
    s = from_numpy_scene(scene if scene is not None else _scene(), device)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=torch.float64)
    boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if is_vf
             else aabb.build_edge_boxes(vb, s.edges))
    pairs, n, _, _ = sweep_ap.sweep_pairs_reference(sort_boxes(boxes), is_vf, 1 << 18)
    pairs = pairs[: int(n)]
    vcat = types.concat_frames(s.vertices_t0, s.vertices_t1,
                               torch.float32 if widened else dtype)
    if is_vf:
        q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, s.faces), pairs)
    else:
        q = types.gather_ee_queries(types.pack_edge_table(vcat, s.edges), pairs)
    rows = solver.pack_query_rows(q, is_vf, 0.0, TOL, compensated=widened).to(dtype)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=device)
    valid[::7] = False
    return rows, valid


def _every_mode_equals_plain(rows, valid, is_vf, widened=False, toi_init=1.0):
    """Kernel B against its plain version in every mode on ``rows``: global
    and per-query TOIs bitwise, per-query bounded checks, and the unfinished
    rows and checks of round-limited passes seeded with the final TOI; the
    ladder's TOI is the unbounded one; no conservative accept.  Returns the
    global TOI."""
    kw = dict(widened=widened)
    g = solver.solve_packed(rows, valid, is_vf, toi_init, TOL, **kw)
    torch.cuda.synchronize()
    gp = solver.solve_packed_reference(rows, valid, is_vf, toi_init, TOL, **kw)
    assert float(g[0]) == float(gp[0]) and not bool(g[1]) and not bool(gp[1])
    for cap in (-1, 10, 100):
        k = solver.solve_packed(rows, valid, is_vf, toi_init, TOL, per_query=True,
                                max_iterations=cap, **kw)
        p = solver.solve_packed_reference(rows, valid, is_vf, toi_init, TOL, per_query=True,
                                          max_iterations=cap, **kw)
        assert torch.equal(k[3], p[3]) and float(k[0]) == float(p[0]), cap
        assert torch.isinf(k[3][~valid]).all()
        if cap >= 0:
            assert int(k[2]) == int(p[2]), cap
    final = g[0]
    for limit in (0, 7, 30, 128):
        k = solver.solve_packed(rows, valid, is_vf, final, TOL, round_limit=limit, **kw)
        p = solver.solve_packed_reference(rows, valid, is_vf, final, TOL, round_limit=limit,
                                          **kw)
        assert torch.equal(k[3], p[3]) and int(k[2]) == int(p[2]), limit
        assert float(k[0]) == float(p[0]) == float(final) and not k[3][~valid].any()
    esc = solver.solve_escalated_cols(rows.t().contiguous(), valid, is_vf, toi_init, TOL,
                                      round_limit=(4, 32), widened=widened)
    assert float(esc[0]) == float(final) and not bool(esc[1])
    return float(final)


@pytest.mark.parametrize("kind", ["f32", "f64", "widened"])
@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_every_mode_and_type_equals_plain(cuda, is_vf, kind):
    rows, valid = _rows_kind(cuda, is_vf, kind)
    before = dict(solver.LAUNCHES_BY_MODE)
    toi = _every_mode_equals_plain(rows, valid, is_vf, widened=kind == "widened")
    assert 0.0 < toi < 1.0
    f64 = kind != "f32"
    for mode in ("global", "per_query", "bounded", "round_limit"):
        key = mode + "_f64" if f64 else mode
        assert solver.LAUNCHES_BY_MODE[key] > before[key], mode


@pytest.mark.parametrize("n", [1, 5, 31, 33, 100, 127, 129, 257])
def test_solver_kernel_ragged_row_counts(cuda, n):
    """Row counts that fill no whole group of eight lanes, set of 32 groups
    or block of 128 queries, the earliest contacts among them."""
    rows, valid = _rows_kind(cuda, False, "f32")
    pq = solver.solve_packed_reference(rows, valid, False, 1.0, TOL, per_query=True)[3]
    pick = torch.sort(torch.argsort(pq)[:n]).values
    sub, sub_valid = rows[pick].contiguous(), valid[pick].contiguous()
    sub_valid[0] = True
    _every_mode_equals_plain(sub, sub_valid, False)


@pytest.mark.parametrize("block_queries", [32, 64, 128])
@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_solver_shared_form_queries_per_block(cuda, kind, block_queries):
    """The shared form takes the most of 128, 64 and 32 queries a block
    whose blocks fill the card's resident slots, else 32; at seven rows past
    ``block_queries`` times those slots (a ragged last block) it takes
    ``block_queries``, and its global and per-query TOIs equal the plain
    version's bitwise."""
    f64 = kind != "f32"
    _, per_sm = solver._share_grid(1, False, False, f64)
    full = per_sm * torch.cuda.get_device_properties(cuda).multi_processor_count
    assert per_sm >= 1
    for q in (1, 2048, 16384, 1 << 20):
        want = next((b for b in (128, 64) if -(-q // b) >= full), 32)
        assert solver._share_grid(q, False, False, f64)[0] == want, q
    rows, valid = _bench_rows(cuda, kind)
    n = block_queries * full + 7
    assert n <= rows.shape[0]
    sub, sub_valid = rows[:n].contiguous(), valid[:n].contiguous()
    for per_query in (False, True):
        assert solver._share_grid(n, False, per_query, f64)[0] == block_queries
        k = solver.solve_packed(sub, sub_valid, False, 1.0, TOL, per_query=per_query)
        torch.cuda.synchronize()
        p = solver.solve_packed_reference(sub, sub_valid, False, 1.0, TOL, per_query=per_query)
        assert float(k[0]) == float(p[0]) and not bool(k[1]), per_query
        if per_query:
            assert torch.equal(k[3], p[3])


def test_solver_kernel_all_rows_invalid(cuda):
    rows, _ = _rows_kind(cuda, True, "f32")
    none = torch.zeros((rows.shape[0],), dtype=torch.bool, device=cuda)
    toi, ovf, checks = solver.solve_packed(rows, none, True, 0.75, TOL)
    assert float(toi) == 0.75 and not bool(ovf) and int(checks) == 0
    toi, _, checks, pq = solver.solve_packed(rows, none, True, 0.75, TOL, per_query=True)
    assert float(toi) == 0.75 and int(checks) == 0 and torch.isinf(pq).all()
    toi, _, checks, unfin = solver.solve_packed(rows, none, True, 0.75, TOL, round_limit=3)
    assert float(toi) == 0.75 and int(checks) == 0 and not unfin.any()
    *_, plane = solver._solve_query_checks(rows, none, True, 0.75, TOL)
    assert int(plane.abs().sum()) == 0


def test_solver_kernel_zero_toi_init(cuda):
    """A seed of 0 prunes every root at its first evaluation in global mode;
    per-query mode ignores the seed."""
    rows, valid = _rows_kind(cuda, True, "f32")
    n_valid = int(valid.sum())
    toi, ovf, checks = solver.solve_packed(rows, valid, True, 0.0, TOL)
    assert float(toi) == 0.0 and not bool(ovf) and int(checks) == n_valid
    k = solver.solve_packed(rows, valid, True, 0.0, TOL, per_query=True)
    free = solver.solve_packed(rows, valid, True, 1.0, TOL, per_query=True)
    assert float(k[0]) == 0.0 and torch.equal(k[3], free[3])
    _, _, checks, unfin = solver.solve_packed(rows, valid, True, 0.0, TOL, round_limit=1)
    assert int(checks) == n_valid and not unfin.any()
    _every_mode_equals_plain(rows, valid, True, toi_init=0.0)


@pytest.mark.parametrize("kind", ["f32", "f64", "widened"])
@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_deep_query_among_shallow(cuda, is_vf, kind):
    """The dense-cluster golden scene's candidates: a few deep searches
    among shallow ones, the case sharing domains inside a block is for.
    Every mode equals the plain version, and the per-query checks plane
    adds up to the checks."""
    import os

    from scalable_ccd_tpu_torch.geometry import read_ply
    from scalable_ccd_tpu_torch.geometry.scenes import Scene

    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "dense-cluster", "frames")
    v0, faces = read_ply(os.path.join(gdir, "f0.ply"))
    v1, _ = read_ply(os.path.join(gdir, "f1.ply"))
    scene = Scene(v0, v1, faces)
    rows, valid = _rows_kind(cuda, is_vf, kind, scene)
    _every_mode_equals_plain(rows, valid, is_vf, widened=kind == "widened")
    for per_query in (False, True):
        out = solver._solve_query_checks(rows, valid, is_vf, 1.0, TOL, per_query=per_query,
                                         widened=kind == "widened")
        plane = out[-1]
        assert int(plane.sum()) == int(out[2]) and int(plane[~valid].abs().sum()) == 0
        assert int(plane.max()) > float(plane[valid].double().median())


# ---- kernel B's one-thread form: a persistent grid with per-lane refill ----------

def _bench_rows(device, kind, is_vf=False):
    """The bench scene's candidates (``cloth_on_sphere(128, 4)``: 41,480 VF
    and 136,473 EE, three and nine batches of 16,384) in ``kind``'s type,
    every seventh row invalid."""
    return _rows_kind(device, is_vf, kind, scenes.cloth_on_sphere(128, 4, drop=0.25))


def _dense_cluster_rows(device, is_vf, kind):
    import os

    from scalable_ccd_tpu_torch.geometry import read_ply
    from scalable_ccd_tpu_torch.geometry.scenes import Scene

    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "dense-cluster", "frames")
    v0, faces = read_ply(os.path.join(gdir, "f0.ply"))
    v1, _ = read_ply(os.path.join(gdir, "f1.ply"))
    return _rows_kind(device, is_vf, kind, Scene(v0, v1, faces))


def _round_limited_equals_plain(rows, valid, is_vf, seed, limit, widened):
    """The round-limited pass (one launch over all rows) seeded with
    ``seed`` against the plain lockstep DFS: the same unfinished rows,
    checks and per-query checks, the TOI unmoved.  Returns the kernel's
    outputs."""
    k = solver._solve_query_checks(rows, valid, is_vf, seed, TOL, round_limit=limit,
                                   widened=widened)
    torch.cuda.synchronize()
    p = solver._reference_query_checks(rows, valid, is_vf, seed, TOL, round_limit=limit,
                                       widened=widened)
    assert torch.equal(k[3], p[3]) and int(k[2]) == int(p[2]) and torch.equal(k[4], p[4])
    assert float(k[0]) == float(p[0]) == float(seed) and not bool(k[1])
    assert not k[3][~valid].any() and int(k[4][~valid].abs().sum()) == 0
    return k


@pytest.mark.parametrize("kind", ["f32", "f64", "widened"])
@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_lane_form_chunk_in_one_launch_equals_plain(cuda, is_vf, kind):
    """A chunk of the bench scene's candidates, several 16,384-row batches,
    in one round-limited launch seeded with the final TOI: the unfinished
    rows, checks and per-query checks of the plain lockstep DFS, and the
    same as one launch per batch; with ``skip_if_done`` and a seed of 0 the
    launch evaluates nothing.  The grid is persistent: no more blocks than
    stay resident."""
    rows, valid = _bench_rows(cuda, kind, is_vf)
    widened = kind == "widened"
    assert rows.shape[0] > 2 * 16384
    final = solver.solve_packed(rows, valid, is_vf, 1.0, TOL, widened=widened)[0]
    before = dict(solver.LAUNCHES_BY_MODE)
    k = _round_limited_equals_plain(rows, valid, is_vf, final, 128, widened)
    assert solver.LAUNCHES_BY_MODE["round_limit"] == before["round_limit"] + 1
    assert k[3].any() and int(k[2]) > 0
    parts = [solver._solve_query_checks(rows[s:s + 16384], valid[s:s + 16384], is_vf, final,
                                        TOL, round_limit=128, widened=widened)
             for s in range(0, rows.shape[0], 16384)]
    assert torch.equal(torch.cat([o[3] for o in parts]), k[3])
    assert torch.equal(torch.cat([o[4] for o in parts]), k[4])
    assert sum(int(o[2]) for o in parts) == int(k[2])
    z = solver.solve_cols(rows.t().contiguous(), valid, is_vf, 0.0, TOL, round_limit=128,
                          widened=widened, skip_if_done=True)
    assert int(z[2]) == 0 and not z[3].any()
    blocks, per_sm = solver._lane_grid(rows.shape[0], is_vf, False, kind != "f32")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert per_sm >= 1 and blocks == min(per_sm * sms, -(-rows.shape[0] // 128))


@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_solver_lane_form_ragged_row_counts(cuda, n):
    """Row counts that fill no whole warp (or leave a warp one query), and
    4,097 rows, more warps of staged queries than one fetch each: every mode
    equals the plain version, and the round-limited pass keeps its
    per-query checks."""
    rows, valid = _bench_rows(cuda, "f32")
    sub, sub_valid = rows[:n].contiguous(), valid[:n].contiguous()
    sub_valid[0] = True
    final = _every_mode_equals_plain(sub, sub_valid, False)
    _round_limited_equals_plain(sub, sub_valid, False, final, 30, False)


def test_solver_lane_form_no_rows_and_no_valid_rows(cuda):
    """``Q = 0`` launches nothing; all rows invalid evaluate nothing in the
    bounded and round-limited modes and write each row's outputs."""
    rows, _ = _bench_rows(cuda, "f32")
    rows = rows[:4097].contiguous()
    for q in (0, rows.shape[0]):
        none = torch.zeros((q,), dtype=torch.bool, device=cuda)
        for kw in (dict(round_limit=5), dict(max_iterations=10),
                   dict(per_query=True, max_iterations=10)):
            out = solver._solve_query_checks(rows[:q], none, False, 0.5, TOL, **kw)
            assert float(out[0]) == 0.5 and not bool(out[1]) and int(out[2]) == 0, kw
            assert out[-1].shape == (q,) and int(out[-1].abs().sum()) == 0
            if "round_limit" in kw:
                assert out[3].shape == (q,) and not out[3].any()
            elif "per_query" in kw:
                assert torch.isinf(out[3]).all()


@pytest.mark.parametrize("kind", ["f32", "f64", "widened"])
def test_solver_lane_form_deep_queries_among_thousands(cuda, kind):
    """The dense-cluster scene's EE rows (a few deep searches) inside 32,768
    of the bench scene's shallow ones, across many warps, so that lanes
    refill while the deep queries run: the round-limited pass seeded with
    the final TOI, the per-query bounded pass (caps 10 and 100: per-query
    TOIs bitwise, checks and per-query checks) equal the plain version, and
    a global cap of 10^6 gives the unbounded TOI."""
    widened = kind == "widened"
    shallow, s_valid = _bench_rows(cuda, kind)
    deep, d_valid = _dense_cluster_rows(cuda, False, kind)
    rows = torch.cat([shallow[:16384], deep, shallow[16384:32768]]).contiguous()
    valid = torch.cat([s_valid[:16384], d_valid, s_valid[16384:32768]]).contiguous()
    final = solver.solve_packed(rows, valid, False, 1.0, TOL, widened=widened)[0]
    _round_limited_equals_plain(rows, valid, False, final, 128, widened)
    in_deep = slice(16384, 16384 + deep.shape[0])
    for cap in (10, 100):
        kq = solver._solve_query_checks(rows, valid, False, 1.0, TOL, per_query=True,
                                        max_iterations=cap, widened=widened)
        pq = solver._reference_query_checks(rows, valid, False, 1.0, TOL, per_query=True,
                                            max_iterations=cap, widened=widened)
        assert torch.equal(kq[3], pq[3]) and float(kq[0]) == float(pq[0]), cap
        assert int(kq[2]) == int(pq[2]) and torch.equal(kq[4], pq[4]), cap
        # the deep queries run into the cap while the shallow ones end
        assert (kq[4][in_deep] > cap).any() and float(kq[4][valid].double().median()) < 100
    big = solver.solve_packed(rows, valid, False, 1.0, TOL, max_iterations=10**6,
                              widened=widened)
    assert float(big[0]) == float(final) and not bool(big[1])


# ---- kernel A's work units (tiles of 32 boxes against rows of 128 partners) -------

def _unit_case(name, device, dtype):
    """A case of ``tests/test_torch_sweep_tiles.py`` on the card in ``dtype``."""
    from test_torch_sweep_tiles import CASES

    sb = CASES[name]()
    return type(sb)(*[t.to(device, dtype) if t.is_floating_point() else t.to(device)
                      for t in sb])


_UNIT_CASES = ["ragged1", "ragged2", "ragged127", "ragged128", "ragged129", "ragged1000",
               "stacked", "vf", "ee", "vf_bucket", "ee_bucket"]


def _unit_modes(name, n):
    """``(any_order, box_range)`` of a case: the congestion-ordered cases
    only with ``any_order``, the whole range and ranges that start or end
    inside a tile."""
    from test_torch_sweep_tiles import box_ranges

    orders = [True] if name.endswith("bucket") else [False, True]
    return [(a, r) for a in orders for r in box_ranges(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", _UNIT_CASES)
def test_sweep_kernel_units_equal_plain(cuda, name, dtype):
    """Ragged tiles, a stack whose runs are longer than a row, box ranges
    that start or end inside a tile, ``any_order`` with skipped and
    unskipped rows; budgets 0, 64 and exactly the total: the plain
    version's pair set and exact total, ``count_only`` the same total."""
    sb = _unit_case(name, cuda, dtype)
    two = not name.startswith("ee")
    planes = sweep_ap.partner_planes(sb)
    for any_order, rng in _unit_modes(name, sb.n):
        kw = dict(box_range=rng, any_order=any_order, planes=planes)
        p = sweep_ap.sweep_pairs_reference(sb, two, 1 << 20, **kw)
        want = _set(p[0], p[1])
        total = int(p[2])
        for budget in (0, 64, total):
            k = sweep_ap.sweep_pairs(sb, two, budget, **kw)
            torch.cuda.synchronize()
            label = (name, any_order, rng, budget)
            assert int(k[2]) == total, label
            assert int(k[1]) == min(total, budget) and bool(k[3]) == (total > budget), label
            got = _set(k[0], k[1])
            assert len(got) == int(k[1]) and got <= want, label
        assert got == want
        assert int(sweep_ap.sweep_pairs(sb, two, count_only=True, **kw)) == total


@pytest.mark.parametrize("name", _UNIT_CASES)
def test_sweep_kernel_tiles_equal_plain(cuda, name):
    """The tile ends and unit prefix of the kernel's first two launches
    equal :func:`sweep_tiles`."""
    sb = _unit_case(name, cuda, torch.float32)
    planes = sweep_ap.partner_planes(sb)
    for any_order, rng in _unit_modes(name, sb.n):
        b0, b1 = (0, sb.n) if rng is None else rng
        n_true = torch.zeros((1,), dtype=torch.int64, device=cuda)
        scratch = sweep_ap._launch(sb, True, (b0, b1), any_order, planes, None, 0, n_true)
        torch.cuda.synchronize()
        _, end, prefix = sweep_ap.sweep_tiles(sb, rng, any_order, planes)
        k_end, k_prefix = sweep_ap._scratch_tiles(scratch, end.numel())
        assert torch.equal(k_end, end) and torch.equal(k_prefix, prefix), (name, any_order, rng)


# ---- kernel A''s work units (a-rows of 128 boxes against rows of 128 partners) ----

def _record_rows(rec, n):
    """The first ``n`` records as sorted int64 rows (a multiset)."""
    r = rec[: int(n)].to(torch.int64).cpu().numpy()
    return r[np.lexsort(r.T[::-1])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", _UNIT_CASES)
def test_records_kernel_units_equal_plain(cuda, name, dtype):
    """Ragged a-rows (n = 1, 2, 127-129, 1000), a stack whose a-rows span
    every partner row, the scenes in both orderings; budgets 0, 64 and
    exactly the totals: the plain version's record multiset and exact
    totals, ``overflow`` as the plain version sets it, the decoded pairs
    equal to kernel A's pair set."""
    sb = _unit_case(name, cuda, dtype)
    two = not name.startswith("ee")
    planes = sweep_ap.partner_planes(sb)
    orders = [True] if name.endswith("bucket") else [False, True]
    for any_order in orders:
        kw = dict(any_order=any_order, planes=planes)
        p = sweep_records.sweep_records_reference(sb, two, 1 << 20, **kw)
        n_rec, n_pairs = int(p[1]), int(p[2])
        want = _record_rows(p[0], n_rec)
        for pair_budget, rec_budget in ((0, 0), (64, 64), (n_pairs, n_rec)):
            before = sweep_records.LAUNCHES_BY_MODE.total
            k = sweep_records.sweep_records(sb, two, pair_budget, rec_budget, **kw)
            torch.cuda.synchronize()
            label = (name, any_order, pair_budget, rec_budget)
            assert sweep_records.LAUNCHES_BY_MODE.total == before + (sb.n > 0), label
            rb = sweep_records._budgets(pair_budget, rec_budget)[1]
            assert (int(k[1]), int(k[2])) == (n_rec, n_pairs), label
            assert bool(k[3]) == (n_pairs > pair_budget or n_rec > rb), label
            got = _record_rows(k[0], min(n_rec, rb))
            keys = {tuple(r) for r in got}
            assert len(keys) == got.shape[0] and keys <= {tuple(r) for r in want}, label
        assert np.array_equal(got, want), name
        a = sweep_ap.sweep_pairs(sb, two, max(n_pairs, 1), **kw)
        cum = sweep_records.records_pair_prefix(k[0], k[1])
        dec, _ = sweep_records.decode_records_range(sb, k[0], cum, 0, n_pairs, 0, two)
        assert _set(dec, dec.shape[0]) == _set(a[0], a[1]) and int(a[2]) == n_pairs


@pytest.mark.parametrize("name", _UNIT_CASES)
def test_records_kernel_units_equal_device_units(cuda, name):
    """The a-row ends and unit prefix of kernel A''s first two launches
    equal :func:`sweep_records.sweep_record_units`."""
    sb = _unit_case(name, cuda, torch.float32)
    planes = sweep_ap.partner_planes(sb)
    for any_order in ([True] if name.endswith("bucket") else [False, True]):
        recs = torch.zeros((64, sweep_records.REC_WORDS), dtype=torch.int32, device=cuda)
        counts = [torch.zeros((1,), dtype=torch.int64, device=cuda) for _ in range(2)]
        scratch = sweep_records._launch(sb, True, any_order, planes, recs, *counts)
        torch.cuda.synchronize()
        _, end, prefix = sweep_records.sweep_record_units(sb, any_order, planes)
        k_end, k_prefix = sweep_records._scratch_units(scratch, sb.n)
        assert torch.equal(k_end, end) and torch.equal(k_prefix, prefix), (name, any_order)


def _row_ranges(n):
    """A-row ranges of a case (``tests/test_torch_record_units.py:
    row_ranges``): empty, one a-row, cut mid-array, past the end, all."""
    from test_torch_record_units import row_ranges

    return row_ranges(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", _UNIT_CASES)
def test_records_kernel_row_range_equals_plain(cuda, name, dtype):
    """``row_range``: ranges empty, of one a-row, cut mid-array and of all
    a-rows, on the ragged cases, the stack and the scenes in both orderings,
    at budgets 0, 64 and exactly the totals: the plain version's record
    multiset of the range and its exact totals, ``overflow`` as the plain
    version sets it, each launch counted under ``"range"``; and the records
    of a partition of the a-rows into 2 and into 4 ranges make the whole
    multiset."""
    sb = _unit_case(name, cuda, dtype)
    two = not name.startswith("ee")
    planes = sweep_ap.partner_planes(sb)
    rows = -(-sb.n // sweep_ap.ROW)
    for any_order in ([True] if name.endswith("bucket") else [False, True]):
        kw = dict(any_order=any_order, planes=planes)
        whole = sweep_records.sweep_records_reference(sb, two, 1 << 20, **kw)
        for rng in _row_ranges(sb.n):
            p = sweep_records.sweep_records_reference(sb, two, 1 << 20, row_range=rng, **kw)
            n_rec, n_pairs = int(p[1]), int(p[2])
            want = _record_rows(p[0], n_rec)
            for pair_budget, rec_budget in ((0, 0), (64, 64), (n_pairs, n_rec)):
                before = sweep_records.LAUNCHES_BY_MODE["range"]
                k = sweep_records.sweep_records(sb, two, pair_budget, rec_budget, row_range=rng,
                                                **kw)
                torch.cuda.synchronize()
                label = (name, any_order, rng, pair_budget)
                launched = min(rng[1], rows) > rng[0]
                assert sweep_records.LAUNCHES_BY_MODE["range"] == before + launched, label
                rb = sweep_records._budgets(pair_budget, rec_budget)[1]
                assert (int(k[1]), int(k[2])) == (n_rec, n_pairs), label
                assert bool(k[3]) == (n_pairs > pair_budget or n_rec > rb), label
                got = _record_rows(k[0], min(n_rec, rb))
                keys = {tuple(r) for r in got}
                assert len(keys) == got.shape[0] and keys <= {tuple(r) for r in want}, label
            assert np.array_equal(got, want), (name, any_order, rng)
        for world in (2, 4):
            per = -(-rows // world)
            parts = [sweep_records.sweep_records(sb, two, int(whole[2]) + 1, row_range=(
                min(s * per, rows), (s + 1) * per), **kw) for s in range(world)]
            torch.cuda.synchronize()
            union = np.concatenate([_record_rows(q[0], q[1]) for q in parts])
            union = union[np.lexsort(union.T[::-1])]
            assert np.array_equal(union, _record_rows(whole[0], whole[1])), (name, world)


@pytest.mark.parametrize("name", _UNIT_CASES)
def test_records_kernel_row_range_units_equal_device_units(cuda, name):
    """The a-row ends and unit prefix of a row range's first two launches
    equal :func:`sweep_records.sweep_record_units` of the range."""
    sb = _unit_case(name, cuda, torch.float32)
    planes = sweep_ap.partner_planes(sb)
    rows = -(-sb.n // sweep_ap.ROW)
    for any_order in ([True] if name.endswith("bucket") else [False, True]):
        for rng in _row_ranges(sb.n):
            if min(rng[1], rows) <= rng[0]:
                continue
            recs = torch.zeros((64, sweep_records.REC_WORDS), dtype=torch.int32, device=cuda)
            counts = [torch.zeros((1,), dtype=torch.int64, device=cuda) for _ in range(2)]
            scratch = sweep_records._launch(sb, True, any_order, planes, recs, *counts, rng)
            torch.cuda.synchronize()
            _, end, prefix = sweep_records.sweep_record_units(sb, any_order, planes, rng)
            k_end, k_prefix = sweep_records._scratch_units(scratch, sb.n, rng)
            assert torch.equal(k_end, end) and torch.equal(k_prefix, prefix), \
                (name, any_order, rng)


# ---- kernel C: gather, tolerance, error filter and pack ---------------------------

#: kernel C's three row types: (table dtype, compensated)
_C_KINDS = {"f32": (torch.float32, False), "f64": (torch.float64, False),
            "compensated": (torch.float32, True)}
_BENCH_CANDIDATES = {}


def _bench_candidates(device, dtype, is_vf):
    """``(pairs buffer, n, vcat, table)`` of the bench scene,
    ``cloth_on_sphere(128, 4, drop=0.25)``, in ``dtype``: kernel A's
    candidate buffer, in the main path's layout."""
    key = (dtype, is_vf)
    if key not in _BENCH_CANDIDATES:
        s = from_numpy_scene(scenes.cloth_on_sphere(grid_n=128, sphere_subdiv=4, drop=0.25),
                             device)
        vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=dtype)
        boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if is_vf
                 else aabb.build_edge_boxes(vb, s.edges))
        pairs, n, _, _ = sweep_ap.sweep_pairs(sort_boxes(boxes), is_vf, 1 << 18)
        vcat = types.concat_frames(s.vertices_t0, s.vertices_t1, dtype)
        table = (types.pack_face_table(vcat, s.faces) if is_vf
                 else types.pack_edge_table(vcat, s.edges))
        _BENCH_CANDIDATES[key] = (pairs, int(n), vcat, table)
    return _BENCH_CANDIDATES[key]


def _same_bits(a, b):
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


@pytest.mark.parametrize("kind", sorted(_C_KINDS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_gather_pack_kernel_equals_plain_bitwise(cuda, is_vf, kind):
    """Every 16,384-row batch of the bench scene's candidates, read from the
    whole buffer at its offset, bitwise the plain version's columns; the
    first batch also with a minimum separation; and the whole buffer in one
    launch with it (kernel C's rows through the row function it shares with
    kernel B's pairs source, ``csrc/pack_row.cuh``)."""
    dtype, comp = _C_KINDS[kind]
    pairs, n, vcat, table = _bench_candidates(cuda, dtype, is_vf)
    assert n > 16384
    before = dict(gp.LAUNCHES_BY_MODE)
    batches = 0
    for start, stop in [(s, min(s + 16384, n)) for s in range(0, n, 16384)] + [(0, n)]:
        for ms in ((0.0, 1e-3) if start == 0 else (0.0,)):
            k = gp.gather_pack(pairs, start, stop, vcat, table, is_vf, ms, TOL, comp)
            torch.cuda.synchronize()
            p = gp.gather_pack_reference(pairs, start, stop, vcat, table, is_vf, ms, TOL, comp)
            assert _same_bits(k, p), (start, ms)
            batches += 1
    mode = "vf" if is_vf else "ee"
    f64 = dtype == torch.float64 or comp
    assert gp.LAUNCHES_BY_MODE[mode] == before[mode] + batches
    assert gp.LAUNCHES_BY_MODE["f64" if f64 else "f32"] == before["f64" if f64 else "f32"] + batches
    assert gp.LAUNCHES_BY_MODE["compensated"] == before["compensated"] + comp * batches


# ---- kernel B's pairs source: each row computed in its lane ------------------

def _pairs_equal_columns(pairs, start, stop, vcat, table, is_vf, ms, comp, seed, cap,
                         checks=True):
    """One pairs-source launch over ``pairs[start:stop]`` against kernel C's
    columns of the same pairs through the columns source, both seeded with
    ``seed`` and capped at ``cap``: the TOI and the overflow flag bit for
    bit, and the checks where ``checks``.  Returns the pairs launch's
    outputs."""
    cols = gp.gather_pack(pairs, start, stop, vcat, table, is_vf, ms, TOL, comp)
    valid = torch.ones((stop - start,), dtype=torch.bool, device=pairs.device)
    k = solver.solve_pairs(pairs, start, stop, vcat, table, is_vf, seed, ms, TOL,
                           max_iterations=cap, compensated=comp)
    c = solver.solve_cols(cols, valid, is_vf, seed, TOL, max_iterations=cap, widened=comp)
    torch.cuda.synchronize()
    assert _same_bits(k[0].reshape(1), c[0].reshape(1)), (start, stop, cap, k[0], c[0])
    assert bool(k[1]) == bool(c[1]), (start, stop, cap)
    if checks:
        assert int(k[2]) == int(c[2]) > 0, (start, stop, cap)
    return k


@pytest.mark.parametrize("ms", [0.0, 1e-3])
@pytest.mark.parametrize("kind", sorted(_C_KINDS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_pairs_source_equals_columns_bitwise(cuda, is_vf, kind, ms):
    """The bench scene's candidates in one pairs-source launch equal kernel
    C plus the columns source: seeded with the unbounded TOI, which no query
    then lowers, at caps 10, 100 and 10^6 (TOI, overflow and checks bit for
    bit, whatever the order the lanes run in); seeded with 1 at the cap of
    10^6, which these queries stay under, the same TOI and overflow.  Each
    launch counts as bounded and pairs; a seed of 0 under ``skip_if_done``
    evaluates nothing."""
    dtype, comp = _C_KINDS[kind]
    pairs, n, vcat, table = _bench_candidates(cuda, dtype, is_vf)
    cols = gp.gather_pack(pairs, 0, n, vcat, table, is_vf, ms, TOL, comp)
    final = solver.solve_cols(cols, torch.ones((n,), dtype=torch.bool, device=cuda), is_vf,
                              1.0, TOL, widened=comp)[0]
    before = dict(solver.LAUNCHES_BY_MODE)
    for cap in (10, 100, 10**6):
        _pairs_equal_columns(pairs, 0, n, vcat, table, is_vf, ms, comp, final, cap)
    k = _pairs_equal_columns(pairs, 0, n, vcat, table, is_vf, ms, comp, 1.0, 10**6,
                             checks=False)
    # the unbounded TOI, unless a conservative accept moved it
    assert bool(k[1]) or _same_bits(k[0].reshape(1), final.reshape(1))
    f64 = dtype == torch.float64 or comp
    assert solver.LAUNCHES_BY_MODE["pairs"] == before["pairs"] + 4
    assert solver.LAUNCHES_BY_MODE["pairs_f64"] == before["pairs_f64"] + 4 * f64
    z = solver.solve_pairs(pairs, 0, n, vcat, table, is_vf, 0.0, ms, TOL, compensated=comp,
                           skip_if_done=True)
    assert float(z[0]) == 0.0 and not bool(z[1]) and int(z[2]) == 0


@pytest.mark.parametrize("q", [1, 31, 33, 4097])
def test_solver_pairs_source_ragged_ranges(cuda, q):
    """Pair ranges that start inside the buffer and fill no whole warp (or
    leave a warp one query), and 4,097 rows: the columns source's TOI,
    overflow and checks, seeded with the range's unbounded TOI at a cap of
    10 and with 1 at 10^6; an empty range launches nothing."""
    pairs, n, vcat, table = _bench_candidates(cuda, torch.float32, False)
    start = 1000
    cols = gp.gather_pack(pairs, start, start + q, vcat, table, False, 0.0, TOL)
    final = solver.solve_cols(cols, torch.ones((q,), dtype=torch.bool, device=cuda), False,
                              1.0, TOL)[0]
    _pairs_equal_columns(pairs, start, start + q, vcat, table, False, 0.0, False, final, 10)
    _pairs_equal_columns(pairs, start, start + q, vcat, table, False, 0.0, False, 1.0, 10**6,
                         checks=False)
    before = solver.LAUNCHES_BY_MODE.total
    e = solver.solve_pairs(pairs, 7, 7, vcat, table, False, 0.5, 0.0, TOL)
    assert float(e[0]) == 0.5 and int(e[2]) == 0 and solver.LAUNCHES_BY_MODE.total == before
    with pytest.raises(ValueError, match="outside"):
        solver.solve_pairs(pairs, n, pairs.shape[0] + 1, vcat, table, False, 1.0, 0.0, TOL)


#: the shared form's scenes: ``cloth_on_sphere`` arguments
_SHARED_SCENES = {"bench": (128, 4, 0.25), "grid600": (600, 4, 0.25)}
_SCENE_CANDIDATES = {}


def _scene_candidates(device, scene, dtype, is_vf):
    """``(pairs buffer, n, vcat, table)`` of a scene of
    :data:`_SHARED_SCENES` in ``dtype``, as :func:`_bench_candidates`."""
    if scene == "bench":
        return _bench_candidates(device, dtype, is_vf)
    key = (scene, dtype, is_vf)
    if key not in _SCENE_CANDIDATES:
        _SCENE_CANDIDATES.clear()  # one scene's candidates held at a time
        s = from_numpy_scene(scenes.cloth_on_sphere(*_SHARED_SCENES[scene]), device)
        vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=dtype)
        boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if is_vf
                 else aabb.build_edge_boxes(vb, s.edges))
        total = int(sweep_ap.sweep_pairs(sort_boxes(boxes), is_vf, count_only=True))
        pairs, n, _, _ = sweep_ap.sweep_pairs(sort_boxes(boxes), is_vf, total)
        vcat = types.concat_frames(s.vertices_t0, s.vertices_t1, dtype)
        table = (types.pack_face_table(vcat, s.faces) if is_vf
                 else types.pack_edge_table(vcat, s.edges))
        _SCENE_CANDIDATES[key] = (pairs, int(n), vcat, table)
    return _SCENE_CANDIDATES[key]


@pytest.mark.parametrize("kind", sorted(_C_KINDS))
@pytest.mark.parametrize("is_vf", [True, False])
@pytest.mark.parametrize("scene", sorted(_SHARED_SCENES))
def test_solver_shared_form_pairs_source_equals_columns_bitwise(cuda, scene, is_vf, kind):
    """Kernel B's shared form (no cap) over a phase's pairs in one launch,
    its rows computed in the block from the pairs, against the same form
    over kernel C's columns of the same pairs, both from a TOI of 1: the
    TOI bit for bit and the overflow flag equal, on the bench scene and on
    grid-600 (past 2^20 EE candidates); the launch counts as global and
    pairs; seeded with 0 under ``skip_if_done`` it evaluates nothing."""
    dtype, comp = _C_KINDS[kind]
    pairs, n, vcat, table = _scene_candidates(cuda, scene, dtype, is_vf)
    before = dict(solver.LAUNCHES_BY_MODE)
    k = solver.solve_pairs(pairs, 0, n, vcat, table, is_vf, 1.0, 0.0, TOL, max_iterations=-1,
                           compensated=comp)
    torch.cuda.synchronize()
    f64 = dtype == torch.float64 or comp
    assert solver.LAUNCHES_BY_MODE["global"] == before["global"] + 1
    assert solver.LAUNCHES_BY_MODE["pairs"] == before["pairs"] + 1
    assert solver.LAUNCHES_BY_MODE["pairs_f64"] == before["pairs_f64"] + f64
    assert solver.LAUNCHES_BY_MODE["bounded"] == before["bounded"]
    cols = gp.gather_pack(pairs, 0, n, vcat, table, is_vf, 0.0, TOL, comp)
    c = solver.solve_cols(cols, torch.ones((n,), dtype=torch.bool, device=cuda), is_vf, 1.0,
                          TOL, widened=comp)
    del cols
    assert bool(k[1]) == bool(c[1]), (scene, is_vf, kind)
    assert bool(k[1]) or _same_bits(k[0].reshape(1), c[0].reshape(1)), (k[0], c[0])
    assert int(k[2]) > 0 and float(k[0]) < 1.0
    z = solver.solve_pairs(pairs, 0, n, vcat, table, is_vf, 0.0, 0.0, TOL, max_iterations=-1,
                           compensated=comp, skip_if_done=True)
    assert float(z[0]) == 0.0 and not bool(z[1]) and int(z[2]) == 0


@pytest.mark.parametrize("cap", [-1, 10**6])
def test_solver_pairs_source_splits_past_the_launch_rows(cuda, monkeypatch, cap):
    """A range past the most rows of one launch (here 4,097) is solved in
    launches of at most that many, each seeded with the TOI the ones
    before it left: the TOI and overflow of one launch, one launch counted
    per part; seeded with 0, no part evaluates anything."""
    pairs, n, vcat, table = _bench_candidates(cuda, torch.float32, False)
    one = solver.solve_pairs(pairs, 3, n, vcat, table, False, 1.0, 0.0, TOL, max_iterations=cap)
    monkeypatch.setattr(solver, "LAUNCH_ROWS", 4097)
    before = solver.LAUNCHES_BY_MODE["pairs"]
    split = solver.solve_pairs(pairs, 3, n, vcat, table, False, 1.0, 0.0, TOL,
                               max_iterations=cap, skip_if_done=True)
    assert solver.LAUNCHES_BY_MODE["pairs"] == before + -(-(n - 3) // 4097)
    assert _same_bits(split[0].reshape(1), one[0].reshape(1)) and bool(split[1]) == bool(one[1])
    z = solver.solve_pairs(pairs, 3, n, vcat, table, False, 0.0, 0.0, TOL, max_iterations=cap,
                           skip_if_done=True)
    assert float(z[0]) == 0.0 and int(z[2]) == 0


@pytest.mark.parametrize("is_vf", [True, False])
def test_gather_pack_kernel_clamps_ids_and_rejects_bad_inputs(cuda, is_vf):
    _, _, vcat, table = _bench_candidates(cuda, torch.float32, is_vf)
    n_a = vcat.shape[0] if is_vf else table.shape[0]
    bad = torch.tensor([[-3, -1], [n_a + 7, table.shape[0] + 2], [5, 9]], dtype=torch.int32,
                       device=cuda)
    k = gp.gather_pack(bad, 0, 3, vcat, table, is_vf, 0.0, TOL)
    assert _same_bits(k, gp.gather_pack_reference(bad, 0, 3, vcat, table, is_vf, 0.0, TOL))
    assert gp.gather_pack(bad, 1, 1, vcat, table, is_vf, 0.0, TOL).shape == (31, 0)
    with pytest.raises(ValueError, match="int32"):
        gp.gather_pack(bad.long(), 0, 3, vcat, table, is_vf, 0.0, TOL)
    with pytest.raises(ValueError, match="compensated"):
        gp.gather_pack(bad, 0, 3, vcat.double(), table.double(), is_vf, 0.0, TOL, True)
    with pytest.raises(ValueError, match="outside"):
        gp.gather_pack(bad, 2, 4, vcat, table, is_vf, 0.0, TOL)


@pytest.mark.parametrize("kind", ["f32", "f64", "widened"])
def test_solver_kernel_reads_column_slices_and_skips_when_done(cuda, kind):
    """Kernel B on a slice of a wider column buffer (a pool block) equals
    it on contiguous rows: the round-limited pass seeded with the final TOI
    (unfinished rows and checks fixed by each query's order) and the
    global TOI; ``skip_if_done`` with a seed of 0 evaluates nothing and
    with a positive seed changes nothing."""
    rows, valid = _rows_kind(cuda, False, kind)
    widened = kind == "widened"
    q = rows.shape[0]
    wide = torch.full((31, q + 100), float("nan"), dtype=rows.dtype, device=cuda)
    wide[:, 37:37 + q] = rows.t()
    cols = wide[:, 37:37 + q]
    final, _, _ = solver.solve_packed(rows, valid, False, 1.0, TOL, widened=widened)
    t, _, _ = solver.solve_cols(cols, valid, False, 1.0, TOL, widened=widened)
    assert float(t) == float(final)
    for skip in (False, True):
        k = solver.solve_cols(cols, valid, False, final, TOL, round_limit=30, widened=widened,
                              skip_if_done=skip)
        p = solver.solve_packed_reference(rows, valid, False, final, TOL, round_limit=30,
                                          widened=widened)
        assert torch.equal(k[3], p[3]) and int(k[2]) == int(p[2]) > 0
    for kw in (dict(), dict(round_limit=30), dict(max_iterations=100)):
        z = solver.solve_cols(cols, valid, False, 0.0, TOL, widened=widened, skip_if_done=True,
                              **kw)
        assert float(z[0]) == 0.0 and not bool(z[1]) and int(z[2]) == 0
        if "round_limit" in kw:
            assert not z[3].any()
        neg = torch.tensor(-0.0, dtype=rows.dtype, device=cuda)
        assert int(solver.solve_cols(cols, valid, False, neg, TOL, widened=widened,
                                     skip_if_done=True, **kw)[2]) == 0


@pytest.mark.parametrize("sweep_impl", ["pairs", "records"])
def test_fused_launches_gather_pack_every_batch(cuda, sweep_impl, monkeypatch):
    """Every narrow batch of ``fused_ccd`` that kernel B reads as columns
    (records at the defaults; pairs under escalation, since at the defaults
    a phase of pairs is one launch that packs its own rows) packs through
    kernel C, one launch per chunk of whole batches of each phase: with the
    chunk cap at three batches of 128, ``ceil(total / 384)`` launches a
    phase, in the records mode for ``sweep_impl="records"``; TOI and totals
    as on the CPU."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 3 * 128 + 100)
    s = _scene()
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    before = dict(gp.LAUNCHES_BY_MODE)
    res = fused_ccd(*args, device=cuda, narrow_batch=128, presample=False,
                    sweep_impl=sweep_impl,
                    escalate_rounds=128 if sweep_impl == "pairs" else None)
    torch.cuda.synchronize()
    launches = 0
    for mode, total in (("vf", res.vf_total), ("ee", res.ee_total)):
        assert int(total) > 384
        assert gp.LAUNCHES_BY_MODE[mode] - before[mode] == -(-int(total) // 384)
        launches += -(-int(total) // 384)
    records = gp.LAUNCHES_BY_MODE["records"] - before["records"]
    assert records == (launches if sweep_impl == "records" else 0)
    ref = fused_ccd(*args, device="cpu", narrow_batch=128, presample=False)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))


def _record_of(fn):
    """``(fn(), record)``: the program's record of the one call of an entry
    point that ``fn`` makes, under a CPU profile (its spans and counters)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from scalable_ccd_tpu_torch.utils.profiler import profiler

    profiler().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("window"):
            res = fn()
            torch.cuda.synchronize()
    (rec,) = profiler().records()
    profiler().clear()
    return res, rec


def _counted_call(fn):
    """``(fn(), counters)``: one call of ``fused_ccd`` under a CPU profile,
    with the counters of the program's record of it."""
    res, rec = _record_of(fn)
    return res, rec.counters


def _launches(counters, kernel):
    return sum(n for k, n in counters.items() if k.startswith(f"launch.{kernel}."))


def test_fused_defaults_solve_each_chunk_in_one_launch(cuda, monkeypatch):
    """``fused_ccd`` at its defaults on CUDA, on the bench scene (41,480 VF
    and 136,473 EE candidates) with the chunk cap at two batches of 16,384,
    so each phase has more than one chunk: auto escalation is off, and every
    chunk of a phase is solved in the phase's one launch over its pairs
    (``launch.solver.global+pairs``, counted in ``chunk_solves``), beside
    the presample's batch, the one launch a phase of kernel C; none of them
    round-limited; ``batches`` counts the presample's two.  The TOI is bit
    for bit that of the frame pool at 128 rounds, asked for as
    ``escalate_rounds=128`` or as ``escalate_pool="frame"`` with auto
    rounds, of the records path (kernel C's chunks and one launch each),
    and of the plain versions on the CPU; totals and flags equal."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 2 * 16384 + 5)
    s = scenes.cloth_on_sphere(grid_n=128, sphere_subdiv=4, drop=0.25)
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    before = dict(solver.LAUNCHES_BY_MODE)
    res, counters = _counted_call(lambda: fused_ccd(*args, device=cuda))
    assert solver.LAUNCHES_BY_MODE["round_limit"] == before["round_limit"]
    assert int(res.vf_total) > 32768 and int(res.ee_total) > 32768
    assert counters["launch.solver.global+pairs"] == counters["chunk_solves"] == 2
    assert _launches(counters, "solver") == 4 and _launches(counters, "gather_pack") == 2
    assert counters["batches"] == 2
    want = (float(res.toi).hex(), int(res.vf_total), int(res.ee_total), bool(res.overflowed),
            bool(res.solver_capped))
    escalated = {}
    for label, kw in (("rounds", dict(escalate_rounds=128)), ("pool", dict(escalate_pool="frame"))):
        before = solver.LAUNCHES_BY_MODE["round_limit"]
        esc, escalated[label] = _counted_call(lambda: fused_ccd(*args, device=cuda, **kw))
        assert solver.LAUNCHES_BY_MODE["round_limit"] > before, label
        assert "chunk_solves" not in escalated[label]
        assert (float(esc.toi).hex(), int(esc.vf_total), int(esc.ee_total),
                bool(esc.overflowed), bool(esc.solver_capped)) == want, label
    assert escalated["rounds"]["batches"] == escalated["pool"]["batches"] > 2
    rec, rec_counters = _counted_call(lambda: fused_ccd(*args, device=cuda, sweep_impl="records"))
    chunks = sum(-(-int(n) // 32768) for n in (res.vf_total, res.ee_total))
    assert rec_counters["chunk_solves"] == chunks and "launch.solver.global+pairs" not in rec_counters
    assert (float(rec.toi).hex(), int(rec.vf_total), int(rec.ee_total), bool(rec.overflowed),
            bool(rec.solver_capped)) == want
    ref = fused_ccd(*args, device="cpu")
    assert (float(ref.toi).hex(), int(ref.vf_total), int(ref.ee_total), bool(ref.overflowed),
            bool(ref.solver_capped)) == want


def _sliding_cloth(grid_n=210):
    """``cloth_on_sphere(grid_n, 4)`` whose cloth also slides (2.5, 1.5)
    grid spacings sideways in the step, as the benchmark's cloth cells move
    it, so that its boxes overlap those of the cells it passes: past 2^20
    candidates in each phase at grid 210."""
    s = scenes.cloth_on_sphere(grid_n=grid_n, sphere_subdiv=4, drop=0.25)
    v1 = np.array(s.vertices_t1)
    spacing = 2.4 / (grid_n - 1)
    v1[:grid_n * grid_n, 0] += 2.5 * spacing
    v1[:grid_n * grid_n, 2] += 1.5 * spacing
    return s.vertices_t0, v1, s.edges, s.faces


def test_fused_defaults_solve_each_phase_in_one_pairs_launch(cuda):
    """``fused_ccd`` at its defaults on a scene past 2^20 candidates in each
    phase (more than one kernel C chunk a phase before): exactly one
    ``launch.solver.global+pairs`` a phase, ``chunk_solves`` 2, kernel C
    launched for the presample's batches alone and no ``sccd.pack`` span;
    the TOI, totals and flags bit for bit those of the records path, which
    packs and solves the same candidates chunk by chunk."""
    args = _sliding_cloth()
    res, rec = _record_of(lambda: fused_ccd(*args, device=cuda))
    assert int(res.vf_total) > 1 << 20 and int(res.ee_total) > 1 << 20
    counters = rec.counters
    assert counters["launch.solver.global+pairs"] == counters["chunk_solves"] == 2
    presampled = sum(1 for sp in rec.spans if sp.name == "sccd.presample")
    assert _launches(counters, "gather_pack") == presampled
    assert _launches(counters, "solver") == 2 + presampled
    assert not any(sp.name == "sccd.pack" for sp in rec.spans)
    got = (float(res.toi).hex(), int(res.vf_total), int(res.ee_total), bool(res.overflowed),
           bool(res.solver_capped))
    chunked, crec = _record_of(lambda: fused_ccd(*args, device=cuda, sweep_impl="records"))
    assert crec.counters["chunk_solves"] > 2 and "launch.solver.global+pairs" not in crec.counters
    assert (float(chunked.toi).hex(), int(chunked.vf_total), int(chunked.ee_total),
            bool(chunked.overflowed), bool(chunked.solver_capped)) == got
    assert not got[3] and 0.0 <= float(res.toi) < 1.0


def test_ipc_path_keeps_its_launches(cuda):
    """``ipc_ccd_strategy`` on the chunked path keeps its launches: each
    broad chunk's bounded solve one ``launch.solver.bounded+pairs``
    (``chunk_solves``), the IPC rule's re-solves kernel C and the shared
    form over columns per batch; it makes no unbounded pairs launch."""
    s = scenes.cloth_on_sphere(grid_n=20, sphere_subdiv=2, drop=0.3, seed=1)
    v0, v1 = np.asarray(s.vertices_t0), np.asarray(s.vertices_t1)
    toi = ccd(v0, v1, s.edges, s.faces, device=cuda)
    assert 0.0 < toi < 1.0
    args = (v0 + 0.99 * toi * (v1 - v0), v1, s.edges, s.faces)
    stats = CCDStats()
    got, rec = _record_of(lambda: ipc_ccd_strategy(*args, min_distance=1e-3, stats=stats,
                                                   device=cuda))
    counters = rec.counters
    assert stats.ipc_refinements > 0 and 0.0 < got < 1.0
    assert counters["launch.solver.bounded+pairs"] == counters["chunk_solves"] > 0
    assert "launch.solver.global+pairs" not in counters
    assert counters.get("launch.solver.global", 0) > 0 and _launches(counters, "gather_pack") > 0
    want = ipc_ccd_strategy(*args, min_distance=1e-3, device="cpu")
    assert got == pytest.approx(want, abs=1e-7)


def _bench_stream(device, dtype, comp, is_vf, sweep_impl, batch, with_ids=False):
    """A narrow-loop stream of the bench scene's candidates in ``dtype``
    (``comp``: compensated rows), on ``device``, in batches of ``batch``."""
    s = from_numpy_scene(scenes.cloth_on_sphere(grid_n=128, sphere_subdiv=4, drop=0.25),
                         device)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=dtype)
    boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if is_vf
             else aabb.build_edge_boxes(vb, s.edges))
    sb = sort_boxes(boxes)
    nar = NarrowSolver.for_phase(is_vf, s.vertices_t0, s.vertices_t1, s.edges, s.faces, 0.0,
                                 TOL, True, -1, -1, dtype, comp)
    if sweep_impl == "pairs":
        pairs, n, _, _ = sweep_ap.sweep_pairs(sb, is_vf, 1 << 18)
        return PairStream(pairs, int(n), nar, batch)
    rec, n_rec, _, _ = sweep_records.sweep_records(sb, is_vf, 1 << 18)
    return RecordStream(sb, rec, int(n_rec), 1 << 18, is_vf, nar, batch, with_ids)


@pytest.mark.parametrize("sweep_impl", ["pairs", "records"])
@pytest.mark.parametrize("kind", sorted(_C_KINDS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_gather_pack_chunks_equal_plain_bitwise(cuda, monkeypatch, is_vf, kind, sweep_impl):
    """The narrow loop's chunks at a cap of three batches of 4,096 plus a
    few rows (so chunk seams fall inside records): every batch's column
    slice of its chunk, taken in reverse order, bitwise the plain version
    on the same rows, one kernel C launch per chunk; in the records mode
    the written ids are the plain decode's."""
    dtype, comp = _C_KINDS[kind]
    monkeypatch.setattr(gp, "CHUNK_ROWS", 3 * 4096 + 5)
    stream = _bench_stream(cuda, dtype, comp, is_vf, sweep_impl, 4096, with_ids=True)
    n, nar = stream.n, stream.nar
    assert stream.chunk == 3 * 4096 and n > 2 * stream.chunk
    if sweep_impl == "pairs":
        want_ids = stream.pairs[:n]
    else:
        want_ids = sweep_records.decode_records_range(stream.sb, stream.records, stream.cum,
                                                      0, n, 0, is_vf)[0]
    before = gp.LAUNCHES_BY_MODE.total
    chunks = set()
    for start in reversed(range(0, n, 4096)):
        stop = min(start + 4096, n)
        cols = stream.cols(start, stop)
        torch.cuda.synchronize()
        assert cols.stride() == (min(stream.chunk, n), 1)
        want = gp.gather_pack_reference(want_ids, start, stop, nar.vcat, nar.table, is_vf,
                                        0.0, TOL, comp)
        assert _same_bits(cols.contiguous(), want), (start, stop)
        assert torch.equal(stream.ids(start, stop), want_ids[start:stop])
        chunks.add(start // stream.chunk)
    assert gp.LAUNCHES_BY_MODE.total - before == len(chunks) == -(-n // stream.chunk)


@pytest.mark.parametrize("is_vf", [True, False])
def test_gather_pack_records_edges_equal_plain(cuda, is_vf):
    """Kernel C's records mode on a record buffer cut at a budget (a
    truncated stream whose last chunk ends inside a record), on runs that
    start and stop inside records, and on an empty run, bitwise its plain
    twin with the same ids; ``out`` a slice of a wider buffer; bad
    arguments raise."""
    s = from_numpy_scene(_scene(), cuda)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if is_vf
             else aabb.build_edge_boxes(vb, s.edges))
    sb = sort_boxes(boxes)
    full, _, n_pairs, _ = sweep_records.sweep_records(sb, is_vf, 1 << 16)
    rec, n_rec, _, ovf = sweep_records.sweep_records(sb, is_vf, int(n_pairs), 97)
    assert bool(ovf) and rec.shape[0] == 97
    cum = sweep_records.records_pair_prefix(rec, min(int(n_rec), 97))
    n = int(cum[-1]) - 3  # a budget that cuts the last record
    vcat = types.concat_frames(s.vertices_t0, s.vertices_t1, torch.float32)
    table = types.pack_face_table(vcat, s.faces) if is_vf else types.pack_edge_table(vcat, s.edges)
    wide = torch.full((31, n + 50), float("nan"), device=cuda)
    for a, b in ((0, n), (1, n - 1), (5, 6), (n - 7, n), (9, 9)):
        ids_k = torch.zeros((max(b - a, 1), 2), dtype=torch.int32, device=cuda)
        ids_p = torch.zeros_like(ids_k)
        k = gp.gather_pack_records(sb, rec, cum, a, b, vcat, table, is_vf, 1e-3, TOL,
                                   pairs_out=ids_k, out=wide[:, 7:])
        torch.cuda.synchronize()
        p = gp.gather_pack_records_reference(sb, rec, cum, a, b, vcat, table, is_vf, 1e-3,
                                             TOL, pairs_out=ids_p)
        assert k.shape == (31, b - a) and k.stride() == (n + 50, 1)
        assert _same_bits(k.contiguous(), p) and torch.equal(ids_k, ids_p), (a, b)
    with pytest.raises(ValueError, match="outside"):
        gp.gather_pack_records(sb, rec, cum, 0, 128 * 97 + 1, vcat, table, is_vf, 0.0, TOL)
    with pytest.raises(ValueError, match="int64"):
        gp.gather_pack_records(sb, rec, cum.int(), 0, 4, vcat, table, is_vf, 0.0, TOL)
    with pytest.raises(ValueError, match="out must"):
        gp.gather_pack_records(sb, rec, cum, 0, 4, vcat, table, is_vf, 0.0, TOL,
                               out=wide[:, :3])


def test_solver_kernel_guard_flags_a_runaway_query(cuda):
    """One vertex falling through a triangle with a minimum separation of
    0.1: no search ends on its tolerances, and kernel B stops the query at
    its runaway guard with overflow set and a conservative TOI (the vertex
    comes within 0.1 of the plane at t = 0.45)."""
    v0 = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.2, 0.2, 1]], device=cuda)
    v1 = v0.clone()
    v1[3, 2] = -1.0
    vcat = types.concat_frames(v0, v1)
    table = types.pack_face_table(vcat, torch.tensor([[0, 1, 2]], device=cuda))
    pairs = torch.tensor([[3, 0]], dtype=torch.int32, device=cuda)
    cols = gp.gather_pack(pairs, 0, 1, vcat, table, True, 0.1, TOL)
    valid = torch.ones((1,), dtype=torch.bool, device=cuda)
    toi, ovf, checks = solver.solve_cols(cols, valid, True, 1.0, TOL)
    assert bool(ovf) and 0.0 <= float(toi) <= 0.45 and int(checks) > 0
