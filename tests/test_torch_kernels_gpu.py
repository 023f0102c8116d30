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
from scalable_ccd_tpu_torch.ops import solver, sweep_ap, sweep_records

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
    before = sweep_ap.LAUNCHES
    k = sweep_ap.sweep_pairs(sb, two_lists, 1 << 16)
    torch.cuda.synchronize()
    assert sweep_ap.LAUNCHES == before + 1
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
    launches = sweep_ap.LAUNCHES
    empty = sweep_ap.sweep_pairs(sb, two_lists, 16, box_range=(5, 5))
    assert int(empty[2]) == 0 and sweep_ap.LAUNCHES == launches


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
    before = sweep_records.LAUNCHES
    k = sweep_records.sweep_records(sb, two_lists, 1 << 16, any_order=any_order)
    torch.cuda.synchronize()
    assert sweep_records.LAUNCHES == before + 1
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
        toi, _, _ = solver.solve_escalated(rows, valid, is_vf, 1.0, TOL, round_limit=limits)
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
        toi, _, _ = solver.solve_escalated(rows, valid, is_vf, 1.0, TOL, round_limit=limits)
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
    esc = solver.solve_escalated(rows, valid, is_vf, toi_init, TOL, round_limit=(4, 32),
                                 widened=widened)
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


@pytest.mark.parametrize("n", [1, 5, 31, 33, 100])
def test_solver_kernel_ragged_row_counts(cuda, n):
    """Row counts that fill no whole group of eight lanes or block of 32
    queries, the earliest contacts among them."""
    rows, valid = _rows_kind(cuda, False, "f32")
    pq = solver.solve_packed_reference(rows, valid, False, 1.0, TOL, per_query=True)[3]
    pick = torch.sort(torch.argsort(pq)[:n]).values
    sub, sub_valid = rows[pick].contiguous(), valid[pick].contiguous()
    sub_valid[0] = True
    _every_mode_equals_plain(sub, sub_valid, False)


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
