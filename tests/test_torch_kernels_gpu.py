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
    rows = torch.zeros((4, 31), dtype=torch.float64, device=cuda)
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
