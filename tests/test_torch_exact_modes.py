"""PyTorch port vs the JAX package: the exact modes, on the CPU.

The plain twins of kernel B's per-query and bounded modes and of kernel A's
box range, and ``fused_ccd``'s ``collisions``, ``min_distance``,
``max_iterations``, ``ipc_refine`` and ``pca``, each held to the JAX suite's
bars: per-query TOIs within ``atol=1e-7`` of ``find_roots_bfs`` (and of the
depth-first ``find_roots`` where a cap binds, ``tests/test_pallas_solver.py:
168-198``), global TOIs within 1e-7, pair sets and hit keys equal.

Per-query TOIs are compared with the JAX solvers run op by op
(``jax.disable_jit``).  Jitted, XLA's CPU compiler contracts ``a * b + c``
into fused multiply-adds, which the port's plain versions (and kernel B,
built with ``-fmad=false``) round separately.  A per-query TOI sits on an
acceptance threshold, so one ulp in a corner value moves it by a tolerance
step (1.9e-6 on 8 of the 1,160 EE queries here); op by op both round every
operation and agree bitwise.  Global TOIs are a minimum over many queries
and hold at 1e-7 against the jitted solvers too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_ccd_tpu.broad_phase import brute_force_overlaps
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import mesh as jmesh
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.narrow_phase import find_roots, find_roots_bfs
from scalable_ccd_tpu.narrow_phase import types as jtypes
from scalable_ccd_tpu.ops.pallas_solver import pack_query_rows as jpack
from scalable_ccd_tpu.pipeline.fused import fused_ccd as jax_fused_ccd
from scalable_ccd_tpu.utils.pca import principal_rotation as jax_rotation
from scalable_ccd_tpu_torch import ccd, fused_ccd
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb
from scalable_ccd_tpu_torch.interop import from_numpy_scene
from scalable_ccd_tpu_torch.ops import solver, sweep_ap
from scalable_ccd_tpu_torch.pipeline import fused as port_fused
from scalable_ccd_tpu_torch.utils.pca import principal_rotation

torch.set_num_threads(2)

TOL = 1e-6
F32 = jnp.float32
CPU = dict(device="cpu")


def _cloth():
    return jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35)


@pytest.fixture(scope="module")
def rows():
    """``{is_vf: (JAX CCDQueries, port rows for ms=0)}`` of every brute-force
    candidate of the small cloth scene."""
    s = _cloth()
    v0 = jnp.asarray(s.vertices_t0, F32)
    v1 = jnp.asarray(s.vertices_t1, F32)
    vb = jaabb.build_vertex_boxes(v0, v1, dtype=F32)
    out = {}
    for is_vf in (True, False):
        if is_vf:
            pairs = brute_force_overlaps(vb, jaabb.build_face_boxes(vb, s.faces))
            q = jtypes.gather_vf_queries(v0, v1, s.faces, jnp.asarray(pairs), dtype=F32)
        else:
            pairs = brute_force_overlaps(jaabb.build_edge_boxes(vb, s.edges))
            q = jtypes.gather_ee_queries(v0, v1, s.edges, jnp.asarray(pairs), dtype=F32)
        out[is_vf] = q
    return out


def _port_rows(q, is_vf, ms=0.0):
    return torch.tensor(np.asarray(jpack(q, is_vf, F32(ms), F32(TOL))))


def _valid(n):
    return torch.ones((n,), dtype=torch.bool)


def _jax_per_query(q, is_vf, ms=0.0, valid=None):
    """``find_roots_bfs`` per-query TOIs of ``q``, op by op (module
    docstring), with a queue that never spills."""
    valid = jnp.ones((q.n,), bool) if valid is None else valid
    with jax.disable_jit():
        ref = find_roots_bfs(
            q, valid, is_vf, toi_init=F32(1.0), ms=F32(ms), tolerance=F32(TOL),
            toi_per_query=True, tile=1 << 13, frontier_capacity=1 << 15,
        )
    assert not np.asarray(ref.overflow).any()
    return np.asarray(ref.per_query_toi)


def _same_pq(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert np.array_equal(got < 1, ref < 1)  # same hit set
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-7)


@pytest.mark.parametrize("is_vf", [True, False])
def test_per_query_plain_matches_bfs(rows, is_vf):
    q = rows[is_vf]
    ref = _jax_per_query(q, is_vf)
    toi, ovf, checks, pq = solver.solve_packed_reference(
        _port_rows(q, is_vf), _valid(q.n), is_vf, 1.0, TOL, per_query=True
    )
    _same_pq(pq, ref)
    assert (pq < 1).any() and int(checks) > 0
    assert float(toi) == pytest.approx(min(1.0, float(ref.min())), abs=1e-7)
    assert float(toi) == pytest.approx(min(1.0, float(pq.min())), abs=0)


def test_per_query_ignores_toi_init_and_masks_invalid_rows(rows):
    q = rows[True]
    r = _port_rows(q, True)
    valid = _valid(q.n)
    valid[::3] = False
    _, _, _, pq_full = solver.solve_packed_reference(r, _valid(q.n), True, 1.0, TOL, per_query=True)
    toi, _, _, pq = solver.solve_packed_reference(r, valid, True, 0.01, TOL, per_query=True)
    assert torch.isinf(pq[~valid]).all()
    assert torch.equal(pq[valid], pq_full[valid])  # no query pruned by toi_init
    assert float(toi) == min(float(np.float32(0.01)), float(pq.min()))


@pytest.mark.parametrize("is_vf", [True, False])
@pytest.mark.parametrize("cap", [10, 100])
def test_bounded_per_query_lockstep_matches_dfs(rows, is_vf, cap):
    q = rows[is_vf]
    ref = find_roots(
        q, jnp.ones((q.n,), bool), is_vf, toi_init=F32(1.0), ms=F32(0.0),
        tolerance=F32(TOL), max_iterations=cap, toi_per_query=True,
        stack_capacity=96,
    )
    toi, _, checks, pq = solver.solve_packed_reference(
        _port_rows(q, is_vf), _valid(q.n), is_vf, 1.0, TOL, per_query=True,
        max_iterations=cap,
    )
    _same_pq(pq, ref.per_query_toi)
    assert float(toi) == pytest.approx(float(ref.toi), abs=1e-7)


@pytest.mark.parametrize("cap", [10, 100])
def test_bounded_global_counts_like_the_queue_solver(rows, cap):
    """Global mode with a binding cap: the plain version counts evaluations
    per query as the JAX queue solver does, so both drop the same domains
    and agree on the TOI and the check total."""
    q = rows[False]
    with jax.disable_jit():
        ref = find_roots_bfs(
            q, jnp.ones((q.n,), bool), False, toi_init=F32(1.0), ms=F32(0.0),
            tolerance=F32(TOL), max_iterations=cap, frontier_capacity=1 << 15,
        )
    assert not bool(np.asarray(ref.overflow).any())
    toi, _, checks = solver.solve_packed_reference(
        _port_rows(q, False), _valid(q.n), False, 1.0, TOL, max_iterations=cap
    )
    assert float(toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert int(checks) == int(ref.total_checks)


@pytest.mark.parametrize("is_vf", [True, False])
def test_bounded_cap_that_never_binds_equals_unbounded(rows, is_vf):
    q = rows[is_vf]
    r = _port_rows(q, is_vf)
    free = solver.solve_packed_reference(r, _valid(q.n), is_vf, 1.0, TOL)
    capped = solver.solve_packed_reference(r, _valid(q.n), is_vf, 1.0, TOL,
                                           max_iterations=1_000_000)
    assert float(capped[0]) == float(free[0])


@pytest.mark.parametrize("is_vf", [True, False])
@pytest.mark.parametrize("ms", [1e-3, 0.02])
def test_min_separation_global_matches_bfs(rows, is_vf, ms):
    q = rows[is_vf]
    ref = find_roots_bfs(
        q, jnp.ones((q.n,), bool), is_vf, toi_init=F32(1.0), ms=F32(ms),
        tolerance=F32(TOL),
    )
    toi, _, _ = solver.solve_packed_reference(
        _port_rows(q, is_vf, ms), _valid(q.n), is_vf, 1.0, TOL
    )
    assert float(toi) == pytest.approx(float(ref.toi), abs=1e-7)


def _sorted_phases(scene=None):
    s = from_numpy_scene(_cloth() if scene is None else scene)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    return {
        True: sort_boxes(merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces))),
        False: sort_boxes(aabb.build_edge_boxes(vb, s.edges)),
    }


def _keys(pairs, n):
    return set(map(tuple, pairs[: int(n)].tolist()))


@pytest.mark.parametrize("two_lists", [True, False])
@pytest.mark.parametrize("chunk", [5, 37])
def test_ranged_plain_sweep_union_is_the_whole_set(two_lists, chunk):
    sb = _sorted_phases()[two_lists]
    whole, n_whole, _, _ = sweep_ap.sweep_pairs_reference(sb, two_lists, 1 << 16)
    got, total = set(), 0
    for b0 in range(0, sb.n, chunk):
        p, n, n_true, ovf = sweep_ap.sweep_pairs(sb, two_lists, 1 << 14, box_range=(b0, b0 + chunk))
        assert not bool(ovf)
        part = _keys(p, n)
        assert not part & got  # ranges do not share a pair
        got |= part
        total += int(n_true)
    assert got == _keys(whole, n_whole) and total == int(n_whole) > 0
    empty = sweep_ap.sweep_pairs_reference(sb, two_lists, 16, box_range=(3, 3))
    assert int(empty[2]) == 0
    with pytest.raises(ValueError, match="box_range"):
        sweep_ap.sweep_pairs_reference(sb, two_lists, 16, box_range=(4, 2))


# ---- fused_ccd's exact modes vs JAX fused_ccd(solver="bfs") ----------------

def _args(s):
    return s.vertices_t0, s.vertices_t1, s.edges, s.faces


def _jax(s, **kw):
    return jax_fused_ccd(*_args(s), solver="bfs", dtype=F32, vf_budget=1 << 14,
                         ee_budget=1 << 14, **kw)


def test_fused_collisions_match_jax():
    """Equal hit keys, TOI and totals against JAX ``fused_ccd``.  The
    per-pair TOIs are held to the JAX solvers run op by op in
    ``test_per_query_plain_matches_bfs`` and, through this pipeline, in
    ``test_fused_collisions_with_a_cap_match_jax`` (module docstring)."""
    s = jscenes.cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.6)
    hits_j, hits_p = [], []
    ref = _jax(s, collisions=hits_j)
    res = fused_ccd(*_args(s), collisions=hits_p, **CPU)
    assert len(hits_j) > 0
    assert sorted((a, b) for a, b, _ in hits_p) == sorted((a, b) for a, b, _ in hits_j)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert float(res.toi) == pytest.approx(min(t for _, _, t in hits_p), abs=0)
    assert int(res.vf_total) == int(ref.vf_total) and int(res.ee_total) == int(ref.ee_total)



def test_fused_min_distance_and_cap_match_jax():
    s = _cloth()
    kw = dict(min_distance=1e-3, max_iterations=1_000_000)
    ref = _jax(s, **kw)
    res = fused_ccd(*_args(s), **kw, **CPU)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert int(res.vf_total) == int(ref.vf_total) and int(res.ee_total) == int(ref.ee_total)
    assert float(res.toi) <= float(fused_ccd(*_args(s), **CPU).toi)


def test_fused_collisions_with_a_cap_match_jax():
    """Collisions under a binding cap: per-query bounded solves, whose hits
    follow the depth-first order of the JAX package's ``find_roots`` (run
    op by op, module docstring), VF hits before EE."""
    s = jscenes.cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.6)
    hits = []
    res = fused_ccd(*_args(s), max_iterations=100, collisions=hits, **CPU)
    v0 = jnp.asarray(s.vertices_t0, F32)
    v1 = jnp.asarray(s.vertices_t1, F32)
    want = []
    for is_vf, sb in _sorted_phases(s).items():
        pairs, n, _, _ = sweep_ap.sweep_pairs_reference(sb, is_vf, 1 << 14)
        pairs = pairs[: int(n)].numpy()
        if is_vf:
            q = jtypes.gather_vf_queries(v0, v1, s.faces, jnp.asarray(pairs), dtype=F32)
        else:
            q = jtypes.gather_ee_queries(v0, v1, s.edges, jnp.asarray(pairs), dtype=F32)
        with jax.disable_jit():
            ref = find_roots(
                q, jnp.ones((q.n,), bool), is_vf, toi_init=F32(1.0), ms=F32(0.0),
                tolerance=F32(TOL), max_iterations=100, toi_per_query=True,
                stack_capacity=96,
            )
        pq = np.asarray(ref.per_query_toi)
        want += sorted((int(a), int(b), float(pq[i])) for i, (a, b) in enumerate(pairs)
                       if pq[i] < 1)
    assert len(want) > 0
    assert [(a, b) for a, b, _ in hits] == [(a, b) for a, b, _ in want]
    np.testing.assert_allclose([t for *_, t in hits], [t for *_, t in want],
                               rtol=0, atol=1e-7)
    assert float(res.toi) == pytest.approx(min(t for *_, t in want), abs=1e-7)


def _rig(x, z):
    """The IPC contact rig of ``tests/test_pipeline.py``: a static unit
    triangle and a vertex ``z`` above it falling 0.03, offset by ``x``."""
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    v0 = np.concatenate([tri, [[0.25, 0.25, z]]]) + [x, 0.0, 0.0]
    v1 = v0.copy()
    v1[3, 2] -= 0.03
    return v0, v1


def test_fused_ipc_refine_matches_jax():
    """The touching rig of ``tests/test_pipeline.py:231-258`` beside a
    cloth: the contact pair triggers the refinement in both packages."""
    c = _cloth()
    rig0, rig1 = _rig(5.0, 0.01)
    nv = c.vertices_t0.shape[0]
    v0 = np.concatenate([c.vertices_t0, rig0])
    v1 = np.concatenate([c.vertices_t1, rig1])
    faces = np.concatenate([c.faces, np.arange(nv, nv + 3, dtype=np.int32)[None]])
    edges = jmesh.edges_from_faces(faces)
    kw = dict(min_distance=0.05, max_iterations=1_000_000, ipc_refine=True)
    ref = jax_fused_ccd(v0, v1, edges, faces, solver="bfs", dtype=F32,
                        vf_budget=1 << 14, ee_budget=1 << 14, **kw)
    res = fused_ccd(v0, v1, edges, faces, **kw, **CPU)
    assert int(res.ipc_refinements) >= 1
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert 0.0 < float(res.toi) < 0.8


def test_fused_ipc_refine_is_independent_of_pair_row_order(monkeypatch):
    """Several narrow batches, two contact pairs among them: the TOI is the
    same whatever the order of the sweep's rows, because the rows are key
    sorted before batching (the order kernel A's rows come in on CUDA)."""
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    v0p, v1p, fp, nv = [], [], [], 0
    for cx in (0.0, 10.0, 20.0, 30.0):
        lo0, hi0, hi1 = tri + [cx, 0, 0], tri + [cx, 0, 0.12], tri + [cx, 0, 0.09]
        v0p += [lo0, hi0]
        v1p += [lo0, hi1]
        fp += [np.arange(3) + nv, np.arange(3) + nv + 3]
        nv += 6
    for x, z in ((5.0, 0.01), (15.0, 0.012)):
        rig0, rig1 = _rig(x, z)
        v0p.append(rig0)
        v1p.append(rig1)
        fp.append(np.arange(3) + nv)
        nv += 4
    v0, v1 = np.concatenate(v0p), np.concatenate(v1p)
    faces = np.stack(fp).astype(np.int32)
    edges = jmesh.edges_from_faces(faces)
    monkeypatch.setattr(port_fused, "_NARROW_BATCH", 4)
    real = port_fused.sweep_pairs
    kw = dict(min_distance=0.05, ipc_refine=True, vf_budget=64, ee_budget=256, **CPU)
    base = fused_ccd(v0, v1, edges, faces, **kw)
    assert int(base.vf_total) > 8 and int(base.ipc_refinements) >= 1
    for seed in range(2):
        def shuffled(sb, two, budget, seed=seed, **sweep_kw):
            pairs, n, n_true, ovf = real(sb, two, budget, **sweep_kw)
            k = int(n)
            perm = torch.from_numpy(np.random.default_rng(seed).permutation(k))
            pairs = pairs.clone()
            pairs[:k] = pairs[:k][perm]
            return pairs, n, n_true, ovf
        monkeypatch.setattr(port_fused, "sweep_pairs", shuffled)
        got = fused_ccd(v0, v1, edges, faces, **kw)
        assert float(got.toi) == float(base.toi)
        assert int(got.ipc_refinements) == int(base.ipc_refinements)


def test_fused_collisions_with_ipc_refine_raise():
    s = _cloth()
    with pytest.raises(ValueError, match="ipc_refine"):
        fused_ccd(*_args(s), collisions=[], ipc_refine=True, **CPU)


def test_pca_rotation_matches_jax_and_keeps_the_toi():
    s = jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.5)
    r = principal_rotation(torch.from_numpy(s.vertices_t0), torch.from_numpy(s.vertices_t1))
    rj = np.asarray(jax_rotation(jnp.asarray(s.vertices_t0), jnp.asarray(s.vertices_t1)))
    for row, row_j in zip(r.numpy(), rj):
        assert np.allclose(row, row_j, atol=1e-9) or np.allclose(row, -row_j, atol=1e-9)
    assert float(torch.linalg.det(r)) == pytest.approx(1.0, abs=1e-12)
    base = fused_ccd(*_args(s), **CPU)
    rot = fused_ccd(*_args(s), pca=True, **CPU)
    assert float(rot.toi) == pytest.approx(float(base.toi), abs=1e-6)
    assert float(ccd(*_args(s), pca=True, **CPU)) == pytest.approx(float(base.toi), abs=1e-6)
