"""PyTorch port vs the JAX package: query data, filters and the plain solver.

Gathered queries, tolerances, error bounds and packed rows must be bitwise
equal in f32.  The plain solver (``solve_packed_reference``, the twin of
kernel B) must give the global TOI of JAX ``find_roots_bfs`` and of the
interpret-mode ``pallas_find_roots`` within ``abs=1e-7``, the JAX suite's
own bar between its solvers (``tests/test_pallas_solver.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu.broad_phase import brute_force_overlaps
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.narrow_phase import find_roots_bfs
from scalable_ccd_tpu.narrow_phase import types as jtypes
from scalable_ccd_tpu.narrow_phase.root_finder import _inclusion as jinclusion
from scalable_ccd_tpu.ops.pallas_solver import pack_query_rows as jpack
from scalable_ccd_tpu.ops.pallas_solver import pallas_find_roots
from scalable_ccd_tpu_torch.interop import from_numpy_queries, to_numpy
from scalable_ccd_tpu_torch.narrow_phase import root_finder, types
from scalable_ccd_tpu_torch.ops import solver

torch.set_num_threads(2)

TOL = 1e-6


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _scene(name="cloth"):
    if name == "cloth":
        return jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35)
    return jscenes.triangle_soup(60, motion=0.2, seed=3)


def _pairs(s, is_vf):
    vb = jaabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=jnp.float32)
    if is_vf:
        return brute_force_overlaps(vb, jaabb.build_face_boxes(vb, s.faces))
    return brute_force_overlaps(jaabb.build_edge_boxes(vb, s.edges))


def _queries(s, is_vf):
    """(JAX CCDQueries, port CCDQueries) gathered from the same pairs."""
    pairs = _pairs(s, is_vf)
    v0 = jnp.asarray(s.vertices_t0, jnp.float32)
    v1 = jnp.asarray(s.vertices_t1, jnp.float32)
    vcat = types.concat_frames(
        torch.from_numpy(s.vertices_t0), torch.from_numpy(s.vertices_t1), torch.float32
    )
    tp = torch.from_numpy(np.asarray(pairs))
    if is_vf:
        jq = jtypes.gather_vf_queries(v0, v1, s.faces, jnp.asarray(pairs), dtype=jnp.float32)
        pq = types.gather_vf_queries(
            vcat, types.pack_face_table(vcat, torch.from_numpy(s.faces)), tp
        )
    else:
        jq = jtypes.gather_ee_queries(v0, v1, s.edges, jnp.asarray(pairs), dtype=jnp.float32)
        pq = types.gather_ee_queries(types.pack_edge_table(vcat, torch.from_numpy(s.edges)), tp)
    return jq, pq


@pytest.mark.parametrize("name", ["cloth", "soup"])
@pytest.mark.parametrize("is_vf", [True, False])
def test_gathered_queries_bitwise_equal(name, is_vf):
    jq, pq = _queries(_scene(name), is_vf)
    assert pq.n > 0
    for field, a, b in zip(jq._fields, jq, to_numpy(pq)):
        assert np.array_equal(_bits(a), _bits(b)), field


@pytest.mark.parametrize("is_vf", [True, False])
def test_tolerance_bitwise_equal(is_vf):
    jq, _ = _queries(_scene(), is_vf)
    pq = from_numpy_queries(jq)  # the JAX queries, carried across
    a = jtypes.compute_tolerance(jq, is_vf, jnp.float32(TOL))
    b = types.compute_tolerance(pq, is_vf, TOL)
    assert np.array_equal(_bits(a), _bits(b.numpy()))


@pytest.mark.parametrize("is_vf", [True, False])
@pytest.mark.parametrize("use_ms", [True, False])
def test_error_bound_bitwise_equal(is_vf, use_ms):
    jq, pq = _queries(_scene("soup"), is_vf)
    a = jtypes.numerical_error_bound(jq, is_vf, use_ms)
    b = types.numerical_error_bound(pq, is_vf, use_ms)
    assert np.array_equal(_bits(a), _bits(b.numpy()))


@pytest.mark.parametrize("is_vf", [True, False])
@pytest.mark.parametrize("ms", [0.0, 1e-4])
def test_pack_query_rows_bitwise_equal(is_vf, ms):
    jq, pq = _queries(_scene(), is_vf)
    a = jpack(jq, is_vf, jnp.float32(ms), jnp.float32(TOL))
    b = solver.pack_query_rows(pq, is_vf, ms, TOL)
    assert b.shape == (pq.n, 31)
    assert np.array_equal(_bits(a), _bits(b.numpy()))


@pytest.mark.parametrize("is_vf", [True, False])
def test_inclusion_bitwise_equal(is_vf):
    jq, pq = _queries(_scene(), is_vf)
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 64, size=(pq.n, 3)) / 128.0
    hi = lo + rng.integers(1, 64, size=(pq.n, 3)) / 128.0
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    err = np.array(jtypes.numerical_error_bound(jq, is_vf, False))
    ms = np.zeros(pq.n, np.float32)
    ref = jinclusion(jq, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(err), jnp.asarray(ms), is_vf)
    got = root_finder.inclusion(
        pq, torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(err),
        torch.from_numpy(ms), is_vf,
    )
    for a, b in zip(ref, got):
        assert np.array_equal(_bits(a), _bits(b.numpy()))


def _solve_all(pq, is_vf, toi_init=1.0, valid=None):
    rows = solver.pack_query_rows(pq, is_vf, 0.0, TOL)
    if valid is None:
        valid = torch.ones((pq.n,), dtype=torch.bool)
    return solver.solve_packed_reference(rows, valid, is_vf, toi_init, TOL)


@pytest.mark.parametrize("name", ["cloth", "soup"])
@pytest.mark.parametrize("is_vf", [True, False])
def test_plain_solver_matches_bfs(name, is_vf):
    jq, pq = _queries(_scene(name), is_vf)
    ref = find_roots_bfs(
        jq, jnp.ones((jq.n,), bool), is_vf, toi_init=jnp.float32(1.0),
        ms=jnp.float32(0.0), tolerance=jnp.float32(TOL), max_iterations=-1,
    )
    toi, ovf, checks = _solve_all(pq, is_vf)
    assert float(toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert int(checks) > 0


@pytest.mark.parametrize("is_vf", [True, False])
def test_plain_solver_matches_pallas_kernel_interpret(is_vf):
    jq, pq = _queries(_scene(), is_vf)
    toi_k, _, _ = pallas_find_roots(
        jq, jnp.ones((jq.n,), bool), is_vf, jnp.float32(1.0), jnp.float32(0.0),
        jnp.float32(TOL), interpret=True,
    )
    toi, _, _ = _solve_all(pq, is_vf)
    assert float(toi) == pytest.approx(float(toi_k), abs=1e-7)


def test_plain_solver_respects_toi_init_and_valid_mask():
    _, pq = _queries(_scene(), True)
    toi_full, _, _ = _solve_all(pq, True)
    assert 0.0 < float(toi_full) < 1.0
    tight = float(toi_full) * 0.5
    toi_t, _, _ = _solve_all(pq, True, toi_init=tight)
    assert float(toi_t) == pytest.approx(tight, rel=1e-6)
    toi_m, ovf, checks = _solve_all(pq, True, valid=torch.zeros((pq.n,), dtype=torch.bool))
    assert float(toi_m) == 1.0 and int(checks) == 0 and not bool(ovf)


def test_plain_solver_no_contact_keeps_one():
    """A vertex moving parallel above a triangle never touches it."""
    z = torch.zeros(1, 3, dtype=torch.float32)
    tri = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    p0s = torch.tensor([[0.2, 0.2, 0.5]])
    q = types.CCDQueries(
        p0s=p0s, p1s=tri[0:1], p2s=tri[1:2], p3s=tri[2:3],
        p0e=p0s + torch.tensor([[0.1, 0.0, 0.0]]), p1e=tri[0:1] + z,
        p2e=tri[1:2] + z, p3e=tri[2:3] + z,
    )
    toi, ovf, checks = _solve_all(q, True)
    assert float(toi) == 1.0 and not bool(ovf) and int(checks) >= 1


def test_solver_wrapper_on_cpu_is_the_plain_version():
    _, pq = _queries(_scene(), False)
    rows = solver.pack_query_rows(pq, False, 0.0, TOL)
    valid = torch.ones((pq.n,), dtype=torch.bool)
    before = solver.LAUNCHES_BY_MODE.total
    got = solver.solve_packed(rows, valid, False, 1.0, TOL)
    ref = solver.solve_packed_reference(rows, valid, False, 1.0, TOL)
    assert solver.LAUNCHES_BY_MODE.total == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        solver.solve_packed(rows.to("meta"), valid.to("meta"), False, 1.0, TOL)
