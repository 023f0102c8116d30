"""PyTorch port vs the JAX package: the precision path, on the CPU.

``dtype=float64`` and ``precision="compensated"``: the same numpy inputs go
through both packages.  Bars, as the JAX suite holds its own f64 paths:

- f64 boxes, sorts (major and congestion ordering), tolerances, error
  bounds (plain and compensated) and packed rows bitwise; the partner
  planes against numpy (the JAX packer holds f32 planes only);
- the f64 pair sets of the plain sweep (whole, ranged, ``any_order``,
  records) equal to JAX ``detect_overlaps`` on f64 boxes and to the port's
  brute-force oracle, and a subset of the f32 set;
- the plain f64 solver's global TOI within ``1e-7`` of JAX
  ``find_roots_bfs`` on the same f64 queries (seen: equal bitwise on these
  scenes); per-query TOIs within ``1e-12`` of the JAX solver run op by op
  (``jax.disable_jit``: jitted, XLA contracts ``a * b + c`` into FMAs) and
  within ``rel=1e-9, abs=1e-12`` of the scalar f64 oracle
  (``tests/test_narrow_phase.py:174``);
- ``fused_ccd(dtype=float64)``, ``ccd()`` and ``ipc_ccd_strategy()`` with
  ``CCDConfig(dtype="float64")`` against their JAX counterparts: TOI
  ``abs=1e-7``, pair totals equal, hit keys equal under ``collisions=``;
- ``precision="compensated"`` against JAX's: TOI ``abs=1e-6`` (the port
  evaluates in native f64 where JAX evaluates in double-word f32, so an
  inclusion decision can flip in the last bits and move a TOI by a
  tolerance step).

Each JAX run is made once per module and shared by the port's cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_ccd_tpu import ccd as jccd
from scalable_ccd_tpu import ipc_ccd_strategy as jipc
from scalable_ccd_tpu.broad_phase import detect_overlaps as jdetect
from scalable_ccd_tpu.broad_phase import merge_two_lists as jmerge
from scalable_ccd_tpu.broad_phase import sort_boxes as jsort
from scalable_ccd_tpu.config import CCDConfig as JCCDConfig
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.narrow_phase import find_roots_bfs
from scalable_ccd_tpu.narrow_phase import types as jtypes
from scalable_ccd_tpu.pipeline.fused import fused_ccd as jfused
from scalable_ccd_tpu_torch import CCDConfig, ccd, fused_ccd, ipc_ccd_strategy
from scalable_ccd_tpu_torch.broad_phase import (
    brute_force_overlaps,
    merge_two_lists,
    sort_boxes,
)
from scalable_ccd_tpu_torch.geometry import aabb
from scalable_ccd_tpu_torch.interop import (
    config_from_jax,
    from_numpy_boxes,
    from_numpy_queries,
    fused_kwargs_from_jax,
)
from scalable_ccd_tpu_torch.narrow_phase import ccd_query_oracle, types
from scalable_ccd_tpu_torch.narrow_phase.root_finder import search_caps
from scalable_ccd_tpu_torch.ops import solver, sweep_ap, sweep_records
from scalable_ccd_tpu_torch.pipeline.policy import resolve_knobs

torch.set_num_threads(2)

TOL = 1e-6
F64 = jnp.float64
CPU = dict(device="cpu")


def _bits(x):
    a = np.asarray(x)
    return a.view({4: np.int32, 8: np.int64}[a.itemsize]) if a.dtype.kind == "f" else a


def _same_fields(jax_value, port_value):
    for name in port_value._fields:
        a, b = np.asarray(getattr(jax_value, name)), getattr(port_value, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), name


def _set(pairs, n=None):
    p = np.asarray(pairs if n is None else pairs[: int(n)])
    return set(map(tuple, p.tolist()))


@pytest.fixture(scope="module")
def cloth():
    return jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35)


def _args(s):
    return s.vertices_t0, s.vertices_t1, s.edges, s.faces


def _jax_boxes(s, radius=0.0, dtype=F64):
    vb = jaabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, inflation_radius=radius,
                                  dtype=dtype)
    return vb, jaabb.build_edge_boxes(vb, s.edges), jaabb.build_face_boxes(vb, s.faces)


def _port_boxes(s, radius=0.0, dtype=torch.float64):
    vb = aabb.build_vertex_boxes(torch.from_numpy(s.vertices_t0),
                                 torch.from_numpy(s.vertices_t1), radius, dtype)
    return (vb, aabb.build_edge_boxes(vb, torch.from_numpy(s.edges)),
            aabb.build_face_boxes(vb, torch.from_numpy(s.faces)))


# ---- boxes, sorts, planes ------------------------------------------------------

@pytest.mark.parametrize("radius", [0.0, 1e-3])
def test_f64_boxes_bitwise(cloth, radius):
    for jb, pb in zip(_jax_boxes(cloth, radius), _port_boxes(cloth, radius)):
        assert pb.min.dtype == torch.float64
        _same_fields(jb, pb)


def test_f64_boxes_of_zero_coordinates_bitwise():
    """``nextafter(0, -inf)`` is the smallest f64 subnormal: the port's
    explicit flush must do in f64 what XLA does on the CPU."""
    v0 = np.array([[0.0, 0.0, 0.0], [1.0, -0.0, 2.0], [0.5, 1e-310, -1e-310]])
    v1 = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    for radius in (0.0, 1e-3):
        jb = jaabb.build_vertex_boxes(v0, v1, inflation_radius=radius, dtype=F64)
        pb = aabb.build_vertex_boxes(torch.from_numpy(v0), torch.from_numpy(v1), radius,
                                     torch.float64)
        _same_fields(jb, pb)


@pytest.fixture(scope="module")
def phases(cloth):
    """``{two_lists: (JAX unsorted f64 boxes, port's)}``."""
    jvb, jeb, jfb = _jax_boxes(cloth)
    vb, eb, fb = _port_boxes(cloth)
    return {True: (jmerge(jvb, jfb), merge_two_lists(vb, fb)), False: (jeb, eb)}


@pytest.mark.parametrize("bucket_minor", [False, True])
@pytest.mark.parametrize("two_lists", [True, False])
def test_f64_sort_bitwise(phases, two_lists, bucket_minor):
    jb, pb = phases[two_lists]
    sb = sort_boxes(pb, bucket_minor=bucket_minor)
    assert sb.major_min.dtype == torch.float64
    _same_fields(jsort(jb, bucket_minor=bucket_minor), sb)
    _same_fields(jsort(jb, bucket_minor=bucket_minor), sort_boxes(from_numpy_boxes(jb),
                                                                  bucket_minor=bucket_minor))


def test_f64_partner_planes(phases):
    sb = sort_boxes(phases[False][1], bucket_minor=True)
    pl = sweep_ap.partner_planes(sb)
    assert {p.dtype for p in pl} == {torch.float64}
    mm = sb.major_min.numpy()
    assert np.array_equal(pl.fwd_min.numpy(), np.minimum.accumulate(mm[::-1])[::-1])
    rows = -(-sb.n // 128)
    for r in range(rows):
        sl = slice(128 * r, 128 * (r + 1))
        assert float(pl.row_umin[r]) == float(sb.minor_min[sl, 0].min())
        assert float(pl.row_umax[r]) == float(sb.minor_max[sl, 0].max())


# ---- pair sets -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pairs(phases):
    """JAX's f64 candidate pairs per phase (``detect_overlaps``)."""
    return {two: _set(jdetect(jsort(jb), is_two_lists=two)) for two, (jb, _) in phases.items()}


@pytest.mark.parametrize("two_lists", [True, False])
def test_f64_pair_sets_equal_jax_and_brute_force(cloth, phases, jax_pairs, two_lists):
    _, pb = phases[two_lists]
    want = jax_pairs[two_lists]
    vb, eb, fb = _port_boxes(cloth)
    assert want == _set(brute_force_overlaps(vb, fb) if two_lists else brute_force_overlaps(eb))
    major, bucket = sort_boxes(pb), sort_boxes(pb, bucket_minor=True)
    whole = sweep_ap.sweep_pairs(major, two_lists, 1 << 14)
    assert int(whole[2]) == len(want) > 0 and _set(whole[0], whole[1]) == want
    ranged = set()
    for b0 in range(0, major.n, 97):
        ranged |= _set(*sweep_ap.sweep_pairs(major, two_lists, 1 << 14,
                                             box_range=(b0, b0 + 97))[:2])
    assert ranged == want
    any_order = sweep_ap.sweep_pairs(bucket, two_lists, 1 << 14, any_order=True)
    assert _set(any_order[0], any_order[1]) == want
    for sb, ao in ((major, False), (bucket, True)):
        rec, n_rec, n_pairs, ovf = sweep_records.sweep_records(sb, two_lists, 1 << 14,
                                                               any_order=ao)
        assert int(n_pairs) == len(want) and not bool(ovf)
        cum = sweep_records.records_pair_prefix(rec, n_rec)
        dec, _ = sweep_records.decode_records_range(sb, rec, cum, 0, int(n_pairs), 0, two_lists)
        assert _set(dec) == want
    # f32 boxes are rounded outward: a superset
    b32 = _port_boxes(cloth, dtype=torch.float32)
    f32 = sort_boxes(merge_two_lists(b32[0], b32[2]) if two_lists else b32[1])
    assert want <= _set(*sweep_ap.sweep_pairs(f32, two_lists, 1 << 14)[:2])


def test_sweep_rejects_mixed_dtypes(phases):
    sb = sort_boxes(phases[False][1])
    bad = sb._replace(major_max=sb.major_max.float())
    with pytest.raises(ValueError, match="major_max must be torch.float64"):
        sweep_ap.check_boxes(bad, "sweep_pairs")
    with pytest.raises(ValueError, match="float32 or float64"):
        sweep_ap.check_boxes(sb._replace(major_min=sb.major_min.half()), "sweep_pairs")


# ---- queries, tolerances, filters, rows --------------------------------------------

@pytest.fixture(scope="module")
def queries(cloth, jax_pairs):
    """``{is_vf: (JAX f64 queries, the port's from the same pairs)}``."""
    s = cloth
    v0, v1 = jnp.asarray(s.vertices_t0, F64), jnp.asarray(s.vertices_t1, F64)
    vcat = types.concat_frames(torch.from_numpy(s.vertices_t0),
                               torch.from_numpy(s.vertices_t1), torch.float64)
    out = {}
    for is_vf in (True, False):
        pairs = np.array(sorted(jax_pairs[is_vf]), np.int32)
        tp = torch.from_numpy(pairs)
        if is_vf:
            jq = jtypes.gather_vf_queries(v0, v1, s.faces, jnp.asarray(pairs), dtype=F64)
            pq = types.gather_vf_queries(
                vcat, types.pack_face_table(vcat, torch.from_numpy(s.faces)), tp)
        else:
            jq = jtypes.gather_ee_queries(v0, v1, s.edges, jnp.asarray(pairs), dtype=F64)
            pq = types.gather_ee_queries(
                types.pack_edge_table(vcat, torch.from_numpy(s.edges)), tp)
        out[is_vf] = (jq, pq)
    return out


def _jax_rows(jq, is_vf, ms, compensated=False):
    """The JAX queue solver's packed rows (``bfs.py:109-125``)."""
    dt = jq.p0s.dtype
    ms_arr = jnp.broadcast_to(jnp.asarray(ms, dt), (jq.n,))
    err = jtypes.numerical_error_bound(jq, is_vf, ms > 0, compensated)
    tol = jtypes.compute_tolerance(jq, is_vf, jnp.asarray(TOL, dt))
    return np.concatenate([*map(np.asarray, jq), tol, err, ms_arr[:, None]], axis=1)


@pytest.mark.parametrize("is_vf", [True, False])
def test_f64_queries_tolerances_and_bounds_bitwise(queries, is_vf):
    jq, pq = queries[is_vf]
    assert pq.p0s.dtype == torch.float64 and pq.n > 0
    _same_fields(jq, pq)
    a = jtypes.compute_tolerance(jq, is_vf, jnp.asarray(TOL, F64))
    assert np.array_equal(_bits(a), _bits(types.compute_tolerance(pq, is_vf, TOL).numpy()))
    for use_ms in (False, True):
        for comp in (False, True):
            a = jtypes.numerical_error_bound(jq, is_vf, use_ms, comp)
            b = types.numerical_error_bound(pq, is_vf, use_ms, comp)
            assert np.array_equal(_bits(a), _bits(b.numpy())), (use_ms, comp)


@pytest.mark.parametrize("ms", [0.0, 1e-4])
@pytest.mark.parametrize("is_vf", [True, False])
def test_f64_and_compensated_rows_bitwise(cloth, queries, is_vf, ms):
    jq, pq = queries[is_vf]
    rows = solver.pack_query_rows(pq, is_vf, ms, TOL)
    assert rows.dtype == torch.float64 and rows.shape == (pq.n, 31)
    assert np.array_equal(_bits(_jax_rows(jq, is_vf, ms)), _bits(rows.numpy()))
    # compensated: f32 queries, the compensated filter in the err columns
    jq32 = jtypes.CCDQueries(*[jnp.asarray(f, jnp.float32) for f in jq])
    pq32 = types.CCDQueries(*[f.float() for f in pq])
    rows32 = solver.pack_query_rows(pq32, is_vf, ms, TOL, compensated=True)
    assert rows32.dtype == torch.float32
    assert np.array_equal(_bits(_jax_rows(jq32, is_vf, ms, True)), _bits(rows32.numpy()))
    plain = solver.pack_query_rows(pq32, is_vf, ms, TOL)
    assert torch.equal(rows32[:, :27], plain[:, :27]) and (rows32[:, 27:30] < plain[:, 27:30]).all()


# ---- the plain solver in f64 --------------------------------------------------------

def _valid(n):
    return torch.ones((n,), dtype=torch.bool)


@pytest.fixture(scope="module")
def jax_solves(queries):
    """``{is_vf: (jitted global result, op-by-op per-query TOIs)}`` of JAX
    ``find_roots_bfs`` on the f64 queries."""
    out = {}
    for is_vf, (jq, _) in queries.items():
        kw = dict(toi_init=F64(1.0), ms=F64(0.0), tolerance=F64(TOL))
        glob = find_roots_bfs(jq, jnp.ones((jq.n,), bool), is_vf, **kw)
        with jax.disable_jit():
            pq = find_roots_bfs(jq, jnp.ones((jq.n,), bool), is_vf, toi_per_query=True,
                                tile=1 << 13, frontier_capacity=1 << 15, **kw)
        assert not np.asarray(pq.overflow).any() and not np.asarray(glob.overflow).any()
        out[is_vf] = (glob, np.asarray(pq.per_query_toi))
    return out


@pytest.mark.parametrize("is_vf", [True, False])
def test_f64_plain_solver_global_toi_matches_bfs(queries, jax_solves, is_vf):
    _, pq = queries[is_vf]
    rows = solver.pack_query_rows(pq, is_vf, 0.0, TOL)
    toi, ovf, checks = solver.solve_packed_reference(rows, _valid(pq.n), is_vf, 1.0, TOL)
    ref = jax_solves[is_vf][0]
    assert toi.dtype == torch.float64 and not bool(ovf) and int(checks) > 0
    assert float(toi) == pytest.approx(float(ref.toi), abs=1e-7)
    # the wrapper on CPU tensors is the plain version
    got = solver.solve_packed(rows, _valid(pq.n), is_vf, 1.0, TOL)
    assert float(got[0]) == float(toi) and int(got[2]) == int(checks)


@pytest.mark.parametrize("is_vf", [True, False])
def test_f64_per_query_tois_match_jax_op_by_op(queries, jax_solves, is_vf):
    _, pq = queries[is_vf]
    rows = solver.pack_query_rows(pq, is_vf, 0.0, TOL)
    toi, ovf, _, tpq = solver.solve_packed_reference(rows, _valid(pq.n), is_vf, 1.0, TOL,
                                                     per_query=True)
    ref = jax_solves[is_vf][1]
    got = tpq.numpy()
    assert tpq.dtype == torch.float64 and not bool(ovf)
    assert np.array_equal(got < 1, ref < 1) and np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.any() and np.abs(got[fin] - ref[fin]).max() <= 1e-12
    assert float(toi) == float(got.min())
    # the lockstep DFS (the kernel's order) under a cap that does not bind
    _, _, _, dfs = solver.solve_packed_reference(rows, _valid(pq.n), is_vf, 1.0, TOL,
                                                 per_query=True, max_iterations=1_000_000)
    assert np.abs(dfs.numpy()[fin] - ref[fin]).max() <= 1e-12


@pytest.mark.parametrize("is_vf", [True, False])
def test_f64_per_query_tois_match_the_scalar_oracle(queries, is_vf):
    _, pq = queries[is_vf]
    rows = solver.pack_query_rows(pq, is_vf, 0.0, TOL)
    _, _, _, tpq = solver.solve_packed_reference(rows, _valid(pq.n), is_vf, 1.0, TOL,
                                                 per_query=True)
    hits = torch.nonzero(torch.isfinite(tpq)).flatten()[:4].tolist()
    misses = torch.nonzero(torch.isinf(tpq)).flatten()[:2].tolist()
    assert hits
    for i in hits + misses:
        pts = rows[i, :24].reshape(8, 3).numpy()
        want, _, overflow = ccd_query_oracle(pts, is_vf, tolerance=TOL, stack_capacity=512)
        assert not overflow
        assert float(tpq[i]) == pytest.approx(want, rel=1e-9, abs=1e-12), i


def test_f64_caps_and_widened_rows(queries):
    """f64 searches get 128 levels and 52 splits per dimension, widened
    rows f32's 24 and f32's cull limit; a widened solve's TOI is an exact
    f32 value."""
    assert search_caps(torch.float32) == search_caps(torch.float32, False)
    assert (search_caps(torch.float64).max_depth, search_caps(torch.float64).dim_cap) == (128, 52)
    wide = search_caps(torch.float64, widened=True)
    assert (wide.max_depth, wide.dim_cap) == (128, 24)
    assert wide.uv_limit == search_caps(torch.float32).uv_limit
    assert wide.uv_limit > search_caps(torch.float64).uv_limit
    _, pq = queries[True]
    pq32 = types.CCDQueries(*[f.float() for f in pq])
    rows = solver.pack_query_rows(pq32, True, 0.0, TOL, compensated=True).double()
    toi, ovf, _ = solver.solve_packed_reference(rows, _valid(pq.n), True, 1.0, TOL, widened=True)
    assert toi.dtype == torch.float64 and float(toi) == float(toi.float()) and not bool(ovf)
    with pytest.raises(ValueError, match="widened rows are float64"):
        solver.solve_packed_reference(rows.float(), _valid(pq.n), True, 1.0, TOL, widened=True)
    with pytest.raises(ValueError, match="float32 or float64"):
        solver.solve_packed_reference(rows.half(), _valid(pq.n), True, 1.0, TOL)


# ---- the pipelines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f64(cloth):
    """One JAX run of each f64 entry point on the cloth scene."""
    hits = []
    res = jfused(*_args(cloth), dtype=F64)
    jfused(*_args(cloth), dtype=F64, collisions=hits)
    cfg = JCCDConfig(dtype="float64")
    return {"fused": res, "hits": hits, "cfg": cfg,
            "ccd": jccd(*_args(cloth), config=cfg),
            "ipc": jipc(*_args(cloth), min_distance=1e-3, config=cfg)}


@pytest.mark.parametrize("kw", [
    dict(), dict(sweep_impl="records"), dict(bucket_minor=True),
    dict(escalate_rounds=8), dict(escalate_rounds=(4, 32), sweep_impl="records"),
    dict(escalate_rounds=8, escalate_pool="frame"),
], ids=["defaults", "records", "bucket", "ladder", "records-ladder", "frame-pool"])
def test_fused_f64_matches_jax(cloth, jax_f64, kw):
    ref = jax_f64["fused"]
    res = fused_ccd(*_args(cloth), **fused_kwargs_from_jax(dtype=F64), **kw, **CPU)
    assert res.toi.dtype == torch.float64
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))
    assert not bool(res.overflowed) and not bool(res.solver_capped)
    assert 0.0 < float(res.toi) < 1.0


def test_fused_f64_collisions_match_jax(cloth, jax_f64):
    hits = []
    res = fused_ccd(*_args(cloth), dtype=torch.float64, collisions=hits, **CPU)
    ref = sorted(jax_f64["hits"])
    assert [h[:2] for h in sorted(hits)] == [h[:2] for h in ref] and hits
    assert float(res.toi) == pytest.approx(min(h[2] for h in ref), abs=1e-7)
    # jitted JAX per-pair TOIs sit within a tolerance step (module docstring)
    assert max(abs(a[2] - b[2]) for a, b in zip(sorted(hits), ref)) <= 1e-5


def test_ccd_and_ipc_f64_match_jax(cloth, jax_f64):
    cfg = config_from_jax(jax_f64["cfg"])
    assert cfg == CCDConfig(dtype="float64") and cfg.torch_dtype == torch.float64
    toi = ccd(*_args(cloth), config=cfg, **CPU)
    assert toi == pytest.approx(jax_f64["ccd"], abs=1e-7)
    assert toi == pytest.approx(float(jax_f64["fused"].toi), abs=1e-7)
    for impl in ("chunked", "fused"):
        got = ipc_ccd_strategy(*_args(cloth), min_distance=1e-3, config=cfg, impl=impl, **CPU)
        assert got == pytest.approx(jax_f64["ipc"], abs=1e-7), impl


@pytest.fixture(scope="module")
def jax_compensated(cloth):
    return {"fused": jfused(*_args(cloth), precision="compensated"),
            "ccd": jccd(*_args(cloth), config=JCCDConfig(precision="compensated"))}


@pytest.mark.parametrize("kw", [dict(), dict(sweep_impl="records", escalate_rounds=8)],
                         ids=["defaults", "records-ladder"])
def test_fused_compensated_matches_jax(cloth, jax_compensated, kw):
    ref = jax_compensated["fused"]
    res = fused_ccd(*_args(cloth), **fused_kwargs_from_jax(precision="compensated"), **kw, **CPU)
    assert res.toi.dtype == torch.float32
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-6)
    assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))
    assert not bool(res.overflowed) and not bool(res.solver_capped)
    # the compensated filter is tighter than f32's: never earlier than f32
    f32 = fused_ccd(*_args(cloth), **CPU)
    assert float(res.toi) >= float(f32.toi) - 1e-6


def test_ccd_compensated_matches_jax(cloth, jax_compensated):
    cfg = config_from_jax(JCCDConfig(precision="compensated"))
    toi = ccd(*_args(cloth), config=cfg, **CPU)
    assert toi == pytest.approx(jax_compensated["ccd"], abs=1e-6)
    assert toi == float(np.float32(toi))
    hits = []
    assert ccd(*_args(cloth), config=cfg, collisions=hits, **CPU) == pytest.approx(toi, abs=1e-6)
    assert min(h[2] for h in hits) == pytest.approx(toi, abs=1e-6)


def test_precision_arguments():
    s = jscenes.cloth_on_sphere(grid_n=6, sphere_subdiv=0, drop=0.2)
    with pytest.raises(ValueError, match="unknown precision 'double'"):
        fused_ccd(*_args(s), precision="double", **CPU)
    with pytest.raises(ValueError, match="unknown dtype"):
        fused_ccd(*_args(s), dtype=torch.float16, **CPU)
    with pytest.raises(ValueError, match="f64 already"):
        fused_ccd(*_args(s), dtype="float64", precision="compensated", **CPU)
    with pytest.raises(ValueError, match="no counterpart"):
        fused_kwargs_from_jax(solver="bfs")
    assert fused_kwargs_from_jax(dtype=F64, precision="compensated") == {
        "dtype": "float64", "precision": "compensated"}
    a = fused_ccd(*_args(s), dtype="float64", **CPU)
    b = fused_ccd(*_args(s), dtype=torch.float64, **CPU)
    assert float(a.toi) == float(b.toi) and a.toi.dtype == torch.float64


def test_auto_policies_follow_the_jax_solver_choice():
    """For f64 and compensated requests the JAX package solves with its
    queue solver: no auto escalation, the batch pool; explicit knobs hold."""
    plain = resolve_knobs(1000, 1000)
    assert (plain.escalate_rounds, plain.escalate_pool) == (128, "frame")
    wide = resolve_knobs(1000, 1000, plain_f32=False)
    assert (wide.escalate_rounds, wide.escalate_pool) == (-1, "batch")
    assert wide._replace(escalate_rounds=128, escalate_pool="frame") == plain
    asked = resolve_knobs(1000, 1000, plain_f32=False, escalate_rounds=64)
    assert (asked.escalate_rounds, asked.escalate_pool) == (64, "batch")
    frame = resolve_knobs(1000, 1000, plain_f32=False, escalate_rounds=64,
                          escalate_pool="frame")
    assert frame.escalate_pool == "frame"
