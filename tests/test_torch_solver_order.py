"""The property kernel B's sharing of domains rests on, on the CPU.

Kernel B (``csrc/solver.cu``) hands domains of one query between the lane
groups of a block in its unbounded global and per-query modes, which
changes the order in which a query's domains are evaluated.  That is sound
because in those modes the TOIs do not depend on the order: accepting,
rejecting and the caps are decisions of the domain alone, and pruning drops
only domains at or after an accepted time.  Here the plain frontier
(``ops/solver.py:solve_packed_reference``) runs with its tile, the number of
domains it pops per round, set to 1 (depth first), 7, 256 and 2^16: the
global TOI and every per-query TOI must be bitwise the same, and equal to
the JAX queue solver's on the same queries, run op by op
(``jax.disable_jit``; jitted, XLA contracts ``a * b + c`` into fused
multiply-adds, ROADMAP section 3).

Rows: candidates of ``cloth_on_sphere(12, 1, drop=0.35)`` (VF and EE, f32
and f64, ``ms`` 0 and 1e-3).  A depth-first plain solve takes one domain
per round, so each case keeps a subset: sixteen rows spread over those
whose search ends within 24 rounds, and rows in contact.  With ``ms = 0``
those are the two with the earliest contact that a 256-check search
already finds; with ``ms = 1e-3`` every contact costs thousands of
evaluations, so the subset holds one, the contact that costs its search
least (found by solving every contact row alone; ``CHEAPEST_CONTACT``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_ccd_tpu.broad_phase import brute_force_overlaps
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.narrow_phase import find_roots_bfs
from scalable_ccd_tpu.narrow_phase import types as jtypes
from scalable_ccd_tpu_torch.interop import from_numpy_queries
from scalable_ccd_tpu_torch.ops import solver

torch.set_num_threads(2)

TOL = 1e-6
TILES = (1, 7, 256, 1 << 16)
CASES = [(is_vf, dt, ms) for is_vf in (True, False) for dt in ("f32", "f64")
         for ms in (0.0, 1e-3)]
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
#: with ms = 1e-3, the candidate row (brute-force order) whose contact costs
#: its per-query search the fewest evaluations: 3,015 (VF f32), 2,881 (VF
#: f64), 4,373 and 4,025 (EE), against up to ~10,000 for other contacts
CHEAPEST_CONTACT = {(True, "f32"): 200, (True, "f64"): 239, (False, "f32"): 707,
                    (False, "f64"): 707}


def _case_id(case):
    is_vf, dt, ms = case
    return f"{'vf' if is_vf else 'ee'}-{dt}-ms{ms:g}"


@pytest.fixture(scope="module")
def queries():
    """``{(is_vf, dt): JAX CCDQueries}`` of every brute-force candidate."""
    s = jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35)
    out = {}
    for dt, (jdt, _) in DTYPES.items():
        v0, v1 = jnp.asarray(s.vertices_t0, jdt), jnp.asarray(s.vertices_t1, jdt)
        vb = jaabb.build_vertex_boxes(v0, v1, dtype=jdt)
        vf = jnp.asarray(brute_force_overlaps(vb, jaabb.build_face_boxes(vb, s.faces)))
        ee = jnp.asarray(brute_force_overlaps(jaabb.build_edge_boxes(vb, s.edges)))
        out[True, dt] = jtypes.gather_vf_queries(v0, v1, s.faces, vf, dtype=jdt)
        out[False, dt] = jtypes.gather_ee_queries(v0, v1, s.edges, ee, dtype=jdt)
    return out


def _rows(q, is_vf, ms):
    return solver.pack_query_rows(from_numpy_queries(q), is_vf, ms, TOL)


@pytest.fixture(scope="module")
def subsets(queries):
    """``{case: (port rows, JAX per-query TOIs, their minimum)}`` of each
    case's subset (module docstring)."""
    out = {}
    for case in CASES:
        is_vf, dt, ms = case
        q = queries[is_vf, dt]
        full = _rows(q, is_vf, ms)
        n = full.shape[0]
        ones = torch.ones((n,), dtype=torch.bool)
        unfin = solver.solve_packed_reference(full, ones, is_vf, float("inf"), TOL,
                                              round_limit=24)[3]
        short = torch.nonzero(~unfin).flatten()
        spread = short[torch.linspace(0, short.numel() - 1, 16).long()]
        if ms == 0:
            capped = solver.solve_packed_reference(full, ones, is_vf, 1.0, TOL,
                                                   per_query=True, max_iterations=256)[3]
            contact = torch.argsort(capped)[:2]
            assert bool(torch.isfinite(capped[contact]).all())
        else:
            contact = torch.tensor([CHEAPEST_CONTACT[is_vf, dt]])
        pick = torch.unique(torch.cat([contact, spread]))
        jq = jtypes.CCDQueries(*[f[pick.numpy()] for f in q])
        jdt = DTYPES[dt][0]
        with jax.disable_jit():
            ref = find_roots_bfs(jq, jnp.ones((jq.n,), bool), is_vf, toi_init=jdt(1.0),
                                 ms=jdt(ms), tolerance=jdt(TOL), toi_per_query=True,
                                 tile=1 << 13, frontier_capacity=1 << 15)
        assert not np.asarray(ref.overflow).any()
        out[case] = (full[pick].contiguous(), np.asarray(ref.per_query_toi),
                     float(np.asarray(ref.per_query_toi).min()))
    return out


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_tois_do_not_depend_on_the_order(subsets, monkeypatch, case, tile):
    is_vf, dt, _ = case
    rows, ref_pq, ref_min = subsets[case]
    monkeypatch.setattr(solver, "_TILE", tile)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool)
    toi, ovf, _ = solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL)
    ptoi, povf, _, pq = solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL,
                                                      per_query=True)
    assert pq.dtype == DTYPES[dt][1] and not bool(ovf) and not bool(povf)
    assert np.array_equal(pq.numpy(), ref_pq)  # bitwise, JAX op by op
    assert (pq < 1).sum() >= 1
    assert float(toi) == float(ptoi) == min(1.0, ref_min)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_least_checks_are_the_seeded_work_of_any_order(subsets, monkeypatch, case):
    """The work a kernel B bound is computed from: the plain frontier seeded
    with the answer evaluates the same domains whatever its tile, the same
    number as the depth-first search seeded with the final TOI, and no
    more than an unseeded search in either mode."""
    is_vf, _, _ = case
    rows = subsets[case][0]
    valid = torch.ones((rows.shape[0],), dtype=torch.bool)
    toi, _, _, pq = solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL, per_query=True)
    dfs = solver.solve_packed_reference(rows, valid, is_vf, toi, TOL, round_limit=1 << 20)
    assert not bool(dfs[3].any())
    got = set()
    for tile in TILES:
        monkeypatch.setattr(solver, "_TILE", tile)
        least = solver._least_checks(rows, valid, is_vf, toi, TOL)
        least_pq = solver._least_checks(rows, valid, is_vf, toi, TOL, per_query_toi=pq)
        assert least <= int(solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL)[2])
        assert least_pq <= int(solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL,
                                                             per_query=True)[2])
        got.add((least, least_pq))
    assert got == {(int(dfs[2]), least_pq)}


def test_checks_spread():
    """The work spread read from kernel B's per-query checks plane: a group
    of rows runs as long as its longest member."""
    plane = torch.tensor([1, 2, 3, 10] * 8 + [4] * 4, dtype=torch.int64)
    got = solver._checks_spread(plane)
    assert got["queries"] == 36 and got["max"] == 10 and got["mean"] == 144 / 36
    assert got["p50"] == 3.0
    # groups of 32: one full group (max 10), one of the last four rows (max 4)
    assert got["lane_efficiency_32"] == pytest.approx(144 / (32 * 10 + 32 * 4))
    # groups of 4: eight of max 10, one of max 4
    assert got["lane_efficiency_4"] == pytest.approx(144 / (8 * 4 * 10 + 4 * 4))
    assert solver._checks_spread(plane[:0]) == {"queries": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        solver._solve_query_checks(torch.zeros((2, 31)), torch.ones(2, dtype=torch.bool),
                                   True, 1.0, TOL)
