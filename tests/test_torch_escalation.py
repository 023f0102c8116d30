"""PyTorch port vs the JAX package: kernel B's ``round_limit`` mode, the
escalation ladder, the frame straggler pool and the congested main path of
``fused_ccd``, on the CPU.

The JAX solver runs in Pallas interpret mode on the scenes of
``tests/test_pallas_solver.py:308-480``; the port runs the plain versions of
its kernels.  Bars: with the shared TOI seeded at the final TOI (so no
query can lower it and each query's search is fixed) the bounded pass's
``unfin`` plane and check count equal JAX's; escalated TOIs, single limits
and ladders, equal the port's unbounded TOI bitwise (no conservative accept
fires on these scenes); ``fused_ccd`` with the congested knobs (one limit
per batch in the frame pool, a ladder in the batch pool) and ``ccd()``
with escalation give JAX's TOI within ``abs=1e-7`` and its pair totals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu import ccd as jax_ccd
from scalable_ccd_tpu.config import CCDConfig as JCCDConfig
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.narrow_phase import types as jtypes
from scalable_ccd_tpu.ops import pallas_solver as jsolver
from scalable_ccd_tpu.pipeline.fused import fused_ccd as jax_fused_ccd
from scalable_ccd_tpu_torch import CCDConfig, ccd, fused_ccd
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb
from scalable_ccd_tpu_torch.interop import (
    config_from_jax,
    from_numpy_scene,
    fused_kwargs_from_jax,
)
from scalable_ccd_tpu_torch.narrow_phase import types
from scalable_ccd_tpu_torch.ops import solver, sweep_ap
from scalable_ccd_tpu_torch.pipeline import fused as port_fused

torch.set_num_threads(2)

TOL = 1e-6
F32 = jnp.float32
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def queries():
    """``{is_vf: (JAX CCDQueries, JAX rows, port rows)}`` of every candidate
    of the solver tests' cloth scene (372 VF, 1,160 EE), gathered by the
    port (its queries and rows are bitwise the JAX package's,
    ``test_torch_narrow_phase.py``) and handed to JAX as arrays."""
    s = from_numpy_scene(jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35))
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    vcat = types.concat_frames(s.vertices_t0, s.vertices_t1, torch.float32)
    out = {}
    for is_vf in (True, False):
        if is_vf:
            sb = sort_boxes(merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)))
        else:
            sb = sort_boxes(aabb.build_edge_boxes(vb, s.edges))
        pairs, n, _, _ = sweep_ap.sweep_pairs(sb, is_vf, 1 << 14)
        pairs = pairs[: int(n)]
        if is_vf:
            q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, s.faces), pairs)
        else:
            q = types.gather_ee_queries(types.pack_edge_table(vcat, s.edges), pairs)
        rows = solver.pack_query_rows(q, is_vf, 0.0, TOL)
        jq = jtypes.CCDQueries(*[jnp.asarray(f.numpy()) for f in q])
        out[is_vf] = (jq, jnp.asarray(rows.numpy()), rows)
    return out


def _ones(n):
    return torch.ones((n,), dtype=torch.bool)


@pytest.mark.parametrize("is_vf,limit", [(True, 25), (False, 5)])
def test_bounded_pass_matches_jax_when_seeded(queries, is_vf, limit):
    """Seeded with the final TOI, the round-limited pass explores the same
    domains in JAX's lockstep blocks and the port's lockstep DFS: the same
    unfinished queries, the same checks, no accept."""
    _, jrows, rows = queries[is_vf]
    final, _, _ = solver.solve_packed(rows, _ones(rows.shape[0]), is_vf, 1.0, TOL)
    jtoi, jovf, jchecks, junfin = jsolver._find_roots_packed(
        jrows, jnp.ones((rows.shape[0],), jnp.int32), is_vf, F32(float(final)), F32(TOL),
        True, True, False, -1, limit)
    toi, ovf, checks, unfin = solver.solve_packed(rows, _ones(rows.shape[0]), is_vf,
                                                  final, TOL, round_limit=limit)
    assert unfin.dtype == torch.bool and 0 < int(unfin.sum()) < rows.shape[0]
    assert np.array_equal(unfin.numpy(), np.asarray(junfin) != 0)
    assert int(checks) == int(jchecks)
    assert float(toi) == float(jtoi) == float(final)
    assert not bool(ovf) and not bool(jovf)


@pytest.mark.parametrize("limits", [0, 1, 7, 30, (0, 4), (1, 7, 30)])
@pytest.mark.parametrize("is_vf", [True, False])
def test_escalation_equals_unbounded_bitwise(queries, is_vf, limits):
    """Every branch of the ladder (nothing left, a pool, the last stage
    unbounded) gives the unbounded TOI; ``checks`` counts every pass; a
    seed below every contact comes back unchanged."""
    _, _, rows = queries[is_vf]
    n = rows.shape[0]
    valid = _ones(n)
    valid[::5] = False
    ref, _, _ = solver.solve_packed(rows, valid, is_vf, 1.0, TOL)
    toi, ovf, checks = solver.solve_escalated(rows, valid, is_vf, 1.0, TOL,
                                              round_limit=limits)
    assert float(toi) == float(ref) and not bool(ovf)
    first = solver.solve_packed(rows, valid, is_vf, 1.0, TOL,
                                round_limit=solver.normalize_round_limits(limits)[0])
    assert int(checks) >= int(first[2]) and int(checks) > 0
    assert not first[3][~valid].any()
    seed = float(ref) * 0.5
    assert float(solver.solve_escalated(rows, valid, is_vf, seed, TOL,
                                        round_limit=limits)[0]) == pytest.approx(seed, rel=1e-6)


def test_escalation_full_branch(queries):
    """More unfinished rows than four pool blocks go straight to one
    unbounded pass: the EE rows tiled 8x (9,280 rows) at round limit 0."""
    _, _, rows = queries[False]
    big = rows.repeat(8, 1)
    assert big.shape[0] > 4 * solver.POOL_BLOCK
    ref, _, _ = solver.solve_packed(big, _ones(big.shape[0]), False, 1.0, TOL)
    toi, ovf, _ = solver.solve_escalated(big, _ones(big.shape[0]), False, 1.0, TOL,
                                         round_limit=(0, 4))
    assert float(toi) == float(ref) and not bool(ovf)


def test_ladder_validation_matches_jax(queries):
    for good in (None, -1, 0, 128, (), (4,), (0, 4), [1, 7, 30]):
        assert solver.normalize_round_limits(good) == jsolver._normalize_round_limits(good)
    _, _, rows = queries[True]
    for bad in ((4, 4), (8, 2), (-1, 4)):
        with pytest.raises(ValueError):
            jsolver._normalize_round_limits(bad)
        with pytest.raises(ValueError):
            solver.solve_escalated(rows, _ones(rows.shape[0]), True, 1.0, TOL, round_limit=bad)
        with pytest.raises(ValueError):
            ccd(*_args(_scene()), config=CCDConfig(escalate_rounds=bad), **CPU)
    # round_limit is a global-mode option
    for kw in (dict(per_query=True), dict(max_iterations=10)):
        with pytest.raises(ValueError):
            solver.solve_packed(rows, _ones(rows.shape[0]), True, 1.0, TOL, round_limit=8, **kw)


def _scene():
    return jscenes.cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.6)


def _args(s):
    return s.vertices_t0, s.vertices_t1, s.edges, s.faces


def _jargs(s):
    return tuple(jnp.asarray(a, t) for a, t in ((s.vertices_t0, F32), (s.vertices_t1, F32),
                                                (s.edges, jnp.int32), (s.faces, jnp.int32)))


JAX_FUSED = dict(solver="pallas", dtype=F32, vf_budget=1 << 14, ee_budget=1 << 14)


@pytest.mark.parametrize("pool,rounds", [("frame", 4), ("batch", (2, 8))])
def test_fused_congested_knobs_match_jax(pool, rounds, monkeypatch):
    """The JAX main path's congested knobs, forced below the threshold:
    the congestion ordering with the ``any_order`` sweep, staged
    escalation through ``pool`` and record emission, against JAX
    ``fused_ccd`` with the same knobs (its kernels in interpret mode).  The
    frame pool runs one limit per batch (JAX ``pallas_find_roots_bounded``),
    the batch pool a ladder (JAX ``pallas_find_roots(round_limit=(2, 8))``)."""
    s = _scene()
    jkw = dict(sweep_impl="pallas_mxu16", bucket_minor=True, escalate_rounds=rounds,
               escalate_pool=pool)
    ref = jax_fused_ccd(*_jargs(s), **JAX_FUSED, **jkw)
    kw = fused_kwargs_from_jax(**jkw)
    assert kw == dict(sweep_impl="records", bucket_minor=True, escalate_rounds=rounds,
                      escalate_pool=pool)
    plain = fused_ccd(*_args(s), bucket_minor=False, escalate_rounds=-1, **CPU)
    # batches of 2,048 put several batches in each phase
    monkeypatch.setattr(port_fused, "_NARROW_BATCH", 1 << 11)
    for variant in (kw, dict(kw, sweep_impl="pairs"), dict(kw, escalate_rounds=0),
                    dict(kw, escalate_rounds=(0, 4), escalate_pool="batch")):
        res = fused_ccd(*_args(s), **variant, **CPU)
        assert not bool(res.overflowed) and not bool(ref.overflowed)
        assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
        assert float(res.toi) == float(plain.toi)
        assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))
        assert bool(res.solver_capped) == bool(ref.solver_capped)


def test_fused_records_collisions_and_ipc_match_pairs():
    """Records through the exact modes: per-batch decode for collisions,
    the whole key-sorted stream for ``ipc_refine``."""
    s = _scene()
    hits_p, hits_r = [], []
    fused_ccd(*_args(s), collisions=hits_p, **CPU)
    fused_ccd(*_args(s), collisions=hits_r, sweep_impl="records", bucket_minor=True, **CPU)
    assert hits_p == hits_r and hits_p
    kw = dict(min_distance=1e-3, max_iterations=1_000_000, ipc_refine=True, **CPU)
    a = fused_ccd(*_args(s), **kw)
    b = fused_ccd(*_args(s), sweep_impl="records", bucket_minor=True, **kw)
    assert float(a.toi) == float(b.toi)
    assert int(a.ipc_refinements) == int(b.ipc_refinements)


def test_fused_records_auto_budget_retry(monkeypatch):
    """Undersized record budgets retry once from the exact pair and record
    totals."""
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MIN", 1)
    monkeypatch.setattr(port_fused, "_AUTO_VF_GUESS", 0)
    monkeypatch.setattr(port_fused, "_AUTO_EE_GUESS", 0)
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MEMO", {})
    calls = []
    real = port_fused.sweep_records

    def counted(sb, two, budget, rec_budget=0, **kw):
        calls.append((budget, rec_budget))
        return real(sb, two, budget, rec_budget, **kw)

    monkeypatch.setattr(port_fused, "sweep_records", counted)
    s = _scene()
    res = fused_ccd(*_args(s), sweep_impl="records", **CPU)
    ref = fused_ccd(*_args(s), **CPU)
    assert not bool(res.overflowed) and float(res.toi) == float(ref.toi)
    assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))
    assert len(calls) == 4 and calls[0] == (1, 0) and calls[2] == (1, 0)
    pow2 = lambda n: 1 << (n - 1).bit_length()  # noqa: E731
    assert calls[1][0] == pow2(int(ref.vf_total)) and calls[3][0] == pow2(int(ref.ee_total))
    assert 0 < calls[1][1] <= calls[1][0] and 0 < calls[3][1] <= calls[3][0]


def test_ccd_with_escalation_matches_jax():
    s = _scene()
    jcfg = JCCDConfig(dtype="float32", escalate_rounds=128)
    cfg = config_from_jax(jcfg)
    assert cfg.escalate_rounds == 128
    want = jax_ccd(*_args(s), config=jcfg)
    got = ccd(*_args(s), config=cfg, **CPU)
    assert got == pytest.approx(want, abs=1e-7)
    assert got == ccd(*_args(s), config=CCDConfig(escalate_rounds=-1), **CPU)
    assert got == ccd(*_args(s), config=CCDConfig(escalate_rounds=(2, 8)), **CPU)
