"""The escalation's round-limited first pass once per chunk, on the CPU.

The narrow loop runs the first, round-limited pass of the staged escalation
once over each chunk of a phase's candidates (the columns kernel C packs,
at most 2^20 rows) and then makes each batch's decision on its segment of
the chunk's ``unfin`` plane: pool or solve now (the frame pool), small or
full (the batch ladder, with its later stages).  With ``narrow_batch``
1,024 and the chunk cap lowered to three batches, on ``cloth_on_sphere(36,
2)`` (3,273 VF and 10,392 EE candidates: 2 and 4 chunks), every case:

- gives JAX ``fused_ccd``'s TOI within ``abs=1e-7`` (its kernels in Pallas
  interpret mode, as ``tests/test_torch_escalation.py`` runs them), the
  port's unbounded TOI bitwise, JAX's totals and its ``solver_capped``;
- makes one launch of the ladder's first limit per chunk, over the whole
  chunk, and none per batch;
- at round limit 0, where every valid row is left unfinished whatever the
  seed, makes the same later launches (rows, valid rows, limits), in the
  same order, as the loop that runs the first pass once per batch.
"""

import jax.numpy as jnp
import pytest
import torch

from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.pipeline.fused import fused_ccd as jax_fused_ccd
from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.config import normalize_round_limits
from scalable_ccd_tpu_torch.ops import gather_pack as gp
from scalable_ccd_tpu_torch.ops import solver
from scalable_ccd_tpu_torch.pipeline import fused as port_fused
from scalable_ccd_tpu_torch.pipeline import narrow as port_narrow

torch.set_num_threads(2)

CPU = dict(device="cpu")
F32 = jnp.float32
PB = solver.POOL_BLOCK
BATCH = 1024
#: (escalate_pool, escalate_rounds) of the frames held to JAX
CASES = [("frame", 0), ("frame", 4), ("batch", 0), ("batch", 4), ("batch", (0, 4))]


@pytest.fixture(scope="module")
def scene():
    s = jscenes.cloth_on_sphere(grid_n=36, sphere_subdiv=2, drop=0.3, seed=1)
    return (s.vertices_t0, s.vertices_t1, s.edges, s.faces)


@pytest.fixture(scope="module")
def jax_refs(scene):
    """JAX ``fused_ccd`` with its kernels in interpret mode, once per pool:
    the frame pool at 4 rounds and the batch ladder ``(0, 4)``."""
    args = tuple(jnp.asarray(a, t) for a, t in zip(scene, (F32, F32, jnp.int32, jnp.int32)))
    return {pool: jax_fused_ccd(*args, solver="pallas", dtype=F32, vf_budget=1 << 14,
                                ee_budget=1 << 14, escalate_rounds=rounds, escalate_pool=pool)
            for pool, rounds in (("frame", 4), ("batch", (0, 4)))}


@pytest.fixture(scope="module")
def unbounded(scene):
    return fused_ccd(*scene, escalate_rounds=-1, narrow_batch=BATCH, presample=False, **CPU)


def _recorded(mp, calls):
    """Record every kernel B call (rows, valid rows, round limit, skip) in
    ``calls``, through the names the pipeline and the solver call."""
    real = solver.solve_cols

    def recorded(cols, valid, is_vf, toi_init, *a, round_limit=-1, skip_if_done=False, **kw):
        out = real(cols, valid, is_vf, toi_init, *a, round_limit=round_limit,
                   skip_if_done=skip_if_done, **kw)
        calls.append({"q": cols.shape[1], "valid": int(valid.sum()), "is_vf": bool(is_vf),
                      "round_limit": round_limit, "skip": skip_if_done,
                      "checks": int(out[2])})
        return out

    mp.setattr(solver, "solve_cols", recorded)
    mp.setattr(port_narrow, "solve_cols", recorded)


def _frame(scene, mp, pool, rounds, batch=BATCH, per_batch=False):
    """``(result, launches)`` of one frame with the chunk cap at three
    batches; ``per_batch`` runs the first pass once per batch instead."""
    calls = []
    mp.setattr(gp, "CHUNK_ROWS", 3 * batch + 7)
    _recorded(mp, calls)
    if per_batch:
        mp.setattr(port_fused, "_frame_pool_loop", _frame_pool_per_batch)
        mp.setattr(port_narrow.NarrowSolver, "solve_chunk", _solve_chunk_per_batch)
    res = fused_ccd(*scene, escalate_pool=pool, escalate_rounds=rounds, narrow_batch=batch,
                    presample=False, **CPU)
    return res, calls


@pytest.fixture(scope="module")
def runs(scene):
    """Every case of ``CASES`` once: ``{case: (result, launches)}``."""
    out = {}
    for pool, rounds in CASES:
        with pytest.MonkeyPatch.context() as mp:
            out[pool, rounds] = _frame(scene, mp, pool, rounds)
    return out


def _frame_pool_per_batch(stream, budget, nar, toi, checks, capped):
    """The frame pool with its bounded pass once per batch, as the port ran
    it before the pass moved to the chunk."""
    dev, batch = toi.device, stream.batch
    cap = -(-min(port_fused._FRAME_POOL_MAX, max(port_fused._FRAME_POOL_MIN, budget >> 6))
            // PB) * PB
    pool = torch.empty((solver.ROW_WIDTH, cap + 2 * PB), dtype=nar.row_dtype, device=dev)
    cur = torch.zeros((), dtype=torch.int64, device=dev)
    lane = torch.arange(PB, device=dev)
    ones = torch.ones((max(batch, PB),), dtype=torch.bool, device=dev)
    for start in range(0, stream.n, batch):
        cols = stream.cols(start, min(start + batch, stream.n))
        q = cols.shape[1]
        toi_b, ovf, ck, unfin = nar.solve_rows(cols, ones[:q], toi,
                                               round_limit=int(nar.round_limit),
                                               skip_if_done=True)
        toi = torch.minimum(toi, toi_b)
        checks, capped = checks + ck, capped | ovf
        cum = torch.cumsum(unfin, 0)
        cnt = cum[-1]
        pooled = (cnt > 0) & (cnt <= PB) & (cur <= cap)
        idx = torch.searchsorted(cum, lane + 1).clamp_(max=q - 1)
        dest = torch.where(pooled, cur, cap + PB) + lane
        pool.index_copy_(1, dest, cols.index_select(1, idx))
        cur = cur + torch.where(pooled, cnt, 0)
        toi2, ovf2, ck2 = nar.solve_rows(cols, unfin & ~pooled, toi)
        toi = torch.minimum(toi, toi2)
        checks, capped = checks + ck2, capped | ovf2
    n_pool = int(cur)
    for s in range(0, n_pool, PB):
        block = pool[:, s:min(s + PB, n_pool)]
        toi2, ovf2, ck2 = nar.solve_rows(block, ones[:block.shape[1]], toi, skip_if_done=True)
        toi = torch.minimum(toi, toi2)
        checks, capped = checks + ck2, capped | ovf2
    return toi, checks, capped


def _solve_chunk_per_batch(self, cols, toi, batch):
    """``NarrowSolver.solve_chunk`` with the whole ladder once per batch
    (``solve_batch``), as the port ran it before the first pass moved to
    the chunk."""
    ovf = torch.zeros((), dtype=torch.bool)
    checks = torch.zeros((), dtype=torch.int64)
    for s in range(0, cols.shape[1], batch):
        toi_b, ovf_b, ck_b = self.solve_batch(cols[:, s:s + batch], toi, skip_if_done=True)
        toi = torch.minimum(toi, toi_b)
        ovf, checks = ovf | ovf_b, checks + ck_b
    return toi, ovf, checks


@pytest.mark.parametrize("pool,rounds", CASES)
def test_chunk_pass_matches_jax_and_unbounded(runs, jax_refs, unbounded, pool, rounds):
    res, calls = runs[pool, rounds]
    ref = jax_refs[pool]
    assert not bool(res.overflowed) and not bool(ref.overflowed)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert float(res.toi) == float(unbounded.toi)
    totals = (int(res.vf_total), int(res.ee_total))
    assert totals == (int(ref.vf_total), int(ref.ee_total))
    assert totals == (int(unbounded.vf_total), int(unbounded.ee_total))
    assert bool(res.solver_capped) == bool(ref.solver_capped)
    assert sum(c["checks"] for c in calls) == int(res.total_checks)


@pytest.mark.parametrize("pool,rounds", CASES)
def test_one_first_pass_per_chunk(runs, pool, rounds):
    """The ladder's first limit runs once per chunk of 3,072 rows (and a
    shorter last one), over the chunk, skipping once the TOI is 0; a later
    stage of a ladder runs per batch, over its pool of ``K`` rows."""
    res, calls = runs[pool, rounds]
    limits = normalize_round_limits(rounds)
    for is_vf, total in ((True, int(res.vf_total)), (False, int(res.ee_total))):
        mine = [c for c in calls if c["is_vf"] == is_vf]
        firsts = [c for c in mine if c["round_limit"] == limits[0]]
        assert [c["q"] for c in firsts] == [min(3 * BATCH, total - c0)
                                            for c0 in range(0, total, 3 * BATCH)]
        assert all(c["skip"] and c["valid"] == c["q"] for c in firsts)
        later = [c for c in mine if c["round_limit"] >= 0 and c["round_limit"] != limits[0]]
        batches = [min(BATCH, total - s) for s in range(0, total, BATCH)]
        if len(limits) > 1:
            assert [c["q"] for c in later] == [min(4 * PB, -(-q // PB) * PB) for q in batches]
        else:
            assert not later


@pytest.mark.parametrize("pool,batch,pool_min", [
    ("frame", BATCH, None), ("frame", BATCH, PB), ("frame", 4 * BATCH, None),
    ("batch", BATCH, None), ("batch", 16 * BATCH, None),
], ids=["frame_pool", "frame_pool_full", "frame_solve_now", "ladder_small", "ladder_full"])
def test_round_limit_zero_decisions_equal_per_batch_loop(scene, unbounded, pool, batch,
                                                         pool_min):
    """At round limit 0 a batch's unfinished rows are its valid rows, so
    the pool / solve-now / small / full decisions (every launch after the
    first passes: its rows, valid rows and limit) are those of the loop
    that runs the first pass once per batch, on the same chunks: pooled
    batches, a pool that fills after three batches, batches of more than a
    pool block, the ladder's pool and its unbounded pass over the EE
    batch of 10,392."""
    out = {}
    for per_batch in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if pool_min is not None:
                mp.setattr(port_fused, "_FRAME_POOL_MIN", pool_min)
            res, calls = _frame(scene, mp, pool, 0, batch, per_batch)
        assert float(res.toi) == float(unbounded.toi) and not bool(res.overflowed)
        out[per_batch] = [(c["is_vf"], c["q"], c["valid"], c["round_limit"])
                          for c in calls if c["round_limit"] != 0]
    assert out[False] == out[True]
    if pool == "frame":
        now = [v for _, q, v, rl in out[False] if rl < 0 and q == batch and v]
        assert bool(now) == (pool_min is not None or batch > PB)
    else:
        full = [v for vf, q, v, rl in out[False] if rl < 0 and q > 4 * PB]
        assert full == ([int(unbounded.ee_total)] if batch > 4 * PB else [])
