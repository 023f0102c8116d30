"""The narrow loop's decisions on the device, on the CPU.

``fused_ccd`` keeps the loop's choices in device scalars (module docstring
of ``pipeline/fused.py``): the frame pool's pool / solve-now / pool-full
choice, the batch ladder's skip / small / full choice and the ``toi > 0``
exit (kernel B's ``skip_if_done``).  Each case forces one branch with
``escalate_rounds`` 0 (every row unfinished after its first pass) or a
limit no row reaches, and a small ``narrow_batch``, records every kernel B
call of the frame (rows, valid rows, round limit, seed, checks) to show
that the branch ran, and holds the frame to JAX ``fused_ccd`` on the same
scene: TOI within ``abs=1e-7``, pair totals exact.  The JAX frame runs once
(its CPU path, the XLA sweep and queue solver); no Pallas interpret call.
Then the exit on the golden ``dense-cluster`` scene in f32, whose TOI is 0:
the batches after the TOI reached 0 add no checks.  Last, the chunks kernel
C packs (the chunk cap lowered to three batches): each branch on both
``sweep_impl``s against JAX, one pack call per chunk, the exact modes
from records against pairs, and the unbounded loop's one kernel B call per
chunk against JAX and, bit for bit, against one call per batch.
"""

import os

import jax.numpy as jnp
import pytest
import torch

from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.pipeline.fused import fused_ccd as jax_fused_ccd
from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.geometry import edges_from_faces, read_ply
from scalable_ccd_tpu_torch.ops import gather_pack as gp
from scalable_ccd_tpu_torch.ops import solver
from scalable_ccd_tpu_torch.pipeline import fused as port_fused
from scalable_ccd_tpu_torch.pipeline import narrow as port_narrow

torch.set_num_threads(2)

CPU = dict(device="cpu")
PB = solver.POOL_BLOCK
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def scene():
    """``cloth_on_sphere(36, 2)``: 3,273 VF and 10,392 EE candidates, so an
    EE batch of 16,384 holds more unfinished rows than the ladder's pool
    (four pool blocks, 8,192 rows)."""
    s = jscenes.cloth_on_sphere(grid_n=36, sphere_subdiv=2, drop=0.3, seed=1)
    return (s.vertices_t0, s.vertices_t1, s.edges, s.faces)


@pytest.fixture(scope="module")
def reference(scene):
    return jax_fused_ccd(*scene, dtype=jnp.float32)


@pytest.fixture
def launches(monkeypatch):
    """Every kernel B call of the frames run in the test, in order: a dict
    of its rows ``q``, valid rows, round limit, ``skip_if_done``, seed, the
    TOI it returned and checks."""
    calls = []
    real = solver.solve_cols

    def recorded(cols, valid, is_vf, toi_init, *a, round_limit=-1, skip_if_done=False,
                 **kw):
        out = real(cols, valid, is_vf, toi_init, *a, round_limit=round_limit,
                   skip_if_done=skip_if_done, **kw)
        calls.append({"q": cols.shape[1], "valid": int(valid.sum()), "is_vf": is_vf,
                      "round_limit": round_limit, "skip": skip_if_done,
                      "seed": float(toi_init), "toi": float(out[0]),
                      "checks": int(out[2])})
        return out

    monkeypatch.setattr(solver, "solve_cols", recorded)
    monkeypatch.setattr(port_narrow, "solve_cols", recorded)
    return calls


def _same_as_jax(res, ref):
    assert not bool(res.overflowed) and not bool(ref.overflowed)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert (int(res.vf_total), int(res.ee_total)) == (int(ref.vf_total), int(ref.ee_total))
    assert not bool(res.solver_capped)


def _unbounded(calls):
    """The unbounded calls of a frame pool run: the solve-now passes (made
    whatever the TOI) and the pool's blocks (which skip once it is 0)."""
    free = [c for c in calls if c["round_limit"] < 0]
    return [c for c in free if not c["skip"]], [c for c in free if c["skip"]]


@pytest.mark.parametrize("branch", ["pool", "solve_now", "pool_full"])
def test_frame_pool_branches_match_jax(scene, reference, launches, monkeypatch, branch):
    """``pool``: batches of 1,024 unfinished rows join the pool, whose
    blocks are solved after the loop; ``solve_now``: batches of more than
    one pool block are solved at once; ``pool_full``: a pool of 2,048 rows
    fills after three batches of 1,024 in each phase, and later batches are
    solved at once."""
    batch = {"pool": 1024, "solve_now": 4096, "pool_full": 1024}[branch]
    if branch == "pool_full":
        monkeypatch.setattr(port_fused, "_FRAME_POOL_MIN", PB)
    res = fused_ccd(*scene, escalate_rounds=0, escalate_pool="frame", narrow_batch=batch,
                    presample=False, **CPU)
    _same_as_jax(res, reference)
    now, blocks = _unbounded(launches)
    assert sum(c["checks"] for c in launches) == int(res.total_checks)
    assert all(c["round_limit"] == 0 and c["skip"] for c in launches if c["round_limit"] >= 0)
    solved_now = [c["valid"] for c in now if c["valid"]]
    pooled = sum(c["valid"] for c in blocks)
    if branch == "pool":
        assert not solved_now and pooled == int(res.vf_total) + int(res.ee_total)
        assert all(c["q"] <= PB and c["valid"] == c["q"] for c in blocks)
    elif branch == "solve_now":
        assert not blocks and min(solved_now) > PB
    else:
        assert pooled == 2 * 3 * 1024 and solved_now and max(solved_now) <= PB


@pytest.mark.parametrize("branch", ["skip", "small", "full"])
def test_batch_ladder_branches_match_jax(scene, reference, launches, branch):
    """``skip``: no row is left after a first pass of 10^6 rounds, and both
    second passes have no valid row; ``small``: a batch's unfinished rows
    (at most four pool blocks) are pooled into one block-aligned pass;
    ``full``: the EE batch of 10,392 unfinished rows is solved over the
    batch."""
    rounds, batch = {"skip": (1 << 20, 1024), "small": (0, 1024), "full": (0, 1 << 14)}[branch]
    res = fused_ccd(*scene, escalate_rounds=rounds, escalate_pool="batch", narrow_batch=batch,
                    presample=False, **CPU)
    _same_as_jax(res, reference)
    assert sum(c["checks"] for c in launches) == int(res.total_checks)
    # one first pass per phase (its one chunk), then (small, full) per batch
    firsts = [i for i, c in enumerate(launches) if c["round_limit"] >= 0]
    assert len(firsts) == 2 and all(launches[i]["skip"] for i in firsts)
    for i in firsts:
        first = launches[i]
        sizes = [min(batch, first["q"] - s) for s in range(0, first["q"], batch)]
        rest = launches[i + 1:i + 1 + 2 * len(sizes)]
        for q, small, full in zip(sizes, rest[0::2], rest[1::2]):
            assert small["round_limit"] < 0 and full["round_limit"] < 0
            assert small["q"] == min(4 * PB, -(-q // PB) * PB) and full["q"] == q
            if branch == "skip":
                assert small["valid"] == full["valid"] == 0
            elif branch == "small":
                assert small["valid"] == q and full["valid"] == 0
    if branch == "full":
        ee = [launches[i:i + 3] for i in firsts if not launches[i]["is_vf"]]
        assert len(ee) == 1 and ee[0][0]["q"] == int(res.ee_total) > 4 * PB
        assert ee[0][1]["valid"] == 0 and ee[0][2]["valid"] == int(res.ee_total)


@pytest.mark.parametrize("kw", [dict(escalate_rounds=0, presample=False),
                                dict(escalate_pool="batch"), dict(escalate_rounds=-1)])
def test_exit_on_device_after_toi_reaches_zero(launches, monkeypatch, kw):
    """``dense-cluster`` in f32 collapses to a TOI of 0, in the sixth EE
    batch of 256; from then on every launch that the JAX loop's ``toi > 0``
    guards is skipped on the device and adds no checks: the first pass of
    every later batch (the batch ladder), the launch of every later chunk
    (the plain loop, one launch per chunk, here with the chunk cap at one
    batch), or the pool's later block (the frame pool, where every row is
    pooled), and the frame's checks are those of the launches before."""
    if kw.get("escalate_rounds") == -1:
        monkeypatch.setattr(gp, "CHUNK_ROWS", 256 + 7)
    v0, f = read_ply(os.path.join(GOLDEN, "dense-cluster", "frames", "f0.ply"))
    v1, _ = read_ply(os.path.join(GOLDEN, "dense-cluster", "frames", "f1.ply"))
    res = fused_ccd(v0, v1, edges_from_faces(f), f, narrow_batch=256, **kw, **CPU)
    assert float(res.toi) == 0.0 and not bool(res.overflowed)
    zero = next(i for i, c in enumerate(launches) if c["seed"] <= 0)
    later = [c for c in launches[zero:] if c["skip"]]
    assert later and all(c["checks"] == 0 for c in later)
    assert len(later) >= (1 if "presample" in kw else 8)
    assert sum(c["checks"] for c in launches) == int(res.total_checks)


@pytest.mark.parametrize("branch", ["small", "full"])
def test_batch_ladder_of_two_stages_matches_jax(scene, reference, launches, branch):
    """A ladder ``(0, 2)`` makes every stage's choice on the device: the
    first pass over the phase's chunk, then per batch the rest of the
    ladder over the ``K``-row pool (a pass of 2 rounds and its own pool and
    unbounded passes), then the unbounded pass over the batch, each of them
    skipping once the TOI is 0.  ``small``:
    batches of 1,024 are pooled and the ladder's second stage solves them;
    ``full``: the EE batch of 10,392 unfinished rows overflows the pool, is
    solved over the batch, and the second stage has no valid row."""
    batch = {"small": 1024, "full": 1 << 14}[branch]
    res = fused_ccd(*scene, escalate_rounds=(0, 2), escalate_pool="batch", narrow_batch=batch,
                    presample=False, **CPU)
    _same_as_jax(res, reference)
    assert sum(c["checks"] for c in launches) == int(res.total_checks)
    firsts = [i for i, c in enumerate(launches) if c["round_limit"] == 0]
    sizes = {i: [min(batch, launches[i]["q"] - s) for s in range(0, launches[i]["q"], batch)]
             for i in firsts}
    assert len(firsts) == 2 and len(launches) == sum(1 + 4 * len(n) for n in sizes.values())
    for i in firsts:
        first = launches[i]
        assert first["skip"]
        for k, q in enumerate(sizes[i]):
            inner, inner_small, inner_full, full = launches[i + 1 + 4 * k:i + 5 + 4 * k]
            pool = min(4 * PB, -(-q // PB) * PB)
            assert all(c["skip"] for c in (inner, inner_small, inner_full, full))
            assert inner["round_limit"] == 2
            assert all(c["round_limit"] < 0 for c in (inner_small, inner_full, full))
            assert inner["q"] == inner_small["q"] == inner_full["q"] == pool
            assert full["q"] == q
            overflows = q > pool  # round 0 leaves every valid row unfinished
            assert inner["valid"] == (0 if overflows else q)
            assert full["valid"] == (q if overflows else 0)
            assert overflows == (branch == "full" and not first["is_vf"])


@pytest.fixture
def packs(monkeypatch):
    """The narrow loop's kernel C calls of the frames run in the test, in
    order: ``(mode, is_vf, rows)``, ``mode`` "pairs" or "records", with
    the chunk cap lowered to three batches of 1,024 and a few rows."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 3 * 1024 + 7)
    calls = []

    def counted(mode, real):
        def pack(*args, **kw):
            out = real(*args, **kw)
            is_vf = args[7] if mode == "records" else args[5]
            calls.append((mode, bool(is_vf), out.shape[1]))
            return out
        return pack

    monkeypatch.setattr(port_narrow, "gather_pack", counted("pairs", gp.gather_pack))
    monkeypatch.setattr(port_narrow, "gather_pack_records",
                        counted("records", gp.gather_pack_records))
    return calls


@pytest.mark.parametrize("sweep_impl", ["pairs", "records"])
@pytest.mark.parametrize("kw", [dict(escalate_pool="frame", escalate_rounds=0),
                                dict(escalate_pool="batch", escalate_rounds=0),
                                dict(escalate_rounds=-1)],
                         ids=["frame_pool", "ladder", "unbounded"])
def test_chunked_loop_matches_jax(scene, reference, launches, packs, sweep_impl, kw):
    """Batches of 1,024 read as column slices of chunks of three batches:
    the frame pool, the batch ladder and the unbounded loop give JAX's
    frame on both ``sweep_impl``s, kernel C packs each phase in
    ``ceil(candidates / 3,072)`` calls of the sweep's mode (chunks of 3,072
    rows and a shorter last one), the escalation's first pass and the
    unbounded loop's one pass read each chunk in one call, and under
    escalation kernel B sees every batch of 1,024: the frame pool's
    solve-now passes and the ladder's unbounded passes over the batch."""
    res = fused_ccd(*scene, narrow_batch=1024, presample=False, sweep_impl=sweep_impl, **kw,
                    **CPU)
    _same_as_jax(res, reference)
    assert sum(c["checks"] for c in launches) == int(res.total_checks)
    for is_vf, total in ((True, int(res.vf_total)), (False, int(res.ee_total))):
        rows = [q for mode, vf, q in packs if vf == is_vf]
        chunks = [min(3072, total - c) for c in range(0, total, 3072)]
        batches = [min(1024, total - s) for s in range(0, total, 1024)]
        assert {mode for mode, vf, _ in packs if vf == is_vf} == {sweep_impl}
        assert rows == chunks
        firsts = [c["q"] for c in launches if c["is_vf"] == is_vf and c["skip"]
                  and c["round_limit"] == kw["escalate_rounds"]]
        assert firsts == chunks
        free = [c for c in launches if c["is_vf"] == is_vf and c["round_limit"] < 0]
        if kw.get("escalate_pool") == "frame":  # the solve-now passes
            assert [c["q"] for c in free if not c["skip"]] == batches
        elif kw.get("escalate_pool") == "batch":  # (pool, batch) per batch
            assert [c["q"] for c in free[1::2]] == batches


@pytest.mark.parametrize("mode", ["collisions", "ipc_refine"])
def test_chunked_exact_modes_records_equal_pairs(packs, monkeypatch, mode):
    """``collisions=`` (the hits' ids written beside the chunk's rows) and
    ``ipc_refine`` (every pair's ids, then key-ordered pair rows) on chunks
    of three batches of 256 give the same frame and hits from records as
    from pairs, and as with one chunk a phase, on ``cloth_on_sphere(24,
    2)`` (1,462 VF and 4,729 EE candidates)."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 3 * 256 + 7)
    s = jscenes.cloth_on_sphere(grid_n=24, sphere_subdiv=2, drop=0.3)
    scene = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    out = {}
    for impl in ("pairs", "records"):
        hits = [] if mode == "collisions" else None
        kw = dict(collisions=hits) if mode == "collisions" else dict(ipc_refine=True)
        res = fused_ccd(*scene, narrow_batch=256, sweep_impl=impl, **kw, **CPU)
        out[impl] = (float(res.toi).hex(), int(res.vf_total), int(res.ee_total),
                     int(res.ipc_refinements), hits)
    assert out["pairs"] == out["records"]
    assert len([m for m, _, _ in packs if m == "records"]) >= 2 + 7
    if mode == "collisions":
        assert out["pairs"][4]
        monkeypatch.setattr(gp, "CHUNK_ROWS", 1 << 20)
        hits = []
        fused_ccd(*scene, narrow_batch=256, collisions=hits, **CPU)
        assert hits == out["pairs"][4]


def _solve_chunk_per_batch(self, cols, toi, batch):
    """``NarrowSolver.solve_chunk`` of an unbounded chunk as the port ran it
    before the chunk became one launch: one ``solve_batch`` per batch."""
    ovf = torch.zeros((), dtype=torch.bool)
    checks = torch.zeros((), dtype=torch.int64)
    for s in range(0, cols.shape[1], batch):
        toi_b, ovf_b, ck_b = self.solve_batch(cols[:, s:s + batch], toi, skip_if_done=True)
        toi = torch.minimum(toi, toi_b)
        ovf, checks = ovf | ovf_b, checks + ck_b
    return toi, ovf, checks


def _seeded_by_the_chunks_before(calls):
    """Each call is seeded with the running TOI: the minimum of 1 and of
    every TOI the calls before it returned."""
    running = 1.0
    for c in calls:
        assert c["seed"] == running
        running = min(running, c["toi"])


@pytest.mark.parametrize("sweep_impl", ["pairs", "records"])
def test_unbounded_chunk_is_one_launch(scene, reference, launches, packs, monkeypatch,
                                       sweep_impl):
    """With escalation off, each chunk of three batches of 1,024 is one
    kernel B call over the chunk's columns, with ``skip_if_done``, seeded
    with the TOI of the chunks before it: one call per kernel C pack.  The
    frame is JAX's (TOI within ``abs=1e-7``, totals exact), its checks the
    calls' sum, and its TOI, totals and flags those of one call per batch,
    bit for bit."""
    kw = dict(escalate_rounds=-1, narrow_batch=1024, presample=False, sweep_impl=sweep_impl,
              **CPU)
    res = fused_ccd(*scene, **kw)
    calls = list(launches)
    _same_as_jax(res, reference)
    assert sum(c["checks"] for c in calls) == int(res.total_checks)
    _seeded_by_the_chunks_before(calls)
    for is_vf, total in ((True, int(res.vf_total)), (False, int(res.ee_total))):
        chunks = [min(3072, total - c) for c in range(0, total, 3072)]
        mine = [c for c in calls if c["is_vf"] == is_vf]
        assert [c["q"] for c in mine] == chunks == [q for _, vf, q in packs if vf == is_vf]
        assert all(c["skip"] and c["round_limit"] < 0 and c["valid"] == c["q"] for c in mine)
    monkeypatch.setattr(port_narrow.NarrowSolver, "solve_chunk", _solve_chunk_per_batch)
    loop = fused_ccd(*scene, **kw)
    assert [c["q"] for c in launches[len(calls):] if not c["is_vf"]] == [
        min(1024, int(res.ee_total) - s) for s in range(0, int(res.ee_total), 1024)]
    assert float(res.toi).hex() == float(loop.toi).hex()
    for name in ("vf_total", "ee_total", "overflowed", "solver_capped"):
        assert int(getattr(res, name)) == int(getattr(loop, name)), name


def test_unbounded_chunks_after_toi_reaches_zero_add_no_checks(launches, monkeypatch):
    """``dense-cluster`` in f32 (1,193 VF and 3,690 EE candidates) with
    escalation off, batches of 256 and chunks of three batches: the TOI
    reaches 0 in the second EE chunk, and each later chunk's one call is
    seeded with 0, skipped on the device and adds no checks; the TOI is
    the per-batch loop's."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 3 * 256 + 7)
    v0, f = read_ply(os.path.join(GOLDEN, "dense-cluster", "frames", "f0.ply"))
    v1, _ = read_ply(os.path.join(GOLDEN, "dense-cluster", "frames", "f1.ply"))
    args = (v0, v1, edges_from_faces(f), f)
    kw = dict(escalate_rounds=-1, narrow_batch=256, presample=False, **CPU)
    res = fused_ccd(*args, **kw)
    calls = list(launches)
    assert float(res.toi) == 0.0 and not bool(res.overflowed)
    vf, ee = int(res.vf_total), int(res.ee_total)
    assert [c["q"] for c in calls] == [min(768, n - c) for n in (vf, ee)
                                        for c in range(0, n, 768)]
    _seeded_by_the_chunks_before(calls)
    zero = next(i for i, c in enumerate(calls) if c["toi"] <= 0)
    later = calls[zero + 1:]
    assert not calls[zero]["is_vf"] and len(later) >= 2
    assert all(c["skip"] and c["seed"] == 0 and c["checks"] == 0 for c in later)
    assert sum(c["checks"] for c in calls) == int(res.total_checks)
    monkeypatch.setattr(port_narrow.NarrowSolver, "solve_chunk", _solve_chunk_per_batch)
    loop = fused_ccd(*args, **kw)
    assert float(loop.toi) == 0.0 and (int(loop.vf_total), int(loop.ee_total)) == (vf, ee)
