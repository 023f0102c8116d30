"""The fused CCD pipeline on PyTorch.

Counterpart of ``scalable_ccd_tpu/pipeline/fused.py:fused_ccd``.  In order:

1. validate the mesh, and rotate it into its principal axes if ``pca``;
2. build conservative boxes, inflated by ``min_distance``, and sort them
   (VF: vertices merged with faces, two-list; EE: edges, one-list); from
   2^20 VF boxes on, in the congestion ordering (``bucket_minor``);
3. sweep each phase into a candidate buffer of the phase's budget: pair rows
   with :func:`scalable_ccd_tpu_torch.ops.sweep_ap.sweep_pairs` (kernel A,
   ``sweep_impl="pairs"``) or bit records with
   :func:`scalable_ccd_tpu_torch.ops.sweep_records.sweep_records` (kernel
   A', ``sweep_impl="records"``), each with ``any_order`` under the
   congestion ordering;
4. take the candidates in narrow batches of ``narrow_batch`` (16,384) pairs,
   gathered and packed with tolerances, error filters and the minimum
   separation by kernel C (:mod:`scalable_ccd_tpu_torch.ops.gather_pack`)
   in chunks of whole batches, at most 2^20 rows each, one launch per chunk
   (records are decoded inside it), and solve them with kernel B
   (:mod:`scalable_ccd_tpu_torch.ops.solver`), both driven by the narrow
   layer every entry point shares (:mod:`scalable_ccd_tpu_torch.pipeline.
   narrow`): a global solve with no cap
   and no escalation is one unbounded launch per chunk, and on CUDA over a
   stream of pairs one launch per phase whose threads compute the rows from
   the pairs (kernel C is not launched), every other solve one or more
   launches per batch, a column slice of its chunk.  VF runs
   before EE and one running TOI is threaded through both; below 2^20
   boxes (or as ``presample`` says) a phase starts with one warm-start
   batch spread over its candidates, and it stops early once the TOI
   reaches 0;
5. staged escalation (``escalate_rounds``): off by default on CUDA, where
   kernel B's unbounded form shares a deep query's domains between the lane
   groups of its block (escalation splits shallow queries from deep ones
   for the TPU kernel's lockstep lanes), so each chunk, or phase of pairs,
   is one launch; 128
   rounds on the global path elsewhere, as in the JAX package, and where
   ``escalate_rounds`` or ``escalate_pool`` asks for it: below 2^20 VF
   boxes the frame straggler pool (every batch's unfinished rows after one
   bounded pass join a phase-wide pool, solved densely at the end of the
   phase), above it the per-batch ladder
   (:func:`scalable_ccd_tpu_torch.ops.solver.solve_escalated_cols`).  In both
   the bounded first pass runs once per chunk, over all its batches, and
   each batch then decides on its segment of the chunk's unfinished rows.
   Both give the unbounded TOI bitwise unless a conservative accept fires;
6. size the pair budgets automatically: a scene-proportional power-of-two
   guess, one retry from the exact totals, and a sticky memo of grown
   budgets per scene-size class.

The defaults resolve as the JAX package's do at its congestion threshold
(``fused.py:96,132-170,1880-1926``; :mod:`scalable_ccd_tpu_torch.pipeline.
policy`), with two exceptions: the port emits
pairs unless records are asked for (kernel A is the measured path), and on
CUDA auto escalation is off (step 5).

Exact modes (the JAX package's ``_phase``, ``fused.py:632-645``):

- ``collisions``: every batch is solved in per-query mode, with no
  presample, no escalation and no early exit, and each pair with a TOI
  below 1 is reported (VF as (vertex, face), EE as (edge, edge));
- ``max_iterations``: the solver's per-query check cap (bounded mode; no
  escalation);
- ``ipc_refine``: the IPC stepping rule per narrow batch.  A batch that
  drops the TOI below 1e-6 is solved again from the TOI before it, with no
  minimum separation, no cap and no zero TOI, and the TOI becomes
  ``min(before, re-solve) * 0.8``.  The refinement depends on which pairs
  share a batch, and the CUDA sweeps append in an order that changes from
  run to run; so under ``ipc_refine`` each phase's candidates are decoded
  whole and sorted by ``(id_a << 32) | id_b`` before batching, on every
  device.

Precision (the JAX package's ``dtype`` and ``precision``, ``fused.py:
1541-1553,1608-1649,1869-1883``): ``dtype`` is the working precision of
boxes, queries, tolerances, error filter and TOI, f32 or f64, and the
kernels run in it.  ``precision="compensated"`` keeps everything up to the
packed query rows in f32, packs the JAX package's compensated error filter,
widens the rows to f64 (exact) and solves them with kernel B's f64
instantiation under f32's split cap, so the TOI is exact in f32 and comes
back as f32: native f64 in place of the JAX package's double-word f32.  For
both, the JAX package's solver is its queue solver, so the auto policies
resolve to no escalation; an explicit ``escalate_rounds`` still applies.

The JAX package runs this as one XLA program; here it is eager PyTorch, with
the narrow loop's decisions on the device as the JAX package keeps them:
a phase's candidates are packed in a few kernel C launches (gather and pack,
:mod:`scalable_ccd_tpu_torch.ops.gather_pack`, one per chunk of at most
2^20 rows, sized from the pair count the host already holds).  At the
defaults on CUDA a phase of pairs is one unbounded kernel B launch that
computes its rows itself, with no column buffer (records: one launch per
chunk over its columns), so the host iterates no batch; with escalation the
round-limited first pass is one launch over the chunk and every batch
kernel B launches on its slice of the chunk.  The ``toi > 0`` exit is
kernel B's ``skip_if_done`` (a phase, chunk or batch after the TOI reached
0 does nothing); the frame pool's pool/solve-now choice and the batch ladder's skip/small/
full choice are predicates on device scalars.  The host reads a fixed
number of scalars per phase, whatever the number of batches:

- each phase's sweep totals, and the overflow flag of an auto budget (the
  retry from the exact totals);
- under the frame pool, its cursor, once per phase, to size the pool's pass;
- the result, which the caller reads.

Paths that keep host reads per batch: the exact modes (``collisions=``
reads each batch's hits; ``ipc_refine`` tests each batch's TOI against
``IPC_MIN_TOI``), the per-query modes of the chunked ``ccd()`` (its global
solves read once a broad chunk) and ``sharded_ccd`` (a check per batch, which keeps its
collectives uniform).

Tracing (:mod:`scalable_ccd_tpu_torch.utils.profiler`): while a
``torch.profiler`` runs, a call records the spans ``sccd.fused_ccd`` (the
call), ``sccd.upload`` (checks, validation, upload, knobs and budgets),
``sccd.boxes`` (step 2), per phase ``sccd.phase.vf`` / ``sccd.phase.ee``
with ``sccd.tables``, ``sccd.sweep`` (step 3 with its totals read and
retry) and ``sccd.narrow`` (steps 4-5), and inside it ``sccd.presample``,
``sccd.pack`` (a chunk's kernel C launch), ``sccd.first_pass`` (a chunk's
round-limited pass), ``sccd.batches`` (a chunk's per-batch loop, or a
chunk's or phase's one unbounded launch) and ``sccd.pool`` (the frame pool's
cursor read and dense pass); and the counters ``batches`` (the narrow
batches the host iterates: the presample's and those of the per-batch
paths), ``chunk_solves`` (chunks, or on CUDA phases of pairs, solved with
one unbounded launch) and ``budget_retries``, beside the
kernels' ``launch.<kernel>.<mode>``.  None of them reads the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scalable_ccd_tpu_torch.config import check_precision
from scalable_ccd_tpu_torch.geometry.mesh import validate_mesh_inputs
from scalable_ccd_tpu_torch.ops.solver import POOL_BLOCK, ROW_WIDTH
from scalable_ccd_tpu_torch.ops.sweep_ap import partner_planes, sweep_pairs
from scalable_ccd_tpu_torch.ops.sweep_records import sweep_records
from scalable_ccd_tpu_torch.pipeline.narrow import (
    IPC_BACKOFF,
    IPC_MIN_TOI,
    NARROW_BATCH,
    NarrowSolver,
    PairStream,
    RecordStream,
    append_hits,
    key_order,
    solve_per_query,
)
from scalable_ccd_tpu_torch.pipeline.policy import (
    Knobs,
    mesh_tensors,
    pow2ceil,
    resolve_device,
    resolve_dtype,
    resolve_knobs,
    sorted_phases,
)
from scalable_ccd_tpu_torch.utils.profiler import profiler

__all__ = ["FusedCCDResult", "fused_ccd"]

#: smallest budget the auto mode picks (16k pair rows)
_AUTO_BUDGET_MIN = 1 << 14

#: auto-budget guesses, as multiples of the phase's box/edge count
_AUTO_VF_GUESS = 2
_AUTO_EE_GUESS = 4

#: sticky auto-budget resizes, keyed by the initial (vf, ee) guesses and
#: the sweep: once a frame overflows a guess, later frames of the same size
#: class start at the grown budget
_AUTO_BUDGET_MEMO: dict = {}

#: frame straggler pool rows: budget / 64, within these bounds, rounded up
#: to whole pool blocks (``fused.py:1267-1268``)
_FRAME_POOL_MIN = 1 << 14
_FRAME_POOL_MAX = 1 << 21


class FusedCCDResult(NamedTuple):
    """0-d tensors on the run's device."""

    #: earliest TOI in [0, 1]; 1.0 = no contact (valid only if not overflowed)
    toi: torch.Tensor
    #: bool — a pair budget was exceeded, candidate pairs may be missing
    overflowed: torch.Tensor
    #: int64 — exact surviving VF candidate pairs (even past the budget)
    vf_total: torch.Tensor
    #: int64 — exact surviving EE candidate pairs (even past the budget)
    ee_total: torch.Tensor
    #: int64 — narrow-phase domain evaluations
    total_checks: torch.Tensor
    #: bool — the solver took a conservative accept somewhere (stack depth
    #: or split cap); the TOI is still valid, possibly earlier than the
    #: true first contact
    solver_capped: torch.Tensor
    #: int64 — narrow batches the IPC rule refined (0 without ipc_refine)
    ipc_refinements: torch.Tensor


def _sweep_phase(sorted_boxes, is_vf, budget, auto, knobs: Knobs, nar, narrow_batch,
                 with_ids):
    """Sweep one phase; on an auto-budget overflow, sweep once more from
    the exact totals.  Returns ``(stream, n_true, overflow, budget, grew)``,
    the stream in batches of ``min(narrow_batch, budget)``, packing through
    ``nar`` (with the pairs' ids where ``with_ids``)."""
    sb = sorted_boxes
    planes = partner_planes(sb) if knobs.bucket_minor else None
    if knobs.sweep_impl == "pairs":
        def sweep(b, _rec_budget=0):
            return sweep_pairs(sb, is_vf, b, any_order=knobs.bucket_minor, planes=planes)
    else:
        def sweep(b, rec_budget=0):
            return sweep_records(sb, is_vf, b, rec_budget, any_order=knobs.bucket_minor,
                                 planes=planes)
    buf, n_first, n_true, overflow = sweep(budget)
    # pairs: (n_pairs, n_true); records: (n_records, n_pairs)
    first, total = torch.stack([n_first, n_true]).tolist()
    grew = auto and bool(overflow)
    if grew:
        profiler().count("budget_retries")
        budget = pow2ceil(total)
        buf, n_first, n_true, overflow = sweep(budget, pow2ceil(first))
    batch = min(narrow_batch, budget)
    if knobs.sweep_impl == "pairs":
        stream = PairStream(buf, min(total, budget), nar, batch)
    else:
        stream = RecordStream(sb, buf, min(first, buf.shape[0]), budget, is_vf, nar, batch,
                              with_ids)
    return stream, n_true, overflow, budget, grew


def _frame_pool_loop(stream, budget, nar: NarrowSolver, toi, checks, capped):
    """Escalation through the frame straggler pool (JAX ``fused.py:1257-1376``):
    every candidate runs one bounded pass; a batch's unfinished rows join
    the pool, unless there are more than one pool block of them or the pool
    is full, and then they are solved at once, unbounded; the pool is solved
    densely after the loop, one block per call.  Returns (toi, checks,
    capped).

    The bounded pass runs once per chunk of the stream (up to 2^20 rows,
    seeded with the running TOI at the chunk's start) rather than once per
    batch; the pool / solve-now decision is then made batch by batch on
    each batch's segment of the chunk's ``unfin`` plane.  The TOI, totals
    and flags are those of a pass per batch: a pass may prune against any
    TOI a query accepted (``ops/solver.py:solve_unfinished_cols``).

    The loop's decisions stay on the device, as the JAX ``lax.cond`` keeps
    them: the pool cursor ``cur`` is a device scalar; a batch's unfinished
    rows, gathered in order by cumsum and searchsorted, land at ``cur`` when
    ``0 < cnt <= POOL_BLOCK`` and ``cur <= cap``, else in a block past the
    pool that nothing reads; the solve-now pass launches over the batch
    with ``valid = unfin & ~pooled`` (no valid row when the rows were
    pooled).  The bounded pass and the pool blocks skip once the TOI is 0
    (``skip_if_done``).  The host reads the cursor once, to size the pool's
    pass."""
    dev, batch = toi.device, stream.batch
    cap = -(-min(_FRAME_POOL_MAX, max(_FRAME_POOL_MIN, budget >> 6)) // POOL_BLOCK) * POOL_BLOCK
    # columns [cap + POOL_BLOCK, cap + 2 * POOL_BLOCK): where a batch that is
    # not pooled writes its gathered rows
    pool = torch.empty((ROW_WIDTH, cap + 2 * POOL_BLOCK), dtype=nar.row_dtype, device=dev)
    cur = torch.zeros((), dtype=torch.int64, device=dev)
    lane = torch.arange(POOL_BLOCK, device=dev)
    ones = torch.ones((max(min(stream.chunk, stream.n), POOL_BLOCK),), dtype=torch.bool,
                      device=dev)
    prof = profiler()
    for c0 in range(0, stream.n, stream.chunk):
        chunk = stream.cols(c0, min(c0 + stream.chunk, stream.n))
        with prof.span("sccd.first_pass"):
            toi_c, ovf, ck, unfin_c = nar.solve_rows(chunk, ones[:chunk.shape[1]], toi,
                                                     round_limit=int(nar.round_limit),
                                                     skip_if_done=True)
            toi = torch.minimum(toi, toi_c)
            checks, capped = checks + ck, capped | ovf
        prof.count("batches", -(-chunk.shape[1] // batch))
        with prof.span("sccd.batches"):
            for s in range(0, chunk.shape[1], batch):
                cols, unfin = chunk[:, s:s + batch], unfin_c[s:s + batch]
                q = cols.shape[1]
                cum = torch.cumsum(unfin, 0)
                cnt = cum[-1]
                pooled = (cnt > 0) & (cnt <= POOL_BLOCK) & (cur <= cap)
                idx = torch.searchsorted(cum, lane + 1).clamp_(max=q - 1)
                # rows past cnt duplicate real rows and land past cur + cnt:
                # the next append overwrites them and the pool's pass stops
                # at cur
                dest = torch.where(pooled, cur, cap + POOL_BLOCK) + lane
                pool.index_copy_(1, dest, cols.index_select(1, idx))
                cur = cur + torch.where(pooled, cnt, 0)
                toi2, ovf2, ck2 = nar.solve_rows(cols, unfin & ~pooled, toi)
                toi = torch.minimum(toi, toi2)
                checks, capped = checks + ck2, capped | ovf2
    with prof.span("sccd.pool"):
        n_pool = int(cur)  # the loop's one host read
        for s in range(0, n_pool, POOL_BLOCK):
            block = pool[:, s:min(s + POOL_BLOCK, n_pool)]
            toi2, ovf2, ck2 = nar.solve_rows(block, ones[:block.shape[1]], toi,
                                             skip_if_done=True)
            toi = torch.minimum(toi, toi2)
            checks, capped = checks + ck2, capped | ovf2
    return toi, checks, capped


def _narrow_phase(stream, budget, presample, nar: NarrowSolver, toi, collisions,
                  ipc_refine, frame_pool):
    """Solve one phase's candidates in the stream's batches; returns (toi,
    checks, capped, refinements)."""
    dev, batch = toi.device, stream.batch
    checks = torch.zeros((), dtype=torch.int64, device=dev)
    capped = torch.zeros((), dtype=torch.bool, device=dev)
    refinements = 0
    n_pairs = stream.n
    prof = profiler()
    if collisions is not None:
        prof.count("batches", -(-n_pairs // batch))
        runs = [(s, min(s + batch, n_pairs)) for s in range(0, n_pairs, batch)]
        toi, capped, checks, ids, tois = solve_per_query(
            nar, ((stream.cols(s, e), stream.ids(s, e)) for s, e in runs), toi)
        append_hits(collisions, ids, tois)
        return toi, checks, capped, refinements

    if presample and not ipc_refine and budget >= 4 * batch and n_pairs > 0:
        # TOI warm start: one batch spread uniformly over the candidates,
        # so the loop starts from a near-final TOI (fused.py:838-852)
        prof.count("batches")
        with prof.span("sccd.presample"):
            toi_s, cap, ck = nar.solve(stream.sample(batch), toi)
            toi = torch.minimum(toi, toi_s)
            checks, capped = checks + ck, capped | cap
    if frame_pool:
        toi, checks, capped = _frame_pool_loop(stream, budget, nar, toi, checks, capped)
        return toi, checks, capped, refinements
    if not ipc_refine:
        # the reference chunk loop's `remaining_queries && toi > 0`: a
        # phase's or chunk's launch, or each batch's first one, skips on the
        # device once the TOI is 0 (skip_if_done)
        if nar.whole_phase(stream):
            if n_pairs > 0:
                toi, cap, ck = nar.solve_phase(stream, toi)
                checks, capped = checks + ck, capped | cap
            return toi, checks, capped, refinements
        for c0 in range(0, n_pairs, stream.chunk):
            toi, cap, ck = nar.solve_chunk(stream.cols(c0, min(c0 + stream.chunk, n_pairs)),
                                           toi, batch)
            checks, capped = checks + ck, capped | cap
        return toi, checks, capped, refinements
    pairs = stream.all()
    stream = PairStream(pairs[key_order(pairs)], n_pairs, nar, batch)
    start = 0
    # the IPC rule reads the TOI on the host anyway, and stops there
    while start < n_pairs and float(toi) > 0:
        prof.count("batches")
        stop = min(start + batch, n_pairs)
        toi_b, cap, ck = nar.solve_batch(stream.cols(start, stop), toi, skip_if_done=True)
        toi_after = torch.minimum(toi, toi_b)
        # compared in the working dtype, as the JAX package's in-dispatch
        # rule does
        if bool(toi_after < IPC_MIN_TOI):
            # packs its own rows, with no minimum separation
            toi_r, cap_r, ck_r = nar.solve(stream.ids(start, stop), toi, exact=True)
            toi_after = torch.minimum(toi, toi_r) * IPC_BACKOFF
            cap, ck = cap | cap_r, ck + ck_r
            refinements += 1
        toi = toi_after
        checks, capped = checks + ck, capped | cap
        start += batch
    return toi, checks, capped, refinements


def fused_ccd(
    vertices_t0,
    vertices_t1,
    edges,
    faces,
    *,
    device=None,
    validate: bool = True,
    min_distance: float = 0.0,
    tolerance: float = 1e-6,
    max_iterations: int = -1,
    allow_zero_toi: bool = True,
    collisions: list | None = None,
    ipc_refine: bool = False,
    pca: bool = False,
    vf_budget="auto",
    ee_budget="auto",
    bucket_minor="auto",
    escalate_rounds=None,
    escalate_pool="auto",
    sweep_impl: str = "pairs",
    dtype=torch.float32,
    precision: str = "f32",
    presample="auto",
    narrow_batch: int = NARROW_BATCH,
) -> FusedCCDResult:
    """Earliest time of impact of a linearly moving triangle mesh.

    Inputs are numpy arrays or tensors: ``(n, 3)`` vertices at t=0 and t=1
    (float64 or float32), ``(m, 2)`` edges and ``(k, 3)`` faces.  Everything
    runs on ``device``, CUDA unless the caller asks for another device, the
    sweeps and the solver as CUDA kernels there; ``device="cpu"`` runs
    their plain PyTorch versions.  A CUDA device on a machine without CUDA
    raises; nothing falls back to the CPU.

    ``min_distance`` is the minimum separation (boxes inflate by it and
    the solver keeps it); ``max_iterations >= 0`` caps each query's domain
    checks, dropping what lies past the cap (not conservative, as in the
    reference).  A ``collisions`` list receives every pair's
    ``(id_a, id_b, toi)`` with ``toi < 1``, VF hits first, each phase in
    id order.  ``ipc_refine`` applies the IPC stepping rule per narrow
    batch (module docstring); it has no per-pair output, so it raises with
    ``collisions``.  ``pca`` rotates the mesh into its principal axes
    first (the TOI is unchanged; candidate counts change).

    ``bucket_minor`` (``"auto"``: from 2^20 VF boxes on) sorts in the
    congestion ordering and sweeps with ``any_order``; the pair set is the
    same.  ``escalate_rounds`` (``None``: off on CUDA, where each chunk of
    up to 2^20 candidates is one unbounded solver launch, and 128 rounds on
    the global path elsewhere or with an explicit ``escalate_pool``; -1 off;
    an int or an ascending ladder) and ``escalate_pool`` (``"auto"``:
    ``"frame"`` below 2^20 VF boxes on the global path with escalation on,
    ``"batch"`` otherwise) are the staged escalation; the TOI is the
    unbounded one bitwise unless a conservative accept fires.  ``sweep_impl`` is
    ``"pairs"`` (kernel A) or ``"records"`` (kernel A').  ``presample``
    (``"auto"``: per phase below 2^20 boxes; a bool, or a ``(vf, ee)``
    pair) runs one warm-start batch spread over a phase's candidates before
    its loop, where the budget holds four batches; the TOI is the same
    either way.  See :func:`resolve_knobs`.  ``narrow_batch`` is the number
    of candidates per solver call, ``min(narrow_batch, budget)`` per phase.

    ``vf_budget``/``ee_budget`` bound the candidate pairs per phase;
    ``"auto"`` guesses from the scene size and retries a phase once from
    its exact totals on overflow, so ``overflowed`` stays False.  With
    integer budgets an overflow is reported in ``overflowed`` and the pairs
    past the budget are missing.

    ``dtype`` (``torch.float32``, ``torch.float64`` or their names) is the
    working precision of boxes, queries, tolerances, error filter and TOI;
    the kernels run in it, and ``toi`` comes back in it.  ``precision`` is
    ``"f32"`` (the working dtype) or ``"compensated"`` (f32 inputs and TOI,
    the inclusion function in native f64 with the compensated error filter;
    module docstring): co-located geometry whose separations lie below the
    f32 filter, where plain f32 collapses the TOI to 0, resolves as in f64.
    """
    prof = profiler()
    with prof.span("sccd.fused_ccd", "cuda" if device is None else device, entry="fused_ccd"):
        with prof.span("sccd.upload"):
            if collisions is not None and ipc_refine:
                raise ValueError(
                    "ipc_refine has no per-pair output (the reference discards "
                    "collisions in ipc_ccd_strategy, ipc_ccd_strategy.cu:52-54)"
                )
            if int(narrow_batch) < 1:
                raise ValueError(
                    f"narrow_batch={narrow_batch!r}: at least one candidate per batch")
            dtype = resolve_dtype(dtype)
            check_precision(precision, dtype == torch.float64)
            compensated = precision == "compensated"
            device = resolve_device(device)
            if validate:
                validate_mesh_inputs(vertices_t0, vertices_t1, edges, faces)
            v0, v1, e, f = mesh_tensors(vertices_t0, vertices_t1, edges, faces, device, pca)

            n_vf, n_ee = v0.shape[0] + f.shape[0], e.shape[0]
            knobs = resolve_knobs(
                n_vf, n_ee, bucket_minor=bucket_minor, escalate_rounds=escalate_rounds,
                escalate_pool=escalate_pool, sweep_impl=sweep_impl,
                max_iterations=max_iterations, collisions=collisions is not None,
                ipc_refine=ipc_refine,
                plain_f32=dtype == torch.float32 and not compensated, presample=presample,
                cuda=device.type == "cuda",
            )
            vf_auto, ee_auto = vf_budget == "auto", ee_budget == "auto"
            memo_key = None
            if vf_auto:
                vf_budget = max(pow2ceil(_AUTO_VF_GUESS * n_vf), _AUTO_BUDGET_MIN)
            if ee_auto:
                ee_budget = max(pow2ceil(_AUTO_EE_GUESS * n_ee), _AUTO_BUDGET_MIN)
            if vf_auto or ee_auto:
                memo_key = (vf_budget, ee_budget, knobs.sweep_impl)
                memo = _AUTO_BUDGET_MEMO.get(memo_key, (0, 0))
                vf_budget = max(vf_budget, memo[0]) if vf_auto else vf_budget
                ee_budget = max(ee_budget, memo[1]) if ee_auto else ee_budget

        with prof.span("sccd.boxes"):
            vf_sorted, ee_sorted = sorted_phases(v0, v1, e, f, min_distance, dtype,
                                                 knobs.bucket_minor)

        toi = torch.ones((), dtype=dtype, device=device)
        grown = [0, 0]
        out = []
        frame_pool = knobs.escalate_pool == "frame"
        for k, (sb, is_vf, budget, auto, ps) in enumerate((
            (vf_sorted, True, int(vf_budget), vf_auto, knobs.presample_vf),
            (ee_sorted, False, int(ee_budget), ee_auto, knobs.presample_ee),
        )):
            with prof.span("sccd.phase.vf" if is_vf else "sccd.phase.ee"):
                with prof.span("sccd.tables"):
                    nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, min_distance, tolerance,
                                                 allow_zero_toi, max_iterations,
                                                 knobs.escalate_rounds, dtype, compensated)
                with prof.span("sccd.sweep"):
                    stream, n_true, overflow, budget, grew = _sweep_phase(
                        sb, is_vf, budget, auto, knobs, nar, int(narrow_batch),
                        collisions is not None)
                grown[k] = budget if grew else 0
                with prof.span("sccd.narrow"):
                    toi, checks, capped, refined = _narrow_phase(
                        stream, budget, ps, nar, toi, collisions, ipc_refine, frame_pool,
                    )
                # the phase's candidate and column buffers are freed before
                # the next phase's sweep allocates its own
                del stream, nar
            out.append((n_true, overflow, checks, capped, refined))
        if memo_key is not None and any(grown):
            old = _AUTO_BUDGET_MEMO.get(memo_key, (0, 0))
            _AUTO_BUDGET_MEMO[memo_key] = (max(old[0], grown[0]), max(old[1], grown[1]))
        ((vf_total, vf_over, vf_ck, vf_cap, vf_ref),
         (ee_total, ee_over, ee_ck, ee_cap, ee_ref)) = out
        return FusedCCDResult(
            toi=toi, overflowed=vf_over | ee_over, vf_total=vf_total,
            ee_total=ee_total, total_checks=vf_ck + ee_ck,
            solver_capped=vf_cap | ee_cap,
            # a fill, not a host-to-device copy (which would wait for the card)
            ipc_refinements=torch.full((), vf_ref + ee_ref, dtype=torch.int64, device=device),
        )
