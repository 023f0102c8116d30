"""The chunked CCD pipeline and the IPC stepping rule.

PyTorch counterpart of ``scalable_ccd_tpu/pipeline/ccd.py``, which mirrors
``scalable_ccd::cuda::ccd`` (``src/scalable_ccd/cuda/ccd.cu:80-145``) and
its chunked inner loop ``partial_ccd`` (``ccd.cu:14-78``): build conservative
boxes once, then for each pairing (VF two-list, EE one-list) interleave
broad-phase chunks with narrow-phase solves, threading one running TOI
through everything so that later chunks are pruned by earlier hits.

A broad chunk is a range of ``box_chunk_size`` sorted boxes, swept by
kernel A with that box range (:func:`sweep_chunks`), the reference's chunk
cursor (``broad_phase.cu:121-224``).  A global solve (no ``collisions``, no
per-query TOIs) runs each chunk on the device with one host read of the
TOI, checks and cap flag at its end: a bounded one (``max_iterations >= 0``:
the IPC stepping rule's) is one kernel B launch whose lanes compute their
rows from the pairs (:meth:`NarrowSolver.solve_pairs`, no column buffer, no
warm-start batch); an unbounded one, and the IPC rule's re-solve, packs and
solves its warm-start batch and batches of ``query_buckets[-1]`` pairs, each
seeded from the device TOI and skipped once it is 0.  A per-query solve
(:func:`solve_per_query`) reads the TOI after each batch, as the JAX
package does (which pads each batch to its bucket menu to bound XLA's
compiled shapes, which eager PyTorch does not need).  The host holds the
running TOI between chunks as a Python float.

Tracing (:mod:`scalable_ccd_tpu_torch.utils.profiler`) names the stages as
:func:`scalable_ccd_tpu_torch.fused_ccd` does: while a ``torch.profiler``
runs, a call records the spans ``sccd.ccd`` (the call, opened before the
upload), ``sccd.upload`` (checks, validation, upload), ``sccd.boxes`` (box
build and sort), per phase ``sccd.phase.vf`` / ``sccd.phase.ee``, and per
broad chunk ``sccd.sweep`` (its kernel A launch, count read and any
re-sweep) and ``sccd.narrow`` (its solves), with ``sccd.presample`` (the
warm-start batch of a per-batch or re-solved chunk) and
``sccd.ipc_refine`` (the IPC re-solve) inside it; and the counters
``chunk_solves`` (chunks solved with one launch), ``batches`` (every other
narrow batch solved, the presample's and the re-solve's included),
``ipc_refinements`` and ``budget_retries`` (a chunk swept again at its
exact total), beside the kernels' ``launch.<kernel>.<mode>``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

from scalable_ccd_tpu_torch.config import DEFAULT_CONFIG, CCDConfig, check_supported
from scalable_ccd_tpu_torch.geometry.mesh import validate_mesh_inputs
from scalable_ccd_tpu_torch.ops.sweep_ap import sweep_pairs
from scalable_ccd_tpu_torch.pipeline.fused import fused_ccd
from scalable_ccd_tpu_torch.pipeline.narrow import (
    IPC_BACKOFF,
    IPC_MIN_TOI,
    NarrowSolver,
    PairStream,
    append_hits,
    solve_per_query,
)
from scalable_ccd_tpu_torch.pipeline.policy import (
    mesh_tensors,
    pow2ceil,
    resolve_device,
    resolve_knobs,
    sorted_phases,
)
from scalable_ccd_tpu_torch.utils.logging import logger
from scalable_ccd_tpu_torch.utils.profiler import profiler

__all__ = ["CCDStats", "ccd", "ipc_ccd_strategy", "sweep_chunks"]

@dataclasses.dataclass
class CCDStats:
    """Per-run counts and wall clock (the JAX package's ``CCDStats``)."""

    vf_candidates: int = 0
    ee_candidates: int = 0
    narrow_checks: int = 0
    #: narrow launches (a batch, or a chunk solved in one launch) that took
    #: a conservative accept
    overflow_queries: int = 0
    ipc_refinements: int = 0
    #: box build + sort
    broad_time_s: float = 0.0
    #: candidate enumeration: host time blocked in :func:`sweep_chunks`
    sweep_time_s: float = 0.0
    #: narrow-phase solves
    narrow_time_s: float = 0.0


def sweep_chunks(sorted_boxes, is_two_lists: bool, box_chunk_size: int,
                 pair_budget: int):
    """Yield ``(pairs, count)`` per chunk of ``box_chunk_size`` sorted boxes.

    Each chunk is one kernel A sweep with that box range and a buffer of
    ``pair_budget`` rows; ``pairs[:count]`` are its candidates.  The sweep
    reports the exact survivor total even past the budget, so a chunk that
    overflows is swept once more at ``pow2ceil(total)`` rows and then
    fits (the reference grows its buffer to ``real_count`` the same way,
    ``memory_handler.cpp:55-79``).
    """
    n = sorted_boxes.n
    prof = profiler()
    for b0 in range(0, n, box_chunk_size):
        rng = (b0, min(b0 + box_chunk_size, n))
        with prof.span("sccd.sweep"):
            pairs, _, n_true, _ = sweep_pairs(sorted_boxes, is_two_lists, pair_budget,
                                              box_range=rng)
            count = int(n_true)
            if count > pair_budget:
                prof.count("budget_retries")
                pairs, _, _, _ = sweep_pairs(sorted_boxes, is_two_lists,
                                             pow2ceil(count), box_range=rng)
        yield pairs, count


def _timed_chunks(chunks, stats: CCDStats):
    """Yield from ``chunks``, adding the time each step blocks the host to
    ``stats.sweep_time_s``."""
    it = iter(chunks)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            stats.sweep_time_s += time.perf_counter() - t0
            return
        stats.sweep_time_s += time.perf_counter() - t0
        yield item


def _partial_ccd(
    is_vf: bool,
    v0,
    v1,
    edges,
    faces,
    sorted_boxes,
    min_distance: float,
    max_iterations: int,
    tolerance: float,
    allow_zero_toi: bool,
    config: CCDConfig,
    presample: bool,
    round_limit,
    toi: float,
    stats: CCDStats,
    collisions: Optional[List[Tuple[int, int, float]]],
    ipc_refine: bool = False,
) -> float:
    """One pairing: interleaved broad chunks and narrow solves
    (``partial_ccd``, ``ccd.cu:45-76``; with ``ipc_refine``,
    ``partial_ipc_ccd_strategy``, ``ipc_ccd_strategy.cu:43-93``).
    ``presample`` and ``round_limit`` are the phase's resolved knobs."""
    mem = config.memory.scaled()
    max_b = mem.query_buckets[-1]
    per_query = config.toi_per_query or collisions is not None
    nar = NarrowSolver.for_phase(is_vf, v0, v1, edges, faces, min_distance,
                                 tolerance, allow_zero_toi, max_iterations, round_limit,
                                 config.torch_dtype, config.precision == "compensated")
    prof = profiler()
    # no warm-start batch when collecting: a sampled pair would hit twice
    warm = presample and collisions is None

    def read(toi_d, outs):
        """The host read of the TOI; the solves ``outs`` add to ``stats``."""
        checks = torch.stack([o[2] for o in outs]).sum()
        capped = torch.stack([o[1] for o in outs]).sum()
        toi, checks, capped = torch.stack(
            [toi_d.double(), checks.double(), capped.double()]).tolist()
        stats.narrow_checks += int(checks)
        stats.overflow_queries += int(capped)
        logger().debug("ToI after a %s solve: %e", "VF" if is_vf else "EE", toi)
        return toi

    def solve_global(pairs, toi, exact):
        """A chunk's global solve from the running TOI ``toi`` with one host
        read (module docstring); ``exact`` is the IPC rule's re-solve."""
        toi_d = torch.full((), toi, dtype=torch.float64, device=pairs.device)
        if max_iterations >= 0 and not exact:
            prof.count("chunk_solves")
            out = nar.solve_pairs(pairs, 0, pairs.shape[0], toi_d, max_b)
            return read(out[0], [out])
        outs = []

        def one(batch, toi_d):
            prof.count("batches")
            outs.append(nar.solve(batch, toi_d, exact=exact, skip_if_done=True))
            return outs[-1][0].double()

        if warm and pairs.shape[0] > 4 * max_b:
            with prof.span("sccd.presample"):
                toi_d = one(PairStream(pairs, pairs.shape[0]).sample(max_b), toi_d)
        for start in range(0, pairs.shape[0], max_b):
            toi_d = one(pairs[start:start + max_b], toi_d)
        return read(toi_d, outs)

    def solve_per_query_chunk(pairs, toi, exact):
        """A chunk's per-query solves (``narrow_phase<is_vf>``,
        ``narrow_phase.cu:136-195``), reading the TOI, and the hits when
        collecting, after every batch."""

        def one(batch, toi):
            prof.count("batches")
            out = solve_per_query(
                nar, [(nar.pack(batch, exact=exact), batch if collisions is not None else None)],
                torch.full((), toi, dtype=torch.float64, device=batch.device), exact)
            toi = read(out[0], [out])
            if collisions is not None:
                append_hits(collisions, out[3], out[4])
            return toi

        if warm and pairs.shape[0] > 4 * max_b:
            with prof.span("sccd.presample"):
                toi = one(PairStream(pairs, pairs.shape[0]).sample(max_b), toi)
        for start in range(0, pairs.shape[0], max_b):
            # early exit, the narrow loop's `&& toi > 0` (narrow_phase.cu:136);
            # off when collecting per-pair TOIs
            if collisions is None and toi <= 0:
                break
            toi = one(pairs[start:start + max_b], toi)
        return toi

    solve = solve_per_query_chunk if per_query else solve_global
    chunks = sweep_chunks(sorted_boxes, is_vf, mem.box_chunk_size, mem.pair_chunk_size)
    for pairs, count in _timed_chunks(chunks, stats):
        if count == 0:
            continue
        if is_vf:
            stats.vf_candidates += count
        else:
            stats.ee_candidates += count
        pairs = pairs[:count]
        t0 = time.perf_counter()
        toi_before = toi
        with prof.span("sccd.narrow"):
            toi = solve(pairs, toi, False)
            if ipc_refine and toi < IPC_MIN_TOI:
                # the IPC rule per broad chunk (ipc_ccd_strategy.cu:73-92):
                # discard the too-early result, re-solve this chunk with no
                # minimum separation, no cap and no zero TOI, and back off.
                # The candidates (from boxes inflated by ms) cover the ms=0
                # solve.
                logger().debug("IPC refinement: earliest_toi=%g, re-running chunk", toi)
                stats.ipc_refinements += 1
                prof.count("ipc_refinements")
                with prof.span("sccd.ipc_refine"):
                    toi = solve(pairs, toi_before, True) * IPC_BACKOFF
        stats.narrow_time_s += time.perf_counter() - t0
        if collisions is None and toi <= 0:
            return toi
    return toi


def ccd(
    vertices_t0,
    vertices_t1,
    edges,
    faces,
    min_distance: float = 0.0,
    max_iterations: int = -1,
    tolerance: float = 1e-6,
    allow_zero_toi: bool = True,
    config: CCDConfig = DEFAULT_CONFIG,
    collisions: Optional[List[Tuple[int, int, float]]] = None,
    stats: Optional[CCDStats] = None,
    validate: bool = True,
    ipc_refine: bool = False,
    pca: bool = False,
    device=None,
) -> float:
    """Earliest time of impact over all vertex-face and edge-edge pairs.

    The public chunked API (``cuda::ccd``, ``ccd.cuh:26-38``): vertices move
    linearly from ``vertices_t0`` to ``vertices_t1`` over t in [0, 1];
    returns the earliest conservative TOI in [0, 1] as a float, 1.0 meaning
    no contact.  A ``collisions`` list also receives every pair's ``(id_a,
    id_b, toi)`` with ``toi < 1`` (VF as (vertex, face), EE as (edge,
    edge)); the solver then runs in per-query mode.  ``stats`` collects
    counts and times.  Inputs and ``device`` are as for
    :func:`scalable_ccd_tpu_torch.fused_ccd`: CUDA unless the caller asks
    for the CPU, and on CUDA the sweep and solver are the CUDA kernels.
    ``config.escalate_rounds`` is the solver's staged escalation (auto: 128
    rounds without an iteration cap in plain f32).  ``config.dtype`` and
    ``config.precision`` are the working precision and the compensated
    mode, as in :func:`scalable_ccd_tpu_torch.fused_ccd`; the returned float
    holds the TOI of that precision.  Values of ``config`` that the port
    lacks raise ``ValueError``
    (:func:`scalable_ccd_tpu_torch.config.check_supported`).
    """
    prof = profiler()
    with prof.span("sccd.ccd", "cuda" if device is None else device, entry="ccd"):
        with prof.span("sccd.upload"):
            check_supported(config)
            stats = stats if stats is not None else CCDStats()
            device = resolve_device(device)
            if validate:
                validate_mesh_inputs(vertices_t0, vertices_t1, edges, faces)
            v0, v1, e, f = mesh_tensors(vertices_t0, vertices_t1, edges, faces, device, pca)

            # the staged escalation of the global solves is the per-batch
            # ladder (JAX ccd.py:239-275: its kernel escalates, its queue
            # solver, which f64 and compensated requests take, does not)
            knobs = resolve_knobs(
                v0.shape[0] + f.shape[0], e.shape[0], bucket_minor=False,
                escalate_rounds=config.escalate_rounds, escalate_pool="batch",
                max_iterations=max_iterations, collisions=collisions is not None,
                ipc_refine=ipc_refine,
                plain_f32=config.dtype == "float32" and config.precision != "compensated",
                presample=config.presample)

        t0 = time.perf_counter()
        with prof.span("sccd.boxes"):
            vf_sorted, ee_sorted = sorted_phases(v0, v1, e, f, min_distance,
                                                 config.torch_dtype, bucket_minor=False)
        stats.broad_time_s += time.perf_counter() - t0

        common = (min_distance, max_iterations, tolerance, allow_zero_toi, config)
        toi = 1.0
        with prof.span("sccd.phase.vf"):
            toi = _partial_ccd(True, v0, v1, e, f, vf_sorted, *common, knobs.presample_vf,
                               knobs.escalate_rounds, toi, stats, collisions, ipc_refine)
        if collisions is not None or toi > 0:
            with prof.span("sccd.phase.ee"):
                toi = _partial_ccd(False, v0, v1, e, f, ee_sorted, *common,
                                   knobs.presample_ee, knobs.escalate_rounds, toi, stats,
                                   collisions, ipc_refine)
    return toi


def ipc_ccd_strategy(
    vertices_t0,
    vertices_t1,
    edges,
    faces,
    min_distance: float = 0.0,
    max_iterations: int = 1_000_000,
    tolerance: float = 1e-6,
    config: CCDConfig = DEFAULT_CONFIG,
    stats: Optional[CCDStats] = None,
    validate: bool = True,
    impl: str = "chunked",
    device=None,
    **fused_kwargs,
) -> float:
    """The IPC stepping rule [Li et al. 2020] on top of the same pipeline
    (``cuda::ipc_ccd_strategy``, ``ipc_ccd_strategy.cu:43-93``).

    CCD runs with the minimum separation; whenever a broad chunk's narrow
    solve drops the running TOI below 1e-6, that result is discarded, the
    chunk is solved again with no separation, no iteration cap and no zero
    TOI, and the TOI is backed off by 0.8 so that the step stays strictly
    before contact.  ``stats.ipc_refinements`` counts the refinements.

    ``impl="chunked"`` refines per broad chunk (the reference's
    granularity); ``impl="fused"`` runs :func:`fused_ccd` with
    ``ipc_refine``, which refines per narrow batch, and takes
    ``fused_kwargs`` (budgets); if its budgets overflow, the chunked path
    runs instead.
    """
    stats = stats if stats is not None else CCDStats()
    if impl == "fused":
        check_supported(config)
        res = fused_ccd(
            vertices_t0, vertices_t1, edges, faces, device=device,
            validate=validate, min_distance=min_distance, tolerance=tolerance,
            max_iterations=max_iterations, allow_zero_toi=True,
            ipc_refine=True, dtype=config.dtype, precision=config.precision,
            **fused_kwargs,
        )
        if bool(res.overflowed):
            # the chunked pipeline needs no budget
            logger().warning("fused IPC overflowed its budgets; falling back to chunked")
        else:
            stats.narrow_checks += int(res.total_checks)
            stats.overflow_queries += int(res.solver_capped)
            stats.ipc_refinements += int(res.ipc_refinements)
            return float(res.toi)
    elif impl != "chunked":
        raise ValueError(f"unknown impl {impl!r}")
    return ccd(
        vertices_t0, vertices_t1, edges, faces,
        min_distance=min_distance, max_iterations=max_iterations,
        tolerance=tolerance, allow_zero_toi=True, config=config, stats=stats,
        validate=validate, ipc_refine=True, device=device,
    )
