"""The chunked CCD pipeline and the IPC stepping rule.

PyTorch counterpart of ``scalable_ccd_tpu/pipeline/ccd.py``, which mirrors
``scalable_ccd::cuda::ccd`` (``src/scalable_ccd/cuda/ccd.cu:80-145``) and
its chunked inner loop ``partial_ccd`` (``ccd.cu:14-78``): build conservative
boxes once, then for each pairing (VF two-list, EE one-list) interleave
broad-phase chunks with narrow-phase solves, threading one running TOI
through everything so that later chunks are pruned by earlier hits.

A broad chunk is a range of ``box_chunk_size`` sorted boxes, swept by
kernel A with that box range (:func:`sweep_chunks`), the reference's chunk
cursor (``broad_phase.cu:121-224``).  Its candidates are solved by kernel
B in batches of ``query_buckets[-1]`` pairs; the JAX package pads each
batch to its bucket menu to bound XLA's compiled shapes, which eager
PyTorch does not need.  The host holds the running TOI as a Python float
and reads it after every batch, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.config import DEFAULT_CONFIG, CCDConfig, check_supported
from scalable_ccd_tpu_torch.geometry.aabb import (
    build_edge_boxes,
    build_face_boxes,
    build_vertex_boxes,
)
from scalable_ccd_tpu_torch.geometry.mesh import validate_mesh_inputs
from scalable_ccd_tpu_torch.ops.sweep_ap import sweep_pairs
from scalable_ccd_tpu_torch.pipeline.fused import (
    CONGESTION_MIN_BOXES,
    IPC_BACKOFF,
    IPC_MIN_TOI,
    NarrowSolver,
    _pow2ceil,
    append_hits,
    fused_ccd,
    mesh_tensors,
    resolve_auto_escalation,
    resolve_device,
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
    #: narrow batches that took a conservative accept
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
    overflows is swept once more at ``_pow2ceil(total)`` rows and then
    fits (the reference grows its buffer to ``real_count`` the same way,
    ``memory_handler.cpp:55-79``).
    """
    n = sorted_boxes.n
    for b0 in range(0, n, box_chunk_size):
        rng = (b0, min(b0 + box_chunk_size, n))
        pairs, _, n_true, _ = sweep_pairs(sorted_boxes, is_two_lists, pair_budget,
                                          box_range=rng)
        count = int(n_true)
        if count > pair_budget:
            pairs, _, _, _ = sweep_pairs(sorted_boxes, is_two_lists,
                                         _pow2ceil(count), box_range=rng)
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


def _narrow_batches(count: int, max_batch: int):
    """``(start, stop)`` of each narrow batch of a chunk's ``count``
    candidates (``MemoryHandler::handleNarrowPhase``, fitted to
    ``max_batch`` rows)."""
    for start in range(0, count, max_batch):
        yield start, min(start + max_batch, count)


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
    toi: float,
    stats: CCDStats,
    collisions: Optional[List[Tuple[int, int, float]]],
    ipc_refine: bool = False,
) -> float:
    """One pairing: interleaved broad chunks and narrow solves
    (``partial_ccd``, ``ccd.cu:45-76``; with ``ipc_refine``,
    ``partial_ipc_ccd_strategy``, ``ipc_ccd_strategy.cu:43-93``)."""
    mem = config.memory.scaled()
    max_b = mem.query_buckets[-1]
    n_boxes = v0.shape[0] + faces.shape[0] if is_vf else edges.shape[0]
    presample = (
        n_boxes < CONGESTION_MIN_BOXES if config.presample in ("auto", None)
        else bool(config.presample)
    )
    per_query = config.toi_per_query or collisions is not None
    # staged escalation of the global solves (JAX ccd.py:269)
    round_limit = resolve_auto_escalation(config.escalate_rounds, max_iterations)
    nar = NarrowSolver.for_phase(is_vf, v0, v1, edges, faces, min_distance,
                                 tolerance, allow_zero_toi, max_iterations, round_limit)

    def solve_chunk(pairs, count, toi, exact):
        """Narrow-solve one chunk's candidates (``narrow_phase<is_vf>``,
        ``narrow_phase.cu:136-195``); ``exact`` is the IPC re-solve."""
        batches = [pairs[a:b] for a, b in _narrow_batches(count, max_b)]
        if presample and collisions is None and count > 4 * max_b:
            # TOI warm start: one batch of strided candidates first (a
            # sampled pair would append its hit twice, hence not when
            # collecting)
            idx = np.minimum(np.arange(max_b, dtype=np.int64) * count // max_b, count - 1)
            batches.insert(0, pairs[torch.as_tensor(idx, device=pairs.device)])
        for chunk in batches:
            out = nar.solve(chunk, toi, per_query=per_query, exact=exact)
            toi_k, capped, checks = out[:3]
            toi, checks, capped = torch.stack(
                [toi_k.double(), checks.double(), capped.double()]
            ).tolist()
            stats.narrow_checks += int(checks)
            stats.overflow_queries += int(capped)
            if collisions is not None:
                hit = out[3] < 1
                append_hits(collisions, chunk[hit], out[3][hit])
            logger().debug("ToI after %s batch (%d queries): %e",
                           "VF" if is_vf else "EE", chunk.shape[0], toi)
            # early exit, the narrow loop's `&& toi > 0` (narrow_phase.cu:136);
            # off when collecting per-pair TOIs
            if collisions is None and toi <= 0:
                return toi
        return toi

    chunks = sweep_chunks(sorted_boxes, is_vf, mem.box_chunk_size, mem.pair_chunk_size)
    for pairs, count in _timed_chunks(chunks, stats):
        if count == 0:
            continue
        if is_vf:
            stats.vf_candidates += count
        else:
            stats.ee_candidates += count
        t0 = time.perf_counter()
        toi_before = toi
        toi = solve_chunk(pairs, count, toi, exact=False)
        if ipc_refine and toi < IPC_MIN_TOI:
            # the IPC rule per broad chunk (ipc_ccd_strategy.cu:73-92):
            # discard the too-early result, re-solve this chunk with no
            # minimum separation, no cap and no zero TOI, and back off.  The
            # candidates (from boxes inflated by ms) cover the ms=0 solve.
            logger().debug("IPC refinement: earliest_toi=%g, re-running chunk", toi)
            stats.ipc_refinements += 1
            toi = solve_chunk(pairs, count, toi_before, exact=True) * IPC_BACKOFF
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
    rounds without an iteration cap).  Values of ``config`` that the port
    lacks raise ``ValueError``
    (:func:`scalable_ccd_tpu_torch.config.check_supported`).
    """
    check_supported(config)
    stats = stats if stats is not None else CCDStats()
    device = resolve_device(device)
    if validate:
        validate_mesh_inputs(vertices_t0, vertices_t1, edges, faces)
    v0, v1, e, f = mesh_tensors(vertices_t0, vertices_t1, edges, faces, device, pca)

    with profiler().scope("ccd", device):
        t0 = time.perf_counter()
        with profiler().scope("build_boxes", device):
            vb = build_vertex_boxes(v0, v1, inflation_radius=min_distance,
                                    dtype=torch.float32)
            eb = build_edge_boxes(vb, e)
            fb = build_face_boxes(vb, f)
        with profiler().scope("sort_boxes", device):
            vf_sorted = sort_boxes(merge_two_lists(vb, fb))
            ee_sorted = sort_boxes(eb)
        stats.broad_time_s += time.perf_counter() - t0

        common = (min_distance, max_iterations, tolerance, allow_zero_toi, config)
        toi = 1.0
        with profiler().scope("vf_pipeline", device):
            toi = _partial_ccd(True, v0, v1, e, f, vf_sorted, *common, toi,
                               stats, collisions, ipc_refine)
        with profiler().scope("ee_pipeline", device):
            if collisions is not None or toi > 0:
                toi = _partial_ccd(False, v0, v1, e, f, ee_sorted, *common, toi,
                                   stats, collisions, ipc_refine)
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
            ipc_refine=True, **fused_kwargs,
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
