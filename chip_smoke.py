#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``scalable_ccd_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; it imports nothing of jax.  Phases,
each printed as one JSON line, each stopping the run with a non-zero exit
when it fails:

0. the device, and ``nvidia-smi``'s name and power limit of the card;
1. build the four CUDA libraries from ``scalable_ccd_tpu_torch/csrc/`` with
   nvcc, one process per source, all started together;
2. kernel A (sweep) against its plain PyTorch version on the bench scene's
   sorted VF and EE boxes: equal pair sets and totals, and a budget of 64
   that overflows with the exact total;
3. kernel B (solver) against its plain version on the bench scene's VF and
   EE candidates: each phase's rows in one unbounded global launch, the main
   path's launch over a chunk (VF from 1, EE seeded with VF's TOI, as the
   loop seeds a chunk with the TOI before it), and in batches of 16,384
   from 1 (the per-batch paths); global TOI within 1e-7 in both shapes, the
   one launch timed and bounded for the kernels row;
4. the main path ``fused_ccd(..., device="cuda")``: equal to the CPU run on
   ``cloth_on_sphere(64, 3)``, the golden ``cloth-sphere-16`` bar, and the
   bench scene ``cloth_on_sphere(128, 4, drop=0.25)`` run once with zeroed
   launch counters (kernels A, B and C must launch) and then timed (median of 5
   after the warm-up); also timed on ``cloth_on_sphere(384, 5)``;
5. kernel B's exact modes against the plain version on the candidates of
   ``cloth_on_sphere(64, 3)``: per-query (equal hit sets, per-query TOIs
   within 1e-7), per-query with ``max_iterations`` 10 and 100 (within
   1e-7, expected bitwise), global with ``ms=1e-3`` and global with
   ``max_iterations=1_000_000`` (the unbounded TOI);
6. kernel A's box range on the bench scene: the ranged launches over
   chunks of 2^15 boxes give the whole-range pair set and totals, and a
   chunk budget of 64 retries to the exact total;
7. the IPC path: ``ccd()``, ``fused_ccd(collisions=)`` and a 3-frame IPC
   stepping loop (``ipc_ccd_strategy`` chunked and fused) on the bench
   scene, the IPC refinement rig, the CUDA runs against the CPU runs on
   ``cloth_on_sphere(64, 3)``, the launch counters of every new mode, and
   the path's timings (median of 5 after a warm-up);
8. congestion on grid-600 (``cloth_on_sphere(600, 4)``, 1,085,284 VF
   boxes): the bucket-ordered sort, kernel A ``any_order`` against its
   plain version (equal pair sets and totals) and against kernel A on the
   major sort (equal sets, also against the plain version there), each
   launch counted by mode, both kernel variants and both plain versions
   timed;
9. kernel A' (records) against its plain version on the bench scene and on
   grid-600, in both orderings: equal record multisets and counts, its
   pair total equal to kernel A's, its decoded pairs equal to kernel A's,
   budgets of 0 and 64 that overflow with exact totals (the 64 records
   written are records of the full run); A' plus the full decode timed
   against kernel A;
10. kernel B ``round_limit`` 128 against its plain version on the bench
    candidates: each phase's rows in one launch (the main path's pass over
    a chunk, kernel B's persistent one-thread form) seeded with the final
    TOI give every 16,384-row batch's unfinished rows, checks and per-query
    checks of the plain version, and equal the per-batch launches, both
    timed; from a cold start the ladder gives the unbounded TOI bitwise;
    then kernel B global, bounded (per-query caps 10 and 100, a global cap
    of 10^6) and ``round_limit`` 128 against their plain versions on
    grid-600's first four batches per phase (the plain ``any_order``
    sweep's row order): the cold global TOI within 1e-7, the capped
    per-query TOIs and checks equal, the global cap's TOI the unbounded one,
    and seeded with the global TOI the unfinished rows and checks equal;
    and over each phase's first chunk of up to 2^20 rows in one launch,
    the unbounded global mode (the main path's launch, VF from 1, EE seeded
    with VF's chunk TOI) against the plain version on the same rows within
    1e-7, timed and bounded, and the round-limited pass against the plain
    version on every batch, timed against the same rows in per-batch
    launches;
11. the congested main path: ``fused_ccd(..., device="cuda")`` at its
    defaults on grid-600 (auto must resolve to the congestion ordering, no
    escalation, the batch path and no presample: one unbounded kernel B
    launch per phase over the pairs source, no kernel C) with zeroed launch
    counters, against
    ``bucket_minor=False, escalate_rounds=-1`` and against the batch ladder
    at 128 rounds (one round-limited launch per chunk), then timed in turns
    with both; the same with ``sweep_impl="records"``; the bench scene at
    its defaults against the frame pool at 128 rounds, both timed; kernel
    B's launches of a default frame, which must be one per phase, none
    round-limited (grid-600 2; the bench 2, and one more per phase for its
    presample batch, kernel C's only launches);
12. the f64 kernels against their plain versions on the bench scene built
    in f64: kernel A whole, ranged and ``any_order`` (equal pair sets and
    totals, a subset of the f32 set), kernel A' (equal record multisets,
    decoded pairs equal to kernel A's), kernel B global on f64 rows and on
    f32 rows widened to f64 (TOI within 1e-12, expected bitwise), per-query
    and ``max_iterations`` 10/100 on ``cloth_on_sphere(64, 3)`` (hit sets
    equal, per-query TOIs within 1e-12), ``round_limit`` 128 seeded with the
    final TOI (unfinished rows and checks equal); each timed in turns with
    its plain version; and the plain f32 ``any_order`` sweep of the bench
    scene timed beside its kernel;
13. kernel A ``count_only``: equal to the emitting kernel's total and to the
    plain count on the bench scene and on grid-600, whole, ranged (2^15-box
    chunks summed) and ``any_order``, f32 and f64, timed in turns with the
    emitting kernel (the difference is what the atomic append costs), each
    with its bound; on grid-600 the f64 ``any_order`` kernel also against
    its plain version, and kernel A' in f64 in both orderings (exact pair
    total, one record per (row, partner), decoded pairs equal to kernel
    A's; under the major sort the plain version's record multiset), timed
    in turns with kernel A, with its bound;
14. the precision path: the three golden scenes through ``fused_ccd`` in
    f32, compensated and f64 (``dense-cluster``: f32 gives 0, the other two
    recover the golden TOI, also through ``ccd()``); ``fused_ccd(dtype=
    float64)``, ``fused_ccd(precision="compensated")``, ``ccd()`` with an f64
    config and ``fused_ccd(dtype=float64, collisions=[])`` on CUDA against
    the CPU on ``cloth_on_sphere(64, 3)``, then on the bench scene with
    zeroed launch counters (the f64 kernels must launch, the f32 solver must
    not) and timed beside the f32 frame; grid-600 in f64 once; the stage
    tool (``scalable_ccd_tpu_torch.tools.stages``) on the bench scene and
    grid-600 in f32 and on the bench scene in f64, its lines printed as they
    are;
15. kernel B on the rows the main path gives it, recorded from its frames
    (``scalable_ccd_tpu_torch.tools.stages --kernel-b``): the bench frame's
    round-limited passes (one per chunk, also replayed in 16,384-row
    launches) and frame pool blocks, the bench frame without escalation,
    grid-600's first round-limited pass and first four batches per phase and the
    per-query rows of ``fused_ccd(collisions=[])`` on
    ``cloth_on_sphere(64, 3)``, in each of their modes, against the plain
    version (equal TOIs, and equal checks and unfinished rows where the
    order fixes them), with the spread of the per-query checks (mean, p50,
    p99, max; the lane efficiency of warps of 32 consecutive queries each
    held by its deepest, and of groups of 4) and both times; ``ptxas``'s registers,
    spills and shared memory for every instantiation of kernels B, A and
    A', and kernel A''s sweep grid (blocks, dynamic shared memory);
16. the multi-device path: kernel A''s ``row_range`` against its plain
    version on the bench scene (major sort) and grid-600 (``any_order``), VF
    and EE, f32 and f64 (a range cut mid-scene equal to the plain version's,
    partitions of the a-rows into 2 and 4 ranges making the whole record
    multiset, each launch counted under ``"range"``; the 4-range partition
    timed, on the bench scene beside the plain version); ``sharded_ccd`` in
    a world of one process on NCCL on the bench scene at both
    ``sweep_impl``s and in f64 (TOI within 1e-7 of ``fused_ccd``, equal
    totals, no overflow, kernel A's or A''s range and kernel B launched)
    and with ``collisions=[]`` on ``cloth_on_sphere(64, 3)`` (hit keys and
    order equal to ``fused_ccd``'s); two processes sharing the card on gloo
    (``parallel.spawn_local``), each running the bench scene and grid-600
    at both partitions and both sweeps with the same checks and launch
    counts in every rank, and each rank's ms per frame; the host broad
    phase's f64 pair sets on the bench scene equal to kernel A's;
17. the narrow loop on the device: kernel C (gather and pack) against its
    plain twins, bitwise, on every chunk of at most 2^20 rows of the bench
    scene's and grid-600's (the congestion ordering) VF and EE candidates,
    in f32, f64 and compensated, in both modes: the pairs mode on kernel
    A's buffer and the records mode on kernel A''s records of the same
    boxes (the rows and the pairs' ids); each mode timed over a phase's
    chunks with its bound; a CUDA records frame of the bench scene and of
    grid-600 with every PyTorch record decode counted (there must be none);
    the synchronizing calls of one frame
    (``torch.cuda.set_sync_debug_mode("warn")``) of the bench scene and
    grid-600 at their defaults (one kernel B launch per phase) at
    ``narrow_batch`` 16,384 and 4,096, which must be equal, with kernel C
    launched for the presample alone; the device idle share of one bench
    frame from a ``torch.profiler`` trace;
18. kernel B's pairs source on the broad chunks of the IPC cell
    (``clothball_ipc.ipc_sim``, frames 0 and 3 of one seed, 2^15-box chunks,
    its separation and cap; where the benchmark lacks the cell, the port's
    ``cloth_on_sphere(210, 4)`` at its size): per chunk and per row type
    (f32, f64, compensated), one pairs-source launch against the per-batch
    path it replaces (kernel C and the columns source per 2^17-row batch,
    each seeded with the TOI before it), bit for bit in TOI and overflow
    (and in checks where no query lowers the seed), with the device ms of
    both, and on frame 0 their host ms with the per-batch path's read a
    batch; the plain twin (kernel C's and B's plain versions) on frame 0's
    last VF and EE chunks, bit for bit, for the ``solve_pairs`` rows; the
    pairs source's ``ptxas`` lines.
    ``python3 chip_smoke.py --chunk-solve`` runs the build and this phase
    alone, and names them in its ok line;
19. kernel B's pairs source in the shared form, the main path's launch over
    a phase (``fused_ccd``'s defaults on CUDA): on the bench scene's and
    grid-600's VF and EE candidates, in f32, f64 and compensated rows, one
    launch of a whole phase (VF from 1, EE seeded with VF's TOI) against the
    plain twin on the same pairs (kernel C's and B's plain versions over
    chunks of 2^20 rows, each seeded with the TOI before it): TOI bit for
    bit and overflow equal, the launch counted as global and pairs, timed
    and bounded for the ``solve_pairs[global]`` rows.
    ``python3 chip_smoke.py --phase-solve`` runs the build and this phase
    alone;
last, grid-1000 in f32 timed once.

Each kernel row carries its bound: the least time the card could take,
the larger of the bytes the call must move over 3.35 TB/s (the H100 SXM's
HBM3 rate) and its operations over the card's peak rate for their type.
The sweeps move 40 bytes per box in (and under ``any_order`` 4 per box and
8 per partner row of planes), 8 per pair or 32 per record out; they do
compares, at most one instruction per lane per clock, 33.5e12 per second
(half the 67 TFLOP/s f32 rate, which counts an FMA as two operations): 5
per candidate slot of the major sort (the stop and four minor tests), and
under ``any_order`` 7 per slot that the walk tests (the stop, both major
directions, four minor tests) and 2 per partner-row union it reads, counted
from this run's ``fwd_min``, row unions and run lengths.  The solver moves
125 bytes per query row in and does about 300 f32 operations per domain
evaluation, over 67 TFLOP/s.  Its unbounded modes count the evaluations that
any search must make: the plain version's on the same rows seeded with the
answer (``least_checks``), which no order can undercut, and which neither the
kernel's order nor the plain frontier's late pruning inflates; its capped
and round-limited modes count their checks, which each query's order fixes
and kernel and plain version share.  In f64 a box is 64 bytes and a query row 249,
and the card's non-tensor f64 rate is half its f32 rate: 33.5e12 operations
and 16.75e12 compares per second.  ``count_only`` moves no pair bytes.  No
single PyTorch call computes a sweep or a root search, so ``library_ms`` is
null.  Kernel C (gather and pack) moves 31 row scalars per row (124 bytes in
f32, 248 in f64 and compensated) and 8 bytes of ids per row or, in the
records mode, 32 bytes of record and 8 of pair prefix per record the rows
lie in, and each table row that the frame references once (a vertex's 6
and a face's 18 scalars, or an edge's 12: the many candidates that share a
row repeat its reads, and a scene's tables fit in the card's L2), counted
from this run's pairs, and does about 400 operations per row; it replaces
the XLA-fused glue of ``pack_query_rows`` and of the record decode (no
Pallas kernel), and no single PyTorch call computes it.  Kernel B's pairs
source computes those rows in the kernel: it reads 8 bytes of ids per row
and the table rows kernel C reads, writes and reads no column, and does
kernel C's operations per row and kernel B's per evaluation.

The last lines are the kernels' JSON record (one row per kernel and mode),
the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-6
BATCH = 1 << 14
LIBS = ("sweep_ap", "sweep_records", "solver", "gather_pack")

#: the H100 SXM's HBM3 bytes/s and f32 operations/s outside the tensor cores
#: (an FMA counted as two operations)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: lane instructions/s: an SM issues at most one instruction per lane per
#: clock, half the f32 rate's count, so a compare goes at most this fast
INSTR_PER_S = F32_OPS_PER_S / 2
#: bytes of one pair row and of one record
PAIR_BYTES, RECORD_BYTES = 8, 32
#: compares of one candidate slot of the major sort (the stop test and four
#: minor compares), of one slot of the any_order walk (the stop, both major
#: directions, four minor) and of one partner-row union test; f32
#: operations of one domain evaluation (csrc/solver.cu)
OPS_PER_SLOT, OPS_PER_ANY_SLOT, OPS_PER_ROW_TEST, OPS_PER_CHECK = 5, 7, 2, 300
#: operations of one packed row of kernel C (csrc/gather_pack.cu): the F
#: residual at 8 corners in 3 dims, the extents, tolerances and error filter
OPS_PER_PACKED_ROW = 400
#: partners per row of the any_order row-skip planes (ops/sweep_ap.py ROW)
PARTNER_ROW = 128


def emit(**fields):
    print(json.dumps(fields), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device milliseconds of one call of ``fn``, the mean of ``reps``: each
    call is queued behind a GPU sleep long enough for the host to enqueue
    all of it, so the events time the card's work and not the host's gaps
    between launches (as ``tools/stages.py --kernel-a`` times kernel A)."""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def alternate(plain, kernel, reps):
    """Plain, kernel, kernel, plain; returns (kernel_ms, plain_ms)."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def host_cpu():
    """The host's CPU from ``/proc/cpuinfo`` (``model name``; where a sandbox
    reports it as unknown, the vendor, family and model numbers, or Arm's
    implementer and part codes) with its clock, and the logical CPU count."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or fields.get("Hardware") or "unknown"
    if model == "unknown":
        ids = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                            "CPU implementer", "CPU part") if k in fields]
        model = ", ".join(ids) or platform.machine() or "unknown"
    if "cpu MHz" in fields:
        model += f", {fields['cpu MHz']} MHz"
    return model, os.cpu_count()


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """``bound_ms`` and ``bound_by`` of a call that must move ``nbytes``
    and do ``ops`` operations at a peak of ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def add_bounds(a, b):
    """The bound of two calls made one after the other."""
    ms = a["bound_ms"] + b["bound_ms"]
    return {"bound_ms": ms, "bound_by": a["bound_by"] if a["bound_ms"] >= b["bound_ms"]
            else b["bound_by"]}


def major_slots(sb):
    """Candidate slots of boxes sorted by ``major_min``: the partners each
    box's major interval reaches, the work any sorted sweep must test."""
    import torch

    reach = torch.searchsorted(sb.major_min, sb.major_max, right=True)
    return int((reach - torch.arange(sb.n, device=reach.device) - 1).clamp(min=0).sum())


def any_order_work(sb, planes, chunk=1 << 24):
    """``(slots, row_tests)`` of kernel A's ``any_order`` walk over ``sb``:
    box ``i``'s run is ``[i + 1, reach)``, ``reach`` the first position
    whose ``fwd_min`` exceeds ``major_max[i]``; the walk tests each
    128-box partner row the run touches against box ``i``'s minor-0
    interval, and the run's slots only in the rows that pass.  Expanded
    over (box, row) in chunks of about ``chunk`` entries, as
    ``sweep_positions`` expands slots."""
    import torch

    n = sb.n
    dev = sb.major_min.device
    start = torch.arange(1, n + 1, device=dev)
    end = torch.maximum(torch.searchsorted(planes.fwd_min, sb.major_max, right=True), start)
    r0 = start // PARTNER_ROW
    nrows = torch.where(end > start, (end - 1) // PARTNER_ROW - r0 + 1, 0)
    cum = torch.cumsum(nrows, 0)
    row_tests = int(cum[-1])
    cuts = torch.arange(chunk, max(row_tests, chunk), chunk, device=dev)
    bounds = [0] + torch.searchsorted(cum, cuts, right=True).tolist() + [n]
    lo, hi = sb.minor_min[:, 0], sb.minor_max[:, 0]
    slots = 0
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        k = nrows[b0:b1]
        i = torch.repeat_interleave(torch.arange(b0, b1, device=dev), k)
        if i.numel() == 0:
            continue
        first = torch.repeat_interleave(torch.cumsum(k, 0) - k, k)
        row = r0[i] + torch.arange(i.numel(), device=dev) - first
        span = (torch.minimum((row + 1) * PARTNER_ROW, end[i])
                - torch.maximum(row * PARTNER_ROW, start[i]))
        hit = (planes.row_umin[row] <= hi[i]) & (planes.row_umax[row] >= lo[i])
        slots += int((span * hit).sum())
    return slots, row_tests


def scalar_bytes(t):
    """4 or 8: the bytes of one scalar of tensor ``t``."""
    return t.element_size()


def rate_divisor(t):
    """1 for f32 tensors, 2 for f64: the card's non-tensor f64 rates are
    half its f32 rates."""
    return scalar_bytes(t) // 4


def box_bytes(sb):
    """Bytes one sorted box holds: major min/max, two minor intervals, three
    vertex ids and the element id (40 in f32, 64 in f64)."""
    return 6 * scalar_bytes(sb.major_min) + 16


def sweep_bound(sb_major, out_bytes):
    return bound(sb_major.n * box_bytes(sb_major) + out_bytes,
                 major_slots(sb_major) * OPS_PER_SLOT,
                 INSTR_PER_S / rate_divisor(sb_major.major_min))


def any_order_bound(sb, planes, work, out_bytes):
    """The bound of an ``any_order`` sweep of ``sb`` whose walk does
    ``work = any_order_work(sb, planes)``."""
    slots, row_tests = work
    es = scalar_bytes(sb.major_min)
    in_bytes = sb.n * (box_bytes(sb) + es) + 2 * es * planes.row_umin.shape[0]
    return bound(in_bytes + out_bytes, slots * OPS_PER_ANY_SLOT + row_tests * OPS_PER_ROW_TEST,
                 INSTR_PER_S / rate_divisor(sb.major_min))


def solve_bound(queries, checks, out_bytes=0, f64=False):
    """The bound of solving ``queries`` packed rows (31 scalars and a valid
    byte each) with ``checks`` domain evaluations."""
    row_bytes = 31 * (8 if f64 else 4) + 1
    return bound(queries * row_bytes + out_bytes, checks * OPS_PER_CHECK,
                 F32_OPS_PER_S / (2 if f64 else 1))


def least_checks(solver, batches, is_vf, toi, per_query_toi=None):
    """The evaluations any unbounded search of the rows in ``batches`` must
    make to find ``toi`` (or, per query, ``per_query_toi``): the plain
    version seeded with the answer (``ops/solver.py:_least_checks``).  A
    kernel B bound counts these, not the kernel's own checks, which follow
    its order, nor the unseeded plain version's, which prunes late."""
    import torch

    rows = torch.cat(batches)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=rows.device)
    return solver._least_checks(rows, valid, is_vf, toi, TOL, per_query_toi)


def whole_chunk_global(solver, rows, is_vf, seed, label):
    """Kernel B's unbounded global mode over ``rows`` in one launch, the main
    path's launch over a chunk (``solve_cols`` with ``skip_if_done``), seeded
    with ``seed``, against the plain version on the same rows: TOI within
    1e-7.  Returns the JSON fields: TOIs, checks, the least checks, device ms
    (behind a GPU sleep, mean of 5), host ms of the plain version, the bound
    and the queries per block the launch takes."""
    import torch

    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=rows.device)
    cols = rows.t().contiguous()

    def launch():
        return solver.solve_cols(cols, valid, is_vf, seed, TOL, skip_if_done=True)

    k = launch()
    torch.cuda.synchronize()
    p, plain_ms = timed_once(lambda: solver.solve_packed_reference(rows, valid, is_vf, seed, TOL))
    err = abs(float(k[0]) - float(p[0]))
    check(err <= 1e-7, f"{label}: toi {float(k[0])} vs plain {float(p[0])}")
    check(not bool(k[1]) and not bool(p[1]), f"{label}: overflow")
    least = solver._least_checks(rows, valid, is_vf, p[0], TOL)
    return {"queries": rows.shape[0], "seed": float(seed), "toi": float(k[0]),
            "plain_toi": float(p[0]), "abs_err": err, "checks": int(k[2]),
            "plain_checks": int(p[2]), "least_checks": least,
            "ms": device_ms(launch, 5), "plain_ms": plain_ms,
            **solve_bound(rows.shape[0], least),
            "block_queries": solver._share_grid(rows.shape[0], is_vf, False, False)[0]}


def max_abs(a, b):
    """Largest |a - b| over two tensors of one shape (0.0 when empty)."""
    return float((a - b).abs().max()) if a.numel() else 0.0


def pair_keys(pairs, n):
    import torch

    p = pairs[: int(n)].to(torch.int64)
    return torch.sort(p[:, 0] * (1 << 32) + p[:, 1]).values


T_START = time.perf_counter()


def main(only=None):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from scalable_ccd_tpu_torch import fused_ccd
    from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
    from scalable_ccd_tpu_torch.geometry import (
        build_edge_boxes,
        build_face_boxes,
        build_vertex_boxes,
        edges_from_faces,
        read_ply,
        validate_mesh_inputs,
    )
    from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
    from scalable_ccd_tpu_torch.narrow_phase import types
    from scalable_ccd_tpu_torch.ops import _build, solver, sweep_ap, sweep_records
    from scalable_ccd_tpu_torch.ops import gather_pack as gp

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cpu_model, cpu_count = host_cpu()
    emit(phase="device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, host_cpu=cpu_model, host_cpu_count=cpu_count,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build: one nvcc per source, started together --------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(LIBS)) as pool:
        list(pool.map(_build.build_library, LIBS))
    for lib in LIBS:
        _build.load_library(lib)
    ptxas = []
    for lib in LIBS:
        log = _build.build_library(lib).with_suffix(".log")
        ptxas += [l.strip() for l in log.read_text().splitlines() if "registers" in l or "spill" in l]
    emit(phase="build", seconds=time.perf_counter() - t0,
         per_library=dict(_build.BUILD_SECONDS), ptxas=ptxas)
    if only is not None:
        if only == "chunk_solve":
            phase_chunk_solve(torch, dev)
        else:
            phase_phase_solve(torch, dev,
                              cloth_on_sphere(grid_n=128, sphere_subdiv=4, drop=0.25),
                              cloth_on_sphere(grid_n=600, sphere_subdiv=4))
        print(smi)
        # a partial run: its ok line names the phases it ran
        print(json.dumps({"ok": True, "phases": ["build", only], "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0

    # ---- bench scene on the card ------------------------------------------
    scene = cloth_on_sphere(grid_n=128, sphere_subdiv=4, drop=0.25)
    v0 = torch.as_tensor(scene.vertices_t0, dtype=torch.float32, device=dev)
    v1 = torch.as_tensor(scene.vertices_t1, dtype=torch.float32, device=dev)
    e = torch.as_tensor(scene.edges, dtype=torch.int32, device=dev)
    f = torch.as_tensor(scene.faces, dtype=torch.int32, device=dev)
    vb = build_vertex_boxes(v0, v1)
    phases = {
        "vf": (True, sort_boxes(merge_two_lists(vb, build_face_boxes(vb, f)))),
        "ee": (False, sort_boxes(build_edge_boxes(vb, e))),
    }

    # ---- 2. kernel A vs plain ---------------------------------------------
    a_ms = a_plain_ms = 0.0
    a_bound = bound(0, 0)
    cand = {}
    for ph, (two, sb) in phases.items():
        budget = 1 << (4 * sb.n - 1).bit_length()
        k = sweep_ap.sweep_pairs(sb, two, budget)
        torch.cuda.synchronize()
        p = sweep_ap.sweep_pairs_reference(sb, two, budget)
        check(not bool(k[3]) and not bool(p[3]), f"kernel A {ph}: budget {budget} overflowed")
        check(int(k[2]) == int(p[2]), f"kernel A {ph}: n_true {int(k[2])} vs plain {int(p[2])}")
        keys = pair_keys(k[0], k[1])
        check(torch.equal(keys, pair_keys(p[0], p[1])), f"kernel A {ph}: pair sets differ")
        check(keys.numel() == torch.unique(keys).numel(), f"kernel A {ph}: duplicate pairs")
        small = sweep_ap.sweep_pairs(sb, two, 64)
        check(bool(small[3]) and int(small[1]) == 64 and int(small[2]) == int(p[2]),
              f"kernel A {ph}: budget 64 did not overflow with the exact total")
        kms, pms = alternate(
            lambda: sweep_ap.sweep_pairs_reference(sb, two, budget),
            lambda: sweep_ap.sweep_pairs(sb, two, budget), 3,
        )
        a_ms, a_plain_ms = a_ms + kms, a_plain_ms + pms
        a_bound = add_bounds(a_bound, sweep_bound(sb, int(p[2]) * PAIR_BYTES))
        cand[ph] = p[0][: int(p[1])]  # sweep order: identical input for both solvers
        emit(phase="kernel_a", which=ph, boxes=sb.n, pairs=int(p[2]), equal=True,
             overflow_64_exact=True, ms=kms, plain_ms=pms)

    # ---- 3. kernel B vs plain ---------------------------------------------
    vcat = types.concat_frames(v0, v1, torch.float32)
    b_ms = b_plain_ms = 0.0
    b_err = 0.0
    b_bound = bound(0, 0)
    bench_rows = {}
    b_seed = torch.ones((), dtype=torch.float32, device=dev)
    for ph, (is_vf, _) in phases.items():
        pairs = cand[ph]
        if is_vf:
            q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, f), pairs)
        else:
            q = types.gather_ee_queries(types.pack_edge_table(vcat, e), pairs)
        rows = solver.pack_query_rows(q, is_vf, 0.0, TOL)
        batches = [rows[s:s + BATCH].contiguous() for s in range(0, rows.shape[0], BATCH)]
        valids = [torch.ones((b.shape[0],), dtype=torch.bool, device=dev) for b in batches]

        def run(fn):
            toi = torch.ones((), dtype=torch.float32, device=dev)
            checks, ovf = 0, False
            for b, v in zip(batches, valids):
                t, o, c = fn(b, v, is_vf, toi, TOL)
                toi = torch.minimum(toi, t)
                checks, ovf = checks + c, ovf | o
            return toi, ovf, checks

        tk, ok_, ck = run(solver.solve_packed)
        torch.cuda.synchronize()
        tp, op_, cp = run(solver.solve_packed_reference)
        err = abs(float(tk) - float(tp))
        check(err <= 1e-7, f"kernel B {ph}: toi {float(tk)} vs plain {float(tp)}")
        check(0.0 <= float(tk) <= 1.0, f"kernel B {ph}: toi {float(tk)} outside [0, 1]")
        kms, pms = alternate(lambda: run(solver.solve_packed_reference),
                             lambda: run(solver.solve_packed), 2)
        # the main path's shape: the phase's rows in one launch
        whole = whole_chunk_global(solver, rows, is_vf, b_seed, f"kernel B {ph} one launch")
        b_seed = torch.minimum(b_seed, torch.tensor(whole["toi"], device=dev))
        b_ms, b_plain_ms = b_ms + whole["ms"], b_plain_ms + whole["plain_ms"]
        b_err = max(b_err, err, whole["abs_err"])
        b_bound = add_bounds(b_bound, {k: whole[k] for k in ("bound_ms", "bound_by")})
        bench_rows[is_vf] = (batches, valids, float(tk))
        emit(phase="kernel_b", which=ph, queries=rows.shape[0], batches=len(batches),
             toi=float(tk), plain_toi=float(tp), abs_err=err, checks=int(ck),
             plain_checks=int(cp), overflow=bool(ok_), plain_overflow=bool(op_),
             batches_ms=kms, batches_plain_ms=pms,
             batches_block_queries=solver._share_grid(BATCH, is_vf, False, False)[0],
             one_launch=whole)

    # ---- 4. the main path ---------------------------------------------------
    mid = cloth_on_sphere(grid_n=64, sphere_subdiv=3)
    margs = (mid.vertices_t0, mid.vertices_t1, mid.edges, mid.faces)
    rg = fused_ccd(*margs, device="cuda")
    rc = fused_ccd(*margs, device="cpu")
    check(abs(float(rg.toi) - float(rc.toi)) <= 1e-7,
          f"grid-64: cuda toi {float(rg.toi)} vs cpu {float(rc.toi)}")
    check(int(rg.vf_total) == int(rc.vf_total) and int(rg.ee_total) == int(rc.ee_total),
          "grid-64: pair totals differ between cuda and cpu")
    check(not bool(rg.overflowed), "grid-64: overflowed")
    emit(phase="main_grid64", toi=float(rg.toi), cpu_toi=float(rc.toi),
         vf_total=int(rg.vf_total), ee_total=int(rg.ee_total))

    gdir = os.path.join(REPO, "tests", "golden", "cloth-sphere-16")
    with open(os.path.join(gdir, "toi.json")) as fh:
        golden = json.load(fh)
    g0, gf = read_ply(os.path.join(gdir, "frames", "f0.ply"))
    g1, _ = read_ply(os.path.join(gdir, "frames", "f1.ply"))
    rgold = fused_ccd(g0, g1, edges_from_faces(gf), gf, device="cuda",
                      tolerance=golden["tolerance"], allow_zero_toi=golden["allow_zero_toi"])
    gt = float(rgold.toi)
    check(not bool(rgold.overflowed), "golden: overflowed")
    check(gt <= golden["toi"] * (1 + 1e-4) + 1e-7, f"golden: toi {gt} later than {golden['toi']}")
    check(abs(gt - golden["toi"]) <= 1e-6 + 2e-2 * golden["toi"],
          f"golden: toi {gt} not within 2% of {golden['toi']}")
    emit(phase="main_golden", scene="cloth-sphere-16", toi=gt, golden_toi=golden["toi"])

    bargs = (v0, v1, e, f)
    validate_mesh_inputs(*bargs)
    zero_counts(sweep_ap, solver)
    res = fused_ccd(*bargs, device="cuda", validate=False)
    torch.cuda.synchronize()
    launches = {"sweep_pairs": sweep_ap.LAUNCHES_BY_MODE.total,
                "solve_packed": solver.LAUNCHES_BY_MODE.total,
                "gather_pack": gp.LAUNCHES_BY_MODE.total}
    main_modes = read_counts(sweep_ap, solver)
    check(all(n > 0 for n in launches.values()), f"main path skipped a kernel: {launches}")
    # the bench scene's defaults: the major sort and one unbounded kernel B
    # launch per phase over the pairs source (no escalation on CUDA), and
    # the presample's over kernel C's columns
    check(main_modes["sweep_whole"] > 0 and main_modes["solve_round_limit"] == 0
          and main_modes["solve_bounded"] == 0 and main_modes["solve_pairs"] == 2
          and main_modes["solve_global"] >= 2, f"main path took an unexpected kernel mode: "
          f"{main_modes}")
    check(not bool(res.overflowed), "bench: overflowed")
    toi = float(res.toi)
    check(0.0 <= toi <= 1.0, f"bench: toi {toi} outside [0, 1]")

    def frame_ms(args, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fused_ccd(*args, device="cuda", validate=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times), times

    ms, times = frame_ms(bargs, 5)
    emit(phase="main_bench", scene="cloth_on_sphere(128, 4, drop=0.25)",
         vf_boxes=phases["vf"][1].n, ee_boxes=phases["ee"][1].n,
         vf_total=int(res.vf_total), ee_total=int(res.ee_total), toi=toi,
         total_checks=int(res.total_checks), solver_capped=bool(res.solver_capped),
         launches=launches, ms_per_frame_median=ms, ms_per_frame=times)

    big = cloth_on_sphere(grid_n=384, sphere_subdiv=5, drop=0.25)
    big_args = tuple(
        torch.as_tensor(a, dtype=dt, device=dev)
        for a, dt in ((big.vertices_t0, torch.float32), (big.vertices_t1, torch.float32),
                      (big.edges, torch.int32), (big.faces, torch.int32))
    )
    rb = fused_ccd(*big_args, device="cuda")
    check(not bool(rb.overflowed) and 0.0 <= float(rb.toi) <= 1.0, "grid-384: bad result")
    bms, btimes = frame_ms(big_args, 3)
    emit(phase="main_grid384", scene="cloth_on_sphere(384, 5, drop=0.25)",
         vf_total=int(rb.vf_total), ee_total=int(rb.ee_total), toi=float(rb.toi),
         ms_per_frame_median=bms, ms_per_frame=btimes)

    exact = phase_exact_modes(torch, dev, cloth_on_sphere, types, solver)
    ranged = phase_box_range(torch, phases, sweep_ap)
    ipc = phase_ipc_path(torch, dev, cloth_on_sphere, sweep_ap, solver)

    grid600_scene = cloth_on_sphere(grid_n=600, sphere_subdiv=4)
    grid600 = scene_on(torch, dev, grid600_scene)
    congestion = phase_congestion(torch, grid600, sweep_ap)
    records = phase_records(torch, bargs, congestion["sorted"], sweep_ap, sweep_records)
    escalation = phase_escalation(torch, dev, bench_rows, solver)
    grid_b = phase_grid_solver(torch, dev, grid600, congestion["sample"], congestion["chunk"],
                               types, solver)
    congested = phase_congested_main(torch, dev, grid600, bargs, cloth_on_sphere, res)
    congestion_row = congestion["row"]
    del grid600, congestion
    f64_rows = phase_f64_kernels(torch, dev, scene, mid, phases)
    counting = phase_count_only(torch, dev, scene, grid600_scene)
    precise = phase_precision_path(torch, dev, scene, mid, grid600_scene, res)
    phase_kernel_b_rows()
    multi = phase_multi_device(torch, dev, scene, grid600_scene, mid, smi)
    loop = phase_narrow_loop(torch, dev, scene, grid600_scene)
    pairs_rows = phase_chunk_solve(torch, dev)
    phase_rows = phase_phase_solve(torch, dev, scene, grid600_scene)
    phase_grid1000(torch, dev, cloth_on_sphere)

    launched = lambda run, key: precise[run].get(key, 0)  # noqa: E731
    src = "scalable_ccd_tpu_torch/csrc/"
    sweep = {"route": "cuda", "source": src + "sweep_ap.cu",
             "replaces": "scalable_ccd_tpu/ops/pallas_sweep_ap.py:291", "library_ms": None}
    recs = {"route": "cuda", "source": src + "sweep_records.cu",
            "replaces": "scalable_ccd_tpu/ops/pallas_sweep_ap.py:1356", "library_ms": None}
    solve = {"route": "cuda", "source": src + "solver.cu",
             "replaces": "scalable_ccd_tpu/ops/pallas_solver.py:114", "library_ms": None}
    pack = {"route": "cuda", "source": src + "gather_pack.cu",
            "replaces": "scalable_ccd_tpu/ops/pallas_solver.py:649", "library_ms": None}
    f32_packs = lambda c, m: c.get(f"gather_{m}", 0) - c.get(f"gather_{m}_f64", 0)  # noqa: E731
    print(json.dumps({"kernels": [
        {"name": "sweep_pairs[whole]", **sweep, "launches": main_modes["sweep_whole"],
         "max_abs_err": 0.0, "ms": a_ms, "plain_ms": a_plain_ms, **a_bound},
        {"name": "sweep_pairs[range]", **sweep, "launches": ipc["sweep_range"],
         "max_abs_err": 0.0, "ms": ranged["ms"], "plain_ms": ranged["plain_ms"], **a_bound},
        {"name": "sweep_pairs[any_order]", **sweep,
         "launches": congested["counts"]["sweep_any_order"], **congestion_row},
        {"name": "sweep_records[sorted]", **recs,
         "launches": congested["records_bench_counts"]["records_sorted"], **records["sorted"]},
        {"name": "sweep_records[any_order]", **recs,
         "launches": congested["records_counts"]["records_any_order"], **records["any_order"]},
        # global over kernel C's columns: the presample's launches on the
        # main path; timed over each bench phase in one launch (phase 3);
        # ``grid600``: each phase's first chunk of grid-600 in one launch
        # (phase 10)
        {"name": "solve_packed[global]", **solve,
         "launches": main_modes["solve_global"] - main_modes["solve_pairs"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain_ms, **b_bound,
         "grid600": grid_b["global"]},
        # the pairs source in the shared form, the main path's launch over a
        # phase (phase 4's launches); ms, plain ms and bound over the bench
        # scene's and grid-600's phases (phase 19)
        {"name": "solve_pairs[global]", **solve, "launches": main_modes["solve_pairs"],
         **phase_rows["float32"]},
        {"name": "solve_packed[per_query]", **solve, "launches": ipc["solve_per_query"],
         **exact["per_query"]},
        {"name": "solve_packed[bounded]", **solve,
         "launches": ipc["solve_bounded"] - ipc["solve_pairs"], **exact["bounded"]},
        # the pairs source, the IPC path's bounded solve (phase 7's launches);
        # ms, plain ms and bound on the IPC cell's frame 0 chunks (phase 18)
        {"name": "solve_pairs[bounded]", **solve, "launches": ipc["solve_pairs"],
         **pairs_rows["float32"]},
        # round_limit: the default path launches none; ``escalated_launches``
        # are grid-600's with escalate_rounds=128 (phase 11)
        {"name": "solve_packed[round_limit]", **solve,
         "launches": main_modes["solve_round_limit"],
         "escalated_launches": congested["ladder_counts"]["solve_round_limit"], **escalation},
        # the f64 instantiations and count_only: launches per frame of the
        # path that uses each (phase 14's runs with zeroed counters)
        {"name": "sweep_pairs[whole,f64]", **sweep,
         "launches": launched("fused_f64", "sweep_whole_f64"), **f64_rows["whole"]},
        {"name": "sweep_pairs[range,f64]", **sweep,
         "launches": launched("ccd_f64", "sweep_range_f64"), **f64_rows["range"]},
        {"name": "sweep_pairs[any_order,f64]", **sweep,
         "launches": launched("grid600_f64", "sweep_any_order_f64"),
         **counting["any_order_f64"]},
        {"name": "sweep_pairs[count_only]", **sweep,
         "launches": launched("stages_128_float32", "sweep_count_only"),
         **counting["float32"]},
        {"name": "sweep_pairs[count_only,f64]", **sweep,
         "launches": launched("stages_128_float64", "sweep_count_only_f64"),
         **counting["float64"]},
        {"name": "sweep_records[sorted,f64]", **recs,
         "launches": launched("fused_f64_records", "records_sorted_f64"),
         **f64_rows["records"]},
        {"name": "solve_packed[global,f64]", **solve,
         "launches": launched("fused_f64", "solve_global_f64")
         - launched("fused_f64", "solve_pairs_f64"), **f64_rows["global"]},
        {"name": "solve_pairs[global,f64]", **solve,
         "launches": launched("fused_f64", "solve_pairs_f64"), **phase_rows["float64"]},
        {"name": "solve_pairs[global,compensated]", **solve,
         "launches": launched("fused_compensated", "solve_pairs_f64"),
         **phase_rows["compensated"]},
        {"name": "solve_packed[per_query,f64]", **solve,
         "launches": launched("fused_f64_collisions", "solve_per_query_f64"),
         **f64_rows["per_query"]},
        {"name": "solve_packed[bounded,f64]", **solve,
         "launches": launched("ipc_f64", "solve_bounded_f64")
         - launched("ipc_f64", "solve_pairs_f64"), **f64_rows["bounded"]},
        {"name": "solve_pairs[bounded,f64]", **solve,
         "launches": launched("ipc_f64", "solve_pairs_f64"), **pairs_rows["float64"]},
        {"name": "solve_pairs[bounded,compensated]", **solve,
         "launches": launched("ipc_compensated", "solve_pairs_f64"),
         **pairs_rows["compensated"]},
        {"name": "solve_packed[round_limit,f64]", **solve,
         "launches": launched("fused_f64_round_limit", "solve_round_limit_f64"),
         **f64_rows["round_limit"]},
        # the a-row range: launches per frame of sharded_ccd in a world of
        # one process (phase 16)
        {"name": "sweep_records[range]", **recs,
         "launches": multi["launches"]["records"]["records_range"],
         **multi["rows"]["float32"]},
        {"name": "sweep_records[range,f64]", **recs,
         "launches": multi["launches"]["records_f64"]["records_range_f64"],
         **multi["rows"]["float64"]},
        # kernel C: launches per frame of the bench scene (phase 4's run,
        # phase 14's f64 and compensated runs)
        {"name": "gather_pack[vf]", **pack, "launches": f32_packs(main_modes, "vf"),
         **loop["f32"]["vf"]},
        {"name": "gather_pack[ee]", **pack, "launches": f32_packs(main_modes, "ee"),
         **loop["f32"]["ee"]},
        {"name": "gather_pack[f64]", **pack,
         "launches": launched("fused_f64", "gather_f64"), **loop["f64"]["both"]},
        {"name": "gather_pack[compensated]", **pack,
         "launches": launched("fused_compensated", "gather_compensated"),
         **loop["compensated"]["both"]},
        # the records mode: launches of grid-600's records frame (phase 11),
        # times over grid-600's chunks (phase 17)
        {"name": "gather_pack[records]", **pack,
         "replaces": "scalable_ccd_tpu/ops/pallas_sweep_ap.py:1521",
         "launches": congested["records_counts"]["gather_records"],
         **loop["grid600_f32"]["records"]},
    ]}))
    emit(phase="done", wall_seconds=time.perf_counter() - T_START)
    print(f"host: {cpu_model}, {cpu_count} CPUs")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


# ---- launch counters -------------------------------------------------------

def _counted_modules():
    from scalable_ccd_tpu_torch.ops import gather_pack, solver, sweep_ap, sweep_records

    return {"sweep": sweep_ap, "records": sweep_records, "solve": solver,
            "gather": gather_pack}


def zero_counts(*_):
    """Set every kernel's launch counts to 0."""
    for mod in _counted_modules().values():
        for k in mod.LAUNCHES_BY_MODE:
            mod.LAUNCHES_BY_MODE[k] = 0


def read_counts(*_):
    """Every kernel's launches by mode, as ``{"<kernel>_<mode>": n}``."""
    return {f"{name}_{k}": v for name, mod in _counted_modules().items()
            for k, v in mod.LAUNCHES_BY_MODE.items()}


# ---- 5. kernel B's exact modes vs plain ----------------------------------------

def phase_exact_modes(torch, dev, cloth_on_sphere, types, solver):
    """Per-query, bounded and min-separation modes of kernel B against the
    plain version on every candidate of cloth_on_sphere(64, 3), in batches
    of 16,384.  Returns the JSON fields of the per_query and bounded rows."""
    from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
    from scalable_ccd_tpu_torch.geometry import (
        build_edge_boxes,
        build_face_boxes,
        build_vertex_boxes,
    )
    from scalable_ccd_tpu_torch.ops import sweep_ap

    sc = cloth_on_sphere(grid_n=64, sphere_subdiv=3)
    v0 = torch.as_tensor(sc.vertices_t0, dtype=torch.float32, device=dev)
    v1 = torch.as_tensor(sc.vertices_t1, dtype=torch.float32, device=dev)
    e = torch.as_tensor(sc.edges, dtype=torch.int32, device=dev)
    f = torch.as_tensor(sc.faces, dtype=torch.int32, device=dev)
    vb = build_vertex_boxes(v0, v1)
    vcat = types.concat_frames(v0, v1, torch.float32)
    rows = {}
    for is_vf in (True, False):
        if is_vf:
            sb = sort_boxes(merge_two_lists(vb, build_face_boxes(vb, f)))
        else:
            sb = sort_boxes(build_edge_boxes(vb, e))
        budget = 1 << (4 * sb.n - 1).bit_length()
        p, n, _, _ = sweep_ap.sweep_pairs_reference(sb, is_vf, budget)
        pairs = p[: int(n)]
        if is_vf:
            q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, f), pairs)
        else:
            q = types.gather_ee_queries(types.pack_edge_table(vcat, e), pairs)
        rows[is_vf] = {ms: [r[s:s + BATCH].contiguous() for s in range(0, r.shape[0], BATCH)]
                       for ms in (0.0, 1e-3)
                       for r in [solver.pack_query_rows(q, is_vf, ms, TOL)]}

    def run(fn, is_vf, ms=0.0, **kw):
        toi = torch.ones((), dtype=torch.float32, device=dev)
        checks, pqs = 0, []
        for b in rows[is_vf][ms]:
            valid = torch.ones((b.shape[0],), dtype=torch.bool, device=dev)
            out = fn(b, valid, is_vf, toi, TOL, **kw)
            toi = torch.minimum(toi, out[0])
            checks += int(out[2])
            if len(out) > 3:
                pqs.append(out[3])
        return toi, checks, (torch.cat(pqs) if pqs else None)

    out = {}
    for label, kw, ms in (("per_query", dict(per_query=True), 0.0),
                          ("per_query_cap10", dict(per_query=True, max_iterations=10), 0.0),
                          ("per_query_cap100", dict(per_query=True, max_iterations=100), 0.0),
                          ("global_ms", {}, 1e-3),
                          ("global_cap", dict(max_iterations=1_000_000), 0.0)):
        errs, kms_sum, pms_sum, info = [], 0.0, 0.0, {}
        bnd = bound(0, 0)
        for is_vf in (True, False):
            ph = "vf" if is_vf else "ee"
            tk, ck, pk = run(solver.solve_packed, is_vf, ms, **kw)
            torch.cuda.synchronize()
            tp, cp, pp = run(solver.solve_packed_reference, is_vf, ms, **kw)
            err = abs(float(tk) - float(tp))
            if pk is not None:
                check(torch.equal(pk < 1, pp < 1), f"{label} {ph}: hit sets differ")
                check(torch.equal(torch.isinf(pk), torch.isinf(pp)), f"{label} {ph}: inf rows differ")
                fin = torch.isfinite(pp)
                err = max(err, max_abs(pk[fin], pp[fin]))
                info[ph + "_hits"] = int((pk < 1).sum())
                info[ph + "_bitwise"] = bool(torch.equal(pk, pp))
            check(err <= 1e-7, f"{label} {ph}: kernel vs plain differ by {err}")
            if label == "global_cap":
                tu, cu, _ = run(solver.solve_packed, is_vf)
                check(float(tk) == float(tu), f"{label} {ph}: capped {float(tk)} vs unbounded {float(tu)}")
                info[ph + "_unbounded_checks"] = cu
            kms, pms = alternate(lambda: run(solver.solve_packed_reference, is_vf, ms, **kw),
                                 lambda: run(solver.solve_packed, is_vf, ms, **kw), 1)
            errs.append(err)
            kms_sum, pms_sum = kms_sum + kms, pms_sum + pms
            n_q = sum(b.shape[0] for b in rows[is_vf][ms])
            # capped per-query work is fixed by each query's order: the
            # plain version's checks are the kernel's
            need = (cp if kw.get("per_query") and "max_iterations" in kw
                    else least_checks(solver, rows[is_vf][ms], is_vf, tp, pp))
            info.update({ph + "_toi": float(tk), ph + "_checks": ck, ph + "_plain_checks": cp,
                         ph + "_least_checks": need, ph + "_queries": n_q})
            # a per-query call also writes one f32 TOI per row
            bnd = add_bounds(bnd, solve_bound(n_q, need, 4 * n_q if pk is not None else 0))
        out[label] = {"max_abs_err": max(errs), "ms": kms_sum, "plain_ms": pms_sum, **bnd}
        emit(phase="kernel_b_mode", mode=label, **out[label], **info)
    bounded = [out[k] for k in ("per_query_cap10", "per_query_cap100", "global_cap")]
    bnd = bound(0, 0)
    for b in bounded:
        bnd = add_bounds(bnd, b)
    return {
        "per_query": out["per_query"],
        "bounded": {"max_abs_err": max(b["max_abs_err"] for b in bounded),
                    "ms": sum(b["ms"] for b in bounded),
                    "plain_ms": sum(b["plain_ms"] for b in bounded), **bnd},
    }


# ---- 6. kernel A's box range ---------------------------------------------------

def phase_box_range(torch, phases, sweep_ap):
    """Ranged launches over chunks of 2^15 sorted boxes against the
    whole-range set, and the chunk cursor's budget retry."""
    import importlib

    sweep_chunks = importlib.import_module("scalable_ccd_tpu_torch.pipeline.ccd").sweep_chunks
    chunk = 1 << 15
    kms_sum = pms_sum = 0.0
    for ph, (two, sb) in phases.items():
        budget = 1 << (4 * sb.n - 1).bit_length()
        whole = sweep_ap.sweep_pairs(sb, two, budget)
        ranges = [(b0, min(b0 + chunk, sb.n)) for b0 in range(0, sb.n, chunk)]
        keys, total = [], 0
        for rng in ranges:
            p, n, n_true, ovf = sweep_ap.sweep_pairs(sb, two, budget, box_range=rng)
            check(not bool(ovf), f"range {ph} {rng}: overflowed")
            keys.append(pair_keys(p, n))
            total += int(n_true)
        keys = torch.sort(torch.cat(keys)).values
        check(total == int(whole[2]), f"range {ph}: total {total} vs whole {int(whole[2])}")
        check(torch.equal(keys, pair_keys(whole[0], whole[1])), f"range {ph}: union differs")
        got, counts = [], []
        for pairs, count in sweep_chunks(sb, two, chunk, 64):
            got.append(pair_keys(pairs, count))
            counts.append(count)
        check(sum(counts) == total and max(counts) > 64,
              f"range {ph}: budget-64 chunks gave {counts}, want total {total}")
        check(torch.equal(torch.sort(torch.cat(got)).values, keys), f"range {ph}: retried set differs")
        kms, pms = alternate(
            lambda: [sweep_ap.sweep_pairs_reference(sb, two, budget, box_range=r) for r in ranges],
            lambda: [sweep_ap.sweep_pairs(sb, two, budget, box_range=r) for r in ranges], 3)
        kms_sum, pms_sum = kms_sum + kms, pms_sum + pms
        emit(phase="kernel_a_range", which=ph, chunks=len(ranges), pairs=total,
             budget64_chunk_counts=counts, ms=kms, plain_ms=pms)
    return {"ms": kms_sum, "plain_ms": pms_sum}


# ---- 7. the IPC path ----------------------------------------------------------------

def ipc_loop(scene, device, impls, frames=3):
    """The IPC stepping loop of examples/ipc_loop.py: per frame, the plain
    fused TOI at ms=0 and ipc_ccd_strategy with each impl; the vertices
    advance by the chunked TOI (numpy f64 on the host, so every device sees
    the same positions)."""
    import numpy as np

    from scalable_ccd_tpu_torch import CCDStats, fused_ccd, ipc_ccd_strategy

    v = np.asarray(scene.vertices_t0, np.float64)
    target = np.asarray(scene.vertices_t1, np.float64)
    out = []
    for _ in range(frames):
        args = (v, target, scene.edges, scene.faces)
        row = {"toi_ms0": float(fused_ccd(*args, device=device).toi)}
        for impl in impls:
            st = CCDStats()
            row[impl] = ipc_ccd_strategy(*args, min_distance=1e-3, max_iterations=1_000_000,
                                         tolerance=1e-6, impl=impl, stats=st, device=device)
            row[impl + "_refinements"] = st.ipc_refinements
        out.append(row)
        v = v + row[impls[0]] * (target - v)
    return out


def check_ipc_frames(frames, label):
    for k, fr in enumerate(frames):
        for impl in ("chunked", "fused"):
            check(0.0 <= fr[impl] <= fr["toi_ms0"],
                  f"{label} frame {k}: {impl} toi {fr[impl]} outside [0, {fr['toi_ms0']}]")
        if fr["chunked_refinements"] == 0 and fr["fused_refinements"] == 0:
            check(abs(fr["chunked"] - fr["fused"]) <= 1e-7,
                  f"{label} frame {k}: chunked {fr['chunked']} vs fused {fr['fused']}")


def same_hits(a, b, label):
    a, b = sorted(a), sorted(b)
    check([h[:2] for h in a] == [h[:2] for h in b], f"{label}: hit sets differ")
    err = max((abs(x[2] - y[2]) for x, y in zip(a, b)), default=0.0)
    check(err <= 1e-7, f"{label}: per-pair TOIs differ by {err}")
    return err


def phase_ipc_path(torch, dev, cloth_on_sphere, sweep_ap, solver):
    import numpy as np

    from scalable_ccd_tpu_torch import CCDConfig, CCDStats, MemoryConfig, ccd, fused_ccd
    from scalable_ccd_tpu_torch import ipc_ccd_strategy
    from scalable_ccd_tpu_torch.geometry import edges_from_faces

    bench = cloth_on_sphere(grid_n=128, sphere_subdiv=4, drop=0.25)
    bargs = tuple(torch.as_tensor(a, dtype=dt, device=dev) for a, dt in (
        (bench.vertices_t0, torch.float32), (bench.vertices_t1, torch.float32),
        (bench.edges, torch.int32), (bench.faces, torch.int32)))

    # the slice's path, with zeroed counters: ccd(), collisions, IPC frames
    zero_counts(sweep_ap, solver)
    st = CCDStats()
    toi_c = ccd(*bargs, device=dev, stats=st)
    hits_f, hits_c = [], []
    res_f = fused_ccd(*bargs, device=dev, collisions=hits_f)
    toi_cc = ccd(*bargs, device=dev, collisions=hits_c)
    frames = ipc_loop(bench, dev, ("chunked", "fused"))
    torch.cuda.synchronize()
    counts = read_counts(sweep_ap, solver)
    for k in ("sweep_range", "solve_global", "solve_per_query", "solve_bounded",
              "solve_pairs"):
        check(counts[k] > 0, f"IPC path launched no {k}: {counts}")

    fused = fused_ccd(*bargs, device=dev)
    check(abs(toi_c - float(fused.toi)) <= 1e-7, f"ccd toi {toi_c} vs fused {float(fused.toi)}")
    check((st.vf_candidates, st.ee_candidates) == (int(fused.vf_total), int(fused.ee_total)),
          f"ccd candidates {st.vf_candidates}/{st.ee_candidates} vs fused totals")
    err = same_hits(hits_f, hits_c, "bench collisions fused vs ccd")
    check(min(t for *_, t in hits_f) == float(res_f.toi) and abs(toi_cc - float(res_f.toi)) <= 1e-7,
          "bench collisions: min hit toi differs from toi")
    check_ipc_frames(frames, "bench IPC")
    emit(phase="ipc_bench", ccd_toi=toi_c, fused_toi=float(fused.toi),
         vf_candidates=st.vf_candidates, ee_candidates=st.ee_candidates,
         hits=len(hits_f), collisions_toi=float(res_f.toi), hit_toi_max_err=err,
         frames=frames, launches=counts)

    # the IPC refinement rig (tests/test_pipeline.py:175-228, f32, rig at x=5)
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    v0p, v1p, fp, nv = [], [], [], 0
    for cx in (0.0, 10.0, 20.0, 30.0):
        v0p += [tri + [cx, 0.0, 0.0], tri + [cx, 0.0, 0.12]]
        v1p += [tri + [cx, 0.0, 0.0], tri + [cx, 0.0, 0.09]]
        fp += [np.arange(3) + nv, np.arange(3) + nv + 3]
        nv += 6
    rig0 = np.concatenate([tri, [[0.25, 0.25, 0.01]]]) + [5.0, 0.0, 0.0]
    rig1 = rig0.copy()
    rig1[3, 2] -= 0.03
    rfaces = np.stack(fp + [np.arange(3) + nv]).astype(np.int32)
    rcfg = CCDConfig(memory=MemoryConfig(box_chunk_size=8, pair_chunk_size=1 << 12,
                                         query_buckets=(1 << 10,)))
    rst = CCDStats()
    rtoi = ipc_ccd_strategy(np.concatenate(v0p + [rig0]), np.concatenate(v1p + [rig1]),
                            edges_from_faces(rfaces), rfaces, min_distance=0.05,
                            config=rcfg, stats=rst, device=dev)
    check(rst.ipc_refinements == 1 and abs(rtoi - 0.8 / 3.0) <= 1e-3 * 0.8 / 3.0,
          f"rig: {rst.ipc_refinements} refinements, toi {rtoi}")
    emit(phase="ipc_rig", toi=rtoi, ipc_refinements=rst.ipc_refinements)

    # CUDA against CPU on cloth_on_sphere(64, 3)
    mid = cloth_on_sphere(grid_n=64, sphere_subdiv=3)
    margs = (mid.vertices_t0, mid.vertices_t1, mid.edges, mid.faces)
    sg, sc = CCDStats(), CCDStats()
    tg, tc = ccd(*margs, device=dev, stats=sg), ccd(*margs, device="cpu", stats=sc)
    check(abs(tg - tc) <= 1e-7 and (sg.vf_candidates, sg.ee_candidates)
          == (sc.vf_candidates, sc.ee_candidates), f"grid-64 ccd: cuda {tg} vs cpu {tc}")
    hg, hc = [], []
    ccd(*margs, device=dev, collisions=hg)
    ccd(*margs, device="cpu", collisions=hc)
    herr = same_hits(hg, hc, "grid-64 collisions cuda vs cpu")
    fg = ipc_loop(mid, dev, ("chunked", "fused"))
    fg2 = ipc_loop(mid, dev, ("fused",))
    fc = ipc_loop(mid, "cpu", ("chunked", "fused"))
    check_ipc_frames(fg, "grid-64 IPC")
    for k, (a, b, c) in enumerate(zip(fg, fc, fg2)):
        for impl in ("chunked", "fused"):
            check(abs(a[impl] - b[impl]) <= 1e-7
                  and a[impl + "_refinements"] == b[impl + "_refinements"],
                  f"grid-64 IPC frame {k} {impl}: cuda {a[impl]} vs cpu {b[impl]}")
        check(a["fused"] == c["fused"], f"grid-64 IPC frame {k}: fused not repeatable")
    emit(phase="ipc_grid64", ccd_toi=tg, cpu_ccd_toi=tc, hits=len(hg), hit_toi_max_err=herr,
         frames_cuda=fg, frames_cpu=fc)

    # timings on the bench scene, median of 5 after a warm-up
    def timed(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times), times

    kw = dict(min_distance=1e-3, max_iterations=1_000_000, tolerance=1e-6, device=dev,
              validate=False)
    timings = {
        "ipc_frame_chunked": timed(lambda: ipc_ccd_strategy(*bargs, **kw)),
        "ipc_frame_fused": timed(lambda: ipc_ccd_strategy(*bargs, impl="fused", **kw)),
        "fused_collisions": timed(lambda: fused_ccd(*bargs, device=dev, validate=False,
                                                    collisions=[])),
        "ccd": timed(lambda: ccd(*bargs, device=dev, validate=False)),
    }
    emit(phase="ipc_timing", scene="cloth_on_sphere(128, 4, drop=0.25)",
         **{k + "_ms_median": v[0] for k, v in timings.items()},
         **{k + "_ms": v[1] for k, v in timings.items()})
    return counts


# ---- 8. congestion on grid-600 ----------------------------------------------------

def scene_on(torch, dev, scene, dtype=None):
    """``(v0, v1, edges, faces)`` of ``scene`` on ``dev`` (vertices f32 unless
    ``dtype`` says f64, indices int32)."""
    dtype = dtype or torch.float32
    return tuple(torch.as_tensor(a, dtype=dt, device=dev) for a, dt in (
        (scene.vertices_t0, dtype), (scene.vertices_t1, dtype),
        (scene.edges, torch.int32), (scene.faces, torch.int32)))


def phase_boxes(args):
    """``{phase: (two_lists, unsorted boxes)}`` of a scene on the card, in
    the dtype of its vertices."""
    from scalable_ccd_tpu_torch.broad_phase import merge_two_lists
    from scalable_ccd_tpu_torch.geometry import (
        build_edge_boxes,
        build_face_boxes,
        build_vertex_boxes,
    )

    v0, v1, e, f = args
    vb = build_vertex_boxes(v0, v1, dtype=v0.dtype)
    return {"vf": (True, merge_two_lists(vb, build_face_boxes(vb, f))),
            "ee": (False, build_edge_boxes(vb, e))}


def timed_once(fn):
    """``(fn(), ms)``, timed with CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def pow2ceil(n):
    return 1 << (max(int(n), 1) - 1).bit_length()


def phase_congestion(torch, args, sweep_ap):
    """The bucket-ordered sort of grid-600 and kernel A ``any_order`` on it,
    against its plain version and against kernel A on the major sort."""
    from scalable_ccd_tpu_torch.broad_phase import sort_boxes
    from scalable_ccd_tpu_torch.ops.gather_pack import chunk_rows

    out = {"sorted": {}, "sample": {}, "chunk": {}}
    kms_sum = pms_sum = 0.0
    bnd = bound(0, 0)
    for ph, (two, boxes) in phase_boxes(args).items():
        (bucket, major), sort_ms = timed_once(
            lambda: (sort_boxes(boxes, bucket_minor=True), sort_boxes(boxes)))
        planes = sweep_ap.partner_planes(bucket)
        n_true = int(sweep_ap.sweep_pairs(major, two, 64)[2])
        budget = pow2ceil(n_true)
        zero_counts()
        k = sweep_ap.sweep_pairs(bucket, two, budget, any_order=True, planes=planes)
        w = sweep_ap.sweep_pairs(major, two, budget)
        counts = {m: sweep_ap.LAUNCHES_BY_MODE[m] for m in ("whole", "any_order")}
        check(counts == {"whole": 2, "any_order": 1},
              f"congestion {ph}: kernel A launches by mode {counts}")
        p, plain_ms = timed_once(
            lambda: sweep_ap.sweep_pairs_reference(bucket, two, budget, any_order=True,
                                                   planes=planes))
        pw, plain_major_ms = timed_once(
            lambda: sweep_ap.sweep_pairs_reference(major, two, budget))
        check(not any(bool(x[3]) for x in (k, w, p, pw)), f"congestion {ph}: overflowed")
        check(int(k[2]) == int(p[2]) == int(w[2]) == int(pw[2]) == n_true,
              f"congestion {ph}: totals {int(k[2])} / plain {int(p[2])} / major {int(w[2])}"
              f" / plain major {int(pw[2])}")
        keys = pair_keys(k[0], k[1])
        check(keys.numel() == torch.unique(keys).numel(), f"congestion {ph}: duplicate pairs")
        check(torch.equal(keys, pair_keys(p[0], p[1])), f"congestion {ph}: plain pair set differs")
        check(torch.equal(keys, pair_keys(w[0], w[1])), f"congestion {ph}: major-sort set differs")
        check(torch.equal(keys, pair_keys(pw[0], pw[1])),
              f"congestion {ph}: plain major-sort set differs")
        check(bool((bucket.major_min[1:] < bucket.major_min[:-1]).any()),
              f"congestion {ph}: the bucket ordering is the major sort")
        # turns: major, any_order, any_order, major
        kms, wms = alternate(
            lambda: sweep_ap.sweep_pairs(major, two, budget),
            lambda: sweep_ap.sweep_pairs(bucket, two, budget, any_order=True, planes=planes), 3)
        kms_sum, pms_sum = kms_sum + kms, pms_sum + plain_ms
        work = any_order_work(bucket, planes)
        ph_bound = any_order_bound(bucket, planes, work, n_true * PAIR_BYTES)
        bnd = add_bounds(bnd, ph_bound)
        out["sorted"][ph] = (two, boxes, bucket, major, planes, budget, work)
        # the first four narrow batches, in the plain sweep's row order
        out["sample"][ph] = p[0][: min(int(p[1]), 4 * BATCH)]
        # the first chunk the narrow loop packs (kernel C) and kernel B's
        # round-limited pass reads in one launch
        out["chunk"][ph] = p[0][: min(int(p[1]), chunk_rows(BATCH))]
        emit(phase="congestion", scene="cloth_on_sphere(600, 4)", which=ph, boxes=bucket.n,
             pairs=n_true, major_slots=major_slots(major), any_order_slots=work[0],
             any_order_row_tests=work[1], sort_both_ms=sort_ms,
             any_order_ms=kms, major_sort_ms=wms, plain_any_order_ms=plain_ms,
             plain_major_sort_ms=plain_major_ms, bound_ms=ph_bound["bound_ms"],
             bound_by=ph_bound["bound_by"], equal=True)
    out["row"] = {"max_abs_err": 0.0, "ms": kms_sum, "plain_ms": pms_sum, **bnd}
    return out


# ---- 9. kernel A' (records) ----------------------------------------------------

def record_keys(rec, n_rec):
    """The ``(row, partner)`` key of each of the first ``n_rec`` records."""
    import torch

    r = rec[: int(n_rec)].to(torch.int64)
    return r[:, 5] * (1 << 32) + r[:, 4]


def record_rows(rec, n_rec):
    """Records in a canonical order (each (row, partner) holds one record)."""
    import torch

    return rec[: int(n_rec)][torch.argsort(record_keys(rec, n_rec))]


def phase_records(torch, bench_args, grid_sorted, sweep_ap, sweep_records):
    """Kernel A' against its plain version, kernel A and the decode, on the
    bench scene and grid-600 in both orderings."""
    from scalable_ccd_tpu_torch.broad_phase import sort_boxes

    cases = []
    for ph, (two, boxes) in phase_boxes(bench_args).items():
        bucket = sort_boxes(boxes, bucket_minor=True)
        major = sort_boxes(boxes)
        budget = pow2ceil(int(sweep_ap.sweep_pairs(major, two, 64)[2]))
        planes = sweep_ap.partner_planes(bucket)
        cases.append(("bench", ph, two, major, bucket, planes, budget,
                      any_order_work(bucket, planes)))
    for ph, (two, _, bucket, major, planes, budget, work) in grid_sorted.items():
        cases.append(("grid600", ph, two, major, bucket, planes, budget, work))
    rows = {"sorted": [0.0, 0.0, bound(0, 0)], "any_order": [0.0, 0.0, bound(0, 0)]}
    for scene, ph, two, major, bucket, planes, budget, work in cases:
        for order, sb in (("sorted", major), ("any_order", bucket)):
            ao = order == "any_order"
            kw = dict(any_order=ao, planes=planes if ao else None)
            k = sweep_records.sweep_records(sb, two, budget, **kw)
            a = sweep_ap.sweep_pairs(sb, two, budget, **kw)
            p, plain_ms = timed_once(
                lambda: sweep_records.sweep_records_reference(sb, two, budget, 0, **kw))
            label = f"records {scene} {ph} {order}"
            check(not bool(k[3]) and not bool(p[3]), f"{label}: overflowed")
            n_rec, n_pairs = int(k[1]), int(k[2])
            check((n_rec, n_pairs) == (int(p[1]), int(p[2])),
                  f"{label}: counts {n_rec}/{n_pairs} vs plain {int(p[1])}/{int(p[2])}")
            check(n_pairs == int(a[2]), f"{label}: {n_pairs} pairs vs kernel A {int(a[2])}")
            check(torch.equal(record_rows(k[0], n_rec), record_rows(p[0], n_rec)),
                  f"{label}: record multisets differ")

            def decode_all(rec=k[0], n_rec=n_rec, n_pairs=n_pairs, sb=sb):
                cum = sweep_records.records_pair_prefix(rec, n_rec)
                return sweep_records.decode_records_range(sb, rec, cum, 0, n_pairs, 0, two)[0]

            dec = decode_all()
            check(torch.equal(pair_keys(dec, n_pairs), pair_keys(a[0], a[1])),
                  f"{label}: decoded pairs differ from kernel A's")
            for small_budget in (0, 64):
                small = sweep_records.sweep_records(sb, two, small_budget, **kw)
                check(bool(small[3]) and (int(small[1]), int(small[2])) == (n_rec, n_pairs),
                      f"{label}: budget {small_budget} did not overflow with exact totals")
            check(bool(torch.isin(record_keys(small[0], 64), record_keys(k[0], n_rec)).all()),
                  f"{label}: budget 64 wrote a record the full run has not")
            rec_ms, a_ms = alternate(
                lambda: sweep_ap.sweep_pairs(sb, two, budget, **kw),
                lambda: sweep_records.sweep_records(sb, two, budget, **kw), 3)
            dec_ms, _ = alternate(
                lambda: sweep_ap.sweep_pairs(sb, two, budget, **kw),
                lambda: (sweep_records.sweep_records(sb, two, budget, **kw), decode_all()), 1)
            if ao:
                case_bound = any_order_bound(bucket, planes, work, n_rec * RECORD_BYTES)
            else:
                case_bound = sweep_bound(major, n_rec * RECORD_BYTES)
            if (scene, order) in (("bench", "sorted"), ("grid600", "any_order")):
                row = rows[order]
                row[0] += rec_ms
                row[1] += plain_ms
                row[2] = add_bounds(row[2], case_bound)
            emit(phase="records", scene=scene, which=ph, order=order, records=n_rec,
                 pairs=n_pairs, pairs_per_record=n_pairs / max(n_rec, 1), equal=True,
                 overflow_0_64_exact=True, records_ms=rec_ms, records_and_decode_ms=dec_ms,
                 kernel_a_ms=a_ms, plain_ms=plain_ms, bound_ms=case_bound["bound_ms"],
                 bound_by=case_bound["bound_by"])
    return {order: {"max_abs_err": 0.0, "ms": r[0], "plain_ms": r[1], **r[2]}
            for order, r in rows.items()}


# ---- 10. kernel B's round limit --------------------------------------------------

def round_limited_chunk(torch, solver, batches, is_vf, seed, limit, label):
    """Kernel B's round-limited pass over the rows of ``batches`` in one
    launch, the shape of the main path's pass over a chunk, seeded with
    ``seed`` (at most the rows' unbounded TOI, so no query lowers it),
    against the plain lockstep DFS on every batch: the unfinished rows,
    checks and per-query checks of each batch's segment equal, the TOI
    unmoved; and the same launch cut into the batches (the earlier shape)
    equal to it.  Returns ``(unfinished, checks, ms, batches_ms, plain_ms)``,
    device ms of the one launch and of the per-batch launches (each behind
    a GPU sleep) and host ms of the plain version."""
    rows = torch.cat(batches)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=rows.device)
    k = solver._solve_query_checks(rows, valid, is_vf, seed, TOL, round_limit=limit)
    torch.cuda.synchronize()
    ps, plain_ms = timed_once(lambda: [
        solver._reference_query_checks(b, valid[:b.shape[0]], is_vf, seed, TOL,
                                       round_limit=limit) for b in batches])
    check(not bool(k[1]) and float(k[0]) == float(seed), f"{label}: toi moved or overflow")
    s = 0
    for i, (b, p) in enumerate(zip(batches, ps)):
        seg = slice(s, s + b.shape[0])
        check(torch.equal(k[3][seg], p[3]), f"{label} batch {i}: unfinished rows differ")
        check(torch.equal(k[4][seg], p[4]) and int(k[4][seg].sum()) == int(p[2]),
              f"{label} batch {i}: checks differ ({int(k[4][seg].sum())} vs {int(p[2])})")
        s += b.shape[0]
    cols = rows.t().contiguous()
    parts = [solver.solve_cols(cols[:, s:s + BATCH], valid[s:s + BATCH], is_vf, seed, TOL,
                               round_limit=limit) for s in range(0, rows.shape[0], BATCH)]
    check(torch.equal(torch.cat([o[3] for o in parts]), k[3])
          and sum(int(o[2]) for o in parts) == int(k[2]),
          f"{label}: one launch and per-batch launches differ")
    ms = device_ms(lambda: solver.solve_cols(cols, valid, is_vf, seed, TOL,
                                             round_limit=limit), 5)
    batches_ms = device_ms(lambda: [
        solver.solve_cols(cols[:, s:s + BATCH], valid[s:s + BATCH], is_vf, seed, TOL,
                          round_limit=limit) for s in range(0, rows.shape[0], BATCH)], 3)
    return int(k[3].sum()), int(k[2]), ms, batches_ms, plain_ms


def phase_escalation(torch, dev, bench_rows, solver):
    """Kernel B ``round_limit`` 128 against the plain lockstep DFS on the
    bench candidates: each phase's rows in one launch, the main path's pass
    over a chunk, seeded with the final TOI, hold every 16,384-row batch's
    unfinished rows, checks and per-query checks to the plain version's, and
    equal the per-batch launches; from a cold start the ladder gives the
    unbounded TOI bitwise.  The row's ``ms`` is the one launch per phase."""
    limit = 128
    kms_sum = pms_sum = 0.0
    bnd = bound(0, 0)
    for is_vf, (batches, valids, final) in bench_rows.items():
        ph = "vf" if is_vf else "ee"
        seed = torch.tensor(final, dtype=torch.float32, device=dev)
        unfin, checks, kms, batches_ms, pms = round_limited_chunk(
            torch, solver, batches, is_vf, seed, limit, f"round_limit {ph}")

        def cold(fn):
            toi = torch.ones((), dtype=torch.float32, device=dev)
            for b, v in zip(batches, valids):
                toi = torch.minimum(toi, fn(b, v, is_vf, toi, TOL)[0])
            return toi

        def ladder_of(rows, *a):
            return solver.solve_escalated_cols(rows.t().contiguous(), *a, round_limit=limit)

        ladder = float(cold(ladder_of))
        check(ladder == final, f"round_limit {ph}: ladder toi {ladder} vs unbounded {final}")
        esc_ms, one_ms = alternate(
            lambda: cold(solver.solve_packed),
            lambda: cold(ladder_of), 1)
        kms_sum, pms_sum = kms_sum + kms, pms_sum + pms
        n_q = sum(b.shape[0] for b in batches)
        bnd = add_bounds(bnd, solve_bound(n_q, checks, n_q))
        emit(phase="escalation", which=ph, round_limit=limit, queries=n_q, batches=len(batches),
             unfinished=unfin, seeded_checks=checks, round_limit_ms=kms,
             round_limit_batches_ms=batches_ms, plain_ms=pms, ladder_toi=ladder,
             unbounded_toi=final, ladder_ms=esc_ms, unbounded_ms=one_ms,
             grid=solver._lane_grid(n_q, is_vf, False, False))
    return {"max_abs_err": 0.0, "ms": kms_sum, "plain_ms": pms_sum, **bnd}


def phase_grid_solver(torch, dev, args, samples, chunks, types, solver):
    """Kernel B on grid-600's candidates (the plain ``any_order`` sweep's row
    order): global, bounded (per-query caps 10 and 100, a global cap of
    10^6) and ``round_limit`` 128 against the plain versions on the first
    four batches of 16,384 per phase; the cold global TOIs within 1e-7, the
    capped per-query TOIs and checks equal, the global cap giving the
    unbounded TOI, and seeded with the global TOI the round-limited pass's
    unfinished rows and checks equal.  Then the round-limited pass over
    each phase's first chunk (up to 2^20 rows) in one launch, seeded with
    the chunk's own unbounded TOI, against the plain version on every batch
    (``round_limited_chunk``).  Returns the JSON fields of the bounded and
    round-limited modes."""
    limit = 128
    v0, v1, e, f = args
    vcat = types.concat_frames(v0, v1, torch.float32)

    def packed(pairs, is_vf):
        if is_vf:
            q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, f), pairs)
        else:
            q = types.gather_ee_queries(types.pack_edge_table(vcat, e), pairs)
        rows = solver.pack_query_rows(q, is_vf, 0.0, TOL)
        return [rows[s:s + BATCH].contiguous() for s in range(0, rows.shape[0], BATCH)]

    out = {"bounded": {"ms": 0.0, "plain_ms": 0.0, **bound(0, 0)},
           "round_limit": {"ms": 0.0, "plain_ms": 0.0, **bound(0, 0)},
           "global": {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, **bound(0, 0)}}
    chunk_seed = torch.ones((), dtype=torch.float32, device=dev)
    for ph, pairs in samples.items():
        is_vf = ph == "vf"
        batches = packed(pairs, is_vf)
        valids = [torch.ones((b.shape[0],), dtype=torch.bool, device=dev) for b in batches]

        def cold(fn, **kw):
            toi = torch.ones((), dtype=torch.float32, device=dev)
            checks, pqs = 0, []
            for b, v in zip(batches, valids):
                o = fn(b, v, is_vf, toi, TOL, **kw)
                toi, checks = torch.minimum(toi, o[0]), checks + int(o[2])
                pqs += [o[3]] if len(o) > 3 else []
            return toi, checks, pqs

        (tk, ck, _), (tp, cp, _) = cold(solver.solve_packed), cold(solver.solve_packed_reference)
        err = abs(float(tk) - float(tp))
        check(err <= 1e-7, f"grid-600 kernel B {ph}: toi {float(tk)} vs plain {float(tp)}")
        g_ms, g_plain_ms = alternate(lambda: cold(solver.solve_packed_reference),
                                     lambda: cold(solver.solve_packed), 1)
        n_q = sum(b.shape[0] for b in batches)
        bounded = {}
        for label, kw in (("cap10", dict(per_query=True, max_iterations=10)),
                          ("cap100", dict(per_query=True, max_iterations=100)),
                          ("global_cap", dict(max_iterations=1_000_000))):
            (tb, cb, pk), b_ms = timed_once(lambda: cold(solver.solve_packed, **kw))
            (tq, cq, pp), b_plain_ms = timed_once(
                lambda: cold(solver.solve_packed_reference, **kw))
            if kw.get("per_query"):
                check(all(torch.equal(x, y) for x, y in zip(pk, pp)) and cb == cq
                      and float(tb) == float(tq),
                      f"grid-600 bounded {label} {ph}: per-query TOIs or checks differ")
                need = cq
            else:
                check(float(tb) == float(tk) and float(tq) == float(tp),
                      f"grid-600 {label} {ph}: capped {float(tb)} / plain {float(tq)} vs "
                      f"unbounded {float(tk)} / plain {float(tp)}")
                need = least_checks(solver, batches, is_vf, tp)
            b_ms = device_ms(lambda: cold(solver.solve_packed, **kw), 3)
            bb = solve_bound(n_q, need, 4 * n_q if kw.get("per_query") else 0)
            bounded[label] = {"ms": b_ms, "plain_ms": b_plain_ms, "checks": cb, **bb}
            o = out["bounded"]
            o.update(ms=o["ms"] + b_ms, plain_ms=o["plain_ms"] + b_plain_ms,
                     **add_bounds({k: o[k] for k in ("bound_ms", "bound_by")}, bb))
        seed = torch.tensor(float(tk), dtype=torch.float32, device=dev)

        def seeded(fn):
            return [fn(b, v, is_vf, seed, TOL, round_limit=limit) for b, v in zip(batches, valids)]

        ks, r_ms = timed_once(lambda: seeded(solver.solve_packed))
        ps, r_plain_ms = timed_once(lambda: seeded(solver.solve_packed_reference))
        unfin = checks = 0
        for i, (k, p) in enumerate(zip(ks, ps)):
            check(torch.equal(k[3], p[3]), f"grid-600 round_limit {ph} batch {i}: unfinished differ")
            check(int(k[2]) == int(p[2]), f"grid-600 round_limit {ph} batch {i}: checks "
                  f"{int(k[2])} vs plain {int(p[2])}")
            check(float(k[0]) == float(p[0]) == float(tk),
                  f"grid-600 round_limit {ph} batch {i}: toi moved")
            unfin, checks = unfin + int(k[3].sum()), checks + int(k[2])
        least = least_checks(solver, batches, is_vf, tp)
        gb, rb = solve_bound(n_q, least), solve_bound(n_q, checks, n_q)

        # the first chunk in one launch: the unbounded global mode as the main
        # path launches it, then the round-limited pass seeded with its TOI
        cb = packed(chunks[ph], is_vf)
        n_c = sum(b.shape[0] for b in cb)
        whole = whole_chunk_global(solver, torch.cat(cb), is_vf, chunk_seed,
                                   f"grid-600 kernel B chunk {ph}")
        c_toi = torch.tensor(whole["toi"], dtype=torch.float32, device=dev)
        chunk_seed = torch.minimum(chunk_seed, c_toi)
        g = out["global"]
        g.update(ms=g["ms"] + whole["ms"], plain_ms=g["plain_ms"] + whole["plain_ms"],
                 max_abs_err=max(g["max_abs_err"], whole["abs_err"]),
                 **add_bounds({k: g[k] for k in ("bound_ms", "bound_by")}, whole))
        c_unfin, c_checks, c_ms, c_batches_ms, c_plain_ms = round_limited_chunk(
            torch, solver, cb, is_vf, c_toi, limit, f"grid-600 round_limit chunk {ph}")
        cbnd = solve_bound(n_c, c_checks, n_c)
        o = out["round_limit"]
        o.update(ms=o["ms"] + c_ms, plain_ms=o["plain_ms"] + c_plain_ms,
                 **add_bounds({k: o[k] for k in ("bound_ms", "bound_by")}, cbnd))
        emit(phase="grid600_solver", which=ph, queries=n_q, batches=len(batches),
             toi=float(tk), plain_toi=float(tp), abs_err=err, checks=ck,
             plain_checks=cp, least_checks=least, global_ms=g_ms, global_plain_ms=g_plain_ms,
             global_bound_ms=gb["bound_ms"], global_bound_by=gb["bound_by"],
             bounded=bounded, unfinished=unfin, seeded_checks=checks,
             round_limit_ms=r_ms, round_limit_plain_ms=r_plain_ms,
             round_limit_bound_ms=rb["bound_ms"], round_limit_bound_by=rb["bound_by"],
             chunk_queries=n_c, chunk_batches=len(cb), chunk_global=whole,
             chunk_toi=float(c_toi),
             chunk_unfinished=c_unfin, chunk_checks=c_checks, chunk_round_limit_ms=c_ms,
             chunk_round_limit_batches_ms=c_batches_ms, chunk_plain_ms=c_plain_ms,
             chunk_bound_ms=cbnd["bound_ms"], chunk_bound_by=cbnd["bound_by"],
             chunk_grid=solver._lane_grid(n_c, is_vf, False, False))
    return {k: {"max_abs_err": 0.0, **v} for k, v in out.items()}


# ---- 11. the congested main path ---------------------------------------------------

def wall_ms(fn, reps):
    """Median and list of ``reps`` host-clock times of ``fn`` ending in a
    synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), times


def phase_congested_main(torch, dev, grid600, bench_args, cloth_on_sphere, bench_res):
    """``fused_ccd`` at its defaults on grid-600 and on the bench scene,
    against the plain ordering without escalation and against escalation
    at 128 rounds, with the launch counters; records on both."""
    from scalable_ccd_tpu_torch import fused_ccd
    from scalable_ccd_tpu_torch.pipeline.policy import Knobs, resolve_knobs

    def same(a, b, label):
        err = abs(float(a.toi) - float(b.toi))
        check(not bool(a.overflowed) and not bool(b.overflowed), f"{label}: overflowed")
        check(err <= 1e-7, f"{label}: toi {float(a.toi)} vs {float(b.toi)}")
        check((int(a.vf_total), int(a.ee_total)) == (int(b.vf_total), int(b.ee_total)),
              f"{label}: pair totals differ")
        return err

    from scalable_ccd_tpu_torch.ops.gather_pack import chunk_rows

    def chunks(res):
        """The chunks of a frame's candidates: one round-limited pass each
        under escalation (at the defaults a phase is one launch)."""
        return sum(-(-int(n) // chunk_rows(BATCH)) for n in (res.vf_total, res.ee_total))

    n_vf = grid600[0].shape[0] + grid600[3].shape[0]
    n_ee = grid600[2].shape[0]
    knobs = resolve_knobs(n_vf, n_ee, cuda=True)
    emit(phase="congested_knobs", scene="cloth_on_sphere(600, 4)", vf_boxes=n_vf,
         ee_boxes=n_ee, **knobs._asdict())
    check(knobs == Knobs(True, -1, "batch", False, False, "pairs"),
          f"grid-600: auto resolved to {knobs}")
    run = lambda args, **kw: fused_ccd(*args, device=dev, validate=False, **kw)  # noqa: E731

    zero_counts()
    res = run(grid600)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["sweep_any_order"] > 0 and counts["solve_round_limit"] == 0
          and counts["solve_global"] == counts["solve_pairs"] == 2
          and counts["gather_f32"] == 0,
          f"grid-600: {counts} launches: one global pairs launch a phase, no kernel C")
    ref = run(grid600, bucket_minor=False, escalate_rounds=-1)
    err = same(res, ref, "grid-600 defaults vs plain ordering unbounded")
    zero_counts()
    ladder = run(grid600, escalate_rounds=128)
    torch.cuda.synchronize()
    ladder_counts = read_counts()
    check(ladder_counts["solve_round_limit"] == chunks(ladder),
          f"grid-600 ladder: {ladder_counts['solve_round_limit']} round-limited launches, "
          f"{chunks(ladder)} chunks")
    same(ladder, res, "grid-600 ladder vs defaults")
    check(float(ladder.toi) == float(res.toi), "grid-600: ladder and defaults differ in bits")
    # in turns: defaults, plain ordering unbounded, the batch ladder at 128
    # rounds, defaults
    ms, times = wall_ms(lambda: run(grid600), 3)
    ref_ms, ref_times = wall_ms(lambda: run(grid600, bucket_minor=False, escalate_rounds=-1), 3)
    ord_ms, ord_times = wall_ms(lambda: run(grid600, escalate_rounds=128), 3)
    ms2, times2 = wall_ms(lambda: run(grid600), 3)
    emit(phase="main_grid600", toi=float(res.toi), plain_toi=float(ref.toi), abs_err=err,
         bitwise=float(res.toi) == float(ref.toi), vf_total=int(res.vf_total),
         ee_total=int(res.ee_total), total_checks=int(res.total_checks),
         plain_checks=int(ref.total_checks), solver_capped=bool(res.solver_capped),
         launches=counts, ms_per_frame_median=[ms, ms2], ms_per_frame=times + times2,
         plain_ordering_unbounded_ms_median=ref_ms, plain_ordering_unbounded_ms=ref_times,
         ladder_ms_median=ord_ms, ladder_ms=ord_times, ladder_launches=ladder_counts)

    zero_counts()
    rec = run(grid600, sweep_impl="records")
    torch.cuda.synchronize()
    records_counts = read_counts()
    check(records_counts["records_any_order"] > 0 and records_counts["solve_global"] > 0,
          f"grid-600 records path skipped a kernel mode: {records_counts}")
    same(rec, res, "grid-600 records vs pairs")
    rms, rtimes = wall_ms(lambda: run(grid600, sweep_impl="records"), 3)
    emit(phase="main_grid600_records", toi=float(rec.toi), launches=records_counts,
         ms_per_frame_median=rms, ms_per_frame=rtimes)

    # the bench scene at its defaults against the frame pool at 128 rounds:
    # one kernel B launch per phase, and one more per phase for the
    # presample's batch; escalated, one round-limited pass per chunk and
    # one more per phase for the presample's batch, which is escalated on
    # its own as in the JAX package
    kb = resolve_knobs(bench_args[0].shape[0] + bench_args[3].shape[0], bench_args[2].shape[0],
                       cuda=True)
    bench_counts = {}
    for label, kw in (("defaults", {}), ("presample_off", {"presample": False}),
                      ("frame_pool", {"escalate_rounds": 128}),
                      ("frame_pool_presample_off", {"escalate_rounds": 128, "presample": False})):
        zero_counts()
        run(bench_args, **kw)
        torch.cuda.synchronize()
        bench_counts[label] = read_counts()
    presampled = int(kb.presample_vf) + int(kb.presample_ee)
    for label, mode, want in (("defaults", "solve_f32", 2 + presampled),
                              ("presample_off", "solve_f32", 2),
                              ("defaults", "gather_f32", presampled),
                              ("presample_off", "gather_f32", 0),
                              ("defaults", "solve_round_limit", 0),
                              ("frame_pool", "solve_round_limit", chunks(bench_res) + presampled),
                              ("frame_pool_presample_off", "solve_round_limit",
                               chunks(bench_res))):
        got = bench_counts[label][mode]
        check(got == want, f"bench {label}: {got} {mode} launches, expected {want} "
              f"({chunks(bench_res)} chunks)")
    emit(phase="round_limited_launches_per_frame",
         bench=bench_counts["frame_pool"]["solve_round_limit"],
         bench_presample_off=bench_counts["frame_pool_presample_off"]["solve_round_limit"],
         bench_chunks=chunks(bench_res), bench_presample_batches=presampled,
         grid600=ladder_counts["solve_round_limit"], grid600_chunks=chunks(res),
         bench_kernel_b=bench_counts["defaults"]["solve_f32"],
         bench_frame_pool_kernel_b=bench_counts["frame_pool"]["solve_f32"],
         grid600_kernel_b=counts["solve_f32"], grid600_ladder_kernel_b=ladder_counts["solve_f32"])
    bref = run(bench_args, escalate_rounds=128)
    berr = same(bench_res, bref, "bench defaults vs the frame pool at 128 rounds")
    check(float(bref.toi) == float(bench_res.toi), "bench: frame pool and defaults differ in bits")
    zero_counts()
    brec = run(bench_args, sweep_impl="records")
    torch.cuda.synchronize()
    records_bench_counts = read_counts()
    check(records_bench_counts["records_sorted"] > 0,
          f"bench records path skipped kernel A': {records_bench_counts}")
    same(brec, bench_res, "bench records vs pairs")
    b_ms, b_times = wall_ms(lambda: run(bench_args, escalate_rounds=128), 5)
    o_ms, o_times = wall_ms(lambda: run(bench_args), 5)
    b2_ms, b2_times = wall_ms(lambda: run(bench_args, escalate_rounds=128), 5)
    emit(phase="main_bench_escalation", toi=float(bench_res.toi), frame_pool_toi=float(bref.toi),
         abs_err=berr, frame_pool_ms_median=[b_ms, b2_ms], frame_pool_ms=b_times + b2_times,
         defaults_ms_median=o_ms, defaults_ms=o_times)

    return {"counts": counts, "ladder_counts": ladder_counts, "records_counts": records_counts,
            "records_bench_counts": records_bench_counts}


def phase_grid1000(torch, dev, cloth_on_sphere):
    """grid-1000 in f32 at the defaults, the first frame and one more timed;
    skipped once the script has run 700 s."""
    from scalable_ccd_tpu_torch import fused_ccd

    if time.perf_counter() - T_START >= 700:
        emit(phase="main_grid1000", skipped="the script had run 700 s")
        return
    t = time.perf_counter()
    grid1000 = scene_on(torch, dev, cloth_on_sphere(grid_n=1000, sphere_subdiv=4))
    scene_s = time.perf_counter() - t
    run = lambda: fused_ccd(*grid1000, device=dev, validate=False)  # noqa: E731
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = run()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    check(not bool(first.overflowed) and 0.0 <= float(first.toi) <= 1.0,
          "grid-1000: bad result")
    g_ms, _ = wall_ms(run, 1)
    emit(phase="main_grid1000", scene="cloth_on_sphere(1000, 4)",
         vf_boxes=grid1000[0].shape[0] + grid1000[3].shape[0], toi=float(first.toi),
         vf_total=int(first.vf_total), ee_total=int(first.ee_total),
         first_ms=first_ms, ms_per_frame=g_ms, scene_build_s=scene_s)


# ---- 17. the narrow loop on the device ---------------------------------------------

def pack_bound(torch, pairs, is_vf, in_bytes, out_bytes, records=0):
    """The bound of kernel C packing every row of ``pairs`` (the frame's
    ``(n, 2)`` ids) from tables of ``in_bytes``-byte scalars into
    ``out_bytes``-byte row scalars: each row's 31 row scalars and its two
    ids (8 B) or, in the records mode, each of the ``records`` records the
    rows lie in read once (32 B) with its entry of the pair prefix (8 B),
    and each table row the frame references read once (a vertex's 6 and a
    face's 18 scalars, or an edge's 12: a row shared by many candidates is
    a repeat the caches serve), and OPS_PER_PACKED_ROW operations per row
    at the input type's rate."""
    rows = pairs.shape[0]
    if is_vf:
        table_scalars = (6 * torch.unique(pairs[:, 0]).numel()
                         + 18 * torch.unique(pairs[:, 1]).numel())
    else:
        table_scalars = 12 * torch.unique(pairs).numel()
    ids = records * (RECORD_BYTES + 8) if records else rows * PAIR_BYTES
    return bound(rows * 31 * out_bytes + ids + table_scalars * in_bytes,
                 rows * OPS_PER_PACKED_ROW, F32_OPS_PER_S / (in_bytes // 4))


def same_bits(k, p):
    """Equal dtype, shape and bits."""
    import torch

    ints = {torch.float64: torch.int64, torch.float32: torch.int32}.get(k.dtype, k.dtype)
    return k.dtype == p.dtype and k.shape == p.shape and torch.equal(
        k.contiguous().view(ints), p.contiguous().view(ints))


def phase_narrow_loop(torch, dev, bench_scene, grid600_scene):
    """Kernel C's two modes against their plain twins on every chunk of the
    main path (bench and grid-600, f32, f64 and compensated), each timed
    with its bound; a CUDA records frame makes no per-batch decode; the host
    syncs and kernel C launches per frame at two batch sizes; the idle
    share of a bench frame.  Returns the kernel rows' fields per scene,
    type and phase."""
    from scalable_ccd_tpu_torch import fused_ccd
    from scalable_ccd_tpu_torch.narrow_phase import types
    from scalable_ccd_tpu_torch.ops import gather_pack as gp
    from scalable_ccd_tpu_torch.ops import solver, sweep_ap, sweep_records
    from scalable_ccd_tpu_torch.pipeline.policy import sorted_phases
    from scalable_ccd_tpu_torch.tools import stages

    t_phase = time.perf_counter()
    kinds = {"f32": (torch.float32, False), "f64": (torch.float64, False),
             "compensated": (torch.float32, True)}

    def candidates(args, dtype, bucket):
        """``{phase: (is_vf, sorted boxes, pairs buffer, n, records, n_held,
        vcat, table)}`` of the main path's sweeps in ``dtype``: kernel A's
        pairs and kernel A''s records of the same sorted boxes."""
        v0, v1, e, f = args
        vf_sb, ee_sb = sorted_phases(v0, v1, e, f, 0.0, dtype, bucket)
        vcat = types.concat_frames(v0, v1, dtype)
        out = {}
        for ph, is_vf, sb in (("vf", True, vf_sb), ("ee", False, ee_sb)):
            kw = dict(any_order=bucket, planes=sweep_ap.partner_planes(sb) if bucket else None)
            total = int(sweep_ap.sweep_pairs(sb, is_vf, count_only=True, **kw))
            buf, n, _, ovf = sweep_ap.sweep_pairs(sb, is_vf, pow2ceil(total), **kw)
            check(not bool(ovf) and int(n) == total, f"narrow loop {ph}: sweep overflowed")
            rec, n_rec, n_pairs, r_ovf = sweep_records.sweep_records(sb, is_vf, pow2ceil(total),
                                                                     **kw)
            check(not bool(r_ovf) and int(n_pairs) == total,
                  f"narrow loop {ph}: the record sweep overflowed")
            table = (types.pack_face_table(vcat, f) if is_vf
                     else types.pack_edge_table(vcat, e))
            out[ph] = (is_vf, sb, buf, total, rec, min(int(n_rec), rec.shape[0]), vcat, table)
        return out

    def chunks_of(n):
        return [(c, min(c + gp.CHUNK_ROWS, n)) for c in range(0, n, gp.CHUNK_ROWS)]

    def kernel_c(label, cands, comp):
        """Every chunk of both modes bitwise (the records mode's ids too),
        then each mode (device ms behind a sleep) and its plain twin
        (host-clock ms around a synchronize) timed over a phase's chunks."""
        rows = {}
        for ph, (is_vf, sb, buf, n, rec, held, vcat, table) in cands.items():
            in_b = vcat.element_size()
            out_b = 8 if comp else in_b
            cuts = chunks_of(n)
            for a, b in cuts:
                k = gp.gather_pack(buf, a, b, vcat, table, is_vf, 0.0, TOL, comp)
                torch.cuda.synchronize()
                p = gp.gather_pack_reference(buf, a, b, vcat, table, is_vf, 0.0, TOL, comp)
                check(same_bits(k, p),
                      f"kernel C {label} {ph} rows [{a}, {b}): not bitwise the plain version")
            run = lambda f: [f(buf, a, b, vcat, table, is_vf, 0.0, TOL, comp)  # noqa: E731
                             for a, b in cuts]
            rows[ph] = {"max_abs_err": 0.0, "ms": device_ms(lambda: run(gp.gather_pack), 5),
                        "plain_ms": cuda_ms(lambda: run(gp.gather_pack_reference), 3),
                        **pack_bound(torch, buf[:n], is_vf, in_b, out_b)}
            emit(phase="narrow_loop_kernel_c", which=label, phase_name=ph, mode="pairs",
                 queries=n, chunks=len(cuts), bitwise=True, **rows[ph])

            cum = sweep_records.records_pair_prefix(rec, held)
            check(int(cum[-1]) == n, f"kernel C {label} {ph}: record pairs {int(cum[-1])} "
                  f"vs {n}")
            width = min(gp.CHUNK_ROWS, n)
            ids_k = torch.empty((width, 2), dtype=torch.int32, device=dev)
            ids_p = torch.empty_like(ids_k)
            decoded = []
            for a, b in cuts:
                k = gp.gather_pack_records(sb, rec, cum, a, b, vcat, table, is_vf, 0.0, TOL, comp,
                                           pairs_out=ids_k)
                torch.cuda.synchronize()
                p = gp.gather_pack_records_reference(sb, rec, cum, a, b, vcat, table, is_vf,
                                                     0.0, TOL, comp, pairs_out=ids_p)
                check(same_bits(k, p) and torch.equal(ids_k[:b - a], ids_p[:b - a]),
                      f"kernel C records {label} {ph} pairs [{a}, {b}): not bitwise the "
                      "plain twin")
                decoded.append(ids_p[:b - a].clone())
            run_r = lambda f: [f(sb, rec, cum, a, b, vcat, table, is_vf, 0.0,  # noqa: E731
                                 TOL, comp) for a, b in cuts]
            rows[ph + "_records"] = {
                "max_abs_err": 0.0, "ms": device_ms(lambda: run_r(gp.gather_pack_records), 5),
                "plain_ms": cuda_ms(lambda: run_r(gp.gather_pack_records_reference), 3),
                **pack_bound(torch, torch.cat(decoded), is_vf, in_b, out_b, records=held)}
            emit(phase="narrow_loop_kernel_c", which=label, phase_name=ph, mode="records",
                 queries=n, records=held, chunks=len(cuts), bitwise=True,
                 **rows[ph + "_records"])
        for name, keys in (("both", ("vf", "ee")), ("records", ("vf_records", "ee_records"))):
            both = {k: rows[keys[0]][k] + rows[keys[1]][k] for k in ("ms", "plain_ms", "bound_ms")}
            rows[name] = {"max_abs_err": 0.0, **both, "bound_by": rows[keys[0]]["bound_by"]}
        return rows

    out = {}
    for scene_name, scene, bucket in (("", bench_scene, False), ("grid600_", grid600_scene, True)):
        for label, (dtype, comp) in kinds.items():
            args = scene_on(torch, dev, scene, torch.float64 if dtype == torch.float64 else None)
            out[scene_name + label] = kernel_c(scene_name + label,
                                               candidates(args, dtype, bucket), comp)
            del args
    grid600 = scene_on(torch, dev, grid600_scene)

    # a CUDA records frame decodes no batch in PyTorch: every module of the
    # package that holds the decode calls a counting wrapper meanwhile
    real_decode = sweep_records.decode_records_range
    decodes = [0]

    def counted_decode(*a, **kw):
        decodes[0] += 1
        return real_decode(*a, **kw)

    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("scalable_ccd_tpu_torch")
               and getattr(m, "decode_records_range", None) is real_decode]
    bench = scene_on(torch, dev, bench_scene)
    records_frames = {}
    try:
        for m in holders:
            m.decode_records_range = counted_decode
        for name, args in (("bench", bench), ("grid600", grid600)):
            zero_counts()
            res = fused_ccd(*args, device=dev, validate=False, sweep_impl="records")
            torch.cuda.synchronize()
            counts = read_counts()
            check(decodes[0] == 0, f"{name} records frame: {decodes[0]} PyTorch decodes")
            check(counts["gather_records"] > 0 and not bool(res.overflowed),
                  f"{name} records frame: kernel C's records mode did not launch: {counts}")
            records_frames[name] = counts["gather_records"]
            emit(phase="narrow_loop_records_frame", scene=name, toi_hex=float(res.toi).hex(),
                 pytorch_decodes=decodes[0], kernel_c_records_launches=counts["gather_records"],
                 kernel_c_launches=counts["gather_f32"] + counts["gather_f64"])
    finally:
        for m in holders:
            m.decode_records_range = real_decode

    # host syncs per frame at the defaults (one kernel B launch per phase,
    # its rows computed from the pairs) on the bench scene and grid-600 at
    # two batch sizes; kernel C launched for the presample alone
    syncs = {}
    for name, args in (("bench", bench), ("grid600", grid600)):
        for batch in (BATCH, BATCH >> 2):
            run = lambda: fused_ccd(*args, device=dev, validate=False,  # noqa: E731
                                    narrow_batch=batch)
            run()
            zero_counts()
            res, n, sites = stages.count_syncs(run)
            torch.cuda.synchronize()
            packs = gp.LAUNCHES_BY_MODE.total
            chunk = gp.chunk_rows(batch)
            need = -(-int(res.vf_total) // chunk) - (-int(res.ee_total) // chunk)
            phase_launches = solver.LAUNCHES_BY_MODE["pairs"]
            check(packs <= 2 and phase_launches == 2,
                  f"{name} narrow_batch={batch}: {packs} kernel C launches (the presample's "
                  f"alone), {phase_launches} pairs launches for 2 phases")
            check(not bool(res.overflowed), f"{name} narrow_batch={batch}: overflowed")
            syncs[name, batch] = (n, float(res.toi).hex())
            emit(phase="narrow_loop_syncs", scene=name, narrow_batch=batch, syncs=n,
                 sites=sites, kernel_c_launches=packs, chunks=need,
                 phase_launches=phase_launches,
                 toi_hex=float(res.toi).hex(), vf_total=int(res.vf_total),
                 ee_total=int(res.ee_total))
        check(syncs[name, BATCH] == syncs[name, BATCH >> 2],
              f"{name}: syncs and TOI per frame differ between batch sizes: "
              f"{syncs[name, BATCH]} vs {syncs[name, BATCH >> 2]}")
    del grid600

    # the device idle share of one bench frame (torch.profiler)
    run = lambda: fused_ccd(*bench, device=dev, validate=False)  # noqa: E731
    run()
    res, stats = stages.idle_share(run)
    emit(phase="narrow_loop_idle", scene="cloth_on_sphere(128, 4, drop=0.25)",
         toi=float(res.toi), **stats, seconds=time.perf_counter() - t_phase)
    out["records_frames"] = records_frames
    return out


# ---- 12. the f64 kernels --------------------------------------------------------

def packed_rows(torch, args, pairs, is_vf, dtype, ms=0.0, compensated=False):
    """Packed query rows of ``pairs`` in ``dtype`` (compensated: f32 rows
    with the compensated filter, widened to f64)."""
    from scalable_ccd_tpu_torch.narrow_phase import types
    from scalable_ccd_tpu_torch.ops import solver

    v0, v1, e, f = args
    vcat = types.concat_frames(v0, v1, torch.float32 if compensated else dtype)
    if is_vf:
        q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, f), pairs)
    else:
        q = types.gather_ee_queries(types.pack_edge_table(vcat, e), pairs)
    rows = solver.pack_query_rows(q, is_vf, ms, TOL, compensated=compensated)
    return rows.double() if compensated else rows


def batched(torch, rows):
    """``rows`` cut into the main path's batches, with all-true masks."""
    batches = [rows[s:s + BATCH].contiguous() for s in range(0, rows.shape[0], BATCH)]
    valids = [torch.ones((b.shape[0],), dtype=torch.bool, device=rows.device) for b in batches]
    return batches, valids


def phase_f64_kernels(torch, dev, bench_scene, mid_scene, f32_phases):
    """Every f64 kernel mode against its plain version; returns the JSON
    fields of their rows.  Also times the plain f32 ``any_order`` sweep of
    the bench scene beside its kernel."""
    from scalable_ccd_tpu_torch.broad_phase import sort_boxes
    from scalable_ccd_tpu_torch.ops import solver, sweep_ap, sweep_records

    f64 = torch.float64
    args = scene_on(torch, dev, bench_scene, f64)
    out = {k: [0.0, 0.0, bound(0, 0), 0.0] for k in
           ("whole", "range", "any_order", "records", "global", "round_limit")}

    def add(key, kms, pms, bnd, err=0.0):
        row = out[key]
        row[0], row[1], row[2], row[3] = row[0] + kms, row[1] + pms, add_bounds(row[2], bnd), \
            max(row[3], err)

    chunk = 1 << 15
    f32_any = [0.0, 0.0]
    cand = {}
    for ph, (two, boxes) in phase_boxes(args).items():
        major, bucket = sort_boxes(boxes), sort_boxes(boxes, bucket_minor=True)
        check(major.major_min.dtype == f64, f"f64 {ph}: boxes are {major.major_min.dtype}")
        planes = sweep_ap.partner_planes(bucket)
        n_true = int(sweep_ap.sweep_pairs(major, two, count_only=True))
        budget = pow2ceil(n_true)
        k = sweep_ap.sweep_pairs(major, two, budget)
        torch.cuda.synchronize()
        p = sweep_ap.sweep_pairs_reference(major, two, budget)
        check(int(k[2]) == int(p[2]) == n_true and not bool(k[3]),
              f"f64 kernel A {ph}: totals {int(k[2])} / plain {int(p[2])} / count {n_true}")
        keys = pair_keys(k[0], k[1])
        check(torch.equal(keys, pair_keys(p[0], p[1])), f"f64 kernel A {ph}: pair sets differ")
        sb32 = f32_phases[ph][1]
        k32 = sweep_ap.sweep_pairs(sb32, two, 1 << (4 * sb32.n - 1).bit_length())
        keys32 = pair_keys(k32[0], k32[1])
        check(bool(torch.isin(keys, keys32).all()) and keys.numel() <= keys32.numel(),
              f"f64 kernel A {ph}: the f64 pair set is no subset of the f32 one")
        kms, pms = alternate(lambda: sweep_ap.sweep_pairs_reference(major, two, budget),
                             lambda: sweep_ap.sweep_pairs(major, two, budget), 3)
        whole_bound = sweep_bound(major, n_true * PAIR_BYTES)
        add("whole", kms, pms, whole_bound)

        ranges = [(b0, min(b0 + chunk, major.n)) for b0 in range(0, major.n, chunk)]
        got = [pair_keys(*sweep_ap.sweep_pairs(major, two, budget, box_range=r)[:2])
               for r in ranges]
        check(torch.equal(torch.sort(torch.cat(got)).values, keys),
              f"f64 kernel A {ph}: the ranged union differs")
        rms, rpms = alternate(
            lambda: [sweep_ap.sweep_pairs_reference(major, two, budget, box_range=r)
                     for r in ranges],
            lambda: [sweep_ap.sweep_pairs(major, two, budget, box_range=r) for r in ranges], 3)
        add("range", rms, rpms, whole_bound)

        ka = sweep_ap.sweep_pairs(bucket, two, budget, any_order=True, planes=planes)
        pa = sweep_ap.sweep_pairs_reference(bucket, two, budget, any_order=True, planes=planes)
        check(int(ka[2]) == int(pa[2]) == n_true, f"f64 any_order {ph}: totals differ")
        check(torch.equal(pair_keys(ka[0], ka[1]), keys)
              and torch.equal(pair_keys(pa[0], pa[1]), keys), f"f64 any_order {ph}: sets differ")
        ams, apms = alternate(
            lambda: sweep_ap.sweep_pairs_reference(bucket, two, budget, any_order=True,
                                                   planes=planes),
            lambda: sweep_ap.sweep_pairs(bucket, two, budget, any_order=True, planes=planes), 3)
        add("any_order", ams, apms,
            any_order_bound(bucket, planes, any_order_work(bucket, planes),
                            n_true * PAIR_BYTES))

        r = sweep_records.sweep_records(major, two, budget)
        rp = sweep_records.sweep_records_reference(major, two, budget)
        n_rec = int(r[1])
        check((n_rec, int(r[2])) == (int(rp[1]), int(rp[2])) and int(r[2]) == n_true
              and not bool(r[3]), f"f64 kernel A' {ph}: counts differ")
        check(torch.equal(record_rows(r[0], n_rec), record_rows(rp[0], n_rec)),
              f"f64 kernel A' {ph}: record multisets differ")
        cum = sweep_records.records_pair_prefix(r[0], n_rec)
        dec = sweep_records.decode_records_range(major, r[0], cum, 0, n_true, 0, two)[0]
        check(torch.equal(pair_keys(dec, n_true), keys),
              f"f64 kernel A' {ph}: decoded pairs differ from kernel A's")
        qms, qpms = alternate(lambda: sweep_records.sweep_records_reference(major, two, budget),
                              lambda: sweep_records.sweep_records(major, two, budget), 3)
        add("records", qms, qpms, sweep_bound(major, n_rec * RECORD_BYTES))

        # the f32 any_order sweep of the same scene: its plain version's time
        b32 = sort_boxes(phase_boxes(scene_on(torch, dev, bench_scene))[ph][1],
                         bucket_minor=True)
        pl32 = sweep_ap.partner_planes(b32)
        b32_budget = pow2ceil(int(sweep_ap.sweep_pairs(b32, two, any_order=True, planes=pl32,
                                                       count_only=True)))
        fms, fpms = alternate(
            lambda: sweep_ap.sweep_pairs_reference(b32, two, b32_budget, any_order=True,
                                                   planes=pl32),
            lambda: sweep_ap.sweep_pairs(b32, two, b32_budget, any_order=True, planes=pl32), 3)
        f32_any[0], f32_any[1] = f32_any[0] + fms, f32_any[1] + fpms

        cand[ph] = p[0][:n_true]
        emit(phase="f64_sweeps", which=ph, boxes=major.n, pairs=n_true, f32_pairs=int(k32[2]),
             records=n_rec, equal=True, whole_ms=kms, whole_plain_ms=pms, range_ms=rms,
             range_plain_ms=rpms, any_order_ms=ams, any_order_plain_ms=apms, records_ms=qms,
             records_plain_ms=qpms, f32_any_order_ms=fms, f32_any_order_plain_ms=fpms)

    # kernel B: global on f64 rows and on widened rows, round_limit seeded
    limit = 128
    for ph, pairs in cand.items():
        is_vf = ph == "vf"
        info = {}
        for label, comp in (("f64", False), ("widened", True)):
            batches, valids = batched(torch, packed_rows(torch, args, pairs, is_vf, f64,
                                                         compensated=comp))

            def run(fn, batches=batches, valids=valids, comp=comp):
                toi = torch.ones((), dtype=f64, device=dev)
                checks, ovf = 0, False
                for b, v in zip(batches, valids):
                    t, o, c = fn(b, v, is_vf, toi, TOL, widened=comp)
                    toi, checks, ovf = torch.minimum(toi, t), checks + c, ovf | o
                return toi, ovf, checks

            tk, ok_, ck = run(solver.solve_packed)
            torch.cuda.synchronize()
            tp, op_, cp = run(solver.solve_packed_reference)
            err = abs(float(tk) - float(tp))
            check(err <= 1e-12, f"f64 kernel B {label} {ph}: toi {float(tk)} vs plain {float(tp)}")
            check(tk.dtype == f64 and 0.0 <= float(tk) <= 1.0 and not bool(ok_) and not bool(op_),
                  f"f64 kernel B {label} {ph}: bad toi or a conservative accept")
            if comp:
                check(float(tk) == float(tk.float()), f"widened {ph}: toi is no f32 value")
            kms, pms = alternate(lambda: run(solver.solve_packed_reference),
                                 lambda: run(solver.solve_packed), 1)
            n_q = sum(b.shape[0] for b in batches)
            if not comp:
                least = least_checks(solver, batches, is_vf, tp)
                add("global", kms, pms, solve_bound(n_q, least, f64=True), err)
                final, f64_batches, f64_valids = float(tk), batches, valids
                info["f64_least_checks"] = least
            info.update({label + "_toi": float(tk), label + "_bitwise": err == 0.0,
                         label + "_checks": int(ck), label + "_plain_checks": int(cp),
                         label + "_ms": kms, label + "_plain_ms": pms})

        seed = torch.tensor(final, dtype=f64, device=dev)

        def seeded(fn):
            return [fn(b, v, is_vf, seed, TOL, round_limit=limit)
                    for b, v in zip(f64_batches, f64_valids)]

        ks, kms = timed_once(lambda: seeded(solver.solve_packed))
        ps, pms = timed_once(lambda: seeded(solver.solve_packed_reference))
        unfin = checks = 0
        for i, (k, p) in enumerate(zip(ks, ps)):
            check(torch.equal(k[3], p[3]) and int(k[2]) == int(p[2])
                  and float(k[0]) == float(p[0]) == final,
                  f"f64 round_limit {ph} batch {i}: kernel and plain differ")
            unfin, checks = unfin + int(k[3].sum()), checks + int(k[2])
        n_q = sum(b.shape[0] for b in f64_batches)
        add("round_limit", kms, pms, solve_bound(n_q, checks, n_q, f64=True))
        emit(phase="f64_kernel_b", which=ph, queries=n_q, **info, round_limit=limit,
             unfinished=unfin, seeded_checks=checks, round_limit_ms=kms,
             round_limit_plain_ms=pms)

    # per-query and bounded on cloth_on_sphere(64, 3)
    margs = scene_on(torch, dev, mid_scene, f64)
    mrows = {}
    for ph, (two, boxes) in phase_boxes(margs).items():
        sb = sort_boxes(boxes)
        pr = sweep_ap.sweep_pairs_reference(sb, two, pow2ceil(4 * sb.n))
        mrows[ph] = batched(torch, packed_rows(torch, margs, pr[0][: int(pr[1])], two, f64))
    modes = {}
    for label, kw in (("per_query", dict(per_query=True)),
                      ("cap10", dict(per_query=True, max_iterations=10)),
                      ("cap100", dict(per_query=True, max_iterations=100))):
        kms_sum = pms_sum = err_max = 0.0
        bnd = bound(0, 0)
        info = {}
        for ph, (batches, valids) in mrows.items():
            is_vf = ph == "vf"

            def run(fn, batches=batches, valids=valids, is_vf=is_vf, kw=kw):
                toi = torch.ones((), dtype=f64, device=dev)
                checks, pqs = 0, []
                for b, v in zip(batches, valids):
                    o = fn(b, v, is_vf, toi, TOL, **kw)
                    toi, checks = torch.minimum(toi, o[0]), checks + int(o[2])
                    pqs.append(o[3])
                return toi, checks, torch.cat(pqs)

            tk, ck, pk = run(solver.solve_packed)
            torch.cuda.synchronize()
            tp, cp, pp = run(solver.solve_packed_reference)
            check(torch.equal(pk < 1, pp < 1) and torch.equal(torch.isinf(pk), torch.isinf(pp)),
                  f"f64 {label} {ph}: hit sets differ")
            fin = torch.isfinite(pp)
            err = max(abs(float(tk) - float(tp)), max_abs(pk[fin], pp[fin]))
            check(err <= 1e-12 and pk.dtype == f64, f"f64 {label} {ph}: differ by {err}")
            kms, pms = alternate(lambda: run(solver.solve_packed_reference),
                                 lambda: run(solver.solve_packed), 1)
            n_q = pk.shape[0]
            kms_sum, pms_sum, err_max = kms_sum + kms, pms_sum + pms, max(err_max, err)
            need = cp if "max_iterations" in kw else least_checks(solver, batches, is_vf, tp, pp)
            bnd = add_bounds(bnd, solve_bound(n_q, need, 8 * n_q, f64=True))
            info.update({ph + "_hits": int((pk < 1).sum()), ph + "_checks": ck,
                         ph + "_least_checks": need,
                         ph + "_bitwise": bool(torch.equal(pk, pp)), ph + "_queries": n_q})
        modes[label] = {"max_abs_err": err_max, "ms": kms_sum, "plain_ms": pms_sum, **bnd}
        emit(phase="f64_kernel_b_mode", mode=label, **modes[label], **info)
    caps = [modes["cap10"], modes["cap100"]]
    rows = {k: {"max_abs_err": v[3], "ms": v[0], "plain_ms": v[1], **v[2]}
            for k, v in out.items()}
    rows["per_query"] = modes["per_query"]
    rows["bounded"] = {"max_abs_err": max(c["max_abs_err"] for c in caps),
                       "ms": sum(c["ms"] for c in caps),
                       "plain_ms": sum(c["plain_ms"] for c in caps),
                       **add_bounds(caps[0], caps[1])}
    rows["f32_any_order_bench"] = {"ms": f32_any[0], "plain_ms": f32_any[1]}
    emit(phase="f32_any_order_bench", ms=f32_any[0], plain_ms=f32_any[1])
    # the f64 any_order sweep of the bench scene (its kernels row is grid-600's)
    emit(phase="f64_any_order_bench", **rows["any_order"])
    return rows


# ---- 13. kernel A count_only ------------------------------------------------------

def phase_count_only(torch, dev, bench_scene, grid600_scene):
    """``count_only`` against the emitting kernel and the plain count, on
    the bench scene and grid-600, whole, ranged and ``any_order``, f32 and
    f64.  Returns the JSON fields of the two ``count_only`` rows and of the
    f64 ``any_order`` row on grid-600."""
    from scalable_ccd_tpu_torch.broad_phase import sort_boxes
    from scalable_ccd_tpu_torch.ops import sweep_ap, sweep_records

    chunk = 1 << 15
    rows = {"float32": [0.0, 0.0, bound(0, 0)], "float64": [0.0, 0.0, bound(0, 0)]}
    any64 = [0.0, 0.0, bound(0, 0)]
    for scene_name, scene in (("bench", bench_scene), ("grid600", grid600_scene)):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            for ph, (two, boxes) in phase_boxes(scene_on(torch, dev, scene, dtype)).items():
                major, bucket = sort_boxes(boxes), sort_boxes(boxes, bucket_minor=True)
                planes = sweep_ap.partner_planes(bucket)
                ranges = [(b0, min(b0 + chunk, major.n)) for b0 in range(0, major.n, chunk)]
                launch = lambda sb, **kw: sweep_ap.sweep_pairs(  # noqa: E731
                    sb, two, count_only=True, **kw)
                count = lambda sb, **kw: int(launch(sb, **kw))  # noqa: E731
                plain = lambda sb, **kw: int(  # noqa: E731
                    sweep_ap.sweep_pairs_reference(sb, two, count_only=True, **kw))
                whole = count(major)
                emitted = sweep_ap.sweep_pairs(major, two, 64)
                ranged = sum(count(major, box_range=r) for r in ranges)
                anyo = count(bucket, any_order=True, planes=planes)
                budget = pow2ceil(whole)
                emitted_any = sweep_ap.sweep_pairs(bucket, two, budget, any_order=True,
                                                   planes=planes)
                label = f"count_only {scene_name} {name} {ph}"
                check(whole == int(emitted[2]) == ranged == anyo == int(emitted_any[2]) > 64,
                      f"{label}: whole {whole}, emitting {int(emitted[2])}, ranged {ranged}, "
                      f"any_order {anyo}, emitting any_order {int(emitted_any[2])}")
                p_whole, plain_ms = timed_once(lambda: plain(major))
                p_any, plain_any_ms = timed_once(
                    lambda: plain(bucket, any_order=True, planes=planes))
                p_ranged, plain_ranged_ms = timed_once(
                    lambda: sum(plain(major, box_range=r) for r in ranges))
                check(p_whole == p_ranged == p_any == whole,
                      f"{label}: plain counts {p_whole}/{p_ranged}/{p_any} vs {whole}")
                # in turns: emitting, count_only, count_only, emitting; the
                # timed calls read nothing back, like the emitting ones
                c_ms, e_ms = alternate(lambda: sweep_ap.sweep_pairs(major, two, budget),
                                       lambda: launch(major), 3)
                ca_ms, ea_ms = alternate(
                    lambda: sweep_ap.sweep_pairs(bucket, two, budget, any_order=True,
                                                 planes=planes),
                    lambda: launch(bucket, any_order=True, planes=planes), 3)
                cr_ms, er_ms = alternate(
                    lambda: [sweep_ap.sweep_pairs(major, two, budget, box_range=r)
                             for r in ranges],
                    lambda: [launch(major, box_range=r) for r in ranges], 3)
                congested = scene_name == "grid600"
                work = any_order_work(bucket, planes)
                co_bound = sweep_bound(major, 8)
                co_any_bound = any_order_bound(bucket, planes, work, 8)
                if not congested:
                    # the rows: the bench scene, which the stage tool sweeps
                    # in the major sort
                    row = rows[name]
                    row[0], row[1], row[2] = row[0] + c_ms, row[1] + plain_ms, \
                        add_bounds(row[2], co_bound)
                extra = {}
                if congested and dtype == torch.float64:
                    pa, pa_ms = timed_once(lambda: sweep_ap.sweep_pairs_reference(
                        bucket, two, budget, any_order=True, planes=planes))
                    check(torch.equal(pair_keys(pa[0], pa[1]),
                                      pair_keys(emitted_any[0], emitted_any[1])),
                          f"{label}: f64 any_order kernel and plain pair sets differ")
                    any64[0], any64[1] = any64[0] + ea_ms, any64[1] + pa_ms
                    any64[2] = add_bounds(any64[2], any_order_bound(
                        bucket, planes, work, whole * PAIR_BYTES))
                    extra = {"any_order_plain_emitting_ms": pa_ms,
                             "whole_f64_bound_ms": sweep_bound(major, whole * PAIR_BYTES)["bound_ms"],
                             **grid_records_f64(torch, sweep_ap, sweep_records, two, major, bucket,
                                                planes, work, budget, whole, label)}
                emit(phase="count_only", scene=scene_name, dtype=name, which=ph, boxes=major.n,
                     pairs=whole, chunks=len(ranges), equal=True,
                     count_only_ms=c_ms, emitting_ms=e_ms,
                     append_share=1 - c_ms / e_ms,
                     any_order_count_only_ms=ca_ms, any_order_emitting_ms=ea_ms,
                     any_order_append_share=1 - ca_ms / ea_ms,
                     ranged_count_only_ms=cr_ms, ranged_emitting_ms=er_ms,
                     plain_count_ms=plain_ms, plain_any_order_count_ms=plain_any_ms,
                     plain_ranged_count_ms=plain_ranged_ms, count_only_bound_ms=co_bound["bound_ms"],
                     any_order_count_only_bound_ms=co_any_bound["bound_ms"], **extra)
    out = {k: {"max_abs_err": 0.0, "ms": r[0], "plain_ms": r[1], **r[2]}
           for k, r in rows.items()}
    out["any_order_f64"] = {"max_abs_err": 0.0, "ms": any64[0], "plain_ms": any64[1], **any64[2]}
    return out


def grid_records_f64(torch, sweep_ap, sweep_records, two, major, bucket, planes, work,
                     budget, total, label):
    """Kernel A' on grid-600's f64 boxes, in both orderings: the exact pair
    total, one record per (row, partner), decoded pairs equal to kernel A's
    pair set, no overflow, and under the major sort the plain version's
    record multiset (timed once); timed in turns with kernel A.  Returns
    the JSON fields of the phase's line."""
    out = {}
    for order, sb in (("sorted", major), ("any_order", bucket)):
        kw = dict(any_order=True, planes=planes) if order == "any_order" else {}
        r = sweep_records.sweep_records(sb, two, budget, **kw)
        a = sweep_ap.sweep_pairs(sb, two, budget, **kw)
        n_rec, n_pairs = int(r[1]), int(r[2])
        keys = record_keys(r[0], n_rec)
        check(n_pairs == int(a[2]) == total and not bool(r[3]) and not bool(a[3])
              and keys.numel() == torch.unique(keys).numel(),
              f"{label} records {order}: {n_rec} records, {n_pairs} pairs vs kernel A "
              f"{int(a[2])} and {total}")
        cum = sweep_records.records_pair_prefix(r[0], n_rec)
        dec = sweep_records.decode_records_range(sb, r[0], cum, 0, n_pairs, 0, two)[0]
        check(torch.equal(pair_keys(dec, n_pairs), pair_keys(a[0], a[1])),
              f"{label} records {order}: decoded pairs differ from kernel A's")
        if order == "sorted":
            p, plain_ms = timed_once(
                lambda: sweep_records.sweep_records_reference(sb, two, budget))
            check((int(p[1]), int(p[2])) == (n_rec, n_pairs)
                  and torch.equal(record_rows(r[0], n_rec), record_rows(p[0], n_rec)),
                  f"{label} records sorted: the plain record multiset differs")
            out["records_sorted_f64_plain_ms"] = plain_ms
        rms, ams = alternate(lambda: sweep_ap.sweep_pairs(sb, two, budget, **kw),
                             lambda: sweep_records.sweep_records(sb, two, budget, **kw), 3)
        bnd = (any_order_bound(sb, planes, work, n_rec * RECORD_BYTES) if kw
               else sweep_bound(sb, n_rec * RECORD_BYTES))
        out.update({f"records_{order}_f64": n_rec, f"records_{order}_f64_ms": rms,
                    f"kernel_a_{order}_f64_ms": ams,
                    f"records_{order}_f64_bound_ms": bnd["bound_ms"]})
    return out


# ---- 14. the precision path ---------------------------------------------------------

def phase_precision_path(torch, dev, bench_scene, mid_scene, grid600_scene, f32_res):
    """The golden scenes, CUDA against CPU, the bench scene and grid-600 in
    f64 and compensated, and the stage tool.  Returns the launch counts of
    the frames that prove the f64 kernels' launches."""
    from scalable_ccd_tpu_torch import CCDConfig, ccd, fused_ccd, ipc_ccd_strategy
    from scalable_ccd_tpu_torch.geometry import edges_from_faces, read_ply
    from scalable_ccd_tpu_torch.tools import stages

    f64 = torch.float64
    modes = {"float32": {}, "compensated": {"precision": "compensated"},
             "float64": {"dtype": f64}}
    configs = {"compensated": CCDConfig(precision="compensated"),
               "float64": CCDConfig(dtype="float64")}

    # the golden scenes (tests/test_golden_data.py:293-333)
    for scene in ("cloth-sphere-16", "soup-60", "dense-cluster"):
        gdir = os.path.join(REPO, "tests", "golden", scene)
        with open(os.path.join(gdir, "toi.json")) as fh:
            g = json.load(fh)
        g0, gf = read_ply(os.path.join(gdir, "frames", "f0.ply"))
        g1, _ = read_ply(os.path.join(gdir, "frames", "f1.ply"))
        gargs = (g0, g1, edges_from_faces(gf), gf)
        tois = {}
        for mode, kw in modes.items():
            r = fused_ccd(*gargs, device=dev, tolerance=g["tolerance"],
                          min_distance=g["min_distance"], allow_zero_toi=g["allow_zero_toi"],
                          **kw)
            t = tois[mode] = float(r.toi)
            check(not bool(r.overflowed), f"golden {scene} {mode}: overflowed")
            check(t <= g["toi"] * (1 + 1e-4) + 1e-7,
                  f"golden {scene} {mode}: toi {t} later than {g['toi']}")
            if scene == "dense-cluster" and mode == "float32":
                check(t == 0.0, f"golden {scene}: f32 toi {t}, expected the collapse to 0")
            else:
                check(abs(t - g["toi"]) <= 1e-6 + 2e-2 * g["toi"],
                      f"golden {scene} {mode}: toi {t} not within 2% of {g['toi']}")
            if scene == "dense-cluster" and mode != "float32":
                tc = ccd(*gargs, device=dev, tolerance=g["tolerance"], config=configs[mode])
                for v, via in ((t, "fused_ccd"), (tc, "ccd")):
                    check(0.0 < v <= g["toi"] * (1 + 1e-4) + 1e-9
                          and abs(v - g["toi"]) <= 2e-2 * g["toi"],
                          f"golden {scene} {mode} {via}: toi {v} vs {g['toi']}")
                tois[mode + "_ccd"] = tc
        emit(phase="precision_golden", scene=scene, golden_toi=g["toi"], **tois)

    # CUDA against the CPU on cloth_on_sphere(64, 3)
    margs = (mid_scene.vertices_t0, mid_scene.vertices_t1, mid_scene.edges, mid_scene.faces)
    errs = {}
    for label, kw in (("fused_f64", {"dtype": f64}), ("fused_compensated", modes["compensated"])):
        rg, rc = fused_ccd(*margs, device=dev, **kw), fused_ccd(*margs, device="cpu", **kw)
        errs[label] = abs(float(rg.toi) - float(rc.toi))
        check(errs[label] <= 1e-7 and (int(rg.vf_total), int(rg.ee_total))
              == (int(rc.vf_total), int(rc.ee_total)) and not bool(rg.overflowed),
              f"grid-64 {label}: cuda {float(rg.toi)} vs cpu {float(rc.toi)}")
    tg = ccd(*margs, device=dev, config=configs["float64"])
    tc = ccd(*margs, device="cpu", config=configs["float64"])
    errs["ccd_f64"] = abs(tg - tc)
    check(errs["ccd_f64"] <= 1e-7, f"grid-64 ccd f64: cuda {tg} vs cpu {tc}")
    hg, hc = [], []
    fused_ccd(*margs, device=dev, dtype=f64, collisions=hg)
    fused_ccd(*margs, device="cpu", dtype=f64, collisions=hc)
    errs["collisions_f64"] = same_hits(hg, hc, "grid-64 f64 collisions cuda vs cpu")
    emit(phase="precision_grid64", hits=len(hg), ccd_toi=tg, **errs)

    # the bench scene: launch counters, then timings beside the f32 frame
    bargs = scene_on(torch, dev, bench_scene, f64)
    cfg64 = configs["float64"]
    runs = {
        "fused_f64": lambda: fused_ccd(*bargs, device=dev, validate=False, dtype=f64),
        "fused_compensated": lambda: fused_ccd(*bargs, device=dev, validate=False,
                                               precision="compensated"),
        "ccd_f64": lambda: ccd(*bargs, device=dev, validate=False, config=cfg64),
        "fused_f64_collisions": lambda: fused_ccd(*bargs, device=dev, validate=False,
                                                  dtype=f64, collisions=[]),
        "fused_f64_records": lambda: fused_ccd(*bargs, device=dev, validate=False, dtype=f64,
                                               sweep_impl="records"),
        "fused_f64_round_limit": lambda: fused_ccd(*bargs, device=dev, validate=False,
                                                   dtype=f64, escalate_rounds=128),
        "ipc_f64": lambda: ipc_ccd_strategy(*bargs, device=dev, validate=False,
                                            min_distance=1e-3, config=cfg64),
        "ipc_compensated": lambda: ipc_ccd_strategy(*bargs, device=dev, validate=False,
                                                    min_distance=1e-3,
                                                    config=configs["compensated"]),
    }
    counts, results = {}, {}
    for label, fn in runs.items():
        zero_counts()
        results[label] = fn()
        torch.cuda.synchronize()
        counts[label] = {k: v for k, v in read_counts().items() if v}
    f64_only = ("fused_f64", "ccd_f64", "fused_f64_collisions", "fused_f64_records",
                "fused_f64_round_limit", "ipc_f64")
    for label in f64_only:
        c = counts[label]
        check(c.get("solve_f64", 0) > 0 and c.get("solve_f32", 0) == 0
              and c.get("sweep_f32", 0) == 0 and c.get("records_f32", 0) == 0,
              f"{label}: the f64 path launched {c}")
    c = counts["fused_compensated"]
    check(c.get("solve_f64", 0) > 0 and c.get("solve_f32", 0) == 0 and c.get("sweep_f32", 0) > 0
          and c.get("sweep_f64", 0) == 0, f"fused_compensated launched {c}")
    for label, key in (("fused_f64", "sweep_whole_f64"), ("fused_f64", "solve_global_f64"),
                       ("ccd_f64", "sweep_range_f64"),
                       ("fused_f64_collisions", "solve_per_query_f64"),
                       ("fused_f64_records", "records_sorted_f64"),
                       ("fused_f64_round_limit", "solve_round_limit_f64"),
                       ("ipc_f64", "solve_bounded_f64"), ("ipc_f64", "solve_pairs_f64"),
                       ("ipc_compensated", "solve_pairs_f64"), ("fused_f64", "solve_pairs_f64"),
                       ("fused_compensated", "solve_pairs_f64")):
        check(counts[label].get(key, 0) > 0, f"{label} launched no {key}: {counts[label]}")
    # the fused runs' pairs launches are the shared form's, one a phase
    for label in ("fused_f64", "fused_compensated"):
        check(counts[label].get("solve_bounded_f64", 0) == 0
              and counts[label].get("solve_pairs_f64", 0) == 2,
              f"{label}: {counts[label]}, not one global pairs launch a phase")
    r64, rcomp = results["fused_f64"], results["fused_compensated"]
    t32 = float(f32_res.toi)
    for label, r in (("fused_f64", r64), ("fused_compensated", rcomp),
                     ("fused_f64_records", results["fused_f64_records"]),
                     ("fused_f64_round_limit", results["fused_f64_round_limit"])):
        check(not bool(r.overflowed) and 0.0 <= float(r.toi) <= 1.0
              and float(r.toi) >= t32 - 1e-6,
              f"bench {label}: toi {float(r.toi)} (f32 {t32}), overflowed {bool(r.overflowed)}")
    check(r64.toi.dtype == f64 and rcomp.toi.dtype == torch.float32, "bench: wrong toi dtypes")
    for label in ("fused_f64_records", "fused_f64_round_limit"):
        check(float(results[label].toi) == float(r64.toi), f"bench {label}: toi differs")
    check(abs(results["ccd_f64"] - float(r64.toi)) <= 1e-7,
          f"bench ccd f64 {results['ccd_f64']} vs fused {float(r64.toi)}")
    check((int(r64.vf_total), int(r64.ee_total)) <= (int(f32_res.vf_total), int(f32_res.ee_total)),
          "bench f64: more candidates than f32")
    b32 = scene_on(torch, dev, bench_scene)
    timings = {"fused_f32": wall_ms(lambda: fused_ccd(*b32, device=dev, validate=False), 5)}
    for label in ("fused_f64", "fused_compensated", "ccd_f64", "fused_f64_collisions"):
        timings[label] = wall_ms(runs[label], 5)
    timings["fused_f32_again"] = wall_ms(lambda: fused_ccd(*b32, device=dev, validate=False), 5)
    emit(phase="precision_bench", scene="cloth_on_sphere(128, 4, drop=0.25)", f32_toi=t32,
         f64_toi=float(r64.toi), compensated_toi=float(rcomp.toi), ccd_f64_toi=results["ccd_f64"],
         ipc_f64_toi=results["ipc_f64"], ipc_compensated_toi=results["ipc_compensated"],
         f64_vf_total=int(r64.vf_total),
         f64_ee_total=int(r64.ee_total), f64_checks=int(r64.total_checks),
         compensated_checks=int(rcomp.total_checks), f32_checks=int(f32_res.total_checks),
         launches=counts, **{k + "_ms_median": v[0] for k, v in timings.items()},
         **{k + "_ms": v[1] for k, v in timings.items()})

    # grid-600 in f64, once
    g64 = scene_on(torch, dev, grid600_scene, f64)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rg = fused_ccd(*g64, device=dev, validate=False, dtype=f64)
    torch.cuda.synchronize()
    g_first_ms = (time.perf_counter() - t) * 1e3
    counts["grid600_f64"] = {k: v for k, v in read_counts().items() if v}
    check(counts["grid600_f64"].get("sweep_any_order_f64", 0) > 0
          and counts["grid600_f64"].get("solve_f32", 0) == 0,
          f"grid-600 f64 launched {counts['grid600_f64']}")
    check(not bool(rg.overflowed) and 0.0 <= float(rg.toi) <= 1.0, "grid-600 f64: bad result")
    g_ms, _ = wall_ms(lambda: fused_ccd(*g64, device=dev, validate=False, dtype=f64), 1)
    emit(phase="precision_grid600", scene="cloth_on_sphere(600, 4)", toi=float(rg.toi),
         vf_total=int(rg.vf_total), ee_total=int(rg.ee_total),
         total_checks=int(rg.total_checks), first_ms=g_first_ms, ms_per_frame=g_ms,
         launches=counts["grid600_f64"])

    # the stage tool, its lines as they are
    for grid, subdiv, drop, dtype in ((128, 4, 0.25, "float32"), (600, 4, 0.25, "float32"),
                                      (128, 4, 0.25, "float64")):
        zero_counts()
        # one timed repetition: the script checks the tool; the standalone
        # tool, run with more, gives PERF.md's breakdown
        lines = stages.run_stages(grid, subdiv, drop, dtype=dtype, device=dev, reps=1)
        torch.cuda.synchronize()
        counts[f"stages_{grid}_{dtype}"] = {k: v for k, v in read_counts().items() if v}
        frame = lines[-1]
        check(frame["stage"] == "fused_ccd" and not frame["overflowed"]
              and all(o["pairs"] == frame[o["phase"] + "_total"] for o in lines
                      if o["stage"].startswith("sweep")),
              f"stage tool {grid} {dtype}: totals differ from the frame's")
    key = "sweep_count_only"
    check(counts["stages_128_float32"].get(key, 0) > 0
          and counts["stages_128_float64"].get(key + "_f64", 0) > 0,
          "the stage tool launched no count_only kernel")
    return counts


# ---- 15. kernel B on the main path's rows -------------------------------------------

def ptxas_by_instantiation(log_text):
    """``{instantiation: "N registers, ..."}`` from a ``ptxas -v`` build log:
    kernel B's entry functions by scalar type, template flags (VF,
    per-query) and form (shared domains, one thread per query), kernel A's by scalar type and mode
    (``any_order``, ``count_only``) and kernel A''s by scalar type and
    ordering, each with its two unit-count launches."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = None
            flags = lambda m: [f == "1" for f in re.findall(r"Lb([01])E", m.group(2))]  # noqa: E731
            fp = lambda m: "f32" if m.group(1) == "f" else "f64"  # noqa: E731
            if m := re.search(r"solve(_lane)?_kernelI([fd])((?:Lb[01]E)+)", line):
                vf, pq = [f == "1" for f in re.findall(r"Lb([01])E", m.group(3))]
                name = (f"{'f32' if m.group(2) == 'f' else 'f64'} {'vf' if vf else 'ee'}"
                        f"{' per_query' if pq else ''}{' one_thread' if m.group(1) else ' shared'}")
                # the one-thread form's row source: columns, or pairs (widened
                # where double rows are computed in float)
                if "PairRowsIdf" in line:
                    name += " pairs widened"
                elif "PairRows" in line:
                    name += " pairs"
            elif m := re.search(r"sweep_units_kernelI([fd])((?:Lb[01]E)+)", line):
                any_order, count_only = flags(m)
                name = (f"sweep {fp(m)} {'any_order' if any_order else 'whole'}"
                        f"{' count_only' if count_only else ''}")
            elif m := re.search(r"tile_units_kernelI([fd])((?:Lb[01]E)+)", line):
                name = f"tile_units {fp(m)}{' any_order' if flags(m)[0] else ''}"
            elif m := re.search(r"sweep_records_kernelI([fd])((?:Lb[01]E)+)", line):
                name = f"records {fp(m)} {'any_order' if flags(m)[0] else 'sorted'}"
            elif m := re.search(r"record_units_kernelI([fd])((?:Lb[01]E)+)", line):
                name = f"record_units {fp(m)}{' any_order' if flags(m)[0] else ''}"
            elif "unit_prefix_kernel" in line:
                name = "unit_prefix"
            if name:
                out[name] = ""
        elif name and ("stack frame" in line or "Used" in line):
            out[name] = (out[name] + "; " if out[name] else "") + line.split(":", 1)[-1].strip()
    return out


def phase_kernel_b_rows():
    """Kernel B on the rows the main path gives it (module docstring, phase
    15; ``tools/stages.py:run_kernel_b``), each line as the tool prints it,
    and kernel B's ``ptxas`` lines."""
    from scalable_ccd_tpu_torch.ops import _build, sweep_records
    from scalable_ccd_tpu_torch.tools import stages

    t = time.perf_counter()
    lines = stages.run_kernel_b(reps=3, plain=True, emit=lambda line: print(line, flush=True))
    bad = [(o["set"], o["phase"], o["mode"]) for o in lines if not o["equal"] or o["overflow"]]
    check(not bad, f"kernel B on the main path's rows differs from its plain version: {bad}")
    log = _build.build_library("solver").with_suffix(".log").read_text()
    sweep_log = _build.build_library("sweep_ap").with_suffix(".log").read_text()
    records_log = _build.build_library("sweep_records").with_suffix(".log").read_text()
    # kernel A''s sweep launch: its blocks and dynamic shared memory per block
    shape = {f"{'f64' if f64 else 'f32'} {'any_order' if ao else 'sorted'}":
             sweep_records._launch_shape(f64, ao) for f64 in (False, True) for ao in (False, True)}
    emit(phase="kernel_b_rows", sets=len(lines), seconds=time.perf_counter() - t,
         ptxas=ptxas_by_instantiation(log), kernel_a_ptxas=ptxas_by_instantiation(sweep_log),
         kernel_a_records_ptxas=ptxas_by_instantiation(records_log),
         kernel_a_records_blocks_smem=shape)
    return lines


# ---- 18. kernel B's pairs source on the IPC cell's chunks ---------------------------

#: the IPC cell's call (``ccd_bench/configs/clothball_ipc.json``, ``call``)
IPC_CALL = {"min_distance": 1e-3, "max_iterations": 1_000_000, "tolerance": 1e-6}
#: the row types of phase 18: (vertex dtype name, compensated)
CHUNK_PRECISIONS = {"float32": ("float32", False), "float64": ("float64", False),
                    "compensated": ("float32", True)}


def ipc_cell_frames(seed):
    """Frames 0 and 3 of the IPC cell's cycle, ``{frame: (v0, v1, edges,
    faces)}`` on the host, and where they come from: the benchmark's
    generator for the cell ``clothball_ipc.ipc_sim`` and ``seed``; where the
    benchmark lacks that cell, the port's own ``cloth_on_sphere(210, 4,
    drop=0.25)`` at the cell's size, frame 0 raised by 0.9 as the cell's
    frame 0 is (other candidates: no slide, more noise)."""
    try:
        from ccd_bench import cells, generator

        cell = cells.resolve("clothball_ipc.ipc_sim")
        cyc = generator.make_cycle(cell.config, cell.traffic, seed)
        return {k: (cyc.v0[k], cyc.v1[k], cyc.edges, cyc.faces) for k in (0, 3)}, cell.name
    except (ImportError, KeyError, FileNotFoundError) as exc:
        import numpy as np

        from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere

        sc = cloth_on_sphere(grid_n=210, sphere_subdiv=4, drop=0.25)
        lift = np.zeros_like(sc.vertices_t0)
        lift[: 210 * 210, 1] = 0.9  # the cloth's vertices come first
        frames = {0: (sc.vertices_t0 + lift, sc.vertices_t1 + lift, sc.edges, sc.faces),
                  3: (sc.vertices_t0, sc.vertices_t1, sc.edges, sc.faces)}
        return frames, f"cloth_on_sphere(210, 4, drop=0.25), the cell unavailable: {exc}"


def pairs_bound(torch, pairs, is_vf, checks, in_bytes, f64):
    """The bound of kernel B's pairs source solving every row of ``pairs``
    with ``checks`` domain evaluations: each row's two ids and each table
    row the rows reference read once (as :func:`pack_bound` counts them), no
    column written or read, OPS_PER_PACKED_ROW operations a row at the
    tables' rate and OPS_PER_CHECK an evaluation at the rows' rate."""
    if is_vf:
        table_scalars = (6 * torch.unique(pairs[:, 0]).numel()
                         + 18 * torch.unique(pairs[:, 1]).numel())
    else:
        table_scalars = 12 * torch.unique(pairs).numel()
    rows = pairs.shape[0]
    # operations in f32 units: the f64 rate is half the f32 rate
    ops = rows * OPS_PER_PACKED_ROW * (in_bytes // 4) + checks * OPS_PER_CHECK * (2 if f64 else 1)
    return bound(rows * PAIR_BYTES + table_scalars * in_bytes, ops)


def phase_chunk_solve(torch, dev):
    """Phase 18 (module docstring): each broad chunk of the IPC cell's
    frames 0 and 3 as ``ccd()`` solves it, one pairs-source launch, against
    the per-batch path it replaces, kernel C and the columns source per
    batch, in f32, f64 and compensated rows, in device ms behind a GPU sleep
    and, on frame 0, in host ms with the per-batch path's read a batch; the
    plain twin on frame 0's last VF and EE chunks.  Returns the kernels rows'
    fields of ``solve_pairs[bounded]`` per row type."""
    from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
    from scalable_ccd_tpu_torch.geometry import (
        build_edge_boxes,
        build_face_boxes,
        build_vertex_boxes,
    )
    from scalable_ccd_tpu_torch.ops import _build, solver
    from scalable_ccd_tpu_torch.ops.gather_pack import gather_pack_reference
    from scalable_ccd_tpu_torch.pipeline.ccd import sweep_chunks
    from scalable_ccd_tpu_torch.pipeline.narrow import NarrowSolver
    from scalable_ccd_tpu_torch.pipeline.policy import mesh_tensors

    t_phase = time.perf_counter()
    seed = 2718281828
    frames, source = ipc_cell_frames(seed)
    ms, cap, tol = (IPC_CALL[k] for k in ("min_distance", "max_iterations", "tolerance"))
    batch = 1 << 17
    rows = []
    kernel_rows = {p: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, **bound(0, 0)}
                   for p in CHUNK_PRECISIONS}
    for frame, (hv0, hv1, he, hf) in frames.items():
        v0, v1, e, f = mesh_tensors(hv0, hv1, he, hf, dev, False)
        vb = build_vertex_boxes(v0, v1, inflation_radius=ms)
        for is_vf, boxes in ((True, merge_two_lists(vb, build_face_boxes(vb, f))),
                             (False, build_edge_boxes(vb, e))):
            # every row type solves the f32 boxes' candidates
            nars = {p: NarrowSolver.for_phase(is_vf, v0, v1, e, f, ms, tol, True, cap,
                                              dtype=getattr(torch, dt), compensated=comp)
                    for p, (dt, comp) in CHUNK_PRECISIONS.items()}
            chunks = list(sweep_chunks(sort_boxes(boxes), is_vf, 1 << 15, 1 << 20))
            for k, (pairs, count) in enumerate(chunks):
                if count == 0:
                    continue
                last = k == len(chunks) - 1
                for prec, nar in nars.items():
                    one = torch.ones((), dtype=torch.float32, device=dev)

                    def per_batch(seed_toi, nar=nar, pairs=pairs, count=count):
                        toi, outs = seed_toi, []
                        for s in range(0, count, batch):
                            cols = nar.pack(pairs, s, min(s + batch, count))
                            valid = torch.ones((cols.shape[1],), dtype=torch.bool, device=dev)
                            outs.append(nar.solve_rows(cols, valid, toi, max_iterations=cap,
                                                       skip_if_done=True))
                            toi = outs[-1][0]
                        return (toi, torch.stack([o[1] for o in outs]).any(),
                                torch.stack([o[2] for o in outs]).sum())

                    def per_batch_read(nar=nar, pairs=pairs, count=count):
                        # the per-batch path with its host read a batch and
                        # the seed uploaded from the host float
                        toi = 1.0
                        for s in range(0, count, batch):
                            if toi <= 0:
                                break
                            cols = nar.pack(pairs, s, min(s + batch, count))
                            valid = torch.ones((cols.shape[1],), dtype=torch.bool, device=dev)
                            out = nar.solve_rows(cols, valid, toi, max_iterations=cap)
                            toi = torch.stack([out[0].double(), out[1].double(),
                                               out[2].double()]).tolist()[0]
                        return toi

                    def chunk(seed_toi, nar=nar, pairs=pairs, count=count):
                        return nar.solve_pairs(pairs, 0, count, seed_toi, batch)

                    def chunk_read(nar=nar, pairs=pairs, count=count):
                        out = nar.solve_pairs(pairs, 0, count, one, batch)
                        return torch.stack([out[0].double(), out[1].double(),
                                            out[2].double()]).tolist()[0]

                    label = f"chunk solve {prec} frame {frame} {'vf' if is_vf else 'ee'} chunk {k}"
                    a, b = per_batch(one), chunk(one)
                    torch.cuda.synchronize()
                    check(float(a[0]) == float(b[0]) and bool(a[1]) == bool(b[1]),
                          f"{label}: toi {float(b[0])!r} overflow {bool(b[1])} against the "
                          f"per-batch {float(a[0])!r} {bool(a[1])}")
                    # seeded with the answer, no query lowers the running TOI:
                    # the checks are each query's own, whatever the launches' order
                    final = a[0].clone()
                    a2, b2 = per_batch(final), chunk(final)
                    torch.cuda.synchronize()
                    check(float(a2[0]) == float(b2[0]) and int(a2[2]) == int(b2[2]),
                          f"{label} seeded: checks {int(b2[2])} against the per-batch "
                          f"{int(a2[2])}")
                    reps = 3 if frame == 0 else 1
                    row = dict(
                        precision=prec, frame=frame, pairing="vf" if is_vf else "ee", chunk=k,
                        candidates=count, batches=-(-count // batch), toi=float(b[0]),
                        overflow=bool(b[1]), checks=int(b[2]), per_batch_checks=int(a[2]),
                        seeded_checks=int(b2[2]),
                        per_batch_ms=device_ms(lambda: per_batch(one), reps),
                        one_launch_ms=device_ms(lambda: chunk(one), reps))
                    if frame == 0:
                        row["per_batch_wall_ms"] = wall_ms(per_batch_read, 3)[0]
                        row["one_launch_wall_ms"] = wall_ms(chunk_read, 3)[0]
                    if frame == 0 and last:
                        # the plain twin, seeded with the chunk's TOI (its
                        # least checks); rows as the kernel's batches hold them
                        def plain(nar=nar, pairs=pairs, count=count, toi=final):
                            c = 0
                            for s in range(0, count, batch):
                                t = min(s + batch, count)
                                cols = gather_pack_reference(pairs, s, t, nar.vcat, nar.table,
                                                             is_vf, ms, tol, nar.compensated)
                                toi, _, ck = solver.solve_packed_reference(
                                    cols.t(), torch.ones((t - s,), dtype=torch.bool,
                                                         device=dev),
                                    is_vf, toi, tol, True, max_iterations=cap,
                                    widened=nar.compensated)
                                c += int(ck)
                            return toi, c

                        tp, cp = plain()
                        err = abs(float(tp) - float(b2[0]))
                        check(err == 0.0 and cp == int(b2[2]),
                              f"{label}: plain twin toi {float(tp)!r}, {cp} checks against "
                              f"{float(b2[0])!r}, {int(b2[2])}")
                        kms = device_ms(lambda: chunk(final), 3)
                        pms = cuda_ms(plain, 1)
                        kr = kernel_rows[prec]
                        kr.update(add_bounds(kr, pairs_bound(
                            torch, pairs[:count], is_vf, int(b2[2]),
                            nar.vcat.element_size(), nar.row_dtype == torch.float64)))
                        kr["ms"] += kms
                        kr["plain_ms"] += pms
                        kr["max_abs_err"] = max(kr["max_abs_err"], err)
                        row.update(plain_checks=cp, kernel_seeded_ms=kms, plain_ms=pms)
                    rows.append(row)
                    emit(phase="chunk_solve_chunk", **row)
            del chunks
    log = _build.build_library("solver").with_suffix(".log").read_text()
    totals = {f"{p}_frame{fr}_{key}": sum(r[key] for r in rows
                                          if r["frame"] == fr and r["precision"] == p)
              for p in CHUNK_PRECISIONS for fr in frames
              for key in ("per_batch_ms", "one_launch_ms", "batches")}
    for p in CHUNK_PRECISIONS:
        for key in ("per_batch_wall_ms", "one_launch_wall_ms"):
            totals[f"{p}_frame0_{key}"] = sum(r[key] for r in rows
                                              if r["frame"] == 0 and r["precision"] == p)
    emit(phase="chunk_solve", frames_from=source, seed=seed, chunks=len(rows), equal=True,
         **totals, seconds=time.perf_counter() - t_phase,
         ptxas={k: v for k, v in ptxas_by_instantiation(log).items() if "one_thread" in k})
    return {p: {**kr, "frame0_one_launch_ms": totals[f"{p}_frame0_one_launch_ms"],
                "frame0_per_batch_ms": totals[f"{p}_frame0_per_batch_ms"]}
            for p, kr in kernel_rows.items()}


# ---- 19. kernel B's pairs source in the shared form ---------------------------------

def phase_phase_solve(torch, dev, bench_scene, grid600_scene):
    """Phase 19 (module docstring): one shared-form launch of kernel B over
    a whole phase's pairs, ``fused_ccd``'s launch at its defaults on CUDA,
    against the plain twin on the same pairs, on the bench scene and
    grid-600 in f32, f64 and compensated rows: TOI bit for bit, overflow
    equal.  Returns the kernels rows' fields of ``solve_pairs[global]`` per
    row type: device ms (behind a GPU sleep, mean of 3), plain ms, and the
    bound from the least checks (the plain version seeded with the TOI)."""
    from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
    from scalable_ccd_tpu_torch.geometry import (
        build_edge_boxes,
        build_face_boxes,
        build_vertex_boxes,
    )
    from scalable_ccd_tpu_torch.narrow_phase import types
    from scalable_ccd_tpu_torch.ops import solver, sweep_ap
    from scalable_ccd_tpu_torch.ops import gather_pack as gp

    t_phase = time.perf_counter()
    out = {p: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, **bound(0, 0)}
           for p in CHUNK_PRECISIONS}
    for name, sc in (("bench", bench_scene), ("grid600", grid600_scene)):
        v0, v1, e, f = scene_on(torch, dev, sc)
        vb = build_vertex_boxes(v0, v1)
        cands = {}
        # every row type solves the f32 boxes' candidates, in the main sweep's order
        for ph, is_vf, boxes in (("vf", True, merge_two_lists(vb, build_face_boxes(vb, f))),
                                 ("ee", False, build_edge_boxes(vb, e))):
            sb = sort_boxes(boxes)
            total = int(sweep_ap.sweep_pairs(sb, is_vf, count_only=True))
            pairs, n, _, _ = sweep_ap.sweep_pairs(sb, is_vf, total)
            cands[ph] = (is_vf, pairs, int(n))
        del vb
        for prec, (dt, comp) in CHUNK_PRECISIONS.items():
            dtype = getattr(torch, dt)
            vcat = types.concat_frames(v0, v1, dtype)
            seed = torch.ones((), dtype=gp.row_dtype(dtype, comp), device=dev)
            for ph, (is_vf, pairs, n) in cands.items():
                table = (types.pack_face_table(vcat, f) if is_vf
                         else types.pack_edge_table(vcat, e))

                def launch(seed=seed, is_vf=is_vf, pairs=pairs, n=n, table=table):
                    return solver.solve_pairs(pairs, 0, n, vcat, table, is_vf, seed, 0.0, TOL,
                                              max_iterations=-1, compensated=comp,
                                              skip_if_done=True)

                def plain(toi, least=False, is_vf=is_vf, pairs=pairs, n=n, table=table):
                    # the plain twin, chunk by chunk, each seeded with the
                    # TOI before it; ``least`` counts its checks instead
                    ovf, checks = False, 0
                    for s in range(0, n, gp.CHUNK_ROWS):
                        t = min(s + gp.CHUNK_ROWS, n)
                        rows = gp.gather_pack_reference(pairs, s, t, vcat, table, is_vf, 0.0,
                                                        TOL, comp).t()
                        valid = torch.ones((t - s,), dtype=torch.bool, device=dev)
                        if least:
                            checks += solver._least_checks(rows, valid, is_vf, toi, TOL,
                                                           widened=comp)
                            continue
                        toi, o, _ = solver.solve_packed_reference(rows, valid, is_vf, toi, TOL,
                                                                  widened=comp)
                        ovf = ovf or bool(o)
                    return checks if least else (toi, ovf)

                label = f"phase solve {name} {prec} {ph}"
                before = dict(solver.LAUNCHES_BY_MODE)
                k = launch()
                torch.cuda.synchronize()
                check(all(solver.LAUNCHES_BY_MODE[m] == before[m] + 1 for m in ("global", "pairs"))
                      and solver.LAUNCHES_BY_MODE["bounded"] == before["bounded"],
                      f"{label}: not one global pairs launch")
                (tp, op_), pms = timed_once(lambda: plain(seed))
                check(same_bits(k[0].reshape(1), tp.reshape(1)) and bool(k[1]) == op_,
                      f"{label}: toi {float(k[0])!r} overflow {bool(k[1])} against the plain "
                      f"twin's {float(tp)!r} {op_}")
                least = plain(tp, least=True)
                kms = device_ms(launch, 3)
                o = out[prec]
                o.update(add_bounds(o, pairs_bound(torch, pairs[:n], is_vf, least,
                                                   vcat.element_size(), dtype == torch.float64
                                                   or comp)))
                o["ms"] += kms
                o["plain_ms"] += pms
                emit(phase="phase_solve", scene=name, precision=prec, which=ph, rows=n,
                     seed=float(seed), toi=float(k[0]), plain_toi=float(tp), bitwise=True,
                     overflow=bool(k[1]), checks=int(k[2]), least_checks=least, ms=kms,
                     plain_ms=pms)
                seed = torch.minimum(seed, k[0])
        del cands
        torch.cuda.empty_cache()
    emit(phase="phase_solve_seconds", seconds=time.perf_counter() - t_phase)
    return out


# ---- 16. the multi-device path ------------------------------------------------------

def phase_row_range(torch, dev, bench_scene, grid600_scene):
    """Kernel A''s ``row_range`` against its plain version: the bench scene
    under the major sort and grid-600 under ``any_order``, VF and EE, f32
    and f64; a range cut mid-scene equal to the plain version's, and the
    ranges of partitions of the a-rows into 2 and 4 making the whole
    multiset.  On the bench scene the 4-range partition is timed against
    the plain version on the same ranges, with the whole sweep's bound (the
    ranges' union); on grid-600 the kernel's partition alone is timed (its
    plain version takes seconds there).  The kernel's time is device time
    behind a GPU sleep (:func:`device_ms`); the time with the host's launch
    gaps is printed beside it.  Returns the kernels rows (the
    bench scene's) by dtype."""
    from scalable_ccd_tpu_torch.broad_phase import sort_boxes
    from scalable_ccd_tpu_torch.ops import sweep_ap, sweep_records

    out = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        kms_sum = pms_sum = 0.0
        bnd = bound(0, 0)
        cases = []
        for ph, (two, boxes) in phase_boxes(scene_on(torch, dev, bench_scene, dtype)).items():
            cases.append(("bench", ph, two, sort_boxes(boxes), None))
        for ph, (two, boxes) in phase_boxes(scene_on(torch, dev, grid600_scene, dtype)).items():
            sb = sort_boxes(boxes, bucket_minor=True)
            cases.append(("grid600", ph, two, sb, sweep_ap.partner_planes(sb)))
        for scene, ph, two, sb, planes in cases:
            ao = planes is not None
            kw = dict(any_order=ao, planes=planes)
            label = f"row_range {scene} {ph} {name}"
            budget = pow2ceil(int(sweep_ap.sweep_pairs(sb, two, count_only=True, **kw)))
            rows = -(-sb.n // PARTNER_ROW)
            whole = sweep_records.sweep_records(sb, two, budget, **kw)
            check(not bool(whole[3]), f"{label}: the whole sweep overflowed")
            want = record_rows(whole[0], whole[1])
            mid = (rows // 3, 2 * rows // 3)
            zero_counts()
            k = sweep_records.sweep_records(sb, two, budget, row_range=mid, **kw)
            torch.cuda.synchronize()
            counted = sweep_records.LAUNCHES_BY_MODE["range"]
            p = sweep_records.sweep_records_reference(sb, two, budget, 0, row_range=mid, **kw)
            check(counted == 1, f"{label}: {counted} launches counted under 'range'")
            check((int(k[1]), int(k[2])) == (int(p[1]), int(p[2])) and not bool(k[3]),
                  f"{label}: counts {int(k[1])}/{int(k[2])} vs plain {int(p[1])}/{int(p[2])}")
            check(torch.equal(record_rows(k[0], k[1]), record_rows(p[0], p[1])),
                  f"{label}: the mid-scene range's records differ from the plain version's")
            parts = {}
            for world in (2, 4):
                per = -(-rows // world)
                ranges = [(min(s * per, rows), (s + 1) * per) for s in range(world)]
                got = [sweep_records.sweep_records(sb, two, budget, row_range=r, **kw)
                       for r in ranges]
                union = torch.cat([g[0][: int(g[1])] for g in got])
                check(sum(int(g[2]) for g in got) == int(whole[2]),
                      f"{label}: the {world} ranges' pairs do not sum to the whole")
                check(torch.equal(record_rows(union, union.shape[0]), want),
                      f"{label}: the {world} ranges' records are not the whole multiset")
                parts[world] = ranges
            ranges = parts[4]

            def four():
                return [sweep_records.sweep_records(sb, two, budget, row_range=r, **kw)
                        for r in ranges]

            kms, host_ms = device_ms(four, 3), cuda_ms(four, 3)
            n_rec = int(whole[1])
            fields = {}
            if not ao:
                _, pms = timed_once(lambda: [sweep_records.sweep_records_reference(
                    sb, two, budget, 0, row_range=r, **kw) for r in ranges])
                case_bound = sweep_bound(sb, n_rec * RECORD_BYTES)
                kms_sum, pms_sum = kms_sum + kms, pms_sum + pms
                bnd = add_bounds(bnd, case_bound)
                fields = dict(plain_four_ranges_ms=pms, bound_ms=case_bound["bound_ms"],
                              bound_by=case_bound["bound_by"])
            emit(phase="row_range", scene=scene, which=ph, dtype=name,
                 order="any_order" if ao else "sorted", rows=rows, mid_range=list(mid),
                 records=n_rec, pairs=int(whole[2]), mid_records=int(k[1]), equal=True,
                 partitions_equal=[2, 4], four_ranges_ms=kms, four_ranges_host_ms=host_ms,
                 **fields)
        out[name] = {"max_abs_err": 0.0, "ms": kms_sum, "plain_ms": pms_sum, **bnd}
    return out


def _phase16_rank(scenes, budgets, device):
    """One rank of phase 16(c): every scene at both partitions and both
    sweeps on ``device`` (the card the ranks share), with zeroed launch
    counts, timed (two frames of the bench scene, one of grid-600);
    ``{case: fields}``."""
    import torch

    sys.path.insert(0, REPO)
    from scalable_ccd_tpu_torch.parallel import sharded_ccd

    dev = torch.device(device)
    torch.cuda.set_device(dev.index or 0)
    out = {}
    for scene, arrays in scenes.items():
        args = tuple(torch.as_tensor(a, device=dev) for a in arrays)
        vf_b, ee_b = budgets[scene]
        for partition in ("replicated", "box"):
            for impl in ("pairs", "records"):
                kw = dict(device=dev, sweep_impl=impl, partition=partition, validate=False,
                          vf_budget_per_shard=vf_b, ee_budget_per_shard=ee_b)
                zero_counts()
                r = sharded_ccd(*args, **kw)
                torch.cuda.synchronize()
                counts = read_counts()
                reps = 2 if scene == "bench" else 1
                ms, times = wall_ms(lambda: sharded_ccd(*args, **kw), reps)
                out[f"{scene} {partition} {impl}"] = dict(
                    toi=float(r.toi), overflowed=bool(r.overflowed), vf_total=int(r.vf_total),
                    ee_total=int(r.ee_total), checks=int(r.total_checks),
                    capped=bool(r.solver_capped), launches=counts, ms_per_frame_median=ms,
                    ms_per_frame=times)
    return out


def phase_multi_device(torch, dev, bench_scene, grid600_scene, mid_scene, smi):
    """Phase 16: kernel A''s row range (a), ``sharded_ccd`` in a world of
    one process on NCCL (b) and in two processes sharing the card on gloo
    (c), each against ``fused_ccd``, and the host broad phase against
    kernel A in f64 (d).  Returns the kernels rows and their launches."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from scalable_ccd_tpu_torch import fused_ccd, host, sharded_ccd
    from scalable_ccd_tpu_torch.broad_phase import sort_boxes
    from scalable_ccd_tpu_torch.ops import sweep_ap
    from scalable_ccd_tpu_torch.parallel import spawn_local

    t_phase = time.perf_counter()
    rows = phase_row_range(torch, dev, bench_scene, grid600_scene)
    t_a = time.perf_counter() - t_phase

    def same(r, ref, label):
        err = abs(float(r.toi) - float(ref.toi))
        check(not bool(r.overflowed), f"{label}: overflowed")
        check(err <= 1e-7, f"{label}: toi {float(r.toi)} vs fused_ccd {float(ref.toi)}")
        check((int(r.vf_total), int(r.ee_total)) == (int(ref.vf_total), int(ref.ee_total)),
              f"{label}: totals {int(r.vf_total)}/{int(r.ee_total)} vs fused_ccd "
              f"{int(ref.vf_total)}/{int(ref.ee_total)}")
        return err

    def budgets(ref):
        return pow2ceil(int(ref.vf_total)), pow2ceil(int(ref.ee_total))

    # (b) a world of one process on NCCL
    bargs = scene_on(torch, dev, bench_scene)
    b64 = scene_on(torch, dev, bench_scene, torch.float64)
    margs = scene_on(torch, dev, mid_scene)
    refs = {"bench": fused_ccd(*bargs, device=dev), "bench_f64": fused_ccd(
        *b64, device=dev, dtype=torch.float64)}
    launches, world1 = {}, {}
    torch.cuda.set_device(dev.index or 0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0)
        try:
            check(dist.get_backend() == "nccl", "the world of one is not on NCCL")
            for label, args, kw, ref in (
                ("pairs", bargs, {}, refs["bench"]),
                ("records", bargs, dict(sweep_impl="records"), refs["bench"]),
                ("records_f64", b64, dict(sweep_impl="records", dtype=torch.float64),
                 refs["bench_f64"]),
            ):
                vf_b, ee_b = budgets(ref)
                kw = dict(kw, validate=False, vf_budget_per_shard=vf_b, ee_budget_per_shard=ee_b)
                run = lambda: sharded_ccd(*args, **kw)  # noqa: E731
                zero_counts()
                r = run()
                torch.cuda.synchronize()
                counts = read_counts()
                err = same(r, ref, f"nccl world of 1 bench {label}")
                key = "sweep_range" if label == "pairs" else "records_range"
                check(counts[key] > 0 and counts["solve_global"] + counts["solve_round_limit"] > 0,
                      f"nccl world of 1 bench {label}: a kernel did not launch: {counts}")
                launches[label] = counts
                ms, times = wall_ms(run, 3)
                world1[label] = dict(toi=float(r.toi), abs_err=err, launches=counts,
                                     ms_per_frame_median=ms, ms_per_frame=times,
                                     fused_toi=float(ref.toi))
            hits, want = [], []
            mref = fused_ccd(*margs, device=dev, collisions=want)
            vf_b, ee_b = budgets(mref)
            zero_counts()
            r = sharded_ccd(*margs, validate=False, collisions=hits, vf_budget_per_shard=vf_b,
                            ee_budget_per_shard=ee_b)
            counts = read_counts()
            same(r, mref, "nccl world of 1 grid-64 collect")
            check([h[:2] for h in hits] == [h[:2] for h in want] and len(hits) > 0,
                  f"grid-64 collect: {len(hits)} hit keys vs fused_ccd's {len(want)}")
            check(counts["solve_per_query"] > 0, f"grid-64 collect: no per-query launch {counts}")
            hit_err = max(abs(a[2] - b[2]) for a, b in zip(hits, want))
            check(hit_err <= 1e-7, f"grid-64 collect: hit TOIs differ by {hit_err}")
            world1["collect_grid64"] = dict(hits=len(hits), hit_toi_max_err=hit_err,
                                            launches=counts)
        finally:
            dist.destroy_process_group()
    emit(phase="multi_device_nccl_world1", nvidia_smi=smi, **world1)
    t_b = time.perf_counter() - t_phase - t_a

    # (c) two processes sharing the card, on gloo
    g600 = scene_on(torch, dev, grid600_scene)
    refs["grid600"] = fused_ccd(*g600, device=dev)
    del g600
    scenes = {name: tuple(np.ascontiguousarray(a, dtype=dt) for a, dt in (
        (sc.vertices_t0, np.float32), (sc.vertices_t1, np.float32), (sc.edges, np.int32),
        (sc.faces, np.int32))) for name, sc in (("bench", bench_scene),
                                                 ("grid600", grid600_scene))}
    out = spawn_local(2, _phase16_rank, scenes,
                      {k: budgets(refs[k]) for k in ("bench", "grid600")}, str(dev),
                      backend="gloo")
    for rank, cases in enumerate(out):
        for case, o in cases.items():
            ref = refs[case.split()[0]]
            label = f"gloo rank {rank} {case}"
            check(not o["overflowed"], f"{label}: overflowed")
            err = abs(o["toi"] - float(ref.toi))
            check(err <= 1e-7, f"{label}: toi {o['toi']} vs fused_ccd {float(ref.toi)}")
            check((o["vf_total"], o["ee_total"]) == (int(ref.vf_total), int(ref.ee_total)),
                  f"{label}: totals differ from fused_ccd's")
            c = o["launches"]
            check(c["sweep_range"] + c["records_range"] > 0
                  and c["solve_global"] + c["solve_round_limit"] > 0,
                  f"{label}: a kernel did not launch in this rank: {c}")
            o["abs_err"] = err
    emit(phase="multi_device_gloo_two_ranks_one_card", nvidia_smi=smi, backend="gloo",
         fused_toi={k: float(v.toi) for k, v in refs.items()}, ranks=out)
    t_c = time.perf_counter() - t_phase - t_a - t_b

    # (d) the host broad phase against kernel A, f64, on the bench scene
    vmin, vmax = host.build_vertex_boxes(bench_scene.vertices_t0, bench_scene.vertices_t1)
    host_sets = {}
    t = time.perf_counter()
    for ph, elems in (("vf", bench_scene.faces), ("ee", bench_scene.edges)):
        emin, emax = host.build_element_boxes(vmin, vmax, elems)
        if ph == "vf":
            nv, nf = len(vmin), len(emin)
            ids = np.arange(nv, dtype=np.int32)
            pairs, _ = host.sort_and_sweep(
                np.concatenate([vmin, emin]), np.concatenate([vmax, emax]),
                np.concatenate([np.stack([ids, -ids - 1, -ids - 1], 1),
                                np.asarray(elems, np.int32)]),
                np.concatenate([-ids - 1, np.arange(nf, dtype=np.int32)]), two_lists=True)
        else:
            e = np.asarray(elems, np.int32)
            vids = np.stack([e[:, 0], e[:, 1], -e[:, 0] - 1], 1)
            pairs, _ = host.sort_and_sweep(emin, emax, vids, np.arange(len(e), dtype=np.int32))
        host_sets[ph] = torch.as_tensor(pairs)
    host_ms = (time.perf_counter() - t) * 1e3
    counts = {}
    for ph, (two, boxes) in phase_boxes(b64).items():
        sb = sort_boxes(boxes)
        n = int(sweep_ap.sweep_pairs(sb, two, count_only=True))
        k = sweep_ap.sweep_pairs(sb, two, pow2ceil(n))
        check(torch.equal(pair_keys(k[0], k[1]).cpu(),
                          pair_keys(host_sets[ph], host_sets[ph].shape[0])),
              f"host broad phase {ph}: its f64 pair set differs from kernel A's")
        counts[ph] = n
    emit(phase="host_broad_phase", scene="cloth_on_sphere(128, 4, drop=0.25)", dtype="float64",
         pairs=counts, equal_to_kernel_a=True, host_ms_both_phases=host_ms,
         host_threads=os.cpu_count())
    emit(phase="multi_device_seconds", row_range=t_a, nccl_world1=t_b, gloo_two_ranks=t_c,
         host=time.perf_counter() - t_phase - t_a - t_b - t_c)
    return {"rows": rows, "launches": launches}


if __name__ == "__main__":
    sys.exit(main(only={"--chunk-solve": "chunk_solve", "--phase-solve": "phase_solve"}.get(
        " ".join(sys.argv[1:]))))
