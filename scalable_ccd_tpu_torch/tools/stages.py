"""Per-stage breakdown of one CCD frame.

Counterpart of the JAX package's ``tools/bench_stages.py`` and
``tools/hw_grid1000_stages.py``.  Run::

    python -m scalable_ccd_tpu_torch.tools.stages [grid] [subdiv] [--dtype float64]

on ``cloth_on_sphere(grid, subdiv, drop)`` (the bench scene by default).  It
times, per phase (VF, EE) where the stage has one:

- ``boxes_sort_planes``: box build, merge, sort and, under the congestion
  ordering, the partner planes;
- ``sweep_count_only``: kernel A walking and counting, writing no pair (the
  stream-only time);
- ``sweep_pairs``: kernel A emitting; its time less ``sweep_count_only``'s is
  what the atomic append costs;
- ``sweep_records``: kernel A';
- ``gather_pack``: the query gather and row packing of every candidate, in
  the main path's chunks (kernel C's pairs mode on CUDA, one launch per
  chunk of at most 2^20 rows, ``launches``), through ``NarrowSolver.pack``;
- ``records_pack``: the same rows packed straight from kernel A''s records,
  as ``sweep_impl="records"`` packs them: the pair prefix of the records and
  kernel C's records mode over the same chunks;
- ``solve``: kernel B over the main path's batches of 16,384 rows (column
  slices of the chunks), one unbounded global pass each,
  the running TOI threaded through VF and then EE; on CUDA one more,
  untimed pass reads each query's evaluation count and the line carries
  their spread (``checks_spread``, ``ops/solver.py:_checks_spread``; ``null``
  on the CPU);

and ``fused_ccd``, the whole frame at its defaults.  Every pair budget is
the power of two above the ``sweep_count_only`` total, never a constant.
Each stage runs once to warm up and then ``reps`` times; ``wall_ms`` is the
median host time of the whole stage, ending in a device synchronize, and
``device_ms`` the median time between CUDA events recorded around the same
work (``null`` on the CPU).  One JSON line per stage, with the scene, the
dtype, the device and the stage's counts.  ``device`` is as for the entry
points: CUDA unless the caller asks for the CPU.

``--kernel-b [--plain]`` measures kernel B alone on the rows the main path
gives it (:func:`run_kernel_b`), and then one launch over a whole phase's
pairs against the per-chunk launches over kernel C's columns it replaces on
frames of a million-triangle cloth (:func:`run_phase_launches`), on a CUDA
device::

    python -m scalable_ccd_tpu_torch.tools.stages --kernel-b --plain

``--kernel-a`` measures kernels A and A' alone in each mode and dtype on the
bench scene and grid-600, and the frames that use them (:func:`run_kernel_a`),
on a CUDA device; run from two trees in turns, it compares two kernels::

    python -m scalable_ccd_tpu_torch.tools.stages --kernel-a

``--frames`` measures whole frames on a CUDA device (:func:`run_frames`):
each frame's TOI bitwise, totals, host ms and kernel C's launches per
frame, the synchronizing calls of
one frame (:func:`count_syncs`) at two batch sizes, and the device idle
share of one bench frame (:func:`idle_share`).  It uses the entry points
alone, so the tool can time another tree's package, the one found first on
``PYTHONPATH``::

    PYTHONPATH=build/parent python scalable_ccd_tpu_torch/tools/stages.py --frames

``--escalation`` times the staged escalation at 128 rounds against none
(one unbounded pass per chunk, the defaults on CUDA) on the bench scene
(the frame pool) and grid-600 (the batch ladder), with each frame's device
time split by kernel and kernel B form
(:func:`run_escalation`); it too uses the entry points alone.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import re
import statistics
import time

import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry.aabb import (
    build_edge_boxes,
    build_face_boxes,
    build_vertex_boxes,
)
from scalable_ccd_tpu_torch.geometry.mesh import edges_from_faces, read_ply
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
from scalable_ccd_tpu_torch.ops import gather_pack, solver
from scalable_ccd_tpu_torch.ops.sweep_ap import ROW, partner_planes, sweep_pairs
from scalable_ccd_tpu_torch.ops.sweep_records import records_pair_prefix, sweep_records
from scalable_ccd_tpu_torch.pipeline.ccd import ccd
from scalable_ccd_tpu_torch.pipeline.fused import fused_ccd
from scalable_ccd_tpu_torch.pipeline.narrow import NARROW_BATCH, NarrowSolver
from scalable_ccd_tpu_torch.pipeline.policy import (
    mesh_tensors,
    pow2ceil,
    resolve_device,
    resolve_dtype,
    resolve_knobs,
)

__all__ = ["run_stages", "kernel_b_sets", "run_kernel_b", "run_phase_launches",
           "sliding_frame", "run_kernel_a", "run_frames", "run_escalation", "count_syncs",
           "idle_share", "main"]


def _timed(fn, reps: int, device: torch.device):
    """``(fn(), wall_ms, device_ms)``: one warm-up call, then the medians of
    ``reps`` calls; ``device_ms`` is ``None`` off CUDA."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = fn()
    sync()
    walls, devs = [], []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        if cuda:
            start.record()
        out = fn()
        if cuda:
            end.record()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            devs.append(start.elapsed_time(end))
    return out, statistics.median(walls), statistics.median(devs) if cuda else None


def run_stages(grid: int = 128, subdiv: int = 4, drop: float = 0.25,
               dtype="float32", device=None, reps: int = 3, emit=print) -> list:
    """Time the stages of one frame (module docstring); ``emit`` receives
    each stage's JSON line, and the list of the stages' dicts is returned."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    scene = cloth_on_sphere(grid_n=grid, sphere_subdiv=subdiv, drop=drop)
    v0, v1, e, f = mesh_tensors(scene.vertices_t0, scene.vertices_t1, scene.edges,
                                scene.faces, device, pca=False)
    knobs = resolve_knobs(v0.shape[0] + f.shape[0], e.shape[0],
                          plain_f32=dtype == torch.float32)
    any_order = knobs.bucket_minor
    common = {"scene": f"cloth_on_sphere({grid}, {subdiv}, drop={drop})",
              "dtype": str(dtype).removeprefix("torch."), "device": str(device),
              "bucket_minor": any_order, "reps": reps}
    out = []

    def stage(name, phase, fn, **counts):
        result, wall, dev = _timed(fn, reps, device)
        line = {"stage": name, "phase": phase, **common, "wall_ms": wall,
                "device_ms": dev, **{k: (v(result) if callable(v) else v)
                                     for k, v in counts.items()}}
        out.append(line)
        emit(json.dumps(line))
        return result

    def prepare(is_vf):
        vb = build_vertex_boxes(v0, v1, dtype=dtype)
        boxes = (merge_two_lists(vb, build_face_boxes(vb, f)) if is_vf
                 else build_edge_boxes(vb, e))
        sb = sort_boxes(boxes, bucket_minor=any_order)
        return sb, partner_planes(sb) if any_order else None

    toi = torch.ones((), dtype=dtype, device=device)
    for is_vf, phase in ((True, "vf"), (False, "ee")):
        sb, planes = stage("boxes_sort_planes", phase, lambda: prepare(is_vf),
                           boxes=lambda r: r[0].n)
        kw = {"any_order": any_order, "planes": planes}
        total = int(stage("sweep_count_only", phase,
                          lambda: sweep_pairs(sb, is_vf, count_only=True, **kw),
                          pairs=int))
        budget = pow2ceil(total)
        pairs = stage("sweep_pairs", phase, lambda: sweep_pairs(sb, is_vf, budget, **kw),
                      pairs=lambda r: int(r[2]), budget=budget)[0][:total]
        rec = stage("sweep_records", phase, lambda: sweep_records(sb, is_vf, budget, **kw),
                    pairs=lambda r: int(r[2]), records=lambda r: int(r[1]), budget=budget)

        nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, 0.0, 1e-6, True, -1, -1, dtype)
        chunk = gather_pack.chunk_rows(NARROW_BATCH)
        chunks = [(c, min(c + chunk, total)) for c in range(0, total, chunk)]
        packed = stage("gather_pack", phase,
                       lambda: [nar.pack(pairs, a, b) for a, b in chunks],
                       queries=lambda r: sum(c.shape[1] for c in r), launches=len(chunks))
        records, n_records = rec[0], int(rec[1])
        held = min(n_records, records.shape[0])

        def records_packed():
            cum = records_pair_prefix(records, held)
            return [gather_pack.gather_pack_records(sb, records, cum, a, b, nar.vcat,
                                                    nar.table, is_vf, nar.ms, nar.tolerance)
                    for a, b in chunks]

        stage("records_pack", phase, records_packed,
              queries=lambda r: sum(c.shape[1] for c in r), records=n_records,
              launches=len(chunks))
        rows = [p[:, s:s + NARROW_BATCH] for p in packed
                for s in range(0, p.shape[1], NARROW_BATCH)]
        valids = [torch.ones((r.shape[1],), dtype=torch.bool, device=device) for r in rows]

        def solve(toi=toi):
            checks = torch.zeros((), dtype=torch.int64, device=device)
            for r, v in zip(rows, valids):
                t, _, c = nar.solve_rows(r, v, toi)
                toi, checks = torch.minimum(toi, t), checks + c
            return toi, checks

        def spread(_, toi=toi):
            if device.type != "cuda" or not rows:
                return None
            planes = []
            for r, v in zip(rows, valids):
                t, *_, plane = solver._solve_query_checks(r.t(), v, is_vf, toi, 1e-6)
                toi = torch.minimum(toi, t)
                planes.append(plane)
            return solver._checks_spread(torch.cat(planes))

        toi = stage("solve", phase, solve, queries=total, batches=len(rows),
                    toi=lambda r: float(r[0]), checks=lambda r: int(r[1]),
                    checks_spread=spread)[0]

    stage("fused_ccd", None,
          lambda: fused_ccd(v0, v1, e, f, device=device, validate=False, dtype=dtype),
          toi=lambda r: float(r.toi), vf_total=lambda r: int(r.vf_total),
          ee_total=lambda r: int(r.ee_total), total_checks=lambda r: int(r.total_checks),
          overflowed=lambda r: bool(r.overflowed))
    return out


# ---- kernel B on the main path's rows -----------------------------------------

@contextlib.contextmanager
def _recorded_launches(calls, keep=lambda kw: True):
    """Append the inputs of every kernel B launch made inside the block to
    ``calls`` (copies, as :func:`scalable_ccd_tpu_torch.ops.solver.
    solve_cols`'s keywords plus ``cols``, contiguous ``(31, Q)`` columns,
    and ``valid``), those that ``keep`` accepts; launches with no valid
    row, and launches that ``skip_if_done`` stops, do no work and are left
    out.  A launch over pairs (:func:`scalable_ccd_tpu_torch.ops.solver.
    solve_pairs`) is recorded with kernel C's columns of its pairs, the
    rows it computes, and keeps its inputs under ``"pairs"``."""
    launch, launch_pairs = solver._launch, solver._launch_pairs

    def record(cols, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
               max_iterations, round_limit, widened, query_checks=False, skip_if_done=False):
        kw = {"is_vf": bool(is_vf), "tolerance": tolerance,
              "allow_zero_toi": bool(allow_zero_toi), "per_query": bool(per_query),
              "max_iterations": int(max_iterations), "round_limit": int(round_limit),
              "widened": bool(widened)}
        idle = not bool(valid.any()) or (skip_if_done and float(toi_init) <= 0)
        if keep(kw) and not idle:
            calls.append({"cols": cols.contiguous().clone(),
                          "valid": valid.clone(),
                          "toi_init": torch.as_tensor(toi_init).clone(), **kw})
        return launch(cols, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
                      max_iterations, round_limit, widened, query_checks, skip_if_done)

    def record_pairs(pairs, start, stop, vcat, table, is_vf, toi_init, ms, tolerance,
                     allow_zero_toi, max_iterations, compensated, skip_if_done):
        kw = {"is_vf": bool(is_vf), "tolerance": tolerance,
              "allow_zero_toi": bool(allow_zero_toi), "per_query": False,
              "max_iterations": int(max_iterations), "round_limit": -1,
              "widened": bool(compensated)}
        idle = stop <= start or (skip_if_done and float(toi_init) <= 0)
        if keep(kw) and not idle:
            ids = pairs[start:stop].clone()
            calls.append({"cols": gather_pack.gather_pack(ids, 0, stop - start, vcat, table,
                                                          is_vf, ms, tolerance, compensated),
                          "valid": torch.ones((stop - start,), dtype=torch.bool,
                                              device=pairs.device),
                          "toi_init": torch.as_tensor(toi_init).clone(),
                          "pairs": {"pairs": ids, "vcat": vcat, "table": table, "ms": ms,
                                    "compensated": bool(compensated)}, **kw})
        return launch_pairs(pairs, start, stop, vcat, table, is_vf, toi_init, ms, tolerance,
                            allow_zero_toi, max_iterations, compensated, skip_if_done)

    solver._launch, solver._launch_pairs = record, record_pairs
    try:
        yield calls
    finally:
        solver._launch, solver._launch_pairs = launch, launch_pairs


def _mode(call):
    if call["round_limit"] >= 0:
        return "round_limit"
    if call["per_query"]:
        return "per_query" if call["max_iterations"] < 0 else "bounded"
    return "global" if call["max_iterations"] < 0 else "bounded"


def kernel_b_sets(device=None) -> list:
    """``[(set, phase, mode, calls)]``: kernel B's launches on the main path,
    recorded from the frames that make them, grouped by phase and mode:

    - ``bench``: ``fused_ccd`` of the bench scene with escalation at 128
      rounds (the presample and the frame straggler pool: one
      ``round_limit`` pass per chunk, here each phase's candidates, then
      the pool's blocks of at most 2,048 rows, ``global``);
    - ``bench_unbounded``: the same frame with ``escalate_rounds=-1``, the
      defaults on CUDA (the presample's batch and each phase one ``global``
      pass, its rows here packed by kernel C);
    - ``grid600``: ``fused_ccd`` of ``cloth_on_sphere(600, 4)`` with
      escalation at 128 rounds (the batch ladder): each phase's first
      ``round_limit`` pass, over its first chunk of up to 2^20 rows, and the
      ladder's passes of its first four batches;
    - ``grid64_collisions``: ``fused_ccd(collisions=[])`` of
      ``cloth_on_sphere(64, 3)`` (``per_query``), and the same rows with
      ``max_iterations`` 10 and 100 (``bounded``, the IPC path's mode).

    A ``round_limit`` set is seeded with its frame's TOI, as the pool's
    passes are once the presample has found it: a pass whose shared TOI no
    other query lowers has one result, which its plain version reproduces.
    Every other launch keeps the running TOI the frame gave it."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("kernel_b_sets records kernel B launches: it needs a CUDA device")
    out = []

    def frame(name, scene, keep=lambda kw: True, **kw):
        s = cloth_on_sphere(*scene)
        v0, v1, e, f = mesh_tensors(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device,
                                    pca=False)
        with _recorded_launches([], keep) as calls:
            res = fused_ccd(v0, v1, e, f, device=device, validate=False, **kw)
        groups = {}
        for c in calls:
            if c["round_limit"] >= 0:
                c["toi_init"] = res.toi.clone()
            groups.setdefault(("vf" if c["is_vf"] else "ee", _mode(c)), []).append(c)
        out.extend((name, ph, mode, cs) for (ph, mode), cs in groups.items())

    frame("bench", (128, 4, 0.25), escalate_rounds=128)
    frame("bench_unbounded", (128, 4, 0.25), escalate_rounds=-1)
    passes = {}

    def first_batches(kw):
        # a phase's first round-limited pass (over its first chunk), and the
        # ladder's two passes after it for each of the first four batches
        key = (kw["is_vf"], kw["round_limit"] >= 0)
        passes[key] = passes.get(key, 0) + 1
        return passes[key] <= (1 if kw["round_limit"] >= 0 else 8)

    frame("grid600", (600, 4, 0.25), first_batches, escalate_rounds=128)
    frame("grid64_collisions", (64, 3, 0.25), collisions=[])
    for cap in (10, 100):
        out.extend(("grid64_collisions", ph, f"bounded{cap}",
                    [{**c, "max_iterations": cap} for c in cs])
                   for name, ph, mode, cs in list(out)
                   if name == "grid64_collisions" and mode == "per_query")
    return out


#: GPU cycles of the sleep queued ahead of a timed pass (~25 ms at 1.98 GHz)
_SLEEP_CYCLES = 50_000_000


def _events_ms(fn, reps):
    """Device milliseconds of one pass of ``fn``, the mean of ``reps``.
    Each pass is queued behind a GPU-side sleep long enough for the host to
    enqueue all of it, so the CUDA events measure the card's work and not
    the host's gaps between launches."""
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _solve_calls(fn, calls, rows=False):
    """``fn`` (a :func:`solver.solve_cols`-like call, or with ``rows`` a
    :func:`solver.solve_packed`-like one, given ``(Q, 31)`` views) on each
    recorded launch's inputs; the list of their outputs.  The kernel reads
    the recorded columns in place, so its times hold no copy."""
    return [fn(c["cols"].t() if rows else c["cols"], c["valid"], c["is_vf"], c["toi_init"],
               c["tolerance"], c["allow_zero_toi"], c["per_query"], c["max_iterations"],
               c["round_limit"], c["widened"]) for c in calls]


def _batched(calls, batch=NARROW_BATCH):
    """The recorded launches cut into launches of at most ``batch`` rows
    (column slices, read in place)."""
    return [{**c, "cols": c["cols"][:, s:s + batch], "valid": c["valid"][s:s + batch]}
            for c in calls for s in range(0, c["cols"].shape[1], batch)]


def run_kernel_b(device=None, reps=3, plain=False, emit=print) -> list:
    """Kernel B on each set of :func:`kernel_b_sets`: one JSON line per set,
    with its launches, rows, checks, TOI, the spread of the per-query
    checks (``ops/solver.py:_checks_spread``: mean, p50, p99, max, and the
    lane efficiency of warps of 32 queries and of 4) and ``ms``, the
    device time of one pass over the set (the mean of ``reps``, each pass
    behind a GPU sleep, the kernel reading the recorded columns in place);
    a ``round_limit`` set, recorded one launch per chunk, is also timed in
    launches of 16,384 rows (``ms_batches``).  With ``plain`` the plain
    version runs once on the same inputs (``plain_ms``, ``plain_checks``),
    and the line says whether they agree (``equal``): every TOI bitwise,
    and where the order fixes them (``round_limit`` seeded, bounded
    per-query) the checks and the unfinished rows; ``least_checks`` (``ops/solver.py:_least_checks``) is
    the work of an unbounded set that any order must do."""
    lines = []
    for name, ph, mode, calls in kernel_b_sets(device):
        outs = _solve_calls(solver._solve_query_checks, calls, rows=True)
        plane = torch.cat([o[-1] for o in outs])
        line = {"set": name, "phase": ph, "mode": mode, "launches": len(calls),
                "queries": int(plane.numel()), "checks": sum(int(o[2]) for o in outs),
                "spread": solver._checks_spread(plane),
                "ms": _events_ms(lambda: _solve_calls(solver.solve_cols, calls), reps),
                "toi": min(float(o[0]) for o in outs),
                "overflow": any(bool(o[1]) for o in outs)}
        if mode == "round_limit":
            line["unfinished"] = sum(int(o[3].sum()) for o in outs)
            line["ms_batches"] = _events_ms(
                lambda: _solve_calls(solver.solve_cols, _batched(calls)), reps)
        if plain:
            line.update(_against_plain(calls, mode, outs))
        lines.append(line)
        emit(json.dumps(line))
    return lines


def _against_plain(calls, mode, outs):
    """The plain version once on the same inputs: its time and checks, and
    the equalities the kernel must meet (:func:`run_kernel_b`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = _solve_calls(solver.solve_packed_reference, calls, rows=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal = all(float(k[0]) == float(p[0]) for k, p in zip(outs, ref))
    if len(ref[0]) > 3:  # per-query TOIs or unfinished rows
        equal &= all(torch.equal(k[3], p[3]) for k, p in zip(outs, ref))
    if mode != "global" and mode != "per_query":
        equal &= all(int(k[2]) == int(p[2]) for k, p in zip(outs, ref))
    out = {"plain_ms": plain_ms, "plain_checks": sum(int(p[2]) for p in ref),
           "equal": bool(equal)}
    if mode in ("global", "per_query"):
        out["least_checks"] = sum(
            solver._least_checks(c["cols"].t(), c["valid"], c["is_vf"], p[0], c["tolerance"],
                                 p[3] if mode == "per_query" else None,
                                 c["allow_zero_toi"], c["widened"])
            for c, p in zip(calls, ref))
    return out


#: the frames of :func:`run_phase_launches`: ``(grid_n, lift)`` of
#: :func:`sliding_frame` at the ``million`` cell's size (506,662 vertices):
#: raised clear of the sphere (TOI 1), and moving into it
_PHASE_FRAMES = {"million_clear": (710, 0.9), "million_contact": (710, 0.0)}


def sliding_frame(grid_n: int, lift: float = 0.0):
    """``cloth_on_sphere(grid_n, 4, drop=0.25)`` whose cloth also slides
    (2.5, 1.5) grid spacings sideways in the step and is raised by ``lift``
    at t=0 and t=1, the motion of the benchmark's cloth cells: a sliding
    cloth's boxes overlap those of the cells it passes, about 14 VF
    candidates a VF box and 35 EE candidates an edge.  Numpy ``(v0, v1,
    edges, faces)``."""
    s = cloth_on_sphere(grid_n=grid_n, sphere_subdiv=4, drop=0.25)
    v0, v1 = s.vertices_t0.copy(), s.vertices_t1.copy()
    cloth = grid_n * grid_n
    spacing = 2.4 / (grid_n - 1)
    v0[:cloth, 1] += lift
    v1[:cloth, 1] += lift
    v1[:cloth, 0] += 2.5 * spacing
    v1[:cloth, 2] += 1.5 * spacing
    return v0, v1, s.edges, s.faces


def run_phase_launches(device=None, reps=3, emit=print) -> list:
    """Kernel B's unbounded shared form on whole phases of
    :data:`_PHASE_FRAMES`: one JSON line per frame and phase.  ``fused_ccd``
    at its defaults solves each phase in one launch over its pairs, the
    rows computed in the kernel; that launch is recorded and timed
    (``phase_ms``) against what it replaces, one launch over the columns of
    each chunk of at most 2^20 rows (kernel C's, packed beforehand), each
    seeded with the TOI the chunks before it leave: each such launch alone
    (``chunk_ms``, against ``chunk_rows``) and all in turn (``chunks_ms``).
    ``straggler_ms``, ``(sum(chunk_ms) - phase_ms) / (chunks - 1)``, is what
    each launch past the first adds: the part of a launch that does not
    grow with its rows (the deepest query's chain, a straggler), and on a
    frame in contact also the pruning that one launch shares across the
    phase (null for a phase of one chunk).  Device ms behind a GPU
    sleep, the mean of ``reps``; ``equal``: the two paths' TOIs bit for bit
    and their overflow flags equal."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run_phase_launches times kernel B launches: it needs a CUDA device")
    lines = []
    for name, (grid_n, lift) in _PHASE_FRAMES.items():
        v0, v1, e, f = mesh_tensors(*sliding_frame(grid_n, lift), device, pca=False)
        with _recorded_launches([]) as calls:
            fused_ccd(v0, v1, e, f, device=device, validate=False)
        for c in (c for c in calls if "pairs" in c):
            lines.append(_phase_line(name, c, reps))
            emit(json.dumps(lines[-1]))
        del calls
        torch.cuda.empty_cache()
    return lines


def _phase_line(frame, c, reps):
    """One line of :func:`run_phase_launches` for the recorded phase
    launch ``c``."""
    p = c["pairs"]
    ids, n, is_vf, comp = p["pairs"], c["cols"].shape[1], c["is_vf"], p["compensated"]
    chunk = gather_pack.CHUNK_ROWS
    spans = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]

    def phase():
        return solver.solve_pairs(ids, 0, n, p["vcat"], p["table"], is_vf, c["toi_init"],
                                  p["ms"], c["tolerance"], c["allow_zero_toi"], -1, comp)

    def one_chunk(a, b, seed):
        return solver.solve_cols(c["cols"][:, a:b], c["valid"][a:b], is_vf, seed,
                                 c["tolerance"], c["allow_zero_toi"], widened=comp)

    seeds, toi, ovf = [], c["toi_init"], False
    for a, b in spans:
        seeds.append(toi)
        out = one_chunk(a, b, toi)
        toi, ovf = torch.minimum(toi, out[0].to(toi.dtype)), ovf or bool(out[1])
    whole = phase()
    chunk_ms = [_events_ms(lambda: one_chunk(a, b, t), reps) for (a, b), t in zip(spans, seeds)]
    phase_ms = _events_ms(phase, reps)
    chunks_ms = _events_ms(lambda: [one_chunk(a, b, t) for (a, b), t in zip(spans, seeds)], reps)
    k = len(spans)
    return {"set": "phase_launch", "frame": frame, "phase": "vf" if is_vf else "ee",
            "rows": n, "chunks": k, "phase_ms": phase_ms, "chunks_ms": chunks_ms,
            "chunk_rows": [b - a for a, b in spans], "chunk_ms": chunk_ms,
            "straggler_ms": (sum(chunk_ms) - phase_ms) / (k - 1) if k > 1 else None,
            "toi": float(whole[0]), "overflow": bool(whole[1]) or ovf,
            "equal": float(whole[0]) == float(toi) and bool(whole[1]) == ovf}


# ---- kernel A alone, and the frames that use it ------------------------------------

#: the scenes of run_kernel_a: ``cloth_on_sphere`` arguments
_KERNEL_A_SCENES = {"bench": (128, 4, 0.25), "grid600": (600, 4, 0.25)}
_FRAME_SCENES = {**_KERNEL_A_SCENES, "grid384": (384, 5, 0.25)}
#: the golden scene whose f32 TOI collapses to 0 (the narrow loop's exit),
#: in the repo's test data
_DENSE_CLUSTER = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                              os.pardir, "tests", "golden", "dense-cluster", "frames")
#: run_frames' dense-cluster frames: at the default batch the scene is one
#: batch a phase; at 256 the TOI reaches 0 in the sixth EE batch of 15
_DENSE_CLUSTER_FRAMES = {
    "float32": {}, "float32_records": {"sweep_impl": "records"},
    "float32_b256": {"narrow_batch": 256},
    "float32_records_b256": {"sweep_impl": "records", "narrow_batch": 256},
    "float32_ladder_b256": {"escalate_pool": "batch", "narrow_batch": 256},
    "float32_unbounded_b256": {"escalate_rounds": -1, "narrow_batch": 256},
}


def _phase_boxes(v0, v1, e, f, dtype):
    vb = build_vertex_boxes(v0, v1, dtype=dtype)
    return {"vf": (True, merge_two_lists(vb, build_face_boxes(vb, f))),
            "ee": (False, build_edge_boxes(vb, e))}


def _keys_sum(pairs, n):
    """The sum of the pairs' 64-bit keys, a digest of the pair set that
    does not depend on the row order."""
    p = pairs[: int(n)].to(torch.int64)
    return int((p[:, 0] * (1 << 32) + p[:, 1]).sum())


def _records_sum(records, n):
    """A digest of the first ``n`` records as a multiset: the sum over
    records of their ``(r, j)`` key and mask words, mixed (int64 sums wrap
    the same way in any order)."""
    r = records[: int(n)].to(torch.int64)
    words = (r[:, :4] & 0xFFFFFFFF) * torch.tensor([1, 3, 5, 7], device=r.device)
    return int(((r[:, 5] * (1 << 32) + r[:, 4]) * 1_000_003 + words.sum(dim=1)).sum())


def run_kernel_a(device=None, reps=5, emit=print) -> list:
    """Kernels A and A' alone, then the frames that use them, on a CUDA
    device.

    Per scene of ``_KERNEL_A_SCENES``, dtype (f32, f64) and phase, one JSON
    line per mode: kernel A's ``whole`` (the major sort), ``range`` (ranged
    launches over chunks of 2^15 boxes, summed), ``any_order`` (the
    congestion ordering), ``count_only`` and ``count_only_any_order``, and
    kernel A''s ``records`` (the major sort) and ``records_any_order``, and
    where ``sweep_records`` takes a ``row_range``, ``records_range`` and
    ``records_range_any_order`` (four ranged launches that partition the
    a-rows, as four ranks of ``sharded_ccd`` cut them, with the digest of
    their union); ``ms`` is the device time of one pass (:func:`_events_ms`), ``pairs``
    the exact total, ``records`` kernel A''s record total and ``keys_sum``
    a digest of the pair set or record multiset.  Then per scene of
    ``_FRAME_SCENES``, dtype and ``sweep_impl`` (``"pairs"``, the default,
    and ``"records"``), ``fused_ccd``: the TOI (and its ``float.hex``),
    totals, checks and the median host ms per frame of ``reps`` after a
    warm-up; and ``ccd()`` on the bench scene in f32.  Only the contracts of
    ``sweep_pairs`` and ``sweep_records`` are used, so a tree with other
    kernels behind them is timed the same way."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run_kernel_a times CUDA kernels: it needs a CUDA device")
    lines = []

    def out(**line):
        lines.append(line)
        emit(json.dumps(line))

    chunk = 1 << 15
    ranged_records = "row_range" in inspect.signature(sweep_records).parameters
    for name, args in _KERNEL_A_SCENES.items():
        s = cloth_on_sphere(*args)
        v0, v1, e, f = mesh_tensors(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device,
                                    pca=False)
        for dtype in (torch.float32, torch.float64):
            for ph, (two, boxes) in _phase_boxes(v0, v1, e, f, dtype).items():
                major, bucket = sort_boxes(boxes), sort_boxes(boxes, bucket_minor=True)
                planes = partner_planes(bucket)
                total = int(sweep_pairs(major, two, count_only=True))
                budget = pow2ceil(total)
                ranges = [(b, min(b + chunk, major.n)) for b in range(0, major.n, chunk)]
                modes = {
                    "whole": lambda: [sweep_pairs(major, two, budget)],
                    "range": lambda: [sweep_pairs(major, two, budget, box_range=r)
                                      for r in ranges],
                    "any_order": lambda: [sweep_pairs(bucket, two, budget, any_order=True,
                                                      planes=planes)],
                    "count_only": lambda: [sweep_pairs(major, two, count_only=True)],
                    "count_only_any_order": lambda: [sweep_pairs(
                        bucket, two, any_order=True, planes=planes, count_only=True)],
                    "records": lambda: [sweep_records(major, two, budget)],
                    "records_any_order": lambda: [sweep_records(
                        bucket, two, budget, any_order=True, planes=planes)],
                }
                # the ranged pass keeps no pair buffer alive, as the
                # chunked ccd() keeps none
                timed = {"range": lambda: [sweep_pairs(major, two, budget, box_range=r)[2]
                                           for r in ranges]}
                if ranged_records:
                    rows = -(-major.n // ROW)
                    per = -(-rows // 4)
                    parts = [(min(k * per, rows), min((k + 1) * per, rows)) for k in range(4)]
                    modes["records_range"] = lambda: [
                        sweep_records(major, two, budget, row_range=r) for r in parts]
                    modes["records_range_any_order"] = lambda: [
                        sweep_records(bucket, two, budget, any_order=True, planes=planes,
                                      row_range=r) for r in parts]
                for mode, fn in modes.items():
                    res = fn()
                    extra = {}
                    if mode.startswith("count_only"):
                        pairs, keys = int(res[0]), None
                    elif mode.startswith("records"):
                        rec = torch.cat([r[0][: int(r[1])] for r in res])
                        n_rec, pairs = rec.shape[0], sum(int(r[2]) for r in res)
                        keys = _records_sum(rec, n_rec)
                        extra = {"records": n_rec, "overflowed": any(bool(r[3]) for r in res)}
                    else:
                        pairs = sum(int(r[2]) for r in res)
                        keys = sum(_keys_sum(r[0], r[1]) for r in res)
                    kernel = "sweep_records" if mode.startswith("records") else "sweep_pairs"
                    out(kernel=kernel, scene=name, dtype=str(dtype)[6:], phase=ph,
                        mode=mode, boxes=major.n, launches=len(res), pairs=pairs,
                        keys_sum=keys, **extra, ms=_events_ms(timed.get(mode, fn), reps))
    for name, args in _FRAME_SCENES.items():
        s = cloth_on_sphere(*args)
        v0, v1, e, f = mesh_tensors(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device,
                                    pca=False)
        for dtype in (torch.float32, torch.float64):
            for impl in ("pairs", "records"):
                res, wall, _ = _timed(
                    lambda: fused_ccd(v0, v1, e, f, device=device, validate=False,
                                      dtype=dtype, sweep_impl=impl),
                    reps, device)
                out(frame="fused_ccd", scene=name, dtype=str(dtype)[6:], sweep_impl=impl,
                    toi=float(res.toi), toi_hex=float(res.toi).hex(),
                    vf_total=int(res.vf_total), ee_total=int(res.ee_total),
                    total_checks=int(res.total_checks), overflowed=bool(res.overflowed),
                    ms=wall)
    s = cloth_on_sphere(*_KERNEL_A_SCENES["bench"])
    v0, v1, e, f = mesh_tensors(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device,
                                pca=False)
    toi, wall, _ = _timed(lambda: ccd(v0, v1, e, f, device=device, validate=False), reps,
                          device)
    out(frame="ccd", scene="bench", dtype="float32", toi=float(toi), toi_hex=float(toi).hex(),
        ms=wall)
    return lines


# ---- whole frames: TOIs, host syncs and the device idle share --------------------------

def _package_site(filename: str, lineno: int):
    """``"pkg/.../file.py:line"`` for a file of the package outside its
    ``tools/``, from the package's last occurrence in the path, else
    ``None``."""
    pkg = fused_ccd.__module__.split(".")[0]
    parts = os.path.normpath(filename).split(os.sep)
    if pkg not in parts:
        return None
    rel = parts[len(parts) - 1 - parts[::-1].index(pkg):]
    return None if rel[1:2] == ["tools"] else f"{'/'.join(rel)}:{lineno}"


def count_syncs(fn):
    """``(fn(), n, sites)``: the synchronizing CUDA calls ``fn`` makes (host
    reads of device values, blocking copies), counted from the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``; ``sites`` counts them by
    the innermost ``file:line`` of the package on the Python stack outside
    its ``tools/``, in whichever tree the package was imported from."""
    import traceback
    import warnings

    sites = {}

    def seen(message, *_args, **_kw):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        inner = [s for s in (_package_site(f.filename, f.lineno)
                             for f in traceback.extract_stack()[:-1]) if s]
        key = inner[-1] if inner else "outside the package"
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum(sites.values()), sites


def idle_share(fn, label="sccd_frame"):
    """``(fn(), stats)``: one call of ``fn`` traced with ``torch.profiler``,
    ending in a device synchronize.  ``stats``: the call's span (host ms,
    from the ``label`` range), the device's busy ms in it (the union of its
    kernels, copies and fills) and ``idle_share``, ``1 - busy / span``;
    ``None`` values if the trace holds no device event.  The profiler adds
    host time to every op, so the share is that of a traced frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            out = fn()
            torch.cuda.synchronize()
    events = prof.events()
    span = [e.time_range for e in events if e.name == label and e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != label]
    busy = sorted((e.time_range.start, e.time_range.end) for e in device)
    by_kernel = {}
    for e in device:
        group = by_kernel.setdefault(_kernel_group(e.name), {"ms": 0.0, "events": 0})
        group["ms"] += (e.time_range.end - e.time_range.start) / 1e3
        group["events"] += 1
    if not span or not busy:
        return out, {"span_ms": None, "device_busy_ms": None, "idle_share": None,
                     "device_events": len(busy), "by_kernel": by_kernel}
    t0, t1 = span[0].start, span[0].end
    total, end = 0.0, t0
    for a, b in busy:
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return out, {"span_ms": (t1 - t0) / 1e3, "device_busy_ms": total / 1e3,
                 "idle_share": 1.0 - total / (t1 - t0), "device_events": len(busy),
                 "by_kernel": by_kernel}


def _kernel_group(name: str) -> str:
    """The port kernel, or kernel B form, that a traced device event belongs
    to: ``kernel_b_one_thread`` (the bounded and round-limited passes),
    ``kernel_b_shared`` (the unbounded modes), ``kernel_c``, ``kernel_a``
    (kernels A and A'), else ``torch`` (PyTorch's own kernels, copies and
    fills).  Reads both the current kernel names and the older
    ``solve_kernel<T, IS_VF, PER_QUERY, SHARE>`` instantiation."""
    if "solve_lane_kernel" in name:
        return "kernel_b_one_thread"
    m = re.search(r"solve_kernel<([^>]*)>", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        return "kernel_b_one_thread" if args[3:4] == ["false"] else "kernel_b_shared"
    if "gather_pack_kernel" in name:
        return "kernel_c"
    if "sweep" in name or "units_kernel" in name:
        return "kernel_a"
    return "torch"


def run_frames(device=None, reps=5, emit=print) -> list:
    """Whole frames on a CUDA device, one JSON line each.  Per scene of
    ``_FRAME_SCENES``, ``fused_ccd`` at its defaults with ``sweep_impl``
    ``"pairs"`` and ``"records"`` (and on the bench scene in f64 and
    compensated): the TOI and its ``float.hex``, totals, checks,
    ``overflowed``, ``solver_capped``, the median host ms of ``reps``
    frames after a warm-up and kernel C's launches per frame; ``ccd()`` on
    the bench scene; the synchronizing
    calls of one frame (:func:`count_syncs`) of the bench scene and grid-600
    at ``narrow_batch`` 16,384 and 4,096, after a warm-up frame; the idle
    share of one bench frame (:func:`idle_share`); the golden
    ``dense-cluster`` scene's frames (``_DENSE_CLUSTER_FRAMES``), timed and
    with the syncs of each, where the repo's test data is at hand."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run_frames times CUDA frames: it needs a CUDA device")
    lines = []

    def out(**line):
        lines.append(line)
        emit(json.dumps(line))

    def timed_frame(frame, **kw):
        """``_timed`` of ``frame(**kw)``, with kernel C's launches per frame
        (all of them, and those of its records mode where the tree has
        one)."""
        counts = gather_pack.LAUNCHES_BY_MODE
        before = (counts.total, counts.get("records", 0))
        res, wall, _ = _timed(lambda: frame(**kw), reps, device)
        n = reps + 1
        return res, wall, {"kernel_c_launches": (counts.total - before[0]) // n,
                           "kernel_c_records_launches": (counts.get("records", 0)
                                                         - before[1]) // n}

    def result(res):
        return {"toi": float(res.toi), "toi_hex": float(res.toi).hex(),
                "vf_total": int(res.vf_total), "ee_total": int(res.ee_total),
                "total_checks": int(res.total_checks), "overflowed": bool(res.overflowed),
                "solver_capped": bool(res.solver_capped)}

    for name, args in _FRAME_SCENES.items():
        s = cloth_on_sphere(*args)
        v0, v1, e, f = mesh_tensors(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device,
                                    pca=False)

        def frame(**kw):
            return fused_ccd(v0, v1, e, f, device=device, validate=False, **kw)

        variants = {"float32": {}, "float32_records": {"sweep_impl": "records"}}
        if name == "bench":
            variants.update(float64={"dtype": torch.float64},
                            compensated={"precision": "compensated"})
        for label, kw in variants.items():
            res, wall, launches = timed_frame(frame, **kw)
            out(frame="fused_ccd", scene=name, variant=label, **result(res), ms=wall,
                **launches)
        if name in ("bench", "grid600"):
            for batch in (NARROW_BATCH, NARROW_BATCH >> 2):
                frame(narrow_batch=batch)
                res, n, sites = count_syncs(lambda: frame(narrow_batch=batch))
                out(frame="syncs", scene=name, narrow_batch=batch, syncs=n, sites=sites,
                    **result(res))
        if name == "bench":
            frame()
            res, stats = idle_share(frame)
            out(frame="idle_share", scene=name, **stats, **result(res))
            toi, wall, _ = _timed(lambda: ccd(v0, v1, e, f, device=device, validate=False),
                                  reps, device)
            out(frame="ccd", scene=name, variant="float32", toi=float(toi),
                toi_hex=float(toi).hex(), ms=wall)
    if os.path.isdir(_DENSE_CLUSTER):
        v0, f = read_ply(os.path.join(_DENSE_CLUSTER, "f0.ply"))
        v1, _ = read_ply(os.path.join(_DENSE_CLUSTER, "f1.ply"))
        v0, v1, e, f = mesh_tensors(v0, v1, edges_from_faces(f), f, device, pca=False)
        for label, kw in _DENSE_CLUSTER_FRAMES.items():
            def frame(kw=kw):
                return fused_ccd(v0, v1, e, f, device=device, validate=False, **kw)

            res, wall, launches = timed_frame(frame)
            _, n, sites = count_syncs(frame)
            out(frame="fused_ccd", scene="dense_cluster", variant=label, **result(res), ms=wall,
                syncs=n, sites=sites, **launches)
    return lines


#: run_escalation's scenes: the frame pool's (bench) and the batch ladder's
#: (grid-600, the congestion ordering)
_ESCALATION_SCENES = {"bench": (128, 4, 0.25), "grid600": (600, 4, 0.25)}


def run_escalation(device=None, reps=5, emit=print) -> list:
    """The staged escalation against no escalation, on a CUDA device, one
    JSON line per scene of ``_ESCALATION_SCENES`` and variant: ``fused_ccd``
    with ``escalate_rounds=128`` (the bench scene's frame pool, grid-600's
    batch ladder) and with ``escalate_rounds=-1`` (the defaults on CUDA:
    one launch per phase), timed in turns (escalated, unbounded, unbounded,
    escalated; each turn the median host ms of ``reps`` frames after a
    warm-up), with the TOI's ``float.hex``, the
    totals, kernel B's launches per frame by mode and one traced frame
    (:func:`idle_share`), whose ``by_kernel`` splits the device time between
    kernel B's one-thread form (the round-limited passes), its shared form
    (the solve-now, pool and ladder passes), kernels C and A and PyTorch.
    It uses the entry points and kernel B's launch counters alone, so it
    can time another tree's package (``PYTHONPATH``)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run_escalation times CUDA frames: it needs a CUDA device")
    lines = []
    variants = {"escalated": {"escalate_rounds": 128}, "unbounded": {"escalate_rounds": -1}}
    for name, args in _ESCALATION_SCENES.items():
        s = cloth_on_sphere(*args)
        v0, v1, e, f = mesh_tensors(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device,
                                    pca=False)

        def frame(kw):
            return fused_ccd(v0, v1, e, f, device=device, validate=False, **kw)

        ms = {label: [] for label in variants}
        launches = {}
        for label in ("escalated", "unbounded", "unbounded", "escalated"):
            before = dict(solver.LAUNCHES_BY_MODE)
            res, wall, _ = _timed(lambda: frame(variants[label]), reps, device)
            ms[label].append(wall)
            launches[label] = {k: (v - before[k]) // (reps + 1)
                               for k, v in solver.LAUNCHES_BY_MODE.items() if v > before[k]}
        for label, kw in variants.items():
            frame(kw)
            res, stats = idle_share(lambda: frame(kw))
            line = {"frame": "escalation", "scene": name, "variant": label, "ms": ms[label],
                    "kernel_b_launches": launches[label], "toi": float(res.toi),
                    "toi_hex": float(res.toi).hex(), "vf_total": int(res.vf_total),
                    "ee_total": int(res.ee_total), "total_checks": int(res.total_checks),
                    "overflowed": bool(res.overflowed),
                    "solver_capped": bool(res.solver_capped), **stats}
            lines.append(line)
            emit(json.dumps(line))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("grid", nargs="?", type=int, default=128)
    ap.add_argument("subdiv", nargs="?", type=int, default=4)
    ap.add_argument("--drop", type=float, default=0.25)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--device", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--kernel-b", action="store_true",
                    help="kernel B alone on the main path's rows (CUDA only)")
    ap.add_argument("--plain", action="store_true",
                    help="with --kernel-b: the plain version on the same inputs, compared")
    ap.add_argument("--kernel-a", action="store_true",
                    help="kernels A and A' alone in every mode and dtype, and their frames "
                         "(CUDA only)")
    ap.add_argument("--escalation", action="store_true",
                    help="the staged escalation against unbounded frames, with device ms "
                         "by kernel (CUDA only)")
    ap.add_argument("--frames", action="store_true",
                    help="whole frames: TOIs, host ms, syncs per frame and the idle share "
                         "(CUDA only)")
    a = ap.parse_args(argv)
    if a.escalation:
        lines = run_escalation(a.device, a.reps)
        return 0 if not any(o["overflowed"] for o in lines) else 1
    if a.frames:
        lines = run_frames(a.device, a.reps)
        return 0 if not any(o.get("overflowed") for o in lines) else 1
    if a.kernel_a:
        lines = run_kernel_a(a.device, a.reps)
        return 0 if not any(o.get("overflowed") for o in lines) else 1
    if a.kernel_b:
        lines = run_kernel_b(a.device, a.reps, a.plain)
        lines += run_phase_launches(a.device, a.reps)
        return 0 if all(o.get("equal", True) and not o["overflow"] for o in lines) else 1
    run_stages(a.grid, a.subdiv, a.drop, a.dtype, a.device, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
