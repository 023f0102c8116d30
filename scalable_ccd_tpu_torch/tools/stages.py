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
- ``sweep_records`` and ``sweep_records_decode``: kernel A', alone and with
  the decode of every pair;
- ``gather_pack``: the query gather and row packing of every candidate, in
  the main path's narrow batches;
- ``solve``: kernel B over those batches, one unbounded global pass each,
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
gives it (:func:`run_kernel_b`), on a CUDA device::

    python -m scalable_ccd_tpu_torch.tools.stages --kernel-b --plain
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry.aabb import (
    build_edge_boxes,
    build_face_boxes,
    build_vertex_boxes,
)
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
from scalable_ccd_tpu_torch.ops import solver
from scalable_ccd_tpu_torch.ops.sweep_ap import partner_planes, sweep_pairs
from scalable_ccd_tpu_torch.ops.sweep_records import (
    decode_records_range,
    records_pair_prefix,
    sweep_records,
)
from scalable_ccd_tpu_torch.pipeline.fused import (
    _NARROW_BATCH,
    NarrowSolver,
    _pow2ceil,
    fused_ccd,
    mesh_tensors,
    resolve_device,
    resolve_dtype,
    resolve_knobs,
)

__all__ = ["run_stages", "kernel_b_sets", "run_kernel_b", "main"]


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
        budget = _pow2ceil(total)
        pairs = stage("sweep_pairs", phase, lambda: sweep_pairs(sb, is_vf, budget, **kw),
                      pairs=lambda r: int(r[2]), budget=budget)[0][:total]
        rec = stage("sweep_records", phase, lambda: sweep_records(sb, is_vf, budget, **kw),
                    pairs=lambda r: int(r[2]), records=lambda r: int(r[1]), budget=budget)

        def records_decoded():
            records, n_records, n_pairs, _ = sweep_records(sb, is_vf, budget, **kw)
            cum = records_pair_prefix(records, n_records)
            return decode_records_range(sb, records, cum, 0, int(n_pairs), 0, is_vf)[0]

        stage("sweep_records_decode", phase, records_decoded, pairs=lambda r: r.shape[0],
              records=int(rec[1]))

        nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, 0.0, 1e-6, True, -1, -1, dtype)
        cuts = range(0, total, _NARROW_BATCH)
        rows = stage("gather_pack", phase,
                     lambda: [nar.rows(pairs[s:s + _NARROW_BATCH]) for s in cuts],
                     queries=total, batches=len(cuts))
        valids = [torch.ones((r.shape[0],), dtype=torch.bool, device=device) for r in rows]

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
                t, *_, plane = solver._solve_query_checks(r, v, is_vf, toi, 1e-6)
                toi = torch.minimum(toi, t)
                planes.append(plane)
            return solver._checks_spread(torch.cat(planes))

        toi = stage("solve", phase, solve, queries=total, batches=len(cuts),
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
    solve_packed`'s keywords plus ``qrows`` and ``valid``), those that
    ``keep`` accepts."""
    launch = solver._launch

    def record(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
               max_iterations, round_limit, widened, query_checks=False):
        kw = {"is_vf": bool(is_vf), "tolerance": tolerance,
              "allow_zero_toi": bool(allow_zero_toi), "per_query": bool(per_query),
              "max_iterations": int(max_iterations), "round_limit": int(round_limit),
              "widened": bool(widened)}
        if keep(kw):
            calls.append({"qrows": qrows.clone(), "valid": valid.clone(),
                          "toi_init": torch.as_tensor(toi_init).clone(), **kw})
        return launch(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
                      max_iterations, round_limit, widened, query_checks)

    solver._launch = record
    try:
        yield calls
    finally:
        solver._launch = launch


def _mode(call):
    if call["round_limit"] >= 0:
        return "round_limit"
    if call["per_query"]:
        return "per_query" if call["max_iterations"] < 0 else "bounded"
    return "global" if call["max_iterations"] < 0 else "bounded"


def kernel_b_sets(device=None) -> list:
    """``[(set, phase, mode, calls)]``: kernel B's launches on the main path,
    recorded from the frames that make them, grouped by phase and mode:

    - ``bench``: ``fused_ccd`` of the bench scene at its defaults (the
      presample and the frame straggler pool: 16,384-row ``round_limit``
      passes, then the pool's blocks of at most 2,048 rows, ``global``);
    - ``bench_unbounded``: the same frame with ``escalate_rounds=-1`` (every
      batch one ``global`` pass);
    - ``grid600``: ``fused_ccd`` of ``cloth_on_sphere(600, 4)`` at its
      defaults (the batch ladder), the launches of each phase's first four
      batches;
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

    frame("bench", (128, 4, 0.25))
    frame("bench_unbounded", (128, 4, 0.25), escalate_rounds=-1)
    passes = {True: 0, False: 0}

    def first_batches(kw):
        # a batch is one round-limited pass and the ladder's solves after it
        passes[kw["is_vf"]] += kw["round_limit"] >= 0
        return passes[kw["is_vf"]] <= 4

    frame("grid600", (600, 4, 0.25), first_batches)
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


def _solve_calls(fn, calls):
    """``fn`` (a :func:`solver.solve_packed`-like call) on each recorded
    launch's inputs; the list of their outputs."""
    return [fn(c["qrows"], c["valid"], c["is_vf"], c["toi_init"], c["tolerance"],
               c["allow_zero_toi"], c["per_query"], c["max_iterations"], c["round_limit"],
               c["widened"]) for c in calls]


def run_kernel_b(device=None, reps=3, plain=False, emit=print) -> list:
    """Kernel B on each set of :func:`kernel_b_sets`: one JSON line per set,
    with its launches, rows, checks, TOI, the spread of the per-query
    checks (``ops/solver.py:_checks_spread``: mean, p50, p99, max, and the
    lane efficiency of warps of 32 queries and of 4) and ``ms``, the
    device time of one pass over the set (the mean of ``reps``, each pass
    behind a GPU sleep).  With ``plain`` the plain version runs once on the
    same inputs (``plain_ms``, ``plain_checks``), and the line says whether
    they agree (``equal``): every TOI bitwise, and where the order fixes
    them (``round_limit`` seeded, bounded per-query) the checks and the
    unfinished rows; ``least_checks`` (``ops/solver.py:_least_checks``) is
    the work of an unbounded set that any order must do."""
    lines = []
    for name, ph, mode, calls in kernel_b_sets(device):
        outs = _solve_calls(solver._solve_query_checks, calls)
        plane = torch.cat([o[-1] for o in outs])
        line = {"set": name, "phase": ph, "mode": mode, "launches": len(calls),
                "queries": int(plane.numel()), "checks": sum(int(o[2]) for o in outs),
                "spread": solver._checks_spread(plane),
                "ms": _events_ms(lambda: _solve_calls(solver.solve_packed, calls), reps),
                "toi": min(float(o[0]) for o in outs),
                "overflow": any(bool(o[1]) for o in outs)}
        if mode == "round_limit":
            line["unfinished"] = sum(int(o[3].sum()) for o in outs)
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
    ref = _solve_calls(solver.solve_packed_reference, calls)
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
            solver._least_checks(c["qrows"], c["valid"], c["is_vf"], p[0], c["tolerance"],
                                 p[3] if mode == "per_query" else None,
                                 c["allow_zero_toi"], c["widened"])
            for c, p in zip(calls, ref))
    return out


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
    a = ap.parse_args(argv)
    if a.kernel_b:
        lines = run_kernel_b(a.device, a.reps, a.plain)
        return 0 if all(o.get("equal", True) and not o["overflow"] for o in lines) else 1
    run_stages(a.grid, a.subdiv, a.drop, a.dtype, a.device, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
