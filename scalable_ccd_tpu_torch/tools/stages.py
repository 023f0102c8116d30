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
  the running TOI threaded through VF and then EE;

and ``fused_ccd``, the whole frame at its defaults.  Every pair budget is
the power of two above the ``sweep_count_only`` total, never a constant.
Each stage runs once to warm up and then ``reps`` times; ``wall_ms`` is the
median host time of the whole stage, ending in a device synchronize, and
``device_ms`` the median time between CUDA events recorded around the same
work (``null`` on the CPU).  One JSON line per stage, with the scene, the
dtype, the device and the stage's counts.  ``device`` is as for the entry
points: CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
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

__all__ = ["run_stages", "main"]


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

        toi = stage("solve", phase, solve, queries=total, batches=len(cuts),
                    toi=lambda r: float(r[0]), checks=lambda r: int(r[1]))[0]

    stage("fused_ccd", None,
          lambda: fused_ccd(v0, v1, e, f, device=device, validate=False, dtype=dtype),
          toi=lambda r: float(r.toi), vf_total=lambda r: int(r.vf_total),
          ee_total=lambda r: int(r.ee_total), total_checks=lambda r: int(r.total_checks),
          overflowed=lambda r: bool(r.overflowed))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("grid", nargs="?", type=int, default=128)
    ap.add_argument("subdiv", nargs="?", type=int, default=4)
    ap.add_argument("--drop", type=float, default=0.25)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--device", default=None)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    run_stages(a.grid, a.subdiv, a.drop, a.dtype, a.device, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
