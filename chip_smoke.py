#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``scalable_ccd_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; it imports nothing of jax.  Phases,
each printed as one JSON line, each stopping the run with a non-zero exit
when it fails:

0. the device, and ``nvidia-smi``'s name and power limit of the card;
1. build both CUDA kernels from ``scalable_ccd_tpu_torch/csrc/`` with nvcc;
2. kernel A (sweep) against its plain PyTorch version on the bench scene's
   sorted VF and EE boxes: equal pair sets and totals, and a budget of 64
   that overflows with the exact total;
3. kernel B (solver) against its plain version on the bench scene's VF and
   EE candidates, in the main path's batches of 16,384: global TOI within
   1e-7;
4. the main path ``fused_ccd(..., device="cuda")``: equal to the CPU run on
   ``cloth_on_sphere(64, 3)``, the golden ``cloth-sphere-16`` bar, and the
   bench scene ``cloth_on_sphere(128, 4, drop=0.25)`` run once with zeroed
   launch counters (both kernels must launch) and then timed (median of 5
   after the warm-up); also timed on ``cloth_on_sphere(384, 5)``.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-6
BATCH = 1 << 14


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


def alternate(plain, kernel, reps):
    """Plain, kernel, kernel, plain; returns (kernel_ms, plain_ms)."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def pair_keys(pairs, n):
    import torch

    p = pairs[: int(n)].to(torch.int64)
    return torch.sort(p[:, 0] * (1 << 32) + p[:, 1]).values


def main():
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
    from scalable_ccd_tpu_torch.ops import _build, solver, sweep_ap

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit(phase="device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    for lib in ("sweep_ap", "solver"):
        _build.load_library(lib)
    ptxas = []
    for lib in ("sweep_ap", "solver"):
        log = _build.build_library(lib).with_suffix(".log")
        ptxas += [l.strip() for l in log.read_text().splitlines() if "registers" in l or "spill" in l]
    emit(phase="build", seconds=time.perf_counter() - t0,
         per_library=dict(_build.BUILD_SECONDS), ptxas=ptxas)

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
        cand[ph] = p[0][: int(p[1])]  # sweep order: identical input for both solvers
        emit(phase="kernel_a", which=ph, boxes=sb.n, pairs=int(p[2]), equal=True,
             overflow_64_exact=True, ms=kms, plain_ms=pms)

    # ---- 3. kernel B vs plain ---------------------------------------------
    vcat = types.concat_frames(v0, v1, torch.float32)
    b_ms = b_plain_ms = 0.0
    b_err = 0.0
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
        b_ms, b_plain_ms, b_err = b_ms + kms, b_plain_ms + pms, max(b_err, err)
        emit(phase="kernel_b", which=ph, queries=rows.shape[0], batches=len(batches),
             toi=float(tk), plain_toi=float(tp), abs_err=err, checks=int(ck),
             plain_checks=int(cp), overflow=bool(ok_), plain_overflow=bool(op_),
             ms=kms, plain_ms=pms)

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
    sweep_ap.LAUNCHES = 0
    solver.LAUNCHES = 0
    res = fused_ccd(*bargs, device="cuda", validate=False)
    torch.cuda.synchronize()
    launches = {"sweep_pairs": sweep_ap.LAUNCHES, "solve_packed": solver.LAUNCHES}
    check(all(n > 0 for n in launches.values()), f"main path skipped a kernel: {launches}")
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

    src = "scalable_ccd_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "sweep_pairs", "route": "cuda", "source": src + "sweep_ap.cu",
         "replaces": "scalable_ccd_tpu/ops/pallas_sweep_ap.py:291",
         "launches": launches["sweep_pairs"], "max_abs_err": 0.0,
         "ms": a_ms, "plain_ms": a_plain_ms},
        {"name": "solve_packed", "route": "cuda", "source": src + "solver.cu",
         "replaces": "scalable_ccd_tpu/ops/pallas_solver.py:114",
         "launches": launches["solve_packed"], "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain_ms},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
