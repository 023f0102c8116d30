"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, one precision below the
configuration's (the cell's reference model's ``control``; for float32, its
boxes and positions stored in bfloat16, the step that would tempt a later
change, since it halves the bytes the sweeps and the solver read).  The comparison has to find it wrong.

    python3 ccd_bench/control.py --workload clothball.sim --seed 7 [--device cuda]

builds the cell's frames at its own size, runs the reference in float32 and
in the control's precision for every frame of the cycle, and prints each
compared number beside its limit, as a run does (``check`` in one JSON
line).  The benchmark's own runs do not run it.
"""

import sys
import time
from pathlib import Path


def control(workload: str, seed: int, device: str, benchmark=None, base=None) -> dict:
    """``{"check": {name: {"value", "limit"}}, "correct": bool, ...}`` of the
    control against the reference on every frame of the cell's cycle."""
    from ccd_bench import cells, check, generator
    from ccd_bench.harness import REFERENCE_TILE

    cell = cells.resolve(workload, benchmark or cells.BENCHMARK, base or cells.BASE)
    model = cells.load_module(cell.base, "reference", cell.reference)
    limits = getattr(model, "LIMITS", check.LIMITS)
    compare = getattr(model, "compare", check.compare)
    opts = generator.call_options(cell.config, cell.traffic)
    cycle = generator.make_cycle(cell.config, cell.traffic, seed, cell.base)
    tile = REFERENCE_TILE[device == "cuda"]
    refs, calls, per_frame = {}, [], []
    start = time.perf_counter()
    for k in range(len(cycle.v0)):
        args = (cycle.v0[k], cycle.v1[k], cycle.edges, cycle.faces, cell.config, opts, device,
                tile)
        refs[k] = model.frame(*args)
        ctl = model.frame(*args, control=True)
        calls.append((k, ctl))
        per_frame.append({"reference": refs[k], "control": ctl})
    numbers, wrong = compare(calls, refs)
    correct = wrong == 0 and all(v <= limits[n] for n, v in numbers.items())
    return {"workload": workload, "seed": seed, "correct": correct, "frames": per_frame,
            "seconds": time.perf_counter() - start,
            "check": {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="ccd_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(control(args.workload, args.seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root in place of this folder
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
