"""One run of one cell: set-up, the measured window (or the traced one),
the comparison with the reference, and the result line.

A run with ``--trace 0``:

1. makes the cell's frames from the seed (:mod:`ccd_bench.generator`) and
   warms up with one pass over the cycle, which builds the kernels (from
   the build cache inside the checkout once the first run made them) and
   brings the auto pair budgets' memo to its steady state; ``setup_s`` ends
   here;
2. measures a window of ``--seconds``: one closed-loop caller makes calls of
   the entry point over the cycle, each ended when the caller holds the TOI
   and the overflow flag on the host, until the window's time has passed;
3. reads every call's answer, frees the program's memory, runs the plain
   reference once per frame on the same device and compares
   (:mod:`ccd_bench.check`).

A run with ``--trace 1`` makes the same set-up, times ``trace_cycles``
whole cycles untraced, profiles the device alone over as many more (the
per-layer metrics and the device's busy time), host and device over
``breakdown_cycles`` more (the breakdown's labels of the idle gaps), and
counts host syncs over ``sync_cycles`` more (:mod:`ccd_bench.traced`), and
compares all those calls in the same way.

What a cell calls and what it is held to are found by name
(:mod:`ccd_bench.cells`): the entry ``calls/<entry>.py``, with
``call(program, v0, v1, edges, faces, device, options)`` and
``answer(result)``, and the reference ``reference/<name>.py``, with
``validate(config, options)``, ``frame(...)`` and, where its answers hold
other numbers, ``LIMITS`` and ``compare``.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, each from its reader in
``metrics/``), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each compared number beside its limit, which also end standard
error.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["main", "WindowRun", "TraceRun"]

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "scalable_ccd_tpu")
#: domains the reference's solver takes from its stack at once, on the CPU
#: and on the card (the TOI does not depend on it)
REFERENCE_TILE = {False: 1 << 16, True: 1 << 20}


class WindowRun:
    """What the end-to-end readers read: host-clock times of the window."""

    def __init__(self, call_s, window_s, setup_s, peak_window_bytes):
        self.call_s = call_s
        self.window_s = window_s
        self.setup_s = setup_s
        self.peak_window_bytes = peak_window_bytes


class TraceRun:
    """What the per-layer readers read: the traced window and its calls."""

    def __init__(self, trace, answers, syncs, sync_calls, n_vf_boxes, n_ee_boxes,
                 untraced_s=None):
        self.trace = trace
        #: host-clock seconds of the same calls run untraced just before
        self.untraced_s = untraced_s
        #: answers of the traced calls (``calls/<entry>.py``'s ``answer``)
        self.answers = answers
        self.syncs = syncs
        self.sync_calls = sync_calls
        self.n_vf_boxes = n_vf_boxes
        self.n_ee_boxes = n_ee_boxes

    @property
    def calls(self) -> int:
        return len(self.answers)

    def device_events(self, patterns, exclude: bool = False) -> list:
        """Device events whose name matches one of the regular expressions
        ``patterns`` (with ``exclude``, those that match none)."""
        import re

        rx = re.compile("|".join(f"(?:{p})" for p in patterns)) if patterns else None
        return [e for e in self.trace.device
                if (rx is not None and rx.search(e[0]) is not None) != exclude]

    def device_s(self, patterns, exclude: bool = False) -> float:
        return sum(b - a for _, a, b in self.device_events(patterns, exclude))


def _fail(msg: str, code: int = 2) -> int:
    print(f"ccd_bench: {msg}", file=sys.stderr, flush=True)
    return code


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(prog="ccd_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the harness's own tests: a dry run of the plain versions on the
    # CPU, and another benchmark file and folder
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--benchmark", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--base", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _window_note(call_s, cpu_s) -> str:
    """A line on the window for standard error: the mean call and the
    process's CPU seconds over the wall's, for each block of ten calls.  A
    block that runs slow at the same CPU share is a host that ran slower,
    not one that waited for the card."""
    ms, share = [], []
    for i in range(0, len(call_s), 10):
        wall = sum(call_s[i:i + 10])
        ms.append(round(1000.0 * wall / len(call_s[i:i + 10]), 1))
        share.append(round(sum(cpu_s[i:i + 10]) / wall, 3))
    return (f"ccd_bench: window: {len(call_s)} calls; by 10-call block, ms per call {ms}, "
            f"process CPU s per wall s {share}")


def main(argv=None, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    # every build cache inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    from ccd_bench import cells, check, generator, traced

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        return _fail("CUDA is not available; this benchmark measures the card")
    try:
        cell = cells.resolve(args.workload,
                             Path(args.benchmark) if args.benchmark else cells.BENCHMARK,
                             Path(args.base) if args.base else cells.BASE)
    except (KeyError, FileNotFoundError) as err:
        return _fail(str(err))
    if cuda and torch.cuda.device_count() < cell.chips:
        return _fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found")
    try:
        import scalable_ccd_tpu_torch as program
    except ImportError as err:
        return _fail(f"the program is not in this checkout: {err}")
    if ROOT not in Path(program.__file__).resolve().parents:
        return _fail(f"the program was imported from {program.__file__}, outside {ROOT}")
    entry = cells.load_module(cell.base, "calls", cell.entry)
    model = cells.load_module(cell.base, "reference", cell.reference)
    opts = generator.call_options(cell.config, cell.traffic)
    try:
        model.validate(cell.config, opts)
    except ValueError as err:
        return _fail(str(err))
    limits = getattr(model, "LIMITS", check.LIMITS)
    compare = getattr(model, "compare", check.compare)

    cycle = generator.make_cycle(cell.config, cell.traffic, args.seed, cell.base)
    n_frames = len(cycle.v0)

    def call(k):
        return k, entry.call(program, cycle.v0[k], cycle.v1[k], cycle.edges, cycle.faces,
                             args.device, opts)

    def calls(n):
        return [call(i % n_frames) for i in range(n)]

    calls(n_frames)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    if not args.trace:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        done, call_s, cpu_s = [], [], []
        start = time.perf_counter()
        while True:
            a, ca = time.perf_counter(), time.process_time()
            done.append(call(len(done) % n_frames))
            b = time.perf_counter()
            call_s.append(b - a)
            cpu_s.append(time.process_time() - ca)
            if b - start >= args.seconds:
                break
        window_s = b - start
        peak_window = torch.cuda.max_memory_allocated() if cuda else 0
        peak = max(peak, peak_window)
        run = WindowRun(call_s, window_s, setup_s, peak_window)
        readers = cell.end_to_end
        note = _window_note(call_s, cpu_s)
    else:
        # the calls' untraced time, then the device's time from a pass that
        # traces the device alone, the host's labels of the idle gaps from
        # one that traces both
        n_trace = n_frames * int(cell.traffic["trace_cycles"])
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        a = time.perf_counter()
        more = calls(n_trace)
        sync()
        untraced_s = time.perf_counter() - a
        done, tr = traced.profile_calls(lambda: calls(n_trace), cuda, host=False)
        n_labels = n_frames * int(cell.traffic["breakdown_cycles"])
        labelled, labels = traced.profile_calls(lambda: calls(n_labels), cuda, host=True)
        sync_calls = n_frames * int(cell.traffic["sync_cycles"])
        counted, syncs = traced.count_syncs(lambda: calls(sync_calls), cuda)
        more += labelled + counted
        del labelled, counted
        peak = max(peak, torch.cuda.max_memory_allocated() if cuda else 0)
        readers = cell.per_layer
        note = (f"ccd_bench: {n_trace} calls untraced in {untraced_s:.6f} s, traced in "
                f"{tr.window_s:.6f} s (device only); {n_labels} in {labels.window_s:.6f} s "
                f"(host and device)")
    found = _forbidden_modules()
    if found:
        return _fail(f"modules loaded that no run may hold: {found}", 3)

    answers = [(k, entry.answer(res)) for k, res in done]
    if args.trace:
        run = TraceRun(tr, [a for _, a in answers], syncs, sync_calls,
                       cycle.n_vf_boxes, cycle.n_ee_boxes, untraced_s)
        answers += [(k, entry.answer(res)) for k, res in more]
        del more
    del done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref_start = time.perf_counter()
    refs = {k: model.frame(cycle.v0[k], cycle.v1[k], cycle.edges, cycle.faces, cell.config,
                           opts, args.device, REFERENCE_TILE[cuda])
            for k in sorted({k for k, _ in answers})}
    ref_s = time.perf_counter() - ref_start
    numbers, wrong = compare(answers, refs)
    correct = wrong == 0 and all(v <= limits[n] for n, v in numbers.items())

    metrics = {}
    for name, unit in readers:
        value = cells.load_reader(cell.base, name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": cell.chips if cuda else 0,
              "memory_peak_bytes": int(peak),
              "power_limit_w": _power_limit_w() if cuda else None}
    out = {"correct": bool(correct), "attempted": len(answers), "failed": int(wrong),
           "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        out["breakdown"] = traced.breakdown(labels)
    out["check"] = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    found = _forbidden_modules()
    if found:
        return _fail(f"modules loaded that no run may hold: {found}", 3)
    print(note, file=sys.stderr)
    print(f"ccd_bench: reference per frame {json.dumps(refs)}, {ref_s:.3f} s in all",
          file=sys.stderr)
    for n, v in numbers.items():
        print(f"check {n} {v} limit {limits[n]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
