"""CPU tests of the benchmark's harness, reference and metric arithmetic.

    python -m pytest ccd_bench/test_ccd_bench_harness.py -q

A dry run is ``ccd_bench/run.py`` with ``--device cpu`` (the plain versions
of the program's kernels) on a copy of the benchmark's files whose
configurations are cut to a 12 x 12 cloth.
"""

from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ccd_bench import cells, check, generator, roofline, traced
from ccd_bench.harness import TraceRun, WindowRun
from ccd_bench.reference import reference_frame

BASE = Path(__file__).resolve().parent
SCENE = cells.load_module(BASE, "scenes", "cloth_on_sphere")
ENTRY = cells.load_module(BASE, "calls", "fused_ccd")
ROOT = BASE.parent
RUN = BASE / "run.py"
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _tiny_tree(tmp: Path, grid: int = 12) -> Path:
    """A copy of the benchmark's files with every configuration cut to a
    ``grid`` x ``grid`` cloth on a twice-subdivided sphere; returns the
    copy's ``BENCHMARK.json``."""
    for sub in ("traffic", "metrics", "configs", "scenes", "calls", "reference"):
        shutil.copytree(BASE / sub, tmp / sub)
    for path in (tmp / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["scene"].update(grid_n=grid, sphere_subdiv=2)
        path.write_text(json.dumps(cfg))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp / "BENCHMARK.json"


def _dry_run(bench: Path, workload: str, trace: int, seed: int = 2**31 + 11):
    """The last line of a dry run on the CPU, parsed, and the run's stderr."""
    proc = subprocess.run(
        [sys.executable, str(RUN), "--workload", workload, "--seed", str(seed),
         "--seconds", "0.5", "--trace", str(trace), "--device", "cpu",
         "--benchmark", str(bench), "--base", str(bench.parent)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    bench = _bench()
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    assert workload == f"{entry['config']}.{entry['traffic']}"
    cell = cells.resolve(workload)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    assert json.loads((ROOT / config["file"]).read_text()) == cell.config
    assert cell.config["source"] == config["source"]
    assert cell.config["reduced"] == config["reduced"]
    assert cell.chips == entry["chips"] == 1
    names = [m for m, _ in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names and len(cell.end_to_end) >= 2 and cell.per_layer
    for m in names:
        assert callable(cells.load_reader(cell.base, m))


def test_benchmark_names_and_units_keep_to_the_contract():
    import re

    bench = _bench()
    name_rx = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit_rx = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name_rx.match(m["name"]) and unit_rx.match(m["unit"]), m
    for m in bench["per_layer"]:
        assert m["moves"] == "call_ms"
    for w in bench["workloads"]:
        assert name_rx.match(w["name"]) and len(w["why"]) <= 200
    for c in bench["configs"]:
        assert name_rx.match(c["name"]) and len(c["source"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


THROWAWAY_SCENE = """
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "cos", Path(__file__).resolve().parent / "cloth_on_sphere.py")
_cos = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cos)


def topology(scene):
    return _cos.topology(scene)


def frame(topo, scene, spec, rng):
    # the cloth of cloth_on_sphere, tilted: raised by lift + tilt * x
    v0, v1 = _cos.frame(topo, scene, {"lift": 0.0}, rng)
    n = len(topo.cloth_v)
    for v in (v0, v1):
        v[:n, 1] += spec["lift"] + scene["tilt"] * topo.cloth_v[:, 0]
    return v0, v1
"""

THROWAWAY_REFERENCE = """
from ccd_bench.reference import reference_frame

OPTIONS = ("escalate_rounds",)
CONTROL = {"float32": "bfloat16"}


def validate(config, options):
    if set(options) - set(OPTIONS) or config["precision"] not in CONTROL:
        raise ValueError("not modelled")


def frame(v0, v1, edges, faces, config, options, device, tile, control=False):
    # the escalation's schedule changes no answer
    validate(config, options)
    return reference_frame(v0, v1, edges, faces, config["tolerance"], device,
                           precision="bfloat16" if control else "float32", tile=tile)
"""


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A configuration of a new scene kind, a traffic mix that passes the
    entry point an option, with a lift range and a reference that models
    the option, and a metric, all added as new files and entries in the
    benchmark file, run with no edit of the harness or the generator."""
    bench_path = _tiny_tree(tmp_path, grid=10)
    cfg = json.loads((tmp_path / "configs" / "clothball.json").read_text())
    cfg["scene"].update(kind="throwaway_kind", grid_n=9, tilt=0.05, advance=0.0)
    (tmp_path / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    (tmp_path / "scenes" / "throwaway_kind.py").write_text(THROWAWAY_SCENE)
    (tmp_path / "reference" / "throwaway_ref.py").write_text(THROWAWAY_REFERENCE)
    traffic = json.loads((tmp_path / "traffic" / "sim.json").read_text())
    traffic.update(frames=3, lift_start=0.5, lift_end=0.25, reference="throwaway_ref",
                   call={"escalate_rounds": -1})
    (tmp_path / "traffic" / "opt.json").write_text(json.dumps(traffic))
    traffic.update(reference="fused_ccd")
    (tmp_path / "traffic" / "unmodelled.json").write_text(json.dumps(traffic))
    (tmp_path / "metrics" / "throwaway_calls.py").write_text(
        "def read(run):\n    return float(len(run.call_s))\n")
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "throwaway", "source": "test", "file": "x",
                             "reduced": [], "why": "test"})
    for traffic in ("opt", "unmodelled"):
        bench["workloads"].append({"name": f"throwaway.{traffic}", "config": "throwaway",
                                   "traffic": traffic, "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "throwaway_calls", "unit": "calls",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["throwaway.opt"]})
    bench_path.write_text(json.dumps(bench))

    cell = cells.resolve("throwaway.opt", bench_path, tmp_path)
    cycle = generator.make_cycle(cell.config, cell.traffic, 7, cell.base)
    assert [s["lift"] for s in cycle.specs] == [0.5, 0.375, 0.25]
    assert generator.call_options(cell.config, cell.traffic) == {"escalate_rounds": -1}
    line, _ = _dry_run(bench_path, "throwaway.opt", 0)
    assert line["correct"] is True
    assert line["metrics"]["throwaway_calls"]["value"] == line["attempted"] >= 1
    assert line["metrics"]["throwaway_calls"]["unit"] == "calls"
    # the throwaway metric belongs to its own cell only
    other, _ = _dry_run(bench_path, "clothball.sim", 0)
    assert "throwaway_calls" not in other["metrics"]
    # a reference that does not model the option refuses the cell: no result
    proc = subprocess.run(
        [sys.executable, str(RUN), "--workload", "throwaway.unmodelled", "--seed", "1",
         "--seconds", "0.2", "--trace", "0", "--device", "cpu",
         "--benchmark", str(bench_path), "--base", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "escalate_rounds" in proc.stderr


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (BASE / "traffic").glob("*.json")))
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_prints_the_contract_keys(tmp_path, traffic, trace):
    bench_path = _tiny_tree(tmp_path)
    workload = next(w["name"] for w in _bench()["workloads"] if w["traffic"] == traffic)
    line, err = _dry_run(bench_path, workload, trace)
    keys = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["check"]) == list(check.LIMITS)
    for name, entry in line["check"].items():
        assert entry == {"value": entry["value"], "limit": check.LIMITS[name]}
        assert f"check {name} {entry['value']} limit {check.LIMITS[name]}" in err
    # the compared numbers end standard error
    assert err.strip().splitlines()[-1].startswith("check capped_mismatch")
    if trace:
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        for name in ("call_ms", "call_p90_ms", "setup_s"):
            assert line["metrics"][name]["value"] > 0


def _frames(grid: int, slide: float, noise: float, seed: int):
    """The four frames of the ``sim`` traffic on a ``grid`` x ``grid`` cloth
    sliding ``slide`` grid spacings a step, at advance 0."""
    h = 2.4 / (grid - 1)
    scene = {"grid_n": grid, "sphere_subdiv": 2, "drop": 0.25,
             "slide": [slide * h, 0.6 * slide * h], "noise": noise, "advance": 0.0}
    topo = SCENE.topology(scene)
    traffic = json.loads((BASE / "traffic" / "sim.json").read_text())
    for k, spec in enumerate(generator.frame_specs(traffic)):
        v0, v1 = SCENE.frame(topo, scene, spec, generator.frame_rng(seed, k))
        yield v0, v1, topo.edges, topo.faces


@pytest.mark.parametrize("grid,slide,noise", [(12, 0.0, 0.02), (20, 2.5, 1e-4)])
def test_reference_agrees_with_the_port_on_the_cpu(grid, slide, noise):
    from scalable_ccd_tpu_torch import fused_ccd

    tois = []
    for v0, v1, e, f in _frames(grid, slide, noise, 2**40 + 3):
        ref = reference_frame(v0, v1, e, f, 1e-6, "cpu")
        got = ENTRY.answer(fused_ccd(v0, v1, e, f, device="cpu"))
        assert got == ref
        tois.append(ref["toi"])
    # the cycle holds a frame in contact and, sliding, frames clear of it
    assert min(tois) < 1
    if slide:
        assert tois[:3] == [1.0, 1.0, 1.0]


def test_reference_finds_every_overlap_of_a_brute_force():
    """The slab sweep's pair sets against all pairs tested at once."""
    from ccd_bench.reference import boxes, broad

    v0, v1, e, f = next(_frames(8, 0.0, 0.05, 5))
    t0, t1 = torch.as_tensor(v0), torch.as_tensor(v1)
    vb = boxes.vertex_boxes(t0, t1)
    fb = boxes.face_boxes(vb, torch.as_tensor(f))
    eb = boxes.edge_boxes(vb, torch.as_tensor(e))

    def overlap(a, b):
        return ((a.lo[:, None] <= b.hi[None]) & (b.lo[None] <= a.hi[:, None])).all(-1)

    fl, el = torch.as_tensor(f).long(), torch.as_tensor(e).long()
    nv = vb.lo.shape[0]
    vf = overlap(vb, fb) & (fl[None, :, :] != torch.arange(nv)[:, None, None]).all(-1)
    ee = overlap(eb, eb) & (el[:, None, :, None] != el[None, :, None, :]).all(-1).all(-1)
    ee = torch.triu(ee, diagonal=1)
    assert broad.vf_pairs(vb, fb, torch.as_tensor(f)).tolist() == vf.nonzero().tolist()
    assert broad.ee_pairs(eb, torch.as_tensor(e)).tolist() == ee.nonzero().tolist()


def test_the_block_size_does_not_change_the_pairs():
    from ccd_bench.reference import boxes, broad

    v0, v1, e, f = next(_frames(16, 2.5, 0.02, 9))
    vb = boxes.vertex_boxes(torch.as_tensor(v0), torch.as_tensor(v1))
    eb = boxes.edge_boxes(vb, torch.as_tensor(e))
    keep = lambda a, b: torch.ones_like(a, dtype=torch.bool)  # noqa: E731
    whole = broad.overlapping_pairs(eb.lo, eb.hi, keep)
    small = broad.overlapping_pairs(eb.lo, eb.hi, keep, block=97)
    assert all(torch.equal(a, b) for a, b in zip(whole, small))


def test_the_row_block_does_not_change_the_answer(monkeypatch):
    import ccd_bench.reference as reference

    frames = list(_frames(14, 2.5, 1e-3, 21))
    whole = [reference_frame(*fr, 1e-6, "cpu") for fr in frames]
    monkeypatch.setattr(reference, "ROW_BLOCK", 97)
    assert [reference_frame(*fr, 1e-6, "cpu") for fr in frames] == whole
    assert any(w["vf_total"] > 97 for w in whole)


def test_dry_run_loads_no_jax_and_the_reference_none_of_the_program(tmp_path):
    bench_path = _tiny_tree(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from ccd_bench.harness import main\n"
        f"rc = main(['--workload', 'clothball.sim', '--seed', '4', '--seconds', '0.2', "
        f"'--device', 'cpu', '--benchmark', {str(bench_path)!r}, '--base', "
        f"{str(tmp_path)!r}])\n"
        "print(json.dumps([rc, sorted({m.split('.')[0] for m in sys.modules})]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    rc, tops = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rc == 0, proc.stderr[-3000:]
    assert "scalable_ccd_tpu_torch" in tops
    for name in ("jax", "jaxlib", "flax", "scalable_ccd_tpu"):
        assert name not in tops

    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "from ccd_bench import cells, generator\n"
        "from ccd_bench.reference import reference_frame\n"
        "sc = {'grid_n': 6, 'sphere_subdiv': 1, 'drop': 0.25, 'noise': 0.01}\n"
        "m = cells.load_module(cells.BASE, 'scenes', 'cloth_on_sphere')\n"
        "t = m.topology(sc)\n"
        "v0, v1 = m.frame(t, sc, {'lift': 0.0}, generator.frame_rng(1, 0))\n"
        "reference_frame(v0, v1, t.edges, t.faces, 1e-6, 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    tops = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("scalable_ccd_tpu_torch", "scalable_ccd_tpu", "jax"):
        assert name not in tops
    # and no source of the reference names the program
    for path in (BASE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                for m in mods:
                    assert m.split(".")[0] in ("torch", "numpy", "ccd_bench", "__future__",
                                                "typing"), (path, m)


def test_the_cycle_is_a_function_of_the_seed():
    cfg = {"scene": {"kind": "cloth_on_sphere", "grid_n": 7, "sphere_subdiv": 1,
                     "drop": 0.25, "slide": [0.1, 0.05], "noise": 0.01, "advance": 0.5}}
    traffic = {"frames": 4, "lift_start": 0.9, "lift_end": 0.0}
    a = generator.make_cycle(cfg, traffic, 2**31 + 5)
    b = generator.make_cycle(cfg, traffic, 2**31 + 5)
    c = generator.make_cycle(cfg, traffic, 2**31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a.v1, b.v1))
    assert not np.array_equal(a.v1[3], c.v1[3])
    assert [s["lift"] for s in a.specs] == pytest.approx([0.9, 0.6, 0.3, 0.0])
    # the cloth moves as a whole, up to the noise; t=0 holds no noise
    topo = SCENE.topology(cfg["scene"])
    step = np.array([0.1, -0.25, 0.05])
    assert np.allclose(a.v1[3][:49] - a.v0[3][:49], step, atol=0.06)
    assert np.allclose(a.v0[3][:49], topo.cloth_v + 0.5 * step)
    assert np.allclose(a.v0[0][:49], topo.cloth_v + 0.5 * step + [0, 0.9, 0])
    assert np.array_equal(a.v0[0][49:], a.v1[0][49:])
    assert np.array_equal(a.edges, SCENE.edges_from_faces(a.faces))


class _Trace:
    def __init__(self, device, start=0.0, end=1.0):
        self.device, self.start, self.end, self.host = device, start, end, []
        self.window_s = end - start

    def busy_s(self):
        return traced.union_s(self.device, self.start, self.end)


def _read(metric, run):
    return cells.load_reader(BASE, metric)(run)


def test_roofline_arithmetic_by_hand():
    # a tiny scene: 10 VF boxes, 7 EE boxes, 3 + 2 candidate pairs a call
    assert roofline.sweep_bytes(10, 7, 5) == 17 * (6 * 4 + 3 * 4) + 5 * 8 == 652
    assert roofline.solver_bytes(5) == 5 * (24 * 4 + 2 * 4) == 520
    assert roofline.bound_s(652) == 652 / 3.35e12
    answers = [{"vf_total": 3, "ee_total": 2}, {"vf_total": 3, "ee_total": 2}]
    device = [
        ("void sweep_units_kernel<float>(Boxes<float>, int)", 0.0, 1e-9),
        ("void tile_units_kernel<float>(Boxes<float>)", 1e-9, 2e-9),
        ("void solve_kernel<float, true, false, true>(float const*)", 2e-9, 4e-9),
        ("void solve_lane_kernel<float, false>(float const*)", 4e-9, 5e-9),
        ("void gather_pack_kernel<float, 0>(Ids, long long, Pack<float, 0>)", 5e-9, 6e-9),
        ("void at::native::elementwise_kernel<128, 2>(int, at::native::Fill)", 0.5, 0.75),
        ("Memcpy HtoD (Pageable -> Device)", 0.6, 0.7),
    ]
    run = TraceRun(_Trace(device), answers, 8, 2, 10, 7, untraced_s=0.5)
    # sweep: two calls' bytes over 2 ns of kernels A
    want = 100 * 2 * (652 / 3.35e12) / 2e-9
    assert math.isclose(_read("sweep_roofline_pct", run), want, rel_tol=1e-12)
    want = 100 * 2 * (520 / 3.35e12) / 3e-9
    assert math.isclose(_read("solver_roofline_pct", run), want, rel_tol=1e-12)
    assert math.isclose(_read("sweep_device_ms", run), 1000 * 2e-9 / 2)
    assert math.isclose(_read("solver_device_ms", run), 1000 * 3e-9 / 2)
    assert math.isclose(_read("pack_device_ms", run), 1000 * 1e-9 / 2)
    assert math.isclose(_read("torch_device_ms", run), 1000 * 0.35 / 2)
    assert _read("torch_ops_per_call", run) == 1.0
    assert _read("host_syncs_per_call", run) == 4.0
    # busy: [0, 6 ns] and [0.5, 0.75], over the 0.5 s the calls took untraced
    assert math.isclose(_read("device_idle_pct", run), 100 * (1 - (6e-9 + 0.25) / 0.5))
    # nothing to read: no metric, never a 0
    empty = TraceRun(_Trace([]), answers, None, 0, 10, 7, untraced_s=0.5)
    for m in ("sweep_roofline_pct", "solver_roofline_pct", "sweep_device_ms",
              "device_idle_pct", "torch_device_ms", "host_syncs_per_call"):
        assert _read(m, empty) is None


def test_end_to_end_readers():
    call_s = [0.1] * 9 + [0.5]
    run = WindowRun(call_s, 1.5, 12.5, 3 * 2**20)
    assert _read("call_ms", run) == 150.0
    # nearest rank: the 9th of 10
    assert _read("call_p90_ms", run) == 100.0
    assert _read("call_p90_ms", WindowRun([0.1] * 8 + [0.4, 0.5], 1.5, 0, 0)) == 400.0
    assert _read("peak_mem_mib", run) == 3.0
    assert _read("setup_s", run) == 12.5


def test_breakdown_labels_idle_gaps_by_the_host_op():
    device = [("void solve_kernel<float>(x)", 0.1, 0.2), ("Memset (Device)", 0.5, 0.6)]
    tr = traced.Trace(0.0, 1.0, 1.0, device, [("aten::nonzero", 0.15, 0.45),
                                               ("cudaLaunchKernel", 0.62, 0.9)])
    out = traced.breakdown(tr)
    assert dict(out["device_ops"]) == {"solve_kernel<float>": pytest.approx(0.1),
                                       "Memset (Device)": pytest.approx(0.1)}
    assert traced._short("void at::native::(anonymous namespace)::fill<float>(int, float)") \
        == "at::native::(anonymous namespace)::fill<float>"
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(0.3)
    assert gaps["cudaLaunchKernel"] == pytest.approx(0.4)
    assert gaps["python (no op)"] == pytest.approx(0.1)
