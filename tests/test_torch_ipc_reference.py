"""The benchmark's plain reference of ``ipc_ccd_strategy``
(``ccd_bench/reference/ipc_ccd_strategy.py``) against the port on the CPU.

The reference imports nothing of the program; the port runs its plain
versions (``device="cpu"``).  On small cloths over a sphere (the
benchmark's own scene kind) both must give the same candidate counts, the
TOI bit for bit and the same ``solver_capped``, with the comparison that
decides a benchmark run's ``correct`` (``ccd_bench/check.py``): where the
IPC rule never fires, and at a box chunk of 256 boxes where it re-solves
two chunks or more.  The same comparison has to find wrong the reference
one precision below (bfloat16 boxes and positions) and three planted
faults: the separation dropped from the program's rows, the rule skipped
by the program, and the reference's chunks halved.

The comparison reads the TOI and not the refinement count, which the tests
here hold besides.  A refinement's back-off by 0.8 shows in the TOI unless
a later chunk's exact contact comes earlier and overrides it: with seed
2^40 + 17 in place of :data:`SEED`, the halved chunks refine 4 times
against 3 and give the same TOI.  So the faults are planted on a frame
whose back-offs last to the answer.
"""

import importlib
import json
from pathlib import Path

import pytest
import torch

from ccd_bench import cells, check, generator
from ccd_bench.reference import ipc_ccd_strategy as reference
from scalable_ccd_tpu_torch import CCDConfig, CCDStats, MemoryConfig, ipc_ccd_strategy
from scalable_ccd_tpu_torch.pipeline import narrow as port_narrow

# the submodule, not the function of the same name that the package exports
port_ccd = importlib.import_module("scalable_ccd_tpu_torch.pipeline.ccd")

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "ccd_bench" / "configs" / "clothball_ipc.json").read_text())
CALL = CONFIG["call"]
SCENE_KIND = cells.load_module(cells.BASE, "scenes", "cloth_on_sphere")
SEED = 123456789


def _scene(advance=None):
    """The configuration's scene cut to a 24 x 24 cloth over a twice
    subdivided sphere; ``advance`` replaces the configuration's."""
    scene = dict(CONFIG["scene"], grid_n=24, sphere_subdiv=2)
    if advance is not None:
        scene["advance"] = advance
    return scene, SCENE_KIND.topology(scene)


def _frame(scene, topo, lift: float, k: int):
    v0, v1 = SCENE_KIND.frame(topo, scene, {"lift": lift}, generator.frame_rng(SEED, k))
    return v0, v1, topo.edges, topo.faces


def _program(frame, chunk: int, **kw) -> dict:
    """The answer of one port call, as the benchmark's entry reads it."""
    stats = CCDStats()
    toi = ipc_ccd_strategy(*frame, stats=stats, device="cpu",
                           config=CCDConfig(memory=MemoryConfig(box_chunk_size=chunk)),
                           **CALL, **kw)
    return {"vf_total": stats.vf_candidates, "ee_total": stats.ee_candidates,
            "overflowed": False, "toi": toi, "solver_capped": stats.overflow_queries > 0,
            "ipc_refinements": stats.ipc_refinements}


def _reference(frame, chunk: int, precision: str = "float32") -> dict:
    return reference.ipc_frame(*frame, CALL["min_distance"], CALL["max_iterations"],
                               CALL["tolerance"], chunk, "cpu", precision=precision)


def _correct(answers, refs) -> bool:
    numbers, wrong = check.compare(list(enumerate(answers)), dict(enumerate(refs)))
    return wrong == 0 and all(v <= check.LIMITS[n] for n, v in numbers.items())


@pytest.fixture(scope="module")
def touching():
    """A frame whose cloth starts 1e-5 of a step before its first contact,
    inside the 1e-3 separation: the contact time at advance 0, from the
    reference without a separation, less 1e-5."""
    scene, topo = _scene(advance=0.0)
    contact = reference.ipc_frame(*_frame(scene, topo, 0.0, 3), 0.0, -1, CALL["tolerance"],
                                  1 << 15, "cpu")["toi"]
    assert 0.01 < contact < 1.0
    scene, topo = _scene(advance=contact - 1e-5)
    return _frame(scene, topo, 0.0, 3)


@pytest.fixture(scope="module")
def touching_at_256(touching):
    return _program(touching, 256), _reference(touching, 256)


def test_the_reference_is_the_program_where_the_rule_never_fires():
    scene, topo = _scene()
    chunk = CONFIG["assumed"]["box_chunk_size"]["value"]
    frames = [_frame(scene, topo, lift, k) for k, lift in enumerate((0.9, 0.0))]
    got = [_program(fr, chunk) for fr in frames]
    want = [_reference(fr, chunk) for fr in frames]
    assert got == want
    assert [w["toi"] for w in want][0] == 1.0 and 0.0 < want[1]["toi"] < 1.0
    assert [w["ipc_refinements"] for w in want] == [0, 0]
    assert min(w["vf_total"] for w in want) > 0 and _correct(got, want)


def test_the_reference_is_the_program_at_small_chunks(touching_at_256):
    got, want = touching_at_256
    assert got == want
    assert want["ipc_refinements"] >= 2 and 0.0 < want["toi"] < 1e-3
    assert _correct([got], [want])


def test_the_control_is_found_wrong(touching):
    want = _reference(touching, 256)
    control = _reference(touching, 256, precision="bfloat16")
    assert not _correct([control], [want])
    assert control["vf_total"] != want["vf_total"] or control["ee_total"] != want["ee_total"]


def test_the_separation_dropped_from_the_rows_is_found_wrong(touching_at_256, touching,
                                                             monkeypatch):
    # the program's rows: kernel C's (the re-solves) and those kernel B's
    # pairs source computes (the chunks' bounded solves)
    pack, solve = port_narrow.gather_pack, port_narrow.solve_pairs

    def pack_without_ms(pairs, start, stop, vcat, table, is_vf, ms, *args, **kw):
        return pack(pairs, start, stop, vcat, table, is_vf, 0.0, *args, **kw)

    def solve_without_ms(pairs, start, stop, vcat, table, is_vf, toi, ms, *args, **kw):
        return solve(pairs, start, stop, vcat, table, is_vf, toi, 0.0, *args, **kw)

    monkeypatch.setattr(port_narrow, "gather_pack", pack_without_ms)
    monkeypatch.setattr(port_narrow, "solve_pairs", solve_without_ms)
    got = _program(touching, 256)
    assert not _correct([got], [touching_at_256[1]])


def test_the_rule_skipped_is_found_wrong(touching_at_256, touching, monkeypatch):
    monkeypatch.setattr(port_ccd, "IPC_MIN_TOI", -1.0)
    got = _program(touching, 256)
    assert got["ipc_refinements"] == 0
    assert not _correct([got], [touching_at_256[1]])


def test_the_reference_chunks_halved_are_found_wrong(touching_at_256, touching):
    got = touching_at_256[0]
    assert not _correct([got], [_reference(touching, 128)])


def test_the_configuration_chunks_as_the_program_does():
    assert CONFIG["assumed"]["box_chunk_size"]["value"] == MemoryConfig().box_chunk_size
    assert CONFIG["call"] == {k: CONFIG["assumed"][k]["value"] for k in CALL}
    # the benchmark's cell answers as the reference does
    entry = cells.load_module(cells.BASE, "calls", "ipc_ccd_strategy")
    assert set(entry.answer((1.0, CCDStats()))) == {"vf_total", "ee_total", "overflowed",
                                                     "toi", "solver_capped"}
