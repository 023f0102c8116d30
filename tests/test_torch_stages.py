"""Kernel A's ``count_only`` option and the stage tool, on the CPU.

``sweep_pairs(count_only=True)`` must give the emitting sweep's exact total
for the whole array, for box ranges (summed) and under ``any_order``, in f32
and f64, and equal JAX ``pallas_sweep_pairs(count_only=True)`` run in
interpret mode.  The stage tool (``python -m scalable_ccd_tpu_torch.tools.
stages``) runs small with ``device="cpu"``; its totals equal ``fused_ccd``'s
and its budgets come from its own ``count_only`` totals.
"""

import json

import jax.numpy as jnp
import pytest
import torch

from scalable_ccd_tpu.broad_phase import merge_two_lists as jmerge
from scalable_ccd_tpu.broad_phase import sort_boxes as jsort
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.ops import pallas_sweep_ap as jap
from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb
from scalable_ccd_tpu_torch.ops import sweep_ap
from scalable_ccd_tpu_torch.tools import stages
from scalable_ccd_tpu_torch.utils import Timer

torch.set_num_threads(2)


def _scene():
    return jscenes.cloth_on_sphere(grid_n=14, sphere_subdiv=1, drop=0.35)


def _boxes(two_lists, dtype):
    s = _scene()
    t = torch.from_numpy
    vb = aabb.build_vertex_boxes(t(s.vertices_t0), t(s.vertices_t1), dtype=dtype)
    if two_lists:
        return merge_two_lists(vb, aabb.build_face_boxes(vb, t(s.faces)))
    return aabb.build_edge_boxes(vb, t(s.edges))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("any_order", [False, True])
@pytest.mark.parametrize("two_lists", [True, False])
def test_count_only_equals_the_emitting_total(two_lists, any_order, dtype):
    sb = sort_boxes(_boxes(two_lists, dtype), bucket_minor=any_order)
    total = sweep_ap.sweep_pairs(sb, two_lists, any_order=any_order, count_only=True)
    assert total.dtype == torch.int64 and total.ndim == 0
    emitted = sweep_ap.sweep_pairs(sb, two_lists, 1 << 15, any_order=any_order)
    assert int(total) == int(emitted[2]) == int(emitted[1]) > 0
    # exact past a budget too, and over box ranges
    assert int(total) == int(sweep_ap.sweep_pairs(sb, two_lists, 16, any_order=any_order)[2])
    ranged = sum(int(sweep_ap.sweep_pairs(sb, two_lists, box_range=(b0, b0 + 61),
                                          any_order=any_order, count_only=True))
                 for b0 in range(0, sb.n, 61))
    assert ranged == int(total)
    assert int(sweep_ap.sweep_pairs(sb, two_lists, box_range=(7, 7), count_only=True)) == 0
    assert int(sweep_ap.sweep_pairs_reference(sb, two_lists, any_order=any_order,
                                              count_only=True, chunk_slots=1 << 10)) == int(total)


def test_count_only_takes_no_budget():
    sb = sort_boxes(_boxes(False, torch.float32))
    with pytest.raises(ValueError, match="no budget"):
        sweep_ap.sweep_pairs(sb, False, 64, count_only=True)
    with pytest.raises(ValueError, match="needs a pair budget"):
        sweep_ap.sweep_pairs(sb, False)
    before = dict(sweep_ap.LAUNCHES_BY_MODE)
    sweep_ap.sweep_pairs(sb, False, count_only=True)
    assert sweep_ap.LAUNCHES_BY_MODE == before  # CPU tensors: the plain version


@pytest.mark.parametrize("two_lists,any_order", [(True, False), (False, True)])
def test_count_only_matches_jax(two_lists, any_order):
    s = _scene()
    vb = jaabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=jnp.float32)
    m = jmerge(vb, jaabb.build_face_boxes(vb, s.faces)) if two_lists \
        else jaabb.build_edge_boxes(vb, s.edges)
    packed, n = jap.pack_boxes_ap(jsort(m, bucket_minor=any_order))
    _, jn, jt, jovf = jap.pallas_sweep_pairs(packed, n, two_lists, budget=128, interpret=True,
                                             any_order=any_order, count_only=True)
    sb = sort_boxes(_boxes(two_lists, torch.float32), bucket_minor=any_order)
    total = sweep_ap.sweep_pairs(sb, two_lists, any_order=any_order, count_only=True)
    assert int(total) == int(jt) > 128 and not bool(jovf)


@pytest.fixture(scope="module")
def staged():
    lines = []
    out = stages.run_stages(16, 1, device="cpu", reps=1, emit=lines.append)
    return out, lines


def test_stage_tool_totals_equal_fused(staged):
    out, lines = staged
    assert [json.loads(line) for line in lines] == out
    s = jscenes.cloth_on_sphere(grid_n=16, sphere_subdiv=1, drop=0.25)
    ref = fused_ccd(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device="cpu")
    by = {(o["stage"], o["phase"]): o for o in out}
    want = {"vf": int(ref.vf_total), "ee": int(ref.ee_total)}
    for ph in ("vf", "ee"):
        for stage in ("sweep_count_only", "sweep_pairs", "sweep_records",
                      "sweep_records_decode"):
            assert by[(stage, ph)]["pairs"] == want[ph], (stage, ph)
        for stage in ("gather_pack", "solve"):
            assert by[(stage, ph)]["queries"] == want[ph]
        # every budget is sized from the count_only total
        assert by[("sweep_pairs", ph)]["budget"] == 1 << (want[ph] - 1).bit_length()
        assert by[("sweep_records", ph)]["records"] <= want[ph]
    frame = by[("fused_ccd", None)]
    assert (frame["vf_total"], frame["ee_total"]) == (want["vf"], want["ee"])
    assert frame["toi"] == float(ref.toi) == by[("solve", "ee")]["toi"]
    assert not frame["overflowed"]
    for o in out:
        assert o["wall_ms"] > 0 and o["device_ms"] is None and o["device"] == "cpu"
        assert o["dtype"] == "float32" and o["scene"] == "cloth_on_sphere(16, 1, drop=0.25)"


@pytest.mark.parametrize("argv,dtype", [
    (["10", "1", "--dtype", "float64"], "float64"),
    (["10", "1"], "float32"),
])
def test_stage_tool_command_line(capsys, argv, dtype):
    assert stages.main(argv + ["--device", "cpu", "--reps", "1"]) == 0
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [o["stage"] for o in out].count("solve") == 2 and out[-1]["stage"] == "fused_ccd"
    assert {o["dtype"] for o in out} == {dtype}
    s = jscenes.cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.25)
    ref = fused_ccd(s.vertices_t0, s.vertices_t1, s.edges, s.faces, device="cpu", dtype=dtype)
    assert out[-1]["toi"] == float(ref.toi)
    assert (out[-1]["vf_total"], out[-1]["ee_total"]) == (int(ref.vf_total), int(ref.ee_total))


def test_timer():
    with Timer() as t:
        sum(range(1000))
    assert t.get_elapsed_s() > 0.0
    assert t.get_elapsed_ms() == pytest.approx(t.get_elapsed_s() * 1e3)
    assert t.get_elapsed_us() == pytest.approx(t.get_elapsed_s() * 1e6)
    t.stop()  # stopping a stopped timer keeps the reading
    assert t.get_elapsed_s() > 0.0


def test_kernel_b_rows_need_cuda():
    """``--kernel-b`` records kernel B's launches on the main path, which
    exist only on a CUDA device; elsewhere it raises before any frame."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        stages.run_kernel_b(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        stages.main(["--kernel-b", "--device", "cpu"])
    modes = [stages._mode({"round_limit": r, "per_query": p, "max_iterations": m})
             for r, p, m in ((128, False, -1), (-1, False, -1), (-1, True, -1),
                             (-1, True, 10), (-1, False, 10))]
    assert modes == ["round_limit", "global", "per_query", "bounded", "bounded"]
