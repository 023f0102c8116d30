"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips elsewhere.  The
file imports no jax, so it also runs where only PyTorch is installed:
``python -m pytest tests/test_torch_kernels_gpu.py -m cuda --noconftest -q``
(``--noconftest`` skips the suite's jax setup).
"""

import pytest
import torch

from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb, scenes
from scalable_ccd_tpu_torch.interop import from_numpy_scene
from scalable_ccd_tpu_torch.narrow_phase import types
from scalable_ccd_tpu_torch.ops import solver, sweep_ap

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scene():
    return scenes.cloth_on_sphere(grid_n=16, sphere_subdiv=2, drop=0.3)


def _sorted(device, two_lists):
    s = from_numpy_scene(_scene(), device)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    if two_lists:
        return sort_boxes(merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)))
    return sort_boxes(aabb.build_edge_boxes(vb, s.edges))


def _set(pairs, n):
    return set(map(tuple, pairs[: int(n)].cpu().numpy().tolist()))


@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_kernel_equals_plain(cuda, two_lists):
    sb = _sorted(cuda, two_lists)
    before = sweep_ap.LAUNCHES
    k = sweep_ap.sweep_pairs(sb, two_lists, 1 << 16)
    torch.cuda.synchronize()
    assert sweep_ap.LAUNCHES == before + 1
    p = sweep_ap.sweep_pairs_reference(sb, two_lists, 1 << 16)
    assert int(k[2]) == int(p[2]) > 0 and not bool(k[3])
    assert _set(k[0], k[1]) == _set(p[0], p[1])


def test_sweep_kernel_overflow_keeps_exact_total(cuda):
    sb = _sorted(cuda, False)
    pairs, n_pairs, n_true, ovf = sweep_ap.sweep_pairs(sb, False, 64)
    full = sweep_ap.sweep_pairs_reference(sb, False, 1 << 16)
    assert bool(ovf) and int(n_pairs) == 64 and int(n_true) == int(full[2])
    assert _set(pairs, 64) <= _set(full[0], full[1])


@pytest.mark.parametrize("is_vf", [True, False])
def test_solver_kernel_equals_plain(cuda, is_vf):
    s = from_numpy_scene(_scene(), cuda)
    pairs, n, _, _ = sweep_ap.sweep_pairs_reference(_sorted(cuda, is_vf), is_vf, 1 << 16)
    pairs = pairs[: int(n)]
    vcat = types.concat_frames(s.vertices_t0, s.vertices_t1, torch.float32)
    if is_vf:
        q = types.gather_vf_queries(vcat, types.pack_face_table(vcat, s.faces), pairs)
    else:
        q = types.gather_ee_queries(types.pack_edge_table(vcat, s.edges), pairs)
    rows = solver.pack_query_rows(q, is_vf, 0.0, TOL)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=cuda)
    valid[::7] = False
    toi_k, ovf_k, checks_k = solver.solve_packed(rows, valid, is_vf, 1.0, TOL)
    torch.cuda.synchronize()
    toi_p, ovf_p, checks_p = solver.solve_packed_reference(rows, valid, is_vf, 1.0, TOL)
    assert float(toi_k) == pytest.approx(float(toi_p), abs=1e-7)
    assert 0.0 <= float(toi_k) < 1.0 and int(checks_k) > 0
    # a seed below every contact comes back unchanged
    seed = float(toi_p) * 0.5
    toi_s, _, _ = solver.solve_packed(rows, valid, is_vf, seed, TOL)
    assert float(toi_s) == pytest.approx(seed, rel=1e-6)


def test_fused_cuda_equals_cpu(cuda):
    s = _scene()
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    res = fused_ccd(*args, device=cuda)
    ref = fused_ccd(*args, device="cpu")
    assert res.toi.device.type == "cuda" and not bool(res.overflowed)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert int(res.vf_total) == int(ref.vf_total)
    assert int(res.ee_total) == int(ref.ee_total)


def test_wrappers_reject_bad_tensors(cuda):
    rows = torch.zeros((4, 31), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        solver.solve_packed(rows, torch.ones(4, dtype=torch.bool, device=cuda), True, 1.0, TOL)
    sb = _sorted(cuda, False)
    with pytest.raises(ValueError):
        sweep_ap.sweep_pairs(sb._replace(minor_min=sb.minor_min.t()), False, 16)
    assert int(sweep_ap.sweep_pairs(sb, False, 16)[1]) <= 16
