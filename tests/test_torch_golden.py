"""The committed golden scenes through the port, on the CPU.

``tests/golden/`` holds three two-frame scenes with their broad-phase truth
(an f64 brute-force oracle's pairs, in the dataset's global id space) and
their f64-oracle earliest TOI, files that neither package computes.  The
port is held to the bars of ``tests/test_golden_data.py:250-333``:

- the candidate set is a superset of the truth in f64 (in fact equal) and
  in f32, whose boxes are rounded outward;
- the TOI is never later than the oracle's (``toi <= golden * (1 + 1e-4) +
  1e-7``) and, where the precision suffices, within ``rel=2e-2``
  (``abs=1e-6``) of it: in f32 on ``cloth-sphere-16`` and ``soup-60``, and
  in f64 and compensated on all three;
- ``dense-cluster`` is the scene on which plain f32 is useless: its f32
  error filter swallows the true separation and the TOI collapses to 0,
  while ``precision="compensated"`` and ``dtype=float64`` recover the
  oracle's ``7.171630859375e-4`` (``0 < toi <= golden * (1 + 1e-4) + 1e-9``,
  ``rel=2e-2``), through ``fused_ccd`` and through ``ccd()``.
"""

import json
import os

import numpy as np
import pytest
import torch

from scalable_ccd_tpu_torch import CCDConfig, ccd, fused_ccd
from scalable_ccd_tpu_torch.broad_phase import (
    brute_force_overlaps,
    merge_two_lists,
    sort_boxes,
)
from scalable_ccd_tpu_torch.geometry import (
    build_edge_boxes,
    build_face_boxes,
    build_vertex_boxes,
    edges_from_faces,
    read_ply,
)
from scalable_ccd_tpu_torch.ops import sweep_ap

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SCENES = ("cloth-sphere-16", "dense-cluster", "soup-60")
#: scenes where plain f32 reproduces the f64 oracle's TOI tightly
TIGHT_F32 = {"cloth-sphere-16", "soup-60"}
MODES = {
    "float32": dict(),
    "compensated": dict(precision="compensated"),
    "float64": dict(dtype=torch.float64),
}
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def golden():
    """``{scene: (v0, v1, edges, faces, toi.json, vf truth, ee truth)}``."""
    out = {}
    for scene in SCENES:
        base = os.path.join(GOLDEN_DIR, scene)
        v0, faces = read_ply(os.path.join(base, "frames", "f0.ply"))
        v1, faces1 = read_ply(os.path.join(base, "frames", "f1.ply"))
        assert np.array_equal(faces, faces1)
        with open(os.path.join(base, "toi.json")) as fh:
            toi = json.load(fh)
        truth = []
        for name in ("f0vf.json", "f0ee.json"):
            with open(os.path.join(base, "boxes", name)) as fh:
                truth.append({(int(a), int(b)) for a, b in json.load(fh)})
        out[scene] = (v0, v1, edges_from_faces(faces), faces, toi, *truth)
    return out


def _candidates(v0, v1, edges, faces, dtype):
    """The port's VF and EE candidate sets in the truth files' global id
    space (edge ids + n_vertices, face ids + n_vertices + n_edges,
    ``tests/test_broad_phase.cu:109-118``), and the boxes."""
    t = torch.from_numpy
    vb = build_vertex_boxes(t(v0), t(v1), dtype=dtype)
    eb, fb = build_edge_boxes(vb, t(edges)), build_face_boxes(vb, t(faces))
    nv, ne = vb.n, eb.n
    vf = sweep_ap.sweep_pairs(sort_boxes(merge_two_lists(vb, fb)), True, 1 << 16)
    ee = sweep_ap.sweep_pairs(sort_boxes(eb), False, 1 << 16)
    assert not bool(vf[3]) and not bool(ee[3])
    vf_set = {(a, b + nv + ne) for a, b in vf[0][: int(vf[1])].tolist()}
    ee_set = {(a + nv, b + nv) for a, b in ee[0][: int(ee[1])].tolist()}
    return vf_set, ee_set, (vb, eb, fb)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("scene", SCENES)
def test_golden_superset(golden, scene, dtype):
    v0, v1, edges, faces, _, vf_truth, ee_truth = golden[scene]
    vf, ee, (vb, eb, fb) = _candidates(v0, v1, edges, faces, dtype)
    assert vf_truth and ee_truth
    assert not vf_truth - vf, f"{len(vf_truth - vf)} VF truth pairs missing"
    assert not ee_truth - ee, f"{len(ee_truth - ee)} EE truth pairs missing"
    if dtype == torch.float64:
        assert vf == vf_truth and ee == ee_truth
        # and equal to the port's own brute force on the same boxes
        nv, ne = vb.n, eb.n
        assert vf == {(a, b + nv + ne) for a, b in brute_force_overlaps(vb, fb).tolist()}
        assert ee == {(a + nv, b + nv) for a, b in brute_force_overlaps(eb).tolist()}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("scene", SCENES)
def test_golden_toi(golden, scene, mode):
    v0, v1, edges, faces, g, _, _ = golden[scene]
    res = fused_ccd(v0, v1, edges, faces, max_iterations=-1, tolerance=g["tolerance"],
                    min_distance=g["min_distance"], allow_zero_toi=g["allow_zero_toi"],
                    **MODES[mode], **CPU)
    toi = float(res.toi)
    assert res.toi.dtype == (torch.float64 if mode == "float64" else torch.float32)
    assert not bool(res.overflowed) and not bool(res.solver_capped)
    # conservative: never later than the f64 oracle
    assert toi <= g["toi"] * (1 + 1e-4) + 1e-7
    if mode != "float32" or scene in TIGHT_F32:
        assert toi == pytest.approx(g["toi"], rel=2e-2, abs=1e-6)
    else:
        assert toi == 0.0  # the f32 filter swallows the separation


@pytest.mark.parametrize("mode", ["compensated", "float64"])
def test_dense_cluster_toi_recovered(golden, mode):
    """The full pipelines recover the f64-oracle TOI where plain f32 gives
    0 (JAX ``test_committed_golden_toi_compensated``)."""
    v0, v1, edges, faces, g, _, _ = golden["dense-cluster"]
    assert g["toi"] == 7.171630859375e-4
    res = fused_ccd(v0, v1, edges, faces, max_iterations=-1, tolerance=g["tolerance"],
                    **MODES[mode], **CPU)
    assert not bool(res.overflowed)
    assert 0.0 < float(res.toi) <= g["toi"] * (1 + 1e-4) + 1e-9
    assert float(res.toi) == pytest.approx(g["toi"], rel=2e-2)
    cfg = CCDConfig(dtype="float64") if mode == "float64" else CCDConfig(precision=mode)
    toi_c = ccd(v0, v1, edges, faces, tolerance=g["tolerance"], config=cfg, **CPU)
    assert 0.0 < toi_c <= g["toi"] * (1 + 1e-4) + 1e-9
    assert toi_c == pytest.approx(g["toi"], rel=2e-2)
    assert toi_c == pytest.approx(float(res.toi), abs=1e-7)


def test_dense_cluster_f32_collapses_through_ccd(golden):
    v0, v1, edges, faces, g, _, _ = golden["dense-cluster"]
    assert ccd(v0, v1, edges, faces, tolerance=g["tolerance"], **CPU) == 0.0
