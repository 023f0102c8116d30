"""PyTorch port vs the JAX package: sort, merge and the sweep's plain version.

Sorted boxes must be bitwise equal; pair sets from ``sweep_pairs_reference``
(the twin of kernel A) must equal JAX ``detect_overlaps`` and the decoded
interpret-mode ``pallas_sweep_pairs`` exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu.broad_phase import detect_overlaps
from scalable_ccd_tpu.broad_phase import merge_two_lists as jmerge
from scalable_ccd_tpu.broad_phase import sort_boxes as jsort
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import mesh as jmesh
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.ops.pallas_sweep_ap import pack_boxes_ap, pallas_sweep_pairs
from scalable_ccd_tpu_torch.broad_phase import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb
from scalable_ccd_tpu_torch.interop import from_numpy_boxes, from_numpy_scene, to_numpy
from scalable_ccd_tpu_torch.ops import sweep_ap

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _scene(name):
    if name == "cloth":
        return jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35)
    if name == "soup":
        return jscenes.triangle_soup(80, motion=0.25, seed=4)
    v0, f = jmesh.read_ply(os.path.join(GOLDEN, name, "frames", "f0.ply"))
    v1, _ = jmesh.read_ply(os.path.join(GOLDEN, name, "frames", "f1.ply"))
    return jscenes.Scene(v0, v1, f)


def _jax_boxes(s):
    vb = jaabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=jnp.float32)
    return vb, jaabb.build_edge_boxes(vb, s.edges), jaabb.build_face_boxes(vb, s.faces)


def _port_boxes(s):
    t = from_numpy_scene(s)
    vb = aabb.build_vertex_boxes(t.vertices_t0, t.vertices_t1)
    return vb, aabb.build_edge_boxes(vb, t.edges), aabb.build_face_boxes(vb, t.faces)


def _sorted_pair(s, two_lists, axis=0):
    jvb, jeb, jfb = _jax_boxes(s)
    pvb, peb, pfb = _port_boxes(s)
    if two_lists:
        return jsort(jmerge(jvb, jfb), axis=axis), sort_boxes(merge_two_lists(pvb, pfb), axis=axis)
    return jsort(jeb, axis=axis), sort_boxes(peb, axis=axis)


def _set(pairs, n=None):
    a = pairs.numpy() if torch.is_tensor(pairs) else np.asarray(pairs)
    return set(map(tuple, a[: len(a) if n is None else int(n)].tolist()))


@pytest.mark.parametrize("name", ["cloth", "soup", "cloth-sphere-16"])
@pytest.mark.parametrize("two_lists", [True, False])
@pytest.mark.parametrize("axis", [0, "auto"])
def test_sort_boxes_bitwise_equal(name, two_lists, axis):
    js, ps = _sorted_pair(_scene(name), two_lists, axis)
    for field, a, b in zip(js._fields, js, to_numpy(ps)):
        assert np.array_equal(_bits(a), _bits(b)), field


def test_merge_two_lists_bitwise_equal():
    jvb, _, jfb = _jax_boxes(_scene("soup"))
    pvb, _, pfb = _port_boxes(_scene("soup"))
    for field, a, b in zip(pvb._fields, jmerge(jvb, jfb), to_numpy(merge_two_lists(pvb, pfb))):
        assert np.array_equal(_bits(a), _bits(b)), field


@pytest.mark.parametrize("name", ["cloth", "soup", "cloth-sphere-16", "dense-cluster"])
@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_reference_equals_detect_overlaps(name, two_lists):
    js, _ = _sorted_pair(_scene(name), two_lists)
    ref = _set(detect_overlaps(js, is_two_lists=two_lists))
    # the JAX sorted boxes themselves, carried across
    pairs, n_pairs, n_true, ovf = sweep_ap.sweep_pairs_reference(
        from_numpy_boxes(js), two_lists, 1 << 16
    )
    assert not bool(ovf) and int(n_true) == int(n_pairs) == len(ref)
    assert _set(pairs, n_pairs) == ref


@pytest.mark.parametrize("two_lists", [True, False])
def test_sweep_reference_equals_pallas_kernel_interpret(two_lists):
    s = jscenes.cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.35)
    js, ps = _sorted_pair(s, two_lists)
    packed, n = pack_boxes_ap(js)
    jp, jn, jt, jovf = pallas_sweep_pairs(packed, n, two_lists, budget=1 << 14, interpret=True)
    pairs, n_pairs, n_true, ovf = sweep_ap.sweep_pairs_reference(ps, two_lists, 1 << 14)
    assert not bool(jovf) and not bool(ovf)
    assert int(n_true) == int(jt)
    assert _set(pairs, n_pairs) == _set(jp, jn)


def test_sweep_budget_overflow_keeps_exact_total():
    _, ps = _sorted_pair(_scene("soup"), False)
    full, n_full, _, _ = sweep_ap.sweep_pairs_reference(ps, False, 1 << 16)
    assert int(n_full) > 64
    pairs, n_pairs, n_true, ovf = sweep_ap.sweep_pairs(ps, False, 64)
    assert bool(ovf) and int(n_pairs) == 64 and int(n_true) == int(n_full)
    assert pairs.shape == (64, 2)
    assert _set(pairs) <= _set(full, n_full)


@pytest.mark.parametrize("chunk_slots", [1, 7, 1000])
def test_sweep_reference_chunking_is_invisible(chunk_slots):
    _, ps = _sorted_pair(_scene("cloth"), True)
    a = sweep_ap.sweep_pairs_reference(ps, True, 1 << 14)
    b = sweep_ap.sweep_pairs_reference(ps, True, 1 << 14, chunk_slots=chunk_slots)
    assert torch.equal(a[0], b[0]) and int(a[2]) == int(b[2])


def test_sweep_empty_scenes():
    # two static triangles far apart: boxes exist, no pair survives
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                  [10, 10, 10], [11, 10, 10], [10, 11, 10]], np.float64)
    s = jscenes.Scene(v, v.copy(), np.array([[0, 1, 2], [3, 4, 5]]))
    for two_lists in (True, False):
        js, ps = _sorted_pair(s, two_lists)
        assert len(detect_overlaps(js, is_two_lists=two_lists)) == 0
        pairs, n_pairs, n_true, ovf = sweep_ap.sweep_pairs(ps, two_lists, 16)
        assert int(n_pairs) == int(n_true) == 0 and not bool(ovf)
    # no boxes at all
    empty = ps._replace(**{f: t[:0] for f, t in ps._asdict().items()})
    pairs, n_pairs, n_true, ovf = sweep_ap.sweep_pairs(empty, False, 16)
    assert pairs.shape == (16, 2) and int(n_true) == 0 and not bool(ovf)


def test_sweep_wrapper_on_cpu_is_the_plain_version():
    _, ps = _sorted_pair(_scene("cloth"), True)
    before = sweep_ap.LAUNCHES_BY_MODE.total
    got = sweep_ap.sweep_pairs(ps, True, 1 << 14)
    ref = sweep_ap.sweep_pairs_reference(ps, True, 1 << 14)
    assert sweep_ap.LAUNCHES_BY_MODE.total == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_sweep_wrapper_rejects_other_devices():
    _, ps = _sorted_pair(_scene("cloth"), True)
    meta = type(ps)(*[t.to("meta") for t in ps])
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_ap.sweep_pairs(meta, True, 1 << 14)


@pytest.mark.parametrize("name", ["cloth-sphere-16", "dense-cluster", "soup-60"])
def test_port_broad_phase_covers_golden_truth(name):
    """Conservativeness bar of ``test_golden_data.py``: the f32 pair sets
    contain every f64 ground-truth pair (ids offset as in the dataset)."""
    s = _scene(name)
    pvb, peb, pfb = _port_boxes(s)
    vf = sweep_ap.sweep_pairs(sort_boxes(merge_two_lists(pvb, pfb)), True, 1 << 16)
    ee = sweep_ap.sweep_pairs(sort_boxes(peb), False, 1 << 16)
    nv, ne = pvb.n, peb.n
    vf_set = {(a, b + nv + ne) for a, b in _set(vf[0], vf[1])}
    ee_set = {(a + nv, b + nv) for a, b in _set(ee[0], ee[1])}
    for rows, fname in ((vf_set, "f0vf.json"), (ee_set, "f0ee.json")):
        with open(os.path.join(GOLDEN, name, "boxes", fname)) as fh:
            truth = {(int(a), int(b)) for a, b in json.load(fh)}
        assert truth <= rows
