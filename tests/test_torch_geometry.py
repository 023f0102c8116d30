"""PyTorch port vs the JAX package: scenes, mesh IO, validation and boxes.

Same inputs (numpy, from a seed or the committed golden frames) through
both packages; boxes must be bitwise equal in f32.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import mesh as jmesh
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu_torch.geometry import aabb, mesh, scenes
from scalable_ccd_tpu_torch.interop import from_numpy_scene, to_numpy

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_SCENES = ("cloth-sphere-16", "dense-cluster", "soup-60")


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _golden_mesh(name, read_ply, edges_from_faces):
    v0, f = read_ply(os.path.join(GOLDEN, name, "frames", "f0.ply"))
    v1, _ = read_ply(os.path.join(GOLDEN, name, "frames", "f1.ply"))
    return v0, v1, edges_from_faces(f), f


def _scene(name):
    """(v0, v1, edges, faces) numpy arrays of a named test scene."""
    if name == "cloth":
        s = jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35)
    elif name == "soup":
        s = jscenes.triangle_soup(60, motion=0.2, seed=3)
    else:
        return _golden_mesh(name, jmesh.read_ply, jmesh.edges_from_faces)
    return s.vertices_t0, s.vertices_t1, s.edges, s.faces


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35),
        lambda m: m.cloth_on_sphere(grid_n=9, sphere_subdiv=2, drop=0.2, seed=5),
        lambda m: m.triangle_soup(60, motion=0.2, seed=3),
    ],
    ids=["cloth12", "cloth9-seed5", "soup60"],
)
def test_scenes_are_identical_arrays(make):
    j, p = make(jscenes), make(scenes)
    for name in ("vertices_t0", "vertices_t1", "edges", "faces"):
        a, b = getattr(j, name), getattr(p, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (p.n_vertices, p.n_edges, p.n_faces) == (j.n_vertices, j.n_edges, j.n_faces)


def test_edges_from_faces_identical():
    faces = np.random.default_rng(11).integers(0, 40, size=(200, 3))
    a, b = jmesh.edges_from_faces(faces), mesh.edges_from_faces(faces)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", GOLDEN_SCENES)
def test_read_ply_identical(name):
    j = _golden_mesh(name, jmesh.read_ply, jmesh.edges_from_faces)
    p = _golden_mesh(name, mesh.read_ply, mesh.edges_from_faces)
    for a, b in zip(j, p):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_write_ply_read_back_by_jax(tmp_path):
    s = scenes.cloth_on_sphere(grid_n=6, sphere_subdiv=0, drop=0.2)
    path = str(tmp_path / "f.ply")
    mesh.write_ply(path, s.vertices_t0, s.faces)
    v, f = jmesh.read_ply(path)
    np.testing.assert_allclose(v, s.vertices_t0, rtol=1e-12)
    assert np.array_equal(f, s.faces)


@pytest.mark.parametrize("name", ["cloth", "soup", *GOLDEN_SCENES])
@pytest.mark.parametrize("radius", [0.0, 1e-3])
def test_boxes_bitwise_equal(name, radius):
    v0, v1, e, f = _scene(name)
    jv = jaabb.build_vertex_boxes(v0, v1, inflation_radius=radius, dtype=jnp.float32)
    j = (jv, jaabb.build_edge_boxes(jv, e), jaabb.build_face_boxes(jv, f))
    s = from_numpy_scene(jscenes.Scene(v0, v1, f))
    pv = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, inflation_radius=radius)
    p = (pv, aabb.build_edge_boxes(pv, s.edges), aabb.build_face_boxes(pv, s.faces))
    for jb, pb in zip(j, p):
        for field, a, b in zip(jb._fields, jb, to_numpy(pb)):
            assert np.asarray(a).dtype == b.dtype, field
            assert np.array_equal(_bits(a), _bits(b)), field


def test_boxes_bitwise_equal_f32_input_with_zero_coordinates():
    """f32 vertices with exact zeros: the widening crosses subnormals there
    (flush-to-zero in the JAX package)."""
    v0, v1, _, f = _scene("cloth")
    v0 = v0.astype(np.float32)
    v0[:5] = 0.0
    v1 = v1.astype(np.float32)
    jv = jaabb.build_vertex_boxes(jnp.asarray(v0), jnp.asarray(v1), dtype=jnp.float32)
    pv = aabb.build_vertex_boxes(torch.from_numpy(v0), torch.from_numpy(v1))
    assert np.array_equal(_bits(jv.min), _bits(pv.min.numpy()))
    assert np.array_equal(_bits(jv.max), _bits(pv.max.numpy()))
    assert (pv.min[:5] <= 0).all() and (pv.max[:5] >= 0).all()


def _bad_inputs():
    v0, v1, e, f = _scene("cloth")
    nan = v1.copy()
    nan[3, 1] = np.nan
    return {
        "ok": (v0, v1, e, f),
        "nan-vertex": (v0, nan, e, f),
        "frame-mismatch": (v0, v1[:-1], e, f),
        "vertex-shape": (v0[:, :2], v1[:, :2], e, f),
        "edge-out-of-range": (v0, v1, np.where(e == e.max(), len(v0), e), f),
        "negative-face": (v0, v1, e, np.where(f == 0, -1, f)),
        "float-edges": (v0, v1, e.astype(np.float64), f),
        "face-shape": (v0, v1, e, f[:, :2]),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_validate_raises_where_jax_raises(case, as_tensor):
    args = _bad_inputs()[case]
    try:
        jmesh.validate_mesh_inputs(*args)
        jax_err = None
    except ValueError as err:
        jax_err = str(err)
    if as_tensor:
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    if jax_err is None:
        mesh.validate_mesh_inputs(*args)
    else:
        with pytest.raises(ValueError) as info:
            mesh.validate_mesh_inputs(*args)
        if not as_tensor:
            assert str(info.value) == jax_err
