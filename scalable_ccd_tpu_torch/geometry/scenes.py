"""Procedural two-frame test scenes (numpy copy of
``scalable_ccd_tpu/geometry/scenes.py``: same geometry, same
``default_rng(seed)`` draws, so both packages get identical inputs).

The reference's test suite runs on downloaded simulation frames
(cloth-ball, armadillo-rollers, ... — ``tests/test_broad_phase.cu:31-65``);
those datasets are unavailable offline, so these deterministic procedural
scenes play the same role for tests and benchmarks: a cloth grid falling
onto a sphere (contact-rich, cloth-ball-like), and a random triangle soup
(uniform density, stresses the sweep's run-length distribution).
"""

from __future__ import annotations

import numpy as np

from scalable_ccd_tpu_torch.geometry.mesh import edges_from_faces

__all__ = ["cloth_on_sphere", "triangle_soup", "Scene"]


class Scene:
    """Two-frame mesh: vertices at t=0 and t=1, faces, unique edges."""

    def __init__(self, v0: np.ndarray, v1: np.ndarray, faces: np.ndarray):
        self.vertices_t0 = np.asarray(v0, dtype=np.float64)
        self.vertices_t1 = np.asarray(v1, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int32)
        self.edges = edges_from_faces(self.faces)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices_t0)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_faces(self) -> int:
        return len(self.faces)


def _grid_mesh(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Regular n x n grid on [-1, 1]^2 triangulated into 2(n-1)^2 faces."""
    xs = np.linspace(-1.0, 1.0, n)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([xx.ravel(), np.zeros(n * n), yy.ravel()], axis=1)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    f1 = np.stack([a.ravel(), b.ravel(), d.ravel()], axis=1)
    f2 = np.stack([a.ravel(), d.ravel(), c.ravel()], axis=1)
    return verts, np.concatenate([f1, f2], axis=0)


def _icosphere(subdiv: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere via icosahedron subdivision."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdiv):
        cache: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = vlist[i] + vlist[j]
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces


def cloth_on_sphere(
    grid_n: int = 64, sphere_subdiv: int = 3, drop: float = 0.25, seed: int = 0
) -> Scene:
    """Cloth grid above a unit sphere moving down by ``drop`` in one step.

    Frame pair is mid-contact: parts of the cloth pass into the sphere's
    bounding boxes, producing a contact-rich candidate set like the
    reference's cloth-ball frames 92->93.
    """
    rng = np.random.default_rng(seed)
    cloth_v, cloth_f = _grid_mesh(grid_n)
    cloth_v = cloth_v * 1.2
    cloth_v[:, 1] = 1.02 + 0.02 * np.sin(3 * cloth_v[:, 0]) * np.cos(3 * cloth_v[:, 2])

    sphere_v, sphere_f = _icosphere(sphere_subdiv)

    v0 = np.concatenate([cloth_v, sphere_v], axis=0)
    faces = np.concatenate([cloth_f, sphere_f + len(cloth_v)], axis=0)

    # Cloth drops; it drapes slightly (radial displacement damped near the
    # sphere) with a little noise so the motion is not axis-aligned-degenerate.
    v1 = v0.copy()
    cloth_sel = slice(0, len(cloth_v))
    v1[cloth_sel, 1] -= drop
    v1[cloth_sel] += rng.normal(scale=1e-3, size=(len(cloth_v), 3))
    return Scene(v0, v1, faces)


def triangle_soup(n_triangles: int = 500, motion: float = 0.1, seed: int = 0) -> Scene:
    """Random triangles in [0,1]^3 with random linear motion."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(n_triangles, 1, 3))
    v0 = (centers + rng.normal(scale=0.05, size=(n_triangles, 3, 3))).reshape(-1, 3)
    v1 = v0 + rng.normal(scale=motion, size=v0.shape)
    faces = np.arange(3 * n_triangles, dtype=np.int64).reshape(n_triangles, 3)
    return Scene(v0, v1, faces)
