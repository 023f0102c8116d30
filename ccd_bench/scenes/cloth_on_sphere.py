"""Scene kind ``cloth_on_sphere``: a frozen numpy copy of the port's
``cloth_on_sphere`` (``scalable_ccd_tpu_torch/geometry/scenes.py``) whose
cloth moves as a whole.

A cloth grid of ``grid_n`` x ``grid_n`` vertices over [-1.2, 1.2]^2 (a
gentle wave at height ~1.02) hangs over a unit icosphere of
``sphere_subdiv`` subdivisions.  In one step the cloth translates by
``(slide[0], -drop, slide[1])``; at t=1 each cloth vertex is further
displaced by normal noise of sigma ``noise``, drawn from the frame's
random stream.  A frame spec's ``lift`` raises the cloth at t=0 and t=1;
at ``lift`` 0 the cloth starts ``advance`` of a step along its motion
from rest, which a configuration sets so that the cloth first touches the
sphere just after t=0.  The sphere is still.

The topology (faces, edges) depends only on ``grid_n`` and
``sphere_subdiv``, so a simulation's frames share it.  Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Topology", "topology", "motion", "frame", "edges_from_faces"]


class Topology:
    """What every frame of one scene shares: the rest positions of the
    cloth and the sphere, the faces and the unique edges."""

    def __init__(self, cloth_v: np.ndarray, sphere_v: np.ndarray, faces: np.ndarray):
        self.cloth_v = cloth_v
        self.sphere_v = sphere_v
        self.faces = faces
        self.edges = edges_from_faces(faces)


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges, each row sorted, rows lexsorted, int32."""
    f = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e.sort(axis=1)
    # one int64 key per edge: a sort of keys is the lexsort np.unique does
    key = np.unique(e[:, 0] * (int(f.max()) + 1) + e[:, 1])
    n = int(f.max()) + 1
    return np.stack([key // n, key % n], axis=1).astype(np.int32)


def _grid_mesh(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Regular n x n grid on [-1, 1]^2 in the y = 0 plane, 2 (n-1)^2 faces."""
    xs = np.linspace(-1.0, 1.0, n)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([xx.ravel(), np.zeros(n * n), yy.ravel()], axis=1)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    f1 = np.stack([a.ravel(), b.ravel(), d.ravel()], axis=1)
    f2 = np.stack([a.ravel(), d.ravel(), c.ravel()], axis=1)
    return verts, np.concatenate([f1, f2], axis=0)


def _icosphere(subdiv: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere by midpoint subdivision of an icosahedron."""
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


def _topology(grid_n: int, sphere_subdiv: int) -> Topology:
    """The cloth at rest (scaled by 1.2, a gentle wave at height ~1.02 over
    the sphere's top) and the unit sphere; faces as int32."""
    cloth_v, cloth_f = _grid_mesh(grid_n)
    cloth_v = cloth_v * 1.2
    cloth_v[:, 1] = 1.02 + 0.02 * np.sin(3 * cloth_v[:, 0]) * np.cos(3 * cloth_v[:, 2])
    sphere_v, sphere_f = _icosphere(sphere_subdiv)
    faces = np.concatenate([cloth_f, sphere_f + len(cloth_v)], axis=0).astype(np.int32)
    return Topology(cloth_v, sphere_v, faces)


def topology(scene: dict) -> Topology:
    """What every frame of the configuration's scene shares."""
    return _topology(int(scene["grid_n"]), int(scene["sphere_subdiv"]))


def motion(scene: dict) -> np.ndarray:
    """The cloth's translation in one step."""
    sx, sz = (float(x) for x in scene.get("slide", (0.0, 0.0)))
    return np.array([sx, -float(scene["drop"]), sz])


def frame(topo: Topology, scene: dict, spec: dict,
          rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """``(v0, v1)``, float64 ``(n, 3)``: the cloth ``advance`` of a step
    along its motion from rest and raised by ``spec["lift"]`` at t=0, and
    at t=1 moved by one step and displaced by noise (one draw of
    ``(n_cloth, 3)``); the sphere still."""
    step = motion(scene)
    cloth0 = topo.cloth_v + float(scene.get("advance", 0.0)) * step
    cloth0[:, 1] += float(spec["lift"])
    cloth1 = cloth0 + step + rng.normal(scale=float(scene["noise"]), size=cloth0.shape)
    v0 = np.concatenate([cloth0, topo.sphere_v], axis=0)
    v1 = np.concatenate([cloth1, topo.sphere_v], axis=0)
    return v0, v1
