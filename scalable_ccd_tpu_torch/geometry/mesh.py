"""Mesh helpers: edge extraction, simple PLY IO and input validation.

numpy copies of ``scalable_ccd_tpu/geometry/mesh.py`` (the reference's
libigl IO and edge extraction, ``tests/io.cpp:10-38``).  Only
:func:`validate_mesh_inputs` differs: tensors are reduced with torch on their
own device instead of through jax.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["edges_from_faces", "read_ply", "write_ply", "validate_mesh_inputs"]


def validate_mesh_inputs(vertices_t0, vertices_t1, edges, faces) -> None:
    """Fail fast on malformed two-frame mesh input at the public API boundary.

    Same checks and messages as the JAX package: matching (n, 3) vertex
    frames, integer (m, 2) edges / (k, 3) faces, indices in range, finite
    coordinates.  Raises ``ValueError``.  numpy inputs are checked on the
    host; when any input is a tensor the five probes (finiteness, index
    min/max) are reduced with torch and fetched in one transfer.
    """
    v0, v1, e, f = vertices_t0, vertices_t1, edges, faces
    shape = lambda a: tuple(a.shape) if torch.is_tensor(a) else tuple(np.shape(a))  # noqa: E731
    if len(shape(v0)) != 2 or shape(v0)[1] != 3:
        raise ValueError(f"vertices_t0 must be (n, 3), got {shape(v0)}")
    if shape(v1) != shape(v0):
        raise ValueError(
            f"vertex frames must match: t0 {shape(v0)} vs t1 {shape(v1)}"
        )
    if len(shape(e)) != 2 or shape(e)[1] != 2:
        raise ValueError(f"edges must be (m, 2), got {shape(e)}")
    if len(shape(f)) != 2 or shape(f)[1] != 3:
        raise ValueError(f"faces must be (k, 3), got {shape(f)}")
    for name, idx in (("edges", e), ("faces", f)):
        if torch.is_tensor(idx):
            if idx.dtype.is_floating_point or idx.dtype.is_complex or idx.dtype == torch.bool:
                raise ValueError(f"{name} must be an integer index array, got {idx.dtype}")
        else:
            dt = getattr(idx, "dtype", None) or np.asarray(idx).dtype
            if not np.issubdtype(dt, np.integer):
                raise ValueError(f"{name} must be an integer index array, got {dt}")
    n = shape(v0)[0]

    if not any(torch.is_tensor(a) for a in (v0, v1, e, f)):
        v0a, v1a = np.asarray(v0), np.asarray(v1)
        mins_maxs = [
            (int(np.min(idx)) if np.size(idx) else 0,
             int(np.max(idx)) if np.size(idx) else -1)
            for idx in (np.asarray(e), np.asarray(f))
        ]
        finite = bool(np.isfinite(v0a).all() and np.isfinite(v1a).all())
    else:
        t = lambda a: a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))  # noqa: E731
        v0t, v1t, et, ft = t(v0), t(v1), t(e), t(f)

        def lo_hi(idx):
            if idx.numel() == 0:
                return [0, -1]
            return [idx.min().to(torch.int64), idx.max().to(torch.int64)]

        probes = [torch.isfinite(v0t).all() & torch.isfinite(v1t).all()]
        probes += lo_hi(et) + lo_hi(ft)
        dev = probes[0].device
        fetched = torch.stack(
            [torch.as_tensor(p, dtype=torch.int64, device=dev) for p in probes]
        ).tolist()
        finite = bool(fetched[0])
        mins_maxs = [(fetched[1], fetched[2]), (fetched[3], fetched[4])]

    for name, (lo, hi) in zip(("edges", "faces"), mins_maxs):
        if hi >= 0 and (lo < 0 or hi >= n):
            raise ValueError(
                f"{name} index out of range [0, {n}): min={lo}, max={hi}"
            )
    if not finite:
        raise ValueError(
            "vertex positions contain non-finite values (NaN/inf); "
            "conservative CCD is undefined on non-finite input"
        )


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges of a triangle mesh (rows sorted, lexsorted),
    matching ``igl::edges`` semantics."""
    f = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e.sort(axis=1)
    e = np.unique(e, axis=0)
    return e.astype(np.int32)


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an ascii or binary-little-endian PLY triangle mesh -> (V, F)."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_v = int(next(l.split()[-1] for l in header if l.startswith("element vertex")))
        n_f = int(next(l.split()[-1] for l in header if l.startswith("element face")))
        v_props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                v_props.append(l.split()[1])

        if fmt == "ascii":
            verts = np.loadtxt(fh, max_rows=n_v, dtype=np.float64)
            faces = np.loadtxt(fh, max_rows=n_f, dtype=np.int64)[:, 1:4]
        else:
            dt_map = {"float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
                      "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
            vdt = np.dtype([(p, dt_map[t]) for p, t in zip(
                [l.split()[2] for l in header if l.startswith("property") and not l.startswith("property list")][: len(v_props)],
                v_props,
            )])
            raw = np.frombuffer(fh.read(n_v * vdt.itemsize), dtype=vdt, count=n_v)
            verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float64)
            faces = np.zeros((n_f, 3), dtype=np.int64)
            for i in range(n_f):
                cnt = np.frombuffer(fh.read(1), dtype=np.uint8)[0]
                idx = np.frombuffer(fh.read(4 * cnt), dtype="<i4")
                faces[i] = idx[:3]
        if verts.ndim == 1:
            verts = verts.reshape(n_v, -1)
        return verts[:, :3].astype(np.float64), faces.astype(np.int32)


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(v)}\n")
        fh.write("property double x\nproperty double y\nproperty double z\n")
        fh.write(f"element face {len(f)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        for row in v:
            fh.write(f"{row[0]} {row[1]} {row[2]}\n")
        for row in f:
            fh.write(f"3 {row[0]} {row[1]} {row[2]}\n")
