"""Narrow-phase query data, tolerances and conservative error bounds.

PyTorch counterpart of ``scalable_ccd_tpu/narrow_phase/types.py`` (the
reference's ``CCDData``, ``ccd_data.cuh:8-26``, its ``add_data`` gather,
``narrow_phase.cu:24-74``, and the tolerance and error filters of
``root_finder.cu:48-135``).  Every expression keeps the JAX package's order
of operations, so the results are bitwise equal in f32 and in f64 (every
function works in the dtype of the queries it is given).

Point semantics of the eight endpoints (``narrow_phase.cu:41-66``):
- VF: p0 = vertex, p1/p2/p3 = the face's three vertices;
- EE: p0/p1 = edge A endpoints, p2/p3 = edge B endpoints;
each moving linearly from ``*s`` (t=0) to ``*e`` (t=1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "CCDQueries",
    "concat_frames",
    "pack_face_table",
    "pack_edge_table",
    "gather_vf_queries",
    "gather_ee_queries",
    "domain_corners",
    "compute_tolerance",
    "numerical_error_bound",
    "COMPENSATED_EPS",
]

#: machine epsilon of the error filter under ``precision="compensated"``
#: (the JAX package's value for its double-word f32 evaluation, ~48 bits,
#: ``narrow_phase/types.py:324-328``).  The port evaluates that mode in
#: native f64 (53 bits) on the same f32 inputs, so the filter still bounds
#: the evaluation error.
COMPENSATED_EPS = 2.0 ** -44


class CCDQueries(NamedTuple):
    """A batch of Q narrow-phase queries, structure-of-arrays."""

    p0s: torch.Tensor  # (Q, 3) point 0 at t=0
    p1s: torch.Tensor
    p2s: torch.Tensor
    p3s: torch.Tensor
    p0e: torch.Tensor  # (Q, 3) point 0 at t=1
    p1e: torch.Tensor
    p2e: torch.Tensor
    p3e: torch.Tensor

    @property
    def n(self) -> int:
        return self.p0s.shape[0]


def concat_frames(vertices_t0, vertices_t1, dtype=None) -> torch.Tensor:
    """``(n, 6)`` concatenation of the two vertex frames, cast to ``dtype``."""
    v0, v1 = vertices_t0, vertices_t1
    if dtype is not None:
        v0, v1 = v0.to(dtype), v1.to(dtype)
    return torch.cat([v0, v1], dim=1)


def pack_face_table(vcat: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """``(nf, 18)`` both-frame endpoints of every face's three vertices."""
    f = faces.to(torch.int64)
    return torch.cat([vcat[f[:, 0]], vcat[f[:, 1]], vcat[f[:, 2]]], dim=1)


def pack_edge_table(vcat: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``(ne, 12)`` both-frame endpoints of every edge's two vertices."""
    e = edges.to(torch.int64)
    return torch.cat([vcat[e[:, 0]], vcat[e[:, 1]]], dim=1)


def _queries(p0, p1, p2, p3) -> CCDQueries:
    return CCDQueries(
        p0s=p0[:, 0:3], p1s=p1[:, 0:3], p2s=p2[:, 0:3], p3s=p3[:, 0:3],
        p0e=p0[:, 3:6], p1e=p1[:, 3:6], p2e=p2[:, 3:6], p3e=p3[:, 3:6],
    )


def gather_vf_queries(vcat, ftab, overlaps) -> CCDQueries:
    """Vertex-face queries from ``(Q, 2)`` (vertex_id, face_id) pairs.

    ``vcat`` is :func:`concat_frames`, ``ftab`` :func:`pack_face_table`;
    out-of-range ids are clamped, as in the JAX package.
    """
    vi = overlaps[:, 0].to(torch.int64).clamp(0, vcat.shape[0] - 1)
    fi = overlaps[:, 1].to(torch.int64).clamp(0, ftab.shape[0] - 1)
    frow = ftab[fi]
    return _queries(vcat[vi], frow[:, 0:6], frow[:, 6:12], frow[:, 12:18])


def gather_ee_queries(etab, overlaps) -> CCDQueries:
    """Edge-edge queries from ``(Q, 2)`` (edgeA, edgeB) pairs; ``etab`` is
    :func:`pack_edge_table`."""
    ea = overlaps[:, 0].to(torch.int64).clamp(0, etab.shape[0] - 1)
    eb = overlaps[:, 1].to(torch.int64).clamp(0, etab.shape[0] - 1)
    arow, brow = etab[ea], etab[eb]
    return _queries(arow[:, 0:6], arow[:, 6:12], brow[:, 0:6], brow[:, 6:12])


def domain_corners(q: CCDQueries, lo, hi, is_vf: bool) -> torch.Tensor:
    """The residual F at the 8 corners of a (t, u, v) box, ``(Q, 2, 2, 2, 3)``
    with axes (query, t, u, v, xyz) (``calculate_vf`` / ``calculate_ee``,
    ``root_finder.cu:137-155``):

    - VF: ``F = p0(t) - (p2(t)-p1(t))*u - (p3(t)-p1(t))*v - p1(t)``
    - EE: ``F = ((p1-p0)*u + p0) - ((p3-p2)*v + p2)``

    with ``p(t) = (pe - ps)*t + ps``; same association as the JAX package.
    """
    t = torch.stack([lo[:, 0], hi[:, 0]], dim=1)[:, :, None]  # (Q, 2, 1)

    def lerp(ps, pe):
        return (pe - ps)[:, None, :] * t + ps[:, None, :]  # (Q, 2, 3)

    p0 = lerp(q.p0s, q.p0e)
    p1 = lerp(q.p1s, q.p1e)
    p2 = lerp(q.p2s, q.p2e)
    p3 = lerp(q.p3s, q.p3e)
    u = torch.stack([lo[:, 1], hi[:, 1]], dim=1)[:, None, :, None, None]
    v = torch.stack([lo[:, 2], hi[:, 2]], dim=1)[:, None, None, :, None]

    def bc(p):  # (Q, 2, 3) -> (Q, 2, 1, 1, 3)
        return p[:, :, None, None, :]

    if is_vf:
        return bc(p0) - bc(p2 - p1) * u - bc(p3 - p1) * v - bc(p1)
    return (bc(p1 - p0) * u + bc(p0)) - (bc(p3 - p2) * v + bc(p2))


def compute_tolerance(q: CCDQueries, is_vf: bool, co_domain_tolerance) -> torch.Tensor:
    """Per-query (t, u, v) domain tolerances, ``(Q, 3)``:
    ``co / (3 * max edge difference of F along d)`` over the unit cube.

    The EE variant keeps the reference quirk (``root_finder.cu:71-87``):
    its tolerances are (ext_t, ext_t, ext_u), not (ext_t, ext_u, ext_v).
    """
    zero = torch.zeros((q.n, 3), dtype=q.p0s.dtype, device=q.p0s.device)
    c = domain_corners(q, zero, zero + 1, is_vf)

    def extent(axis):
        d = (c.select(axis, 1) - c.select(axis, 0)).abs()
        return d.flatten(1).amax(dim=1)

    ext_t, ext_u, ext_v = extent(1), extent(2), extent(3)
    co = torch.as_tensor(co_domain_tolerance, dtype=q.p0s.dtype, device=q.p0s.device)
    if is_vf:
        return torch.stack([co / (3 * ext_t), co / (3 * ext_u), co / (3 * ext_v)], dim=1)
    return torch.stack([co / (3 * ext_t), co / (3 * ext_t), co / (3 * ext_u)], dim=1)


def numerical_error_bound(q: CCDQueries, is_vf: bool, use_ms: bool,
                          compensated: bool = False) -> torch.Tensor:
    """Conservative bound on the evaluation error of F in the queries'
    dtype, ``(Q, 3)``: ``max_d^3 * k * eps`` with k = 30 (VF) / 28 (EE), plus
    4 with a minimum separation, and ``max_d`` the largest absolute
    coordinate (at least 1) among the eight endpoints
    (``get_numerical_error``, ``root_finder.cu:90-135``).  ``compensated``
    takes :data:`COMPENSATED_EPS` for ``eps`` instead of the dtype's."""
    eps = COMPENSATED_EPS if compensated else torch.finfo(q.p0s.dtype).eps
    k = (30 if is_vf else 28) + (4 if use_ms else 0)
    pts = torch.stack([q.p0s, q.p1s, q.p2s, q.p3s, q.p0e, q.p1e, q.p2e, q.p3e], dim=1)
    m = torch.clamp(pts.abs().amax(dim=1), min=1.0)
    return m * m * m * (k * eps)
