"""Conservative axis-aligned bounding boxes, structure-of-arrays.

PyTorch counterpart of ``scalable_ccd_tpu/geometry/aabb.py`` (the
reference's box construction, ``src/scalable_ccd/broad_phase/aabb.cpp:38-133``).
Every box is widened by one ulp in each direction via ``nextafter`` plus an
up-rounded inflation radius (``AABB::conservative_inflation``,
``aabb.cpp:31-36``).

Vertex-id encoding (reference ``aabb.cpp:57,107-108,128-129``):
vertex i  -> (i, -i-1, -i-1);  edge (a,b) -> (a, b, -a-1);
face (a,b,c) -> (a, b, c).  "Do two simplices share a vertex" is then nine
integer equality tests, because negative slots never match a real id.

Denormals: the JAX package runs with denormals flushed (XLA on CPU and the
TPU treat subnormal operands and results as zero), and the widening touches
subnormals exactly where a coordinate is 0 or the radius is 0
(``nextafter(0, inf)`` is the smallest subnormal).  :func:`_conservative_bounds`
flushes those operands and results explicitly, so the boxes are bitwise the
JAX package's on every device; a flushed box still contains its exact input.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "AABBs",
    "build_vertex_boxes",
    "build_edge_boxes",
    "build_face_boxes",
]


class AABBs(NamedTuple):
    """A batch of n boxes (all fields length-n tensors)."""

    #: (n, 3) lower corners (conservatively rounded down).
    min: torch.Tensor
    #: (n, 3) upper corners (conservatively rounded up).
    max: torch.Tensor
    #: (n, 3) int32 vertex ids in the encoding described above.
    vertex_ids: torch.Tensor
    #: (n,) int32 id of the vertex/edge/face this box bounds.
    element_id: torch.Tensor

    @property
    def n(self) -> int:
        return self.min.shape[0]


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of the same sign (flush-to-zero)."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, x * 0, x)


def _conservative_bounds(lo, hi, inflation_radius, dtype):
    """Widen [lo, hi] outward by one ulp and an up-rounded inflation radius.

    Cast to ``dtype`` first, then ``nextafter`` (``aabb.py:57-64`` of the JAX
    package), with its flush-to-zero arithmetic (module docstring).
    """
    lo = _flush(lo.to(dtype))
    hi = _flush(hi.to(dtype))
    inf = torch.full((), float("inf"), dtype=dtype, device=lo.device)
    r = torch.full((), float(inflation_radius), dtype=dtype, device=lo.device)
    inf_r = _flush(torch.nextafter(r, inf))
    lo = _flush(_flush(torch.nextafter(lo, -inf)) - inf_r)
    hi = _flush(_flush(torch.nextafter(hi, inf)) + inf_r)
    return lo, hi


def build_vertex_boxes(
    vertices_t0: torch.Tensor,
    vertices_t1: Optional[torch.Tensor] = None,
    inflation_radius: float = 0.0,
    dtype=torch.float32,
) -> AABBs:
    """Boxes around (possibly linearly moving) vertices (``aabb.cpp:38-92``).

    The min/max over the two endpoint positions is taken in the input
    precision, then cast and ulp-widened.
    """
    v0 = vertices_t0
    if vertices_t1 is None:
        lo = hi = v0
    else:
        lo = torch.minimum(v0, vertices_t1)
        hi = torch.maximum(v0, vertices_t1)
    lo, hi = _conservative_bounds(lo, hi, inflation_radius, dtype)
    ids = torch.arange(lo.shape[0], dtype=torch.int32, device=lo.device)
    vertex_ids = torch.stack([ids, -ids - 1, -ids - 1], dim=1)
    return AABBs(min=lo, max=hi, vertex_ids=vertex_ids, element_id=ids)


def build_edge_boxes(vertex_boxes: AABBs, edges: torch.Tensor) -> AABBs:
    """Union of the two vertex boxes of each edge (``aabb.cpp:94-112``);
    unioning conservative boxes is exact, so no further widening."""
    e = edges.to(torch.int64)
    lo = torch.minimum(vertex_boxes.min[e[:, 0]], vertex_boxes.min[e[:, 1]])
    hi = torch.maximum(vertex_boxes.max[e[:, 0]], vertex_boxes.max[e[:, 1]])
    e32 = edges.to(torch.int32)
    vertex_ids = torch.stack([e32[:, 0], e32[:, 1], -e32[:, 0] - 1], dim=1)
    element_id = torch.arange(e.shape[0], dtype=torch.int32, device=lo.device)
    return AABBs(min=lo, max=hi, vertex_ids=vertex_ids, element_id=element_id)


def build_face_boxes(vertex_boxes: AABBs, faces: torch.Tensor) -> AABBs:
    """Union of the three vertex boxes of each face (``aabb.cpp:114-133``)."""
    f = faces.to(torch.int64)
    vmin, vmax = vertex_boxes.min, vertex_boxes.max
    lo = torch.minimum(torch.minimum(vmin[f[:, 0]], vmin[f[:, 1]]), vmin[f[:, 2]])
    hi = torch.maximum(torch.maximum(vmax[f[:, 0]], vmax[f[:, 1]]), vmax[f[:, 2]])
    element_id = torch.arange(f.shape[0], dtype=torch.int32, device=lo.device)
    return AABBs(
        min=lo, max=hi, vertex_ids=faces.to(torch.int32), element_id=element_id
    )
