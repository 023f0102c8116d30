"""Sorted sweep broad phase: sorting, list merging and the pair filters.

PyTorch counterpart of ``scalable_ccd_tpu/broad_phase/sweep.py`` (the
reference's ``sweep.cu:101-182`` and ``sort_and_sweep.cpp``).  Boxes are
sorted by their major-axis lower bound; every candidate partner of box ``i``
is then a later box ``j`` with ``major_min[j] <= major_max[i]``.  The sweep
itself (kernel A and its plain twin) lives in
:mod:`scalable_ccd_tpu_torch.ops.sweep_ap`.

Filters (reference ``cuda/broad_phase/collision.cuh``):
- minor-axis overlap (``MiniBox::intersects``, aabb.cuh:100-104);
- two-list validity: the ids must have opposite signs (``is_valid_pair``);
- no shared vertex: nine integer compares (``share_a_vertex``).

Emit convention (``sweep.cu:152-164``): one-list pairs are (min, max) of
element ids; two-list pairs are (flip(min), max) = (list-A element id,
list-B element id), where ``flip(id) = -id - 1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scalable_ccd_tpu_torch.geometry.aabb import AABBs

__all__ = [
    "SortedBoxes",
    "sort_boxes",
    "merge_two_lists",
    "flip_id",
    "pair_filters",
    "emit_pairs",
]


class SortedBoxes(NamedTuple):
    """Boxes sorted by major-axis lower bound, split into major interval and
    minor mini-box (the reference's ``DeviceAABBs``, aabb.cuh:122-150)."""

    major_min: torch.Tensor  # (n,)
    major_max: torch.Tensor  # (n,)
    minor_min: torch.Tensor  # (n, 2)
    minor_max: torch.Tensor  # (n, 2)
    vertex_ids: torch.Tensor  # (n, 3) int32
    element_id: torch.Tensor  # (n,) int32

    @property
    def n(self) -> int:
        return self.major_min.shape[0]


_MINOR_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def sort_boxes(boxes: AABBs, axis=0, bucket_minor: bool = False) -> SortedBoxes:
    """Sort boxes along ``axis`` (0/1/2, or ``"auto"`` for the axis of largest
    box-center variance) and split into major/minor arrays.

    The key is ``major_min`` and the sort is stable, so ties keep input order
    exactly as the JAX package's ``jnp.argsort`` does (which also orders
    ``-0.0`` and ``0.0`` as equal).

    ``bucket_minor`` is the congestion ordering (JAX ``sort_boxes``,
    ``broad_phase/sweep.py:171-200``): the minor axis of wider center spread
    moves into slot 0, and the key becomes ``bucket + frac``, one f32 per
    box whatever the box dtype, where ``bucket`` quantizes ``major_min`` by
    4x the mean major extent and ``frac`` is the box's position along minor
    axis 0.  Thousands of
    near-equal-major boxes of a congested scene then order coherently along
    the minor axis, which makes the sweep's row skip fire.  ``major_min`` is
    no longer sorted, so only the kernel sweeps with ``any_order`` may read
    such boxes (:mod:`scalable_ccd_tpu_torch.ops.sweep_ap`).
    """
    if axis == "auto":
        var = torch.var(boxes.min + boxes.max, dim=0, correction=0)
        perm = torch.argsort(-var, stable=True)
        pmin = boxes.min[:, perm]
        pmax = boxes.max[:, perm]
        major_min, major_max = pmin[:, 0], pmax[:, 0]
        minor_min, minor_max = pmin[:, 1:], pmax[:, 1:]
    else:
        m0, m1 = _MINOR_AXES[axis]
        major_min = boxes.min[:, axis]
        major_max = boxes.max[:, axis]
        # stacked columns, not a list index: a list index is copied to the
        # card first, and that copy waits for it
        minor_min = torch.stack((boxes.min[:, m0], boxes.min[:, m1]), dim=1)
        minor_max = torch.stack((boxes.max[:, m0], boxes.max[:, m1]), dim=1)
    key = major_min
    if bucket_minor:
        # the key and the row unions use minor axis 0: put the wider-spread
        # minor there (the minor filters are symmetric in the two axes)
        # (chosen on the device: a host read here would wait for the card)
        mvar = torch.var(minor_min + minor_max, dim=0, correction=0)
        swap = mvar[1] > mvar[0]
        minor_min = torch.where(swap, minor_min.flip(1), minor_min)
        minor_max = torch.where(swap, minor_max.flip(1), minor_max)
        extent = torch.clamp(major_max - major_min, min=0.0).mean()
        q = torch.where(extent > 0, 4.0 * extent, torch.ones_like(extent))
        bucket = torch.floor(major_min / q)
        m0 = minor_min[:, 0]
        mlo = m0.min()
        mspan = torch.clamp(m0.max() - mlo, min=1e-30)
        frac = torch.clamp((m0 - mlo) / mspan, 0.0, 1.0 - 1e-7)
        key = ((bucket - bucket.min()) + frac).to(torch.float32)
    order = torch.sort(key, stable=True).indices
    return SortedBoxes(
        major_min=major_min[order].contiguous(),
        major_max=major_max[order].contiguous(),
        minor_min=minor_min[order].contiguous(),
        minor_max=minor_max[order].contiguous(),
        vertex_ids=boxes.vertex_ids[order].contiguous(),
        element_id=boxes.element_id[order].contiguous(),
    )


def flip_id(ids: torch.Tensor) -> torch.Tensor:
    """Reversible negative tagging, ``flip_id(id) = -id - 1``
    (reference ``collision.cuh:11``)."""
    return -ids - 1


def merge_two_lists(boxes_a: AABBs, boxes_b: AABBs) -> AABBs:
    """Tag list A with negative element ids and concatenate with list B
    (the sort in :func:`sort_boxes` does the reference's merge,
    ``broad_phase.cu:70-96``)."""
    return AABBs(
        min=torch.cat([boxes_a.min, boxes_b.min]),
        max=torch.cat([boxes_a.max, boxes_b.max]),
        vertex_ids=torch.cat([boxes_a.vertex_ids, boxes_b.vertex_ids]),
        element_id=torch.cat([flip_id(boxes_a.element_id), boxes_b.element_id]),
    )


def pair_filters(sorted_boxes: SortedBoxes, i, j, is_two_lists: bool):
    """Minor-axis overlap + list validity + shared-vertex filters for sorted
    positions ``(i, j)`` (``_pair_filters``, JAX ``sweep.py:309-327``)."""
    a_min, a_max = sorted_boxes.minor_min[i], sorted_boxes.minor_max[i]
    b_min, b_max = sorted_boxes.minor_min[j], sorted_boxes.minor_max[j]
    keep = ((a_min <= b_max) & (b_min <= a_max)).all(dim=-1)
    a_vid = sorted_boxes.vertex_ids[i]
    b_vid = sorted_boxes.vertex_ids[j]
    keep &= ~(a_vid[:, :, None] == b_vid[:, None, :]).flatten(1).any(dim=1)
    if is_two_lists:
        keep &= (sorted_boxes.element_id[i] >= 0) != (sorted_boxes.element_id[j] >= 0)
    return keep


def emit_pairs(a_eid: torch.Tensor, b_eid: torch.Tensor, is_two_lists: bool):
    """(n, 2) int32 pairs in the reference emit convention."""
    lo = torch.minimum(a_eid, b_eid)
    hi = torch.maximum(a_eid, b_eid)
    first = flip_id(lo) if is_two_lists else lo
    return torch.stack([first, hi], dim=1)
