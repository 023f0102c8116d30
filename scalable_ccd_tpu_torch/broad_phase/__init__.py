"""Broad phase: sorting, list merging and the pair filters (the sweep
kernels are in :mod:`scalable_ccd_tpu_torch.ops.sweep_ap`)."""

from scalable_ccd_tpu_torch.broad_phase.brute_force import brute_force_overlaps
from scalable_ccd_tpu_torch.broad_phase.sweep import (
    SortedBoxes,
    emit_pairs,
    flip_id,
    merge_two_lists,
    pair_filters,
    sort_boxes,
)

__all__ = [
    "SortedBoxes",
    "brute_force_overlaps",
    "emit_pairs",
    "flip_id",
    "merge_two_lists",
    "pair_filters",
    "sort_boxes",
]
