"""O(n^2) brute-force broad phase, the broad-phase oracle.

The port's own copy of ``scalable_ccd_tpu/broad_phase/brute_force.py`` on
the port's :class:`AABBs`: a direct all-pairs box intersection in numpy with
the sweep's filters and emit convention, independent of every sweep (the
reference validates against downloaded ground-truth files,
``tests/ground_truth.cpp:27-64``).  The boxes' fields may be tensors on any
device or numpy arrays; test-scale inputs only.
"""

from __future__ import annotations

import numpy as np
import torch

from scalable_ccd_tpu_torch.geometry.aabb import AABBs

__all__ = ["brute_force_overlaps"]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def brute_force_overlaps(
    boxes_a: AABBs, boxes_b: AABBs | None = None, block: int = 2048
) -> np.ndarray:
    """All filtered overlapping pairs.

    One-list mode (``boxes_b is None``): pairs (min, max) of element ids over
    distinct boxes.  Two-list mode: pairs (a_element_id, b_element_id) for
    boxes from different lists.  Matches the sweep's emit convention
    (reference ``sweep.cu:152-164``).
    """
    if boxes_b is None:
        return _one_list(boxes_a, block)
    return _two_list(boxes_a, boxes_b, block)


def _intersect_blocks(amin, amax, bmin, bmax):
    return np.all(
        (amin[:, None, :] <= bmax[None, :, :]) & (bmin[None, :, :] <= amax[:, None, :]),
        axis=-1,
    )


def _share_vertex_blocks(avid, bvid):
    return np.any(avid[:, None, :, None] == bvid[None, :, None, :], axis=(-1, -2))


def _one_list(boxes: AABBs, block: int) -> np.ndarray:
    bmin, bmax = _np(boxes.min), _np(boxes.max)
    vid, eid = _np(boxes.vertex_ids), _np(boxes.element_id)
    n = bmin.shape[0]
    out = []
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        for j0 in range(i0, n, block):
            j1 = min(j0 + block, n)
            hit = _intersect_blocks(bmin[i0:i1], bmax[i0:i1], bmin[j0:j1], bmax[j0:j1])
            hit &= ~_share_vertex_blocks(vid[i0:i1], vid[j0:j1])
            ii, jj = np.nonzero(hit)
            gi, gj = ii + i0, jj + j0
            keep = gi < gj
            gi, gj = gi[keep], gj[keep]
            a, b = eid[gi], eid[gj]
            out.append(np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1))
    if not out:
        return np.zeros((0, 2), dtype=np.int32)
    pairs = np.concatenate(out, axis=0).astype(np.int32)
    return np.unique(pairs, axis=0)


def _two_list(boxes_a: AABBs, boxes_b: AABBs, block: int) -> np.ndarray:
    amin, amax = _np(boxes_a.min), _np(boxes_a.max)
    bmin, bmax = _np(boxes_b.min), _np(boxes_b.max)
    avid, bvid = _np(boxes_a.vertex_ids), _np(boxes_b.vertex_ids)
    aeid, beid = _np(boxes_a.element_id), _np(boxes_b.element_id)
    out = []
    for i0 in range(0, amin.shape[0], block):
        i1 = min(i0 + block, amin.shape[0])
        for j0 in range(0, bmin.shape[0], block):
            j1 = min(j0 + block, bmin.shape[0])
            hit = _intersect_blocks(amin[i0:i1], amax[i0:i1], bmin[j0:j1], bmax[j0:j1])
            hit &= ~_share_vertex_blocks(avid[i0:i1], bvid[j0:j1])
            ii, jj = np.nonzero(hit)
            out.append(np.stack([aeid[ii + i0], beid[jj + j0]], axis=1))
    if not out:
        return np.zeros((0, 2), dtype=np.int32)
    pairs = np.concatenate(out, axis=0).astype(np.int32)
    return np.unique(pairs, axis=0)
