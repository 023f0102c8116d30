"""Kernel A's work units on the CPU: :func:`sweep_tiles`, the plain version
of the kernel's first two launches.

Each unit is a tile of ``TILE`` sorted boxes against one ``ROW``-partner
row of the tile's partner range (under ``any_order``, a row the row skip
keeps).  Expanded into ``(box, partner)`` slots, the units must hold no slot
twice and cover every slot of every box's run (under ``any_order``, every
one the row and group skips may not drop: those whose minor-0 intervals
meet), so every pair of :func:`sweep_positions` exactly once; the kernel's
per-slot tests applied to those slots must give the pair set of the plain
sweep.  No jax here: the file also runs on the card.
"""

import numpy as np
import pytest
import torch

from scalable_ccd_tpu_torch.broad_phase import SortedBoxes, merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.broad_phase.sweep import pair_filters
from scalable_ccd_tpu_torch.geometry import aabb, scenes
from scalable_ccd_tpu_torch.interop import from_numpy_scene
from scalable_ccd_tpu_torch.ops import sweep_ap

torch.set_num_threads(2)


def synthetic_boxes(n, seed=0, width=0.05, stacked=False, dtype=torch.float32,
                    device="cpu"):
    """``n`` sorted boxes made from ``seed`` with numpy, ids of two lists
    (about half negative, ``merge_two_lists``'s flipped ids); ``stacked``
    puts them all on one spot, so every run spans the rest of the array."""
    rng = np.random.default_rng(seed)
    if stacked:
        lo = np.zeros((n, 3)) + rng.uniform(0, 1e-3, (n, 3))
        hi = lo + 0.5
    else:
        lo = rng.uniform(0, 1, (n, 3))
        hi = lo + rng.uniform(0, width, (n, 3)) * rng.uniform(0, 2, (n, 1)) ** 3
    order = np.argsort(lo[:, 0], kind="stable")
    lo, hi = lo[order], hi[order]
    vid = rng.integers(0, 2 * n + 3, (n, 3))
    eid = np.arange(n)
    eid = np.where(rng.uniform(size=n) < 0.5, -eid - 1, eid)
    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,  # noqa: E731
                                            device=device)
    return SortedBoxes(t(lo[:, 0]), t(hi[:, 0]), t(lo[:, 1:]), t(hi[:, 1:]),
                       t(vid, torch.int32), t(eid, torch.int32))


def scene_boxes(two_lists, bucket=False, dtype=torch.float32, device="cpu"):
    """The sorted VF (``two_lists``) or EE boxes of ``cloth_on_sphere(16, 2,
    0.3)``, in the congestion ordering if ``bucket``."""
    s = from_numpy_scene(scenes.cloth_on_sphere(grid_n=16, sphere_subdiv=2, drop=0.3), device)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=dtype)
    boxes = (merge_two_lists(vb, aabb.build_face_boxes(vb, s.faces)) if two_lists
             else aabb.build_edge_boxes(vb, s.edges))
    return sort_boxes(boxes, bucket_minor=bucket)


def unit_slots(sb, box_range, begin, end, prefix, any_order=False, planes=None):
    """``(i, j)`` int64: every slot the kernel's units visit, ``j > i``.
    A tile's units are the rows its range touches, under ``any_order`` only
    those whose minor-0 union meets the tile's, and their count must be the
    tile's share of ``prefix``; under ``any_order`` a group of 32 partners
    (counted from the unit's first partner) whose own union misses the
    tile's is skipped too, as the kernel skips it."""
    b0, b1 = box_range
    n_tiles = begin.numel()
    row0, row1 = begin // sweep_ap.ROW, (end - 1) // sweep_ap.ROW
    n_rows = torch.where(end > begin, row1 - row0 + 1, 0)
    tile = torch.repeat_interleave(torch.arange(n_tiles), n_rows)
    row = row0[tile] + torch.arange(tile.numel()) - (torch.cumsum(n_rows, 0) - n_rows)[tile]
    if any_order:
        lane = (b0 + sweep_ap.TILE * torch.arange(n_tiles))[:, None] + torch.arange(sweep_ap.TILE)
        inside = lane < b1
        lane = lane.clamp(max=b1 - 1)
        u_lo = torch.where(inside, sb.minor_min[lane, 0], float("inf")).amin(dim=1)[tile]
        u_hi = torch.where(inside, sb.minor_max[lane, 0], -float("inf")).amax(dim=1)[tile]
        keep = (planes.row_umin[row] <= u_hi) & (planes.row_umax[row] >= u_lo)
        tile, row, u_lo, u_hi = tile[keep], row[keep], u_lo[keep], u_hi[keep]
    assert torch.equal(torch.bincount(tile, minlength=n_tiles), prefix[1:] - prefix[:-1])
    j = torch.maximum(row * sweep_ap.ROW, begin[tile])[:, None] + torch.arange(sweep_ap.ROW)
    j_ok = j < torch.minimum((row + 1) * sweep_ap.ROW, end[tile])[:, None]
    if any_order:
        groups = j.view(-1, sweep_ap.ROW // 32, 32).clamp(max=sb.n - 1)
        ok = j_ok.view(groups.shape)
        g_lo = torch.where(ok, sb.minor_min[groups, 0], float("inf")).amin(dim=2)
        g_hi = torch.where(ok, sb.minor_max[groups, 0], -float("inf")).amax(dim=2)
        hit = (g_lo <= u_hi[:, None]) & (g_hi >= u_lo[:, None])
        j_ok &= hit.repeat_interleave(32, dim=1)
    i = (b0 + sweep_ap.TILE * tile)[:, None] + torch.arange(sweep_ap.TILE)
    slot_i = i[:, :, None].expand(-1, -1, sweep_ap.ROW)
    slot_j = j[:, None, :].expand(-1, sweep_ap.TILE, -1)
    ok = j_ok[:, None, :] & (slot_i < b1) & (slot_j > slot_i)
    return slot_i[ok], slot_j[ok]


def run_slots(sb, box_range, any_order, planes):
    """``(i, j)``: every slot of every box's own run, ``[i + 1, reach_i)``."""
    b0, b1 = box_range
    stops = planes.fwd_min if any_order else sb.major_min
    reach = torch.searchsorted(stops, sb.major_max[b0:b1], right=True)
    i = torch.arange(b0, b1)
    k = (reach - i - 1).clamp(min=0)
    ii = torch.repeat_interleave(i, k)
    start = torch.repeat_interleave(torch.cumsum(k, 0) - k, k)
    return ii, ii + 1 + torch.arange(ii.numel()) - start


def _keys(i, j, n):
    return i * n + j


CASES = {
    **{f"ragged{n}": (lambda n=n: synthetic_boxes(n, seed=n)) for n in (1, 2, 127, 128, 129, 1000)},
    "stacked": lambda: synthetic_boxes(300, seed=7, stacked=True),
    "vf": lambda: scene_boxes(True),
    "ee": lambda: scene_boxes(False),
    "vf_bucket": lambda: scene_boxes(True, bucket=True),
    "ee_bucket": lambda: scene_boxes(False, bucket=True),
}


def box_ranges(n):
    """The whole range and ranges that start or end inside a tile."""
    out = [None, (0, min(n, 5)), (min(n, 33), min(n, 129)), (min(n, 100), n)]
    return [r for r in out if r is None or r[1] > r[0]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_units_cover_every_slot_once(name):
    sb = CASES[name]()
    bucket = name.endswith("bucket")
    planes = sweep_ap.partner_planes(sb)
    for any_order in ([True] if bucket else [False, True]):
        for rng in box_ranges(sb.n):
            b0, b1 = (0, sb.n) if rng is None else rng
            begin, end, prefix = sweep_ap.sweep_tiles(sb, rng, any_order, planes)
            assert begin.numel() == -(-(b1 - b0) // sweep_ap.TILE)
            assert int(prefix[0]) == 0 and bool((prefix[1:] >= prefix[:-1]).all())
            si, sj = unit_slots(sb, (b0, b1), begin, end, prefix, any_order, planes)
            keys = _keys(si, sj, sb.n)
            assert keys.numel() == torch.unique(keys).numel(), "a slot is visited twice"
            ri, rj = run_slots(sb, (b0, b1), any_order, planes)
            if any_order:  # the skips drop only slots whose minor-0 intervals miss
                meet = ((sb.minor_min[rj, 0] <= sb.minor_max[ri, 0])
                        & (sb.minor_min[ri, 0] <= sb.minor_max[rj, 0]))
                ri, rj = ri[meet], rj[meet]
            assert bool(torch.isin(_keys(ri, rj, sb.n), keys).all()), "a run slot is missed"
            pairs = list(sweep_ap.sweep_positions(sb, True, rng, any_order, planes))
            pi = torch.cat([p[0] for p in pairs]) if pairs else torch.empty(0, dtype=torch.int64)
            pj = torch.cat([p[1] for p in pairs]) if pairs else torch.empty(0, dtype=torch.int64)
            pk = _keys(pi, pj, sb.n)
            assert bool(torch.isin(pk, keys).all()) and pk.numel() == torch.unique(pk).numel()


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_tests_on_units_give_the_plain_pair_set(name):
    """The kernel's per-slot tests (its own stop, the reverse major test
    under ``any_order``, the minor, list and shared-vertex filters) over the
    slots of the units it visits give exactly the plain sweep's pairs."""
    sb = CASES[name]()
    bucket = name.endswith("bucket")
    planes = sweep_ap.partner_planes(sb)
    two = not name.startswith("ee")
    for any_order in ([True] if bucket else [False, True]):
        for rng in box_ranges(sb.n):
            b0, b1 = (0, sb.n) if rng is None else rng
            begin, end, prefix = sweep_ap.sweep_tiles(sb, rng, any_order, planes)
            i, j = unit_slots(sb, (b0, b1), begin, end, prefix, any_order, planes)
            keep = sb.major_min[j] <= sb.major_max[i]
            if any_order:
                keep &= sb.major_min[i] <= sb.major_max[j]
            keep &= pair_filters(sb, i, j, two)
            got = torch.sort(_keys(i[keep], j[keep], sb.n)).values
            want = [_keys(p, q, sb.n) for p, q in sweep_ap.sweep_positions(
                sb, two, rng, any_order, planes)]
            want = torch.sort(torch.cat(want)).values if want else got[:0]
            assert torch.equal(got, want)


def test_tiles_of_a_stack_span_many_rows():
    """A stack of co-located boxes: one run is longer than a row, so a tile
    owns several units."""
    sb = CASES["stacked"]()
    begin, end, prefix = sweep_ap.sweep_tiles(sb)
    assert int(end[0]) == sb.n and int(prefix[1]) > 1
    assert int(prefix[-1]) == int((prefix[1:] - prefix[:-1]).sum())
