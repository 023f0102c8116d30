"""Kernel A''s work units on the CPU: :func:`sweep_record_units`, the plain
version of the kernel's first two launches, and the kernel's per-unit
tests and mask transpose, emulated.

A unit is a record's a-row of ``ROW`` sorted boxes against one
``ROW``-partner row of the a-row's partner range (under ``any_order``, a
row the row skip keeps).  Inside a unit the kernel tests four sub-tiles of
32 boxes against groups of 32 partners, skipping a sub-tile and group whose
minor-0 unions miss.  Expanded into ``(box, partner)`` slots, the units must
hold no slot twice and cover every slot of every box's run whose minor-0
intervals meet; the per-slot tests over those slots, gathered into records
by the kernel's ballot transpose (bit ``l`` of partner ``u``'s word is bit
``u`` of lane ``l``'s mask), must give :func:`sweep_records_reference`'s
record multiset and exact totals.  No jax here: the file also runs on the
card.
"""

import numpy as np
import pytest
import torch
from test_torch_sweep_tiles import CASES, _keys, run_slots, synthetic_boxes

from scalable_ccd_tpu_torch.broad_phase.sweep import pair_filters
from scalable_ccd_tpu_torch.ops import sweep_ap, sweep_records

torch.set_num_threads(2)

ROW = sweep_ap.ROW
INF = float("inf")


def orders(name):
    """The orderings a case runs: the congestion-ordered cases only under
    ``any_order``."""
    return [True] if name.endswith("bucket") else [False, True]


def record_units(sb, any_order, planes, row_range=None):
    """``(a_row, j0, m)`` per unit in unit order: the a-row (absolute), and
    its ``m`` partners from position ``j0``; the units per a-row of
    ``row_range`` (``None``: every a-row) must be its share of the
    prefix."""
    begin, end, prefix = sweep_records.sweep_record_units(sb, any_order, planes, row_range)
    r0 = 0 if row_range is None else row_range[0]
    n_rows = begin.numel()
    if row_range is None:
        assert n_rows == -(-sb.n // ROW)
    assert torch.equal(begin, ROW * (r0 + torch.arange(n_rows)) + 1)
    assert int(prefix[0]) == 0 and bool((prefix[1:] >= prefix[:-1]).all())
    row0, row1 = begin // ROW, (end - 1) // ROW
    rows = torch.where(end > begin, row1 - row0 + 1, 0)
    t = torch.repeat_interleave(torch.arange(n_rows), rows)
    p_row = row0[t] + torch.arange(t.numel()) - (torch.cumsum(rows, 0) - rows)[t]
    if any_order:
        lanes = ROW * (r0 + torch.arange(n_rows))[:, None] + torch.arange(ROW)
        inside, lanes = lanes < sb.n, lanes.clamp(max=sb.n - 1)
        u_lo = torch.where(inside, sb.minor_min[lanes, 0], INF).amin(dim=1)[t]
        u_hi = torch.where(inside, sb.minor_max[lanes, 0], -INF).amax(dim=1)[t]
        kept = (planes.row_umin[p_row] <= u_hi) & (planes.row_umax[p_row] >= u_lo)
        t, p_row = t[kept], p_row[kept]
    assert torch.equal(torch.bincount(t, minlength=n_rows), prefix[1:] - prefix[:-1])
    j0 = torch.maximum(p_row * ROW, begin[t])
    return r0 + t, j0, torch.minimum(p_row * ROW + ROW, end[t]) - j0


def unit_slots(sb, a_row, j0, m):
    """``(i, j, visit)``, ``(U, ROW, ROW)``: a-lane ``a`` of each unit's
    a-row against its partner ``p``; ``visit`` where both exist, ``j > i``
    and the sub-tile of ``a`` and the group of ``p`` have meeting minor-0
    unions."""
    n = sb.n
    i = a_row[:, None, None] * ROW + torch.arange(ROW)[None, :, None]
    p = torch.arange(ROW)[None, None, :]
    j = j0[:, None, None] + p
    a_in, p_in = i < n, p < m[:, None, None]
    lo, hi = sb.minor_min[:, 0], sb.minor_max[:, 0]
    ic, jc = i.clamp(max=n - 1), j.clamp(max=n - 1)
    s_lo = torch.where(a_in, lo[ic], INF).view(-1, 4, 32).amin(dim=2)
    s_hi = torch.where(a_in, hi[ic], -INF).view(-1, 4, 32).amax(dim=2)
    g_lo = torch.where(p_in, lo[jc], INF).view(-1, 4, 32).amin(dim=2)
    g_hi = torch.where(p_in, hi[jc], -INF).view(-1, 4, 32).amax(dim=2)
    meet = (g_lo[:, None, :] <= s_hi[:, :, None]) & (g_hi[:, None, :] >= s_lo[:, :, None])
    meet = meet.repeat_interleave(32, dim=1).repeat_interleave(32, dim=2)
    visit = a_in & p_in & (j > i) & meet
    return i.expand_as(visit), j.expand_as(visit), visit


def emulated_records(sb, two, any_order, planes, row_range=None):
    """The kernel's records: its slot tests on the units (of the a-rows of
    ``row_range``), each lane's mask over a group of 32 partners, and the
    ballot transpose into one record per partner with a bit; ``(records
    sorted by row, n_records, n_pairs)``."""
    a_row, j0, m = record_units(sb, any_order, planes, row_range)
    i, j, visit = unit_slots(sb, a_row, j0, m)
    vi, vj = i[visit], j[visit]
    ok = (sb.major_min[vj] <= sb.major_max[vi]) & pair_filters(sb, vi, vj, two)
    if any_order:
        ok &= sb.major_min[vi] <= sb.major_max[vj]
    keep = torch.zeros_like(visit)
    keep[visit] = ok
    k = keep.view(-1, 4, 32, 4, 32).to(torch.int64)  # (unit, sub-tile, lane, group, u)
    bit = torch.arange(32)
    mask = (k << bit).sum(dim=-1)  # lane l's 32-bit mask over the group
    # ballot of bit u over the lanes: partner u's word of the sub-tile
    word = ((((mask[..., None] >> bit) & 1)) << bit[None, None, :, None, None]).sum(dim=2)
    word = word.permute(0, 2, 3, 1)  # (unit, group, u, sub-tile)
    has = word.sum(dim=-1) > 0
    jj = (j0[:, None, None] + 32 * torch.arange(4)[:, None] + bit)[has]
    rr = a_row[:, None, None].expand_as(has)[has]
    w = word[has]
    rec = torch.zeros((w.shape[0], sweep_records.REC_WORDS), dtype=torch.int64)
    rec[:, :4] = torch.where(w >= 2**31, w - 2**32, w)
    rec[:, 4], rec[:, 5] = jj, rr
    return sort_rows(rec.numpy()), w.shape[0], int(keep.sum())


def sort_rows(r):
    return r[np.lexsort(r.T[::-1])]


@pytest.mark.parametrize("name", sorted(CASES))
def test_record_units_cover_every_slot_once(name):
    sb = CASES[name]()
    planes = sweep_ap.partner_planes(sb)
    for any_order in orders(name):
        a_row, j0, m = record_units(sb, any_order, planes)
        i, j, visit = unit_slots(sb, a_row, j0, m)
        keys = _keys(i[visit], j[visit], sb.n)
        assert keys.numel() == torch.unique(keys).numel(), "a slot is visited twice"
        ri, rj = run_slots(sb, (0, sb.n), any_order, planes)
        meet = ((sb.minor_min[rj, 0] <= sb.minor_max[ri, 0])
                & (sb.minor_min[ri, 0] <= sb.minor_max[rj, 0]))
        assert bool(torch.isin(_keys(ri[meet], rj[meet], sb.n), keys).all()), \
            "a run slot is missed"


@pytest.mark.parametrize("name", sorted(CASES))
def test_unit_tests_and_transpose_give_the_plain_records(name):
    """The kernel's slot tests over its units, gathered by the ballot
    transpose, give exactly the plain version's record multiset, record
    total and pair total."""
    sb = CASES[name]()
    planes = sweep_ap.partner_planes(sb)
    two = not name.startswith("ee")
    for any_order in orders(name):
        got, n_rec, n_pairs = emulated_records(sb, two, any_order, planes)
        p = sweep_records.sweep_records_reference(sb, two, 1 << 20, any_order=any_order,
                                                  planes=planes)
        assert (n_rec, n_pairs) == (int(p[1]), int(p[2])), (name, any_order)
        want = sort_rows(p[0][: int(p[1])].to(torch.int64).numpy())
        assert np.array_equal(got, want), (name, any_order)


def test_record_units_of_a_stack_span_many_rows():
    """A stack of 1000 co-located boxes: every a-row's range runs to the
    end, so the first a-row owns one unit per partner row, and the emulated
    records still equal the plain ones."""
    sb = synthetic_boxes(1000, seed=11, stacked=True)
    begin, end, prefix = sweep_records.sweep_record_units(sb)
    assert bool((end == sb.n).all()) and int(prefix[1]) == -(-sb.n // ROW)
    got, n_rec, n_pairs = emulated_records(sb, True, False, sweep_ap.partner_planes(sb))
    p = sweep_records.sweep_records_reference(sb, True, 1 << 20)
    assert (n_rec, n_pairs) == (int(p[1]), int(p[2])) and n_rec > 1000
    assert np.array_equal(got, sort_rows(p[0][: int(p[1])].to(torch.int64).numpy()))


def row_ranges(n):
    """Ranges of a-rows: empty, one a-row, cut mid-array, all a-rows."""
    rows = -(-n // ROW)
    out = [(0, 0), (0, 1), (rows // 2, rows), (max(rows - 1, 0), rows + 3), (0, rows)]
    return out + [(1, 3)] if rows >= 3 else out


@pytest.mark.parametrize("name", sorted(CASES))
def test_record_units_of_a_row_range(name):
    """The units of a row range are the whole sweep's units of its a-rows;
    the emulated kernel on them gives the plain version's records of the
    range; and the records of partitions of the a-rows into 2 and 4 ranges
    (a rank's share each, as the multi-device path cuts them) are the whole
    multiset, in both orderings."""
    sb = CASES[name]()
    planes = sweep_ap.partner_planes(sb)
    two = not name.startswith("ee")
    rows = -(-sb.n // ROW)
    for any_order in orders(name):
        whole = sweep_records.sweep_records_reference(sb, two, 1 << 20, any_order=any_order,
                                                      planes=planes)
        all_rows = sort_rows(whole[0][: int(whole[1])].to(torch.int64).numpy())
        wa, wj, wm = record_units(sb, any_order, planes)
        for rng in row_ranges(sb.n):
            a_row, j0, m = record_units(sb, any_order, planes, rng)
            inside = (wa >= rng[0]) & (wa < min(rng[1], rows))
            assert torch.equal(a_row, wa[inside]) and torch.equal(j0, wj[inside])
            assert torch.equal(m, wm[inside])
            got, n_rec, n_pairs = emulated_records(sb, two, any_order, planes, rng)
            p = sweep_records.sweep_records_reference(sb, two, 1 << 20, any_order=any_order,
                                                      planes=planes, row_range=rng)
            assert (n_rec, n_pairs) == (int(p[1]), int(p[2])), (name, any_order, rng)
            want = sort_rows(p[0][: int(p[1])].to(torch.int64).numpy())
            assert np.array_equal(got, want), (name, any_order, rng)
            assert bool(((p[0][: int(p[1]), 5] >= rng[0]) & (p[0][: int(p[1]), 5] < rng[1])).all())
        for world in (2, 4):
            per = -(-rows // world)
            parts = [sweep_records.sweep_records_reference(
                sb, two, 1 << 20, any_order=any_order, planes=planes,
                row_range=(min(s * per, rows), (s + 1) * per)) for s in range(world)]
            assert sum(int(q[2]) for q in parts) == int(whole[2])
            union = np.concatenate([q[0][: int(q[1])].to(torch.int64).numpy() for q in parts])
            assert np.array_equal(sort_rows(union), all_rows), (name, any_order, world)


def test_row_range_is_checked():
    sb = CASES["ragged129"]()
    for bad in ((-1, 1), (3, 4), (1, 0)):
        with pytest.raises(ValueError, match="row_range"):
            sweep_records.sweep_records(sb, True, 64, row_range=bad)
