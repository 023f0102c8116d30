"""PyTorch port vs the JAX package: the congestion ordering, kernel A's
``any_order`` mode and kernel A' (record emission) with its decode, on the CPU.

The JAX kernels run in Pallas interpret mode on the scenes of
``tests/test_pallas_sweep_ap.py:148-300``; the port runs the plain versions
of its kernels.  Bars: the bucket-ordered sort bitwise (same permutation),
pair sets and totals exactly, record multisets exactly, decoded pairs as
sets, and the auto policies as functions of the box counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu.broad_phase import merge_two_lists as jmerge
from scalable_ccd_tpu.broad_phase import sort_boxes as jsort
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.ops import pallas_sweep_ap as jap
from scalable_ccd_tpu_torch.broad_phase import sort_boxes
from scalable_ccd_tpu_torch.interop import from_numpy_boxes
from scalable_ccd_tpu_torch.ops import sweep_ap, sweep_records
from scalable_ccd_tpu_torch.pipeline import fused as port_fused

torch.set_num_threads(2)

F32 = jnp.float32


def _merged(two_lists):
    """The JAX package's unsorted boxes of one phase of the sweep tests'
    cloth scene."""
    s = jscenes.cloth_on_sphere(grid_n=14, sphere_subdiv=1, drop=0.35)
    vb = jaabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=F32)
    if two_lists:
        return jmerge(vb, jaabb.build_face_boxes(vb, s.faces))
    return jaabb.build_edge_boxes(vb, s.edges)


def _set(pairs, n):
    return set(map(tuple, np.asarray(pairs[: int(n)]).tolist()))


@pytest.fixture(scope="module")
def phases():
    """``{two_lists: (JAX boxes, JAX bucket-sorted boxes, port boxes)}``."""
    return {two: (m, jsort(m, bucket_minor=True), from_numpy_boxes(m))
            for two in (True, False) for m in [_merged(two)]}


@pytest.mark.parametrize("two_lists", [True, False])
def test_bucket_sort_matches_jax(phases, two_lists):
    """Same minor-axis swap, same composite key, same stable order: every
    field bitwise.  The mean extent is a float32 reduction whose order
    differs between the frameworks; on these scenes it lands on the same
    value, so the keys and the permutation agree exactly."""
    _, jsb, boxes = phases[two_lists]
    sb = sort_boxes(boxes, bucket_minor=True)
    for name in sb._fields:
        assert np.array_equal(np.asarray(getattr(jsb, name)),
                              getattr(sb, name).numpy()), name
    major = sb.major_min.numpy()
    assert (np.diff(major) < 0).any(), "the ordering is the major sort; test is vacuous"


def test_bucket_sort_swaps_the_wider_minor_axis():
    """A scene spread along z and flat along y sorts with z in minor slot 0
    in both packages."""
    rng = np.random.default_rng(3)
    c = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32) * np.array([1.0, 1e-3, 5.0], np.float32)
    mn, mx = c - 0.01, c + 0.01
    ids = np.arange(64, dtype=np.int32)
    jb = jaabb.AABBs(min=jnp.asarray(mn), max=jnp.asarray(mx),
                     vertex_ids=jnp.asarray(np.stack([ids, ids + 64, ids + 128], 1)),
                     element_id=jnp.asarray(ids))
    jsb = jsort(jb, bucket_minor=True)
    sb = sort_boxes(from_numpy_boxes(jb), bucket_minor=True)
    assert np.array_equal(np.sort(sb.minor_min[:, 0].numpy()), np.sort(mn[:, 2]))
    for name in sb._fields:
        assert np.array_equal(np.asarray(getattr(jsb, name)), getattr(sb, name).numpy()), name


@pytest.mark.parametrize("two_lists", [True, False])
def test_any_order_sweep_matches_jax(phases, two_lists):
    """Plain ``any_order`` pairs equal JAX ``pallas_sweep_pairs(any_order=
    True)`` as sets with the same total, and equal the major sort's set."""
    _, jsb, boxes = phases[two_lists]
    packed, n = jap.pack_boxes_ap(jsb)
    jp, jn, jt, jovf = jap.pallas_sweep_pairs(packed, n, two_lists, budget=1 << 15,
                                              interpret=True, any_order=True)
    sb = sort_boxes(boxes, bucket_minor=True)
    p, n_p, n_t, ovf = sweep_ap.sweep_pairs(sb, two_lists, 1 << 15, any_order=True)
    assert not bool(ovf) and not bool(jovf)
    assert int(n_t) == int(jt) == int(n_p) > 0
    got = _set(p, n_p)
    assert got == _set(jp, jn)
    major = sort_boxes(boxes)
    assert got == _set(*sweep_ap.sweep_pairs(major, two_lists, 1 << 15)[:2])
    # under the major sort the mode changes nothing
    assert _set(*sweep_ap.sweep_pairs(major, two_lists, 1 << 15, any_order=True)[:2]) == got


def test_partner_planes():
    boxes = from_numpy_boxes(_merged(False))
    sb = sort_boxes(boxes, bucket_minor=True)
    pl = sweep_ap.partner_planes(sb)
    mm = sb.major_min.numpy()
    assert np.array_equal(pl.fwd_min.numpy(), np.minimum.accumulate(mm[::-1])[::-1])
    rows = -(-sb.n // 128)
    assert pl.row_umin.shape == (rows,) and pl.row_umax.shape == (rows,)
    for r in (0, rows - 1):
        sl = slice(128 * r, 128 * (r + 1))
        assert float(pl.row_umin[r]) == float(sb.minor_min[sl, 0].min())
        assert float(pl.row_umax[r]) == float(sb.minor_max[sl, 0].max())
    assert np.array_equal(sweep_ap.partner_planes(sort_boxes(boxes)).fwd_min.numpy(),
                          sort_boxes(boxes).major_min.numpy())


def _jax_records(recs, n_recs):
    """JAX's tiled ``(rec_rows, 128)`` buffer as ``(n_recs, 8)`` rows."""
    return np.asarray(recs).reshape(-1, 8)[: int(n_recs)]


def _rows_sorted(words):
    return words[np.lexsort(words.T[::-1])]


@pytest.mark.parametrize("two_lists,any_order", [(True, True), (False, False),
                                                  (False, True)])
def test_records_match_jax(phases, two_lists, any_order):
    """The plain record multiset (words 0-5) equals JAX
    ``pallas_sweep_records``'s on the same sorted boxes, with the same
    ``n_records`` and ``n_pairs``; the port's decode of its records gives
    JAX's decoded pair set; the port's decode and sampler, run on JAX's own
    records, give JAX's pairs row for row."""
    m, jsb_bucket, _ = phases[two_lists]
    jsb = jsb_bucket if any_order else jsort(m)
    packed, n = jap.pack_boxes_ap(jsb)
    jrec, jnr, jnp_, jovf = jap.pallas_sweep_records(
        packed, n, two_lists, pair_budget=1 << 15, interpret=True,
        any_order=any_order, layout="mxu16")
    sb = from_numpy_boxes(jsb)
    rec, n_rec, n_pairs, ovf = sweep_records.sweep_records(sb, two_lists, 1 << 15,
                                                           any_order=any_order)
    assert not bool(ovf) and not bool(jovf)
    assert (int(n_rec), int(n_pairs)) == (int(jnr), int(jnp_))
    assert 0 < int(n_rec) < int(n_pairs)
    jr = _jax_records(jrec, jnr)
    assert np.array_equal(_rows_sorted(rec[: int(n_rec), :6].numpy()), _rows_sorted(jr[:, :6]))
    assert not rec[: int(n_rec), 6:].any()

    # decode: the port's records, batch by batch with the cursor
    jcum = jap.records_pair_prefix(jrec, jnr)
    ref, r_lo = [], jnp.int32(0)
    for start in range(0, int(jnp_), 512):
        chunk, r_lo = jap.decode_records_range(packed, jrec, jcum, jnp.int32(start), 512,
                                               jnp_, r_lo, two_lists)
        ref += list(map(tuple, np.asarray(chunk[: min(512, int(jnp_) - start)]).tolist()))
    cum = sweep_records.records_pair_prefix(rec, n_rec)
    assert int(cum[-1]) == int(n_pairs)
    got, cursor = [], 0
    for start in range(0, int(n_pairs), 300):
        stop = min(start + 300, int(n_pairs))
        chunk, cursor = sweep_records.decode_records_range(sb, rec, cum, start, stop,
                                                           cursor, two_lists)
        got += list(map(tuple, chunk.numpy().tolist()))
    assert len(got) == len(set(got)) == int(n_pairs)
    assert set(got) == set(ref)
    assert set(got) == _set(*sweep_ap.sweep_pairs(sb, two_lists, 1 << 15,
                                                  any_order=any_order)[:2])

    # the same functions on JAX's records, in JAX's record order
    tj = torch.tensor(jr)
    cum_j = sweep_records.records_pair_prefix(tj, int(jnr))
    assert np.array_equal(cum_j.numpy(), np.asarray(jcum)[: int(jnr)])
    whole, _ = sweep_records.decode_records_range(sb, tj, cum_j, 0, int(jnp_), 0, two_lists)
    assert list(map(tuple, whole.numpy().tolist())) == ref
    for batch in (64, 4096):
        jchunk, jvalid = jap.sample_first_pairs(packed, jrec, jcum, jnr, batch, two_lists)
        chunk = sweep_records.sample_first_pairs(sb, tj, int(jnr), batch, two_lists)
        assert np.array_equal(chunk.numpy(), np.asarray(jchunk)[np.asarray(jvalid)])


def test_records_budget_overflow_keeps_exact_totals():
    """A budget of 64 pairs overflows; the record and pair totals stay
    exact, and the buffer holds only whole records."""
    s = jscenes.triangle_soup(80, motion=0.25, seed=4)
    vb = jaabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=F32)
    sb = sort_boxes(from_numpy_boxes(jaabb.build_edge_boxes(vb, s.edges)))
    full = sweep_records.sweep_records(sb, False, 1 << 15)
    assert int(full[2]) > 64 and not bool(full[3])
    rec, n_rec, n_pairs, ovf = sweep_records.sweep_records(sb, False, 64)
    assert bool(ovf) and rec.shape == (64, 8)
    assert (int(n_rec), int(n_pairs)) == (int(full[1]), int(full[2]))
    held = min(int(n_rec), 64)
    assert torch.equal(rec[:held], full[0][:held])


def test_popcount32():
    rng = np.random.default_rng(0)
    x = rng.integers(-(2**31), 2**31, 4096, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, -(2**31), 2**31 - 1]
    want = np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x])
    assert np.array_equal(sweep_records.popcount32(torch.tensor(x)).numpy(), want)


def test_auto_policies_follow_box_counts():
    """``resolve_knobs`` as JAX ``fused_ccd`` resolves its auto knobs
    (``fused.py:1880-1947``): congestion ordering and the batch ladder from
    2^20 VF boxes, the frame pool and presample below; escalation at 128
    rounds on the global path only."""
    thr = port_fused.CONGESTION_MIN_BOXES
    assert thr == 1 << 20
    bench = port_fused.resolve_knobs(56_324, 56_321)
    assert bench == port_fused.Knobs(False, 128, "frame", True, True, "pairs")
    grid600 = port_fused.resolve_knobs(1_085_284, 1_085_281)
    assert grid600 == port_fused.Knobs(True, 128, "batch", False, False, "pairs")
    # presample per phase: an edge-heavy scene can straddle the threshold
    assert port_fused.resolve_knobs(thr - 1, thr)[3:5] == (True, False)
    assert port_fused.resolve_knobs(thr, 10).bucket_minor
    # escalation off with a cap; per-query and IPC modes take the ladder
    capped = port_fused.resolve_knobs(10, 10, max_iterations=100)
    assert capped.escalate_rounds == -1 and capped.escalate_pool == "batch"
    assert port_fused.resolve_knobs(10, 10, collisions=True).escalate_pool == "batch"
    assert port_fused.resolve_knobs(10, 10, ipc_refine=True).escalate_pool == "batch"
    assert port_fused.resolve_knobs(10, 10, escalate_rounds=(4, 16)).escalate_pool == "batch"
    # explicit values pass through
    forced = port_fused.resolve_knobs(10, 10, bucket_minor=True, escalate_rounds=-1,
                                      escalate_pool="batch", sweep_impl="records")
    assert forced == port_fused.Knobs(True, -1, "batch", True, True, "records")
    for auto in (None, -2):
        assert port_fused.resolve_auto_escalation(auto, -1) == 128
        assert port_fused.resolve_auto_escalation(auto, 10) == -1
    with pytest.raises(ValueError):
        port_fused.resolve_knobs(10, 10, sweep_impl="mxu16")
    with pytest.raises(ValueError):
        port_fused.resolve_knobs(10, 10, escalate_rounds=(8, 2))
    # the frame pool takes one limit on the global path; asked for elsewhere it raises
    for kw in (dict(escalate_rounds=(4, 16)), dict(escalate_rounds=-1), dict(collisions=True),
               dict(ipc_refine=True), dict(max_iterations=100)):
        with pytest.raises(ValueError, match="frame"):
            port_fused.resolve_knobs(10, 10, escalate_pool="frame", **kw)
