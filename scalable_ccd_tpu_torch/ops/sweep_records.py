"""Broad-phase sweep with bit-record emission: kernel A' (``csrc/sweep_records.cu``),
its plain twin, and the record decode.

Replaces the JAX package's ``pallas_sweep_records``
(``scalable_ccd_tpu/ops/pallas_sweep_ap.py:1356``) and ports its decode glue
(``records_pair_prefix``, ``decode_records_range``, ``_decode_record_bits``
and ``sample_first_pairs``, ``:1495-1642``), which is XLA code there and
plain PyTorch here.  The pair set is kernel A's
(:mod:`scalable_ccd_tpu_torch.ops.sweep_ap`, ``any_order`` included); it
leaves the sweep as records, one per (partner ``j``, 128-box a-row ``r``)
with a survivor ``i < j``: eight int32 words, ``w0..w3`` the 128-bit mask of
the surviving a-lanes (lane ``i % 128`` is bit ``i % 32`` of word
``(i % 128) // 32``), ``w4 = j``, ``w5 = r = i // 128``, ``w6 = w7 = 0``.
A narrow batch decodes its own range of pairs with a monotone record
cursor.  The TPU's ``layout`` knob (four ways to place the same records in
VMEM) and the a-side extent classing are not ported, so ``w5`` is always
``i // 128`` and the buffer is a plain ``(R, 8)`` tensor.

:func:`sweep_records` runs the CUDA kernel on CUDA tensors and the plain
version on CPU tensors; any other device raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import SortedBoxes, emit_pairs
from scalable_ccd_tpu_torch.ops._build import load_library
from scalable_ccd_tpu_torch.ops.sweep_ap import (
    ROW,
    check_boxes,
    partner_planes,
    sweep_positions,
)

__all__ = [
    "sweep_records",
    "sweep_records_reference",
    "popcount32",
    "records_pair_prefix",
    "decode_records_range",
    "decode_record_bits",
    "sample_first_pairs",
    "LAUNCHES",
    "LAUNCHES_BY_MODE",
    "REC_WORDS",
]

#: kernel launches made by :func:`sweep_records` in this process
LAUNCHES = 0

#: the same launches by ordering: "sorted" (the major sort) or "any_order"
LAUNCHES_BY_MODE = {"sorted": 0, "any_order": 0}

#: int32 words per record
REC_WORDS = 8


def _bind(lib):
    fn = lib.sccd_sweep_records
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_sweep_records_error_string.argtypes = [ctypes.c_int]
    lib.sccd_sweep_records_error_string.restype = ctypes.c_char_p
    return fn


def _budgets(pair_budget, rec_budget):
    pair_budget = int(pair_budget)
    rec_budget = int(rec_budget) if rec_budget and rec_budget > 0 else pair_budget
    return pair_budget, rec_budget


def sweep_records(sorted_boxes: SortedBoxes, is_two_lists: bool, pair_budget: int,
                  rec_budget: int = 0, any_order: bool = False, planes=None):
    """All candidate pairs of a sorted box set, as bit records.

    Returns ``(records, n_records, n_pairs, overflow)``: ``records`` is an
    ``(rec_budget, 8)`` int32 buffer whose first ``min(n_records,
    rec_budget)`` rows are records (module docstring); ``n_records`` and
    ``n_pairs`` (int64) are the exact record and pair totals even past the
    budgets; ``overflow`` is ``n_pairs > pair_budget`` or ``n_records >
    rec_budget``.  ``rec_budget`` defaults to ``pair_budget`` (every record
    holds a pair, so the pair budget overflows first).  ``any_order`` and
    ``planes`` are as in :func:`scalable_ccd_tpu_torch.ops.sweep_ap.
    sweep_pairs`.  On CUDA the record order is nondeterministic; on the CPU
    records come in (row, partner) order.
    """
    global LAUNCHES
    dev = sorted_boxes.major_min.device
    if any_order and planes is None:
        planes = partner_planes(sorted_boxes)
    if dev.type == "cpu":
        return sweep_records_reference(sorted_boxes, is_two_lists, pair_budget,
                                       rec_budget, any_order, planes)
    if dev.type != "cuda":
        raise ValueError(f"sweep_records: unsupported device {dev}")
    check_boxes(sorted_boxes, "sweep_records", planes if any_order else None)
    pair_budget, rec_budget = _budgets(pair_budget, rec_budget)
    records = torch.zeros((rec_budget, REC_WORDS), dtype=torch.int32, device=dev)
    n_records = torch.zeros((1,), dtype=torch.int64, device=dev)
    n_pairs = torch.zeros((1,), dtype=torch.int64, device=dev)
    n = sorted_boxes.n
    if n > 0:
        lib = load_library("sweep_records")
        fn = _bind(lib)
        sb = sorted_boxes
        pl = (planes.fwd_min.data_ptr(), planes.row_umin.data_ptr(),
              planes.row_umax.data_ptr()) if any_order else (None, None, None)
        with torch.cuda.device(dev):
            rc = fn(
                sb.major_min.data_ptr(), sb.major_max.data_ptr(),
                sb.minor_min.data_ptr(), sb.minor_max.data_ptr(),
                sb.vertex_ids.data_ptr(), sb.element_id.data_ptr(), *pl,
                n, int(bool(is_two_lists)), int(bool(any_order)),
                records.data_ptr(), rec_budget, n_records.data_ptr(),
                n_pairs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            msg = lib.sccd_sweep_records_error_string(rc).decode()
            raise RuntimeError(f"sweep_records kernel launch failed: {msg}")
        LAUNCHES += 1
        LAUNCHES_BY_MODE["any_order" if any_order else "sorted"] += 1
    n_records, n_pairs = n_records[0], n_pairs[0]
    return records, n_records, n_pairs, (n_pairs > pair_budget) | (n_records > rec_budget)


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def sweep_records_reference(sorted_boxes: SortedBoxes, is_two_lists: bool,
                            pair_budget: int, rec_budget: int = 0,
                            any_order: bool = False, planes=None):
    """Plain PyTorch twin of kernel A', on any device; same outputs as
    :func:`sweep_records`, records in (row, partner) order.  The pairs of
    :func:`scalable_ccd_tpu_torch.ops.sweep_ap.sweep_positions` are grouped
    by ``(i // 128, j)`` and each group's lanes summed into its mask (each
    bit once, so the sum is the or)."""
    sb = sorted_boxes
    dev = sb.major_min.device
    pair_budget, rec_budget = _budgets(pair_budget, rec_budget)
    pos = list(sweep_positions(sb, is_two_lists, any_order=any_order, planes=planes))
    i = torch.cat([p[0] for p in pos]) if pos else torch.zeros((0,), dtype=torch.int64, device=dev)
    j = torch.cat([p[1] for p in pos]) if pos else torch.zeros((0,), dtype=torch.int64, device=dev)
    keys, inv = torch.unique(torch.div(i, ROW, rounding_mode="floor") * max(sb.n, 1) + j,
                             return_inverse=True)
    lane = i % ROW
    masks = torch.zeros((keys.shape[0] * 4,), dtype=torch.int64, device=dev)
    masks.index_add_(0, inv * 4 + lane // 32, torch.ones_like(lane) << (lane % 32))
    recs = torch.zeros((keys.shape[0], REC_WORDS), dtype=torch.int32, device=dev)
    recs[:, :4] = _to_int32(masks.view(-1, 4))
    recs[:, 4] = (keys % max(sb.n, 1)).to(torch.int32)
    recs[:, 5] = torch.div(keys, max(sb.n, 1), rounding_mode="floor").to(torch.int32)
    n_records, n_pairs = keys.shape[0], i.shape[0]
    records = torch.zeros((rec_budget, REC_WORDS), dtype=torch.int32, device=dev)
    records[:min(n_records, rec_budget)] = recs[:rec_budget]
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
    over = n_pairs > pair_budget or n_records > rec_budget
    return records, t(n_records), t(n_pairs), torch.tensor(over, device=dev)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 (SWAR on the two 16-bit halves, so no step
    leaves the int32 range)."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def records_pair_prefix(records: torch.Tensor, n_records) -> torch.Tensor:
    """Inclusive int64 prefix of the pairs per record; rows at or past
    ``n_records`` count 0, so the prefix ends at the pair total
    (``records_pair_prefix``, JAX ``:1495``)."""
    per_rec = popcount32(records[:, :4]).sum(dim=1, dtype=torch.int64)
    rows = torch.arange(records.shape[0], device=records.device)
    return torch.cumsum(torch.where(rows < n_records, per_rec, 0), 0)


def decode_record_bits(sorted_boxes: SortedBoxes, records: torch.Tensor, r, k,
                       is_two_lists: bool) -> torch.Tensor:
    """The ``k``-th set bit of record ``r`` (both ``(b,)`` int64) as a
    ``(b, 2)`` element-id pair in the reference emit convention
    (``_decode_record_bits``, JAX ``:1554``)."""
    rec = records[r]
    w = rec[:, :4]
    cc = torch.cumsum(popcount32(w).to(torch.int64), dim=1)  # (b, 4) inclusive
    g = (k[:, None] >= cc[:, :3]).sum(dim=1)  # the word holding the bit
    word = w.gather(1, g[:, None])[:, 0]
    before = torch.where(g > 0, cc.gather(1, (g - 1).clamp(min=0)[:, None])[:, 0], 0)
    kk = k - before
    bits = ((word[:, None] >> torch.arange(32, device=w.device, dtype=torch.int32)) & 1)
    # positions before the kk-th set bit hold at most kk set bits
    bit = (torch.cumsum(bits, dim=1) <= kk[:, None]).sum(dim=1)
    a_slot = rec[:, 5].to(torch.int64) * ROW + g * 32 + bit
    eid = sorted_boxes.element_id
    return emit_pairs(eid[a_slot], eid[rec[:, 4].to(torch.int64)], is_two_lists)


def decode_records_range(sorted_boxes: SortedBoxes, records: torch.Tensor, cum,
                         start: int, stop: int, r_lo, is_two_lists: bool):
    """Decode pairs ``[start, stop)`` of the record stream (``stop`` at most
    the pair total).  ``cum`` is :func:`records_pair_prefix`'s output and
    ``r_lo`` (a 0-d tensor or int) a record at or before the one holding
    pair ``start``: pass 0 for the first batch and the returned cursor for
    the next (``decode_records_range``, JAX ``:1521``).  Pairs ``start ..
    stop-1`` lie in at most ``stop - start`` records from ``r_lo`` on, since
    every record holds a pair, so one searchsorted over that window finds
    them.  Returns ``((stop - start, 2)`` pairs, the new cursor)."""
    dev = records.device
    b = stop - start
    R = records.shape[0]
    p = torch.arange(start, stop, device=dev)
    if b <= 0 or R == 0:
        return torch.empty((0, 2), dtype=torch.int32, device=dev), r_lo
    r_lo = torch.as_tensor(r_lo, dtype=torch.int64, device=dev)
    win = torch.clamp(r_lo + torch.arange(b + 1, device=dev), max=R - 1)
    r = r_lo + torch.searchsorted(cum[win], p, right=True)
    r = torch.clamp(r, max=R - 1)
    excl = torch.where(r > 0, cum[(r - 1).clamp(min=0)], 0)
    chunk = decode_record_bits(sorted_boxes, records, r, p - excl, is_two_lists)
    return chunk, r[-1]


def sample_first_pairs(sorted_boxes: SortedBoxes, records: torch.Tensor, n_records,
                       batch: int, is_two_lists: bool) -> torch.Tensor:
    """The first pair of records ``floor(i * n / batch)``, ``i < min(batch,
    n)``, with ``n = min(n_records, R)``: one batch spread over the whole
    stream (``sample_first_pairs``, JAX ``:1616``; records come in sweep
    order there, so the sample covers every contact region)."""
    dev = records.device
    nr = min(int(n_records), records.shape[0])
    i = torch.arange(min(batch, nr), device=dev)
    r = i * (nr // batch) + (i * (nr % batch)) // batch
    return decode_record_bits(sorted_boxes, records, r, torch.zeros_like(r), is_two_lists)
