"""Broad-phase sweep: kernel A (``csrc/sweep_ap.cu``) and its plain twin.

Replaces the JAX package's all-pairs subtile sweep kernel
(``scalable_ccd_tpu/ops/pallas_sweep_ap.py:_sweep_kernel``, launched by
``pallas_sweep_pairs``, with its ``tile0``/``n_tiles`` a-side range, its
``any_order`` mode and its ``count_only`` option).  Both versions here
compute the same pair set: for each sorted box ``i`` (of a box range, when
one is given), every later box ``j`` with ``major_min[j] <= major_max[i]``
that passes :func:`scalable_ccd_tpu_torch.broad_phase.sweep.pair_filters`,
emitted already decoded in the reference convention (one-list ``(min,
max)``, two-list ``(-min-1, max)``, ``decode_pairs_ap`` of the JAX package).

``any_order`` sweeps boxes in any order, the congestion ordering of
``sort_boxes(bucket_minor=True)`` among them (JAX ``pack_boxes_ap``'s
partner planes, ``pallas_sweep_ap.py:244-282``, and the kernel's
``any_order`` tests, ``:574-623``).  :func:`partner_planes` gives the
suffix minimum of ``major_min`` (``fwd_min``, non-decreasing for any
order, so ``fwd_min[j] > major_max[i]`` stops box ``i``'s run exactly) and
the union of minor axis 0 over each row of 128 partners (a row whose union
misses box ``i``'s minor-0 interval holds no partner of ``i`` and is
skipped).  The reverse major test ``major_min[i] <= major_max[j]``, free
under the major sort, is made explicitly.  The JAX kernel's 1024-box window
and 8-box batch unions only stage partners on the TPU and are not ported.

The planes are f32 or f64, all of one dtype (the kernel is instantiated for
both); the pair set of f64 boxes is a subset of the f32 one, whose boxes are
rounded outward.  ``count_only`` walks and tests as always and returns only
the exact survivor total: no pair buffer exists, and the kernel sums its
survivors per thread, warp and block and takes one atomic per block, so its
time against the emitting kernel's is what the append costs.

The kernel works in units (``csrc/sweep_ap.cu``): a tile of :data:`TILE`
sorted boxes of the box range against one :data:`ROW`-partner row of the
tile's partner range, which ends where the stops (``major_min``, or
``fwd_min`` under ``any_order``) pass the tile's largest ``major_max``;
under ``any_order`` only the rows the row skip keeps for the tile count.
:func:`sweep_tiles` is the plain version of its first two launches, which
find each tile's range and number the units; each box's own run lies in
its tile's range, so the units cover every candidate slot once.

:func:`sweep_pairs` runs the CUDA kernel on CUDA tensors and the plain
version on CPU tensors; any other device raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import (
    SortedBoxes,
    emit_pairs,
    pair_filters,
)
from scalable_ccd_tpu_torch.ops._build import count_launch, launch_counts, load_library

__all__ = [
    "PartnerPlanes",
    "partner_planes",
    "sweep_pairs",
    "sweep_pairs_reference",
    "sweep_positions",
    "sweep_tiles",
    "LAUNCHES_BY_MODE",
    "ROW",
    "TILE",
]

#: kernel launches made by :func:`sweep_pairs` in this process, by mode: "whole" (every box starts a run) or "range"
#: (a ``box_range`` was given), also "any_order" and "count_only" when those
#: were on; by scalar type as :func:`scalable_ccd_tpu_torch.ops._build.
#: launch_counts` lays out
LAUNCHES_BY_MODE = launch_counts("sweep_ap", "whole", "range", "any_order", "count_only")

#: partners per row of the row-skip planes (the JAX kernel's 128-lane row)
ROW = 128

#: boxes per tile of the kernel's work units (one warp; a unit is a tile
#: against one row of partners)
TILE = 32

#: fill of the pair buffer rows past ``n_pairs`` in the plain version
_SENTINEL = -(2**31) + 1


class PartnerPlanes(NamedTuple):
    """The partner side's stop and row-skip planes of one sorted box set."""

    fwd_min: torch.Tensor   # (n,): min of major_min over positions >= j
    row_umin: torch.Tensor  # (ceil(n/128),): min of minor_min[:, 0] per row
    row_umax: torch.Tensor  # (ceil(n/128),): max of minor_max[:, 0] per row


def partner_planes(sorted_boxes: SortedBoxes) -> PartnerPlanes:
    """:class:`PartnerPlanes` of ``sorted_boxes`` (JAX ``pack_boxes_ap``,
    ``extras``, ``pallas_sweep_ap.py:247-257``); the last row is padded with
    inverted bounds, which widen no union."""
    sb = sorted_boxes
    n = sb.n
    fwd = torch.flip(torch.cummin(torch.flip(sb.major_min, [0]), 0).values, [0])
    rows = -(-n // ROW)
    pad = rows * ROW - n
    inf = float("inf")
    lo = torch.nn.functional.pad(sb.minor_min[:, 0], (0, pad), value=inf)
    hi = torch.nn.functional.pad(sb.minor_max[:, 0], (0, pad), value=-inf)
    return PartnerPlanes(
        fwd.contiguous(),
        lo.view(rows, ROW).amin(dim=1).contiguous(),
        hi.view(rows, ROW).amax(dim=1).contiguous(),
    )


def _bind(lib):
    fn = lib.sccd_sweep_pairs
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_sweep_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sccd_sweep_scratch_bytes.restype = ctypes.c_longlong
    lib.sccd_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sccd_sweep_error_string.restype = ctypes.c_char_p
    return fn


def check_boxes(sb: SortedBoxes, caller: str, planes: PartnerPlanes | None = None):
    """Raise ``ValueError`` unless ``sb`` (and ``planes``) hold the dtypes,
    shapes, device and layout the kernels take: f32 or f64 planes, all of
    the dtype of ``major_min``."""
    n = sb.n
    dev = sb.major_min.device
    fdt = sb.major_min.dtype
    if fdt not in (torch.float32, torch.float64):
        raise ValueError(f"{caller}: boxes must be float32 or float64, got {fdt}")
    spec = [
        ("major_min", sb.major_min, fdt, (n,)),
        ("major_max", sb.major_max, fdt, (n,)),
        ("minor_min", sb.minor_min, fdt, (n, 2)),
        ("minor_max", sb.minor_max, fdt, (n, 2)),
        ("vertex_ids", sb.vertex_ids, torch.int32, (n, 3)),
        ("element_id", sb.element_id, torch.int32, (n,)),
    ]
    if planes is not None:
        rows = -(-n // ROW)
        spec += [
            ("fwd_min", planes.fwd_min, fdt, (n,)),
            ("row_umin", planes.row_umin, fdt, (rows,)),
            ("row_umax", planes.row_umax, fdt, (rows,)),
        ]
    for name, t, dtype, shape in spec:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{caller}: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous")
        # the kernels read a minor interval as one float2 or double2
        if name.startswith("minor") and t.data_ptr() % (2 * t.element_size()):
            raise ValueError(
                f"{caller}: {name} must be {2 * t.element_size()}-byte aligned")
    if n >= 2**31 - ROW:
        raise ValueError(f"{caller}: {n} boxes exceed the int32 index range")


def _resolve_range(box_range, n):
    if box_range is None:
        return 0, n
    b0, b1 = (int(b) for b in box_range)
    if not 0 <= b0 <= n or b1 < b0:
        raise ValueError(f"box_range {box_range} is not a range of the {n} boxes")
    return b0, min(b1, n)


def _check_budget(budget, count_only: bool):
    if count_only:
        if budget is not None:
            raise ValueError("count_only writes no pairs: it takes no budget")
        return None
    if budget is None:
        raise ValueError("sweep_pairs needs a pair budget unless count_only")
    return int(budget)


def sweep_pairs(sorted_boxes: SortedBoxes, is_two_lists: bool, budget=None,
                box_range=None, any_order: bool = False, planes=None,
                count_only: bool = False):
    """All candidate pairs of a sorted box set.

    ``box_range = (b0, b1)`` keeps the pairs whose earlier sorted box lies
    in ``[b0, b1)`` (``b1`` is clipped to the box count); partners are
    still taken from the whole array, so the union over ranges that cover
    every box is the whole set.  ``any_order`` takes boxes in any order
    (module docstring); ``planes`` are their :func:`partner_planes`,
    computed here when not given.  Returns ``(pairs, n_pairs, n_true,
    overflow)``: ``pairs`` is a ``(budget, 2)`` int32 buffer whose first
    ``n_pairs`` rows are the surviving pairs; ``n_true`` (int64) is the
    exact survivor count even past the budget; ``overflow`` is ``n_true >
    budget``.  The three scalars are 0-d tensors on the boxes' device.

    ``count_only`` returns ``n_true`` alone and writes no pair; it takes no
    budget (one given raises).

    On CUDA the row order is nondeterministic (survivors are appended with
    an atomic counter); the pair set, and every TOI computed from it, is
    order-free.  On the CPU the plain version emits rows in sweep order.
    """
    dev = sorted_boxes.major_min.device
    budget = _check_budget(budget, count_only)
    if any_order and planes is None:
        planes = partner_planes(sorted_boxes)
    if dev.type == "cpu":
        return sweep_pairs_reference(
            sorted_boxes, is_two_lists, budget, box_range=box_range,
            any_order=any_order, planes=planes, count_only=count_only,
        )
    if dev.type != "cuda":
        raise ValueError(f"sweep_pairs: unsupported device {dev}")
    check_boxes(sorted_boxes, "sweep_pairs", planes if any_order else None)
    pairs = None if count_only else torch.empty((budget, 2), dtype=torch.int32, device=dev)
    n_true = torch.zeros((1,), dtype=torch.int64, device=dev)
    b0, b1 = _resolve_range(box_range, sorted_boxes.n)
    if b1 > b0:
        _launch(sorted_boxes, is_two_lists, (b0, b1), any_order, planes, pairs, budget,
                n_true)
        modes = ["whole" if box_range is None else "range"]
        modes += ["any_order"] if any_order else []
        modes += ["count_only"] if count_only else []
        count_launch(LAUNCHES_BY_MODE, modes, sorted_boxes.major_min.dtype == torch.float64)
    n_true = n_true[0]
    if count_only:
        return n_true
    return pairs, torch.clamp(n_true, max=budget), n_true, n_true > budget


def _launch(sb: SortedBoxes, is_two_lists, box_range, any_order, planes, pairs, budget,
            n_true):
    """Launch kernel A over the non-empty ``box_range``; ``pairs`` is None
    with ``count_only``.  Returns the kernel's scratch (int64), which
    :func:`_scratch_tiles` reads."""
    b0, b1 = box_range
    dev = sb.major_min.device
    lib = load_library("sweep_ap")
    fn = _bind(lib)
    scratch = torch.empty((-(-lib.sccd_sweep_scratch_bytes(b0, b1) // 8),),
                          dtype=torch.int64, device=dev)
    pl = (planes.fwd_min.data_ptr(), planes.row_umin.data_ptr(),
          planes.row_umax.data_ptr()) if any_order else (None, None, None)
    with torch.cuda.device(dev):
        rc = fn(
            sb.major_min.data_ptr(), sb.major_max.data_ptr(),
            sb.minor_min.data_ptr(), sb.minor_max.data_ptr(),
            sb.vertex_ids.data_ptr(), sb.element_id.data_ptr(), *pl,
            sb.n, b0, b1, int(bool(is_two_lists)), int(bool(any_order)),
            int(sb.major_min.dtype == torch.float64), int(pairs is None),
            None if pairs is None else pairs.data_ptr(),
            0 if pairs is None else budget, n_true.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.sccd_sweep_error_string(rc)
        raise RuntimeError(f"sweep_ap kernel launch failed: {msg.decode()}")
    return scratch


def _scratch_tiles(scratch: torch.Tensor, n_tiles: int, per_block: int = 256):
    """``(end, prefix)`` of :func:`sweep_tiles` as a kernel's first two
    launches left them in ``scratch`` (``csrc/sweep_common.cuh:scratch_at``:
    the prefix, the grab counter, a sum per block of ``per_block`` tiles,
    the ends)."""
    blocks = -(-n_tiles // per_block)
    end = scratch[n_tiles + 2 + blocks:].view(torch.int32)[:n_tiles]
    return end.to(torch.int64), scratch[:n_tiles + 1]


def sweep_tiles(sorted_boxes: SortedBoxes, box_range=None, any_order: bool = False,
                planes=None, tile: int = TILE):
    """Plain version of the work units of kernel A: ``(begin, end,
    prefix)``, int64.  Tile ``t`` holds the sorted boxes ``[b0 + tile * t,
    min(b0 + tile * (t + 1), b1))`` of ``box_range = (b0, b1)``; its partners
    are ``[begin[t], end[t])``, ``begin`` the tile's first box plus one and
    ``end`` the first position whose stop (``major_min``, or ``fwd_min``
    under ``any_order``) exceeds the tile's largest ``major_max``.  Tile
    ``t`` owns units ``[prefix[t], prefix[t + 1])``, one per :data:`ROW`
    -partner row its range touches, in order; under ``any_order`` only the
    rows whose union of minor axis 0 meets the union of the tile's.  Kernel
    A's tiles are :data:`TILE` boxes; kernel A' takes ``tile=ROW``, the
    a-rows of its records (``ops/sweep_records.py:sweep_record_units``)."""
    sb = sorted_boxes
    dev = sb.major_min.device
    b0, b1 = _resolve_range(box_range, sb.n)
    if any_order and planes is None:
        planes = partner_planes(sb)
    begin = torch.arange(b0, b1, tile, device=dev) + 1
    pad = begin.numel() * tile - (b1 - b0)
    inf = float("inf")

    def per_tile(x, fill, reduce):
        return reduce(torch.nn.functional.pad(x[b0:b1], (0, pad), value=fill).view(-1, tile), 1)

    reach = per_tile(sb.major_max, -inf, torch.amax)
    stops = planes.fwd_min if any_order else sb.major_min
    # the stops up to a tile's first box lie at or below its reach
    end = torch.maximum(torch.searchsorted(stops, reach, right=True), begin)
    row0, row1 = begin // ROW, (end - 1) // ROW
    units = torch.where(end > begin, row1 - row0 + 1, 0)
    if any_order:
        u_lo = per_tile(sb.minor_min[:, 0], inf, torch.amin)
        u_hi = per_tile(sb.minor_max[:, 0], -inf, torch.amax)
        tile_of = torch.repeat_interleave(torch.arange(begin.numel(), device=dev), units)
        first = torch.cumsum(units, 0) - units
        row = row0[tile_of] + torch.arange(tile_of.numel(), device=dev) - first[tile_of]
        kept = (planes.row_umin[row] <= u_hi[tile_of]) & (planes.row_umax[row] >= u_lo[tile_of])
        units = torch.zeros_like(units).index_add_(0, tile_of, kept.to(units.dtype))
    prefix = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                        torch.cumsum(units, 0)])
    return begin, end, prefix


def sweep_positions(sorted_boxes: SortedBoxes, is_two_lists: bool,
                    box_range=None, any_order: bool = False, planes=None,
                    chunk_slots: int = 1 << 22):
    """Plain sweep: yield ``(i, j)`` int64 sorted positions of the surviving
    pairs, ``i < j``, in sweep order, one chunk of about ``chunk_slots``
    candidate slots at a time.

    Run lengths come from one ``searchsorted`` over the sorted lower bounds
    (``count_major_runs`` of the JAX package), or over ``fwd_min`` under
    ``any_order``, where both major directions are then filtered; the slot
    space is expanded with ``repeat_interleave`` chunk by chunk.
    """
    sb = sorted_boxes
    dev = sb.major_min.device
    n = sb.n
    r0, r1 = _resolve_range(box_range, n)
    if r1 <= r0:
        return
    if any_order and planes is None:
        planes = partner_planes(sb)
    stops = planes.fwd_min if any_order else sb.major_min
    reach = torch.searchsorted(stops, sb.major_max[r0:r1], right=True)
    k = torch.zeros((n,), dtype=reach.dtype, device=dev)
    k[r0:r1] = (reach - torch.arange(r0, r1, device=dev) - 1).clamp_(min=0)
    cum = torch.cumsum(k, 0)
    total = int(cum[-1])
    cuts = torch.arange(chunk_slots, max(total, chunk_slots), chunk_slots, device=dev)
    bounds = [0] + torch.searchsorted(cum, cuts, right=True).tolist() + [n]
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b1 <= b0:
            continue
        kc = k[b0:b1]
        i = torch.repeat_interleave(torch.arange(b0, b1, device=dev), kc)
        if i.numel() == 0:
            continue
        start = torch.cumsum(kc, 0) - kc  # exclusive offsets
        slot = torch.arange(i.numel(), device=dev) - torch.repeat_interleave(start, kc)
        j = i + 1 + slot
        keep = pair_filters(sb, i, j, is_two_lists)
        if any_order:
            keep &= (sb.major_min[j] <= sb.major_max[i]) & (sb.major_min[i] <= sb.major_max[j])
        yield i[keep], j[keep]


def sweep_pairs_reference(
    sorted_boxes: SortedBoxes, is_two_lists: bool, budget=None,
    chunk_slots: int = 1 << 22, box_range=None, any_order: bool = False,
    planes=None, count_only: bool = False,
):
    """Plain PyTorch twin of kernel A, on any device; arguments and outputs
    as in :func:`sweep_pairs`, rows in sweep order (:func:`sweep_positions`,
    expanded in chunks of about ``chunk_slots`` slots).  ``count_only`` sums
    the survivors of each chunk and emits nothing."""
    sb = sorted_boxes
    dev = sb.major_min.device
    budget = _check_budget(budget, count_only)
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
    positions = sweep_positions(sb, is_two_lists, box_range, any_order, planes, chunk_slots)
    if count_only:
        return t(sum(i.numel() for i, _ in positions))
    found = [emit_pairs(sb.element_id[i], sb.element_id[j], is_two_lists)
             for i, j in positions]
    allp = (
        torch.cat(found) if found
        else torch.empty((0, 2), dtype=torch.int32, device=dev)
    )
    n_true = allp.shape[0]
    pairs = torch.full((budget, 2), _SENTINEL, dtype=torch.int32, device=dev)
    n_pairs = min(n_true, budget)
    pairs[:n_pairs] = allp[:n_pairs]
    return pairs, t(n_pairs), t(n_true), torch.tensor(n_true > budget, device=dev)
