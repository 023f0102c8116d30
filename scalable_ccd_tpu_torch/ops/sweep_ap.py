"""Broad-phase sweep: kernel A (``csrc/sweep_ap.cu``) and its plain twin.

Replaces the JAX package's all-pairs subtile sweep kernel
(``scalable_ccd_tpu/ops/pallas_sweep_ap.py:_sweep_kernel``, launched by
``pallas_sweep_pairs``, with its ``tile0``/``n_tiles`` a-side range and its
``any_order`` mode).  Both versions here compute the same pair set: for each
sorted box ``i`` (of a box range, when one is given), every later box ``j``
with ``major_min[j] <= major_max[i]`` that passes
:func:`scalable_ccd_tpu_torch.broad_phase.sweep.pair_filters`, emitted
already decoded in the reference convention (one-list ``(min, max)``,
two-list ``(-min-1, max)``, ``decode_pairs_ap`` of the JAX package).

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
from scalable_ccd_tpu_torch.ops._build import load_library

__all__ = [
    "PartnerPlanes",
    "partner_planes",
    "sweep_pairs",
    "sweep_pairs_reference",
    "sweep_positions",
    "LAUNCHES",
    "LAUNCHES_BY_MODE",
    "ROW",
]

#: kernel launches made by :func:`sweep_pairs` in this process
LAUNCHES = 0

#: the same launches by mode: "whole" (every box starts a run) or "range"
#: (a ``box_range`` was given), and also "any_order" when that mode was on
LAUNCHES_BY_MODE = {"whole": 0, "range": 0, "any_order": 0}

#: partners per row of the row-skip planes (the JAX kernel's 128-lane row)
ROW = 128

#: fill of the pair buffer rows past ``n_pairs`` in the plain version
_SENTINEL = -(2**31) + 1


class PartnerPlanes(NamedTuple):
    """The partner side's stop and row-skip planes of one sorted box set."""

    fwd_min: torch.Tensor   # (n,) f32: min of major_min over positions >= j
    row_umin: torch.Tensor  # (ceil(n/128),) f32: min of minor_min[:, 0] per row
    row_umax: torch.Tensor  # (ceil(n/128),) f32: max of minor_max[:, 0] per row


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
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sccd_sweep_error_string.restype = ctypes.c_char_p
    return fn


def check_boxes(sb: SortedBoxes, caller: str, planes: PartnerPlanes | None = None):
    """Raise ``ValueError`` unless ``sb`` (and ``planes``) hold the dtypes,
    shapes, device and layout the kernels take."""
    n = sb.n
    dev = sb.major_min.device
    spec = [
        ("major_min", sb.major_min, torch.float32, (n,)),
        ("major_max", sb.major_max, torch.float32, (n,)),
        ("minor_min", sb.minor_min, torch.float32, (n, 2)),
        ("minor_max", sb.minor_max, torch.float32, (n, 2)),
        ("vertex_ids", sb.vertex_ids, torch.int32, (n, 3)),
        ("element_id", sb.element_id, torch.int32, (n,)),
    ]
    if planes is not None:
        rows = -(-n // ROW)
        spec += [
            ("fwd_min", planes.fwd_min, torch.float32, (n,)),
            ("row_umin", planes.row_umin, torch.float32, (rows,)),
            ("row_umax", planes.row_umax, torch.float32, (rows,)),
        ]
    for name, t, dtype, shape in spec:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{caller}: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous")
        if t.data_ptr() % 8 and name.startswith("minor"):
            raise ValueError(f"{caller}: {name} must be 8-byte aligned")
    if n >= 2**31 - ROW:
        raise ValueError(f"{caller}: {n} boxes exceed the int32 index range")


def _resolve_range(box_range, n):
    if box_range is None:
        return 0, n
    b0, b1 = (int(b) for b in box_range)
    if not 0 <= b0 <= n or b1 < b0:
        raise ValueError(f"box_range {box_range} is not a range of the {n} boxes")
    return b0, min(b1, n)


def sweep_pairs(sorted_boxes: SortedBoxes, is_two_lists: bool, budget: int,
                box_range=None, any_order: bool = False, planes=None):
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

    On CUDA the row order is nondeterministic (survivors are appended with
    an atomic counter); the pair set, and every TOI computed from it, is
    order-free.  On the CPU the plain version emits rows in sweep order.
    """
    global LAUNCHES
    dev = sorted_boxes.major_min.device
    if any_order and planes is None:
        planes = partner_planes(sorted_boxes)
    if dev.type == "cpu":
        return sweep_pairs_reference(
            sorted_boxes, is_two_lists, budget, box_range=box_range,
            any_order=any_order, planes=planes,
        )
    if dev.type != "cuda":
        raise ValueError(f"sweep_pairs: unsupported device {dev}")
    check_boxes(sorted_boxes, "sweep_pairs", planes if any_order else None)
    budget = int(budget)
    pairs = torch.empty((budget, 2), dtype=torch.int32, device=dev)
    n_true = torch.zeros((1,), dtype=torch.int64, device=dev)
    n = sorted_boxes.n
    b0, b1 = _resolve_range(box_range, n)
    if b1 > b0:
        lib = load_library("sweep_ap")
        fn = _bind(lib)
        sb = sorted_boxes
        pl = (planes.fwd_min.data_ptr(), planes.row_umin.data_ptr(),
              planes.row_umax.data_ptr()) if any_order else (None, None, None)
        with torch.cuda.device(dev):
            rc = fn(
                sb.major_min.data_ptr(), sb.major_max.data_ptr(),
                sb.minor_min.data_ptr(), sb.minor_max.data_ptr(),
                sb.vertex_ids.data_ptr(), sb.element_id.data_ptr(), *pl,
                n, b0, b1, int(bool(is_two_lists)), int(bool(any_order)),
                pairs.data_ptr(), budget, n_true.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            msg = lib.sccd_sweep_error_string(rc)
            raise RuntimeError(f"sweep_ap kernel launch failed: {msg.decode()}")
        LAUNCHES += 1
        LAUNCHES_BY_MODE["whole" if box_range is None else "range"] += 1
        if any_order:
            LAUNCHES_BY_MODE["any_order"] += 1
    n_true = n_true[0]
    return pairs, torch.clamp(n_true, max=budget), n_true, n_true > budget


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
    sorted_boxes: SortedBoxes, is_two_lists: bool, budget: int,
    chunk_slots: int = 1 << 22, box_range=None, any_order: bool = False,
    planes=None,
):
    """Plain PyTorch twin of kernel A, on any device; arguments and outputs
    as in :func:`sweep_pairs`, rows in sweep order (:func:`sweep_positions`,
    expanded in chunks of about ``chunk_slots`` slots)."""
    sb = sorted_boxes
    dev = sb.major_min.device
    budget = int(budget)
    found = [
        emit_pairs(sb.element_id[i], sb.element_id[j], is_two_lists)
        for i, j in sweep_positions(sb, is_two_lists, box_range, any_order,
                                    planes, chunk_slots)
    ]
    allp = (
        torch.cat(found) if found
        else torch.empty((0, 2), dtype=torch.int32, device=dev)
    )
    n_true = allp.shape[0]
    pairs = torch.full((budget, 2), _SENTINEL, dtype=torch.int32, device=dev)
    n_pairs = min(n_true, budget)
    pairs[:n_pairs] = allp[:n_pairs]
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
    return pairs, t(n_pairs), t(n_true), torch.tensor(n_true > budget, device=dev)
