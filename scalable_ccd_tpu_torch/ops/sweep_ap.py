"""Broad-phase sweep: kernel A (``csrc/sweep_ap.cu``) and its plain twin.

Replaces the JAX package's all-pairs subtile sweep kernel
(``scalable_ccd_tpu/ops/pallas_sweep_ap.py:_sweep_kernel``, launched by
``pallas_sweep_pairs``).  Both versions here compute the same pair set: for
each sorted box ``i``, every later box ``j`` with
``major_min[j] <= major_max[i]`` that passes
:func:`scalable_ccd_tpu_torch.broad_phase.sweep.pair_filters`, emitted
already decoded in the reference convention (one-list ``(min, max)``,
two-list ``(-min-1, max)``, ``decode_pairs_ap`` of the JAX package).

:func:`sweep_pairs` runs the CUDA kernel on CUDA tensors and the plain
version on CPU tensors; any other device raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import (
    SortedBoxes,
    emit_pairs,
    pair_filters,
)
from scalable_ccd_tpu_torch.ops._build import load_library

__all__ = ["sweep_pairs", "sweep_pairs_reference", "LAUNCHES"]

#: kernel launches made by :func:`sweep_pairs` in this process
LAUNCHES = 0

#: fill of the pair buffer rows past ``n_pairs`` in the plain version
_SENTINEL = -(2**31) + 1


def _bind(lib):
    fn = lib.sccd_sweep_pairs
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sccd_sweep_error_string.restype = ctypes.c_char_p
    return fn


def _check_boxes(sb: SortedBoxes):
    n = sb.n
    dev = sb.major_min.device
    spec = (
        ("major_min", torch.float32, (n,)),
        ("major_max", torch.float32, (n,)),
        ("minor_min", torch.float32, (n, 2)),
        ("minor_max", torch.float32, (n, 2)),
        ("vertex_ids", torch.int32, (n, 3)),
        ("element_id", torch.int32, (n,)),
    )
    for name, dtype, shape in spec:
        t = getattr(sb, name)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"sweep_pairs: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"sweep_pairs: {name} must be contiguous")
        if t.data_ptr() % 8 and name.startswith("minor"):
            raise ValueError(f"sweep_pairs: {name} must be 8-byte aligned")
    if n >= 2**31:
        raise ValueError(f"sweep_pairs: {n} boxes exceed the int32 index range")


def sweep_pairs(sorted_boxes: SortedBoxes, is_two_lists: bool, budget: int):
    """All candidate pairs of a sorted box set.

    Returns ``(pairs, n_pairs, n_true, overflow)``: ``pairs`` is a
    ``(budget, 2)`` int32 buffer whose first ``n_pairs`` rows are the
    surviving pairs; ``n_true`` (int64) is the exact survivor count even
    past the budget; ``overflow`` is ``n_true > budget``.  The three scalars
    are 0-d tensors on the boxes' device.

    On CUDA the row order is nondeterministic (survivors are appended with
    an atomic counter); the pair set, and every TOI computed from it, is
    order-free.  On the CPU the plain version emits rows in sweep order.
    """
    global LAUNCHES
    dev = sorted_boxes.major_min.device
    if dev.type == "cpu":
        return sweep_pairs_reference(sorted_boxes, is_two_lists, budget)
    if dev.type != "cuda":
        raise ValueError(f"sweep_pairs: unsupported device {dev}")
    _check_boxes(sorted_boxes)
    budget = int(budget)
    pairs = torch.empty((budget, 2), dtype=torch.int32, device=dev)
    n_true = torch.zeros((1,), dtype=torch.int64, device=dev)
    n = sorted_boxes.n
    if n > 0:
        fn = _bind(load_library("sweep_ap"))
        sb = sorted_boxes
        with torch.cuda.device(dev):
            rc = fn(
                sb.major_min.data_ptr(), sb.major_max.data_ptr(),
                sb.minor_min.data_ptr(), sb.minor_max.data_ptr(),
                sb.vertex_ids.data_ptr(), sb.element_id.data_ptr(),
                n, int(bool(is_two_lists)), pairs.data_ptr(), budget,
                n_true.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            msg = load_library("sweep_ap").sccd_sweep_error_string(rc)
            raise RuntimeError(f"sweep_ap kernel launch failed: {msg.decode()}")
        LAUNCHES += 1
    n_true = n_true[0]
    return pairs, torch.clamp(n_true, max=budget), n_true, n_true > budget


def sweep_pairs_reference(
    sorted_boxes: SortedBoxes, is_two_lists: bool, budget: int,
    chunk_slots: int = 1 << 22,
):
    """Plain PyTorch twin of kernel A, on any device.

    Run lengths come from one ``searchsorted`` over the sorted lower bounds
    (``count_major_runs`` of the JAX package); the pre-filter slot space
    (61M slots over both phases of the bench scene) is expanded with
    ``repeat_interleave`` in chunks of about ``chunk_slots`` slots, filtered,
    and concatenated in sweep order.  Same outputs as :func:`sweep_pairs`.
    """
    sb = sorted_boxes
    dev = sb.major_min.device
    budget = int(budget)
    n = sb.n
    found = []
    if n > 0:
        reach = torch.searchsorted(sb.major_min, sb.major_max, right=True)
        k = (reach - torch.arange(n, device=dev) - 1).clamp_(min=0)
        cum = torch.cumsum(k, 0)
        total = int(cum[-1])
        cuts = torch.arange(
            chunk_slots, max(total, chunk_slots), chunk_slots, device=dev
        )
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
            i, j = i[keep], j[keep]
            found.append(emit_pairs(sb.element_id[i], sb.element_id[j], is_two_lists))
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
