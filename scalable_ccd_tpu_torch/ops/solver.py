"""Narrow-phase solver: kernel B (``csrc/solver.cu``) and its plain twin.

Replaces the JAX package's per-query depth-first solver kernel
(``scalable_ccd_tpu/ops/pallas_solver.py:_solver_kernel``, global mode,
launched by ``_find_roots_packed``).  Both versions here solve packed query
rows (:func:`pack_query_rows`) for the earliest time of impact, pruned
against one running TOI seeded with ``toi_init``, with the acceptance, cull
and cap rules of :mod:`scalable_ccd_tpu_torch.narrow_phase.root_finder`.
Only the global mode is ported; the JAX kernel's per-query, bounded
iteration and round-limit modes are not.

:func:`solve_packed` runs the CUDA kernel on CUDA tensors and the plain
version on CPU tensors; any other device raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from scalable_ccd_tpu_torch.narrow_phase.root_finder import bisect_step
from scalable_ccd_tpu_torch.narrow_phase.types import (
    CCDQueries,
    compute_tolerance,
    numerical_error_bound,
)
from scalable_ccd_tpu_torch.ops._build import load_library

__all__ = [
    "pack_query_rows",
    "solve_packed",
    "solve_packed_reference",
    "LAUNCHES",
    "ROW_WIDTH",
]

#: kernel launches made by :func:`solve_packed` in this process
LAUNCHES = 0

#: floats per packed query row: 8 endpoints, tol (3), err (3), ms
ROW_WIDTH = 31

#: domains the plain solver evaluates per round (the JAX queue solver's
#: largest tile)
_TILE = 1 << 16


def pack_query_rows(queries: CCDQueries, is_vf: bool, ms, tolerance) -> torch.Tensor:
    """``(Q, 31)`` f32 rows in the kernel's field order: the eight corner
    points, the per-dim tolerance, the per-dim error filter, ms
    (``pack_query_rows``, JAX ``pallas_solver.py:649``)."""
    dt = torch.float32
    dev = queries.p0s.device
    ms_arr = torch.as_tensor(ms, dtype=dt, device=dev).expand(queries.n)
    err = torch.where(
        (ms_arr > 0).any(),
        numerical_error_bound(queries, is_vf, True),
        numerical_error_bound(queries, is_vf, False),
    )
    tol = compute_tolerance(queries, is_vf, tolerance)
    return torch.cat([*queries, tol, err, ms_arr[:, None]], dim=1).to(dt)


def _unpack(rows: torch.Tensor):
    q = CCDQueries(*[rows[:, 3 * k:3 * k + 3] for k in range(8)])
    return q, rows[:, 24:27], rows[:, 27:30], rows[:, 30]


def _bind(lib):
    fn = lib.sccd_solve_packed
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_solver_error_string.argtypes = [ctypes.c_int]
    lib.sccd_solver_error_string.restype = ctypes.c_char_p
    return fn


def solve_packed(qrows, valid, is_vf: bool, toi_init, tolerance,
                 allow_zero_toi: bool = True):
    """Earliest TOI of the valid rows of ``qrows``, global mode.

    ``qrows`` is ``(Q, 31)`` f32 (:func:`pack_query_rows`), ``valid`` a
    ``(Q,)`` bool mask, ``toi_init`` the running TOI (a float or a 0-d
    tensor), ``tolerance`` the co-domain tolerance.  Returns 0-d tensors
    ``(toi, overflow, checks)``: ``toi = min(toi_init, earliest accepted
    time)``; ``overflow`` is set where a conservative accept was taken (the
    TOI stays valid, possibly early); ``checks`` (int64) counts domain
    evaluations.
    """
    global LAUNCHES
    dev = qrows.device
    if dev.type == "cpu":
        return solve_packed_reference(
            qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi
        )
    if dev.type != "cuda":
        raise ValueError(f"solve_packed: unsupported device {dev}")
    Q = qrows.shape[0]
    if qrows.dtype != torch.float32 or tuple(qrows.shape) != (Q, ROW_WIDTH):
        raise ValueError(
            f"solve_packed: qrows must be float32 (Q, {ROW_WIDTH}), got "
            f"{qrows.dtype} {tuple(qrows.shape)}"
        )
    if valid.device != dev or valid.dtype != torch.bool or tuple(valid.shape) != (Q,):
        raise ValueError(
            f"solve_packed: valid must be bool ({Q},) on {dev}, got "
            f"{valid.dtype} {tuple(valid.shape)} on {valid.device}"
        )
    if not (qrows.is_contiguous() and valid.is_contiguous()):
        raise ValueError("solve_packed: qrows and valid must be contiguous")
    if Q >= 2**31 // ROW_WIDTH:
        raise ValueError(f"solve_packed: {Q} rows exceed the kernel's index range")
    cols = qrows.t().contiguous()  # (31, Q): neighbouring threads, neighbouring words
    # + 0.0 turns a -0.0 seed into +0.0 (the atomicMin compares int bits)
    toi = torch.as_tensor(toi_init, dtype=torch.float32, device=dev).reshape(1) + 0.0
    checks = torch.zeros((1,), dtype=torch.int64, device=dev)
    ovf = torch.zeros((1,), dtype=torch.int32, device=dev)
    if Q > 0:
        lib = load_library("solver")
        fn = _bind(lib)
        with torch.cuda.device(dev):
            rc = fn(
                cols.data_ptr(), valid.data_ptr(), Q, int(bool(is_vf)),
                int(bool(allow_zero_toi)), float(tolerance), toi.data_ptr(),
                checks.data_ptr(), ovf.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            msg = lib.sccd_solver_error_string(rc).decode()
            raise RuntimeError(f"solver kernel launch failed: {msg}")
        LAUNCHES += 1
    return toi[0], ovf[0] != 0, checks[0]


def solve_packed_reference(qrows, valid, is_vf: bool, toi_init, tolerance,
                           allow_zero_toi: bool = True):
    """Plain PyTorch twin of kernel B, on any device.

    A vectorised frontier bisection in the manner of the JAX package's queue
    solver (``narrow_phase/bfs.py``): a stack of domains, each carrying its
    query id, depth and per-dimension split counts; every round pops the top
    ``_TILE`` domains, applies :func:`bisect_step` against the running TOI,
    and pushes the children back with the earlier-time child on top.  The
    stack grows as needed (no queue capacity, so no spill accepts); the
    depth and per-dimension caps are the kernel's.  Same outputs as
    :func:`solve_packed`.
    """
    dev = qrows.device
    dt = torch.float32
    toi = torch.as_tensor(toi_init, dtype=dt, device=dev).reshape(()).clone()
    co_tol = torch.as_tensor(tolerance, dtype=dt, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    checks = 0
    qid = torch.nonzero(valid.to(torch.bool)).flatten()
    n0 = qid.shape[0]
    lo = torch.zeros((n0, 3), dtype=dt, device=dev)
    hi = torch.ones((n0, 3), dtype=dt, device=dev)
    depth = torch.zeros((n0,), dtype=torch.int32, device=dev)
    dimcnt = torch.zeros((n0, 3), dtype=torch.int32, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    while qid.shape[0] > 0:
        count = qid.shape[0]
        top = max(count - _TILE, 0)
        p_lo, p_hi, p_q = lo[top:], hi[top:], qid[top:]
        p_depth, p_cnt = depth[top:], dimcnt[top:]
        q, tol, err, ms = _unpack(qrows[p_q])
        st = bisect_step(
            q, p_lo, p_hi, tol, err, ms, co_tol, toi, p_depth, p_cnt,
            is_vf, allow_zero_toi,
        )
        checks += count - top
        toi = torch.minimum(toi, torch.where(st.accept, p_lo[:, 0], inf).amin())
        ovf |= st.overflow.any()

        onehot = torch.nn.functional.one_hot(st.split, 3).to(torch.bool)
        mid = st.mid[:, None]
        c_depth = p_depth + 1
        c_cnt = p_cnt + onehot.to(torch.int32)
        # (child2, child1) per lane: child1 ([s_lo, mid]) lands nearer the
        # top of the stack and is popped first
        keep = torch.stack([st.push2, st.do_split], dim=1).flatten()
        c_lo = torch.stack([torch.where(onehot, mid, p_lo), p_lo], dim=1).flatten(0, 1)
        c_hi = torch.stack([p_hi, torch.where(onehot, mid, p_hi)], dim=1).flatten(0, 1)
        two = lambda x: torch.stack([x, x], dim=1).flatten(0, 1)  # noqa: E731
        lo = torch.cat([lo[:top], c_lo[keep]])
        hi = torch.cat([hi[:top], c_hi[keep]])
        qid = torch.cat([qid[:top], two(p_q)[keep]])
        depth = torch.cat([depth[:top], two(c_depth)[keep]])
        dimcnt = torch.cat([dimcnt[:top], two(c_cnt)[keep]])
    return toi, ovf, torch.tensor(checks, dtype=torch.int64, device=dev)
