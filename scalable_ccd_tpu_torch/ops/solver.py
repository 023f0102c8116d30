"""Narrow-phase solver: kernel B (``csrc/solver.cu``) and its plain twin.

Replaces the JAX package's per-query depth-first solver kernel
(``scalable_ccd_tpu/ops/pallas_solver.py:_solver_kernel``, launched by
``_find_roots_packed``) in its global, ``per_query``, ``max_iterations``
and ``round_limit`` modes.  Both versions here solve packed query rows
(:func:`pack_query_rows`) for the earliest time of impact with the
acceptance, cull and cap rules of
:mod:`scalable_ccd_tpu_torch.narrow_phase.root_finder`:

- global: pruned against one running TOI seeded with ``toi_init``;
- per-query: each query prunes only against its own TOI, which starts at
  +inf, and the call also returns every query's exact TOI;
- bounded (``max_iterations >= 0``): a domain past a query's check cap is
  dropped, never accepted; combinable with either of the above;
- ``round_limit >= 0`` (global mode only): each query stops after that many
  rounds of its search and, if still mid-search, is reported in an
  ``unfin`` plane instead of being accepted.

:func:`solve_escalated` is the staged escalation built on the last mode
(JAX ``_normalize_round_limits`` and ``_escalate_ladder``,
``pallas_solver.py:724-811``): one bounded pass, then the unfinished rows,
pooled in their original order, solved again from scratch and pruned by the
first pass's TOI, stage by stage of a ladder of limits, the last stage
unbounded.  Its TOI is the unbounded TOI bitwise unless a conservative
accept fired (``overflow``).

Rows are f32 or f64, and the TOI comes back in their dtype (the kernel is
instantiated for both; :func:`scalable_ccd_tpu_torch.narrow_phase.
root_finder.search_caps` gives each its caps).  ``widened`` marks f64 rows
widened from f32 ones, the port's ``precision="compensated"``: packed in f32
with the compensated error filter, solved in native f64 under f32's split
cap, so that every bound, and with it the TOI, is exact in f32.

:func:`solve_packed` runs the CUDA kernel on CUDA tensors and the plain
version on CPU tensors; any other device raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from scalable_ccd_tpu_torch.config import normalize_round_limits
from scalable_ccd_tpu_torch.narrow_phase.root_finder import (
    bisect_step,
    dfs_lockstep,
    search_caps,
)
from scalable_ccd_tpu_torch.narrow_phase.types import (
    CCDQueries,
    compute_tolerance,
    numerical_error_bound,
)
from scalable_ccd_tpu_torch.ops._build import count_launch, launch_counts, load_library

__all__ = [
    "pack_query_rows",
    "solve_packed",
    "solve_packed_reference",
    "solve_escalated",
    "normalize_round_limits",
    "LAUNCHES",
    "LAUNCHES_BY_MODE",
    "POOL_BLOCK",
    "ROW_WIDTH",
]

#: kernel launches made by :func:`solve_packed` in this process
LAUNCHES = 0

#: the same launches by mode: "global" (neither per-query, bounded nor
#: round-limited), "per_query", "bounded" and "round_limit"; a per-query
#: bounded launch counts in both; by scalar type as
#: :func:`scalable_ccd_tpu_torch.ops._build.launch_counts` lays out
LAUNCHES_BY_MODE = launch_counts("global", "per_query", "bounded", "round_limit")

#: rows per pool block of the escalation glue (the JAX package's solver
#: block, ``SOLVER_BLOCK_SUB * 128``)
POOL_BLOCK = 2048

#: floats per packed query row: 8 endpoints, tol (3), err (3), ms
ROW_WIDTH = 31

#: most domains the plain solver evaluates per round (the JAX queue solver's
#: largest tile); a round takes at most max(queries, 256) of them, as in the
#: JAX queue solver, so that few queries search nearly depth first
_TILE = 1 << 16


def pack_query_rows(queries: CCDQueries, is_vf: bool, ms, tolerance,
                    compensated: bool = False) -> torch.Tensor:
    """``(Q, 31)`` rows in the queries' dtype and the kernel's field order:
    the eight corner points, the per-dim tolerance, the per-dim error
    filter, ms (``pack_query_rows``, JAX ``pallas_solver.py:649``).
    ``compensated`` packs the compensated error filter (the rows of the JAX
    queue solver under ``precision="compensated"``, ``bfs.py:109-125``)."""
    dt = queries.p0s.dtype
    dev = queries.p0s.device
    ms_arr = torch.as_tensor(ms, dtype=dt, device=dev).expand(queries.n)
    err = torch.where(
        (ms_arr > 0).any(),
        numerical_error_bound(queries, is_vf, True, compensated),
        numerical_error_bound(queries, is_vf, False, compensated),
    )
    tol = compute_tolerance(queries, is_vf, tolerance)
    return torch.cat([*queries, tol, err, ms_arr[:, None]], dim=1)


def _unpack(rows: torch.Tensor):
    q = CCDQueries(*[rows[:, 3 * k:3 * k + 3] for k in range(8)])
    return q, rows[:, 24:27], rows[:, 27:30], rows[:, 30]


def _bind(lib):
    fn = lib.sccd_solve_packed
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_solver_error_string.argtypes = [ctypes.c_int]
    lib.sccd_solver_error_string.restype = ctypes.c_char_p
    return fn


def _check_round_limit(round_limit, per_query, max_iterations):
    if round_limit >= 0 and (per_query or max_iterations >= 0):
        raise ValueError(
            "round_limit is a global-mode option: it takes neither per_query "
            "nor max_iterations (pallas_solver.py:145-150)"
        )


def _co_tolerance(tolerance, dt, widened: bool) -> float:
    """The co-domain tolerance as the rows' scalar type holds it (f32's
    value for widened rows)."""
    return float(torch.as_tensor(tolerance, dtype=torch.float32 if widened else dt))


def _check_rows(qrows, widened: bool):
    if (qrows.dtype not in (torch.float32, torch.float64)
            or tuple(qrows.shape[1:]) != (ROW_WIDTH,)):
        raise ValueError(
            f"solve_packed: qrows must be float32 or float64 (Q, {ROW_WIDTH}), got "
            f"{qrows.dtype} {tuple(qrows.shape)}"
        )
    if widened and qrows.dtype != torch.float64:
        raise ValueError(f"solve_packed: widened rows are float64, got {qrows.dtype}")


def solve_packed(qrows, valid, is_vf: bool, toi_init, tolerance,
                 allow_zero_toi: bool = True, per_query: bool = False,
                 max_iterations: int = -1, round_limit: int = -1,
                 widened: bool = False):
    """Earliest TOI of the valid rows of ``qrows``.

    ``qrows`` is ``(Q, 31)`` f32 or f64 (:func:`pack_query_rows`; ``widened``
    says that f64 rows were widened from f32, module docstring), ``valid`` a
    ``(Q,)`` bool mask, ``toi_init`` the running TOI (a float or a 0-d
    tensor), ``tolerance`` the co-domain tolerance.  Returns 0-d tensors
    ``(toi, overflow, checks)``, ``toi`` in the rows' dtype: ``toi =
    min(toi_init, earliest accepted time)``; ``overflow`` is set where a
    conservative accept was taken (the TOI stays valid, possibly early);
    ``checks`` (int64) counts domain evaluations, dropped ones included.

    ``per_query`` prunes each query only against its own TOI and appends
    a fourth output, the ``(Q,)`` per-query TOIs (+inf for invalid rows
    and rows without contact); ``toi`` is then ``min(toi_init, min of
    them)``.  ``max_iterations >= 0`` drops a query's domains once its
    evaluation count, taken before the increment, exceeds the cap.

    ``round_limit >= 0`` (global mode; with ``per_query`` or a cap it
    raises) stops each query after that many rounds of its search, counted
    as the JAX kernel counts them (one round evaluates the current domain,
    if any, and unwinds at most two levels), and appends a fourth output,
    the ``(Q,)`` bool ``unfin`` plane of the queries still mid-search; those
    neither lower the TOI nor set ``overflow``.
    """
    _check_round_limit(round_limit, per_query, max_iterations)
    if qrows.device.type == "cpu":
        return solve_packed_reference(
            qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi,
            per_query, max_iterations, round_limit, widened,
        )
    return _launch(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
                   max_iterations, round_limit, widened)[0]


def _launch(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
            max_iterations, round_limit, widened, query_checks=False):
    """Kernel B on CUDA tensors: ``(outputs of solve_packed, plane)``, the
    plane each query's evaluation count (``(Q,)`` int64) where
    ``query_checks`` asks for it, else ``None``."""
    global LAUNCHES
    dev = qrows.device
    if dev.type != "cuda":
        raise ValueError(f"solve_packed: unsupported device {dev}")
    _check_rows(qrows, widened)
    Q = qrows.shape[0]
    dt = qrows.dtype
    f64 = dt == torch.float64
    caps = search_caps(dt, widened)
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
    # + 0.0 turns a -0.0 seed into +0.0 (the atomicMin compares integer bits)
    toi = torch.as_tensor(toi_init, dtype=dt, device=dev).reshape(1) + 0.0
    checks = torch.zeros((1,), dtype=torch.int64, device=dev)
    ovf = torch.zeros((1,), dtype=torch.int32, device=dev)
    pq = torch.full((Q,), float("inf"), dtype=dt, device=dev) if per_query else None
    unfin = torch.zeros((Q,), dtype=torch.bool, device=dev) if round_limit >= 0 else None
    plane = torch.zeros((Q,), dtype=torch.int64, device=dev) if query_checks else None
    if Q > 0:
        lib = load_library("solver")
        fn = _bind(lib)
        with torch.cuda.device(dev):
            rc = fn(
                cols.data_ptr(), valid.data_ptr(), Q, int(bool(is_vf)),
                int(bool(allow_zero_toi)), int(bool(per_query)), int(f64),
                caps.dim_cap, int(max_iterations), int(round_limit),
                _co_tolerance(tolerance, dt, widened), caps.uv_limit,
                toi.data_ptr(), pq.data_ptr() if per_query else None,
                unfin.data_ptr() if unfin is not None else None,
                checks.data_ptr(), ovf.data_ptr(),
                plane.data_ptr() if plane is not None else None,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            msg = lib.sccd_solver_error_string(rc).decode()
            raise RuntimeError(f"solver kernel launch failed: {msg}")
        LAUNCHES += 1
        modes = ["per_query"] if per_query else []
        modes += ["bounded"] if max_iterations >= 0 else []
        modes += ["round_limit"] if round_limit >= 0 else []
        count_launch(LAUNCHES_BY_MODE, modes or ["global"], f64)
    out = (toi[0], ovf[0] != 0, checks[0])
    if per_query:
        out += (pq,)
    elif unfin is not None:
        out += (unfin,)
    return out, plane


def _solve_query_checks(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi=True,
                        per_query=False, max_iterations=-1, round_limit=-1, widened=False):
    """:func:`solve_packed` on CUDA tensors with one more output: the
    ``(Q,)`` int64 plane of each query's domain evaluations (0 for invalid
    rows).  For measurements only (``chip_smoke.py``, the stage tool); no
    caller on the main path asks for the plane."""
    _check_round_limit(round_limit, per_query, max_iterations)
    out, plane = _launch(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi,
                         per_query, max_iterations, round_limit, widened, query_checks=True)
    return out + (plane,)


def _checks_spread(plane) -> dict:
    """The spread of per-query evaluation counts (:func:`_solve_query_checks`):
    mean, median, 99th percentile and maximum, and the lane efficiency of
    running them in groups of consecutive rows, each group as long as its
    longest member, for groups of 32 queries (one query per thread, a warp)
    and of 4 (eight lanes per query, a warp): ``sum(checks) / sum over
    groups of (size * the group's max)``."""
    c = plane.to(torch.float64)
    if c.numel() == 0:
        return {"queries": 0}
    out = {"queries": int(c.numel()), "mean": float(c.mean()),
           "p50": float(c.quantile(0.5)), "p99": float(c.quantile(0.99)),
           "max": int(c.max())}
    for size in (32, 4):
        pad = (-c.numel()) % size
        g = torch.cat([c, c.new_zeros(pad)]).reshape(-1, size)
        busy = float(g.amax(dim=1).sum()) * size
        out[f"lane_efficiency_{size}"] = float(c.sum()) / busy if busy else 1.0
    return out


def _least_checks(qrows, valid, is_vf, toi, tolerance, per_query_toi=None,
                  allow_zero_toi=True, widened=False) -> int:
    """The domain evaluations that any unbounded search of these rows must
    make: the plain frontier seeded with the answer, the final TOI ``toi``
    (global mode) or each query's final TOI ``per_query_toi`` (per-query
    mode), so that it prunes against it from the start.  A search that does
    not know the answer prunes against a bound at or above it, and a larger
    bound prunes less and culls fewer siblings, so whatever its order it
    evaluates a superset of these domains.  For measurements only
    (``chip_smoke.py``'s bounds); no caller on the main path uses it."""
    _check_rows(qrows, widened)
    dev, dt = qrows.device, qrows.dtype
    caps = search_caps(dt, widened)
    co_tol = torch.tensor(_co_tolerance(tolerance, dt, widened), dtype=dt, device=dev)
    seed = torch.as_tensor(toi, dtype=dt, device=dev).reshape(()).clone()
    per_query = per_query_toi is not None
    tpq = (per_query_toi.to(dt).clone() if per_query
           else torch.full((qrows.shape[0],), float("inf"), dtype=dt, device=dev))
    out = _frontier(qrows, valid.to(torch.bool), is_vf, seed, tpq, co_tol, caps,
                    allow_zero_toi, per_query, -1)
    return int(out[2])


def solve_packed_reference(qrows, valid, is_vf: bool, toi_init, tolerance,
                           allow_zero_toi: bool = True, per_query: bool = False,
                           max_iterations: int = -1, round_limit: int = -1,
                           widened: bool = False):
    """Plain PyTorch twin of kernel B, on any device; same arguments and
    outputs as :func:`solve_packed`, computed in the rows' dtype.

    Per-query bounded calls (``per_query`` and ``max_iterations >= 0``) and
    round-limited calls run the lockstep depth-first search
    :func:`scalable_ccd_tpu_torch.narrow_phase.root_finder.dfs_lockstep`,
    whose exploration order and round count are the kernel's, so their
    per-query TOIs, and the ``unfin`` planes of a run whose shared TOI no
    thread lowers, equal the kernel's.  Every other call
    runs a vectorised frontier bisection in the manner of the JAX package's
    queue solver (``narrow_phase/bfs.py``): a stack of domains, each
    carrying its query id, depth and per-dimension split counts; every round
    pops the top ``min(max(Q, 256), _TILE)`` domains, applies
    :func:`bisect_step` against the running TOI (global) or each domain's
    query TOI (``per_query``), and pushes the children back with the
    earlier-time child on top.  The stack grows as needed (no queue
    capacity, so no spill accepts); the depth and per-dimension caps are the
    kernel's.  Unbounded results do not depend on the exploration order.  A
    global bounded call counts each query's evaluations as the JAX queue
    solver does (the domains of one query popped in one round all see the
    count from before the round); where the cap binds, the kernel's result
    depends on when its threads lower the shared TOI and no plain version
    can reproduce it, and where it does not bind both give the unbounded TOI.
    """
    dev = qrows.device
    _check_rows(qrows, widened)
    dt = qrows.dtype
    caps = search_caps(dt, widened)
    co_tol = torch.tensor(_co_tolerance(tolerance, dt, widened), dtype=dt, device=dev)
    valid = valid.to(torch.bool)
    _check_round_limit(round_limit, per_query, max_iterations)
    if (per_query and max_iterations >= 0) or round_limit >= 0:
        q, tol, err, ms = _unpack(qrows)
        return dfs_lockstep(q, tol, err, ms, valid, co_tol, toi_init, is_vf,
                            allow_zero_toi, max_iterations, round_limit, caps)
    toi = torch.as_tensor(toi_init, dtype=dt, device=dev).reshape(()).clone()
    tpq = torch.full((qrows.shape[0],), float("inf"), dtype=dt, device=dev)
    return _frontier(qrows, valid, is_vf, toi, tpq, co_tol, caps, allow_zero_toi,
                     per_query, max_iterations)


def _frontier(qrows, valid, is_vf, toi, tpq, co_tol, caps, allow_zero_toi, per_query,
              max_iterations):
    """The frontier bisection of :func:`solve_packed_reference` from the
    running TOI ``toi`` (0-d) and, in ``per_query`` mode, the per-query
    TOIs ``tpq`` (``(Q,)``, lowered in place); returns the outputs of
    :func:`solve_packed_reference`."""
    dev, dt = qrows.device, qrows.dtype
    n_rows = qrows.shape[0]
    qchecks = torch.zeros((n_rows,), dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    checks = 0
    qid = torch.nonzero(valid).flatten()
    n0 = qid.shape[0]
    lo = torch.zeros((n0, 3), dtype=dt, device=dev)
    hi = torch.ones((n0, 3), dtype=dt, device=dev)
    depth = torch.zeros((n0,), dtype=torch.int32, device=dev)
    dimcnt = torch.zeros((n0, 3), dtype=torch.int32, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    tile = min(max(n_rows, 256), _TILE)
    while qid.shape[0] > 0:
        count = qid.shape[0]
        top = max(count - tile, 0)
        p_lo, p_hi, p_q = lo[top:], hi[top:], qid[top:]
        p_depth, p_cnt = depth[top:], dimcnt[top:]
        q, tol, err, ms = _unpack(qrows[p_q])
        bound = tpq[p_q] if per_query else toi.expand(p_q.shape)
        if max_iterations >= 0:
            # pre-round counts; a dropped domain is pruned (no bound < -inf)
            pre = qchecks[p_q]
            qchecks.index_add_(0, p_q, torch.ones_like(pre))
            bound = torch.where(pre > max_iterations, -inf, bound)
        st = bisect_step(
            q, p_lo, p_hi, tol, err, ms, co_tol, bound, p_depth, p_cnt,
            is_vf, allow_zero_toi, caps,
        )
        checks += count - top
        acc_t = torch.where(st.accept, p_lo[:, 0], inf)
        if per_query:
            tpq.scatter_reduce_(0, p_q, acc_t, "amin")
        else:
            toi = torch.minimum(toi, acc_t.amin())
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
    checks = torch.tensor(checks, dtype=torch.int64, device=dev)
    if not per_query:
        return toi, ovf, checks
    if n_rows:
        toi = torch.minimum(toi, tpq.amin())
    return toi, ovf, checks, tpq


def solve_escalated(qrows, valid, is_vf: bool, toi_init, tolerance,
                    allow_zero_toi: bool = True, round_limit=-1,
                    widened: bool = False):
    """Global solve with staged escalation; returns ``(toi, overflow,
    checks)`` as :func:`solve_packed` does, ``checks`` counting every pass.

    ``round_limit`` is an int or a ladder (:func:`normalize_round_limits`);
    without a limit this is one unbounded :func:`solve_packed` call.  With
    one, the first pass stops at ``limits[0]`` rounds, and the host reads
    how many rows are unfinished (JAX ``_escalate_ladder``, where a
    ``lax.cond`` picks the branch on the device): none, and the pass is the
    answer; up to four pool blocks, and they are pooled in their original
    order and solved by the rest of the ladder; more, and they are solved
    in one unbounded pass.  Every later pass starts from the first pass's
    TOI and solves its rows from scratch."""
    limits = normalize_round_limits(round_limit)
    if not limits:
        return solve_packed(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi,
                            widened=widened)
    toi1, ovf1, checks1, unfin = solve_packed(
        qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi,
        round_limit=limits[0], widened=widened,
    )
    count = int(unfin.sum())
    if count == 0:
        return toi1, ovf1, checks1
    Q = qrows.shape[0]
    pool_cap = min(4 * POOL_BLOCK, -(-Q // POOL_BLOCK) * POOL_BLOCK)
    rows = qrows[torch.nonzero(unfin).flatten()]
    ones = torch.ones((count,), dtype=torch.bool, device=qrows.device)
    rest = limits[1:] if count <= pool_cap else ()
    toi2, ovf2, checks2 = solve_escalated(rows, ones, is_vf, toi1, tolerance,
                                          allow_zero_toi, rest, widened)
    return toi2, ovf1 | ovf2, checks1 + checks2
