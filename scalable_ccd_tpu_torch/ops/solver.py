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

:func:`solve_escalated_cols` is the staged escalation built on the last mode
(JAX ``_normalize_round_limits`` and ``_escalate_ladder``,
``pallas_solver.py:724-811``): one bounded pass, then the unfinished rows,
pooled in their original order, solved again from scratch and pruned by the
first pass's TOI, stage by stage of a ladder of limits, the last stage
unbounded (:func:`solve_unfinished_cols`, which the narrow loop also runs
per batch after one first pass over a whole chunk).  Its TOI is the
unbounded TOI bitwise unless a conservative accept fired (``overflow``).

Rows are f32 or f64, and the TOI comes back in their dtype (the kernel is
instantiated for both; :func:`scalable_ccd_tpu_torch.narrow_phase.
root_finder.search_caps` gives each its caps).  ``widened`` marks f64 rows
widened from f32 ones, the port's ``precision="compensated"``: packed in f32
with the compensated error filter, solved in native f64 under f32's split
cap, so that every bound, and with it the TOI, is exact in f32.

:func:`solve_cols` takes the rows as ``(31, Q)`` columns, field ``k`` of
query ``q`` at ``[k, q]`` (kernel C's output, :mod:`scalable_ccd_tpu_torch.
ops.gather_pack`, or a slice of a wider column buffer, read in place);
:func:`solve_packed` takes ``(Q, 31)`` rows.  Both run the CUDA kernel on
CUDA tensors and the plain version on CPU tensors; any other device raises.
Nothing falls back.  ``skip_if_done`` is the narrow loop's exit on the
device: a launch seeded with a running TOI of 0 or less does nothing.

:func:`solve_pairs` takes no rows at all: the candidate pairs and the
phase's tables, each row computed inside kernel B as kernel C computes it
(its pairs source), for a global solve, bounded or not, of a whole broad
chunk or phase in one launch with no column buffer.
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
    "solve_cols",
    "solve_packed",
    "solve_packed_reference",
    "solve_escalated_cols",
    "solve_unfinished_cols",
    "solve_pairs",
    "normalize_round_limits",
    "LAUNCHES_BY_MODE",
    "MAX_STEPS",
    "POOL_BLOCK",
    "ROW_WIDTH",
]

#: kernel launches made by :func:`solve_packed` and :func:`solve_pairs` in
#: this process, by mode: "global" (neither per-query, bounded nor
#: round-limited), "per_query", "bounded", "round_limit" and "pairs" (the
#: pairs source, :func:`solve_pairs`, global or bounded); a launch counts
#: in each of its modes; by scalar type as
#: :func:`scalable_ccd_tpu_torch.ops._build.launch_counts` lays out
LAUNCHES_BY_MODE = launch_counts("solver", "global", "per_query", "bounded", "round_limit",
                                 "pairs")

#: rows per batch of :func:`solve_pairs`'s plain twin (``MemoryConfig.
#: query_buckets[-1]``, ``ccd()``'s narrow batch), which bounds its memory
PAIRS_BATCH = 1 << 17

#: the most rows of one :func:`solve_pairs` launch (the kernel's ``int``
#: row count); a longer range is solved in launches of at most this many
LAUNCH_ROWS = 2**31 - 1

#: rows per pool block of the escalation glue (the JAX package's solver
#: block, ``SOLVER_BLOCK_SUB * 128``)
POOL_BLOCK = 2048

#: floats per packed query row: 8 endpoints, tol (3), err (3), ms
ROW_WIDTH = 31

#: the runaway guard: a query of an unbounded plain solve stops after this
#: many domain evaluations, accepts its earliest unexplored time and sets
#: overflow (kernel B's ``kMaxSteps``, ``csrc/solver.cu``)
MAX_STEPS = 1 << 20

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
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_solver_error_string.argtypes = [ctypes.c_int]
    lib.sccd_solver_error_string.restype = ctypes.c_char_p
    return fn


def _bind_pairs(lib):
    fn = lib.sccd_solve_pairs
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _grid(entry: str, Q: int, is_vf: bool, per_query: bool, f64: bool):
    lib = load_library("solver")
    _bind(lib)  # the error strings' types
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(int(is_vf), int(per_query), int(f64), int(Q), ctypes.byref(out),
            ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"solver grid query failed: "
                           f"{lib.sccd_solver_error_string(rc).decode()}")
    return out.value, per_sm.value


def _lane_grid(Q: int, is_vf: bool, per_query: bool, f64: bool):
    """``(blocks, blocks per SM)``: the persistent grid of kernel B's
    one-thread form (bounded and round-limited modes) for ``Q`` queries on
    the current CUDA device, in 128-thread blocks, and the blocks the
    occupancy calculator keeps resident on one SM.  For reports only
    (``chip_smoke.py``)."""
    return _grid("sccd_solver_lane_grid", Q, is_vf, per_query, f64)


def _share_grid(Q: int, is_vf: bool, per_query: bool, f64: bool):
    """``(queries per block, blocks per SM)`` of kernel B's shared form
    (unbounded global and per-query modes) for ``Q`` queries on the current
    CUDA device: 128, 64 or 32 queries a block (the most whose blocks fill
    every SM's resident slots, else 32), and the blocks the occupancy
    calculator keeps resident on one SM.  For reports and tests."""
    return _grid("sccd_solver_share_grid", Q, is_vf, per_query, f64)


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


def _check_cols(cols, widened: bool):
    if (cols.dtype not in (torch.float32, torch.float64) or cols.dim() != 2
            or cols.shape[0] != ROW_WIDTH):
        raise ValueError(
            f"solve_cols: cols must be float32 or float64 ({ROW_WIDTH}, Q), got "
            f"{cols.dtype} {tuple(cols.shape)}"
        )
    if widened and cols.dtype != torch.float64:
        raise ValueError(f"solve_cols: widened rows are float64, got {cols.dtype}")


def _skipped(dt, dev, Q, toi_init, per_query, round_limit):
    """The outputs of a launch that ``skip_if_done`` stopped: the seed, no
    overflow, no checks, and the fourth output of the mode untouched."""
    out = (torch.as_tensor(toi_init, dtype=dt, device=dev).reshape(()).clone(),
           torch.zeros((), dtype=torch.bool, device=dev),
           torch.zeros((), dtype=torch.int64, device=dev))
    if per_query:
        out += (torch.full((Q,), float("inf"), dtype=dt, device=dev),)
    elif round_limit >= 0:
        out += (torch.zeros((Q,), dtype=torch.bool, device=dev),)
    return out


def solve_cols(cols, valid, is_vf: bool, toi_init, tolerance,
               allow_zero_toi: bool = True, per_query: bool = False,
               max_iterations: int = -1, round_limit: int = -1,
               widened: bool = False, skip_if_done: bool = False):
    """:func:`solve_packed` of ``(31, Q)`` columns: ``cols[:, q]`` is row
    ``q`` (module docstring); its column stride must be 1, and a slice of
    a wider buffer is read in place.  ``skip_if_done``: when the seed
    ``toi_init`` is 0 or less, no query is evaluated and the outputs are
    the seed, no overflow and 0 checks (the narrow loop's ``toi > 0``
    exit, decided on the device; only for launches made where the JAX
    loop's condition guards the solve)."""
    _check_round_limit(round_limit, per_query, max_iterations)
    _check_cols(cols, widened)
    if cols.device.type == "cpu":
        return solve_packed_reference(
            cols.t(), valid, is_vf, toi_init, tolerance, allow_zero_toi,
            per_query, max_iterations, round_limit, widened, skip_if_done,
        )
    return _launch(cols, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
                   max_iterations, round_limit, widened, skip_if_done=skip_if_done)[0]


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
    _check_rows(qrows, widened)
    return solve_cols(_columns(qrows), valid, is_vf, toi_init, tolerance, allow_zero_toi,
                      per_query, max_iterations, round_limit, widened)


def _columns(qrows):
    """``(31, Q)`` contiguous columns of ``(Q, 31)`` rows: neighbouring
    threads of kernel B read neighbouring words."""
    return qrows.t().contiguous()


def _launch(cols, valid, is_vf, toi_init, tolerance, allow_zero_toi, per_query,
            max_iterations, round_limit, widened, query_checks=False, skip_if_done=False):
    """Kernel B on CUDA columns: ``(outputs of solve_cols, plane)``, the
    plane each query's evaluation count (``(Q,)`` int64) where
    ``query_checks`` asks for it, else ``None``."""
    dev = cols.device
    if dev.type != "cuda":
        raise ValueError(f"solve_cols: unsupported device {dev}")
    _check_cols(cols, widened)
    Q = cols.shape[1]
    dt = cols.dtype
    f64 = dt == torch.float64
    caps = search_caps(dt, widened)
    if valid.device != dev or valid.dtype != torch.bool or tuple(valid.shape) != (Q,):
        raise ValueError(
            f"solve_cols: valid must be bool ({Q},) on {dev}, got "
            f"{valid.dtype} {tuple(valid.shape)} on {valid.device}"
        )
    ld = cols.stride(0)
    if not (valid.is_contiguous() and (cols.stride(1) == 1 or Q <= 1) and ld >= Q):
        raise ValueError("solve_cols: valid must be contiguous and cols a column buffer "
                         f"(strides (ld >= Q, 1)), got strides {cols.stride()}")
    if Q >= 2**31 // ROW_WIDTH:
        raise ValueError(f"solve_cols: {Q} rows exceed the kernel's index range")
    # the running TOI before this launch; + 0.0 turns a -0.0 seed into +0.0
    # (the atomicMin compares integer bits)
    seed = torch.as_tensor(toi_init, dtype=dt, device=dev).reshape(1)
    toi = seed + 0.0
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
                cols.data_ptr(), max(ld, Q), seed.data_ptr() if skip_if_done else None,
                valid.data_ptr(), Q, int(bool(is_vf)),
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


def solve_pairs(pairs, start: int, stop: int, vcat, table, is_vf: bool, toi_init, ms,
                tolerance, allow_zero_toi: bool = True, max_iterations: int = 1_000_000,
                compensated: bool = False, skip_if_done: bool = False,
                batch: int = PAIRS_BATCH):
    """Global solve of the candidate pairs ``pairs[start:stop]`` with no
    packed rows: returns 0-d ``(toi, overflow, checks)`` as
    :func:`solve_packed` does, ``toi`` in the rows' dtype
    (:func:`scalable_ccd_tpu_torch.ops.gather_pack.row_dtype`).

    ``pairs``, ``vcat``, ``table``, ``is_vf``, ``ms``, ``tolerance`` and
    ``compensated`` are :func:`scalable_ccd_tpu_torch.ops.gather_pack.
    gather_pack`'s; ``toi_init``, ``allow_zero_toi``, ``max_iterations``
    (``< 0``: unbounded) and ``skip_if_done`` are :func:`solve_cols`'s.  On
    CUDA it is one launch of kernel B (the one-thread form when bounded,
    the shared form when unbounded) whose threads compute each row from its
    pair as kernel C does, bit for bit, so that no column buffer exists and
    a broad chunk or a whole phase is one launch (a range past
    :data:`LAUNCH_ROWS` rows, one launch per that many).  Its plain twin, on
    CPU tensors, packs and solves batches of at most ``batch`` rows in turn
    (:func:`~scalable_ccd_tpu_torch.ops.gather_pack.gather_pack_reference`
    and :func:`solve_packed_reference`), each seeded with the TOI before it,
    so that its memory stays bounded: the global TOI is a minimum over the
    queries, and how they are split into launches changes only the checks
    (where a cap binds, the result depends on the order, module
    docstring)."""
    start, stop = int(start), int(stop)
    if pairs.device.type == "cpu":
        from scalable_ccd_tpu_torch.ops.gather_pack import gather_pack_reference

        toi = torch.as_tensor(toi_init, dtype=torch.float64 if compensated else vcat.dtype)
        toi = toi.reshape(()).clone()
        ovf = torch.zeros((), dtype=torch.bool)
        checks = torch.zeros((), dtype=torch.int64)
        for s in range(start, stop, int(batch)):
            e = min(s + int(batch), stop)
            cols = gather_pack_reference(pairs, s, e, vcat, table, is_vf, ms, tolerance,
                                         compensated)
            toi, o, c = solve_packed_reference(
                cols.t(), torch.ones((e - s,), dtype=torch.bool), is_vf, toi, tolerance,
                allow_zero_toi, max_iterations=max_iterations, widened=compensated,
                skip_if_done=skip_if_done)
            ovf, checks = ovf | o, checks + c
        return toi, ovf, checks
    return _launch_pairs(pairs, start, stop, vcat, table, is_vf, toi_init, ms, tolerance,
                         allow_zero_toi, max_iterations, compensated, skip_if_done)


def _launch_pairs(pairs, start, stop, vcat, table, is_vf, toi_init, ms, tolerance,
                  allow_zero_toi, max_iterations, compensated, skip_if_done):
    """Kernel B's pairs source on CUDA tensors (:func:`solve_pairs`)."""
    from scalable_ccd_tpu_torch.ops import gather_pack as gp

    dev = pairs.device
    dt = gp._tables("solve_pairs", dev, vcat, table, is_vf, compensated)
    if pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"solve_pairs: pairs int32 (N, 2) expected, got {pairs.dtype} "
                         f"{tuple(pairs.shape)}")
    if not pairs.is_contiguous() or pairs.data_ptr() % 8:
        raise ValueError("solve_pairs: pairs must be contiguous and 8-byte aligned")
    if not 0 <= start <= stop <= pairs.shape[0]:
        raise ValueError(f"solve_pairs: rows [{start}, {stop}) outside the {pairs.shape[0]} "
                         "pairs")
    rdt = gp.row_dtype(dt, compensated)
    f64 = rdt == torch.float64
    caps = search_caps(rdt, compensated)
    # the running TOI before the first launch; + 0.0 turns a -0.0 seed into
    # +0.0 (the atomicMin compares integer bits)
    seed = torch.as_tensor(toi_init, dtype=rdt, device=dev).reshape(1)
    toi = seed + 0.0
    checks = torch.zeros((1,), dtype=torch.int64, device=dev)
    ovf = torch.zeros((1,), dtype=torch.int32, device=dev)
    if stop > start:
        kind, ms_t, co_tol, k_eps = gp._scalars(dt, is_vf, ms, tolerance, compensated)
        lib = load_library("solver")
        _bind(lib)  # the error strings' types
        fn = _bind_pairs(lib)
        modes = ["global" if max_iterations < 0 else "bounded", "pairs"]
        for s in range(start, stop, LAUNCH_ROWS):
            # a later launch's skip seed is the TOI the launches before it left
            skip = (seed if s == start else toi.clone()) if skip_if_done else None
            with torch.cuda.device(dev):
                rc = fn(pairs.data_ptr(), s, min(LAUNCH_ROWS, stop - s), vcat.data_ptr(),
                        vcat.shape[0], table.data_ptr(), table.shape[0], int(bool(is_vf)),
                        kind, ms_t, co_tol, k_eps, skip.data_ptr() if skip is not None else None,
                        int(bool(allow_zero_toi)), caps.dim_cap, int(max_iterations),
                        caps.uv_limit, toi.data_ptr(), checks.data_ptr(), ovf.data_ptr(), None,
                        torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                msg = lib.sccd_solver_error_string(rc).decode()
                raise RuntimeError(f"solver kernel launch failed: {msg}")
            count_launch(LAUNCHES_BY_MODE, modes, f64)
    return toi[0], ovf[0] != 0, checks[0]


def _solve_query_checks(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi=True,
                        per_query=False, max_iterations=-1, round_limit=-1, widened=False):
    """:func:`solve_packed` on CUDA tensors with one more output: the
    ``(Q,)`` int64 plane of each query's domain evaluations (0 for invalid
    rows).  For measurements only (``chip_smoke.py``, the stage tool); no
    caller on the main path asks for the plane."""
    _check_round_limit(round_limit, per_query, max_iterations)
    _check_rows(qrows, widened)
    out, plane = _launch(_columns(qrows), valid, is_vf, toi_init, tolerance, allow_zero_toi,
                         per_query, max_iterations, round_limit, widened, query_checks=True)
    return out + (plane,)


def _reference_query_checks(qrows, valid, is_vf, toi_init, tolerance, allow_zero_toi=True,
                            per_query=False, max_iterations=-1, round_limit=-1,
                            widened=False):
    """The plain twin of :func:`_solve_query_checks` in the modes whose
    per-query evaluation counts each query's order fixes, the per-query
    bounded and round-limited ones: :func:`solve_packed_reference`'s
    outputs (the lockstep DFS's) and its ``(Q,)`` int64 plane of each
    query's evaluations.  For measurements and tests only."""
    _check_round_limit(round_limit, per_query, max_iterations)
    if not ((per_query and max_iterations >= 0) or round_limit >= 0):
        raise ValueError("_reference_query_checks: a per-query bounded or round-limited mode")
    _check_rows(qrows, widened)
    dt = qrows.dtype
    co_tol = torch.tensor(_co_tolerance(tolerance, dt, widened), dtype=dt, device=qrows.device)
    q, tol, err, ms = _unpack(qrows)
    return dfs_lockstep(q, tol, err, ms, valid.to(torch.bool), co_tol, toi_init, is_vf,
                        allow_zero_toi, max_iterations, round_limit, search_caps(dt, widened),
                        query_checks=True)


def _checks_spread(plane) -> dict:
    """The spread of per-query evaluation counts (:func:`_solve_query_checks`):
    mean, median, 99th percentile and maximum, and the lane efficiency of
    running them in groups of consecutive rows, each group as long as its
    longest member, for groups of 32 queries (one query per thread, a warp
    that takes no new query until all 32 end) and of 4 (eight lanes per
    query, a warp): ``sum(checks) / sum over groups of (size * the group's
    max)``."""
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
                           widened: bool = False, skip_if_done: bool = False):
    """Plain PyTorch twin of kernel B, on any device; same arguments and
    outputs as :func:`solve_packed`, computed in the rows' dtype.  Under
    ``skip_if_done`` it reads the seed on the host.

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
    kernel's, and so is its runaway guard: a query past :data:`MAX_STEPS`
    evaluations (with a cap, past the last evaluation a capped search can
    make) accepts the earliest time still on its stack and sets overflow.
    Unbounded results do not depend on the exploration order, unless the
    guard fires (then the accepted time depends on it, as in the kernel).  A
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
    if skip_if_done and float(toi_init) <= 0:
        return _skipped(dt, dev, qrows.shape[0], toi_init, per_query, round_limit)
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
    # the kernel raises its guard past a cap's last evaluation (the cap,
    # then one dropped evaluation per pending sibling)
    guard = MAX_STEPS if max_iterations < 0 else max(
        MAX_STEPS, max_iterations + 2 * caps.max_depth + 2)
    while qid.shape[0] > 0:
        count = qid.shape[0]
        top = max(count - tile, 0)
        p_lo, p_hi, p_q = lo[top:], hi[top:], qid[top:]
        p_depth, p_cnt = depth[top:], dimcnt[top:]
        q, tol, err, ms = _unpack(qrows[p_q])
        bound = tpq[p_q] if per_query else toi.expand(p_q.shape)
        # pre-round counts
        pre = qchecks[p_q]
        qchecks.index_add_(0, p_q, torch.ones_like(pre))
        if max_iterations >= 0:
            # a dropped domain is pruned (no bound < -inf)
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
        # the runaway guard: a query past it accepts the earliest time
        # still on its stack, and its domains leave the stack
        over = qchecks[qid] >= guard
        if bool(over.any()):
            t_over, q_over = lo[over, 0], qid[over]
            if per_query:
                tpq.scatter_reduce_(0, q_over, t_over, "amin")
            else:
                toi = torch.minimum(toi, t_over.amin())
            ovf.fill_(True)
            stay = ~over
            lo, hi, qid, depth, dimcnt = lo[stay], hi[stay], qid[stay], depth[stay], dimcnt[stay]
    checks = torch.tensor(checks, dtype=torch.int64, device=dev)
    if not per_query:
        return toi, ovf, checks
    if n_rows:
        toi = torch.minimum(toi, tpq.amin())
    return toi, ovf, checks, tpq


def solve_escalated_cols(cols, valid, is_vf: bool, toi_init, tolerance,
                         allow_zero_toi: bool = True, round_limit=-1,
                         widened: bool = False, skip_if_done: bool = False):
    """Global solve of ``(31, Q)`` columns with staged escalation; returns
    ``(toi, overflow, checks)`` as :func:`solve_packed` does, ``checks``
    counting every pass.  ``skip_if_done`` applies to every pass.

    ``round_limit`` is an int or a ladder (:func:`normalize_round_limits`);
    without a limit this is one unbounded :func:`solve_cols` call.  With
    one, the first pass stops at ``limits[0]`` rounds, and
    :func:`solve_unfinished_cols` solves the rows it left unfinished with
    the rest of the ladder, from the first pass's TOI."""
    limits = normalize_round_limits(round_limit)
    if not limits:
        return solve_cols(cols, valid, is_vf, toi_init, tolerance, allow_zero_toi,
                          widened=widened, skip_if_done=skip_if_done)
    toi1, ovf1, checks1, unfin = solve_cols(
        cols, valid, is_vf, toi_init, tolerance, allow_zero_toi,
        round_limit=limits[0], widened=widened, skip_if_done=skip_if_done,
    )
    if cols.shape[1] == 0:
        return toi1, ovf1, checks1
    toi, ovf, checks = solve_unfinished_cols(cols, unfin, is_vf, toi1, tolerance,
                                             allow_zero_toi, limits[1:], widened,
                                             skip_if_done)
    return toi, ovf1 | ovf, checks1 + checks


def solve_unfinished_cols(cols, unfin, is_vf: bool, toi_init, tolerance,
                          allow_zero_toi: bool = True, round_limit=-1,
                          widened: bool = False, skip_if_done: bool = False):
    """The escalation after a first pass over the ``Q >= 1`` columns
    ``cols``: the rows the bool plane ``unfin`` marks are solved again from
    scratch, pruned by ``toi_init`` (the TOI after that pass, or any lower
    TOI that a query accepted), by the rest of the ladder ``round_limit``
    (its later stages; none: unbounded).  Returns ``(toi, overflow,
    checks)`` of these passes.  ``skip_if_done`` applies to every pass: one
    seeded with a TOI of 0 would prune every domain it evaluates, so
    skipping it changes the checks alone.

    The rows go one of three ways (JAX ``_escalate_ladder``): none, and
    nothing is solved; up to ``K = min(4 * POOL_BLOCK, Q rounded up to whole
    pool blocks)`` of them, and they are pooled in their original order
    (cumsum and searchsorted) and solved by the rest of the ladder
    (:func:`solve_escalated_cols`); more, and they are solved in one
    unbounded pass.  The device picks the branch: the pool pass runs over
    ``K`` gathered columns, valid where ``count <= K``, and the unbounded
    pass over the batch, valid where ``count > K``; the one not taken has
    no valid row and evaluates nothing.  No host read, at any length of the
    ladder."""
    Q = cols.shape[1]
    dev = cols.device
    pool_cap = min(4 * POOL_BLOCK, -(-Q // POOL_BLOCK) * POOL_BLOCK)
    cum = torch.cumsum(unfin, 0)
    count = cum[-1]
    lane = torch.arange(pool_cap, device=dev)
    idx = torch.searchsorted(cum, lane + 1).clamp_(max=Q - 1)
    small = (lane < count) & (count <= pool_cap)
    toi_s, ovf_s, ck_s = solve_escalated_cols(cols.index_select(1, idx), small, is_vf, toi_init,
                                              tolerance, allow_zero_toi, round_limit, widened,
                                              skip_if_done)
    toi_f, ovf_f, ck_f = solve_cols(cols, unfin & (count > pool_cap), is_vf, toi_init,
                                    tolerance, allow_zero_toi, widened=widened,
                                    skip_if_done=skip_if_done)
    return torch.minimum(toi_s, toi_f), ovf_s | ovf_f, ck_s + ck_f
