"""Gather and pack of one narrow batch: kernel C (``csrc/gather_pack.cu``)
and its plain twin.

For the candidate pairs ``pairs[start:stop]`` (element ids, int32 ``(N,
2)``: VF as (vertex, face), EE as (edge, edge)) both versions gather the
four points' endpoints at t=0 and t=1 from the phase's tables, compute the
per-query domain tolerances and the error filter, and return the packed
rows as ``(31, Q)`` columns, the layout kernel B reads
(:func:`scalable_ccd_tpu_torch.ops.solver.solve_cols`): field ``k`` of row
``i`` at ``[k, i]``, in the field order of
:func:`scalable_ccd_tpu_torch.ops.solver.pack_query_rows`.  The result is
bitwise ``pack_query_rows(gather_vf_queries(...) or gather_ee_queries(...),
is_vf, ms, tolerance, compensated).to(row dtype).t()``, which the plain
version computes.

The JAX package runs this glue inside its jitted narrow batch
(``pipeline/fused.py`` ``run_solver`` / ``run_bounded``, with
``ops/pallas_solver.py:649`` ``pack_query_rows``), as XLA code and not as a
Pallas kernel; the port gives it a kernel of its own so that a batch is one
launch and not some forty small ops and two copies.

Rows are f32 or f64 in the tables' dtype; ``compensated`` (f32 tables)
packs the compensated error filter in f32 and writes the rows as f64, the
exact widening kernel B's widened mode takes.

:func:`gather_pack` runs the CUDA kernel on CUDA tensors and the plain
version on CPU tensors; any other device raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from scalable_ccd_tpu_torch.narrow_phase.types import (
    COMPENSATED_EPS,
    gather_ee_queries,
    gather_vf_queries,
)
from scalable_ccd_tpu_torch.ops._build import count_launch, launch_counts, load_library
from scalable_ccd_tpu_torch.ops.solver import ROW_WIDTH, pack_query_rows

__all__ = ["gather_pack", "gather_pack_reference", "row_dtype", "LAUNCHES",
           "LAUNCHES_BY_MODE"]

#: kernel launches made by :func:`gather_pack` in this process
LAUNCHES = 0

#: the same launches by mode: "vf" or "ee", and "compensated" for the
#: compensated rows (counted as f64, their rows' type); by scalar type as
#: :func:`scalable_ccd_tpu_torch.ops._build.launch_counts` lays out
LAUNCHES_BY_MODE = launch_counts("vf", "ee", "compensated")


def row_dtype(table_dtype, compensated: bool = False):
    """The dtype of the packed rows of tables in ``table_dtype``."""
    return torch.float64 if compensated else table_dtype


def gather_pack(pairs, start: int, stop: int, vcat, table, is_vf: bool, ms, tolerance,
                compensated: bool = False) -> torch.Tensor:
    """``(31, stop - start)`` packed columns of the candidate pairs
    ``pairs[start:stop]`` (module docstring).

    ``vcat`` is :func:`scalable_ccd_tpu_torch.narrow_phase.types.
    concat_frames`, ``table`` the phase's face table (``pack_face_table``,
    VF) or edge table (``pack_edge_table``, EE); ids out of range are
    clamped, as the gather clamps them.  ``ms`` is the minimum separation
    and ``tolerance`` the co-domain tolerance, both rounded to the tables'
    dtype first."""
    if pairs.device.type == "cpu":
        return gather_pack_reference(pairs, start, stop, vcat, table, is_vf, ms, tolerance,
                                     compensated)
    return _launch(pairs, start, stop, vcat, table, is_vf, ms, tolerance, compensated)


def gather_pack_reference(pairs, start: int, stop: int, vcat, table, is_vf: bool, ms,
                          tolerance, compensated: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of kernel C, on any device; same arguments and
    output as :func:`gather_pack`."""
    chunk = pairs[start:stop]
    q = gather_vf_queries(vcat, table, chunk) if is_vf else gather_ee_queries(table, chunk)
    rows = pack_query_rows(q, is_vf, ms, tolerance, compensated)
    return rows.to(row_dtype(vcat.dtype, compensated)).t().contiguous()


def _bind(lib):
    fn = lib.sccd_gather_pack
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sccd_gather_pack_error_string.argtypes = [ctypes.c_int]
    lib.sccd_gather_pack_error_string.restype = ctypes.c_char_p
    return fn


def _scalar(x, dt) -> float:
    """``x`` rounded to ``dt``, as ``torch.as_tensor(x, dtype=dt)`` rounds it."""
    return float(torch.tensor(float(x), dtype=dt))


def _launch(pairs, start, stop, vcat, table, is_vf, ms, tolerance, compensated):
    """Kernel C on CUDA tensors."""
    global LAUNCHES
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError(f"gather_pack: unsupported device {dev}")
    dt = vcat.dtype
    width = 18 if is_vf else 12
    if dt not in (torch.float32, torch.float64) or table.dtype != dt:
        raise ValueError(f"gather_pack: vcat and table must share float32 or float64, got "
                         f"{dt} and {table.dtype}")
    if compensated and dt != torch.float32:
        raise ValueError(f"gather_pack: compensated rows pack float32 tables, got {dt}")
    if (pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[1] != 2
            or tuple(vcat.shape[1:]) != (6,) or tuple(table.shape[1:]) != (width,)):
        raise ValueError(
            f"gather_pack: pairs int32 (N, 2), vcat (n, 6) and table (m, {width}) expected, "
            f"got {pairs.dtype} {tuple(pairs.shape)}, {tuple(vcat.shape)}, "
            f"{tuple(table.shape)}")
    if any(t.device != dev for t in (vcat, table)):
        raise ValueError(f"gather_pack: every tensor must be on {dev}")
    if not (pairs.is_contiguous() and vcat.is_contiguous() and table.is_contiguous()):
        raise ValueError("gather_pack: pairs, vcat and table must be contiguous")
    start, stop = int(start), int(stop)
    if not 0 <= start <= stop <= pairs.shape[0]:
        raise ValueError(f"gather_pack: rows [{start}, {stop}) outside the {pairs.shape[0]} "
                         "pairs")
    Q = stop - start
    if Q >= 2**31 or max(vcat.shape[0], table.shape[0]) >= 2**31:
        raise ValueError("gather_pack: the batch or a table exceeds the kernel's index range")
    out = torch.empty((ROW_WIDTH, Q), dtype=row_dtype(dt, compensated), device=dev)
    if Q == 0:
        return out
    ms_t = _scalar(ms, dt)
    eps = COMPENSATED_EPS if compensated else torch.finfo(dt).eps
    k_eps = ((30 if is_vf else 28) + (4 if ms_t > 0 else 0)) * eps
    kind = 2 if compensated else int(dt == torch.float64)
    lib = load_library("gather_pack")
    fn = _bind(lib)
    with torch.cuda.device(dev):
        rc = fn(pairs.data_ptr(), start, Q, vcat.data_ptr(), vcat.shape[0], table.data_ptr(),
                table.shape[0], int(bool(is_vf)), kind, ms_t, _scalar(tolerance, dt), k_eps,
                out.data_ptr(), Q, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.sccd_gather_pack_error_string(rc).decode()
        raise RuntimeError(f"gather_pack kernel launch failed: {msg}")
    LAUNCHES += 1
    count_launch(LAUNCHES_BY_MODE, ["vf" if is_vf else "ee"]
                 + (["compensated"] if compensated else []), out.dtype == torch.float64)
    return out
