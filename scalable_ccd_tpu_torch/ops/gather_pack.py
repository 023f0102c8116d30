"""Gather and pack of narrow-phase rows: kernel C (``csrc/gather_pack.cu``)
and its plain twins.

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

The records mode (:func:`gather_pack_records`) packs pairs ``[start,
stop)`` of kernel A''s record stream (:mod:`scalable_ccd_tpu_torch.ops.
sweep_records`) straight from the records: each row finds its record in the
pair prefix, takes its bit and maps it to element ids, as
:func:`scalable_ccd_tpu_torch.ops.sweep_records.decode_records_range` does,
and packs the pair; it can also write the pairs' ids.  Its plain twin is that
decode followed by the pairs mode's plain version.

The JAX package runs this glue inside its jitted narrow batch
(``pipeline/fused.py`` ``run_solver`` / ``run_bounded``, with
``ops/pallas_solver.py:649`` ``pack_query_rows``, and its records decode),
as XLA code and not as a Pallas kernel.  The port gives it a kernel of its
own, launched once per chunk of a phase's candidates: the narrow loop packs
a phase in chunks of whole batches of at most :data:`CHUNK_ROWS` rows
(:func:`chunk_rows`), and kernel B reads each batch as a column slice of its
chunk (``pipeline/narrow.py``, ``PairStream`` and ``RecordStream``).

Rows are f32 or f64 in the tables' dtype; ``compensated`` (f32 tables)
packs the compensated error filter in f32 and writes the rows as f64, the
exact widening kernel B's widened mode takes.  ``out``, where given, is a
column buffer ``(31, >= Q)`` of the rows' dtype with column stride 1 (a
slice of a wider buffer too); the rows go to its first ``Q`` columns and
those are returned.

:func:`gather_pack` and :func:`gather_pack_records` run the CUDA kernel on
CUDA tensors and the plain version on CPU tensors; any other device raises.
Nothing falls back.
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
from scalable_ccd_tpu_torch.ops.sweep_records import REC_WORDS, decode_records_range

__all__ = ["gather_pack", "gather_pack_reference", "gather_pack_records",
           "gather_pack_records_reference", "row_dtype", "chunk_rows", "CHUNK_ROWS",
           "LAUNCHES_BY_MODE"]

#: kernel launches made by :func:`gather_pack` and :func:`gather_pack_records`
#: in this process, by mode: "vf" or "ee", "compensated" for the
#: compensated rows (counted as f64, their rows' type) and "records" for the
#: records mode; by scalar type as
#: :func:`scalable_ccd_tpu_torch.ops._build.launch_counts` lays out
LAUNCHES_BY_MODE = launch_counts("gather_pack", "vf", "ee", "compensated", "records")

#: most rows of one chunk, the columns of one phase's packed-row buffer in
#: the narrow loop: 2^20 rows are 130 MB of f32 rows and 260 MB of f64 or
#: compensated ones, whatever the scene
CHUNK_ROWS = 1 << 20

#: pairs per record at most (a record's mask covers a 128-box a-row)
_ROW = 128


def chunk_rows(batch: int) -> int:
    """Rows of one chunk for narrow batches of ``batch``: the most whole
    batches that fit in :data:`CHUNK_ROWS` rows, and one batch where a batch
    is larger, so that no batch straddles two chunks."""
    batch = int(batch)
    return max(batch, CHUNK_ROWS // batch * batch)


def row_dtype(table_dtype, compensated: bool = False):
    """The dtype of the packed rows of tables in ``table_dtype``."""
    return torch.float64 if compensated else table_dtype


def gather_pack(pairs, start: int, stop: int, vcat, table, is_vf: bool, ms, tolerance,
                compensated: bool = False, *, out=None) -> torch.Tensor:
    """``(31, stop - start)`` packed columns of the candidate pairs
    ``pairs[start:stop]`` (module docstring).

    ``vcat`` is :func:`scalable_ccd_tpu_torch.narrow_phase.types.
    concat_frames`, ``table`` the phase's face table (``pack_face_table``,
    VF) or edge table (``pack_edge_table``, EE); ids out of range are
    clamped, as the gather clamps them.  ``ms`` is the minimum separation
    and ``tolerance`` the co-domain tolerance, both rounded to the tables'
    dtype first.  ``out``: the column buffer to write (module docstring)."""
    if pairs.device.type == "cpu":
        return gather_pack_reference(pairs, start, stop, vcat, table, is_vf, ms, tolerance,
                                     compensated, out=out)
    return _launch(pairs, start, stop, vcat, table, is_vf, ms, tolerance, compensated, out)


def gather_pack_reference(pairs, start: int, stop: int, vcat, table, is_vf: bool, ms,
                          tolerance, compensated: bool = False, *, out=None) -> torch.Tensor:
    """Plain PyTorch twin of kernel C, on any device; same arguments and
    output as :func:`gather_pack`."""
    chunk = pairs[start:stop]
    q = gather_vf_queries(vcat, table, chunk) if is_vf else gather_ee_queries(table, chunk)
    rows = pack_query_rows(q, is_vf, ms, tolerance, compensated)
    cols = rows.to(row_dtype(vcat.dtype, compensated)).t()
    if out is None:
        return cols.contiguous()
    dst = _check_out(out, cols.shape[1], cols.dtype, pairs.device, "gather_pack")
    return dst.copy_(cols)


def gather_pack_records(sorted_boxes, records, cum, start: int, stop: int, vcat, table,
                        is_vf: bool, ms, tolerance, compensated: bool = False,
                        pairs_out=None, *, out=None) -> torch.Tensor:
    """``(31, stop - start)`` packed columns of pairs ``[start, stop)`` of a
    phase's record stream (module docstring).

    ``sorted_boxes`` are the phase's sorted boxes (their ``element_id``),
    ``records`` kernel A''s ``(R, 8)`` buffer and ``cum`` its
    :func:`scalable_ccd_tpu_torch.ops.sweep_records.records_pair_prefix`;
    ``stop`` is at most the stream's pair count (``cum[-1]``, or less where a
    budget cut it).  The pairs are in the emit convention of two lists when
    ``is_vf`` (VF) and of one list otherwise (EE), as
    :func:`~scalable_ccd_tpu_torch.ops.sweep_records.decode_records_range`
    gives them.  ``pairs_out``, an int32 ``(>= stop - start, 2)`` buffer,
    also receives the rows' pairs.  The rest as for :func:`gather_pack`."""
    if records.device.type == "cpu":
        return gather_pack_records_reference(sorted_boxes, records, cum, start, stop, vcat,
                                             table, is_vf, ms, tolerance, compensated,
                                             pairs_out, out=out)
    return _launch_records(sorted_boxes, records, cum, start, stop, vcat, table, is_vf, ms,
                           tolerance, compensated, pairs_out, out)


def gather_pack_records_reference(sorted_boxes, records, cum, start: int, stop: int, vcat,
                                  table, is_vf: bool, ms, tolerance,
                                  compensated: bool = False, pairs_out=None, *,
                                  out=None) -> torch.Tensor:
    """Plain PyTorch twin of kernel C's records mode, on any device:
    :func:`~scalable_ccd_tpu_torch.ops.sweep_records.decode_records_range`
    from the record holding pair ``start`` (found by one search of ``cum``),
    then :func:`gather_pack_reference`; same arguments and output as
    :func:`gather_pack_records`."""
    r_lo = torch.searchsorted(cum, torch.tensor([int(start)], device=cum.device),
                              right=True)[0] if cum.numel() else 0
    pairs, _ = decode_records_range(sorted_boxes, records, cum, int(start), int(stop), r_lo,
                                    is_vf)
    if pairs_out is not None:
        pairs_out[:pairs.shape[0]].copy_(pairs)
    return gather_pack_reference(pairs, 0, pairs.shape[0], vcat, table, is_vf, ms, tolerance,
                                 compensated, out=out)


def _bind(lib):
    fn = lib.sccd_gather_pack
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    rec = lib.sccd_gather_pack_records
    rec.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    rec.restype = ctypes.c_int
    lib.sccd_gather_pack_error_string.argtypes = [ctypes.c_int]
    lib.sccd_gather_pack_error_string.restype = ctypes.c_char_p
    return fn, rec


def _scalar(x, dt) -> float:
    """``x`` rounded to ``dt``, as ``torch.as_tensor(x, dtype=dt)`` rounds it."""
    return float(torch.tensor(float(x), dtype=dt))


def _check_out(out, Q, dt, dev, name):
    """The first ``Q`` columns of the caller's column buffer ``out``, which
    must hold them in the rows' dtype with column stride 1; a new ``(31,
    Q)`` buffer where ``out`` is ``None``."""
    if out is None:
        return torch.empty((ROW_WIDTH, Q), dtype=dt, device=dev)
    if (out.dtype != dt or out.device != dev or out.dim() != 2
            or out.shape[0] != ROW_WIDTH or out.shape[1] < Q
            or (out.stride(1) != 1 and out.shape[1] > 1)):
        raise ValueError(
            f"{name}: out must be a ({ROW_WIDTH}, >= {Q}) {dt} column buffer on {dev} with "
            f"column stride 1, got {out.dtype} {tuple(out.shape)} strides {out.stride()} "
            f"on {out.device}")
    return out[:, :Q]


def _tables(name, dev, vcat, table, is_vf, compensated):
    """Checks the tables for a launch on ``dev``; returns their dtype."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    dt = vcat.dtype
    width = 18 if is_vf else 12
    if dt not in (torch.float32, torch.float64) or table.dtype != dt:
        raise ValueError(f"{name}: vcat and table must share float32 or float64, got "
                         f"{dt} and {table.dtype}")
    if compensated and dt != torch.float32:
        raise ValueError(f"{name}: compensated rows pack float32 tables, got {dt}")
    if tuple(vcat.shape[1:]) != (6,) or tuple(table.shape[1:]) != (width,):
        raise ValueError(f"{name}: vcat (n, 6) and table (m, {width}) expected, got "
                         f"{tuple(vcat.shape)}, {tuple(table.shape)}")
    if any(t.device != dev for t in (vcat, table)):
        raise ValueError(f"{name}: every tensor must be on {dev}")
    # the kernel reads table rows in 16-byte vector loads
    if not (vcat.is_contiguous() and table.is_contiguous()) or any(
            t.data_ptr() % 16 for t in (vcat, table)):
        raise ValueError(f"{name}: vcat and table must be contiguous and 16-byte aligned")
    if max(vcat.shape[0], table.shape[0]) >= 2**31:
        raise ValueError(f"{name}: a table exceeds the kernel's index range")
    return dt


def _scalars(dt, is_vf, ms, tolerance, compensated):
    """``(kind, ms, co_tol, k_eps)`` of a launch, each rounded to ``dt``."""
    ms_t = _scalar(ms, dt)
    eps = COMPENSATED_EPS if compensated else torch.finfo(dt).eps
    k_eps = ((30 if is_vf else 28) + (4 if ms_t > 0 else 0)) * eps
    kind = 2 if compensated else int(dt == torch.float64)
    return kind, ms_t, _scalar(tolerance, dt), k_eps


def _counted(is_vf, compensated, f64, records=False):
    modes = ["vf" if is_vf else "ee"] + (["compensated"] if compensated else [])
    count_launch(LAUNCHES_BY_MODE, modes + (["records"] if records else []), f64)


def _raise_on(lib, rc, name):
    if rc != 0:
        msg = lib.sccd_gather_pack_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def _launch(pairs, start, stop, vcat, table, is_vf, ms, tolerance, compensated, out):
    """Kernel C's pairs mode on CUDA tensors."""
    dev = pairs.device
    dt = _tables("gather_pack", dev, vcat, table, is_vf, compensated)
    if pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"gather_pack: pairs int32 (N, 2) expected, got {pairs.dtype} "
                         f"{tuple(pairs.shape)}")
    if not pairs.is_contiguous() or pairs.data_ptr() % 8:
        raise ValueError("gather_pack: pairs must be contiguous and 8-byte aligned")
    start, stop = int(start), int(stop)
    if not 0 <= start <= stop <= pairs.shape[0]:
        raise ValueError(f"gather_pack: rows [{start}, {stop}) outside the {pairs.shape[0]} "
                         "pairs")
    Q = stop - start
    rdt = row_dtype(dt, compensated)
    cols = _check_out(out, Q, rdt, dev, "gather_pack")
    if Q == 0:
        return cols
    kind, ms_t, co_tol, k_eps = _scalars(dt, is_vf, ms, tolerance, compensated)
    lib = load_library("gather_pack")
    fn, _ = _bind(lib)
    with torch.cuda.device(dev):
        rc = fn(pairs.data_ptr(), start, Q, vcat.data_ptr(), vcat.shape[0], table.data_ptr(),
                table.shape[0], int(bool(is_vf)), kind, ms_t, co_tol, k_eps,
                cols.data_ptr(), cols.stride(0), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "gather_pack")
    _counted(is_vf, compensated, rdt == torch.float64)
    return cols


def _launch_records(sb, records, cum, start, stop, vcat, table, is_vf, ms, tolerance,
                    compensated, pairs_out, out):
    """Kernel C's records mode on CUDA tensors."""
    dev = records.device
    dt = _tables("gather_pack_records", dev, vcat, table, is_vf, compensated)
    eid = sb.element_id
    R = records.shape[0]
    if (records.dtype != torch.int32 or records.dim() != 2 or records.shape[1] != REC_WORDS
            or cum.dtype != torch.int64 or tuple(cum.shape) != (R,)
            or eid.dtype != torch.int32 or eid.dim() != 1):
        raise ValueError(
            f"gather_pack_records: records int32 (R, {REC_WORDS}), cum int64 (R,) and "
            f"element_id int32 (n,) expected, got {records.dtype} {tuple(records.shape)}, "
            f"{cum.dtype} {tuple(cum.shape)}, {eid.dtype} {tuple(eid.shape)}")
    if any(t.device != dev for t in (cum, eid)):
        raise ValueError(f"gather_pack_records: every tensor must be on {dev}")
    if not (records.is_contiguous() and cum.is_contiguous() and eid.is_contiguous()) or \
            records.data_ptr() % 16:
        raise ValueError("gather_pack_records: records, cum and element_id must be "
                         "contiguous, records 16-byte aligned")
    start, stop = int(start), int(stop)
    # a record holds at most 128 pairs: pair ids past 128 R cannot exist
    if not 0 <= start <= stop <= _ROW * R:
        raise ValueError(f"gather_pack_records: pairs [{start}, {stop}) outside the {R} "
                         "records")
    if eid.shape[0] >= 2**31:
        raise ValueError("gather_pack_records: the boxes exceed the kernel's index range")
    Q = stop - start
    rdt = row_dtype(dt, compensated)
    cols = _check_out(out, Q, rdt, dev, "gather_pack_records")
    if pairs_out is not None and (
            pairs_out.dtype != torch.int32 or pairs_out.device != dev
            or pairs_out.dim() != 2 or pairs_out.shape[1] != 2 or pairs_out.shape[0] < Q
            or not pairs_out.is_contiguous() or pairs_out.data_ptr() % 8):
        raise ValueError(f"gather_pack_records: pairs_out must be a contiguous int32 "
                         f"(>= {Q}, 2) buffer on {dev}")
    if Q == 0:
        return cols
    kind, ms_t, co_tol, k_eps = _scalars(dt, is_vf, ms, tolerance, compensated)
    lib = load_library("gather_pack")
    _, fn = _bind(lib)
    with torch.cuda.device(dev):
        rc = fn(records.data_ptr(), R, cum.data_ptr(), eid.data_ptr(), eid.shape[0], start,
                Q, vcat.data_ptr(), vcat.shape[0], table.data_ptr(), table.shape[0],
                int(bool(is_vf)), kind, ms_t, co_tol, k_eps, cols.data_ptr(), cols.stride(0),
                pairs_out.data_ptr() if pairs_out is not None else None,
                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "gather_pack_records")
    _counted(is_vf, compensated, rdt == torch.float64, records=True)
    return cols
