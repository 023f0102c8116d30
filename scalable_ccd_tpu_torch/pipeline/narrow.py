"""The narrow layer that :func:`scalable_ccd_tpu_torch.fused_ccd`,
:func:`scalable_ccd_tpu_torch.ccd` and :func:`scalable_ccd_tpu_torch.parallel.
sharded_ccd` stand on: a phase's candidates packed by kernel C
(:mod:`scalable_ccd_tpu_torch.ops.gather_pack`) and solved by kernel B
(:mod:`scalable_ccd_tpu_torch.ops.solver`) from one running TOI.  Each entry
point keeps only how its candidates arrive (a whole phase, a broad chunk, a
stripe) and where its host reads the TOI.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scalable_ccd_tpu_torch.config import normalize_round_limits
from scalable_ccd_tpu_torch.narrow_phase.types import (
    concat_frames,
    pack_edge_table,
    pack_face_table,
)
from scalable_ccd_tpu_torch.ops.gather_pack import (
    chunk_rows,
    gather_pack,
    gather_pack_records,
    row_dtype,
)
from scalable_ccd_tpu_torch.ops.solver import (
    LAUNCH_ROWS,
    ROW_WIDTH,
    solve_cols,
    solve_escalated_cols,
    solve_pairs,
    solve_unfinished_cols,
)
from scalable_ccd_tpu_torch.ops.sweep_records import records_pair_prefix, sample_first_pairs
from scalable_ccd_tpu_torch.utils.profiler import profiler

__all__ = ["IPC_BACKOFF", "IPC_MIN_TOI", "NARROW_BATCH", "NarrowSolver", "PairStream",
           "RecordStream", "append_hits", "key_order", "solve_per_query"]

#: candidate pairs per solver call (``fused_ccd(narrow_batch=)``'s default)
NARROW_BATCH = 1 << 14

#: the IPC rule refines a batch whose TOI falls below this
#: (``ipc_ccd_strategy.cu:73``), and backs off by IPC_BACKOFF
IPC_MIN_TOI = 1e-6
IPC_BACKOFF = 0.8


class NarrowSolver(NamedTuple):
    """What every narrow batch of one phase shares: the endpoint tables and
    the solve options."""

    is_vf: bool
    vcat: torch.Tensor
    table: torch.Tensor
    ms: float
    tolerance: float
    allow_zero_toi: bool
    max_iterations: int
    #: staged escalation of global solves: -1, a limit or a ladder
    round_limit: object = -1
    #: the compensated precision: f32 tables and rows, widened to f64 for
    #: the solve, TOIs narrowed back to f32 (exact)
    compensated: bool = False

    @classmethod
    def for_phase(cls, is_vf, v0, v1, edges, faces, ms, tolerance,
                  allow_zero_toi, max_iterations, round_limit=-1,
                  dtype=torch.float32, compensated=False):
        vcat = concat_frames(v0, v1, dtype)
        table = pack_face_table(vcat, faces) if is_vf else pack_edge_table(vcat, edges)
        return cls(is_vf, vcat, table, float(ms), float(tolerance),
                   bool(allow_zero_toi), int(max_iterations), round_limit,
                   bool(compensated))

    @property
    def row_dtype(self):
        """The dtype of the packed rows the solver takes."""
        return row_dtype(self.vcat.dtype, self.compensated)

    def pack(self, pairs, start=0, stop=None, *, out=None, exact=False):
        """``(31, stop - start)`` packed columns of the element-id pairs
        ``pairs[start:stop]`` (all of them by default), one launch of kernel
        C's pairs mode (:func:`scalable_ccd_tpu_torch.ops.gather_pack.
        gather_pack`), into ``out`` where given; ``exact`` packs them with
        no minimum separation."""
        stop = pairs.shape[0] if stop is None else stop
        return gather_pack(pairs, start, stop, self.vcat, self.table, self.is_vf,
                           0.0 if exact else self.ms, self.tolerance, self.compensated,
                           out=out)

    def pack_records(self, stream, start, stop, *, out=None, pairs_out=None):
        """The same of pairs ``[start, stop)`` of a :class:`RecordStream`,
        straight from its records (kernel C's records mode,
        :func:`scalable_ccd_tpu_torch.ops.gather_pack.gather_pack_records`),
        their ids into ``pairs_out`` where given."""
        return gather_pack_records(stream.sb, stream.records, stream.cum, start, stop,
                                   self.vcat, self.table, self.is_vf, self.ms,
                                   self.tolerance, self.compensated, pairs_out, out=out)

    def _narrowed(self, out):
        """A solve's outputs with its TOIs in the phase's TOI dtype: a
        widened solve returns f64 values that are exact in f32."""
        if not self.compensated:
            return out
        return tuple(o.float() if o.is_floating_point() else o for o in out)

    def solve_rows(self, cols, valid, toi, zero_ok=None, **modes):
        """:func:`solve_cols` of packed columns ``cols`` with the phase's
        options; ``modes`` are its ``per_query``, ``max_iterations``,
        ``round_limit`` and ``skip_if_done``."""
        zero_ok = self.allow_zero_toi if zero_ok is None else zero_ok
        return self._narrowed(solve_cols(
            cols, valid, self.is_vf, toi, self.tolerance, zero_ok,
            widened=self.compensated, **modes))

    def solve_pairs(self, pairs, start, stop, toi, batch: int):
        """A global solve of the element-id pairs ``pairs[start:stop]`` with
        the phase's options (bounded or not, as its ``max_iterations``),
        seeded with ``toi``, skipped once ``toi`` is 0: one kernel B launch
        whose threads compute each row themselves, with no columns
        (:func:`scalable_ccd_tpu_torch.ops.solver.solve_pairs`; its plain
        twin in batches of ``batch`` rows); the outputs of
        :func:`solve_cols`."""
        return self._narrowed(solve_pairs(
            pairs, start, stop, self.vcat, self.table, self.is_vf, toi, self.ms,
            self.tolerance, self.allow_zero_toi, self.max_iterations, self.compensated,
            skip_if_done=True, batch=batch))

    def whole_phase(self, stream) -> bool:
        """Whether a global solve of ``stream`` is :meth:`solve_phase`, one
        unbounded kernel B launch over its pairs: a :class:`PairStream` on
        CUDA, and neither a cap nor escalation.  Elsewhere its chunks are
        packed and solved one by one (:meth:`solve_chunk`)."""
        return (isinstance(stream, PairStream) and stream.pairs.device.type == "cuda"
                and self.max_iterations < 0 and not normalize_round_limits(self.round_limit))

    def solve_phase(self, stream, toi):
        """Solve every candidate of a :class:`PairStream` from the running
        TOI ``toi`` (skipped once it is 0) in one unbounded launch whose
        threads compute the rows from the pairs (:meth:`solve_pairs`): no
        column buffer and no kernel C launch.  The global TOI is a minimum
        over the queries, so solving a phase in one launch rather than one
        per chunk changes only the checks.  Returns ``(toi, overflow,
        checks)``; counts its launches in ``chunk_solves``."""
        prof = profiler()
        prof.count("chunk_solves", -(-stream.n // LAUNCH_ROWS))
        with prof.span("sccd.batches"):
            return self.solve_pairs(stream.pairs, 0, stream.n, toi, stream.batch)

    def solve(self, pairs, toi, exact=False, skip_if_done=False):
        """A global :meth:`solve_batch` of ``(P, 2)`` element-id pairs, packed
        first (:meth:`pack`)."""
        return self.solve_batch(self.pack(pairs, exact=exact), toi, exact=exact,
                                skip_if_done=skip_if_done)

    def solve_batch(self, cols, toi, per_query=False, exact=False, skip_if_done=False):
        """Solve a batch's packed columns ``cols`` (a column slice of its
        chunk is read in place) from the running TOI ``toi``; the outputs
        of :func:`solve_cols`.  ``exact`` is the IPC re-solve: no cap and
        no zero TOI (the columns packed with no minimum separation).  Global
        solves without a cap go through the escalation ladder.
        ``skip_if_done`` (global solves) does nothing once ``toi`` is 0."""
        max_iter, zero_ok = (-1, False) if exact else (self.max_iterations, self.allow_zero_toi)
        valid = torch.ones((cols.shape[1],), dtype=torch.bool, device=cols.device)
        if per_query:
            return self.solve_rows(cols, valid, toi, zero_ok, per_query=True,
                                   max_iterations=max_iter)
        if max_iter >= 0:
            return self.solve_rows(cols, valid, toi, zero_ok, max_iterations=max_iter,
                                   skip_if_done=skip_if_done)
        return self._narrowed(solve_escalated_cols(
            cols, valid, self.is_vf, toi, self.tolerance, zero_ok, self.round_limit,
            self.compensated, skip_if_done))

    def solve_chunk(self, cols, toi, batch: int):
        """Solve a chunk's packed columns ``cols`` from the running TOI
        ``toi`` (once the TOI is 0, every later pass skips); returns ``(toi,
        overflow, checks)``.  A global solve with neither a cap nor
        escalation is one unbounded launch over the whole chunk, seeded with
        ``toi``: the global TOI is a minimum over the queries, so how the
        rows are split into launches changes only the checks.  With
        escalation (global solves, no cap) the first, round-limited pass
        runs once over the whole chunk, seeded with ``toi``, and each batch
        of ``batch`` columns then solves its rows left unfinished
        (:func:`scalable_ccd_tpu_torch.ops.solver.solve_unfinished_cols`:
        the batch's segment of the chunk's ``unfin`` plane, pooled or solved
        at once, and the ladder's later stages), pruned by the running TOI;
        the TOI, totals and flags are those of a first pass per batch, since
        a pass may prune against any TOI a query accepted.  With a cap every
        batch is one :meth:`solve_batch` (where the cap binds, the result
        depends on the launches' order)."""
        limits = normalize_round_limits(self.round_limit)
        escalate = self.max_iterations < 0 and bool(limits)
        dev, q = cols.device, cols.shape[1]
        prof = profiler()
        if self.max_iterations < 0 and not limits:
            prof.count("chunk_solves")
            with prof.span("sccd.batches"):
                valid = torch.ones((q,), dtype=torch.bool, device=dev)
                toi_c, ovf, checks = self.solve_rows(cols, valid, toi, skip_if_done=True)
                return torch.minimum(toi, toi_c), ovf, checks
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        checks = torch.zeros((), dtype=torch.int64, device=dev)
        if escalate:
            with prof.span("sccd.first_pass"):
                valid = torch.ones((q,), dtype=torch.bool, device=dev)
                toi1, ovf, checks, unfin = self.solve_rows(cols, valid, toi,
                                                           round_limit=limits[0],
                                                           skip_if_done=True)
                toi = torch.minimum(toi, toi1)
        prof.count("batches", -(-q // batch))
        with prof.span("sccd.batches"):
            for s in range(0, q, batch):
                if escalate:
                    toi_b, ovf_b, ck_b = self._narrowed(solve_unfinished_cols(
                        cols[:, s:s + batch], unfin[s:s + batch], self.is_vf, toi,
                        self.tolerance, self.allow_zero_toi, limits[1:], self.compensated,
                        skip_if_done=True))
                else:
                    toi_b, ovf_b, ck_b = self.solve_batch(cols[:, s:s + batch], toi,
                                                          skip_if_done=True)
                toi = torch.minimum(toi, toi_b)
                ovf, checks = ovf | ovf_b, checks + ck_b
        return toi, ovf, checks


def key_order(pairs: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts ``(P, 2)`` non-negative id pairs by
    ``(a << 32) | b``."""
    p = pairs.to(torch.int64)
    return torch.argsort(p[:, 0] * (1 << 32) + p[:, 1])


def append_hits(collisions: list, pairs, tois) -> None:
    """Append ``(id_a, id_b, toi)`` per row, in key order."""
    order = key_order(pairs)
    p = pairs[order].cpu().numpy()
    t = tois[order].cpu().numpy()
    collisions.extend((int(a), int(b), float(ti)) for (a, b), ti in zip(p, t))


class _Stream:
    """A phase's ``n`` candidates, taken in narrow batches of ``batch`` and
    packed for kernel B chunk by chunk: a chunk is the most whole batches
    that fit in 2^20 rows (:func:`scalable_ccd_tpu_torch.ops.gather_pack.
    chunk_rows`), packed with one kernel C launch when a batch of it is
    first asked for, into the stream's one column buffer (the chunk's width,
    or ``n`` columns where fewer), and a batch is a column slice of it,
    which kernel B reads in place.  Batches may come in any order; a slice
    is valid until the next chunk is packed, which the device orders after
    every launch already queued on it."""

    def __init__(self, n: int, nar: "NarrowSolver | None", batch: int, with_ids: bool):
        self.n, self.nar, self.batch = n, nar, int(batch)
        self.chunk = chunk_rows(batch)
        self.with_ids = with_ids
        self._c0 = None
        self._cols = self._ids = None

    def _chunk_of(self, start: int, stop: int) -> int:
        """The first row of the chunk holding candidates ``[start, stop)``,
        packed now unless it is the chunk in the buffer."""
        c0 = start - start % self.chunk
        if not 0 <= start < stop <= min(c0 + self.chunk, self.n):
            raise ValueError(f"candidates [{start}, {stop}) are not a run of one chunk of "
                             f"{self.chunk} rows of the {self.n}")
        if c0 != self._c0:
            with profiler().span("sccd.pack"):
                if self._cols is None:
                    width, dev = min(self.chunk, self.n), self.nar.vcat.device
                    self._cols = torch.empty((ROW_WIDTH, width), dtype=self.nar.row_dtype,
                                             device=dev)
                    if self.with_ids:
                        self._ids = torch.empty((width, 2), dtype=torch.int32, device=dev)
                self._pack(c0, min(c0 + self.chunk, self.n))
            self._c0 = c0
        return c0

    def cols(self, start: int, stop: int) -> torch.Tensor:
        """``(31, stop - start)`` packed columns of candidates ``[start,
        stop)``, a run inside one chunk: a column view of its chunk."""
        c0 = self._chunk_of(start, stop)
        return self._cols[:, start - c0:stop - c0]


class PairStream(_Stream):
    """A phase's candidates as pair rows (kernel A's buffer)."""

    def __init__(self, pairs: torch.Tensor, n: int, nar=None, batch: int = NARROW_BATCH):
        super().__init__(n, nar, batch, with_ids=False)
        self.pairs = pairs

    def _pack(self, c0, c1):
        self.nar.pack(self.pairs, c0, c1, out=self._cols)

    def ids(self, start: int, stop: int) -> torch.Tensor:
        """The ``(stop - start, 2)`` element-id pairs of candidates ``[start,
        stop)``."""
        return self.pairs[start:stop]

    def sample(self, batch: int) -> torch.Tensor:
        """Rows ``floor(i * n / batch)``, ``i < min(batch, n)``: one batch
        spread over the whole buffer (JAX ``fused.py:845-852``)."""
        lane = torch.arange(min(batch, self.n), dtype=torch.int64, device=self.pairs.device)
        return self.pairs[lane * (self.n // batch) + (lane * (self.n % batch)) // batch]

    def all(self) -> torch.Tensor:
        return self.pairs[:self.n]


class RecordStream(_Stream):
    """A phase's candidates as kernel A' records, packed straight from the
    records (kernel C's records mode), which also writes the pairs' ids
    where ``with_ids`` asks for them (the hits of ``collisions=``)."""

    def __init__(self, sorted_boxes, records, n_records: int, pair_budget: int, is_vf: bool,
                 nar, batch: int, with_ids: bool = False):
        self.sb, self.records, self.n_records = sorted_boxes, records, n_records
        self.is_vf = is_vf
        self.cum = records_pair_prefix(records, n_records)
        # the pairs of the records the buffer holds, at most the budget
        super().__init__(min(int(self.cum[-1]), pair_budget) if records.shape[0] else 0,
                         nar, batch, with_ids)

    def _pack(self, c0, c1):
        self.nar.pack_records(self, c0, c1, out=self._cols, pairs_out=self._ids)

    def ids(self, start: int, stop: int) -> torch.Tensor:
        """The ``(stop - start, 2)`` element-id pairs of candidates ``[start,
        stop)``, written beside their chunk's rows (``with_ids``)."""
        if not self.with_ids:
            raise ValueError("RecordStream: ids need with_ids=True")
        c0 = self._chunk_of(start, stop)
        return self._ids[start - c0:stop - c0]

    def sample(self, batch: int) -> torch.Tensor:
        return sample_first_pairs(self.sb, self.records, self.n_records, batch, self.is_vf)

    def all(self) -> torch.Tensor:
        """Every candidate's element-id pair, written by kernel C's records
        mode chunk by chunk (the rows it packs beside them are dropped)."""
        ids = torch.empty((self.n, 2), dtype=torch.int32, device=self.records.device)
        for c0 in range(0, self.n, self.chunk):
            c1 = min(c0 + self.chunk, self.n)
            self.nar.pack_records(self, c0, c1, pairs_out=ids[c0:c1])
        return ids


def solve_per_query(nar: NarrowSolver, batches, toi, exact: bool = False):
    """Solve ``batches``, each a narrow batch's packed columns and ``(P, 2)``
    element-id pairs (``None``: keep no hits, which would read the device),
    in per-query mode from the running TOI ``toi`` (0-d); ``exact`` is the IPC
    re-solve.  Returns ``(toi, capped, checks, hit_ids, hit_tois)``, the hits
    the pairs whose TOI is below 1, in the batches' order."""
    dev = toi.device
    checks = torch.zeros((), dtype=torch.int64, device=dev)
    capped = torch.zeros((), dtype=torch.bool, device=dev)
    hit_ids = [torch.zeros((0, 2), dtype=torch.int32, device=dev)]
    hit_tois = [torch.zeros((0,), dtype=toi.dtype, device=dev)]
    for cols, ids in batches:
        toi_b, cap, ck, pq = nar.solve_batch(cols, toi, per_query=True, exact=exact)
        toi = torch.minimum(toi, toi_b)
        checks, capped = checks + ck, capped | cap
        if ids is not None:
            hit = pq < 1
            hit_ids.append(ids[hit])
            hit_tois.append(pq[hit])
    return toi, capped, checks, torch.cat(hit_ids), torch.cat(hit_tois)
