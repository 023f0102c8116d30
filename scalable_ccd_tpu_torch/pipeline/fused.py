"""The fused CCD pipeline on PyTorch.

Counterpart of ``scalable_ccd_tpu/pipeline/fused.py:fused_ccd``.  In order:

1. validate the mesh, and rotate it into its principal axes if ``pca``;
2. build conservative boxes, inflated by ``min_distance``, and sort them
   (VF: vertices merged with faces, two-list; EE: edges, one-list); from
   2^20 VF boxes on, in the congestion ordering (``bucket_minor``);
3. sweep each phase into a candidate buffer of the phase's budget: pair rows
   with :func:`scalable_ccd_tpu_torch.ops.sweep_ap.sweep_pairs` (kernel A,
   ``sweep_impl="pairs"``) or bit records with
   :func:`scalable_ccd_tpu_torch.ops.sweep_records.sweep_records` (kernel
   A', ``sweep_impl="records"``), each with ``any_order`` under the
   congestion ordering;
4. take the candidates in narrow batches of 16,384 pairs (records decode
   each batch's range), gather and pack them with tolerances, error filters
   and the minimum separation, and solve them with kernel B
   (:mod:`scalable_ccd_tpu_torch.ops.solver`).  VF runs before EE and one
   running TOI is threaded through both; below 2^20 boxes a phase starts
   with one warm-start batch spread over its candidates (presample), and it
   stops early once the TOI reaches 0;
5. staged escalation (``escalate_rounds``, 128 rounds on the global path):
   below 2^20 VF boxes the frame straggler pool (every batch runs one
   bounded pass and appends its unfinished rows to a phase-wide pool,
   solved densely at the end of the phase), above it the per-batch ladder
   (:func:`scalable_ccd_tpu_torch.ops.solver.solve_escalated`).  Both give
   the unbounded TOI bitwise unless a conservative accept fires;
6. size the pair budgets automatically: a scene-proportional power-of-two
   guess, one retry from the exact totals, and a sticky memo of grown
   budgets per scene-size class.

The defaults resolve as the JAX package's do at its congestion threshold
(``fused.py:96,132-170,1880-1926``), with one exception: the port emits
pairs unless records are asked for (kernel A is the measured path).

Exact modes (the JAX package's ``_phase``, ``fused.py:632-645``):

- ``collisions``: every batch is solved in per-query mode, with no
  presample, no escalation and no early exit, and each pair with a TOI
  below 1 is reported (VF as (vertex, face), EE as (edge, edge));
- ``max_iterations``: the solver's per-query check cap (bounded mode; no
  escalation);
- ``ipc_refine``: the IPC stepping rule per narrow batch.  A batch that
  drops the TOI below 1e-6 is solved again from the TOI before it, with no
  minimum separation, no cap and no zero TOI, and the TOI becomes
  ``min(before, re-solve) * 0.8``.  The refinement depends on which pairs
  share a batch, and the CUDA sweeps append in an order that changes from
  run to run; so under ``ipc_refine`` each phase's candidates are decoded
  whole and sorted by ``(id_a << 32) | id_b`` before batching, on every
  device.

The JAX package runs this as one XLA program; here it is eager PyTorch, and
the host reads a few scalars on the way (each phase's candidate totals, the
TOI after every narrow batch for the early exit, and the unfinished count
of every escalated solve).  The compensated precision is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.config import normalize_round_limits
from scalable_ccd_tpu_torch.geometry.aabb import (
    build_edge_boxes,
    build_face_boxes,
    build_vertex_boxes,
)
from scalable_ccd_tpu_torch.geometry.mesh import validate_mesh_inputs
from scalable_ccd_tpu_torch.narrow_phase.types import (
    concat_frames,
    gather_ee_queries,
    gather_vf_queries,
    pack_edge_table,
    pack_face_table,
)
from scalable_ccd_tpu_torch.ops.solver import (
    POOL_BLOCK,
    ROW_WIDTH,
    pack_query_rows,
    solve_escalated,
    solve_packed,
)
from scalable_ccd_tpu_torch.ops.sweep_ap import partner_planes, sweep_pairs
from scalable_ccd_tpu_torch.ops.sweep_records import (
    decode_records_range,
    records_pair_prefix,
    sample_first_pairs,
    sweep_records,
)
from scalable_ccd_tpu_torch.utils.pca import apply_pca

__all__ = [
    "FusedCCDResult",
    "Knobs",
    "NarrowSolver",
    "fused_ccd",
    "resolve_auto_escalation",
    "resolve_device",
    "resolve_knobs",
]

#: the congestion threshold (VF boxes; per phase for presample): the
#: congestion ordering and the batch ladder switch on, presample and the
#: frame pool off (the JAX package's ``_AUTO_BUCKET_MIN_BOXES``)
CONGESTION_MIN_BOXES = 1 << 20

#: staged-escalation rounds of the auto policy (``_AUTO_ESCALATE_ROUNDS``)
AUTO_ESCALATE_ROUNDS = 128

#: candidate pairs per solver call
_NARROW_BATCH = 1 << 14

#: smallest budget the auto mode picks (16k pair rows)
_AUTO_BUDGET_MIN = 1 << 14

#: auto-budget guesses, as multiples of the phase's box/edge count
_AUTO_VF_GUESS = 2
_AUTO_EE_GUESS = 4

#: sticky auto-budget resizes, keyed by the initial (vf, ee) guesses and
#: the sweep: once a frame overflows a guess, later frames of the same size
#: class start at the grown budget
_AUTO_BUDGET_MEMO: dict = {}

#: the IPC rule refines a batch whose TOI falls below this
#: (``ipc_ccd_strategy.cu:73``), and backs off by IPC_BACKOFF
IPC_MIN_TOI = 1e-6
IPC_BACKOFF = 0.8

#: frame straggler pool rows: budget / 64, within these bounds, rounded up
#: to whole pool blocks (``fused.py:1267-1268``)
_FRAME_POOL_MIN = 1 << 14
_FRAME_POOL_MAX = 1 << 21


class FusedCCDResult(NamedTuple):
    """0-d tensors on the run's device."""

    #: earliest TOI in [0, 1]; 1.0 = no contact (valid only if not overflowed)
    toi: torch.Tensor
    #: bool — a pair budget was exceeded, candidate pairs may be missing
    overflowed: torch.Tensor
    #: int64 — exact surviving VF candidate pairs (even past the budget)
    vf_total: torch.Tensor
    #: int64 — exact surviving EE candidate pairs (even past the budget)
    ee_total: torch.Tensor
    #: int64 — narrow-phase domain evaluations
    total_checks: torch.Tensor
    #: bool — the solver took a conservative accept somewhere (stack depth
    #: or split cap); the TOI is still valid, possibly earlier than the
    #: true first contact
    solver_capped: torch.Tensor
    #: int64 — narrow batches the IPC rule refined (0 without ipc_refine)
    ipc_refinements: torch.Tensor


class Knobs(NamedTuple):
    """The resolved policy of one ``fused_ccd`` call."""

    bucket_minor: bool
    #: -1 (one unbounded pass), a limit >= 0, or a ladder of limits
    escalate_rounds: object
    #: "batch" (per-batch ladder) or "frame" (frame straggler pool)
    escalate_pool: str
    presample_vf: bool
    presample_ee: bool
    sweep_impl: str


def resolve_auto_escalation(escalate_rounds, max_iterations: int):
    """``escalate_rounds`` with auto (``None`` or the config sentinel -2)
    resolved: :data:`AUTO_ESCALATE_ROUNDS` on the global path, off with a
    check cap (``_resolve_auto_escalation``, JAX ``fused.py:135-147``; the
    port's solver is always the kernel)."""
    if escalate_rounds is not None and escalate_rounds != -2:
        return escalate_rounds
    return AUTO_ESCALATE_ROUNDS if max_iterations < 0 else -1


def resolve_knobs(n_vf: int, n_ee: int, *, bucket_minor="auto", escalate_rounds=None,
                  escalate_pool="auto", sweep_impl: str = "pairs",
                  max_iterations: int = -1, collisions: bool = False,
                  ipc_refine: bool = False) -> Knobs:
    """The auto policies as functions of the phases' box counts ``n_vf``
    (vertices + faces) and ``n_ee`` (edges), as JAX ``fused_ccd`` resolves
    them (``fused.py:1880-1947``): congestion ordering from
    :data:`CONGESTION_MIN_BOXES` VF boxes; escalation at 128 rounds on the
    global path; the frame pool below the threshold where its preconditions
    hold (global mode, one limit), the batch ladder otherwise; presample per
    phase below the threshold.  An explicit ``escalate_pool="frame"`` where
    the frame pool cannot run raises (the JAX package warns and takes the
    batch ladder)."""
    if sweep_impl not in ("pairs", "records"):
        raise ValueError(f"unknown sweep_impl {sweep_impl!r}: 'pairs' or 'records'")
    if escalate_pool not in ("auto", None, "batch", "frame"):
        raise ValueError(
            f"unknown escalate_pool {escalate_pool!r}: 'batch' (per-batch "
            "ladder) or 'frame' (frame straggler pool)"
        )
    congested = n_vf >= CONGESTION_MIN_BOXES
    if bucket_minor == "auto":
        bucket_minor = congested
    er = resolve_auto_escalation(escalate_rounds, max_iterations)
    normalize_round_limits(er)  # a bad ladder raises here
    frame_ok = (not collisions and not ipc_refine and max_iterations < 0
                and isinstance(er, int) and er >= 0)
    if escalate_pool in ("auto", None):
        escalate_pool = "frame" if frame_ok and not congested else "batch"
    elif escalate_pool == "frame" and not frame_ok:
        raise ValueError(
            "escalate_pool='frame' needs the global path and one round limit: "
            f"got escalate_rounds={er!r}, max_iterations={max_iterations}, "
            f"collisions={collisions}, ipc_refine={ipc_refine}"
        )
    return Knobs(bool(bucket_minor), er, escalate_pool, n_vf < CONGESTION_MIN_BOXES,
                 n_ee < CONGESTION_MIN_BOXES, sweep_impl)


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def _as_tensor(x, dtype, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def resolve_device(device=None) -> torch.device:
    """``device``, or CUDA when it is ``None``, whatever the inputs are; a
    CUDA device on a machine without CUDA raises (the plain versions run
    only where the caller asks for the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def mesh_tensors(vertices_t0, vertices_t1, edges, faces, device, pca: bool):
    """The mesh on ``device``: vertices in their input precision (f32 or
    f64), indices int32; rotated into principal axes if ``pca``."""
    v0 = vertices_t0 if torch.is_tensor(vertices_t0) else np.asarray(vertices_t0)
    vdt = torch.float64 if v0.dtype in (np.float64, torch.float64) else torch.float32
    v0 = _as_tensor(vertices_t0, vdt, device)
    v1 = _as_tensor(vertices_t1, vdt, device)
    if pca:
        v0, v1, _ = apply_pca(v0, v1)
    return v0, v1, _as_tensor(edges, torch.int32, device), _as_tensor(faces, torch.int32, device)


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

    @classmethod
    def for_phase(cls, is_vf, v0, v1, edges, faces, ms, tolerance,
                  allow_zero_toi, max_iterations, round_limit=-1):
        vcat = concat_frames(v0, v1, torch.float32)
        table = pack_face_table(vcat, faces) if is_vf else pack_edge_table(vcat, edges)
        return cls(is_vf, vcat, table, float(ms), float(tolerance),
                   bool(allow_zero_toi), int(max_iterations), round_limit)

    def rows(self, pairs, exact=False):
        """``(P, 31)`` packed rows of ``(P, 2)`` element-id pairs; ``exact``
        packs them with no minimum separation."""
        if self.is_vf:
            q = gather_vf_queries(self.vcat, self.table, pairs)
        else:
            q = gather_ee_queries(self.table, pairs)
        return pack_query_rows(q, self.is_vf, 0.0 if exact else self.ms, self.tolerance)

    def solve(self, pairs, toi, per_query=False, exact=False):
        """Solve ``(P, 2)`` element-id pairs from the running TOI ``toi``;
        the outputs of :func:`solve_packed`.  ``exact`` is the IPC
        re-solve: no minimum separation, no cap and no zero TOI.  Global
        solves without a cap go through the escalation ladder."""
        rows = self.rows(pairs, exact)
        max_iter, zero_ok = (-1, False) if exact else (self.max_iterations, self.allow_zero_toi)
        valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=rows.device)
        if per_query or max_iter >= 0:
            return solve_packed(rows, valid, self.is_vf, toi, self.tolerance,
                                zero_ok, per_query, max_iter)
        return solve_escalated(rows, valid, self.is_vf, toi, self.tolerance,
                               zero_ok, self.round_limit)

    def solve_bounded(self, pairs, toi):
        """One round-limited global pass of ``pairs`` (no ladder); returns
        ``(toi, overflow, checks, unfin, rows)``, ``rows`` the packed rows
        for the frame pool (``pallas_find_roots_bounded``)."""
        rows = self.rows(pairs)
        valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=rows.device)
        out = solve_packed(rows, valid, self.is_vf, toi, self.tolerance,
                           self.allow_zero_toi, round_limit=int(self.round_limit))
        return out + (rows,)


def _key_order(pairs: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts ``(P, 2)`` non-negative id pairs by
    ``(a << 32) | b``."""
    p = pairs.to(torch.int64)
    return torch.argsort(p[:, 0] * (1 << 32) + p[:, 1])


def append_hits(collisions: list, pairs, tois) -> None:
    """Append ``(id_a, id_b, toi)`` per row, in key order."""
    order = _key_order(pairs)
    p = pairs[order].cpu().numpy()
    t = tois[order].cpu().numpy()
    collisions.extend((int(a), int(b), float(ti)) for (a, b), ti in zip(p, t))


class PairStream:
    """A phase's candidates as decoded pair rows (kernel A's buffer)."""

    def __init__(self, pairs: torch.Tensor, n: int):
        self.pairs, self.n = pairs, n

    def batch(self, start: int, stop: int) -> torch.Tensor:
        return self.pairs[start:stop]

    def sample(self, batch: int) -> torch.Tensor:
        """Rows ``floor(i * n / batch)``, ``i < min(batch, n)``: one batch
        spread over the whole buffer (``fused.py:845-852``)."""
        lane = torch.arange(min(batch, self.n), dtype=torch.int64, device=self.pairs.device)
        return self.pairs[lane * (self.n // batch) + (lane * (self.n % batch)) // batch]

    def all(self) -> torch.Tensor:
        return self.pairs[:self.n]


class RecordStream:
    """A phase's candidates as kernel A' records, decoded batch by batch
    with the monotone record cursor (batches are taken in order)."""

    def __init__(self, sorted_boxes, records, n_records: int, pair_budget: int, is_vf: bool):
        self.sb, self.records, self.n_records = sorted_boxes, records, n_records
        self.is_vf = is_vf
        self.cum = records_pair_prefix(records, n_records)
        # the pairs of the records the buffer holds, at most the budget
        self.n = min(int(self.cum[-1]), pair_budget) if records.shape[0] else 0
        self.cursor = 0

    def batch(self, start: int, stop: int) -> torch.Tensor:
        chunk, self.cursor = decode_records_range(
            self.sb, self.records, self.cum, start, stop, self.cursor, self.is_vf)
        return chunk

    def sample(self, batch: int) -> torch.Tensor:
        return sample_first_pairs(self.sb, self.records, self.n_records, batch, self.is_vf)

    def all(self) -> torch.Tensor:
        return decode_records_range(self.sb, self.records, self.cum, 0, self.n, 0,
                                    self.is_vf)[0]


def _sweep_phase(sorted_boxes, is_vf, budget, auto, knobs: Knobs):
    """Sweep one phase; on an auto-budget overflow, sweep once more from
    the exact totals.  Returns ``(stream, n_true, overflow, budget, grew)``."""
    sb = sorted_boxes
    planes = partner_planes(sb) if knobs.bucket_minor else None
    if knobs.sweep_impl == "pairs":
        def sweep(b, _rec_budget=0):
            return sweep_pairs(sb, is_vf, b, any_order=knobs.bucket_minor, planes=planes)
    else:
        def sweep(b, rec_budget=0):
            return sweep_records(sb, is_vf, b, rec_budget, any_order=knobs.bucket_minor,
                                 planes=planes)
    buf, n_first, n_true, overflow = sweep(budget)
    # pairs: (n_pairs, n_true); records: (n_records, n_pairs)
    first, total = torch.stack([n_first, n_true]).tolist()
    grew = auto and bool(overflow)
    if grew:
        budget = _pow2ceil(total)
        buf, n_first, n_true, overflow = sweep(budget, _pow2ceil(first))
    if knobs.sweep_impl == "pairs":
        stream = PairStream(buf, min(total, budget))
    else:
        stream = RecordStream(sb, buf, min(first, buf.shape[0]), budget, is_vf)
    return stream, n_true, overflow, budget, grew


def _frame_pool_loop(stream, budget, batch, nar: NarrowSolver, toi, checks, capped):
    """Escalation through the frame straggler pool (JAX ``fused.py:1257-1376``):
    every batch runs one bounded pass; a batch's unfinished rows join the
    pool, unless there are more than one pool block of them or the pool is
    full, and then they are solved at once, unbounded; the pool is solved
    densely after the loop, one block per call.  Returns (toi, checks,
    capped)."""
    dev = toi.device
    cap = -(-min(_FRAME_POOL_MAX, max(_FRAME_POOL_MIN, budget >> 6)) // POOL_BLOCK) * POOL_BLOCK
    pool = torch.empty((cap + POOL_BLOCK, ROW_WIDTH), dtype=torch.float32, device=dev)
    cur = 0
    start = 0
    toi_h = float(toi)
    while start < stream.n and toi_h > 0:
        chunk = stream.batch(start, min(start + batch, stream.n))
        toi_b, ovf, ck, unfin, rows = nar.solve_bounded(chunk, toi)
        toi = torch.minimum(toi, toi_b)
        checks, capped = checks + ck, capped | ovf
        cnt, toi_h = torch.stack([unfin.sum().to(torch.float64), toi.double()]).tolist()
        cnt = int(cnt)
        if 0 < cnt <= POOL_BLOCK and cur <= cap:
            pool[cur:cur + cnt] = rows[unfin]
            cur += cnt
        elif cnt > 0:
            toi2, ovf2, ck2 = solve_packed(rows, unfin, nar.is_vf, toi, nar.tolerance,
                                           nar.allow_zero_toi)
            toi = torch.minimum(toi, toi2)
            checks, capped = checks + ck2, capped | ovf2
            toi_h = float(toi)
        start += batch
    for s in range(0, cur, POOL_BLOCK):
        if float(toi) <= 0:
            break
        rows = pool[s:min(s + POOL_BLOCK, cur)]
        valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=dev)
        toi2, ovf2, ck2 = solve_packed(rows, valid, nar.is_vf, toi, nar.tolerance,
                                       nar.allow_zero_toi)
        toi = torch.minimum(toi, toi2)
        checks, capped = checks + ck2, capped | ovf2
    return toi, checks, capped


def _narrow_phase(stream, budget, batch, presample, nar: NarrowSolver, toi,
                  collisions, ipc_refine, frame_pool):
    """Solve one phase's candidates in batches; returns (toi, checks,
    capped, refinements)."""
    dev = toi.device
    checks = torch.zeros((), dtype=torch.int64, device=dev)
    capped = torch.zeros((), dtype=torch.bool, device=dev)
    refinements = 0
    n_pairs = stream.n
    if collisions is not None:
        hit_pairs, hit_tois = [], []
        for start in range(0, n_pairs, batch):
            chunk = stream.batch(start, min(start + batch, n_pairs))
            toi_b, cap, ck, pq = nar.solve(chunk, toi, per_query=True)
            toi = torch.minimum(toi, toi_b)
            checks, capped = checks + ck, capped | cap
            hit = pq < 1
            hit_pairs.append(chunk[hit])
            hit_tois.append(pq[hit])
        if hit_pairs:
            append_hits(collisions, torch.cat(hit_pairs), torch.cat(hit_tois))
        return toi, checks, capped, refinements

    if presample and not ipc_refine and budget >= 4 * batch and n_pairs > 0:
        # TOI warm start: one batch spread uniformly over the candidates,
        # so the loop starts from a near-final TOI (fused.py:838-852)
        toi_s, cap, ck = nar.solve(stream.sample(batch), toi)
        toi = torch.minimum(toi, toi_s)
        checks, capped = checks + ck, capped | cap
    if frame_pool:
        toi, checks, capped = _frame_pool_loop(stream, budget, batch, nar, toi,
                                               checks, capped)
        return toi, checks, capped, refinements
    if ipc_refine:
        pairs = stream.all()
        stream = PairStream(pairs[_key_order(pairs)], n_pairs)
    start = 0
    # the host reads the TOI once per batch for the early exit, the
    # reference chunk loop's `remaining_queries && toi > 0`
    while start < n_pairs and float(toi) > 0:
        chunk = stream.batch(start, min(start + batch, n_pairs))
        toi_b, cap, ck = nar.solve(chunk, toi)
        toi_after = torch.minimum(toi, toi_b)
        # compared in f32, as the JAX package's in-dispatch rule does
        if ipc_refine and bool(toi_after < IPC_MIN_TOI):
            toi_r, cap_r, ck_r = nar.solve(chunk, toi, exact=True)
            toi_after = torch.minimum(toi, toi_r) * IPC_BACKOFF
            cap, ck = cap | cap_r, ck + ck_r
            refinements += 1
        toi = toi_after
        checks, capped = checks + ck, capped | cap
        start += batch
    return toi, checks, capped, refinements


def fused_ccd(
    vertices_t0,
    vertices_t1,
    edges,
    faces,
    *,
    device=None,
    validate: bool = True,
    min_distance: float = 0.0,
    tolerance: float = 1e-6,
    max_iterations: int = -1,
    allow_zero_toi: bool = True,
    collisions: list | None = None,
    ipc_refine: bool = False,
    pca: bool = False,
    vf_budget="auto",
    ee_budget="auto",
    bucket_minor="auto",
    escalate_rounds=None,
    escalate_pool="auto",
    sweep_impl: str = "pairs",
) -> FusedCCDResult:
    """Earliest time of impact of a linearly moving triangle mesh.

    Inputs are numpy arrays or tensors: ``(n, 3)`` vertices at t=0 and t=1
    (float64 or float32), ``(m, 2)`` edges and ``(k, 3)`` faces.  Everything
    runs on ``device``, CUDA unless the caller asks for another device, the
    sweeps and the solver as CUDA kernels there; ``device="cpu"`` runs
    their plain PyTorch versions.  A CUDA device on a machine without CUDA
    raises; nothing falls back to the CPU.

    ``min_distance`` is the minimum separation (boxes inflate by it and
    the solver keeps it); ``max_iterations >= 0`` caps each query's domain
    checks, dropping what lies past the cap (not conservative, as in the
    reference).  A ``collisions`` list receives every pair's
    ``(id_a, id_b, toi)`` with ``toi < 1``, VF hits first, each phase in
    id order.  ``ipc_refine`` applies the IPC stepping rule per narrow
    batch (module docstring); it has no per-pair output, so it raises with
    ``collisions``.  ``pca`` rotates the mesh into its principal axes
    first (the TOI is unchanged; candidate counts change).

    ``bucket_minor`` (``"auto"``: from 2^20 VF boxes on) sorts in the
    congestion ordering and sweeps with ``any_order``; the pair set is the
    same.  ``escalate_rounds`` (``None``: 128 rounds on the global path, -1
    off; an int or an ascending ladder) and ``escalate_pool`` (``"auto"``:
    ``"frame"`` below 2^20 VF boxes on the global path, ``"batch"``
    otherwise) are the staged escalation; the TOI is the unbounded one
    bitwise unless a conservative accept fires.  ``sweep_impl`` is
    ``"pairs"`` (kernel A) or ``"records"`` (kernel A').  See
    :func:`resolve_knobs`.

    ``vf_budget``/``ee_budget`` bound the candidate pairs per phase;
    ``"auto"`` guesses from the scene size and retries a phase once from
    its exact totals on overflow, so ``overflowed`` stays False.  With
    integer budgets an overflow is reported in ``overflowed`` and the pairs
    past the budget are missing.  Boxes are built and solved in f32.
    """
    if collisions is not None and ipc_refine:
        raise ValueError(
            "ipc_refine has no per-pair output (the reference discards "
            "collisions in ipc_ccd_strategy, ipc_ccd_strategy.cu:52-54)"
        )
    device = resolve_device(device)
    if validate:
        validate_mesh_inputs(vertices_t0, vertices_t1, edges, faces)
    v0, v1, e, f = mesh_tensors(vertices_t0, vertices_t1, edges, faces, device, pca)

    n_vf, n_ee = v0.shape[0] + f.shape[0], e.shape[0]
    knobs = resolve_knobs(
        n_vf, n_ee, bucket_minor=bucket_minor, escalate_rounds=escalate_rounds,
        escalate_pool=escalate_pool, sweep_impl=sweep_impl,
        max_iterations=max_iterations, collisions=collisions is not None,
        ipc_refine=ipc_refine,
    )
    vf_auto, ee_auto = vf_budget == "auto", ee_budget == "auto"
    memo_key = None
    if vf_auto:
        vf_budget = max(_pow2ceil(_AUTO_VF_GUESS * n_vf), _AUTO_BUDGET_MIN)
    if ee_auto:
        ee_budget = max(_pow2ceil(_AUTO_EE_GUESS * n_ee), _AUTO_BUDGET_MIN)
    if vf_auto or ee_auto:
        memo_key = (vf_budget, ee_budget, knobs.sweep_impl)
        memo = _AUTO_BUDGET_MEMO.get(memo_key, (0, 0))
        vf_budget = max(vf_budget, memo[0]) if vf_auto else vf_budget
        ee_budget = max(ee_budget, memo[1]) if ee_auto else ee_budget

    vb = build_vertex_boxes(v0, v1, inflation_radius=min_distance, dtype=torch.float32)
    vf_sorted = sort_boxes(merge_two_lists(vb, build_face_boxes(vb, f)), axis=0,
                           bucket_minor=knobs.bucket_minor)
    ee_sorted = sort_boxes(build_edge_boxes(vb, e), axis=0, bucket_minor=knobs.bucket_minor)

    toi = torch.ones((), dtype=torch.float32, device=device)
    grown = [0, 0]
    out = []
    frame_pool = knobs.escalate_pool == "frame"
    for k, (sb, is_vf, budget, auto, ps) in enumerate((
        (vf_sorted, True, int(vf_budget), vf_auto, knobs.presample_vf),
        (ee_sorted, False, int(ee_budget), ee_auto, knobs.presample_ee),
    )):
        stream, n_true, overflow, budget, grew = _sweep_phase(sb, is_vf, budget, auto, knobs)
        grown[k] = budget if grew else 0
        nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, min_distance, tolerance,
                                     allow_zero_toi, max_iterations, knobs.escalate_rounds)
        toi, checks, capped, refined = _narrow_phase(
            stream, budget, min(_NARROW_BATCH, budget), ps, nar, toi,
            collisions, ipc_refine, frame_pool,
        )
        out.append((n_true, overflow, checks, capped, refined))
    if memo_key is not None and any(grown):
        old = _AUTO_BUDGET_MEMO.get(memo_key, (0, 0))
        _AUTO_BUDGET_MEMO[memo_key] = (max(old[0], grown[0]), max(old[1], grown[1]))
    (vf_total, vf_over, vf_ck, vf_cap, vf_ref), (ee_total, ee_over, ee_ck, ee_cap, ee_ref) = out
    return FusedCCDResult(
        toi=toi, overflowed=vf_over | ee_over, vf_total=vf_total,
        ee_total=ee_total, total_checks=vf_ck + ee_ck,
        solver_capped=vf_cap | ee_cap,
        ipc_refinements=torch.tensor(vf_ref + ee_ref, dtype=torch.int64, device=device),
    )
