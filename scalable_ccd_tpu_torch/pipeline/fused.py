"""The fused CCD pipeline on PyTorch.

Counterpart of ``scalable_ccd_tpu/pipeline/fused.py:fused_ccd``.  In order:

1. validate the mesh, and rotate it into its principal axes if ``pca``;
2. build conservative boxes, inflated by ``min_distance``, and sort them
   (VF: vertices merged with faces, two-list; EE: edges, one-list);
3. sweep each phase with :func:`scalable_ccd_tpu_torch.ops.sweep_ap.sweep_pairs`
   (kernel A on CUDA) into a pair buffer of the phase's budget;
4. gather the queries of each narrow batch of 16,384 pairs, pack them with
   tolerances, error filters and the minimum separation, and solve them
   with :func:`scalable_ccd_tpu_torch.ops.solver.solve_packed` (kernel B on
   CUDA).  VF runs before EE and one running TOI is threaded through both;
   each phase starts with one warm-start batch of strided rows of its pair
   buffer (presample), and stops early once the TOI reaches 0;
5. size the pair budgets automatically: a scene-proportional power-of-two
   guess, one retry from the exact survivor total, and a sticky memo of
   grown budgets per scene-size class.

Exact modes (the JAX package's ``_phase``, ``fused.py:632-645``):

- ``collisions``: every batch is solved in per-query mode, with no
  presample and no early exit, and each pair with a TOI below 1 is
  reported (VF as (vertex, face), EE as (edge, edge));
- ``max_iterations``: the solver's per-query check cap (bounded mode);
- ``ipc_refine``: the IPC stepping rule per narrow batch.  A batch that
  drops the TOI below 1e-6 is solved again from the TOI before it, with no
  minimum separation, no cap and no zero TOI, and the TOI becomes
  ``min(before, re-solve) * 0.8``.  The refinement depends on which pairs
  share a batch, and on CUDA kernel A appends pair rows in an order that
  changes from run to run; so under ``ipc_refine`` each phase's pair rows
  are sorted by ``(id_a << 32) | id_b`` before batching, on every device.

The JAX package runs this as one XLA program; here it is eager PyTorch, and
the host reads a few scalars on the way (each phase's pair count, the
overflow check, and the TOI after every narrow batch for the early exit).
The narrow phase runs as one pass per batch, the JAX package's
``escalate_rounds=-1`` mode; staged escalation, the compensated precision
and the congestion ordering are not part of this port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import merge_two_lists, sort_boxes
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
from scalable_ccd_tpu_torch.ops.solver import pack_query_rows, solve_packed
from scalable_ccd_tpu_torch.ops.sweep_ap import sweep_pairs
from scalable_ccd_tpu_torch.utils.pca import apply_pca

__all__ = ["FusedCCDResult", "NarrowSolver", "fused_ccd", "resolve_device"]

#: presample switches off at this many boxes per phase (the JAX package's
#: congestion threshold, ``_AUTO_BUCKET_MIN_BOXES``)
_PRESAMPLE_MAX_BOXES = 1 << 20

#: candidate pairs per solver call
_NARROW_BATCH = 1 << 14

#: smallest budget the auto mode picks (16k pair rows)
_AUTO_BUDGET_MIN = 1 << 14

#: auto-budget guesses, as multiples of the phase's box/edge count
_AUTO_VF_GUESS = 2
_AUTO_EE_GUESS = 4

#: sticky auto-budget resizes, keyed by the initial (vf, ee) guesses: once a
#: frame overflows a guess, later frames of the same size class start at the
#: grown budget
_AUTO_BUDGET_MEMO: dict = {}

#: the IPC rule refines a batch whose TOI falls below this
#: (``ipc_ccd_strategy.cu:73``), and backs off by IPC_BACKOFF
IPC_MIN_TOI = 1e-6
IPC_BACKOFF = 0.8


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


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def _as_tensor(x, dtype, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def resolve_device(device, vertices_t0) -> torch.device:
    """``device``, or the device of ``vertices_t0`` when it is a tensor, or
    the CPU; a CUDA device on a machine without CUDA raises."""
    if device is None:
        device = vertices_t0.device if torch.is_tensor(vertices_t0) else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
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

    @classmethod
    def for_phase(cls, is_vf, v0, v1, edges, faces, ms, tolerance,
                  allow_zero_toi, max_iterations):
        vcat = concat_frames(v0, v1, torch.float32)
        table = pack_face_table(vcat, faces) if is_vf else pack_edge_table(vcat, edges)
        return cls(is_vf, vcat, table, float(ms), float(tolerance),
                   bool(allow_zero_toi), int(max_iterations))

    def solve(self, pairs, toi, per_query=False, exact=False):
        """Solve ``(P, 2)`` element-id pairs from the running TOI ``toi``;
        the outputs of :func:`solve_packed`.  ``exact`` is the IPC
        re-solve: no minimum separation, no cap and no zero TOI."""
        if self.is_vf:
            q = gather_vf_queries(self.vcat, self.table, pairs)
        else:
            q = gather_ee_queries(self.table, pairs)
        ms, max_iter, zero_ok = (
            (0.0, -1, False) if exact
            else (self.ms, self.max_iterations, self.allow_zero_toi)
        )
        rows = pack_query_rows(q, self.is_vf, ms, self.tolerance)
        valid = torch.ones((rows.shape[0],), dtype=torch.bool, device=rows.device)
        return solve_packed(rows, valid, self.is_vf, toi, self.tolerance,
                            zero_ok, per_query, max_iter)


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


def _sweep_phase(sorted_boxes, is_vf, budget, auto):
    """Sweep one phase; on an auto-budget overflow, sweep once more at the
    exact total.  Returns ``(pairs, n_pairs_host, n_true, overflow, budget,
    grew)``."""
    pairs, n_pairs, n_true, overflow = sweep_pairs(sorted_boxes, is_vf, budget)
    grew = auto and int(n_true) > budget
    if grew:
        budget = _pow2ceil(int(n_true))
        pairs, n_pairs, n_true, overflow = sweep_pairs(sorted_boxes, is_vf, budget)
    return pairs, int(n_pairs), n_true, overflow, budget, grew


def _narrow_phase(pairs, n_pairs, budget, batch, presample, nar: NarrowSolver,
                  toi, collisions, ipc_refine):
    """Solve one phase's candidates in batches; returns (toi, checks,
    capped, refinements)."""
    dev = pairs.device
    checks = torch.zeros((), dtype=torch.int64, device=dev)
    capped = torch.zeros((), dtype=torch.bool, device=dev)
    refinements = 0
    if collisions is not None:
        hit_pairs, hit_tois = [], []
        for start in range(0, n_pairs, batch):
            chunk = pairs[start:min(start + batch, n_pairs)]
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
        # TOI warm start: one batch of rows spread uniformly over the pair
        # buffer, so the loop starts from a near-final TOI (fused.py:845-852
        # of the JAX package: row floor(i * n / batch) for lane i < n)
        lane = torch.arange(min(batch, n_pairs), dtype=torch.int64, device=dev)
        idx = lane * (n_pairs // batch) + (lane * (n_pairs % batch)) // batch
        toi_s, cap, ck = nar.solve(pairs[idx], toi)
        toi = torch.minimum(toi, toi_s)
        checks, capped = checks + ck, capped | cap
    if ipc_refine:
        pairs = pairs[:n_pairs]
        pairs = pairs[_key_order(pairs)]
    start = 0
    # the host reads the TOI once per batch for the early exit, the
    # reference chunk loop's `remaining_queries && toi > 0`
    while start < n_pairs and float(toi) > 0:
        chunk = pairs[start:min(start + batch, n_pairs)]
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
) -> FusedCCDResult:
    """Earliest time of impact of a linearly moving triangle mesh.

    Inputs are numpy arrays or tensors: ``(n, 3)`` vertices at t=0 and t=1
    (float64 or float32), ``(m, 2)`` edges and ``(k, 3)`` faces.  Everything
    runs on ``device`` (default: the device of ``vertices_t0`` when it is a
    tensor, else the CPU).  On CUDA the sweep and the solver are the CUDA
    kernels; on the CPU their plain PyTorch versions.  A CUDA device on a
    machine without CUDA raises; nothing falls back to the CPU.

    ``min_distance`` is the minimum separation (boxes inflate by it and
    the solver keeps it); ``max_iterations >= 0`` caps each query's domain
    checks, dropping what lies past the cap (not conservative, as in the
    reference).  A ``collisions`` list receives every pair's
    ``(id_a, id_b, toi)`` with ``toi < 1``, VF hits first, each phase in
    id order.  ``ipc_refine`` applies the IPC stepping rule per narrow
    batch (module docstring); it has no per-pair output, so it raises with
    ``collisions``.  ``pca`` rotates the mesh into its principal axes
    first (the TOI is unchanged; candidate counts change).

    ``vf_budget``/``ee_budget`` bound the candidate pairs per phase;
    ``"auto"`` guesses from the scene size and retries a phase once at its
    exact total on overflow, so ``overflowed`` stays False.  With integer
    budgets an overflow is reported in ``overflowed`` and the pairs past
    the budget are missing.  Boxes are built and solved in f32.
    """
    if collisions is not None and ipc_refine:
        raise ValueError(
            "ipc_refine has no per-pair output (the reference discards "
            "collisions in ipc_ccd_strategy, ipc_ccd_strategy.cu:52-54)"
        )
    device = resolve_device(device, vertices_t0)
    if validate:
        validate_mesh_inputs(vertices_t0, vertices_t1, edges, faces)
    v0, v1, e, f = mesh_tensors(vertices_t0, vertices_t1, edges, faces, device, pca)

    n_vf, n_ee = v0.shape[0] + f.shape[0], e.shape[0]
    vf_auto, ee_auto = vf_budget == "auto", ee_budget == "auto"
    memo_key = None
    if vf_auto:
        vf_budget = max(_pow2ceil(_AUTO_VF_GUESS * n_vf), _AUTO_BUDGET_MIN)
    if ee_auto:
        ee_budget = max(_pow2ceil(_AUTO_EE_GUESS * n_ee), _AUTO_BUDGET_MIN)
    if vf_auto or ee_auto:
        memo_key = (vf_budget, ee_budget)
        memo = _AUTO_BUDGET_MEMO.get(memo_key, (0, 0))
        vf_budget = max(vf_budget, memo[0]) if vf_auto else vf_budget
        ee_budget = max(ee_budget, memo[1]) if ee_auto else ee_budget
    ps_vf, ps_ee = n_vf < _PRESAMPLE_MAX_BOXES, n_ee < _PRESAMPLE_MAX_BOXES

    vb = build_vertex_boxes(v0, v1, inflation_radius=min_distance, dtype=torch.float32)
    vf_sorted = sort_boxes(merge_two_lists(vb, build_face_boxes(vb, f)), axis=0)
    ee_sorted = sort_boxes(build_edge_boxes(vb, e), axis=0)

    toi = torch.ones((), dtype=torch.float32, device=device)
    grown = [0, 0]
    out = []
    for k, (sb, is_vf, budget, auto, ps) in enumerate((
        (vf_sorted, True, int(vf_budget), vf_auto, ps_vf),
        (ee_sorted, False, int(ee_budget), ee_auto, ps_ee),
    )):
        pairs, n_pairs, n_true, overflow, budget, grew = _sweep_phase(
            sb, is_vf, budget, auto
        )
        grown[k] = budget if grew else 0
        nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, min_distance, tolerance,
                                     allow_zero_toi, max_iterations)
        toi, checks, capped, refined = _narrow_phase(
            pairs, n_pairs, budget, min(_NARROW_BATCH, budget), ps, nar, toi,
            collisions, ipc_refine,
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
