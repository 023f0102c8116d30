"""Multi-device CCD on ``torch.distributed``.

Counterpart of ``scalable_ccd_tpu/parallel/sharded.py`` (``default_mesh``,
``make_sharded_ccd``, ``sharded_ccd``) and of the axis-name branches of JAX
``fused_ccd_core`` it stands on (``pipeline/fused.py:183-244,690-800,
1052-1167,1410-1485``), on a process group in place of a device mesh: one
process per rank, each with its own device (``cuda:{rank % device_count}``
unless the caller names one).

- The mesh is replicated: every rank builds and sorts the boxes
  identically, with the same knobs as :func:`scalable_ccd_tpu_torch.
  fused_ccd` (:mod:`scalable_ccd_tpu_torch.pipeline.policy`: the congestion
  ordering from 2^20 VF boxes).
- The sweep is range-sharded: rank ``s`` of ``S`` sweeps its share of the
  sorted order, ``ceil(rows / S)`` a-rows of 128 boxes, with kernel A's
  ``box_range`` (``sweep_impl="pairs"``) or kernel A''s ``row_range``
  (``"records"``, whose records each rank decodes to element-id pairs);
  partners run on past the share, so every pair is emitted by exactly one
  rank and the per-rank totals sum to the whole.
- ``partition="box"``: every rank still builds and sorts the whole box
  arrays, then keeps only its owned share plus a right halo of
  ``halo_boxes`` (rounded up to whole a-rows) as live box planes through
  the sweep and the narrow phase (:func:`partition_slice`); a halo too
  short for a partner sets ``overflowed``, and :func:`sharded_ccd` retries
  with the halo times 4, up to 3 times, from the same sort.
- The narrow phase is balanced: one all-gather of the candidate counts and
  one of the candidate buffers per phase, and each rank takes a stride-``S``
  stripe of every source rank's candidates into a dense prefix, so the
  solve work is even to within ``S`` rows wherever the contacts lie
  (:func:`_balance`).
- The running TOI is all-reduced (MIN) after every narrow batch, so ranks
  prune against each other's hits mid-phase; the loop's trip count and its
  early exit come only from values every rank holds alike (the gathered
  counts, the reduced TOI), so every rank makes the same collectives.

``collect=True`` solves the stripes per query and gathers every rank's hits
into one replicated hit list, VF first and each phase in id order, as
``fused_ccd(collisions=)`` gives it.  The staged escalation is the per-batch
ladder (the frame pool is single-device only, JAX ``fused.py:1241``).

On gloo with CUDA tensors the collectives go through host copies (gloo's
CUDA support differs between collectives and builds); on NCCL they run on
the card.  The JAX package's TPU knobs (``solver``, ``stack_capacity``,
``sweep_batch``, ``sweep_window``, ``shift_cap``, ``narrow_order``) are not
ported: :func:`scalable_ccd_tpu_torch.interop.sharded_kwargs_from_jax`
drops them at their defaults and raises on any other value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from scalable_ccd_tpu_torch.broad_phase.sweep import SortedBoxes
from scalable_ccd_tpu_torch.config import check_precision
from scalable_ccd_tpu_torch.geometry.mesh import validate_mesh_inputs
from scalable_ccd_tpu_torch.ops.sweep_ap import ROW, partner_planes, sweep_pairs
from scalable_ccd_tpu_torch.ops.sweep_records import (
    decode_records_range,
    records_pair_prefix,
    sweep_records,
)
from scalable_ccd_tpu_torch.pipeline.fused import FusedCCDResult
from scalable_ccd_tpu_torch.pipeline.narrow import (
    IPC_BACKOFF,
    IPC_MIN_TOI,
    NarrowSolver,
    PairStream,
    key_order,
    solve_per_query,
)
from scalable_ccd_tpu_torch.pipeline.policy import (
    mesh_tensors,
    resolve_dtype,
    resolve_knobs,
    sorted_phases,
)

__all__ = [
    "FusedCollisionsResult",
    "default_group",
    "make_sharded_ccd",
    "partition_slice",
    "rank_device",
    "sharded_ccd",
]

#: the halo retry of ``partition="box"``: the factor and the retries
#: (JAX ``sharded.py:276-294``)
HALO_GROWTH, HALO_RETRIES = 4, 3

#: element-id fill of padded candidate rows (never read as a pair)
_SENTINEL = -(2**31) + 1


class FusedCollisionsResult(NamedTuple):
    """:class:`FusedCCDResult`'s fields and the replicated hit list of
    ``collect=True``: per phase the ``(count, 2)`` int32 id pairs (VF as
    (vertex, face), EE as (edge, edge)) in id order and their TOIs."""

    toi: torch.Tensor
    overflowed: torch.Tensor
    vf_total: torch.Tensor
    ee_total: torch.Tensor
    total_checks: torch.Tensor
    solver_capped: torch.Tensor
    ipc_refinements: torch.Tensor
    vf_hits: torch.Tensor
    vf_hit_toi: torch.Tensor
    vf_hit_count: torch.Tensor
    ee_hits: torch.Tensor
    ee_hit_toi: torch.Tensor
    ee_hit_count: torch.Tensor


def default_group():
    """The default (world) process group (JAX ``default_mesh``); raises
    unless ``torch.distributed`` has been initialised."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the sharded path needs an initialised torch.distributed process group: "
            "call torch.distributed.init_process_group first (or run under "
            "scalable_ccd_tpu_torch.parallel.spawn_local)"
        )
    return dist.group.WORLD


def rank_device(device=None) -> torch.device:
    """``device``, or ``cuda:{rank % device_count}`` when it is ``None`` (the
    process's global rank); a CUDA device on a machine without CUDA
    raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means this rank's CUDA device, but CUDA is not available; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available")
    return device


class _Comm:
    """The collectives of one rank on ``group``, for tensors on ``device``."""

    def __init__(self, group, device):
        self.group = group
        self.device = device
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        # gloo takes host tensors in every collective; NCCL device tensors
        self.host = dist.get_backend(group) == "gloo"

    def _out(self, t):
        return t.cpu() if self.host else t

    def all_reduce(self, t, op):
        x = self._out(t).clone()
        dist.all_reduce(x, op=op, group=self.group)
        return x.to(self.device)

    def min(self, t):
        return self.all_reduce(t, dist.ReduceOp.MIN)

    def all_gather(self, t):
        """Every rank's ``t`` (one shape on all ranks), in rank order."""
        x = self._out(t).contiguous()
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x, group=self.group)
        return [o.to(self.device) for o in out]

    def counts(self, n: int):
        """Every rank's count ``n``, in rank order, as ints."""
        t = torch.tensor([int(n)], dtype=torch.int64, device=self.device)
        return [int(c) for c in torch.cat(self.all_gather(t)).tolist()]

    def gather_rows(self, rows, counts, fill):
        """Every rank's ``rows`` (``counts[s]`` of them on rank ``s``), padded
        to the largest count for the gather; the list of each rank's rows."""
        m = max(counts)
        if m == 0:
            return [rows[:0] for _ in counts]
        pad = torch.full((m - rows.shape[0],) + tuple(rows.shape[1:]), fill, dtype=rows.dtype,
                         device=rows.device)
        return [g[:c] for g, c in zip(self.all_gather(torch.cat([rows, pad])), counts)]


def _rows_per_rank(n: int, world: int) -> int:
    """A-rows of 128 sorted boxes in each rank's share of ``n`` boxes."""
    return -(-(-(-n // ROW)) // world)


def _box_share(n: int, rank: int, world: int, halo_boxes: int):
    """``(start, C, L)`` of rank ``rank``'s slice under ``partition="box"``:
    it owns the sorted positions ``[start, start + C)``, ``C`` its share of
    whole 128-box a-rows, and holds ``L = C + H`` rows from ``start``, ``H``
    the halo rounded up to whole a-rows (at least one)."""
    C = _rows_per_rank(n, world) * ROW
    H = max(-(-int(halo_boxes) // ROW), 1) * ROW
    return rank * C, C, C + H


def suffix_min(major_min):
    """Entry ``i`` the least ``major_min`` at sorted position ``i`` or
    after (the global suffix minimum the halo test reads)."""
    return torch.flip(torch.cummin(torch.flip(major_min, (0,)), 0).values, (0,))


def halo_fits(sorted_boxes: SortedBoxes, rank: int, world: int, halo_boxes: int,
              suffix=None):
    """Whether rank ``rank``'s slice (:func:`partition_slice`) holds every
    partner of its owned boxes: a 0-d bool, False when the suffix minimum of
    ``major_min`` (monotone in any ordering) past the slice is at most the
    owned boxes' largest ``major_max``.  ``suffix`` is
    :func:`suffix_min` of ``major_min``, computed here when it is None."""
    sb = sorted_boxes
    start, C, L = _box_share(sb.n, rank, world, halo_boxes)
    if C == 0 or start + L >= sb.n:
        return torch.ones((), dtype=torch.bool, device=sb.major_min.device)
    after = (suffix_min(sb.major_min) if suffix is None else suffix)[start + L]
    return after > sb.major_max[start:start + C].amax()


def partition_slice(sorted_boxes: SortedBoxes, rank: int, world: int, halo_boxes: int):
    """Rank ``rank``'s live box planes under ``partition="box"`` (JAX
    ``_partition_slice``, ``fused.py:183-244``): ``(local, owned, halo_ok)``.

    ``local`` holds the ``L = C + H`` sorted positions from ``rank * C``
    (:func:`_box_share`), copied out of the whole arrays, so it keeps none
    of them alive; the part past the scene is filled with sentinels whose
    intervals are inverted (``+big`` lower, ``-big`` upper bounds), which
    meet nothing and, under ``any_order``, widen no row union of
    :func:`scalable_ccd_tpu_torch.ops.sweep_ap.partner_planes` and stop
    every run.  ``owned = C``; ``halo_ok`` is :func:`halo_fits`."""
    sb = sorted_boxes
    n = sb.n
    fdt = sb.major_min.dtype
    start, C, L = _box_share(n, rank, world, halo_boxes)
    lo, hi = min(start, n), min(start + L, n)
    big = torch.finfo(fdt).max / 8

    def take(a, fill):
        part = a[lo:hi]
        tail = torch.full((L - part.shape[0],) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([part, tail])

    local = SortedBoxes(take(sb.major_min, big), take(sb.major_max, -big),
                        take(sb.minor_min, big), take(sb.minor_max, -big),
                        take(sb.vertex_ids, _SENTINEL), take(sb.element_id, 0))
    return local, C, halo_fits(sb, rank, world, halo_boxes)


def _box_slices(comm: "_Comm", phases, halo_boxes: int, retries: int):
    """``partition="box"``: each phase's slice of this rank at the first
    halo of ``halo_boxes``, then times ``HALO_GROWTH`` up to ``retries``
    times, that fits on every rank (one MIN all-reduce of every phase's
    tests per step, so every rank picks alike), from the one sort.  Returns
    ``([(local, owned), ...], fits)``, ``fits`` False when the largest halo
    tried still misses a partner on some rank."""
    halos = [int(halo_boxes)]
    for _ in range(retries):
        # grow from the a-row-aligned halo the slice holds
        halos.append(max(halos[-1], ROW) * HALO_GROWTH)
    tests = []
    for sb in phases:
        suffix = suffix_min(sb.major_min)
        tests += [halo_fits(sb, comm.rank, comm.world, h, suffix) for h in halos]
    fits = comm.all_reduce(torch.stack(tests).to(torch.int64), dist.ReduceOp.MIN)
    fits = fits.view(len(phases), len(halos)).amin(0).tolist()
    k = fits.index(1) if 1 in fits else len(halos) - 1
    slices = [partition_slice(sb, comm.rank, comm.world, halos[k])[:2] for sb in phases]
    return slices, bool(fits[k])


def _shard_sweep(sb, is_vf, budget, knobs, rows):
    """The a-rows ``rows = (r0, r1)`` of one phase's sweep over ``sb`` as
    element-id pairs: ``(pairs, n_true, overflow)``, ``pairs`` the
    ``min(n_true, budget)`` rows the budget holds and ``n_true`` the
    share's exact total."""
    r0, r1 = rows
    planes = partner_planes(sb) if knobs.bucket_minor else None
    kw = dict(any_order=knobs.bucket_minor, planes=planes)
    if knobs.sweep_impl == "pairs":
        buf, n_pairs, n_true, overflow = sweep_pairs(
            sb, is_vf, budget, box_range=(min(r0 * ROW, sb.n), min(r1 * ROW, sb.n)), **kw)
        return buf[:int(n_pairs)], n_true, overflow
    records, n_records, n_true, overflow = sweep_records(sb, is_vf, budget, row_range=rows,
                                                         **kw)
    cum = records_pair_prefix(records, n_records)
    held = min(int(cum[-1]), budget) if records.shape[0] else 0
    return decode_records_range(sb, records, cum, 0, held, 0, is_vf)[0], n_true, overflow


def _owned_rows(n: int, rank: int, world: int):
    """The a-rows of rank ``rank``'s share of ``n`` replicated sorted boxes."""
    per, rows = _rows_per_rank(n, world), -(-n // ROW)
    return min(rank * per, rows), min((rank + 1) * per, rows)


def _balance(comm: _Comm, pairs, by_key: bool):
    """Pool and stripe the ranks' candidates (JAX ``balance_sharded``,
    ``fused.py:1052-1088``): each rank takes its stripe of every source
    rank's rows, every ``S``-th row from its own rank on, into one dense
    prefix, so the ranks' prefixes differ by at most one row per source.
    The JAX package cuts contiguous stripes; a strided stripe gives every
    rank rows of every contact region in its first batches and in its
    presample, so no rank solves a run of hard queries unpruned while the
    early contacts sit in another rank's later batches.  ``by_key`` sorts
    each source's rows by ``(a << 32) | b`` first, so the stripes do not
    depend on the order the sweep appended them in.  Returns ``(stripes,
    used)``, ``used`` the longest prefix of any rank (every rank computes it
    from the gathered counts)."""
    counts = comm.counts(pairs.shape[0])
    sources = comm.gather_rows(pairs, counts, _SENTINEL)
    S = comm.world
    parts, lengths = [], [0] * S
    for rows, c in zip(sources, counts):
        for s in range(S):
            lengths[s] += max(0, -(-(c - s) // S))
        if by_key:
            rows = rows[key_order(rows)]
        parts.append(rows[comm.rank::S])
    return torch.cat(parts), max(lengths)


def _solve_stripes(comm, stripes, used, batch, presample, nar: NarrowSolver, toi,
                   ipc_refine):
    """The pooled, co-pruned loop (JAX ``fused.py:1410-1485``) over this
    rank's ``stripes``: batches of ``batch``, the running TOI all-reduced
    after every batch, the early exit and the IPC rule read on the reduced
    TOI.  A rank whose stripes are shorter than ``used`` joins every
    reduction with its TOI unchanged.  Returns (toi, checks, capped,
    refinements)."""
    dev = toi.device
    checks = torch.zeros((), dtype=torch.int64, device=dev)
    capped = torch.zeros((), dtype=torch.bool, device=dev)
    n = stripes.shape[0]
    if presample and n > 0:
        # a warm start spread over this rank's own prefix; the reduction
        # below shares the warmest with every rank before batch one
        toi_s, cap, ck = nar.solve(PairStream(stripes, n).sample(batch), toi)
        toi = torch.minimum(toi, toi_s)
        checks, capped = checks + ck, capped | cap
    toi = comm.min(toi)
    refinements = 0
    for start in range(0, used, batch):
        if float(toi) <= 0:
            break
        chunk = stripes[start:start + batch]
        toi_after = toi
        if chunk.shape[0]:
            toi_b, cap, ck = nar.solve(chunk, toi)
            toi_after = torch.minimum(toi, toi_b)
            checks, capped = checks + ck, capped | cap
        toi_after = comm.min(toi_after)
        if ipc_refine and bool(toi_after < IPC_MIN_TOI):
            toi_r = toi
            if chunk.shape[0]:
                toi_x, cap, ck = nar.solve(chunk, toi, exact=True)
                toi_r = torch.minimum(toi, toi_x)
                checks, capped = checks + ck, capped | cap
            toi_after = comm.min(toi_r * IPC_BACKOFF)
            refinements += 1
        toi = toi_after
    return toi, checks, capped, refinements


def _collect_stripes(comm, stripes, batch, nar: NarrowSolver, toi):
    """Per-query solves of this rank's stripes and the replicated hit list
    (JAX ``fused.py:1090-1167``): ``(toi, checks, capped, hits, hit_toi)``,
    the hits of every rank in ``(a << 32) | b`` order; ``toi`` is this
    rank's own (reduced by the caller)."""
    batches = (stripes[s:s + batch] for s in range(0, stripes.shape[0], batch))
    toi, capped, checks, pairs, tois = solve_per_query(
        nar, ((nar.pack(b), b) for b in batches), toi)
    counts = comm.counts(pairs.shape[0])
    pairs = torch.cat(comm.gather_rows(pairs, counts, _SENTINEL))
    tois = torch.cat(comm.gather_rows(tois, counts, float("inf")))
    order = key_order(pairs)
    return toi, checks, capped, pairs[order], tois[order]


class _Options(NamedTuple):
    vf_budget: int
    ee_budget: int
    max_iterations: int
    allow_zero_toi: bool
    dtype: torch.dtype
    narrow_batch: int
    sweep_impl: str
    ipc_refine: bool
    bucket_minor: object
    collect: bool
    escalate_rounds: object
    presample: object
    precision: str
    halo_boxes: int


def _step(comm: _Comm, opt: _Options, v0, v1, edges, faces, min_distance, tolerance,
          halo_retries):
    """One rank's part of a sharded CCD step; every output is replicated.
    Under ``partition="box"`` the whole sorted arrays live only until both
    phases' slices are cut (:func:`_box_slices`)."""
    dev = comm.device
    compensated = opt.precision == "compensated"
    v0, v1, e, f = mesh_tensors(v0, v1, edges, faces, dev, False)
    n_vf, n_ee = v0.shape[0] + f.shape[0], e.shape[0]
    knobs = resolve_knobs(
        n_vf, n_ee, bucket_minor=opt.bucket_minor, escalate_rounds=opt.escalate_rounds,
        escalate_pool="batch", sweep_impl=opt.sweep_impl, max_iterations=opt.max_iterations,
        collisions=opt.collect, ipc_refine=opt.ipc_refine,
        plain_f32=opt.dtype == torch.float32 and not compensated, presample=opt.presample,
    )
    phases = sorted_phases(v0, v1, e, f, min_distance, opt.dtype, knobs.bucket_minor)
    if opt.halo_boxes:
        slices, fits = _box_slices(comm, phases, opt.halo_boxes, halo_retries)
        phases = [local for local, _ in slices]
        rows = [(0, owned // ROW) for _, owned in slices]
    else:
        fits = True
        rows = [_owned_rows(sb.n, comm.rank, comm.world) for sb in phases]
    toi = torch.ones((), dtype=opt.dtype, device=dev)
    checks = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.tensor(not fits, dtype=torch.bool, device=dev)
    capped = torch.zeros((), dtype=torch.bool, device=dev)
    totals, refinements, hits = [], 0, []
    for sb, r, is_vf, budget, ps in zip(phases, rows, (True, False),
                                        (opt.vf_budget, opt.ee_budget),
                                        (knobs.presample_vf, knobs.presample_ee)):
        pairs, n_true, ovf = _shard_sweep(sb, is_vf, budget, knobs, r)
        totals.append(n_true)
        overflow = overflow | ovf
        stripes, used = _balance(comm, pairs, opt.ipc_refine)
        nar = NarrowSolver.for_phase(is_vf, v0, v1, e, f, min_distance, tolerance,
                                     opt.allow_zero_toi, opt.max_iterations,
                                     knobs.escalate_rounds, opt.dtype, compensated)
        batch = min(opt.narrow_batch, budget)
        if opt.collect:
            toi, ck, cap, hp, ht = _collect_stripes(comm, stripes, batch, nar, toi)
            hits.append((hp, ht))
        else:
            ps = ps and not opt.ipc_refine and budget >= 4 * batch
            toi, ck, cap, refined = _solve_stripes(comm, stripes, used, batch, ps, nar, toi,
                                                   opt.ipc_refine)
            refinements += refined
        checks, capped = checks + ck, capped | cap
    toi = comm.min(toi)
    sums = comm.all_reduce(torch.stack([totals[0].to(dev), totals[1].to(dev), checks]),
                           dist.ReduceOp.SUM)
    flags = comm.all_reduce(torch.stack([overflow, capped]).to(torch.int64), dist.ReduceOp.MAX)
    res = FusedCCDResult(
        toi=toi, overflowed=flags[0] > 0, vf_total=sums[0], ee_total=sums[1],
        total_checks=sums[2], solver_capped=flags[1] > 0,
        ipc_refinements=torch.tensor(refinements, dtype=torch.int64, device=dev),
    )
    if not opt.collect:
        return res
    count = lambda p: torch.tensor(p.shape[0], dtype=torch.int64, device=dev)  # noqa: E731
    (vfh, vft), (eeh, eet) = hits
    return FusedCollisionsResult(*res, vf_hits=vfh, vf_hit_toi=vft, vf_hit_count=count(vfh),
                                 ee_hits=eeh, ee_hit_toi=eet, ee_hit_count=count(eeh))


def make_sharded_ccd(
    group=None,
    *,
    device=None,
    vf_budget_per_shard: int = 1 << 14,
    ee_budget_per_shard: int = 1 << 14,
    max_iterations: int = -1,
    allow_zero_toi: bool = True,
    dtype=torch.float32,
    narrow_batch: int = 1 << 14,
    sweep_impl: str = "pairs",
    ipc_refine: bool = False,
    bucket_minor="auto",
    collect: bool = False,
    escalate_rounds=None,
    presample="auto",
    precision: str = "f32",
    partition: str = "replicated",
    halo_boxes: int = 1 << 14,
):
    """A multi-device CCD step over the process group ``group`` (``None``:
    the default world, :func:`default_group`).

    Returns ``fn(v0, v1, edges, faces, min_distance=0.0, tolerance=1e-6, *,
    halo_retries=0) ->`` :class:`FusedCCDResult`, every field replicated on
    every rank; each rank calls it with the same mesh.  ``collect=True`` returns
    :class:`FusedCollisionsResult`, with the replicated hit list.  Every
    rank of the group must call ``fn`` together (it makes collectives).

    ``device`` is this rank's device: ``None`` is ``cuda:{rank %
    device_count}``, and a CUDA device without CUDA raises; ``"cpu"`` runs
    the plain versions of the kernels.  ``vf_budget_per_shard`` and
    ``ee_budget_per_shard`` bound each rank's candidate pairs per phase
    (integers: an overflow sets ``overflowed``).  ``sweep_impl``,
    ``bucket_minor``, ``escalate_rounds``, ``presample``, ``dtype``,
    ``precision``, ``max_iterations``, ``allow_zero_toi``, ``ipc_refine`` and
    ``narrow_batch`` are :func:`scalable_ccd_tpu_torch.pipeline.fused.
    fused_ccd`'s (the staged escalation is the per-batch ladder).
    ``partition`` is ``"replicated"`` (every rank holds the whole sorted
    box arrays through the step) or ``"box"``: every rank still builds and
    sorts the whole box arrays (the inputs are replicated), then keeps only
    its owned share of the sorted order and a right halo of ``halo_boxes``
    (:func:`partition_slice`) through the sweep and the narrow phase.  A
    halo too short for some rank sets ``overflowed``; ``halo_retries`` lets
    ``fn`` try the halo times 4 that many times first, from the same sort.
    """
    if partition not in ("replicated", "box"):
        raise ValueError(f"unknown partition {partition!r}: 'replicated' or 'box'")
    if collect and ipc_refine:
        raise ValueError("ipc_refine has no per-pair output: it does not combine with collect")
    if int(narrow_batch) < 1:
        raise ValueError(f"narrow_batch={narrow_batch!r}: at least one candidate per batch")
    for name, b in (("vf_budget_per_shard", vf_budget_per_shard),
                    ("ee_budget_per_shard", ee_budget_per_shard)):
        if isinstance(b, str) or int(b) < 0:
            raise ValueError(f"{name}={b!r}: a non-negative integer (no auto budget here)")
    if partition == "box" and int(halo_boxes) < 1:
        raise ValueError(f"halo_boxes={halo_boxes!r}: at least one box")
    dtype = resolve_dtype(dtype)
    check_precision(precision, dtype == torch.float64)
    group = default_group() if group is None else group
    comm = _Comm(group, rank_device(device))
    opt = _Options(int(vf_budget_per_shard), int(ee_budget_per_shard), int(max_iterations),
                   bool(allow_zero_toi), dtype, int(narrow_batch), sweep_impl, bool(ipc_refine),
                   bucket_minor, bool(collect), escalate_rounds, presample, precision,
                   int(halo_boxes) if partition == "box" else 0)
    # a bad knob raises here, before any collective
    resolve_knobs(0, 0, bucket_minor=bucket_minor, escalate_rounds=escalate_rounds,
                  escalate_pool="batch", sweep_impl=sweep_impl, max_iterations=max_iterations,
                  collisions=collect, ipc_refine=ipc_refine, presample=presample)

    def step(v0, v1, edges, faces, min_distance=0.0, tolerance=1e-6, *, halo_retries=0):
        return _step(comm, opt, v0, v1, edges, faces, float(min_distance), float(tolerance),
                     int(halo_retries))

    return step


def sharded_ccd(
    vertices_t0,
    vertices_t1,
    edges,
    faces,
    group=None,
    min_distance: float = 0.0,
    tolerance: float = 1e-6,
    validate: bool = True,
    collisions: list | None = None,
    **kwargs,
) -> FusedCCDResult:
    """One multi-device CCD step (:func:`make_sharded_ccd`'s ``fn``, called
    once); every rank of ``group`` calls it with the same mesh and gets the
    same result.

    A ``collisions`` list receives every pair's ``(id_a, id_b, toi)`` with
    ``toi < 1``, VF hits first, each phase in id order, as
    :func:`scalable_ccd_tpu_torch.pipeline.fused.fused_ccd` gives them.
    Under ``partition="box"`` a halo too short is retried with the halo
    times 4, up to 3 times (JAX ``sharded.py:276-294``), decided on the
    reduced halo test before the sweep, so every rank retries together and
    the sort is reused; a budget overflow is not retried, as a longer halo
    cannot change the pairs.  ``kwargs`` are :func:`make_sharded_ccd`'s.
    """
    if validate:
        validate_mesh_inputs(vertices_t0, vertices_t1, edges, faces)
    collect = collisions is not None

    fn = make_sharded_ccd(group, collect=collect, **kwargs)
    res = fn(vertices_t0, vertices_t1, edges, faces, min_distance, tolerance,
             halo_retries=HALO_RETRIES)
    if not collect:
        return res
    for hits, tois in ((res.vf_hits, res.vf_hit_toi), (res.ee_hits, res.ee_hit_toi)):
        h, t = hits.cpu().numpy(), tois.cpu().numpy()
        collisions.extend((int(a), int(b), float(ti)) for (a, b), ti in zip(h, t))
    return FusedCCDResult(*res[:len(FusedCCDResult._fields)])
