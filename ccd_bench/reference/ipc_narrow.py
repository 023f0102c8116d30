"""The plain solver of :mod:`ccd_bench.reference.narrow` with the options of
the IPC stepping rule: a minimum separation, a per-query check cap and a TOI
that may not be zero.

The same frozen copy of the port's plain frontier solver (the tight-inclusion
rules of the Scalable-CCD reference, every multiply and add rounded on its
own in float32), extended where Tight-Inclusion's rules take these options:

- a row carries its separation ``ms`` (float32) and an error bound with
  k + 4 where ``ms > 0`` (``get_numerical_error``, k = 34 for VF and 32 for
  EE; the port's ``narrow_phase/types.py:168``);
- a domain misses where ``cmin - ms > err`` or ``cmax + ms < -err`` on an
  axis, and lies inside the envelope unless ``cmin + ms < -err`` or ``cmax -
  ms > err`` on one: the inclusion against ``+-(err + ms)`` in
  Tight-Inclusion's order of operations;
- without zero TOIs a domain at t = 0 is accepted only for its widths or a
  degenerate split, never for lying inside the envelope or being narrower
  than the co-domain tolerance;
- with a cap ``max_iterations >= 0`` a query's domain is dropped, never
  accepted, once the query's evaluations before the round exceed the cap;
  the runaway guard then sits past the last evaluation a capped search can
  make.  Where the cap binds, the answer depends on the order in which a
  search lowers the running TOI, and no plain version reproduces the
  card's; where it does not bind, the answer is the unbounded one.
"""

from __future__ import annotations

import torch

from ccd_bench.reference.narrow import (DIM_CAP, MAX_DEPTH, MAX_STEPS, Queries, _corners,
                                        _tolerance)

__all__ = ["pack_rows", "solve"]


def _error_bound(q: Queries, is_vf: bool, with_ms: bool) -> torch.Tensor:
    """``max_d^3 * k * eps``, k = 30 (VF) or 28 (EE), 4 more with a
    separation."""
    eps = torch.finfo(q.p0s.dtype).eps
    pts = torch.stack(list(q), dim=1)
    m = torch.clamp(pts.abs().amax(dim=1), min=1.0)
    return m * m * m * (((30 if is_vf else 28) + (4 if with_ms else 0)) * eps)


def pack_rows(vcat: torch.Tensor, pairs: torch.Tensor, is_vf: bool, faces, edges,
              tolerance: float, ms: float) -> torch.Tensor:
    """``(Q, 31)`` rows: the 8 endpoints, the tolerance, the error bound and
    the separation ``ms`` (float32).  ``vcat`` is ``(n, 6)``: t=0 then t=1
    positions."""
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    if is_vf:
        f = faces.long()[b]
        pts = [vcat[a], vcat[f[:, 0]], vcat[f[:, 1]], vcat[f[:, 2]]]
    else:
        e = edges.long()
        ea, eb = e[a], e[b]
        pts = [vcat[ea[:, 0]], vcat[ea[:, 1]], vcat[eb[:, 0]], vcat[eb[:, 1]]]
    q = Queries(*[p[:, 0:3] for p in pts], *[p[:, 3:6] for p in pts])
    sep = torch.full((q.p0s.shape[0], 1), ms, dtype=vcat.dtype, device=vcat.device)
    return torch.cat([*q, _tolerance(q, is_vf, tolerance), _error_bound(q, is_vf, ms > 0), sep],
                     dim=1)


def _unpack(rows):
    q = Queries(*[rows[:, 3 * k:3 * k + 3] for k in range(8)])
    return q, rows[:, 24:27], rows[:, 27:30], rows[:, 30:31]


def _step(q, lo, hi, tol, err, ms, co_tol, bound, depth, dimcnt, is_vf, uv_limit,
          allow_zero_toi):
    """One evaluation of each domain: ``(accept, do_split, push2, split,
    mid, overflow)``."""
    min_t = lo[:, 0]
    live = min_t < bound
    c = _corners(q, lo, hi, is_vf).flatten(1, 3)
    cmin, cmax = c.amin(dim=1), c.amax(dim=1)
    true_tol = torch.clamp((cmax - cmin).amax(dim=1), min=0.0)
    hit = ~((cmin - ms > err) | (cmax + ms < -err)).any(dim=1)
    box_in = ~((cmin + ms < -err) | (cmax - ms > err)).any(dim=1)
    pos_ok = torch.ones_like(live) if allow_zero_toi else min_t > 0
    widths = hi - lo
    cond1 = (widths <= tol).all(dim=1)
    cond2 = box_in & pos_ok
    cond3 = (true_tol <= co_tol) & pos_ok
    r = widths / tol
    d0 = (r[:, 0] >= r[:, 1]) & (r[:, 0] >= r[:, 2])
    d1 = ~d0 & (r[:, 1] >= r[:, 2])
    split = torch.where(d0, 0, torch.where(d1, 1, 2))
    s_lo = lo.gather(1, split[:, None])[:, 0]
    s_hi = hi.gather(1, split[:, None])[:, 0]
    mid = (s_lo + s_hi) * 0.5
    degenerate = (s_lo >= mid) | (mid >= s_hi)
    live = live & hit
    accept = live & (cond1 | cond2 | cond3 | degenerate)
    want = live & ~accept
    full = (depth >= MAX_DEPTH) | (dimcnt.gather(1, split[:, None])[:, 0] >= DIM_CAP)
    overflow = want & full
    do_split = want & ~full
    if is_vf:
        other = torch.where(split == 1, lo[:, 2], lo[:, 1])
        push2 = torch.where(split == 0, mid <= bound, (mid + other) <= uv_limit)
    else:
        push2 = (split != 0) | (mid <= bound)
    return accept | overflow, do_split, push2 & do_split, split, mid, overflow


def solve(rows: torch.Tensor, is_vf: bool, toi_init, tolerance: float, tile: int = 1 << 16,
          allow_zero_toi: bool = True, max_iterations: int = -1):
    """``(toi, overflow)`` of the rows, 0-d float32 and bool tensors: the
    earliest time of impact from ``toi_init`` (a float, rounded to float32
    to the nearest), and whether a conservative accept fired."""
    dev, dt = rows.device, rows.dtype
    one = torch.ones((), dtype=dt)
    uv_limit = float(one / (one - torch.finfo(dt).eps))
    co_tol = float(torch.as_tensor(tolerance, dtype=dt))
    guard = MAX_STEPS if max_iterations < 0 else max(MAX_STEPS,
                                                     max_iterations + 2 * MAX_DEPTH + 2)
    toi = torch.as_tensor(toi_init, dtype=dt, device=dev).reshape(()).clone()
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    n = rows.shape[0]
    qchecks = torch.zeros((n,), dtype=torch.int64, device=dev)
    qid = torch.arange(n, device=dev)
    lo = torch.zeros((n, 3), dtype=dt, device=dev)
    hi = torch.ones((n, 3), dtype=dt, device=dev)
    depth = torch.zeros((n,), dtype=torch.int32, device=dev)
    dimcnt = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    while qid.shape[0] > 0:
        top = max(qid.shape[0] - tile, 0)
        p_lo, p_hi, p_q, p_depth, p_cnt = lo[top:], hi[top:], qid[top:], depth[top:], dimcnt[top:]
        q, tol, err, ms = _unpack(rows[p_q])
        bound = toi.expand(p_q.shape)
        if max_iterations >= 0:
            # the count before this round; a dropped domain is pruned
            bound = torch.where(qchecks[p_q] > max_iterations, -inf, bound)
        qchecks.index_add_(0, p_q, torch.ones_like(p_q))
        accept, do_split, push2, split, mid, over = _step(
            q, p_lo, p_hi, tol, err, ms, co_tol, bound, p_depth, p_cnt, is_vf, uv_limit,
            allow_zero_toi)
        toi = torch.minimum(toi, torch.where(accept, p_lo[:, 0], inf).amin())
        ovf |= over.any()
        onehot = torch.nn.functional.one_hot(split, 3).to(torch.bool)
        m = mid[:, None]
        # (child2, child1) per domain: child1, the lower half, is popped first
        keep = torch.stack([push2, do_split], dim=1).flatten()
        c_lo = torch.stack([torch.where(onehot, m, p_lo), p_lo], dim=1).flatten(0, 1)
        c_hi = torch.stack([p_hi, torch.where(onehot, m, p_hi)], dim=1).flatten(0, 1)

        def two(x):
            return torch.stack([x, x], dim=1).flatten(0, 1)[keep]

        lo = torch.cat([lo[:top], c_lo[keep]])
        hi = torch.cat([hi[:top], c_hi[keep]])
        qid = torch.cat([qid[:top], two(p_q)])
        depth = torch.cat([depth[:top], two(p_depth + 1)])
        dimcnt = torch.cat([dimcnt[:top], two(p_cnt + onehot.to(torch.int32))])
        over = qchecks[qid] >= guard
        if bool(over.any()):
            toi = torch.minimum(toi, lo[over, 0].amin())
            ovf.fill_(True)
            stay = ~over
            lo, hi, qid, depth, dimcnt = lo[stay], hi[stay], qid[stay], depth[stay], dimcnt[stay]
    return toi, ovf
