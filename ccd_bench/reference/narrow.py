"""The earliest time of impact of a frame's candidates, plain PyTorch.

A frozen copy of the port's plain solver (``ops/solver.py:
solve_packed_reference`` in its global, unbounded mode, with ``bisect_step``
and ``inclusion`` of ``narrow_phase/root_finder.py`` and the row packing of
``narrow_phase/types.py``), the tight-inclusion rules of the Scalable-CCD
reference: each query is a (t, u, v) unit cube bisected depth first, a
domain accepted where it is narrower than the tolerance, lies inside the
error envelope or degenerates, pruned where its earliest time is not below
the running TOI.  Everything is computed in float32 with every multiply and
add rounded on its own.

Domains are taken from a stack in tiles, ``tile`` at a time.  The TOI does
not depend on the order, except where a query runs past the runaway guard
(``MAX_STEPS`` evaluations), so the tile is a matter of speed only.  Whether
a conservative accept (``overflow``) fires can depend on the order, since
another query may prune the domain first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["pack_rows", "solve", "MAX_STEPS"]

#: a query stops here, accepts its earliest unexplored time and flags overflow
MAX_STEPS = 1 << 20
#: float32's stack depth and splits per dimension
MAX_DEPTH, DIM_CAP = 64, 24


class Queries(NamedTuple):
    p0s: torch.Tensor
    p1s: torch.Tensor
    p2s: torch.Tensor
    p3s: torch.Tensor
    p0e: torch.Tensor
    p1e: torch.Tensor
    p2e: torch.Tensor
    p3e: torch.Tensor


def _corners(q: Queries, lo, hi, is_vf: bool) -> torch.Tensor:
    """The residual at the 8 corners of each (t, u, v) box, ``(Q, 2, 2, 2, 3)``:
    VF ``p0(t) - (p2-p1)(t) u - (p3-p1)(t) v - p1(t)``, EE ``((p1-p0) u + p0)
    - ((p3-p2) v + p2)``, with ``p(t) = (pe - ps) t + ps``."""
    t = torch.stack([lo[:, 0], hi[:, 0]], dim=1)[:, :, None]

    def lerp(ps, pe):
        return (pe - ps)[:, None, :] * t + ps[:, None, :]

    p0, p1 = lerp(q.p0s, q.p0e), lerp(q.p1s, q.p1e)
    p2, p3 = lerp(q.p2s, q.p2e), lerp(q.p3s, q.p3e)
    u = torch.stack([lo[:, 1], hi[:, 1]], dim=1)[:, None, :, None, None]
    v = torch.stack([lo[:, 2], hi[:, 2]], dim=1)[:, None, None, :, None]

    def bc(p):
        return p[:, :, None, None, :]

    if is_vf:
        return bc(p0) - bc(p2 - p1) * u - bc(p3 - p1) * v - bc(p1)
    return (bc(p1 - p0) * u + bc(p0)) - (bc(p3 - p2) * v + bc(p2))


def _tolerance(q: Queries, is_vf: bool, co) -> torch.Tensor:
    """``co / (3 * extent)`` per dimension; EE keeps the reference's
    (t, t, u) order."""
    zero = torch.zeros((q.p0s.shape[0], 3), dtype=q.p0s.dtype, device=q.p0s.device)
    c = _corners(q, zero, zero + 1, is_vf)

    def extent(axis):
        return (c.select(axis, 1) - c.select(axis, 0)).abs().flatten(1).amax(dim=1)

    et, eu, ev = extent(1), extent(2), extent(3)
    co = torch.as_tensor(co, dtype=q.p0s.dtype, device=q.p0s.device)
    if is_vf:
        return torch.stack([co / (3 * et), co / (3 * eu), co / (3 * ev)], dim=1)
    return torch.stack([co / (3 * et), co / (3 * et), co / (3 * eu)], dim=1)


def _error_bound(q: Queries, is_vf: bool) -> torch.Tensor:
    """``max_d^3 * k * eps``, k = 30 (VF) or 28 (EE), with no separation."""
    eps = torch.finfo(q.p0s.dtype).eps
    pts = torch.stack(list(q), dim=1)
    m = torch.clamp(pts.abs().amax(dim=1), min=1.0)
    return m * m * m * ((30 if is_vf else 28) * eps)


def pack_rows(vcat: torch.Tensor, pairs: torch.Tensor, is_vf: bool, faces, edges,
              tolerance: float) -> torch.Tensor:
    """``(Q, 31)`` rows: the 8 endpoints, the tolerance, the error bound and
    a separation of 0.  ``vcat`` is ``(n, 6)``: t=0 then t=1 positions."""
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    if is_vf:
        f = faces.long()[b]
        pts = [vcat[a], vcat[f[:, 0]], vcat[f[:, 1]], vcat[f[:, 2]]]
    else:
        e = edges.long()
        ea, eb = e[a], e[b]
        pts = [vcat[ea[:, 0]], vcat[ea[:, 1]], vcat[eb[:, 0]], vcat[eb[:, 1]]]
    q = Queries(*[p[:, 0:3] for p in pts], *[p[:, 3:6] for p in pts])
    ms = torch.zeros((q.p0s.shape[0], 1), dtype=vcat.dtype, device=vcat.device)
    return torch.cat([*q, _tolerance(q, is_vf, tolerance), _error_bound(q, is_vf), ms], dim=1)


def _unpack(rows):
    return Queries(*[rows[:, 3 * k:3 * k + 3] for k in range(8)]), rows[:, 24:27], rows[:, 27:30]


def _step(q, lo, hi, tol, err, co_tol, bound, depth, dimcnt, is_vf, uv_limit):
    """One evaluation of each domain: ``(accept, do_split, push2, split,
    mid, overflow)``."""
    min_t = lo[:, 0]
    live = min_t < bound
    c = _corners(q, lo, hi, is_vf).flatten(1, 3)
    cmin, cmax = c.amin(dim=1), c.amax(dim=1)
    true_tol = torch.clamp((cmax - cmin).amax(dim=1), min=0.0)
    hit = ~((cmin > err) | (cmax < -err)).any(dim=1)
    box_in = ~((cmin < -err) | (cmax > err)).any(dim=1)
    widths = hi - lo
    cond1 = (widths <= tol).all(dim=1)
    cond3 = true_tol <= co_tol
    r = widths / tol
    d0 = (r[:, 0] >= r[:, 1]) & (r[:, 0] >= r[:, 2])
    d1 = ~d0 & (r[:, 1] >= r[:, 2])
    split = torch.where(d0, 0, torch.where(d1, 1, 2))
    s_lo = lo.gather(1, split[:, None])[:, 0]
    s_hi = hi.gather(1, split[:, None])[:, 0]
    mid = (s_lo + s_hi) * 0.5
    degenerate = (s_lo >= mid) | (mid >= s_hi)
    live = live & hit
    accept = live & (cond1 | box_in | cond3 | degenerate)
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


def solve(rows: torch.Tensor, is_vf: bool, toi_init, tolerance: float,
          tile: int = 1 << 16):
    """``(toi, overflow)`` of the rows, 0-d tensors: the earliest time of
    impact from ``toi_init`` (zero TOIs allowed), and whether a
    conservative accept fired."""
    dev, dt = rows.device, rows.dtype
    one = torch.ones((), dtype=dt)
    uv_limit = float(one / (one - torch.finfo(dt).eps))
    co_tol = float(torch.as_tensor(tolerance, dtype=dt))
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
        q, tol, err = _unpack(rows[p_q])
        qchecks.index_add_(0, p_q, torch.ones_like(p_q))
        accept, do_split, push2, split, mid, over = _step(
            q, p_lo, p_hi, tol, err, co_tol, toi.expand(p_q.shape), p_depth, p_cnt, is_vf,
            uv_limit)
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
        over = qchecks[qid] >= MAX_STEPS
        if bool(over.any()):
            toi = torch.minimum(toi, lo[over, 0].amin())
            ovf.fill_(True)
            stay = ~over
            lo, hi, qid, depth, dimcnt = lo[stay], hi[stay], qid[stay], depth[stay], dimcnt[stay]
    return toi, ovf
