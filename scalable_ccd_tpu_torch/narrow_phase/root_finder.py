"""Tight-inclusion rules shared by both solver versions.

PyTorch counterpart of ``scalable_ccd_tpu/narrow_phase/root_finder.py``:
the 8-corner inclusion test (``_inclusion``, reference
``origin_in_inclusion_function``, ``root_finder.cu:157-198``) and one
bisection step's acceptance and cull rules (``find_roots``, reference
``ccd_kernel``, ``root_finder.cu:311-368``), written once on tensors of
domains.  The plain solver (:func:`scalable_ccd_tpu_torch.ops.solver.
solve_packed_reference`) applies them to a frontier of domains; kernel B
(``csrc/solver.cu``) is the same rules in C, one query per thread.

Acceptance: (1) domain widths below the per-dimension tolerance; (2) the
corner box lies inside the +-(err+ms) envelope; (3) the corner box is
narrower than the co-domain tolerance; (4) the bisection degenerates.  (2)
and (3) need ``t > 0`` unless zero TOIs are allowed.  Culls: the second
child of a t-split only if it can beat the running TOI; for VF the second
child of a u- or v-split only if ``u + v <= 1`` stays reachable.  The caps of
the JAX kernel hold too: a domain 64 splits deep, or split 24 times in one
dimension, is accepted conservatively and flags overflow.

:func:`dfs_lockstep` is the plain per-query depth-first search in kernel
B's exploration order, which per-query bounded results depend on (the JAX
package's ``find_roots``, ``narrow_phase/root_finder.py:142``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scalable_ccd_tpu_torch.narrow_phase.types import CCDQueries, domain_corners

__all__ = [
    "inclusion",
    "BisectStep",
    "bisect_step",
    "dfs_lockstep",
    "MAX_DEPTH",
    "DIM_CAP",
]

#: stack levels of the kernel's value-free stack
MAX_DEPTH = 64
#: splits per dimension that keep every bound an exact f32 dyadic
DIM_CAP = 24


def inclusion(q: CCDQueries, lo, hi, err, ms, is_vf: bool):
    """``(hit, box_in, true_tol)`` per domain: the +-(err+ms) envelope meets
    the corner box (a root is possible); the corner box lies inside the
    envelope; the widest codomain extent."""
    c = domain_corners(q, lo, hi, is_vf).flatten(1, 3)  # (Q, 8, 3)
    cmin = c.amin(dim=1)
    cmax = c.amax(dim=1)
    true_tol = torch.clamp((cmax - cmin).amax(dim=1), min=0.0)
    ms_ = ms[:, None]
    miss = ((cmin - ms_ > err) | (cmax + ms_ < -err)).any(dim=1)
    box_in = ~((cmin + ms_ < -err) | (cmax - ms_ > err)).any(dim=1)
    return ~miss, box_in, true_tol


class BisectStep(NamedTuple):
    accept: torch.Tensor    # (Q,) bool: accepted (incl. conservative accepts)
    do_split: torch.Tensor  # (Q,) bool: split into child1 = [s_lo, mid]
    push2: torch.Tensor     # (Q,) bool: ... and child2 = [mid, s_hi]
    split: torch.Tensor     # (Q,) int64 split dimension
    mid: torch.Tensor       # (Q,) midpoint of the split dimension
    overflow: torch.Tensor  # (Q,) bool: conservative accept at a cap


def bisect_step(q: CCDQueries, lo, hi, tol, err, ms, co_tol, bound,
                depth, dimcnt, is_vf: bool, allow_zero_toi: bool) -> BisectStep:
    """Evaluate each domain ``[lo, hi]`` once against the running TOI
    ``bound``; ``depth`` is its number of splits from the unit cube and
    ``dimcnt`` (Q, 3) those per dimension."""
    min_t = lo[:, 0]
    live = min_t < bound
    hit, box_in, true_tol = inclusion(q, lo, hi, err, ms, is_vf)
    widths = hi - lo
    pos_ok = torch.ones_like(live) if allow_zero_toi else min_t > 0
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
    accept = accept | overflow
    do_split = want & ~full
    if is_vf:
        eps = torch.finfo(lo.dtype).eps
        one = torch.ones((), dtype=lo.dtype, device=lo.device)
        uv_limit = one / (one - eps)
        other = torch.where(split == 1, lo[:, 2], lo[:, 1])
        push2 = torch.where(split == 0, mid <= bound, (mid + other) <= uv_limit)
    else:
        push2 = (split != 0) | (mid <= bound)
    return BisectStep(accept, do_split, push2 & do_split, split, mid, overflow)


def dfs_lockstep(q: CCDQueries, tol, err, ms, valid, co_tol, toi_init,
                 is_vf: bool, allow_zero_toi: bool, max_iterations: int = -1,
                 round_limit: int = -1):
    """Depth-first bisection of every query, all queries in lockstep.

    Every round each query with work left pops its stack top, evaluates it
    with :func:`bisect_step`, and pushes child2 (if kept) under child1, so
    child1 is explored first and a pending sibling is entered on unwind:
    kernel B's order, which bounded results depend on.

    Per-query mode (``round_limit < 0``): each query prunes only against its
    own TOI.  A query's evaluation count is compared before it is
    incremented; past ``max_iterations`` (``>= 0``) a domain is dropped,
    never accepted.  A query that evaluates N domains takes N rounds, so the
    plain version is meant for small caps and small inputs.  Returns
    ``(toi, overflow, checks, per_query_toi)`` with ``toi = min(toi_init,
    per-query TOIs)``; ``per_query_toi`` is +inf for invalid rows and rows
    without contact.

    Round-limited global mode (``round_limit >= 0``, no cap): every query
    prunes against one TOI seeded with ``toi_init`` and lowered after each
    round, and rounds are counted as kernel B's value-free stack takes
    them: after a domain that does not split, the kernel unwinds one level
    per popped parent plus one to enter the next sibling, two levels per
    round, so a query whose next domain is ``U`` levels away spends
    ``ceil((U - 2) / 2)`` rounds without evaluating.  The search stops after
    ``round_limit`` rounds; returns ``(toi, overflow, checks, unfin)``,
    ``unfin`` marking the queries still mid-search.
    """
    dev, dt = tol.device, tol.dtype
    rounds_mode = round_limit >= 0
    n = valid.shape[0]
    depth_cap = MAX_DEPTH + 2  # one pending sibling per level, plus the top
    s_lo = torch.zeros((n, depth_cap, 3), dtype=dt, device=dev)
    s_hi = torch.zeros((n, depth_cap, 3), dtype=dt, device=dev)
    s_hi[:, 0] = 1.0
    s_depth = torch.zeros((n, depth_cap), dtype=torch.int32, device=dev)
    s_cnt = torch.zeros((n, depth_cap, 3), dtype=torch.int32, device=dev)
    size = valid.to(torch.int64)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    tpq = torch.full((n,), float("inf"), dtype=dt, device=dev)
    checks = torch.zeros((n,), dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    toi = torch.as_tensor(toi_init, dtype=dt, device=dev).reshape(())
    delay = torch.zeros((n,), dtype=torch.int64, device=dev)  # rounds of unwinding left
    rounds = 0
    while not (rounds_mode and rounds >= round_limit):
        if rounds_mode:
            if not bool(((size > 0) | (delay > 0)).any()):
                break
            rounds += 1
            waiting = delay > 0
            delay -= waiting.to(torch.int64)
            act = torch.nonzero((size > 0) & ~waiting).flatten()
            if act.numel() == 0:
                continue
        else:
            act = torch.nonzero(size > 0).flatten()
            if act.numel() == 0:
                break
        top = size[act] - 1
        lo, hi = s_lo[act, top], s_hi[act, top]
        depth, cnt = s_depth[act, top], s_cnt[act, top]
        size[act] = top
        pre = checks[act]
        checks[act] = pre + 1
        if rounds_mode:
            bound = toi.expand(act.shape)
        else:
            # a dropped domain is pruned: no bound lies below -inf
            bound = torch.where(pre > max_iterations, -inf, tpq[act])
        qa = CCDQueries(*[f[act] for f in q])
        st = bisect_step(qa, lo, hi, tol[act], err[act], ms[act], co_tol, bound,
                         depth, cnt, is_vf, allow_zero_toi)
        acc_t = torch.where(st.accept, lo[:, 0], inf)
        if rounds_mode:
            toi = torch.minimum(toi, acc_t.amin())
        else:
            tpq[act] = torch.minimum(tpq[act], acc_t)
        ovf |= st.overflow.any()

        onehot = torch.nn.functional.one_hot(st.split, 3).to(torch.bool)
        mid = st.mid[:, None]
        c_depth = depth + 1
        c_cnt = cnt + onehot.to(torch.int32)
        for keep, c_lo, c_hi in (
            (st.push2, torch.where(onehot, mid, lo), hi),  # child2 below
            (st.do_split, lo, torch.where(onehot, mid, hi)),  # child1 on top
        ):
            rows, at = act[keep], size[act][keep]
            s_lo[rows, at] = c_lo[keep]
            s_hi[rows, at] = c_hi[keep]
            s_depth[rows, at] = c_depth[keep]
            s_cnt[rows, at] = c_cnt[keep]
            size[rows] = at + 1
        if rounds_mode:
            # unwind distance from a finished domain to the next sibling on
            # the stack (or to the root when there is none)
            left = size[act]
            nxt = s_depth[act, (left - 1).clamp(min=0)].to(torch.int64)
            d = depth.to(torch.int64)
            unwind = torch.where(left > 0, d - nxt + 1, d)
            delay[act] = torch.where(st.do_split, 0, (unwind - 1).clamp(min=0) // 2)
    if rounds_mode:
        return toi, ovf, checks.sum(), (size > 0) | (delay > 0)
    if n:
        toi = torch.minimum(toi, tpq.amin())
    return toi, ovf, checks.sum(), tpq
