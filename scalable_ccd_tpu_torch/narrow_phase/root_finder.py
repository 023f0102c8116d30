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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scalable_ccd_tpu_torch.narrow_phase.types import CCDQueries, domain_corners

__all__ = ["inclusion", "BisectStep", "bisect_step", "MAX_DEPTH", "DIM_CAP"]

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
