"""Scalar reference implementation of the tight-inclusion root finder.

The port's own copy of ``scalable_ccd_tpu/narrow_phase/oracle.py`` (numpy and
``math`` only): a float64 oracle, one query at a time, with the acceptance
and cull rules of :mod:`scalable_ccd_tpu_torch.narrow_phase.root_finder` and
of the reference CUDA kernel
(``src/scalable_ccd/cuda/narrow_phase/root_finder.cu``).  It shares no code
with either package's solvers, so agreement with it is a truth independent
of both.  Test-scale inputs only.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["ccd_query_oracle"]


def _corners(pts, t_lo, t_hi, u_lo, u_hi, v_lo, v_hi, is_vf):
    """F at the 8 corners. pts = (8, 3): p0s..p3s, p0e..p3e."""
    p_s, p_e = pts[:4], pts[4:]
    out = []
    for t in (t_lo, t_hi):
        p = [(p_e[i] - p_s[i]) * t + p_s[i] for i in range(4)]
        for u in (u_lo, u_hi):
            for v in (v_lo, v_hi):
                if is_vf:
                    f = p[0] - (p[2] - p[1]) * u - (p[3] - p[1]) * v - p[1]
                else:
                    f = ((p[1] - p[0]) * u + p[0]) - ((p[3] - p[2]) * v + p[2])
                out.append(f)
    return np.asarray(out)


def _tolerance(pts, is_vf, co_tol):
    # corner values of F over [0,1]^3, indexed [t][u][v]
    c = {}
    for t in (0, 1):
        for u in (0, 1):
            for v in (0, 1):
                c[(t, u, v)] = _corners(pts, t, t, u, u, v, v, is_vf)[0]

    def ext(axis):
        m = 0.0
        for a in (0, 1):
            for b in (0, 1):
                if axis == 0:
                    d = c[(1, a, b)] - c[(0, a, b)]
                elif axis == 1:
                    d = c[(a, 1, b)] - c[(a, 0, b)]
                else:
                    d = c[(a, b, 1)] - c[(a, b, 0)]
                m = max(m, np.max(np.abs(d)))
        return m

    et, eu, ev = ext(0), ext(1), ext(2)
    if is_vf:
        return np.array([co_tol / (3 * et), co_tol / (3 * eu), co_tol / (3 * ev)])
    # EE quirk (root_finder.cu:82-87): tol = (ext_t, ext_t, ext_u) — the
    # t extent is reused for u and the u extent lands in the v slot
    return np.array([co_tol / (3 * et), co_tol / (3 * et), co_tol / (3 * eu)])


def _error_bound(pts, is_vf, use_ms):
    eps = np.finfo(np.float64).eps
    k = (30 if is_vf else 28) + (4 if use_ms else 0)
    m = np.maximum(np.max(np.abs(pts), axis=0), 1.0)
    return m * m * m * (k * eps)


def ccd_query_oracle(
    pts,
    is_vf: bool,
    tolerance: float = 1e-6,
    ms: float = 0.0,
    max_iterations: int = -1,
    allow_zero_toi: bool = True,
    stack_capacity: int = 96,
    prune_bound: float = math.inf,
):
    """Earliest certified TOI for one query; returns (toi, checks, overflow).

    ``pts``: (8, 3) float64 — p0s, p1s, p2s, p3s, p0e, p1e, p2e, p3e.
    ``toi`` is +inf when no contact is certified.  DFS with explicit stack,
    lower-t child explored first; identical accept/cull conditions to the
    batched solver (per-query pruning, i.e. the TOI_PER_QUERY semantics).
    """
    pts = np.asarray(pts, np.float64)
    tol = _tolerance(pts, is_vf, tolerance)
    err = _error_bound(pts, is_vf, ms > 0)
    eps = np.finfo(np.float64).eps
    uv_limit = 1.0 / (1.0 - eps)

    stack = [(np.zeros(3), np.ones(3))]
    best = math.inf
    checks = 0
    overflow = False

    while stack:
        lo, hi = stack.pop()
        checks += 1
        bound = min(best, prune_bound)
        if lo[0] >= bound:
            continue
        if max_iterations >= 0 and (checks - 1) > max_iterations:
            continue

        c = _corners(pts, lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], is_vf)
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        true_tol = max(0.0, np.max(cmax - cmin))
        if np.any(cmin - ms > err) or np.any(cmax + ms < -err):
            continue  # no root possible
        box_in = not (np.any(cmin + ms < -err) or np.any(cmax - ms > err))

        widths = hi - lo
        min_t = lo[0]
        pos_ok = allow_zero_toi or min_t > 0

        split = int(np.argmax(widths / tol))
        mid = (lo[split] + hi[split]) / 2
        degenerate = lo[split] >= mid or mid >= hi[split]

        if (
            np.all(widths <= tol)
            or (box_in and pos_ok)
            or (true_tol <= tolerance and pos_ok)
            or degenerate
        ):
            best = min(best, min_t)
            continue

        # push child2 = [mid, hi] first so child1 = [lo, mid] pops first
        if split == 0:
            push2 = mid <= bound
        elif is_vf:
            other = lo[2] if split == 1 else lo[1]
            push2 = (mid + other) <= uv_limit
        else:
            push2 = True

        n_push = 1 + int(push2)
        if len(stack) + n_push > stack_capacity:
            overflow = True
            best = min(best, min_t)
            continue
        if push2:
            lo2 = lo.copy()
            lo2[split] = mid
            stack.append((lo2, hi.copy()))
        hi1 = hi.copy()
        hi1[split] = mid
        stack.append((lo.copy(), hi1))

    return best, checks, overflow
