"""Every candidate pair of a frame, plain PyTorch: the boxes that overlap.

The broad phase's answer is a set: every vertex-face pair and every
edge-edge pair whose boxes overlap (closed intervals on all three axes) and
that share no vertex.  The program sorts and sweeps; this reference does not
copy it, and finds the same set another way, by slabs:

- the boxes are cut into slabs of width ``w`` along z, each box entered in
  every slab its z-interval meets;
- inside a slab the entries are sorted by their lower x bound, as exact
  integer keys (a float32's bits, made monotone, under the slab number), so
  every partner of an entry lies after it up to the first entry whose lower
  x bound passes its upper one (``searchsorted``);
- each candidate is tested exactly on all three axes, and a pair is kept in
  one slab only, the slab of the larger of the two lower z bounds, which
  both boxes meet.

The candidates are expanded in blocks of at most ``block`` pairs.  Any slab
width gives the same set; a width of a few box extents keeps the candidates
few.
"""

from __future__ import annotations

import torch

from ccd_bench.reference.boxes import Boxes

__all__ = ["overlapping_pairs", "vf_pairs", "ee_pairs"]

#: candidate pairs expanded at once
BLOCK = 1 << 24


def _x_key(x: torch.Tensor) -> torch.Tensor:
    """float32 values as non-negative int64 keys of the same order (-0 and
    +0 alike)."""
    bits = (x + 0.0).contiguous().view(torch.int32).long()
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + (1 << 31)


def overlapping_pairs(lo: torch.Tensor, hi: torch.Tensor, keep, block: int = BLOCK):
    """``(a, b)`` int64 index vectors of every pair of boxes ``a != b`` of
    ``(lo, hi)`` that overlap and pass ``keep(a, b)`` (a mask), each
    unordered pair once, ordered ``a < b``."""
    dev, n = lo.device, lo.shape[0]
    empty = torch.zeros((0,), dtype=torch.long, device=dev)
    if n < 2:
        return empty, empty
    zlo, zhi = lo[:, 2].double(), hi[:, 2].double()
    z0 = float(zlo.min())
    # a few box extents, and at most 1024 slabs
    w = max(float(4 * (zhi - zlo).median()), (float(zhi.max()) - z0) / 1024, 1e-30)
    s0 = torch.floor((zlo - z0) / w).long()
    s1 = torch.floor((zhi - z0) / w).long()
    # one entry per (box, slab)
    reps = s1 - s0 + 1
    box = torch.repeat_interleave(torch.arange(n, device=dev), reps)
    first = torch.cumsum(reps, 0) - reps
    slab = s0[box] + (torch.arange(box.shape[0], device=dev) - first[box])
    key = (slab << 32) | _x_key(lo[box, 0])
    order = torch.argsort(key, stable=True)
    box, slab, key = box[order], slab[order], key[order]
    bound = (slab << 32) | _x_key(hi[box, 0])
    end = torch.searchsorted(key, bound, right=True)
    n_ent = box.shape[0]
    count = (end - torch.arange(n_ent, device=dev) - 1).clamp(min=0)
    cum = torch.cumsum(count, 0)
    out_a, out_b = [], []
    i0 = 0
    while i0 < n_ent:
        base = int(cum[i0 - 1]) if i0 else 0
        i1 = int(torch.searchsorted(cum, base + block, right=True))
        i1 = min(max(i1, i0 + 1), n_ent)
        c = count[i0:i1]
        tot = int(cum[i1 - 1]) - base
        if tot:
            ii = torch.repeat_interleave(torch.arange(i0, i1, device=dev), c)
            start = cum[ii] - count[ii] - base
            jj = ii + 1 + (torch.arange(tot, device=dev) - start)
            a, b = box[ii], box[jj]
            hit = ((lo[a] <= hi[b]) & (lo[b] <= hi[a])).all(dim=1)
            hit &= slab[ii] == torch.maximum(s0[a], s0[b])
            hit &= keep(a, b)
            a, b = a[hit], b[hit]
            out_a.append(torch.minimum(a, b))
            out_b.append(torch.maximum(a, b))
        i0 = i1
    if not out_a:
        return empty, empty
    return torch.cat(out_a), torch.cat(out_b)


def vf_pairs(vb: Boxes, fb: Boxes, faces: torch.Tensor) -> torch.Tensor:
    """``(P, 2)`` int64 (vertex, face) pairs whose boxes overlap, the vertex
    not a corner of the face, sorted."""
    nv = vb.lo.shape[0]
    f = faces.long()
    lo = torch.cat([vb.lo, fb.lo])
    hi = torch.cat([vb.hi, fb.hi])

    def keep(a, b):
        # exactly one vertex box and one face box, the vertex not in the face
        lo_i, hi_i = torch.minimum(a, b), torch.maximum(a, b)
        ok = (lo_i < nv) & (hi_i >= nv)
        fi = (hi_i - nv).clamp(min=0)
        return ok & (f[fi] != lo_i[:, None]).all(dim=1)

    a, b = overlapping_pairs(lo, hi, keep)
    pairs = torch.stack([a, b - nv], dim=1)
    return pairs[torch.argsort(pairs[:, 0] * (fb.lo.shape[0] + 1) + pairs[:, 1])]


def ee_pairs(eb: Boxes, edges: torch.Tensor) -> torch.Tensor:
    """``(P, 2)`` int64 (edge, edge) pairs, first < second, whose boxes
    overlap and that share no vertex, sorted."""
    e = edges.long()

    def keep(a, b):
        ea, eb_ = e[a], e[b]
        return ((ea[:, :, None] != eb_[:, None, :]).all(dim=2).all(dim=1))

    a, b = overlapping_pairs(eb.lo, eb.hi, keep)
    pairs = torch.stack([a, b], dim=1)
    return pairs[torch.argsort(pairs[:, 0] * (e.shape[0] + 1) + pairs[:, 1])]
