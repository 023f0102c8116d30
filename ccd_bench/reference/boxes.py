"""Conservative boxes of a moving mesh, plain PyTorch.

A frozen copy of the port's box rules (``geometry/aabb.py``), which the
reference has to meet bit for bit, since the broad phase's pair counts are
compared exactly: the min and max over t=0 and t=1 in the input precision,
cast to the box precision, widened by one ulp each way by ``nextafter``, with
subnormal operands and results flushed to zero.  The radius is 0 at the
benchmark's settings, which leaves the ulp alone.

``box_dtype=torch.bfloat16`` is the control's coarser storage: the float32
boxes rounded outward to bfloat16 and held as float32 again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Boxes", "vertex_boxes", "edge_boxes", "face_boxes", "round_out_bf16"]


class Boxes(NamedTuple):
    """``(n, 3)`` lower and upper corners, float32."""

    lo: torch.Tensor
    hi: torch.Tensor


def _flush(x: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, x * 0, x)


def round_out_bf16(lo: torch.Tensor, hi: torch.Tensor) -> Boxes:
    """float32 bounds rounded outward to bfloat16 values (held as float32):
    a conservative box stored in half the bits.  A bfloat16 is the top half
    of a float32, so cutting the low 16 bits rounds toward zero, and one
    more step of the kept bits moves away from zero."""
    def outward(x, away_sign):
        bits = x.contiguous().view(torch.int32)
        cut = bits & -65536
        step = ((x * away_sign > 0) & (cut != bits)).to(torch.int32) * 65536
        return (cut + step).view(torch.float32)

    return Boxes(outward(lo, -1.0), outward(hi, 1.0))


def vertex_boxes(v0: torch.Tensor, v1: torch.Tensor, box_dtype=torch.float32) -> Boxes:
    """Boxes of the vertices' linear paths from ``v0`` to ``v1`` (float64)."""
    lo = _flush(torch.minimum(v0, v1).to(torch.float32))
    hi = _flush(torch.maximum(v0, v1).to(torch.float32))
    inf = torch.full((), float("inf"), dtype=torch.float32, device=lo.device)
    r = _flush(torch.nextafter(torch.zeros((), dtype=torch.float32, device=lo.device), inf))
    lo = _flush(_flush(torch.nextafter(lo, -inf)) - r)
    hi = _flush(_flush(torch.nextafter(hi, inf)) + r)
    if box_dtype == torch.bfloat16:
        return round_out_bf16(lo, hi)
    return Boxes(lo, hi)


def edge_boxes(vb: Boxes, edges: torch.Tensor) -> Boxes:
    e = edges.long()
    return Boxes(torch.minimum(vb.lo[e[:, 0]], vb.lo[e[:, 1]]),
                 torch.maximum(vb.hi[e[:, 0]], vb.hi[e[:, 1]]))


def face_boxes(vb: Boxes, faces: torch.Tensor) -> Boxes:
    f = faces.long()
    lo = torch.minimum(torch.minimum(vb.lo[f[:, 0]], vb.lo[f[:, 1]]), vb.lo[f[:, 2]])
    hi = torch.maximum(torch.maximum(vb.hi[f[:, 0]], vb.hi[f[:, 1]]), vb.hi[f[:, 2]])
    return Boxes(lo, hi)
