"""Peaks of the card and the least bytes each layer's inputs and outputs
need, whatever kernel implements it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet) at its full
700 W; a card set to a lower power limit reaches less, so every share is
stated beside the card's limit (the result line's ``device.power_limit_w``).

- Sweep (kernels A and A'): every box of both phases read once, its six
  float32 bounds and three int32 vertex ids, and every candidate pair that
  survives written once, two int32 ids.
- Solver (kernel B): every candidate read once, the four vertices at t=0 and
  t=1 (24 float32) and its two int32 ids.

Both are bounds by bytes alone, so a share below 100% says how far the
kernels are from streaming what they must; the operations a search needs
(the least domain checks) are not counted yet.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "BOX_BYTES", "PAIR_BYTES", "CANDIDATE_BYTES",
           "sweep_bytes", "solver_bytes", "bound_s"]

#: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12

#: a box as the sweep reads it: 6 float32 bounds, 3 int32 vertex ids
BOX_BYTES = 6 * 4 + 3 * 4
#: a candidate pair as the sweep writes it: 2 int32 ids
PAIR_BYTES = 2 * 4
#: a candidate as the solver reads it: 4 vertices x 2 frames x 3 float32, 2 int32 ids
CANDIDATE_BYTES = 24 * 4 + 2 * 4


def sweep_bytes(n_vf_boxes: int, n_ee_boxes: int, n_pairs: int) -> int:
    """Bytes a call's sweeps need: both phases' boxes in, their pairs out."""
    return (n_vf_boxes + n_ee_boxes) * BOX_BYTES + n_pairs * PAIR_BYTES


def solver_bytes(n_candidates: int) -> int:
    """Bytes a call's solver needs: each candidate's vertices and ids in."""
    return n_candidates * CANDIDATE_BYTES


def bound_s(n_bytes: int) -> float:
    """The least seconds ``n_bytes`` take at the card's HBM bandwidth."""
    return n_bytes / HBM_BYTES_PER_S
