"""PCA world rotation for the broad phase.

PyTorch counterpart of ``scalable_ccd_tpu/utils/pca.py`` (the reference's
``nipals_pca``, ``utils/pca.cpp:5-47``): stack both vertex frames,
eigendecompose their 3x3 covariance, and rotate the world so that the
direction of largest spread becomes the sweep's sort axis x.  A rotation
keeps distances and linear motion, so the TOI is unchanged; only the boxes,
and hence the candidate counts, change.
"""

from __future__ import annotations

import torch

__all__ = ["principal_rotation", "apply_pca"]


def principal_rotation(vertices_t0: torch.Tensor, vertices_t1: torch.Tensor) -> torch.Tensor:
    """``(3, 3)`` rotation whose rows are the principal axes, largest
    variance first, with the last row's sign fixed so that det = +1."""
    pts = torch.cat([vertices_t0, vertices_t1], dim=0)
    centered = pts - pts.mean(dim=0, keepdim=True)
    cov = centered.T @ centered / centered.shape[0]
    # eigh gives ascending eigenvalues: reverse so row 0 is the largest
    _, vecs = torch.linalg.eigh(cov)
    r = vecs.flip(1).T.clone()
    r[2] = r[2] * torch.sign(torch.linalg.det(r))
    return r


def apply_pca(vertices_t0: torch.Tensor, vertices_t1: torch.Tensor):
    """Both frames rotated into the principal axes; returns ``(V0', V1', R)``."""
    r = principal_rotation(vertices_t0, vertices_t1)
    return vertices_t0 @ r.T, vertices_t1 @ r.T, r
