"""State carried across between the JAX package and this port.

CCD has no weights; its state is the scene and the intermediate structures
(boxes, sorted boxes, queries).  These helpers turn values of the JAX
package, handed over as numpy arrays (``np.asarray`` of each field), into
this port's tensors, and the port's values back into numpy, so that a
single stage can be run on identical input in both packages.  Nothing here
imports jax: the JAX-side values only need to convert with ``np.asarray``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import SortedBoxes
from scalable_ccd_tpu_torch.geometry.aabb import AABBs
from scalable_ccd_tpu_torch.narrow_phase.types import CCDQueries

__all__ = [
    "Scene",
    "from_numpy_scene",
    "from_numpy_boxes",
    "from_numpy_queries",
    "to_numpy",
]


class Scene(NamedTuple):
    """A two-frame mesh as tensors."""

    vertices_t0: torch.Tensor  # (n, 3) float64
    vertices_t1: torch.Tensor  # (n, 3) float64
    edges: torch.Tensor  # (m, 2) int32
    faces: torch.Tensor  # (k, 3) int32


def _t(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}.get(a.dtype, torch.int32)
    return torch.tensor(a, dtype=dtype, device=device)  # copies: a may be read-only


def from_numpy_scene(scene, device="cpu") -> Scene:
    """A scene object with ``vertices_t0``, ``vertices_t1``, ``edges`` and
    ``faces`` (either package's ``Scene``) as tensors."""
    return Scene(
        vertices_t0=_t(scene.vertices_t0, device, torch.float64),
        vertices_t1=_t(scene.vertices_t1, device, torch.float64),
        edges=_t(scene.edges, device, torch.int32),
        faces=_t(scene.faces, device, torch.int32),
    )


def from_numpy_boxes(boxes, device="cpu"):
    """JAX ``AABBs`` or ``SortedBoxes`` (fields as numpy arrays or anything
    ``np.asarray`` accepts) as the port's type of the same name; float
    fields keep their precision, integer fields become int32."""
    fields = boxes._fields
    cls = SortedBoxes if "major_min" in fields else AABBs
    return cls(*[_t(getattr(boxes, name), device) for name in cls._fields])


def from_numpy_queries(queries, device="cpu") -> CCDQueries:
    """JAX ``CCDQueries`` as the port's ``CCDQueries``."""
    return CCDQueries(*[_t(getattr(queries, name), device) for name in CCDQueries._fields])


def to_numpy(value):
    """A tensor, or a NamedTuple of tensors, as numpy (the same NamedTuple
    type holding numpy arrays)."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return type(value)(*[to_numpy(v) for v in value])
